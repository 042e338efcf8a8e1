"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/*.cu`` compiles with ``nvcc -shared -Xcompiler -fPIC`` (``-I csrc``, linked
with ``-lcuda`` for ``cuTensorMapEncodeTiled``) into a shared library with a plain C
interface, under ``build/torch_ext/`` at the repository root, named by a hash of the
source, the ``csrc/*.cuh`` headers and the flags, so an unchanged source is never rebuilt
and an edited header rebuilds every source. This route
needs neither ``ninja`` nor PyTorch's headers (``torch.utils.cpp_extension.load`` needs
both, and including the headers costs minutes of compile time). ``load_all`` starts one
``nvcc`` per source at once. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lcuda"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}     # stem -> compiler output (register/spill report)


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, then PATH, then /usr/local/cuda."""
    candidates = [os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                  shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def nvcc_command(src: Path, out: Path, include_dir: Optional[Path] = None) -> List[str]:
    """The compiler call for one source; its quoted includes resolve in the source's own
    directory first, then in `include_dir` (csrc/ by default)."""
    return [nvcc_path(), *NVCC_FLAGS, "-I", str(include_dir or CSRC), str(src), "-o", str(out)]


def library_path(stem: str) -> Path:
    """Where csrc/<stem>.cu builds to: named by a hash of it, the headers and the flags."""
    h = hashlib.sha256((CSRC / f"{stem}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def stems() -> List[str]:
    """Every CUDA source of the port, by file stem."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def load_all(names=None) -> Dict[str, ctypes.CDLL]:
    """Build (all nvcc processes started together) and load the given sources."""
    names = list(names or stems())
    with _lock:
        procs = {}
        for stem in names:
            if stem in _libs:
                continue
            src = CSRC / f"{stem}.cu"
            out = library_path(stem)
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                procs[stem] = (subprocess.Popen(
                    nvcc_command(src, tmp),
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
        failed = []
        for stem, (proc, tmp, out) in procs.items():
            build_log[stem] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {stem}.cu (exit {proc.returncode}):\n"
                              f"{build_log[stem]}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("\n".join(failed))
        for stem in names:
            if stem not in _libs:
                _libs[stem] = ctypes.CDLL(str(library_path(stem)))
        return {stem: _libs[stem] for stem in names}


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from csrc/<stem>.cu, compiling it on first use."""
    return load_all([stem])[stem]
