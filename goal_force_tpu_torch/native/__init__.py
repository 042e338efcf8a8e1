"""The native (C++) control-map renderer, built at first use and loaded with ctypes.

``control_render.cpp`` is a copy of the JAX package's renderer. ``native()`` compiles it
with ``g++ -O3 -march=native -shared -fPIC`` into ``build/native/`` at the repository
root, named by a hash of the source, the flags and the host CPU's feature flags (the
library is built for this CPU), so an unchanged source is never rebuilt on one host, and
returns the loaded library, or None where it does not build (no compiler). The build
writes a temporary file and renames it, so processes that build at once do not see a
partial library. ``build_error`` holds the compiler's message of a failed build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from functools import lru_cache
from pathlib import Path
from typing import Optional

SRC = Path(__file__).resolve().parent / "control_render.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]
build_error: Optional[str] = None


def _cpu_flags() -> bytes:
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((ln for ln in f if ln.startswith(b"flags")), b"")
    except OSError:
        return b""


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS).encode() + _cpu_flags())
    return BUILD_DIR / f"control_render-{h.hexdigest()[:16]}.so"


@lru_cache(maxsize=1)
def native() -> Optional[ctypes.CDLL]:
    """The loaded renderer, compiled once per source; None if it does not build."""
    global build_error
    import numpy as np
    from numpy.ctypeslib import ndpointer

    out = library_path()
    try:
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(["g++", *FLAGS, str(SRC), "-o", str(tmp)], check=True,
                           capture_output=True, text=True)
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
    except (OSError, subprocess.CalledProcessError) as e:
        build_error = getattr(e, "stderr", None) or str(e)
        return None
    f32 = ndpointer(np.float32, flags="C_CONTIGUOUS")
    i = ctypes.c_int
    lib.gf_add_moving_blob.argtypes = [f32, i, i, i, i, i, f32, f32, ctypes.c_float,
                                       ctypes.c_float]
    lib.gf_add_static_blobs.argtypes = [f32, i, i, i, i, i, f32, f32, f32, i, ctypes.c_float]
    lib.gf_clamp01.argtypes = [f32, ctypes.c_int64]
    for fn in (lib.gf_add_moving_blob, lib.gf_add_static_blobs, lib.gf_clamp01):
        fn.restype = None
    return lib
