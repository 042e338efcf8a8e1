#!/usr/bin/env python3
"""Mutation check of chip_smoke.py's K3/K4/K5 checks, on one CUDA card.

    python3 chip_mutants.py

Builds broken copies of goal_force_tpu_torch/csrc/flash_attention_bwd.cu (one nvcc per
mutant, all started together, in a temporary directory), loads each in place of the
real library and runs chip_smoke's bf16 kernel checks of K3/K4/K5 (the 1000x777,
training self and training cross shapes) with every failed check recorded instead of
raised. Prints one JSON line per mutant with the checks that caught it; exits 0 when
every mutant was caught by at least one check.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

import chip_smoke as cs
from goal_force_tpu_torch.ops import _build

SRC = _build.CSRC / "flash_attention_bwd.cu"

# name -> (text in the source, its replacement); each text occurs exactly once.
MUTANTS = {
    "K3 no straddle mask": (
        "if (straddles && kbase + n * 8 + 2 * t + (e & 1) >= Skv) s[n][e] = MASK_VALUE;", ""),
    "K3 loses kv tile 1": (
        "mma_pb<4>(acc, s, Vt, lane);   // acc += bf16(p) V",
        "if (j != 1) mma_pb<4>(acc, s, Vt, lane);"),
    "K4 ds shrunk by 0.2%": (
        "ds[n][e] = p[n][e] * (ds[n][e] - di_s[col]) * scale;",
        "ds[n][e] = p[n][e] * (ds[n][e] - di_s[col]) * scale * 0.998f;"),
    "K4 di over half the columns": (
        "const int col = x * 8 + 2 * c;", "const int col = (x % 8) * 8 + 2 * c;"),
    "K4 loses the last q tile": (
        "for (int i = 0; i < n_qt; ++i) {", "for (int i = 0; i < n_qt - 1; ++i) {"),
    "K5 loses kv tile 1": (
        "mma_pb<4>(dqa, ds, Kt, lane);   // dq += bf16(ds) K",
        "if (j != 1) mma_pb<4>(dqa, ds, Kt, lane);"),
    "K5 row g's lse for row g+8": (
        "float x = expf(p[n][e] * scale - (hi ? lse1 : lse0));",
        "float x = expf(p[n][e] * scale - lse0);"),
}


def build_mutants(tmp: Path):
    source = SRC.read_text()
    procs = {}
    for i, (name, (old, new)) in enumerate(MUTANTS.items()):
        if source.count(old) != 1:
            raise RuntimeError(f"{name}: the text to mutate occurs {source.count(old)} times")
        src = tmp / f"mutant{i}.cu"
        src.write_text(source.replace(old, new))
        out = tmp / f"mutant{i}.so"
        procs[name] = (subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS, str(src), "-o",
                                         str(out)], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log_ = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed:\n{log_}")
        libs[name] = out
    return libs


def main() -> int:
    cs.phase_device()
    failures = []
    cs.check = lambda cond, msg: None if cond else failures.append(msg)
    lines = []
    cs.log = lambda phase, **f: lines.append(f)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_mutants(Path(tmp))
        caught_all = True
        for name, path in libs.items():
            failures.clear()
            lines.clear()
            _build._libs["flash_attention_bwd"] = ctypes.CDLL(str(path))
            cs._training_kernels(dtypes=(torch.bfloat16,), timed=False)
            torch.cuda.synchronize()
            failed = [{k: ln[k] for k in ("case", "max_abs_err", "atol", "rel_bias")}
                      for ln in lines if ln.get("ok") is False]
            caught_all &= bool(failures)
            print(json.dumps({"mutant": name, "caught": bool(failures), "failed_checks": failed}),
                  flush=True)
    return 0 if caught_all else 1


if __name__ == "__main__":
    sys.exit(main())
