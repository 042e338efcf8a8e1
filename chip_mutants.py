#!/usr/bin/env python3
"""Mutation check of chip_smoke.py's K3/K4/K5 and K6 checks, on one CUDA card.

    python3 chip_mutants.py

Builds broken copies of goal_force_tpu_torch/csrc/flash_attention_bwd.cu and
flash_attention_int8.cu (one nvcc per mutant, all started together, in a temporary
directory), loads each in place of the real library and runs chip_smoke's kernel checks
of that source with every failed check recorded instead of raised: the bf16 checks of
K3/K4/K5 (the 1000x777, training self and training cross shapes), and the float32 and
bf16 checks of K6 (1000x777 with tiles of 128 and of 300, the main path's self and cross
shapes). Prints one JSON line per mutant with the checks that caught it; exits 0 when
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

# name -> (source stem, text in the source, its replacement); each text occurs once.
MUTANTS = {
    "K3 no straddle mask": ("flash_attention_bwd",
        "if (straddles && kbase + n * 8 + 2 * t + (e & 1) >= Skv) s[n][e] = MASK_VALUE;", ""),
    "K3 loses kv tile 1": ("flash_attention_bwd",
        "mma_pb<4>(acc, s, Vt, lane);   // acc += bf16(p) V",
        "if (j != 1) mma_pb<4>(acc, s, Vt, lane);"),
    "K4 ds shrunk by 0.2%": ("flash_attention_bwd",
        "ds[n][e] = p[n][e] * (ds[n][e] - di_s[col]) * scale;",
        "ds[n][e] = p[n][e] * (ds[n][e] - di_s[col]) * scale * 0.998f;"),
    "K4 di over half the columns": ("flash_attention_bwd",
        "const int col = x * 8 + 2 * c;", "const int col = (x % 8) * 8 + 2 * c;"),
    "K4 loses the last q tile": ("flash_attention_bwd",
        "for (int i = 0; i < n_qt; ++i) {", "for (int i = 0; i < n_qt - 1; ++i) {"),
    "K5 loses kv tile 1": ("flash_attention_bwd",
        "mma_pb<4>(dqa, ds, Kt, lane);   // dq += bf16(ds) K",
        "if (j != 1) mma_pb<4>(dqa, ds, Kt, lane);"),
    "K5 row g's lse for row g+8": ("flash_attention_bwd",
        "float x = expf(p[n][e] * scale - (hi ? lse1 : lse0));",
        "float x = expf(p[n][e] * scale - lse0);"),
    "K6 k scale per key tile, not per key column": ("flash_attention_int8",
        "if (i < n) kc[i] = skb[min((key0 + i) / bk, Tk - 1)];",
        "if (i < n) kc[i] = skb[min(key0 / bk, Tk - 1)];"),
    "K6 row g's q scale for row g+8": ("flash_attention_int8",
        "const float qs1 = scale * sqb[min(r1 / bq, Tq - 1)];",
        "const float qs1 = scale * sqb[min(r0 / bq, Tq - 1)];"),
    "K6 no mask on the straddling key tile": ("flash_attention_int8",
        "if (straddles && kbase + cl >= Skv) x = MASK_VALUE;", ""),
    "K6 exp2 in place of exp": ("flash_attention_int8",
        "float softmax_exp(float x) { return expf(x); }",
        "float softmax_exp(float x) { return exp2f(x); }"),
    "K6 p truncated to bf16, not rounded to nearest": ("flash_attention_int8",
        "__nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);",
        "__nv_bfloat162 v = __halves2bfloat162(__float2bfloat16_rz(lo), __float2bfloat16_rz(hi));"),
}


CHECKS = {
    "flash_attention_bwd": lambda: cs._training_kernels(dtypes=(torch.bfloat16,), timed=False),
    "flash_attention_int8": lambda: cs._int8_kernels(timed=False),
}


def build_mutants(tmp: Path):
    procs = {}
    for i, (name, (stem, old, new)) in enumerate(MUTANTS.items()):
        source = (_build.CSRC / f"{stem}.cu").read_text()
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
        libs[name] = (MUTANTS[name][0], out)
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
        for name, (stem, path) in libs.items():
            failures.clear()
            lines.clear()
            _build._libs[stem] = ctypes.CDLL(str(path))
            CHECKS[stem]()
            torch.cuda.synchronize()
            failed = [{k: ln[k] for k in ("case", "max_abs_err", "atol", "rel_bias")}
                      for ln in lines if ln.get("ok") is False]
            caught_all &= bool(failures)
            print(json.dumps({"mutant": name, "caught": bool(failures), "failed_checks": failed}),
                  flush=True)
    return 0 if caught_all else 1


if __name__ == "__main__":
    sys.exit(main())
