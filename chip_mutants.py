#!/usr/bin/env python3
"""Mutation check of chip_smoke.py's K1, K3/K4/K5 and K6 checks, on one CUDA card.

    python3 chip_mutants.py

Builds 27 broken copies of the port's kernels (5 of K1 and 3 of K2 in flash_attention.cu
and the forward skeleton's header flash_attention_sm90.cuh, 14 of K3-K5 in
flash_attention_bwd.cu and its headers, 5 of K6 in flash_attention_int8.cu; a mutant may
patch a header, built into its own source only, so one text of the skeleton's header
breaks K2 in one mutant and K3 in another), one nvcc per mutant, all started together,
each in a temporary directory of its own with copies of the headers. Loads each in place
of the real library and runs chip_smoke's kernel checks of that source with every failed
check recorded instead of raised: the float32 and bf16 checks of K1/K2 (small shapes,
kv_len, the tile edges, the serving self and cross shapes), the bf16 checks of K3/K4/K5
(the 1000x777, training self and training cross shapes, the tile edges, and K3 with q and
k x8), and the float32 and bf16 checks of K6 (1000x777 and the tile edges with
quantization tiles of 128 and of 300, the serving self and cross shapes). Prints one JSON
line per mutant with the checks that caught it; exits 0 when every mutant was caught by at
least one check.
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

SM90 = "flash_attention_sm90.cuh"
BWD = "flash_attention_bwd_sm90.cuh"
# Texts of the skeleton header's online max (K2 and K3).
STRADDLE = "if (kbase + BK > valid) {   // only the tile that straddles `valid` pays for the mask"
RESCALE = "if (__any_sync(0xffffffff, a0 != 1.f || a1 != 1.f)) {   // else acc * 1 == acc"

# name -> (source stem, file patched (None: the source itself), text in that file, its
# replacement); each text occurs once.
MUTANTS = {
    "K1 no straddle mask": ("flash_attention", None,
        "if (straddles) {   // only the tile that straddles `valid` pays for the mask",
        "if (false) {"),
    "K1 loses key tile 1": ("flash_attention", None,
        "sc[4 * n + e] = exp2f(x);", "sc[4 * n + e] = kbase == sm90::BK ? 0.f : exp2f(x);"),
    "K1 row r's sum for row r+8": ("flash_attention", None,
        "inv1 = s1 == 0.f ? 1.f : 1.f / s1;", "inv1 = s0 == 0.f ? 1.f : 1.f / s0;"),
    "K1 kv_len ignored": ("flash_attention", None,
        "const int l = a.kv_len[b];", "const int l = a.Skv;"),
    "K1 q fold skips the second 64-column half": ("flash_attention", None,
        "for (int hh = 0; hh < 2; ++hh) {", "for (int hh = 0; hh < 1; ++hh) {"),
    "K2 no straddle mask": ("flash_attention", SM90, STRADDLE, "if (false) {"),
    "K2 kv_len ignored": ("flash_attention", None, "struct K2Policy : K1Policy {",
        "struct K2Policy : K1Policy {\n"
        "  __device__ static int kv_valid(const sm90::Args& a, int) { return a.Skv; }"),
    "K2 acc not rescaled by alpha": ("flash_attention", SM90, RESCALE, "if (false) {"),
    "K3 no straddle mask": ("flash_attention_bwd", SM90, STRADDLE, "if (false) {"),
    "K3 loses key tile 1": ("flash_attention_bwd", SM90,
        "pv_issue(acc, pf, sV + s * V_BYTES);", "if (j != 1) pv_issue(acc, pf, sV + s * V_BYTES);"),
    "K3 acc not rescaled by alpha": ("flash_attention_bwd", SM90, RESCALE, "if (false) {"),
    "K3 lse without its m*scale term": ("flash_attention_bwd", None,
        "lb[r0] = __fmul_rn(m0, a.scale) + logf(fmaxf(l0, 1e-30f));",
        "lb[r0] = logf(fmaxf(l0, 1e-30f));"),
    "K3 row g's lse written for row g+8": ("flash_attention_bwd", None,
        "lb[r0 + 8] = __fmul_rn(m1, a.scale) + logf(fmaxf(l1, 1e-30f));",
        "lb[r0 + 8] = __fmul_rn(m0, a.scale) + logf(fmaxf(l0, 1e-30f));"),
    "K4 ds shrunk by 0.2%": ("flash_attention_bwd", BWD,
        "dpt[e] = st[e] * (dpt[e] - lds(tab + 4 * (KV_QROWS + c))) * a.scale;",
        "dpt[e] = st[e] * (dpt[e] - lds(tab + 4 * (KV_QROWS + c))) * a.scale * 0.998f;"),
    "K4/K5 di over half the columns": ("flash_attention_bwd", None,
        "for (int x = 0; x < 2; ++x) {", "for (int x = 0; x < 1; ++x) {"),
    "K4 dV loses the last q tile": ("flash_attention_bwd", BWD,
        "pv_issue(dv, pf, sdo);", "if (i + 1 < n_qt) pv_issue(dv, pf, sdo);"),
    "K5 loses key tile 1": ("flash_attention_bwd", BWD,
        "pv_issue(dq, df, sk);", "if (j != 1) pv_issue(dq, df, sk);"),
    "K5 row g's lse for row g+8": ("flash_attention_bwd", BWD,
        "sc[i] = ex2(fmaf(sc[i], a.scale_log2, -(i & 2 ? l1 : l0)));",
        "sc[i] = ex2(fmaf(sc[i], a.scale_log2, -l0));"),
    "K4 dK misses scale": ("flash_attention_bwd", BWD,
        "dpt[e] = st[e] * (dpt[e] - lds(tab + 4 * (KV_QROWS + c))) * a.scale;",
        "dpt[e] = st[e] * (dpt[e] - lds(tab + 4 * (KV_QROWS + c)));"),
    "K5 dQ misses scale": ("flash_attention_bwd", BWD,
        "dp[i] = sc[i] * (dp[i] - (i & 2 ? d1 : d0)) * a.scale;",
        "dp[i] = sc[i] * (dp[i] - (i & 2 ? d1 : d0));"),
    "K5 reads batch row 0's lse and di in every batch row": ("flash_attention_bwd", BWD,
        "const long long off = ((long long)b * a.N + h) * a.rows;   // r0 + 8 < rows",
        "const long long off = (long long)h * a.rows;"),
    "K4/K5 scratch keeps lse without the log2 e factor": ("flash_attention_bwd", None,
        "scratch[bh * rows + r] = r < Sq ? lse[bh * Sq + r] * sm90_bwd::LOG2E : INFINITY;",
        "scratch[bh * rows + r] = r < Sq ? lse[bh * Sq + r] : INFINITY;"),
    "K6 k scale per key tile, not per key column": ("flash_attention_int8", None,
        "kc[i] = skb[min((key0 + i) / a.bk, a.Tk - 1)];", "kc[i] = skb[min(key0 / a.bk, a.Tk - 1)];"),
    "K6 row r's q scale for row r+8": ("flash_attention_int8", None,
        "qs1 = a.scale * sqb[min((r0 + 8) / a.bq, a.Tq - 1)];",
        "qs1 = a.scale * sqb[min(r0 / a.bq, a.Tq - 1)];"),
    "K6 no mask on the straddling key tile": ("flash_attention_int8", None,
        "if (straddles) {   // only the tile that straddles Skv pays for the mask",
        "if (false) {"),
    "K6 exp2 in place of exp": ("flash_attention_int8", None,
        "float softmax_exp(float x) { return expf(x); }",
        "float softmax_exp(float x) { return exp2f(x); }"),
    "K6 p truncated to bf16, not rounded to nearest": ("flash_attention_int8", SM90,
        "__nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);",
        "__nv_bfloat162 v = __halves2bfloat162(__float2bfloat16_rz(lo), __float2bfloat16_rz(hi));"),
}


CHECKS = {
    "flash_attention": lambda: cs._forward_kernels(timed=False),
    "flash_attention_bwd": lambda: cs._training_kernels(dtypes=(torch.bfloat16,), timed=False),
    "flash_attention_int8": lambda: cs._int8_kernels(timed=False),
}


def build_mutants(tmp: Path):
    procs = {}
    for i, (name, (stem, patched, old, new)) in enumerate(MUTANTS.items()):
        d = tmp / f"mutant{i}"
        d.mkdir()
        for f in [_build.CSRC / f"{stem}.cu", *_build.CSRC.glob("*.cuh")]:
            (d / f.name).write_text(f.read_text())
        target = d / (patched or f"{stem}.cu")
        text = target.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the text to mutate occurs {text.count(old)} times")
        target.write_text(text.replace(old, new))
        out = d / f"{stem}.so"
        procs[name] = (subprocess.Popen(_build.nvcc_command(d / f"{stem}.cu", out, d),
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out)
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
