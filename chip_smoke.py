#!/usr/bin/env python3
"""Drive the PyTorch port (goal_force_tpu_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero with no result line:

1. device  - a CUDA card must be present; prints nvidia-smi's name and power limit.
2. build   - compiles goal_force_tpu_torch/csrc/*.cu with nvcc for sm_90a (one nvcc per
             source, started together) and prints each kernel's ptxas report and the
             Hopper kernels' (K1-K6) SASS instruction counts by opcode; each of them must
             hold HGMMA (wgmma) and no HMMA (mma.sync), spill nothing, and draw no ptxas
             warning that it serialized its wgmma.
3. kernels - holds K1/K2 against their plain torch versions on the card (small shapes,
             saturation, per-batch kv_len, both at the Hopper tiles' edges: B = 2, Sq and
             Skv of 127 and 129, and the main-path self and cross shapes), K3/K4/K5 (o and
             lse, dk and dv, dq) in float32 and bf16 at 1000x777 and at the training self
             and cross shapes, K3/K4/K5 in bf16 at their tiles' edges (B = 2, Sq and Skv
             of 127 and 129, and Skv = 40) and K3 with q and k x8 (a running max that
             moves), and K6 (int8 q and k) in float32 and bf16 at 1000x777
             and at the tile edges with quantization tiles of 128 and 300, and at the main
             path's self and cross shapes; times kernel, plain version, K6's quantize step
             and SDPA (as a yardstick only) at the path shapes.
4. small   - a head_dim-128 float32 pipeline at a small size, kernels vs plain
             attention (float32 convs without TF32 for the check).
5. small_train - one training loss + backward at that size, kernels vs plain attention
             (loss and every ControlNet gradient), and the launch counts of the rule.
6. small_int8 - the W8A8 linears on the card, then that pipeline with W8A8 packs in its
             four DiT/ControlNet models: K6 vs the plain int8 attention, K6 launches only.
7. main    - GoalForcePipeline at full A14B width (depth cut to 4 DiT + 2 ControlNet
             layers per expert, 2 umt5 layers, full Wan2.1 VAE), random weights from a
             seed, answering two 81x480x832 requests of 4 steps each; launch counts
             are reset just before and read just after.
8. unbounded - one merged-CFG step with qk_bounded=False and enlarged q-norm weights,
             so the runtime logit bound routes self-attention to K2.
9. main_int8 - main's pipeline quantized in place (W8A8 block linears) with
             attn_impl="flash_int8": the same two requests, 48 K6 launches each and no
             other, and the frames' mean distance from main's bf16 frames.
10. train  - frees the serving pipeline and trains the ControlNet at full A14B width
             (4 DiT + 2 ControlNet layers, bf16, B = 1, 81x480x832 synthetic clips): 2
             steps, a checkpoint, a full-state resume and a 3rd step; checks the loss,
             the frozen models, the checkpoint and the launches per step, and logs the
             stage split and peak memory.
11. full_int8 - full A14B depth on one card (40 DiT + 10 ControlNet layers per expert,
             24-layer umt5-xxl, full VAE), W8A8 + K6: one 2-step request across the
             expert switch, 100 K6 launches per step; logs init, stages and peak memory.

The second-to-last line is nvidia-smi's "name, power.limit"; before it, one JSON line
lists each kernel's launches, error and times; the last line is the result JSON.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor-core peak (data sheet)
PEAK_F32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12            # H100 SXM HBM3 bandwidth
SELF = (2, 32760, 40, 128)      # main-path self-attention q/k/v
CROSS_KV = (2, 512, 40, 128)    # main-path cross-attention text keys
TRAIN_SELF = (1, 32760, 40, 128)     # training (B = 1) self-attention q/k/v
TRAIN_CROSS_KV = (1, 512, 40, 128)   # training cross-attention text keys
STEPS = 4
K1_PER_REQUEST = 2 * (4 + 2) * STEPS


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


T0 = time.perf_counter()


def log(phase, **fields):
    """One JSON line; "t" is seconds since the script started."""
    print(json.dumps({"phase": phase, "t": round(time.perf_counter() - T0, 3), **fields}),
          flush=True)


def sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def event_ms(fn, iters=3, warmup=1):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(q_shape, kv_shape, itemsize=2, peak=PEAK_BF16_FLOPS):
    """Least time for one call: max(bytes of q,k,v,o / HBM rate, 4*B*N*Sq*Skv*H / peak)."""
    b, sq, n, h = q_shape
    skv = kv_shape[1]
    nbytes = (2 * b * sq * n * h + 2 * b * skv * n * h) * itemsize
    flops = 4 * b * n * sq * skv * h
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_device():
    check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 matmuls in full float32
    torch.backends.cudnn.allow_tf32 = True          # float32 convs (VAE) in TF32
    log("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda,
        matmul_tf32=False, cudnn_tf32=True)
    return card


def phase_build():
    from goal_force_tpu_torch.ops import _build

    _, secs = sync_time(_build.load_all)      # one nvcc per source, started together
    check(set(_build.stems()) == {"flash_attention", "flash_attention_bwd",
                                  "flash_attention_int8"},
          f"unexpected CUDA sources {_build.stems()}")
    for stem, log_ in sorted(_build.build_log.items()):
        ptxas = [ln.strip() for ln in log_.splitlines() if "registers" in ln or "spill" in ln
                 or "Compiling entry" in ln or "error" in ln.lower() or "Performance Loss" in ln]
        log("build", source=f"{stem}.cu", ptxas=ptxas)
        # A Hopper body that spills, or whose wgmmas ptxas serializes, is not the kernel
        # that was measured.
        for i, ln in enumerate(ptxas):
            if "Compiling entry" in ln and any(frag in ln for frag in SM90_BODIES):
                spill = next((x for x in ptxas[i + 1:] if "spill" in x), "")
                check(spill.startswith("0 bytes stack frame, 0 bytes spill stores"),
                      f"{stem}.cu: a Hopper kernel spills: {ln} {spill}")
        # C75xx: only the Hopper bodies issue wgmma.
        check(not any("Performance Loss" in ln for ln in ptxas),
              f"{stem}.cu: ptxas serialized a Hopper kernel's wgmma: {ptxas}")
    log("build", seconds=round(secs, 3), nvcc=_build.nvcc_path())
    found = set()
    for stem in ("flash_attention", "flash_attention_int8", "flash_attention_bwd"):
        counts = _sass_counts(_build.library_path(stem))
        found |= set(counts)
        log("build", source=f"{stem}.cu", sass_opcodes=counts)
        for name, ops in counts.items():   # every Hopper body: wgmma only, no mma.sync
            check(ops.get("HGMMA", 0) > 0 and ops.get("HMMA", 0) == 0,
                  f"{name}: SASS holds {ops.get('HGMMA', 0)} HGMMA and {ops.get('HMMA', 0)} HMMA")
    check(found == set(SM90_BODIES.values()), f"Hopper bodies found in the SASS: {found}")


# Hopper kernel bodies in the SASS: a function-name fragment -> the kernel's name.
SM90_BODIES = {"K1Policy": "K1", "K2Policy": "K2", "K3Policy": "K3", "K6Policy": "K6",
               "fa_sm90_bwd_dkv": "K4", "fa_sm90_bwd_dq": "K5"}


def _sass_counts(lib_path):
    """Instructions by opcode in the SASS of each Hopper kernel (SM90_BODIES) of a built
    library: the elementwise share of the instruction stream beside the HGMMAs."""
    import collections
    import re

    from goal_force_tpu_torch.ops import _build

    dump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([dump, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        kernel = next((k for frag, k in SM90_BODIES.items() if frag in name), None)
        if kernel is None:
            continue
        ops = collections.Counter()
        for m in re.finditer(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)(\.[A-Z0-9]+)?",
                             part):
            op, sub = m.group(1), m.group(2) or ""
            ops[op + sub if op == "MUFU" else op] += 1
        out[kernel] = {**dict(ops.most_common(20)), "HGMMA": ops["HGMMA"], "HMMA": ops["HMMA"]}
    return out


def _rand(shape, gen, dtype, mult=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * mult).to(dtype)


# Mean error along the reference's sign, over mean |ref|: rounding errors of a right
# kernel average out (~1e-5), while p rounded towards zero instead of to nearest
# shrinks every output by ~2e-3, far below one ulp of any single element.
MAX_BIAS = 5e-4


def compare(name, got, ref, atol, rtol, phase="kernels"):
    g, r = got.float(), ref.float()
    err = (g - r).abs()
    lim = atol + rtol * r.abs()
    bias = float(((g - r) * r.sign()).mean() / r.abs().mean().clamp(min=1e-30))
    ok = (bool(torch.isfinite(g).all()) and bool((err <= lim).all())
          and abs(bias) <= MAX_BIAS)
    log(phase, case=name, max_abs_err=float(err.max()), atol=atol, rtol=rtol,
        rel_bias=bias, max_rel_bias=MAX_BIAS, ok=ok)
    check(ok, f"kernel check failed: {name}")
    return float(err.max())


def only(**counts):
    """The full launch-count dict with the given kernels' counts and 0 elsewhere."""
    from goal_force_tpu_torch.ops import flash_attention as fa

    return {k: counts.get(k, 0) for k in fa.launch_counts}


def picked(fn):
    """fn's result and the launches it made (synchronised)."""
    from goal_force_tpu_torch.ops import flash_attention as fa

    before = dict(fa.launch_counts)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: fa.launch_counts[k] - before[k] for k in before}


# The Hopper kernels' tile edges: 128-row q tiles and 128-key tiles, ragged at the end of
# every batch row (Sq, Skv in {127, 129}, B = 2), and K1's and K2's kv_len (per batch row)
# on both sides of a tile edge: no key, one short of a tile, exactly one tile, one key past
# it.
EDGES = (((127, 127), (0, 127)), ((127, 129), (128, 129)), ((129, 127), (127, 1)),
         ((129, 129), (0, 128)))


def phase_kernels():
    """Kernel vs plain on the same inputs; returns per-kernel measurements."""
    out = _forward_kernels()
    out.update(_training_kernels())
    out.update(_int8_kernels())
    return out


def _forward_kernels(timed=True):
    """K1/K2 vs their plain versions in float32 and bf16 (small shapes, saturation,
    per-batch kv_len), both at the tile edges (EDGES), and both at the main path's self
    and cross shapes; times kernel, plain version and SDPA (a yardstick only) there."""
    from goal_force_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator("cuda").manual_seed(1234)
    scale = 128**-0.5
    # bf16 limits follow the size of what is compared. Kernel and plain version round the
    # same float32 values to bf16, so they differ by about one bf16 ulp of the output,
    # plus a p that rounds the other way where exp2 differs in its last float32 bit.
    # (1000|260)x(777|300) keys: |o| < 0.5 (ulp <= 2e-3) -> 5e-3; x40 inputs concentrate
    # each row on a few keys, |o| up to max|v| ~ 5 -> 2e-2; the self shape: 32,760 keys,
    # |o| < 0.0625 (ulp 2.4e-4) -> 1e-3, under the ~2e-3 a lost 64-key tile would move it;
    # the cross shape: 512 keys, |o| < 0.5 -> 1e-2.
    f32_tol = dict(atol=2e-5, rtol=2e-5)
    bf16_tol = dict(atol=5e-3, rtol=0.0)
    bf16_tol_shape = {"self": dict(atol=1e-3, rtol=0.0), "cross": dict(atol=1e-2, rtol=0.0)}


    for dtype, tol in ((torch.float32, f32_tol), (torch.bfloat16, bf16_tol)):
        tag = str(dtype).split(".")[-1]
        q = _rand((1, 1000, 4, 128), gen, dtype)
        k, v = _rand((1, 777, 4, 128), gen, dtype), _rand((1, 777, 4, 128), gen, dtype)
        got = fa.flash_attention_nomax(q, k, v, scale)
        compare(f"K1 clamp {tag} (1,1000,4,128)x(1,777,4,128)", got,
                fa.flash_attention_nomax_plain(q, k, v, scale), **tol)
        got, n = picked(lambda: fa.flash_attention(q, k, v, scale, dispatch="auto"))
        check(n == only(K1=1), f"auto dispatch on bounded inputs launched {n}")
        compare(f"K1 no clamp via auto {tag}", got,
                fa.flash_attention_nomax_plain(q, k, v, scale, clamp=None), **tol)
        q40, k40 = q * 40, k * 40
        got, n = picked(lambda: fa.flash_attention(q40, k40, v, scale, dispatch="auto"))
        check(n == only(K2=1), f"auto dispatch on x40 inputs launched {n}")
        compare(f"K2 via auto x40 {tag}", got, fa.flash_attention_max_plain(q40, k40, v, scale),
                atol=2e-3 if dtype == torch.float32 else 2e-2, rtol=0.0)
        sat = fa.flash_attention(q40, k40, v, scale, dispatch="nomax")
        vmax = float(v.float().abs().max())
        check(bool(torch.isfinite(sat.float()).all()) and float(sat.float().abs().max()) <= vmax + 1e-3,
              f"K1 saturation {tag}: not finite or beyond max|v|")
        log("kernels", case=f"K1 saturation x40 {tag}", finite=True,
            max_abs_out=float(sat.float().abs().max()), max_abs_v=vmax, ok=True)
        lens = torch.tensor([0, 300], device="cuda")
        qb = _rand((2, 260, 2, 128), gen, dtype)
        kb, vb = _rand((2, 300, 2, 128), gen, dtype), _rand((2, 300, 2, 128), gen, dtype)
        for kname, kern, plain in (("K1", fa.flash_attention_nomax, fa.flash_attention_nomax_plain),
                                   ("K2", fa.flash_attention_max, fa.flash_attention_max_plain)):
            got = kern(qb, kb, vb, scale, kv_len=lens)
            check(bool((got[0] == 0).all()), f"{kname} kv_len=0 row is not exactly 0")
            compare(f"{kname} kv_len=(0,300) {tag}", got, plain(qb, kb, vb, scale, kv_len=lens), **tol)

    k1, k1_plain = fa.flash_attention_nomax, fa.flash_attention_nomax_plain
    k2, k2_plain = fa.flash_attention_max, fa.flash_attention_max_plain
    for (sq, skv), lens in EDGES:
        q, k, v = (_rand((2, s, 2, 128), gen, torch.bfloat16) for s in (sq, skv, skv))
        kv_len = torch.tensor(lens, device="cuda")
        for kname, kern, plain, kw, what in (
                ("K1", k1, k1_plain, dict(kv_len=kv_len, clamp=fa.NOMAX_CLAMP), f"kv_len={lens}"),
                ("K1", k1, k1_plain, dict(clamp=None), "no clamp"),
                ("K2", k2, k2_plain, dict(kv_len=kv_len), f"kv_len={lens}"),
                ("K2", k2, k2_plain, {}, "all keys")):
            got = kern(q, k, v, scale, **kw)
            ref = plain(q, k, v, scale, **kw)
            if "kv_len" in kw and lens[0] == 0:
                check(bool((got[0] == 0).all()), f"{kname} edge {sq}x{skv}: kv_len=0 row is not 0")
            compare(f"{kname} edge (2,{sq},2,128)x(2,{skv},2,128) bf16 {what}", got, ref,
                    atol=bf16_limit(ref), rtol=0.0)

    # Main-path shapes, bf16: self-attention (K1; K2 on the unbounded path) and cross.
    out = {}
    q, k, v = (_rand(SELF, gen, torch.bfloat16) for _ in range(3))
    ck, cv = _rand(CROSS_KV, gen, torch.bfloat16), _rand(CROSS_KV, gen, torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for kname, kern, plain in (
            ("K1", lambda a, b, c: fa.flash_attention_nomax(a, b, c, scale),
             lambda a, b, c: fa.flash_attention_nomax_plain(a, b, c, scale)),
            ("K2", lambda a, b, c: fa.flash_attention_max(a, b, c, scale),
             lambda a, b, c: fa.flash_attention_max_plain(a, b, c, scale))):
        rec = {}
        for sname, kk, vv in (("self", k, v), ("cross", ck, cv)):
            got = kern(q, kk, vv)
            ref = plain(q, kk, vv)
            err = compare(f"{kname} {sname} {tuple(q.shape)}x{tuple(kk.shape)} bf16", got, ref,
                          **bf16_tol_shape[sname])
            del got, ref
            torch.cuda.empty_cache()
            if not timed:
                continue
            plain_ms = event_ms(lambda: plain(q, kk, vv), iters=1, warmup=0)   # warm: 2nd call
            ms = event_ms(lambda: kern(q, kk, vv))
            lib_ms = event_ms(lambda: sdpa(q.transpose(1, 2), kk.transpose(1, 2),
                                           vv.transpose(1, 2)))
            bound, by = attention_bound_ms(q.shape, kk.shape)
            rec[sname] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                              bound_by=by, library_ms=lib_ms,
                              shape=f"{tuple(q.shape)}x{tuple(kk.shape)}")
            log("kernels", case=f"{kname} {sname} timing", **rec[sname])
        out[kname] = rec
    del q, k, v, ck, cv
    torch.cuda.empty_cache()
    return out


def bf16_limit(ref) -> float:
    """Two bf16 ulps at the largest |ref|: kernel and plain version round float32 sums
    that differ only in summation order to bf16, so a right kernel is within one ulp."""
    top = float(ref.float().abs().max())
    return 2.0 * 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 1e-30


def kernel_bound_ms(flops, nbytes, peak=PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _training_kernels(dtypes=(torch.float32, torch.bfloat16), timed=True):
    """K3/K4/K5 vs their plain versions in float32 and bf16, at a shape with a padded q
    tile and a partly masked kv tile and at the training path's self and cross shapes,
    then (bf16) K3/K4/K5 at their tiles' edges and K3 with q and k x8; times kernel,
    plain version and SDPA (a yardstick only) at the bf16 path shapes."""
    from goal_force_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator("cuda").manual_seed(4321)
    scale = 128**-0.5
    tols = {torch.float32: dict(atol=2e-5, rtol=2e-5)}  # float32: another summation order
    grad_f32 = dict(atol=1e-4, rtol=1e-4)               # sums of up to 32,760 such terms
    lse_tol = dict(atol=1e-5, rtol=1e-5)                # float32 logs of float32 sums
    sdpa = torch.nn.functional.scaled_dot_product_attention
    shapes = (("small", (1, 1000, 4, 128), (1, 777, 4, 128)),
              ("self", TRAIN_SELF, TRAIN_SELF), ("cross", TRAIN_SELF, TRAIN_CROSS_KV))
    out = {"K3": {}, "K4": {}, "K5": {}}
    for dtype in dtypes:
        tag = str(dtype).split(".")[-1]
        for sname, q_shape, kv_shape in shapes:
            q, do = _rand(q_shape, gen, dtype), _rand(q_shape, gen, dtype)
            k, v = _rand(kv_shape, gen, dtype), _rand(kv_shape, gen, dtype)
            case = f"{tag} {sname} {q_shape}x{kv_shape}"

            def tol(ref, grad=False):
                if dtype == torch.bfloat16:
                    return dict(atol=bf16_limit(ref), rtol=0.0)
                return grad_f32 if grad else tols[dtype]

            (o, lse), n = picked(lambda: fa.flash_attention_fwd_lse(q, k, v, scale))
            check(n == only(K3=1), f"K3 {case} launched {n}")
            o_ref, lse_ref = fa.flash_attention_fwd_lse_plain(q, k, v, scale)
            err = {"K3": compare(f"K3 o {case}", o, o_ref, **tol(o_ref))}
            compare(f"K3 lse {case}", lse, lse_ref, **lse_tol)
            del o, lse
            # The backward kernels get the plain forward's o and lse, so each is held
            # against its plain version on exactly the same inputs.
            (dk, dv), n = picked(lambda: fa.flash_attention_bwd_dkv(q, k, v, o_ref, do,
                                                                    lse_ref, scale))
            check(n == only(K4=1), f"K4 {case} launched {n}")
            dk_ref, dv_ref = fa.flash_attention_bwd_dkv_plain(q, k, v, o_ref, do, lse_ref, scale)
            err["K4"] = max(compare(f"K4 dk {case}", dk, dk_ref, **tol(dk_ref, True)),
                            compare(f"K4 dv {case}", dv, dv_ref, **tol(dv_ref, True)))
            del dk, dv, dk_ref, dv_ref
            dq, n = picked(lambda: fa.flash_attention_bwd_dq(q, k, v, o_ref, do, lse_ref, scale))
            check(n == only(K5=1), f"K5 {case} launched {n}")
            dq_ref = fa.flash_attention_bwd_dq_plain(q, k, v, o_ref, do, lse_ref, scale)
            err["K5"] = compare(f"K5 dq {case}", dq, dq_ref, **tol(dq_ref, True))
            del dq, dq_ref
            torch.cuda.empty_cache()
            if not timed or dtype != torch.bfloat16 or sname == "small":
                continue
            b, sq, nh, hd = q_shape
            skv = kv_shape[1]
            mm = b * nh * sq * skv * hd                 # one Sq x Skv x 128 product per head
            qb, kvb, lseb = q.numel() * 2, k.numel() * 2, b * nh * sq * 4
            args = (q, k, v, o_ref, do, lse_ref, scale)
            runs = {
                "K3": (lambda: fa.flash_attention_fwd_lse(q, k, v, scale),
                       lambda: fa.flash_attention_fwd_lse_plain(q, k, v, scale),
                       kernel_bound_ms(4 * mm, 2 * qb + 2 * kvb + lseb)),
                "K4": (lambda: fa.flash_attention_bwd_dkv(*args),
                       lambda: fa.flash_attention_bwd_dkv_plain(*args),
                       kernel_bound_ms(8 * mm, 3 * qb + 4 * kvb + lseb)),
                "K5": (lambda: fa.flash_attention_bwd_dq(*args),
                       lambda: fa.flash_attention_bwd_dq_plain(*args),
                       kernel_bound_ms(6 * mm, 4 * qb + 2 * kvb + lseb))}
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            sdpa_fwd = event_ms(lambda: sdpa(qt, kt, vt))
            qg, kg, vg = (x.detach().requires_grad_(True) for x in (qt, kt, vt))
            dot = do.transpose(1, 2)
            sdpa_fb = event_ms(lambda: torch.autograd.grad(sdpa(qg, kg, vg), (qg, kg, vg), dot))
            del qg, kg, vg
            for kname, (kern, plain, (bound, by)) in runs.items():
                rec = dict(max_abs_err=err[kname], ms=event_ms(kern),
                           plain_ms=event_ms(plain, iters=1, warmup=0), bound_ms=bound,
                           bound_by=by, library_ms=sdpa_fwd if kname == "K3" else None,
                           shape=f"{q_shape}x{kv_shape}")
                if kname != "K3":   # SDPA's backward computes dq, dk and dv in one call
                    rec["sdpa_bwd_ms"] = sdpa_fb - sdpa_fwd
                out[kname][sname] = rec
                log("kernels", case=f"{kname} {sname} timing", **rec)
                torch.cuda.empty_cache()
            del q, k, v, do, o_ref, lse_ref, args, runs
            torch.cuda.empty_cache()
    if torch.bfloat16 in dtypes:
        _training_edges(gen, scale, lse_tol)
    return out


# The Hopper K3/K4/K5 tiles: K3 takes 128 q rows per CTA and walks 128-key tiles, K4 takes
# 128 keys per CTA and walks 64-row q tiles, K5 takes 128 q rows per CTA and walks 64-key
# tiles. Sq and Skv of 127 and 129 (B = 2) leave ragged tiles at every batch row's end;
# Skv = 40 leaves K4's second consumer warpgroup with no key and K3's and K5's only key
# tile short.
BWD_EDGES = tuple(shape for shape, _ in EDGES) + ((129, 40),)


def _training_edges(gen, scale, lse_tol):
    """K3 (o, lse), K4 (dk, dv) and K5 (dq) in bf16 against their plain versions at
    BWD_EDGES, K4/K5 with the plain forward's o and lse, to two bf16 ulps of the largest
    |ref| and the bias check (lse to lse_tol); then K3 with q and k x8 at 1000x777, whose
    logits (|s*scale| up to ~200) make the running max climb over the tiles, so alpha
    rescales l and acc by factors far from 1."""
    from goal_force_tpu_torch.ops import flash_attention as fa

    def k3(q, k, v, case):
        (o, lse), n = picked(lambda: fa.flash_attention_fwd_lse(q, k, v, scale))
        check(n == only(K3=1), f"K3 {case} launched {n}")
        o_ref, lse_ref = fa.flash_attention_fwd_lse_plain(q, k, v, scale)
        compare(f"K3 o {case}", o, o_ref, atol=bf16_limit(o_ref), rtol=0.0)
        compare(f"K3 lse {case}", lse, lse_ref, **lse_tol)
        return o_ref, lse_ref

    for sq, skv in BWD_EDGES:
        q, do = (_rand((2, sq, 2, 128), gen, torch.bfloat16) for _ in range(2))
        k, v = (_rand((2, skv, 2, 128), gen, torch.bfloat16) for _ in range(2))
        case = f"edge (2,{sq},2,128)x(2,{skv},2,128) bf16"
        o, lse = k3(q, k, v, case)
        (dk, dv), n = picked(lambda: fa.flash_attention_bwd_dkv(q, k, v, o, do, lse, scale))
        dq, n5 = picked(lambda: fa.flash_attention_bwd_dq(q, k, v, o, do, lse, scale))
        check(n == only(K4=1) and n5 == only(K5=1), f"K4/K5 {case} launched {n} / {n5}")
        dk_ref, dv_ref = fa.flash_attention_bwd_dkv_plain(q, k, v, o, do, lse, scale)
        dq_ref = fa.flash_attention_bwd_dq_plain(q, k, v, o, do, lse, scale)
        for name, got, ref in (("K4 dk", dk, dk_ref), ("K4 dv", dv, dv_ref), ("K5 dq", dq, dq_ref)):
            compare(f"{name} {case}", got, ref, atol=bf16_limit(ref), rtol=0.0)
    q, k, v = (_rand(s, gen, torch.bfloat16, m) for s, m in (((1, 1000, 4, 128), 8.0),
                                                            ((1, 777, 4, 128), 8.0),
                                                            ((1, 777, 4, 128), 1.0)))
    k3(q, k, v, "x8 (1,1000,4,128)x(1,777,4,128) bf16")


PEAK_INT8_OPS = 1979e12         # H100 SXM dense int8 tensor-core peak (data sheet)


def int8_attention_bound_ms(q_shape, kv_shape, bq, bk):
    """Least time for one K6 call: the larger of (int8 q and k codes, their scales and bf16
    v read once, bf16 o written once) / HBM rate and 2*B*N*Sq*Skv*H int8 operations at the
    int8 peak plus as many bf16 FLOP at the bf16 peak (both on the tensor cores)."""
    b, sq, n, h = q_shape
    skv = kv_shape[1]
    nbytes = (b * sq * n * h * (1 + 2) + b * skv * n * h * (1 + 2)
              + 4 * b * n * (-(-sq // bq) + -(-skv // bk)))
    mm = 2 * b * n * sq * skv * h
    t_ops = (mm / PEAK_INT8_OPS + mm / PEAK_BF16_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _int8_kernels(dtypes=(torch.float32, torch.bfloat16), timed=True):
    """K6 against its plain version on the same int8 codes and tile scales (quantize_tiles
    runs once and feeds both): 1000x777 with quantization tiles of 128 and of 300 (a tile
    boundary inside a 16-row fragment and inside a 128-key tile) and the tile edges of
    EDGES with tiles of 128 and 300 (clamped to S) in float32 and bf16, then the main
    path's self (tiles 1024/1024) and cross (1024/512) shapes in bf16; times K6,
    the quantize step, the plain version and SDPA (a yardstick only) at the path shapes."""
    from goal_force_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator("cuda").manual_seed(5678)
    scale = 128**-0.5
    # float32: the same integer logits and float32 arithmetic in another order (online vs
    # whole-row max, expf vs torch.exp): 2e-5 as for K1/K2. bf16: two ulps at the largest
    # |o| (bf16_limit) plus the mean signed error check of compare().
    f32_tol = dict(atol=2e-5, rtol=2e-5)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cases = [("1000x777 tiles 128", (1, 1000, 4, 128), (1, 777, 4, 128), 128),
             ("1000x777 tiles 300", (1, 1000, 4, 128), (1, 777, 4, 128), 300)]
    cases += [(f"edge {sq}x{skv} tiles {block}", (2, sq, 2, 128), (2, skv, 2, 128), block)
              for (sq, skv), _ in EDGES for block in (128, 300)]
    path = [("self", SELF, SELF, 1024), ("cross", SELF, CROSS_KV, 1024)]
    out = {}
    for dtype in dtypes:
        tag = str(dtype).split(".")[-1]
        for name, q_shape, kv_shape, block in cases + (path if dtype == torch.bfloat16 else []):
            q, k, v = _rand(q_shape, gen, dtype), _rand(kv_shape, gen, dtype), _rand(kv_shape, gen, dtype)
            bq, bk = fa.int8_blocks(q_shape[1], kv_shape[1], block, block)
            qi, sqs = fa.quantize_tiles(q, bq)
            ki, sks = fa.quantize_tiles(k, bk)
            got, n = picked(lambda: fa.flash_attention_int8_codes(qi, sqs, ki, sks, v, scale, bq, bk))
            check(n == only(K6=1), f"K6 {name} {tag} launched {n}")
            ref = fa._int8_plain(qi, sqs, ki, sks, v, scale, bq, bk)
            tol = f32_tol if dtype == torch.float32 else dict(atol=bf16_limit(ref), rtol=0.0)
            err = compare(f"K6 {name} {tag} {q_shape}x{kv_shape} tiles {bq}/{bk}", got, ref, **tol)
            del got, ref
            torch.cuda.empty_cache()
            if not timed or name not in ("self", "cross"):
                continue
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            bound, by = int8_attention_bound_ms(q_shape, kv_shape, bq, bk)
            rec = dict(max_abs_err=err,
                       ms=event_ms(lambda: fa.flash_attention_int8_codes(qi, sqs, ki, sks, v,
                                                                         scale, bq, bk)),
                       quantize_ms=event_ms(lambda: (fa.quantize_tiles(q, bq),
                                                     fa.quantize_tiles(k, bk))),
                       plain_ms=event_ms(lambda: fa.flash_attention_int8_plain(
                           q, k, v, scale, block, block), iters=1, warmup=0),
                       bound_ms=bound, bound_by=by, library_ms=None,
                       sdpa_bf16_ms=event_ms(lambda: sdpa(qt, kt, vt)),
                       shape=f"{q_shape}x{kv_shape}", tiles=[bq, bk])
            out[name] = rec
            log("kernels", case=f"K6 {name} timing", **rec)
            del q, k, v, qi, ki, qt, kt, vt
            torch.cuda.empty_cache()
    return {"K6": out}


def _request_inputs(seed, num_frames, height, width, pipe_cfg):
    from goal_force_tpu_torch.data import ControlSpec, render_control_video

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    base = np.stack([xx / width, yy / height, 0.5 + 0.5 * np.sin(xx / 37.0 + seed)], -1)
    image = np.clip(base + 0.05 * rng.standard_normal((height, width, 3)), 0, 1).astype(np.float32)
    spec = ControlSpec(
        force=float(rng.uniform(60, 380)), angle_deg=float(rng.uniform(0, 360)),
        x_pos=float(rng.uniform(0.2, 0.8)), y_pos=float(rng.uniform(0.2, 0.8)),
        target_force=float(rng.uniform(60, 380)), target_angle_deg=float(rng.uniform(0, 360)),
        target_x_pos=float(rng.uniform(0.2, 0.8)), target_y_pos=float(rng.uniform(0.2, 0.8)),
        projectile_mass=float(rng.uniform(1, 4)),
        projectile_xy_px=(float(rng.uniform(0, width)), float(rng.uniform(0, height))),
        target_mass=float(rng.uniform(1, 4)),
        target_xy_px=(float(rng.uniform(0, width)), float(rng.uniform(0, height))))
    video = render_control_video(spec, num_frames, height, width, pipe_cfg.min_force,
                                 pipe_cfg.max_force, pipe_cfg.min_mass, pipe_cfg.max_mass,
                                 rng=rng)
    return image, video


def phase_small():
    """head_dim-128 pipeline small enough for plain attention: kernels vs plain, fp32."""
    from goal_force_tpu_torch import configs as C
    from goal_force_tpu_torch.ops import flash_attention as fa
    from goal_force_tpu_torch.pipelines.goal_force import GoalForcePipeline

    dit_cfg, t5_cfg, vae_cfg, cn_cfg = _small_configs()
    pipe = GoalForcePipeline.init_random(seed=5, dit_cfg=dit_cfg, t5_cfg=t5_cfg, vae_cfg=vae_cfg,
                                         cn_cfg=cn_cfg, dtype=torch.float32, device="cuda")
    for cn in ("controlnet", "controlnet2"):   # non-identity ControlNets
        for zc in pipe.models[cn].controlnet_zero_convs_after:
            zc.weight.normal_(generator=torch.Generator("cuda").manual_seed(9)).mul_(0.02)
    image, video = _request_inputs(1, 17, 128, 256, pipe.pipe_cfg)
    kw = dict(seed=2, num_frames=17, num_inference_steps=4)
    # One merged-CFG step: the velocity through the kernels vs through plain attention.
    ctx = pipe.encode_prompts(["a small check", pipe.pipe_cfg.negative_prompt])
    y = pipe.encode_first_frame(image, 17)
    cl = pipe.encode_control_video(video)
    lat = torch.randn((1, 5, 16, 32, vae_cfg.z_dim), generator=torch.Generator("cuda").manual_seed(4),
                      device="cuda")
    step = lambda: pipe.denoise_step(pipe.models["dit"], pipe.models["controlnet"], lat, 1000.0,
                                     1.0, 0.9375, ctx, y, cl, pipe.pipe_cfg.cfg_scale)
    fa.reset_launch_counts()
    got_step = step()
    n_step = dict(fa.launch_counts)
    pipe.attn_impl = "plain"
    step_err = float((got_step - step()).abs().max())
    pipe.attn_impl = "auto"
    # The whole request, 4 steps + VAE decode, with float32 convs in full float32: TF32
    # rounds conv inputs to 10 mantissa bits, so a 1e-7 difference in the latents can
    # flip a rounding and surface in the frames as ~1e-3. The TF32 run is logged only.
    tf32_before = torch.backends.cudnn.allow_tf32

    def request(impl, cudnn_tf32):
        pipe.attn_impl = impl
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
        try:
            return pipe("a small check", image, control_signal_video=video, **kw)
        finally:
            pipe.attn_impl = "auto"
            torch.backends.cudnn.allow_tf32 = tf32_before

    fa.reset_launch_counts()
    got = request("auto", False)
    n = dict(fa.launch_counts)
    ref = request("plain", False)
    err = float(np.abs(got - ref).max())
    rerun = float(np.abs(ref - request("plain", False)).max())
    tf32_err = float(np.abs(request("auto", True) - request("plain", True)).max())
    # Both limits: float32 attention with another summation order (~1e-6 relative).
    log("small", tokens=5 * 8 * 16, step_launches=n_step, step_max_abs_err=step_err,
        step_atol=1e-4, launches=n, frames_max_abs_err=err, frames_atol=1e-3,
        plain_rerun_max_abs_diff=rerun, cudnn_tf32_frames_max_abs_err=tf32_err,
        ok=step_err <= 1e-4 and err <= 1e-3)
    check(n_step == only(K1=6) and n == only(K1=2 * (2 + 1) * 4),
          f"small path launched {n_step} / {n}")
    check(step_err <= 1e-4, f"small path: one step differs by {step_err}")
    check(err <= 1e-3, f"small path: kernels vs plain attention differ by {err}")
    del pipe
    torch.cuda.empty_cache()


def _instrument(pipe, stage_times):
    """Wrap the pipeline's stages so each appends (name, synchronised seconds)."""
    def timed(name, fn):
        def run(*a, **k):
            out, s = sync_time(lambda: fn(*a, **k))
            stage_times.append((name, s))
            return out
        return run

    pipe.encode_prompts = timed("t5", pipe.encode_prompts)
    pipe.encode_first_frame = timed("vae_encode_first_frame", pipe.encode_first_frame)
    pipe.encode_control_video = timed("vae_encode_control", pipe.encode_control_video)
    pipe._vae_decode_full = timed("vae_decode", pipe._vae_decode_full)
    real_step = pipe.denoise_step

    def step(*a, **k):
        n_steps = sum(name.startswith("step") for name, _ in stage_times)
        return timed(f"step{n_steps}", real_step)(*a, **k)

    pipe.denoise_step = step


def _uninstrument(pipe):
    for name in ("encode_prompts", "encode_first_frame", "encode_control_video",
                 "_vae_decode_full", "denoise_step"):
        pipe.__dict__.pop(name, None)


PROMPTS = ("a red ball rolls across a wooden table and hits a blue cup",
           "a marble is flicked towards a stack of dominoes")


def _serve(pipe, phase, per_request, seeds=(11, 22), steps=STEPS):
    """Answer one request per seed with the stages timed; checks each request's frames
    and that it launched exactly `per_request` (a launch-count dict). The counts are set
    to 0 just before the first request; returns the frames and the counts of the run."""
    from goal_force_tpu_torch.ops import flash_attention as fa

    pc = pipe.pipe_cfg
    stage_times = []
    _instrument(pipe, stage_times)
    outputs = []
    fa.reset_launch_counts()
    try:
        for r, seed in enumerate(seeds):
            image, video = _request_inputs(seed, pc.num_frames, pc.height, pc.width, pc)
            stage_times.clear()
            before = dict(fa.launch_counts)
            frames, total = sync_time(lambda: pipe(PROMPTS[r % 2], image,
                                                   control_signal_video=video, seed=seed,
                                                   num_inference_steps=steps))
            counts = {k: fa.launch_counts[k] - before[k] for k in before}
            check(frames.shape == (pc.num_frames, pc.height, pc.width, 3),
                  f"{phase} request {r}: frames shape {frames.shape}")
            check(bool(np.isfinite(frames).all()), f"{phase} request {r}: non-finite frames")
            check(frames.min() >= 0.0 and frames.max() <= 1.0,
                  f"{phase} request {r}: frames outside [0, 1]")
            check(counts == per_request,
                  f"{phase} request {r}: launch counts {counts}, expected {per_request}")
            log(phase, stage=f"request{r}", seconds=total, stages=dict(stage_times),
                launches=counts, frames_mean=float(frames.mean()), frames_std=float(frames.std()))
            outputs.append(frames)
    finally:
        _uninstrument(pipe)
    run_counts = dict(fa.launch_counts)
    if len(outputs) > 1:
        diff = float(np.abs(outputs[0] - outputs[1]).mean())
        check(diff > 1e-3, f"{phase}: the two requests gave the same frames (mean |diff| {diff})")
        log(phase, stage="between_requests", mean_abs_diff=diff)
    return outputs, run_counts


def phase_main():
    from goal_force_tpu_torch import configs as C
    from goal_force_tpu_torch.pipelines.goal_force import GoalForcePipeline

    dit_cfg = dataclasses.replace(C.WAN22_A14B, num_layers=4)
    t5_cfg = dataclasses.replace(C.UMT5_XXL, num_layers=2)
    cn_cfg = C.ControlNetConfig(num_layers=2, in_channels=C.WAN21_VAE.z_dim)
    pipe, secs = sync_time(lambda: GoalForcePipeline.init_random(
        seed=0, dit_cfg=dit_cfg, t5_cfg=t5_cfg, vae_cfg=C.WAN21_VAE, cn_cfg=cn_cfg,
        dtype=torch.bfloat16, device="cuda"))
    n_params = {k: sum(p.numel() for p in m.parameters()) for k, m in pipe.models.items()}
    log("main", stage="init", seconds=secs, params=n_params, tokens=pipe.pipe_cfg.tokens,
        memory_gb=torch.cuda.memory_allocated() / 2**30)
    torch.cuda.reset_peak_memory_stats()
    frames, launches = _serve(pipe, "main", only(K1=K1_PER_REQUEST))
    log("main", stage="done", launches=launches,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 2**30)
    return pipe, launches, frames


QPATHS = ("self_attn", "cross_attn", "ffn")     # the block linears JAX quantizes
FP8_LINEAR_RTOL = 2e-3    # the card's fp8 sums of 5120 products: 1.2e-4 measured
QUANTIZED = ("dit", "dit2", "controlnet", "controlnet2")
K6_PER_STEP = 2 * (4 + 2)                       # self + cross per DiT and ControlNet block


def _quantize(models, kind="int8"):
    from goal_force_tpu_torch.ops import quant

    for name in QUANTIZED:
        quant.quantize_linear_modules(models[name], QPATHS, kind)


class _PlainInt8:
    """Within the block, ``flash_attention_int8`` computes its plain version on CUDA
    tensors too (the same function without K6), for a path-level comparison."""

    def __enter__(self):
        from goal_force_tpu_torch.ops import flash_attention as fa

        self.fa, self.saved = fa, fa.flash_attention_int8
        fa.flash_attention_int8 = fa.flash_attention_int8_plain

    def __exit__(self, *exc):
        self.fa.flash_attention_int8 = self.saved


def _check_linears():
    """The packs' library products on the card against the same function with the code
    product computed another way: the int8 pack against itself on the CPU (the int32 sum
    is exact and the epilogue is the same float32 arithmetic: 1e-6 of the largest output),
    the fp8 pack against its code product in float64 on the card (the e4m3 products are
    exact; what differs is how many bits the tensor cores keep of the float32 sum of 5120
    of them, logged)."""
    from goal_force_tpu_torch.ops import quant

    gen = torch.Generator().manual_seed(8)
    lin = torch.nn.Linear(5120, 1024)
    with torch.no_grad():
        lin.weight.normal_(generator=gen).mul_(0.02)
        lin.bias.normal_(generator=gen)
    x = torch.randn((2, 50, 5120), generator=gen)
    f64 = lambda xq, wq: (xq.double() @ wq.double().t()).float()
    res = {}
    for kind, cls in quant.PACKS.items():
        for rows in (50, 8):            # 100 rows, and 16 rows (padded for torch._int_mm)
            pack = cls.from_linear(lin)
            if kind == "int8":
                ref = pack(x[:, :rows]).cuda()
            got = pack.to("cuda")(x[:, :rows].cuda())
            if kind == "fp8":
                saved, quant._matmul_codes = quant._matmul_codes, f64
                try:
                    ref = pack(x[:, :rows].cuda())
                finally:
                    quant._matmul_codes = saved
            err = float((got - ref).abs().max() / ref.abs().max())
            lim = 1e-6 if kind == "int8" else FP8_LINEAR_RTOL
            res[f"{kind} rows {2 * rows}"] = err
            check(err <= lim, f"{kind} linear on the card: error {err} (> {lim})")
    log("small_int8", case="linears on the card (max err / max |out|)", **res, ok=True)


def phase_small_int8():
    """The small head_dim-128 float32 pipeline with W8A8 packs in its four DiT/ControlNet
    models: one merged-CFG step and a whole request through K6 against the same with the
    plain int8 attention (the same function), and the launches (K6 only)."""
    from goal_force_tpu_torch.ops import flash_attention as fa
    from goal_force_tpu_torch.pipelines.goal_force import GoalForcePipeline

    _check_linears()
    dit_cfg, t5_cfg, vae_cfg, cn_cfg = _small_configs()
    pipe = GoalForcePipeline.init_random(seed=5, dit_cfg=dit_cfg, t5_cfg=t5_cfg, vae_cfg=vae_cfg,
                                         cn_cfg=cn_cfg, dtype=torch.float32, device="cuda")
    for cn in ("controlnet", "controlnet2"):   # non-identity ControlNets
        _perturb_zero_convs(pipe.models[cn], 9)
    _quantize(pipe.models)
    pipe.attn_impl = "flash_int8"
    image, video = _request_inputs(1, 17, 128, 256, pipe.pipe_cfg)
    ctx = pipe.encode_prompts(["a small check", pipe.pipe_cfg.negative_prompt])
    y = pipe.encode_first_frame(image, 17)
    cl = pipe.encode_control_video(video)
    lat = torch.randn((1, 5, 16, 32, vae_cfg.z_dim), generator=torch.Generator("cuda").manual_seed(4),
                      device="cuda")
    step = lambda: pipe.denoise_step(pipe.models["dit"], pipe.models["controlnet"], lat, 1000.0,
                                     1.0, 0.9375, ctx, y, cl, pipe.pipe_cfg.cfg_scale)
    got_step, n_step = picked(step)
    with _PlainInt8():
        ref_step, n_plain = picked(step)
    tf32_before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False        # float32 convs in full float32, as in small
    try:
        kw = dict(seed=2, num_frames=17, num_inference_steps=4)
        got, n = picked(lambda: pipe("a small check", image, control_signal_video=video, **kw))
        with _PlainInt8():
            ref = pipe("a small check", image, control_signal_video=video, **kw)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32_before
    # the step's velocity, from the Euler update latents + (0.9375 - 1.0) * v
    v_got, v_ref = ((out - lat) / (0.9375 - 1.0) for out in (got_step, ref_step))
    top = float(v_ref.abs().max())
    step_err = dict(max=float((v_got - v_ref).abs().max()),
                    mean=float((v_got - v_ref).abs().mean()))
    err = dict(max=float(np.abs(got - ref).max()), mean=float(np.abs(got - ref).mean()))
    # K6 and the plain version give the same attention to float32 rounding (~1e-6); an
    # activation that lands that close to a rounding boundary of the next linear's int8
    # quantization takes the neighbouring code, which moves that token's output by one
    # code step: at most 1/127 of the largest output the linear can give. The bounds are
    # those of the CPU tests that hold the port to JAX (tests/test_torch_lowp.py): one
    # step's velocity within one code step of its largest value, and frames, whose later
    # steps flip codes of their own, within 3e-2 (2e-3 on average).
    step_ok = step_err["max"] <= top / 127
    frames_ok = err["max"] <= 3e-2 and err["mean"] <= 2e-3
    log("small_int8", tokens=5 * 8 * 16, step_launches=n_step, plain_step_launches=n_plain,
        velocity_abs_err=step_err, velocity_limit=top / 127,
        launches=n, frames_abs_err=err, frames_limits=dict(max=3e-2, mean=2e-3),
        ok=step_ok and frames_ok)
    check(n_step == only(K6=6) and n == only(K6=2 * (2 + 1) * 4) and n_plain == only(),
          f"small_int8 launched {n_step} / {n} / plain {n_plain}")
    check(step_ok, f"small_int8: one step differs by {step_err}")
    check(frames_ok, f"small_int8: K6 vs plain int8 attention frames differ by {err}")
    del pipe
    torch.cuda.empty_cache()


def phase_main_int8(pipe, bf16_frames):
    """main's pipeline quantized in place (W8A8 block linears of the four DiT/ControlNet
    models) with attn_impl="flash_int8": the same two requests, 48 K6 and nothing else
    each, and the mean |frames - bf16 frames| of the same request."""
    import gc

    (_, secs) = sync_time(lambda: _quantize(pipe.models))
    gc.collect()
    torch.cuda.empty_cache()
    n_params = {k: sum(t.numel() for t in m.state_dict().values()) for k, m in pipe.models.items()}
    log("main_int8", stage="quantize", seconds=secs, tensors=n_params,
        memory_gb=torch.cuda.memory_allocated() / 2**30)
    pipe.attn_impl = "flash_int8"
    torch.cuda.reset_peak_memory_stats()
    try:
        frames, launches = _serve(pipe, "main_int8", only(K6=K6_PER_STEP * STEPS))
    finally:
        pipe.attn_impl = "auto"
    vs_bf16 = [float(np.abs(a - b).mean()) for a, b in zip(frames, bf16_frames)]
    max_vs_bf16 = [float(np.abs(a - b).max()) for a, b in zip(frames, bf16_frames)]
    between = float(np.abs(bf16_frames[0] - bf16_frames[1]).mean())
    # The quality bound against bf16: each request's int8 frames stay far closer to the
    # bf16 frames of the same request than two requests' frames are to each other.
    ok = max(vs_bf16) <= 0.1 * between
    log("main_int8", stage="done", launches=launches,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 2**30,
        mean_abs_diff_vs_bf16=vs_bf16, max_abs_diff_vs_bf16=max_vs_bf16,
        bf16_mean_abs_diff_between_requests=between, limit=0.1 * between, ok=ok)
    check(ok, f"main_int8: frames differ from bf16's by {vs_bf16} on average")
    return launches


def phase_full_int8():
    """Full A14B depth on one card: 40 DiT + 10 ControlNet layers per expert, the full
    24-layer umt5-xxl and the full Wan2.1 VAE, bf16 with W8A8 block linears and K6. Each
    expert is built in bf16, its ControlNet copied from it, and both quantized before the
    next expert is built. One 81x480x832 request of 2 steps: sigma 1.0 -> 0.833, so the
    steps run t = 1000 (high-noise expert) and t = 833 (low-noise expert)."""
    import gc

    from goal_force_tpu_torch import configs as C
    from goal_force_tpu_torch.models import controlnet as cnm
    from goal_force_tpu_torch.models import t5 as t5m
    from goal_force_tpu_torch.models import vae as vaem
    from goal_force_tpu_torch.models import wan_dit
    from goal_force_tpu_torch.models.tokenizer import load_tokenizer
    from goal_force_tpu_torch.ops import quant
    from goal_force_tpu_torch.pipelines.goal_force import GoalForcePipeline

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dit_cfg, t5_cfg, vae_cfg = C.WAN22_A14B, C.UMT5_XXL, C.WAN21_VAE
    cn_cfg = C.ControlNetConfig(num_layers=10, in_channels=vae_cfg.z_dim)
    gen = torch.Generator("cuda").manual_seed(0)
    t0 = time.perf_counter()
    models = {}
    for dit_name, cn_name in (("dit", "controlnet"), ("dit2", "controlnet2")):
        models[dit_name] = wan_dit.init_wan_dit(dit_cfg, gen, torch.bfloat16, device="cuda")
        models[cn_name] = cnm.init_from_dit(models[dit_name], dit_cfg, cn_cfg, gen,
                                            torch.bfloat16, device="cuda")
        bf16_gb = torch.cuda.memory_allocated() / 2**30
        for name in (dit_name, cn_name):
            quant.quantize_linear_modules(models[name], QPATHS, "int8")
        torch.cuda.synchronize()
        log("full_int8", stage=f"init {dit_name}+{cn_name}", memory_with_bf16_pair_gb=bf16_gb,
            memory_gb=torch.cuda.memory_allocated() / 2**30,
            seconds=time.perf_counter() - t0)
    models["t5"] = t5m.init_t5(t5_cfg, gen, torch.bfloat16, device="cuda")
    models["vae"] = vaem.init_vae(vae_cfg, gen, torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pipe = GoalForcePipeline(dit_cfg, t5_cfg, vae_cfg, cn_cfg, C.PipelineConfig(), models,
                             load_tokenizer(None, t5_cfg.vocab, t5_cfg.text_len),
                             torch.bfloat16, torch.device("cuda"), attn_impl="flash_int8")
    gb = {k: sum(t.numel() * t.element_size() for t in m.state_dict().values()) / 1e9
          for k, m in models.items()}
    log("full_int8", stage="init", seconds=init_s, weights_gb=gb,
        memory_gb=torch.cuda.memory_allocated() / 2**30,
        init_peak_gb=torch.cuda.max_memory_allocated() / 2**30)
    torch.cuda.reset_peak_memory_stats()
    per_step = (dit_cfg.num_layers + cn_cfg.num_layers) * 2
    frames, launches = _serve(pipe, "full_int8", only(K6=2 * per_step), seeds=(11,), steps=2)
    log("full_int8", stage="done", launches=launches, k6_per_step=per_step,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 2**30)
    del pipe, models, frames
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_unbounded(pipe):
    """qk_bounded=False with q-norm weights x8: the runtime bound exceeds 100 for
    self-attention (K2) and stays small for cross-attention (K1 without clamp)."""
    from goal_force_tpu_torch.ops import flash_attention as fa

    pc = pipe.pipe_cfg
    saved_cfg = pipe.dit_cfg
    pipe.dit_cfg = dataclasses.replace(saved_cfg, qk_bounded=False)
    blocks = list(pipe.models["dit"].blocks) + list(pipe.models["controlnet"].controlnet_dit.blocks)
    for blk in blocks:
        blk.self_attn.norm_q.weight.mul_(8)
    try:
        gen = torch.Generator("cuda").manual_seed(3)
        lat = torch.randn((1, pc.latent_frames, pc.latent_height, pc.latent_width, 16),
                          generator=gen, device="cuda").to(pipe.dtype)
        image, video = _request_inputs(33, pc.num_frames, pc.height, pc.width, pc)
        ctx = pipe.encode_prompts(["a ball", pc.negative_prompt])
        y = pipe.encode_first_frame(image, pc.num_frames)
        cl = pipe.encode_control_video(video)
        fa.reset_launch_counts()
        out, secs = sync_time(lambda: pipe.denoise_step(
            pipe.models["dit"], pipe.models["controlnet"], lat, 1000.0, 1.0, 0.9375,
            ctx, y, cl, pc.cfg_scale))
        launches = dict(fa.launch_counts)
    finally:
        for blk in blocks:
            blk.self_attn.norm_q.weight.div_(8)
        pipe.dit_cfg = saved_cfg
    check(tuple(out.shape) == tuple(lat.shape) and bool(torch.isfinite(out.float()).all()),
          "unbounded step: bad output")
    check(launches == only(K1=6, K2=6), f"unbounded step launched {launches}")
    log("unbounded", seconds=secs, launches=launches)
    return launches


def _small_configs():
    """The small phases' configs: a head_dim-128 DiT (2 heads) over the tiny T5/VAE/CN."""
    from goal_force_tpu_torch import configs as C

    _, t5_cfg, vae_cfg, cn_cfg = C.tiny_pipeline_configs()
    dit_cfg = C.WanDiTConfig(dim=256, in_dim=2 * vae_cfg.z_dim + 4, ffn_dim=512,
                             out_dim=vae_cfg.z_dim, text_dim=t5_cfg.dim, freq_dim=32,
                             num_heads=2, num_layers=2, rope_max_len=64)
    return dit_cfg, t5_cfg, vae_cfg, cn_cfg


def _perturb_zero_convs(cn, seed):
    """N(0, 0.02) zero convs, seeded: at their zero init the ControlNet blocks get exactly
    zero gradient and add nothing, so a check could not see them."""
    gen = torch.Generator("cuda").manual_seed(seed)
    with torch.no_grad():
        for zc in cn.controlnet_zero_convs_after:
            zc.weight.copy_(torch.randn(zc.weight.shape, generator=gen, device="cuda") * 0.02)
            zc.bias.copy_(torch.randn(zc.bias.shape, generator=gen, device="cuda") * 0.02)


def phase_small_train():
    """One training_loss + backward at the small head_dim-128 float32 config (640
    tokens), with nonzero zero convs: the kernels (K3/K4/K5 under grad, K1 for DiT block
    0) against plain attention, for the loss and every ControlNet gradient."""
    from goal_force_tpu_torch.models import controlnet as cnm
    from goal_force_tpu_torch.models import wan_dit
    from goal_force_tpu_torch.ops import flash_attention as fa
    from goal_force_tpu_torch.training import train_step as tts

    dit_cfg, t5_cfg, vae_cfg, cn_cfg = _small_configs()
    gen = torch.Generator("cuda").manual_seed(6)
    dit = wan_dit.init_wan_dit(dit_cfg, gen, torch.float32, device="cuda")
    cn = cnm.init_from_dit(dit, dit_cfg, cn_cfg, gen, torch.float32, device="cuda",
                           requires_grad=True)
    _perturb_zero_convs(cn, 9)
    z, (f, h, w) = vae_cfg.z_dim, (5, 16, 32)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    inputs = dict(x0=rnd(1, f, h, w, z), noise=rnd(1, f, h, w, z), sigma=0.93,
                  timestep=torch.full((1,), 930.0, device="cuda"), weight=1.7,
                  context=rnd(1, t5_cfg.text_len, t5_cfg.dim), y=rnd(1, f, h, w, 4 + z),
                  control_latents=rnd(1, f, h, w, z))
    params = tts.trainable_params(cn)

    def loss_and_grads(impl):
        loss = tts.training_loss(dit, cn, dit_cfg, cn_cfg, **inputs, attn_impl=impl)
        return float(loss.detach()), torch.autograd.grad(loss, list(params.values()))

    (loss, grads), n = picked(lambda: loss_and_grads("auto"))
    ref_loss, ref_grads = loss_and_grads("plain")
    # float32 on both sides with another summation order (~1e-6 relative): the loss to
    # 1e-5 relative, each gradient to 1e-4 of that parameter's largest gradient.
    rel = {name: float((g - r).abs().max() / r.abs().max().clamp(min=1e-30))
           for name, g, r in zip(params, grads, ref_grads)}
    worst = max(rel, key=rel.get)
    loss_rel = abs(loss - ref_loss) / abs(ref_loss)
    expected = only(K1=2, K3=8, K4=3, K5=4)
    log("small_train", tokens=f * (h // 2) * (w // 2), loss=loss, plain_loss=ref_loss,
        loss_rel_err=loss_rel, loss_rtol=1e-5, worst_param=worst, worst_grad_rel_err=rel[worst],
        grad_rtol=1e-4, launches=n, expected_launches=expected,
        nonzero_block_grads=all(float(g.abs().max()) > 0 for g in grads))
    check(loss_rel <= 1e-5, f"small_train: loss {loss} vs plain {ref_loss}")
    check(rel[worst] <= 1e-4, f"small_train: gradient of {worst} off by {rel[worst]}")
    check(all(float(g.abs().max()) > 0 for g in grads), "small_train: a zero gradient")
    # DiT block 0 needs no gradient (K1 x2); the ControlNet block and DiT block 1 make 4
    # grad-requiring calls, each run forward twice (remat): K3 8, K5 4, K4 3 (DiT block
    # 1's cross-attention keys come from the frozen text path).
    check(n == expected, f"small_train launched {n}, expected {expected}")
    del dit, cn, grads, ref_grads
    torch.cuda.empty_cache()


class _SyntheticClips:
    """Training samples at the pipeline's size: a drifting gradient image as the video
    and a control video rendered by render_control_video, made from each index's seed."""

    def __init__(self, n, pipe_cfg):
        self.n, self.pc = n, pipe_cfg

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        pc = self.pc
        image, control = _request_inputs(100 + i, pc.num_frames, pc.height, pc.width, pc)
        video = np.stack([np.roll(image, 4 * t, axis=1) for t in range(pc.num_frames)])
        return {"video": video, "control_video": control,
                "prompt": f"a ball is pushed across the table, clip {i}"}


def phase_train():
    """ControlNet training at full WAN22_A14B width (4 DiT + 2 ControlNet layers, umt5 at
    2 layers, the full Wan2.1 VAE), bf16, B = 1, 81x480x832: two steps, a checkpoint at
    step 2, a full-state resume and a third step. The zero convs start at N(0, 0.02)
    (seeded) instead of 0, so the ControlNet blocks get a gradient at step 1."""
    import gc
    import shutil
    import tempfile

    from goal_force_tpu_torch import configs as C
    from goal_force_tpu_torch.io import safetensors_io as sio
    from goal_force_tpu_torch.models import controlnet as cnm
    from goal_force_tpu_torch.models import t5 as t5m
    from goal_force_tpu_torch.models import vae as vaem
    from goal_force_tpu_torch.models import wan_dit
    from goal_force_tpu_torch.models.tokenizer import load_tokenizer
    from goal_force_tpu_torch.ops import flash_attention as fa
    from goal_force_tpu_torch.training.trainer import TrainerConfig, train

    gc.collect()
    torch.cuda.empty_cache()
    dit_cfg = dataclasses.replace(C.WAN22_A14B, num_layers=4)
    t5_cfg = dataclasses.replace(C.UMT5_XXL, num_layers=2)
    cn_cfg = C.ControlNetConfig(num_layers=2, in_channels=C.WAN21_VAE.z_dim)
    pc = C.PipelineConfig()
    gen = torch.Generator("cuda").manual_seed(0)
    frozen = {"dit": wan_dit.init_wan_dit(dit_cfg, gen, torch.bfloat16, device="cuda"),
              "t5": t5m.init_t5(t5_cfg, gen, torch.bfloat16, device="cuda"),
              "vae": vaem.init_vae(C.WAN21_VAE, gen, torch.bfloat16, device="cuda")}
    cn0 = cnm.init_from_dit(frozen["dit"], dit_cfg, cn_cfg, gen, torch.bfloat16,
                            device="cuda", requires_grad=True)
    _perturb_zero_convs(cn0, 7)
    frozen_host = {k: {n: p.to("cpu", copy=True) for n, p in m.state_dict().items()}
                   for k, m in frozen.items()}
    n_params = {k: sum(p.numel() for p in m.parameters()) for k, m in
                (*frozen.items(), ("controlnet", cn0))}
    out_dir = tempfile.mkdtemp(prefix="gf_train_")
    log("train", stage="init", params=n_params, memory_gb=torch.cuda.memory_allocated() / 2**30,
        checkpoint_dir_free_gb=shutil.disk_usage(out_dir).free / 2**30)
    cfg = TrainerConfig(output_dir=out_dir, save_steps=2, log_every=1, num_epochs=1,
                        keep_last_states=1, num_frames=pc.num_frames, height=pc.height,
                        width=pc.width)
    data = _SyntheticClips(3, pc)
    tok = load_tokenizer(None, t5_cfg.vocab, t5_cfg.text_len)
    run = lambda **kw: train(cfg, dit_cfg, t5_cfg, C.WAN21_VAE, cn_cfg, frozen, cn0, data, tok,
                             device="cuda", history=history, **kw)
    history = []
    try:
        fa.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        (state2, secs2) = sync_time(lambda: run(max_steps=2))
        at_step2 = {n: p.to("cpu", copy=True) for n, p in state2.params.state_dict().items()}
        del state2
        gc.collect()
        (state3, secs3) = sync_time(lambda: run(resume=True, max_steps=1))
        launches = dict(fa.launch_counts)
        # the step's stages reset the peak counter: the run's peak is the largest of theirs
        peak_gb = max([torch.cuda.max_memory_allocated() / 2**30] +
                      [v for h in history for k, v in h.items() if k.endswith("_peak_gb")])
        for h in history:
            log("train", stage=f"step{h['step']}", **h)
        # 3 steps x (K1 2: DiT block 0; K3 20: 10 grad-requiring calls run twice under
        # remat; K5 10; K4 7: DiT blocks 1-3 cross-attention need no dk/dv).
        expected = only(K1=6, K3=60, K4=21, K5=30)
        log("train", stage="done", seconds_steps_1_2=secs2, seconds_resume_step_3=secs3,
            launches=launches, expected_launches=expected, max_memory_allocated_gb=peak_gb,
            files=sorted(os.listdir(out_dir)))
        check([h["step"] for h in history] == [1, 2, 3], f"steps run: {history}")
        check(all(math.isfinite(h["loss"]) and h["grad_norm"] > 0 for h in history),
              "train: non-finite loss or zero gradient")
        check(launches == expected, f"train launched {launches}, expected {expected}")
        for k, m in frozen.items():
            same = all(torch.equal(p.cpu(), frozen_host[k][n]) for n, p in m.state_dict().items())
            check(same, f"train: the frozen {k} changed")
        # Every ControlNet tensor got a gradient (nonzero first moment), and every tensor
        # that 3 AdamW steps of ~lr can move in bf16 moved: one with an element below
        # 2^8 * 3 * lr, where such a step exceeds half a bf16 ulp. Norm weights at
        # exactly 1.0 cannot move (half an ulp of 1.0 is 2^-8 = 3.9e-3).
        init = cn0.state_dict()
        after = state3.params.state_dict()
        no_grad = [n for n in init if not bool(state3.opt_state[f"exp_avg.{n}"].any())]
        movable = {n for n, p in init.items() if bool((p.float().abs() < 256 * 3 * cfg.lr).any())}
        moved = {n for n in init if not torch.equal(after[n], init[n])}
        check(not no_grad, f"train: ControlNet tensors without gradient: {no_grad}")
        check(movable <= moved, f"train: tensors that should move did not: {movable - moved}")
        fresh = wan_dit.empty_module(cnm.GoalForceControlNet, dit_cfg, cn_cfg,
                                     dtype=torch.bfloat16, device="cuda")
        fresh.load_state_dict(sio.load_goalforce_controlnet(os.path.join(out_dir,
                                                                         "step-2.safetensors")))
        same = all(torch.equal(p.cpu(), at_step2[n]) for n, p in fresh.state_dict().items())
        check(same, "train: step-2.safetensors does not reload to the step-2 ControlNet")
        log("train", stage="checks", frozen_unchanged=True, controlnet_tensors=len(init),
            with_gradient=len(init), movable=len(movable), changed=len(moved),
            unchanged=sorted(set(init) - moved), step2_checkpoint_reloads=True, ok=True)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return launches


def main() -> int:
    card = phase_device()
    phase_build()
    measured = phase_kernels()
    phase_small()
    phase_small_train()
    phase_small_int8()
    pipe, main_launches, bf16_frames = phase_main()
    unb_launches = phase_unbounded(pipe)
    int8_launches = phase_main_int8(pipe, bf16_frames)
    del pipe, bf16_frames
    train_launches = phase_train()
    full_launches = phase_full_int8()
    fwd = "goal_force_tpu_torch/csrc/flash_attention.cu"
    train_src = "goal_force_tpu_torch/csrc/flash_attention_bwd.cu"
    int8_src = "goal_force_tpu_torch/csrc/flash_attention_int8.cu"
    tpu = "goal_force_tpu/ops/flash_attention.py"
    kernels = []
    for name, src, line, launches, extra in (
            ("K1 flash_attention_nomax", fwd, 241, main_launches["K1"],
             {"cross": measured["K1"]["cross"]}),
            ("K2 flash_attention_max", fwd, 154, unb_launches["K2"],
             {"cross": measured["K2"]["cross"], "path": "unbounded (qk_bounded=False, q-norm x8)"}),
            ("K3 flash_attention_fwd_lse", train_src, 29, train_launches["K3"],
             {"cross": measured["K3"]["cross"], "path": "train"}),
            ("K4 flash_attention_bwd_dkv", train_src, 76, train_launches["K4"],
             {"cross": measured["K4"]["cross"], "path": "train"}),
            ("K5 flash_attention_bwd_dq", train_src, 118, train_launches["K5"],
             {"cross": measured["K5"]["cross"], "path": "train"}),
            ("K6 flash_attention_int8", int8_src, 581, int8_launches["K6"],
             {"cross": measured["K6"]["cross"], "path": "main_int8",
              "full_int8_launches": full_launches["K6"]})):
        rec = measured[name.split()[0]]["self"]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": f"{tpu}:{line}", "launches": launches,
                        **{k: rec.get(k) for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                   "bound_by", "library_ms", "shape")},
                        **{k: rec[k] for k in ("quantize_ms", "sdpa_bf16_ms") if k in rec},
                        **({"sdpa_bwd_ms": rec["sdpa_bwd_ms"]} if "sdpa_bwd_ms" in rec else {}),
                        **extra})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
