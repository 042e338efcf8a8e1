#!/usr/bin/env python3
"""Drive the PyTorch port (goal_force_tpu_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero with no result line:

1. device  - a CUDA card must be present; prints nvidia-smi's name and power limit.
2. build   - compiles goal_force_tpu_torch/csrc/*.cu with nvcc for sm_90a (one nvcc per
             source, started together) and prints each kernel's ptxas report and the
             Hopper kernels' (K1-K6) SASS instruction counts by opcode; each of them must
             hold HGMMA (wgmma) and no HMMA (mma.sync), spill nothing, and draw no ptxas
             warning that it serialized its wgmma. Then builds the native control renderer
             (goal_force_tpu_torch/native, g++; no fallback) and renders one 81x480x832
             control video with it and with numpy (equal within 1e-6).
3. kernels - holds K1/K2 against their plain torch versions on the card (small shapes,
             saturation, per-batch kv_len, both at the Hopper tiles' edges: B = 2, Sq and
             Skv of 127 and 129, and the main-path self and cross shapes), K3/K4/K5 (o and
             lse, dk and dv, dq) in float32 and bf16 at 1000x777 and at the training self
             and cross shapes, K3/K4/K5 in bf16 at their tiles' edges (B = 2, Sq and Skv
             of 127 and 129, and Skv = 40) and K3 with q and k x8 (a running max that
             moves), and K6 (int8 q and k) in float32 and bf16 at 1000x777
             and at the tile edges with quantization tiles of 128 and 300, and at the main
             path's self and cross shapes, and K1 at the sliding-window shape (14,040
             tokens, self and cross), at the Fun-Reference / VACE-reference shape (B = 2,
             34,320 tokens) and at generate_batch's (B = 4, 32,760 tokens); times kernel,
             plain version, K6's quantize step and SDPA (as a yardstick only) at the path
             shapes.
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
8. teacache - main's first request again with TeaCache (tea_cache_l1_thresh): under 0.03
             every step computes and the frames equal main's bit for bit with main's K1
             launches; under 1e12 the two middle steps skip the blocks, and K1 launches
             only in the two computed steps. Logs the decisions and each step's seconds.
9. window  - main's first request with sliding windows of 9 latent frames every 6 over
             the 21 (three windows of 14,040 tokens each, ControlNet inside each): K1
             launches 3x a step's per step; then one window over all 21 frames, whose
             frames must agree with main's. Logs each window's seconds.
10. cli    - the reference contract at main's widths and depth: main's weights saved in
             the reference formats (the high-noise expert as 2 bf16 safetensors shards
             read through a glob, umt5 and the VAE as .pth, the VAE under "model.", a
             step-K ControlNet checkpoint with non-zero zero convs), one CSV row and an
             832x480 PNG; the CLI's functions (from_pretrained with a SentencePiece
             tokenizer directory and host staging) answer the row in 4 steps, which must
             equal main's pipeline's frames for the same sample, tokenizer and seed; the
             row's five artifacts are written; the files are deleted.
11. unbounded - one merged-CFG step with qk_bounded=False and enlarged q-norm weights,
             so the runtime logit bound routes self-attention to K2.
12. variants - main's pipeline with full-width adapters (a motion controller and a camera
             SimpleAdapter written in the reference formats and read back through
             from_pretrained's loaders, a Fun-Reference ref_conv in both experts), 2-step
             requests: at 33 frames the plain request, end_image, v2v, motion_bucket_id,
             camera "Left" and a strided ControlNet (stride 2), 12 K1 per step each; at 81
             frames the plain request without ControlNet and Fun-Reference (8 K1 per
             step, 34,320 tokens), two single requests and generate_batch of the same 2
             clips (12 K1 per step at B = 4), which must equal the singles within 1e-2.
             Each request's frames must differ from its plain request's; logs launches
             per step, stage seconds and peak memory, then v2v's untiled 81-frame encode
             (its peak, or the allocation it was refused).
13. main_int8 - main's pipeline quantized in place (W8A8 block linears) with
             attn_impl="flash_int8": the same two requests, 48 K6 launches each and no
             other, and the frames' mean distance from main's bf16 frames.
14. t2v_vace - a full-width t2v pipeline (in_dim 16, 4 DiT layers, no ControlNet) with
             VACE hint blocks after layers 0 and 2 (written and read back through
             from_pretrained's loader): a t2v request (8 K1 per step) and a VACE request
             with video, mask and reference image (34,320 tokens, 12 K1 per step), 2
             steps at 81x480x832.
15. fun_control - a full-width Fun-Control pipeline (in_dim 52, 4 DiT layers): two
             33-frame requests with two control videos (8 K1 per step), frames differ.
16. train  - frees the serving pipeline and trains the ControlNet at full A14B width
             (4 DiT + 2 ControlNet layers, bf16, B = 1, 81x480x832 synthetic clips): 2
             steps, a checkpoint, a full-state resume and a 3rd step; checks the loss,
             the frozen models, the checkpoint and the launches per step, and logs the
             stage split and peak memory.
17. train_cli - the training CLI's functions at train's config on reference-format
             files (the expert as safetensors shards, umt5 and the VAE as .pth; Balls,
             Dominos and Plants CSVs with 832x480 mp4 clips): LoRA adapters (rank 32)
             jointly with the ControlNet for 3 steps, then a resume from the step-2 state
             whose step 3 must equal the first run's bit for bit; checks the base expert,
             the adapters' B, the step-2 file's keys and K3/K4/K5 launches; logs stages,
             peaks and how many merged bf16 weights the adapters change.
18. full_int8 - full A14B depth on one card (40 DiT + 10 ControlNet layers per expert,
             24-layer umt5-xxl, full VAE), W8A8 + K6: one 2-step request across the
             expert switch, 100 K6 launches per step; logs init, stages and peak memory.
19. full_bf16 - full A14B depth in bf16 on one card: the low-noise pair is built and
             staged to pinned host memory before the high-noise pair is built; two
             identical 2-step requests (3 swaps, 200 K1 launches each), the second of
             which must repeat the first step for step; logs init, stages, each swap and
             peak memory.

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
WINDOW, WINDOW_STRIDE = 9, 6            # latent frames: windows at 0, 6 and 12 of 21
WINDOW_SELF = (2, WINDOW * 30 * 52, 40, 128)    # one window's self-attention q/k/v
REF_SELF = (2, 22 * 30 * 52, 40, 128)    # Fun-Reference / VACE reference: one more frame
BATCH_SELF = (4, 32760, 40, 128)         # generate_batch of 2 clips under merged CFG
BATCH_CROSS_KV = (4, 512, 40, 128)
VARIANT_FRAMES = 33      # 9 latent frames (14,040 tokens): K1's window shape
VARIANT_STEPS = 2
# The I2V-480P rescale polynomial is at least 0.037 for every drift >= 0, so 0.03 computes
# every step; 1e12 skips every step between the first and the last.
TC_NO_SKIP, TC_SKIP_ALL = 0.03, 1e12


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
    _build_renderer()


def _build_renderer():
    """The native control renderer (g++, no fallback), and one full-size control video
    from it against the numpy path."""
    from goal_force_tpu_torch import native
    from goal_force_tpu_torch.data import ControlSpec, render_control_video

    lib, secs = sync_time(native.native)
    check(lib is not None, f"the native control renderer does not build: {native.build_error}")
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True).stdout
    spec = ControlSpec(force=220, angle_deg=35, x_pos=0.36, y_pos=0.58, target_force=120,
                       target_angle_deg=80, target_x_pos=0.62, target_y_pos=0.45,
                       projectile_mass=2.0, projectile_xy_px=(300, 200), target_mass=3.0,
                       target_xy_px=(520, 260))
    kw = dict(min_force=30.0, max_force=400.0)
    t0 = time.perf_counter()
    fast = render_control_video(spec, 81, 480, 832, backend="native", **kw)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    slow = render_control_video(spec, 81, 480, 832, backend="numpy", **kw)
    numpy_s = time.perf_counter() - t0
    err = float(np.abs(fast - slow).max())
    log("build", renderer=str(native.library_path()), seconds=secs,
        gxx=gxx.splitlines()[0] if gxx else None, render_81x480x832_native_s=native_s,
        render_81x480x832_numpy_s=numpy_s, max_abs_diff_vs_numpy=err, atol=1e-6,
        ok=err <= 1e-6)
    check(err <= 1e-6, f"native renderer differs from numpy by {err}")


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
    del q, k, v
    torch.cuda.empty_cache()
    # K1 at the sliding-window shape: one window of 9 latent frames holds 9 x 30 x 52 =
    # 14,040 tokens, 109.7 tiles of 128, so the last q tile and the last key tile are
    # partial (self) and the last q tile is (cross).
    q, k, v = (_rand(WINDOW_SELF, gen, torch.bfloat16) for _ in range(3))
    kern = lambda a, b, c: fa.flash_attention_nomax(a, b, c, scale)
    plain = lambda a, b, c: fa.flash_attention_nomax_plain(a, b, c, scale)
    for sname, kk, vv in (("self", k, v), ("cross", ck, cv)):
        got = kern(q, kk, vv)
        ref = plain(q, kk, vv)
        err = compare(f"K1 window {sname} {tuple(q.shape)}x{tuple(kk.shape)} bf16", got, ref,
                      **bf16_tol_shape[sname])
        del got, ref
        torch.cuda.empty_cache()
        if not timed:
            continue
        bound, by = attention_bound_ms(q.shape, kk.shape)
        rec = dict(max_abs_err=err, ms=event_ms(lambda: kern(q, kk, vv)),
                   plain_ms=event_ms(lambda: plain(q, kk, vv), iters=1, warmup=0),
                   bound_ms=bound, bound_by=by,
                   library_ms=event_ms(lambda: sdpa(q.transpose(1, 2), kk.transpose(1, 2),
                                                    vv.transpose(1, 2))),
                   shape=f"{tuple(q.shape)}x{tuple(kk.shape)}")
        out["K1"][f"window_{sname}"] = rec
        log("kernels", case=f"K1 window {sname} timing", **rec)
    del q, k, v, ck, cv
    torch.cuda.empty_cache()
    # K1 at the variants' new shapes: Fun-Reference and VACE with a reference image prepend
    # one latent frame (34,320 tokens, 268.1 tiles of 128: partial last q and key tiles);
    # generate_batch of 2 clips runs B = 4 (2 clips x merged CFG).
    for tag, qshape, kvshape in (("ref", REF_SELF, CROSS_KV), ("batch", BATCH_SELF,
                                                              BATCH_CROSS_KV)):
        q, k, v = (_rand(qshape, gen, torch.bfloat16) for _ in range(3))
        ck, cv = _rand(kvshape, gen, torch.bfloat16), _rand(kvshape, gen, torch.bfloat16)
        for sname, kk, vv in (("self", k, v), ("cross", ck, cv)):
            got = kern(q, kk, vv)
            ref = plain(q, kk, vv)
            err = compare(f"K1 {tag} {sname} {tuple(q.shape)}x{tuple(kk.shape)} bf16", got, ref,
                          **bf16_tol_shape[sname])
            del got, ref
            torch.cuda.empty_cache()
            if not timed:
                continue
            bound, by = attention_bound_ms(q.shape, kk.shape)
            rec = dict(max_abs_err=err, ms=event_ms(lambda: kern(q, kk, vv)),
                       plain_ms=event_ms(lambda: plain(q, kk, vv), iters=1, warmup=0),
                       bound_ms=bound, bound_by=by,
                       library_ms=event_ms(lambda: sdpa(q.transpose(1, 2), kk.transpose(1, 2),
                                                        vv.transpose(1, 2))),
                       shape=f"{tuple(q.shape)}x{tuple(kk.shape)}")
            out["K1"][f"{tag}_{sname}"] = rec
            log("kernels", case=f"K1 {tag} {sname} timing", **rec)
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


def _step_log(pipe):
    """Wrap the pipeline's full and skipped steps: each call appends (kind, synchronised
    seconds), kind "full" for a TeaCache step that computes, "plain" for an ordinary
    step and "skip" for a skipped one. Returns the log and a function that unwraps."""
    steps = []
    full, skip = pipe.denoise_step, pipe.denoise_step_skip

    def full_(*a, **k):
        out, secs = sync_time(lambda: full(*a, **k))
        steps.append(("full" if k.get("return_residual") else "plain", secs))
        return out

    def skip_(*a, **k):
        out, secs = sync_time(lambda: skip(*a, **k))
        steps.append(("skip", secs))
        return out

    pipe.denoise_step, pipe.denoise_step_skip = full_, skip_
    return steps, lambda: [pipe.__dict__.pop(n, None) for n in ("denoise_step",
                                                                 "denoise_step_skip")]


def _check_frames(phase, frames, pc):
    check(frames.shape == (pc.num_frames, pc.height, pc.width, 3)
          and bool(np.isfinite(frames).all()) and frames.min() >= 0.0 and frames.max() <= 1.0,
          f"{phase}: frames of shape {frames.shape}, not finite or outside [0, 1]")


def phase_teacache(pipe, main_frames):
    """main's first request (seed, prompt and inputs) again with TeaCache: under a
    threshold that computes every step the frames must equal main's bit for bit with
    main's K1 launches; under one that skips every middle step, K1 launches only in the
    computed steps (the first and the last)."""
    from goal_force_tpu_torch.ops import flash_attention as fa

    pc = pipe.pipe_cfg
    image, video = _request_inputs(11, pc.num_frames, pc.height, pc.width, pc)
    per_step = K1_PER_REQUEST // STEPS
    fa.reset_launch_counts()
    for name, thresh, want in (("no_skip", TC_NO_SKIP, ["full"] * STEPS),
                               ("skip", TC_SKIP_ALL, ["full"] + ["skip"] * (STEPS - 2) + ["full"])):
        steps, unwrap = _step_log(pipe)
        before = dict(fa.launch_counts)
        try:
            frames, secs = sync_time(lambda: pipe(PROMPTS[0], image, control_signal_video=video,
                                                  seed=11, num_inference_steps=STEPS,
                                                  tea_cache_l1_thresh=thresh))
        finally:
            unwrap()
        counts = {k: fa.launch_counts[k] - before[k] for k in before}
        decisions = [kind for kind, _ in steps]
        computed = decisions.count("full")
        diff = float(np.abs(frames - main_frames).max())
        log("teacache", request=name, threshold=thresh, decisions=decisions, seconds=secs,
            computed_step_seconds=[t for k, t in steps if k == "full"],
            skipped_step_seconds=[t for k, t in steps if k == "skip"], launches=counts,
            k1_per_computed_step=per_step, max_abs_diff_vs_main=diff,
            frames_mean=float(frames.mean()))
        _check_frames(f"teacache {name}", frames, pc)
        check(decisions == want, f"teacache {name}: decisions {decisions}, expected {want}")
        check(counts == only(K1=computed * per_step), f"teacache {name} launched {counts}")
        if name == "no_skip":
            check(diff == 0.0, f"teacache {name}: frames differ from main's by {diff}")
    return dict(fa.launch_counts)


WINDOW_ATOL = 1e-2   # one window over every frame vs main's frames: ~1 bf16 ulp near 1.0


def phase_window(pipe, main_frames):
    """main's first request with sliding windows of 9 latent frames every 6 over the 21
    (three windows of 14,040 tokens, the ControlNet inside each), then with one window
    over all 21, whose frames must agree with main's (same function, summed in float32
    under a unit mask)."""
    from goal_force_tpu_torch.ops import flash_attention as fa
    from goal_force_tpu_torch.pipelines import goal_force as gfm

    pc = pipe.pipe_cfg
    image, video = _request_inputs(11, pc.num_frames, pc.height, pc.width, pc)
    per_window = K1_PER_REQUEST // STEPS
    real_tiled = gfm.temporal_tiled_forward
    windows = []

    def tiled(model_fn, latents, *a, **k):
        def timed(lat, *rest):
            out, secs = sync_time(lambda: model_fn(lat, *rest))
            windows.append((lat.shape[1], secs))
            return out
        return real_tiled(timed, latents, *a, **k)

    gfm.temporal_tiled_forward = tiled
    fa.reset_launch_counts()
    try:
        for name, size, stride in (("three_windows", WINDOW, WINDOW_STRIDE),
                                   ("one_window", pc.latent_frames, pc.latent_frames)):
            windows.clear()
            before = dict(fa.launch_counts)
            frames, secs = sync_time(lambda: pipe(
                PROMPTS[0], image, control_signal_video=video, seed=11,
                num_inference_steps=STEPS, sliding_window_size=size,
                sliding_window_stride=stride))
            counts = {k: fa.launch_counts[k] - before[k] for k in before}
            n_win = len(windows) // STEPS
            diff = float(np.abs(frames - main_frames).max())
            log("window", request=name, window=size, stride=stride,
                window_frames=[f for f, _ in windows[:n_win]],
                window_tokens=[f * 30 * 52 for f, _ in windows[:n_win]],
                window_seconds=[t for _, t in windows], seconds=secs, launches=counts,
                max_abs_diff_vs_main=diff, atol=WINDOW_ATOL if n_win == 1 else None,
                frames_mean=float(frames.mean()))
            _check_frames(f"window {name}", frames, pc)
            want = [WINDOW] * 3 if name == "three_windows" else [pc.latent_frames]
            check([f for f, _ in windows] == want * STEPS, f"window {name}: windows {windows}")
            check(counts == only(K1=STEPS * len(want) * per_window),
                  f"window {name} launched {counts}")
            if name == "one_window":
                check(diff <= WINDOW_ATOL, f"window {name}: frames differ from main's by {diff}")
    finally:
        gfm.temporal_tiled_forward = real_tiled
    return dict(fa.launch_counts)


def _variant_request(pipe, phase, name, fn, per_step, frames_shape, steps=VARIANT_STEPS,
                     base=None):
    """One request fn() with its stages timed. Checks its frames (shape, finite, in
    [0, 1]) and that K1 (and nothing else) launched per_step times in each of its steps;
    logs the launches per step, the step seconds, the peak memory and max |frames - base|,
    which must exceed 1e-3 (the variant's input changed the result). Returns the frames."""
    from goal_force_tpu_torch.ops import flash_attention as fa

    stage_times = []
    _instrument(pipe, stage_times)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = dict(fa.launch_counts)
    try:
        frames, secs = sync_time(fn)
    finally:
        _uninstrument(pipe)
    counts = {k: fa.launch_counts[k] - before[k] for k in before}
    diff = None if base is None else float(np.abs(frames - base).max())
    log(phase, request=name, seconds=secs, stages=dict(stage_times), launches=counts,
        k1_per_step=counts["K1"] / steps, peak_gb=torch.cuda.max_memory_allocated() / 2**30,
        max_abs_diff_vs_plain=diff, frames_mean=float(frames.mean()))
    check(frames.shape == frames_shape and bool(np.isfinite(frames).all())
          and frames.min() >= 0.0 and frames.max() <= 1.0,
          f"{phase} {name}: frames of shape {frames.shape}, not finite or outside [0, 1]")
    check(counts == only(K1=per_step * steps), f"{phase} {name} launched {counts}")
    if base is not None:
        check(diff > 1e-3, f"{phase} {name}: frames equal the plain request's ({diff})")
    return frames


def _save_and_load_adapters(root, dit_cfg, adapters):
    """Write drawn adapters in the reference formats (the camera adapter inside a camera
    model's file, under "control_adapter.") and read them back through from_pretrained's
    loaders."""
    from goal_force_tpu_torch.io import safetensors_io as sio
    from goal_force_tpu_torch.pipelines.goal_force import load_adapters

    paths = {}
    for name, mod in adapters.items():
        sd = {k: v.contiguous() for k, v in mod.state_dict().items()}
        if name == "camera_adapter":
            sd = {"control_adapter." + k: v for k, v in sd.items()}
        paths[name] = os.path.join(root, f"{name}.safetensors")
        sio.save_safetensors(sd, paths[name])
    nbytes = sum(os.path.getsize(p) for p in paths.values())
    n_vace = len(adapters["vace"].vace_blocks) if "vace" in adapters else 0
    loaded, secs = sync_time(lambda: load_adapters(
        dit_cfg, paths.get("vace"), n_vace, paths.get("motion_controller"),
        paths.get("camera_adapter"), torch.bfloat16, "cuda"))
    for name, mod in adapters.items():
        want = mod.state_dict()
        check(all(torch.equal(t, want[k]) for k, t in loaded[name].state_dict().items()),
              f"{name}: read back differs from what was written")
    return loaded, nbytes, secs


def phase_variants(pipe):
    """The Wan variants on main's bf16 pipeline, 2 steps each. Adapters drawn at full
    width (a motion controller whose last layer is not zero, a camera SimpleAdapter, a
    Fun-Reference ref_conv in both experts), the first two written in the reference
    formats and read back through from_pretrained's loaders. At 33 frames (K1 at the
    window's 14,040 tokens): the plain request, end_image, v2v (its untiled encode),
    motion_bucket_id, camera "Left" and a strided ControlNet (stride 2: blocks 0 and 2,
    raw states after them), each 12 K1 per step. At 81 frames: the plain request without
    ControlNet and Fun-Reference (8 K1 per step, 34,320 tokens), then generate_batch of 2
    clips (12 K1 per step at B = 4), which must equal its two single requests within
    WINDOW_ATOL. Last, v2v's untiled encode at 81 frames, as JAX encodes it, measured
    and reported whether or not it fits."""
    import gc
    import tempfile

    from goal_force_tpu_torch.models import adapters as adm
    from goal_force_tpu_torch.models import camera_controller as camm
    from goal_force_tpu_torch.models import controlnet as cnm
    from goal_force_tpu_torch.models import wan_dit
    from goal_force_tpu_torch.ops import flash_attention as fa

    pc = pipe.pipe_cfg
    dit_cfg = pipe.dit_cfg
    gen = torch.Generator("cuda").manual_seed(31)
    mc = adm.init_motion_controller(gen, dit_cfg.freq_dim, dit_cfg.dim, torch.bfloat16,
                                    device="cuda")
    with torch.no_grad():
        wan_dit.init_linear_(mc.linear[4], gen)     # a trained controller's is not zero
    cam = camm.init_simple_adapter(dit_cfg.dim, gen, kernel=dit_cfg.patch_size[1],
                                   dtype=torch.bfloat16, device="cuda")
    with tempfile.TemporaryDirectory() as root:
        loaded, nbytes, load_s = _save_and_load_adapters(
            root, dit_cfg, {"motion_controller": mc, "camera_adapter": cam})
    del mc, cam
    pipe.models.update(loaded)
    for name in ("dit", "dit2"):
        wan_dit.init_ref_conv_(pipe.models[name], pipe.vae_cfg.z_dim, gen)
    log("variants", stage="adapters", file_bytes=nbytes, load_seconds=load_s,
        params={k: sum(t.numel() for t in pipe.models[k].parameters())
                for k in ("motion_controller", "camera_adapter")},
        ref_conv_params=pipe.models["dit"].ref_conv.weight.numel())

    n = VARIANT_FRAMES
    shape33 = (n, pc.height, pc.width, 3)
    image, video = _request_inputs(41, n, pc.height, pc.width, pc)
    end_image, other = _request_inputs(42, n, pc.height, pc.width, pc)
    kw = dict(seed=41, num_frames=n, num_inference_steps=VARIANT_STEPS)
    fa.reset_launch_counts()
    run = lambda name, per_step, shape, fn, base=None: _variant_request(
        pipe, "variants", name, fn, per_step, shape, base=base)
    plain = run("plain_33", 12, shape33,
                lambda: pipe(PROMPTS[0], image, control_signal_video=video, **kw))
    run("end_image_33", 12, shape33, lambda: pipe(PROMPTS[0], image, control_signal_video=video,
                                                  end_image=end_image, **kw), plain)
    v2v_input = np.clip(0.5 * other + 0.25, 0.0, 1.0)
    run("v2v_33", 12, shape33, lambda: pipe(PROMPTS[0], image, control_signal_video=video,
                                            input_video=v2v_input, denoising_strength=0.8,
                                            **kw), plain)
    run("motion_33", 12, shape33, lambda: pipe(PROMPTS[0], image, control_signal_video=video,
                                               motion_bucket_id=90, **kw), plain)
    run("camera_left_33", 12, shape33, lambda: pipe(PROMPTS[0], image,
                                                    control_signal_video=video,
                                                    camera_control_direction="Left", **kw),
        plain)
    # strided ControlNets (stride 2), in place of main's for one request
    saved = (pipe.cn_cfg, pipe.models["controlnet"], pipe.models["controlnet2"])
    pipe.cn_cfg = dataclasses.replace(pipe.cn_cfg, stride=2)
    for cn_name, dit_name in (("controlnet", "dit"), ("controlnet2", "dit2")):
        pipe.models[cn_name] = cnm.init_from_dit(pipe.models[dit_name], dit_cfg, pipe.cn_cfg,
                                                 gen, torch.bfloat16, device="cuda")
    try:
        run("strided_controlnet_33", 12, shape33,
            lambda: pipe(PROMPTS[0], image, control_signal_video=video, **kw), plain)
    finally:
        pipe.cn_cfg, pipe.models["controlnet"], pipe.models["controlnet2"] = saved
    gc.collect()
    torch.cuda.empty_cache()

    shape81 = (pc.num_frames, pc.height, pc.width, 3)
    images_, videos = zip(*(_request_inputs(s, pc.num_frames, pc.height, pc.width, pc)
                            for s in (43, 44)))
    ref_image = _request_inputs(45, 1, pc.height, pc.width, pc)[0]
    kw81 = dict(num_inference_steps=VARIANT_STEPS)
    plain81 = run("plain_no_controlnet_81", 8, shape81,
                  lambda: pipe(PROMPTS[0], images_[0], seed=43, controlnet=False, **kw81))
    run("reference_81", 8, shape81, lambda: pipe(PROMPTS[0], images_[0], seed=43,
                                                  controlnet=False, reference_image=ref_image,
                                                  **kw81), plain81)
    singles = [run(f"single{i}_81", 12, shape81,
                   lambda i=i: pipe(PROMPTS[i], images_[i], control_signal_video=videos[i],
                                    seed=43 + i, **kw81))
               for i in range(2)]
    batch = run("batch_2x81", 12, (2,) + shape81,
                lambda: pipe.generate_batch(list(PROMPTS), np.stack(images_),
                                            control_signal_videos=list(videos),
                                            seeds=[43, 44], **kw81))
    batch_diff = [float(np.abs(batch[i] - singles[i]).max()) for i in range(2)]
    log("variants", stage="batch_vs_singles", max_abs_diff=batch_diff, atol=WINDOW_ATOL,
        ok=max(batch_diff) <= WINDOW_ATOL)
    check(max(batch_diff) <= WINDOW_ATOL,
          f"generate_batch differs from its singles by {batch_diff}")
    run_counts = dict(fa.launch_counts)
    del batch, singles, plain81
    gc.collect()
    torch.cuda.empty_cache()
    _v2v_encode_81(pipe, videos[0])
    for name in ("motion_controller", "camera_adapter"):
        del pipe.models[name]
    for name in ("dit", "dit2"):
        del pipe.models[name].ref_conv
    gc.collect()
    torch.cuda.empty_cache()
    return run_counts


def _v2v_encode_81(pipe, video):
    """v2v's untiled float32 encode of an 81-frame input, as JAX encodes it: its peak if it
    fits, else what the allocator refused (a measurement, not a check)."""
    import gc

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    try:
        lat, secs = sync_time(lambda: pipe._encode_untiled(video))
        log("variants", stage="v2v_untiled_encode_81", fits=True, seconds=secs,
            latents=list(lat.shape), resident_gb=resident / 2**30,
            peak_gb=torch.cuda.max_memory_allocated() / 2**30)
        del lat
    except torch.cuda.OutOfMemoryError as e:
        log("variants", stage="v2v_untiled_encode_81", fits=False, resident_gb=resident / 2**30,
            peak_before_failure_gb=torch.cuda.max_memory_allocated() / 2**30,
            error=str(e).splitlines()[0][:300])
    gc.collect()
    torch.cuda.empty_cache()


def phase_t2v_vace():
    """A full-width text-to-video pipeline (A14B widths, in_dim 16, 4 DiT layers per expert,
    no ControlNet) with VACE hint blocks after DiT layers 0 and 2, drawn at full width and
    read back through from_pretrained's loader: one t2v request (8 K1 per step), then one
    VACE request with video, mask and reference image (22 latent frames, 34,320 tokens,
    12 K1 per step), both 81x480x832 and 2 steps."""
    import gc
    import tempfile

    from goal_force_tpu_torch import configs as C
    from goal_force_tpu_torch.ops import flash_attention as fa
    from goal_force_tpu_torch.pipelines.goal_force import GoalForcePipeline

    dit_cfg = dataclasses.replace(C.WAN22_A14B, num_layers=4, in_dim=C.WAN21_VAE.z_dim)
    t5_cfg = dataclasses.replace(C.UMT5_XXL, num_layers=2)
    layers = (0, 2)
    pipe, secs = sync_time(lambda: GoalForcePipeline.init_random(
        seed=7, dit_cfg=dit_cfg, t5_cfg=t5_cfg, vae_cfg=C.WAN21_VAE, cn_cfg=None,
        dtype=torch.bfloat16, device="cuda", adapters=("vace",), vace_layers=layers))
    with tempfile.TemporaryDirectory() as root:
        loaded, nbytes, load_s = _save_and_load_adapters(root, dit_cfg,
                                                         {"vace": pipe.models["vace"]})
    pipe.models["vace"] = loaded["vace"]
    check(pipe.vace_layers == layers, f"t2v_vace: vace layers {pipe.vace_layers}")
    log("t2v_vace", stage="init", seconds=secs, vace_file_bytes=nbytes, vace_load_seconds=load_s,
        vace_params=sum(t.numel() for t in pipe.models["vace"].parameters()),
        memory_gb=torch.cuda.memory_allocated() / 2**30)
    pc = pipe.pipe_cfg
    shape = (pc.num_frames, pc.height, pc.width, 3)
    kw = dict(height=pc.height, width=pc.width, seed=51, num_inference_steps=VARIANT_STEPS)
    image, video = _request_inputs(51, pc.num_frames, pc.height, pc.width, pc)
    mask = np.zeros((pc.num_frames, pc.height, pc.width), np.float32)
    mask[:, 120:360, 208:624] = 1.0                          # regenerate the centre
    fa.reset_launch_counts()
    t2v = _variant_request(pipe, "t2v_vace", "t2v_81", lambda: pipe(PROMPTS[0], **kw), 8, shape)
    _variant_request(pipe, "t2v_vace", "vace_81_with_reference", lambda: pipe(
        PROMPTS[0], vace_video=video, vace_video_mask=mask, vace_reference_image=image, **kw),
        12, shape, base=t2v)
    run_counts = dict(fa.launch_counts)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return run_counts


def phase_fun_control():
    """A full-width Fun-Control pipeline (A14B widths, in_dim 52 = 16 + 16 control + 4 + 16,
    4 DiT layers per expert, no ControlNet): one 33-frame request with a first frame and a
    control video (8 K1 per step), and the same with another control video, whose frames
    must differ."""
    import gc

    from goal_force_tpu_torch import configs as C
    from goal_force_tpu_torch.ops import flash_attention as fa
    from goal_force_tpu_torch.pipelines.goal_force import GoalForcePipeline

    z = C.WAN21_VAE.z_dim
    dit_cfg = dataclasses.replace(C.WAN22_A14B, num_layers=4, in_dim=3 * z + 4)
    t5_cfg = dataclasses.replace(C.UMT5_XXL, num_layers=2)
    pipe, secs = sync_time(lambda: GoalForcePipeline.init_random(
        seed=9, dit_cfg=dit_cfg, t5_cfg=t5_cfg, vae_cfg=C.WAN21_VAE, cn_cfg=None,
        dtype=torch.bfloat16, device="cuda"))
    log("fun_control", stage="init", seconds=secs, in_dim=dit_cfg.in_dim,
        memory_gb=torch.cuda.memory_allocated() / 2**30)
    pc = pipe.pipe_cfg
    n = VARIANT_FRAMES
    image, video = _request_inputs(61, n, pc.height, pc.width, pc)
    _, other = _request_inputs(62, n, pc.height, pc.width, pc)
    kw = dict(seed=61, num_frames=n, num_inference_steps=VARIANT_STEPS)
    fa.reset_launch_counts()
    first = _variant_request(pipe, "fun_control", "fun_control_33", lambda: pipe(
        PROMPTS[0], image, fun_control_video=video, **kw), 8, (n, pc.height, pc.width, 3))
    _variant_request(pipe, "fun_control", "other_control_video_33", lambda: pipe(
        PROMPTS[0], image, fun_control_video=other, **kw), 8, (n, pc.height, pc.width, 3),
        base=first)
    run_counts = dict(fa.launch_counts)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return run_counts


CLI_HEADER = ("image,caption,projectile_force_magnitude,projectile_force_angle,"
              "projectile_coordx,projectile_coordy,width,height,"
              "target_indirect_force_magnitude,target_indirect_force_angle,target_coordx,"
              "target_coordy,projectile_mass,target_mass")
CLI_ROW = "table.png,{},220.0,35,300,200.0,832,480,120,80,520,260,2.0,3"
CLI_ATOL = 1e-3      # frames of the CLI's load vs the in-memory pipeline (0 expected)


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def phase_cli(pipe):
    """The reference contract at full width: main's pipeline's weights saved in the
    reference formats (the high-noise expert as 2 bf16 safetensors shards read through a
    glob, the low-noise one as one file, umt5 as a .pth, the VAE as a .pth under
    "model.", a step-K ControlNet checkpoint with non-zero zero convs), one CSV row and
    an 832x480 PNG written with the port's writer, and the CLI's functions (load_pipeline
    -> from_pretrained with a SentencePiece tokenizer directory and host staging,
    row_samples, answer_row, write_row) answering the row in 4 steps. The frames must
    equal main's pipeline answering the same sample with the same tokenizer and seed."""
    import gc
    import shutil
    import tempfile

    from goal_force_tpu_torch.data.video_io import save_image
    from goal_force_tpu_torch.io import safetensors_io as sio
    from goal_force_tpu_torch.ops import flash_attention as fa
    from goal_force_tpu_torch.scripts import infer

    pc = pipe.pipe_cfg
    cn = pipe.models["controlnet"]
    zero = [(zc.weight.clone(), zc.bias.clone()) for zc in cn.controlnet_zero_convs_after]
    tokenizer = pipe.tokenizer
    tmp = tempfile.mkdtemp(prefix="gf_cli_")
    try:
        _perturb_zero_convs(cn, 17)          # a trained checkpoint's zero convs
        t0 = time.perf_counter()
        high = pipe.models["dit"].state_dict()
        keys = sorted(high)
        for i in range(2):
            sio.save_safetensors({k: high[k] for k in keys[i::2]}, os.path.join(
                tmp, "high", f"diffusion_pytorch_model-0000{i + 1}-of-00002.safetensors"))
        sio.save_safetensors(pipe.models["dit2"].state_dict(),
                             os.path.join(tmp, "low", "diffusion_pytorch_model.safetensors"))
        torch.save({k: v.cpu() for k, v in pipe.models["t5"].state_dict().items()},
                   os.path.join(tmp, "models_t5_umt5-xxl-enc-bf16.pth"))
        torch.save({"model." + k: v.cpu() for k, v in pipe.models["vae"].state_dict().items()},
                   os.path.join(tmp, "Wan2.1_VAE.pth"))
        ckpt = os.path.join(tmp, "ckpt", "step-3.safetensors")
        sio.save_safetensors(sio.export_goalforce_controlnet(cn), ckpt)
        write_s = time.perf_counter() - t0
        weight_bytes = _dir_bytes(tmp)
        tok_dir = os.path.join(tmp, "umt5_tokenizer")
        os.makedirs(tok_dir)
        src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goal_force_tpu",
                           "tokenizer_assets", "cog", "tokenizer")
        for name in ("spiece.model", "added_tokens.json"):
            shutil.copy(os.path.join(src, name), tok_dir)
        image, _ = _request_inputs(41, 1, pc.height, pc.width, pc)
        save_image(image, os.path.join(tmp, "examples", "images", "table.png"))
        csv_path = os.path.join(tmp, "examples", "rows.csv")
        with open(csv_path, "w") as f:
            f.write(CLI_HEADER + "\n" + CLI_ROW.format(PROMPTS[0]) + "\n")
        log("cli", stage="files", seconds=write_s, bytes=weight_bytes,
            files=sorted(os.path.relpath(os.path.join(d, x), tmp)
                         for d, _, fs in os.walk(tmp) for x in fs))
        args = infer.parse_args([
            "--high_noise_model", os.path.join(tmp, "high", "diffusion_pytorch_model-*.safetensors"),
            "--low_noise_model", os.path.join(tmp, "low", "diffusion_pytorch_model.safetensors"),
            "--t5_path", os.path.join(tmp, "models_t5_umt5-xxl-enc-bf16.pth"),
            "--vae_path", os.path.join(tmp, "Wan2.1_VAE.pth"), "--tokenizer_path", tok_dir,
            "--model_ckpt_path", ckpt, "--example_paths", csv_path,
            "--output_dir", os.path.join(tmp, "out"), "--num_inference_steps", str(STEPS),
            "--controlnet_num_layers", str(pipe.cn_cfg.num_layers), "--seed", "7"])
        loaded, load_s = sync_time(lambda: infer.load_pipeline(args, dit_cfg=pipe.dit_cfg,
                                                               t5_cfg=pipe.t5_cfg))
        lm = loaded.models
        same = {}
        for k in ("dit", "dit2", "t5", "vae", "controlnet"):
            want = pipe.models[k].state_dict()
            same[k] = all(torch.equal(t, want[n].to(t.device))
                          for n, t in lm[k].state_dict().items())
        cn2_zero = all(not zc.weight.any() and not zc.bias.any()
                       for zc in lm["controlnet2"].controlnet_zero_convs_after)
        cn_ckpt = all(torch.equal(a.weight, b.weight) and torch.equal(a.bias, b.bias)
                      for a, b in zip(lm["controlnet"].controlnet_zero_convs_after,
                                      cn.controlnet_zero_convs_after))
        standby_pinned = all(not t.is_cuda and t.is_pinned()
                             for k in ("dit2", "controlnet2") for t in lm[k].state_dict().values())
        log("cli", stage="load", seconds=load_s, tokenizer=type(loaded.tokenizer).__name__,
            staged=loaded._stager is not None, standby_pinned=standby_pinned,
            weights_equal_main=same, controlnet2_zero_convs_zero=cn2_zero,
            controlnet_zero_convs_from_checkpoint=cn_ckpt,
            memory_gb=torch.cuda.memory_allocated() / 2**30)
        check(all(same.values()), f"cli: loaded weights differ from main's: {same}")
        check(cn2_zero and cn_ckpt, "cli: the ControlNets' zero convs are not as loaded")
        check(loaded._stager is not None and standby_pinned,
              "cli: the low-noise pair is not staged in pinned host memory")
        samples = list(infer.row_samples(csv_path, args, loaded.pipe_cfg))
        check(len(samples) == 1, f"cli: {len(samples)} samples from one row")
        sample = samples[0]
        swaps = []
        real_swap = loaded._stager.swap
        loaded._stager.swap = lambda: swaps.append(sync_time(real_swap)[1])
        stage_times = []
        _instrument(loaded, stage_times)
        fa.reset_launch_counts()
        frames, answer_s = sync_time(lambda: infer.answer_row(loaded, sample, args))
        launches = dict(fa.launch_counts)
        _uninstrument(loaded)
        check(launches == only(K1=K1_PER_REQUEST), f"cli launched {launches}")
        out_dir, step = infer.output_dir(args)
        base = infer.row_base(sample, args, out_dir, step)
        infer.write_row(sample, frames, base, loaded.pipe_cfg)
        written = {k: os.path.exists(base + k) for k in infer.ARTIFACTS}
        pipe.tokenizer, pipe.pipe_cfg = loaded.tokenizer, loaded.pipe_cfg
        del loaded, lm
        gc.collect()
        torch.cuda.empty_cache()
        ref = infer.answer_row(pipe, sample, args, progress=False)
        err = float(np.abs(frames - ref).max())
        check(frames.shape == (pc.num_frames, pc.height, pc.width, 3)
              and bool(np.isfinite(frames).all()) and 0.0 <= frames.min()
              and frames.max() <= 1.0, "cli: bad frames")
        log("cli", stage="request", seconds=answer_s, stages=dict(stage_times),
            swap_seconds=swaps, launches=launches, max_abs_err_vs_main=err, atol=CLI_ATOL,
            frames_mean=float(frames.mean()), ok=err <= CLI_ATOL)
        log("cli", stage="artifacts", base=os.path.basename(base),
            written=sorted(k for k, v in written.items() if v),
            not_written=sorted(k for k, v in written.items() if not v),
            sizes={k: os.path.getsize(base + k) for k, v in written.items() if v})
        check(err <= CLI_ATOL, f"cli: frames differ from main's by {err}")
        check(len(swaps) == 1, f"cli: {len(swaps)} swaps in one request")
        check(all(written.values()), f"cli: artifacts not written: {written}")
    finally:
        with torch.no_grad():
            for zc, (w, b) in zip(cn.controlnet_zero_convs_after, zero):
                zc.weight.copy_(w)
                zc.bias.copy_(b)
        pipe.tokenizer, pipe.pipe_cfg = tokenizer, pc
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


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
                             load_tokenizer(None, t5_cfg.vocab, t5_cfg.text_len, quiet=True),
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


def _fingerprint(modules):
    """One number from every tensor of `modules` (on the card): equal sums of the same
    tensors, so a pair that comes back from the host unchanged gives the same value."""
    ts = [t for m in modules for t in m.state_dict().values()]
    return torch.stack([t.float().sum() for t in ts]).double().sum().item()


def phase_full_bf16():
    """Full A14B depth in bf16 on one card with host staging: 40 DiT + 10 ControlNet
    layers per expert (non-zero zero convs), the 24-layer umt5-xxl and the full Wan2.1
    VAE. The low-noise pair is built first and staged to pinned host memory before the
    high-noise pair is built, so both pairs are never on the card together. Two
    81x480x832 requests of 2 steps with the same seed and inputs (t = 1000 on the
    high-noise pair, t = 833 on the low-noise pair): the stager swaps in, back and in
    again, and the second request must repeat the first step for step."""
    import gc

    from goal_force_tpu_torch import configs as C
    from goal_force_tpu_torch.models import controlnet as cnm
    from goal_force_tpu_torch.models import t5 as t5m
    from goal_force_tpu_torch.models import vae as vaem
    from goal_force_tpu_torch.models import wan_dit
    from goal_force_tpu_torch.models.tokenizer import load_tokenizer
    from goal_force_tpu_torch.ops import flash_attention as fa
    from goal_force_tpu_torch.parallel.host_staging import stage_to_host
    from goal_force_tpu_torch.pipelines.goal_force import GoalForcePipeline

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dit_cfg, t5_cfg, vae_cfg = C.WAN22_A14B, C.UMT5_XXL, C.WAN21_VAE
    cn_cfg = C.ControlNetConfig(num_layers=10, in_channels=vae_cfg.z_dim)
    gen = torch.Generator("cuda").manual_seed(0)
    t0 = time.perf_counter()
    models, prints = {}, {}
    for dit_name, cn_name, tag, seed in (("dit2", "controlnet2", "low", 23),
                                         ("dit", "controlnet", "high", 29)):
        models[dit_name] = wan_dit.init_wan_dit(dit_cfg, gen, torch.bfloat16, device="cuda")
        models[cn_name] = cnm.init_from_dit(models[dit_name], dit_cfg, cn_cfg, gen,
                                            torch.bfloat16, device="cuda")
        _perturb_zero_convs(models[cn_name], seed)
        prints[tag] = _fingerprint((models[dit_name], models[cn_name]))
        pair_gb = sum(t.numel() * t.element_size() for k in (dit_name, cn_name)
                      for t in models[k].state_dict().values()) / 2**30
        stage_s = None
        if tag == "low":
            _, stage_s = sync_time(lambda: stage_to_host(
                {"dit": models["dit2"], "controlnet": models["controlnet2"]}, pin_memory=True))
            gc.collect()
            torch.cuda.empty_cache()
        log("full_bf16", stage=f"init {dit_name}+{cn_name}", pair_gib=pair_gb,
            stage_to_host_seconds=stage_s, memory_gb=torch.cuda.memory_allocated() / 2**30,
            seconds=time.perf_counter() - t0)
    models["t5"] = t5m.init_t5(t5_cfg, gen, torch.bfloat16, device="cuda")
    models["vae"] = vaem.init_vae(vae_cfg, gen, torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pipe = GoalForcePipeline(dit_cfg, t5_cfg, vae_cfg, cn_cfg, C.PipelineConfig(), models,
                             load_tokenizer(None, t5_cfg.vocab, t5_cfg.text_len, quiet=True),
                             torch.bfloat16, torch.device("cuda")).host_stage_experts()
    gb = {k: sum(t.numel() * t.element_size() for t in m.state_dict().values()) / 2**30
          for k, m in models.items()}
    log("full_bf16", stage="init", seconds=init_s, weights_gib=gb,
        memory_gb=torch.cuda.memory_allocated() / 2**30,
        init_peak_gb=torch.cuda.max_memory_allocated() / 2**30)

    swaps, peaks = [], []
    real_swap = pipe._stager.swap

    def timed_swap():
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        _, secs = sync_time(real_swap)
        peak = torch.cuda.max_memory_allocated()
        peaks.append(peak)
        swaps.append({"seconds": secs, "peak_gb": peak / 2**30,
                      "peak_above_resident_gb": (peak - resident) / 2**30})

    pipe._stager.swap = timed_swap
    steps, stage_times = [], []
    _instrument(pipe, stage_times)
    timed_step = pipe.denoise_step

    def step(dit, cn, *a, **k):
        out = timed_step(dit, cn, *a, **k)
        tag = "high" if dit is models["dit"] else "low"
        other = models["dit2"] if tag == "high" else models["dit"]
        steps.append({"expert": tag, "out": out.float().cpu(),
                      "weights_intact": _fingerprint((dit, cn)) == prints[tag],
                      "on_card": all(t.is_cuda for t in dit.state_dict().values()),
                      "other_on_host": not any(t.is_cuda for t in other.state_dict().values())})
        return out

    pipe.denoise_step = step
    pc = pipe.pipe_cfg
    per_request = only(K1=2 * 2 * (dit_cfg.num_layers + cn_cfg.num_layers))
    image, video = _request_inputs(11, pc.num_frames, pc.height, pc.width, pc)
    outputs = []
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    try:
        for r in range(2):
            stage_times.clear()
            before, n_swaps = dict(fa.launch_counts), len(swaps)
            frames, total = sync_time(lambda: pipe(PROMPTS[0], image, control_signal_video=video,
                                                   seed=11, num_inference_steps=2))
            counts = {k: fa.launch_counts[k] - before[k] for k in before}
            log("full_bf16", stage=f"request{r}", seconds=total, stages=dict(stage_times),
                launches=counts, swaps=swaps[n_swaps:],
                frames_mean=float(frames.mean()))
            check(frames.shape == (pc.num_frames, pc.height, pc.width, 3)
                  and bool(np.isfinite(frames).all()) and frames.min() >= 0.0
                  and frames.max() <= 1.0, f"full_bf16 request {r}: bad frames")
            check(counts == per_request, f"full_bf16 request {r}: launched {counts}")
            outputs.append(frames)
    finally:
        _uninstrument(pipe)
    run_counts = dict(fa.launch_counts)
    peaks.append(torch.cuda.max_memory_allocated())
    experts = [s["expert"] for s in steps]
    repeat = [float((steps[i + 2]["out"] - steps[i]["out"]).abs().max()) for i in range(2)]
    frames_diff = float(np.abs(outputs[1] - outputs[0]).max())
    intact = all(s["weights_intact"] and s["on_card"] and s["other_on_host"] for s in steps)
    log("full_bf16", stage="done", launches=run_counts, k1_per_step=per_request["K1"] // 2,
        experts=experts, swaps=swaps, weights_intact_and_placed=intact,
        second_request_step_max_abs_diff=repeat, second_request_frames_max_abs_diff=frames_diff,
        max_memory_allocated_gb=max(peaks) / 2**30)
    check(experts == ["high", "low", "high", "low"], f"full_bf16: experts {experts}")
    check(len(swaps) == 3, f"full_bf16: {len(swaps)} swaps")
    check(intact, "full_bf16: a pair on the card changed, or the pairs were misplaced")
    check(repeat[0] == 0.0, f"full_bf16: request 2's first step differs by {repeat[0]}")
    del pipe, models, outputs, steps
    gc.collect()
    torch.cuda.empty_cache()
    return run_counts


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
    tok = load_tokenizer(None, t5_cfg.vocab, t5_cfg.text_len, quiet=True)
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


TRAIN_HEADER = ("video,caption,projectile_force_magnitude,projectile_force_angle,"
                "projectile_coordx,projectile_coordy,width,height,"
                "target_indirect_force_magnitude,target_indirect_force_angle,target_coordx,"
                "target_coordy,projectile_mass,target_mass")


def _write_training_set(root, pc):
    """Balls, Dominos and Plants training sets in the reference's layout (a CSV beside
    its mp4 clips, 832x480, written with the port's writer): Balls clips hold 161 frames
    (the dataset takes every second one), Dominos and Plants 81; the Plants set has a
    carnation clip, which the dataset crops. Two rows per set, with different forces,
    so each set's calibration range is not empty. Returns {set: (base, csv)}."""
    import shutil

    from goal_force_tpu_torch.data.video_io import save_video

    image, _ = _request_inputs(61, 1, pc.height, pc.width, pc)
    first = (image * 255).astype(np.uint8)
    out = {}
    for name, n, files, rows in (
            ("balls", 2 * pc.num_frames - 1, ("ball0.mp4", "ball1.mp4"),
             ["ball0.mp4,a red ball rolls into a blue ball,150,30,300,200,832,480,80,45,"
              "520,260,1.5,2.0",
              "ball1.mp4,a marble hits a cup,260,200,400,240,832,480,140,90,600,300,3.0,2.5"]),
            ("dominos", pc.num_frames, ("domino0.mp4", "domino1.mp4"),
             ["domino0.mp4,dominoes fall to the right,220,0,200,240,832,480,60,0,500,240,2,2",
              "domino1.mp4,a domino tips over,120,180,600,200,832,480,130,180,300,200,1,2"]),
            ("plants", pc.num_frames, ("carnation_0.mp4", "ivy_0.mp4"),
             ["carnation_0.mp4,a carnation sways in the wind,40,100,416,240,832,480",
              "ivy_0.mp4,ivy leaves shake,80,200,300,200,832,480"])):
        base = os.path.join(root, name)
        os.makedirs(base)
        frames = np.stack([np.roll(first, 3 * t, axis=1) for t in range(n)])
        save_video(frames, os.path.join(base, files[0]), fps=15)
        shutil.copy(os.path.join(base, files[0]), os.path.join(base, files[1]))
        header = TRAIN_HEADER if name != "plants" else \
            "video,caption,force,angle,coordx,coordy,width,height"
        csv = os.path.join(base, "train.csv")
        with open(csv, "w") as f:
            f.write(header + "\n" + "\n".join(rows) + "\n")
        out[name] = (base, csv)
    return out


def phase_train_cli():
    """The training CLI's functions at train's config (full WAN22_A14B width, 4 DiT + 2
    ControlNet layers, umt5 at 2 layers, bf16, 81x480x832) on reference-format files:
    the frozen weights (the expert as 2 safetensors shards read through a glob, umt5 and
    the VAE as .pth, the VAE under "model.") and Balls, Dominos and Plants CSVs with mp4
    clips. --train_lora (rank 32) jointly with the ControlNet: 3 steps without a break
    (saving at step 2), then a resume from state-2 that takes step 3 again, which must
    repeat the first run's step 3 bit for bit. Checks the base expert, the adapters'
    B, the step-2 file's keys and the launches; logs the stages, the peaks and how many
    merged bf16 weights the adapters change."""
    import argparse
    import gc
    import shutil
    import tempfile

    from goal_force_tpu_torch import configs as C
    from goal_force_tpu_torch.io import safetensors_io as sio
    from goal_force_tpu_torch.lora import TARGETS, lora_to_peft, merged_weight
    from goal_force_tpu_torch.models import t5 as t5m
    from goal_force_tpu_torch.models import vae as vaem
    from goal_force_tpu_torch.models import wan_dit
    from goal_force_tpu_torch.ops import flash_attention as fa
    from goal_force_tpu_torch.scripts import train as tcli
    from goal_force_tpu_torch.training.train_step import trainable_params

    gc.collect()
    torch.cuda.empty_cache()
    dit_cfg = dataclasses.replace(C.WAN22_A14B, num_layers=4)
    t5_cfg = dataclasses.replace(C.UMT5_XXL, num_layers=2)
    pc = C.PipelineConfig()
    tmp = tempfile.mkdtemp(prefix="gf_train_cli_")
    try:
        t0 = time.perf_counter()
        gen = torch.Generator("cuda").manual_seed(5)
        sd = wan_dit.init_wan_dit(dit_cfg, gen, torch.bfloat16, device="cuda").state_dict()
        keys = sorted(sd)
        for i in range(2):
            sio.save_safetensors({k: sd[k] for k in keys[i::2]}, os.path.join(
                tmp, "high", f"diffusion_pytorch_model-0000{i + 1}-of-00002.safetensors"))
        del sd
        torch.save({k: v.cpu() for k, v in t5m.init_t5(t5_cfg, gen, torch.bfloat16,
                                                      device="cuda").state_dict().items()},
                   os.path.join(tmp, "models_t5_umt5-xxl-enc-bf16.pth"))
        torch.save({"model." + k: v.cpu() for k, v in vaem.init_vae(
            C.WAN21_VAE, gen, torch.bfloat16, device="cuda").state_dict().items()},
            os.path.join(tmp, "Wan2.1_VAE.pth"))
        sets = _write_training_set(os.path.join(tmp, "data"), pc)
        gc.collect()
        torch.cuda.empty_cache()
        log("train_cli", stage="files", seconds=time.perf_counter() - t0, bytes=_dir_bytes(tmp),
            files=sorted(os.path.relpath(os.path.join(d, x), tmp)
                         for d, _, fs in os.walk(tmp) for x in fs))
        argv = ["--high_noise_model", os.path.join(tmp, "high", "diffusion_pytorch_model-*.safetensors"),
                "--t5_path", os.path.join(tmp, "models_t5_umt5-xxl-enc-bf16.pth"),
                "--vae_path", os.path.join(tmp, "Wan2.1_VAE.pth"),
                "--controlnet_num_layers", "2", "--train_lora", "--lora_rank", "32",
                "--save_steps", "2", "--max_steps", "3", "--output_path", os.path.join(tmp, "run")]
        for name, (base, csv) in sets.items():
            argv += [f"--{name}_base_path", base, f"--{name}_metadata_path", csv]
        args = tcli.parse_args(argv)
        models, load_s = sync_time(lambda: tcli.load_models(args, dit_cfg=dit_cfg, t5_cfg=t5_cfg))
        dit = models["frozen"]["dit"]
        base_print = _fingerprint([dit])
        log("train_cli", stage="load", seconds=load_s,
            memory_gb=torch.cuda.memory_allocated() / 2**30)
        history = []
        fa.reset_launch_counts()
        state, secs = sync_time(lambda: tcli.run(args, models, tcli.build_datasets(args, seed=0),
                                                 history=history, keep_last_states=2))
        step3 = {n: t.detach().to("cpu", copy=True)
                 for n, t in trainable_params(state.params).items()}
        opt3 = {n: t.to("cpu", copy=True) for n, t in state.opt_state.items()}
        step2_keys = set(sio.load_safetensors(os.path.join(tmp, "run", "step-2.safetensors")))
        want_keys = set(lora_to_peft(state.params["lora"])) | set(
            sio.export_goalforce_controlnet(state.params["controlnet"]))
        del state
        gc.collect()
        for f in ("step-3.safetensors", "state-3.safetensors"):
            os.remove(os.path.join(tmp, "run", f))
        resume_args = argparse.Namespace(**{**vars(args), "resume": True, "max_steps": 1})
        resumed, secs_resume = sync_time(lambda: tcli.run(
            resume_args, models, tcli.build_datasets(args, seed=0), history=history,
            keep_last_states=2))
        launches = dict(fa.launch_counts)
        got = {n: t.detach().cpu() for n, t in trainable_params(resumed.params).items()}
        same = [n for n in step3 if torch.equal(got[n], step3[n])]
        same_opt = all(torch.equal(t.cpu(), opt3[n]) for n, t in resumed.opt_state.items())
        lora = resumed.params["lora"]
        b_moved = {t: bool(ab["b"].any()) for t, ab in lora.items()}
        changed, total, per_target = 0, 0, {}
        with torch.no_grad():
            for t, ab in lora.items():
                grp, leaf = TARGETS[t]
                n_t = 0
                for i, blk in enumerate(dit.blocks):
                    w = blk.get_submodule(f"{grp}.{leaf}").weight
                    n_t += int((merged_weight(w, ab["a"][i], ab["b"][i], 1.0) != w).sum())
                    total += w.numel()
                per_target[t] = n_t
                changed += n_t
        peak_gb = max(v for h in history for k, v in h.items() if k.endswith("_peak_gb"))
        for h in history:
            log("train_cli", stage=f"step{h['step']}", **h)
        # per step (every attention needs a gradient through the adapters): DiT 4 blocks x
        # (self, cross) and ControlNet 2 blocks x (self, cross) = 12 calls, K3 twice each
        # (remat), K5 once each, K4 where k and v need a gradient: the 4 DiT self calls
        # and all 4 ControlNet calls (the DiT's cross k, v come from the frozen text path).
        expected = only(K3=4 * 24, K4=4 * 8, K5=4 * 12)
        unchanged_base = _fingerprint([dit]) == base_print
        log("train_cli", stage="done", seconds_steps_1_3=secs, seconds_resume_step_3=secs_resume,
            launches=launches, expected_launches=expected, max_memory_allocated_gb=peak_gb,
            resumed_step3_equal=len(same) == len(step3), optimizer_state_equal=same_opt,
            trainable_tensors=len(step3), base_dit_unchanged=unchanged_base, b_moved=b_moved,
            step2_keys=len(step2_keys), step2_keys_as_expected=step2_keys == want_keys,
            merged_bf16_weights_changed=changed, merged_bf16_weights=total,
            merged_changed_fraction=changed / total, merged_changed_per_target=per_target,
            files=sorted(os.listdir(os.path.join(tmp, "run"))))
        check([h["step"] for h in history] == [1, 2, 3, 3], f"train_cli steps: {history}")
        check(all(math.isfinite(h["loss"]) and h["grad_norm"] > 0 for h in history),
              "train_cli: non-finite loss or zero gradient")
        check(launches == expected, f"train_cli launched {launches}, expected {expected}")
        check(unchanged_base, "train_cli: the base expert changed")
        check(all(b_moved.values()), f"train_cli: a B stayed at zero: {b_moved}")
        check(step2_keys == want_keys, "train_cli: step-2 holds other keys than the adapters' "
              "PEFT keys and the ControlNet's")
        check(len(same) == len(step3) and same_opt,
              f"train_cli: the resumed step 3 differs in {sorted(set(step3) - set(same))[:5]}")
        del models, resumed, dit, lora
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    card = phase_device()
    phase_build()
    measured = phase_kernels()
    phase_small()
    phase_small_train()
    phase_small_int8()
    pipe, main_launches, bf16_frames = phase_main()
    tc_launches = phase_teacache(pipe, bf16_frames[0])
    window_launches = phase_window(pipe, bf16_frames[0])
    cli_launches = phase_cli(pipe)
    unb_launches = phase_unbounded(pipe)
    variants_launches = phase_variants(pipe)
    int8_launches = phase_main_int8(pipe, bf16_frames)
    del pipe, bf16_frames
    t2v_vace_launches = phase_t2v_vace()
    fun_control_launches = phase_fun_control()
    train_launches = phase_train()
    train_cli_launches = phase_train_cli()
    full_launches = phase_full_int8()
    full_bf16_launches = phase_full_bf16()
    fwd = "goal_force_tpu_torch/csrc/flash_attention.cu"
    train_src = "goal_force_tpu_torch/csrc/flash_attention_bwd.cu"
    int8_src = "goal_force_tpu_torch/csrc/flash_attention_int8.cu"
    tpu = "goal_force_tpu/ops/flash_attention.py"
    kernels = []
    for name, src, line, launches, extra in (
            ("K1 flash_attention_nomax", fwd, 241, main_launches["K1"],
             {"cross": measured["K1"]["cross"], "window_self": measured["K1"]["window_self"],
              "window_cross": measured["K1"]["window_cross"],
              "teacache_launches": tc_launches["K1"], "window_launches": window_launches["K1"],
              "cli_launches": cli_launches["K1"],
              "full_bf16_launches": full_bf16_launches["K1"],
              **{k: measured["K1"][k] for k in ("ref_self", "ref_cross", "batch_self",
                                                "batch_cross")},
              "variants_launches": variants_launches["K1"],
              "t2v_vace_launches": t2v_vace_launches["K1"],
              "fun_control_launches": fun_control_launches["K1"]}),
            ("K2 flash_attention_max", fwd, 154, unb_launches["K2"],
             {"cross": measured["K2"]["cross"], "path": "unbounded (qk_bounded=False, q-norm x8)"}),
            ("K3 flash_attention_fwd_lse", train_src, 29, train_launches["K3"],
             {"cross": measured["K3"]["cross"], "path": "train",
              "train_cli_launches": train_cli_launches["K3"]}),
            ("K4 flash_attention_bwd_dkv", train_src, 76, train_launches["K4"],
             {"cross": measured["K4"]["cross"], "path": "train",
              "train_cli_launches": train_cli_launches["K4"]}),
            ("K5 flash_attention_bwd_dq", train_src, 118, train_launches["K5"],
             {"cross": measured["K5"]["cross"], "path": "train",
              "train_cli_launches": train_cli_launches["K5"]}),
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
