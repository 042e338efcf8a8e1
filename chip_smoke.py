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
             control video with it and with numpy (equal within 1e-6). While nvcc
             runs, the card runs the two phases that launch no kernel, vae38 (15d) and
             cog (15f); their lines come between the build's first line and its report.
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
             34,320 tokens) and at generate_batch's (B = 4, 32,760 tokens), and
             K1 through the runtime dispatch and K2 at speech-to-video's shapes (B = 1
             self 32,760^2 and cross x512, the audio injection's B = 20, 1,560 x 5 keys,
             with its tile edges at Skv 1, 2, 5 and 127 with and without kv_len) and K1
             at the image branch's B = 2, 32,760 x 257; times kernel, plain version, K6's
             quantize step, the runtime bound's reductions and host sync, and SDPA (as a
             yardstick only) at the path shapes; a plain version is timed on the run
             whose output the check compares.
3b. ring   - ring attention's per-rank functions (parallel/ring_attention.py) at full
             width for 4 virtual ranks on the one card (bf16, B = 1, 32,760 tokens as 4
             blocks of 8,190, 40x128 heads), fed each rank's queries and the K/V blocks in
             its rotation order: self (16 K3) and 512-key cross as 4 x 128 (16 K3) against
             the plain whole attention, then the backward (16 K4 + 16 K5) against the plain
             backward; times one virtual rank's forward and backward. No shift runs: no
             multi-GPU time is measured.
3c. pp     - pipeline parallel (models/wan_dit.py: GPipeStage and gpipe, the schedule of
             pp_run_blocks) at full A14B width for 4 virtual stages on the one card, in
             tick order, each stage's output handed to the next directly (no shift runs:
             no multi-GPU time is measured): bf16, 4 blocks (1 per stage), the merged-CFG
             batch of 2 (32,760 tokens, 512 text keys) as 2 microbatches, 3 ControlNet
             injections (on stages 0-2). Serving: each microbatch's output
             bit-equal to run_blocks on its row alone, 16 K1 (bubble ticks skip their
             blocks). Training: one forward + backward under remat through the schedule
             (every tick computes, bubbles too): the gradients of the input and the
             injections within two bf16 ulps of run_blocks' backward per microbatch, and
             K3/K4/K5 launched 40/16 times run_blocks' (20 stage-ticks of 2 blocks).
             Logs the seconds of each against run_blocks, each stage's weights and the
             most memory one of its ticks adds, and the bubble share (3/5).
4. small   - a head_dim-128 float32 pipeline at a small size, kernels vs plain
             attention (float32 convs without TF32 for the check).
5. small_train - one training loss + backward at that size, kernels vs plain attention
             (loss and every ControlNet gradient), and the launch counts of the rule.
6. small_int8 - the W8A8 linears on the card, then that pipeline with W8A8 packs in its
             four DiT/ControlNet models: K6 vs the plain int8 attention, K6 launches only.
6b. small_s2v - a head_dim-128 speech-to-video model (2 heads, 2 layers, audio
             injections after both) over the tiny T5 and VAE in float32: a plain and a
             motion request (9 frames, 256 x 256, 2 steps, CFG) through the kernels
             against plain attention (frames within 1e-2), 12 K1 per step exactly.
6c. small_hunyuan - the HunyuanVideo DiT forward at head_dim 128 (dim 256, 2 heads, 1
             double + 1 single block, 384 joint tokens, per-row kv_len 133 and 258) with
             attn_impl "flash" against "plain", float32 (1e-4 of the output's scale) and
             bf16 (3e-2 of it), 2 K1 launches each.
6d. small_cog - the LLaVA tower and a CogVideoX request on the card against the CPU.
6e. small_stepvideo - the StepVideo DiT forward at head_dim 128 (2 heads, 1 block, 256
             image tokens, 28 text keys), "auto" (K1 through the runtime bound, 2
             launches) against "plain", float32 and bf16; BERT, Step-1 and the tiny VAE's
             chunked decode on the card against the CPU (float32) and in bf16 (towers).
6f. small_flux - a Flux DiT at head_dim 128 (2 heads, 1 joint + 1 single block, 256
             image tokens behind 20 text tokens) and a Union ControlNet at that width
             (1 + 1 blocks, a mode token), "auto" (K1 through the runtime bound, 2
             launches each) against "plain", float32 and bf16; the tiny 16-channel VAE's
             decode on the card against the CPU (float32) and over bf16 weights.
6g. small_sd3 - SD3's tiny pipeline (an SD3.5-shaped DiT with a dual block and RMS q/k
             norms, the tiny CLIP-L, bigG, T5 and VAE): one 32x32 request (2 steps,
             merged CFG) on the card against the CPU over the same float32 weights (1e-4);
             head_dim 64, so no kernel launch.
6h. small_qwen_image - a Qwen-Image DiT at head_dim 128 (2 heads, 2 blocks, 256 image
             tokens, an extra image's 64 and 20 text tokens) with the blockwise ControlNet,
             "auto" (K1 through the runtime bound, 2 launches) against "plain", float32 and
             bf16; the tiny Qwen2.5-VL text and vision towers and the tiny VAE's encode and
             decode on the card against the CPU (float32).
6i. small_nexus_gen - Nexus-Gen's pipeline over a small Flux at head_dim 128 (2 heads, 1
             joint + 1 single block) with a tiny Qwen2.5-VL text stack, heads, adapter and
             merger, float32 on the card (K1 behind the runtime bound) against the CPU: a
             64x64 request and an edit, 2 steps each (8 K1), images within 1e-4; the
             cached AR loop against the teacher-forced forward; greedy tokens.
6j. small_hunyuan_dit, small_omnigen - the tiny HunyuanDiT (CFG with a regional prompt)
             and OmniGen (a reference image, three branches, the condition cache)
             pipelines on the card against the CPU (1e-4); no kernel launch.
7. main    - GoalForcePipeline at full A14B width (depth cut to 3 DiT + 2 ControlNet
             layers per expert, 2 umt5 layers, full Wan2.1 VAE), random weights from a
             seed, answering two 81x480x832 requests of 4 steps each; launch counts
             are reset just before and read just after.
7b. sharded - main's first request through the multi-GPU path (ROADMAP M13a's serving
             half) on one card: an NCCL world of one rank, make_mesh(1, 1, 1, pp=1) (the
             3-axis mesh, checked) and
             pipe.shard(mesh), so every collective (Ulysses all-to-alls, tensor-parallel
             all-reduces, token and batch gathers) runs as a copy over a group of one;
             the request runs with attn_impl="ring" ("sp" = 1: the sharded "auto"
             path): frames within 1e-3 of main's, 10 K1 per step, the collectives per
             step as counted by collectives_per_step; logs step seconds beside main's
             and PSNR / SSIM of the two frame sets (utils/metrics.py, on a thread beside
             the next phases; logged before the kernels line). No multi-GPU time is
             measured.
7c. tools  - the base-model demo (--tiny_random --device cuda, 9 frames at 64x96)
             writes an mp4; extract_first_frame, extract_canny_edges and compare_videos
             run on it.
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
12. variants - first generate_batch of main's two requests on main's pipeline (81 frames,
             4 steps, 10 K1 per step at B = 4), which must equal main's frames within
             1e-2; then full-width adapters (a motion controller and a camera
             SimpleAdapter written in the reference formats and read back through
             from_pretrained's loaders, a Fun-Reference ref_conv in both experts), 2-step
             requests: at 33 frames the plain request, end_image, v2v, motion_bucket_id,
             camera "Left" and a strided ControlNet (stride 2), 10 K1 per step each; at 81
             frames the plain request without ControlNet and Fun-Reference (6 K1 per
             step, 34,320 tokens). Each request's frames must differ from its plain request's; logs launches
             per step, stage seconds and peak memory, then v2v's untiled 81-frame encode
             (its peak, or the allocation it was refused).
13. main_int8 - main's pipeline quantized in place (W8A8 block linears) with
             attn_impl="flash_int8": the same two requests, 40 K6 launches each and no
             other, and the frames' mean distance from main's bf16 frames; then the first
             request through shard() over the world of one, within 1e-3 of its unsharded
             frames with the same launches.
14. t2v_vace - a full-width t2v pipeline (in_dim 16, 3 DiT layers, no ControlNet) with
             VACE hint blocks after layers 0 and 2 (written and read back through
             from_pretrained's loader): a t2v request (6 K1 per step) and a VACE request
             with video, mask and reference image (34,320 tokens, 10 K1 per step), 2
             steps at 81x480x832.
15. fun_control - a full-width Fun-Control pipeline (in_dim 52, 4 DiT layers): two
             33-frame requests with two control videos (8 K1 per step), frames differ.
15b. s2v  - S2VPipeline at Wan2.2-S2V-14B widths (dim 5120, 40x128 heads, ffn 13824,
             audio_dim 1024 over 25 wav2vec2 layers, 4 audio tokens), 2 of 40 layers with
             audio injections after layers 0 and 1, 2 of 24 umt5 layers, the full Wan2.1
             VAE, random weights, 2 steps at CFG 5.0: audio features from a random
             wav2vec2-large-shaped model on the card (save_pretrained, read back,
             extract, the first bucket), then (a) 81x480x832 (32,760 self tokens, the
             audio injection at B = 20, 1,560 x 5 keys), (b) a pose video at 33 frames,
             (c) a 73-frame motion video at 448x832 and 17 frames (its untiled float32
             decode of 23 latent frames is the largest that fit), each 12 K1 per step;
             (d) one step with every self-attention's norm_q x8 (4 K2 + 8 K1), and the
             same step with and without the runtime bound's host sync, timed.
15b'. sharded_s2v - request (b) again with the pipeline's mesh set to the NCCL world of
             one (every attention takes its heads and batch rows and gathers them back):
             frames equal to (b)'s, the same K1/K2 launches, the collectives counted.
15c. image_branch - the CLIP ViT-H/14 vision tower at full width encodes one 480x832
             frame; an I2V DiT at Wan2.1-I2V-14B-480P widths (in_dim 36, 4 of 40 layers,
             img_emb, k_img/v_img) runs one forward at B = 2, 81x480x832, with the
             frame's clip_feature (12 K1) and without (8 K1); the outputs differ.
15d. vae38 - the Wan2.2 VAE (z 48, 16x) at full width, random weights: encode and
             decode one 81x480x832 video in float32, untiled; times and peaks.
15e. hunyuan - HunyuanVideo text-to-video at full width and depth, random bf16 weights:
             the 12.8 B DiT (20 double + 40 single blocks, 24x128 heads), the 32-layer
             Llama tower, CLIP-L with the vendored BPE tokenizer, the VAE decoder; one
             720x1280x129 request (119,056 joint tokens, 2 steps, embedded guidance 6.0,
             tiled decode with JAX's default tiles): 120 K1 launches, finite
             (1, 129, 720, 1280, 3) frames; text, step, decode seconds and the peak. Then
             K1 at B = 2, 67,576 tokens, 24 heads, per-row kv_len 67,397 / 67,520, and at
             the path's B = 1, 119,056 tokens with the kv_len the request's joint
             attentions were given, each against its plain version (two bf16 ulps); times
             both with their bound and SDPA given the same key mask.
15f. hunyuan_i2v, cog - HunyuanVideo-I2V's LLaVA prompt path; CogVideoX-5B at cut depth.
15g. stepvideo - StepVideo-T2V at its released widths (the DiT at 4 of 48 blocks,
             Step-1 at 2 of 48 layers, BERT and the VAE decoder whole), random weights:
             one 544x992 request of 34 frames (12,648 tokens, 2 decode chunks), 2 steps of
             CFG 9.0 as two forwards each: 32 K1 through the runtime bound (32 syncs),
             finite (34, 544, 992, 3) frames; one forward with the q norms x8 (8 K2)
             against the plain path; K1 at the full path's (1, 75,888, 48, 128) self and
             x397 cross, against its plain version on 4 heads, timed beside its bound,
             the bound's sync and SDPA.
15h. flux  - FLUX.1-dev at its released configuration and full depth (dim 3072, 24x128
             heads, 19 joint + 38 single blocks, bf16, 23.8 GB), CLIP-L whole, T5 v1.1
             XXL at 2 of 24 layers on the vendored tokenizers (512 tokens), the 16-channel
             VAE at full width (float32 compute over bf16 weights) and a Union ControlNet
             (5 + 10 blocks, 10 modes), random weights: at 1024x1024 (a) text-to-image,
             2 steps, guidance 3.5; (b) CFG 2.0 with a negative prompt, 1 step, as one
             merged batch of 2; (c) image-to-image from (a)'s image at strength 0.5, 2
             steps; (d) one ControlNet step with a mode; (e) one Kontext step (8,704
             tokens): 57 K1 per DiT forward and 15 per ControlNet forward, one bound sync
             each, 0 K2, finite (1024, 1024, 3) images. Then one forward with the q norms
             x8 (57 K2) against the plain path, the bound's cost per forward, and K1 at the
             path's (1, 4,608), (2, 4,608) and (1, 8,704) x 24 x 128 against its plain
             version on every head, timed beside its bound, the bound's sync and SDPA.
15h'. nexus_gen - Nexus-Gen at full width and depth (after flux): Qwen2.5-VL-7B's text
             stack (28 layers, LM head), vision head, 81-entry prefill table, adapter,
             one-layer merger and vision tower over FLUX.1-dev (19 + 38 blocks), CLIP-L,
             T5 at 2 of 24 layers and the VAE, random bf16 weights: (a) a 1024x1024
             request, 2 steps (4,177 joint tokens: 57 K1 per forward, one bound sync
             each); (b) the cached AR loop against the teacher-forced forward; (c) an edit
             with the vision tower's 324 tokens of a 504x504 image (4,501 joint tokens),
             2 steps; (d) 16 greedy tokens; the bound's cost, 57 K2 past it against the
             plain path, K1 at both path shapes timed beside its bound and SDPA.
15i. sd3   - SD3.5-Large at its released widths and full depth (38 blocks of 2432,
             38x64 heads, RMS q/k norms, pos-embed 192, bf16, 16.2 GB), CLIP-L and bigG
             whole, T5 v1.1 XXL at 2 of 24 layers on the vendored tokenizers, the
             16-channel VAE, random weights: at 1024x1024 (a) text-to-image, 2 of 28 steps,
             CFG 7.0 as one merged batch of 2; (b) image-to-image from (a)'s image at
             strength 0.5, 1 step; (c) one step of SD3.5-Medium at its released widths and
             depth (24 blocks of 1536, 13 dual, pos-embed 384): finite (1024, 1024, 3)
             images and no kernel launch (head_dim 64: the plain attention); then the plain
             attention at both path shapes (2, 4,301) x 38 or 24 x 64, timed beside SDPA.
15j. qwen_image - Qwen-Image at its released configuration and full depth (60 blocks of
             3072, 24x128 heads, bf16, 40.9 GB), Qwen2.5-VL-7B's text (28 layers) and
             vision (32 layers) towers, the Wan-architecture VAE (float32) and the
             60-block ControlNet, random weights: at 1328x1328 (a) text-to-image, 2 of 30
             steps, CFG 4.0 as two forwards a step (6,903 joint tokens); (b) the
             ControlNet and (c) Qwen-Image-Edit with (a)'s image (the vision tower, 4,096
             more image tokens), 2 steps each: 60 K1 per forward, one bound sync each, 0
             K2, finite (1328, 1328, 3) images. Then one forward with the q norms x8 (60
             K2) against the plain path, the bound's cost per forward, and K1 at the
             path's t2i and edit shapes against its plain version on every head, timed
             beside its bound, the bound's sync and SDPA.
15k. hunyuan_dit - HunyuanDiT at its released configuration (40 blocks of 1,408, 16x88
             heads), its BERT tower and mT5-XL's encoder whole, the SD VAE in float32:
             a 1024x1024 merged-CFG request (2 DDIM steps) and an image-to-image step, no
             kernel launch (head_dim 88); the plain attention at (2, 4,096, 16, 88)^2
             beside SDPA.
15l. omnigen - OmniGen-v1 (Phi-3: 32 layers of 3,072, 32x96 heads) with the SD VAE in
             float32: a 1024x1024 request (two branches, the condition cache) and one
             with a 512x512 reference image (three branches), 2 steps each, no kernel
             launch (head_dim 96); a cached step against the same step uncached; the
             plain attention at (1, 4,121, 32, 96)^2 beside SDPA.
16. train  - frees the serving pipeline and trains the ControlNet at full A14B width
             (2 DiT + 2 ControlNet layers, bf16, B = 1, 81x480x832 synthetic clips): 2
             steps, a checkpoint, a full-state resume and a 3rd step; checks the loss,
             the frozen models, the checkpoint and the launches per step, and logs the
             stage split and peak memory.
16b. sharded_train - train's first two steps through train(mesh=) over the NCCL world
             of one, FSDP-placed, the VAE encodes through the spatial split
             (parallel/spatial.py: no axis splits over one rank, the latents are
             gathered): bit-equal to train, the launches and collectives per step, the
             encodes' seconds and peaks beside train's.
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

Each phase logs {"stage": "start"} with its start time "t" first. The second-to-last line
is nvidia-smi's "name, power.limit"; before it, one JSON line lists each kernel's
launches, error and times; the last line is the result JSON.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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
# main's depth (3 DiT layers, cut from 4 for the smoke's time; the strided ControlNet of
# `variants` reads DiT blocks 0 and 2) and ControlNet
MAIN_LAYERS, MAIN_CN_LAYERS = 3, 2
K1_PER_STEP = 2 * (MAIN_LAYERS + MAIN_CN_LAYERS)    # self + cross per DiT and CN block
K1_PER_REQUEST = K1_PER_STEP * STEPS
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


_BACKGROUND = []


def in_background(fn, *args, done=None):
    """fn(*args) on a thread, beside the card's work: host-only work (numpy metrics,
    deleting temporary files) that nothing after it reads. ``finish_background`` joins
    the threads in turn, re-raises what one raised, and calls done(result) on the main
    thread (so its log line stays whole)."""
    import threading

    box = {}

    def run():
        try:
            box["out"] = fn(*args)
        except BaseException as e:      # re-raised on the main thread
            box["err"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    _BACKGROUND.append((thread, box, done))


def finish_background():
    while _BACKGROUND:
        thread, box, done = _BACKGROUND.pop(0)
        thread.join()
        if "err" in box:
            raise box["err"]
        if done is not None:
            done(box["out"])


def remove_later(path):
    """Deletes a temporary directory on a thread (``in_background``)."""
    import shutil

    in_background(shutil.rmtree, path, True)


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


def timed_call(fn):
    """fn()'s result and the milliseconds of that one call (CUDA events around it): the
    plain versions are timed on the run whose output the check compares."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _time_stages(obj, stages, **attrs):
    """Wraps each named function of obj so that every call's synchronised seconds append
    to stages[key] (attrs: name -> key); returns the unwrapped functions by name."""
    real = {}
    for attr, key in attrs.items():
        def run(*a, _fn=getattr(obj, attr), _key=key, **kw):
            out, secs = sync_time(lambda: _fn(*a, **kw))
            stages.setdefault(_key, []).append(secs)
            return out
        real[attr] = getattr(obj, attr)
        setattr(obj, attr, run)
    return real


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


def _import_wav2vec2():
    from transformers import Wav2Vec2Config, Wav2Vec2ForCTC  # noqa: F401


def start_build():
    """nvcc on a thread (one process per source, started together), so that the card
    runs the phases that launch no kernel meanwhile; ``phase_build`` joins it."""
    import threading

    from goal_force_tpu_torch.ops import _build

    in_background(_import_wav2vec2)      # s2v's transformers import, while nvcc runs
    box = {}

    def run():
        t0 = time.perf_counter()
        try:
            _build.load_all()
        except BaseException as e:      # re-raised by phase_build
            box["err"] = e
        box["secs"] = time.perf_counter() - t0

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return thread, box


def phase_build(pending):
    from goal_force_tpu_torch.ops import _build

    thread, box = pending
    thread.join()
    if "err" in box:
        raise box["err"]
    secs = box["secs"]
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
    stems = ("flash_attention", "flash_attention_int8", "flash_attention_bwd")
    with ThreadPoolExecutor(len(stems)) as pool:      # one cuobjdump per library, together
        sass = list(pool.map(lambda stem: _sass_counts(_build.library_path(stem)), stems))
    for stem, counts in zip(stems, sass):
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
    for name, recs in _s2v_kernels().items():
        out[name].update(recs)
    out.update(_training_kernels())
    out.update(_int8_kernels())
    return out


# Speech-to-video: every attention of S2V takes the runtime logit bound, then K1
# without clamp (or K2). CFG runs two batch-1 forwards, so self-attention is B = 1 over
# 32,760 tokens and the text cross-attention 32,760 x 512; the audio injection attends each
# of the 20 latent frames' 1,560 video tokens to that frame's 5 audio keys (B = 20). The
# I2V image branch adds a cross-attention over 257 CLIP keys at B = 2, bounded (K1 with
# its clamp).
S2V_SELF = (1, 32760, 40, 128)
S2V_CROSS_KV = (1, 512, 40, 128)
AUDIO_Q, AUDIO_KV = (20, 1560, 40, 128), (20, 5, 40, 128)
IMAGE_KV = (2, 257, 40, 128)
AUDIO_EDGES = (1, 2, 5, 127)     # keys per audio row: under one 128-key tile, and one short


def _timed_record(kern, plain_ms, q, k, v, err):
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bound, by = attention_bound_ms(q.shape, k.shape)
    return dict(max_abs_err=err, ms=event_ms(lambda: kern(q, k, v)), plain_ms=plain_ms,
                bound_ms=bound, bound_by=by,
                library_ms=event_ms(lambda: sdpa(q.transpose(1, 2), k.transpose(1, 2),
                                                 v.transpose(1, 2))),
                shape=f"{tuple(q.shape)}x{tuple(k.shape)}")


def _s2v_kernels(timed=True):
    """K1 (through dispatch "auto": the runtime bound, then K1 without clamp) and K2
    against their plain versions at S2V's shapes (the audio injection's B = 20, 1,560 x 5;
    B = 1 self 32,760^2 and cross 32,760 x 512), K1 with its clamp at the image branch's
    B = 2, 32,760 x 257, and both at the audio shape's tile edges (Skv 1, 2, 5 and 127, with
    and without a per-row kv_len); times kernel, plain version, SDPA and the bound's host
    sync at the new shapes."""
    from goal_force_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator("cuda").manual_seed(4321)
    scale = 128**-0.5
    out = {"K1": {}, "K2": {}}
    # Tile edges at the audio shape: every row's few keys sit in the one key tile whose
    # box TMA zero-fills past them; kv_len gives rows 0 .. skv valid keys in turn.
    for skv in AUDIO_EDGES:
        q = _rand(AUDIO_Q, gen, torch.bfloat16)
        k, v = (_rand((20, skv, 40, 128), gen, torch.bfloat16) for _ in range(2))
        lens = torch.tensor([i % (skv + 1) for i in range(20)], device="cuda")
        for kname, kern, plain, kw, what in (
                ("K1", fa.flash_attention_nomax, fa.flash_attention_nomax_plain,
                 dict(clamp=None), "no clamp"),
                ("K1", fa.flash_attention_nomax, fa.flash_attention_nomax_plain,
                 dict(kv_len=lens, clamp=None), "no clamp, kv_len"),
                ("K1", fa.flash_attention_nomax, fa.flash_attention_nomax_plain,
                 dict(kv_len=lens), "clamp, kv_len"),
                ("K2", fa.flash_attention_max, fa.flash_attention_max_plain, {}, "all keys"),
                ("K2", fa.flash_attention_max, fa.flash_attention_max_plain,
                 dict(kv_len=lens), "kv_len")):
            got = kern(q, k, v, scale, **kw)
            ref = plain(q, k, v, scale, **kw)
            if "kv_len" in kw:
                check(bool((got[lens == 0] == 0).all()),
                      f"{kname} audio edge Skv={skv}: a row with no key is not 0")
            compare(f"{kname} audio edge (20,1560,40,128)x(20,{skv},40,128) bf16 {what}", got,
                    ref, atol=bf16_limit(ref), rtol=0.0)
        del q, k, v
    # The path's shapes. K1 is reached as S2V reaches it: flash_attention(dispatch="auto"),
    # which must pick K1 there (random normal q and k stay far under NOMAX_BOUND).
    auto = lambda a, b, c: fa.flash_attention(a, b, c, scale, dispatch="auto")
    k1 = lambda a, b, c: fa.flash_attention_nomax(a, b, c, scale, clamp=None)
    k1_plain = lambda a, b, c: fa.flash_attention_nomax_plain(a, b, c, scale, clamp=None)
    k2 = lambda a, b, c: fa.flash_attention_max(a, b, c, scale)
    k2_plain = lambda a, b, c: fa.flash_attention_max_plain(a, b, c, scale)
    for tag, qshape, kvshape in (("audio", AUDIO_Q, AUDIO_KV), ("s2v_self", S2V_SELF, S2V_SELF),
                                 ("s2v_cross", S2V_SELF, S2V_CROSS_KV)):
        q, k, v = _rand(qshape, gen, torch.bfloat16), *(_rand(kvshape, gen, torch.bfloat16)
                                                       for _ in range(2))
        for kname, kern, plain in (("K1", k1, k1_plain), ("K2", k2, k2_plain)):
            got, n = picked(lambda: (auto if kname == "K1" else kern)(q, k, v))
            check(n == only(**{kname: 1}), f"{kname} {tag}: launched {n}")
            ref, plain_ms = timed_call(lambda: plain(q, k, v))
            atol = {"s2v_self": 1e-3, "s2v_cross": 1e-2}.get(tag, bf16_limit(ref))
            err = compare(f"{kname} {tag} {tuple(q.shape)}x{tuple(k.shape)} bf16", got, ref,
                          atol=atol, rtol=0.0)
            del got, ref
            torch.cuda.empty_cache()
            if timed:
                out[kname][tag] = _timed_record(kern, plain_ms, q, k, v, err)
                log("kernels", case=f"{kname} {tag} timing", **out[kname][tag])
        if timed:
            # the runtime bound alone (its reductions and the one host sync per call), and
            # the whole call as S2V makes it: bound, then K1
            rec = out["K1"][tag]
            rec["bound_sync_ms"] = event_ms(lambda: float(fa.logit_bound(q, k, v, scale)))
            rec["dispatch_ms"] = event_ms(lambda: auto(q, k, v))
            log("kernels", case=f"logit bound {tag}", bound_sync_ms=rec["bound_sync_ms"],
                dispatch_ms=rec["dispatch_ms"])
        del q, k, v
        torch.cuda.empty_cache()
    # The image branch's cross-attention over 257 CLIP tokens (bounded: K1 with its clamp).
    q = _rand(SELF, gen, torch.bfloat16)
    k, v = (_rand(IMAGE_KV, gen, torch.bfloat16) for _ in range(2))
    kern = lambda a, b, c: fa.flash_attention_nomax(a, b, c, scale)
    plain = lambda a, b, c: fa.flash_attention_nomax_plain(a, b, c, scale)
    got = kern(q, k, v)
    ref, plain_ms = timed_call(lambda: plain(q, k, v))
    err = compare(f"K1 image_cross {tuple(q.shape)}x{tuple(k.shape)} bf16", got, ref,
                  atol=1e-2, rtol=0.0)
    del got, ref
    if timed:
        out["K1"]["image_cross"] = _timed_record(kern, plain_ms, q, k, v, err)
        log("kernels", case="K1 image_cross timing", **out["K1"]["image_cross"])
    del q, k, v
    torch.cuda.empty_cache()
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
            ref, plain_ms = timed_call(lambda: plain(q, kk, vv))
            err = compare(f"{kname} {sname} {tuple(q.shape)}x{tuple(kk.shape)} bf16", got, ref,
                          **bf16_tol_shape[sname])
            del got, ref
            torch.cuda.empty_cache()
            if not timed:
                continue
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
        ref, plain_ms = timed_call(lambda: plain(q, kk, vv))
        err = compare(f"K1 window {sname} {tuple(q.shape)}x{tuple(kk.shape)} bf16", got, ref,
                      **bf16_tol_shape[sname])
        del got, ref
        torch.cuda.empty_cache()
        if not timed:
            continue
        bound, by = attention_bound_ms(q.shape, kk.shape)
        rec = dict(max_abs_err=err, ms=event_ms(lambda: kern(q, kk, vv)), plain_ms=plain_ms,
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
            ref, plain_ms = timed_call(lambda: plain(q, kk, vv))
            err = compare(f"K1 {tag} {sname} {tuple(q.shape)}x{tuple(kk.shape)} bf16", got, ref,
                          **bf16_tol_shape[sname])
            del got, ref
            torch.cuda.empty_cache()
            if not timed:
                continue
            bound, by = attention_bound_ms(q.shape, kk.shape)
            rec = dict(max_abs_err=err, ms=event_ms(lambda: kern(q, kk, vv)), plain_ms=plain_ms,
                       bound_ms=bound, bound_by=by,
                       library_ms=event_ms(lambda: sdpa(q.transpose(1, 2), kk.transpose(1, 2),
                                                        vv.transpose(1, 2))),
                       shape=f"{tuple(q.shape)}x{tuple(kk.shape)}")
            out["K1"][f"{tag}_{sname}"] = rec
            log("kernels", case=f"K1 {tag} {sname} timing", **rec)
        del q, k, v, ck, cv
        torch.cuda.empty_cache()
    return out


RING_RANKS = 4     # virtual ranks of the ring phase: 32,760 tokens as 4 blocks of 8,190


def _rotation(blocks, r):
    """Virtual rank r's K/V blocks in the order the ring delivers them: its own, then
    rank r-1's, and so on."""
    n = len(blocks)
    return [blocks[(r - i) % n] for i in range(n)]


def phase_ring(measured):
    """Ring attention's per-rank functions (parallel/ring_attention.py) at full width for
    RING_RANKS virtual ranks on the one card, fed directly with each rank's queries and
    the K/V blocks in its rotation order (the shift, the only collective, is not run: no
    multi-GPU time is measured). bf16, B = 1, 32,760 tokens, 40 x 128 heads, split into 4
    blocks of 8,190: self (16 K3) and cross against 512 keys as 4 x 128 (16 K3), each
    merged output against the plain whole attention at K1's limits for the shape (self
    1e-3, cross 1e-2, and the mean signed error) and the merged lse within 1e-5; then
    the backward (16 K4 + 16 K5) under the merged o and lse, the dk/dv shares summed by
    the blocks' owners, against the plain backward's dq, dk and dv at two bf16 ulps of
    their largest (K4/K5's limit). Times one virtual rank's forward and backward beside a
    quarter of this run's K3 and K4 + K5 at the training self shape."""
    import gc

    from goal_force_tpu_torch.ops import flash_attention as fa
    from goal_force_tpu_torch.parallel.ring_attention import ring_backward, ring_forward

    gen = torch.Generator("cuda").manual_seed(4322)
    scale = 128**-0.5
    n = RING_RANKS
    q, k, v, do = (_rand(TRAIN_SELF, gen, torch.bfloat16) for _ in range(4))
    kc, vc = (_rand(TRAIN_CROSS_KV, gen, torch.bfloat16) for _ in range(2))
    qs, dos = q.chunk(n, dim=1), do.chunk(n, dim=1)
    launches = only()
    rec = {}
    limits = {"self": dict(atol=1e-3, rtol=0.0), "cross": dict(atol=1e-2, rtol=0.0)}
    for kind, kk, vv in (("self", k, v), ("cross", kc, vc)):
        blocks = list(zip(kk.chunk(n, dim=1), vv.chunk(n, dim=1)))
        res, cnt = picked(lambda: [ring_forward(qs[r], _rotation(blocks, r), scale)
                                   for r in range(n)])
        check(cnt == only(K3=n * n), f"ring {kind} forward launched {cnt}")
        launches["K3"] += cnt["K3"]
        o = torch.cat([o for o, _ in res], dim=1)
        lse = torch.cat([l for _, l in res], dim=2)
        del res
        o_ref, lse_ref = fa.flash_attention_fwd_lse_plain(q, kk, vv, scale)
        err = compare(f"ring {kind} o {TRAIN_SELF}x{tuple(kk.shape)} as {n} blocks", o, o_ref,
                      phase="ring", **limits[kind])
        compare(f"ring {kind} lse", lse, lse_ref, atol=1e-5, rtol=1e-5, phase="ring")
        rec[kind] = dict(max_abs_err=err, fwd_rank_ms=event_ms(
            lambda: ring_forward(qs[0], _rotation(blocks, 0), scale)))
        if kind == "cross":
            del o, lse, o_ref, lse_ref
            continue
        # the backward under the merged o and lse, as _RingFn runs it
        dk, dv = torch.zeros_like(k, dtype=torch.float32), torch.zeros_like(v, dtype=torch.float32)
        per = TRAIN_SELF[1] // n

        def backward(r):
            def block_grads(i, dk_i, dv_i):
                j = (r - i) % n                   # the block's owner
                dk[:, j * per:(j + 1) * per] += dk_i.float()
                dv[:, j * per:(j + 1) * per] += dv_i.float()
            return ring_backward(qs[r], o.chunk(n, dim=1)[r], lse.chunk(n, dim=2)[r].contiguous(),
                                 dos[r], _rotation(blocks, r), scale, block_grads)

        dq, cnt = picked(lambda: torch.cat([backward(r) for r in range(n)], dim=1))
        check(cnt == only(K4=n * n, K5=n * n), f"ring backward launched {cnt}")
        launches["K4"] += cnt["K4"]
        launches["K5"] += cnt["K5"]
        dk_ref, dv_ref = fa.flash_attention_bwd_dkv_plain(q, k, v, o_ref, do, lse_ref, scale)
        rec["bwd_err"] = max(
            compare("ring dk (16 K4)", dk.to(k.dtype), dk_ref, atol=bf16_limit(dk_ref), rtol=0.0,
                    phase="ring"),
            compare("ring dv (16 K4)", dv.to(v.dtype), dv_ref, atol=bf16_limit(dv_ref), rtol=0.0,
                    phase="ring"))
        del dk_ref, dv_ref
        dq_ref = fa.flash_attention_bwd_dq_plain(q, k, v, o_ref, do, lse_ref, scale)
        rec["bwd_err"] = max(rec["bwd_err"], compare("ring dq (16 K5)", dq, dq_ref,
                                                     atol=bf16_limit(dq_ref), rtol=0.0,
                                                     phase="ring"))
        del dq_ref, o_ref, lse_ref
        o0, lse0 = o.chunk(n, dim=1)[0], lse.chunk(n, dim=2)[0].contiguous()
        rec["bwd_rank_ms"] = event_ms(lambda: ring_backward(
            qs[0], o0, lse0, dos[0], _rotation(blocks, 0), scale, lambda i, a, b: None))
        del o, lse, dq, dk, dv
        gc.collect()
        torch.cuda.empty_cache()
    quarter = {"K3": measured["K3"]["self"]["ms"] / n,
               "K4_K5": (measured["K4"]["self"]["ms"] + measured["K5"]["self"]["ms"]) / n}
    log("ring", virtual_ranks=n, launches=launches, self_fwd_rank_ms=rec["self"]["fwd_rank_ms"],
        k3_self_ms_over_4=quarter["K3"], cross_fwd_rank_ms=rec["cross"]["fwd_rank_ms"],
        k3_cross_ms_over_4=measured["K3"]["cross"]["ms"] / n,
        self_bwd_rank_ms=rec["bwd_rank_ms"], k4_k5_self_ms_over_4=quarter["K4_K5"],
        note="one card, virtual ranks: no shift runs, no multi-GPU time is measured")
    return launches, rec


# 1 block per stage (cut from 8 blocks, 2 per stage, for the smoke's time);
# the 3 injections after blocks 0-2 land on stages 0-2
PP_STAGES, PP_BLOCKS, PP_INJECTIONS = 4, 4, 3
PP_PER_STAGE = PP_BLOCKS // PP_STAGES


def _pp_stages(blocks, x, ctx, t_mod, cos, sin, cfg, injections, remat=False):
    """PP_STAGES virtual stages of the GPipe schedule (2 microbatches), each with its
    layers' injections."""
    from goal_force_tpu_torch.models import wan_dit

    per = PP_PER_STAGE
    return [wan_dit.GPipeStage(blocks, x, ctx, t_mod, cos, sin, cfg, s, PP_STAGES, 2,
                               injections[s * per:(s + 1) * per], remat=remat)
            for s in range(PP_STAGES)]


def _pp_schedule(stages):
    """pp_run_blocks' ticks over virtual stages on one card: each stage's output handed to
    the next directly (stage 0 receives zeros, as the shift without wraparound gives it),
    and the drained slots summed over the stages (the psum over "pp")."""
    from goal_force_tpu_torch.models import wan_dit

    drained = wan_dit.gpipe(stages, lambda outs: [torch.zeros_like(outs[0])] + outs[:-1])
    return wan_dit.from_microbatches(sum(drained))


def phase_pp():
    """Pipeline parallel (models/wan_dit.py: GPipeStage and gpipe, the schedule of
    pp_run_blocks) at full A14B width for PP_STAGES virtual stages on the one card, run in
    tick order with each stage's output handed to the next directly: no shift runs, and
    no multi-GPU time is measured. bf16, PP_BLOCKS blocks (PP_PER_STAGE per stage), the
    merged-CFG batch of 2 (32,760 tokens, 512 text keys) as 2 microbatches, 3 ControlNet
    injections (after blocks 0-2). Serving: each microbatch's output bit-equal to
    run_blocks over the blocks on its row alone, 2 K1 per block per microbatch (the
    bubble ticks skip their blocks). Training: one forward + backward of sum(out * w)
    under remat through the schedule, where every tick computes (the bubbles too: the
    gates keep every buffer in the graph): the gradients of the input and of the
    injections within two bf16 ulps of their largest (K4/K5's limit) of run_blocks'
    backward per microbatch, and K3/K4/K5 launched 2.5 times as often (20 stage-ticks of
    PP_PER_STAGE blocks against 2 microbatches x PP_BLOCKS blocks). Logs the seconds of each against run_blocks, each
    stage's weights and the largest memory a tick of it adds, and the bubble share."""
    import gc

    from goal_force_tpu_torch import configs as C
    from goal_force_tpu_torch.models import wan_dit

    cfg = dataclasses.replace(C.WAN22_A14B, num_layers=PP_BLOCKS)
    bf16 = torch.bfloat16
    gen = torch.Generator("cuda").manual_seed(4323)
    blocks = torch.nn.ModuleList(wan_dit.empty_module(wan_dit.WanBlock, cfg, dtype=bf16,
                                                      device="cuda") for _ in range(PP_BLOCKS))
    with torch.no_grad():
        for blk in blocks:
            wan_dit.init_block_(blk, gen)
    blocks.requires_grad_(False)
    cos, sin = wan_dit.rope_for_grid(cfg, (21, 30, 52), "cuda")
    x, w = (_rand((2, 32760, cfg.dim), gen, bf16) for _ in range(2))
    ctx = _rand((2, 512, cfg.dim), gen, bf16)
    t_mod = _rand((2, 6, cfg.dim), gen, bf16, 0.1)
    inj = [_rand((2, 32760, cfg.dim), gen, bf16, 0.1) for _ in range(PP_INJECTIONS)]
    args = (ctx, t_mod, cos, sin, cfg)
    per = PP_PER_STAGE
    rec = {"stage_weights_gib": [sum(p.numel() * p.element_size()
                                     for b in range(s * per, (s + 1) * per)
                                     for p in blocks[b].parameters()) / 2**30
                                 for s in range(PP_STAGES)]}
    launches = only()

    peaks = [0.0] * PP_STAGES

    def measured(stages):
        """Each stage's ticks recording the most memory one of them adds (synchronised)."""
        for st in stages:
            def run(t, received, st=st, tick=st.tick):
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                out = tick(t, received)
                torch.cuda.synchronize()
                peaks[st.stage] = max(peaks[st.stage],
                                      (torch.cuda.max_memory_allocated() - base) / 2**30)
                return out
            st.tick = run
        return stages

    with torch.no_grad():
        (got, cnt), rec["serve_s"] = sync_time(lambda: picked(lambda: _pp_schedule(
            measured(_pp_stages(blocks, x, *args, inj)))))
        check(cnt == only(K1=2 * 2 * PP_BLOCKS), f"pp serving launched {cnt}")
        launches["K1"] += cnt["K1"]
        rec["serve_tick_peak_gib"] = list(peaks)
        rec["serve_run_blocks_s"] = 0.0
        for m in range(2):
            (ref, cnt), secs = sync_time(lambda: picked(lambda: wan_dit.run_blocks(
                blocks, x[m:m + 1], ctx[m:m + 1], t_mod[m:m + 1], cos, sin, cfg,
                injections=[i[m:m + 1] for i in inj])))
            rec["serve_run_blocks_s"] += secs
            # the same blocks and kernels on the same rows: bit-equal expected; the check
            # is K1's self-shape limit
            rec[f"serve_bit_equal_{m}"] = torch.equal(got[m:m + 1], ref)
            compare(f"pp serving microbatch {m} (bit-equal: {rec[f'serve_bit_equal_{m}']})",
                    got[m:m + 1], ref, atol=1e-3, rtol=0.0, phase="pp")
        del got, ref
    per_call = None
    xg = x.clone().requires_grad_(True)
    ig = [i.clone().requires_grad_(True) for i in inj]
    refs = []
    rec["train_run_blocks_s"] = 0.0
    for m in range(2):
        xm = x[m:m + 1].clone().requires_grad_(True)
        im = [i[m:m + 1].clone().requires_grad_(True) for i in inj]

        def ref_step():
            out = wan_dit.run_blocks(blocks, xm, ctx[m:m + 1], t_mod[m:m + 1], cos, sin, cfg,
                                     injections=im, remat=True)
            return torch.autograd.grad(out, [xm, *im], w[m:m + 1])

        (grads, cnt), secs = sync_time(lambda: picked(ref_step))
        rec["train_run_blocks_s"] += secs
        per_call = cnt if per_call is None else {k: per_call[k] + cnt[k] for k in cnt}
        refs.append(grads)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def pp_step():
        out = _pp_schedule(_pp_stages(blocks, xg, *args, ig, remat=True))
        return torch.autograd.grad(out, [xg, *ig], w)

    (grads, cnt), rec["train_s"] = sync_time(lambda: picked(pp_step))
    rec["train_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    ticks = 2 + PP_STAGES - 1
    # ticks x stages stage-ticks of PP_PER_STAGE blocks = ticks x PP_BLOCKS block calls,
    # against run_blocks' 2 x PP_BLOCKS
    want = {k: v * ticks // 2 for k, v in per_call.items()}
    check(all(v * ticks % 2 == 0 for v in per_call.values())
          and cnt == want and cnt["K3"] > 0 and cnt["K4"] > 0 and cnt["K5"] > 0,
          f"pp training launched {cnt}, expected {want} (run_blocks: {per_call})")
    for k in ("K3", "K4", "K5"):
        launches[k] += cnt[k]
    errs = []
    for name, i in (("dx", 0), *((f"d injection {j}", j + 1) for j in range(PP_INJECTIONS))):
        for m in range(2):
            ref = refs[m][i]
            errs.append(compare(f"pp {name} microbatch {m} (training)", grads[i][m:m + 1], ref,
                                atol=bf16_limit(ref), rtol=0.0, phase="pp"))
    rec["train_max_abs_err"] = max(errs)
    rec["bubble_share"] = (PP_STAGES - 1) / ticks
    log("pp", virtual_stages=PP_STAGES, blocks=PP_BLOCKS, microbatches=2, launches=launches,
        run_blocks_launches_train=per_call, **rec,
        bubbles="serving skips the bubble ticks' blocks; training computes them (3/5 of its "
                "stage-ticks), as JAX's gates do",
        note="one card, virtual stages fed directly: no shift runs, no multi-GPU time is "
             "measured")
    del blocks, grads, refs, xg, ig, x, w, inj
    gc.collect()
    torch.cuda.empty_cache()
    return launches, rec


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
            plain_ms = {}
            (o_ref, lse_ref), plain_ms["K3"] = timed_call(
                lambda: fa.flash_attention_fwd_lse_plain(q, k, v, scale))
            err = {"K3": compare(f"K3 o {case}", o, o_ref, **tol(o_ref))}
            compare(f"K3 lse {case}", lse, lse_ref, **lse_tol)
            del o, lse
            # The backward kernels get the plain forward's o and lse, so each is held
            # against its plain version on exactly the same inputs.
            (dk, dv), n = picked(lambda: fa.flash_attention_bwd_dkv(q, k, v, o_ref, do,
                                                                    lse_ref, scale))
            check(n == only(K4=1), f"K4 {case} launched {n}")
            (dk_ref, dv_ref), plain_ms["K4"] = timed_call(
                lambda: fa.flash_attention_bwd_dkv_plain(q, k, v, o_ref, do, lse_ref, scale))
            err["K4"] = max(compare(f"K4 dk {case}", dk, dk_ref, **tol(dk_ref, True)),
                            compare(f"K4 dv {case}", dv, dv_ref, **tol(dv_ref, True)))
            del dk, dv, dk_ref, dv_ref
            dq, n = picked(lambda: fa.flash_attention_bwd_dq(q, k, v, o_ref, do, lse_ref, scale))
            check(n == only(K5=1), f"K5 {case} launched {n}")
            dq_ref, plain_ms["K5"] = timed_call(
                lambda: fa.flash_attention_bwd_dq_plain(q, k, v, o_ref, do, lse_ref, scale))
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
                       kernel_bound_ms(4 * mm, 2 * qb + 2 * kvb + lseb)),
                "K4": (lambda: fa.flash_attention_bwd_dkv(*args),
                       kernel_bound_ms(8 * mm, 3 * qb + 4 * kvb + lseb)),
                "K5": (lambda: fa.flash_attention_bwd_dq(*args),
                       kernel_bound_ms(6 * mm, 4 * qb + 2 * kvb + lseb))}
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            sdpa_fwd = event_ms(lambda: sdpa(qt, kt, vt))
            qg, kg, vg = (x.detach().requires_grad_(True) for x in (qt, kt, vt))
            dot = do.transpose(1, 2)
            sdpa_fb = event_ms(lambda: torch.autograd.grad(sdpa(qg, kg, vg), (qg, kg, vg), dot))
            del qg, kg, vg
            for kname, (kern, (bound, by)) in runs.items():
                rec = dict(max_abs_err=err[kname], ms=event_ms(kern),
                           plain_ms=plain_ms[kname], bound_ms=bound,
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
MAIN_SEEDS = (11, 22)     # main's two requests: PROMPTS[0] and PROMPTS[1]


def _serve(pipe, phase, per_request, seeds=MAIN_SEEDS, steps=STEPS, stages=None):
    """Answer one request per seed with the stages timed; checks each request's frames
    and that it launched exactly `per_request` (a launch-count dict). The counts are set
    to 0 just before the first request; returns the frames and the counts of the run.
    stages: a list that gets each request's {stage: seconds}."""
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
            if stages is not None:
                stages.append(dict(stage_times))
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

    dit_cfg = dataclasses.replace(C.WAN22_A14B, num_layers=MAIN_LAYERS)
    t5_cfg = dataclasses.replace(C.UMT5_XXL, num_layers=2)
    cn_cfg = C.ControlNetConfig(num_layers=MAIN_CN_LAYERS, in_channels=C.WAN21_VAE.z_dim)
    pipe, secs = sync_time(lambda: GoalForcePipeline.init_random(
        seed=0, dit_cfg=dit_cfg, t5_cfg=t5_cfg, vae_cfg=C.WAN21_VAE, cn_cfg=cn_cfg,
        dtype=torch.bfloat16, device="cuda"))
    n_params = {k: sum(p.numel() for p in m.parameters()) for k, m in pipe.models.items()}
    log("main", stage="init", seconds=secs, params=n_params, tokens=pipe.pipe_cfg.tokens,
        memory_gb=torch.cuda.memory_allocated() / 2**30)
    torch.cuda.reset_peak_memory_stats()
    stages = []
    frames, launches = _serve(pipe, "main", only(K1=K1_PER_REQUEST), stages=stages)
    log("main", stage="done", launches=launches,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 2**30)
    return pipe, launches, frames, stages


def collectives_per_step(blocks, rows, ffn_chunk):
    """The collectives one merged-CFG step calls under a mesh: all-reduces for the time
    and text embeddings, per block the self- and cross-attention's q/k norms and o and
    each FFN chunk's output; four all-to-alls per block (q, k, v, the output); the
    token and batch gathers."""
    chunks = -(-rows // ffn_chunk)
    return {"all_reduce": 2 + blocks * (2 + 1 + 2 + 1 + chunks), "all_to_all": 4 * blocks,
            "all_gather": 2}


SHARDED_ATOL = 1e-3
_WORLD = {}


def _world_mesh():
    """The NCCL process group of one rank (a file rendezvous) that ``sharded`` starts
    and the later sharded phases reuse, and its make_mesh(1, 1, 1, pp=1): pp = 1 keeps
    the 3-axis mesh, so every sharded phase also checks that a mesh without pipeline
    stages runs as before; ``_end_world`` destroys it."""
    import tempfile

    import torch.distributed as dist

    from goal_force_tpu_torch.parallel.mesh import make_mesh

    if "mesh" not in _WORLD:
        _WORLD["rdv"] = tempfile.mkdtemp(prefix="gf_rdv_")
        dist.init_process_group("nccl", init_method=f"file://{_WORLD['rdv']}/rdv", rank=0,
                                world_size=1)
        _WORLD["mesh"] = make_mesh(1, 1, 1, pp=1, device="cuda")
        check(_WORLD["mesh"].mesh_dim_names == ("dp", "sp", "tp"),
              f"make_mesh(pp=1) made {_WORLD['mesh'].mesh_dim_names}")
    return _WORLD["mesh"]


def _end_world():
    import shutil

    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    shutil.rmtree(_WORLD.pop("rdv", ""), ignore_errors=True)
    _WORLD.clear()


def _sharded_equal(phase, name, got, want, launches, want_launches):
    """A sharded call over the world of one against its unsharded twin: the outputs
    within SHARDED_ATOL (bit-equal expected: every collective is a copy) and the same
    launches."""
    got, want = (np.asarray(t.float().cpu()) if torch.is_tensor(t) else t for t in (got, want))
    diff = float(np.abs(got - want).max())
    log(phase, stage=f"sharded {name}", launches=launches, max_abs_diff_vs_unsharded=diff,
        bit_equal=bool(np.array_equal(got, want)))
    check(diff <= SHARDED_ATOL, f"{phase} sharded {name}: differs from unsharded by {diff}")
    check(launches == want_launches, f"{phase} sharded {name} launched {launches}, "
          f"expected {want_launches}")


def phase_sharded(pipe, main_frames, main_stages):
    """main's first request through the multi-GPU path on one card: an NCCL process
    group of one rank (a file rendezvous), make_mesh(1, 1, 1) and pipe.shard(mesh), so
    every collective (the Ulysses all-to-alls, the tensor-parallel all-reduces, the
    token and batch gathers, the token ids' broadcasts) runs as a copy over a group of
    one, and K1 runs on the rank's heads after the exchange. The request runs with
    attn_impl="ring": over one rank "sp" is 1, so the ring falls back to "auto" as JAX's
    does, and the request runs the sharded "auto" path (which ``t2v_vace``, ``s2v`` and
    ``image_branch`` also take under the mesh). The frames must equal main's within
    SHARDED_ATOL; K1 launches 12 per step as in main; each collective's count per step
    is collectives_per_step's. Logs the step seconds beside main's, and compare_videos
    (PSNR, SSIM) of the two frame sets, computed on a thread beside the later phases. The
    pipeline then serves unsharded again (over one rank the placed parameters are the
    whole tensors). The process group stays for the later sharded phases."""
    import torch.distributed as dist

    from goal_force_tpu_torch.models.wan_dit import FFN_CHUNK_TOKENS
    from goal_force_tpu_torch.ops import flash_attention as fa
    from goal_force_tpu_torch.parallel import collectives as col
    from goal_force_tpu_torch.utils.metrics import compare_videos

    pc = pipe.pipe_cfg
    image, video = _request_inputs(11, pc.num_frames, pc.height, pc.width, pc)
    mesh = _world_mesh()
    # "sp" is 1 over one rank, so attn_impl="ring" is "auto" there, as in JAX
    impl, pipe.attn_impl = pipe.attn_impl, "ring"
    try:
        _, secs = sync_time(lambda: pipe.shard(mesh))
        log("sharded", stage="shard", seconds=secs, backend=dist.get_backend(),
            mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)))
        steps, unwrap = _step_log(pipe)
        fa.reset_launch_counts()
        col.counts.clear()
        try:
            frames, secs = sync_time(lambda: pipe(PROMPTS[0], image, control_signal_video=video,
                                                  seed=11, num_inference_steps=STEPS))
        finally:
            unwrap()
        launches, collectives = dict(fa.launch_counts), dict(col.counts)
    finally:
        pipe.attn_impl, pipe.mesh = impl, None
    _check_frames("sharded", frames, pc)
    blocks = pipe.dit_cfg.num_layers + pipe.cn_cfg.num_layers
    per_step = collectives_per_step(blocks, 2 * pc.tokens, FFN_CHUNK_TOKENS)
    want = {k: v * STEPS for k, v in per_step.items()}
    want["broadcast"] = 2
    main_steps = [t for k, t in sorted(main_stages[0].items()) if k.startswith("step")]
    log("sharded", stage="attn_impl=ring", seconds=secs, step_seconds=[t for _, t in steps],
        main_step_seconds=main_steps, collectives=collectives, collectives_per_step=per_step)
    _sharded_equal("sharded", "attn_impl=ring (sp = 1: auto)", frames, main_frames,
                   launches, only(K1=K1_PER_REQUEST))
    check(collectives == want, f"sharded: collectives {collectives}, expected {want}")
    in_background(compare_videos, frames, main_frames, done=lambda report: log(
        "sharded", stage="compare_videos", psnr_mean=report["psnr_mean"],
        psnr_min=report["psnr_min"], ssim_mean=report["ssim_mean"]))
    return launches


def phase_tools():
    """The goal-force tools on the card: the base-model demo (--tiny_random --device
    cuda, a small clip) writes an mp4; extract_first_frame and extract_canny_edges run
    on it, and compare_videos holds the clip against itself."""
    import shutil
    import tempfile

    from goal_force_tpu_torch.data.video_io import load_video
    from goal_force_tpu_torch.scripts import compare_videos as cmp
    from goal_force_tpu_torch.scripts import demo
    from goal_force_tpu_torch.scripts.extract_canny_edges import extract_canny_edges
    from goal_force_tpu_torch.scripts.extract_first_frame import extract_first_frame

    tmp = tempfile.mkdtemp(prefix="gf_tools_")
    try:
        mp4 = os.path.join(tmp, "demo.mp4")
        frames, secs = sync_time(lambda: demo.main([
            "--tiny_random", "--device", "cuda", "--num_frames", "9", "--height", "64",
            "--width", "96", "--num_inference_steps", "2", "--output", mp4]))
        check(frames.shape == (9, 64, 96, 3) and bool(np.isfinite(frames).all()),
              f"tools: demo frames {frames.shape}")
        written = load_video(mp4)
        check(written.shape == frames.shape, f"tools: the demo's mp4 holds {written.shape}")
        first = extract_first_frame(mp4, os.path.join(tmp, "first.png"), 64, 96)
        canny = extract_canny_edges(mp4, os.path.join(tmp, "canny.mp4"), 9, 64, 96)
        report = cmp.main([mp4, mp4])
        check(first.shape == (64, 96, 3) and canny.shape == (9, 64, 96, 3)
              and report["psnr_min"] == float("inf"),
              f"tools: first frame {first.shape}, canny {canny.shape}, psnr {report}")
        log("tools", demo_seconds=secs, mp4_bytes=os.path.getsize(mp4),
            first_frame_mean=float(first.mean()), canny_edge_share=float(canny.mean()))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


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


def phase_variants(pipe, main_frames):
    """The Wan variants on main's bf16 pipeline. First, before any adapter is attached,
    generate_batch of main's two requests (81 frames, 4 steps, 10 K1 per step at B = 4,
    32,760 tokens), which must give main's frames within WINDOW_ATOL. Then 2 steps per
    request. Adapters drawn at full
    width (a motion controller whose last layer is not zero, a camera SimpleAdapter, a
    Fun-Reference ref_conv in both experts), the first two written in the reference
    formats and read back through from_pretrained's loaders. At 33 frames (K1 at the
    window's 14,040 tokens): the plain request, end_image, v2v (its untiled encode),
    motion_bucket_id, camera "Left" and a strided ControlNet (stride 2: blocks 0 and 2,
    raw states after them), each 10 K1 per step. At 81 frames: the plain request without
    ControlNet and Fun-Reference (6 K1 per step, 34,320 tokens). Last, v2v's untiled
    encode at 81 frames, as JAX encodes it, measured and reported whether or not it
    fits."""
    import gc
    import tempfile

    from goal_force_tpu_torch.models import adapters as adm
    from goal_force_tpu_torch.models import camera_controller as camm
    from goal_force_tpu_torch.models import controlnet as cnm
    from goal_force_tpu_torch.models import wan_dit
    from goal_force_tpu_torch.ops import flash_attention as fa

    pc = pipe.pipe_cfg
    dit_cfg = pipe.dit_cfg
    shape81 = (pc.num_frames, pc.height, pc.width, 3)
    fa.reset_launch_counts()
    run = lambda name, per_step, shape, fn, base=None: _variant_request(
        pipe, "variants", name, fn, per_step, shape, base=base)
    # main's two requests as one batch: its singles are main's answers
    main_images, main_videos = zip(*(_request_inputs(s, pc.num_frames, pc.height, pc.width, pc)
                                     for s in MAIN_SEEDS))
    batch = _variant_request(
        pipe, "variants", "batch_2x81", lambda: pipe.generate_batch(
            list(PROMPTS), np.stack(main_images), control_signal_videos=list(main_videos),
            seeds=list(MAIN_SEEDS), num_inference_steps=STEPS),
        K1_PER_STEP, (2,) + shape81, steps=STEPS)
    batch_diff = [float(np.abs(batch[i] - main_frames[i]).max()) for i in range(2)]
    log("variants", stage="batch_vs_singles", max_abs_diff=batch_diff, atol=WINDOW_ATOL,
        ok=max(batch_diff) <= WINDOW_ATOL)
    check(max(batch_diff) <= WINDOW_ATOL,
          f"generate_batch differs from main's single requests by {batch_diff}")
    del batch, main_images, main_videos

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
    plain = run("plain_33", K1_PER_STEP, shape33,
                lambda: pipe(PROMPTS[0], image, control_signal_video=video, **kw))
    run("end_image_33", K1_PER_STEP, shape33, lambda: pipe(PROMPTS[0], image, control_signal_video=video,
                                                  end_image=end_image, **kw), plain)
    v2v_input = np.clip(0.5 * other + 0.25, 0.0, 1.0)
    run("v2v_33", K1_PER_STEP, shape33, lambda: pipe(PROMPTS[0], image, control_signal_video=video,
                                            input_video=v2v_input, denoising_strength=0.8,
                                            **kw), plain)
    run("motion_33", K1_PER_STEP, shape33, lambda: pipe(PROMPTS[0], image, control_signal_video=video,
                                               motion_bucket_id=90, **kw), plain)
    run("camera_left_33", K1_PER_STEP, shape33, lambda: pipe(PROMPTS[0], image,
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
        run("strided_controlnet_33", K1_PER_STEP, shape33,
            lambda: pipe(PROMPTS[0], image, control_signal_video=video, **kw), plain)
    finally:
        pipe.cn_cfg, pipe.models["controlnet"], pipe.models["controlnet2"] = saved
    gc.collect()
    torch.cuda.empty_cache()

    image81, video81 = _request_inputs(43, pc.num_frames, pc.height, pc.width, pc)
    ref_image = _request_inputs(45, 1, pc.height, pc.width, pc)[0]
    kw81 = dict(num_inference_steps=VARIANT_STEPS)
    plain81 = run("plain_no_controlnet_81", 2 * MAIN_LAYERS, shape81,
                  lambda: pipe(PROMPTS[0], image81, seed=43, controlnet=False, **kw81))
    run("reference_81", 2 * MAIN_LAYERS, shape81, lambda: pipe(PROMPTS[0], image81, seed=43,
                                                  controlnet=False, reference_image=ref_image,
                                                  **kw81), plain81)
    run_counts = dict(fa.launch_counts)
    del plain81
    gc.collect()
    torch.cuda.empty_cache()
    _v2v_encode_81(pipe, video81)
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


T2V_VACE_LAYERS = 3


def phase_t2v_vace():
    """A full-width text-to-video pipeline (A14B widths, in_dim 16, 3 DiT layers per expert
    (cut from 4 for the smoke's time), no ControlNet) with VACE hint blocks after
    DiT layers 0 and 2, drawn at full width and read back through from_pretrained's
    loader: one t2v request (6 K1 per step), then one VACE request with video, mask and
    reference image (22 latent frames, 34,320 tokens, 10 K1 per step), both 81x480x832
    and 2 steps."""
    import gc
    import tempfile

    from goal_force_tpu_torch import configs as C
    from goal_force_tpu_torch.ops import flash_attention as fa
    from goal_force_tpu_torch.pipelines.goal_force import GoalForcePipeline

    dit_cfg = dataclasses.replace(C.WAN22_A14B, num_layers=T2V_VACE_LAYERS,
                                  in_dim=C.WAN21_VAE.z_dim)
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
    per_step = 2 * T2V_VACE_LAYERS                          # self + cross per DiT block
    t2v = _variant_request(pipe, "t2v_vace", "t2v_81", lambda: pipe(PROMPTS[0], **kw), per_step,
                           shape)
    vace_req = lambda: pipe(PROMPTS[0], vace_video=video, vace_video_mask=mask,
                            vace_reference_image=image, **kw)
    per_step += 2 * len(layers)                             # and per VACE hint block
    vace = _variant_request(pipe, "t2v_vace", "vace_81_with_reference", vace_req, per_step,
                            shape, base=t2v)
    run_counts = dict(fa.launch_counts)
    # the VACE request again through shard() over the world of one: the hint blocks on
    # the rank's tokens, the same frames and the same K1 launches
    pipe.shard(_world_mesh())
    try:
        (got, n), secs = sync_time(lambda: picked(vace_req))
    finally:
        pipe.mesh = None
    log("t2v_vace", stage="sharded", seconds=secs)
    _sharded_equal("t2v_vace", "vace_81_with_reference", got, vace, n,
                   only(K1=per_step * VARIANT_STEPS))
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
        ckpt = os.path.join(tmp, "ckpt", "step-3.safetensors")
        writes = [lambda i=i: sio.save_safetensors({k: high[k] for k in keys[i::2]}, os.path.join(
            tmp, "high", f"diffusion_pytorch_model-0000{i + 1}-of-00002.safetensors"))
            for i in range(2)]
        writes += [
            lambda: sio.save_safetensors(pipe.models["dit2"].state_dict(), os.path.join(
                tmp, "low", "diffusion_pytorch_model.safetensors")),
            lambda: torch.save({k: v.cpu() for k, v in pipe.models["t5"].state_dict().items()},
                               os.path.join(tmp, "models_t5_umt5-xxl-enc-bf16.pth")),
            lambda: torch.save({"model." + k: v.cpu()
                                for k, v in pipe.models["vae"].state_dict().items()},
                               os.path.join(tmp, "Wan2.1_VAE.pth")),
            lambda: sio.save_safetensors(sio.export_goalforce_controlnet(cn), ckpt)]
        with ThreadPoolExecutor(len(writes)) as pool:      # the files written together
            for f in [pool.submit(w) for w in writes]:
                f.result()
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

        def write_row(row_cfg, root):
            """The row's artifacts (host encodes) and their sizes; then `root` goes."""
            try:
                infer.write_row(sample, frames, base, row_cfg)
                written = {k: os.path.exists(base + k) for k in infer.ARTIFACTS}
                return written, {k: os.path.getsize(base + k) for k, v in written.items() if v}
            finally:
                shutil.rmtree(root, True)

        def artifacts(result):
            written, sizes = result
            log("cli", stage="artifacts", base=os.path.basename(base),
                written=sorted(k for k, v in written.items() if v),
                not_written=sorted(k for k, v in written.items() if not v), sizes=sizes)
            check(all(written.values()), f"cli: artifacts not written: {written}")

        # on a thread while main's pipeline answers the row; joined before the kernels line
        in_background(write_row, loaded.pipe_cfg, tmp, done=artifacts)
        tmp = None
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
        check(err <= CLI_ATOL, f"cli: frames differ from main's by {err}")
        check(len(swaps) == 1, f"cli: {len(swaps)} swaps in one request")
    finally:
        with torch.no_grad():
            for zc, (w, b) in zip(cn.controlnet_zero_convs_after, zero):
                zc.weight.copy_(w)
                zc.bias.copy_(b)
        pipe.tokenizer, pipe.pipe_cfg = tokenizer, pc
        if tmp is not None:
            remove_later(tmp)
    return launches


QPATHS = ("self_attn", "cross_attn", "ffn")     # the block linears JAX quantizes
FP8_LINEAR_RTOL = 2e-3    # the card's fp8 sums of 5120 products: 1.2e-4 measured
QUANTIZED = ("dit", "dit2", "controlnet", "controlnet2")
K6_PER_STEP = K1_PER_STEP                       # self + cross per DiT and ControlNet block


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


class _Crc32Tokenizer:
    """Whitespace words -> 2 + crc32(word) % (vocab - 2), then EOS (1), PAD (0): ids that
    are the same in every process (the hash tokenizer's follow the process's string-hash
    seed) and below the small T5's vocabulary."""

    def __init__(self, vocab: int, seq_len: int):
        self.vocab, self.seq_len = vocab, seq_len

    def __call__(self, texts):
        import zlib

        ids = np.zeros((len(texts), self.seq_len), np.int32)
        mask = np.zeros((len(texts), self.seq_len), np.int32)
        for i, t in enumerate(texts):
            coded = [2 + zlib.crc32(w.encode()) % (self.vocab - 2) for w in t.split()]
            coded = coded[:self.seq_len - 1] + [1]
            ids[i, :len(coded)] = coded
            mask[i, :len(coded)] = 1
        return ids, mask


class _TeacherForcedInt8:
    """Within the block, every call of ``flash_attention_int8`` launches K6 and also
    computes the plain int8 attention on the same q, k, v; the run goes on with K6's
    output, so every packed linear sees the inputs of the K6 run. The packed linear after
    each attention (``o``, marked by ``mark``) gets both outputs in turn: ``pairs``
    collects (K6's input, the plain input, the pack)."""

    def __init__(self, models):
        from goal_force_tpu_torch.ops import flash_attention as fa
        from goal_force_tpu_torch.ops import quant

        self.fa, self.quant, self.pairs, self.pending = fa, quant, [], []
        self.marked = [m for model in models for name, m in model.named_modules()
                       if isinstance(m, quant.QuantLinear) and name.endswith((".o",))]

    def __enter__(self):
        fa, quant, pending, pairs = self.fa, self.quant, self.pending, self.pairs
        self.saved_attn, self.saved_fwd = fa.flash_attention_int8, quant.QuantLinear.forward
        k6 = self.saved_attn

        def attn(q, k, v, scale, *a, **kw):
            out = k6(q, k, v, scale, *a, **kw)
            pending.append(fa.flash_attention_int8_plain(q, k, v, scale, *a, **kw))
            return out

        saved_fwd = self.saved_fwd
        marked = {id(m) for m in self.marked}

        def forward(layer, x):
            if id(layer) in marked:
                pairs.append((x, pending.pop(0).reshape(x.shape), layer))
            return saved_fwd(layer, x)

        fa.flash_attention_int8 = attn
        quant.QuantLinear.forward = forward
        return self

    def __exit__(self, *exc):
        self.fa.flash_attention_int8 = self.saved_attn
        self.quant.QuantLinear.forward = self.saved_fwd


def _code_step_check(x_k6, x_plain, pack):
    """One packed linear on the two attention outputs of the same q, k, v. Each row is
    quantized with its own scale xs = amax / 127 and codes q = round(x / xs), so
    y = xs * ws * (q . w) (+ bias): with K6 and the plain version equal to float32
    rounding, an element near a rounding boundary takes the neighbouring code (|dq| = 1)
    and a row's amax may move by that rounding (dxs). The outputs then differ by
    exactly |ws| * (xs * (|dq| . |w|) + |dxs| * |q . w|), to the epilogue's float32
    rounding (2^-20 of |y| + |bias|): that is the bound, one code step of the linear's range per
    flipped code. Returns (codes that differ, largest |dq|, worst error / bound)."""
    xs = [t.float().reshape(-1, t.shape[-1]) for t in (x_k6, x_plain)]
    sc = [t.abs().amax(dim=-1, keepdim=True).clamp(min=1e-8) / 127.0 for t in xs]
    q = [torch.round(t / s) for t, s in zip(xs, sc)]
    w = pack.weight.double()
    ws = pack.weight_scale.double()
    dq = (q[0] - q[1]).abs().double()
    y = [pack(t.reshape(x_k6.shape)).double().reshape(dq.shape[0], -1) for t in (x_k6, x_plain)]
    bias = 0.0 if pack.bias is None else pack.bias.double().abs()
    bound = ws * (sc[0].double() * (dq @ w.abs().t())
                  + (sc[0] - sc[1]).double().abs() * (q[1].double() @ w.t()).abs())
    bound = bound + 2.0**-20 * (y[1].abs() + bias)
    err = (y[0] - y[1]).abs()
    ratio = float((err / bound.clamp(min=1e-30)).max()) if bool((err > 0).any()) else 0.0
    return int((dq > 0).sum()), float(dq.max()), ratio


def phase_small_int8():
    """The small head_dim-128 float32 pipeline with W8A8 packs in its four DiT/ControlNet
    models and a tokenizer whose ids are the same in every process: one merged-CFG step
    with K6 against the plain int8 attention, linear by linear on the same inputs
    (``_code_step_check``), a whole request through K6 against the same with the plain
    int8 attention (the same function), and the launches (K6 only)."""
    from goal_force_tpu_torch.ops import flash_attention as fa
    from goal_force_tpu_torch.pipelines.goal_force import GoalForcePipeline

    _check_linears()
    dit_cfg, t5_cfg, vae_cfg, cn_cfg = _small_configs()
    pipe = GoalForcePipeline.init_random(seed=5, dit_cfg=dit_cfg, t5_cfg=t5_cfg, vae_cfg=vae_cfg,
                                         cn_cfg=cn_cfg, dtype=torch.float32, device="cuda")
    pipe.tokenizer = _Crc32Tokenizer(t5_cfg.vocab, t5_cfg.text_len)
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
    with _TeacherForcedInt8([pipe.models["dit"], pipe.models["controlnet"]]) as tf:
        _, n_forced = picked(step)
    linears = [_code_step_check(*pair) for pair in tf.pairs]
    tf32_before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False        # float32 convs in full float32, as in small
    try:
        kw = dict(seed=2, num_frames=17, num_inference_steps=4)
        got, n = picked(lambda: pipe("a small check", image, control_signal_video=video, **kw))
        with _PlainInt8():
            ref = pipe("a small check", image, control_signal_video=video, **kw)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32_before
    # the step's velocity, from the Euler update latents + (0.9375 - 1.0) * v (logged:
    # flips compound through the later linears and merged CFG, so it has no bound here)
    v_got, v_ref = ((out - lat) / (0.9375 - 1.0) for out in (got_step, ref_step))
    step_err = dict(max=float((v_got - v_ref).abs().max()),
                    mean=float((v_got - v_ref).abs().mean()),
                    top=float(v_ref.abs().max()))
    err = dict(max=float(np.abs(got - ref).max()), mean=float(np.abs(got - ref).mean()))
    # Linear by linear (teacher-forced: each o takes K6's output and the plain output of
    # the same q, k, v), no code moves by more than one step and each output stays
    # within _code_step_check's derived bound (worst error / bound <= 1). The frames of
    # a whole request, whose later steps flip codes of their own, within 3e-2 (2e-3 on
    # average), the bounds of the CPU tests that hold the port to JAX
    # (tests/test_torch_lowp.py).
    worst = max(r for _, _, r in linears)
    linear_ok = len(linears) == 6 and all(d <= 1 for _, d, _ in linears) and worst <= 1.0
    frames_ok = err["max"] <= 3e-2 and err["mean"] <= 2e-3
    log("small_int8", tokens=5 * 8 * 16, token_ids=ctx.shape[1], step_launches=n_step,
        plain_step_launches=n_plain, forced_step_launches=n_forced,
        linears=[dict(flipped_codes=f, max_code_step=d, err_over_bound=r)
                 for f, d, r in linears], worst_err_over_bound=worst,
        velocity_abs_err=step_err, launches=n, frames_abs_err=err,
        frames_limits=dict(max=3e-2, mean=2e-3), ok=linear_ok and frames_ok)
    check(n_step == only(K6=6) and n == only(K6=2 * (2 + 1) * 4) and n_plain == only()
          and n_forced == only(K6=6), f"small_int8 launched {n_step} / {n} / plain {n_plain} "
          f"/ forced {n_forced}")
    check(linear_ok, f"small_int8: a linear after K6 moved past one code step: {linears}")
    check(frames_ok, f"small_int8: K6 vs plain int8 attention frames differ by {err}")
    del pipe
    torch.cuda.empty_cache()
    return dict(worst_err_over_bound=worst, frames_abs_err=err)


def phase_main_int8(pipe, bf16_frames):
    """main's pipeline quantized in place (W8A8 block linears of the four DiT/ControlNet
    models) with attn_impl="flash_int8": the same two requests, 40 K6 and nothing else
    each, and the mean |frames - bf16 frames| of the same request. Then the first
    request through shard(), held to its unsharded frames. Returns both requests'
    launches and the sharded request's."""
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
    # the first request again through shard() over the world of one: the packs split
    # (over one rank: whole), K6 alone as unsharded, the same frames
    pc = pipe.pipe_cfg
    image, video = _request_inputs(MAIN_SEEDS[0], pc.num_frames, pc.height, pc.width, pc)
    req = lambda: pipe(PROMPTS[0], image, control_signal_video=video, seed=MAIN_SEEDS[0],
                       num_inference_steps=STEPS)
    pipe.attn_impl = "flash_int8"
    try:
        pipe.shard(_world_mesh())
        (got, n), secs = sync_time(lambda: picked(req))
    finally:
        pipe.attn_impl, pipe.mesh = "auto", None
    log("main_int8", stage="sharded", seconds=secs)
    _sharded_equal("main_int8", "request", got, frames[0], n, only(K6=K6_PER_STEP * STEPS))
    return launches, n


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
    # the staged pair's pinned chunks stay in the host allocator's cache: released here,
    # while the context lives, they take a fraction of the time the interpreter's exit
    # takes to release them
    torch._C._host_emptyCache()
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
    blocks = MAIN_LAYERS + MAIN_CN_LAYERS          # self-attention K2, cross K1 per block
    check(launches == only(K1=blocks, K2=blocks), f"unbounded step launched {launches}")
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
    """ControlNet training at full WAN22_A14B width (2 DiT + 2 ControlNet layers, umt5 at
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
    dit_cfg = dataclasses.replace(C.WAN22_A14B, num_layers=TRAIN_LAYERS)
    t5_cfg = dataclasses.replace(C.UMT5_XXL, num_layers=2)
    cn_cfg = C.ControlNetConfig(num_layers=TRAIN_CN_LAYERS, in_channels=C.WAN21_VAE.z_dim)
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
        expected = {k: 3 * n for k, n in train_launches_per_step(
            dit_cfg.num_layers, cn_cfg.num_layers).items()}
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
        remove_later(out_dir)
    del state3
    gc.collect()
    return launches, dict(cfg=cfg, configs=(dit_cfg, t5_cfg, C.WAN21_VAE, cn_cfg), frozen=frozen,
                          cn0=cn0, data=data, tokenizer=tok, history=history[:2],
                          at_step2=at_step2, peak_gb=peak_gb)


# the training phases' depth (DiT layers cut from 4 to 3, then to 2, for the smoke's time)
TRAIN_LAYERS, TRAIN_CN_LAYERS = 2, 2


def train_launches_per_step(dit_blocks, cn_blocks, lora=False):
    """K1/K3/K4/K5 launches of one training step. The ControlNet injects after DiT blocks
    0..cn_blocks-1, so without LoRA DiT block 0 runs without grad (K1 for its self- and
    cross-attention) and the blocks after it need a gradient; with LoRA every DiT block
    trains. Each attention that needs a gradient runs K3 twice (the forward and the
    remat recompute) and K5 once, and K4 where its k and v need one: every
    self-attention, and the ControlNet's cross-attention (the DiT's cross k and v come
    from the frozen text path)."""
    dit_grad = dit_blocks if lora else dit_blocks - 1
    calls = 2 * (dit_grad + cn_blocks)
    return only(K1=0 if lora else 2, K3=2 * calls, K4=dit_grad + 2 * cn_blocks, K5=calls)


def train_collectives_per_step(dit_blocks, cn_blocks, t5_blocks, rows, ffn_chunk):
    """The collectives of one training step under a mesh with every block weight
    FSDP-split, by kind. The side stack's blocks inject after DiT blocks 0..cn_blocks-1,
    so DiT block 0 runs without grad (no recompute) and the g = dit_blocks - 1 blocks
    after it, like every ControlNet block, run forward, are recomputed in the backward
    and backpropagated. Per block forward (recompute included): 4 all-to-alls (q, k, v,
    the output), all-reduces for the self-attention q/k norms and o, the cross-attention
    q/k norms and o, and each of the c FFN chunks, and one all-gather of the block's
    weights. Per backpropagated block: the 4 all-to-alls' transposes, the q/k norms'
    shared sums (self q and k, cross q; a ControlNet block's cross k too: its weight
    trains), the column-parallel inputs' sums (self- and cross-attention, each FFN
    chunk); a ControlNet block also gathers the "tp" gradients of its 10 sliced weights,
    6 q/k/v biases, its 4 norm weights and the ffn.0 bias of each chunk, and its weight
    gather's backward is a reduce-scatter. Once per step: the text and time embeddings'
    row sums, the gathers of T5 (its embedding and each block), of the DiT's embeddings
    and its head, of the ControlNet's embeddings and of the tokens before the head, the
    ControlNet embedding's reduce-scatter, and 4 all-reduces (the replicated gradients,
    the loss over "dp", the two gradient norms). The VAE's spatial split adds
    SPLIT_GATHERS_PER_STEP all-gathers (each encode's latents; over one rank no axis is
    split, so no halo shifts and no gather of the mid-block's keys)."""
    c = -(-rows // ffn_chunk)
    g = dit_blocks - 1
    fwd = dit_blocks + g + 2 * cn_blocks
    return {"all_to_all": 4 * fwd + 4 * (g + cn_blocks),
            "all_reduce": (6 + c) * fwd + (5 + c) * g + (6 + c) * cn_blocks + 2 + 4,
            "all_gather": (fwd + cn_blocks * (20 + c) + (1 + t5_blocks) + 2 + 1 + 1
                           + SPLIT_GATHERS_PER_STEP),
            "reduce_scatter": cn_blocks + 1}


SPLIT_GATHERS_PER_STEP = 3      # the latents of the video, control and first-frame encodes
ENCODES = ("vae_encode_video", "vae_encode_control", "vae_encode_first_frame")


def phase_sharded_train(run):
    """train's first two steps again through train(mesh=) over the NCCL world of one that
    ``sharded`` started (make_mesh(1, 1, 1)): the same frozen models, now FSDP-placed by
    fsdp_specs (over one rank each shard is the whole tensor), the same initial
    ControlNet, clips and generators. The loss, gradient norm and step-2 ControlNet must
    equal train's bit for bit (every collective is a copy); each step launches what a
    train step launches (train_launches_per_step) and calls the collectives of
    train_collectives_per_step. The three VAE encodes run split (parallel/spatial.py):
    over one rank no axis splits, so no halo moves, but the split's plumbing and its
    latent gathers run. Logs the step seconds, the encodes' seconds and peaks beside
    train's, and the split's collectives apart from the others."""
    import gc
    import tempfile

    from goal_force_tpu_torch.models.wan_dit import FFN_CHUNK_TOKENS
    from goal_force_tpu_torch.ops import flash_attention as fa
    from goal_force_tpu_torch.parallel import collectives as col
    from goal_force_tpu_torch.training import trainer

    mesh = _world_mesh()
    out_dir = tempfile.mkdtemp(prefix="gf_train_sharded_")
    cfg = dataclasses.replace(run["cfg"], output_dir=out_dir)
    per_step, make = [], trainer.make_train_step

    def counted(*a, **k):
        step = make(*a, **k)

        def run_step(*sa, **sk):
            launches, calls = dict(fa.launch_counts), dict(col.counts)
            out = step(*sa, **sk)
            torch.cuda.synchronize()
            per_step.append(({n: fa.launch_counts[n] - launches[n] for n in launches},
                             {n: col.counts[n] - calls.get(n, 0) for n in col.counts
                              if col.counts[n] != calls.get(n, 0)}))
            return out
        return run_step

    history = []
    trainer.make_train_step = counted
    try:
        fa.reset_launch_counts()
        col.counts.clear()
        torch.cuda.reset_peak_memory_stats()
        state, secs = sync_time(lambda: trainer.train(
            cfg, *run["configs"], run["frozen"], run["cn0"], run["data"], run["tokenizer"],
            device="cuda", history=history, max_steps=2, mesh=mesh))
        launches = dict(fa.launch_counts)
        peak_gb = max([torch.cuda.max_memory_allocated() / 2**30] +
                      [v for h in history for k, v in h.items() if k.endswith("_peak_gb")])
        after = {n: p.to("cpu", copy=True) for n, p in state.params.state_dict().items()}
    finally:
        trainer.make_train_step = make
        remove_later(out_dir)
    from goal_force_tpu_torch import configs as C

    dit_cfg, t5_cfg, _, cn_cfg = run["configs"]
    pc = C.PipelineConfig()
    want_calls = train_collectives_per_step(dit_cfg.num_layers, cn_cfg.num_layers,
                                            t5_cfg.num_layers, pc.tokens, FFN_CHUNK_TOKENS)
    step_launches = train_launches_per_step(dit_cfg.num_layers, cn_cfg.num_layers)
    ref = run["history"]
    same_metrics = [(h["loss"], h["grad_norm"]) == (r["loss"], r["grad_norm"])
                    for h, r in zip(history, ref)]
    same_cn = [n for n, t in after.items() if not torch.equal(t, run["at_step2"][n])]
    for h, r in zip(history, ref):
        log("sharded_train", stage=f"step{h['step']}", loss=h["loss"], train_loss=r["loss"],
            grad_norm=h["grad_norm"], train_grad_norm=r["grad_norm"],
            step_time=h["step_time"], train_step_time=r["step_time"],
            forward_backward=h["forward_backward"], train_forward_backward=r["forward_backward"],
            forward_backward_peak_gb=h["forward_backward_peak_gb"],
            train_forward_backward_peak_gb=r["forward_backward_peak_gb"],
            **{f"{e}{p}": h[e + p] for e in ENCODES for p in ("", "_peak_gb")},
            **{f"train_{e}{p}": r[e + p] for e in ENCODES for p in ("", "_peak_gb")})
    log("sharded_train", stage="done", seconds=secs, launches=launches,
        launches_per_step=[p[0] for p in per_step], collectives_per_step=[p[1] for p in per_step],
        expected_collectives_per_step=want_calls,
        split_collectives_per_step={"all_gather": SPLIT_GATHERS_PER_STEP, "shift": 0},
        max_memory_allocated_gb=peak_gb,
        train_max_memory_allocated_gb=run["peak_gb"], metrics_equal=same_metrics,
        controlnet_tensors_differing=same_cn)
    check([h["step"] for h in history] == [1, 2], f"sharded_train: steps {history}")
    check(all(same_metrics), "sharded_train: loss or grad_norm differ from train's")
    check(not same_cn, f"sharded_train: ControlNet tensors differ from train's: {same_cn[:5]}")
    check(all(p[0] == step_launches for p in per_step),
          f"sharded_train launched {[p[0] for p in per_step]} per step, expected {step_launches}")
    check(all(p[1] == want_calls for p in per_step),
          f"sharded_train: collectives {[p[1] for p in per_step]}, expected {want_calls}")
    del state, after
    gc.collect()
    torch.cuda.empty_cache()
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
    """The training CLI's functions at train's config (full WAN22_A14B width, 2 DiT + 2
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
    dit_cfg = dataclasses.replace(C.WAN22_A14B, num_layers=TRAIN_LAYERS)
    t5_cfg = dataclasses.replace(C.UMT5_XXL, num_layers=2)
    pc = C.PipelineConfig()
    tmp = tempfile.mkdtemp(prefix="gf_train_cli_")
    try:
        t0 = time.perf_counter()
        gen = torch.Generator("cuda").manual_seed(5)      # drawn in this order
        sd = wan_dit.init_wan_dit(dit_cfg, gen, torch.bfloat16, device="cuda").state_dict()
        t5_sd = t5m.init_t5(t5_cfg, gen, torch.bfloat16, device="cuda").state_dict()
        vae_sd = vaem.init_vae(C.WAN21_VAE, gen, torch.bfloat16, device="cuda").state_dict()
        keys = sorted(sd)
        writes = [lambda i=i: sio.save_safetensors({k: sd[k] for k in keys[i::2]}, os.path.join(
            tmp, "high", f"diffusion_pytorch_model-0000{i + 1}-of-00002.safetensors"))
            for i in range(2)]
        writes += [
            lambda: torch.save({k: v.cpu() for k, v in t5_sd.items()},
                               os.path.join(tmp, "models_t5_umt5-xxl-enc-bf16.pth")),
            lambda: torch.save({"model." + k: v.cpu() for k, v in vae_sd.items()},
                               os.path.join(tmp, "Wan2.1_VAE.pth")),
            lambda: _write_training_set(os.path.join(tmp, "data"), pc)]
        with ThreadPoolExecutor(len(writes)) as pool:      # the files written together
            sets = [f.result() for f in [pool.submit(w) for w in writes]][-1]
        del sd, t5_sd, vae_sd
        gc.collect()
        torch.cuda.empty_cache()
        log("train_cli", stage="files", seconds=time.perf_counter() - t0, bytes=_dir_bytes(tmp),
            files=sorted(os.path.relpath(os.path.join(d, x), tmp)
                         for d, _, fs in os.walk(tmp) for x in fs))
        argv = ["--high_noise_model", os.path.join(tmp, "high", "diffusion_pytorch_model-*.safetensors"),
                "--t5_path", os.path.join(tmp, "models_t5_umt5-xxl-enc-bf16.pth"),
                "--vae_path", os.path.join(tmp, "Wan2.1_VAE.pth"),
                "--controlnet_num_layers", str(TRAIN_CN_LAYERS),
                "--train_lora", "--lora_rank", "32",
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
        # 4 steps (3, then the resumed 3rd), every DiT block training through its adapters
        expected = {k: 4 * n for k, n in train_launches_per_step(
            dit_cfg.num_layers, TRAIN_CN_LAYERS, lora=True).items()}
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
        remove_later(tmp)
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Speech-to-video, the image branch and the Wan2.2 VAE
# ---------------------------------------------------------------------------

S2V_STEPS = 2
# 2 of 40 layers (cut from 4 for the smoke's time), audio after both
S2V_LAYERS = 2
S2V_K1_PER_STEP = 2 * (2 * S2V_LAYERS + 2)   # CFG's two forwards x (self, text cross, 2 audio)
S2V_MOTION_FRAMES = 17                # (c): 19 motion + 4 latent frames decode untiled
S2V_POSE_FRAMES = 33                  # (b): the pose request at 9 latent frames


def _s2v_request_inputs(seed, frames, height, width, motion=False, pose=False):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    image = np.clip(np.stack([xx / width, yy / height, 0.5 + 0.5 * np.sin(xx / 29.0 + seed)],
                             -1) + 0.05 * rng.standard_normal((height, width, 3)), 0, 1)
    out = {"image": image.astype(np.float32)}
    if pose:
        out["pose"] = rng.uniform(size=(frames - 1, height, width, 3)).astype(np.float32)
    if motion:
        out["motion"] = rng.uniform(size=(73, height, width, 3)).astype(np.float32)
    return out


def _s2v_instrument(pipe, stage_times):
    """Wrap the S2V pipeline's stages so each appends (name, synchronised seconds)."""
    def timed(name, fn):
        def run(*a, **k):
            out, secs = sync_time(lambda: fn(*a, **k))
            stage_times.append((name, secs))
            return out
        return run

    for name in ("encode_prompts", "_encode_px", "_pose_latents", "_decode"):
        setattr(pipe, name, timed(name.lstrip("_"), getattr(pipe, name)))
    real_step = pipe.denoise_step

    def step(*a, **k):
        n = sum(name.startswith("step") for name, _ in stage_times)
        return timed(f"step{n}", real_step)(*a, **k)

    pipe.denoise_step = step


def _s2v_request(pipe, phase, name, fn, frames_shape, per_step, steps=S2V_STEPS, base=None):
    """One S2V request with its stages timed; checks its frames and its launches (exactly
    per_step K1 in each step); logs stages, peak memory and max |frames - base|."""
    import gc

    from goal_force_tpu_torch.ops import flash_attention as fa

    stage_times = []
    _s2v_instrument(pipe, stage_times)
    gc.collect()
    torch.cuda.empty_cache()     # the untiled float32 decode needs ~60 GiB in few blocks
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = dict(fa.launch_counts)
    try:
        frames, secs = sync_time(fn)
    finally:
        for attr in ("encode_prompts", "_encode_px", "_pose_latents", "_decode", "denoise_step"):
            pipe.__dict__.pop(attr, None)
    counts = {k: fa.launch_counts[k] - before[k] for k in before}
    n = None if base is None else min(len(frames), len(base))     # frames both share
    diff = None if base is None else float(np.abs(frames[:n] - base[:n]).max())
    log(phase, request=name, seconds=secs, stages=dict(stage_times), launches=counts,
        k1_per_step=counts["K1"] / steps, peak_gb=torch.cuda.max_memory_allocated() / 2**30,
        max_abs_diff_vs_a=diff, frames_mean=float(frames.mean()), frames_shape=list(frames.shape))
    check(frames.shape == frames_shape and bool(np.isfinite(frames).all())
          and frames.min() >= 0.0 and frames.max() <= 1.0,
          f"{phase} {name}: frames of shape {frames.shape}, not finite or outside [0, 1]")
    check(counts == only(K1=per_step * steps), f"{phase} {name} launched {counts}")
    if base is not None:
        check(diff > 1e-3, f"{phase} {name}: frames equal request (a)'s ({diff})")
    return frames


def _small_s2v_configs():
    """A head_dim-128 S2V (2 heads, 2 layers, injections after both) over the tiny T5 and
    VAE: 256 x 256 pixels give 256 tokens per latent frame, enough for the kernels."""
    from goal_force_tpu_torch import configs as C
    from goal_force_tpu_torch.models.s2v import S2VConfig

    t5_cfg, vae_cfg = C.tiny_t5(), C.tiny_vae()
    cfg = S2VConfig(dim=256, in_dim=vae_cfg.z_dim, ffn_dim=512, out_dim=vae_cfg.z_dim,
                    text_dim=t5_cfg.dim, freq_dim=32, num_heads=2, num_layers=2,
                    cond_dim=vae_cfg.z_dim, audio_dim=32, num_audio_token=4,
                    audio_inject_layers=(0, 1))
    return cfg, t5_cfg, vae_cfg


def phase_small_s2v():
    """The small S2V in float32: a plain and a motion request (9 frames, 256 x 256, 2
    steps, CFG) through the kernels against attn_impl="plain" (cudnn TF32 off): frames
    within 1e-2, launches exact (12 K1 per step: 2 x (2 self + 2 cross + 2 audio))."""
    from goal_force_tpu_torch.ops import flash_attention as fa
    from goal_force_tpu_torch.pipelines.s2v import S2VPipeline

    cfg, t5_cfg, vae_cfg = _small_s2v_configs()
    pipe = S2VPipeline.init_random(seed=12, cfg=cfg, t5_cfg=t5_cfg, vae_cfg=vae_cfg,
                                   dtype=torch.float32, device="cuda")
    frames, h, w = 9, 256, 256
    x = _s2v_request_inputs(13, frames, h, w, motion=True)
    audio = np.random.default_rng(14).normal(size=(1, 25, cfg.audio_dim, frames - 1))
    tf32_before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    launches = {}
    try:
        for name, extra, n_frames in (("plain", {}, frames),
                                      ("motion", {"motion_video": x["motion"]}, frames + 72)):
            kw = dict(audio_embeds=audio.astype(np.float32), seed=15, num_frames=frames,
                      num_inference_steps=S2V_STEPS, cfg_scale=5.0, **extra)
            pipe.attn_impl = "auto"
            fa.reset_launch_counts()
            got = pipe("a small check", x["image"], **kw)
            launches[name] = dict(fa.launch_counts)
            pipe.attn_impl = "plain"
            ref = pipe("a small check", x["image"], **kw)
            err = float(np.abs(got - ref).max())
            log("small_s2v", request=name, frames_shape=list(got.shape), launches=launches[name],
                frames_max_abs_err=err, frames_atol=1e-2, ok=err <= 1e-2)
            check(got.shape == (n_frames, h, w, 3) and bool(np.isfinite(got).all()),
                  f"small_s2v {name}: frames of shape {got.shape} or not finite")
            check(launches[name] == only(K1=12 * S2V_STEPS),
                  f"small_s2v {name} launched {launches[name]}")
            check(err <= 1e-2, f"small_s2v {name}: kernels vs plain attention differ by {err}")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32_before
        pipe.attn_impl = "auto"
    del pipe
    torch.cuda.empty_cache()
    return {k: launches["plain"][k] + launches["motion"][k] for k in launches["plain"]}


def _wav2vec_embeds(root, frames):
    """audio_embeds from the card: a random wav2vec2-large-shaped model (hidden 1024, 24
    layers: 25 hidden states) written by save_pretrained and read back, Wav2Vec2Features
    .extract on 16 kHz noise, then get_audio_embed_bucket_fps's first bucket of frames - 1
    video frames."""
    from transformers import Wav2Vec2Config, Wav2Vec2ForCTC

    from goal_force_tpu_torch.models.audio import Wav2Vec2Features, get_audio_embed_bucket_fps

    torch.manual_seed(16)
    cfg = Wav2Vec2Config(hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
                         intermediate_size=4096, vocab_size=32)
    path = os.path.join(root, "wav2vec2-large")
    t0 = time.perf_counter()
    with torch.device("cuda"):          # the random init on the card, not the host
        Wav2Vec2ForCTC(cfg).save_pretrained(path)
    save_s = time.perf_counter() - t0
    feats, load_s = sync_time(lambda: Wav2Vec2Features(path, device="cuda"))
    wav = (np.random.default_rng(17).normal(size=(16000 * frames // 16,)) * 0.1).astype(np.float32)
    stack, secs = sync_time(lambda: feats.extract(wav, 16000, fps=16))
    buckets, n = get_audio_embed_bucket_fps(stack[0], fps=16, batch_frames=frames - 1)
    log("s2v", stage="wav2vec2", save_seconds=save_s, load_seconds=load_s, extract_seconds=secs,
        features=list(stack.shape), dtype=str(stack.dtype), buckets=n,
        model_params=sum(p.numel() for p in feats.model.parameters()))
    check(stack.shape[:3] == (1, 25, 1024) and bool(np.isfinite(stack).all()),
          f"wav2vec2 features of shape {stack.shape} or not finite")
    del feats
    torch.cuda.empty_cache()
    return buckets[:1]


def phase_s2v():
    """S2VPipeline at Wan2.2-S2V-14B widths (dim 5120, 40 x 128 heads, ffn 13824, audio_dim
    1024 over 25 wav2vec2 layers, 4 audio tokens) with 2 of 40 layers and injections after
    layers (0, 1), umt5-xxl at 2 of 24 layers, the full Wan2.1 VAE, random weights, 2 of 50
    steps at CFG 5.0: (a) audio_embeds from wav2vec2 on the card at 81x480x832 (32,760
    self tokens, audio B = 20 at 1,560 x 5), (b) with a pose video at 33 frames, (c) a
    motion request (73-frame motion video) at 448x832 and 17 frames, (d) one step with
    every self-attention's norm_q x8 (self on K2, cross and audio on K1), then a step
    with the runtime bound's host sync taken away, to time it."""
    import gc
    import tempfile

    from goal_force_tpu_torch import configs as C
    from goal_force_tpu_torch.models import s2v as s2vm
    from goal_force_tpu_torch.ops import flash_attention as fa
    from goal_force_tpu_torch.pipelines.s2v import S2VPipeline

    cfg = dataclasses.replace(s2vm.WAN22_S2V_14B, num_layers=S2V_LAYERS,
                              audio_inject_layers=(0, 1))
    t5_cfg = dataclasses.replace(C.UMT5_XXL, num_layers=2)
    pipe, secs = sync_time(lambda: S2VPipeline.init_random(
        seed=21, cfg=cfg, t5_cfg=t5_cfg, vae_cfg=C.WAN21_VAE, dtype=torch.bfloat16,
        device="cuda"))
    log("s2v", stage="init", seconds=secs,
        params={k: sum(p.numel() for p in m.parameters()) for k, m in pipe.models.items()},
        memory_gb=torch.cuda.memory_allocated() / 2**30)
    pc = pipe.pipe_cfg
    with tempfile.TemporaryDirectory() as root:
        audio = _wav2vec_embeds(root, pc.num_frames)
    gc.collect()
    prompt = "a woman speaks to the camera in a bright room"
    kw = dict(seed=22, num_inference_steps=S2V_STEPS, cfg_scale=5.0)
    x = _s2v_request_inputs(23, pc.num_frames, pc.height, pc.width)
    fa.reset_launch_counts()
    a = _s2v_request(pipe, "s2v", "a_81", lambda: pipe(prompt, x["image"], audio_embeds=audio,
                                                         num_frames=pc.num_frames, **kw),
                     (pc.num_frames, pc.height, pc.width, 3), S2V_K1_PER_STEP)
    xb = _s2v_request_inputs(23, S2V_POSE_FRAMES, pc.height, pc.width, pose=True)
    audio_b = np.ascontiguousarray(audio[..., :S2V_POSE_FRAMES - 1])
    request_b = lambda: pipe(prompt, x["image"], audio_embeds=audio_b,
                             s2v_pose_video=xb["pose"], num_frames=S2V_POSE_FRAMES, **kw)
    before = dict(fa.launch_counts)
    b = _s2v_request(pipe, "s2v", f"b_pose_{S2V_POSE_FRAMES}", request_b,
                     (S2V_POSE_FRAMES, pc.height, pc.width, 3), S2V_K1_PER_STEP, base=a)
    b_launches = {k: fa.launch_counts[k] - before[k] for k in before}
    xc = _s2v_request_inputs(24, S2V_MOTION_FRAMES, 448, pc.width, motion=True)
    audio_c = np.ascontiguousarray(audio[..., :S2V_MOTION_FRAMES - 1])
    _s2v_request(pipe, "s2v", f"c_motion_448_{S2V_MOTION_FRAMES}", lambda: pipe(
        prompt, xc["image"], audio_embeds=audio_c, motion_video=xc["motion"],
        num_frames=S2V_MOTION_FRAMES, **kw), (72 + S2V_MOTION_FRAMES, 448, pc.width, 3),
        S2V_K1_PER_STEP)
    run_counts = dict(fa.launch_counts)
    run_counts["K2"] += _s2v_unbounded_step(pipe, audio, x["image"])
    sharded_launches = phase_sharded_s2v(pipe, request_b, b, b_launches,
                                         (S2V_POSE_FRAMES, pc.height, pc.width, 3))
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return run_counts, sharded_launches


def phase_sharded_s2v(pipe, request, frames_b, launches_b, frames_shape):
    """Request (b) again with the S2V pipeline's mesh set to the NCCL world of one rank
    (pipe.shard(make_mesh(1, 1, 1))): every attention takes its heads over ("sp", "tp")
    and its batch rows over "dp" (all of them, over one rank) and gathers them back, the
    token ids are broadcast from rank 0. Frames must equal (b)'s (bit-equal expected:
    every collective is a copy) and K1/K2 launch as in (b); logs the collectives. No
    multi-GPU time is measured."""
    from goal_force_tpu_torch.ops import flash_attention as fa
    from goal_force_tpu_torch.parallel import collectives as col

    log("sharded_s2v", stage="start")
    pipe.shard(_world_mesh())
    col.counts.clear()
    before = dict(fa.launch_counts)
    try:
        frames = _s2v_request(pipe, "sharded_s2v", "b_pose_sharded", request, frames_shape,
                              S2V_K1_PER_STEP)
    finally:
        pipe.mesh = None
    calls = dict(col.counts)
    launches = {k: fa.launch_counts[k] - before[k] for k in before}
    _sharded_equal("sharded_s2v", "b_pose", frames, frames_b, launches, launches_b)
    # per step: CFG's two forwards x (4 self, 4 text cross, 2 audio) attentions, each
    # gathering its heads and its rows; the prompts' ids and mask broadcast once
    want = {"all_gather": 2 * S2V_K1_PER_STEP * S2V_STEPS, "broadcast": 2}
    log("sharded_s2v", collectives=calls, expected_collectives=want)
    check(calls == want, f"sharded_s2v: collectives {calls}, expected {want}")
    return launches


def _s2v_unbounded_step(pipe, audio, image):
    """(d): one CFG step at 81 frames with every self-attention's norm_q x8, so the
    runtime bound sends self-attention to K2 (8 launches) and cross and audio stay on K1
    (12); then the same step as it is, twice with the bound and twice with the bound
    replaced by a host constant (same kernels, no reductions, no host sync). Returns the
    K2 launches of (d)."""
    from goal_force_tpu_torch.ops import flash_attention as fa

    pc = pipe.pipe_cfg
    model = pipe.models["s2v"]
    gen = torch.Generator("cuda").manual_seed(25)
    lat = torch.randn((1, pc.latent_frames, pc.latent_height, pc.latent_width, 16),
                      generator=gen, device="cuda").to(pipe.dtype)
    ctx = pipe.encode_prompts(["a woman speaks", pc.negative_prompt])
    ref_lat = pipe._encode_px(image[None])
    aud = torch.as_tensor(audio, device="cuda").to(pipe.dtype)
    t = torch.full((1,), 1000.0, dtype=pipe.dtype, device="cuda")

    def step():
        return pipe.denoise_step(lat, ref_lat, t, 1.0, 0.9375, ctx[:1], ctx[1:], aud, None,
                                 None, 5.0)

    for blk in model.blocks:
        blk.self_attn.norm_q.weight.mul_(8)
    try:
        fa.reset_launch_counts()
        out, secs = sync_time(step)
        launches = dict(fa.launch_counts)
    finally:
        for blk in model.blocks:
            blk.self_attn.norm_q.weight.div_(8)
    check(tuple(out.shape) == tuple(lat.shape) and bool(torch.isfinite(out.float()).all()),
          "s2v unbounded step: bad output")
    check(launches == only(K1=2 * (S2V_LAYERS + 2), K2=2 * S2V_LAYERS),
          f"s2v unbounded step launched {launches}")
    log("s2v", stage="d_unbounded_step", seconds=secs, launches=launches)
    bound_sync_cost("s2v", "step", step, only(K1=S2V_K1_PER_STEP))
    return launches["K2"]


def phase_image_branch():
    """The CLIP ViT-H/14 vision tower at full width (random bf16 weights) encodes one
    480 x 832 frame; a DiT at Wan2.1-I2V-14B-480P widths (in_dim 36, has_image_input, 4 of
    40 layers, img_emb and k_img/v_img) runs one wan_dit_forward at B = 2, 81x480x832,
    with the frame's clip_feature (12 K1: 4 self, 4 text, 4 image) and without it (8 K1);
    the two velocities must differ."""
    import gc

    from goal_force_tpu_torch import configs as C
    from goal_force_tpu_torch.models import image_encoder as vit
    from goal_force_tpu_torch.models import wan_dit
    from goal_force_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator("cuda").manual_seed(31)
    tower = vit.init_vit(vit.VIT_H_14, gen, torch.bfloat16, device="cuda")
    image = _s2v_request_inputs(32, 1, 480, 832)["image"]
    vit.encode_image(tower, image)                                  # warm-up
    clip, secs = sync_time(lambda: vit.encode_image(tower, image))
    check(tuple(clip.shape) == (1, 257, 1280) and bool(torch.isfinite(clip.float()).all()),
          f"image encoder: clip_feature of shape {tuple(clip.shape)} or not finite")
    log("image_branch", stage="vit_h_14", seconds=secs, clip_feature=list(clip.shape),
        params=sum(p.numel() for p in tower.parameters()))
    del tower
    cfg = dataclasses.replace(C.WAN22_A14B, has_image_input=True, num_layers=4)
    dit = wan_dit.init_wan_dit(cfg, gen, torch.bfloat16, device="cuda")
    wan_dit.init_image_branch_(dit, gen, clip_dim=1280)
    b = 2
    x = torch.randn((b, 21, 60, 104, 16), generator=gen, device="cuda").to(torch.bfloat16)
    y = torch.randn((b, 21, 60, 104, 20), generator=gen, device="cuda").to(torch.bfloat16)
    ctx = torch.randn((b, 512, 4096), generator=gen, device="cuda").to(torch.bfloat16)
    t = torch.tensor([900.0, 900.0], device="cuda", dtype=torch.bfloat16)
    clip2 = clip.expand(b, -1, -1)
    outs, launches = {}, {}
    with torch.no_grad():
        for name, kw, want in (("with_clip", dict(clip_feature=clip2), 12), ("without", {}, 8)):
            torch.cuda.reset_peak_memory_stats()
            (outs[name], n), secs = sync_time(lambda: picked(
                lambda: wan_dit.wan_dit_forward(dit, cfg, x, t, ctx, y, **kw)))
            launches[name] = n
            log("image_branch", stage=name, seconds=secs, launches=n,
                peak_gb=torch.cuda.max_memory_allocated() / 2**30)
            check(n == only(K1=want), f"image_branch {name} launched {n}")
            check(bool(torch.isfinite(outs[name].float()).all()),
                  f"image_branch {name}: not finite")
    diff = float((outs["with_clip"].float() - outs["without"].float()).abs().max())
    log("image_branch", stage="compare", max_abs_diff=diff)
    check(diff > 1e-3, f"image_branch: clip_feature changed nothing ({diff})")
    # the forward with the clip_feature again, placed on the world of one: the image
    # cross-attention on the rank's heads and tokens against the replicated CLIP keys
    from goal_force_tpu_torch.parallel.mesh import use_mesh
    from goal_force_tpu_torch.parallel.sharding import place

    mesh = _world_mesh()
    place(dit, mesh)
    with torch.no_grad(), use_mesh(mesh):
        (got, n), secs = sync_time(lambda: picked(
            lambda: wan_dit.wan_dit_forward(dit, cfg, x, t, ctx, y, clip_feature=clip2)))
    log("image_branch", stage="sharded", seconds=secs)
    _sharded_equal("image_branch", "with_clip", got, outs["with_clip"], n, only(K1=12))
    del dit, outs, x, y, ctx, got
    gc.collect()
    torch.cuda.empty_cache()
    return {k: launches["with_clip"][k] + launches["without"][k] for k in launches["without"]}


def phase_vae38():
    """The Wan2.2 VAE (VAE38: dim 160, dec_dim 256, z 48, patch 2, 16x) at full width with
    random weights: encode and decode one 81x480x832 video in float32, untiled; logs the
    times and peaks."""
    import gc

    from goal_force_tpu_torch.models import vae38

    gen = torch.Generator("cuda").manual_seed(41)
    cfg = vae38.WAN22_VAE38
    vae = vae38.init_vae38(cfg, gen, torch.float32, device="cuda")
    video = torch.rand((1, 81, 480, 832, 3), generator=gen, device="cuda") * 2 - 1
    with torch.no_grad():
        for name in ("encode", "decode"):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            if name == "encode":
                lat, secs = sync_time(lambda: vae38.encode_video(vae, cfg, video))
                out, want = lat, (1, 21, 30, 52, 48)
            else:
                out, secs = sync_time(lambda: vae38.decode_video(vae, cfg, lat))
                want = (1, 81, 480, 832, 3)
            log("vae38", stage=name, seconds=secs, shape=list(out.shape),
                resident_gb=base / 2**30, peak_gb=torch.cuda.max_memory_allocated() / 2**30)
            check(tuple(out.shape) == want and bool(torch.isfinite(out).all()),
                  f"vae38 {name}: shape {tuple(out.shape)} or not finite")
    check(float(out.abs().max()) <= 1.0, "vae38 decode: frames outside [-1, 1]")
    del vae, video, lat, out
    gc.collect()
    torch.cuda.empty_cache()


# HunyuanVideo at JAX's defaults: 720x1280, 129 frames -> 33x90x160 latents, 33x45x80 =
# 118,800 image tokens + 256 text tokens in every joint attention, 24 heads of 128;
# 20 double + 40 single blocks, each one K1 launch per forward (B = 1 without CFG).
HY_HEIGHT, HY_WIDTH, HY_FRAMES, HY_STEPS = 720, 1280, 129, 2
HY_K1_PER_STEP = 20 + 40
HY_SELF = (1, 33 * 45 * 80 + 256, 24, 128)
# 544x960x129 under CFG: 33x34x60 = 67,320 image + 256 text tokens, B = 2, two prompts
# of 77 and 200 valid text tokens (kv_len not a multiple of the 128-key tile).
HY_B2 = (2, 33 * 34 * 60 + 256, 24, 128)
HY_B2_KV = (33 * 34 * 60 + 77, 33 * 34 * 60 + 200)
HY_PROMPT = "a red ball rolls across a wooden table, hits a blue cup and the cup tips over"


def _small_hunyuan_config():
    from goal_force_tpu_torch.models.hunyuan_video_dit import HunyuanVideoDiTConfig

    return HunyuanVideoDiTConfig(dim=256, num_heads=2, num_double_blocks=1,
                                 num_single_blocks=1, text_dim=64, pooled_dim=64)


def phase_small_hunyuan():
    """The HunyuanVideo DiT forward at head_dim 128 (dim 256, 2 heads, 1 double + 1 single
    block), B = 2 rows with 5 and 130 valid text tokens of 256 and 128 image tokens (384
    joint tokens, kv_len 133 and 258): attn_impl "flash" (K1, 2 launches) against "plain"
    on the same inputs, in float32 (within 1e-4 of the output's scale) and bf16 (within
    2 bf16 ulps of the largest output per block, over the 2 blocks: 3e-2 of it)."""
    from goal_force_tpu_torch.models import hunyuan_video_dit as hd
    from goal_force_tpu_torch.ops import flash_attention as fa

    cfg = _small_hunyuan_config()
    gen = torch.Generator("cuda").manual_seed(71)
    rec = {}
    for dtype, rel in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
        tag = str(dtype).split(".")[-1]
        dit = hd.init_hunyuan_video_dit(cfg, gen, dtype, device="cuda")
        mask = torch.zeros((2, cfg.txt_len), dtype=torch.int32, device="cuda")
        mask[0, :5], mask[1, :130] = 1, 1
        args = (_rand((2, 2, 16, 16, 16), gen, dtype), torch.tensor([900.0, 250.0], device="cuda"),
                _rand((2, cfg.txt_len, cfg.text_dim), gen, dtype), mask,
                _rand((2, cfg.pooled_dim), gen, dtype),
                torch.tensor([6.0, 6.0], device="cuda", dtype=dtype))
        fa.reset_launch_counts()
        got = hd.hunyuan_video_dit_forward(dit, cfg, *args, attn_impl="flash")
        torch.cuda.synchronize()
        n = dict(fa.launch_counts)
        ref = hd.hunyuan_video_dit_forward(dit, cfg, *args, attn_impl="plain")
        scale = float(ref.float().abs().max())
        name = f"small_hunyuan DiT forward {tag} flash vs plain"
        if dtype == torch.float32:
            err = compare(name, got, ref, atol=rel * scale, rtol=0.0, phase="small_hunyuan")
        else:   # bf16 roundings of two whole blocks: the bound only, the bias is logged
            d = (got.float() - ref.float())
            err = float(d.abs().max())
            ok = bool(torch.isfinite(got).all()) and err <= rel * scale
            log("small_hunyuan", case=name, max_abs_err=err, atol=rel * scale,
                rel_bias=float((d * ref.float().sign()).mean() / ref.float().abs().mean()),
                ok=ok)
            check(ok, f"{name}: differ by {err}")
        check(n == only(K1=2), f"small_hunyuan {tag}: launched {n}")
        rec[tag] = dict(max_abs_err=err, out_max=scale, launches=n["K1"])
        del dit, got, ref
    log("small_hunyuan", tokens=2 * 8 * 8 + 256, kv_len=[133, 258], **rec)
    torch.cuda.empty_cache()
    return {"K1": sum(r["launches"] for r in rec.values())}


def _hunyuan_k1(shape, kv_len, gen, phase="hunyuan"):
    """K1 with its clamp (dispatch "nomax", as the joint attention calls it) on random bf16
    q, k, v of `shape` with per-row kv_len: against its plain version (timed on that run),
    then timed with SDPA given the same key mask. The bound counts the keys each row
    attends (its kv_len)."""
    from goal_force_tpu_torch.ops import flash_attention as fa

    scale = 128**-0.5
    b, s, n, h = shape
    q, k, v = (_rand(shape, gen, torch.bfloat16) for _ in range(3))
    lens = torch.tensor(kv_len, device="cuda")
    kern = lambda a, bb, c: fa.flash_attention_nomax(a, bb, c, scale, kv_len=lens)
    plain = lambda a, bb, c: fa.flash_attention_nomax_plain(a, bb, c, scale, kv_len=lens)
    got, launched = picked(lambda: kern(q, k, v))
    check(launched == only(K1=1), f"K1 hunyuan {shape}: launched {launched}")
    name = f"K1 hunyuan {shape} kv_len {list(kv_len)} bf16"
    ref, plain_ms = timed_call(lambda: plain(q, k, v))
    err = compare(name, got, ref, atol=bf16_limit(ref), rtol=0.0, phase=phase)
    del got, ref
    torch.cuda.empty_cache()
    flops = 4 * n * h * s * sum(kv_len)
    nbytes = 2 * (2 * b * s * n * h + 2 * b * s * n * h)
    bound, by = kernel_bound_ms(flops, nbytes)
    keep = (torch.arange(s, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rec = dict(max_abs_err=err, ms=event_ms(lambda: kern(q, k, v)), plain_ms=plain_ms,
               bound_ms=bound, bound_by=by,
               full_kv_bound_ms=4 * b * n * s * s * h / PEAK_BF16_FLOPS * 1e3,
               library_ms=event_ms(lambda: sdpa(q.transpose(1, 2), k.transpose(1, 2),
                                                v.transpose(1, 2), attn_mask=keep)),
               shape=f"{shape}x{shape}", kv_len=list(kv_len))
    log(phase, case=f"{name} timing", **rec)
    del q, k, v
    torch.cuda.empty_cache()
    return rec


def phase_hunyuan():
    """HunyuanVideo text-to-video at full width and depth on one card, random bf16
    weights from a seed: the 12.8 B DiT (20 double + 40 single blocks), the 32-layer Llama
    tower (the last 2 skipped), CLIP-L with the vendored BPE tokenizer, the VAE decoder.
    One request at 720x1280x129 (2 Euler steps, embedded guidance 6.0, no CFG, tiled decode
    with JAX's default tiles): 120 K1 launches and no K2; finite frames of shape
    (1, 129, 720, 1280, 3). Logs text, step and decode seconds and the peak. Then K1 at
    B = 2, 67,576 tokens (544x960 under CFG) with two per-row kv_len that are not tile
    multiples, and at the path's B = 1, 119,056 tokens with the kv_len that the request's
    joint attentions were given, each against its plain version and timed with its bound
    and SDPA."""
    from goal_force_tpu_torch.models import clip as clipm
    from goal_force_tpu_torch.models import hunyuan_video_dit as hd
    from goal_force_tpu_torch.models import hunyuan_video_vae as hv
    from goal_force_tpu_torch.models import text_encoders as te
    from goal_force_tpu_torch.models.sd_text_encoder import SD_TEXT_CONFIG
    from goal_force_tpu_torch.ops import flash_attention as fa
    from goal_force_tpu_torch.pipelines import hunyuan_video as hp
    from goal_force_tpu_torch.prompters import hunyuan_video_clip_tokenizer

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator("cuda").manual_seed(81)
    cfg, llama_cfg, vae_cfg = hd.HunyuanVideoDiTConfig(), te.LlamaConfig(), hv.HunyuanVAEConfig()
    (dit, llama, clip, dec), init_s = sync_time(lambda: (
        hd.init_hunyuan_video_dit(cfg, gen, torch.bfloat16, device="cuda"),
        te.init_llama(llama_cfg, gen, torch.bfloat16, device="cuda"),
        clipm.init_clip_text(SD_TEXT_CONFIG, gen, torch.bfloat16, device="cuda"),
        hv.init_hunyuan_vae(hv.HunyuanVAEDecoder, vae_cfg, gen, torch.bfloat16, device="cuda")))
    count = lambda m: sum(p.numel() for p in m.parameters())
    log("hunyuan", stage="init", seconds=init_s, dit_params=count(dit), llama_params=count(llama),
        clip_params=count(clip), vae_decoder_params=count(dec),
        gib=torch.cuda.memory_allocated() / 2**30)
    encode = hp.make_llama_prompt_encoder(llama, llama_cfg, clip, SD_TEXT_CONFIG, cfg.txt_len,
                                          tokenize_clip=hunyuan_video_clip_tokenizer())
    _, decode = hp.vae_codecs(dec, vae_cfg)
    stages = {"step_s": []}

    def timed_encode(prompt):
        out, stages["text_s"] = sync_time(lambda: encode(prompt))
        return out

    def timed_decode(z, **tk):
        out, stages["decode_s"] = sync_time(lambda: decode(z, **tk))
        return out

    pipe = hp.HunyuanVideoPipeline(dit=dit, dit_cfg=cfg, encode_prompt=timed_encode,
                                   decode_video=timed_decode, dtype=torch.bfloat16)
    step = pipe._step

    def timed_step(*a, **kw):
        out, secs = sync_time(lambda: step(*a, **kw))
        stages["step_s"].append(secs)
        return out

    pipe._step = timed_step
    # the kv_len each joint attention of the request is given (a device tensor, read after)
    attention, kv_seen = hd.attention, []

    def recording_attention(*a, **kw):
        kv_seen.append(kw["kv_len"])
        return attention(*a, **kw)

    hd.attention = recording_attention
    fa.reset_launch_counts()
    try:
        frames, secs = sync_time(lambda: pipe(HY_PROMPT, height=HY_HEIGHT, width=HY_WIDTH,
                                              num_frames=HY_FRAMES,
                                              num_inference_steps=HY_STEPS,
                                              embedded_guidance=6.0, seed=7, tiled=True))
    finally:
        hd.attention = attention
    launches = dict(fa.launch_counts)
    path_kv = sorted({tuple(t.tolist()) for t in kv_seen})
    shape = (1, HY_FRAMES, HY_HEIGHT, HY_WIDTH, 3)
    finite = bool(np.isfinite(frames).all())
    log("hunyuan", stage="request", seconds=secs, **stages, launches=launches,
        k1_per_step=HY_K1_PER_STEP, steps=HY_STEPS, schedule_steps=HY_STEPS,
        tokens=HY_SELF[1], kv_len=path_kv, frames_shape=list(frames.shape), finite=finite,
        frames_mean=float(frames.mean()), frames_std=float(frames.std()),
        peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    check(launches == only(K1=HY_K1_PER_STEP * HY_STEPS), f"hunyuan request launched {launches}")
    check(tuple(frames.shape) == shape and finite, f"hunyuan frames {frames.shape}, finite {finite}")
    img_tokens = HY_SELF[1] - cfg.txt_len
    check(len(kv_seen) == HY_K1_PER_STEP * HY_STEPS and len(path_kv) == 1
          and img_tokens < path_kv[0][0] <= HY_SELF[1],
          f"hunyuan request: {len(kv_seen)} joint attentions with kv_len {path_kv}")
    del pipe, frames, kv_seen
    torch.cuda.empty_cache()
    gen = torch.Generator("cuda").manual_seed(82)
    rec = {"path": _hunyuan_k1(HY_SELF, path_kv[0], gen),
           "b2": _hunyuan_k1(HY_B2, HY_B2_KV, gen)}
    # the full-width modules stay resident for hunyuan_i2v
    return launches, rec, {"dit": dit, "llama": llama, "clip": clip, "dec": dec}


# HunyuanVideo-I2V: a 33-frame cut of the T2V request's 129 (9 latent frames)
HY_I2V_FRAMES = 33
HY_I2V_IMAGE_TOKENS = 9 * 45 * 80
HY_I2V_NEGATIVE = "blurry, low quality, static"
# Llama-3's ids of the template's special tokens, LLaVA's <image> and the double return
# that the MLLM crop anchors on; every other word hashes into the vocabulary
LLAMA_SPECIAL_IDS = {"<|start_header_id|>": 128006, "<|end_header_id|>": 128007,
                     "<|eot_id|>": 128009, "<image>": 128257, "\n\n": 271, "\n": 198}


def hash_encoder(special_ids, span):
    """text -> ids for a tokenizer the repo does not ship: each special token at its id,
    every other word or punctuation mark at a crc32 hash in [1000, 1000 + span)."""
    import re
    import zlib

    special = re.compile("(" + "|".join(re.escape(t) for t in sorted(
        special_ids, key=len, reverse=True)) + ")")

    def encode(text):
        ids = []
        for piece in special.split(text):
            if piece in special_ids:
                ids.append(special_ids[piece])
            else:
                ids += [1000 + zlib.crc32(w.encode()) % span
                        for w in re.findall(r"\w+|[^\w\s]", piece)]
        return ids

    return encode


def llama_hash_tokenizer(length):
    """A TextTokenizer for the Llama prompts (no Llama tokenizer ships with the repo):
    the template's special tokens, <image> and the double and single returns at their
    Llama-3 / LLaVA ids, every other word or punctuation mark at a crc32 hash in
    [1000, 128000). Pads with 128004."""
    from goal_force_tpu_torch.prompters import TextTokenizer

    return TextTokenizer(hash_encoder(LLAMA_SPECIAL_IDS, 127000), length, pad_id=128004)


def phase_hunyuan_i2v(models):
    """HunyuanVideo-I2V on hunyuan's resident full-width modules (the DiT, the 32-layer
    Llama as LLaVA's language model, CLIP-L, the VAE decoder) plus a full-width vision
    tower (CLIP-L/14-336: 24 layers, 1024 wide, 16 heads), the projector and the VAE
    encoder, random bf16 from a seed. One request: a 720x1280 image, 33 frames, 2 steps,
    CFG 6.0 with a negative prompt (B = 2: the image row's 144 image features + its text
    against the negative row's text, padded to one length), token replace and
    i2v_stability, tiled decode. Checks 120 K1 and no K2, the two rows' kv_len differing
    in every joint attention, finite (1, 33, 720, 1280, 3) frames; logs the LLaVA encode,
    step and decode seconds and the peak. Then K1 at the request's own shape with its two
    kv_len against its plain version, timed with its bound and SDPA."""
    from goal_force_tpu_torch.models import hunyuan_video_dit as hd
    from goal_force_tpu_torch.models import hunyuan_video_vae as hv
    from goal_force_tpu_torch.models import llava as llm
    from goal_force_tpu_torch.models.sd_text_encoder import SD_TEXT_CONFIG
    from goal_force_tpu_torch.ops import flash_attention as fa
    from goal_force_tpu_torch.pipelines import hunyuan_video as hp
    from goal_force_tpu_torch.prompters import hunyuan_video_clip_tokenizer

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator("cuda").manual_seed(83)
    cfg, vae_cfg, llava_cfg = hd.HunyuanVideoDiTConfig(), hv.HunyuanVAEConfig(), llm.LlavaConfig()
    (llava, enc), init_s = sync_time(lambda: (
        llm.init_llava(llava_cfg, gen, torch.bfloat16, device="cuda",
                       language_model=models["llama"]),
        hv.init_hunyuan_vae(hv.HunyuanVAEEncoder, vae_cfg, gen, torch.bfloat16, device="cuda")))
    count = lambda m: sum(p.numel() for p in m.parameters())
    log("hunyuan_i2v", stage="init", seconds=init_s, vision_params=count(llava.vision_tower),
        projector_params=count(llava.multi_modal_projector), vae_encoder_params=count(enc),
        gib=torch.cuda.memory_allocated() / 2**30)
    encode = hp.make_llava_prompt_encoder(llava, llava_cfg, models["clip"], SD_TEXT_CONFIG,
                                          cfg.txt_len, tokenize_llama=llama_hash_tokenizer(
                                              cfg.txt_len),
                                          tokenize_clip=hunyuan_video_clip_tokenizer())
    encode_video, decode = hp.vae_codecs({"encoder": enc, "decoder": models["dec"]}, vae_cfg)
    stages = {"text_s": [], "text_tokens": [], "step_s": []}

    def timed_encode(prompt, images=None):
        out, secs = sync_time(lambda: encode(prompt, images))
        stages["text_s"].append(secs)
        stages["text_tokens"].append(out[0].shape[1])
        return out

    def timed_image(v, **tk):
        out, stages["image_encode_s"] = sync_time(lambda: encode_video(v, **tk))
        return out

    def timed_decode(z, **tk):
        out, stages["decode_s"] = sync_time(lambda: decode(z, **tk))
        return out

    pipe = hp.HunyuanVideoPipeline(dit=models["dit"], dit_cfg=cfg, encode_prompt=timed_encode,
                                   decode_video=timed_decode, encode_video=timed_image,
                                   dtype=torch.bfloat16)
    step = pipe._step

    def timed_step(*a, **kw):
        out, secs = sync_time(lambda: step(*a, **kw))
        stages["step_s"].append(secs)
        return out

    pipe._step = timed_step
    attention, kv_seen = hd.attention, []

    def recording_attention(*a, **kw):
        kv_seen.append(kw["kv_len"])
        return attention(*a, **kw)

    image = np.random.default_rng(84).uniform(0, 1, (HY_HEIGHT, HY_WIDTH, 3)).astype(np.float32)
    hd.attention = recording_attention
    fa.reset_launch_counts()
    try:
        frames, secs = sync_time(lambda: pipe(
            HY_PROMPT, negative_prompt=HY_I2V_NEGATIVE, cfg_scale=6.0, input_images=image,
            height=HY_HEIGHT, width=HY_WIDTH, num_frames=HY_I2V_FRAMES,
            num_inference_steps=HY_STEPS, embedded_guidance=6.0, seed=8, tiled=True))
    finally:
        hd.attention = attention
    launches = dict(fa.launch_counts)
    rows_kv = sorted({tuple(t.tolist()) for t in kv_seen})
    shape = (1, HY_I2V_FRAMES, HY_HEIGHT, HY_WIDTH, 3)
    finite = bool(np.isfinite(frames).all())
    tokens = HY_I2V_IMAGE_TOKENS + max(stages["text_tokens"])
    log("hunyuan_i2v", stage="request", seconds=secs, **stages, launches=launches,
        k1_per_step=HY_K1_PER_STEP, steps=HY_STEPS, tokens=tokens, kv_len=rows_kv,
        frames_shape=list(frames.shape), finite=finite, frames_mean=float(frames.mean()),
        frames_std=float(frames.std()), peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    check(launches == only(K1=HY_K1_PER_STEP * HY_STEPS),
          f"hunyuan_i2v request launched {launches}")
    check(tuple(frames.shape) == shape and finite,
          f"hunyuan_i2v frames {frames.shape}, finite {finite}")
    check(len(kv_seen) == HY_K1_PER_STEP * HY_STEPS and len(rows_kv) == 1
          and len(rows_kv[0]) == 2 and rows_kv[0][0] != rows_kv[0][1]
          and all(HY_I2V_IMAGE_TOKENS < n <= tokens for n in rows_kv[0]),
          f"hunyuan_i2v: {len(kv_seen)} joint attentions with kv_len {rows_kv}")
    check(stages["text_tokens"][0] == 144 + cfg.txt_len - 4
          and stages["text_tokens"][1] == cfg.txt_len,
          f"hunyuan_i2v prompt lengths {stages['text_tokens']}")
    del pipe, frames, kv_seen, llava, enc
    models.clear()
    gc.collect()     # the timed pipelines' bound methods form cycles with them
    torch.cuda.empty_cache()
    rec = _hunyuan_k1((2, tokens, 24, 128), rows_kv[0], torch.Generator("cuda").manual_seed(85),
                      phase="hunyuan_i2v")
    return launches, rec


def _small_llava_config():
    from goal_force_tpu_torch.models import clip as clipm
    from goal_force_tpu_torch.models import llava as llm
    from goal_force_tpu_torch.models import text_encoders as te

    return llm.LlavaConfig(
        text=te.LlamaConfig(hidden_size=256, num_layers=2, num_heads=2, num_kv_heads=1,
                            intermediate_size=512, vocab=1000),
        vision=clipm.CLIPConfig(image_size=336, patch_size=14, vision_dim=128,
                                vision_heads=2, vision_layers=3))


def phase_small_cog():
    """The LLaVA tower and CogVideoX on the card against the port on the CPU, float32
    with TF32 off, on the same weights and inputs: llava_encode at a small config (576
    image tokens, 2 rows; within 1e-4 of the output's scale); a CogVideoX request on the
    tiny DiT and T5 with a 16-channel tiny VAE decoder (CFG 6.0, 2 DDIM steps, 9 frames
    at 32x48; within 1e-4 of the frames' scale); the chunked plain attention with a bias
    and per-row kv_len (8 blocks) against the CPU's unchunked one. No kernel launches."""
    import copy

    from goal_force_tpu_torch.models import cog_vae as cv
    from goal_force_tpu_torch.models import llava as llm
    from goal_force_tpu_torch.ops import attention as attn
    from goal_force_tpu_torch.ops import flash_attention as fa
    from goal_force_tpu_torch.pipelines import cog_video as cp

    tf32_before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    rec = {}
    try:
        fa.reset_launch_counts()
        cfg = _small_llava_config()
        cpu = llm.init_llava(cfg, torch.Generator().manual_seed(91), torch.float32, device="cpu")
        rng = np.random.default_rng(92)
        ids = rng.integers(2, cfg.text.vocab, size=(2, 20))
        ids[0, 4], ids[1, 9] = cfg.image_token_id, cfg.image_token_id
        mask = np.ones((2, 20), np.int32)
        mask[1, 15:] = 0
        pixels = torch.from_numpy(np.stack([llm.clip_preprocess_image(
            rng.uniform(0, 1, (200 + 40 * i, 300, 3)).astype(np.float32)) for i in range(2)]))
        want = llm.llava_encode(cpu, cfg, ids, pixels, torch.from_numpy(mask))
        got = llm.llava_encode(copy.deepcopy(cpu).to("cuda"), cfg, ids, pixels.cuda(),
                               torch.from_numpy(mask).cuda())
        scale = float(want.abs().max())
        rec["llava"] = compare("small_cog llava_encode cuda vs cpu", got.cpu(), want,
                               atol=1e-4 * scale, rtol=0.0, phase="small_cog")

        vae_cfg = dataclasses.replace(cv.tiny_cog_vae_config(), latent_dim=16)
        pipe = cp.CogVideoPipeline.init_random(seed=93, device="cpu")
        dec = cv.init_cog_vae(cv.CogVAEDecoder, vae_cfg, torch.Generator().manual_seed(94),
                              device="cpu")
        pipe.decode_video = cp.cog_vae_codec(dec, vae_cfg, "decoder")
        noise = torch.randn((1, 3, 4, 6, 16), generator=torch.Generator().manual_seed(95))
        kw = dict(prompt="a ball rolls left", negative_prompt="blurry", cfg_scale=6.0,
                  num_frames=9, height=32, width=48, num_inference_steps=2, noise=noise)
        want = pipe(**kw)
        gpu = cp.CogVideoPipeline(dit=copy.deepcopy(pipe.dit).to("cuda"),
                                  t5=copy.deepcopy(pipe.t5).to("cuda"), dit_cfg=pipe.dit_cfg,
                                  t5_cfg=pipe.t5_cfg, dtype=torch.float32)
        gpu.decode_video = cp.cog_vae_codec(copy.deepcopy(dec).to("cuda"), vae_cfg, "decoder")
        got = gpu(**kw)
        scale = float(np.abs(want).max())
        rec["cog"] = compare("small_cog CogVideoX request cuda vs cpu", torch.from_numpy(got),
                             torch.from_numpy(want), atol=1e-4 * scale, rtol=0.0,
                             phase="small_cog")

        g = torch.Generator().manual_seed(96)
        q, k, v = (torch.randn(s, generator=g) for s in ((2, 37, 3, 64), (2, 29, 3, 64),
                                                          (2, 29, 3, 64)))
        bias = torch.randn((2, 3, 37, 29), generator=g)
        kv_len = torch.tensor([29, 17])
        want = attn.plain_attention(q, k, v, 0.125, bias, kv_len)
        budget = attn.PLAIN_LOGITS_BYTES
        attn.PLAIN_LOGITS_BYTES = 4 * 2 * 3 * 29 * 5     # 5 rows per block: 8 blocks
        try:
            got = attn.plain_attention(*(t.cuda() for t in (q, k, v)), 0.125, bias.cuda(),
                                       kv_len.cuda())
        finally:
            attn.PLAIN_LOGITS_BYTES = budget
        rec["chunked"] = compare("small_cog chunked plain_attention cuda vs unchunked cpu",
                                 got.cpu(), want, atol=1e-5, rtol=0.0, phase="small_cog")
        torch.cuda.synchronize()
        check(dict(fa.launch_counts) == only(), f"small_cog launched {dict(fa.launch_counts)}")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32_before
    log("small_cog", **rec)
    torch.cuda.empty_cache()


# CogVideoX-5B at its widths, cut in depth; JAX's defaults: 49 frames at 480x720 (13 x
# 30 x 45 = 17,550 video + 226 text tokens), CFG 7.0 as one batch of 2, untiled decode
COG_FRAMES, COG_HEIGHT, COG_WIDTH, COG_STEPS = 49, 480, 720, 2
COG_BLOCKS, COG_T5_LAYERS = 2, 2      # blocks cut from 4 for the smoke's time
COG_ATTN = (2, 13 * 30 * 45 + 226, 48, 64)
COG_UNCHUNKED = (2, 4096, 48, 64)        # 6 GiB of float32 logits: held whole on the card
COG_PROMPT = ("A golden retriever chases a red ball across a sunny lawn, "
              "the ball bounces off a wooden fence and rolls back.")


def phase_cog():
    """CogVideoX-5B at its widths (dim 3072, 48x64 heads, text_dim 4096, the VAE at
    (128, 256, 256, 512)), cut to 2 of 42 DiT blocks and T5 v1.1 XXL at 2 of 24 layers,
    random bf16 weights from a seed, the vendored spiece tokenizer: one request at JAX's
    defaults (49 frames at 480x720, CFG 7.0 as B = 2, untiled decode), 2 DDIM steps
    (v-prediction, zero-terminal SNR). No kernel launches (head_dim 64 runs the plain
    attention); finite (1, 49, 480, 720, 3) frames; logs the T5, step and decode seconds
    and the peak. Then the chunked plain attention at Cog's shape (2, 17,776, 48, 64)
    bf16 against SDPA on the same tensors (two bf16 ulps), both timed, with the chunk's
    peak; and the chunked against the unchunked one at (2, 4,096, 48, 64)."""
    from goal_force_tpu_torch import configs as C
    from goal_force_tpu_torch.models import cog_dit as cd
    from goal_force_tpu_torch.models import cog_vae as cv
    from goal_force_tpu_torch.models import t5 as t5m
    from goal_force_tpu_torch.ops import attention as attn
    from goal_force_tpu_torch.ops import flash_attention as fa
    from goal_force_tpu_torch.pipelines import cog_video as cp
    from goal_force_tpu_torch.prompters import cog_tokenizer

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator("cuda").manual_seed(97)
    cfg = dataclasses.replace(cd.CogDiTConfig(), num_blocks=COG_BLOCKS)
    t5_cfg = dataclasses.replace(C.T5_V1_1_XXL, num_layers=COG_T5_LAYERS, text_len=226)
    vae_cfg = cv.CogVAEConfig()
    (dit, t5, dec), init_s = sync_time(lambda: (
        cd.init_cog_dit(cfg, gen, torch.bfloat16, device="cuda"),
        t5m.init_t5(t5_cfg, gen, torch.bfloat16, device="cuda"),
        cv.init_cog_vae(cv.CogVAEDecoder, vae_cfg, gen, torch.bfloat16, device="cuda")))
    count = lambda m: sum(p.numel() for p in m.parameters())
    log("cog", stage="init", seconds=init_s, dit_params=count(dit), t5_params=count(t5),
        vae_decoder_params=count(dec), gib=torch.cuda.memory_allocated() / 2**30)
    decode = cp.cog_vae_codec(dec, vae_cfg, "decoder")
    stages = {"step_s": []}

    def timed_decode(z, **tk):
        out, stages["decode_s"] = sync_time(lambda: decode(z, **tk))
        return out

    pipe = cp.CogVideoPipeline(dit=dit, t5=t5, dit_cfg=cfg, t5_cfg=t5_cfg,
                               tokenize=cog_tokenizer(), decode_video=timed_decode,
                               dtype=torch.bfloat16)
    encode_text, velocity = pipe._encode_text, pipe._velocity

    def timed_text(prompts):
        out, stages["t5_s"] = sync_time(lambda: encode_text(prompts))
        return out

    def timed_velocity(*a):
        out, secs = sync_time(lambda: velocity(*a))
        stages["step_s"].append(secs)
        return out

    pipe._encode_text, pipe._velocity = timed_text, timed_velocity
    fa.reset_launch_counts()
    frames, secs = sync_time(lambda: pipe(COG_PROMPT, num_frames=COG_FRAMES, height=COG_HEIGHT,
                                          width=COG_WIDTH, num_inference_steps=COG_STEPS,
                                          cfg_scale=7.0, seed=9))
    launches = dict(fa.launch_counts)
    shape = (1, COG_FRAMES, COG_HEIGHT, COG_WIDTH, 3)
    finite = bool(np.isfinite(frames).all())
    log("cog", stage="request", seconds=secs, **stages, launches=launches, steps=COG_STEPS,
        tokens=COG_ATTN[1], frames_shape=list(frames.shape), finite=finite,
        frames_mean=float(frames.mean()), frames_std=float(frames.std()),
        peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    check(launches == only(), f"cog request launched {launches}")
    check(tuple(frames.shape) == shape and finite, f"cog frames {frames.shape}, finite {finite}")
    del pipe, dit, t5, dec, frames
    gc.collect()
    torch.cuda.empty_cache()

    gen = torch.Generator("cuda").manual_seed(98)
    scale = 64 ** -0.5
    q, k, v = (_rand(COG_ATTN, gen, torch.bfloat16) for _ in range(3))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got, plain_ms = timed_call(lambda: attn.plain_attention(q, k, v, scale))
    chunk_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)).transpose(1, 2)
    ref = sdpa()
    err = compare(f"cog chunked plain_attention {COG_ATTN} bf16 vs SDPA", got, ref,
                  atol=bf16_limit(ref), rtol=0.0, phase="cog")
    b, s, n, h = COG_ATTN
    bound, by = kernel_bound_ms(4 * b * n * s * s * h, 2 * 4 * b * s * n * h)
    rec = dict(shape=list(COG_ATTN), max_abs_err=err, plain_ms=plain_ms,
               plain_warm_ms=event_ms(lambda: attn.plain_attention(q, k, v, scale)),
               sdpa_ms=event_ms(sdpa), bound_ms=bound, bound_by=by,
               rows_per_block=max(1, attn.PLAIN_LOGITS_BYTES // (4 * b * n * s)),
               chunk_peak_gib=chunk_peak)
    log("cog", case="chunked plain_attention timing", **rec)
    del q, k, v, got, ref
    torch.cuda.empty_cache()
    q, k, v = (_rand(COG_UNCHUNKED, gen, torch.bfloat16) for _ in range(3))
    got = attn.plain_attention(q, k, v, scale)
    budget = attn.PLAIN_LOGITS_BYTES
    attn.PLAIN_LOGITS_BYTES = 1 << 62
    try:
        ref = attn.plain_attention(q, k, v, scale)
    finally:
        attn.PLAIN_LOGITS_BYTES = budget
    rec["unchunked_max_abs_err"] = compare(
        f"cog chunked vs unchunked plain_attention {COG_UNCHUNKED} bf16", got, ref,
        atol=bf16_limit(ref), rtol=0.0, phase="cog")
    del q, k, v, got, ref
    torch.cuda.empty_cache()
    return launches, rec


# The small StepVideo DiT: head_dim 128 so that "auto" reaches K1 (2 heads, 1 block), 2
# latent frames of 8x16 (256 image tokens) against 8 CLIP + 20 caption tokens (28 keys)
def _small_stepvideo_configs():
    from goal_force_tpu_torch.models import stepvideo_dit as sd
    from goal_force_tpu_torch.models import stepvideo_vae as sv
    from goal_force_tpu_torch.models import text_encoders as te

    return (sd.StepVideoConfig(num_heads=2, head_dim=128, num_layers=1, in_channels=16,
                               caption_dim=64, clip_dim=32),
            te.BertConfig(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=48,
                          max_positions=80),
            te.Step1Config(hidden_size=64, num_layers=2, num_heads=4, num_groups=2,
                           ffn_hidden_size=96, vocab=1000, multiple_of=32),
            sv.tiny_stepvideo_vae_config())


class BoundRecorder:
    """Wraps ops/flash_attention.py::logit_bound while active: counts the runtime bound's
    calls (one host sync each in flash_attention's "auto") and, with values=True, keeps
    each bound (one more sync each). With replace=True each call returns a host zero
    instead: the same kernels under the bound, with no reductions and no host sync."""

    def __init__(self, values=False, replace=False):
        self.values, self.replace, self.calls, self.bounds = values, replace, 0, []

    def __enter__(self):
        from goal_force_tpu_torch.ops import flash_attention as fa

        self.real = fa.logit_bound

        def recording(*a):
            out = torch.zeros(()) if self.replace else self.real(*a)
            self.calls += 1
            if self.values:
                self.bounds.append(float(out))
            return out

        fa.logit_bound = recording
        return self

    def __exit__(self, *exc):
        from goal_force_tpu_torch.ops import flash_attention as fa

        fa.logit_bound = self.real


def bound_sync_cost(phase, unit, fn, launches):
    """The runtime bound's cost over one `unit` (fn): fn timed with the bound and with it
    replaced, in turns (with, replaced, replaced, with), each call's launches held to
    `launches`; logs the times, the difference of their minima and the bound's calls."""
    times = {"with_bound": [], "bound_replaced": []}
    for key in ("with_bound", "bound_replaced", "bound_replaced", "with_bound"):
        with BoundRecorder(replace=key == "bound_replaced") as bounds:
            n = picked(lambda: times[key].append(sync_time(fn)[1]))[1]
        check(n == launches, f"{phase} {unit} ({key}) launched {n}")
    log(phase, stage="bound_sync_cost", **{
        f"{unit}_seconds": times,
        f"per_{unit}_cost_s": min(times["with_bound"]) - min(times["bound_replaced"]),
        f"bound_calls_per_{unit}": bounds.calls})


def phase_small_stepvideo():
    """StepVideo's modules at small sizes on the card: the DiT forward at head_dim 128 (2
    heads, 1 block, 256 image tokens, 28 text keys), "auto" (K1 through the runtime bound,
    2 launches: self and cross) against "plain" on the same inputs, float32 (within 1e-4
    of the output's scale) and bf16 (within 3e-2 of it: two blocks' worth of bf16
    roundings, as small_hunyuan); BERT (2 layers, a padded row) and Step-1 (2 layers, 2
    groups of 2 heads, 320 tokens) on the card against the CPU in float32 (1e-4 of the
    scale) and in bf16 against the card's float32 (3e-2 of the scale); the tiny VAE's
    chunked decode (2 chunks, the seam mix) on the card against the CPU, float32 with TF32
    off (1e-4 of the scale). Logs the K1 launches and the bounds the dispatch read."""
    import copy

    from goal_force_tpu_torch.models import stepvideo_dit as sd
    from goal_force_tpu_torch.models import stepvideo_vae as sv
    from goal_force_tpu_torch.models import text_encoders as te
    from goal_force_tpu_torch.ops import flash_attention as fa

    cfg, bert_cfg, step1_cfg, vae_cfg = _small_stepvideo_configs()
    gen = torch.Generator("cuda").manual_seed(101)
    rec, launches = {}, {}
    for dtype, rel in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
        tag = str(dtype).split(".")[-1]
        dit = sd.init_stepvideo_dit(cfg, gen, dtype, device="cuda")
        args = (_rand((1, 2, 8, 16, 16), gen, dtype), torch.tensor([0.6], device="cuda"),
                _rand((1, 20, cfg.caption_dim), gen, dtype), _rand((1, 8, cfg.clip_dim), gen, dtype))
        fa.reset_launch_counts()
        with BoundRecorder(values=True) as bounds:
            got = sd.stepvideo_dit_forward(dit, cfg, *args, attn_impl="auto")
            torch.cuda.synchronize()
        launches[tag] = dict(fa.launch_counts)
        ref = sd.stepvideo_dit_forward(dit, cfg, *args, attn_impl="plain")
        scale = float(ref.float().abs().max())
        d = got.float() - ref.float()
        err = float(d.abs().max())
        ok = bool(torch.isfinite(got).all()) and err <= rel * scale
        log("small_stepvideo", case=f"DiT forward {tag} auto vs plain", max_abs_err=err,
            atol=rel * scale, out_max=scale, launches=launches[tag], bounds=bounds.bounds,
            rel_bias=float((d * ref.float().sign()).mean() / ref.float().abs().mean()), ok=ok)
        check(ok, f"small_stepvideo DiT {tag}: auto vs plain differ by {err}")
        check(launches[tag] == only(K1=2) and bounds.calls == 2
              and max(bounds.bounds) < fa.NOMAX_BOUND,
              f"small_stepvideo DiT {tag}: launched {launches[tag]}, bounds {bounds.bounds}")
        rec[f"dit_{tag}"] = err
        del dit, got, ref

    tf32_before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        cpu_gen = torch.Generator().manual_seed(102)
        bert = te.init_bert(bert_cfg, cpu_gen, device="cpu")
        step1 = te.init_step1(step1_cfg, cpu_gen, torch.float32, device="cpu")
        rng = np.random.default_rng(103)
        ids = torch.from_numpy(rng.integers(1, bert_cfg.vocab, size=(2, 77)))
        mask = torch.ones((2, 77), dtype=torch.int32)
        mask[1, 30:] = 0
        sids = torch.from_numpy(rng.integers(0, step1_cfg.vocab, size=(1, 320)))
        towers = {"bert": (bert, lambda m, dev: te.bert_encode(m, bert_cfg, ids.to(dev),
                                                               mask.to(dev))),
                  "step1": (step1, lambda m, dev: te.step1_encode(m, step1_cfg, sids.to(dev)))}
        for name, (model, run) in towers.items():
            want = run(model, "cpu")
            gpu = copy.deepcopy(model).to("cuda")
            got = run(gpu, "cuda")
            scale = float(want.abs().max())
            rec[f"{name}_float32"] = compare(f"small_stepvideo {name} float32 cuda vs cpu",
                                             got.cpu(), want, atol=1e-4 * scale, rtol=0.0,
                                             phase="small_stepvideo")
            low = run(gpu.to(torch.bfloat16), "cuda").float()
            err = float((low - got).abs().max())
            ok = bool(torch.isfinite(low).all()) and err <= 3e-2 * float(got.abs().max())
            log("small_stepvideo", case=f"{name} bf16 vs float32 on the card", max_abs_err=err,
                atol=3e-2 * float(got.abs().max()), ok=ok)
            check(ok, f"small_stepvideo {name} bf16: differs from float32 by {err}")
            rec[f"{name}_bf16"] = err
        vae = sv.init_stepvideo_vae(vae_cfg, cpu_gen, device="cpu", encoder=False)
        z = torch.randn((1, 6, 2, 3, vae_cfg.z_dim), generator=cpu_gen)
        want = sv.stepvideo_vae_decode(vae, z, vae_cfg)
        got = sv.stepvideo_vae_decode(copy.deepcopy(vae).to("cuda"), z.cuda(), vae_cfg)
        scale = float(want.abs().max())
        rec["vae_decode"] = compare("small_stepvideo VAE chunked decode cuda vs cpu", got.cpu(),
                                    want, atol=1e-4 * scale, rtol=0.0, phase="small_stepvideo")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32_before
    log("small_stepvideo", tokens=256, text_keys=28, launches=launches, **rec)
    torch.cuda.empty_cache()
    return {k: launches["float32"][k] + launches["bfloat16"][k] for k in launches["float32"]}


# StepVideo-T2V at its released widths, cut in depth: the DiT at 4 of 48 blocks (48x128
# heads, dim 6144), Step-1 at 2 of 48 layers; BERT and the VAE decoder whole. One request
# at JAX's 544x992 and 34 of its 204 frames (2 chunks: 6 latent frames of 34x62 = 12,648
# tokens), 2 of 30 steps, CFG 9.0 as two forwards a step: 2 x 2 x 4 x 2 = 32 K1.
SV_BLOCKS, SV_STEP1_LAYERS = 4, 2
SV_HEIGHT, SV_WIDTH, SV_FRAMES, SV_STEPS = 544, 992, 34, 2
SV_TOKENS = (SV_FRAMES // 17 * 3) * (SV_HEIGHT // 16) * (SV_WIDTH // 16)
SV_K1_PER_STEP = 2 * SV_BLOCKS * 2
SV_TEXT_KEYS = 77 + 320
# the full path's attention: 204 frames -> 36 latent frames of 34x62 = 75,888 tokens
SV_SELF = (1, 36 * 34 * 62, 48, 128)
SV_CROSS_KV = (1, SV_TEXT_KEYS, 48, 128)
SV_PLAIN_HEADS = 4       # the plain version at full length on 4 of the 48 heads
SV_PROMPT = "a red ball rolls across a wooden table, hits a blue cup and the cup tips over"
SV_NEGATIVE = "blurry, low quality, static"


def _stepvideo_k1(kv_shape, gen):
    """K1 without its clamp (what "auto" picks below the bound) at StepVideo's full-path
    query shape against `kv_shape` keys, random bf16: "auto" must pick K1; the kernel on
    the first SV_PLAIN_HEADS heads against its plain version there (timed on that run);
    the kernel, the runtime bound's reductions and host sync, and SDPA on the same bf16
    tensors (a yardstick) timed with CUDA events, 1 warm-up and 3 launches."""
    from goal_force_tpu_torch.ops import flash_attention as fa

    scale = 128 ** -0.5
    b, s, n, h = SV_SELF
    skv = kv_shape[1]
    q = _rand(SV_SELF, gen, torch.bfloat16)
    k, v = (_rand(kv_shape, gen, torch.bfloat16) for _ in range(2))
    got, launched = picked(lambda: fa.flash_attention(q, k, v, scale, dispatch="auto"))
    check(launched == only(K1=1), f"K1 stepvideo {kv_shape}: auto launched {launched}")
    hs = slice(0, SV_PLAIN_HEADS)
    sub = lambda t: t[:, :, hs].contiguous()
    ref, plain_ms = timed_call(lambda: fa.flash_attention_nomax_plain(
        sub(q), sub(k), sub(v), scale, clamp=None))
    name = f"K1 stepvideo {SV_SELF}x{tuple(kv_shape)} heads 0-{SV_PLAIN_HEADS - 1} bf16"
    err = compare(name, got[:, :, hs], ref, atol=bf16_limit(ref), rtol=0.0, phase="stepvideo")
    del got, ref
    torch.cuda.empty_cache()
    bound, by = kernel_bound_ms(4 * b * n * s * skv * h, 2 * (2 * b * s * n * h + 2 * b * skv * n * h))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    rec = dict(shape=f"{SV_SELF}x{tuple(kv_shape)}", max_abs_err=err,
               plain_heads=SV_PLAIN_HEADS, plain_ms=plain_ms,
               ms=event_ms(lambda: fa.flash_attention_nomax(q, k, v, scale, clamp=None)),
               bound_ms=bound, bound_by=by,
               bound_sync_ms=event_ms(lambda: float(fa.logit_bound(q, k, v, scale))),
               library_ms=event_ms(lambda: sdpa(qt, kt, vt)))
    log("stepvideo", case=f"{name} timing", **rec)
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return rec


def phase_stepvideo():
    """StepVideo-T2V at its released widths, random weights from a seed: the DiT (dim
    6144, 48x128 heads, in 64, caption 6144, clip 1024) at 4 of 48 blocks, Step-1 (6144
    wide, 48 heads in 8 groups, ffn 16384, vocab 65,536) at 2 of 48 layers on hash ids at
    320 tokens, BERT whole (24 layers, 1024, vocab 47,020) on the vendored WordPiece ids at
    77, all bf16, and the VAE decoder whole (dec_ch 128, mult (1, 2, 4, 4), z 64) in
    float32 as JAX decodes. One request at 544x992 and 34 frames (2 chunks: 12,648 tokens;
    the decode's seam mix runs), 2 steps, CFG 9.0 as two forwards a step, untiled decode:
    32 K1, 0 K2 and 32 runtime-bound syncs; finite (34, 544, 992, 3) frames; logs the BERT
    and Step-1 seconds, each step's, the decode's and the peak. Then the bound's cost: one
    CFG branch's forward with the bound and with a host constant in its place, in turns
    (8 K1 each). Then one forward with both
    attentions' q-norm weights x8 (the bound passes 100: 8 K2, 0 K1) against the plain
    path on the card (within 5e-2 of the output's scale: four full-width bf16 blocks). Last,
    K1 at the full path's shape: (1, 75,888, 48, 128) self and against 397 text keys
    (_stepvideo_k1)."""
    from goal_force_tpu_torch.models import stepvideo_dit as sd
    from goal_force_tpu_torch.models import stepvideo_vae as sv
    from goal_force_tpu_torch.models import text_encoders as te
    from goal_force_tpu_torch.ops import flash_attention as fa
    from goal_force_tpu_torch.pipelines import step_video as sp
    from goal_force_tpu_torch.prompters import hunyuan_dit_tokenizers

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator("cuda").manual_seed(111)
    cfg = dataclasses.replace(sd.StepVideoConfig(), num_layers=SV_BLOCKS)
    step1_cfg = dataclasses.replace(te.Step1Config(), num_layers=SV_STEP1_LAYERS)
    bert_cfg, vae_cfg = te.BertConfig(), sv.StepVideoVAEConfig()
    (dit, step1, bert, vae), init_s = sync_time(lambda: (
        sd.init_stepvideo_dit(cfg, gen, torch.bfloat16, device="cuda"),
        te.init_step1(step1_cfg, gen, torch.bfloat16, device="cuda"),
        te.init_bert(bert_cfg, gen, torch.bfloat16, device="cuda"),
        sv.init_stepvideo_vae(vae_cfg, gen, torch.float32, device="cuda", encoder=False)))
    count = lambda m: sum(p.numel() for p in m.parameters())
    log("stepvideo", stage="init", seconds=init_s, dit_params=count(dit),
        step1_params=count(step1), bert_params=count(bert), vae_decoder_params=count(vae),
        gib=torch.cuda.memory_allocated() / 2**30)
    stages = {"step_s": [], "bert_s": [], "step1_s": []}

    def timed(fn, key):
        def run(*a, **kw):
            out, secs = sync_time(lambda: fn(*a, **kw))
            stages[key].append(secs)
            return out
        return run

    real = te.bert_encode, te.step1_encode
    te.bert_encode, te.step1_encode = timed(real[0], "bert_s"), timed(real[1], "step1_s")
    try:
        encode = sp.make_stepvideo_prompt_encoder(bert, bert_cfg, step1, step1_cfg,
                                                  tokenize_bert=hunyuan_dit_tokenizers()[0])
    finally:
        te.bert_encode, te.step1_encode = real
    pipe = sp.StepVideoPipeline(dit=dit, vae=vae, dit_cfg=cfg, vae_cfg=vae_cfg,
                                encode_prompt=encode, dtype=torch.bfloat16)
    pipe._velocity = timed(pipe._velocity, "step_s")
    decode = pipe._decode

    def timed_decode(*a):
        out, stages["decode_s"] = sync_time(lambda: decode(*a))
        return out

    pipe._decode = timed_decode
    fa.reset_launch_counts()
    with BoundRecorder() as bounds:
        frames, secs = sync_time(lambda: pipe(SV_PROMPT, SV_NEGATIVE, cfg_scale=9.0,
                                              height=SV_HEIGHT, width=SV_WIDTH,
                                              num_frames=SV_FRAMES,
                                              num_inference_steps=SV_STEPS, seed=13))
    launches = dict(fa.launch_counts)
    shape = (SV_FRAMES, SV_HEIGHT, SV_WIDTH, 3)
    finite = bool(np.isfinite(frames).all())
    log("stepvideo", stage="request", seconds=secs, **stages, launches=launches,
        bound_syncs=bounds.calls, k1_per_step=SV_K1_PER_STEP, steps=SV_STEPS,
        tokens=SV_TOKENS, text_keys=SV_TEXT_KEYS, frames_shape=list(frames.shape),
        finite=finite, frames_mean=float(frames.mean()), frames_std=float(frames.std()),
        peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    check(launches == only(K1=SV_K1_PER_STEP * SV_STEPS) and bounds.calls == SV_K1_PER_STEP
          * SV_STEPS, f"stepvideo request launched {launches}, {bounds.calls} bound syncs")
    check(tuple(frames.shape) == shape and finite,
          f"stepvideo frames {frames.shape}, finite {finite}")
    del pipe, frames
    gc.collect()
    torch.cuda.empty_cache()

    # the runtime bound's cost at the request's shapes: one CFG branch's forward with the
    # bound, and with it replaced by a host constant (the same kernels, no reductions and
    # no host sync), in turns
    lat = _rand((1, SV_TOKENS // (34 * 62), 34, 62, cfg.in_channels), gen, torch.bfloat16)
    t = torch.tensor([0.5], dtype=torch.bfloat16, device="cuda")
    llm, clip = encode(SV_PROMPT)[::-1]
    bound_sync_cost("stepvideo", "forward",
                    lambda: sd.stepvideo_dit_forward(dit, cfg, lat, t, llm, clip),
                    only(K1=2 * SV_BLOCKS))

    # one forward past the bound: both attentions' q-norm weights x8
    norms = [a.q_norm.weight for blk in dit.transformer_blocks for a in (blk.attn1, blk.attn2)]
    for w in norms:
        w.mul_(8)
    try:
        fa.reset_launch_counts()
        with BoundRecorder(values=True) as bounds:
            got, secs = sync_time(lambda: sd.stepvideo_dit_forward(dit, cfg, lat, t, llm, clip))
        unb = dict(fa.launch_counts)
        ref, plain_s = sync_time(lambda: sd.stepvideo_dit_forward(dit, cfg, lat, t, llm, clip,
                                                                  attn_impl="plain"))
    finally:
        for w in norms:
            w.div_(8)
    scale = float(ref.float().abs().max())
    d = got.float() - ref.float()
    err = float(d.abs().max())
    ok = bool(torch.isfinite(got).all()) and err <= 5e-2 * scale
    log("stepvideo", stage="unbounded_forward", seconds=secs, plain_seconds=plain_s,
        launches=unb, bounds=bounds.bounds, max_abs_err=err, atol=5e-2 * scale, out_max=scale,
        mean_abs_err=float(d.abs().mean()),
        rel_bias=float((d * ref.float().sign()).mean() / ref.float().abs().mean()), ok=ok)
    check(unb == only(K2=2 * SV_BLOCKS) and min(bounds.bounds) >= fa.NOMAX_BOUND,
          f"stepvideo unbounded forward launched {unb}, bounds {bounds.bounds}")
    check(ok, f"stepvideo unbounded forward: kernels vs plain differ by {err}")
    del dit, step1, bert, vae, encode, got, ref, lat, llm, clip, d
    gc.collect()
    torch.cuda.empty_cache()

    gen = torch.Generator("cuda").manual_seed(112)
    path = {"self": _stepvideo_k1(SV_SELF, gen), "cross": _stepvideo_k1(SV_CROSS_KV, gen)}
    return launches, unb, path


def _small_flux_configs():
    from goal_force_tpu_torch.configs import FluxDiTConfig
    from goal_force_tpu_torch.models import flux_controlnet as fcn

    dit = FluxDiTConfig(dim=256, num_heads=2, num_joint_blocks=1, num_single_blocks=1,
                        text_dim=64, pooled_dim=32, freq_dim=64)
    return dit, fcn.FluxControlNetConfig(dit, 1, 1, num_mode=3)


def _auto_vs_plain(phase, name, fn, rel, want_launches):
    """fn(attn_impl) with "auto" (the kernels behind the runtime bound, the bounds read)
    against "plain" on the same inputs: finite and within rel of the output's scale; the
    launches must be want_launches with one bound sync each, every bound under K1's."""
    from goal_force_tpu_torch.ops import flash_attention as fa

    fa.reset_launch_counts()
    with BoundRecorder(values=True) as bounds:
        got = fn("auto")
        torch.cuda.synchronize()
    launches = dict(fa.launch_counts)
    ref = fn("plain")
    got, ref = (torch.cat([t.float().flatten() for t in x]) if isinstance(x, tuple)
                else x.float() for x in (got, ref))
    scale = float(ref.abs().max())
    d = got - ref
    err = float(d.abs().max())
    ok = bool(torch.isfinite(got).all()) and err <= rel * scale
    log(phase, case=f"{name} auto vs plain", max_abs_err=err, atol=rel * scale, out_max=scale,
        launches=launches, bounds=bounds.bounds,
        rel_bias=float((d * ref.sign()).mean() / ref.abs().mean()), ok=ok)
    check(ok, f"{phase} {name}: auto vs plain differ by {err}")
    check(launches == want_launches and bounds.calls == sum(want_launches.values())
          and max(bounds.bounds) < fa.NOMAX_BOUND,
          f"{phase} {name}: launched {launches}, bounds {bounds.bounds}")
    return err, launches


def phase_small_flux():
    """Flux's modules at small sizes on the card: the DiT forward at head_dim 128 (2
    heads, 1 joint + 1 single block, a 32x32 latent: 256 image tokens behind 20 text
    tokens) and a Union ControlNet at that width (1 + 1 blocks, mode 2: 277 joint tokens),
    each "auto" (K1 through the runtime bound, 2 launches) against "plain" on the same
    inputs, float32 (within 1e-4 of the output's scale) and bf16 (within 3e-2 of it, as
    small_stepvideo); the tiny 16-channel VAE's decode (tiny plans, 32x32 out) on the card
    against the CPU, float32 with TF32 off (1e-4 of the scale), and over bf16 weights
    against float32 ones on the card (3e-2). Logs the K1 launches and the bounds read."""
    import copy

    from goal_force_tpu_torch.models import flux_controlnet as fcn
    from goal_force_tpu_torch.models import flux_dit as fd
    from goal_force_tpu_torch.models import sd_vae as sv
    from goal_force_tpu_torch.pipelines import flux as fp

    cfg, cn_cfg = _small_flux_configs()
    gen = torch.Generator("cuda").manual_seed(121)
    rec, launches = {}, {}
    for dtype, rel in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
        tag = str(dtype).split(".")[-1]
        dit = fd.init_flux_dit(cfg, gen, dtype, device="cuda")
        cn = fcn.init_flux_controlnet(cn_cfg, gen, dtype, device="cuda")
        for zl in (*cn.controlnet_blocks, *cn.controlnet_single_blocks):
            zl.weight.normal_(generator=gen).mul_(0.02)     # residuals that are not zero
        lat = _rand((1, 32, 32, 16), gen, dtype)
        txt, pooled = _rand((1, 20, cfg.text_dim), gen, dtype), _rand((1, 32), gen, dtype)
        t = torch.tensor([700.0], device="cuda")
        g = torch.tensor([3.5], device="cuda")
        rec[f"dit_{tag}"], launches[f"dit_{tag}"] = _auto_vs_plain(
            "small_flux", f"DiT forward {tag}",
            lambda impl: fd.flux_dit_forward(dit, cfg, lat, t, txt, pooled, g, attn_impl=impl),
            rel, only(K1=2))
        cond = _rand((1, 32, 32, 16), gen, dtype)
        rec[f"controlnet_{tag}"], launches[f"controlnet_{tag}"] = _auto_vs_plain(
            "small_flux", f"ControlNet forward {tag}",
            lambda impl: fcn.flux_controlnet_forward(cn, cn_cfg, lat, cond, t, txt, pooled, g,
                                                     mode_id=2, attn_impl=impl),
            rel, only(K1=2))
        del dit, cn

    enc_plan, dec_plan, groups = fp.tiny_sd3_vae_plans()
    cpu_gen = torch.Generator().manual_seed(122)
    dec = sv.init_sd_vae(sv.SDVAEDecoder, dec_plan, cpu_gen, device="cpu")
    z = torch.randn((1, 16, 16, 16), generator=cpu_gen)
    tf32_before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        want = sv.sd3_vae_decode(dec, z, sv.FLUX_SCALING, groups)
        gpu = copy.deepcopy(dec).to("cuda")
        got = sv.sd3_vae_decode(gpu, z.cuda(), sv.FLUX_SCALING, groups)
        scale = float(want.abs().max())
        rec["vae_decode_float32"] = compare("small_flux VAE decode float32 cuda vs cpu",
                                            got.cpu(), want, atol=1e-4 * scale, rtol=0.0,
                                            phase="small_flux")
        low = sv.sd3_vae_decode(gpu.to(torch.bfloat16), z.cuda(), sv.FLUX_SCALING, groups)
        err = float((low - got).abs().max())
        ok = low.dtype == torch.float32 and bool(torch.isfinite(low).all()) \
            and err <= 3e-2 * float(got.abs().max())
        log("small_flux", case="VAE decode over bf16 weights vs float32 on the card",
            max_abs_err=err, atol=3e-2 * float(got.abs().max()), dtype=str(low.dtype), ok=ok)
        check(ok, f"small_flux VAE decode over bf16 weights: differs by {err}")
        rec["vae_decode_bf16_weights"] = err
    finally:
        torch.backends.cudnn.allow_tf32 = tf32_before
    log("small_flux", image_tokens=256, text_tokens=20, launches=launches, **rec)
    torch.cuda.empty_cache()
    return {k: sum(v[k] for v in launches.values()) for k in launches["dit_float32"]}


# FLUX.1-dev at its released configuration and full depth: 19 joint + 38 single blocks,
# so 57 K1 per DiT forward at 1024x1024 (512 text + 4,096 image tokens), 15 per forward of
# the Union ControlNet (5 + 10 blocks, a mode token: 4,609 tokens).
FLUX_HW = 1024
FLUX_K1 = 19 + 38
FLUX_CN_K1 = 5 + 10
FLUX_CN_MODES = 10
FLUX_T5_LAYERS = 2
FLUX_TOKENS = 512 + (FLUX_HW // 16) ** 2
FLUX_PATH = {"b1": (1, FLUX_TOKENS, 24, 128), "b2": (2, FLUX_TOKENS, 24, 128),
             "kontext": (1, FLUX_TOKENS + (FLUX_HW // 16) ** 2, 24, 128)}
FLUX_PROMPT = "a red ball rolls across a wooden table and hits a blue cup, studio light"
FLUX_NEGATIVE = "blurry, low quality"


def _flux_k1(name, shape, gen, phase="flux"):
    """K1 without its clamp (what "auto" picks below the bound) at one of the path shapes
    of `phase` (Flux's or Qwen-Image's; q = k = v), random bf16 at the qk-normed scale:
    "auto" must pick K1; the kernel against its plain version on every head (timed on
    that run); the kernel, the runtime bound's reductions and host sync, and SDPA on the
    same bf16 tensors (a yardstick) timed with CUDA events, 1 warm-up and 3 launches."""
    from goal_force_tpu_torch.ops import flash_attention as fa

    scale = 128 ** -0.5
    b, s, n, h = shape
    q, k, v = (_rand(shape, gen, torch.bfloat16) for _ in range(3))
    got, launched = picked(lambda: fa.flash_attention(q, k, v, scale, dispatch="auto"))
    check(launched == only(K1=1), f"K1 {phase} {name}: auto launched {launched}")
    ref, plain_ms = timed_call(lambda: fa.flash_attention_nomax_plain(q, k, v, scale,
                                                                      clamp=None))
    err = compare(f"K1 {phase} {name} {shape}^2 bf16", got, ref, atol=bf16_limit(ref),
                  rtol=0.0, phase=phase)
    del got, ref
    bound, by = kernel_bound_ms(4 * b * n * s * s * h, 2 * 4 * b * s * n * h)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    rec = dict(shape=f"{shape}^2", max_abs_err=err, plain_ms=plain_ms,
               ms=event_ms(lambda: fa.flash_attention_nomax(q, k, v, scale, clamp=None)),
               bound_ms=bound, bound_by=by,
               bound_sync_ms=event_ms(lambda: float(fa.logit_bound(q, k, v, scale))),
               library_ms=event_ms(lambda: sdpa(qt, kt, vt)))
    rec["fraction_of_bound"] = rec["bound_ms"] / rec["ms"]
    log(phase, case=f"K1 {phase} {name} timing", **rec)
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return rec


def phase_flux():
    """FLUX.1-dev at its released configuration and full depth, random weights from a
    seed (see the module docstring, 15h): five 1024x1024 requests through FluxPipeline,
    each with its launches (57 K1 per DiT forward, 15 per ControlNet forward, 0 K2) and
    bound syncs (one per launch) counted, finite (1024, 1024, 3) images, and the text,
    step, ControlNet, encode and decode seconds and the peak logged; one forward with
    every q-norm weight x8 (the bound passes 100: 57 K2, 0 K1) against the plain path on
    the card (within 5e-2 of the output's scale: 57 full-width bf16 blocks); the bound's
    cost per forward (bound_sync_cost); K1 at the path's three shapes (_flux_k1)."""
    from goal_force_tpu_torch.configs import FLUX_DEV, T5_V1_1_XXL
    from goal_force_tpu_torch.models import clip as clipm
    from goal_force_tpu_torch.models import flux_controlnet as fcn
    from goal_force_tpu_torch.models import flux_dit as fd
    from goal_force_tpu_torch.models import sd_vae as sv
    from goal_force_tpu_torch.models import t5 as t5m
    from goal_force_tpu_torch.models.sd_text_encoder import SD_TEXT_CONFIG
    from goal_force_tpu_torch.ops import flash_attention as fa
    from goal_force_tpu_torch.pipelines import flux as fp
    from goal_force_tpu_torch.prompters import flux_tokenizers

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator("cuda").manual_seed(131)
    t5_cfg = dataclasses.replace(T5_V1_1_XXL, num_layers=FLUX_T5_LAYERS, text_len=512)
    cn_cfg = fcn.FluxControlNetConfig(FLUX_DEV, 5, 10, num_mode=FLUX_CN_MODES)
    bf16 = torch.bfloat16

    def build():
        cn = fcn.init_flux_controlnet(cn_cfg, gen, bf16, device="cuda")
        for zl in (*cn.controlnet_blocks, *cn.controlnet_single_blocks):
            zl.weight.normal_(generator=gen).mul_(1e-3)    # residuals that are not zero
        return (fd.init_flux_dit(FLUX_DEV, gen, bf16, device="cuda"),
                clipm.init_clip_text(SD_TEXT_CONFIG, gen, bf16, device="cuda"),
                t5m.init_t5(t5_cfg, gen, bf16, device="cuda"),
                sv.init_sd_vae(sv.SDVAEEncoder, sv.SD_VAE_ENCODER_PLAN, gen, bf16, device="cuda"),
                sv.init_sd_vae(sv.SDVAEDecoder, sv.SD_VAE_DECODER_PLAN, gen, bf16, device="cuda"),
                cn)

    (dit, clip, t5, enc, dec, cn), init_s = sync_time(build)
    count = lambda m: sum(p.numel() for p in m.parameters())
    log("flux", stage="init", seconds=init_s, dit_params=count(dit), clip_params=count(clip),
        t5_params=count(t5), vae_params=count(enc) + count(dec), controlnet_params=count(cn),
        gib=torch.cuda.memory_allocated() / 2**30)
    tok_clip, tok_t5 = flux_tokenizers(t5_length=512)
    pipe = fp.FluxPipeline(dit=dit, clip=clip, t5=t5, vae_encoder=enc, vae_decoder=dec,
                           dit_cfg=FLUX_DEV, t5_cfg=t5_cfg, tokenize_clip=tok_clip,
                           tokenize_t5=tok_t5, dtype=bf16)
    stages = {}
    _time_stages(pipe, stages, _encode_text="text_s", _velocity="step_s", _encode="encode_s",
                 _decode="decode_s")
    real_cn = _time_stages(fcn, stages, flux_controlnet_forward="controlnet_s")[
        "flux_controlnet_forward"]
    common = dict(height=FLUX_HW, width=FLUX_HW, seed=17)
    requests = (
        ("a_t2i", dict(num_inference_steps=2, embedded_guidance=3.5), 2 * FLUX_K1),
        ("b_cfg", dict(negative_prompt=FLUX_NEGATIVE, cfg_scale=2.0, num_inference_steps=1),
         FLUX_K1),
        ("c_i2i", dict(num_inference_steps=2, denoising_strength=0.5), 2 * FLUX_K1),
        ("d_controlnet", dict(num_inference_steps=1, controlnet={"model": cn, "cfg": cn_cfg},
                              controlnet_mode=3), FLUX_K1 + FLUX_CN_K1),
        ("e_kontext", dict(num_inference_steps=1), FLUX_K1))
    launches, image = {}, None
    try:
        for name, kw, k1 in requests:
            stages.clear()
            if name == "c_i2i":
                kw["input_image"] = image
            elif name == "d_controlnet":
                kw["controlnet_image"] = image
            elif name == "e_kontext":
                kw["kontext_image"] = image
            fa.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            with BoundRecorder() as bounds:
                out, secs = sync_time(lambda: pipe(FLUX_PROMPT, **kw, **common))
            launched = dict(fa.launch_counts)
            finite = bool(np.isfinite(out).all())
            log("flux", stage="request", request=name, seconds=secs, **stages,
                launches=launched, bound_syncs=bounds.calls, want_k1=k1,
                image_shape=list(out.shape), finite=finite, image_mean=float(out.mean()),
                image_std=float(out.std()), peak_gib=torch.cuda.max_memory_allocated() / 2**30)
            check(launched == only(K1=k1) and bounds.calls == k1,
                  f"flux {name} launched {launched}, {bounds.calls} bound syncs")
            check(out.shape == (FLUX_HW, FLUX_HW, 3) and finite,
                  f"flux {name} image {out.shape}, finite {finite}")
            for key, n in launched.items():
                launches[key] = launches.get(key, 0) + n
            if image is None:
                image = out
    finally:
        fcn.flux_controlnet_forward = real_cn
    emb, pooled = pipe._encode_text([FLUX_PROMPT])
    del pipe, cn, image
    gc.collect()
    torch.cuda.empty_cache()

    # the runtime bound's cost at (a)'s shapes: one forward with the bound and with it
    # replaced by a host constant (the same kernels, no reductions and no host sync)
    lat = _rand((1, FLUX_HW // 8, FLUX_HW // 8, 16), gen, bf16)
    t = torch.tensor([500.0], dtype=bf16, device="cuda")
    g = torch.tensor([3.5], dtype=bf16, device="cuda")
    forward = lambda impl="auto": fd.flux_dit_forward(dit, FLUX_DEV, lat, t, emb, pooled, g,
                                                      attn_impl=impl)
    bound_sync_cost("flux", "forward", forward, only(K1=FLUX_K1))

    # one forward past the bound: every q-norm weight x8
    norms = [n.weight for blk in dit.blocks for n in (blk.attn.norm_q_a, blk.attn.norm_q_b)]
    norms += [blk.norm_q_a.weight for blk in dit.single_blocks]
    for w in norms:
        w.mul_(8)
    try:
        fa.reset_launch_counts()
        with BoundRecorder(values=True) as bounds:
            got, secs = sync_time(forward)
        unb = dict(fa.launch_counts)
        ref, plain_s = sync_time(lambda: forward("plain"))
    finally:
        for w in norms:
            w.div_(8)
    scale = float(ref.float().abs().max())
    d = got.float() - ref.float()
    err = float(d.abs().max())
    ok = bool(torch.isfinite(got).all()) and err <= 5e-2 * scale
    log("flux", stage="unbounded_forward", seconds=secs, plain_seconds=plain_s,
        launches=unb, bounds_min=min(bounds.bounds), bounds_max=max(bounds.bounds),
        max_abs_err=err, atol=5e-2 * scale, out_max=scale, mean_abs_err=float(d.abs().mean()),
        rel_bias=float((d * ref.float().sign()).mean() / ref.float().abs().mean()), ok=ok)
    check(unb == only(K2=FLUX_K1) and min(bounds.bounds) >= fa.NOMAX_BOUND,
          f"flux unbounded forward launched {unb}, bounds {bounds.bounds}")
    check(ok, f"flux unbounded forward: kernels vs plain differ by {err}")
    del dit, clip, t5, enc, dec, got, ref, lat, emb, pooled, d
    gc.collect()
    torch.cuda.empty_cache()

    gen = torch.Generator("cuda").manual_seed(132)
    path = {name: _flux_k1(name, shape, gen) for name, shape in FLUX_PATH.items()}
    return launches, unb, path


def phase_small_sd3():
    """SD3's tiny pipeline (an SD3.5-shaped DiT with a dual block and RMS q/k norms, the
    tiny CLIP-L, bigG, T5 and 16-channel VAE) answers one 32x32 request (2 steps, merged
    CFG 2.0) on the card and on the CPU over the same float32 weights and noise, TF32 off:
    the images within 1e-4. Every attention is 64 wide, so the plain path runs: no
    kernel launches."""
    import copy

    from goal_force_tpu_torch.ops import flash_attention as fa
    from goal_force_tpu_torch.pipelines import sd3 as sp

    cpu = sp.SD3Pipeline.init_random(seed=141, device="cpu")
    gpu = dataclasses.replace(cpu, **{n: copy.deepcopy(getattr(cpu, n)).to("cuda") for n in (
        "dit", "clip1", "clip2", "t5", "vae_encoder", "vae_decoder")})
    noise = np.random.default_rng(142).standard_normal((1, 16, 16, 16)).astype(np.float32)
    req = dict(prompt="a red ball", negative_prompt="blurry", cfg_scale=2.0, height=32,
               width=32, num_inference_steps=2, noise=noise)
    tf32_before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        want = cpu(**req)
        fa.reset_launch_counts()
        got, secs = sync_time(lambda: gpu(**req))
        launches = dict(fa.launch_counts)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32_before
    err = float(np.abs(got - want).max())
    ok = got.shape == (32, 32, 3) and bool(np.isfinite(got).all()) and err <= 1e-4
    log("small_sd3", case="request cuda vs cpu", seconds=secs, max_abs_err=err, atol=1e-4,
        launches=launches, ok=ok)
    check(ok, f"small_sd3: the card's image differs from the CPU's by {err}")
    check(launches == only(), f"small_sd3 launched {launches} (head_dim 64: plain)")
    del cpu, gpu
    torch.cuda.empty_cache()
    return launches


# SD3.5-Large at its released widths and full depth (38 blocks of 2432 = 38 x 64, RMS
# q/k norms, pos-embed 192), CLIP-L and bigG whole, T5 v1.1 XXL at 2 of 24 layers (the
# vendored tokenizers, 128 T5 ids: 205 text tokens), the 16-channel VAE; SD3.5-Medium (24
# blocks of 1536, 13 dual, pos-embed 384) for one step. 1024x1024: 4,096 image tokens.
SD3_HW = 1024
SD3_T5_LAYERS = 2
SD3_TOKENS = (SD3_HW // 16) ** 2 + 77 + 128
SD3_PATH = {"large": (2, SD3_TOKENS, 38, 64), "medium": (2, SD3_TOKENS, 24, 64)}


def _sd3_plain(name, shape, gen, phase="sd3"):
    """The plain attention (float32 logits in row blocks of <= 2 GiB) at one of the path
    shapes of `phase` (SD3's, HunyuanDiT's or OmniGen's), bf16 q = k = v at the qk-normed
    scale, timed with CUDA events (1 warm-up, 3 calls) beside SDPA on the same tensors (a
    yardstick) and the call's bound."""
    from goal_force_tpu_torch.ops.attention import plain_attention

    b, s, n, h = shape
    q, k, v = (_rand(shape, gen, torch.bfloat16) for _ in range(3))
    scale = h ** -0.5
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    out = plain_attention(q, k, v, scale)
    ref = sdpa(qt, kt, vt).transpose(1, 2)
    err = float((out.float() - ref.float()).abs().max())
    bound, by = kernel_bound_ms(4 * b * n * s * s * h, 2 * 4 * b * s * n * h)
    rec = dict(shape=f"{shape}^2", plain_ms=event_ms(lambda: plain_attention(q, k, v, scale)),
               library_ms=event_ms(lambda: sdpa(qt, kt, vt)), bound_ms=bound, bound_by=by,
               max_abs_err_vs_sdpa=err)
    rec["fraction_of_bound"] = rec["bound_ms"] / rec["plain_ms"]
    log(phase, case=f"plain attention {name} timing", **rec)
    check(err <= 4 * bf16_limit(ref), f"{phase} plain attention {name}: {err} from SDPA")
    del q, k, v, qt, kt, vt, out, ref
    torch.cuda.empty_cache()
    return rec


def phase_sd3():
    """SD3.5-Large at its released widths and full depth, random bf16 weights from a seed:
    at 1024x1024 (a) text-to-image, 2 of 28 steps, CFG 7.0 as one merged batch of 2; (b)
    image-to-image from (a)'s image at strength 0.5, 1 step; (c) one step of SD3.5-Medium
    at its released widths and depth over the same towers and VAE. Each finite (1024,
    1024, 3) with no kernel launch (head_dim 64: every attention is the plain one); the
    text, step, encode and decode seconds and the peaks. Then the plain attention at both
    DiTs' path shapes, timed beside SDPA and its bound."""
    from goal_force_tpu_torch.configs import T5_V1_1_XXL
    from goal_force_tpu_torch.models import clip as clipm
    from goal_force_tpu_torch.models import sd3_dit as sd3
    from goal_force_tpu_torch.models import sd_vae as sv
    from goal_force_tpu_torch.models import t5 as t5m
    from goal_force_tpu_torch.models.sd_text_encoder import SD_TEXT_CONFIG, SDXL_TEXT2_CONFIG
    from goal_force_tpu_torch.ops import flash_attention as fa
    from goal_force_tpu_torch.pipelines import sd3 as sp
    from goal_force_tpu_torch.prompters import sd3_tokenizers

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator("cuda").manual_seed(151)
    bf16 = torch.bfloat16
    t5_cfg = dataclasses.replace(T5_V1_1_XXL, num_layers=SD3_T5_LAYERS, text_len=128)

    def build():
        dits = [sd3.init_sd3_dit(cfg, gen, bf16, device="cuda")
                for cfg in (sd3.SD35_LARGE, sd3.SD35_MEDIUM)]
        for dit in dits:        # a position table that is not zero, so the crop shows
            dit.pos_embedder.pos_embed.normal_(generator=gen).mul_(0.02)
        return (dits[0],
                clipm.init_clip_text(SD_TEXT_CONFIG, gen, bf16, device="cuda"),
                sp.init_bigg(SDXL_TEXT2_CONFIG, gen, bf16, device="cuda"),
                t5m.init_t5(t5_cfg, gen, bf16, device="cuda"),
                sv.init_sd_vae(sv.SDVAEEncoder, sv.SD_VAE_ENCODER_PLAN, gen, bf16, device="cuda"),
                sv.init_sd_vae(sv.SDVAEDecoder, sv.SD_VAE_DECODER_PLAN, gen, bf16, device="cuda"),
                dits[1])

    (dit, clip1, clip2, t5, enc, dec, medium), init_s = sync_time(build)
    count = lambda m: sum(p.numel() for p in m.parameters())
    log("sd3", stage="init", seconds=init_s, large_params=count(dit), medium_params=count(medium),
        clip_params=count(clip1) + count(clip2), t5_params=count(t5),
        vae_params=count(enc) + count(dec), gib=torch.cuda.memory_allocated() / 2**30)
    tok1, tok2, tok3 = sd3_tokenizers(t5_length=128)
    pipe = sp.SD3Pipeline(dit=dit, clip1=clip1, clip2=clip2, t5=t5, vae_encoder=enc,
                          vae_decoder=dec, dit_cfg=sd3.SD35_LARGE, t5_cfg=t5_cfg,
                          clip1_cfg=SD_TEXT_CONFIG, clip2_cfg=SDXL_TEXT2_CONFIG,
                          tokenize_clip=tok1, tokenize_clip2=tok2, tokenize_t5=tok3,
                          dtype=bf16)
    stages = {}
    _time_stages(pipe, stages, _encode_text="text_s", _velocity="step_s", _encode="encode_s",
                 _decode="decode_s")
    common = dict(negative_prompt=FLUX_NEGATIVE, cfg_scale=7.0, height=SD3_HW, width=SD3_HW,
                  seed=19)
    launches, image = {}, None
    for name, model, cfg, kw in (
            ("a_t2i", None, None, dict(num_inference_steps=2)),
            ("b_i2i", None, None, dict(num_inference_steps=1, denoising_strength=0.5)),
            ("c_medium", medium, sd3.SD35_MEDIUM, dict(num_inference_steps=1))):
        stages.clear()
        if name == "b_i2i":
            kw["input_image"] = image
        if model is not None:
            pipe.dit, pipe.dit_cfg = model, cfg
        fa.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        out, secs = sync_time(lambda: pipe(FLUX_PROMPT, **kw, **common))
        launched = dict(fa.launch_counts)
        finite = bool(np.isfinite(out).all())
        log("sd3", stage="request", request=name, seconds=secs, **stages, launches=launched,
            image_shape=list(out.shape), finite=finite, image_mean=float(out.mean()),
            image_std=float(out.std()), peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        check(launched == only(), f"sd3 {name} launched {launched} (head_dim 64: plain)")
        check(out.shape == (SD3_HW, SD3_HW, 3) and finite,
              f"sd3 {name} image {out.shape}, finite {finite}")
        for key, n in launched.items():
            launches[key] = launches.get(key, 0) + n
        if image is None:
            image = out
    del pipe, dit, clip1, clip2, t5, enc, dec, medium, image
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator("cuda").manual_seed(152)
    path = {name: _sd3_plain(name, shape, gen) for name, shape in SD3_PATH.items()}
    return launches, path


def _small_qwen_configs():
    from goal_force_tpu_torch.models import qwen_image_controlnet as qcn
    from goal_force_tpu_torch.models import qwen_image_dit as qd
    from goal_force_tpu_torch.models import qwen_vl as qv

    dit = qd.QwenImageDiTConfig(dim=256, num_heads=2, head_dim=128, num_layers=2, text_dim=64)
    return (dit, qcn.QwenImageControlNetConfig(num_layers=2, dim=256),
            qv.QwenVLTextConfig(hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
                                intermediate_size=96, vocab=1000, mrope_section=(2, 3, 3)),
            qv.QwenVLVisionConfig(hidden_size=64, depth=2, num_heads=4, intermediate_size=96,
                                  out_hidden_size=64, fullatt_block_indexes=(1,)))


def phase_small_qwen_image():
    """Qwen-Image's modules at small sizes on the card: the DiT forward at head_dim 128 (2
    heads, 2 blocks, a 32x32 latent: 256 image tokens and a 16x16 extra image's 64 behind
    20 text tokens) with the blockwise ControlNet, "auto" (K1 through the runtime bound, 2
    launches) against "plain" on the same inputs, float32 (within 1e-4 of the output's
    scale) and bf16 (within 3e-2 of it); the tiny text tower (M-RoPE over an image span),
    the vision tower (two images, windows and full attention) and the tiny VAE's encode
    and decode on the card against the CPU, float32 with TF32 off (1e-4 of the scale)."""
    import copy

    from goal_force_tpu_torch.models import qwen_image_controlnet as qcn
    from goal_force_tpu_torch.models import qwen_image_dit as qd
    from goal_force_tpu_torch.models import qwen_vl as qv
    from goal_force_tpu_torch.models import vae as vm
    from goal_force_tpu_torch.pipelines import qwen_image as qp

    cfg, cn_cfg, txt_cfg, vis_cfg = _small_qwen_configs()
    gen = torch.Generator("cuda").manual_seed(161)
    rec, launches = {}, {}
    for dtype, rel in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
        tag = str(dtype).split(".")[-1]
        dit = qd.init_qwen_image_dit(cfg, gen, dtype, device="cuda")
        cn = qcn.init_qwen_image_controlnet(cn_cfg, gen, dtype, device="cuda")
        for blk in cn.controlnet_blocks:
            blk.output_proj.weight.normal_(generator=gen).mul_(0.02)   # residuals not zero
        lat, extra = _rand((1, 32, 32, 16), gen, dtype), _rand((1, 16, 16, 16), gen, dtype)
        txt, cond = _rand((1, 20, cfg.text_dim), gen, dtype), _rand((1, 256, 64), gen, dtype)
        t = torch.tensor([0.7], dtype=dtype, device="cuda")
        rec[f"dit_{tag}"], launches[f"dit_{tag}"] = _auto_vs_plain(
            "small_qwen_image", f"DiT forward {tag}",
            lambda impl: qd.qwen_image_dit_forward(dit, cfg, lat, t, txt, attn_impl=impl,
                                                   controlnet=cn, controlnet_cond=cond,
                                                   extra_latents=[extra]),
            rel, only(K1=2))
        del dit, cn

    cpu_gen = torch.Generator().manual_seed(162)
    text = qv.init_qwen_vl_text(txt_cfg, cpu_gen, torch.float32, device="cpu")
    vis = qv.init_qwen_vl_vision(vis_cfg, cpu_gen, torch.float32, device="cpu")
    vae_cfg = qp.tiny_qwen_image_configs()[2]
    vae = vm.init_vae(vae_cfg, cpu_gen, device="cpu")
    for mod in vae.modules():
        if isinstance(mod, vm.AttentionBlock):
            mod.proj.weight.normal_(generator=cpu_gen).mul_(0.02)
    ids = torch.tensor([[3, 4, 101] + [100] * 6 + [5, 6, 7]])
    pos = torch.as_tensor(qv.get_rope_index(ids.numpy(), [(1, 4, 6)], 100, 101))
    feats = torch.randn((6, 64), generator=cpu_gen)
    pixels = torch.randn((24 + 32, 3 * 2 * 14 * 14), generator=cpu_gen)
    img = torch.rand((1, 1, 32, 32, 3), generator=cpu_gen) * 2 - 1
    z = torch.randn((1, 1, 16, 16, 16), generator=cpu_gen)
    cases = {
        "text tower": lambda m, d: qv.qwen_vl_text_forward(
            m["text"], txt_cfg, qv.qwen_vl_embed(m["text"], ids.to(d), feats.to(d), 100),
            torch.ones_like(ids).to(d), pos.to(d)),
        "vision tower": lambda m, d: qv.qwen_vl_vision_forward(
            m["vis"], vis_cfg, pixels.to(d), ((1, 4, 6), (1, 8, 4))),
        "VAE encode": lambda m, d: vm.encode_video(m["vae"], vae_cfg, img.to(d)),
        "VAE decode": lambda m, d: vm.decode_video(m["vae"], vae_cfg, z.to(d)),
    }
    mods = {"text": text, "vis": vis, "vae": vae}
    gpu = {k: copy.deepcopy(v).to("cuda") for k, v in mods.items()}
    tf32_before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for name, fn in cases.items():
            want = fn(mods, "cpu")
            got = fn(gpu, "cuda")
            scale = float(want.abs().max())
            rec[name.replace(" ", "_")] = compare(
                f"small_qwen_image {name} float32 cuda vs cpu", got.cpu(), want,
                atol=1e-4 * scale, rtol=0.0, phase="small_qwen_image")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32_before
    log("small_qwen_image", image_tokens=256, extra_tokens=64, text_tokens=20,
        launches=launches, **rec)
    del gpu
    torch.cuda.empty_cache()
    return {k: sum(v[k] for v in launches.values()) for k in launches["dit_float32"]}


QWEN_SPECIAL_IDS = {"<|im_start|>": 151644, "<|im_end|>": 151645,
                    "<|vision_start|>": 151652, "<|vision_end|>": 151653,
                    "<|image_pad|>": 151655}


# Qwen-Image's prompts (no Qwen2.5-VL tokenizer ships with the repo): the chat template's
# special tokens at their Qwen2.5-VL ids, every other word or punctuation mark at a crc32
# hash in [1000, 151000).
qwen_hash_tokenizer = hash_encoder(QWEN_SPECIAL_IDS, 150000)


# Qwen-Image at its released configuration and full depth: 60 blocks of 3072, 24 x 128
# heads, so 60 K1 per DiT forward at 1328x1328 (6,889 image tokens behind the 14 of the 48
# hash ids left after the template's 34: 6,903); the edit request's 1024x1024 edit image
# adds 4,096 tokens and its template 1,225 vision tokens to the text.
QWEN_HW = 1328
QWEN_K1 = 60
QWEN_TOKENS = 14 + (QWEN_HW // 16) ** 2
QWEN_PROMPT = FLUX_PROMPT
QWEN_EDIT = "make the ball green and move the cup to the left"


def phase_qwen_image():
    """Qwen-Image at its released configuration and full depth (dim 3072, 24x128 heads, 60
    blocks, in 64, text 3584, axes (16, 56, 56)), Qwen2.5-VL-7B's text tower (28 layers)
    and vision tower (32 layers) whole, the Wan-architecture VAE (float32) and the
    60-block ControlNet, random bf16 weights from a seed: at 1328x1328 (a) text-to-image,
    2 of 30 steps, CFG 4.0 as two forwards a step, on JAX's hash ids; (b) the ControlNet
    on (a)'s image; (c) Qwen-Image-Edit with (a)'s image as the edit image (auto-resized
    to 1024x1024, read by the vision tower, appended as 4,096 tokens; the prompt through
    ``qwen_hash_tokenizer``), each 2 steps (Qwen's schedule of one step is 0 / 0 at its
    terminal shift, in JAX too): 60 K1 per forward, one bound sync each, 0 K2,
    finite (1328, 1328, 3) images; the text, vision, step, encode and decode seconds and
    the peaks. Then (d) one forward with every q-norm weight x8 (60 K2) against the plain
    path, the bound's cost per forward, and K1 at the path's two shapes against its plain
    version on every head, timed beside its bound, the bound's sync and SDPA."""
    from goal_force_tpu_torch.models import qwen_image_controlnet as qcn
    from goal_force_tpu_torch.models import qwen_image_dit as qd
    from goal_force_tpu_torch.models import qwen_vl as qv
    from goal_force_tpu_torch.models import vae as vm
    from goal_force_tpu_torch.models.qwen_image_vae import QWEN_IMAGE_VAE_CONFIG
    from goal_force_tpu_torch.ops import flash_attention as fa
    from goal_force_tpu_torch.pipelines import qwen_image as qp

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator("cuda").manual_seed(171)
    bf16 = torch.bfloat16
    cfg = qd.QwenImageDiTConfig()

    def build():
        cn = qcn.init_qwen_image_controlnet(qcn.QwenImageControlNetConfig(), gen, bf16,
                                            device="cuda")
        for blk in cn.controlnet_blocks:
            blk.output_proj.weight.normal_(generator=gen).mul_(1e-3)   # residuals not zero
        return (qd.init_qwen_image_dit(cfg, gen, bf16, device="cuda"),
                qv.init_qwen_vl_text(qv.QwenVLTextConfig(), gen, bf16, device="cuda"),
                qv.init_qwen_vl_vision(qv.QwenVLVisionConfig(), gen, bf16, device="cuda"),
                vm.init_vae(QWEN_IMAGE_VAE_CONFIG, gen, torch.float32, device="cuda"), cn)

    (dit, text, vision, vae, cn), init_s = sync_time(build)
    count = lambda m: sum(p.numel() for p in m.parameters())
    log("qwen_image", stage="init", seconds=init_s, dit_params=count(dit),
        text_params=count(text), vision_params=count(vision), vae_params=count(vae),
        controlnet_params=count(cn), gib=torch.cuda.memory_allocated() / 2**30)
    pipe = qp.QwenImagePipeline(dit=dit, text_encoder=text, vae_encoder=vae, vae_decoder=vae,
                                dit_cfg=cfg, text_cfg=qv.QwenVLTextConfig(),
                                vae_cfg=QWEN_IMAGE_VAE_CONFIG, dtype=bf16, vae_factor=8,
                                vision_encoder=vision, vision_cfg=qv.QwenVLVisionConfig())
    stages, joint = {}, []
    _time_stages(pipe, stages, _encode_prompt="text_s", _encode_image_prompt="vision_s",
                 _denoise="step_s", _enc="encode_s", _decode="decode_s")
    forward = pipe._forward

    def recording(latents, t, ctx, **kw):
        # the joint length of each forward: text, the main image and the extra images
        extra = kw.get("extra_latents") or ()
        joint.append(ctx.shape[1] + sum(z.shape[1] * z.shape[2] // 4
                                        for z in (latents, *extra)))
        return forward(latents, t, ctx, **kw)

    pipe._forward = recording
    common = dict(negative_prompt=FLUX_NEGATIVE, cfg_scale=4.0, height=QWEN_HW, width=QWEN_HW,
                  seed=23)
    launches, image, path = {}, None, {}
    for name, kw, k1 in (
            ("a_t2i", dict(num_inference_steps=2), 4 * QWEN_K1),
            ("b_controlnet", dict(num_inference_steps=2, controlnet=cn), 4 * QWEN_K1),
            ("c_edit", dict(num_inference_steps=2), 4 * QWEN_K1)):
        stages.clear()
        joint.clear()
        prompt = QWEN_PROMPT
        if name == "b_controlnet":
            kw["controlnet_image"] = image
        elif name == "c_edit":
            kw["edit_image"], prompt = image, QWEN_EDIT
            pipe.tokenize = qwen_hash_tokenizer
        fa.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        with BoundRecorder() as bounds:
            out, secs = sync_time(lambda: pipe(prompt, **kw, **common))
        launched = dict(fa.launch_counts)
        pipe.tokenize = None
        finite = bool(np.isfinite(out).all())
        log("qwen_image", stage="request", request=name, seconds=secs, **stages,
            launches=launched, bound_syncs=bounds.calls, want_k1=k1, joint_tokens=joint,
            image_shape=list(out.shape), finite=finite, image_mean=float(out.mean()),
            image_std=float(out.std()), peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        check(launched == only(K1=k1) and bounds.calls == k1,
              f"qwen_image {name} launched {launched}, {bounds.calls} bound syncs")
        check(out.shape == (QWEN_HW, QWEN_HW, 3) and finite,
              f"qwen_image {name} image {out.shape}, finite {finite}")
        if name == "a_t2i":
            check(set(joint) == {QWEN_TOKENS}, f"qwen_image t2i joint lengths {joint}")
        path[name] = max(joint)
        for key, n in launched.items():
            launches[key] = launches.get(key, 0) + n
        if image is None:
            image = out
    pipe._forward = forward
    emb = pipe._encode_prompt(QWEN_PROMPT).to(bf16)
    del pipe, forward, recording, text, vision, vae, cn, image
    gc.collect()
    torch.cuda.empty_cache()

    # the runtime bound's cost at (a)'s shapes: one forward with the bound and with it
    # replaced by a host constant (the same kernels, no reductions and no host sync)
    lat = _rand((1, QWEN_HW // 8, QWEN_HW // 8, 16), gen, bf16)
    t = torch.tensor([0.5], dtype=bf16, device="cuda")
    fwd = lambda impl="auto": qd.qwen_image_dit_forward(dit, cfg, lat, t, emb, attn_impl=impl)
    bound_sync_cost("qwen_image", "forward", fwd, only(K1=QWEN_K1))

    # (d) one forward past the bound: every q-norm weight x8
    norms = [w for blk in dit.transformer_blocks
             for w in (blk.attn.norm_q.weight, blk.attn.norm_added_q.weight)]
    for w in norms:
        w.mul_(8)
    try:
        fa.reset_launch_counts()
        with BoundRecorder(values=True) as bounds:
            got, secs = sync_time(fwd)
        unb = dict(fa.launch_counts)
        ref, plain_s = sync_time(lambda: fwd("plain"))
    finally:
        for w in norms:
            w.div_(8)
    scale = float(ref.float().abs().max())
    d = got.float() - ref.float()
    err = float(d.abs().max())
    ok = bool(torch.isfinite(got).all()) and err <= 5e-2 * scale
    log("qwen_image", stage="unbounded_forward", seconds=secs, plain_seconds=plain_s,
        launches=unb, bounds_min=min(bounds.bounds, default=None),
        bounds_max=max(bounds.bounds, default=None),
        max_abs_err=err, atol=5e-2 * scale, out_max=scale, mean_abs_err=float(d.abs().mean()),
        rel_bias=float((d * ref.float().sign()).mean() / ref.float().abs().mean()), ok=ok)
    check(unb == only(K2=QWEN_K1) and min(bounds.bounds, default=0) >= fa.NOMAX_BOUND,
          f"qwen_image unbounded forward launched {unb}, bounds {bounds.bounds}")
    check(ok, f"qwen_image unbounded forward: kernels vs plain differ by {err}")
    del dit, got, ref, lat, emb, d
    gc.collect()
    torch.cuda.empty_cache()

    gen = torch.Generator("cuda").manual_seed(172)
    k1 = {"t2i": _flux_k1("t2i", (1, path["a_t2i"], 24, 128), gen, phase="qwen_image"),
          "edit": _flux_k1("edit", (1, path["c_edit"], 24, 128), gen, phase="qwen_image")}
    return launches, unb, k1


def _small_nexus_configs():
    import dataclasses as dc

    from goal_force_tpu_torch.models import nexus_gen as ng
    from goal_force_tpu_torch.models import qwen_vl as qv
    from goal_force_tpu_torch.models.sd_text_encoder import SD_TEXT_CONFIG
    from goal_force_tpu_torch.pipelines import flux as fp

    dit, _ = _small_flux_configs()
    text = qv.QwenVLTextConfig(hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
                               intermediate_size=96, vocab=1000, mrope_section=(2, 3, 3))
    clip = dc.replace(SD_TEXT_CONFIG, text_dim=dit.pooled_dim, text_heads=4, text_layers=2)
    return (dit, fp.tiny_flux_configs()[1], clip, text,
            ng.NexusGenMergerConfig(text=text, num_layers=1, out_channel=dit.text_dim,
                                    expand_ratio=2))


def _cuda_copy(pipe, names):
    """The pipeline with deep copies of the named modules on the card."""
    import copy

    return dataclasses.replace(pipe, **{n: copy.deepcopy(getattr(pipe, n)).to("cuda")
                                        for n in names})


def _card_vs_cpu(phase, name, cpu_fn, gpu_fn, atol, want_launches):
    """gpu_fn() on the card against cpu_fn() (numpy images), cudnn TF32 off: finite,
    within atol, launching want_launches (each K1/K2 behind one bound sync)."""
    from goal_force_tpu_torch.ops import flash_attention as fa

    tf32_before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        want = cpu_fn()
        fa.reset_launch_counts()
        with BoundRecorder() as bounds:
            got, secs = sync_time(gpu_fn)
        launches = dict(fa.launch_counts)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32_before
    err = float(np.abs(got - want).max())
    ok = got.shape == want.shape and bool(np.isfinite(got).all()) and err <= atol
    log(phase, case=f"{name} cuda vs cpu", seconds=secs, max_abs_err=err, atol=atol,
        launches=launches, bound_syncs=bounds.calls, ok=ok)
    check(ok, f"{phase} {name}: the card's output differs from the CPU's by {err}")
    check(launches == want_launches and bounds.calls == sum(want_launches.values()),
          f"{phase} {name} launched {launches}, {bounds.calls} bound syncs")
    return err, launches


# A cached route (Nexus-Gen's AR loop, OmniGen's condition cache) against the uncached one
# at full width: in float32 (the weights converted) the two may differ only by float32's
# rounding in another summation order (limit CACHE_F32_REL of the scale); in bf16 the
# cached route may differ from the uncached one by no more than twice the uncached bf16
# route's own distance from the float32 one (bf16 noise, amplified alike by the random
# layers).
CACHE_F32_REL = 1e-4


def _cached_vs_full(phase, name, cached, full, cached32, full32, **fields):
    """Logs and checks both comparisons (the rule above); without `cached32` the bf16 one
    only."""
    dist = lambda a, b: float((a.float() - b.float()).abs().max())
    scale = float(full32.abs().max())
    err, own = dist(cached, full), dist(full, full32)
    err32 = None if cached32 is None else dist(cached32, full32)
    ok = (cached.shape == full.shape and bool(torch.isfinite(cached).all())
          and (err32 is None or err32 <= CACHE_F32_REL * scale) and err <= 2 * own)
    log(phase, stage="cached_vs_full", case=name, **fields, float32_max_abs_err=err32,
        float32_atol=CACHE_F32_REL * scale, bf16_max_abs_err=err,
        bf16_full_vs_float32=own, bf16_cached_vs_float32=dist(cached, full32),
        bf16_atol=2 * own, out_max=scale,
        bf16_mean_abs_err=float((cached.float() - full.float()).abs().mean()),
        mean_abs=float(full32.abs().mean()), ok=ok)
    check(ok, f"{phase} {name}: float32 {err32}, bf16 {err} (bf16's own {own})")


def _phase_summary(phase, t0, launches, peaks=()):
    """A phase's last line: its seconds, its peak memory (the largest of its requests'
    peaks and the allocator's since the last reset) and its launches per kernel."""
    log(phase, stage="done", seconds=time.perf_counter() - t0,
        peak_gib=max([torch.cuda.max_memory_allocated() / 2**30, *peaks]),
        launches={k: v for k, v in launches.items() if v})


def phase_small_nexus_gen():
    """Nexus-Gen's tiny pipeline over a small Flux at head_dim 128 (2 heads, 1 joint + 1
    single block, the tiny T5, CLIP-L and VAE) with a tiny Qwen2.5-VL text stack (LM
    head), heads (a 6x6 target grid: 9 image tokens), adapter and merger, float32 on the
    card (the kernels behind the runtime bound) against the CPU (plain attention), cudnn
    TF32 off: a 64x64 request and an edit (4 reference embeddings on a 4x4 grid), 2
    steps each (265 and 269 joint tokens: 2 K1 per forward, one bound sync each), images
    within 1e-4; the AR loop against the teacher-forced forward on the card (float32,
    1e-5 of the scale) and greedy generation's 8 tokens equal to the CPU's."""
    import copy

    from goal_force_tpu_torch.models import clip as clipm
    from goal_force_tpu_torch.models import flux_dit as fd
    from goal_force_tpu_torch.models import nexus_gen as ng
    from goal_force_tpu_torch.models import qwen_vl as qv
    from goal_force_tpu_torch.models import sd_vae as sv
    from goal_force_tpu_torch.models import t5 as t5m
    from goal_force_tpu_torch.pipelines import flux as fp
    from goal_force_tpu_torch.pipelines import nexus_gen as npipe

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    dit_cfg, t5_cfg, clip_cfg, text_cfg, merger_cfg = _small_nexus_configs()
    gen = torch.Generator().manual_seed(181)
    f32 = torch.float32
    enc_plan, dec_plan, groups = fp.tiny_sd3_vae_plans()
    flux = fp.FluxPipeline(
        dit=fd.init_flux_dit(dit_cfg, gen, f32, device="cpu"),
        clip=clipm.init_clip_text(clip_cfg, gen, f32, device="cpu"),
        t5=t5m.init_t5(t5_cfg, gen, f32, device="cpu"),
        vae_encoder=sv.init_sd_vae(sv.SDVAEEncoder, enc_plan, gen, f32, device="cpu"),
        vae_decoder=sv.init_sd_vae(sv.SDVAEDecoder, dec_plan, gen, f32, device="cpu"),
        dit_cfg=dit_cfg, t5_cfg=t5_cfg, clip_cfg=clip_cfg, vae_groups=groups, vae_factor=2,
        dtype=f32)
    h = text_cfg.hidden_size
    cpu = npipe.NexusGenPipeline(
        ar_model=qv.init_qwen_vl_text(text_cfg, gen, f32, device="cpu", lm_head=True),
        ar_cfg=text_cfg, heads=ng.init_nexus_gen_heads(h, 9, gen, f32, device="cpu"),
        adapter=ng.init_nexus_gen_adapter(h, dit_cfg.text_dim, gen, f32, device="cpu"),
        flux=flux, grid_thw=(1, 6, 6))
    merger = ng.init_nexus_gen_merger(merger_cfg, gen, f32, device="cpu")
    gpu = _cuda_copy(cpu, ("ar_model", "heads", "adapter"))
    gpu.flux = _cuda_copy(flux, ("dit", "clip", "t5", "vae_encoder", "vae_decoder"))
    gpu_merger = copy.deepcopy(merger).to("cuda")
    noise = np.random.default_rng(182).standard_normal((1, 32, 32, 16)).astype(np.float32)
    ref = np.random.default_rng(183).standard_normal((1, 4, h)).astype(np.float32)
    req = dict(height=64, width=64, num_inference_steps=2, noise=noise)
    rec, launches = {}, {}
    rec["call"], launches["call"] = _card_vs_cpu(
        "small_nexus_gen", "request", lambda: cpu("a lighthouse at dusk", **req),
        lambda: gpu("a lighthouse at dusk", **req), 1e-4, only(K1=4))
    rec["edit"], launches["edit"] = _card_vs_cpu(
        "small_nexus_gen", "edit", lambda: cpu.edit("make it night", ref, (1, 4, 4), merger,
                                                    merger_cfg, **req),
        lambda: gpu.edit("make it night", ref, (1, 4, 4), gpu_merger, merger_cfg, **req),
        1e-4, only(K1=4))

    embeds, pos, n = gpu._prompt_embeds("a lighthouse at dusk")
    with torch.no_grad():
        tf = ng.nexus_gen_target_embeddings(gpu.ar_model, text_cfg, gpu.heads, embeds, pos, n)
        ar = ng.nexus_gen_ar_generate(gpu.ar_model, text_cfg, gpu.heads, embeds[:, :-n],
                                      pos[..., :-n], (1, 6, 6), 2)
    scale = float(tf.abs().max())
    rec["ar_vs_teacher_forced"] = compare(
        "small_nexus_gen AR loop vs teacher-forced forward float32", ar, tf,
        atol=1e-5 * scale, rtol=0.0, phase="small_nexus_gen")
    ids = np.array([[3, 17, 420, 8, 29, 911]])
    toks = {d: qv.qwen_vl_text_generate(p.ar_model, text_cfg, ids, 8)
            for d, p in (("cpu", cpu), ("cuda", gpu))}
    log("small_nexus_gen", case="greedy tokens cuda vs cpu", **toks,
        ok=toks["cpu"] == toks["cuda"])
    check(toks["cpu"] == toks["cuda"] and len(toks["cpu"]) == 8,
          f"small_nexus_gen generate: {toks}")
    log("small_nexus_gen", launches=launches, **rec)
    total = {k: sum(v[k] for v in launches.values()) for k in launches["call"]}
    _phase_summary("small_nexus_gen", t0, total)
    del gpu, gpu_merger
    torch.cuda.empty_cache()
    return total


def phase_small_hunyuan_dit():
    """HunyuanDiT's tiny pipeline (init_random: dim 16, 2 heads of 8, 4 down + 2 up
    blocks, the tiny SD VAE) on the card against the CPU over the same float32 weights
    and noise, cudnn TF32 off: a 64x64 request, 2 DDIM steps, CFG 5.0 merged with one
    regional prompt (B = 3), images within 1e-4. Head_dim 8: the plain attention, no
    kernel launch."""
    from goal_force_tpu_torch.pipelines import hunyuan_image as hp

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cpu = hp.HunyuanImagePipeline.init_random(seed=191, device="cpu")
    gpu = _cuda_copy(cpu, ("dit", "vae_encoder", "vae_decoder"))
    mask = np.zeros((64, 64), np.float32)
    mask[:, :32] = 1.0
    req = dict(prompt="a red ball", negative_prompt="blurry", cfg_scale=5.0, height=64,
               width=64, num_inference_steps=2, local_prompts=["a ball"], masks=[mask],
               mask_scales=[0.5], local_blur_kernel_size=3, local_blur_sigma=1.0,
               noise=np.random.default_rng(192).standard_normal((1, 8, 8, 4)).astype(
                   np.float32))
    err, launches = _card_vs_cpu("small_hunyuan_dit", "request", lambda: cpu(**req),
                                 lambda: gpu(**req), 1e-4, only())
    _phase_summary("small_hunyuan_dit", t0, launches)
    del gpu
    torch.cuda.empty_cache()
    return launches


def phase_small_omnigen():
    """OmniGen's tiny pipeline (init_random: Phi-3 at 32 wide, 4 heads of 8, 2 layers, the
    tiny SD VAE) on the card against the CPU over the same float32 weights and noise,
    cudnn TF32 off: a 64x64 request with one 32x32 reference image (three branches, the
    condition cache on), 2 steps, images within 1e-4. Head_dim 8: the plain attention,
    no kernel launch."""
    from goal_force_tpu_torch.pipelines import omnigen_image as op

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cpu = op.OmniGenImagePipeline.init_random(seed=201, device="cpu")
    gpu = _cuda_copy(cpu, ("transformer", "vae_encoder", "vae_decoder"))
    rng = np.random.default_rng(202)
    req = dict(prompt="a red ball", reference_images=[
        rng.uniform(-1, 1, size=(32, 32, 3)).astype(np.float32)], height=64, width=64,
        num_inference_steps=2, noise=rng.standard_normal((1, 8, 8, 4)).astype(np.float32))
    err, launches = _card_vs_cpu("small_omnigen", "request", lambda: cpu(**req),
                                 lambda: gpu(**req), 1e-4, only())
    _phase_summary("small_omnigen", t0, launches)
    del gpu
    torch.cuda.empty_cache()
    return launches


# Nexus-Gen over FLUX.1-dev at full depth: the AR prompt is 12 hash ids and the 81-entry
# prefill table; Flux's joint sequence puts the 81 adapted image embeddings in the text
# slot before the 4,096 image tokens at 1024x1024 (4,177); the edit's text slot holds the
# merger's 81 + 324 reference embeddings (a 504x504 image: grid (1, 36, 36)): 4,501.
NEXUS_HW = 1024
NEXUS_REF_HW = 504
NEXUS_IMG_TOKENS = 81
NEXUS_REF_TOKENS = (NEXUS_REF_HW // 28) ** 2
NEXUS_TOKENS = NEXUS_IMG_TOKENS + (NEXUS_HW // 16) ** 2
NEXUS_EDIT_TOKENS = NEXUS_TOKENS + NEXUS_REF_TOKENS
NEXUS_EDIT = "make the ball green and the cup red"
NEXUS_NEW_TOKENS = 16


def phase_nexus_gen():
    """Nexus-Gen at full width and depth, random bf16 weights from a seed: Qwen2.5-VL-7B's
    text stack (28 layers of 3,584, 28 query and 4 KV heads, FFN 18,944, vocab 152,064)
    with its LM head, the vision head, the 81-entry prefill table, the adapter (3,584 ->
    4,096), the one-layer editing merger and the vision tower (32 layers), over
    FLUX.1-dev (19 + 38 blocks), CLIP-L, T5 v1.1 XXL at 2 of 24 layers and the 16-channel
    VAE. (a) a 1024x1024 text-to-image request, 2 steps (57 K1 per forward behind one
    bound sync each at (1, 4,177, 24, 128)^2); (c) an edit, 2 steps: the reference
    embeddings from the vision tower on (a)'s image at 504x504 (grid (1, 36, 36): 324
    tokens), the merger, the editing rope tables (4,501 joint tokens). Then the bound's
    cost per forward at (a)'s shapes and one forward with every q-norm weight x8 (57 K2)
    against the plain path; with Flux freed, (d) qwen_vl_text_generate with 16 new
    tokens: its tokens per second; (b) nexus_gen_ar_generate (prefill + 80 cached steps)
    against nexus_gen_target_embeddings on the same prompt in bf16, held to the forward's
    own bf16 error against the stack converted to float32 (``_cached_vs_full``); K1 at
    both path shapes against its plain version on every head, timed beside its bound,
    the bound's sync and SDPA."""
    from PIL import Image

    from goal_force_tpu_torch.configs import FLUX_DEV, T5_V1_1_XXL
    from goal_force_tpu_torch.models import clip as clipm
    from goal_force_tpu_torch.models import flux_dit as fd
    from goal_force_tpu_torch.models import nexus_gen as ng
    from goal_force_tpu_torch.models import qwen_vl as qv
    from goal_force_tpu_torch.models import sd_vae as sv
    from goal_force_tpu_torch.models import t5 as t5m
    from goal_force_tpu_torch.models.sd_text_encoder import SD_TEXT_CONFIG
    from goal_force_tpu_torch.models.tokenizer import hash_ids
    from goal_force_tpu_torch.ops import flash_attention as fa
    from goal_force_tpu_torch.pipelines import flux as fp
    from goal_force_tpu_torch.pipelines import nexus_gen as npipe
    from goal_force_tpu_torch.prompters import flux_tokenizers

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator("cuda").manual_seed(211)
    bf16 = torch.bfloat16
    t5_cfg = dataclasses.replace(T5_V1_1_XXL, num_layers=FLUX_T5_LAYERS, text_len=512)
    text_cfg, vis_cfg = qv.QwenVLTextConfig(), qv.QwenVLVisionConfig()
    hid = text_cfg.hidden_size
    merger_cfg = ng.NexusGenMergerConfig(text=text_cfg, num_layers=1,
                                         out_channel=FLUX_DEV.text_dim)

    def build():
        return (fd.init_flux_dit(FLUX_DEV, gen, bf16, device="cuda"),
                clipm.init_clip_text(SD_TEXT_CONFIG, gen, bf16, device="cuda"),
                t5m.init_t5(t5_cfg, gen, bf16, device="cuda"),
                sv.init_sd_vae(sv.SDVAEEncoder, sv.SD_VAE_ENCODER_PLAN, gen, bf16, device="cuda"),
                sv.init_sd_vae(sv.SDVAEDecoder, sv.SD_VAE_DECODER_PLAN, gen, bf16, device="cuda"),
                qv.init_qwen_vl_text(text_cfg, gen, bf16, device="cuda", lm_head=True),
                qv.init_qwen_vl_vision(vis_cfg, gen, bf16, device="cuda"),
                ng.init_nexus_gen_heads(hid, NEXUS_IMG_TOKENS, gen, bf16, device="cuda"),
                ng.init_nexus_gen_adapter(hid, FLUX_DEV.text_dim, gen, bf16, device="cuda"),
                ng.init_nexus_gen_merger(merger_cfg, gen, bf16, device="cuda"))

    (dit, clip, t5, enc, dec, text, vision, heads, adapter, merger), init_s = sync_time(build)
    count = lambda m: sum(p.numel() for p in m.parameters())
    log("nexus_gen", stage="init", seconds=init_s, dit_params=count(dit),
        text_params=count(text), vision_params=count(vision),
        heads_adapter_merger_params=count(heads) + count(adapter) + count(merger),
        flux_towers_vae_params=count(clip) + count(t5) + count(enc) + count(dec),
        gib=torch.cuda.memory_allocated() / 2**30)
    tok_clip, tok_t5 = flux_tokenizers(t5_length=512)
    flux = fp.FluxPipeline(dit=dit, clip=clip, t5=t5, vae_encoder=enc, vae_decoder=dec,
                           dit_cfg=FLUX_DEV, t5_cfg=t5_cfg, tokenize_clip=tok_clip,
                           tokenize_t5=tok_t5, dtype=bf16)
    pipe = npipe.NexusGenPipeline(ar_model=text, ar_cfg=text_cfg, heads=heads,
                                  adapter=adapter, flux=flux)
    stages, joint = {}, []
    _time_stages(flux, stages, _encode_text="text_s", _velocity="step_s", _decode="decode_s")
    real = _time_stages(ng, stages, nexus_gen_target_embeddings="ar_s",
                        nexus_gen_merger_forward="merger_s")
    velocity = flux._velocity

    def recording(model_in, timestep, prompt_emb, *a, **kw):
        joint.append(prompt_emb.shape[1] + model_in.shape[1] * model_in.shape[2] // 4)
        return velocity(model_in, timestep, prompt_emb, *a, **kw)

    flux._velocity = recording
    common = dict(height=NEXUS_HW, width=NEXUS_HW, num_inference_steps=2)
    launches, image, path, peaks = {}, None, {}, []
    try:
        for name, tokens in (("a_t2i", NEXUS_TOKENS), ("c_edit", NEXUS_EDIT_TOKENS)):
            stages.clear()
            joint.clear()
            if name == "a_t2i":
                fn = lambda: pipe(FLUX_PROMPT, seed=29, **common)
            else:
                small = np.asarray(Image.fromarray((image * 255).astype(np.uint8)).resize(
                    (NEXUS_REF_HW, NEXUS_REF_HW), Image.BICUBIC), np.float32) / 255.0
                pixels, grid = qv.preprocess_image_for_vision(small, vis_cfg)
                feats, vision_s = sync_time(lambda: qv.qwen_vl_vision_forward(
                    vision, vis_cfg, torch.as_tensor(pixels, device="cuda"), (grid,)))
                stages["vision_s"] = [vision_s]
                check(tuple(grid) == (1, 36, 36) and feats.shape == (NEXUS_REF_TOKENS, hid),
                      f"nexus_gen reference grid {grid}, features {tuple(feats.shape)}")
                fn = lambda: pipe.edit(NEXUS_EDIT, feats[None], grid, merger, merger_cfg,
                                       seed=31, **common)
            fa.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            with BoundRecorder() as bounds:
                out, secs = sync_time(fn)
            launched = dict(fa.launch_counts)
            finite = bool(np.isfinite(out).all())
            log("nexus_gen", stage="request", request=name, seconds=secs, **stages,
                launches=launched, bound_syncs=bounds.calls, want_k1=2 * FLUX_K1,
                joint_tokens=joint, image_shape=list(out.shape), finite=finite,
                image_mean=float(out.mean()), image_std=float(out.std()),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)
            peaks.append(torch.cuda.max_memory_allocated() / 2**30)
            check(launched == only(K1=2 * FLUX_K1) and bounds.calls == 2 * FLUX_K1,
                  f"nexus_gen {name} launched {launched}, {bounds.calls} bound syncs")
            check(out.shape == (NEXUS_HW, NEXUS_HW, 3) and finite,
                  f"nexus_gen {name} image {out.shape}, finite {finite}")
            check(set(joint) == {tokens}, f"nexus_gen {name} joint lengths {joint}")
            path[name] = tokens
            for key, n in launched.items():
                launches[key] = launches.get(key, 0) + n
            if image is None:
                image = out
    finally:
        flux._velocity = velocity
        for attr, fn in real.items():
            setattr(ng, attr, fn)

    embeds, pos, n = pipe._prompt_embeds(FLUX_PROMPT)
    with torch.no_grad():
        tf, tf_s = sync_time(lambda: ng.nexus_gen_target_embeddings(text, text_cfg, heads,
                                                                    embeds, pos, n))
        ctx = ng.nexus_gen_adapter_forward(adapter, tf)
        _, pooled = flux._encode_text([FLUX_PROMPT])
    del pipe, flux, clip, t5, enc, dec, vision, adapter, merger, image, out, fn, feats
    del recording, velocity
    gc.collect()
    torch.cuda.empty_cache()

    # the runtime bound's cost at (a)'s shapes, then one forward past the bound
    lat = _rand((1, NEXUS_HW // 8, NEXUS_HW // 8, 16), gen, bf16)
    t = torch.tensor([500.0], dtype=bf16, device="cuda")
    g = torch.tensor([3.5], dtype=bf16, device="cuda")
    forward = lambda impl="auto": fd.flux_dit_forward(dit, FLUX_DEV, lat, t, ctx, pooled, g,
                                                      attn_impl=impl)
    bound_sync_cost("nexus_gen", "forward", forward, only(K1=FLUX_K1))
    norms = [m.weight for blk in dit.blocks for m in (blk.attn.norm_q_a, blk.attn.norm_q_b)]
    norms += [blk.norm_q_a.weight for blk in dit.single_blocks]
    for w in norms:
        w.mul_(8)
    try:
        fa.reset_launch_counts()
        with BoundRecorder(values=True) as bounds:
            got, secs = sync_time(forward)
        unb = dict(fa.launch_counts)
        ref, plain_s = sync_time(lambda: forward("plain"))
    finally:
        for w in norms:
            w.div_(8)
    scale = float(ref.float().abs().max())
    d = got.float() - ref.float()
    err = float(d.abs().max())
    ok = bool(torch.isfinite(got).all()) and err <= 5e-2 * scale
    log("nexus_gen", stage="unbounded_forward", seconds=secs, plain_seconds=plain_s,
        launches=unb, bounds_min=min(bounds.bounds), bounds_max=max(bounds.bounds),
        max_abs_err=err, atol=5e-2 * scale, out_max=scale, mean_abs_err=float(d.abs().mean()),
        ok=ok)
    check(unb == only(K2=FLUX_K1) and min(bounds.bounds) >= fa.NOMAX_BOUND,
          f"nexus_gen unbounded forward launched {unb}, bounds {bounds.bounds}")
    check(ok, f"nexus_gen unbounded forward: kernels vs plain differ by {err}")
    del dit, got, ref, lat, ctx, pooled, d
    gc.collect()
    torch.cuda.empty_cache()

    # (d) greedy generation at full depth
    ids = hash_ids(FLUX_PROMPT, text_cfg.vocab, 12)[None]
    prefill_pos = torch.arange(12, device="cuda")[None, None].expand(3, 1, 12)
    with torch.no_grad():
        _, prefill_s = sync_time(lambda: qv.qwen_vl_text_prefill(
            text, text_cfg, text.embed_tokens.weight[torch.as_tensor(ids, device="cuda")],
            prefill_pos, 12 + NEXUS_NEW_TOKENS))
    toks, gen_s = sync_time(lambda: qv.qwen_vl_text_generate(text, text_cfg, ids,
                                                             NEXUS_NEW_TOKENS))
    ok = len(toks) == NEXUS_NEW_TOKENS and all(0 <= t < text_cfg.vocab for t in toks)
    log("nexus_gen", stage="generate", new_tokens=len(toks), seconds=gen_s,
        tokens_per_s=len(toks) / gen_s, prefill_seconds=prefill_s,
        decode_tokens_per_s=(len(toks) - 1) / max(gen_s - prefill_s, 1e-9), tokens=toks, ok=ok)
    check(ok, f"nexus_gen generate gave {toks}")

    # (b) the cached AR loop against the teacher-forced forward on the same prompt, in
    # bf16, held to the forward's own bf16 error against the stack converted to float32
    with torch.no_grad():
        ar, ar_s = sync_time(lambda: ng.nexus_gen_ar_generate(
            text, text_cfg, heads, embeds[:, :-n], pos[..., :-n], (1, 18, 18)))
        tf32 = ng.nexus_gen_target_embeddings(text.float(), text_cfg, heads.float(),
                                              embeds.float(), pos, n)
    _cached_vs_full("nexus_gen", "AR loop vs teacher-forced embeddings", ar, tf, None, tf32,
                    cached_seconds=ar_s, full_seconds=tf_s)
    del text, heads, embeds, pos, tf, ar, tf32
    gc.collect()
    torch.cuda.empty_cache()

    gen = torch.Generator("cuda").manual_seed(212)
    k1 = {name: _flux_k1(name, (1, tokens, 24, 128), gen, phase="nexus_gen")
          for name, tokens in path.items()}
    launches["K2"] = launches.get("K2", 0) + unb.get("K2", 0)
    _phase_summary("nexus_gen", t0, launches, peaks)
    return launches, k1


# HunyuanDiT at its released widths and depth (40 blocks of 1,408, 16 heads of 88), its
# BERT tower (24 layers of 1,024) and mT5-XL's encoder (24 layers of 2,048, 32 heads, FFN
# 5,120, vocab 250,112) whole, the SD VAE in float32; 1024x1024 is 4,096 image tokens.
HYDIT_HW = 1024
HYDIT_SELF = (2, (HYDIT_HW // 16) ** 2, 16, 88)


def phase_hunyuan_dit():
    """HunyuanDiT at its released configuration, random bf16 weights from a seed (the VAE
    float32): (a) a 1024x1024 request, 2 DDIM steps, CFG 6.0 as one merged batch of 2, the
    prompt through the vendored BERT tokenizer and hash ids for mT5; (b) image-to-image
    from (a)'s image at strength 0.5, 1 step. Finite (1024, 1024, 3) images and no kernel
    launch (head_dim 88: every attention is the plain one); the text, step, encode and
    decode seconds and the peaks. Then the plain attention at the self-attention's shape
    (2, 4,096, 16, 88)^2, timed beside SDPA and its bound."""
    from goal_force_tpu_torch.configs import T5Config
    from goal_force_tpu_torch.models import hunyuan_dit as hd
    from goal_force_tpu_torch.models import sd_vae as sv
    from goal_force_tpu_torch.models import t5 as t5m
    from goal_force_tpu_torch.models import text_encoders as te
    from goal_force_tpu_torch.ops import flash_attention as fa
    from goal_force_tpu_torch.pipelines import hunyuan_image as hp
    from goal_force_tpu_torch.prompters import hunyuan_dit_tokenizers

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator("cuda").manual_seed(221)
    bf16, f32 = torch.bfloat16, torch.float32
    cfg, bert_cfg = hd.HunyuanDiTConfig(), te.BertConfig()
    mt5_cfg = T5Config(vocab=250112, dim=2048, dim_attn=2048, dim_ffn=5120, num_heads=32,
                       num_layers=24, shared_pos=True, text_len=cfg.t5_len)

    def build():
        return (hd.init_hunyuan_dit(cfg, gen, bf16, device="cuda"),
                te.init_bert(bert_cfg, gen, bf16, device="cuda"),
                t5m.init_t5(mt5_cfg, gen, bf16, device="cuda"),
                sv.init_sd_vae(sv.SDVAEEncoder, sv.SD_VAE_ENCODER_PLAN, gen, f32, device="cuda",
                               latent_channels=4, quant=True),
                sv.init_sd_vae(sv.SDVAEDecoder, sv.SD_VAE_DECODER_PLAN, gen, f32, device="cuda",
                               latent_channels=4, quant=True))

    (dit, bert, mt5, enc, dec), init_s = sync_time(build)
    count = lambda m: sum(p.numel() for p in m.parameters())
    log("hunyuan_dit", stage="init", seconds=init_s, dit_params=count(dit),
        bert_params=count(bert), mt5_params=count(mt5), vae_params=count(enc) + count(dec),
        gib=torch.cuda.memory_allocated() / 2**30)
    tok = hunyuan_dit_tokenizers()[0].with_length(cfg.text_len)
    pipe = hp.HunyuanImagePipeline(
        dit=dit, vae_decoder=dec, cfg=cfg, vae_encoder=enc, dtype=bf16,
        encode_prompt=hp.make_prompt_encoder(cfg, bert, bert_cfg, tok, mt5, mt5_cfg))
    stages = {}
    _time_stages(pipe, stages, _embeds="text_s", _velocity="step_s", _encode="encode_s",
                 _decode="decode_s")
    common = dict(negative_prompt=FLUX_NEGATIVE, cfg_scale=6.0, height=HYDIT_HW,
                  width=HYDIT_HW, seed=41)
    launches, image, peaks = {}, None, []
    for name, kw in (("a_t2i", dict(num_inference_steps=2)),
                     ("b_i2i", dict(num_inference_steps=1, denoising_strength=0.5))):
        stages.clear()
        if name == "b_i2i":
            kw["input_image"] = image
        fa.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        out, secs = sync_time(lambda: pipe(FLUX_PROMPT, **kw, **common))
        launched = dict(fa.launch_counts)
        finite = bool(np.isfinite(out).all())
        log("hunyuan_dit", stage="request", request=name, seconds=secs, **stages,
            launches=launched, image_shape=list(out.shape), finite=finite,
            image_mean=float(out.mean()), image_std=float(out.std()),
            peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        check(launched == only(), f"hunyuan_dit {name} launched {launched} (head_dim 88)")
        for key, n in launched.items():
            launches[key] = launches.get(key, 0) + n
        check(out.shape == (HYDIT_HW, HYDIT_HW, 3) and finite,
              f"hunyuan_dit {name} image {out.shape}, finite {finite}")
        if image is None:
            image = out
    del pipe, dit, bert, mt5, enc, dec, image
    gc.collect()
    torch.cuda.empty_cache()
    plain = _sd3_plain("self", HYDIT_SELF, torch.Generator("cuda").manual_seed(222),
                       phase="hunyuan_dit")
    _phase_summary("hunyuan_dit", t0, launches, peaks)
    return launches, plain


# OmniGen-v1 at its released widths and depth (Phi-3: 32 layers of 3,072, 32 heads of 96,
# FFN 8,192, vocab 32,064) with the SD VAE in float32, without the released checkpoint's
# LongRoPE factor lists (its config.json is not in the repository): OmniGenConfig's
# defaults, whose amplitude sqrt(1 + ln 32 / ln 4096) still applies. 1024x1024 is 4,096
# image tokens behind 24 hash ids and the time token (4,121 > 4,096: the long side).
OMNI_HW = 1024
OMNI_REF_HW = 512
OMNI_SELF = (1, 24 + 1 + (OMNI_HW // 16) ** 2, 32, 96)


def phase_omnigen():
    """OmniGen-v1 at full width and depth, random bf16 weights from a seed (the VAE
    float32): (a) a 1024x1024 request, 2 steps, the condition cache on (two branches: a
    full forward each at the first step, a cached one after); (b) with one 512x512
    reference image ((a)'s image: 1,024 spliced tokens, three branches), 2 steps; finite
    (1024, 1024, 3) images and no kernel launch (head_dim 96: the plain attention); the
    forward, encode and decode seconds and the peaks. (c) one cached step of (b)'s text
    branch against the same step uncached, in bf16 and with the model converted to
    float32 (``_cached_vs_full``). Then the plain attention at the full forward's shape
    (1, 4,121, 32, 96)^2 beside SDPA and its bound."""
    from PIL import Image

    from goal_force_tpu_torch.models import omnigen as om
    from goal_force_tpu_torch.models import sd_vae as sv
    from goal_force_tpu_torch.ops import flash_attention as fa
    from goal_force_tpu_torch.pipelines import omnigen_image as op

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator("cuda").manual_seed(231)
    bf16, f32 = torch.bfloat16, torch.float32
    cfg = om.OmniGenConfig()

    def build():
        return (om.init_omnigen(cfg, gen, bf16, device="cuda"),
                sv.init_sd_vae(sv.SDVAEEncoder, sv.SD_VAE_ENCODER_PLAN, gen, f32, device="cuda",
                               latent_channels=4, quant=True),
                sv.init_sd_vae(sv.SDVAEDecoder, sv.SD_VAE_DECODER_PLAN, gen, f32, device="cuda",
                               latent_channels=4, quant=True))

    (tf, enc, dec), init_s = sync_time(build)
    count = lambda m: sum(p.numel() for p in m.parameters())
    log("omnigen", stage="init", seconds=init_s, transformer_params=count(tf),
        vae_params=count(enc) + count(dec), gib=torch.cuda.memory_allocated() / 2**30)
    pipe = op.OmniGenImagePipeline(transformer=tf, vae_encoder=enc, vae_decoder=dec, cfg=cfg,
                                   dtype=bf16)
    stages = {}
    _time_stages(pipe, stages, _encode="encode_s", _decode="decode_s")
    real = _time_stages(op, stages, omnigen_forward="forward_s")
    common = dict(height=OMNI_HW, width=OMNI_HW, num_inference_steps=2)
    launches, image, peaks = {}, None, []
    try:
        for name, forwards in (("a_t2i", 4), ("b_reference", 6)):
            stages.clear()
            kw = dict(seed=43)
            if name == "b_reference":
                small = np.asarray(Image.fromarray((image * 255).astype(np.uint8)).resize(
                    (OMNI_REF_HW, OMNI_REF_HW), Image.BICUBIC), np.float32) / 127.5 - 1.0
                kw["reference_images"] = [small]
                ref_image = small
            fa.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            out, secs = sync_time(lambda: pipe(FLUX_PROMPT, **kw, **common))
            launched = dict(fa.launch_counts)
            finite = bool(np.isfinite(out).all())
            log("omnigen", stage="request", request=name, seconds=secs, **stages,
                launches=launched, image_shape=list(out.shape), finite=finite,
                image_mean=float(out.mean()), image_std=float(out.std()),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)
            peaks.append(torch.cuda.max_memory_allocated() / 2**30)
            check(launched == only(), f"omnigen {name} launched {launched} (head_dim 96)")
            for key, n in launched.items():
                launches[key] = launches.get(key, 0) + n
            check(len(stages["forward_s"]) == forwards,
                  f"omnigen {name} ran {len(stages['forward_s'])} forwards")
            check(out.shape == (OMNI_HW, OMNI_HW, 3) and finite,
                  f"omnigen {name} image {out.shape}, finite {finite}")
            if image is None:
                image = out
    finally:
        for attr, fn in real.items():
            setattr(op, attr, fn)

    # (c) one cached step of (b)'s text branch (its 1,048-token prefix holds the
    # reference's span) against the same step uncached, in bf16 and on a float32 copy
    n_img = (OMNI_HW // 16) ** 2
    lat1, lat2 = (_rand((1, OMNI_HW // 8, OMNI_HW // 8, 4), gen, f32) for _ in range(2))
    t1, t2 = (torch.tensor([v], device="cuda") for v in (0.25, 0.75))
    outs = {}
    with torch.no_grad():
        for dtype in (bf16, f32):       # the float32 pass on the model converted in place
            p = dataclasses.replace(pipe, transformer=tf.to(dtype), dtype=dtype)
            full, cached = p._branches(FLUX_PROMPT, [ref_image], n_img)[0]
            args = lambda lat, t: (lat.to(dtype), t.to(dtype))
            _, kv = full(*args(lat1, t1), True)
            outs[dtype] = (sync_time(lambda: cached(*args(lat2, t2), kv)),
                           sync_time(lambda: full(*args(lat2, t2), False)),
                           kv[0][0].shape[1])
            del p, full, cached, kv
    ((got, cached_s), (ref, full_s), prefix), ((got32, _), (ref32, _), _) = outs[bf16], outs[f32]
    del outs
    _cached_vs_full("omnigen", "cached step vs uncached", got, ref, got32, ref32,
                    cached_seconds=cached_s, full_seconds=full_s, prefix_tokens=prefix)
    del pipe, tf, enc, dec, image, got, ref, got32, ref32
    gc.collect()
    torch.cuda.empty_cache()
    plain = _sd3_plain("self", OMNI_SELF, torch.Generator("cuda").manual_seed(232),
                       phase="omnigen")
    _phase_summary("omnigen", t0, launches, peaks)
    return launches, plain


def main() -> int:
    try:
        return _main()
    finally:
        _end_world()
        for thread, _, _ in _BACKGROUND:      # after a failure: the temporary files go too
            thread.join()


def started(phase, fn, *args):
    """fn(*args), its phase's start time logged first."""
    log(phase, stage="start")
    return fn(*args)


def _main() -> int:
    card = phase_device()
    build = started("build", start_build)
    started("vae38", phase_vae38)            # no kernel: on the card while nvcc runs
    cog_launches, cog_rec = started("cog", phase_cog)
    phase_build(build)
    measured = started("kernels", phase_kernels)
    ring_launches, ring_rec = started("ring", phase_ring, measured)
    pp_launches, pp_rec = started("pp", phase_pp)
    started("small", phase_small)
    started("small_train", phase_small_train)
    started("small_int8", phase_small_int8)
    small_s2v_launches = started("small_s2v", phase_small_s2v)
    small_hy_launches = started("small_hunyuan", phase_small_hunyuan)
    started("small_cog", phase_small_cog)
    small_sv_launches = started("small_stepvideo", phase_small_stepvideo)
    small_flux_launches = started("small_flux", phase_small_flux)
    small_sd3_launches = started("small_sd3", phase_small_sd3)
    small_qwen_launches = started("small_qwen_image", phase_small_qwen_image)
    small_nexus_launches = started("small_nexus_gen", phase_small_nexus_gen)
    started("small_hunyuan_dit", phase_small_hunyuan_dit)
    started("small_omnigen", phase_small_omnigen)
    pipe, main_launches, bf16_frames, main_stages = started("main", phase_main)
    sharded_launches = started("sharded", phase_sharded, pipe, bf16_frames[0], main_stages)
    started("tools", phase_tools)
    tc_launches = started("teacache", phase_teacache, pipe, bf16_frames[0])
    window_launches = started("window", phase_window, pipe, bf16_frames[0])
    cli_launches = started("cli", phase_cli, pipe)
    unb_launches = started("unbounded", phase_unbounded, pipe)
    variants_launches = started("variants", phase_variants, pipe, bf16_frames)
    int8_launches, sharded_int8_launches = started("main_int8", phase_main_int8, pipe,
                                                   bf16_frames)
    del pipe, bf16_frames
    t2v_vace_launches = started("t2v_vace", phase_t2v_vace)
    fun_control_launches = started("fun_control", phase_fun_control)
    s2v_launches, sharded_s2v_launches = started("s2v", phase_s2v)
    image_launches = started("image_branch", phase_image_branch)
    hy_launches, hy_rec, hy_models = started("hunyuan", phase_hunyuan)
    i2v_launches, i2v_rec = started("hunyuan_i2v", phase_hunyuan_i2v, hy_models)
    del hy_models
    sv_launches, sv_unbounded, sv_path = started("stepvideo", phase_stepvideo)
    flux_launches, flux_unbounded, flux_path = started("flux", phase_flux)
    nexus_launches, nexus_path = started("nexus_gen", phase_nexus_gen)
    sd3_launches, sd3_plain = started("sd3", phase_sd3)
    qwen_launches, qwen_unbounded, qwen_path = started("qwen_image", phase_qwen_image)
    hydit_launches, hydit_plain = started("hunyuan_dit", phase_hunyuan_dit)
    omni_launches, omni_plain = started("omnigen", phase_omnigen)
    train_launches, train_run = started("train", phase_train)
    sharded_train_launches = started("sharded_train", phase_sharded_train, train_run)
    del train_run
    train_cli_launches = started("train_cli", phase_train_cli)
    full_launches = started("full_int8", phase_full_int8)
    full_bf16_launches = started("full_bf16", phase_full_bf16)
    finish_background()
    fwd = "goal_force_tpu_torch/csrc/flash_attention.cu"
    train_src = "goal_force_tpu_torch/csrc/flash_attention_bwd.cu"
    int8_src = "goal_force_tpu_torch/csrc/flash_attention_int8.cu"
    tpu = "goal_force_tpu/ops/flash_attention.py"
    kernels = []
    for name, src, line, launches, extra in (
            ("K1 flash_attention_nomax", fwd, 241, main_launches["K1"],
             {"cross": measured["K1"]["cross"], "window_self": measured["K1"]["window_self"],
              "window_cross": measured["K1"]["window_cross"],
              "sharded_launches": sharded_launches["K1"],
              "teacache_launches": tc_launches["K1"], "window_launches": window_launches["K1"],
              "cli_launches": cli_launches["K1"],
              "full_bf16_launches": full_bf16_launches["K1"],
              **{k: measured["K1"][k] for k in ("ref_self", "ref_cross", "batch_self",
                                                "batch_cross")},
              "variants_launches": variants_launches["K1"],
              "pp_launches": pp_launches["K1"], "pp_serve_s": pp_rec["serve_s"],
              "pp_serve_run_blocks_s": pp_rec["serve_run_blocks_s"],
              "t2v_vace_launches": t2v_vace_launches["K1"],
              "fun_control_launches": fun_control_launches["K1"],
              "s2v_launches": s2v_launches["K1"], "small_s2v_launches": small_s2v_launches["K1"],
              "sharded_s2v_launches": sharded_s2v_launches["K1"],
              "image_branch_launches": image_launches["K1"],
              **{k: measured["K1"][k] for k in ("audio", "s2v_self", "s2v_cross",
                                                "image_cross")},
              "small_hunyuan_launches": small_hy_launches["K1"],
              "hunyuan_launches": hy_launches["K1"], "hunyuan_path": hy_rec["path"],
              "hunyuan_b2": hy_rec["b2"],
              "hunyuan_i2v_launches": i2v_launches["K1"], "hunyuan_i2v_path": i2v_rec,
              "cog_launches": cog_launches["K1"],
              "small_stepvideo_launches": small_sv_launches["K1"],
              "stepvideo_launches": sv_launches["K1"], "stepvideo_path": sv_path,
              "small_flux_launches": small_flux_launches["K1"],
              "flux_launches": flux_launches["K1"], "flux_path": flux_path,
              "small_sd3_launches": small_sd3_launches["K1"],
              "sd3_launches": sd3_launches["K1"], "sd3_plain_attention": sd3_plain,
              "small_qwen_image_launches": small_qwen_launches["K1"],
              "qwen_image_launches": qwen_launches["K1"], "qwen_image_path": qwen_path,
              "small_nexus_gen_launches": small_nexus_launches["K1"],
              "nexus_gen_launches": nexus_launches["K1"], "nexus_gen_path": nexus_path,
              "hunyuan_dit_launches": hydit_launches.get("K1", 0),
              "hunyuan_dit_plain_attention": hydit_plain,
              "omnigen_launches": omni_launches.get("K1", 0),
              "omnigen_plain_attention": omni_plain}),
            ("K2 flash_attention_max", fwd, 154, unb_launches["K2"],
             {"cross": measured["K2"]["cross"], "path": "unbounded (qk_bounded=False, q-norm x8)",
              "s2v_launches": s2v_launches["K2"],
              "sharded_s2v_launches": sharded_s2v_launches["K2"],
              **{k: measured["K2"][k] for k in ("audio", "s2v_self", "s2v_cross")},
              "small_stepvideo_launches": small_sv_launches["K2"],
              "stepvideo_launches": sv_unbounded["K2"],
              "small_flux_launches": small_flux_launches["K2"],
              "flux_launches": flux_launches["K2"] + flux_unbounded["K2"],
              "small_qwen_image_launches": small_qwen_launches["K2"],
              "qwen_image_launches": qwen_launches["K2"] + qwen_unbounded["K2"],
              "nexus_gen_launches": nexus_launches.get("K2", 0)}),
            ("K3 flash_attention_fwd_lse", train_src, 29, train_launches["K3"],
             {"cross": measured["K3"]["cross"], "path": "train",
              "train_cli_launches": train_cli_launches["K3"],
              "ring_launches": ring_launches["K3"],
              "ring_self_fwd_rank_ms": ring_rec["self"]["fwd_rank_ms"],
              "ring_cross_fwd_rank_ms": ring_rec["cross"]["fwd_rank_ms"],
              "ring_max_abs_err": {k: ring_rec[k]["max_abs_err"] for k in ("self", "cross")},
              "sharded_train_launches": sharded_train_launches["K3"],
              "pp_launches": pp_launches["K3"], "pp_train_s": pp_rec["train_s"],
              "pp_train_run_blocks_s": pp_rec["train_run_blocks_s"],
              "pp_train_max_abs_err": pp_rec["train_max_abs_err"]}),
            ("K4 flash_attention_bwd_dkv", train_src, 76, train_launches["K4"],
             {"cross": measured["K4"]["cross"], "path": "train",
              "train_cli_launches": train_cli_launches["K4"],
              "ring_launches": ring_launches["K4"], "ring_bwd_rank_ms": ring_rec["bwd_rank_ms"],
              "ring_bwd_max_abs_err": ring_rec["bwd_err"],
              "sharded_train_launches": sharded_train_launches["K4"],
              "pp_launches": pp_launches["K4"]}),
            ("K5 flash_attention_bwd_dq", train_src, 118, train_launches["K5"],
             {"cross": measured["K5"]["cross"], "path": "train",
              "train_cli_launches": train_cli_launches["K5"],
              "ring_launches": ring_launches["K5"],
              "sharded_train_launches": sharded_train_launches["K5"],
              "pp_launches": pp_launches["K5"]}),
            ("K6 flash_attention_int8", int8_src, 581, int8_launches["K6"],
             {"cross": measured["K6"]["cross"], "path": "main_int8",
              "full_int8_launches": full_launches["K6"],
              "sharded_int8_launches": sharded_int8_launches["K6"]})):
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
