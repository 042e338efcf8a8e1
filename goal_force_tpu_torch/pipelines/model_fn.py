"""The denoiser forward: DiT + ControlNet side stack + conditioning.

Port of ``goal_force_tpu/pipelines/model_fn.py``:

- ``denoise_forward``: time embed (+ the motion controller's offset) -> text embed -> y
  concat -> patchify (+ camera tokens, Fun-Reference tokens in front) -> RoPE ->
  ControlNet injections -> blocks with per-block injection (or strided raw states, or
  VACE hints, segment by segment) -> head -> unpatchify; with ``return_token_states``
  also the tokens before and after the blocks (TeaCache's pair);
- ``denoise_forward_skip``: TeaCache's skip path (patchify, add the cached residual,
  head, unpatchify);
- ``temporal_tiled_forward``: sliding windows over the latent frames, blended with
  linear ramps. Each window runs the ControlNet on its slice of the control latents, as
  the JAX package does (the original tiler drops the ControlNet inside windows).

Under a mesh (``parallel/mesh.py::use_mesh``) ``denoise_forward`` splits the batch over
"dp" (where the axis divides it) and the patch tokens over "sp" after the patch
embedding (padded to a multiple of the axis), hands each rank its rows of the RoPE
tables, and gathers tokens and batch before the head: every rank returns the whole
output, equal to the unsharded one. With ``rows_split`` (the training step) the caller
has split the batch over "dp" already and each rank keeps its rows. Where a module is
FSDP-placed (``parallel/fsdp.py``) its whole weights are gathered where they are used:
the DiT's embeddings before the blocks and its head after them, each block inside its
checkpoint. With ``pp_microbatches`` the trunk runs in JAX's GPipe schedule over the
mesh's "pp" axis (``models/wan_dit.py::pp_run_blocks``); on a mesh whose "pp" exceeds 1
it must be given, as the blocks then live on their stages.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from goal_force_tpu_torch.configs import ControlNetConfig, WanDiTConfig
from goal_force_tpu_torch.models.adapters import Vace, vace_hints
from goal_force_tpu_torch.models.controlnet import GoalForceControlNet, controlnet_injections
from goal_force_tpu_torch.models.wan_dit import (
    WanDiT,
    head,
    patchify,
    pp_run_blocks,
    reference_tokens,
    rope_for_grid,
    run_blocks,
    text_embed,
    time_embed,
    unpatchify,
)
from goal_force_tpu_torch.parallel import collectives as col
from goal_force_tpu_torch.parallel import fsdp
from goal_force_tpu_torch.parallel.mesh import axis_size, current_mesh


def denoise_forward(
    dit: WanDiT,
    dit_cfg: WanDiTConfig,
    latents: torch.Tensor,            # (B, F, H, W, z)
    timestep: torch.Tensor,           # (B,)
    context: torch.Tensor,            # (B, L_txt, text_dim)
    y: Optional[torch.Tensor] = None,  # (B, F, H, W, 4 + z)
    controlnet: Optional[GoalForceControlNet] = None,
    controlnet_cfg: Optional[ControlNetConfig] = None,
    control_latents: Optional[torch.Tensor] = None,  # (B, F, H, W, z)
    attn_impl: str = "auto",
    remat: bool = False,
    return_token_states: bool = False,
    block_weights: Optional[Callable] = None,
    t_mod_offset: Optional[torch.Tensor] = None,      # motion controller (B, 6, D)
    vace: Optional[Vace] = None,
    vace_context: Optional[torch.Tensor] = None,      # (B, F, H, W, vace_in_dim)
    vace_scale: float = 1.0,
    vace_layers: Sequence[int] = (),
    reference_latents: Optional[torch.Tensor] = None,  # (B, h, w, z) Fun-Reference
    camera_embedding: Optional[torch.Tensor] = None,   # (B, S, D) camera adapter tokens
    rows_split: bool = False,
    pp_microbatches: Optional[int] = None,
):
    """Velocity prediction (B, F, H, W, out_dim). remat: recompute every DiT and
    ControlNet block in the backward pass (the training path).

    return_token_states: return ``(v, (tokens_pre, tokens_post))``, the tokens after
    patchify and after the blocks (with their ControlNet injections), TeaCache's pair.
    block_weights: ``block_weights(i, block)`` gives what runs in place of DiT block i
    (LoRA merges its adapters there, inside the block's remat region, so only one
    block's merged weights live at a time); segmented runs keep i global.

    The adapters' conditionings, as in JAX: t_mod_offset shifts t_mod; camera_embedding
    is added to the patch tokens; reference_latents go through the DiT's ref_conv and
    are prepended as tokens (the RoPE grid gains one frame) and stripped before the
    head; with a strided ControlNet (controlnet_cfg.stride = s) the side stack's raw
    states are added after blocks 0, s, 2s, ...; VACE hints are added after the blocks
    of vace_layers, scaled by vace_scale. Fun-Reference and VACE each refuse the
    goal-force ControlNet.

    rows_split: under a mesh, the inputs are this rank's rows of the batch already (split
    over "dp" by the caller), and so is the output.

    pp_microbatches: run the block trunk pipeline-parallel in this many microbatches
    (``pp_run_blocks``: over the ambient mesh's "pp" axis, ``run_blocks`` where it has
    none). As in JAX it refuses the strided ControlNet and VACE, which run the trunk in
    segments."""
    use_cn = controlnet is not None and control_latents is not None
    if pp_microbatches and ((use_cn and controlnet_cfg is not None
                             and controlnet_cfg.stride is not None) or vace is not None):
        raise NotImplementedError(
            "pp_microbatches cannot be combined with strided-ControlNet or "
            "VACE segmented execution; shard without a pp axis for these modes")
    if not pp_microbatches and axis_size("pp") > 1:
        raise ValueError("on a mesh with a \"pp\" axis the trunk runs pipelined: pass "
                         "pp_microbatches (the blocks live on their stages)")
    mesh = current_mesh()
    dp_split = (mesh is not None and not rows_split
                and latents.shape[0] % axis_size("dp") == 0)
    if dp_split:
        latents, timestep, context, y, control_latents, t_mod_offset, reference_latents, \
            camera_embedding, vace_context = (col.split_batch(u) for u in (
                latents, timestep, context, y, control_latents, t_mod_offset,
                reference_latents, camera_embedding, vace_context))
    blocks, head_ = dit.blocks, dit.head
    dit = fsdp.gathered(dit, skip=("blocks", "head"))      # the embeddings, until the blocks
    t, t_mod = time_embed(dit, dit_cfg, timestep)
    if t_mod_offset is not None:
        t_mod = t_mod + t_mod_offset.to(t_mod.dtype)
    ctx = text_embed(dit, context)
    x = latents
    if y is not None:
        x = torch.cat([x, y.to(x.dtype)], dim=-1)
    tokens, grid = patchify(dit.patch_embedding, x, dit_cfg.patch_size)
    if camera_embedding is not None:
        tokens = tokens + camera_embedding.to(tokens.dtype)
    tokens_pre = tokens if return_token_states else None
    n_ref = 0
    rope_grid = grid
    if reference_latents is not None:
        if not hasattr(dit, "ref_conv"):
            raise ValueError("reference_latents requires a DiT with ref_conv weights "
                             "(Fun-Reference checkpoints)")
        if use_cn:
            raise NotImplementedError(
                "Fun-Reference tokens cannot combine with the goal-force ControlNet: the "
                "side-stack states cover only the video tokens")
        ref = reference_tokens(dit.ref_conv, reference_latents.to(dit.ref_conv.weight.dtype))
        n_ref = ref.shape[1]
        tokens = torch.cat([ref.to(tokens.dtype), tokens], dim=1)
        rope_grid = (grid[0] + 1, grid[1], grid[2])
    cos, sin = rope_for_grid(dit_cfg, rope_grid, tokens.device)
    n_tokens = tokens.shape[1]
    if mesh is not None:
        tokens, cos, sin = (col.split_seq(u, dim) for u, dim in ((tokens, 1), (cos, 0), (sin, 0)))
    with col.sequence_split(n_tokens):
        del dit
        tokens = _blocks(blocks, dit_cfg, tokens, ctx, t_mod, cos, sin, controlnet,
                         controlnet_cfg, control_latents, use_cn, attn_impl, remat,
                         block_weights, vace, vace_context, vace_scale, vace_layers,
                         pp_microbatches)
    if mesh is not None:
        tokens = col.gather_seq(tokens, n_tokens)
    if n_ref:
        tokens = tokens[:, n_ref:]
    out = head(fsdp.gathered(head_), tokens, t, dit_cfg.eps)
    out = unpatchify(out, grid, dit_cfg.patch_size, dit_cfg.out_dim)
    gather = col.gather_batch if dp_split else (lambda u: u)
    if return_token_states:
        return gather(out), (gather(tokens_pre), gather(tokens))
    return gather(out)


def _blocks(blocks, dit_cfg, tokens, ctx, t_mod, cos, sin, controlnet, controlnet_cfg,
            control_latents, use_cn, attn_impl, remat, block_weights, vace, vace_context,
            vace_scale, vace_layers, pp_microbatches):
    """The block stack with the ControlNet's injections (or its strided raw states, or
    VACE hints), pipelined with pp_microbatches."""
    stride = controlnet_cfg.stride if (use_cn and controlnet_cfg is not None) else None
    inj = None
    if use_cn:
        inj = controlnet_injections(controlnet, dit_cfg, control_latents.to(tokens.dtype),
                                    ctx, t_mod, cos, sin, attn_impl=attn_impl, remat=remat,
                                    apply_zero_convs=stride is None)
    run = partial(run_blocks, blocks, context=ctx, t_mod=t_mod, cos=cos, sin=sin,
                  cfg=dit_cfg, attn_impl=attn_impl, remat=remat, block_weights=block_weights)
    n_layers = dit_cfg.num_layers
    if stride is not None:
        # Raw states after blocks 0, stride, 2 * stride, ...; the last segment runs to the
        # end whatever the stride.
        pos = 0
        for i, state in enumerate(inj):
            stop = min(pos + 1, n_layers)
            tokens = run(tokens, start=pos, stop=stop) + state.to(tokens.dtype)
            pos = stop
            nxt = min(pos + stride - 1, n_layers) if i + 1 < len(inj) else n_layers
            if nxt > pos:
                tokens = run(tokens, start=pos, stop=nxt)
                pos = nxt
    elif vace is not None and vace_context is not None:
        if use_cn:
            raise NotImplementedError("VACE and goal-force ControlNet cannot be combined")
        # the hint blocks take the default attention, as JAX's vace_hints does
        hints = vace_hints(vace, dit_cfg, tokens, vace_context.to(tokens.dtype), ctx, t_mod,
                           cos, sin)
        pos = 0
        for hint, layer in zip(hints, vace_layers):
            tokens = run(tokens, start=pos, stop=min(layer + 1, n_layers))
            tokens = tokens + hint.to(tokens.dtype) * vace_scale
            pos = layer + 1
        if pos < n_layers:
            tokens = run(tokens, start=pos)
    elif pp_microbatches:
        tokens = pp_run_blocks(blocks, tokens, ctx, t_mod, cos, sin, dit_cfg,
                               n_micro=pp_microbatches, injections=inj, remat=remat,
                               attn_impl=attn_impl, block_weights=block_weights)
    else:
        tokens = run(tokens, injections=inj)
    return tokens


def denoise_forward_skip(
    dit: WanDiT,
    dit_cfg: WanDiTConfig,
    latents: torch.Tensor,
    timestep: torch.Tensor,
    y: Optional[torch.Tensor],
    residual: torch.Tensor,          # (B, S, D): tokens after the blocks minus before
) -> torch.Tensor:
    """TeaCache's skip path: patchify, add the cached block-stack residual, head,
    unpatchify."""
    t, _ = time_embed(dit, dit_cfg, timestep)
    x = latents
    if y is not None:
        x = torch.cat([x, y.to(x.dtype)], dim=-1)
    tokens, grid = patchify(dit.patch_embedding, x, dit_cfg.patch_size)
    tokens = tokens + residual.to(tokens.dtype)
    out = head(dit.head, tokens, t, dit_cfg.eps)
    return unpatchify(out, grid, dit_cfg.patch_size, dit_cfg.out_dim)


def temporal_tiled_forward(
    model_fn,
    latents: torch.Tensor,            # (B, F, H, W, C)
    y: Optional[torch.Tensor],
    window: int,
    stride: int,
    control_latents: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sliding-window denoising over latent frames with linear blend masks.

    Windows start every `stride` frames; one is skipped once the previous window
    already reached the last frame. Where windows overlap (border = window - stride
    frames), a window's mask ramps as (i + 0.5) / border at each side that is not the
    sequence's end. model_fn(latents_w, y_w, control_w) gets each window's slices; the
    outputs are summed in float32 under their masks and divided by the summed masks."""
    f = latents.shape[1]
    border = window - stride
    value = torch.zeros(latents.shape, dtype=torch.float32, device=latents.device)
    weight = np.zeros((1, f, 1, 1, 1), np.float32)
    for t0 in range(0, f, stride):
        if t0 - stride >= 0 and t0 - stride + window >= f:
            continue
        t1 = min(t0 + window, f)
        out = model_fn(latents[:, t0:t1], None if y is None else y[:, t0:t1],
                       None if control_latents is None else control_latents[:, t0:t1])
        n = t1 - t0
        mask = np.ones((n,), np.float32)
        if border > 0:
            ramp = (np.arange(border) + 0.5) / border
            if t0 != 0:
                mask[:border] = ramp
            if t1 != f:
                mask[-border:] = ramp[::-1]
        m = torch.from_numpy(mask).to(latents.device).reshape(1, n, 1, 1, 1)
        value[:, t0:t1] += out.float() * m
        weight[:, t0:t1] += mask.reshape(1, n, 1, 1, 1)
    return (value / torch.from_numpy(weight).to(latents.device)).to(latents.dtype)
