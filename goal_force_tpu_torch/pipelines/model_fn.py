"""The denoiser forward: DiT + ControlNet side stack + conditioning.

Port of the main-path branches of ``goal_force_tpu/pipelines/model_fn.py``:

- ``denoise_forward``: time embed -> text embed -> y concat -> patchify -> RoPE ->
  ControlNet injections -> blocks with per-block injection -> head -> unpatchify; with
  ``return_token_states`` also the tokens before and after the blocks (TeaCache's pair);
- ``denoise_forward_skip``: TeaCache's skip path (patchify, add the cached residual,
  head, unpatchify);
- ``temporal_tiled_forward``: sliding windows over the latent frames, blended with
  linear ramps. Each window runs the ControlNet on its slice of the control latents, as
  the JAX package does (the original tiler drops the ControlNet inside windows).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from goal_force_tpu_torch.configs import ControlNetConfig, WanDiTConfig
from goal_force_tpu_torch.models.controlnet import GoalForceControlNet, controlnet_injections
from goal_force_tpu_torch.models.wan_dit import (
    WanDiT,
    head,
    patchify,
    rope_for_grid,
    run_blocks,
    text_embed,
    time_embed,
    unpatchify,
)


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
):
    """Velocity prediction (B, F, H, W, out_dim). remat: recompute every DiT and
    ControlNet block in the backward pass (the training path).

    return_token_states: return ``(v, (tokens_pre, tokens_post))``, the tokens after
    patchify and after the blocks (with their ControlNet injections), TeaCache's pair.
    block_weights: ``block_weights(i, block)`` gives what runs in place of DiT block i
    (LoRA merges its adapters there, inside the block's remat region, so only one
    block's merged weights live at a time)."""
    t, t_mod = time_embed(dit, dit_cfg, timestep)
    ctx = text_embed(dit, context)
    x = latents
    if y is not None:
        x = torch.cat([x, y.to(x.dtype)], dim=-1)
    tokens, grid = patchify(dit.patch_embedding, x, dit_cfg.patch_size)
    tokens_pre = tokens if return_token_states else None
    cos, sin = rope_for_grid(dit_cfg, grid, tokens.device)

    inj = None
    if controlnet is not None and control_latents is not None:
        if controlnet_cfg is not None and controlnet_cfg.stride is not None:
            raise NotImplementedError("strided ControlNet injection is not ported yet")
        inj = controlnet_injections(controlnet, dit_cfg, control_latents.to(tokens.dtype),
                                    ctx, t_mod, cos, sin, attn_impl=attn_impl, remat=remat)
    tokens = run_blocks(dit.blocks, tokens, ctx, t_mod, cos, sin, dit_cfg,
                        injections=inj, attn_impl=attn_impl, remat=remat,
                        block_weights=block_weights)
    del inj
    out = head(dit.head, tokens, t, dit_cfg.eps)
    out = unpatchify(out, grid, dit_cfg.patch_size, dit_cfg.out_dim)
    if return_token_states:
        return out, (tokens_pre, tokens)
    return out


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
