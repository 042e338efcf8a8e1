"""The denoiser forward: DiT + ControlNet side stack + conditioning.

Port of the main-path branches of ``goal_force_tpu/pipelines/model_fn.py::
denoise_forward``: time embed -> text embed -> y concat -> patchify -> RoPE ->
ControlNet injections -> blocks with per-block injection -> head -> unpatchify.
"""

from __future__ import annotations

from typing import Optional

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
) -> torch.Tensor:
    """Velocity prediction (B, F, H, W, out_dim). remat: recompute every DiT and
    ControlNet block in the backward pass (the training path)."""
    t, t_mod = time_embed(dit, dit_cfg, timestep)
    ctx = text_embed(dit, context)
    x = latents
    if y is not None:
        x = torch.cat([x, y.to(x.dtype)], dim=-1)
    tokens, grid = patchify(dit.patch_embedding, x, dit_cfg.patch_size)
    cos, sin = rope_for_grid(dit_cfg, grid, tokens.device)

    inj = None
    if controlnet is not None and control_latents is not None:
        if controlnet_cfg is not None and controlnet_cfg.stride is not None:
            raise NotImplementedError("strided ControlNet injection is not ported yet")
        inj = controlnet_injections(controlnet, dit_cfg, control_latents.to(tokens.dtype),
                                    ctx, t_mod, cos, sin, attn_impl=attn_impl, remat=remat)
    tokens = run_blocks(dit.blocks, tokens, ctx, t_mod, cos, sin, dit_cfg,
                        injections=inj, attn_impl=attn_impl, remat=remat)
    del inj
    out = head(dit.head, tokens, t, dit_cfg.eps)
    return unpatchify(out, grid, dit_cfg.patch_size, dit_cfg.out_dim)
