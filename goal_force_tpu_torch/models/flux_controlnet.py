"""The Flux ControlNet: a short Flux MMDiT that emits per-block residuals.

Port of ``goal_force_tpu/models/flux_controlnet.py``: the trunk runs the Flux joint and
single blocks of ``models/flux_dit.py``; the control image's latents are patchified and
added to the x embedding through ``controlnet_x_embedder``; with a mode embedder (the
Union ControlNet) one mode token is prepended to the text stream (at 1024² the joint
sequence is then 1 + 512 + 4,096 = 4,609 tokens); each block feeds a zero-initialised
linear whose output is its residual, and the short stacks are repeated over intervals to
the paired DiT's block counts (``align_res_stack``). The DiT adds them in
``flux_dit_forward(controlnet_res=, controlnet_single_res=)``.

``FluxControlNet`` holds the parameters under the reference names: the trunk's (see
``models/flux_dit.py``, no head), ``controlnet_x_embedder``, ``controlnet_blocks.{i}``,
``controlnet_single_blocks.{i}`` and ``controlnet_mode_embedder.weight``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from goal_force_tpu_torch.configs import FluxDiTConfig
from goal_force_tpu_torch.models.flux_dit import (
    FluxTrunk,
    _tables,
    flux_rope_tables,
    init_flux_trunk_,
    joint_block,
    patchify2d,
    single_block,
    time_cond,
)
from goal_force_tpu_torch.models.wan_dit import empty_module, linear


@dataclasses.dataclass(frozen=True)
class FluxControlNetConfig:
    dit: FluxDiTConfig
    num_joint_blocks: int = 5
    num_single_blocks: int = 10
    num_mode: int = 0
    additional_input_dim: int = 0


class FluxControlNet(FluxTrunk):
    def __init__(self, cfg: FluxControlNetConfig):
        d = cfg.dit
        super().__init__(d, cfg.num_joint_blocks, cfg.num_single_blocks)
        self.controlnet_x_embedder = nn.Linear(d.in_dim + cfg.additional_input_dim, d.dim)
        self.controlnet_blocks = nn.ModuleList(nn.Linear(d.dim, d.dim)
                                               for _ in range(cfg.num_joint_blocks))
        self.controlnet_single_blocks = nn.ModuleList(nn.Linear(d.dim, d.dim)
                                                      for _ in range(cfg.num_single_blocks))
        if cfg.num_mode:
            self.controlnet_mode_embedder = nn.Embedding(cfg.num_mode, d.dim)


def align_res_stack(res_list: Sequence[torch.Tensor], num_blocks: int) -> Optional[torch.Tensor]:
    """Each entry repeated over an interval of ceil(num_blocks / len) blocks: a stacked
    (num_blocks, B, S, D) tensor, or None for an empty list."""
    if not res_list:
        return None
    interval = (num_blocks + len(res_list) - 1) // len(res_list)
    return torch.stack([res_list[i // interval] for i in range(num_blocks)])


def flux_controlnet_forward(
    model: FluxControlNet,
    cfg: FluxControlNetConfig,
    latents: torch.Tensor,            # (B, H, W, 16) channels-last
    cond_latents: torch.Tensor,       # (B, H, W, 16 + extra / 4) control image latents
    timestep: torch.Tensor,
    prompt_emb: torch.Tensor,
    pooled_prompt_emb: torch.Tensor,
    guidance: Optional[torch.Tensor] = None,
    mode_id: Optional[int] = None,
    attn_impl: str = "auto",
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(joint residuals (num_joint of the DiT, B, S_img, D) or None, single residuals
    (num_single of the DiT, ...) or None), aligned to the paired DiT's block counts."""
    d = cfg.dit
    b, h, w, _ = latents.shape
    temb = time_cond(model, d, timestep, pooled_prompt_emb, guidance)
    x = linear(model.x_embedder, patchify2d(latents))
    x = x + linear(model.controlnet_x_embedder, patchify2d(cond_latents))
    txt = linear(model.context_embedder, prompt_emb.to(x.dtype))
    if mode_id is not None and hasattr(model, "controlnet_mode_embedder"):
        tok = model.controlnet_mode_embedder.weight[mode_id].to(txt.dtype)
        txt = torch.cat([tok.expand(b, 1, d.dim), txt], dim=1)
    t_len = txt.shape[1]
    cos, sin = _tables(*flux_rope_tables(t_len, h // 2, w // 2, tuple(d.axes_dim),
                                         d.rope_theta), x.device)
    joint_res = []
    for blk, zl in zip(model.blocks, model.controlnet_blocks):
        x, txt = joint_block(blk, x, txt, temb, cos, sin, d, attn_impl)
        joint_res.append(linear(zl, x))
    single_res = []
    merged = torch.cat([txt, x], dim=1)
    for blk, zl in zip(model.single_blocks, model.controlnet_single_blocks):
        merged = single_block(blk, merged, temb, cos, sin, d, attn_impl)
        single_res.append(linear(zl, merged[:, t_len:]))
    return (align_res_stack(joint_res, d.num_joint_blocks),
            align_res_stack(single_res, d.num_single_blocks))


@torch.no_grad()
def init_flux_controlnet(cfg: FluxControlNetConfig, gen: torch.Generator,
                         dtype=torch.bfloat16, *, device) -> FluxControlNet:
    """Random weights from `gen` (the trunk as ``init_flux_dit``), the residual linears
    at zero (JAX's init) and the mode embeddings N(0, 1)."""
    model = init_flux_trunk_(empty_module(FluxControlNet, cfg, dtype=dtype, device=device), gen)
    for zl in (*model.controlnet_blocks, *model.controlnet_single_blocks):
        zl.weight.zero_()
        zl.bias.zero_()
    if cfg.num_mode:
        model.controlnet_mode_embedder.weight.normal_(generator=gen)
    return model
