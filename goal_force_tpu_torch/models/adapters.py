"""Wan adapter models: the motion controller, VACE editing hints, camera control.

Port of ``goal_force_tpu/models/adapters.py``. Modules hold the reference's keys:

- ``MotionController``: ``linear.0/2/4``, a 3-layer SiLU MLP over the sinusoidal
  embedding of ``motion_bucket_id * 10``; its output offsets the DiT's t_mod (6 x dim).
- ``Vace``: ``vace_blocks.{i}`` (DiT blocks; ``before_proj`` on block 0, ``after_proj``
  on each) and ``vace_patch_embedding`` (Conv3d over the VACE context). ``vace_hints``
  runs the hint stack; hint i is added after DiT block ``vace_layers[i]``, scaled by
  ``vace_scale`` (``apply_vace_hints``).
- ``plucker_rays`` and ``camera_adapter_apply``: per-pixel Plücker rays from explicit
  extrinsics, and a 2-D patch projection of a camera embedding to per-token features.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from goal_force_tpu_torch.configs import WanDiTConfig
from goal_force_tpu_torch.models.wan_dit import (
    Activation,
    WanBlock,
    dit_block,
    empty_module,
    init_block_,
    init_linear_,
    init_patch_embedding_,
    linear,
    patchify,
    silu_f32,
    sinusoidal_embedding,
)

# ---------------------------------------------------------------------------
# Motion controller
# ---------------------------------------------------------------------------


class MotionController(nn.Module):
    def __init__(self, freq_dim: int = 256, dim: int = 1536):
        super().__init__()
        self.linear = nn.Sequential(nn.Linear(freq_dim, dim), Activation(), nn.Linear(dim, dim),
                                    Activation(), nn.Linear(dim, dim * 6))


def motion_controller_apply(mc: MotionController, motion_bucket_id: torch.Tensor) -> torch.Tensor:
    """motion_bucket_id (B,) -> (B, 6 * dim) t_mod offset."""
    emb = sinusoidal_embedding(mc.linear[0].weight.shape[1], motion_bucket_id * 10)
    emb = emb.to(mc.linear[0].weight.dtype)
    h = silu_f32(linear(mc.linear[0], emb))
    h = silu_f32(linear(mc.linear[2], h))
    return linear(mc.linear[4], h)


@torch.no_grad()
def init_motion_controller(gen: torch.Generator, freq_dim: int = 256, dim: int = 1536,
                           dtype=torch.float32, *, device) -> MotionController:
    """Uniform +-1/sqrt(fan_in) linears with zero biases; the last layer is zero, as the
    reference initialises it."""
    mc = empty_module(MotionController, freq_dim, dim, dtype=dtype, device=device)
    for i in (0, 2, 4):
        init_linear_(mc.linear[i], gen)
    mc.linear[4].weight.zero_()
    return mc.eval().requires_grad_(False)


# ---------------------------------------------------------------------------
# VACE
# ---------------------------------------------------------------------------

VACE_LAYERS_14B = (0, 5, 10, 15, 20, 25, 30, 35)
VACE_LAYERS_1_3B = (0, 2, 4, 6, 8, 10, 12, 14, 16, 18, 20, 22, 24, 26, 28)


class VaceBlock(WanBlock):
    def __init__(self, cfg: WanDiTConfig, first: bool):
        super().__init__(cfg)
        if first:
            self.before_proj = nn.Linear(cfg.dim, cfg.dim)
        self.after_proj = nn.Linear(cfg.dim, cfg.dim)


class Vace(nn.Module):
    def __init__(self, cfg: WanDiTConfig, num_layers: int, vace_in_dim: int = 96):
        super().__init__()
        self.vace_blocks = nn.ModuleList(VaceBlock(cfg, i == 0) for i in range(num_layers))
        self.vace_patch_embedding = nn.Conv3d(vace_in_dim, cfg.dim, cfg.patch_size,
                                              cfg.patch_size)


def vace_hints(vace: Vace, dit_cfg: WanDiTConfig, x_tokens: torch.Tensor,
               vace_context: torch.Tensor, context, t_mod, cos, sin,
               attn_impl: str = "auto") -> List[torch.Tensor]:
    """The hints, one (B, S, D) per VACE block, for main-stack tokens x_tokens (B, S, D)
    and the channels-last context (B, F, H, W, vace_in_dim); a context of fewer tokens
    is zero-padded to S."""
    c, _ = patchify(vace.vace_patch_embedding, vace_context, dit_cfg.patch_size)
    if c.shape[1] < x_tokens.shape[1]:
        c = torch.cat([c, c.new_zeros(c.shape[0], x_tokens.shape[1] - c.shape[1], c.shape[2])],
                      dim=1)
    hints = []
    for i, blk in enumerate(vace.vace_blocks):
        if i == 0:
            c = linear(blk.before_proj, c) + x_tokens
        c = dit_block(blk, c, context, t_mod, cos, sin, dit_cfg, attn_impl)
        hints.append(linear(blk.after_proj, c))
    return hints


def apply_vace_hints(block_id: int, x, hints, vace_layers: Sequence[int], scale: float):
    """x plus the hint of block_id's VACE layer (scaled), or x where it has none."""
    mapping = {layer: n for n, layer in enumerate(vace_layers)}
    if block_id in mapping:
        return x + hints[mapping[block_id]].to(x.dtype) * scale
    return x


@torch.no_grad()
def init_vace(dit_cfg: WanDiTConfig, gen: torch.Generator,
              vace_layers: Sequence[int] = VACE_LAYERS_14B, vace_in_dim: int = 96,
              dtype=torch.float32, *, device) -> Vace:
    """The JAX init's distributions: DiT blocks as ``init_block_``, a uniform patch
    embedding, uniform +-1/sqrt(dim) projections, zero biases."""
    vace = empty_module(Vace, dit_cfg, len(vace_layers), vace_in_dim, dtype=dtype,
                        device=device)
    for blk in vace.vace_blocks:
        init_block_(blk, gen)
    init_patch_embedding_(vace.vace_patch_embedding, gen)
    init_linear_(vace.vace_blocks[0].before_proj, gen)
    for blk in vace.vace_blocks:
        init_linear_(blk.after_proj, gen)
    return vace.eval().requires_grad_(False)


# ---------------------------------------------------------------------------
# Camera control (Plücker rays + 2-D patch projection)
# ---------------------------------------------------------------------------

def plucker_rays(extrinsics: np.ndarray, fx, fy, cx, cy, height: int, width: int) -> np.ndarray:
    """Per-pixel Plücker embedding (o x d, d) of camera-to-world poses (F, 4, 4) with
    normalised intrinsics -> (F, H, W, 6) float32."""
    j, i = np.meshgrid(np.arange(height, dtype=np.float64),
                       np.arange(width, dtype=np.float64), indexing="ij")
    dirs = np.stack([(i + 0.5 - cx * width) / (fx * width),
                     (j + 0.5 - cy * height) / (fy * height), np.ones_like(i)], -1)
    out = np.zeros((extrinsics.shape[0], height, width, 6), np.float32)
    for t, c2w in enumerate(extrinsics):
        d = dirs @ c2w[:3, :3].T
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        o = np.broadcast_to(c2w[:3, 3], d.shape)
        out[t] = np.concatenate([np.cross(o, d), d], -1)
    return out


def camera_adapter_apply(layer: nn.Linear, control_camera_latents: torch.Tensor,
                         patch_hw: Tuple[int, int] = (2, 2)) -> torch.Tensor:
    """(B, F, H, W, C) camera embedding -> per-token features (B, F*H*W/(ph*pw), D): each
    ph x pw patch flattened in (c, dy, dx) order through `layer`."""
    b, f, hh, ww, c = control_camera_latents.shape
    ph, pw = patch_hw
    x = control_camera_latents.reshape(b, f, hh // ph, ph, ww // pw, pw, c)
    x = x.permute(0, 1, 2, 4, 6, 3, 5).reshape(b, f * (hh // ph) * (ww // pw), c * ph * pw)
    return linear(layer, x)


def vace_from_state_dict(sd, dit_cfg: WanDiTConfig, num_layers: int, dtype=torch.float32,
                         *, device) -> Vace:
    """A Vace of `num_layers` blocks loaded strictly from the ``vace_*`` keys of a
    reference-format state dict (a VACE checkpoint may carry the DiT's keys beside them,
    which are not read)."""
    from goal_force_tpu_torch.pipelines.goal_force import load_state_dict_strict

    sd = {k: v for k, v in sd.items()
          if k.startswith(("vace_blocks.", "vace_patch_embedding."))}
    in_dim = sd["vace_patch_embedding.weight"].shape[1]
    vace = empty_module(Vace, dit_cfg, num_layers, in_dim, dtype=dtype, device=device)
    load_state_dict_strict(vace, sd, "VACE")
    return vace.eval().requires_grad_(False)


def motion_controller_from_state_dict(sd, dtype=torch.float32, *, device) -> MotionController:
    from goal_force_tpu_torch.pipelines.goal_force import load_state_dict_strict

    freq_dim, dim = sd["linear.0.weight"].shape[1], sd["linear.0.weight"].shape[0]
    mc = empty_module(MotionController, freq_dim, dim, dtype=dtype, device=device)
    load_state_dict_strict(mc, sd, "motion controller")
    return mc.eval().requires_grad_(False)
