"""Force/mass ControlNet: patch embedding + N DiT-block copies + zero-init 1x1 convs.

Port of ``goal_force_tpu/models/controlnet.py``. Parameter names follow the goal-force
ControlNet checkpoint after its ``pipe.controlnet.`` prefix is stripped:
``controlnet_patch_embedding.patch_embedding.*``, ``controlnet_dit.blocks.{i}.*`` and
``controlnet_zero_convs_after.{i}.*`` (Conv1d, kernel 1).
"""

from __future__ import annotations

import copy
from typing import List

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from goal_force_tpu_torch.configs import ControlNetConfig, WanDiTConfig
from goal_force_tpu_torch.models.wan_dit import (
    WanBlock,
    dit_block,
    empty_module,
    init_patch_embedding_,
    patchify,
)
from goal_force_tpu_torch.parallel import collectives as col
from goal_force_tpu_torch.parallel import fsdp
from goal_force_tpu_torch.parallel.mesh import current_mesh


class _PatchEmbedding(nn.Module):
    def __init__(self, dit_cfg: WanDiTConfig, in_channels: int):
        super().__init__()
        self.patch_embedding = nn.Conv3d(in_channels, dit_cfg.dim, dit_cfg.patch_size,
                                         dit_cfg.patch_size)


class _Blocks(nn.Module):
    def __init__(self, dit_cfg: WanDiTConfig, num_layers: int):
        super().__init__()
        self.blocks = nn.ModuleList(WanBlock(dit_cfg) for _ in range(num_layers))


class GoalForceControlNet(nn.Module):
    def __init__(self, dit_cfg: WanDiTConfig, cfg: ControlNetConfig):
        super().__init__()
        self.cfg = cfg
        self.controlnet_patch_embedding = _PatchEmbedding(dit_cfg, cfg.in_channels)
        self.controlnet_dit = _Blocks(dit_cfg, cfg.num_layers)
        self.controlnet_zero_convs_after = nn.ModuleList(
            nn.Conv1d(dit_cfg.dim, dit_cfg.dim, 1) for _ in range(cfg.num_layers))


@torch.no_grad()
def init_from_dit(dit, dit_cfg: WanDiTConfig, cfg: ControlNetConfig, gen: torch.Generator,
                  dtype=torch.bfloat16, *, device, requires_grad: bool = False
                  ) -> GoalForceControlNet:
    """Copy blocks i*stride of the expert DiT (without an I2V expert's k_img/v_img/
    norm_k_img), draw a fresh patch embedding, and zero the
    zero convs (so the ControlNet starts as the identity). requires_grad=True returns it
    trainable (the training path); by default it is frozen, as for serving."""
    stride = cfg.stride or 1
    cn = empty_module(GoalForceControlNet, dit_cfg, cfg, dtype=dtype, device=device)
    init_patch_embedding_(cn.controlnet_patch_embedding.patch_embedding, gen)
    for i, blk in enumerate(cn.controlnet_dit.blocks):
        # an I2V expert's image-key projections stay behind: the side stack has no image
        # tokens (JAX copies them and never reads them)
        own = blk.state_dict()
        blk.load_state_dict(copy.deepcopy({k: v for k, v in dit.blocks[i * stride]
                                           .state_dict().items() if k in own}))
    for zc in cn.controlnet_zero_convs_after:
        zc.weight.zero_()
        zc.bias.zero_()
    return cn.eval().requires_grad_(requires_grad)


def _block(blk, c, context, t_mod, rope_cos, rope_sin, dit_cfg, attn_impl):
    return dit_block(fsdp.gathered(blk), c, context, t_mod, rope_cos, rope_sin, dit_cfg,
                     attn_impl)


def _block_and_zero_conv(blk, zc, c, context, t_mod, rope_cos, rope_sin, dit_cfg, attn_impl):
    """A side-stack block and its zero conv, their FSDP shards gathered together (one
    all-gather) inside the block's checkpoint."""
    blk, zc = fsdp.gathered(blk, zc)
    c = dit_block(blk, c, context, t_mod, rope_cos, rope_sin, dit_cfg, attn_impl)
    return c, F.linear(c, zc.weight[:, :, 0].to(c.dtype), zc.bias.to(c.dtype))


def controlnet_injections(cn: GoalForceControlNet, dit_cfg: WanDiTConfig, control_latents,
                          context, t_mod, rope_cos, rope_sin,
                          attn_impl: str = "auto", remat: bool = False,
                          apply_zero_convs: bool = True) -> List[torch.Tensor]:
    """Run the side stack and return the per-layer injections, each (B, S, D).

    control_latents: (B, F, H, W, C) VAE latents of the control video; under a mesh the
    side stack runs on this rank's tokens, as the main stream does. Each block's state
    goes through its 1x1 zero conv as soon as it is computed, so only the injections are
    kept. remat: one non-reentrant checkpoint per block with its zero conv fused in, as
    JAX checkpoints each body of its side-stack scan. apply_zero_convs=False returns the
    blocks' raw states instead: the strided mode adds them without zero convs, as the
    reference does.
    """
    cn = fsdp.gathered(cn, skip=("controlnet_dit", "controlnet_zero_convs_after"))
    tokens, _ = patchify(cn.controlnet_patch_embedding.patch_embedding, control_latents,
                         dit_cfg.patch_size)
    if current_mesh() is not None:
        tokens = col.split_seq(tokens)   # the main stream's token split
    out = []
    c = tokens
    # under a mesh a recompute carries its forward's context (it runs on autograd's thread)
    carry = col.carry_context if current_mesh() is not None else (lambda f: f)
    if not apply_zero_convs:
        for blk in cn.controlnet_dit.blocks:
            args = (blk, c, context, t_mod, rope_cos, rope_sin, dit_cfg, attn_impl)
            c = checkpoint(carry(_block), *args, use_reentrant=False) if remat else _block(*args)
            out.append(c)
        return out
    for blk, zc in zip(cn.controlnet_dit.blocks, cn.controlnet_zero_convs_after):
        args = (blk, zc, c, context, t_mod, rope_cos, rope_sin, dit_cfg, attn_impl)
        if remat:
            c, inj = checkpoint(carry(_block_and_zero_conv), *args, use_reentrant=False)
        else:
            c, inj = _block_and_zero_conv(*args)
        out.append(inj)
    return out
