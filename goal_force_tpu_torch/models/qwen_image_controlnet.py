"""Qwen-Image's blockwise ControlNet in PyTorch.

Port of ``goal_force_tpu/models/qwen_image_controlnet.py``: the patchified control
latents pass once through ``img_in``; after each DiT block the main image tokens receive
``output_proj(gelu(input_proj(rms(img) + rms(cond))))`` (one block per DiT layer, exact
GELU, the RMS norms' weights applied in float32; ``output_proj`` starts at zero).

``QwenImageControlNet`` holds the parameters under the reference names that JAX
``qwen_image_controlnet_params_from_torch`` reads: ``img_in`` and
``controlnet_blocks.{i}.{x_rms, y_rms, input_proj, output_proj}``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from goal_force_tpu_torch.models.wan_dit import RMSNorm, empty_module, linear


@dataclasses.dataclass(frozen=True)
class QwenImageControlNetConfig:
    num_layers: int = 60
    in_dim: int = 64
    additional_in_dim: int = 0
    dim: int = 3072
    eps: float = 1e-6


class BlockWiseControlBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.x_rms = RMSNorm(dim)
        self.y_rms = RMSNorm(dim)
        self.input_proj = nn.Linear(dim, dim)
        self.output_proj = nn.Linear(dim, dim)


class QwenImageControlNet(nn.Module):
    def __init__(self, cfg: QwenImageControlNetConfig):
        super().__init__()
        self.img_in = nn.Linear(cfg.in_dim + cfg.additional_in_dim, cfg.dim)
        self.controlnet_blocks = nn.ModuleList(BlockWiseControlBlock(cfg.dim)
                                               for _ in range(cfg.num_layers))


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    return (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps) * w).to(x.dtype)


def qwen_cn_process_conditioning(model: QwenImageControlNet,
                                 cond_tokens: torch.Tensor) -> torch.Tensor:
    """Patchified control latents (B, S, in_dim) -> (B, S, dim)."""
    return linear(model.img_in, cond_tokens)


def qwen_cn_block_p(p: BlockWiseControlBlock, img: torch.Tensor, cond: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    """The residual of one DiT block; the caller adds it to the image stream."""
    h = linear(p.input_proj, _rms(img, p.x_rms.weight, eps) + _rms(cond, p.y_rms.weight, eps))
    return linear(p.output_proj, F.gelu(h))


def qwen_cn_block(model: QwenImageControlNet, block_id: int, img: torch.Tensor,
                  cond: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return qwen_cn_block_p(model.controlnet_blocks[block_id], img, cond, eps)


@torch.no_grad()
def init_qwen_image_controlnet(cfg: QwenImageControlNetConfig, gen: torch.Generator,
                               dtype=torch.bfloat16, *, device) -> QwenImageControlNet:
    """JAX ``init_qwen_image_controlnet``'s distributions drawn from `gen`: N(0, 0.02**2)
    ``img_in`` and input projections, zero output projections and biases, unit norms."""
    model = empty_module(QwenImageControlNet, cfg, dtype=dtype, device=device)
    model.img_in.weight.normal_(generator=gen).mul_(0.02)
    model.img_in.bias.zero_()
    for blk in model.controlnet_blocks:
        blk.x_rms.weight.fill_(1.0)
        blk.y_rms.weight.fill_(1.0)
        blk.input_proj.weight.normal_(generator=gen).mul_(0.02)
        for t in (blk.input_proj.bias, blk.output_proj.weight, blk.output_proj.bias):
            t.zero_()
    return model.eval().requires_grad_(False)
