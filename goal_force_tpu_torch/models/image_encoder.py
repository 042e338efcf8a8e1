"""CLIP image encoder: the ViT-H/14 vision tower of open-clip's XLM-Roberta-CLIP.

Port of ``goal_force_tpu/models/image_encoder.py``: bicubic resize to 224, CLIP
normalisation, ViT-H/14 (patch 14, dim 1280, 16 heads of 80, pre-norm, class token, erf
GELU MLP) returning the output of the first 31 of its 32 blocks, (B, 257, 1280): the
``clip_feature`` of the I2V models that take one (``wan_dit_forward(clip_feature=)``).
Only the vision tower exists; the text tower is never called.

Parameters keep the reference's names under ``model.visual.`` (or ``visual.``):
``patch_embedding`` (a bias-free Conv2d), ``cls_embedding``, ``pos_embedding``,
``pre_norm``, ``transformer.{i}.{norm1, attn.to_qkv, attn.proj, norm2, mlp.0, mlp.2}``.
Attention has head_dim 80 and is plain torch (float32 logits and softmax, as JAX's
einsums), no kernel: the flash kernels take head_dim 128 only.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from goal_force_tpu_torch.models.wan_dit import (
    Activation,
    LayerNormAffine,
    empty_module,
    gelu_erf,
    init_linear_,
)

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 14
    dim: int = 1280
    mlp_ratio: int = 4
    num_heads: int = 16
    num_layers: int = 32
    use_blocks: int = 31      # the reference's use_31_block
    eps: float = 1e-5

    @property
    def num_tokens(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1


VIT_H_14 = ViTConfig()


class _Attention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.to_qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)


class _Block(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.norm1 = LayerNormAffine(cfg.dim)
        self.attn = _Attention(cfg.dim)
        self.norm2 = LayerNormAffine(cfg.dim)
        self.mlp = nn.Sequential(nn.Linear(cfg.dim, cfg.dim * cfg.mlp_ratio), Activation(),
                                 nn.Linear(cfg.dim * cfg.mlp_ratio, cfg.dim))


class VisionTransformer(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embedding = nn.Conv2d(3, cfg.dim, cfg.patch_size, cfg.patch_size,
                                         bias=False)
        self.cls_embedding = nn.Parameter(torch.zeros(1, 1, cfg.dim))
        self.pos_embedding = nn.Parameter(torch.zeros(1, cfg.num_tokens, cfg.dim))
        self.pre_norm = LayerNormAffine(cfg.dim)
        self.transformer = nn.ModuleList(_Block(cfg) for _ in range(cfg.num_layers))


def _ln(p: LayerNormAffine, x, eps: float):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * p.weight + p.bias


def _attn(p: _Attention, x, num_heads: int):
    b, s, c = x.shape
    q, k, v = F.linear(x, p.to_qkv.weight, p.to_qkv.bias).reshape(b, s, 3, num_heads,
                                                                     -1).unbind(2)
    logits = torch.einsum("bsnh,btnh->bnst", q.float(), k.float())
    probs = torch.softmax(logits * (q.shape[-1] ** -0.5), dim=-1).to(x.dtype)
    out = torch.einsum("bnst,btnh->bsnh", probs, v).reshape(b, s, c)
    return F.linear(out, p.proj.weight, p.proj.bias)


def vit_encode(model: VisionTransformer, cfg: ViTConfig, images: torch.Tensor) -> torch.Tensor:
    """images: (B, 224, 224, 3) CLIP-normalised -> (B, 257, dim) after use_blocks blocks."""
    b, hh, ww, _ = images.shape
    p = cfg.patch_size
    x = images.reshape(b, hh // p, p, ww // p, p, 3).permute(0, 1, 3, 5, 2, 4)
    x = x.reshape(b, (hh // p) * (ww // p), 3 * p * p)
    w = model.patch_embedding.weight
    x = x @ w.reshape(w.shape[0], -1).t()
    cls = model.cls_embedding.to(x.dtype).expand(b, 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1) + model.pos_embedding.to(x.dtype)
    x = _ln(model.pre_norm, x, cfg.eps)
    for blk in model.transformer[: cfg.use_blocks]:
        x = x + _attn(blk.attn, _ln(blk.norm1, x, cfg.eps), cfg.num_heads)
        m = _ln(blk.norm2, x, cfg.eps)
        m = F.linear(gelu_erf(F.linear(m, blk.mlp[0].weight, blk.mlp[0].bias)),
                     blk.mlp[2].weight, blk.mlp[2].bias)
        x = x + m
    return x


def preprocess_image(image: np.ndarray, size: int = 224) -> np.ndarray:
    """(H, W, 3) float [0, 1] -> (size, size, 3) CLIP-normalised (cv2 bicubic)."""
    import cv2

    img = cv2.resize(image.astype(np.float32), (size, size), interpolation=cv2.INTER_CUBIC)
    return (img - np.asarray(CLIP_MEAN, np.float32)) / np.asarray(CLIP_STD, np.float32)


@torch.no_grad()
def encode_image(model: VisionTransformer, image: np.ndarray,
                 cfg: ViTConfig = VIT_H_14) -> torch.Tensor:
    """(H, W, 3) float [0, 1] -> clip_feature (1, 257, dim) on the model's device."""
    w = model.pos_embedding
    x = torch.from_numpy(preprocess_image(image, cfg.image_size))[None]
    return vit_encode(model, cfg, x.to(device=w.device, dtype=w.dtype))


def vit_from_state_dict(sd: Dict[str, torch.Tensor], cfg: ViTConfig = VIT_H_14,
                        dtype=torch.float32, *, device) -> VisionTransformer:
    """The vision tower from a WanImageEncoder state dict (keys under ``model.visual.``
    or ``visual.``). Every key the tower reads must be there with its shape; the keys it
    does not read (the text tower, the vision head) are ignored, as JAX's
    ``vit_params_from_torch`` ignores them."""
    pre = "model.visual." if any(k.startswith("model.visual.") for k in sd) else "visual."
    model = empty_module(VisionTransformer, cfg, dtype=dtype, device=device)
    want = model.state_dict()
    missing = sorted(k for k in want if pre + k not in sd)
    if missing:
        raise KeyError(f"image encoder: {len(missing)} missing keys under {pre!r}: "
                       f"{missing[:8]}")
    bad = [(k, tuple(sd[pre + k].shape), tuple(v.shape)) for k, v in want.items()
           if tuple(sd[pre + k].shape) != tuple(v.shape)]
    if bad:
        raise ValueError(f"image encoder: shapes (file, model) do not fit: {bad[:8]}")
    model.load_state_dict({k: sd[pre + k] for k in want})
    return model.eval().requires_grad_(False)


@torch.no_grad()
def init_vit(cfg: ViTConfig, gen: torch.Generator, dtype=torch.float32, *,
             device) -> VisionTransformer:
    """JAX ``init_vit``'s distributions: uniform +-1/sqrt(fan_in) linears with zero
    biases, unit/zero norms, N(0, 1/dim) patch, class and position embeddings."""
    model = empty_module(VisionTransformer, cfg, dtype=dtype, device=device)
    gain = 1.0 / math.sqrt(cfg.dim)
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            init_linear_(mod, gen)
        elif isinstance(mod, LayerNormAffine):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    for t in (model.patch_embedding.weight, model.cls_embedding, model.pos_embedding):
        t.normal_(generator=gen).mul_(gain)
    return model.eval().requires_grad_(False)
