"""StepVideo DiT in PyTorch.

Port of ``goal_force_tpu/models/stepvideo_dit.py``: PixArt-style adaLN-single (one
6*dim modulation shared by every block, each block adding its own ``scale_shift_table``),
the split-half (NeoX) 3D RoPE with a per-head channel split (64, 32, 32) (tables built in
float64 on the host, the rotation applied in float32), affine q/k RMS norms, bias-free
attention projections, cross-attention on the unmodulated residual stream over the
caption tokens (no text mask), a gelu-tanh feed-forward, the caption LayerNorm without
affine and PixArt projection with the CLIP projection prepended, the 1x1 patch embedding
as a per-pixel linear, and the 2-way ``scale_shift_table`` output modulation by the
timestep embedding. The timestep sinusoid is ``models/wan_dit.py::sinusoidal_embedding``
(cos first, as JAX's ``timestep_embedding``) of the timestep x1000.

Both attentions go through ``ops/attention.py::attention(impl="auto")`` with no
``bounded``: on the card at head_dim 128 the runtime logit bound picks K1 (no clamp) or
K2, one host sync per call; on the CPU the plain attention runs.

``StepVideoDiT`` holds the parameters under the reference ("diffsynth") names
(``pos_embed.proj``, ``adaln_single.emb.timestep_embedder.linear_{1,2}``,
``adaln_single.linear``, ``caption_projection.linear_{1,2}``, ``clip_projection``,
``transformer_blocks.{i}.{norm1, norm2, attn1.{wqkv, wo, q_norm, k_norm}, attn2.{wq, wkv,
wo, q_norm, k_norm}, ff.net.{0.proj, 2}, scale_shift_table}``, ``scale_shift_table``,
``proj_out``) and in the reference layout: ``attn1.wqkv``'s output is viewed per head as
(n, 3*hd) and split along its last axis, ``attn2.wkv``'s as (n, 2*hd). JAX reorders those
columns on load instead; ``io/from_jax.py`` undoes its reorder.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from goal_force_tpu_torch.models.wan_dit import (
    Activation,
    LayerNormAffine,
    RMSNorm,
    empty_module,
    gelu_tanh,
    init_linear_,
    layer_norm,
    rms_norm,
    silu_f32,
    sinusoidal_embedding,
)
from goal_force_tpu_torch.ops.attention import attention


@dataclasses.dataclass(frozen=True)
class StepVideoConfig:
    """StepVideo-T2V's defaults."""

    num_heads: int = 48
    head_dim: int = 128
    num_layers: int = 48
    in_channels: int = 64
    caption_dim: int = 6144
    clip_dim: int = 1024
    rope_split: Tuple[int, ...] = (64, 32, 32)
    eps: float = 1e-6

    @property
    def dim(self) -> int:
        return self.num_heads * self.head_dim


class StepSelfAttention(nn.Module):
    def __init__(self, cfg: StepVideoConfig):
        super().__init__()
        d = cfg.dim
        self.wqkv = nn.Linear(d, 3 * d, bias=False)
        self.wo = nn.Linear(d, d, bias=False)
        self.q_norm = RMSNorm(cfg.head_dim)
        self.k_norm = RMSNorm(cfg.head_dim)


class StepCrossAttention(nn.Module):
    def __init__(self, cfg: StepVideoConfig):
        super().__init__()
        d = cfg.dim
        self.wq = nn.Linear(d, d, bias=False)
        self.wkv = nn.Linear(d, 2 * d, bias=False)
        self.wo = nn.Linear(d, d, bias=False)
        self.q_norm = RMSNorm(cfg.head_dim)
        self.k_norm = RMSNorm(cfg.head_dim)


class GeluProj(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.proj = nn.Linear(d_in, d_out, bias=False)


class StepFeedForward(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.net = nn.ModuleList([GeluProj(d, 4 * d), Activation(),
                                  nn.Linear(4 * d, d, bias=False)])


class StepVideoBlock(nn.Module):
    def __init__(self, cfg: StepVideoConfig):
        super().__init__()
        d = cfg.dim
        self.norm1 = LayerNormAffine(d)
        self.attn1 = StepSelfAttention(cfg)
        self.attn2 = StepCrossAttention(cfg)
        self.norm2 = LayerNormAffine(d)
        self.ff = StepFeedForward(d)
        self.scale_shift_table = nn.Parameter(torch.zeros(6, d))


class PatchEmbed(nn.Module):
    def __init__(self, cfg: StepVideoConfig):
        super().__init__()
        self.proj = nn.Conv2d(cfg.in_channels, cfg.dim, 1)


class TwoLinears(nn.Module):
    def __init__(self, d_in: int, d: int):
        super().__init__()
        self.linear_1 = nn.Linear(d_in, d)
        self.linear_2 = nn.Linear(d, d)


class TimestepEmb(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.timestep_embedder = TwoLinears(256, d)


class AdaLNSingle(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.emb = TimestepEmb(d)
        self.linear = nn.Linear(d, 6 * d)


class StepVideoDiT(nn.Module):
    def __init__(self, cfg: StepVideoConfig):
        super().__init__()
        d = cfg.dim
        self.pos_embed = PatchEmbed(cfg)
        self.adaln_single = AdaLNSingle(d)
        self.caption_projection = TwoLinears(cfg.caption_dim, d)
        self.clip_projection = nn.Linear(cfg.clip_dim, d)
        self.transformer_blocks = nn.ModuleList(StepVideoBlock(cfg) for _ in range(cfg.num_layers))
        self.scale_shift_table = nn.Parameter(torch.zeros(2, d))
        self.proj_out = nn.Linear(d, cfg.in_channels)


@lru_cache(maxsize=8)
def stepvideo_rope_tables(f: int, h: int, w: int, rope_split: Tuple[int, ...],
                          theta: float = 1e4):
    """Per-axis half tables ((S, d_i // 2) float32 cos, sin) over the (f, h, w) grid, from
    float64 angles."""
    grids = np.meshgrid(np.arange(f), np.arange(h), np.arange(w), indexing="ij")
    out = []
    for i, d in enumerate(rope_split):
        freqs = 1.0 / theta ** (np.arange(0, d, 2, dtype=np.float64) / d)
        ang = np.outer(grids[i].reshape(-1).astype(np.float64), freqs)
        out.append((np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)))
    return tuple(out)


def _rope_neox(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Split-half rotation of x (B, S, N, D) in float32 by (S, D // 2) tables."""
    x1, x2 = x.float().chunk(2, dim=-1)
    c, s = cos[None, :, None], sin[None, :, None]
    return torch.cat([(x1 * c - x2 * s).to(x.dtype), (x2 * c + x1 * s).to(x.dtype)], dim=-1)


def apply_rope_3d(x: torch.Tensor, tables, rope_split) -> torch.Tensor:
    return torch.cat([_rope_neox(part, cos, sin) for part, (cos, sin)
                      in zip(x.split(list(rope_split), dim=-1), tables)], dim=-1)


def stepvideo_block(p: StepVideoBlock, x, kv, t6, tables, cfg: StepVideoConfig,
                    attn_impl: str = "auto"):
    """One block: modulated self-attention with RoPE, cross-attention of the unmodulated
    residual stream over the caption tokens, modulated gelu-tanh feed-forward."""
    n, hd = cfg.num_heads, cfg.head_dim
    b, s, d = x.shape
    mod = p.scale_shift_table.to(t6.dtype)[None] + t6.reshape(b, 6, d)
    sm, sc, g, smlp, scmlp, gmlp = (mod[:, i][:, None] for i in range(6))

    h = layer_norm(x, cfg.eps, p.norm1.weight, p.norm1.bias) * (1 + sc) + sm
    a = p.attn1
    # the reference layout: each head's (q | k | v) columns side by side
    q, k, v = F.linear(h, a.wqkv.weight).reshape(b, s, n, 3 * hd).split(hd, dim=-1)
    q = apply_rope_3d(rms_norm(q, a.q_norm.weight, cfg.eps), tables, cfg.rope_split)
    k = apply_rope_3d(rms_norm(k, a.k_norm.weight, cfg.eps), tables, cfg.rope_split)
    out = attention(q, k, v, impl=attn_impl).reshape(b, s, d)
    x = x + g * F.linear(out, a.wo.weight)
    del q, k, v, out

    c = p.attn2
    t = kv.shape[1]
    q = rms_norm(F.linear(x, c.wq.weight).reshape(b, s, n, hd), c.q_norm.weight, cfg.eps)
    kk, vv = F.linear(kv, c.wkv.weight).reshape(b, t, n, 2 * hd).split(hd, dim=-1)
    kk = rms_norm(kk, c.k_norm.weight, cfg.eps)
    out = attention(q, kk, vv, impl=attn_impl).reshape(b, s, d)
    x = x + F.linear(out, c.wo.weight)
    del q, out

    h = layer_norm(x, cfg.eps, p.norm2.weight, p.norm2.bias) * (1 + scmlp) + smlp
    h = F.linear(gelu_tanh(F.linear(h, p.ff.net[0].proj.weight)), p.ff.net[2].weight)
    return x + gmlp * h


def _lin(m: nn.Linear, x):
    return F.linear(x, m.weight, m.bias)


def stepvideo_dit_forward(model: StepVideoDiT, cfg: StepVideoConfig, latents: torch.Tensor,
                          timestep: torch.Tensor, caption_emb: torch.Tensor,
                          clip_emb: Optional[torch.Tensor] = None,
                          attn_impl: str = "auto") -> torch.Tensor:
    """(B, F, H, W, C) latents, (B,) timesteps in [0, 1], (B, L, caption_dim) Step-1
    states and optionally (B, Lc, clip_dim) BERT states -> (B, F, H, W, C)."""
    b, f, h, w, c = latents.shape
    dtype = model.proj_out.weight.dtype
    conv = model.pos_embed.proj
    x = F.linear(latents.to(dtype).reshape(b, f * h * w, c), conv.weight[:, :, 0, 0], conv.bias)

    te = model.adaln_single.emb.timestep_embedder
    temb = sinusoidal_embedding(256, timestep * 1000.0).to(dtype)
    temb = _lin(te.linear_2, silu_f32(_lin(te.linear_1, temb)))
    t6 = _lin(model.adaln_single.linear, silu_f32(temb))

    cp = model.caption_projection
    cap = layer_norm(caption_emb.to(dtype), cfg.eps)
    cap = _lin(cp.linear_2, gelu_tanh(_lin(cp.linear_1, cap)))
    if clip_emb is not None:
        cap = torch.cat([_lin(model.clip_projection, clip_emb.to(dtype)), cap], dim=1)

    tables = tuple((torch.from_numpy(cs).to(x.device), torch.from_numpy(sn).to(x.device))
                   for cs, sn in stepvideo_rope_tables(f, h, w, tuple(cfg.rope_split)))
    for blk in model.transformer_blocks:
        x = stepvideo_block(blk, x, cap, t6, tables, cfg, attn_impl)

    mod = model.scale_shift_table.to(dtype)[None] + temb[:, None]
    shift, scale = mod[:, 0][:, None], mod[:, 1][:, None]
    x = layer_norm(x, cfg.eps) * (1 + scale) + shift
    return _lin(model.proj_out, x).reshape(b, f, h, w, cfg.in_channels)


@torch.no_grad()
def init_stepvideo_dit(cfg: StepVideoConfig, gen: torch.Generator, dtype=torch.bfloat16, *,
                       device) -> StepVideoDiT:
    """Random weights drawn from `gen` (JAX ``init_stepvideo_dit``'s distributions):
    uniform +-1/sqrt(fan_in) linears and patch embedding, zero biases, unit norms, the
    scale-shift tables N(0, 1/dim)."""
    model = empty_module(StepVideoDiT, cfg, dtype=dtype, device=device)
    for m in model.modules():
        if isinstance(m, nn.Linear):
            init_linear_(m, gen)
        elif isinstance(m, (LayerNormAffine, RMSNorm)):
            m.weight.fill_(1.0)
            if isinstance(m, LayerNormAffine):
                m.bias.zero_()
        elif isinstance(m, StepVideoBlock):
            m.scale_shift_table.normal_(generator=gen).div_(math.sqrt(cfg.dim))
    conv = model.pos_embed.proj
    s = 1.0 / math.sqrt(cfg.in_channels)
    conv.weight.uniform_(-s, s, generator=gen)
    conv.bias.zero_()
    model.scale_shift_table.normal_(generator=gen).div_(math.sqrt(cfg.dim))
    return model.eval().requires_grad_(False)
