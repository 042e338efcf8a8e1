"""CogVideoX DiT in PyTorch.

Port of ``goal_force_tpu/models/cog_dit.py``: the (1, 2, 2) patchify, the sinusoidal
timestep MLP, text-first joint attention in every block (biased q/k/v, a per-head affine
LayerNorm on q and k, 3D RoPE on the image tokens only, interleaved pairs), the adaptive
LayerNorm pairs (one affine LayerNorm shared by the image and text streams, six
modulation chunks), the final LayerNorm and the single AdaLN head in (shift, scale)
order. The timestep sinusoid is ``models/wan_dit.py::sinusoidal_embedding`` (cos first, as
JAX's ``timestep_embedding``). The attention is at head_dim 64 (3072 / 48), so it runs
``ops/attention.py::plain_attention`` (chunked over query rows), as JAX runs it in XLA.

``CogDiT`` holds the parameters under the reference ("diffsynth") names that JAX
``cog_dit_params_from_torch`` reads: ``patchify.proj``, ``time_embedder.
timestep_embedder.{0,2}``, ``context_embedder``, ``blocks.{i}.{norm1.{linear, norm},
attn1.{to_q, to_k, to_v, to_out}, norm_q, norm_k, norm2.{linear, norm}, ff.{0,2}}``,
``norm_final``, ``norm_out.{linear, norm}`` and ``proj_out``.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from goal_force_tpu_torch.models.clip import _ln
from goal_force_tpu_torch.models.wan_dit import (
    Activation,
    LayerNormAffine,
    empty_module,
    gelu_tanh,
    init_linear_,
    silu_f32,
    sinusoidal_embedding,
)
from goal_force_tpu_torch.ops.attention import attention
from goal_force_tpu_torch.ops.rope import apply_rope


@dataclasses.dataclass(frozen=True)
class CogDiTConfig:
    """CogVideoX-5B."""

    dim: int = 3072
    cond_dim: int = 512
    num_heads: int = 48
    num_blocks: int = 42
    in_channels: int = 16
    text_dim: int = 4096
    freq_dim: int = 3072
    patch: int = 2
    rope_dim: int = 64             # per-head rope dim (head_dim)
    base_height: int = 480
    base_width: int = 720
    eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads


class CogPatchify(nn.Module):
    def __init__(self, cfg: CogDiTConfig):
        super().__init__()
        p = cfg.patch
        self.proj = nn.Conv3d(cfg.in_channels, cfg.dim, (1, p, p), stride=(1, p, p))


class CogTimeEmbedder(nn.Module):
    def __init__(self, cfg: CogDiTConfig):
        super().__init__()
        self.timestep_embedder = nn.Sequential(nn.Linear(cfg.freq_dim, cfg.cond_dim),
                                               Activation(),
                                               nn.Linear(cfg.cond_dim, cfg.cond_dim))


class CogAdaLayerNorm(nn.Module):
    def __init__(self, cond_dim: int, dim: int, chunks: int):
        super().__init__()
        self.linear = nn.Linear(cond_dim, chunks * dim)
        self.norm = LayerNormAffine(dim)


class CogAttention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.to_q = nn.Linear(dim, dim)
        self.to_k = nn.Linear(dim, dim)
        self.to_v = nn.Linear(dim, dim)
        self.to_out = nn.Linear(dim, dim)


class CogBlock(nn.Module):
    def __init__(self, cfg: CogDiTConfig):
        super().__init__()
        d = cfg.dim
        self.norm1 = CogAdaLayerNorm(cfg.cond_dim, d, 6)
        self.attn1 = CogAttention(d)
        self.norm_q = LayerNormAffine(cfg.head_dim)
        self.norm_k = LayerNormAffine(cfg.head_dim)
        self.norm2 = CogAdaLayerNorm(cfg.cond_dim, d, 6)
        self.ff = nn.Sequential(nn.Linear(d, 4 * d), Activation(), nn.Linear(4 * d, d))


class CogDiT(nn.Module):
    def __init__(self, cfg: CogDiTConfig):
        super().__init__()
        d = cfg.dim
        self.patchify = CogPatchify(cfg)
        self.time_embedder = CogTimeEmbedder(cfg)
        self.context_embedder = nn.Linear(cfg.text_dim, d)
        self.blocks = nn.ModuleList(CogBlock(cfg) for _ in range(cfg.num_blocks))
        self.norm_final = LayerNormAffine(d)
        self.norm_out = CogAdaLayerNorm(cfg.cond_dim, d, 2)
        self.proj_out = nn.Linear(d, cfg.in_channels * cfg.patch ** 2)


@lru_cache(maxsize=8)
def cog_rope_tables(t: int, gh: int, gw: int, rope_dim: int, base_h: int, base_w: int,
                    theta: float = 10000.0):
    """(S, rope_dim//2) float32 numpy cos/sin over the (t, gh, gw) patch grid from float64
    angles: the h/w grids resize-cropped into the base 480x720 box of latent patches,
    the head dims split 1/4 (t), 3/8 (h), 3/8 (w)."""
    base_gw = base_w // (8 * 2)
    base_gh = base_h // (8 * 2)
    if gh / gw > base_gh / base_gw:
        resize_h, resize_w = base_gh, int(round(base_gh / gh * gw))
    else:
        resize_w, resize_h = base_gw, int(round(base_gw / gw * gh))
    top = int(round((base_gh - resize_h) / 2.0))
    left = int(round((base_gw - resize_w) / 2.0))
    grid_h = np.linspace(top, top + resize_h, gh, endpoint=False, dtype=np.float64)
    grid_w = np.linspace(left, left + resize_w, gw, endpoint=False, dtype=np.float64)
    grid_t = np.arange(t, dtype=np.float64)

    def axis(grid, d):
        freqs = 1.0 / theta ** (np.arange(0, d, 2, dtype=np.float64) / d)
        return np.outer(grid, freqs)

    ft = axis(grid_t, rope_dim // 4)[:, None, None, :]
    fh = axis(grid_h, rope_dim // 8 * 3)[None, :, None, :]
    fw = axis(grid_w, rope_dim // 8 * 3)[None, None, :, :]
    ang = np.concatenate([np.broadcast_to(f, (t, gh, gw, f.shape[-1])) for f in (ft, fh, fw)],
                         axis=-1).reshape(t * gh * gw, -1)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _lin(m: nn.Linear, x):
    return F.linear(x, m.weight, m.bias)


def _ada(p: CogAdaLayerNorm, x_img, x_txt, time_emb, eps):
    """The shared affine LayerNorm of both streams, modulated by six chunks."""
    e = _lin(p.linear, silu_f32(time_emb))
    sa, sca, ga, sb, scb, gb = (c[:, None, :] for c in e.chunk(6, dim=-1))
    h_img = _ln(p.norm, x_img, eps) * (1 + sca) + sa
    h_txt = _ln(p.norm, x_txt, eps) * (1 + scb) + sb
    return h_img, h_txt, ga, gb


def cog_block(p: CogBlock, x_img, x_txt, time_emb, cos, sin, cfg: CogDiTConfig,
              attn_impl: str = "auto"):
    """One block: text-first joint attention, then the feed-forward, each behind its
    adaptive LayerNorm pair and gated back into both streams."""
    n = cfg.num_heads
    t_len = x_txt.shape[1]
    h_img, h_txt, ga, gb = _ada(p.norm1, x_img, x_txt, time_emb, cfg.eps)
    io = torch.cat([h_txt, h_img], dim=1)
    b, s, _ = io.shape
    a = p.attn1
    q, k, v = (_lin(m, io).reshape(b, s, n, -1) for m in (a.to_q, a.to_k, a.to_v))
    q = _ln(p.norm_q, q, 1e-6)
    k = _ln(p.norm_k, k, 1e-6)
    q = torch.cat([q[:, :t_len], apply_rope(q[:, t_len:], cos, sin)], dim=1)
    k = torch.cat([k[:, :t_len], apply_rope(k[:, t_len:], cos, sin)], dim=1)
    out = _lin(a.to_out, attention(q, k, v, impl=attn_impl).reshape(b, s, cfg.dim))
    x_img = x_img + ga * out[:, t_len:]
    x_txt = x_txt + gb * out[:, :t_len]
    del q, k, v, out

    h_img, h_txt, ga, gb = _ada(p.norm2, x_img, x_txt, time_emb, cfg.eps)
    io = torch.cat([h_txt, h_img], dim=1)
    io = _lin(p.ff[2], gelu_tanh(_lin(p.ff[0], io)))
    return x_img + ga * io[:, t_len:], x_txt + gb * io[:, :t_len]


def cog_dit_forward(model: CogDiT, cfg: CogDiTConfig, latents: torch.Tensor,
                    timestep: torch.Tensor, prompt_emb: torch.Tensor,
                    attn_impl: str = "auto") -> torch.Tensor:
    """(B, T, H, W, 16) latents, (B,) timesteps, (B, L, text_dim) text -> (B, T, H, W, 16)."""
    b, t, h, w, _ = latents.shape
    p = cfg.patch
    gh, gw = h // p, w // p
    dtype = model.proj_out.weight.dtype
    # patchify: Conv3d (1, 2, 2) as a per-frame linear over (c, ph, pw)
    x = latents.to(dtype).reshape(b, t, gh, p, gw, p, cfg.in_channels)
    x = x.permute(0, 1, 2, 4, 6, 3, 5).reshape(b, t * gh * gw, cfg.in_channels * p * p)
    conv = model.patchify.proj
    x = F.linear(x, conv.weight.reshape(conv.weight.shape[0], -1), conv.bias)

    te = model.time_embedder.timestep_embedder
    temb = sinusoidal_embedding(cfg.freq_dim, timestep).to(dtype)
    temb = _lin(te[2], silu_f32(_lin(te[0], temb)))
    txt = _lin(model.context_embedder, prompt_emb.to(dtype))

    cos_np, sin_np = cog_rope_tables(t, gh, gw, cfg.rope_dim, cfg.base_height, cfg.base_width)
    cos, sin = (torch.from_numpy(a).to(x.device) for a in (cos_np, sin_np))
    for blk in model.blocks:
        x, txt = cog_block(blk, x, txt, temb, cos, sin, cfg, attn_impl)

    # the final LayerNorm runs over the joint sequence; per token it is the image part's
    x = _ln(model.norm_final, x, cfg.eps)
    shift, scale = _lin(model.norm_out.linear, silu_f32(temb)).chunk(2, dim=-1)
    x = _ln(model.norm_out.norm, x, cfg.eps) * (1 + scale[:, None]) + shift[:, None]
    x = _lin(model.proj_out, x)
    # unpatchify, channel-major (C P Q)
    x = x.reshape(b, t, gh, gw, cfg.in_channels, p, p).permute(0, 1, 2, 5, 3, 6, 4)
    return x.reshape(b, t, h, w, cfg.in_channels)


@torch.no_grad()
def init_cog_dit(cfg: CogDiTConfig, gen: torch.Generator, dtype=torch.bfloat16, *,
                 device) -> CogDiT:
    """Random weights drawn from `gen`: uniform +-1/sqrt(fan_in) linears and patchify,
    zero biases, unit norms (JAX ``init_cog_dit``'s distributions)."""
    model = empty_module(CogDiT, cfg, dtype=dtype, device=device)
    for m in model.modules():
        if isinstance(m, nn.Linear):
            init_linear_(m, gen)
        elif isinstance(m, nn.Conv3d):
            s = 1.0 / math.sqrt(m.weight[0].numel())
            m.weight.uniform_(-s, s, generator=gen)
            m.bias.zero_()
        elif isinstance(m, LayerNormAffine):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return model.eval().requires_grad_(False)
