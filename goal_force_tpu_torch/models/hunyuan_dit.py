"""HunyuanDiT (image) in PyTorch.

Port of ``goal_force_tpu/models/hunyuan_dit.py``: the U-ViT long-skip topology (21 down
blocks, whose outputs 0..18 are pushed and popped LIFO by the 19 up blocks through
``skip_norm`` + ``skip_linear``); per block a shift-only modulation on the self-attention
input, float32 LayerNorms, an affine per-head LayerNorm on q and k, rope on q and k in
the self-attention and on q only in the text cross-attention, a tanh-GELU MLP;
CLIP(77) + embedded mT5(256) text with the learned padding embedding where the masks are
0, the mT5 attention pool, the size and style embeddings in the condition vector; a final
layer with a 2-way modulation, and the unpatchify patch-major, "(P Q C)", keeping the
first 4 of 8 channels.

``hunyuan_dit_rope`` is the pipeline's rope of the fill-resize-crop grid in the 512-base
box (host float64; the W-coordinate table first, as the reference concatenates them).
Every attention goes through ``ops/attention.py::attention(impl=attn_impl)``: the heads are
88 wide, so "auto" takes the plain attention (the kernels take head_dim 128 only), as JAX
takes XLA's.

``HunyuanDiT`` holds the parameters under the reference names that JAX
``hunyuan_dit_params_from_torch`` reads: ``text_emb_padding``, ``t5_embedder.{0,2}``,
``t5_pooler.{positional_embedding, q_proj, k_proj, v_proj, c_proj}``, ``style_embedder``,
``patch_embedder.proj``, ``timestep_embedder.mlp.{0,2}``, ``extra_embedder.{0,2}``,
``blocks.{i}.{norm1, norm2, norm3, rota1.{q,k}_norm, rota2.{q,k}_norm,
attn{1,2}.to_{q,k,v,out}, modulation.1, mlp.{0,2}}`` (the up blocks also ``skip_norm``
and ``skip_linear``), ``final_layer.{linear, adaLN_modulation.1}``.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from goal_force_tpu_torch.models.wan_dit import (
    Activation,
    LayerNormAffine,
    empty_module,
    gelu_tanh,
    init_linear_,
    layer_norm,
    linear,
    silu_f32,
    sinusoidal_embedding,
)
from goal_force_tpu_torch.ops.attention import attention, plain_attention
from goal_force_tpu_torch.ops.rope import apply_rope


@dataclasses.dataclass(frozen=True)
class HunyuanDiTConfig:
    dim: int = 1408
    num_heads: int = 16
    num_layers_down: int = 21
    num_layers_up: int = 19
    in_channels: int = 4
    out_channels: int = 8
    text_dim: int = 1024
    t5_dim: int = 2048
    text_len: int = 77
    t5_len: int = 256
    mlp_ratio: float = 4.3637
    freq_dim: int = 256
    eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    @property
    def mlp_dim(self) -> int:
        return int(self.dim * self.mlp_ratio)


POOL_DIM = 1024      # the mT5 attention pool's output width
POOL_HEADS = 8


@lru_cache(maxsize=8)
def hunyuan_dit_rope(th: int, tw: int, head_dim: int, base_size: int = 32,
                     theta: float = 10000.0):
    """(S, head_dim // 2) float32 cos, sin of the (th, tw) patch grid fill-resized and
    centre-cropped into the base box; host float64."""
    if base_size / th < base_size / tw:
        rh, rw = base_size, int(round(base_size / th * tw))
    else:
        rw, rh = base_size, int(round(base_size / tw * th))
    top = int(round((base_size - rh) / 2.0))
    left = int(round((base_size - rw) / 2.0))
    grid_h = np.linspace(top, top + rh, th, endpoint=False, dtype=np.float64)
    grid_w = np.linspace(left, left + rw, tw, endpoint=False, dtype=np.float64)
    ww, hh = np.meshgrid(grid_w, grid_h)

    def axis(vals, d):
        freqs = 1.0 / theta ** (np.arange(0, d, 2, dtype=np.float64) / d)
        return np.outer(vals.reshape(-1), freqs)

    d2 = head_dim // 2
    ang = np.concatenate([axis(ww, d2), axis(hh, d2)], axis=-1)   # the W table first
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


# ---------------------------------------------------------------------------
# Modules (parameter holders under the reference names)
# ---------------------------------------------------------------------------

class HunyuanAttention(nn.Module):
    def __init__(self, dim: int, kv_dim: int):
        super().__init__()
        self.to_q = nn.Linear(dim, dim)
        self.to_k = nn.Linear(kv_dim, dim)
        self.to_v = nn.Linear(kv_dim, dim)
        self.to_out = nn.Linear(dim, dim)


class HeadNorms(nn.Module):
    def __init__(self, head_dim: int):
        super().__init__()
        self.q_norm = LayerNormAffine(head_dim)
        self.k_norm = LayerNormAffine(head_dim)


class HunyuanDiTBlock(nn.Module):
    def __init__(self, cfg: HunyuanDiTConfig, skip: bool = False):
        super().__init__()
        d, hd = cfg.dim, cfg.head_dim
        self.norm1, self.norm2, self.norm3 = (LayerNormAffine(d) for _ in range(3))
        self.rota1, self.rota2 = HeadNorms(hd), HeadNorms(hd)
        self.attn1 = HunyuanAttention(d, d)
        self.attn2 = HunyuanAttention(d, cfg.text_dim)
        self.modulation = nn.ModuleList([Activation(), nn.Linear(d, d)])
        self.mlp = nn.ModuleList([nn.Linear(d, cfg.mlp_dim), Activation(),
                                  nn.Linear(cfg.mlp_dim, d)])
        if skip:
            self.skip_norm = LayerNormAffine(2 * d)
            self.skip_linear = nn.Linear(2 * d, d)


class AttentionPool(nn.Module):
    def __init__(self, length: int, dim: int, out_dim: int = POOL_DIM):
        super().__init__()
        self.positional_embedding = nn.Parameter(torch.zeros(length + 1, dim))
        self.q_proj, self.k_proj, self.v_proj = (nn.Linear(dim, dim) for _ in range(3))
        self.c_proj = nn.Linear(dim, out_dim)


class PatchEmbed(nn.Module):
    def __init__(self, in_channels: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, dim, 2, stride=2)


class TimestepMLP(nn.Module):
    def __init__(self, freq_dim: int, dim: int):
        super().__init__()
        self.mlp = nn.ModuleList([nn.Linear(freq_dim, dim), Activation(), nn.Linear(dim, dim)])


class FinalLayer(nn.Module):
    def __init__(self, cfg: HunyuanDiTConfig):
        super().__init__()
        self.linear = nn.Linear(cfg.dim, 4 * cfg.out_channels)
        self.adaLN_modulation = nn.ModuleList([Activation(), nn.Linear(cfg.dim, 2 * cfg.dim)])


class HunyuanDiT(nn.Module):
    def __init__(self, cfg: HunyuanDiTConfig):
        super().__init__()
        d = cfg.dim
        self.text_emb_padding = nn.Parameter(torch.zeros(cfg.text_len + cfg.t5_len,
                                                         cfg.text_dim))
        self.t5_embedder = nn.ModuleList([nn.Linear(cfg.t5_dim, 4 * cfg.t5_dim), Activation(),
                                          nn.Linear(4 * cfg.t5_dim, cfg.text_dim)])
        self.t5_pooler = AttentionPool(cfg.t5_len, cfg.t5_dim)
        self.style_embedder = nn.Parameter(torch.zeros(d))
        self.patch_embedder = PatchEmbed(cfg.in_channels, d)
        self.timestep_embedder = TimestepMLP(cfg.freq_dim, d)
        self.extra_embedder = nn.ModuleList([nn.Linear(6 * 256 + POOL_DIM + d, 4 * d),
                                             Activation(), nn.Linear(4 * d, d)])
        self.blocks = nn.ModuleList(
            [HunyuanDiTBlock(cfg) for _ in range(cfg.num_layers_down)]
            + [HunyuanDiTBlock(cfg, skip=True) for _ in range(cfg.num_layers_up)])
        self.final_layer = FinalLayer(cfg)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _head_ln(p: LayerNormAffine, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The affine per-head LayerNorm over head_dim, in float32 throughout."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * p.weight.float() + p.bias.float()).to(x.dtype)


def _ln(p: LayerNormAffine, x: torch.Tensor) -> torch.Tensor:
    return layer_norm(x, 1e-6, p.weight, p.bias)


def _qkv(p: HunyuanAttention, x, ctx, n: int):
    b, s, _ = x.shape
    t = ctx.shape[1]
    return (linear(p.to_q, x).reshape(b, s, n, -1), linear(p.to_k, ctx).reshape(b, t, n, -1),
            linear(p.to_v, ctx).reshape(b, t, n, -1))


def hunyuan_dit_block(p: HunyuanDiTBlock, x, cond, text, cos, sin, cfg: HunyuanDiTConfig,
                      residual=None, attn_impl: str = "auto") -> torch.Tensor:
    n = cfg.num_heads
    if residual is not None:
        x = linear(p.skip_linear, _ln(p.skip_norm, torch.cat([x, residual], dim=-1)))
    shift = linear(p.modulation[1], silu_f32(cond))
    h = _ln(p.norm1, x) + shift[:, None]
    q, k, v = _qkv(p.attn1, h, h, n)
    q = apply_rope(_head_ln(p.rota1.q_norm, q), cos, sin)
    k = apply_rope(_head_ln(p.rota1.k_norm, k), cos, sin)
    x = x + linear(p.attn1.to_out, attention(q, k, v, impl=attn_impl).reshape(x.shape))

    q, k, v = _qkv(p.attn2, _ln(p.norm3, x), text, n)
    q = apply_rope(_head_ln(p.rota2.q_norm, q), cos, sin)     # q only
    k = _head_ln(p.rota2.k_norm, k)
    x = x + linear(p.attn2.to_out, attention(q, k, v, impl=attn_impl).reshape(x.shape))

    h = _ln(p.norm2, x)
    return x + linear(p.mlp[2], gelu_tanh(linear(p.mlp[0], h)))


def _attention_pool(p: AttentionPool, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The mean token prepended, the learned positions added, one multi-head attention of
    the mean's query over every token."""
    b, l, c = x.shape
    x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1)
    x = x + p.positional_embedding.to(x.dtype)[None]
    hd = c // num_heads
    q = linear(p.q_proj, x[:, :1]).reshape(b, 1, num_heads, hd)
    k = linear(p.k_proj, x).reshape(b, l + 1, num_heads, hd)
    v = linear(p.v_proj, x).reshape(b, l + 1, num_heads, hd)
    out = plain_attention(q, k, v, 1.0 / math.sqrt(hd)).reshape(b, c)
    return linear(p.c_proj, out)


def _mlp2(layers: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    """linear -> SiLU (float32) -> linear."""
    return linear(layers[2], silu_f32(linear(layers[0], x)))


def hunyuan_dit_forward(model: HunyuanDiT, cfg: HunyuanDiTConfig,
                        latents: torch.Tensor,         # (B, H, W, 4) channels-last
                        text_emb: torch.Tensor,        # (B, 77, 1024) CLIP hidden
                        text_emb_t5: torch.Tensor,     # (B, 256, 2048) mT5 hidden
                        text_mask: torch.Tensor,       # (B, 77)
                        text_mask_t5: torch.Tensor,    # (B, 256)
                        timestep: torch.Tensor,        # (B,)
                        size_emb: torch.Tensor,        # (B, 6) image-size conditioning
                        attn_impl: str = "auto") -> torch.Tensor:
    """The prediction (B, H, W, 4)."""
    b, h, w, _ = latents.shape
    th, tw = h // 2, w // 2
    dtype = model.final_layer.linear.weight.dtype
    dev = latents.device

    t5 = _mlp2(model.t5_embedder, text_emb_t5.to(dtype))
    text = torch.cat([text_emb.to(dtype), t5], dim=1)
    mask = torch.cat([text_mask, text_mask_t5], dim=-1).bool()
    text = torch.where(mask[..., None], text, model.text_emb_padding.to(dtype))

    pooled_t5 = _attention_pool(model.t5_pooler, text_emb_t5.to(dtype), POOL_HEADS)
    temb = _mlp2(model.timestep_embedder.mlp,
                 sinusoidal_embedding(cfg.freq_dim, timestep).to(dtype))
    semb = sinusoidal_embedding(256, size_emb.reshape(-1)).reshape(b, 6 * 256)
    style = model.style_embedder.to(dtype)[None].expand(b, cfg.dim)
    cond = temb + _mlp2(model.extra_embedder,
                        torch.cat([pooled_t5, semb.to(dtype), style], dim=-1))

    # the 2x2 patch conv as a matmul over (c, dy, dx) features
    x = latents.to(dtype).reshape(b, th, 2, tw, 2, cfg.in_channels)
    x = x.permute(0, 1, 3, 5, 2, 4).reshape(b, th * tw, cfg.in_channels * 4)
    pe = model.patch_embedder.proj
    x = F.linear(x, pe.weight.reshape(pe.weight.shape[0], -1), pe.bias)

    cos_np, sin_np = hunyuan_dit_rope(th, tw, cfg.head_dim)
    cos, sin = torch.as_tensor(cos_np, device=dev), torch.as_tensor(sin_np, device=dev)
    run = lambda blk, x, res=None: hunyuan_dit_block(blk, x, cond, text, cos, sin, cfg,
                                                     residual=res, attn_impl=attn_impl)
    down, up = model.blocks[:cfg.num_layers_down], model.blocks[cfg.num_layers_down:]
    skips = []
    for blk in down:
        x = run(blk, x)
        skips.append(x)
    # the outputs of down blocks 0 .. num_down - 3, popped last first
    skips = skips[:cfg.num_layers_down - 2]
    for blk in up:
        x = run(blk, x, skips.pop())

    fl = model.final_layer
    shift, scale = linear(fl.adaLN_modulation[1], silu_f32(cond)).chunk(2, dim=-1)
    x = layer_norm(x, cfg.eps) * (1 + scale[:, None]) + shift[:, None]
    x = linear(fl.linear, x)
    x = x.reshape(b, th, tw, 2, 2, cfg.out_channels).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, cfg.out_channels)[..., :cfg.out_channels // 2]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_hunyuan_dit(cfg: HunyuanDiTConfig, gen: torch.Generator, dtype=torch.bfloat16, *,
                     device) -> HunyuanDiT:
    """Random weights with JAX's distributions, drawn from `gen`: uniform ±1/sqrt(fan_in)
    linears with zero biases (the pool's N(0, 0.02²)), unit LayerNorms, N(0, 1) padding
    and style embeddings, the pool's positions N(0, 1 / t5_dim). The released widths hold
    1.5 B parameters (3.0 GB in bf16)."""
    model = empty_module(HunyuanDiT, cfg, dtype=dtype, device=device)
    pool = model.t5_pooler
    for m in model.modules():
        if isinstance(m, nn.Linear):
            if any(m is x for x in (pool.q_proj, pool.k_proj, pool.v_proj, pool.c_proj)):
                m.weight.normal_(generator=gen).mul_(0.02)
                m.bias.zero_()
            else:
                init_linear_(m, gen)
        elif isinstance(m, LayerNormAffine):
            m.weight.fill_(1.0)
            m.bias.zero_()
    pe = model.patch_embedder.proj
    pe.weight.uniform_(-1.0, 1.0, generator=gen).mul_(1.0 / math.sqrt(4 * cfg.in_channels))
    pe.bias.zero_()
    model.text_emb_padding.normal_(generator=gen)
    model.style_embedder.normal_(generator=gen)
    pool.positional_embedding.normal_(generator=gen).mul_(cfg.t5_dim ** -0.5)
    return model.eval().requires_grad_(False)
