"""Wan video DiT in PyTorch.

Port of ``goal_force_tpu/models/wan_dit.py`` (main path, the Fun-Reference ``ref_conv``
and the int8/fp8 packs of ``ops/quant.py``; no pipeline parallelism, no CLIP image
branch). Modules hold the parameters under the reference
("civitai") state-dict names that ``goal_force_tpu/io/torch_convert.py`` reads, so a
reference-format state dict loads directly. The computation is written as functions
over those modules, one per JAX function, with the same dtype steps:

- channels-last (B, F, H, W, C) latents; patchify is a reshape + matmul over flattened
  patches in (c, dy, dx) feature order (the Conv3d weight's own order);
- RMSNorm / LayerNorm statistics in float32, cast back before the weight multiply;
  GELU(tanh) and SiLU in float32;
- RoPE from float32 cos/sin tables; attention through ``ops.attention``.
"""

from __future__ import annotations

import math
from functools import partial
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from goal_force_tpu_torch.configs import WanDiTConfig
from goal_force_tpu_torch.ops.attention import attention
from goal_force_tpu_torch.ops.quant import QuantLinear
from goal_force_tpu_torch.ops.rope import apply_rope, assemble_rope, rope_tables_3d


# ---------------------------------------------------------------------------
# Primitive layers
# ---------------------------------------------------------------------------

def linear(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """An ``nn.Linear``, or an int8/fp8 pack (``ops/quant.py``), as JAX's ``linear``
    dispatches on its "w_i8"/"w_f8" leaves."""
    if isinstance(layer, QuantLinear):
        return layer(x)
    return F.linear(x, layer.weight, layer.bias)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Normalize in float32, cast to x.dtype, then multiply by the weight."""
    xf = x.float()
    n = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return n.to(x.dtype) * w


def layer_norm(x: torch.Tensor, eps: float = 1e-6, w=None, b=None) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    out = ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)
    if w is not None:
        out = out * w + b
    return out


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    out = 0.5 * xf * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (xf + 0.044715 * xf**3)))
    return out.to(x.dtype)


def silu_f32(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x.float()).to(x.dtype)


def sinusoidal_embedding(dim: int, position: torch.Tensor) -> torch.Tensor:
    """float32 cos||sin table of the positions."""
    pos = position.float()
    half = dim // 2
    freqs = torch.pow(torch.tensor(10000.0, device=pos.device),
                      -torch.arange(half, dtype=torch.float32, device=pos.device) / half)
    sinusoid = torch.outer(pos, freqs)
    return torch.cat([torch.cos(sinusoid), torch.sin(sinusoid)], dim=1)


# ---------------------------------------------------------------------------
# Modules (parameter holders under the reference names)
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))


class LayerNormAffine(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


class Activation(nn.Module):
    """Parameter-free slot that keeps the reference's Sequential indices."""


class WanAttention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.o = nn.Linear(dim, dim)
        self.norm_q = RMSNorm(dim)
        self.norm_k = RMSNorm(dim)


class WanBlock(nn.Module):
    def __init__(self, cfg: WanDiTConfig):
        super().__init__()
        self.self_attn = WanAttention(cfg.dim)
        self.cross_attn = WanAttention(cfg.dim)
        self.norm3 = LayerNormAffine(cfg.dim)
        self.ffn = nn.Sequential(nn.Linear(cfg.dim, cfg.ffn_dim), Activation(),
                                 nn.Linear(cfg.ffn_dim, cfg.dim))
        self.modulation = nn.Parameter(torch.zeros(1, 6, cfg.dim))


class WanHead(nn.Module):
    def __init__(self, cfg: WanDiTConfig):
        super().__init__()
        self.head = nn.Linear(cfg.dim, cfg.out_dim * math.prod(cfg.patch_size))
        self.modulation = nn.Parameter(torch.zeros(1, 2, cfg.dim))


class WanDiT(nn.Module):
    """ref_conv_in > 0 adds the Fun-Reference ``ref_conv`` (Conv2d(ref_conv_in, dim, 2,
    stride 2)); a model has it where its state dict does."""

    def __init__(self, cfg: WanDiTConfig, ref_conv_in: int = 0):
        super().__init__()
        self.cfg = cfg
        if ref_conv_in:
            self.ref_conv = nn.Conv2d(ref_conv_in, cfg.dim, 2, 2)
        self.patch_embedding = nn.Conv3d(cfg.in_dim, cfg.dim, cfg.patch_size, cfg.patch_size)
        self.text_embedding = nn.Sequential(nn.Linear(cfg.text_dim, cfg.dim), Activation(),
                                            nn.Linear(cfg.dim, cfg.dim))
        self.time_embedding = nn.Sequential(nn.Linear(cfg.freq_dim, cfg.dim), Activation(),
                                            nn.Linear(cfg.dim, cfg.dim))
        self.time_projection = nn.Sequential(Activation(), nn.Linear(cfg.dim, cfg.dim * 6))
        self.blocks = nn.ModuleList(WanBlock(cfg) for _ in range(cfg.num_layers))
        self.head = WanHead(cfg)


# ---------------------------------------------------------------------------
# Patchify (Conv3d with kernel == stride is a matmul over flattened patches)
# ---------------------------------------------------------------------------

def patchify(conv: nn.Conv3d, x: torch.Tensor, patch_size: Tuple[int, int, int]):
    """x: (B, F, H, W, C) -> tokens (B, F*h*w, D), grid (F, h, w)."""
    pf, ph, pw = patch_size
    b, f, hh, ww, c = x.shape
    fo, ho, wo = f // pf, hh // ph, ww // pw
    x = x.reshape(b, fo, pf, ho, ph, wo, pw, c).permute(0, 1, 3, 5, 7, 2, 4, 6)
    x = x.reshape(b, fo * ho * wo, c * pf * ph * pw)
    w = conv.weight.reshape(conv.weight.shape[0], -1)
    return F.linear(x, w, conv.bias), (fo, ho, wo)


def unpatchify(x: torch.Tensor, grid, patch_size, out_dim: int) -> torch.Tensor:
    """(B, S, prod(patch)*out_dim) -> (B, F, H, W, C); feature order (pf, ph, pw, c)."""
    pf, ph, pw = patch_size
    b = x.shape[0]
    f, h, w = grid
    x = x.reshape(b, f, h, w, pf, ph, pw, out_dim).permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, f * pf, h * ph, w * pw, out_dim)


# ---------------------------------------------------------------------------
# DiT block
# ---------------------------------------------------------------------------

def self_attention(p: WanAttention, x, cos, sin, num_heads: int, eps: float,
                   attn_impl: str = "auto", bounded: bool = False):
    b, s, d = x.shape
    q = rms_norm(linear(p.q, x), p.norm_q.weight, eps).reshape(b, s, num_heads, -1)
    k = rms_norm(linear(p.k, x), p.norm_k.weight, eps).reshape(b, s, num_heads, -1)
    v = linear(p.v, x).reshape(b, s, num_heads, -1)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    out = attention(q, k, v, impl=attn_impl, bounded=bounded)
    return linear(p.o, out.reshape(b, s, d))


def cross_attention(p: WanAttention, x, context, num_heads: int, eps: float,
                    attn_impl: str = "auto", bounded: bool = False):
    """Text cross-attention over every context token (no mask)."""
    b, s, d = x.shape
    t = context.shape[1]
    q = rms_norm(linear(p.q, x), p.norm_q.weight, eps).reshape(b, s, num_heads, -1)
    k = rms_norm(linear(p.k, context), p.norm_k.weight, eps).reshape(b, t, num_heads, -1)
    v = linear(p.v, context).reshape(b, t, num_heads, -1)
    out = attention(q, k, v, impl=attn_impl, bounded=bounded).reshape(b, s, d)
    return linear(p.o, out)


def dit_block(p: WanBlock, x, context, t_mod, cos, sin, cfg: WanDiTConfig,
              attn_impl: str = "auto"):
    """One DiT block with 6-way AdaLN modulation. t_mod: (B, 6, D)."""
    mod = p.modulation.to(t_mod.dtype) + t_mod                 # (B, 6, D)
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = (
        mod[:, i][:, None, :] for i in range(6))
    h = layer_norm(x, cfg.eps) * (1 + scale_msa) + shift_msa
    x = x + gate_msa * self_attention(p.self_attn, h, cos, sin, cfg.num_heads, cfg.eps,
                                      attn_impl, bounded=cfg.qk_bounded)
    x = x + cross_attention(p.cross_attn, layer_norm(x, cfg.eps, p.norm3.weight, p.norm3.bias),
                            context, cfg.num_heads, cfg.eps, attn_impl,
                            bounded=cfg.qk_bounded)
    h = layer_norm(x, cfg.eps) * (1 + scale_mlp) + shift_mlp
    return x + gate_mlp * feed_forward(p, h)


FFN_CHUNK_TOKENS = 16384


def feed_forward(p: WanBlock, h: torch.Tensor) -> torch.Tensor:
    """The block's GELU(tanh) MLP, over chunks of at most FFN_CHUNK_TOKENS tokens. It acts
    on each token alone, so the chunks compute the same function; only one chunk's float32
    GELU temporaries are alive at a time (XLA fuses the GELU and keeps none), which at
    65,520 tokens and ffn_dim 13,824 is 0.9 GB each instead of 3.6 GB."""
    rows = h.reshape(-1, h.shape[-1])
    out = [linear(p.ffn[2], gelu_tanh(linear(p.ffn[0], c)))
           for c in rows.split(FFN_CHUNK_TOKENS)]
    return (out[0] if len(out) == 1 else torch.cat(out)).reshape(*h.shape[:-1], -1)


def _block_with_weights(block_weights, i, blk, *args):
    return dit_block(block_weights(i, blk), *args)


def run_blocks(blocks: Sequence[WanBlock], x, context, t_mod, cos, sin, cfg: WanDiTConfig,
               injections: Optional[List[torch.Tensor]] = None, attn_impl: str = "auto",
               remat: bool = False, block_weights=None, start: int = 0,
               stop: Optional[int] = None):
    """Run x through blocks[start:stop]; injections[i] (the ControlNet outputs) is added
    after block i for every i < len(injections). Indices are the blocks' own in
    `blocks`, so a segment's block i still gets injections[i] and block_weights(i, ...).

    remat: recompute each block in the backward pass instead of keeping its activations
    (one non-reentrant checkpoint per block, as JAX checkpoints each scan body). The
    forward then already sees grad-requiring inputs, so attention takes K3 there too.
    block_weights: ``block_weights(i, blk)`` gives the block that runs in place of block
    i, called inside the block's checkpoint (LoRA's merged weights).
    """
    n_inj = 0 if injections is None else len(injections)
    for i in range(start, len(blocks) if stop is None else stop):
        blk = blocks[i]
        fn = dit_block if block_weights is None else partial(_block_with_weights,
                                                             block_weights, i)
        if remat:
            x = checkpoint(fn, blk, x, context, t_mod, cos, sin, cfg, attn_impl,
                           use_reentrant=False)
        else:
            x = fn(blk, x, context, t_mod, cos, sin, cfg, attn_impl)
        if i < n_inj:
            x = x + injections[i].to(x.dtype)
    return x


def head(p: WanHead, x, t, eps: float = 1e-6):
    """Final projection with 2-way modulation. t: (B, D)."""
    mod = p.modulation.to(t.dtype) + t[:, None, :]             # (B, 2, D)
    shift, scale = mod[:, 0][:, None, :], mod[:, 1][:, None, :]
    return linear(p.head, layer_norm(x, eps) * (1 + scale) + shift)


def time_embed(model: WanDiT, cfg: WanDiTConfig, timestep: torch.Tensor, dtype=None):
    """timestep (B,) -> t (B, D), t_mod (B, 6, D)."""
    emb = sinusoidal_embedding(cfg.freq_dim, timestep)
    emb = emb.to(dtype if dtype is not None else model.time_embedding[0].weight.dtype)
    t = linear(model.time_embedding[0], emb)
    t = linear(model.time_embedding[2], silu_f32(t))
    t_mod = linear(model.time_projection[1], silu_f32(t))
    return t, t_mod.reshape(t.shape[0], 6, cfg.dim)


def text_embed(model: WanDiT, x):
    return linear(model.text_embedding[2], gelu_tanh(linear(model.text_embedding[0], x)))


def rope_for_grid(cfg: WanDiTConfig, grid, device):
    tables = rope_tables_3d(cfg.head_dim, cfg.rope_max_len)
    return assemble_rope(tables, *grid, device=device)


def wan_dit_forward(model: WanDiT, cfg: WanDiTConfig, x, timestep, context, y=None,
                    attn_impl: str = "auto"):
    """Base-model velocity (B, F, H, W, out_dim) for latents x (B, F, H, W, C),
    timestep (B,), context (B, L, text_dim) and optional conditioning y."""
    t, t_mod = time_embed(model, cfg, timestep)
    context = text_embed(model, context)
    if y is not None:
        x = torch.cat([x, y.to(x.dtype)], dim=-1)
    tokens, grid = patchify(model.patch_embedding, x, cfg.patch_size)
    cos, sin = rope_for_grid(cfg, grid, tokens.device)
    tokens = run_blocks(model.blocks, tokens, context, t_mod, cos, sin, cfg,
                        attn_impl=attn_impl)
    out = head(model.head, tokens, t, cfg.eps)
    return unpatchify(out, grid, cfg.patch_size, cfg.out_dim)


# ---------------------------------------------------------------------------
# Random init (the JAX package's distributions)
# ---------------------------------------------------------------------------

def empty_module(cls, *args, dtype=torch.float32, device, **kwargs):
    """Build a module without running its default initialisers."""
    with torch.device("meta"):
        mod = cls(*args, **kwargs)
    return mod.to(dtype=dtype).to_empty(device=device)


def init_linear_(layer: nn.Linear, gen: torch.Generator, d_in: Optional[int] = None):
    scale = 1.0 / math.sqrt(d_in or layer.weight.shape[1])
    layer.weight.uniform_(-scale, scale, generator=gen)
    if layer.bias is not None:
        layer.bias.zero_()


@torch.no_grad()
def init_block_(blk: WanBlock, gen: torch.Generator):
    for attn_mod in (blk.self_attn, blk.cross_attn):
        for lin in (attn_mod.q, attn_mod.k, attn_mod.v, attn_mod.o):
            init_linear_(lin, gen)
        attn_mod.norm_q.weight.fill_(1.0)
        attn_mod.norm_k.weight.fill_(1.0)
    blk.norm3.weight.fill_(1.0)
    blk.norm3.bias.zero_()
    init_linear_(blk.ffn[0], gen)
    init_linear_(blk.ffn[2], gen)
    dim = blk.modulation.shape[-1]
    blk.modulation.normal_(generator=gen).div_(dim**0.5)


@torch.no_grad()
def init_patch_embedding_(conv: nn.Conv3d, gen: torch.Generator):
    fan_in = conv.weight[0].numel()
    scale = 1.0 / math.sqrt(fan_in)
    conv.weight.uniform_(-scale, scale, generator=gen)
    conv.bias.zero_()


def dit_kwargs(sd) -> dict:
    """WanDiT's optional parts that a reference-format state dict holds."""
    return {"ref_conv_in": sd["ref_conv.weight"].shape[1]} if "ref_conv.weight" in sd else {}


def reference_tokens(conv: nn.Conv2d, latents: torch.Tensor) -> torch.Tensor:
    """Fun-Reference: latents (B, h, w, z) -> tokens (B, h/2 * w/2, D), each 2 x 2 patch
    flattened in (c, dy, dx) order through the 2 x 2 / stride-2 ``ref_conv``."""
    b, hh, ww, c = latents.shape
    r = latents.reshape(b, hh // 2, 2, ww // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
    r = r.reshape(b, (hh // 2) * (ww // 2), c * 4)
    return F.linear(r, conv.weight.reshape(conv.weight.shape[0], -1), conv.bias)


@torch.no_grad()
def init_ref_conv_(model: WanDiT, z_dim: int, gen: torch.Generator) -> WanDiT:
    """Give `model` a Fun-Reference ref_conv with uniform +-1/sqrt(fan_in) weights."""
    w = model.patch_embedding.weight
    model.ref_conv = nn.Conv2d(z_dim, model.cfg.dim, 2, 2, dtype=w.dtype, device=w.device)
    init_patch_embedding_(model.ref_conv, gen)
    model.ref_conv.requires_grad_(False)
    return model


@torch.no_grad()
def init_wan_dit(cfg: WanDiTConfig, gen: torch.Generator, dtype=torch.bfloat16, *,
                 device) -> WanDiT:
    """Random weights with the JAX init's distributions (uniform +-1/sqrt(fan_in) linears,
    zero biases, unit norms, N(0, 1/dim) modulations), drawn from `gen`."""
    model = empty_module(WanDiT, cfg, dtype=dtype, device=device)
    init_patch_embedding_(model.patch_embedding, gen)
    for lin in (model.text_embedding[0], model.text_embedding[2], model.time_embedding[0],
                model.time_embedding[2], model.time_projection[1], model.head.head):
        init_linear_(lin, gen)
    for blk in model.blocks:
        init_block_(blk, gen)
    model.head.modulation.normal_(generator=gen).div_(cfg.dim**0.5)
    return model.eval().requires_grad_(False)
