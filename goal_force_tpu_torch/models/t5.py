"""umt5-xxl and T5 v1.1 text encoders in PyTorch.

Port of ``goal_force_tpu/models/t5.py``: RMS-style T5 layer norm in float32, unscaled
attention with an additive relative-position bias and float32 softmax (a plain einsum:
it is a few hundred tokens, not a kernel), and the gated tanh-GELU feed-forward. umt5
has a relative-position embedding per layer; T5 v1.1 (``shared_pos``: CogVideoX, Flux,
SD3) has one, computed once and added in every layer.
Parameter names follow the reference text-encoder checkpoint (``token_embedding``,
``blocks.{i}.attn.q``, ``blocks.{i}.ffn.gate.0``, ``blocks.{i}.pos_embedding.embedding``,
or with ``shared_pos`` the one top-level ``pos_embedding.embedding``).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
from torch import nn

from goal_force_tpu_torch.configs import T5Config
from goal_force_tpu_torch.models.wan_dit import Activation, empty_module
from goal_force_tpu_torch.parallel import fsdp


def t5_layer_norm(x, w, eps: float = 1e-6):
    """RMS norm in float32, cast to the weight's dtype before scaling."""
    xf = x.float()
    n = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return w * n.to(w.dtype)


def t5_gelu(x):
    xf = x.float()
    out = 0.5 * xf * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (xf + 0.044715 * xf**3)))
    return out.to(x.dtype)


@lru_cache(maxsize=4)
def relative_buckets(lq: int, lk: int, num_buckets: int = 32, max_dist: int = 128) -> np.ndarray:
    """Static (Lq, Lk) int32 bucket matrix, bidirectional."""
    rel = np.arange(lk)[None, :] - np.arange(lq)[:, None]
    nb = num_buckets // 2
    buckets = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    max_exact = nb // 2
    large = max_exact + (
        np.log(np.maximum(rel, 1) / max_exact) / math.log(max_dist / max_exact) * (nb - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, nb - 1)
    buckets += np.where(rel < max_exact, rel, large)
    return buckets.astype(np.int32)


class _RelEmbedding(nn.Module):
    def __init__(self, num_buckets: int, num_heads: int):
        super().__init__()
        self.embedding = nn.Embedding(num_buckets, num_heads)


class _Norm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))


class T5Attention(nn.Module):
    def __init__(self, dim: int, dim_attn: int):
        super().__init__()
        self.q = nn.Linear(dim, dim_attn, bias=False)
        self.k = nn.Linear(dim, dim_attn, bias=False)
        self.v = nn.Linear(dim, dim_attn, bias=False)
        self.o = nn.Linear(dim_attn, dim, bias=False)


class T5FeedForward(nn.Module):
    def __init__(self, dim: int, dim_ffn: int):
        super().__init__()
        self.gate = nn.Sequential(nn.Linear(dim, dim_ffn, bias=False), Activation())
        self.fc1 = nn.Linear(dim, dim_ffn, bias=False)
        self.fc2 = nn.Linear(dim_ffn, dim, bias=False)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.norm1 = _Norm(cfg.dim)
        self.attn = T5Attention(cfg.dim, cfg.dim_attn)
        self.norm2 = _Norm(cfg.dim)
        self.ffn = T5FeedForward(cfg.dim, cfg.dim_ffn)
        if not cfg.shared_pos:
            self.pos_embedding = _RelEmbedding(cfg.num_buckets, cfg.num_heads)


class T5Encoder(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab, cfg.dim)
        if cfg.shared_pos:
            self.pos_embedding = _RelEmbedding(cfg.num_buckets, cfg.num_heads)
        self.blocks = nn.ModuleList(T5Block(cfg) for _ in range(cfg.num_layers))
        self.norm = _Norm(cfg.dim)


def t5_attention(p: T5Attention, x, bias, num_heads: int):
    """Unscaled attention with additive bias, float32 softmax."""
    b, l, _ = x.shape
    q = (x @ p.q.weight.t()).reshape(b, l, num_heads, -1)
    k = (x @ p.k.weight.t()).reshape(b, l, num_heads, -1)
    v = (x @ p.v.weight.t()).reshape(b, l, num_heads, -1)
    logits = torch.einsum("binc,bjnc->bnij", q.float(), k.float()) + bias.float()
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bnij,bjnc->binc", probs, v).reshape(b, l, -1)
    return out @ p.o.weight.t()


def _pos_bias(emb: _RelEmbedding, buckets):
    return emb.embedding.weight[buckets].permute(2, 0, 1)[None]   # (1, H, L, L)


def t5_block(p: T5Block, x, mask_bias, buckets, num_heads: int, pos_bias=None):
    """One encoder block; `pos_bias` (1, H, L, L) replaces the block's own relative bias
    (``shared_pos``)."""
    if pos_bias is None:
        pos_bias = _pos_bias(p.pos_embedding, buckets)
    h = t5_layer_norm(x, p.norm1.weight)
    x = x + t5_attention(p.attn, h, pos_bias + mask_bias, num_heads)
    h = t5_layer_norm(x, p.norm2.weight)
    ff = (h @ p.ffn.fc1.weight.t()) * t5_gelu(h @ p.ffn.gate[0].weight.t())
    return x + ff @ p.ffn.fc2.weight.t()


def t5_encode(model: T5Encoder, cfg: T5Config, ids: torch.Tensor, mask: torch.Tensor):
    """ids, mask: (B, L) int -> embeddings (B, L, dim). The caller zeroes the positions
    past each prompt's length. An FSDP-placed encoder (``parallel/fsdp.py``) has its
    embedding and final norm gathered once and each block's weights before the block."""
    model = fsdp.gathered(model, skip=("blocks",), tp=False)
    x = model.token_embedding.weight[ids.long()]
    l = ids.shape[1]
    buckets = torch.from_numpy(relative_buckets(l, l, cfg.num_buckets, cfg.rel_max_dist)
                               ).long().to(ids.device)
    neg = torch.finfo(torch.float32).min
    mask_bias = torch.where(mask[:, None, None, :] == 0, neg, 0.0).float()
    shared = _pos_bias(model.pos_embedding, buckets) if cfg.shared_pos else None
    for blk in model.blocks:
        x = t5_block(fsdp.gathered(blk, tp=False), x, mask_bias, buckets, cfg.num_heads,
                     shared)
    return t5_layer_norm(x, model.norm.weight)


@torch.no_grad()
def init_t5(cfg: T5Config, gen: torch.Generator, dtype=torch.bfloat16, *,
            device) -> T5Encoder:
    """Random weights with the JAX init's distributions."""
    model = empty_module(T5Encoder, cfg, dtype=dtype, device=device)

    def normal_(w, std):
        w.normal_(generator=gen).mul_(std)

    pos_std = (2 * cfg.num_buckets * cfg.num_heads) ** -0.5
    for blk in model.blocks:
        blk.norm1.weight.fill_(1.0)
        blk.norm2.weight.fill_(1.0)
        normal_(blk.attn.q.weight, (cfg.dim * cfg.dim_attn) ** -0.5)
        normal_(blk.attn.k.weight, cfg.dim**-0.5)
        normal_(blk.attn.v.weight, cfg.dim**-0.5)
        normal_(blk.attn.o.weight, (cfg.num_heads * cfg.dim_attn) ** -0.5)
        normal_(blk.ffn.gate[0].weight, cfg.dim**-0.5)
        normal_(blk.ffn.fc1.weight, cfg.dim**-0.5)
        normal_(blk.ffn.fc2.weight, cfg.dim_ffn**-0.5)
        if not cfg.shared_pos:
            normal_(blk.pos_embedding.embedding.weight, pos_std)
    if cfg.shared_pos:
        normal_(model.pos_embedding.embedding.weight, pos_std)
    normal_(model.token_embedding.weight, 1.0)
    model.norm.weight.fill_(1.0)
    return model.eval().requires_grad_(False)
