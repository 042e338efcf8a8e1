"""OmniGen in PyTorch: a Phi-3 decoder as the diffusion backbone.

Port of ``goal_force_tpu/models/omnigen.py``:

  - the 2D sincos position embedding over the 192 x 192 grid at base size 64 (the W half
    first), centre-cropped to the image (``cropped_pos_embed``, over the crop's
    coordinates only; host float64 -> float32);
  - ``omnigen_timestep_embedding`` (cos before sin) and ``_time_mlp`` (the time token and
    the final layer's condition);
  - the Phi-3 stack: RMSNorm, fused ``qkv_proj``, split-half rotary with the "su"
    (LongRoPE) tables (``_su_rope_tables``, host float64: the long factors when the WHOLE
    sequence, cached prefix included, exceeds ``original_max_positions``, cos and sin
    scaled by sqrt(1 + ln(max / orig) / ln(orig)); indexed by the absolute position ids),
    fused ``gate_up_proj`` SwiGLU; every key under the (B, S_q, S_kv) 0/1 mask as an
    additive float32 bias of finfo.min (``_phi3_block``, ``phi3_run``);
  - the condition-prefix cache: ``phi3_run(keep_prefix=)`` returns each layer's first
    keep_prefix keys (after rope) and values, and ``past_kv=`` puts them before the new
    keys, so a later step feeds only [time token, image] with its rows of the mask;
  - ``_patch_embed`` (the 2x2 conv as a matmul over (c, dy, dx) features),
    ``omnigen_unpatchify`` ((dy, dx, c) features) and ``omnigen_forward`` (the sequence
    [text with the reference images' latents spliced in, time token, image], the final
    adaLN over the image tokens).

The attention is the plain one (``ops/attention.py::plain_attention``, head_dim 96), as
JAX forms it with einsums. ``OmniGen`` holds the parameters under the checkpoint's names:
``llm.{embed_tokens, layers.{i}.{input_layernorm, self_attn.{qkv_proj, o_proj},
post_attention_layernorm, mlp.{gate_up_proj, down_proj}}, norm}``, ``x_embedder.proj``,
``input_x_embedder.proj``, ``time_token.mlp.{0,2}``, ``t_embedder.mlp.{0,2}``,
``final_layer.{adaLN_modulation.1, linear}``.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from goal_force_tpu_torch.models.wan_dit import (
    Activation,
    RMSNorm,
    empty_module,
    layer_norm,
    linear,
    rms_norm,
    silu_f32,
)
from goal_force_tpu_torch.ops.attention import plain_attention


@dataclasses.dataclass(frozen=True)
class OmniGenConfig:
    """Phi-3's geometry as OmniGen-v1 uses it."""

    hidden_size: int = 3072
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    intermediate_size: int = 8192
    vocab: int = 32064
    eps: float = 1e-5
    rope_theta: float = 10000.0
    original_max_positions: int = 4096
    max_positions: int = 131072
    rope_short_factor: Optional[Tuple[float, ...]] = None
    rope_long_factor: Optional[Tuple[float, ...]] = None
    patch_size: int = 2
    in_channels: int = 4
    pos_embed_max_size: int = 192
    pe_interpolation: float = 1.0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


# ---------------------------------------------------------------------------
# Modules (parameter holders under the checkpoint's names)
# ---------------------------------------------------------------------------

class Phi3Attention(nn.Module):
    def __init__(self, cfg: OmniGenConfig):
        super().__init__()
        d, hd = cfg.hidden_size, cfg.head_dim
        self.qkv_proj = nn.Linear(d, (cfg.num_heads + 2 * cfg.num_kv_heads) * hd, bias=False)
        self.o_proj = nn.Linear(cfg.num_heads * hd, d, bias=False)


class Phi3MLP(nn.Module):
    def __init__(self, cfg: OmniGenConfig):
        super().__init__()
        self.gate_up_proj = nn.Linear(cfg.hidden_size, 2 * cfg.intermediate_size, bias=False)
        self.down_proj = nn.Linear(cfg.intermediate_size, cfg.hidden_size, bias=False)


class Phi3Layer(nn.Module):
    def __init__(self, cfg: OmniGenConfig):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size)
        self.self_attn = Phi3Attention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size)
        self.mlp = Phi3MLP(cfg)


class Phi3Model(nn.Module):
    def __init__(self, cfg: OmniGenConfig):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab, cfg.hidden_size)
        self.layers = nn.ModuleList(Phi3Layer(cfg) for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size)


class PatchEmbedMR(nn.Module):
    def __init__(self, cfg: OmniGenConfig):
        super().__init__()
        p = cfg.patch_size
        self.proj = nn.Conv2d(cfg.in_channels, cfg.hidden_size, p, stride=p)


class TimeMLP(nn.Module):
    def __init__(self, dim: int, freq_dim: int = 256):
        super().__init__()
        self.mlp = nn.ModuleList([nn.Linear(freq_dim, dim), Activation(), nn.Linear(dim, dim)])


class OmniGenFinalLayer(nn.Module):
    def __init__(self, cfg: OmniGenConfig):
        super().__init__()
        d = cfg.hidden_size
        self.adaLN_modulation = nn.ModuleList([Activation(), nn.Linear(d, 2 * d)])
        self.linear = nn.Linear(d, cfg.patch_size ** 2 * cfg.in_channels)


class OmniGen(nn.Module):
    def __init__(self, cfg: OmniGenConfig):
        super().__init__()
        self.llm = Phi3Model(cfg)
        self.x_embedder = PatchEmbedMR(cfg)
        self.input_x_embedder = PatchEmbedMR(cfg)
        self.time_token = TimeMLP(cfg.hidden_size)
        self.t_embedder = TimeMLP(cfg.hidden_size)
        self.final_layer = OmniGenFinalLayer(cfg)


# ---------------------------------------------------------------------------
# Positional and timestep embeddings
# ---------------------------------------------------------------------------

def _sincos_1d(dim: int, pos: np.ndarray) -> np.ndarray:
    omega = 1.0 / 10000.0 ** (np.arange(dim // 2, dtype=np.float64) / (dim / 2.0))
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def _grid_embed(dim: int, coords_h: np.ndarray, coords_w: np.ndarray) -> np.ndarray:
    """(len(h) * len(w), dim) float32 over the (h, w) grid, row-major: the first half of
    the features from the W coordinates, the second from the H coordinates."""
    gw, gh = np.meshgrid(coords_w, coords_h)
    return np.concatenate([_sincos_1d(dim // 2, gw), _sincos_1d(dim // 2, gh)],
                          axis=1).astype(np.float32)


@lru_cache(maxsize=8)
def cropped_pos_embed(cfg: OmniGenConfig, height: int, width: int) -> np.ndarray:
    """(1, h * w, dim) float32: the centre crop, for a latent of (height, width), of the
    max-size grid's table (the grid scaled by 64 / pos_embed_max_size), computed over the
    crop's coordinates only: each entry depends on its own (row, column) alone, so it
    equals JAX's crop of ``omnigen_pos_embed``'s whole table."""
    h, w = height // cfg.patch_size, width // cfg.patch_size
    g = cfg.pos_embed_max_size
    coords = np.arange(g, dtype=np.float32) / (g / 64) / cfg.pe_interpolation
    top, left = (g - h) // 2, (g - w) // 2
    return _grid_embed(cfg.hidden_size, coords[top:top + h],
                       coords[left:left + w]).reshape(1, h * w, -1)


def omnigen_timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """cos-first float32 sinusoid (B, dim)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    ang = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def _time_mlp(p: TimeMLP, t: torch.Tensor, dtype) -> torch.Tensor:
    h = omnigen_timestep_embedding(t, 256).to(dtype)
    return linear(p.mlp[2], F.silu(linear(p.mlp[0], h)))


# ---------------------------------------------------------------------------
# Phi-3 decoder
# ---------------------------------------------------------------------------

@lru_cache(maxsize=8)
def _su_rope_tables(cfg: OmniGenConfig, seq_len: int):
    """Phi-3's "su" (LongRoPE) tables (seq_len, head_dim // 2), host float64 -> float32:
    the per-dim factors (long past the original window, else short, else 1) divide the
    inverse frequencies; cos and sin are amplified by sqrt(1 + ln(scale) / ln(orig))
    where the trained context exceeds the original window."""
    d = cfg.head_dim
    if seq_len > cfg.original_max_positions and cfg.rope_long_factor:
        ext = np.asarray(cfg.rope_long_factor, np.float64)
    elif cfg.rope_short_factor:
        ext = np.asarray(cfg.rope_short_factor, np.float64)
    else:
        ext = np.ones((d // 2,), np.float64)
    inv_freq = 1.0 / (ext * cfg.rope_theta ** (np.arange(0, d, 2, dtype=np.float64) / d))
    scale = cfg.max_positions / cfg.original_max_positions
    amp = 1.0 if scale <= 1.0 else math.sqrt(
        1.0 + math.log(scale) / math.log(cfg.original_max_positions))
    ang = np.outer(np.arange(seq_len, dtype=np.float64), inv_freq)
    return (np.cos(ang) * amp).astype(np.float32), (np.sin(ang) * amp).astype(np.float32)


def _rope_halves(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Split-half rotary in float32, cos/sin (S, d/2) over both halves; x (B, S, N, D)."""
    c = torch.cat([cos, cos], dim=-1)[None, :, None, :]
    s = torch.cat([sin, sin], dim=-1)[None, :, None, :]
    xf = x.float()
    a, b = xf.chunk(2, dim=-1)
    return (xf * c + torch.cat([-b, a], dim=-1) * s).to(x.dtype)


def _phi3_block(p: Phi3Layer, x, mask_bias, cos, sin, cfg: OmniGenConfig,
                past_kv=None, keep_prefix: int = 0):
    """past_kv: the cached condition prefix's (k, v), (B, S_past, nk, hd) after rope; the
    new keys go behind them. keep_prefix > 0 also returns this layer's first keep_prefix
    keys and values."""
    b, s, _ = x.shape
    n, nk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    h = rms_norm(x, p.input_layernorm.weight, cfg.eps)
    q, k, v = linear(p.self_attn.qkv_proj, h).split([n * hd, nk * hd, nk * hd], dim=-1)
    q = _rope_halves(q.reshape(b, s, n, hd), cos, sin)
    k = _rope_halves(k.reshape(b, s, nk, hd), cos, sin)
    v = v.reshape(b, s, nk, hd)
    prefix = (k[:, :keep_prefix], v[:, :keep_prefix]) if keep_prefix else None
    if past_kv is not None:
        k = torch.cat([past_kv[0].to(k.dtype), k], dim=1)
        v = torch.cat([past_kv[1].to(v.dtype), v], dim=1)
    if nk != n:
        k, v = (t.repeat_interleave(n // nk, dim=2) for t in (k, v))
    att = plain_attention(q, k, v, 1.0 / math.sqrt(hd), bias=mask_bias[:, None])
    x = x + linear(p.self_attn.o_proj, att.reshape(b, s, n * hd))
    h = rms_norm(x, p.post_attention_layernorm.weight, cfg.eps)
    gate, up = linear(p.mlp.gate_up_proj, h).chunk(2, dim=-1)
    return x + linear(p.mlp.down_proj, silu_f32(gate) * up), prefix


def phi3_run(llm: Phi3Model, cfg: OmniGenConfig, embeds: torch.Tensor,
             attn_mask: torch.Tensor, position_ids: Optional[torch.Tensor] = None,
             past_kv=None, keep_prefix: int = 0):
    """The stack over input embeddings (B, S, H) with a (B, S_q, S_kv) 0/1 mask.

    past_kv: per layer [(k, v), ...] of the condition prefix; embeds then holds the
    suffix only and position_ids (B, S) its absolute positions. The rope tables are
    chosen by the whole length (suffix + prefix). keep_prefix: also return each layer's
    first keep_prefix keys and values."""
    s = embeds.shape[1]
    s_total = s + (past_kv[0][0].shape[1] if past_kv is not None else 0)
    dev = embeds.device
    cos, sin = (torch.as_tensor(t, device=dev) for t in _su_rope_tables(cfg, s_total))
    if position_ids is not None:
        idx = torch.as_tensor(position_ids, device=dev)[0].long()
        cos, sin = cos[idx], sin[idx]
    mask_bias = (1.0 - attn_mask.float()) * torch.finfo(torch.float32).min
    x = embeds
    prefixes: List = []
    for i, p in enumerate(llm.layers):
        x, pre = _phi3_block(p, x, mask_bias, cos, sin, cfg,
                             past_kv=None if past_kv is None else past_kv[i],
                             keep_prefix=keep_prefix)
        prefixes.append(pre)
    out = rms_norm(x, llm.norm.weight, cfg.eps)
    return (out, prefixes) if keep_prefix else out


# ---------------------------------------------------------------------------
# OmniGen
# ---------------------------------------------------------------------------

def _patch_embed(p: PatchEmbedMR, x: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, hw, D): the patch conv as a matmul over (c, dy, dx)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // patch, patch, w // patch, patch, c).permute(0, 1, 3, 5, 2, 4)
    x = x.reshape(b, (h // patch) * (w // patch), c * patch * patch)
    return F.linear(x, p.proj.weight.reshape(p.proj.weight.shape[0], -1), p.proj.bias)


def omnigen_unpatchify(x: torch.Tensor, height: int, width: int, patch: int,
                       channels: int) -> torch.Tensor:
    """(B, T, p*p*C) in (dy, dx, c) feature order -> (B, H, W, C)."""
    b = x.shape[0]
    gh, gw = height // patch, width // patch
    x = x.reshape(b, gh, gw, patch, patch, channels).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, height, width, channels)


def _pos(cfg: OmniGenConfig, h: int, w: int, dtype, device) -> torch.Tensor:
    return torch.as_tensor(cropped_pos_embed(cfg, h, w), device=device).to(dtype)


def omnigen_forward(
    model: OmniGen,
    cfg: OmniGenConfig,
    latents: torch.Tensor,                # (B, H, W, 4) noisy latents, channels-last
    timestep: torch.Tensor,               # (B,)
    input_ids: Optional[torch.Tensor],    # (B, L) prompt ids
    attn_mask: torch.Tensor,              # (B, S, S) 0/1
    input_img_latents: Sequence[torch.Tensor] = (),      # [(1, h, w, 4), ...]
    image_slices: Sequence[Tuple[int, int, int]] = (),   # (batch, start, end)
    position_ids: Optional[torch.Tensor] = None,
    past_kv=None,
    return_past_kv: bool = False,
):
    """The velocity (B, H, W, 4). The reference images' latents, patch-embedded by
    ``input_x_embedder``, replace the text embeddings at ``image_slices``; the sequence
    is [condition, time token, image]. return_past_kv: also the condition prefix's
    per-layer keys and values; past_kv replays them, and the model then takes only [time
    token, image] with the mask's rows for them and their position ids."""
    b, hgt, wdt, _ = latents.shape
    dtype, dev = model.x_embedder.proj.weight.dtype, latents.device
    x = _patch_embed(model.x_embedder, latents.to(dtype), cfg.patch_size)
    x = x + _pos(cfg, hgt, wdt, dtype, dev)
    num_tokens = x.shape[1]
    time_token = _time_mlp(model.time_token, timestep, dtype)[:, None]

    if past_kv is None and input_ids is not None:
        ids = torch.as_tensor(input_ids, device=dev).long()
        cond = model.llm.embed_tokens.weight[ids].to(dtype)
        for (bi, s0, s1), lat in zip(image_slices, input_img_latents):
            emb = _patch_embed(model.input_x_embedder, lat.to(dtype), cfg.patch_size)
            emb = emb + _pos(cfg, lat.shape[1], lat.shape[2], dtype, dev)
            cond = cond.clone()
            cond[bi, s0:s1] = emb[0]
        seq = torch.cat([cond, time_token, x], dim=1)
    else:
        seq = torch.cat([time_token, x], dim=1)

    keep = seq.shape[1] - (num_tokens + 1) if return_past_kv else 0
    out = phi3_run(model.llm, cfg, seq, attn_mask, position_ids, past_kv=past_kv,
                   keep_prefix=keep)
    if return_past_kv:
        out, prefix_kv = out
    img = out[:, -num_tokens:]
    fl = model.final_layer
    e = linear(fl.adaLN_modulation[1], silu_f32(_time_mlp(model.t_embedder, timestep, dtype)))
    shift, scale = e.chunk(2, dim=-1)
    h = layer_norm(img, 1e-6) * (1 + scale[:, None]) + shift[:, None]
    res = omnigen_unpatchify(linear(fl.linear, h), hgt, wdt, cfg.patch_size, cfg.in_channels)
    return (res, prefix_kv) if return_past_kv else res


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_omnigen(cfg: OmniGenConfig, gen: torch.Generator, dtype=torch.bfloat16, *,
                 device) -> OmniGen:
    """Random weights with JAX's distributions, drawn from `gen`: N(0, 0.02²) embeddings
    and linears (the patch convs too), zero biases, unit norms. OmniGen-v1's widths hold
    3.8 B parameters (7.6 GB in bf16)."""
    model = empty_module(OmniGen, cfg, dtype=dtype, device=device)
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Embedding, nn.Conv2d)):
            m.weight.normal_(generator=gen).mul_(0.02)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
        elif isinstance(m, RMSNorm):
            m.weight.fill_(1.0)
    return model.eval().requires_grad_(False)
