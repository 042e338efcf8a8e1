"""Qwen2.5-VL's text decoder (M-RoPE, GQA) and windowed vision tower in PyTorch: the
Qwen-Image prompt tower and Qwen-Image-Edit's image reader.

Port of ``goal_force_tpu/models/qwen_vl.py``:

  - the text side: ``QwenVLTextConfig``, ``mrope_tables`` (the per-(t, h, w) angle
    tables in float32, channel sections (16, 24, 24) over the duplicated half-dims),
    ``qwen_vl_text_forward`` (pre-RMSNorm layers, q/k/v with biases, split-half rotary in
    float32, GQA by repeating each kv head, causal attention over the 0/1 padding mask as
    an additive float32 bias of finfo.min, SwiGLU with its SiLU in float32, the final
    norm), ``get_rope_index`` (host numpy: 3D positions for image spans, text positions
    running on from the largest so far) and ``qwen_vl_embed`` (image features in place of
    the image tokens, in order);
  - KV-cached decoding (Nexus-Gen's image tokens, greedy text generation):
    ``qwen_vl_text_prefill`` (the causal forward that also returns every layer's rope'd
    keys and values in caches (L, B, cache_len, nk, hd), zero past the prompt),
    ``qwen_vl_text_decode_step`` (one token at index ``pos``: its keys and values written
    into the caches in place, where JAX's ``dynamic_update_slice`` returns new ones, the
    keys past ``pos`` hidden by finfo.min) and ``qwen_vl_text_generate`` (greedy argmax
    through ``lm_head`` or the tied embedding, stopping at, and dropping, an id of
    ``eos_ids``). The three share ``_block_qkv`` and ``_block_finish`` with
    ``qwen_vl_text_forward``; q/k/v biases are optional, so a Llama stack runs here too;
  - the vision side: ``QwenVLVisionConfig``, ``vision_rot_tables`` (the (h, w) rotary
    angles in the within-merge-block order), ``vision_window_index`` (the window order
    over merge units and the segment ids of windows and images), ``qwen_vl_vision_forward``
    (the 14 x 14 x 2 patch matmul, the tokens reordered by window, RMS-normed blocks with
    a fused biased qkv and a gated SwiGLU, attention within each window and over the whole
    image at ``fullatt_block_indexes``, the 2x2 merger MLP, the inverse reorder),
    ``smart_resize`` and ``preprocess_image_for_vision`` (PIL bicubic, CLIP
    normalisation, the processor's patch layout).

Both towers attend through ``ops/attention.py::plain_attention`` with the mask as an
additive bias (the reference's varlen windows are one dense segment-masked attention, as
in JAX). JAX forms those logits in the input dtype and adds the mask in float32; here the
logits are float32 throughout, so the two agree in float32 and differ by bf16 rounding of
the logits in bf16.

``QwenVLTextModel`` holds the text parameters under the HF Qwen2.5-VL names without the
``model.`` prefix (``embed_tokens``, ``layers.{i}.{input_layernorm, self_attn.{q,k,v,o}
_proj, post_attention_layernorm, mlp.{gate,up,down}_proj}``, ``norm``; ``lm_head`` where
built with ``lm_head=True``);
``QwenVLVisionModel`` the vision parameters under the HF names without ``visual.``
(``patch_embed.proj``, ``blocks.{i}.{norm1, norm2, attn.qkv, attn.proj, mlp.{gate,up,
down}_proj}``, ``merger.{ln_q, mlp.0, mlp.2}``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from goal_force_tpu_torch.models.wan_dit import (
    Activation,
    RMSNorm,
    empty_module,
    linear,
    rms_norm,
)
from goal_force_tpu_torch.ops.attention import plain_attention


@dataclasses.dataclass(frozen=True)
class QwenVLTextConfig:
    hidden_size: int = 3584
    num_layers: int = 28
    num_heads: int = 28
    num_kv_heads: int = 4
    intermediate_size: int = 18944
    vocab: int = 152064
    eps: float = 1e-6
    rope_theta: float = 1e6
    mrope_section: Tuple[int, ...] = (16, 24, 24)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclasses.dataclass(frozen=True)
class QwenVLVisionConfig:
    hidden_size: int = 1280
    depth: int = 32
    num_heads: int = 16
    intermediate_size: int = 3420
    patch_size: int = 14
    temporal_patch_size: int = 2
    in_channels: int = 3
    spatial_merge_size: int = 2
    out_hidden_size: int = 3584
    window_size: int = 112
    fullatt_block_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    rope_theta: float = 1e4
    eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


# ---------------------------------------------------------------------------
# Modules (parameter holders under the HF names)
# ---------------------------------------------------------------------------

class QwenVLAttention(nn.Module):
    def __init__(self, cfg: QwenVLTextConfig, qkv_bias: bool = True):
        super().__init__()
        d, hd = cfg.hidden_size, cfg.head_dim
        self.q_proj = nn.Linear(d, cfg.num_heads * hd, bias=qkv_bias)
        self.k_proj = nn.Linear(d, cfg.num_kv_heads * hd, bias=qkv_bias)
        self.v_proj = nn.Linear(d, cfg.num_kv_heads * hd, bias=qkv_bias)
        self.o_proj = nn.Linear(cfg.num_heads * hd, d, bias=False)


class QwenVLMLP(nn.Module):
    def __init__(self, d: int, f: int, bias: bool = False):
        super().__init__()
        self.gate_proj = nn.Linear(d, f, bias=bias)
        self.up_proj = nn.Linear(d, f, bias=bias)
        self.down_proj = nn.Linear(f, d, bias=bias)


class QwenVLLayer(nn.Module):
    def __init__(self, cfg: QwenVLTextConfig, qkv_bias: bool = True):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size)
        self.self_attn = QwenVLAttention(cfg, qkv_bias)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size)
        self.mlp = QwenVLMLP(cfg.hidden_size, cfg.intermediate_size)


class QwenVLTextModel(nn.Module):
    def __init__(self, cfg: QwenVLTextConfig, lm_head: bool = False, qkv_bias: bool = True):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab, cfg.hidden_size)
        self.layers = nn.ModuleList(QwenVLLayer(cfg, qkv_bias)
                                    for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size)
        if lm_head:
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab, bias=False)


class QwenVLVisionAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.qkv = nn.Linear(d, 3 * d)
        self.proj = nn.Linear(d, d)


class QwenVLVisionBlock(nn.Module):
    def __init__(self, cfg: QwenVLVisionConfig):
        super().__init__()
        d = cfg.hidden_size
        self.norm1 = RMSNorm(d)
        self.attn = QwenVLVisionAttention(d)
        self.norm2 = RMSNorm(d)
        self.mlp = QwenVLMLP(d, cfg.intermediate_size, bias=True)


class QwenVLPatchEmbed(nn.Module):
    def __init__(self, cfg: QwenVLVisionConfig):
        super().__init__()
        p, t = cfg.patch_size, cfg.temporal_patch_size
        self.proj = nn.Conv3d(cfg.in_channels, cfg.hidden_size, (t, p, p), stride=(t, p, p),
                              bias=False)


class QwenVLMerger(nn.Module):
    def __init__(self, cfg: QwenVLVisionConfig):
        super().__init__()
        wide = cfg.hidden_size * cfg.spatial_merge_size ** 2
        self.ln_q = RMSNorm(cfg.hidden_size)
        self.mlp = nn.ModuleList([nn.Linear(wide, wide), Activation(),
                                  nn.Linear(wide, cfg.out_hidden_size)])


class QwenVLVisionModel(nn.Module):
    def __init__(self, cfg: QwenVLVisionConfig):
        super().__init__()
        self.patch_embed = QwenVLPatchEmbed(cfg)
        self.blocks = nn.ModuleList(QwenVLVisionBlock(cfg) for _ in range(cfg.depth))
        self.merger = QwenVLMerger(cfg)


# ---------------------------------------------------------------------------
# Text decoder
# ---------------------------------------------------------------------------

def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    a, b = x.chunk(2, dim=-1)
    return torch.cat([-b, a], dim=-1)


def _rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)


def mrope_tables(cfg: QwenVLTextConfig, position_ids: torch.Tensor):
    """position_ids (3, B, S) -> float32 cos, sin (B, S, head_dim): each channel of the
    half-dims takes its section's axis (t, h, w), the half repeated."""
    hd = cfg.head_dim
    inv_freq = torch.as_tensor(
        (1.0 / cfg.rope_theta ** (np.arange(0, hd, 2) / hd)).astype(np.float32),
        device=position_ids.device)
    ang = position_ids.float()[..., None] * inv_freq                   # (3, B, S, hd/2)
    sec = np.concatenate([np.full(n, i) for i, n in enumerate(cfg.mrope_section)])
    pick = torch.as_tensor(sec, device=ang.device)
    half = torch.arange(hd // 2, device=ang.device)
    cos_h, sin_h = (f(ang)[pick, ..., half].permute(1, 2, 0) for f in (torch.cos, torch.sin))
    return torch.cat([cos_h, cos_h], -1), torch.cat([sin_h, sin_h], -1)


def _mlp(p: QwenVLMLP, h: torch.Tensor) -> torch.Tensor:
    g = F.silu(linear(p.gate_proj, h).float()).to(h.dtype)
    return linear(p.down_proj, g * linear(p.up_proj, h))


def _causal_bias(s: int, device) -> torch.Tensor:
    """(S, S) float32: 0 on and below the diagonal, finfo.min above."""
    causal = torch.ones((s, s), dtype=torch.bool, device=device).tril()
    return torch.zeros((s, s), dtype=torch.float32, device=device).masked_fill(
        ~causal, torch.finfo(torch.float32).min)


def _block_qkv(p: QwenVLLayer, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               cfg: QwenVLTextConfig):
    """x (B, S, H), cos/sin (B, S, 1, head_dim) -> rope'd q (B, S, n, hd) and k, and v
    (B, S, nk, hd)."""
    b, s, _ = x.shape
    n, nk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    h = rms_norm(x, p.input_layernorm.weight, cfg.eps)
    a = p.self_attn
    q = _rotary(linear(a.q_proj, h).reshape(b, s, n, hd), cos, sin)
    k = _rotary(linear(a.k_proj, h).reshape(b, s, nk, hd), cos, sin)
    return q, k, linear(a.v_proj, h).reshape(b, s, nk, hd)


def _attend(q, k, v, bias, cfg: QwenVLTextConfig) -> torch.Tensor:
    """GQA (each kv head repeated) under an additive float32 bias -> (B, S, n * hd)."""
    b, s, n, hd = q.shape
    k, v = (t.repeat_interleave(n // cfg.num_kv_heads, dim=2) for t in (k, v))
    return plain_attention(q, k, v, 1.0 / math.sqrt(hd), bias=bias).reshape(b, s, n * hd)


def _block_finish(p: QwenVLLayer, x: torch.Tensor, att: torch.Tensor,
                  cfg: QwenVLTextConfig) -> torch.Tensor:
    x = x + linear(p.self_attn.o_proj, att)
    return x + _mlp(p.mlp, rms_norm(x, p.post_attention_layernorm.weight, cfg.eps))


def text_layer(p: QwenVLLayer, x: torch.Tensor, bias, cos: torch.Tensor, sin: torch.Tensor,
               cfg: QwenVLTextConfig) -> torch.Tensor:
    """One decoder layer under an additive bias (None: every key visible), cos/sin
    (B, S, 1, head_dim)."""
    return _block_finish(p, x, _attend(*_block_qkv(p, x, cos, sin, cfg), bias, cfg), cfg)


def qwen_vl_text_forward(model: QwenVLTextModel, cfg: QwenVLTextConfig,
                         embeds: torch.Tensor, attn_mask: torch.Tensor,
                         position_ids: torch.Tensor) -> torch.Tensor:
    """embeds (B, S, H), attn_mask (B, S) 0/1 padding mask, position_ids (3, B, S) ->
    final-norm hidden states (B, S, H)."""
    s = embeds.shape[1]
    cos, sin = (t[:, :, None, :] for t in mrope_tables(cfg, position_ids))
    bias = _causal_bias(s, embeds.device)[None].masked_fill(
        attn_mask[:, None, :] <= 0, torch.finfo(torch.float32).min)[:, None]
    x = embeds
    for p in model.layers:
        x = text_layer(p, x, bias, cos, sin, cfg)
    return rms_norm(x, model.norm.weight, cfg.eps)


# ---------------------------------------------------------------------------
# KV-cached decoding
# ---------------------------------------------------------------------------

def qwen_vl_text_prefill(model: QwenVLTextModel, cfg: QwenVLTextConfig,
                         embeds: torch.Tensor, position_ids: torch.Tensor, cache_len: int):
    """Causal prefill: (hidden (B, S, H), kcache, vcache), the caches (L, B, cache_len,
    nk, hd) holding each layer's rope'd keys and values in their first S rows, zeros
    after, for ``qwen_vl_text_decode_step``."""
    b, s, _ = embeds.shape
    cos, sin = (t[:, :, None, :] for t in mrope_tables(cfg, position_ids))
    bias = _causal_bias(s, embeds.device)
    shape = (cfg.num_layers, b, cache_len, cfg.num_kv_heads, cfg.head_dim)
    kcache, vcache = (embeds.new_zeros(shape) for _ in range(2))
    x = embeds
    for i, p in enumerate(model.layers):
        q, k, v = _block_qkv(p, x, cos, sin, cfg)
        kcache[i, :, :s], vcache[i, :, :s] = k, v
        x = _block_finish(p, x, _attend(q, k, v, bias, cfg), cfg)
    return rms_norm(x, model.norm.weight, cfg.eps), kcache, vcache


def qwen_vl_text_decode_step(model: QwenVLTextModel, cfg: QwenVLTextConfig,
                             emb: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                             kcache: torch.Tensor, vcache: torch.Tensor, pos: int):
    """One cached step: emb (B, 1, H) is the input embedding of the token at sequence
    index `pos`, cos/sin (B, 1, head_dim) its rope tables. Its keys and values go into
    row `pos` of the caches, in place; it attends to rows <= pos. Returns (hidden (B, 1,
    H), kcache, vcache)."""
    cache_len = kcache.shape[2]
    bias = torch.zeros(cache_len, dtype=torch.float32, device=emb.device).masked_fill(
        torch.arange(cache_len, device=emb.device) > pos, torch.finfo(torch.float32).min)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x = emb
    for i, p in enumerate(model.layers):
        q, k, v = _block_qkv(p, x, cos, sin, cfg)
        kcache[i, :, pos:pos + 1], vcache[i, :, pos:pos + 1] = k, v
        x = _block_finish(p, x, _attend(q, kcache[i], vcache[i], bias, cfg), cfg)
    return rms_norm(x, model.norm.weight, cfg.eps), kcache, vcache


def _lm_logits(model: QwenVLTextModel, h: torch.Tensor) -> torch.Tensor:
    """The LM head, or the tied token embedding where the model has none."""
    head = getattr(model, "lm_head", None)
    return F.linear(h, head.weight if head is not None else model.embed_tokens.weight)


@torch.no_grad()
def qwen_vl_text_generate(model: QwenVLTextModel, cfg: QwenVLTextConfig, input_ids,
                          max_new_tokens: int, eos_ids=(), cache_len: int = 0):
    """Greedy KV-cached generation (Qwen2's ``generate`` with do_sample=False).
    input_ids (B, S) host ints; returns the first row's generated ids, stopping at, and
    dropping, any id in `eos_ids`. Text positions: the three M-RoPE streams carry the
    same index, which is plain 1D RoPE, so the stack doubles as a Qwen2 LM."""
    ids = np.asarray(input_ids)
    b, s = ids.shape
    wte = model.embed_tokens.weight
    dev = wte.device
    cache_len = cache_len or s + max_new_tokens
    pos = torch.arange(s, device=dev)[None, None].expand(3, b, s)
    hidden, kc, vc = qwen_vl_text_prefill(model, cfg, wte[torch.as_tensor(ids, device=dev)],
                                          pos, cache_len)
    cur = _lm_logits(model, hidden[:, -1]).argmax(-1)
    toks = [int(cur[0])]
    for i in range(max_new_tokens - 1):
        if toks[-1] in eos_ids:
            break
        cos, sin = mrope_tables(cfg, torch.full((3, b, 1), s + i, device=dev))
        hh, kc, vc = qwen_vl_text_decode_step(model, cfg, wte[cur][:, None], cos, sin, kc, vc,
                                              s + i)
        cur = _lm_logits(model, hh[:, 0]).argmax(-1)
        toks.append(int(cur[0]))
    if toks and toks[-1] in eos_ids:
        toks.pop()
    return toks


def get_rope_index(input_ids: np.ndarray, image_grid_thw: Sequence[Tuple[int, int, int]],
                   image_token_id: int, vision_start_token_id: int,
                   spatial_merge_size: int = 2, tokens_per_second: int = 2) -> np.ndarray:
    """Host 3D position ids (3, B, S): each image span's (t, h, w) grid over its merged
    patches (temporal ids 0), every text span running on from the largest id so far."""
    b, s = input_ids.shape
    out = np.zeros((3, b, s), np.int32)
    for bi in range(b):
        toks = input_ids[bi].tolist()
        pos_list = []
        st, img_idx = 0, 0
        while True:
            try:
                ed = toks.index(image_token_id, st)
            except ValueError:
                break
            text_len = ed - st
            st_idx = pos_list[-1].max() + 1 if pos_list else 0
            pos_list.append(np.tile(np.arange(text_len), (3, 1)) + st_idx)
            t, h, w = image_grid_thw[img_idx]
            gh, gw = h // spatial_merge_size, w // spatial_merge_size
            t_idx = np.zeros(t * gh * gw, np.int64)
            h_idx = np.tile(np.repeat(np.arange(gh), gw), t)
            w_idx = np.tile(np.arange(gw), t * gh)
            pos_list.append(np.stack([t_idx, h_idx, w_idx]) + text_len + st_idx)
            st = ed + t * gh * gw
            img_idx += 1
        if st < len(toks):
            st_idx = pos_list[-1].max() + 1 if pos_list else 0
            pos_list.append(np.tile(np.arange(len(toks) - st), (3, 1)) + st_idx)
        out[:, bi] = np.concatenate(pos_list, axis=1)
    return out


def qwen_vl_embed(model: QwenVLTextModel, input_ids: torch.Tensor,
                  image_embeds: Optional[torch.Tensor], image_token_id: int) -> torch.Tensor:
    """Token embeddings with the image features, in order, in place of the image
    tokens."""
    emb = model.embed_tokens.weight[input_ids]
    if image_embeds is not None:
        mask = input_ids == image_token_id
        emb = emb.clone()
        emb[mask] = image_embeds[:int(mask.sum())].to(emb.dtype)
    return emb


# ---------------------------------------------------------------------------
# Vision tower
# ---------------------------------------------------------------------------

def vision_rot_tables(cfg: QwenVLVisionConfig,
                      grid_thw: Sequence[Tuple[int, int, int]]) -> np.ndarray:
    """Per-token (h, w) rotary angles in the within-merge-block order, (S, head_dim // 2)
    float32 (float64 on the host)."""
    m = cfg.spatial_merge_size
    parts = []
    for t, h, w in grid_thw:
        hp = np.arange(h)[:, None] * np.ones((1, w), np.int64)
        wp = np.ones((h, 1), np.int64) * np.arange(w)[None]
        reorder = lambda a: a.reshape(h // m, m, w // m, m).transpose(0, 2, 1, 3).reshape(-1)
        ids = np.stack([reorder(hp), reorder(wp)], axis=-1)
        parts.append(np.tile(ids, (t, 1)))
    ids = np.concatenate(parts, axis=0)
    d = cfg.head_dim // 2
    inv_freq = 1.0 / cfg.rope_theta ** (np.arange(0, d, 2, dtype=np.float64) / d)
    freqs = ids[..., None].astype(np.float64) * inv_freq
    return freqs.reshape(ids.shape[0], -1).astype(np.float32)


def vision_window_index(cfg: QwenVLVisionConfig, grid_thw: Sequence[Tuple[int, int, int]]):
    """(the window order over merge units, per-token window segment ids, per-token image
    segment ids), on the host."""
    m = cfg.spatial_merge_size
    unit = m * m
    vw = cfg.window_size // m // cfg.patch_size
    index_list, seg_sizes, img_seg = [], [], []
    base = 0
    for n_img, (t, h, w) in enumerate(grid_thw):
        gh, gw = h // m, w // m
        idx = np.arange(t * gh * gw).reshape(t, gh, gw)
        pad_h, pad_w = (-gh) % vw, (-gw) % vw
        nh, nw = (gh + pad_h) // vw, (gw + pad_w) // vw
        padded = np.full((t, gh + pad_h, gw + pad_w), -100, np.int64)
        padded[:, :gh, :gw] = idx
        padded = padded.reshape(t, nh, vw, nw, vw).transpose(0, 1, 3, 2, 4) \
            .reshape(t, nh * nw, vw, vw)
        seqlens = (padded != -100).sum((2, 3)).reshape(-1)
        flat = padded.reshape(-1)
        index_list.append(flat[flat != -100] + base)
        seg_sizes.extend([int(x) * unit for x in seqlens if x > 0])
        base += t * gh * gw
        img_seg.extend([n_img] * (t * gh * gw * unit))
    window_index = np.concatenate(index_list)
    win_seg = np.concatenate([np.full(n, i) for i, n in enumerate(seg_sizes)])
    return window_index, win_seg, np.asarray(img_seg, np.int64)


def _segment_bias(seg: torch.Tensor) -> torch.Tensor:
    """(1, 1, S, S) float32: 0 within a segment, finfo.min across."""
    ok = seg[:, None] == seg[None, :]
    return torch.zeros(ok.shape, dtype=torch.float32, device=seg.device).masked_fill(
        ~ok, torch.finfo(torch.float32).min)[None, None]


def _seg_attention(p: QwenVLVisionAttention, x: torch.Tensor, bias: torch.Tensor,
                   cos: torch.Tensor, sin: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Dense segment-masked attention over the (S, D) token list."""
    s, d = x.shape
    hd = d // n_heads
    q, k, v = linear(p.qkv, x).reshape(s, 3, n_heads, hd).unbind(1)
    q, k = _rotary(q, cos, sin), _rotary(k, cos, sin)
    att = plain_attention(q[None], k[None], v[None], 1.0 / math.sqrt(hd), bias=bias)
    return linear(p.proj, att.reshape(s, d))


def qwen_vl_vision_forward(model: QwenVLVisionModel, cfg: QwenVLVisionConfig,
                           pixels: torch.Tensor,
                           grid_thw: Sequence[Tuple[int, int, int]]) -> torch.Tensor:
    """pixels (S, C * T * P * P) flattened patches (the processor's layout) -> merged
    features (S / merge², out_hidden)."""
    unit = cfg.spatial_merge_size ** 2
    w = model.patch_embed.proj.weight
    x = F.linear(pixels.to(w.dtype), w.reshape(w.shape[0], -1))
    s = x.shape[0]
    rot = vision_rot_tables(cfg, tuple(grid_thw))
    widx, win_seg, img_seg = vision_window_index(cfg, tuple(grid_thw))
    perm = (widx[:, None] * unit + np.arange(unit)[None]).reshape(-1)
    dev = x.device
    x = x[torch.as_tensor(perm, device=dev)]
    emb = np.concatenate([rot[perm], rot[perm]], axis=-1)
    cos, sin = (torch.as_tensor(f(emb), device=dev)[:, None, :] for f in (np.cos, np.sin))
    full_bias = _segment_bias(torch.as_tensor(img_seg[perm], device=dev))
    win_bias = _segment_bias(torch.as_tensor(win_seg, device=dev))
    for i, p in enumerate(model.blocks):
        bias = full_bias if i in cfg.fullatt_block_indexes else win_bias
        x = x + _seg_attention(p.attn, rms_norm(x, p.norm1.weight, cfg.eps), bias, cos, sin,
                               cfg.num_heads)
        x = x + _mlp(p.mlp, rms_norm(x, p.norm2.weight, cfg.eps))
    mg = model.merger
    x = rms_norm(x, mg.ln_q.weight, cfg.eps).reshape(s // unit, unit * cfg.hidden_size)
    x = linear(mg.mlp[2], F.gelu(linear(mg.mlp[0], x)))
    return x[torch.as_tensor(np.argsort(widx), device=dev)]


# ---------------------------------------------------------------------------
# Host image preprocessing (HF Qwen2VLImageProcessor)
# ---------------------------------------------------------------------------

_QWEN_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
_QWEN_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def smart_resize(height: int, width: int, factor: int = 28, min_pixels: int = 56 * 56,
                 max_pixels: int = 14 * 14 * 4 * 1280):
    """Target (h, w): multiples of `factor`, the aspect kept, the pixel count within
    [min_pixels, max_pixels]."""
    if max(height, width) / min(height, width) > 200:
        raise ValueError("absolute aspect ratio must be smaller than 200")
    h_bar = max(factor, round(height / factor) * factor)
    w_bar = max(factor, round(width / factor) * factor)
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = math.floor(height / beta / factor) * factor
        w_bar = math.floor(width / beta / factor) * factor
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


def preprocess_image_for_vision(image01: np.ndarray, cfg: QwenVLVisionConfig,
                                min_pixels: int = 56 * 56,
                                max_pixels: int = 14 * 14 * 4 * 1280):
    """(H, W, 3) float in [0, 1] -> ((n_patches, C*T*P*P) float32 patches, grid_thw): a
    bicubic smart resize to multiples of patch x merge, CLIP normalisation, the frame
    repeated to temporal_patch_size, the (t, h//m, w//m, m, C, T, P, P) patch layout."""
    from PIL import Image

    p, m, t = cfg.patch_size, cfg.spatial_merge_size, cfg.temporal_patch_size
    h0, w0 = image01.shape[:2]
    h, w = smart_resize(h0, w0, factor=p * m, min_pixels=min_pixels, max_pixels=max_pixels)
    pil = Image.fromarray((np.clip(image01, 0, 1) * 255).astype(np.uint8))
    arr = np.asarray(pil.resize((w, h), Image.BICUBIC), np.float32) / 255.0
    arr = (arr - np.asarray(_QWEN_IMAGE_MEAN)) / np.asarray(_QWEN_IMAGE_STD)
    arr = np.repeat(arr.transpose(2, 0, 1)[None], t, axis=0)
    gh, gw = h // p, w // p
    patches = arr.reshape(1, t, 3, gh // m, m, p, gw // m, m, p)
    patches = patches.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    return patches.reshape(gh * gw, 3 * t * p * p).astype(np.float32), (1, gh, gw)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

@torch.no_grad()
def _init_normal_(model: nn.Module, gen: torch.Generator) -> nn.Module:
    """JAX's Qwen inits: N(0, 0.02**2) embeddings and weights, zero biases, unit norms."""
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Embedding, nn.Conv3d)):
            mod.weight.normal_(generator=gen).mul_(0.02)
            if getattr(mod, "bias", None) is not None:
                mod.bias.zero_()
        elif isinstance(mod, RMSNorm):
            mod.weight.fill_(1.0)
    return model.eval().requires_grad_(False)


def init_qwen_vl_text(cfg: QwenVLTextConfig, gen: torch.Generator, dtype=torch.bfloat16, *,
                      device, lm_head: bool = False, qkv_bias: bool = True) -> QwenVLTextModel:
    """Random text-tower weights drawn from `gen` on `device` (Qwen2.5-VL-7B's tower is
    7.6 B parameters: 15.2 GB in bf16; its LM head 0.55 B more)."""
    return _init_normal_(empty_module(QwenVLTextModel, cfg, lm_head, qkv_bias, dtype=dtype,
                                      device=device), gen)


def init_qwen_vl_vision(cfg: QwenVLVisionConfig, gen: torch.Generator, dtype=torch.bfloat16,
                        *, device) -> QwenVLVisionModel:
    """Random vision-tower weights drawn from `gen` on `device` (0.67 B parameters)."""
    return _init_normal_(empty_module(QwenVLVisionModel, cfg, dtype=dtype, device=device), gen)
