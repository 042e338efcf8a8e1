"""HunyuanVideo MMDiT in PyTorch.

Port of ``goal_force_tpu/models/hunyuan_video_dit.py``: the token refiner (with its own
masked float32 softmax), the double-stream blocks (image and text streams, each with its
own modulation, joined in one attention) and the single-stream blocks (parallel attention
and MLP on one modulated input, RoPE on the image segment only, a bias-free ``ff.2``),
the I2V token replace (the first frame's tokens take the t = 0 modulation), and the
prelude / trunk / head split that TeaCache uses.

Both joint attentions run as ONE attention over [image tokens ++ text tokens] with a
per-row count of valid keys ``kv_valid`` = image tokens + the row's valid text tokens, a
(B,) tensor on the device (no host sync). The per-head q/k RMSNorm bounds the logits, so
the call is ``ops/attention.py::attention(..., bounded=True, kv_len=kv_valid)``: K1
(``dispatch="nomax"``) on a CUDA tensor at head_dim 128. Padding text rows attend over
the valid keys; their outputs never reach a valid position (padding keys stay masked in
every block) and the head drops the text stream.

``HunyuanVideoDiT`` holds the parameters under the reference ("diffsynth") state-dict
names that JAX ``hunyuan_video_dit_params_from_torch`` reads, so a reference-format file
loads directly. The MLPs run over chunks of ``wan_dit.FFN_CHUNK_TOKENS`` tokens (each
token's MLP is the same function; only one chunk's float32 GELU temporaries are alive).
Under an ambient mesh every rank runs the whole model on whole tensors and the
attention takes its heads (``ops/attention.py::attention``), as JAX's does there.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from goal_force_tpu_torch.models.wan_dit import (
    FFN_CHUNK_TOKENS,
    Activation,
    LayerNormAffine,
    RMSNorm,
    empty_module,
    gelu_tanh,
    init_linear_,
    layer_norm,
    rms_norm,
    sinusoidal_embedding,
)
from goal_force_tpu_torch.ops.attention import attention
from goal_force_tpu_torch.ops.rope import apply_rope


@dataclasses.dataclass(frozen=True)
class HunyuanVideoDiTConfig:
    """Defaults: the released HunyuanVideo DiT (12.8 B parameters)."""

    dim: int = 3072
    num_heads: int = 24
    num_double_blocks: int = 20
    num_single_blocks: int = 40
    in_channels: int = 16
    text_dim: int = 4096
    pooled_dim: int = 768
    guidance_embed: bool = True
    freq_dim: int = 256
    rope_dims: Tuple[int, ...] = (16, 56, 56)
    rope_theta: float = 256.0
    txt_len: int = 256
    refiner_depth: int = 2
    patch: Tuple[int, int, int] = (1, 2, 2)
    eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads


@lru_cache(maxsize=8)
def hunyuan_rope_tables(t: int, gh: int, gw: int, rope_dims: Tuple[int, ...], theta: float):
    """(S, head_dim//2) float32 numpy cos/sin over the (t, h, w) grid, row-major, from
    float64 angles."""
    grids = np.meshgrid(np.arange(t), np.arange(gh), np.arange(gw), indexing="ij")
    parts_cos, parts_sin = [], []
    for i, d in enumerate(rope_dims):
        freqs = 1.0 / theta ** (np.arange(0, d, 2, dtype=np.float64) / d)
        ang = np.outer(grids[i].reshape(-1).astype(np.float64), freqs)
        parts_cos.append(np.cos(ang))
        parts_sin.append(np.sin(ang))
    return (np.concatenate(parts_cos, -1).astype(np.float32),
            np.concatenate(parts_sin, -1).astype(np.float32))


# ---------------------------------------------------------------------------
# Modules (parameter holders under the reference names)
# ---------------------------------------------------------------------------

def _mlp_seq(d_in: int, d_hidden: int, d_out: int, bias2: bool = True) -> nn.Sequential:
    return nn.Sequential(nn.Linear(d_in, d_hidden), Activation(),
                         nn.Linear(d_hidden, d_out, bias=bias2))


class TimestepEmbedder(nn.Module):
    def __init__(self, freq_dim: int, dim: int):
        super().__init__()
        self.timestep_embedder = _mlp_seq(freq_dim, dim, dim)


class RefinerBlock(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.norm1 = LayerNormAffine(d)
        self.self_attn_qkv = nn.Linear(d, 3 * d)
        self.self_attn_proj = nn.Linear(d, d)
        self.norm2 = LayerNormAffine(d)
        self.mlp = _mlp_seq(d, 4 * d, d)
        self.adaLN_modulation = nn.Sequential(Activation(), nn.Linear(d, 2 * d))


class TokenRefiner(nn.Module):
    def __init__(self, cfg: HunyuanVideoDiTConfig):
        super().__init__()
        d = cfg.dim
        self.input_embedder = nn.Linear(cfg.text_dim, d)
        self.t_embedder = TimestepEmbedder(cfg.freq_dim, d)
        self.c_embedder = _mlp_seq(cfg.text_dim, d, d)
        self.blocks = nn.ModuleList(RefinerBlock(d) for _ in range(cfg.refiner_depth))


class Modulation(nn.Module):
    def __init__(self, d: int, n: int):
        super().__init__()
        self.linear = nn.Linear(d, n * d)


class StreamComponent(nn.Module):
    """One stream of a double block (component_a: image, component_b: text)."""

    def __init__(self, cfg: HunyuanVideoDiTConfig):
        super().__init__()
        d = cfg.dim
        self.mod = Modulation(d, 6)
        self.to_qkv = nn.Linear(d, 3 * d)
        self.norm_q = RMSNorm(cfg.head_dim)
        self.norm_k = RMSNorm(cfg.head_dim)
        self.to_out = nn.Linear(d, d)
        self.ff = _mlp_seq(d, 4 * d, d)


class DoubleBlock(nn.Module):
    def __init__(self, cfg: HunyuanVideoDiTConfig):
        super().__init__()
        self.component_a = StreamComponent(cfg)
        self.component_b = StreamComponent(cfg)


class SingleBlock(nn.Module):
    def __init__(self, cfg: HunyuanVideoDiTConfig):
        super().__init__()
        d = cfg.dim
        self.mod = Modulation(d, 3)
        self.to_qkv = nn.Linear(d, 3 * d)
        self.norm_q = RMSNorm(cfg.head_dim)
        self.norm_k = RMSNorm(cfg.head_dim)
        self.to_out = nn.Linear(d, d)
        self.ff = _mlp_seq(d, 4 * d, d, bias2=False)


class ImgIn(nn.Module):
    def __init__(self, cfg: HunyuanVideoDiTConfig):
        super().__init__()
        self.proj = nn.Conv3d(cfg.in_channels, cfg.dim, cfg.patch, cfg.patch)


class FinalLayer(nn.Module):
    def __init__(self, cfg: HunyuanVideoDiTConfig):
        super().__init__()
        d = cfg.dim
        self.linear = nn.Linear(d, cfg.in_channels * math.prod(cfg.patch))
        self.adaLN_modulation = nn.Sequential(Activation(), nn.Linear(d, 2 * d))


class HunyuanVideoDiT(nn.Module):
    """guidance_in is present where ``cfg.guidance_embed``."""

    def __init__(self, cfg: HunyuanVideoDiTConfig):
        super().__init__()
        d = cfg.dim
        self.cfg = cfg
        self.img_in = ImgIn(cfg)
        self.txt_in = TokenRefiner(cfg)
        self.time_in = TimestepEmbedder(cfg.freq_dim, d)
        self.vector_in = _mlp_seq(cfg.pooled_dim, d, d)
        if cfg.guidance_embed:
            self.guidance_in = TimestepEmbedder(cfg.freq_dim, d)
        self.double_blocks = nn.ModuleList(DoubleBlock(cfg) for _ in range(cfg.num_double_blocks))
        self.single_blocks = nn.ModuleList(SingleBlock(cfg) for _ in range(cfg.num_single_blocks))
        self.final_layer = FinalLayer(cfg)


# ---------------------------------------------------------------------------
# Token refiner (text input)
# ---------------------------------------------------------------------------

def _lin(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, layer.weight, layer.bias)


def _mlp(seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """Linear, SiLU in float32, Linear."""
    h = _lin(seq[0], x)
    return _lin(seq[2], F.silu(h.float()).to(h.dtype))


def _temb(p: TimestepEmbedder, t: torch.Tensor, freq_dim: int, dtype) -> torch.Tensor:
    return _mlp(p.timestep_embedder, sinusoidal_embedding(freq_dim, t).to(dtype))


def token_refiner(p: TokenRefiner, cfg: HunyuanVideoDiTConfig, text_emb, timestep, mask):
    """text_emb: (B, L, text_dim); mask: (B, L) 1/0. Returns (B, L, dim)."""
    dtype = p.input_embedder.weight.dtype
    t_vec = _temb(p.t_embedder, timestep, cfg.freq_dim, dtype)
    mf = mask.float()[..., None]
    # clamp: an all-masked row (empty prompt) must not poison the batch (0/0)
    pooled = (text_emb.float() * mf).sum(1) / mf.sum(1).clamp(min=1.0)
    c = t_vec + _mlp(p.c_embedder, pooled.to(dtype))
    x = _lin(p.input_embedder, text_emb.to(dtype))
    # tokens attend within the valid set; the first key column is forced on
    m = mask.bool()
    ok = m[:, None, :, None] & m[:, None, None, :]
    ok[:, :, :, 0] = True
    bias = torch.zeros(ok.shape, dtype=torch.float32, device=x.device).masked_fill(
        ~ok, torch.finfo(torch.float32).min)
    n = cfg.num_heads
    silu_c = F.silu(c.float()).to(c.dtype)
    for blk in p.blocks:
        g_msa, g_mlp = _lin(blk.adaLN_modulation[1], silu_c).chunk(2, dim=-1)
        h = layer_norm(x, cfg.eps, blk.norm1.weight, blk.norm1.bias)
        b, l, _ = h.shape
        q, k, v = (u.reshape(b, l, n, -1) for u in _lin(blk.self_attn_qkv, h).chunk(3, dim=-1))
        logits = torch.einsum("bqnc,bknc->bnqk", q, k) / math.sqrt(q.shape[-1])
        probs = torch.softmax(logits.float() + bias, dim=-1).to(x.dtype)
        att = torch.einsum("bnqk,bknc->bqnc", probs, v).reshape(b, l, -1)
        x = x + _lin(blk.self_attn_proj, att) * g_msa[:, None, :]
        h = layer_norm(x, cfg.eps, blk.norm2.weight, blk.norm2.bias)
        x = x + _mlp(blk.mlp, h) * g_mlp[:, None, :]
    return x


# ---------------------------------------------------------------------------
# Stream blocks
# ---------------------------------------------------------------------------

def _mod(p: Modulation, vec: torch.Tensor, n: int):
    e = _lin(p.linear, F.silu(vec.float()).to(vec.dtype))
    return e.chunk(n, dim=-1)


def _tok(m, m_tr, tr_mask):
    """Per-token modulation for the I2V token replace: the first-frame image tokens take
    the t = 0 modulation m_tr, every other token the normal m."""
    if m_tr is None:
        return m[:, None]
    return torch.where(tr_mask, m_tr[:, None], m[:, None])


def _tr_mask(s: int, tr_token: int, device) -> torch.Tensor:
    return (torch.arange(s, device=device) < tr_token)[None, :, None]


def _qk_norm(q, k, v, p, b: int, s: int, cfg: HunyuanVideoDiTConfig):
    n = cfg.num_heads
    q = rms_norm(q.reshape(b, s, n, -1), p.norm_q.weight, cfg.eps)
    k = rms_norm(k.reshape(b, s, n, -1), p.norm_k.weight, cfg.eps)
    return q, k, v.reshape(b, s, n, -1)


def _qkv_norm_rope(p: StreamComponent, x, cfg: HunyuanVideoDiTConfig, cos=None, sin=None):
    b, s, _ = x.shape
    q, k, v = _qk_norm(*_lin(p.to_qkv, x).chunk(3, dim=-1), p, b, s, cfg)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def _joint_attention(q_img, k_img, v_img, q_txt, k_txt, v_txt, cfg, attn_impl, kv_valid):
    """ONE attention over [img ++ txt] with the per-row valid-key count kv_valid."""
    b, s_img = q_img.shape[0], q_img.shape[1]
    q = torch.cat([q_img, q_txt], dim=1)
    k = torch.cat([k_img, k_txt], dim=1)
    v = torch.cat([v_img, v_txt], dim=1)
    out = attention(q, k, v, impl=attn_impl, kv_len=kv_valid, bounded=True)
    out = out.reshape(b, -1, cfg.dim)
    return out[:, :s_img], out[:, s_img:]


def _chunked(fn, h: torch.Tensor) -> torch.Tensor:
    """fn over chunks of at most FFN_CHUNK_TOKENS tokens (fn acts on each token alone)."""
    rows = h.reshape(-1, h.shape[-1])
    out = [fn(c) for c in rows.split(FFN_CHUNK_TOKENS)]
    return (out[0] if len(out) == 1 else torch.cat(out)).reshape(*h.shape[:-1], -1)


def _mlp_gelu(seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    return _chunked(lambda c: _lin(seq[2], gelu_tanh(_lin(seq[0], c))), x)


def double_block(p: DoubleBlock, img, txt, vec, cos, sin, cfg: HunyuanVideoDiTConfig,
                 attn_impl="auto", kv_valid=None, vec_tr=None, tr_token=None):
    """vec_tr/tr_token: I2V token replace on the image stream only."""
    a, bb = p.component_a, p.component_b
    sa1, sc1, g1a, sa2, sc2, g2a = _mod(a.mod, vec, 6)
    sb1, scb1, g1b, sb2, scb2, g2b = _mod(bb.mod, vec, 6)
    if vec_tr is not None:
        ta1, tc1, tg1, ta2, tc2, tg2 = _mod(a.mod, vec_tr, 6)
        mk = _tr_mask(img.shape[1], tr_token, img.device)
    else:
        ta1 = tc1 = tg1 = ta2 = tc2 = tg2 = None
        mk = None
    h_img = layer_norm(img, cfg.eps) * (1 + _tok(sc1, tc1, mk)) + _tok(sa1, ta1, mk)
    h_txt = layer_norm(txt, cfg.eps) * (1 + scb1[:, None]) + sb1[:, None]
    qi, ki, vi = _qkv_norm_rope(a, h_img, cfg, cos, sin)
    qt, kt, vt = _qkv_norm_rope(bb, h_txt, cfg)
    att_img, att_txt = _joint_attention(qi, ki, vi, qt, kt, vt, cfg, attn_impl, kv_valid)

    img = img + _lin(a.to_out, att_img) * _tok(g1a, tg1, mk)
    h = layer_norm(img, cfg.eps) * (1 + _tok(sc2, tc2, mk)) + _tok(sa2, ta2, mk)
    img = img + _mlp_gelu(a.ff, h) * _tok(g2a, tg2, mk)

    txt = txt + _lin(bb.to_out, att_txt) * g1b[:, None]
    h = layer_norm(txt, cfg.eps) * (1 + scb2[:, None]) + sb2[:, None]
    txt = txt + _mlp_gelu(bb.ff, h) * g2b[:, None]
    return img, txt


def single_block(p: SingleBlock, x, vec, cos, sin, cfg: HunyuanVideoDiTConfig,
                 attn_impl="auto", kv_valid=None, vec_tr=None, tr_token=None, txt_len=None):
    """Parallel attention + MLP on one modulated input; RoPE on the image segment only
    (the last txt_len tokens are text)."""
    shift, scale, gate = _mod(p.mod, vec, 3)
    if vec_tr is not None:
        tsh, tsc, tga = _mod(p.mod, vec_tr, 3)
        mk = _tr_mask(x.shape[1], tr_token, x.device)
        shift, scale, gate = _tok(shift, tsh, mk), _tok(scale, tsc, mk), _tok(gate, tga, mk)
    else:
        shift, scale, gate = shift[:, None], scale[:, None], gate[:, None]
    h = layer_norm(x, cfg.eps) * (1 + scale) + shift
    b, s, _ = x.shape
    tl = cfg.txt_len if txt_len is None else txt_len
    q, k, v = _qk_norm(*_lin(p.to_qkv, h).chunk(3, dim=-1), p, b, s, cfg)
    q = torch.cat([apply_rope(q[:, :-tl], cos, sin), q[:, -tl:]], dim=1)
    k = torch.cat([apply_rope(k[:, :-tl], cos, sin), k[:, -tl:]], dim=1)
    att = attention(q, k, v, impl=attn_impl, kv_len=kv_valid, bounded=True).reshape(b, s, cfg.dim)
    x = x + _lin(p.to_out, att) * gate
    ff = _chunked(lambda c: F.linear(gelu_tanh(_lin(p.ff[0], c)), p.ff[2].weight), h)
    return x + ff * gate


# ---------------------------------------------------------------------------
# Top level
# ---------------------------------------------------------------------------

def patchify3d(x: torch.Tensor, patch) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, S, C*prod(patch)) with (c, pt, ph, pw) feature order (the
    Conv3d kernel's own layout)."""
    pt, ph, pw = patch
    b, t, h, w, c = x.shape
    x = x.reshape(b, t // pt, pt, h // ph, ph, w // pw, pw, c)
    x = x.permute(0, 1, 3, 5, 7, 2, 4, 6)
    return x.reshape(b, (t // pt) * (h // ph) * (w // pw), c * pt * ph * pw)


def hunyuan_video_dit_forward(model: HunyuanVideoDiT, cfg: HunyuanVideoDiTConfig, latents,
                              timestep, prompt_emb, text_mask, pooled_prompt_emb,
                              guidance=None, remat: bool = False, attn_impl: str = "auto",
                              token_replace: bool = False) -> torch.Tensor:
    """Velocity (B, T, H, W, 16) for latents (B, T, H, W, 16), timestep (B,), the LLM
    hidden states (B, L, text_dim) with their 0/1 mask (B, L) and the CLIP pooled
    embedding (B, 768).

    token_replace: HunyuanVideo-I2V. The first latent frame holds the clean conditioning
    image, so its tokens take the t = 0 conditioning vector (time_in(0) + vector_in)."""
    pre = hunyuan_video_prelude(model, cfg, latents, timestep, prompt_emb, text_mask,
                                pooled_prompt_emb, guidance, token_replace=token_replace)
    img = hunyuan_video_trunk(model, cfg, pre, remat=remat, attn_impl=attn_impl)
    return hunyuan_video_head(model, cfg, img, pre["vec"], latents.shape)


def hunyuan_video_prelude(model: HunyuanVideoDiT, cfg: HunyuanVideoDiTConfig, latents,
                          timestep, prompt_emb, text_mask, pooled_prompt_emb, guidance=None,
                          token_replace: bool = False) -> Dict:
    """Everything before the block stacks (embeddings, token streams, RoPE tables and
    kv_valid): cheap enough to run every step, also where TeaCache skips the trunk."""
    b, t, h, w, _ = latents.shape
    gh, gw = h // 2, w // 2
    dtype = model.final_layer.linear.weight.dtype
    fd = cfg.freq_dim
    t_vec = _temb(model.time_in, timestep, fd, dtype)
    p_vec = _mlp(model.vector_in, pooled_prompt_emb.to(dtype))
    vec = t_vec + p_vec
    vec_tr, tr_token = None, None
    if token_replace:
        vec_tr = _temb(model.time_in, torch.zeros_like(timestep), fd, dtype) + p_vec
        tr_token = gh * gw
    if cfg.guidance_embed and guidance is not None:
        vec = vec + _temb(model.guidance_in, guidance * 1000.0, fd, dtype)
    conv = model.img_in.proj
    img = F.linear(patchify3d(latents, cfg.patch), conv.weight.reshape(conv.weight.shape[0], -1),
                   conv.bias)
    txt = token_refiner(model.txt_in, cfg, prompt_emb, timestep, text_mask)
    cos_np, sin_np = hunyuan_rope_tables(t, gh, gw, tuple(cfg.rope_dims), cfg.rope_theta)
    cos = torch.from_numpy(cos_np).to(img.device)
    sin = torch.from_numpy(sin_np).to(img.device)
    # valid keys of the joint attention: every image token + the row's valid text prefix
    kv_valid = img.shape[1] + text_mask.to(device=img.device, dtype=torch.int32).sum(1)
    return {"vec": vec, "vec_tr": vec_tr, "tr_token": tr_token, "img": img, "txt": txt,
            "cos": cos, "sin": sin, "kv_valid": kv_valid}


def hunyuan_video_trunk(model: HunyuanVideoDiT, cfg: HunyuanVideoDiTConfig, pre: Dict,
                        remat: bool = False, attn_impl: str = "auto") -> torch.Tensor:
    """The double and single block stacks: image tokens in, image tokens out. remat:
    recompute each block in the backward pass (one checkpoint per block)."""
    kw = dict(attn_impl=attn_impl, kv_valid=pre["kv_valid"], vec_tr=pre["vec_tr"],
              tr_token=pre["tr_token"])
    run = (lambda fn, *a, **k: checkpoint(fn, *a, use_reentrant=False, **k)) if remat \
        else (lambda fn, *a, **k: fn(*a, **k))
    img, txt = pre["img"], pre["txt"]
    vec, cos, sin = pre["vec"], pre["cos"], pre["sin"]
    for blk in model.double_blocks:
        img, txt = run(double_block, blk, img, txt, vec, cos, sin, cfg, **kw)
    tl = txt.shape[1]
    x = torch.cat([img, txt], dim=1)
    del img, txt
    for blk in model.single_blocks:
        x = run(single_block, blk, x, vec, cos, sin, cfg, txt_len=tl, **kw)
    return x[:, :-tl]


def hunyuan_video_head(model: HunyuanVideoDiT, cfg: HunyuanVideoDiTConfig, img, vec,
                       out_shape) -> torch.Tensor:
    """Final adaLN + linear + unpatchify ("(C pT pH pW)", channel-major)."""
    b, t, h, w, _ = out_shape
    gh, gw = h // 2, w // 2
    fl = model.final_layer
    shift, scale = _lin(fl.adaLN_modulation[1], F.silu(vec.float()).to(vec.dtype)).chunk(2, -1)
    img = layer_norm(img, cfg.eps) * (1 + scale[:, None]) + shift[:, None]
    img = _lin(fl.linear, img)
    pt, ph, pw = cfg.patch
    img = img.reshape(b, t // pt, gh, gw, cfg.in_channels, pt, ph, pw)
    img = img.permute(0, 1, 5, 2, 6, 3, 7, 4)
    return img.reshape(b, t, h, w, cfg.in_channels)


def hunyuan_video_teacache_signal(model: HunyuanVideoDiT, cfg: HunyuanVideoDiTConfig, img,
                                  vec) -> torch.Tensor:
    """TeaCache's drift signal: double_blocks[0].component_a's first modulated input."""
    sa1, sc1 = _mod(model.double_blocks[0].component_a.mod, vec, 6)[:2]
    return layer_norm(img, cfg.eps) * (1 + sc1[:, None]) + sa1[:, None]


# ---------------------------------------------------------------------------
# Random init
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_hunyuan_video_dit(cfg: HunyuanVideoDiTConfig, gen: torch.Generator,
                           dtype=torch.bfloat16, *, device) -> HunyuanVideoDiT:
    """Random weights with the distributions of JAX ``init_hunyuan_video_dit``: uniform
    +-1/sqrt(fan_in) linears (and patch embedding), zero biases, unit norms and LayerNorm
    scales; drawn from `gen`."""
    model = empty_module(HunyuanVideoDiT, cfg, dtype=dtype, device=device)
    for m in model.modules():
        if isinstance(m, nn.Linear):
            init_linear_(m, gen)
        elif isinstance(m, (RMSNorm, LayerNormAffine)):
            m.weight.fill_(1.0)
            if isinstance(m, LayerNormAffine):
                m.bias.zero_()
    conv = model.img_in.proj
    s = 1.0 / math.sqrt(conv.weight[0].numel())
    conv.weight.uniform_(-s, s, generator=gen)
    conv.bias.zero_()
    return model.eval().requires_grad_(False)

