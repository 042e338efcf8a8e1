"""The Qwen-Image DiT in PyTorch.

Port of ``goal_force_tpu/models/qwen_image_dit.py``: channels-last (B, H, W, 16)
latents patchified 2x2 in (c, dy, dx) order; Qwen2.5-VL's hidden states RMS-normed into
``txt_in``; the time (sigma x 1000 through the cos-first sinusoid) through a
linear-SiLU-linear embedder; 60 double-stream blocks whose joint sequence puts the TEXT
first, each stream modulated 6 ways (2 x (shift, scale, gate)), q/k RMS-normed per head,
3-axis RoPE on both streams (``qwen_rope_tables_multi``: centred (row, col) positions, a
frame axis per image, the text positions running on from the largest image extent) and
sigmoid-GELU (x * sigmoid(1.702 x)) MLPs; a 2-way AdaLN head (scale first). The forward
returns the main image's TOKENS (B, S, 64); the pipeline unpatchifies
(``qwen_unpatchify``).

The forward also takes the blockwise ControlNet (its residual added to the main image
tokens after each block), ``extra_latents`` (context and edit images appended as more
image tokens at frame positions 1, 2, ...; their outputs dropped), EliGen's entity
prompts (each local prompt before the global one, each with its own text positions, and
the block bias of ``_qwen_entity_bias``) and ``rope_interpolate`` (Qwen-Image-Edit's
sampled positions for the extra grids).

Every joint attention goes through ``ops/attention.py::attention(impl=attn_impl)``: on
the card "auto" at head_dim 128 takes K1 without clamp below the runtime logit bound and
K2 at or past it, one host sync per call; an EliGen bias takes the plain attention, as
JAX sends a bias to XLA.

``QwenImageDiT`` holds the parameters under the reference names that JAX
``qwen_image_dit_params_from_torch`` reads: ``img_in``, ``txt_in``, ``txt_norm``,
``time_text_embed.timestep_embedder.{linear_1, linear_2}``,
``transformer_blocks.{i}.{img_mod.1, txt_mod.1}``, ``transformer_blocks.{i}.attn.{to_q,
to_k, to_v, add_q_proj, add_k_proj, add_v_proj, norm_q, norm_k, norm_added_q,
norm_added_k, to_out.0, to_add_out}``, ``transformer_blocks.{i}.{img,txt}_mlp.net.{0.proj,
2}``, ``norm_out.linear`` and ``proj_out``.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from goal_force_tpu_torch.models.flux_dit import AdaLayerNorm, _heads, _run, _tables, patchify2d
from goal_force_tpu_torch.models.qwen_image_controlnet import (
    QwenImageControlNet,
    qwen_cn_block_p,
    qwen_cn_process_conditioning,
)
from goal_force_tpu_torch.models.wan_dit import (
    Activation,
    RMSNorm,
    empty_module,
    init_linear_,
    layer_norm,
    linear,
    rms_norm,
    silu_f32,
    sinusoidal_embedding,
)
from goal_force_tpu_torch.ops.attention import attention
from goal_force_tpu_torch.ops.rope import apply_rope


@dataclasses.dataclass(frozen=True)
class QwenImageDiTConfig:
    dim: int = 3072
    num_heads: int = 24
    head_dim: int = 128
    num_layers: int = 60
    in_dim: int = 64                 # 2x2-patchified 16-channel latents
    text_dim: int = 3584             # Qwen2.5-VL's hidden width
    freq_dim: int = 256
    axes_dim: Tuple[int, ...] = (16, 56, 56)
    rope_theta: float = 10000.0
    eps: float = 1e-6


# ---------------------------------------------------------------------------
# Modules (parameter holders under the reference names)
# ---------------------------------------------------------------------------

class QwenAttention(nn.Module):
    def __init__(self, cfg: QwenImageDiTConfig):
        super().__init__()
        d, hd = cfg.dim, cfg.head_dim
        for name in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj",
                     "to_add_out"):
            setattr(self, name, nn.Linear(d, d))
        for name in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            setattr(self, name, RMSNorm(hd))
        self.to_out = nn.ModuleList([nn.Linear(d, d)])


class GeluProj(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.proj = nn.Linear(d_in, d_out)


class QwenMLP(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.net = nn.ModuleList([GeluProj(d, 4 * d), Activation(), nn.Linear(4 * d, d)])


class QwenBlock(nn.Module):
    def __init__(self, cfg: QwenImageDiTConfig):
        super().__init__()
        d = cfg.dim
        self.img_mod = nn.ModuleList([Activation(), nn.Linear(d, 6 * d)])
        self.txt_mod = nn.ModuleList([Activation(), nn.Linear(d, 6 * d)])
        self.attn = QwenAttention(cfg)
        self.img_mlp, self.txt_mlp = QwenMLP(d), QwenMLP(d)


class QwenTimestepEmbedder(nn.Module):
    def __init__(self, freq_dim: int, d: int):
        super().__init__()
        self.linear_1 = nn.Linear(freq_dim, d)
        self.linear_2 = nn.Linear(d, d)


class QwenTimeTextEmbed(nn.Module):
    def __init__(self, freq_dim: int, d: int):
        super().__init__()
        self.timestep_embedder = QwenTimestepEmbedder(freq_dim, d)


class QwenImageDiT(nn.Module):
    def __init__(self, cfg: QwenImageDiTConfig):
        super().__init__()
        d = cfg.dim
        self.img_in = nn.Linear(cfg.in_dim, d)
        self.txt_norm = RMSNorm(cfg.text_dim)
        self.txt_in = nn.Linear(cfg.text_dim, d)
        self.time_text_embed = QwenTimeTextEmbed(cfg.freq_dim, d)
        self.transformer_blocks = nn.ModuleList(QwenBlock(cfg) for _ in range(cfg.num_layers))
        self.norm_out = AdaLayerNorm(d, 2)
        self.proj_out = nn.Linear(d, cfg.in_dim)


# ---------------------------------------------------------------------------
# RoPE tables
# ---------------------------------------------------------------------------

@lru_cache(maxsize=8)
def qwen_rope_tables_multi(shapes, txt_len: int, axes_dim: Tuple[int, ...], theta: float,
                           interpolate: bool = False):
    """((cos, sin) of the image tokens (S_img, D/2), (cos, sin) of the text (S_txt, D/2)),
    float32 numpy from float64 angles. shapes: the (gh, gw) token grids, the i-th at frame
    position i; rows and columns centred (range(-(n - n//2), n//2)); the text positions
    start at the largest max(gh // 2, gw // 2) on all three axes. interpolate: the grids
    past the first take their rows and columns by linspace-sampling the first grid's
    (Qwen-Image-Edit's edit_rope_interpolation)."""
    halves = [d // 2 for d in axes_dim]

    def axis_angles(pos, d):
        freqs = 1.0 / theta ** (np.arange(0, d, 2, dtype=np.float64) / d)
        return np.outer(np.asarray(pos, np.float64), freqs)

    parts = []
    for idx, (gh, gw) in enumerate(shapes):
        af = axis_angles([idx], axes_dim[0])
        if interpolate and idx > 0:
            gh0, gw0 = shapes[0]
            h_pos0 = np.arange(-(gh0 - gh0 // 2), gh0 // 2)
            w_pos0 = np.arange(-(gw0 - gw0 // 2), gw0 // 2)
            ah = axis_angles(h_pos0[np.linspace(0, gh0 - 1, gh).astype(np.int64)], axes_dim[1])
            aw = axis_angles(w_pos0[np.linspace(0, gw0 - 1, gw).astype(np.int64)], axes_dim[2])
        else:
            ah = axis_angles(np.arange(-(gh - gh // 2), gh // 2), axes_dim[1])
            aw = axis_angles(np.arange(-(gw - gw // 2), gw // 2), axes_dim[2])
        parts.append(np.concatenate([
            np.broadcast_to(af[:, None, None, :], (1, gh, gw, halves[0])),
            np.broadcast_to(ah[None, :, None, :], (1, gh, gw, halves[1])),
            np.broadcast_to(aw[None, None, :, :], (1, gh, gw, halves[2])),
        ], axis=-1).reshape(gh * gw, -1))
    img = np.concatenate(parts, axis=0)
    start = max(max(gh // 2, gw // 2) for gh, gw in shapes)
    tpos = np.arange(start, start + txt_len)
    txt = np.concatenate([axis_angles(tpos, d) for d in axes_dim], axis=-1)
    return ((np.cos(img).astype(np.float32), np.sin(img).astype(np.float32)),
            (np.cos(txt).astype(np.float32), np.sin(txt).astype(np.float32)))


def qwen_rope_tables(gh: int, gw: int, txt_len: int, axes_dim: Tuple[int, ...],
                     theta: float):
    """The tables of one grid."""
    return qwen_rope_tables_multi(((gh, gw),), txt_len, axes_dim, theta)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _approx_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _mod3(e: torch.Tensor):
    return [c[:, None] for c in e.chunk(3, dim=-1)]


def _qwen_entity_bias(entity_masks: torch.Tensor, seg_lens: Sequence[int], s_img_total: int,
                      s_main: int) -> torch.Tensor:
    """EliGen's (B, 1, S, S) additive bias over (the text segments, global prompt last;
    the image tokens): each local prompt and the image tokens its mask covers (tiled over
    the extra images) see each other only; distinct prompt segments are masked; the
    global prompt and image-image attention stay dense. entity_masks (B, M, h, w) binary
    at latent resolution."""
    b, m = entity_masks.shape[:2]
    gh, gw = entity_masks.shape[2] // 2, entity_masks.shape[3] // 2
    patch = entity_masks.reshape(b, m, gh, 2, gw, 2).sum((3, 5)) > 0
    patch = patch.reshape(b, m, gh * gw).repeat(1, 1, s_img_total // s_main)
    s_txt = int(sum(seg_lens))
    s = s_txt + s_img_total
    allow = torch.ones((b, s, s), dtype=torch.bool, device=entity_masks.device)
    cum = np.cumsum([0] + list(seg_lens))
    for i in range(m):
        st, en = int(cum[i]), int(cum[i + 1])
        im = patch[:, i][:, None].expand(b, en - st, s_img_total)
        allow[:, st:en, s_txt:] = im
        allow[:, s_txt:, st:en] = im.transpose(1, 2)
    n = len(seg_lens)
    for i in range(n):
        for j in range(n):
            if i != j:
                allow[:, int(cum[i]):int(cum[i + 1]), int(cum[j]):int(cum[j + 1])] = False
    zero = torch.zeros((), device=allow.device)
    return torch.where(allow, zero, float("-inf"))[:, None]


def qwen_block(p: QwenBlock, img, txt, temb, img_rope, txt_rope, cfg: QwenImageDiTConfig,
               attn_impl: str = "auto", attn_bias=None):
    """One double-stream block; the joint sequence is (text, image)."""
    n, eps = cfg.num_heads, cfg.eps
    t_act = silu_f32(temb)
    img_attn_mod, img_mlp_mod = linear(p.img_mod[1], t_act).chunk(2, dim=-1)
    txt_attn_mod, txt_mlp_mod = linear(p.txt_mod[1], t_act).chunk(2, dim=-1)
    sh, sc, g_img = _mod3(img_attn_mod)
    h_img = layer_norm(img, eps) * (1 + sc) + sh
    sh, sc, g_txt = _mod3(txt_attn_mod)
    h_txt = layer_norm(txt, eps) * (1 + sc) + sh
    a = p.attn
    qi = apply_rope(rms_norm(_heads(linear(a.to_q, h_img), n), a.norm_q.weight, eps), *img_rope)
    ki = apply_rope(rms_norm(_heads(linear(a.to_k, h_img), n), a.norm_k.weight, eps), *img_rope)
    vi = _heads(linear(a.to_v, h_img), n)
    qt = apply_rope(rms_norm(_heads(linear(a.add_q_proj, h_txt), n), a.norm_added_q.weight,
                             eps), *txt_rope)
    kt = apply_rope(rms_norm(_heads(linear(a.add_k_proj, h_txt), n), a.norm_added_k.weight,
                             eps), *txt_rope)
    vt = _heads(linear(a.add_v_proj, h_txt), n)
    del h_img, h_txt
    q, k, v = (torch.cat(pair, dim=1) for pair in ((qt, qi), (kt, ki), (vt, vi)))
    del qi, ki, vi, qt, kt, vt
    out = attention(q, k, v, impl="plain" if attn_bias is not None else attn_impl,
                    bias=attn_bias)
    del q, k, v
    st = txt.shape[1]
    out = out.reshape(out.shape[0], out.shape[1], cfg.dim)
    img = img + g_img * linear(a.to_out[0], out[:, st:])
    txt = txt + g_txt * linear(a.to_add_out, out[:, :st])
    del out
    return _mlp_update(img, img_mlp_mod, p.img_mlp, eps), _mlp_update(txt, txt_mlp_mod,
                                                                       p.txt_mlp, eps)


def _mlp_update(x, mod, mlp: QwenMLP, eps: float):
    sh, sc, gate = _mod3(mod)
    h = layer_norm(x, eps) * (1 + sc) + sh
    return x + gate * linear(mlp.net[2], _approx_gelu(linear(mlp.net[0].proj, h)))


# ---------------------------------------------------------------------------
# Top level
# ---------------------------------------------------------------------------

def qwen_image_dit_forward(
    model: QwenImageDiT,
    cfg: QwenImageDiTConfig,
    latents: torch.Tensor,          # (B, H, W, 16) channels-last
    timestep: torch.Tensor,         # (B,) sigma in [0, 1] (x 1000 in the embedding)
    prompt_emb: torch.Tensor,       # (B, L, text_dim)
    remat: bool = False,
    attn_impl: str = "auto",
    controlnet: Optional[QwenImageControlNet] = None,
    controlnet_cond: Optional[torch.Tensor] = None,     # (B, S, in_dim) patchified
    extra_latents: Optional[Sequence[torch.Tensor]] = None,   # [(B, H_i, W_i, 16)]
    entity_prompt_embs: Optional[Sequence[torch.Tensor]] = None,   # [(B, L_i, text_dim)]
    entity_masks: Optional[torch.Tensor] = None,        # (B, M, h, w) binary
    rope_interpolate: bool = False,
) -> torch.Tensor:
    """The main image's velocity tokens (B, S_main, in_dim)."""
    dtype = model.proj_out.weight.dtype
    x = patchify2d(latents)
    shapes = [(latents.shape[1] // 2, latents.shape[2] // 2)]
    s_main = x.shape[1]
    for extra in (extra_latents or ()):
        shapes.append((extra.shape[1] // 2, extra.shape[2] // 2))
        x = torch.cat([x, patchify2d(extra.to(latents.dtype))], dim=1)
    img = linear(model.img_in, x)

    def embed_txt(e):
        return linear(model.txt_in, rms_norm(e.to(dtype), model.txt_norm.weight, cfg.eps))

    segments = list(entity_prompt_embs or ()) + [prompt_emb]
    txt = torch.cat([embed_txt(e) for e in segments], dim=1)
    te = model.time_text_embed.timestep_embedder
    temb = sinusoidal_embedding(cfg.freq_dim, timestep * 1000.0).to(dtype)
    temb = linear(te.linear_2, silu_f32(linear(te.linear_1, temb)))

    shapes = tuple(shapes)
    tables = lambda length: qwen_rope_tables_multi(shapes, length, tuple(cfg.axes_dim),
                                                   cfg.rope_theta, interpolate=rope_interpolate)
    img_rope = _tables(*tables(prompt_emb.shape[1])[0], x.device)
    attn_bias = None
    if entity_prompt_embs:
        # each text segment takes its own positions from the shared start
        seg = [tables(e.shape[1])[1] for e in segments]
        txt_rope = _tables(np.concatenate([t[0] for t in seg]),
                           np.concatenate([t[1] for t in seg]), x.device)
        attn_bias = _qwen_entity_bias(entity_masks, [e.shape[1] for e in segments],
                                      x.shape[1], s_main)
    else:
        txt_rope = _tables(*tables(prompt_emb.shape[1])[1], x.device)

    cn_cond = None
    if controlnet is not None and controlnet_cond is not None:
        cn_cond = qwen_cn_process_conditioning(controlnet, controlnet_cond.to(dtype))
    for i, blk in enumerate(model.transformer_blocks):
        img, txt = _run(qwen_block, remat, blk, img, txt, temb, img_rope, txt_rope, cfg,
                        attn_impl, attn_bias=attn_bias)
        if cn_cond is not None:
            # the residual lands on the main image tokens only
            res = qwen_cn_block_p(controlnet.controlnet_blocks[i], img[:, :s_main], cn_cond,
                                  cfg.eps)
            img = torch.cat([img[:, :s_main] + res, img[:, s_main:]], dim=1)
    scale, shift = linear(model.norm_out.linear, silu_f32(temb)).chunk(2, dim=-1)
    img = layer_norm(img[:, :s_main], cfg.eps) * (1 + scale[:, None]) + shift[:, None]
    return linear(model.proj_out, img)


def qwen_unpatchify(tokens: torch.Tensor, height: int, width: int,
                    channels: int = 16) -> torch.Tensor:
    """(B, S, C*4) tokens -> (B, H/8, W/8, C) latents of a (height, width) image."""
    b = tokens.shape[0]
    gh, gw = height // 16, width // 16
    x = tokens.reshape(b, gh, gw, channels, 2, 2).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, gh * 2, gw * 2, channels)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_qwen_image_dit(cfg: QwenImageDiTConfig, gen: torch.Generator, dtype=torch.bfloat16,
                        *, device) -> QwenImageDiT:
    """JAX ``init_qwen_image_dit``'s distributions drawn from `gen` on `device`: uniform
    +-1/sqrt(fan_in) linears, zero biases, unit norms. The released Qwen-Image is 20.4 B
    parameters: 40.9 GB in bf16, built in place on the card."""
    model = empty_module(QwenImageDiT, cfg, dtype=dtype, device=device)
    for m in model.modules():
        if isinstance(m, nn.Linear):
            init_linear_(m, gen)
        elif isinstance(m, RMSNorm):
            m.weight.fill_(1.0)
    return model.eval().requires_grad_(False)
