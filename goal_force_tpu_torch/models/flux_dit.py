"""The Flux.1 MMDiT in PyTorch.

Port of ``goal_force_tpu/models/flux_dit.py``: channels-last (B, H, W, 16) latents
patchified 2x2 in (c, dy, dx) feature order; the conditioning time + pooled CLIP (+
embedded guidance x 1000) through linear-SiLU-linear embedders over the cos-first
sinusoid; 3-axis RoPE over the ids (0, row, col) per patch (text ids zero, a Kontext
image's axis-0 id 1), angles in float64 on the host, float32 tables applied to
interleaved pairs (``ops/rope.py::apply_rope``); joint (double-stream) blocks with the
text stream first in the joint sequence, affine q/k RMS norms per stream and gelu-tanh
FFs; single-stream blocks with the fused ``to_qkv_mlp`` split (d, 2d, 3d), parallel
attention and GELU and one ``proj_out`` over both; the AdaLayerNormContinuous head.

The forward also takes what the pipeline composes: ControlNet residuals after each block
(padded over the Kontext rows), Kontext tokens appended to the image stream and dropped
at the head, EliGen's merged text (local prompts first, the global one last) with its
block bias, a RoPE table override (Nexus-Gen), the IP-Adapter's per-block image K/V,
``return_tokens`` for TeaCache, and ``remat`` (``torch.utils.checkpoint`` per block).

Both attentions go through ``ops/attention.py::attention(impl=attn_impl)`` with no
``bounded``: on the card, "auto" at head_dim 128 takes K1 (no clamp) or K2 behind the
runtime logit bound, one host sync per call; a bias (EliGen) or the CPU takes the plain
attention. The IP-Adapter's side attention runs the plain attention, as JAX runs its
einsums in XLA.

``FluxDiT`` holds the parameters under the reference ("diffsynth") names: ``x_embedder``,
``context_embedder``, ``time_embedder.timestep_embedder.{0,2}``,
``guidance_embedder.timestep_embedder.{0,2}`` (FLUX.1-dev), ``pooled_text_embedder.{0,2}``,
``blocks.{i}.{norm1_a,norm1_b}.linear``, ``blocks.{i}.attn.{a,b}_to_{qkv,out}``,
``blocks.{i}.attn.norm_{q,k}_{a,b}``, ``blocks.{i}.ff_{a,b}.{0,2}``,
``single_blocks.{i}.{norm.linear, to_qkv_mlp, norm_q_a, norm_k_a, proj_out}``,
``final_norm_out.linear`` and ``final_proj_out``.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from goal_force_tpu_torch.configs import FluxDiTConfig
from goal_force_tpu_torch.models.wan_dit import (
    Activation,
    RMSNorm,
    empty_module,
    gelu_tanh,
    init_linear_,
    layer_norm,
    linear,
    rms_norm,
    silu_f32,
    sinusoidal_embedding,
)
from goal_force_tpu_torch.ops.attention import attention, plain_attention
from goal_force_tpu_torch.ops.rope import apply_rope


# ---------------------------------------------------------------------------
# Modules (parameter holders under the reference names)
# ---------------------------------------------------------------------------

class AdaLayerNorm(nn.Module):
    def __init__(self, dim: int, n: int):
        super().__init__()
        self.linear = nn.Linear(dim, n * dim)


class FluxJointAttention(nn.Module):
    def __init__(self, cfg: FluxDiTConfig):
        super().__init__()
        d, hd = cfg.dim, cfg.head_dim
        self.a_to_qkv = nn.Linear(d, 3 * d)
        self.b_to_qkv = nn.Linear(d, 3 * d)
        self.norm_q_a, self.norm_k_a = RMSNorm(hd), RMSNorm(hd)
        self.norm_q_b, self.norm_k_b = RMSNorm(hd), RMSNorm(hd)
        self.a_to_out = nn.Linear(d, d)
        self.b_to_out = nn.Linear(d, d)


def _mlp(d_in: int, d: int, d_out: Optional[int] = None) -> nn.ModuleList:
    """Linear, activation, linear under the Sequential indices 0 and 2."""
    return nn.ModuleList([nn.Linear(d_in, d), Activation(), nn.Linear(d, d_out or d)])


class FluxJointBlock(nn.Module):
    def __init__(self, cfg: FluxDiTConfig):
        super().__init__()
        d = cfg.dim
        self.norm1_a, self.norm1_b = AdaLayerNorm(d, 6), AdaLayerNorm(d, 6)
        self.attn = FluxJointAttention(cfg)
        self.ff_a, self.ff_b = _mlp(d, 4 * d, d), _mlp(d, 4 * d, d)


class FluxSingleBlock(nn.Module):
    def __init__(self, cfg: FluxDiTConfig):
        super().__init__()
        d = cfg.dim
        self.norm = AdaLayerNorm(d, 3)
        self.to_qkv_mlp = nn.Linear(d, 7 * d)
        self.norm_q_a, self.norm_k_a = RMSNorm(cfg.head_dim), RMSNorm(cfg.head_dim)
        self.proj_out = nn.Linear(5 * d, d)


class TimestepEmbeddings(nn.Module):
    def __init__(self, freq_dim: int, d: int):
        super().__init__()
        self.timestep_embedder = _mlp(freq_dim, d)


class FluxTrunk(nn.Module):
    """The embedders and the block stacks shared by the DiT and its ControlNet."""

    def __init__(self, cfg: FluxDiTConfig, num_joint: int, num_single: int):
        super().__init__()
        d = cfg.dim
        self.time_embedder = TimestepEmbeddings(cfg.freq_dim, d)
        if cfg.guidance_embed:
            self.guidance_embedder = TimestepEmbeddings(cfg.freq_dim, d)
        self.pooled_text_embedder = _mlp(cfg.pooled_dim, d)
        self.context_embedder = nn.Linear(cfg.text_dim, d)
        self.x_embedder = nn.Linear(cfg.in_dim, d)
        self.blocks = nn.ModuleList(FluxJointBlock(cfg) for _ in range(num_joint))
        self.single_blocks = nn.ModuleList(FluxSingleBlock(cfg) for _ in range(num_single))


class FluxDiT(FluxTrunk):
    def __init__(self, cfg: FluxDiTConfig):
        super().__init__(cfg, cfg.num_joint_blocks, cfg.num_single_blocks)
        self.final_norm_out = AdaLayerNorm(cfg.dim, 2)
        self.final_proj_out = nn.Linear(cfg.dim, cfg.out_dim)


# ---------------------------------------------------------------------------
# RoPE over (axis0, row, col) ids
# ---------------------------------------------------------------------------

@lru_cache(maxsize=8)
def flux_rope_tables(text_len: int, grid_h: int, grid_w: int,
                     axes_dim: Tuple[int, ...], theta: float,
                     kontext_grids: Tuple[Tuple[int, int], ...] = ()):
    """(S_total, head_dim // 2) float32 numpy cos, sin over cat(text ids 0, the image's
    (0, row, col) per 2x2 patch, each Kontext grid's (1, row, col)); per axis the angles
    pos / theta^(2j / dim_i) in float64."""
    s_img = grid_h * grid_w
    s_k = sum(gh * gw for gh, gw in kontext_grids)
    ids = np.zeros((text_len + s_img + s_k, 3), np.float64)
    ids[text_len:text_len + s_img, 1] = np.repeat(np.arange(grid_h), grid_w)
    ids[text_len:text_len + s_img, 2] = np.tile(np.arange(grid_w), grid_h)
    off = text_len + s_img
    for gh, gw in kontext_grids:
        ids[off:off + gh * gw, 0] = 1.0
        ids[off:off + gh * gw, 1] = np.repeat(np.arange(gh), gw)
        ids[off:off + gh * gw, 2] = np.tile(np.arange(gw), gh)
        off += gh * gw
    cos, sin = [], []
    for i, d in enumerate(axes_dim):
        omega = 1.0 / theta ** (np.arange(0, d, 2, dtype=np.float64) / d)
        ang = np.outer(ids[:, i], omega)
        cos.append(np.cos(ang))
        sin.append(np.sin(ang))
    return (np.concatenate(cos, axis=-1).astype(np.float32),
            np.concatenate(sin, axis=-1).astype(np.float32))


def _tables(cos, sin, device):
    """The (cos, sin) tables (numpy or torch) as float32 tensors on `device`."""
    return tuple(torch.as_tensor(t, dtype=torch.float32, device=device) for t in (cos, sin))


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _ada_mod(p: AdaLayerNorm, temb: torch.Tensor, n: int):
    """linear(silu(temb)) -> n chunks of (B, 1, D)."""
    return [c[:, None, :] for c in linear(p.linear, silu_f32(temb)).chunk(n, dim=-1)]


def _heads(x: torch.Tensor, n: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.reshape(b, s, n, d // n)


def _ip_attend(q: torch.Tensor, ip: Dict, dtype) -> torch.Tensor:
    """The IP-Adapter's side attention: the same queries (B, S, N, H) over the block's
    image K/V (B or 1, T, N, H), scaled, in `dtype`."""
    b = q.shape[0]
    k = ip["k"].expand((b,) + ip["k"].shape[1:]).to(dtype)
    v = ip["v"].expand((b,) + ip["v"].shape[1:]).to(dtype)
    return ip["scale"].to(dtype) * plain_attention(q, k, v, q.shape[-1] ** -0.5)


def joint_block(p: FluxJointBlock, x_img, x_txt, temb, cos, sin, cfg: FluxDiTConfig,
                attn_impl: str = "auto", attn_bias=None, ip=None):
    """One double-stream block; the joint sequence is (text, image)."""
    n, eps = cfg.num_heads, cfg.eps
    sm_a, sc_a, g_a, smlp_a, scmlp_a, gmlp_a = _ada_mod(p.norm1_a, temb, 6)
    sm_b, sc_b, g_b, smlp_b, scmlp_b, gmlp_b = _ada_mod(p.norm1_b, temb, 6)
    a = p.attn
    h_a = layer_norm(x_img, eps) * (1 + sc_a) + sm_a
    h_b = layer_norm(x_txt, eps) * (1 + sc_b) + sm_b
    q_a, k_a, v_a = linear(a.a_to_qkv, h_a).chunk(3, dim=-1)
    q_b, k_b, v_b = linear(a.b_to_qkv, h_b).chunk(3, dim=-1)
    del h_a, h_b
    q = torch.cat([rms_norm(_heads(q_b, n), a.norm_q_b.weight, eps),
                   rms_norm(_heads(q_a, n), a.norm_q_a.weight, eps)], dim=1)
    k = torch.cat([rms_norm(_heads(k_b, n), a.norm_k_b.weight, eps),
                   rms_norm(_heads(k_a, n), a.norm_k_a.weight, eps)], dim=1)
    v = torch.cat([_heads(v_b, n), _heads(v_a, n)], dim=1)
    del q_a, k_a, v_a, q_b, k_b, v_b
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    out = attention(q, k, v, impl=attn_impl, bias=attn_bias)
    b, s = out.shape[:2]
    t = x_txt.shape[1]
    if ip is not None:
        out = torch.cat([out[:, :t], out[:, t:] + _ip_attend(q[:, t:], ip, out.dtype)], dim=1)
    del q, k, v
    out = out.reshape(b, s, cfg.dim)
    o_txt = linear(a.b_to_out, out[:, :t])
    o_img = linear(a.a_to_out, out[:, t:])
    del out

    x_img = x_img + g_a * o_img
    h_a = layer_norm(x_img, eps) * (1 + scmlp_a) + smlp_a
    x_img = x_img + gmlp_a * linear(p.ff_a[2], gelu_tanh(linear(p.ff_a[0], h_a)))
    x_txt = x_txt + g_b * o_txt
    h_b = layer_norm(x_txt, eps) * (1 + scmlp_b) + smlp_b
    x_txt = x_txt + gmlp_b * linear(p.ff_b[2], gelu_tanh(linear(p.ff_b[0], h_b)))
    return x_img, x_txt


def single_block(p: FluxSingleBlock, x, temb, cos, sin, cfg: FluxDiTConfig,
                 attn_impl: str = "auto", attn_bias=None, ip=None):
    """One single-stream block: the fused qkv + MLP projection, attention and GELU side
    by side, one output projection over both."""
    n, d, eps = cfg.num_heads, cfg.dim, cfg.eps
    shift, scale, gate = _ada_mod(p.norm, temb, 3)
    h = layer_norm(x, eps) * (1 + scale) + shift
    q, k, v, mlp = linear(p.to_qkv_mlp, h).split([d, d, d, 4 * d], dim=-1)
    del h
    q = apply_rope(rms_norm(_heads(q, n), p.norm_q_a.weight, eps), cos, sin)
    k = apply_rope(rms_norm(_heads(k, n), p.norm_k_a.weight, eps), cos, sin)
    att = attention(q, k, _heads(v, n), impl=attn_impl, bias=attn_bias)
    if ip is not None:
        att = att + _ip_attend(q, ip, att.dtype)
    del q, k, v
    att = att.reshape(x.shape[0], x.shape[1], d)
    out = linear(p.proj_out, torch.cat([att, gelu_tanh(mlp)], dim=-1))
    return x + gate * out


# ---------------------------------------------------------------------------
# Top level
# ---------------------------------------------------------------------------

def _mlp_embed(p: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    return linear(p[2], silu_f32(linear(p[0], x)))


def eligen_entity_bias(entity_masks: torch.Tensor, txt_len: int, s_img: int) -> torch.Tensor:
    """EliGen's attention bias (B, 1, S, S), S = (M + 1)·txt_len + s_img, over (M local
    prompts, the global prompt, the image): each local prompt and its image patches see
    each other only; every pair of distinct prompt blocks is masked, the global prompt's
    included; image-image attention stays dense. entity_masks: (B, M, H, W) binary at
    latent resolution."""
    b, m, h, w = entity_masks.shape
    patch = entity_masks.reshape(b, m, h // 2, 2, w // 2, 2)
    patch = (patch.sum((3, 5)) > 0).reshape(b, m, s_img)
    n = m + 1
    s = n * txt_len + s_img
    mask = torch.ones((b, s, s), dtype=torch.bool, device=entity_masks.device)
    img0 = n * txt_len
    for i in range(m):
        p0, p1 = i * txt_len, (i + 1) * txt_len
        im = patch[:, i][:, None].expand(b, txt_len, s_img)
        mask[:, p0:p1, img0:] = im
        mask[:, img0:, p0:p1] = im.transpose(1, 2)
    for i in range(n):
        for j in range(n):
            if i != j:
                mask[:, i * txt_len:(i + 1) * txt_len, j * txt_len:(j + 1) * txt_len] = False
    zero = torch.zeros((), device=mask.device)
    return torch.where(mask, zero, float("-inf"))[:, None]


def patchify2d(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2·W/2, C·4) in (c, dy, dx) feature order."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, (h // 2) * (w // 2), c * 4)


def unpatchify2d(x: torch.Tensor, grid_h: int, grid_w: int, out_channels: int) -> torch.Tensor:
    """(B, S, C·4) -> (B, H, W, C), the inverse of ``patchify2d``."""
    b = x.shape[0]
    x = x.reshape(b, grid_h, grid_w, out_channels, 2, 2).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, grid_h * 2, grid_w * 2, out_channels)


def time_cond(model: FluxTrunk, cfg: FluxDiTConfig, timestep, pooled, guidance=None):
    """The conditioning: time embedding + pooled-text embedding (+ the guidance's at
    guidance x 1000 where the model has a guidance embedder)."""
    dtype = model.x_embedder.weight.dtype
    cond = _mlp_embed(model.time_embedder.timestep_embedder,
                      sinusoidal_embedding(cfg.freq_dim, timestep).to(dtype))
    cond = cond + _mlp_embed(model.pooled_text_embedder, pooled.to(dtype))
    if cfg.guidance_embed and guidance is not None:
        cond = cond + _mlp_embed(model.guidance_embedder.timestep_embedder,
                                 sinusoidal_embedding(cfg.freq_dim, guidance * 1000.0).to(dtype))
    return cond


def _block_ip(ip: Optional[Dict], i: int) -> Optional[Dict]:
    return None if ip is None else {k: v[i] for k, v in ip.items()}


def _run(fn, remat: bool, *args, **kw):
    if remat:
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return fn(*args, **kw)


def flux_dit_forward(
    model: FluxDiT,
    cfg: FluxDiTConfig,
    latents: torch.Tensor,             # (B, H, W, 16) channels-last
    timestep: torch.Tensor,            # (B,)
    prompt_emb: torch.Tensor,          # (B, L_txt, text_dim) T5 states
    pooled_prompt_emb: torch.Tensor,   # (B, pooled_dim) CLIP pooled
    guidance: Optional[torch.Tensor] = None,   # (B,) embedded guidance
    remat: bool = False,
    attn_impl: str = "auto",
    controlnet_res: Optional[torch.Tensor] = None,         # (num_joint, B, S_img, D)
    controlnet_single_res: Optional[torch.Tensor] = None,  # (num_single, B, S_img, D)
    kontext_latents: Optional[torch.Tensor] = None,        # (B, Hk, Wk, 16)
    entity_prompt_emb: Optional[torch.Tensor] = None,      # (B, M, L, text_dim)
    entity_masks: Optional[torch.Tensor] = None,           # (B, M, H, W)
    rope_tables_override=None,                             # (cos, sin) (S, hd/2)
    return_tokens: bool = False,
    ipadapter: Optional[Dict] = None,   # {"joint"/"single": {"k", "v", "scale"} stacked}
):
    """The velocity prediction in the latents' shape. With return_tokens, also the image
    tokens before and after the blocks (TeaCache's residual)."""
    b, h, w, _ = latents.shape
    gh, gw = h // 2, w // 2
    temb = time_cond(model, cfg, timestep, pooled_prompt_emb, guidance)
    x = linear(model.x_embedder, patchify2d(latents))
    s_img = x.shape[1]
    kontext_grids = ()
    if kontext_latents is not None:
        kontext_grids = ((kontext_latents.shape[1] // 2, kontext_latents.shape[2] // 2),)
        x = torch.cat([x, linear(model.x_embedder, patchify2d(kontext_latents))], dim=1)
    attn_bias = None
    if entity_prompt_emb is not None and entity_masks is not None:
        bb, m, ll, _ = entity_prompt_emb.shape
        merged_txt = torch.cat([entity_prompt_emb.to(x.dtype).reshape(bb, m * ll, -1),
                                prompt_emb.to(x.dtype)], dim=1)
        txt = linear(model.context_embedder, merged_txt)
        attn_bias = eligen_entity_bias(entity_masks, prompt_emb.shape[1], x.shape[1])
    else:
        txt = linear(model.context_embedder, prompt_emb.to(x.dtype))
    t_len = txt.shape[1]
    if rope_tables_override is not None:
        cos, sin = _tables(*rope_tables_override, x.device)
    else:
        cos, sin = _tables(*flux_rope_tables(t_len, gh, gw, tuple(cfg.axes_dim),
                                             cfg.rope_theta, kontext_grids), x.device)
    ip_joint = None if ipadapter is None else ipadapter.get("joint")
    ip_single = None if ipadapter is None else ipadapter.get("single")

    s_tot = x.shape[1]

    def pad_res(r):
        return r if s_tot == s_img else F.pad(r, (0, 0, 0, s_tot - s_img))

    x_in = x
    for i, blk in enumerate(model.blocks):
        x, txt = _run(joint_block, remat, blk, x, txt, temb, cos, sin, cfg, attn_impl,
                      attn_bias=attn_bias, ip=_block_ip(ip_joint, i))
        if controlnet_res is not None:
            x = x + pad_res(controlnet_res[i]).to(x.dtype)
    merged = torch.cat([txt, x], dim=1)
    del txt, x
    for i, blk in enumerate(model.single_blocks):
        merged = _run(single_block, remat, blk, merged, temb, cos, sin, cfg, attn_impl,
                      attn_bias=attn_bias, ip=_block_ip(ip_single, i))
        if controlnet_single_res is not None:
            res = pad_res(controlnet_single_res[i]).to(merged.dtype)
            merged = torch.cat([merged[:, :t_len], merged[:, t_len:] + res], dim=1)
    x = merged[:, t_len:t_len + s_img]
    v = flux_dit_head(model, cfg, x, temb, gh, gw)
    if return_tokens:
        return v, x_in[:, :s_img], x
    return v


def flux_dit_head(model: FluxDiT, cfg: FluxDiTConfig, x: torch.Tensor, temb: torch.Tensor,
                  gh: int, gw: int) -> torch.Tensor:
    """The AdaLayerNormContinuous head, the output projection and the unpatchify (alone,
    so TeaCache's skipped steps reuse it)."""
    scale, shift = linear(model.final_norm_out.linear, silu_f32(temb)).chunk(2, dim=-1)
    x = layer_norm(x, cfg.eps) * (1 + scale[:, None]) + shift[:, None]
    return unpatchify2d(linear(model.final_proj_out, x), gh, gw, cfg.out_dim // 4)


def flux_dit_mod_input(model: FluxDiT, cfg: FluxDiTConfig, latents, timestep, pooled_prompt_emb,
                       guidance=None) -> torch.Tensor:
    """Block 0's modulated image-stream input: TeaCache's change signal."""
    temb = time_cond(model, cfg, timestep, pooled_prompt_emb, guidance)
    x = linear(model.x_embedder, patchify2d(latents))
    sm, sc = _ada_mod(model.blocks[0].norm1_a, temb, 6)[:2]
    return layer_norm(x, cfg.eps) * (1 + sc) + sm


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_flux_trunk_(model: nn.Module, gen: torch.Generator) -> nn.Module:
    """JAX ``init_flux_dit``'s distributions on every linear and norm of `model`:
    uniform +-1/sqrt(fan_in) weights, zero biases, unit RMS norms."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            init_linear_(m, gen)
        elif isinstance(m, RMSNorm):
            m.weight.fill_(1.0)
    return model.eval().requires_grad_(False)


def init_flux_dit(cfg: FluxDiTConfig, gen: torch.Generator, dtype=torch.bfloat16, *,
                  device) -> FluxDiT:
    """Random weights drawn from `gen` on `device` (FLUX.1-dev at full depth is 11.9 B
    parameters: 23.8 GB in bf16, built in place on the card)."""
    return init_flux_trunk_(empty_module(FluxDiT, cfg, dtype=dtype, device=device), gen)
