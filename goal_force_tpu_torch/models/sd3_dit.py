"""The SD3 / SD3.5 MMDiT in PyTorch.

Port of ``goal_force_tpu/models/sd3_dit.py``: channels-last (B, H, W, 16) latents
patchified 2x2 in (c, dy, dx) feature order plus a learned 2D position embedding
centre-cropped from ``pos_embed_max_size``; the conditioning time (cos-first sinusoid)
+ pooled text through linear-SiLU-linear embedders; joint blocks whose joint sequence
puts the IMAGE stream first (Flux puts the text first), SD3.5's per-head RMS q/k norms
(``use_rms_norm``), SD3.5-Medium's dual blocks (a second gated self-attention on the image
stream, blocks 0 .. num_dual_blocks - 1) before the plain ones, and a final block whose
text stream takes a 2-way AdaLN (scale first) and no update, its attention emitting only
the image stream. ``norm_out`` is a 2-way AdaLN (scale first); the unpatchify is
patch-major, "(P Q C)".

Every attention goes through ``ops/attention.py::attention(impl=attn_impl)``. The heads
are 64 wide, so "auto" takes the plain attention (the kernels take head_dim 128 only),
in row blocks of at most ``PLAIN_LOGITS_BYTES`` of float32 logits, as JAX runs its
head_dim-64 attention in XLA.

``SD3DiT`` holds the parameters under the reference ("diffsynth") names that JAX
``sd3_dit_params_from_torch`` reads: ``pos_embedder.{proj, pos_embed}`` (a Conv2d and a
(1, M, M, D) table), ``time_embedder.timestep_embedder.{0,2}``,
``pooled_text_embedder.{0,2}``, ``context_embedder``,
``blocks.{i}.{norm1_a,norm1_b}.linear``, ``blocks.{i}.attn.{a,b}_to_{qkv,out}``,
``blocks.{i}.attn.norm_{q,k}_{a,b}`` (SD3.5), ``blocks.{i}.attn2.*`` (dual blocks),
``blocks.{i}.ff_{a,b}.{0,2}`` (the last block has no ``b_to_out`` and no ``ff_b``, and a
2-way ``norm1_b``), ``norm_out.linear`` and ``proj_out``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from goal_force_tpu_torch.models.flux_dit import (
    AdaLayerNorm,
    TimestepEmbeddings,
    _mlp,
    _mlp_embed,
    _run,
)
from goal_force_tpu_torch.models.wan_dit import (
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
from goal_force_tpu_torch.ops.attention import attention


@dataclasses.dataclass(frozen=True)
class SD3DiTConfig:
    """SD3-Medium's defaults; SD3.5 sets use_rms_norm (and num_dual_blocks for
    SD3.5-Medium)."""

    dim: int = 1536
    num_layers: int = 24              # incl. the final block
    num_dual_blocks: int = 0
    use_rms_norm: bool = False
    pos_embed_max_size: int = 192
    in_channels: int = 16
    patch: int = 2
    text_dim: int = 4096
    pooled_dim: int = 2048
    freq_dim: int = 256
    eps: float = 1e-6

    @property
    def num_heads(self) -> int:
        return self.dim // 64

    @property
    def head_dim(self) -> int:
        return 64


# The released widths: SD3.5-Large (38 blocks of 2432 = 38 x 64, pos-embed 192) and
# SD3.5-Medium (24 blocks of 1536, the first 13 dual, pos-embed 384).
SD35_LARGE = SD3DiTConfig(dim=2432, num_layers=38, use_rms_norm=True, pos_embed_max_size=192)
SD35_MEDIUM = SD3DiTConfig(dim=1536, num_layers=24, num_dual_blocks=13, use_rms_norm=True,
                           pos_embed_max_size=384)


# ---------------------------------------------------------------------------
# Modules (parameter holders under the reference names)
# ---------------------------------------------------------------------------

class SD3Attention(nn.Module):
    """Stream a (the image) and, unless single, stream b (the text); `out_b` False drops
    the text output projection (the final block)."""

    def __init__(self, cfg: SD3DiTConfig, single: bool = False, out_b: bool = True):
        super().__init__()
        d, hd = cfg.dim, cfg.head_dim
        self.a_to_qkv = nn.Linear(d, 3 * d)
        self.a_to_out = nn.Linear(d, d)
        if not single:
            self.b_to_qkv = nn.Linear(d, 3 * d)
            if out_b:
                self.b_to_out = nn.Linear(d, d)
        if cfg.use_rms_norm:
            self.norm_q_a, self.norm_k_a = RMSNorm(hd), RMSNorm(hd)
            if not single:
                self.norm_q_b, self.norm_k_b = RMSNorm(hd), RMSNorm(hd)


class SD3Block(nn.Module):
    def __init__(self, cfg: SD3DiTConfig, dual: bool = False, final: bool = False):
        super().__init__()
        d = cfg.dim
        self.norm1_a = AdaLayerNorm(d, 9 if dual else 6)
        self.norm1_b = AdaLayerNorm(d, 2 if final else 6)
        self.attn = SD3Attention(cfg, out_b=not final)
        if dual:
            self.attn2 = SD3Attention(cfg, single=True)
        self.ff_a = _mlp(d, 4 * d, d)
        if not final:
            self.ff_b = _mlp(d, 4 * d, d)


class SD3PatchEmbed(nn.Module):
    def __init__(self, cfg: SD3DiTConfig):
        super().__init__()
        m = cfg.pos_embed_max_size
        self.proj = nn.Conv2d(cfg.in_channels, cfg.dim, cfg.patch, stride=cfg.patch)
        self.pos_embed = nn.Parameter(torch.zeros(1, m, m, cfg.dim))


class SD3DiT(nn.Module):
    def __init__(self, cfg: SD3DiTConfig):
        super().__init__()
        d, n = cfg.dim, cfg.num_layers
        self.pos_embedder = SD3PatchEmbed(cfg)
        self.time_embedder = TimestepEmbeddings(cfg.freq_dim, d)
        self.pooled_text_embedder = _mlp(cfg.pooled_dim, d)
        self.context_embedder = nn.Linear(cfg.text_dim, d)
        self.blocks = nn.ModuleList(
            SD3Block(cfg, dual=i < cfg.num_dual_blocks, final=i == n - 1) for i in range(n))
        self.norm_out = AdaLayerNorm(d, 2)
        self.proj_out = nn.Linear(d, cfg.in_channels * cfg.patch ** 2)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _ada_mod(p: AdaLayerNorm, temb: torch.Tensor, n: int):
    return [c[:, None, :] for c in linear(p.linear, silu_f32(temb)).chunk(n, dim=-1)]


def _qkv(p: SD3Attention, stream: str, x: torch.Tensor, cfg: SD3DiTConfig):
    b, s, _ = x.shape
    q, k, v = (t.reshape(b, s, cfg.num_heads, cfg.head_dim)
               for t in linear(getattr(p, f"{stream}_to_qkv"), x).chunk(3, dim=-1))
    if cfg.use_rms_norm:
        q = rms_norm(q, getattr(p, f"norm_q_{stream}").weight, cfg.eps)
        k = rms_norm(k, getattr(p, f"norm_k_{stream}").weight, cfg.eps)
    return q, k, v


def joint_attention(p: SD3Attention, x_a, x_b, cfg: SD3DiTConfig, attn_impl: str = "auto"):
    """The image stream (a) first in the joint sequence; returns (image out, text out or
    None where the attention has no text output projection)."""
    qa, ka, va = _qkv(p, "a", x_a, cfg)
    qb, kb, vb = _qkv(p, "b", x_b, cfg)
    out = attention(torch.cat([qa, qb], dim=1), torch.cat([ka, kb], dim=1),
                    torch.cat([va, vb], dim=1), impl=attn_impl)
    del qa, ka, va, qb, kb, vb
    sa = x_a.shape[1]
    out = out.reshape(x_a.shape[0], -1, cfg.dim)
    o_b = linear(p.b_to_out, out[:, sa:]) if hasattr(p, "b_to_out") else None
    return linear(p.a_to_out, out[:, :sa]), o_b


def single_attention(p: SD3Attention, x, cfg: SD3DiTConfig, attn_impl: str = "auto"):
    q, k, v = _qkv(p, "a", x, cfg)
    out = attention(q, k, v, impl=attn_impl)
    return linear(p.a_to_out, out.reshape(x.shape[0], x.shape[1], cfg.dim))


def _ff(p: nn.ModuleList, x):
    return linear(p[2], gelu_tanh(linear(p[0], x)))


def joint_block(p: SD3Block, x_a, x_b, temb, cfg: SD3DiTConfig, attn_impl: str = "auto"):
    """A joint block; a dual block adds a second gated self-attention on the image."""
    eps = cfg.eps
    dual = hasattr(p, "attn2")
    mods = _ada_mod(p.norm1_a, temb, 9 if dual else 6)
    sm_a, sc_a, g_a, smlp_a, scmlp_a, gmlp_a = mods[:6]
    sm_b, sc_b, g_b, smlp_b, scmlp_b, gmlp_b = _ada_mod(p.norm1_b, temb, 6)
    norm_a = layer_norm(x_a, eps)
    h_a = norm_a * (1 + sc_a) + sm_a
    h_b = layer_norm(x_b, eps) * (1 + sc_b) + sm_b
    att_a, att_b = joint_attention(p.attn, h_a, h_b, cfg, attn_impl)
    x_a = x_a + g_a * att_a
    if dual:
        sm_a2, sc_a2, g_a2 = mods[6:]
        x_a = x_a + g_a2 * single_attention(p.attn2, norm_a * (1 + sc_a2) + sm_a2, cfg,
                                            attn_impl)
    del norm_a
    h_a = layer_norm(x_a, eps) * (1 + scmlp_a) + smlp_a
    x_a = x_a + gmlp_a * _ff(p.ff_a, h_a)
    x_b = x_b + g_b * att_b
    h_b = layer_norm(x_b, eps) * (1 + scmlp_b) + smlp_b
    x_b = x_b + gmlp_b * _ff(p.ff_b, h_b)
    return x_a, x_b


def final_block(p: SD3Block, x_a, x_b, temb, cfg: SD3DiTConfig, attn_impl: str = "auto"):
    """The last block: the text stream takes a 2-way AdaLN (scale first) and no update;
    only the image stream comes out."""
    eps = cfg.eps
    sm_a, sc_a, g_a, smlp_a, scmlp_a, gmlp_a = _ada_mod(p.norm1_a, temb, 6)
    sc_b, sm_b = _ada_mod(p.norm1_b, temb, 2)
    h_a = layer_norm(x_a, eps) * (1 + sc_a) + sm_a
    h_b = layer_norm(x_b, eps) * (1 + sc_b) + sm_b
    x_a = x_a + g_a * joint_attention(p.attn, h_a, h_b, cfg, attn_impl)[0]
    h_a = layer_norm(x_a, eps) * (1 + scmlp_a) + smlp_a
    return x_a + gmlp_a * _ff(p.ff_a, h_a)


def patch_embed(p: SD3PatchEmbed, x: torch.Tensor, cfg: SD3DiTConfig) -> torch.Tensor:
    """(B, H, W, C) -> tokens + the position table centre-cropped to the grid."""
    b, h, w, c = x.shape
    pt = cfg.patch
    gh, gw = h // pt, w // pt
    x = x.reshape(b, gh, pt, gw, pt, c).permute(0, 1, 3, 5, 2, 4).reshape(b, gh * gw, -1)
    tokens = F.linear(x, p.proj.weight.reshape(cfg.dim, -1), p.proj.bias)
    top = (cfg.pos_embed_max_size - gh) // 2
    left = (cfg.pos_embed_max_size - gw) // 2
    pos = p.pos_embed[0, top:top + gh, left:left + gw].reshape(1, gh * gw, -1)
    return tokens + pos.to(tokens.dtype)


def sd3_dit_forward(
    model: SD3DiT,
    cfg: SD3DiTConfig,
    latents: torch.Tensor,            # (B, H, W, 16) channels-last
    timestep: torch.Tensor,           # (B,)
    prompt_emb: torch.Tensor,         # (B, L, text_dim)
    pooled_prompt_emb: torch.Tensor,  # (B, pooled_dim)
    remat: bool = False,
    attn_impl: str = "auto",
) -> torch.Tensor:
    """The velocity prediction (B, H, W, 16)."""
    b, h, w, _ = latents.shape
    pt = cfg.patch
    gh, gw = h // pt, w // pt
    dtype = model.proj_out.weight.dtype
    temb = _mlp_embed(model.time_embedder.timestep_embedder,
                      sinusoidal_embedding(cfg.freq_dim, timestep).to(dtype))
    temb = temb + _mlp_embed(model.pooled_text_embedder, pooled_prompt_emb.to(dtype))
    txt = linear(model.context_embedder, prompt_emb.to(dtype))
    x = patch_embed(model.pos_embedder, latents, cfg)
    for blk in model.blocks[:-1]:
        x, txt = _run(joint_block, remat, blk, x, txt, temb, cfg, attn_impl)
    x = _run(final_block, remat, model.blocks[-1], x, txt, temb, cfg, attn_impl)
    del txt
    sc, sm = _ada_mod(model.norm_out, temb, 2)
    x = linear(model.proj_out, layer_norm(x, cfg.eps) * (1 + sc) + sm)
    x = x.reshape(b, gh, gw, pt, pt, cfg.in_channels).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * pt, gw * pt, cfg.in_channels)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_sd3_dit(cfg: SD3DiTConfig, gen: torch.Generator, dtype=torch.bfloat16, *,
                 device) -> SD3DiT:
    """JAX ``init_sd3_dit``'s distributions, drawn from `gen` on `device`: uniform
    +-1/sqrt(fan_in) linears and patch projection, zero biases, unit RMS norms, a zero
    position table. SD3.5-Large at full depth is 8.1 B parameters: 16.2 GB in bf16,
    built in place on the card."""
    model = empty_module(SD3DiT, cfg, dtype=dtype, device=device)
    for m in model.modules():
        if isinstance(m, nn.Linear):
            init_linear_(m, gen)
        elif isinstance(m, RMSNorm):
            m.weight.fill_(1.0)
    proj = model.pos_embedder.proj
    init_linear_(proj, gen, d_in=proj.weight[0].numel())
    model.pos_embedder.pos_embed.zero_()
    return model.eval().requires_grad_(False)
