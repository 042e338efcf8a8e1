"""Flux's auxiliary conditioning modules: InfiniteYou, the value controller, the LoRA
encoder and the IP-Adapter's per-block image K/V.

Port of ``goal_force_tpu/models/flux_adapters.py`` (and the Flux image projection of
``goal_force_tpu/models/ipadapter.py``):

  - ``infiniteyou_projector``: a perceiver resampler; learned query latents attend over
    cat(projected ArcFace tokens, latents) with both sides scaled by head_dim^-1/4,
    LayerNorm-first FFNs with exact GELU, then a projection and a LayerNorm;
  - ``value_control_embedding`` / ``multi_value_embedding``: value x 1000 through a cos-
    first sinusoid, linear-SiLU-linear, broadcast over learned positional tokens;
  - ``flux_lora_encode``: per LoRA layer a learned probe x @ A^T @ B^T and a LayerNorm,
    per layer type a projection, CLIP encoder layers (quick GELU, no mask) over [special,
    lora tokens], the special tokens read out through a LayerNorm and a linear;
  - ``flux_ip_kwargs``: the IP-Adapter's MLP image projection, then each block's K (RMS
    over head_dim, no affine) and V, stacked for ``flux_dit_forward(ipadapter=)``.

The attentions here are small and run inline in torch, as JAX runs them in XLA. Each
module keeps the reference names, and each has a loader that reads a state dict
strictly, recovering the sizes from its shapes (``*_from_state_dict``); JAX has no
loader for the IP-Adapter, whose names here are the reference FluxIpAdapter's
(``image_proj.proj.{0,2}``, ``image_proj.norm``, ``ipadapter_modules.{i}.to_{k,v}_ip``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from goal_force_tpu_torch.models.clip import CLIPEncoderLayer, _ln, _tower
from goal_force_tpu_torch.models.sd_unet import linear
from goal_force_tpu_torch.models.wan_dit import (
    Activation,
    LayerNormAffine,
    empty_module,
    init_linear_,
)


LN_EPS = 1e-5


def _mlp_list(d_in: int, d_hidden: int, d_out: int, bias: bool = True) -> nn.ModuleList:
    return nn.ModuleList([nn.Linear(d_in, d_hidden, bias=bias), Activation(),
                          nn.Linear(d_hidden, d_out, bias=bias)])


def _count(sd, fmt: str) -> int:
    i = 0
    while fmt.format(i) in sd:
        i += 1
    return i


def _load(cls, sd, what: str, *args, dtype=None, device=None):
    """cls(*args) read strictly from sd, in `dtype` on `device` (default: the file's)."""
    from goal_force_tpu_torch.io.auto import _strict

    dtype = dtype or next(v.dtype for v in sd.values() if v.is_floating_point())
    device = device or next(iter(sd.values())).device
    return _strict(lambda _cfg: cls(*args), None, sd, what, dtype, device)


# ---------------------------------------------------------------------------
# InfiniteYou
# ---------------------------------------------------------------------------

class PerceiverAttention(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.norm1, self.norm2 = LayerNormAffine(dim), LayerNormAffine(dim)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, 2 * inner, bias=False)
        self.to_out = nn.Linear(inner, dim, bias=False)


class InfiniteYouProjector(nn.Module):
    """InfiniteYouImageProjector: ``latents`` (1, queries, dim), ``proj_in``,
    ``layers.{i}.0`` (perceiver attention), ``layers.{i}.1.{0,1,3}`` (LayerNorm and the
    bias-free FFN), ``proj_out``, ``norm_out``."""

    def __init__(self, dim: int = 1280, depth: int = 4, inner: int = 1280,
                 num_queries: int = 8, embedding_dim: int = 512, output_dim: int = 4096,
                 ff_dim: int = 5120):
        super().__init__()
        self.latents = nn.Parameter(torch.zeros(1, num_queries, dim))
        self.proj_in = nn.Linear(embedding_dim, dim)
        self.proj_out = nn.Linear(dim, output_dim)
        self.norm_out = LayerNormAffine(output_dim)
        self.layers = nn.ModuleList(
            nn.ModuleList([PerceiverAttention(dim, inner),
                           nn.ModuleList([LayerNormAffine(dim), nn.Linear(dim, ff_dim, bias=False),
                                          Activation(), nn.Linear(ff_dim, dim, bias=False)])])
            for _ in range(depth))


def _perceiver_attention(p: PerceiverAttention, x, latents, heads: int, head_dim: int):
    b, l, _ = latents.shape
    xn, ln = _ln(p.norm1, x, LN_EPS), _ln(p.norm2, latents, LN_EPS)
    q = linear(p.to_q, ln)
    k, v = linear(p.to_kv, torch.cat([xn, ln], dim=1)).chunk(2, dim=-1)
    q, k, v = (t.reshape(b, -1, heads, head_dim).transpose(1, 2) for t in (q, k, v))
    scale = 1.0 / math.sqrt(math.sqrt(head_dim))
    w = torch.softmax(((q * scale) @ (k * scale).transpose(-1, -2)).float(), -1).to(x.dtype)
    return linear(p.to_out, (w @ v).transpose(1, 2).reshape(b, l, -1))


def infiniteyou_projector(model: InfiniteYouProjector, id_embeds: torch.Tensor,
                          heads: int = 20, head_dim: int = 64) -> torch.Tensor:
    """(B, N, 512) ArcFace tokens -> (B, num_queries, 4096)."""
    x = linear(model.proj_in, id_embeds)
    latents = model.latents.to(x.dtype).expand(id_embeds.shape[0], -1, -1)
    for attn, ff in model.layers:
        latents = latents + _perceiver_attention(attn, x, latents, heads, head_dim)
        h = F.gelu(linear(ff[1], _ln(ff[0], latents, LN_EPS)))
        latents = latents + linear(ff[3], h)
    return _ln(model.norm_out, linear(model.proj_out, latents), LN_EPS)


def infiniteyou_from_state_dict(sd: Dict[str, torch.Tensor]) -> InfiniteYouProjector:
    _, queries, dim = sd["latents"].shape
    return _load(InfiniteYouProjector, sd, "infiniteyou", dim, _count(sd, "layers.{}.0.to_q.weight"),
                 sd["layers.0.0.to_q.weight"].shape[0], queries, sd["proj_in.weight"].shape[1],
                 sd["proj_out.weight"].shape[0], sd["layers.0.1.1.weight"].shape[0])


# ---------------------------------------------------------------------------
# Value control
# ---------------------------------------------------------------------------

class SingleValueEncoder(nn.Module):
    """``prefer_value_embedder.{0,2}`` and ``positional_embedding`` (prefer_len, dim_out)."""

    def __init__(self, dim_in: int = 256, dim_hidden: int = 4096, dim_out: int = 4096,
                 prefer_len: int = 32):
        super().__init__()
        self.prefer_value_embedder = _mlp_list(dim_in, dim_hidden, dim_out)
        self.positional_embedding = nn.Parameter(torch.zeros(prefer_len, dim_out))


def value_control_embedding(model: SingleValueEncoder, value, dim_in: int = 256,
                            prefer_len: int = 32) -> torch.Tensor:
    """A scalar preference value -> (prefer_len, dim_out) tokens: value x 1000 through the
    [cos | sin] sinusoid, linear-SiLU-linear, plus the positions. The frequencies are
    JAX's float32 exp()s: at angles of up to ~1000 the pow() form of
    ``sinusoidal_embedding`` would round ~1e-4 apart."""
    dev = model.positional_embedding.device
    half = dim_in // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=dev)
                      / half)
    v = torch.as_tensor(value, dtype=torch.float32, device=dev).reshape(-1) * 1000.0
    ang = v[:, None] * freqs[None]
    emb = torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)
    p = model.prefer_value_embedder
    h = linear(p[2], F.silu(linear(p[0], emb)))
    return h.expand(prefer_len, h.shape[-1]) + model.positional_embedding.to(h.dtype)


def multi_value_embedding(encoders: Sequence[SingleValueEncoder], values: Sequence) -> torch.Tensor:
    """The token blocks of the values that are present, concatenated."""
    return torch.cat([value_control_embedding(m, v) for m, v in zip(encoders, values)
                      if v is not None], dim=0)


def value_encoder_from_state_dict(sd: Dict[str, torch.Tensor]) -> SingleValueEncoder:
    hidden, dim_in = sd["prefer_value_embedder.0.weight"].shape
    prefer_len, dim_out = sd["positional_embedding"].shape
    return _load(SingleValueEncoder, sd, "value encoder", dim_in, hidden, dim_out, prefer_len)


# ---------------------------------------------------------------------------
# LoRA encoder
# ---------------------------------------------------------------------------

def flux_lora_patterns() -> List[Dict]:
    """The 19 x 10 + 38 x 3 Flux LoRA target layers with their (in, out) widths."""
    pats = []
    double = {"attn.a_to_qkv": (3072, 9216), "attn.a_to_out": (3072, 3072),
              "ff_a.0": (3072, 12288), "ff_a.2": (12288, 3072),
              "norm1_a.linear": (3072, 18432),
              "attn.b_to_qkv": (3072, 9216), "attn.b_to_out": (3072, 3072),
              "ff_b.0": (3072, 12288), "ff_b.2": (12288, 3072),
              "norm1_b.linear": (3072, 18432)}
    for i in range(19):
        for sfx, dim in double.items():
            pats.append({"name": f"blocks.{i}.{sfx}", "dim": dim, "type": sfx})
    single = {"to_qkv_mlp": (3072, 21504), "proj_out": (15360, 3072),
              "norm.linear": (3072, 9216)}
    for i in range(38):
        for sfx, dim in single.items():
            pats.append({"name": f"single_blocks.{i}.{sfx}", "dim": dim, "type": sfx})
    return pats


def _key(name: str) -> str:
    return name.replace(".", "___")


class LoRALayerBlock(nn.Module):
    def __init__(self, num_embeds: int, dim_in: int, dim_out: int):
        super().__init__()
        self.x = nn.Parameter(torch.zeros(1, num_embeds, dim_in))
        self.layer_norm = LayerNormAffine(dim_out)


class LoRAEmbedder(nn.Module):
    def __init__(self, patterns: List[Dict], num_embeds: int, out_dim: int):
        super().__init__()
        self.model_dict = nn.ModuleDict({_key(p["name"]): LoRALayerBlock(num_embeds, *p["dim"])
                                         for p in patterns})
        proj = {}
        for p in patterns:
            proj.setdefault(_key(p["type"]), nn.Linear(p["dim"][1], out_dim))
        self.proj_dict = nn.ModuleDict(proj)


class FluxLoRAEncoder(nn.Module):
    def __init__(self, patterns: Optional[List[Dict]] = None, num_embeds: int = 16,
                 embed_dim: int = 4096, intermediate: int = 8192, num_layers: int = 1,
                 num_special: int = 1):
        super().__init__()
        self.embedder = LoRAEmbedder(patterns or flux_lora_patterns(), num_embeds, embed_dim)
        self.encoders = nn.ModuleList(CLIPEncoderLayer(embed_dim, intermediate)
                                      for _ in range(num_layers))
        self.special_embeds = nn.Parameter(torch.zeros(1, num_special, embed_dim))
        self.final_layer_norm = LayerNormAffine(embed_dim)
        self.final_linear = nn.Linear(embed_dim, embed_dim)


def flux_lora_encode(model: FluxLoRAEncoder, lora: Dict, patterns: Optional[List[Dict]] = None,
                     heads: int = 32, num_special: int = 1) -> torch.Tensor:
    """A LoRA state dict (``{name}.lora_A.default.weight`` / ``lora_B``) -> (1,
    num_special, embed_dim)."""
    parts = []
    for pat in patterns or flux_lora_patterns():
        blk = model.embedder.model_dict[_key(pat["name"])]
        ab = [torch.as_tensor(lora[f"{pat['name']}.lora_{s}.default.weight"]).to(blk.x)
              for s in "AB"]
        x = _ln(blk.layer_norm, blk.x @ ab[0].T @ ab[1].T, LN_EPS)
        parts.append(linear(model.embedder.proj_dict[_key(pat["type"])], x))
    emb = torch.cat(parts, dim=1)
    emb = torch.cat([model.special_embeds.to(emb.dtype), emb], dim=1)
    emb = _tower(model.encoders, emb, heads, "quick_gelu", LN_EPS, causal=False)
    return linear(model.final_linear, _ln(model.final_layer_norm, emb[:, :num_special], LN_EPS))


def flux_lora_encoder_from_state_dict(sd: Dict[str, torch.Tensor],
                                      patterns: Optional[List[Dict]] = None) -> FluxLoRAEncoder:
    _, num_special, dim = sd["special_embeds"].shape
    pat0 = (patterns or flux_lora_patterns())[0]
    return _load(FluxLoRAEncoder, sd, "flux lora encoder", patterns,
                 sd[f"embedder.model_dict.{_key(pat0['name'])}.x"].shape[1], dim,
                 sd["encoders.0.fc1.weight"].shape[0], _count(sd, "encoders.{}.fc1.weight"),
                 num_special)


# ---------------------------------------------------------------------------
# IP-Adapter
# ---------------------------------------------------------------------------

class MLPProjModel(nn.Module):
    def __init__(self, ctx_dim: int, id_dim: int, num_tokens: int):
        super().__init__()
        self.proj = _mlp_list(id_dim, 2 * id_dim, ctx_dim * num_tokens)
        self.norm = LayerNormAffine(ctx_dim)


class IpAdapterModule(nn.Module):
    def __init__(self, ctx_dim: int, dim: int):
        super().__init__()
        self.to_k_ip = nn.Linear(ctx_dim, dim, bias=False)
        self.to_v_ip = nn.Linear(ctx_dim, dim, bias=False)


class FluxIpAdapter(nn.Module):
    """The reference FluxIpAdapter: one K/V module per DiT block (19 joint, then 38
    single) over the projected SigLIP embedding."""

    def __init__(self, num_blocks: int = 57, dim: int = 3072, ctx_dim: int = 4096,
                 id_dim: int = 1152, num_tokens: int = 128):
        super().__init__()
        self.ipadapter_modules = nn.ModuleList(IpAdapterModule(ctx_dim, dim)
                                               for _ in range(num_blocks))
        self.image_proj = MLPProjModel(ctx_dim, id_dim, num_tokens)


def image_tokens(norm: LayerNormAffine, x: torch.Tensor) -> torch.Tensor:
    """(B, tokens·ctx) -> (1, B·tokens, ctx): the batch folded into tokens, then a
    LayerNorm (eps 1e-5) in x's dtype; the IP-Adapters' image projections end so."""
    x = x.reshape(-1, norm.weight.shape[0])
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + 1e-5)
    return (x * norm.weight.to(x.dtype) + norm.bias.to(x.dtype))[None]


def flux_ip_image_proj(p: MLPProjModel, image_embeds: torch.Tensor) -> torch.Tensor:
    """(B, id_dim) -> (1, B·tokens, ctx_dim): linear, exact GELU, linear, then
    ``image_tokens``."""
    return image_tokens(p.norm, linear(p.proj[2], F.gelu(linear(p.proj[0], image_embeds))))


def flux_ip_kwargs(model: FluxIpAdapter, image_embeds: torch.Tensor, num_heads: int = 24,
                   head_dim: int = 128, scale: float = 1.0, num_joint: int = 19,
                   num_single: int = 38) -> Dict:
    """Each block's image K (RMS over head_dim, eps 1e-5, no affine) and V, stacked:
    {"joint": {"k", "v", "scale"} over the first num_joint modules, "single": ... over
    the next num_single}, as ``flux_dit_forward(ipadapter=)`` takes them."""
    tokens = flux_ip_image_proj(model.image_proj, image_embeds)

    def kv(m: IpAdapterModule):
        k = linear(m.to_k_ip, tokens).reshape(tokens.shape[0], -1, num_heads, head_dim)
        kf = k.float()
        k = (kf * torch.rsqrt(kf.square().mean(-1, keepdim=True) + 1e-5)).to(tokens.dtype)
        return k, linear(m.to_v_ip, tokens).reshape(tokens.shape[0], -1, num_heads, head_dim)

    ks, vs = zip(*(kv(m) for m in model.ipadapter_modules))

    def part(lo: int, n: int) -> Dict:
        return {"k": torch.stack(ks[lo:lo + n]), "v": torch.stack(vs[lo:lo + n]),
                "scale": torch.full((n,), scale, dtype=tokens.dtype, device=tokens.device)}

    return {"joint": part(0, num_joint), "single": part(num_joint, num_single)}


def flux_ipadapter_from_state_dict(sd: Dict[str, torch.Tensor]) -> FluxIpAdapter:
    dim, ctx = sd["ipadapter_modules.0.to_k_ip.weight"].shape
    id_dim = sd["image_proj.proj.0.weight"].shape[1]
    return _load(FluxIpAdapter, sd, "flux ipadapter", _count(sd, "ipadapter_modules.{}.to_k_ip.weight"),
                 dim, ctx, id_dim, sd["image_proj.proj.2.weight"].shape[0] // ctx)


@torch.no_grad()
def init_adapter(cls, *args, gen: torch.Generator, dtype=torch.float32, device) -> nn.Module:
    """One of the modules above (``cls(*args)``) with random weights from `gen`, for tests
    and the card's smoke (JAX loads these from files only): uniform +-1/sqrt(fan_in)
    linears with zero biases, unit LayerNorms, the learned tokens and probes N(0, 1)."""
    model = empty_module(cls, *args, dtype=dtype, device=device)
    for m in model.modules():
        if isinstance(m, nn.Linear):
            init_linear_(m, gen)
        elif isinstance(m, LayerNormAffine):
            m.weight.fill_(1.0)
            m.bias.zero_()
    for name, p in model.named_parameters():
        if name.rsplit(".", 1)[-1] in ("latents", "positional_embedding", "x", "special_embeds"):
            p.normal_(generator=gen)
    return model.eval().requires_grad_(False)
