"""CLIP text and vision towers in PyTorch.

Port of ``goal_force_tpu/models/clip.py``: ``CLIPConfig`` with its presets, the float32
LayerNorm ``_ln``, the activations ``_act``, the causal attention ``_attn``, the pre-LN
tower ``_tower`` and ``clip_encode_text`` (EOS- or argmax-pooled, projected features);
on the vision side ``clip_encode_image`` (CLS-pooled, post-LN, projected),
``clip_vision_hidden_states`` (an intermediate layer's tokens, pre-``ln_post``, as
LLaVA reads them) and ``clip_similarity``. The vision attention is at head_dim 64 and
runs ``ops/attention.py::plain_attention``, as JAX runs it in XLA.

``CLIPTextModel`` holds the parameters under the reference ("diffsynth") SD text
encoder's state-dict names that ``goal_force_tpu/models/sd_text_encoder.py::
sd_text_params_from_torch`` reads: ``token_embedding``, ``position_embeds`` (1, S, D),
``encoders.{i}.{layer_norm1, attn.to_q/to_k/to_v/to_out, layer_norm2, fc1, fc2}`` and
``final_layer_norm``, plus a bias-free ``text_projection`` where the tower projects its
pooled features (``clip_encode_text``). ``CLIPVisionModel`` holds the vision tower under
the HF ``CLIPModel`` names that JAX ``clip_params_from_hf`` reads (``vision_model.
{embeddings.{patch_embedding, class_embedding, position_embedding}, pre_layrnorm,
encoder.layers.{i}.{layer_norm1, self_attn.{q,k,v,out}_proj, layer_norm2, mlp.fc1,
mlp.fc2}, post_layernorm}``, plus a bias-free ``visual_projection``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from goal_force_tpu_torch.models.wan_dit import LayerNormAffine, empty_module, init_linear_


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    # text tower
    vocab_size: int = 49408
    text_dim: int = 512
    text_heads: int = 8
    text_layers: int = 12
    max_positions: int = 77
    # vision tower
    image_size: int = 224
    patch_size: int = 32
    vision_dim: int = 768
    vision_heads: int = 12
    vision_layers: int = 12
    # shared
    proj_dim: int = 512
    mlp_ratio: int = 4
    hidden_act: str = "quick_gelu"   # "quick_gelu" (HF CLIP) | "gelu" (open_clip ViT-H)
    text_pooling: str = "eos_token"  # "eos_token" (HF) | "argmax" (open_clip)
    eos_token_id: int = 49407
    eps: float = 1e-5


# HF CLIP-L/14 and CLIP-H/14 (the JAX package's scorer towers)
CLIP_L_14 = CLIPConfig(text_dim=768, text_heads=12, text_layers=12,
                       patch_size=14, vision_dim=1024, vision_heads=16,
                       vision_layers=24, proj_dim=768)
CLIP_H_14 = CLIPConfig(text_dim=1024, text_heads=16, text_layers=24,
                       patch_size=14, vision_dim=1280, vision_heads=16,
                       vision_layers=32, proj_dim=1024,
                       hidden_act="gelu", text_pooling="argmax")


class CLIPAttention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.to_q = nn.Linear(dim, dim)
        self.to_k = nn.Linear(dim, dim)
        self.to_v = nn.Linear(dim, dim)
        self.to_out = nn.Linear(dim, dim)


class CLIPEncoderLayer(nn.Module):
    def __init__(self, dim: int, mlp_dim: int):
        super().__init__()
        self.layer_norm1 = LayerNormAffine(dim)
        self.attn = CLIPAttention(dim)
        self.layer_norm2 = LayerNormAffine(dim)
        self.fc1 = nn.Linear(dim, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, dim)


class CLIPTextModel(nn.Module):
    """projection: add the bias-free ``text_projection`` (text_dim -> proj_dim, or
    `proj_dim` where given: SDXL's bigG projects 1280 -> 1280 whatever the config's
    proj_dim says). final_norm=False leaves out ``final_layer_norm`` (SDXL's first tower,
    CLIP-L cut to 11 layers, has none)."""

    def __init__(self, cfg: CLIPConfig, projection: bool = False, final_norm: bool = True,
                 proj_dim: int | None = None):
        super().__init__()
        d = cfg.text_dim
        self.token_embedding = nn.Embedding(cfg.vocab_size, d)
        self.position_embeds = nn.Parameter(torch.zeros(1, cfg.max_positions, d))
        self.encoders = nn.ModuleList(CLIPEncoderLayer(d, d * cfg.mlp_ratio)
                                      for _ in range(cfg.text_layers))
        if final_norm:
            self.final_layer_norm = LayerNormAffine(d)
        if projection:
            self.text_projection = nn.Linear(d, proj_dim or cfg.proj_dim, bias=False)


def _ln(p: LayerNormAffine, x: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm in float32, the affine in float32 too, then cast to x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * p.weight + p.bias).to(x.dtype)


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    return F.gelu(x)


def _attn(p: CLIPAttention, x: torch.Tensor, num_heads: int, causal: bool) -> torch.Tensor:
    b, s, d = x.shape
    h = num_heads
    q = F.linear(x, p.to_q.weight, p.to_q.bias).reshape(b, s, h, d // h)
    k = F.linear(x, p.to_k.weight, p.to_k.bias).reshape(b, s, h, d // h)
    v = F.linear(x, p.to_v.weight, p.to_v.bias).reshape(b, s, h, d // h)
    logits = torch.einsum("bqhc,bkhc->bhqk", q, k) * (d // h) ** -0.5
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits.float(), dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhc->bqhc", probs, v).reshape(b, s, d)
    return F.linear(out, p.to_out.weight, p.to_out.bias)


def _tower(layers, x: torch.Tensor, num_heads: int, act: str, eps: float,
           causal: bool) -> torch.Tensor:
    """Pre-LN transformer over `layers` in order."""
    for p in layers:
        x = x + _attn(p.attn, _ln(p.layer_norm1, x, eps), num_heads, causal)
        y = F.linear(_ln(p.layer_norm2, x, eps), p.fc1.weight, p.fc1.bias)
        x = x + F.linear(_act(act, y), p.fc2.weight, p.fc2.bias)
    return x


class HFCLIPAttention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)


class HFCLIPMLP(nn.Module):
    def __init__(self, dim: int, mlp_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, dim)


class HFCLIPEncoderLayer(nn.Module):
    def __init__(self, dim: int, mlp_dim: int):
        super().__init__()
        self.layer_norm1 = LayerNormAffine(dim)
        self.self_attn = HFCLIPAttention(dim)
        self.layer_norm2 = LayerNormAffine(dim)
        self.mlp = HFCLIPMLP(dim, mlp_dim)


class HFCLIPEncoder(nn.Module):
    def __init__(self, dim: int, mlp_dim: int, depth: int):
        super().__init__()
        self.layers = nn.ModuleList(HFCLIPEncoderLayer(dim, mlp_dim) for _ in range(depth))


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        d, p = cfg.vision_dim, cfg.patch_size
        self.class_embedding = nn.Parameter(torch.zeros(d))
        self.patch_embedding = nn.Conv2d(3, d, p, stride=p, bias=False)
        self.position_embedding = nn.Embedding((cfg.image_size // p) ** 2 + 1, d)


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        d = cfg.vision_dim
        self.embeddings = CLIPVisionEmbeddings(cfg)
        self.pre_layrnorm = LayerNormAffine(d)
        self.encoder = HFCLIPEncoder(d, d * cfg.mlp_ratio, cfg.vision_layers)
        self.post_layernorm = LayerNormAffine(d)


class CLIPVisionModel(nn.Module):
    """projection: add the bias-free ``visual_projection`` (vision_dim -> proj_dim)."""

    def __init__(self, cfg: CLIPConfig, projection: bool = False):
        super().__init__()
        self.vision_model = CLIPVisionTransformer(cfg)
        if projection:
            self.visual_projection = nn.Linear(cfg.vision_dim, cfg.proj_dim, bias=False)


def _vision_tower(layers, x: torch.Tensor, num_heads: int, act: str, eps: float) -> torch.Tensor:
    """The pre-LN vision tower over `layers` (HF names); its attention is the plain one."""
    from goal_force_tpu_torch.ops.attention import plain_attention

    b, s, d = x.shape
    for p in layers:
        h = _ln(p.layer_norm1, x, eps)
        a = p.self_attn
        q, k, v = (F.linear(h, m.weight, m.bias).reshape(b, s, num_heads, d // num_heads)
                   for m in (a.q_proj, a.k_proj, a.v_proj))
        out = plain_attention(q, k, v, (d // num_heads) ** -0.5).reshape(b, s, d)
        x = x + F.linear(out, a.out_proj.weight, a.out_proj.bias)
        y = F.linear(_ln(p.layer_norm2, x, eps), p.mlp.fc1.weight, p.mlp.fc1.bias)
        x = x + F.linear(_act(act, y), p.mlp.fc2.weight, p.mlp.fc2.bias)
    return x


def _vision_embed(vm: CLIPVisionTransformer, cfg: CLIPConfig, pixels: torch.Tensor):
    """(B, H, W, 3) pixels -> pre-LN'd [CLS; patches] + positions (B, 1+N, vision_dim)."""
    emb = vm.embeddings
    w = emb.patch_embedding.weight
    patches = F.conv2d(pixels.permute(0, 3, 1, 2).to(w.dtype), w, stride=cfg.patch_size)
    x = patches.flatten(2).transpose(1, 2)
    cls = emb.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
    x = torch.cat([cls, x], dim=1) + emb.position_embedding.weight[:x.shape[1] + 1]
    return _ln(vm.pre_layrnorm, x, cfg.eps)


def clip_encode_image(model: CLIPVisionModel, cfg: CLIPConfig, pixels: torch.Tensor,
                      return_tokens: bool = False):
    """(B, H, W, 3) preprocessed pixels -> (B, proj_dim) image features: CLS-pooled,
    post-LN, projected. `return_tokens` also returns every post-LN token feature
    (B, 1+N, vision_dim)."""
    vm = model.vision_model
    x = _vision_tower(vm.encoder.layers, _vision_embed(vm, cfg, pixels), cfg.vision_heads,
                      cfg.hidden_act, cfg.eps)
    proj = model.visual_projection.weight
    if return_tokens:
        tokens = _ln(vm.post_layernorm, x, cfg.eps)
        return F.linear(tokens[:, 0], proj), tokens
    return F.linear(_ln(vm.post_layernorm, x[:, :1], cfg.eps)[:, 0], proj)


def clip_vision_hidden_states(model: CLIPVisionModel, cfg: CLIPConfig, pixels: torch.Tensor,
                              feature_layer: int = -2) -> torch.Tensor:
    """(B, H, W, 3) preprocessed pixels -> (B, 1+N, vision_dim) token features of an
    intermediate layer, before ``post_layernorm``: HF's ``hidden_states[feature_layer]``
    (index -2 runs all but the last layer)."""
    n_blocks = cfg.vision_layers + 1 + feature_layer if feature_layer < 0 else feature_layer
    if not 0 <= n_blocks <= cfg.vision_layers:
        raise ValueError(f"feature_layer {feature_layer} out of range for "
                         f"{cfg.vision_layers} vision layers")
    vm = model.vision_model
    return _vision_tower(vm.encoder.layers[:n_blocks], _vision_embed(vm, cfg, pixels),
                         cfg.vision_heads, cfg.hidden_act, cfg.eps)


def clip_similarity(text_model: CLIPTextModel, vision_model: CLIPVisionModel, cfg: CLIPConfig,
                    pixels: torch.Tensor, input_ids: torch.Tensor, logit_scale=None):
    """Cosine similarity matrix (n_text, n_image) of the projected features, scaled by
    exp(logit_scale) where one is given (HF ``CLIPModel``'s ``logits_per_text``)."""
    img = clip_encode_image(vision_model, cfg, pixels)
    txt = clip_encode_text(text_model, cfg, input_ids)
    img = img / img.norm(dim=-1, keepdim=True)
    txt = txt / txt.norm(dim=-1, keepdim=True)
    sim = txt @ img.T
    if logit_scale is not None:
        sim = torch.exp(torch.as_tensor(logit_scale, dtype=sim.dtype, device=sim.device)) * sim
    return sim


def embed_tokens(model: CLIPTextModel, input_ids: torch.Tensor) -> torch.Tensor:
    return model.token_embedding.weight[input_ids] + model.position_embeds[0, :input_ids.shape[1]]


def clip_encode_text(model: CLIPTextModel, cfg: CLIPConfig, input_ids: torch.Tensor,
                     return_tokens: bool = False):
    """(B, S) int ids -> (B, proj_dim) projected pooled text features.

    Pooling: "eos_token" takes the first `eos_token_id` position, "argmax" the largest
    id (the EOT token has the highest id in the CLIP BPE vocab). `return_tokens` also
    returns the final-LN token features."""
    b = input_ids.shape[0]
    x = _tower(model.encoders, embed_tokens(model, input_ids), cfg.text_heads, cfg.hidden_act,
               cfg.eps, causal=True)
    x = _ln(model.final_layer_norm, x, cfg.eps)
    if cfg.text_pooling == "eos_token":
        idx = torch.argmax((input_ids == cfg.eos_token_id).int(), dim=-1)
    else:
        idx = torch.argmax(input_ids, dim=-1)
    pooled = x[torch.arange(b, device=x.device), idx]
    feats = F.linear(pooled, model.text_projection.weight)
    return (feats, x) if return_tokens else feats


@torch.no_grad()
def init_clip_text(cfg: CLIPConfig, gen: torch.Generator, dtype=torch.float32, *,
                   device, projection: bool = False, final_norm: bool = True,
                   proj_dim: int | None = None) -> CLIPTextModel:
    """Random weights for tests and the smoke, drawn from `gen`: N(0, 0.02**2) token and
    position embeddings, uniform +-1/sqrt(fan_in) linears, zero biases, unit norms."""
    model = empty_module(CLIPTextModel, cfg, projection, final_norm, proj_dim, dtype=dtype,
                         device=device)
    model.token_embedding.weight.normal_(generator=gen).mul_(0.02)
    model.position_embeds.normal_(generator=gen).mul_(0.02)
    for m in model.modules():
        if isinstance(m, nn.Linear):
            init_linear_(m, gen)
        elif isinstance(m, LayerNormAffine):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return model.eval().requires_grad_(False)



@torch.no_grad()
def init_clip_vision(cfg: CLIPConfig, gen: torch.Generator, dtype=torch.float32, *,
                     device, projection: bool = False) -> CLIPVisionModel:
    """Random vision-tower weights drawn from `gen`: N(0, 0.02**2) patch, class and
    position embeddings, uniform +-1/sqrt(fan_in) linears, zero biases, unit norms."""
    model = empty_module(CLIPVisionModel, cfg, projection, dtype=dtype, device=device)
    emb = model.vision_model.embeddings
    for w in (emb.patch_embedding.weight, emb.class_embedding, emb.position_embedding.weight):
        w.normal_(generator=gen).mul_(0.02)
    for m in model.modules():
        if isinstance(m, nn.Linear):
            init_linear_(m, gen)
        elif isinstance(m, LayerNormAffine):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return model.eval().requires_grad_(False)
