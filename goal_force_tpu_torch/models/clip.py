"""CLIP text tower in PyTorch.

Port of the text side of ``goal_force_tpu/models/clip.py``: ``CLIPConfig`` with its
presets, the float32 LayerNorm ``_ln``, the activations ``_act``, the causal attention
``_attn``, the pre-LN tower ``_tower`` and ``clip_encode_text`` (EOS- or argmax-pooled,
projected features). The vision side waits for the families that use it (LLaVA,
ImageReward).

``CLIPTextModel`` holds the parameters under the reference ("diffsynth") SD text
encoder's state-dict names that ``goal_force_tpu/models/sd_text_encoder.py::
sd_text_params_from_torch`` reads: ``token_embedding``, ``position_embeds`` (1, S, D),
``encoders.{i}.{layer_norm1, attn.to_q/to_k/to_v/to_out, layer_norm2, fc1, fc2}`` and
``final_layer_norm``, plus a bias-free ``text_projection`` where the tower projects its
pooled features (``clip_encode_text``).
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
    """projection: add the bias-free ``text_projection`` (text_dim -> proj_dim)."""

    def __init__(self, cfg: CLIPConfig, projection: bool = False):
        super().__init__()
        d = cfg.text_dim
        self.token_embedding = nn.Embedding(cfg.vocab_size, d)
        self.position_embeds = nn.Parameter(torch.zeros(1, cfg.max_positions, d))
        self.encoders = nn.ModuleList(CLIPEncoderLayer(d, d * cfg.mlp_ratio)
                                      for _ in range(cfg.text_layers))
        self.final_layer_norm = LayerNormAffine(d)
        if projection:
            self.text_projection = nn.Linear(d, cfg.proj_dim, bias=False)


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
                   device, projection: bool = False) -> CLIPTextModel:
    """Random weights for tests and the smoke, drawn from `gen`: N(0, 0.02**2) token and
    position embeddings, uniform +-1/sqrt(fan_in) linears, zero biases, unit norms."""
    model = empty_module(CLIPTextModel, cfg, projection, dtype=dtype, device=device)
    model.token_embedding.weight.normal_(generator=gen).mul_(0.02)
    model.position_embeds.normal_(generator=gen).mul_(0.02)
    for m in model.modules():
        if isinstance(m, nn.Linear):
            init_linear_(m, gen)
        elif isinstance(m, LayerNormAffine):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return model.eval().requires_grad_(False)

