"""The Llama text tower of HunyuanVideo in PyTorch.

Port of the Llama part of ``goal_force_tpu/models/text_encoders.py``: ``LlamaConfig``,
``llama_encode`` and ``llama_layers`` (GQA, RoPE from float64 host tables at theta 5e5,
an additive float32 mask of finfo.min, SwiGLU with its SiLU in float32; the last
``hidden_state_skip_layer`` layers skipped and no final norm). ``LlamaModel`` holds the
parameters under the HF LlamaModel names that JAX ``llama_params_from_torch`` reads
(``embed_tokens``, ``layers.{i}.{input_layernorm, self_attn.{q,k,v,o}_proj,
post_attention_layernorm, mlp.{gate,up,down}_proj}``) and the final ``norm`` the
reference file carries (unused by the skip-layer contract). BERT and Step1 wait for
their families.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from goal_force_tpu_torch.models.wan_dit import RMSNorm, empty_module, init_linear_


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """HunyuanVideo's llava-llama-3-8B text tower."""

    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    intermediate_size: int = 14336
    vocab: int = 128320
    eps: float = 1e-5
    rope_theta: float = 500000.0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        d, hd = cfg.hidden_size, cfg.head_dim
        self.q_proj = nn.Linear(d, cfg.num_heads * hd, bias=False)
        self.k_proj = nn.Linear(d, cfg.num_kv_heads * hd, bias=False)
        self.v_proj = nn.Linear(d, cfg.num_kv_heads * hd, bias=False)
        self.o_proj = nn.Linear(cfg.num_heads * hd, d, bias=False)


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        d, f = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = nn.Linear(d, f, bias=False)
        self.up_proj = nn.Linear(d, f, bias=False)
        self.down_proj = nn.Linear(f, d, bias=False)


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size)
        self.self_attn = LlamaAttention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size)
        self.mlp = LlamaMLP(cfg)


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab, cfg.hidden_size)
        self.layers = nn.ModuleList(LlamaLayer(cfg) for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size)


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with the weight applied in float32, then cast to x's dtype."""
    xf = x.float()
    return (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps) * w).to(x.dtype)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    a, b = x.chunk(2, dim=-1)
    return torch.cat([-b, a], dim=-1)


def llama_rope(cfg: LlamaConfig, s: int, device):
    """(1, S, 1, head_dim) float32 cos/sin, from float64 host tables."""
    hd = cfg.head_dim
    inv_freq = 1.0 / cfg.rope_theta ** (np.arange(0, hd, 2) / hd)
    ang = np.arange(s)[:, None] * inv_freq[None]
    cos = np.concatenate([np.cos(ang), np.cos(ang)], -1).astype(np.float32)
    sin = np.concatenate([np.sin(ang), np.sin(ang)], -1).astype(np.float32)
    return (torch.from_numpy(cos).to(device)[None, :, None],
            torch.from_numpy(sin).to(device)[None, :, None])


def llama_encode(model: LlamaModel, cfg: LlamaConfig, input_ids: torch.Tensor,
                 attention_mask: torch.Tensor, hidden_state_skip_layer: int = 2) -> torch.Tensor:
    """(B, S) ids + 0/1 mask -> hidden states with the LAST hidden_state_skip_layer
    layers skipped (no final norm)."""
    x = model.embed_tokens.weight[input_ids]
    return llama_layers(model, cfg, x, attention_mask,
                        keep=cfg.num_layers - hidden_state_skip_layer)


def llama_layers(model: LlamaModel, cfg: LlamaConfig, x: torch.Tensor,
                 attention_mask: torch.Tensor, keep: int) -> torch.Tensor:
    """The decoder stack on input embeddings x (B, S, D), stopping after `keep` layers.
    Attention: causal and over the mask's valid keys, as an additive float32 bias of
    finfo.min (a row with no valid key spreads evenly over all keys, as in JAX)."""
    b, s = x.shape[:2]
    n, nk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cos, sin = llama_rope(cfg, s, x.device)
    causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    ok = causal[None] & (attention_mask[:, None, :] > 0)
    bias = torch.zeros(ok.shape, dtype=torch.float32, device=x.device).masked_fill(
        ~ok, torch.finfo(torch.float32).min)[:, None]
    for p in model.layers[:keep]:
        h = _rms(x, p.input_layernorm.weight, cfg.eps)
        a = p.self_attn
        q = F.linear(h, a.q_proj.weight).reshape(b, s, n, hd)
        k = F.linear(h, a.k_proj.weight).reshape(b, s, nk, hd)
        v = F.linear(h, a.v_proj.weight).reshape(b, s, nk, hd)
        q = (q.float() * cos + _rotate_half(q.float()) * sin).to(x.dtype)
        k = (k.float() * cos + _rotate_half(k.float()) * sin).to(x.dtype)
        k = k.repeat_interleave(n // nk, dim=2)
        v = v.repeat_interleave(n // nk, dim=2)
        logits = torch.einsum("bqnc,bknc->bnqk", q, k) / math.sqrt(hd)
        probs = torch.softmax(logits.float() + bias, dim=-1).to(x.dtype)
        att = torch.einsum("bnqk,bknc->bqnc", probs, v).reshape(b, s, -1)
        x = x + F.linear(att, a.o_proj.weight)
        h = _rms(x, p.post_attention_layernorm.weight, cfg.eps)
        m = p.mlp
        gate = F.silu(F.linear(h, m.gate_proj.weight).float()).to(x.dtype)
        x = x + F.linear(gate * F.linear(h, m.up_proj.weight), m.down_proj.weight)
    return x


@torch.no_grad()
def init_llama(cfg: LlamaConfig, gen: torch.Generator, dtype=torch.bfloat16, *,
               device) -> LlamaModel:
    """Random weights for tests and the smoke, drawn from `gen`: N(0, 0.02**2) token
    embeddings, uniform +-1/sqrt(fan_in) linears, unit norms."""
    model = empty_module(LlamaModel, cfg, dtype=dtype, device=device)
    model.embed_tokens.weight.normal_(generator=gen).mul_(0.02)
    for m in model.modules():
        if isinstance(m, nn.Linear):
            init_linear_(m, gen)
        elif isinstance(m, RMSNorm):
            m.weight.fill_(1.0)
    return model.eval().requires_grad_(False)
