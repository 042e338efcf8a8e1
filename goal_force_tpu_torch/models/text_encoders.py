"""The auxiliary text towers in PyTorch: HunyuanVideo's Llama, HunyuanDiT's CLIP (a BERT)
and StepVideo's Step-1 LLM.

Port of ``goal_force_tpu/models/text_encoders.py``. The Llama part: ``LlamaConfig``,
``llama_encode`` and ``llama_layers`` (GQA, RoPE from float64 host tables at theta 5e5,
an additive float32 mask of finfo.min, SwiGLU with its SiLU in float32; the last
``hidden_state_skip_layer`` layers skipped and no final norm). ``LlamaModel`` holds the
parameters under the HF LlamaModel names that JAX ``llama_params_from_torch`` reads
(``embed_tokens``, ``layers.{i}.{input_layernorm, self_attn.{q,k,v,o}_proj,
post_attention_layernorm, mlp.{gate,up,down}_proj}``) and the final ``norm`` the
reference file carries (unused by the skip-layer contract).

BERT (``BertConfig``, ``BertModel`` under HF's ``BertModel`` names, ``bert_encode``):
post-LN layers, absolute positions, token type 0, exact-erf GELU, the padding mask as an
additive float32 bias of finfo.min, and ``clip_skip`` stopping ``clip_skip - 1`` layers
early. Step-1 (``Step1Config``, ``Step1Model`` under the reference keys, ``step1_encode``):
pre-RMSNorm layers with a fused ``wqkv`` split as ``[n*hd | g*2*hd]`` (each group's kv as
``[k | v]``, the groups expanded by ``repeat_interleave``), attention bidirectional with no
mask, no rotary embedding and no final norm, and a fused SwiGLU whose ``w1`` output splits
as ``[a | gate]`` into ``silu(a) * gate``. Both towers compute their attention in
``ops/attention.py::plain_attention`` (head_dim 64 and 128 at 77 and 320 tokens), as JAX
computes it inline in XLA.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from goal_force_tpu_torch.models.clip import _ln
from goal_force_tpu_torch.models.wan_dit import (
    LayerNormAffine,
    RMSNorm,
    empty_module,
    init_linear_,
)
from goal_force_tpu_torch.ops.attention import plain_attention


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


# ---------------------------------------------------------------------------
# BERT (HunyuanDiT's CLIP tower)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BertConfig:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    vocab: int = 47020
    max_positions: int = 512
    type_vocab: int = 2
    eps: float = 1e-12


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_positions, cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab, cfg.hidden_size)
        self.LayerNorm = LayerNormAffine(cfg.hidden_size)


class BertSelfAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(d, d)
        self.value = nn.Linear(d, d)


class BertDenseNorm(nn.Module):
    """HF's BertSelfOutput / BertOutput: a dense layer and the post-residual LayerNorm."""

    def __init__(self, d_in: int, d: int):
        super().__init__()
        self.dense = nn.Linear(d_in, d)
        self.LayerNorm = LayerNormAffine(d)


class BertAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.self = BertSelfAttention(d)
        self.output = BertDenseNorm(d, d)


class BertIntermediate(nn.Module):
    def __init__(self, d: int, f: int):
        super().__init__()
        self.dense = nn.Linear(d, f)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        d, f = cfg.hidden_size, cfg.intermediate_size
        self.attention = BertAttention(d)
        self.intermediate = BertIntermediate(d, f)
        self.output = BertDenseNorm(f, d)


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg) for _ in range(cfg.num_layers))


class BertModel(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = BertEncoder(cfg)


# HF BertModel keys that the tower's contract never reads (the position-id buffer and the
# pooler); a checkpoint may carry them, the loader drops them
BERT_UNUSED = ("embeddings.position_ids", "pooler.")


def bert_encode(model: BertModel, cfg: BertConfig, input_ids: torch.Tensor,
                attention_mask: torch.Tensor, clip_skip: int = 1) -> torch.Tensor:
    """(B, S) ids + 0/1 mask -> the hidden states of layer -clip_skip (B, S, H): the stack
    stops clip_skip - 1 layers early."""
    b, s = input_ids.shape
    e = model.embeddings
    x = (e.word_embeddings.weight[input_ids] + e.position_embeddings.weight[:s][None]
         + e.token_type_embeddings.weight[0][None, None])
    x = _ln(e.LayerNorm, x, cfg.eps)
    bias = torch.zeros(attention_mask.shape, dtype=torch.float32, device=x.device).masked_fill(
        attention_mask <= 0, torch.finfo(torch.float32).min)[:, None, None, :]
    n, hd = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    for p in model.encoder.layer[:cfg.num_layers - (clip_skip - 1)]:
        a = p.attention.self
        q, k, v = (F.linear(x, m.weight, m.bias).reshape(b, s, n, hd)
                   for m in (a.query, a.key, a.value))
        att = plain_attention(q, k, v, 1.0 / math.sqrt(hd), bias).reshape(b, s, -1)
        o = p.attention.output
        x = _ln(o.LayerNorm, x + F.linear(att, o.dense.weight, o.dense.bias), cfg.eps)
        h = F.linear(x, p.intermediate.dense.weight, p.intermediate.dense.bias)
        h = F.gelu(h.float()).to(x.dtype)
        o = p.output
        x = _ln(o.LayerNorm, x + F.linear(h, o.dense.weight, o.dense.bias), cfg.eps)
    return x


@torch.no_grad()
def init_bert(cfg: BertConfig, gen: torch.Generator, dtype=torch.float32, *,
              device) -> BertModel:
    """Random weights for tests and the smoke, drawn from `gen`: N(0, 0.02**2)
    embeddings, uniform +-1/sqrt(fan_in) linears with zero biases, unit LayerNorms."""
    model = empty_module(BertModel, cfg, dtype=dtype, device=device)
    for m in model.modules():
        if isinstance(m, nn.Embedding):
            m.weight.normal_(generator=gen).mul_(0.02)
        elif isinstance(m, nn.Linear):
            init_linear_(m, gen)
        elif isinstance(m, LayerNormAffine):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return model.eval().requires_grad_(False)


# ---------------------------------------------------------------------------
# Step-1 (StepVideo's LLM tower)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Step1Config:
    hidden_size: int = 6144
    num_layers: int = 48
    num_heads: int = 48
    num_groups: int = 8
    ffn_hidden_size: int = 16384
    vocab: int = 65536
    eps: float = 1e-5
    multiple_of: int = 256

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def ff_dim(self) -> int:
        m = self.multiple_of
        return m * ((self.ffn_hidden_size + m - 1) // m)


class Step1Embeddings(nn.Module):
    def __init__(self, cfg: Step1Config):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab, cfg.hidden_size)


class Step1Attention(nn.Module):
    def __init__(self, cfg: Step1Config):
        super().__init__()
        d, hd = cfg.hidden_size, cfg.head_dim
        self.wqkv = nn.Linear(d, (cfg.num_heads + 2 * cfg.num_groups) * hd, bias=False)
        self.wo = nn.Linear(cfg.num_heads * hd, d, bias=False)


class Step1FeedForward(nn.Module):
    def __init__(self, cfg: Step1Config):
        super().__init__()
        self.w1 = nn.Linear(cfg.hidden_size, 2 * cfg.ff_dim, bias=False)
        self.w2 = nn.Linear(cfg.ff_dim, cfg.hidden_size, bias=False)


class Step1Layer(nn.Module):
    def __init__(self, cfg: Step1Config):
        super().__init__()
        self.attention_norm = RMSNorm(cfg.hidden_size)
        self.attention = Step1Attention(cfg)
        self.ffn_norm = RMSNorm(cfg.hidden_size)
        self.feed_forward = Step1FeedForward(cfg)


class Step1Transformer(nn.Module):
    def __init__(self, cfg: Step1Config):
        super().__init__()
        self.layers = nn.ModuleList(Step1Layer(cfg) for _ in range(cfg.num_layers))


class Step1Model(nn.Module):
    def __init__(self, cfg: Step1Config):
        super().__init__()
        self.tok_embeddings = Step1Embeddings(cfg)
        self.transformer = Step1Transformer(cfg)


def step1_encode(model: Step1Model, cfg: Step1Config, input_ids: torch.Tensor) -> torch.Tensor:
    """(B, S) ids -> (B, S, H) hidden states. Attention is bidirectional over every token
    (the caller's padding is not masked), with no rotary embedding and no final norm."""
    b, s = input_ids.shape
    n, g, hd = cfg.num_heads, cfg.num_groups, cfg.head_dim
    x = model.tok_embeddings.word_embeddings.weight[input_ids]
    for p in model.transformer.layers:
        h = _rms(x, p.attention_norm.weight, cfg.eps)
        qkv = F.linear(h, p.attention.wqkv.weight)
        q = qkv[..., :n * hd].reshape(b, s, n, hd)
        k, v = qkv[..., n * hd:].reshape(b, s, g, 2 * hd).split(hd, dim=-1)
        k = k.repeat_interleave(n // g, dim=2)
        v = v.repeat_interleave(n // g, dim=2)
        att = plain_attention(q, k, v, 1.0 / math.sqrt(hd)).reshape(b, s, n * hd)
        x = x + F.linear(att, p.attention.wo.weight)
        h = _rms(x, p.ffn_norm.weight, cfg.eps)
        a, gate = F.linear(h, p.feed_forward.w1.weight).chunk(2, dim=-1)
        x = x + F.linear(F.silu(a.float()).to(x.dtype) * gate, p.feed_forward.w2.weight)
    return x


@torch.no_grad()
def init_step1(cfg: Step1Config, gen: torch.Generator, dtype=torch.bfloat16, *,
               device) -> Step1Model:
    """Random weights for tests and the smoke, drawn from `gen`: N(0, 0.02**2) token
    embeddings, uniform +-1/sqrt(fan_in) linears, unit norms."""
    model = empty_module(Step1Model, cfg, dtype=dtype, device=device)
    model.tok_embeddings.word_embeddings.weight.normal_(generator=gen).mul_(0.02)
    for m in model.modules():
        if isinstance(m, nn.Linear):
            init_linear_(m, gen)
        elif isinstance(m, RMSNorm):
            m.weight.fill_(1.0)
    return model.eval().requires_grad_(False)
