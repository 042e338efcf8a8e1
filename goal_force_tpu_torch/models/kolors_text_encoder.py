"""ChatGLM3-6B, Kolors' text encoder.

Port of ``goal_force_tpu/models/kolors_text_encoder.py``: RMSNorm blocks (float32
statistics), grouped-query attention (32 heads over 2 K/V groups, one fused and biased
``query_key_value``), CAUSAL attention (the hidden keys at float32's lowest finite
logit), a partial rotary embedding (interleaved pairs on the first ``kv_channels // 2``
dims of each head, the rest passed through, the angles built on the host in float64 over
``kv_channels // 2`` dims), and a SwiGLU MLP with the SiLU in float32.

``chatglm_encode`` returns Kolors' two embeddings: ``hidden_states[-clip_skip]`` (the
input of layer n - clip_skip + 1) as the prompt embedding, and the LAST token of the
output BEFORE the final RMSNorm as the pooled embedding; the final norm feeds only the
LM head, which the encoder never runs.

``ChatGLMModel`` keeps the reference names (``embedding.word_embeddings``,
``encoder.layers.{i}.{input_layernorm,self_attention.query_key_value,self_attention.dense,
post_attention_layernorm,mlp.dense_h_to_4h,mlp.dense_4h_to_h}``,
``encoder.final_layernorm``); ``chatglm_state_dict`` drops an HF file's ``transformer.``
prefix, its ``rotary_pos_emb.inv_freq`` buffer and its ``output_layer`` (the LM head),
which JAX's converter never reads, so the rest loads strictly. The attention runs
``ops/attention.py::plain_attention`` (float32 logits; JAX takes them in the input's
dtype before its float32 softmax: in float32 the two agree).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from goal_force_tpu_torch.models.sd_unet import linear
from goal_force_tpu_torch.models.wan_dit import RMSNorm, empty_module
from goal_force_tpu_torch.ops.attention import plain_attention


@dataclasses.dataclass(frozen=True)
class ChatGLMConfig:
    """ChatGLM3-6B text-encoder geometry."""

    hidden_size: int = 4096
    ffn_hidden_size: int = 13696
    num_layers: int = 28
    num_heads: int = 32
    kv_channels: int = 128
    kv_groups: int = 2
    vocab: int = 65024
    eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.kv_channels

    @property
    def rot_dim(self) -> int:
        # RotaryEmbedding(rotary_dim // 2): angles over kv_channels/2 dims, applied to
        # the first kv_channels/2 * 2 dims of each head
        return (self.kv_channels // 2) // 2 * 2


class ChatGLMAttention(nn.Module):
    def __init__(self, cfg: ChatGLMConfig):
        super().__init__()
        n, g, hd = cfg.num_heads, cfg.kv_groups, cfg.head_dim
        self.query_key_value = nn.Linear(cfg.hidden_size, (n + 2 * g) * hd)
        self.dense = nn.Linear(n * hd, cfg.hidden_size, bias=False)


class ChatGLMMLP(nn.Module):
    def __init__(self, cfg: ChatGLMConfig):
        super().__init__()
        self.dense_h_to_4h = nn.Linear(cfg.hidden_size, 2 * cfg.ffn_hidden_size, bias=False)
        self.dense_4h_to_h = nn.Linear(cfg.ffn_hidden_size, cfg.hidden_size, bias=False)


class ChatGLMLayer(nn.Module):
    def __init__(self, cfg: ChatGLMConfig):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size)
        self.self_attention = ChatGLMAttention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size)
        self.mlp = ChatGLMMLP(cfg)


class ChatGLMEmbedding(nn.Module):
    def __init__(self, cfg: ChatGLMConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab, cfg.hidden_size)


class ChatGLMEncoder(nn.Module):
    def __init__(self, cfg: ChatGLMConfig):
        super().__init__()
        self.layers = nn.ModuleList(ChatGLMLayer(cfg) for _ in range(cfg.num_layers))
        self.final_layernorm = RMSNorm(cfg.hidden_size)


class ChatGLMModel(nn.Module):
    def __init__(self, cfg: ChatGLMConfig):
        super().__init__()
        self.embedding = ChatGLMEmbedding(cfg)
        self.encoder = ChatGLMEncoder(cfg)


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    n = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (n * w).to(x.dtype)


@lru_cache(maxsize=8)
def _glm_rope(seq_len: int, n_elem: int) -> Tuple[np.ndarray, np.ndarray]:
    """(S, n_elem // 2) float32 cos and sin of float64 host angles."""
    theta = 1.0 / (10000.0 ** (np.arange(0, n_elem, 2, dtype=np.float64) / n_elem))
    ang = np.outer(np.arange(seq_len, dtype=np.float64), theta)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _apply_glm_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Interleaved-pair rotation of the first 2 x cos.shape[-1] dims of x (B, S, N, H) in
    float32; the rest passes through."""
    rot = cos.shape[-1] * 2
    b, s, n, _ = x.shape
    xf = x[..., :rot].float().reshape(b, s, n, -1, 2)
    c, si = cos[None, :, None, :], sin[None, :, None, :]
    out = torch.stack([xf[..., 0] * c - xf[..., 1] * si, xf[..., 1] * c + xf[..., 0] * si], -1)
    return torch.cat([out.reshape(b, s, n, rot).to(x.dtype), x[..., rot:]], dim=-1)


def _glm_block(p: ChatGLMLayer, x: torch.Tensor, cos, sin, causal_bias,
               cfg: ChatGLMConfig) -> torch.Tensor:
    b, s, _ = x.shape
    n, g, hd = cfg.num_heads, cfg.kv_groups, cfg.head_dim
    qkv = linear(p.self_attention.query_key_value, _rms(x, p.input_layernorm.weight, cfg.eps))
    q, k, v = qkv.split([n * hd, g * hd, g * hd], dim=-1)
    q = _apply_glm_rope(q.reshape(b, s, n, hd), cos, sin)
    k = _apply_glm_rope(k.reshape(b, s, g, hd), cos, sin)
    k = k.repeat_interleave(n // g, dim=2)
    v = v.reshape(b, s, g, hd).repeat_interleave(n // g, dim=2)
    att = plain_attention(q, k, v, hd ** -0.5, causal_bias).reshape(b, s, n * hd)
    x = x + linear(p.self_attention.dense, att)
    up = linear(p.mlp.dense_h_to_4h, _rms(x, p.post_attention_layernorm.weight, cfg.eps))
    a, gate = up.chunk(2, dim=-1)
    return x + linear(p.mlp.dense_4h_to_h, F.silu(a.float()).to(x.dtype) * gate)


def chatglm_encode(model: ChatGLMModel, cfg: ChatGLMConfig, ids: torch.Tensor,
                   clip_skip: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
    """ids (B, L) -> (prompt_emb (B, L, H) = hidden_states[-clip_skip], pooled (B, H) =
    the last token of the pre-final-norm output)."""
    x = model.embedding.word_embeddings.weight[ids]
    s = ids.shape[1]
    cos, sin = (torch.from_numpy(a).to(x.device) for a in _glm_rope(s, cfg.kv_channels // 2))
    keep = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    causal_bias = torch.where(keep, 0.0, torch.finfo(torch.float32).min)[None, None]
    states = [x]
    for p in model.encoder.layers:
        x = _glm_block(p, x, cos, sin, causal_bias, cfg)
        states.append(x)
    return states[-clip_skip], states[-1][:, -1]


UNUSED_KEYS = ("rotary_pos_emb.inv_freq", "output_layer.weight")


def chatglm_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A ChatGLM file's keys without the HF ``transformer.`` prefix, the rotary buffer and
    the LM head (the encoder reads neither)."""
    pre = "transformer." if any(k.startswith("transformer.embedding.") for k in sd) else ""
    out = {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}
    return {k: v for k, v in out.items() if k not in UNUSED_KEYS}


@torch.no_grad()
def init_chatglm(cfg: ChatGLMConfig, gen: torch.Generator, dtype=torch.float32, *,
                 device) -> ChatGLMModel:
    """Random weights with JAX ``init_chatglm``'s distributions: every matrix (the word
    embeddings too) N(0, 0.02²), a zero qkv bias, unit norms."""
    model = empty_module(ChatGLMModel, cfg, dtype=dtype, device=device)
    for name, p in model.named_parameters():
        if name.endswith("layernorm.weight"):
            p.fill_(1.0)
        elif name.endswith(".bias"):
            p.zero_()
        else:
            p.normal_(generator=gen).mul_(0.02)
    return model.eval().requires_grad_(False)
