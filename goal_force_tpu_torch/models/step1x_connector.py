"""Step1X's Qwen2Connector: the token refiner between Qwen2.5-VL states and Flux.

Port of ``goal_force_tpu/models/step1x_connector.py``: the masked mean of the LLM states,
scaled by (1 + scale_factor), through a 768-wide projection gives the pooled embedding;
the refiner embeds the tokens, builds its conditioning from the cos-first sinusoid of
t (the pipeline passes timestep / 1000) and the masked mean, and runs ``depth`` blocks
of LayerNorm, a biased fused qkv under a padding-pair mask (column 0 always visible, so
no row is empty), gated (zero-initialised adaLN) attention and SiLU MLP residuals. The
attention is small and runs inline, as JAX runs it in XLA.

``Step1xConnector`` holds the parameters under the reference names:
``S.input_embedder``, ``S.t_embedder.mlp.{0,2}``, ``S.c_embedder.linear_{1,2}``,
``S.individual_token_refiner.blocks.{i}.{norm1, self_attn_qkv, self_attn_proj, norm2,
mlp.fc1, mlp.fc2, adaLN_modulation.1}``, ``global_proj_out`` and ``scale_factor``.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from goal_force_tpu_torch.models.clip import _ln
from goal_force_tpu_torch.models.sd_unet import linear
from goal_force_tpu_torch.models.wan_dit import (
    Activation,
    LayerNormAffine,
    empty_module,
    sinusoidal_embedding,
)


@dataclasses.dataclass(frozen=True)
class Step1xConnectorConfig:
    in_channels: int = 3584
    hidden_size: int = 4096
    heads_num: int = 32
    depth: int = 2
    mlp_ratio: float = 4.0
    eps: float = 1e-6


class _MLP(nn.Module):
    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(d, hidden)
        self.fc2 = nn.Linear(hidden, d)


class RefinerBlock(nn.Module):
    def __init__(self, cfg: Step1xConnectorConfig):
        super().__init__()
        d = cfg.hidden_size
        self.norm1 = LayerNormAffine(d)
        self.self_attn_qkv = nn.Linear(d, 3 * d)
        self.self_attn_proj = nn.Linear(d, d)
        self.norm2 = LayerNormAffine(d)
        self.mlp = _MLP(d, int(d * cfg.mlp_ratio))
        self.adaLN_modulation = nn.ModuleList([Activation(), nn.Linear(d, 2 * d)])


class _TEmbedder(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.mlp = nn.ModuleList([nn.Linear(256, d), Activation(), nn.Linear(d, d)])


class _CEmbedder(nn.Module):
    def __init__(self, d_in: int, d: int):
        super().__init__()
        self.linear_1 = nn.Linear(d_in, d)
        self.linear_2 = nn.Linear(d, d)


class _Refiner(nn.Module):
    def __init__(self, cfg: Step1xConnectorConfig):
        super().__init__()
        self.blocks = nn.ModuleList(RefinerBlock(cfg) for _ in range(cfg.depth))


class SingleTokenRefiner(nn.Module):
    def __init__(self, cfg: Step1xConnectorConfig):
        super().__init__()
        d = cfg.hidden_size
        self.input_embedder = nn.Linear(cfg.in_channels, d)
        self.t_embedder = _TEmbedder(d)
        self.c_embedder = _CEmbedder(cfg.in_channels, d)
        self.individual_token_refiner = _Refiner(cfg)


class Step1xConnector(nn.Module):
    def __init__(self, cfg: Step1xConnectorConfig):
        super().__init__()
        self.S = SingleTokenRefiner(cfg)
        self.global_proj_out = nn.Linear(cfg.in_channels, 768)
        self.scale_factor = nn.Parameter(torch.zeros(1))


def _mlp2(fc0: nn.Linear, fc2: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return linear(fc2, F.silu(linear(fc0, x).float()).to(x.dtype))


def _refiner_block(p: RefinerBlock, x, c, mask_bias, cfg: Step1xConnectorConfig):
    b, s, d = x.shape
    n = cfg.heads_num
    e = linear(p.adaLN_modulation[1], F.silu(c.float()).to(c.dtype))
    gate_msa, gate_mlp = e.chunk(2, dim=-1)
    h = _ln(p.norm1, x, cfg.eps)
    q, k, v = (a.reshape(b, s, n, d // n) for a in linear(p.self_attn_qkv, h).chunk(3, dim=-1))
    logits = torch.einsum("bqnc,bknc->bnqk", q, k) / math.sqrt(d // n)
    probs = torch.softmax(logits.float() + mask_bias, -1).to(x.dtype)
    att = torch.einsum("bnqk,bknc->bqnc", probs, v).reshape(b, s, d)
    x = x + linear(p.self_attn_proj, att) * gate_msa[:, None]
    h = _ln(p.norm2, x, cfg.eps)
    h = linear(p.mlp.fc2, F.silu(linear(p.mlp.fc1, h).float()).to(x.dtype))
    return x + h * gate_mlp[:, None]


def step1x_connector_forward(model: Step1xConnector, cfg: Step1xConnectorConfig,
                             x: torch.Tensor, t: torch.Tensor, mask: torch.Tensor):
    """x (B, S, in), t (B,), mask (B, S) of 0/1 -> (refined (B, S, hidden), pooled
    (B, 768))."""
    r = model.S
    mf = mask.to(x.dtype)[..., None]
    x_mean = (x * mf).sum(1) / mf.sum(1)
    glob = linear(model.global_proj_out, x_mean * (1.0 + model.scale_factor.to(x.dtype)))
    temb = sinusoidal_embedding(256, t).to(x.dtype)
    c = (_mlp2(r.t_embedder.mlp[0], r.t_embedder.mlp[2], temb)
         + _mlp2(r.c_embedder.linear_1, r.c_embedder.linear_2, x_mean))
    h = linear(r.input_embedder, x)
    pair = (mask[:, None, :] > 0) & (mask[:, :, None] > 0)
    pair[:, :, 0] = True
    mask_bias = torch.where(pair[:, None], 0.0, torch.finfo(torch.float32).min)
    for blk in r.individual_token_refiner.blocks:
        h = _refiner_block(blk, h, c, mask_bias, cfg)
    return h, glob


@torch.no_grad()
def init_step1x_connector(cfg: Step1xConnectorConfig, gen: torch.Generator,
                          dtype=torch.float32, *, device) -> Step1xConnector:
    """Random weights from `gen` with JAX ``init_step1x_connector``'s distributions:
    linears N(0, 0.02²) with zero biases, the adaLN modulations at zero, unit norms,
    scale_factor -0.91."""
    model = empty_module(Step1xConnector, cfg, dtype=dtype, device=device)
    for m in model.modules():
        if isinstance(m, nn.Linear):
            m.weight.normal_(generator=gen).mul_(0.02)
            m.bias.zero_()
        elif isinstance(m, LayerNormAffine):
            m.weight.fill_(1.0)
            m.bias.zero_()
    for blk in model.S.individual_token_refiner.blocks:
        blk.adaLN_modulation[1].weight.zero_()
    model.scale_factor.fill_(-(1.0 - 0.09))
    return model.eval().requires_grad_(False)
