"""Nexus-Gen in PyTorch: the Qwen2.5-VL autoregressive model's heads, the editing
embedding merger and the generation adapter.

Port of ``goal_force_tpu/models/nexus_gen.py``:

  - ``NexusGenHeads``: the bias-free ``vision_head`` (hidden -> hidden), whose outputs are
    the autoregressive image embeddings, and the 81 learned ``image_prefill_embeds`` that
    stand in for the target image tokens;
  - ``nexus_gen_target_embeddings``: one teacher-forced causal forward whose last 81
    positions (the prefill table behind ``<vision_start>``) each predict the next image
    embedding; ``nexus_gen_ar_generate``: the same embeddings from a KV-cached prefill and
    80 decode steps over the table (a Python loop over ``qwen_vl_text_decode_step``). The
    two are equal: causal attention makes teacher forcing with the table the sequential
    decode;
  - ``NexusGenMerger`` / ``nexus_gen_merger_forward``: bidirectional Qwen2.5-VL decoder
    layers over the image embeddings at FRACTIONAL M-RoPE positions scaled onto the 72 x
    72 base grid (``merger_position_ids``), then the RMS / linear / RMS / SiLU / linear /
    RMS projector to the Flux text width;
  - ``NexusGenAdapter`` / ``nexus_gen_adapter_forward``: linear / LayerNorm / ReLU /
    linear / LayerNorm (3584 -> 4096), the LayerNorms in float32;
  - ``nexus_ar_image_positions`` and ``nexus_editing_rope_tables``: host numpy, the
    latter in float64 as in JAX (the editing path's Flux rope tables).

The modules hold the reference names: the merger ``layers.{i}.*`` (``QwenVLLayer``) and
``projector.{0,1,2,4,5}``, the heads ``vision_head`` and ``image_prefill_embeds``, the
adapter ``adapter.{0,1,3,4}``; ``*_from_state_dict`` load them strictly.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from goal_force_tpu_torch.models.qwen_vl import (
    QwenVLLayer,
    QwenVLTextConfig,
    QwenVLTextModel,
    mrope_tables,
    qwen_vl_text_decode_step,
    qwen_vl_text_forward,
    qwen_vl_text_prefill,
    text_layer,
)
from goal_force_tpu_torch.models.wan_dit import (
    Activation,
    LayerNormAffine,
    RMSNorm,
    empty_module,
    linear,
    rms_norm,
)


@dataclasses.dataclass(frozen=True)
class NexusGenMergerConfig:
    text: QwenVLTextConfig = QwenVLTextConfig()
    num_layers: int = 1
    out_channel: int = 4096
    expand_ratio: int = 4
    base_grid: int = 72
    spatial_merge_size: int = 2
    tokens_per_second: int = 2


class NexusGenHeads(nn.Module):
    def __init__(self, hidden: int = 3584, num_img_tokens: int = 81):
        super().__init__()
        self.vision_head = nn.Linear(hidden, hidden, bias=False)
        self.image_prefill_embeds = nn.Embedding(num_img_tokens, hidden)


class NexusGenMerger(nn.Module):
    def __init__(self, cfg: NexusGenMergerConfig):
        super().__init__()
        d, wide = cfg.text.hidden_size, cfg.out_channel * cfg.expand_ratio
        self.layers = nn.ModuleList(QwenVLLayer(cfg.text) for _ in range(cfg.num_layers))
        self.projector = nn.ModuleList([RMSNorm(d), nn.Linear(d, wide), RMSNorm(wide),
                                        Activation(), nn.Linear(wide, cfg.out_channel),
                                        RMSNorm(cfg.out_channel)])


class NexusGenAdapter(nn.Module):
    def __init__(self, input_dim: int = 3584, output_dim: int = 4096):
        super().__init__()
        self.adapter = nn.ModuleList([nn.Linear(input_dim, output_dim),
                                      LayerNormAffine(output_dim), Activation(),
                                      nn.Linear(output_dim, output_dim),
                                      LayerNormAffine(output_dim)])


# ---------------------------------------------------------------------------
# Merger and adapter
# ---------------------------------------------------------------------------

def merger_position_ids(grid_thw: Tuple[int, int, int],
                        cfg: NexusGenMergerConfig) -> np.ndarray:
    """Fractional (3, 1, S) float32 position ids scaled onto the base grid."""
    t, h, w = grid_thw
    m = cfg.spatial_merge_size
    gt, gh, gw = t, h // m, w // m
    t_idx = np.repeat(np.arange(gt) * cfg.tokens_per_second, gh * gw)
    h_idx = np.tile(np.repeat(np.arange(gh), gw), gt) * (cfg.base_grid / h)
    w_idx = np.tile(np.arange(gw), gt * gh) * (cfg.base_grid / w)
    return np.stack([t_idx, h_idx, w_idx]).astype(np.float32)[:, None, :]


def nexus_gen_merger_forward(merger: NexusGenMerger, cfg: NexusGenMergerConfig,
                             embeds: torch.Tensor, grid_thw: Tuple[int, int, int],
                             ref_embeds: Optional[torch.Tensor] = None,
                             ref_grid_thw: Optional[Tuple[int, int, int]] = None
                             ) -> torch.Tensor:
    """embeds (B, S, hidden) [+ the reference's (B, S_ref, hidden)] -> (B, S [+ S_ref],
    out_channel); every token sees every other."""
    pos = merger_position_ids(grid_thw, cfg)
    x = embeds
    if ref_embeds is not None:
        pos = np.concatenate([pos, merger_position_ids(ref_grid_thw, cfg)], axis=-1)
        x = torch.cat([embeds, ref_embeds.to(embeds.dtype)], dim=1)
    cos, sin = (t[:, :, None, :] for t in mrope_tables(
        cfg.text, torch.as_tensor(pos, device=x.device)))
    for p in merger.layers:
        x = text_layer(p, x, None, cos, sin, cfg.text)
    pj, e = merger.projector, cfg.text.eps
    x = linear(pj[1], rms_norm(x, pj[0].weight, e))
    x = F.silu(rms_norm(x, pj[2].weight, e).float()).to(x.dtype)
    return rms_norm(linear(pj[4], x), pj[5].weight, e)


def _layer_norm_f32(p: LayerNormAffine, x: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm with its affine in float32, cast back (JAX's adapter norm)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * p.weight.float() + p.bias.float()).to(x.dtype)


def nexus_gen_adapter_forward(adapter: NexusGenAdapter, x: torch.Tensor,
                              eps: float = 1e-5) -> torch.Tensor:
    a = adapter.adapter
    x = torch.relu(_layer_norm_f32(a[1], linear(a[0], x), eps))
    return _layer_norm_f32(a[4], linear(a[3], x), eps)


def nexus_gen_image_embeddings(hidden_states: torch.Tensor,
                               heads: NexusGenHeads) -> torch.Tensor:
    """The autoregressive image embeddings: vision_head(hidden)."""
    return linear(heads.vision_head, hidden_states)


# ---------------------------------------------------------------------------
# Autoregressive image embeddings
# ---------------------------------------------------------------------------

def nexus_ar_image_positions(text_len: int, grid_thw: Tuple[int, int, int] = (1, 18, 18),
                             spatial_merge_size: int = 2) -> np.ndarray:
    """(3, 1, N) int32 M-RoPE ids of the generated image tokens: the merged grid's (t, h,
    w) ids offset by the prompt length, as get_rope_index gives them."""
    t, h, w = grid_thw
    gh, gw = h // spatial_merge_size, w // spatial_merge_size
    t_idx = np.zeros(t * gh * gw, np.int64)
    h_idx = np.tile(np.repeat(np.arange(gh), gw), t)
    w_idx = np.tile(np.arange(gw), t * gh)
    return (np.stack([t_idx, h_idx, w_idx]) + text_len)[:, None, :].astype(np.int32)


def nexus_gen_target_embeddings(model: QwenVLTextModel, cfg: QwenVLTextConfig,
                                heads: NexusGenHeads, embeds: torch.Tensor,
                                position_ids: torch.Tensor,
                                num_img_tokens: int = 81) -> torch.Tensor:
    """One teacher-forced forward: the sequence ends with [<vision_start>, prefill_0 ..
    prefill_{N-1}]; each of those positions' hidden states predicts the next image
    embedding through the vision head. Returns (B, N, hidden)."""
    mask = torch.ones(embeds.shape[:2], dtype=torch.int32, device=embeds.device)
    hidden = qwen_vl_text_forward(model, cfg, embeds, mask, position_ids)
    return nexus_gen_image_embeddings(hidden[:, -num_img_tokens - 1:-1], heads)


def nexus_gen_ar_generate(model: QwenVLTextModel, cfg: QwenVLTextConfig,
                          heads: NexusGenHeads, prompt_embeds: torch.Tensor,
                          prompt_position_ids: torch.Tensor,
                          grid_thw: Tuple[int, int, int] = (1, 18, 18),
                          spatial_merge_size: int = 2) -> torch.Tensor:
    """The (B, N, hidden) image embeddings, N = prod(grid) / merge²: the prompt (ending
    with <vision_start>) is prefilled and its last hidden state gives embedding 0; step i
    feeds the LEARNED prefill entry i (not the model's prediction) at image position i
    and its vision-head output is embedding i + 1."""
    b, p_len, hidden = prompt_embeds.shape
    t, h, w = grid_thw
    n_img = t * (h // spatial_merge_size) * (w // spatial_merge_size)
    last_h, kc, vc = qwen_vl_text_prefill(model, cfg, prompt_embeds, prompt_position_ids,
                                          p_len + n_img)
    embs = [nexus_gen_image_embeddings(last_h[:, -1:], heads)]
    img_pos = nexus_ar_image_positions(p_len, grid_thw, spatial_merge_size)
    cos, sin = mrope_tables(cfg, torch.as_tensor(img_pos, device=prompt_embeds.device))
    table = heads.image_prefill_embeds.weight
    for i in range(n_img - 1):
        emb = table[i].to(prompt_embeds.dtype).expand(b, 1, hidden)
        hh, kc, vc = qwen_vl_text_decode_step(model, cfg, emb, cos[:, i:i + 1],
                                              sin[:, i:i + 1], kc, vc, p_len + i)
        embs.append(nexus_gen_image_embeddings(hh, heads))
    return torch.cat(embs, dim=1)


# ---------------------------------------------------------------------------
# Editing rope tables
# ---------------------------------------------------------------------------

def nexus_editing_rope_tables(latent_gh: int, latent_gw: int, target_hw, ref_hw, axes_dim,
                              theta: float = 1e4):
    """Flux rope tables of the editing path, host float64 cast to float32: the text
    positions carry SPATIAL ids (the target embeddings' grid scaled onto the latent grid
    with axis-0 id 0, the reference's with axis-0 id 1), then the image's usual (0, row,
    col) ids. Returns (cos, sin) for ``rope_tables_override``."""
    th, tw = target_hw
    rh, rw = ref_hw

    def grid_ids(gh, gw, axis0, sh, sw):
        ids = np.zeros((gh * gw, 3), np.float64)
        ids[:, 0] = axis0
        ids[:, 1] = np.repeat(np.arange(gh) * sh, gw)
        ids[:, 2] = np.tile(np.arange(gw) * sw, gh)
        return ids

    # the embeddings are 2x2-merged as the latents are patchified (grid = hw // 2)
    tgt = grid_ids(th // 2, tw // 2, 0.0, (2 * latent_gh) / th, (2 * latent_gw) / tw)
    ref = grid_ids(rh // 2, rw // 2, 1.0, (2 * latent_gh) / rh, (2 * latent_gw) / rw)
    img = grid_ids(latent_gh, latent_gw, 0.0, 1.0, 1.0)
    ids = np.concatenate([tgt, ref, img], axis=0)
    parts_cos, parts_sin = [], []
    for i, d in enumerate(axes_dim):
        omega = 1.0 / theta ** (np.arange(0, d, 2, dtype=np.float64) / d)
        ang = np.outer(ids[:, i], omega)
        parts_cos.append(np.cos(ang))
        parts_sin.append(np.sin(ang))
    return (np.concatenate(parts_cos, -1).astype(np.float32),
            np.concatenate(parts_sin, -1).astype(np.float32))


# ---------------------------------------------------------------------------
# Loaders and init
# ---------------------------------------------------------------------------

def _load(cls, arg, sd, what: str, dtype, device) -> nn.Module:
    from goal_force_tpu_torch.io.auto import _strict
    from goal_force_tpu_torch.pipelines.goal_force import resolve_device

    return _strict(cls, arg, {k: torch.as_tensor(v) for k, v in sd.items()}, what, dtype,
                   resolve_device(device))


def nexus_gen_heads_from_state_dict(sd, dtype=torch.float32, device="cuda") -> NexusGenHeads:
    """``vision_head`` and ``image_prefill_embeds`` from a state dict that may hold more
    (the whole AR file)."""
    n, hidden = sd["image_prefill_embeds.weight"].shape
    part = {k: sd[k] for k in ("vision_head.weight", "image_prefill_embeds.weight")}
    return _load(functools.partial(NexusGenHeads, num_img_tokens=n), hidden, part,
                 "nexus_gen heads", dtype, device)


def nexus_gen_adapter_from_state_dict(sd, dtype=torch.float32,
                                      device="cuda") -> NexusGenAdapter:
    """``adapter.{0,1,3,4}`` from a state dict that may hold more."""
    d_out, d_in = sd["adapter.0.weight"].shape
    part = {k: v for k, v in sd.items() if k.startswith("adapter.")}
    return _load(functools.partial(NexusGenAdapter, output_dim=d_out), d_in, part,
                 "nexus_gen adapter", dtype, device)


def nexus_gen_merger_from_state_dict(sd, cfg: NexusGenMergerConfig, dtype=torch.float32,
                                     device="cuda") -> NexusGenMerger:
    return _load(NexusGenMerger, cfg, sd, "nexus_gen merger", dtype, device)


@torch.no_grad()
def _init_(model: nn.Module, gen: torch.Generator, std: float) -> nn.Module:
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Embedding)):
            mod.weight.normal_(generator=gen).mul_(std)
            if getattr(mod, "bias", None) is not None:
                mod.bias.zero_()
        elif isinstance(mod, (RMSNorm, LayerNormAffine)):
            mod.weight.fill_(1.0)
            if isinstance(mod, LayerNormAffine):
                mod.bias.zero_()
    return model.eval().requires_grad_(False)


def init_nexus_gen_heads(hidden: int, num_img_tokens: int, gen: torch.Generator,
                         dtype=torch.bfloat16, *, device) -> NexusGenHeads:
    """Random heads: N(0, 0.05²) vision head and prefill table (JAX's tiny pipeline)."""
    return _init_(empty_module(NexusGenHeads, hidden, num_img_tokens, dtype=dtype,
                               device=device), gen, 0.05)


def init_nexus_gen_adapter(input_dim: int, output_dim: int, gen: torch.Generator,
                           dtype=torch.bfloat16, *, device) -> NexusGenAdapter:
    """Random adapter: N(0, 0.05²) linears, zero biases, unit LayerNorms (JAX's tiny
    pipeline)."""
    return _init_(empty_module(NexusGenAdapter, input_dim, output_dim, dtype=dtype,
                               device=device), gen, 0.05)


def init_nexus_gen_merger(cfg: NexusGenMergerConfig, gen: torch.Generator,
                          dtype=torch.bfloat16, *, device) -> NexusGenMerger:
    """Random merger: N(0, 0.02²) linears, zero biases, unit norms."""
    return _init_(empty_module(NexusGenMerger, cfg, dtype=dtype, device=device), gen, 0.02)
