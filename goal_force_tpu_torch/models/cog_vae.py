"""CogVideoX 3D VAE in PyTorch.

Port of ``goal_force_tpu/models/cog_vae.py``: the causal conv3d (its time padding
repeats the first frame, its spatial padding is zeros), the time-compressing
downsample (an odd sequence keeps frame 0 and averages the rest in pairs, then a
stride-2 spatial conv padded right and bottom), the upsample (an odd sequence upsamples
frame 0 spatially only and the rest x2 in (t, h, w), then a spatial conv), the spatial
norm (a GroupNorm modulated by 1x1x1 convs of the latents resized to the features, the
odd first frame resized apart), the ResNet blocks, the decoder and encoder plans
(``cog_decoder_plan``, ``cog_encoder_plan``; scaling 0.7, 16 latent channels; the
encoder's 32 output channels hold mean and logvar, the mean is kept) and their
spatially tiled forms (``models/tiler.py::tiled_forward_2d_to_3d``).

The public functions take and return channels-last (B, T, H, W, C) tensors, as JAX's;
inside, activations are channels-first (B, C, T, H, W). As in JAX, a conv runs in its
input's dtype (the weights cast to it): bf16 latents decode in bf16, a float32 video
encodes in float32. Nearest resizes index as ``jax.image.resize`` does, floor((i + 0.5)
· in / out).

``CogVAEDecoder`` and ``CogVAEEncoder`` hold the parameters under the reference
("diffsynth") names that JAX ``cog_vae_{decoder,encoder}_params_from_torch`` read:
``conv_in``, ``blocks.{i}.{norm1, conv1, norm2, conv2, conv_shortcut}`` (the decoder's
norms as ``{norm_layer, conv_y, conv_b}``) or ``blocks.{i}.conv`` for a resample,
``norm_out`` and ``conv_out``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from goal_force_tpu_torch.models.hunyuan_video_vae import _group_norm, _to_cf, _to_cl
from goal_force_tpu_torch.models.wan_dit import LayerNormAffine, empty_module


@dataclasses.dataclass(frozen=True)
class CogVAEConfig:
    """The channel ladder of the 4-level CogVideoX VAE."""

    channels: Tuple[int, ...] = (128, 256, 256, 512)
    latent_dim: int = 16
    scaling: float = 0.7
    groups: int = 32
    eps: float = 1e-6


def tiny_cog_vae_config():
    return CogVAEConfig(channels=(8, 8, 16, 16), latent_dim=4, groups=4)


def cog_decoder_plan(cfg: CogVAEConfig):
    c0, c1, c2, c3 = cfg.channels
    return ([("res", c3, c3)] * 6 + [("up", c3, True)]
            + [("res", c3, c2)] + [("res", c2, c2)] * 3 + [("up", c2, True)]
            + [("res", c2, c2)] * 4 + [("up", c2, False)]
            + [("res", c2, c0)] + [("res", c0, c0)] * 3)


def cog_encoder_plan(cfg: CogVAEConfig):
    c0, c1, c2, c3 = cfg.channels
    return ([("res", c0, c0)] * 3 + [("down", c0, True)]
            + [("res", c0, c1)] + [("res", c1, c1)] * 2 + [("down", c1, True)]
            + [("res", c1, c2)] + [("res", c2, c2)] * 2 + [("down", c2, False)]
            + [("res", c2, c3)] + [("res", c3, c3)] * 4)


# ---------------------------------------------------------------------------
# Modules (parameter holders under the reference names)
# ---------------------------------------------------------------------------

class SpatialNorm(nn.Module):
    def __init__(self, c: int, zq: int):
        super().__init__()
        self.norm_layer = LayerNormAffine(c)
        self.conv_y = nn.Conv3d(zq, c, 1)
        self.conv_b = nn.Conv3d(zq, c, 1)


class CogResnet(nn.Module):
    """zq: the latent channels of the decoder's spatial norms; None for GroupNorms."""

    def __init__(self, ci: int, co: int, zq=None):
        super().__init__()
        norm = (lambda c: SpatialNorm(c, zq)) if zq else LayerNormAffine
        self.norm1 = norm(ci)
        self.conv1 = nn.Conv3d(ci, co, 3)
        self.norm2 = norm(co)
        self.conv2 = nn.Conv3d(co, co, 3)
        if ci != co:
            self.conv_shortcut = nn.Conv3d(ci, co, 1)


class CogResample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3)


def _plan_modules(plan, zq):
    return nn.ModuleList(CogResnet(s[1], s[2], zq) if s[0] == "res" else CogResample(s[1])
                         for s in plan)


class CogVAEDecoder(nn.Module):
    def __init__(self, cfg: CogVAEConfig):
        super().__init__()
        c0, z = cfg.channels[0], cfg.latent_dim
        self.conv_in = nn.Conv3d(z, cfg.channels[-1], 3)
        self.blocks = _plan_modules(cog_decoder_plan(cfg), z)
        self.norm_out = SpatialNorm(c0, z)
        self.conv_out = nn.Conv3d(c0, 3, 3)


class CogVAEEncoder(nn.Module):
    def __init__(self, cfg: CogVAEConfig):
        super().__init__()
        c3 = cfg.channels[-1]
        self.conv_in = nn.Conv3d(3, cfg.channels[0], 3)
        self.blocks = _plan_modules(cog_encoder_plan(cfg), None)
        self.norm_out = LayerNormAffine(c3)
        self.conv_out = nn.Conv3d(c3, 2 * cfg.latent_dim, 3)


# ---------------------------------------------------------------------------
# Primitives (channels-first inside)
# ---------------------------------------------------------------------------

def _conv3d(conv: nn.Conv3d, x: torch.Tensor) -> torch.Tensor:
    """The causal conv: kt - 1 copies of frame 0 in front, zeros around each frame."""
    w = conv.weight
    kt, kh, kw = w.shape[2:]
    if kt > 1:
        x = torch.cat([x[:, :, :1]] * (kt - 1) + [x], dim=2)
    return F.conv3d(x, w.to(x.dtype), conv.bias.to(x.dtype), padding=(0, kh // 2, kw // 2))


def _conv_frames(conv: nn.Conv2d, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """A spatial conv applied to every frame (no padding: the caller pads)."""
    w = conv.weight
    return F.conv3d(x, w.to(x.dtype)[:, :, None], conv.bias.to(x.dtype), stride=(1, stride, stride))


def _nearest(x: torch.Tensor, size) -> torch.Tensor:
    """Nearest resize of dims (2, 3, 4) to `size`, indexing as ``jax.image.resize``."""
    for d, n in zip((2, 3, 4), size):
        m = x.shape[d]
        if m != n:
            idx = ((torch.arange(n, dtype=torch.float32) + 0.5) * m / n).floor().long()
            x = x.index_select(d, idx.to(x.device))
    return x


def _resize_time_split(z: torch.Tensor, t_out: int, h: int, w: int) -> torch.Tensor:
    if t_out > 1 and t_out % 2 == 1:
        return torch.cat([_nearest(z[:, :, :1], (1, h, w)),
                          _nearest(z[:, :, 1:], (t_out - 1, h, w))], dim=2)
    return _nearest(z, (t_out, h, w))


def _spatial_norm(p: SpatialNorm, f, zq, cfg: CogVAEConfig):
    """GroupNorm(f) * conv_y(z) + conv_b(z), in place on conv_y's output (f and z share
    the latents' dtype in the decoder)."""
    z = _resize_time_split(zq, *f.shape[2:])
    out = _conv3d(p.conv_y, z)
    out.mul_(_group_norm(p.norm_layer, f, cfg.groups, cfg.eps))
    return out.add_(_conv3d(p.conv_b, z))


def _norm(p, x, zq, cfg: CogVAEConfig):
    if zq is not None:
        return _spatial_norm(p, x, zq, cfg)
    return _group_norm(p, x, cfg.groups, cfg.eps)


def _resnet(p: CogResnet, x, zq, cfg: CogVAEConfig):
    h = _conv3d(p.conv1, F.silu(_norm(p.norm1, x, zq, cfg), inplace=True))
    h = _conv3d(p.conv2, F.silu(_norm(p.norm2, h, zq, cfg), inplace=True))
    if hasattr(p, "conv_shortcut"):
        x = _conv3d(p.conv_shortcut, x)
    return h.add_(x)


def _downsample(p: CogResample, x, compress_time: bool):
    b, c, t, h, w = x.shape
    if compress_time:
        if t % 2 == 1 and t > 1:
            rest = x[:, :, 1:].reshape(b, c, (t - 1) // 2, 2, h, w).mean(dim=3)
            x = torch.cat([x[:, :, :1], rest], dim=2)
        elif t % 2 == 0:
            x = x.reshape(b, c, t // 2, 2, h, w).mean(dim=3)
    return _conv_frames(p.conv, F.pad(x, (0, 1, 0, 1)), stride=2)


def _upsample(p: CogResample, x, compress_time: bool):
    b, c, t, h, w = x.shape
    if compress_time and t > 1 and t % 2 == 1:
        x = torch.cat([_nearest(x[:, :, :1], (1, 2 * h, 2 * w)),
                       _nearest(x[:, :, 1:], (2 * (t - 1), 2 * h, 2 * w))], dim=2)
    elif compress_time and t > 1:
        x = _nearest(x, (2 * t, 2 * h, 2 * w))
    else:
        x = _nearest(x, (t, 2 * h, 2 * w))
    return _conv_frames(p.conv, F.pad(x, (1, 1, 1, 1)))


def _run_plan(blocks, plan, x, zq, cfg: CogVAEConfig):
    for spec, p in zip(plan, blocks):
        if spec[0] == "res":
            x = _resnet(p, x, zq, cfg)
        elif spec[0] == "down":
            x = _downsample(p, x, spec[2])
        else:
            x = _upsample(p, x, spec[2])
    return x


def cog_vae_decode(model: CogVAEDecoder, latents: torch.Tensor,
                   cfg: CogVAEConfig = CogVAEConfig()) -> torch.Tensor:
    """(B, T, H, W, 16) latents -> (B, T', 8H, 8W, 3) video in [-1, 1], unclamped."""
    z = _to_cf(latents / cfg.scaling)
    x = _conv3d(model.conv_in, z)
    x = _run_plan(model.blocks, cog_decoder_plan(cfg), x, z, cfg)
    x = F.silu(_spatial_norm(model.norm_out, x, z, cfg), inplace=True)
    return _to_cl(_conv3d(model.conv_out, x))


def cog_vae_encode(model: CogVAEEncoder, video: torch.Tensor,
                   cfg: CogVAEConfig = CogVAEConfig()) -> torch.Tensor:
    """(B, T, H, W, 3) video in [-1, 1] -> (B, T', H/8, W/8, 16) scaled latent means."""
    x = _conv3d(model.conv_in, _to_cf(video))
    x = _run_plan(model.blocks, cog_encoder_plan(cfg), x, None, cfg)
    x = F.silu(_group_norm(model.norm_out, x, cfg.groups, cfg.eps))
    return _to_cl(_conv3d(model.conv_out, x)[:, :cfg.latent_dim]) * cfg.scaling


def cog_vae_decode_tiled(model: CogVAEDecoder, latents: torch.Tensor,
                         cfg: CogVAEConfig = CogVAEConfig(), tile_size=(60, 90),
                         tile_stride=(30, 45)) -> torch.Tensor:
    """Spatial tiles in latent units over (H, W), every frame in each tile; float32
    frames on the latents' device."""
    from goal_force_tpu_torch.models.tiler import tiled_forward_2d_to_3d

    T = latents.shape[1]
    return tiled_forward_2d_to_3d(
        lambda z: cog_vae_decode(model, z, cfg), latents, tile_size, tile_stride,
        scales=(3 / cfg.latent_dim, (T // 2 * 8 + T % 2) / T, 8.0, 8.0))


def cog_vae_encode_tiled(model: CogVAEEncoder, video: torch.Tensor,
                         cfg: CogVAEConfig = CogVAEConfig(), tile_size=(60, 90),
                         tile_stride=(30, 45)) -> torch.Tensor:
    """Spatial tiles given in latent units (x8 in pixels); float32 latents on the
    video's device."""
    from goal_force_tpu_torch.models.tiler import tiled_forward_2d_to_3d

    T = video.shape[1]
    return tiled_forward_2d_to_3d(
        lambda v: cog_vae_encode(model, v, cfg), video, tuple(i * 8 for i in tile_size),
        tuple(i * 8 for i in tile_stride),
        scales=(cfg.latent_dim / 3, (T // 4 + T % 2) / T, 1 / 8, 1 / 8))


@torch.no_grad()
def init_cog_vae(cls, cfg: CogVAEConfig, gen: torch.Generator, dtype=torch.float32, *,
                 device):
    """`cls` (CogVAEEncoder or CogVAEDecoder) with N(0, (0.5/sqrt(fan_in))**2) conv
    weights, zero biases and unit norms (JAX ``init_cog_vae_*``'s distributions), drawn
    from `gen`."""
    model = empty_module(cls, cfg, dtype=dtype, device=device)
    for m in model.modules():
        if isinstance(m, (nn.Conv3d, nn.Conv2d)):
            m.weight.normal_(generator=gen).mul_(0.5 / math.sqrt(m.weight[0].numel()))
            m.bias.zero_()
        elif isinstance(m, LayerNormAffine):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return model.eval().requires_grad_(False)


def cog_vae_side(sd) -> str:
    """"decoder" or "encoder": which half a reference-format state dict holds."""
    return "decoder" if any(k.startswith("norm_out.norm_layer.") for k in sd) else "encoder"
