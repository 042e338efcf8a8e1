"""Wan2.2 VAE38 — the 48-channel, 16x video VAE of Wan2.2-TI2V-5B, in PyTorch.

Port of ``goal_force_tpu/models/vae38.py``: pixel-space patchify(2) (3 -> 12 channels),
residual stages with parameter-free shortcuts (an average pool on the way down, a
duplicating upsample on the way up), spatial 8x and patch 2 = 16x. As in the JAX package
it runs the closed form of the reference's streaming: ``avg_down3d`` is a front-padded
average pool over the whole sequence, and ``dup_up3d`` repeats frames 2x and drops the
first (factor_t - 1) of them.

The building blocks (causal conv3d, channel RMS norm, residual and attention blocks, the
spatial and temporal resamples) are ``models/vae.py``'s. Public functions take and return
channels-last (B, T, H, W, C) tensors; inside, activations are channels-first. Parameter
names are the reference's, as ``vae38_params_from_torch`` reads them:
``encoder.downsamples.{i}.downsamples.{j}`` (residual blocks j < n, then the stage's
``resample.1`` and ``time_conv`` at j = n), ``decoder.upsamples.{i}.upsamples.{j}``,
``encoder|decoder.middle.{0,1,2}``, ``encoder|decoder.head.{0,2}``, ``conv1``, ``conv2``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import torch
from torch import nn

from goal_force_tpu_torch.models.vae import (
    AttentionBlock,
    RMSNormC,
    Resample,
    ResidualBlock,
    _head,
    _to_cf,
    _to_cl,
    attention_block,
    causal_conv3d,
    downsample3d_time,
    downsample_spatial,
    norm_silu,
    residual_block,
    upsample3d_time,
    upsample_spatial,
)
from goal_force_tpu_torch.models.wan_dit import empty_module

# Per-channel latent statistics of the 48-channel VAE.
VAE38_MEAN = (
    -0.2289, -0.0052, -0.1323, -0.2339, -0.2799, 0.0174, 0.1838, 0.1557,
    -0.1382, 0.0542, 0.2813, 0.0891, 0.1570, -0.0098, 0.0375, -0.1825,
    -0.2246, -0.1207, -0.0698, 0.5109, 0.2665, -0.2108, -0.2158, 0.2502,
    -0.2055, -0.0322, 0.1109, 0.1567, -0.0729, 0.0899, -0.2799, -0.1230,
    -0.0313, -0.1649, 0.0117, 0.0723, -0.2839, -0.2083, -0.0520, 0.3748,
    0.0152, 0.1957, 0.1433, -0.2944, 0.3573, -0.0548, -0.1681, -0.0667,
)
VAE38_STD = (
    0.4765, 1.0364, 0.4514, 1.1677, 0.5313, 0.4990, 0.4818, 0.5013,
    0.8158, 1.0344, 0.5894, 1.0901, 0.6885, 0.6165, 0.8454, 0.4978,
    0.5759, 0.3523, 0.7135, 0.6804, 0.5833, 1.4146, 0.8986, 0.5659,
    0.7069, 0.5338, 0.4889, 0.4917, 0.4069, 0.4999, 0.6866, 0.4093,
    0.5709, 0.6065, 0.6415, 0.4944, 0.5726, 1.2042, 0.5458, 1.6887,
    0.3971, 1.0600, 0.3943, 0.5537, 0.5444, 0.4089, 0.7468, 0.7744,
)


@dataclasses.dataclass(frozen=True)
class VAE38Config:
    dim: int = 160
    dec_dim: int = 256
    z_dim: int = 48
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    temporal_downsample: Tuple[bool, ...] = (False, True, True)
    patch_size: int = 2
    upsampling_factor: int = 16

    @property
    def temporal_upsample(self):
        return tuple(reversed(self.temporal_downsample))


WAN22_VAE38 = VAE38Config()


def tiny_vae38() -> VAE38Config:
    return VAE38Config(dim=8, dec_dim=8, z_dim=4, num_res_blocks=1)


# ---------------------------------------------------------------------------
# Stage plans: (din, dout, temporal, spatial) per stage
# ---------------------------------------------------------------------------

def enc_stages(cfg: VAE38Config) -> List[Tuple[int, int, bool, bool]]:
    dims = [cfg.dim * u for u in (1,) + tuple(cfg.dim_mult)]
    out = []
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        t_down = cfg.temporal_downsample[i] if i < len(cfg.temporal_downsample) else False
        out.append((din, dout, t_down, i != len(cfg.dim_mult) - 1))
    return out


def dec_stages(cfg: VAE38Config) -> List[Tuple[int, int, bool, bool]]:
    dims = [cfg.dec_dim * u for u in (cfg.dim_mult[-1],) + tuple(reversed(cfg.dim_mult))]
    out = []
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        t_up = cfg.temporal_upsample[i] if i < len(cfg.temporal_upsample) else False
        out.append((din, dout, t_up, i != len(cfg.dim_mult) - 1))
    return out


# ---------------------------------------------------------------------------
# Modules (parameter holders under the reference names)
# ---------------------------------------------------------------------------

class _Stage(nn.Module):
    """Residual blocks din -> dout -> ... -> dout, then a resample at index n when the
    stage resamples (its time conv doubles the channels on the decoder side)."""

    def __init__(self, name: str, din: int, dout: int, n: int, temporal: bool,
                 spatial: bool, decoder: bool):
        super().__init__()
        mods = [ResidualBlock(din if j == 0 else dout, dout) for j in range(n)]
        if spatial:
            time_cout = (2 * dout if decoder else dout) if temporal else 0
            mods.append(Resample(dout, dout, time_cout))
        setattr(self, name, nn.ModuleList(mods))


class Encoder38(nn.Module):
    def __init__(self, cfg: VAE38Config):
        super().__init__()
        top = cfg.dim * cfg.dim_mult[-1]
        self.conv1 = nn.Conv3d(3 * cfg.patch_size**2, cfg.dim, 3)
        self.downsamples = nn.ModuleList(
            _Stage("downsamples", din, dout, cfg.num_res_blocks, t, s, decoder=False)
            for din, dout, t, s in enc_stages(cfg))
        self.middle = nn.ModuleList([ResidualBlock(top, top), AttentionBlock(top),
                                     ResidualBlock(top, top)])
        self.head = _head(top, cfg.z_dim * 2)


class Decoder38(nn.Module):
    def __init__(self, cfg: VAE38Config):
        super().__init__()
        top = cfg.dec_dim * cfg.dim_mult[-1]
        self.conv1 = nn.Conv3d(cfg.z_dim, top, 3)
        self.middle = nn.ModuleList([ResidualBlock(top, top), AttentionBlock(top),
                                     ResidualBlock(top, top)])
        self.upsamples = nn.ModuleList(
            _Stage("upsamples", din, dout, cfg.num_res_blocks + 1, t, s, decoder=True)
            for din, dout, t, s in dec_stages(cfg))
        self.head = _head(cfg.dec_dim, 3 * cfg.patch_size**2)


class WanVAE38(nn.Module):
    def __init__(self, cfg: VAE38Config):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder38(cfg)
        self.decoder = Decoder38(cfg)
        self.conv1 = nn.Conv3d(cfg.z_dim * 2, cfg.z_dim * 2, 1)
        self.conv2 = nn.Conv3d(cfg.z_dim, cfg.z_dim, 1)


# ---------------------------------------------------------------------------
# Parameter-free pieces
# ---------------------------------------------------------------------------

def pixel_patchify(x: torch.Tensor, p: int = 2) -> torch.Tensor:
    """(B, T, H, W, 3) -> (B, T, H/p, W/p, 3 p p), features in (c, dx, dy) order."""
    b, t, h, w, c = x.shape
    x = x.reshape(b, t, h // p, p, w // p, p, c)
    return x.permute(0, 1, 2, 4, 6, 5, 3).reshape(b, t, h // p, w // p, c * p * p)


def pixel_unpatchify(x: torch.Tensor, p: int = 2) -> torch.Tensor:
    b, t, h, w, cpp = x.shape
    c = cpp // (p * p)
    x = x.reshape(b, t, h, w, c, p, p)
    return x.permute(0, 1, 2, 6, 3, 5, 4).reshape(b, t, h * p, w * p, c)


def avg_down3d(x: torch.Tensor, factor_t: int, factor_s: int, out_channels: int):
    """Channels-first (B, C, T, H, W): zero frames in front up to a multiple of factor_t,
    then each (factor_t, factor_s, factor_s) group and its C channels, flattened in
    (C, t, dy, dx) order, averaged over consecutive groups into out_channels."""
    b, c, t, h, w = x.shape
    pad_t = (factor_t - t % factor_t) % factor_t
    if pad_t:
        x = torch.cat([x.new_zeros((b, c, pad_t, h, w)), x], dim=2)
        t += pad_t
    x = x.reshape(b, c, t // factor_t, factor_t, h // factor_s, factor_s,
                  w // factor_s, factor_s)
    x = x.permute(0, 1, 3, 5, 7, 2, 4, 6)
    group = c * factor_t * factor_s * factor_s // out_channels
    return x.reshape(b, out_channels, group, t // factor_t, h // factor_s,
                     w // factor_s).mean(dim=2)


def dup_up3d(x: torch.Tensor, factor_t: int, factor_s: int, out_channels: int,
             first_chunk: bool) -> torch.Tensor:
    """Channels-first: each channel repeated, the copies spread over (t, dy, dx), and the
    first factor_t - 1 frames dropped for the first chunk (the whole sequence here)."""
    b, c, t, h, w = x.shape
    repeats = out_channels * factor_t * factor_s * factor_s // c
    x = x.repeat_interleave(repeats, dim=1)
    x = x.reshape(b, out_channels, factor_t, factor_s, factor_s, t, h, w)
    x = x.permute(0, 1, 5, 2, 6, 3, 7, 4).reshape(
        b, out_channels, t * factor_t, h * factor_s, w * factor_s)
    return x[:, :, factor_t - 1:] if first_chunk else x


# ---------------------------------------------------------------------------
# Encoder / decoder (channels-last in and out)
# ---------------------------------------------------------------------------

def encode(vae: WanVAE38, cfg: VAE38Config, video: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, 3), T = 1 + 4k -> unscaled mu (B, 1 + k, H/16, W/16, z)."""
    if video.shape[1] % 4 != 1:
        raise ValueError(f"encode expects T = 1+4k frames, got T={video.shape[1]}")
    enc = vae.encoder
    x = causal_conv3d(enc.conv1, _to_cf(pixel_patchify(video, cfg.patch_size)))
    for stage, (din, dout, t_down, down) in zip(enc.downsamples, enc_stages(cfg)):
        shortcut = avg_down3d(x, 2 if (t_down and down) else 1, 2 if down else 1, dout)
        mods = stage.downsamples
        for rb in mods[:cfg.num_res_blocks]:
            x = residual_block(rb, x)
        if down:
            x = downsample_spatial(mods[-1], x)
            if t_down:
                x = downsample3d_time(mods[-1].time_conv, x)
        x = x + shortcut
    x = residual_block(enc.middle[0], x)
    x = attention_block(enc.middle[1], x)
    x = residual_block(enc.middle[2], x)
    x = causal_conv3d(enc.head[2], norm_silu(enc.head[0], x))
    moments = causal_conv3d(vae.conv1, x)
    return _to_cl(moments[:, : cfg.z_dim])


def decode(vae: WanVAE38, cfg: VAE38Config, z: torch.Tensor) -> torch.Tensor:
    """(B, L, h, w, z) -> (B, 4L - 3, 16h, 16w, 3), unclamped."""
    dec = vae.decoder
    x = causal_conv3d(vae.conv2, _to_cf(z))
    x = causal_conv3d(dec.conv1, x)
    x = residual_block(dec.middle[0], x)
    x = attention_block(dec.middle[1], x)
    x = residual_block(dec.middle[2], x)
    n = cfg.num_res_blocks + 1
    for stage, (din, dout, t_up, up) in zip(dec.upsamples, dec_stages(cfg)):
        mods = stage.upsamples
        shortcut = dup_up3d(x, 2 if t_up else 1, 2, dout, first_chunk=True) if up else None
        for rb in mods[:n]:
            x = residual_block(rb, x)
        if up:
            if t_up:
                x = upsample3d_time(mods[-1].time_conv, x)
            x = upsample_spatial(mods[-1], x) + shortcut
        del shortcut
    x = causal_conv3d(dec.head[2], norm_silu(dec.head[0], x))
    return pixel_unpatchify(_to_cl(x), cfg.patch_size)


def latent_scale38(cfg: VAE38Config, dtype, device):
    if cfg.z_dim == 48:
        return (torch.tensor(VAE38_MEAN, dtype=dtype, device=device),
                torch.tensor(VAE38_STD, dtype=dtype, device=device))
    return (torch.zeros(cfg.z_dim, dtype=dtype, device=device),
            torch.ones(cfg.z_dim, dtype=dtype, device=device))


def encode_video(vae: WanVAE38, cfg: VAE38Config, video: torch.Tensor) -> torch.Tensor:
    """Scaled encode: (mu - mean) / std."""
    mu = encode(vae, cfg, video)
    mean, std = latent_scale38(cfg, mu.dtype, mu.device)
    return (mu - mean) / std


def decode_video(vae: WanVAE38, cfg: VAE38Config, latents: torch.Tensor) -> torch.Tensor:
    """Scaled decode, clamped to [-1, 1]."""
    mean, std = latent_scale38(cfg, latents.dtype, latents.device)
    return torch.clamp(decode(vae, cfg, latents * std + mean), -1.0, 1.0)


def vae38_from_state_dict(sd, cfg: VAE38Config = WAN22_VAE38, dtype=torch.float32, *,
                          device) -> WanVAE38:
    """The VAE from a reference-format state dict (a ``model.`` prefix is stripped, as
    JAX's ``vae38_params_from_torch`` strips it), strictly: a missing, unexpected or
    mis-shaped key raises."""
    from goal_force_tpu_torch.pipelines.goal_force import load_state_dict_strict, vae_state_dict

    vae = empty_module(WanVAE38, cfg, dtype=dtype, device=device)
    load_state_dict_strict(vae, vae_state_dict(sd), "vae38")
    return vae.eval().requires_grad_(False)


# ---------------------------------------------------------------------------
# Random init (the JAX package's distributions)
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_vae38(cfg: VAE38Config, gen: torch.Generator, dtype=torch.float32, *,
               device) -> WanVAE38:
    """Uniform +-1/sqrt(fan_in) conv weights, zero biases, unit gammas, zero-init
    attention projections, as JAX ``init_vae38`` draws them."""
    vae = empty_module(WanVAE38, cfg, dtype=dtype, device=device)
    for mod in vae.modules():
        if isinstance(mod, (nn.Conv2d, nn.Conv3d)):
            scale = 1.0 / math.sqrt(mod.weight[0].numel())
            mod.weight.uniform_(-scale, scale, generator=gen)
            mod.bias.zero_()
        elif isinstance(mod, RMSNormC):
            mod.gamma.fill_(1.0)
    for mod in vae.modules():
        if isinstance(mod, AttentionBlock):
            mod.proj.weight.zero_()
    return vae.eval().requires_grad_(False)
