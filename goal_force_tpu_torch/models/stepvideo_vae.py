"""StepVideo 3D VAE (version 2) in PyTorch.

Port of ``goal_force_tpu/models/stepvideo_vae.py``:

- the per-frame group norm: statistics over (H, W, C/groups) for each (batch, frame);
- the causal conv: zeros in front of time (k - 1, plus the stride's slack), spatial
  SAME; the resnet's norm + SiLU, two zero frames in front and a VALID-time conv is the
  same function as a causal conv of kernel 3 on the normed input;
- the mid block's single-head attention, token-causal over the flattened (t, h, w)
  sequence, run over blocks of query rows (each row's softmax stays whole; a block
  reads only the keys at or before its last row, the rest being exact zeros of the
  softmax; ``models/vae.py::masked_mid_attention``), as JAX computes it in XLA;
- ``_down2d`` (zero pad bottom/right, stride-2 conv per frame), ``_up2d`` (nearest x2 per
  frame, conv), ``_up3d`` (nearest x2 over (t, h, w), then ``_res3d_upsample``), the 3D
  pixel (un)shuffle and the channel-averaging and channel-duplicating shortcuts;
- ``stepvideo_encode_chunk`` / ``stepvideo_decode_chunk`` (17 frames <-> 3 latent
  frames, 16x spatial), the chunked encode (a diagonal-Gaussian sample from an explicit
  generator, or the mean), the chunked decode with the 0.6/0.4 seam mix, and the tiled
  decode (no seam mix) over ``models/vae.py::_blend_mask_1d``.

The public functions take and return channels-last (B, T, H, W, C) tensors, as JAX's;
inside, activations are channels-first (B, C, T, H, W). A conv runs in its input's dtype
(the weights cast to it), as in JAX: latents decode in float32 whatever the weights'
dtype. At StepVideo's size the decoder's last level holds (20, 544, 992, 128) float32
activations (5.5 GB each), so the norm runs a few frames at a time under
``NORM_F32_BYTES`` of float32 temporaries (its statistics are per frame, so the result is
the same), its SiLU in place, and the convs and the per-frame 2D ops over chunks of
frames whose input slice stays under ``CONV_BYTES``, written into one output.

``StepVideoVAE`` holds the encoder and decoder (either or both) under the reference
``encoder.*`` / ``decoder.*`` names that JAX ``stepvideo_vae_params_from_torch`` reads.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from goal_force_tpu_torch.models.vae import _blend_mask_1d, masked_mid_attention
from goal_force_tpu_torch.models.wan_dit import LayerNormAffine, empty_module


@dataclasses.dataclass(frozen=True)
class StepVideoVAEConfig:
    enc_ch: int = 32
    enc_mult: Tuple[int, ...] = (4, 8, 16, 16)
    dec_ch: int = 128
    dec_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    z_dim: int = 64
    groups: int = 32
    eps: float = 1e-6
    frame_len: int = 17
    latent_len: int = 3
    temporal_downsample: int = 4

    @property
    def enc_down3d_levels(self):
        return (1, 2)

    @property
    def dec_up3d_levels(self):
        return (2, 3)


def tiny_stepvideo_vae_config():
    return StepVideoVAEConfig(enc_ch=8, enc_mult=(2, 2, 4, 4), dec_ch=16,
                              dec_mult=(1, 1, 2, 2), num_res_blocks=1, z_dim=4, groups=4)


# ---------------------------------------------------------------------------
# Modules (parameter holders under the reference names)
# ---------------------------------------------------------------------------

class CausalConv(nn.Module):
    """A Conv3d under ``.conv``."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv3d(cin, cout, k, stride)


class ConvLayer(nn.Module):
    """The patchify / unpatchify layers: their causal conv under ``.conv``."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = CausalConv(cin, cout)


class Resnet3D(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = LayerNormAffine(cin)
        self.conv1 = CausalConv(cin, cout)
        self.norm2 = LayerNormAffine(cout)
        self.conv2 = CausalConv(cout, cout)
        if cin != cout:
            self.nin_shortcut = CausalConv(cin, cout, 1)


class AttnBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.norm = LayerNormAffine(c)
        self.q = CausalConv(c, c, 1)
        self.k = CausalConv(c, c, 1)
        self.v = CausalConv(c, c, 1)
        self.proj_out = CausalConv(c, c, 1)


class Mid(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.block_1 = Resnet3D(c, c)
        self.attn_1 = AttnBlock(c)
        self.block_2 = Resnet3D(c, c)


class Conv2dHolder(nn.Module):
    """Downsample2D / Upsample2D: a Conv2d under ``.conv`` (stride 2 for the former)."""

    def __init__(self, c: int, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, stride)


class Down3D(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = CausalConv(c, c, 3, 2)


class Res3DUpsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv1 = CausalConv(c, c)
        self.norm1 = LayerNormAffine(c)
        self.conv2 = CausalConv(c, c)
        self.norm2 = LayerNormAffine(c)


class Up3D(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv3d = Res3DUpsample(c)


class Level(nn.Module):
    def __init__(self, cin: int, cout: int, n: int, resample: Optional[nn.Module],
                 name: str):
        super().__init__()
        self.block = nn.ModuleList(Resnet3D(cin if j == 0 else cout, cout) for j in range(n))
        if resample is not None:
            setattr(self, name, resample)


class VideoEncoder(nn.Module):
    def __init__(self, cfg: StepVideoVAEConfig):
        super().__init__()
        ch, mult = cfg.enc_ch, cfg.enc_mult
        self.conv_in = CausalConv(3, ch)
        levels, cin = [], ch
        for i, m in enumerate(mult):
            cout = ch * m
            down = None
            if i != len(mult) - 1:
                down = Down3D(cout) if i in cfg.enc_down3d_levels else Conv2dHolder(cout, 2)
            levels.append(Level(cin, cout, cfg.num_res_blocks, down, "downsample"))
            cin = cout
        self.down = nn.ModuleList(levels)
        self.mid = Mid(cin)
        self.norm_out = LayerNormAffine(cin)
        channels = 4 * cfg.z_dim * 8
        self.conv_patchify = ConvLayer(cin, channels // 8)
        self.conv_out = CausalConv(channels, 2 * cfg.z_dim)


class VideoDecoder(nn.Module):
    def __init__(self, cfg: StepVideoVAEConfig):
        super().__init__()
        ch, mult = cfg.dec_ch, cfg.dec_mult
        channels = 4 * cfg.z_dim * 8
        block_in = ch * mult[-1]
        self.conv_in = CausalConv(cfg.z_dim, channels)
        self.conv_unpatchify = ConvLayer(channels, block_in * 8)
        self.mid = Mid(block_in)
        levels, cin = [None] * len(mult), block_in
        for i in reversed(range(len(mult))):
            cout = ch * mult[i]
            up = None
            if i != 0:
                up = Up3D(cout) if i in cfg.dec_up3d_levels else Conv2dHolder(cout)
            levels[i] = Level(cin, cout, cfg.num_res_blocks + 1, up, "upsample")
            cin = cout
        self.up = nn.ModuleList(levels)
        self.norm_out = LayerNormAffine(cin)
        self.conv_out = CausalConv(cin, 3)


class StepVideoVAE(nn.Module):
    """The encoder and the decoder, or one of them."""

    def __init__(self, cfg: StepVideoVAEConfig, encoder: bool = True, decoder: bool = True):
        super().__init__()
        if encoder:
            self.encoder = VideoEncoder(cfg)
        if decoder:
            self.decoder = VideoDecoder(cfg)


# ---------------------------------------------------------------------------
# Primitives (channels-first inside)
# ---------------------------------------------------------------------------

NORM_F32_BYTES = 1 << 30   # float32 temporaries of the frames normalized at once
CONV_BYTES = 2 << 30       # the input slice of one chunk of a conv's output frames


def _frame_steps(x: torch.Tensor, budget: int, per_frame_factor: int = 1):
    """Chunks of frames (dim 2) whose slice takes at most `budget` bytes (at least one)."""
    t = x.shape[2]
    frame = x[:, :, :1].numel() * per_frame_factor
    step = max(1, budget // max(1, frame))
    return [(t0, min(t, t0 + step)) for t0 in range(0, t, step)]


def _spatial_gn(p: LayerNormAffine, x: torch.Tensor, groups: int, eps: float,
                silu: bool) -> torch.Tensor:
    """Per-frame group norm in float32 (statistics over (C/groups, H, W) for each (b, t)),
    the affine in float32, SiLU on the float32 result where asked, cast to x's dtype."""
    b, c, t, h, w = x.shape
    wt = p.weight.float().reshape(1, c, 1, 1, 1)
    bs = p.bias.float().reshape(1, c, 1, 1, 1)
    out = torch.empty_like(x)
    for t0, t1 in _frame_steps(x, NORM_F32_BYTES, 4):
        xf = x[:, :, t0:t1].float().reshape(b, groups, c // groups, t1 - t0, h, w)
        mu = xf.mean((2, 4, 5), keepdim=True)
        xf = xf - mu
        var = xf.square().mean((2, 4, 5), keepdim=True)
        xf = (xf * torch.rsqrt(var + eps)).reshape(b, c, t1 - t0, h, w)
        xf = xf.mul_(wt).add_(bs)
        out[:, :, t0:t1] = F.silu(xf, inplace=True) if silu else xf
        del xf
    return out


def causal_conv(p: CausalConv, x: torch.Tensor, stride=(1, 1, 1)) -> torch.Tensor:
    """Zeros in front of time (kt - 1 + max(1 - stride_t, 0)), spatial SAME (kh // 2 on
    each side), the conv in x's dtype; over chunks of output frames."""
    conv = p.conv
    w, bias = conv.weight.to(x.dtype), conv.bias.to(x.dtype)
    kt, kh = w.shape[2], w.shape[3]
    st = stride[0]
    t_pad = (kt - 1) + max(1 - st, 0)
    b, _, t, hh, ww = x.shape
    t_out = (t + t_pad - kt) // st + 1
    pad = (0, kh // 2, kh // 2)
    frame = x[:, :, :1].numel() * x.element_size()
    step = max(1, CONV_BYTES // (frame * st))
    if step >= t_out:
        return F.conv3d(F.pad(x, (0, 0, 0, 0, t_pad, 0)) if t_pad else x, w, bias, stride, pad)
    out = None
    for o0 in range(0, t_out, step):
        o1 = min(t_out, o0 + step)
        i0, i1 = o0 * st - t_pad, (o1 - 1) * st - t_pad + kt
        xs = x[:, :, max(i0, 0):i1]
        if i0 < 0:
            xs = F.pad(xs, (0, 0, 0, 0, -i0, 0))
        y = F.conv3d(xs, w, bias, stride, pad)
        if out is None:
            out = x.new_empty((b, y.shape[1], t_out) + tuple(y.shape[3:]))
        out[:, :, o0:o1] = y
        del xs, y
    return out


def _linear1x1(p: CausalConv, x: torch.Tensor) -> torch.Tensor:
    """A 1x1x1 conv (x @ w + b over channels) in x's dtype."""
    return F.conv3d(x, p.conv.weight.to(x.dtype), p.conv.bias.to(x.dtype))


def _resnet(p: Resnet3D, x: torch.Tensor, cfg: StepVideoVAEConfig) -> torch.Tensor:
    h = causal_conv(p.conv1, _spatial_gn(p.norm1, x, cfg.groups, cfg.eps, silu=True))
    if hasattr(p, "nin_shortcut"):
        x = _linear1x1(p.nin_shortcut, x)
    h = causal_conv(p.conv2, _spatial_gn(p.norm2, h, cfg.groups, cfg.eps, silu=True))
    return h.add_(x)


def _attn(p: AttnBlock, x: torch.Tensor, cfg: StepVideoVAEConfig) -> torch.Tensor:
    """Single-head attention over the flattened (t, h, w) tokens, token i seeing tokens
    0..i (float32 logits, finfo.min elsewhere)."""
    b, c, t, h, w = x.shape
    n = _spatial_gn(p.norm, x, cfg.groups, cfg.eps, silu=False)
    q, k, v = (_linear1x1(m, n).reshape(b, c, -1).transpose(1, 2) for m in (p.q, p.k, p.v))
    del n
    pos = torch.arange(q.shape[1], device=x.device)
    out = masked_mid_attention(q, k, v, 1.0 / math.sqrt(c),
                               lambda s0, s1: pos[None, :s1] <= pos[s0:s1, None])
    out = out.transpose(1, 2).reshape(b, c, t, h, w)
    return x + _linear1x1(p.proj_out, out)


def _per_frame_2d(fn, x: torch.Tensor, grow: int) -> torch.Tensor:
    """fn over (n, C, H, W) frames, in chunks of frames whose input, `grow` times over,
    stays under CONV_BYTES, into one (B, C', T, H', W')."""
    b, _, t, _, _ = x.shape
    out = None
    for t0, t1 in _frame_steps(x, CONV_BYTES, x.element_size() * grow):
        xs = x[:, :, t0:t1].transpose(1, 2).reshape(b * (t1 - t0), *x.shape[1:2], *x.shape[3:])
        y = fn(xs)
        y = y.reshape(b, t1 - t0, *y.shape[1:]).transpose(1, 2)
        if out is None:
            out = x.new_empty((b, y.shape[1], t) + tuple(y.shape[3:]))
        out[:, :, t0:t1] = y
        del xs, y
    return out


def _down2d(p: Conv2dHolder, x: torch.Tensor) -> torch.Tensor:
    """Zero pad bottom/right by one, stride-2 conv per frame."""
    w, bias = p.conv.weight.to(x.dtype), p.conv.bias.to(x.dtype)
    return _per_frame_2d(lambda f: F.conv2d(F.pad(f, (0, 1, 0, 1)), w, bias, 2), x, 1)


def _nearest2(x: torch.Tensor, dims) -> torch.Tensor:
    """Nearest x2 along `dims` (each element repeated twice, as jax.image.resize does
    for an exact x2), in one copy."""
    shape = list(x.shape)
    view, expand = [], []
    for d, n in enumerate(shape):
        view.append(n)
        expand.append(n)
        if d in dims:
            view.append(1)
            expand.append(2)
    out = [n * 2 if d in dims else n for d, n in enumerate(shape)]
    return x.reshape(view).expand(expand).reshape(out)


def _up2d(p: Conv2dHolder, x: torch.Tensor) -> torch.Tensor:
    """Nearest x2 per frame, then a conv of kernel 3 with padding 1."""
    w, bias = p.conv.weight.to(x.dtype), p.conv.bias.to(x.dtype)
    return _per_frame_2d(lambda f: F.conv2d(_nearest2(f, (2, 3)), w, bias, padding=1), x, 4)


def _res3d_upsample(p: Res3DUpsample, x: torch.Tensor, cfg: StepVideoVAEConfig):
    h = causal_conv(p.conv1, x)
    h = _spatial_gn(p.norm1, h, cfg.groups, cfg.eps, silu=True)
    h = causal_conv(p.conv2, h)
    h = _spatial_gn(p.norm2, h, cfg.groups, cfg.eps, silu=False)
    return F.silu(h.add_(x), inplace=True).add_(x)


def _up3d(p: Up3D, x: torch.Tensor, cfg: StepVideoVAEConfig) -> torch.Tensor:
    return _res3d_upsample(p.conv3d, _nearest2(x, (2, 3, 4)), cfg)


def _pixel_unshuffle_3d(x: torch.Tensor, f: int) -> torch.Tensor:
    """f - 1 zero frames in front, then space to channels as (c, ft, fh, fw)."""
    x = F.pad(x, (0, 0, 0, 0, f - 1, 0))
    b, c, t, h, w = x.shape
    x = x.reshape(b, c, t // f, f, h // f, f, w // f, f).permute(0, 1, 3, 5, 7, 2, 4, 6)
    return x.reshape(b, c * f ** 3, t // f, h // f, w // f)


def _pixel_shuffle_3d(x: torch.Tensor, f: int) -> torch.Tensor:
    """Channels (c, ft, fh, fw) to space, the first f - 1 frames dropped."""
    b, c, t, h, w = x.shape
    nc = c // f ** 3
    x = x.reshape(b, nc, f, f, f, t, h, w).permute(0, 1, 5, 2, 6, 3, 7, 4)
    return x.reshape(b, nc, t * f, h * f, w * f)[:, :, f - 1:]


def _channel_avg_down(x: torch.Tensor, out_channels: int, f: int) -> torch.Tensor:
    if f > 1:
        x = _pixel_unshuffle_3d(x, f)
    b, c, t, h, w = x.shape
    return x.reshape(b, out_channels, c // out_channels, t, h, w).mean(2)


def _channel_dup_up(x: torch.Tensor, out_channels: int, f: int) -> torch.Tensor:
    x = x.repeat_interleave(out_channels * f ** 3 // x.shape[1], dim=1)
    return _pixel_shuffle_3d(x, f) if f > 1 else x


# ---------------------------------------------------------------------------
# Encoder / decoder
# ---------------------------------------------------------------------------

def _encode_cf(p: VideoEncoder, x: torch.Tensor, cfg: StepVideoVAEConfig) -> torch.Tensor:
    x = causal_conv(p.conv_in, x)
    n_lv = len(cfg.enc_mult)
    for i, lvl in enumerate(p.down):
        for bp in lvl.block:
            x = _resnet(bp, x, cfg)
        if i != n_lv - 1:
            if i in cfg.enc_down3d_levels:
                x = causal_conv(lvl.downsample.conv, x, stride=(2, 2, 2))
            else:
                x = _down2d(lvl.downsample, x)
    x = _resnet(p.mid.block_1, x, cfg)
    x = _attn(p.mid.attn_1, x, cfg)
    x = _resnet(p.mid.block_2, x, cfg)
    x = _spatial_gn(p.norm_out, x, cfg.groups, cfg.eps, silu=True)
    channels = 4 * cfg.z_dim * 8
    short = _channel_avg_down(x, channels, 2)
    x = _pixel_unshuffle_3d(causal_conv(p.conv_patchify.conv, x), 2) + short
    short = _channel_avg_down(x, 2 * cfg.z_dim, 1)
    return causal_conv(p.conv_out, x) + short


def stepvideo_encode_chunk(model: StepVideoVAE, video: torch.Tensor,
                           cfg: StepVideoVAEConfig) -> torch.Tensor:
    """(B, 17, H, W, 3) -> (B, 3, H/16, W/16, 2*z) moments."""
    x = _encode_cf(model.encoder, video.permute(0, 4, 1, 2, 3), cfg)
    return x.permute(0, 2, 3, 4, 1)


def _decode_cf(p: VideoDecoder, z: torch.Tensor, cfg: StepVideoVAEConfig) -> torch.Tensor:
    channels = 4 * cfg.z_dim * 8
    block_in = cfg.dec_ch * cfg.dec_mult[-1]
    x = causal_conv(p.conv_in, z) + _channel_dup_up(z, channels, 1)
    short = _channel_dup_up(x, block_in, 2)
    x = _pixel_shuffle_3d(causal_conv(p.conv_unpatchify.conv, x), 2) + short
    del short
    x = _resnet(p.mid.block_1, x, cfg)
    x = _attn(p.mid.attn_1, x, cfg)
    x = _resnet(p.mid.block_2, x, cfg)
    for i in reversed(range(len(cfg.dec_mult))):
        lvl = p.up[i]
        for bp in lvl.block:
            x = _resnet(bp, x, cfg)
        if i != 0:
            if i in cfg.dec_up3d_levels:
                x = _up3d(lvl.upsample, x, cfg)
            else:
                x = _up2d(lvl.upsample, x)
    x = causal_conv(p.conv_out, _spatial_gn(p.norm_out, x, cfg.groups, cfg.eps, silu=True))
    return x[:, :, cfg.temporal_downsample - 1:]


def stepvideo_decode_chunk(model: StepVideoVAE, z: torch.Tensor,
                           cfg: StepVideoVAEConfig) -> torch.Tensor:
    """(B, 3, h, w, z) -> (B, 17, 16h, 16w, 3)."""
    return _decode_cf(model.decoder, z.permute(0, 4, 1, 2, 3), cfg).permute(0, 2, 3, 4, 1)


def stepvideo_vae_encode(model: StepVideoVAE, video: torch.Tensor,
                         cfg: StepVideoVAEConfig = StepVideoVAEConfig(),
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Chunks of 17 frames -> latents (B, 3 per chunk, H/16, W/16, z): each chunk's mean,
    or, given a generator, a sample of its diagonal Gaussian (logvar clipped to
    [-30, 20])."""
    chunks = []
    for t0 in range(0, video.shape[1], cfg.frame_len):
        moments = stepvideo_encode_chunk(model, video[:, t0:t0 + cfg.frame_len], cfg)
        mean, logvar = moments.chunk(2, dim=-1)
        if generator is not None:
            std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
            eps = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                              device=generator.device).to(mean.device)
            mean = mean + std * eps
        chunks.append(mean)
    return torch.cat(chunks, dim=1)


def stepvideo_vae_decode(model: StepVideoVAE, latents: torch.Tensor,
                         cfg: StepVideoVAEConfig = StepVideoVAEConfig(),
                         smooth_scale: float = 0.6) -> torch.Tensor:
    """Chunks of 3 latent frames -> 17 frames each, concatenated; at each seam the last
    frame of a chunk and the first of the next are mixed smooth_scale / 1 - smooth_scale."""
    x = torch.cat([stepvideo_decode_chunk(model, latents[:, t0:t0 + cfg.latent_len], cfg)
                   for t0 in range(0, latents.shape[1], cfg.latent_len)], dim=1)
    fl = cfg.frame_len
    if x.shape[1] > fl:
        front, back = x[:, fl - 1:-1:fl].clone(), x[:, fl::fl].clone()
        x[:, fl - 1:-1:fl] = front * smooth_scale + back * (1 - smooth_scale)
        x[:, fl::fl] = back * smooth_scale + front * (1 - smooth_scale)
    return x


def stepvideo_vae_decode_tiled(model: StepVideoVAE, latents: torch.Tensor,
                               cfg: StepVideoVAEConfig = StepVideoVAEConfig(),
                               tile_size=(34, 34), tile_stride=(16, 16)) -> torch.Tensor:
    """Per latent chunk and spatial tile (latent units), blended by border ramps of
    (size - stride) * 16 pixels; no seam mix. float32 frames on latents' device."""
    b, T, H, W, _ = latents.shape
    sh, sw = tile_size
    rh, rw = tile_stride
    values = weight = None
    for t0 in range(0, T, cfg.latent_len):
        for h0 in range(0, H, rh):
            if h0 - rh >= 0 and h0 - rh + sh >= H:
                continue
            for w0 in range(0, W, rw):
                if w0 - rw >= 0 and w0 - rw + sw >= W:
                    continue
                out = stepvideo_decode_chunk(model, latents[:, t0:t0 + cfg.latent_len,
                                                            h0:min(h0 + sh, H),
                                                            w0:min(w0 + sw, W)], cfg).float()
                if values is None:
                    f = out.shape[2] // min(sh, H)
                    shape = (T // cfg.latent_len * cfg.frame_len, H * f, W * f)
                    values = torch.zeros((b, *shape, 3), dtype=torch.float32,
                                         device=latents.device)
                    weight = torch.zeros((1, *shape, 1), dtype=torch.float32,
                                         device=latents.device)
                mh = _blend_mask_1d(out.shape[2], h0 == 0, h0 + sh >= H, max((sh - rh) * f, 1))
                mw = _blend_mask_1d(out.shape[3], w0 == 0, w0 + sw >= W, max((sw - rw) * f, 1))
                mask = torch.from_numpy(np.minimum(mh[:, None], mw[None, :])).to(
                    latents.device)[None, None, :, :, None]
                tt, th, tw = t0 // cfg.latent_len * cfg.frame_len, h0 * f, w0 * f
                region = (slice(None), slice(tt, tt + out.shape[1]),
                          slice(th, th + out.shape[2]), slice(tw, tw + out.shape[3]))
                values[region] += out * mask
                weight[region] += mask
                del out
    return values / weight


# ---------------------------------------------------------------------------
# Random init (the JAX package draws only a tiny decoder, with numpy)
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_stepvideo_vae(cfg: StepVideoVAEConfig, gen: torch.Generator, dtype=torch.float32,
                       *, device, encoder: bool = True, decoder: bool = True) -> StepVideoVAE:
    """Uniform +-1/sqrt(fan_in) conv weights, zero biases, unit norms; drawn from `gen`."""
    model = empty_module(StepVideoVAE, cfg, encoder, decoder, dtype=dtype, device=device)
    for m in model.modules():
        if isinstance(m, (nn.Conv3d, nn.Conv2d)):
            s = 1.0 / math.sqrt(m.weight[0].numel())
            m.weight.uniform_(-s, s, generator=gen)
            m.bias.zero_()
        elif isinstance(m, LayerNormAffine):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return model.eval().requires_grad_(False)
