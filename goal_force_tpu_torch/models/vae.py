"""Wan2.1 3D causal video VAE in PyTorch.

Port of ``goal_force_tpu/models/vae.py`` (the closed form of the causal VAE):

  - stride-1 causal conv (kernel 3): full-sequence conv with 2 leading zero frames;
  - encoder temporal downsample (kernel 3, stride 2, no pad): concat([x[:1], conv_s2(x)]);
  - decoder temporal upsample (kernel 3, stride 1, 2x channels):
        concat([z[:1], interleave2(conv([0, 0, z_1..z_{T-1}]))]).

The public functions take and return channels-last (B, T, H, W, C) tensors as the JAX
package does; inside, activations are channels-first (B, C, T, H, W), the layout of
torch's convolutions and of the reference's RMS_norm gammas. Every conv casts its
weight to the activation's dtype, so float32 pixels run the VAE in float32 whatever
dtype the weights are stored in. The mid-block attention is a plain einsum.
Parameter names follow the reference ``Wan2.1_VAE.pth`` (without its ``model.`` prefix).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from goal_force_tpu_torch.configs import VAE_LATENT_MEAN, VAE_LATENT_STD, VAEConfig
from goal_force_tpu_torch.models.wan_dit import Activation, empty_module


# ---------------------------------------------------------------------------
# Modules (parameter holders under the reference names)
# ---------------------------------------------------------------------------

class RMSNormC(nn.Module):
    """Channel RMS norm; gamma is (C, 1, 1, 1) for video and (C, 1, 1) for images."""

    def __init__(self, dim: int, images: bool = False):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones((dim, 1, 1) if images else (dim, 1, 1, 1)))


class ResidualBlock(nn.Module):
    def __init__(self, din: int, dout: int):
        super().__init__()
        self.residual = nn.Sequential(
            RMSNormC(din), Activation(), nn.Conv3d(din, dout, 3),
            RMSNormC(dout), Activation(), Activation(), nn.Conv3d(dout, dout, 3))
        self.shortcut = nn.Conv3d(din, dout, 1) if din != dout else None


class AttentionBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = RMSNormC(dim, images=True)
        self.to_qkv = nn.Conv2d(dim, dim * 3, 1)
        self.proj = nn.Conv2d(dim, dim, 1)


class Resample(nn.Module):
    def __init__(self, din: int, dout: int, time_cout: int = 0):
        super().__init__()
        self.resample = nn.Sequential(Activation(), nn.Conv2d(din, dout, 3))
        self.time_conv = nn.Conv3d(din, time_cout, (3, 1, 1)) if time_cout else None


def _head(dim: int, cout: int) -> nn.Sequential:
    return nn.Sequential(RMSNormC(dim), Activation(), nn.Conv3d(dim, cout, 3))


def _plan_modules(plan, decoder: bool) -> nn.ModuleList:
    mods = []
    for op in plan:
        kind = op[0]
        if kind == "res":
            mods.append(ResidualBlock(op[1], op[2]))
        elif kind in ("down2d", "down3d"):
            d = op[1]
            mods.append(Resample(d, d, d if kind == "down3d" else 0))
        else:
            d = op[1]
            mods.append(Resample(d, d // 2, 2 * d if kind == "up3d" else 0))
    return nn.ModuleList(mods)


def encoder_plan(cfg: VAEConfig) -> List[Tuple]:
    """Static module plan of the encoder's downsamples."""
    dims = [cfg.dim * u for u in (1,) + tuple(cfg.dim_mult)]
    plan = []
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        for _ in range(cfg.num_res_blocks):
            plan.append(("res", din, dout))
            din = dout
        if i != len(cfg.dim_mult) - 1:
            plan.append(("down3d" if cfg.temporal_downsample[i] else "down2d", dout))
    return plan


def decoder_plan(cfg: VAEConfig) -> List[Tuple]:
    """Static module plan of the decoder's upsamples."""
    dims = [cfg.dim * u for u in (cfg.dim_mult[-1],) + tuple(reversed(cfg.dim_mult))]
    plan = []
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        if i in (1, 2, 3):
            din = din // 2
        for _ in range(cfg.num_res_blocks + 1):
            plan.append(("res", din, dout))
            din = dout
        if i != len(cfg.dim_mult) - 1:
            plan.append(("up3d" if cfg.temporal_upsample[i] else "up2d", dout))
    return plan


class Encoder3d(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        top = cfg.dim * cfg.dim_mult[-1]
        self.conv1 = nn.Conv3d(3, cfg.dim, 3)
        self.downsamples = _plan_modules(encoder_plan(cfg), decoder=False)
        self.middle = nn.ModuleList([ResidualBlock(top, top), AttentionBlock(top),
                                     ResidualBlock(top, top)])
        self.head = _head(top, cfg.z_dim * 2)


class Decoder3d(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        top = cfg.dim * cfg.dim_mult[-1]
        self.conv1 = nn.Conv3d(cfg.z_dim, top, 3)
        self.middle = nn.ModuleList([ResidualBlock(top, top), AttentionBlock(top),
                                     ResidualBlock(top, top)])
        self.upsamples = _plan_modules(decoder_plan(cfg), decoder=True)
        self.head = _head(cfg.dim, 3)


class WanVAE(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder3d(cfg)
        self.decoder = Decoder3d(cfg)
        self.conv1 = nn.Conv3d(cfg.z_dim * 2, cfg.z_dim * 2, 1)
        self.conv2 = nn.Conv3d(cfg.z_dim, cfg.z_dim, 1)


# ---------------------------------------------------------------------------
# Primitive ops (channels-first activations)
# ---------------------------------------------------------------------------

def causal_conv3d(conv: nn.Conv3d, x, t_stride: int = 1, causal_pad: bool = True,
                  split=None):
    """Conv3d with 2*(kt//2) zero frames in front (none with causal_pad=False) and
    symmetric spatial zero padding; over a rank's block of a spatial split
    (``parallel/spatial.py``) the padding along a split axis is the neighbours' halo."""
    kt, kh, kw = conv.weight.shape[2:]
    pt = 2 * (kt // 2) if causal_pad else 0
    if pt:
        x = F.pad(x, (0, 0, 0, 0, pt, 0))
    w, b = conv.weight.to(x.dtype), conv.bias.to(x.dtype)
    if split is not None:
        return split.conv(x, w, b, (t_stride, 1, 1), (0, kh // 2, kw // 2))
    return F.conv3d(x, w, b, stride=(t_stride, 1, 1), padding=(0, kh // 2, kw // 2))


def spatial_norm(p: RMSNormC, x, eps: float = 1e-12):
    """F.normalize over channels * sqrt(C) * gamma (in float32, cast back first). The
    scale sqrt(C) / |x| is formed per pixel, so the activation is read and written twice."""
    xf = x.float()
    r = math.sqrt(x.shape[1]) / torch.linalg.vector_norm(xf, dim=1, keepdim=True).clamp_min(eps)
    return (xf * r).to(x.dtype) * p.gamma.to(x.dtype)


def norm_silu(p: RMSNormC, x):
    """silu(spatial_norm(p, x)) in float32; in place on the norm's output where that is
    float32 and outside autograd."""
    h = spatial_norm(p, x)
    if h.dtype == torch.float32 and not h.requires_grad:
        return F.silu(h, inplace=True)
    return F.silu(h.float()).to(h.dtype)


def residual_block(p: ResidualBlock, x, split=None):
    h = x if p.shortcut is None else causal_conv3d(p.shortcut, x, split=split)
    r = p.residual
    y = causal_conv3d(r[2], norm_silu(r[0], x), split=split)
    y = causal_conv3d(r[6], norm_silu(r[3], y), split=split)
    return y + h


def attention_block(p: AttentionBlock, x, split=None):
    """Single-head per-frame spatial attention. x: (B, C, T, H, W). Over a rank's block
    of a spatial split its pixels are the queries, and the keys and values of every
    rank's block are gathered."""
    b, c, t, hh, ww = x.shape
    h = x.permute(0, 2, 1, 3, 4).reshape(b * t, c, hh, ww)
    h = spatial_norm(p.norm, h)
    w_qkv, b_qkv = p.to_qkv.weight.to(h.dtype), p.to_qkv.bias.to(h.dtype)
    qkv = F.conv2d(h, w_qkv, b_qkv) if split is None else split.conv(h, w_qkv, b_qkv, (1, 1),
                                                                     (0, 0))
    qkv = qkv.reshape(b * t, 3, c, hh * ww).transpose(2, 3)       # (BT, 3, HW, C)
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    if split is not None and split.split_any:
        kv = split.gather(qkv[:, 1:].reshape(b * t, 2, hh, ww, c))
        k, v = kv.flatten(2, 3).unbind(1)
    logits = torch.einsum("bsc,btc->bst", q.float(), k.float())
    probs = torch.softmax(logits * (c**-0.5), dim=-1).to(x.dtype)
    out = torch.einsum("bst,btc->bsc", probs, v).transpose(1, 2).reshape(b * t, c, hh, ww)
    w_o, b_o = p.proj.weight.to(out.dtype), p.proj.bias.to(out.dtype)
    out = F.conv2d(out, w_o, b_o) if split is None else split.conv(out, w_o, b_o, (1, 1), (0, 0))
    return x + out.reshape(b, t, c, hh, ww).permute(0, 2, 1, 3, 4)


MID_ATTENTION_ROWS = 8192     # query rows per block of a masked mid attention


def masked_mid_attention(q, k, v, scale: float, visible) -> torch.Tensor:
    """Single-head attention of (B, S, C) tensors with a causal mask, over blocks of
    ``MID_ATTENTION_ROWS`` query rows (the HunyuanVideo and StepVideo VAEs' mid blocks
    hold up to ~42k tokens, whose whole float32 logits would take GBs). ``visible(s0, s1)``
    gives the (s1 - s0, n) bool mask of the keys 0..n-1 that rows s0..s1-1 see; the keys
    from n on are masked for all of them and are not read. A masked logit is float32's
    finfo.min and each row's softmax stays whole, so the function is that of one block."""
    out = torch.empty_like(q)
    for s0 in range(0, q.shape[1], MID_ATTENTION_ROWS):
        s1 = min(q.shape[1], s0 + MID_ATTENTION_ROWS)
        ok = visible(s0, s1)
        n = ok.shape[1]
        logits = torch.einsum("bqc,bkc->bqk", q[:, s0:s1], k[:, :n]) * scale
        logits = torch.where(ok[None], logits.float(), torch.finfo(torch.float32).min)
        probs = torch.softmax(logits, -1).to(v.dtype)
        del logits
        out[:, s0:s1] = torch.einsum("bqk,bkc->bqc", probs, v[:, :n])
        del probs
    return out


def _conv2d_frames(conv: nn.Conv2d, x, stride: int = 1, padding=(1, 1)):
    """A 2D conv applied to every frame of (B, C, T, H, W)."""
    w = conv.weight.to(x.dtype)[:, :, None]
    return F.conv3d(x, w, conv.bias.to(x.dtype), stride=(1, stride, stride),
                    padding=(0, *padding))


def downsample_spatial(p: Resample, x, split=None):
    """ZeroPad2d((0,1,0,1)) + conv 3x3 stride 2; over a rank's block of a spatial split
    the padding row and column come from the neighbours below and to the right."""
    if split is None:
        return _conv2d_frames(p.resample[1], F.pad(x, (0, 1, 0, 1)), stride=2, padding=(0, 0))
    conv = p.resample[1]
    return split.conv(split.pad_after(x), conv.weight.to(x.dtype)[:, :, None],
                      conv.bias.to(x.dtype), (1, 2, 2), (0, 0, 0))


def upsample_spatial(p: Resample, x):
    """Nearest 2x (an exact pixel repeat) + conv 3x3."""
    x = x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)
    return _conv2d_frames(p.resample[1], x)


def downsample3d_time(conv: nn.Conv3d, x, split=None):
    """Frame 0, then the stride-2 conv over the frames without causal padding (nothing
    where there are fewer frames than the kernel: one frame encodes as itself)."""
    if x.shape[2] < conv.weight.shape[2]:
        return x[:, :, :1]
    tail = causal_conv3d(conv, x, t_stride=2, causal_pad=False, split=split)
    return torch.cat([x[:, :, :1], tail], dim=2)


def upsample3d_time(conv: nn.Conv3d, x):
    b, c, t, hh, ww = x.shape
    if t == 1:
        return x
    y = causal_conv3d(conv, x[:, :, 1:])                           # (B, 2C, T-1, H, W)
    y = y.reshape(b, 2, c, t - 1, hh, ww).permute(0, 2, 3, 1, 4, 5)
    y = y.reshape(b, c, 2 * (t - 1), hh, ww)
    return torch.cat([x[:, :, :1], y], dim=2)


def _run_plan(plan, mods, x, split=None):
    """The plan's modules in turn; a spatial split (encoder only) moves to the next level
    after each spatial downsample."""
    for op, p in zip(plan, mods):
        kind = op[0]
        if kind == "res":
            x = residual_block(p, x, split)
        elif kind in ("down2d", "down3d"):
            x = downsample_spatial(p, x, split)
            if split is not None:
                split.halve()
            if kind == "down3d":
                x = downsample3d_time(p.time_conv, x, split)
        elif kind == "up2d":
            x = upsample_spatial(p, x)
        elif kind == "up3d":
            x = upsample_spatial(p, upsample3d_time(p.time_conv, x))
    return x


def _to_cf(x):
    return x.permute(0, 4, 1, 2, 3)


def _to_cl(x):
    return x.permute(0, 2, 3, 4, 1)


# ---------------------------------------------------------------------------
# Encoder / decoder (channels-last in and out)
# ---------------------------------------------------------------------------

def encode(vae: WanVAE, cfg: VAEConfig, video, split=None):
    """video (B, T, H, W, 3) in [-1,1], T = 1+4k -> unscaled mu (B, 1+k, H/8, W/8, z).

    split: a ``parallel/spatial.py::SpatialSplit`` at the pixels' level, whose rank's
    block `video` is: the result is then that rank's block of the latents, and the split
    is left at their level."""
    if video.shape[1] % 4 != 1:
        raise ValueError(f"encode expects T = 1+4k frames, got T={video.shape[1]}")
    enc = vae.encoder
    x = causal_conv3d(enc.conv1, _to_cf(video), split=split)
    x = _run_plan(encoder_plan(cfg), enc.downsamples, x, split)
    x = residual_block(enc.middle[0], x, split)
    x = attention_block(enc.middle[1], x, split)
    x = residual_block(enc.middle[2], x, split)
    x = causal_conv3d(enc.head[2], norm_silu(enc.head[0], x), split=split)
    moments = causal_conv3d(vae.conv1, x, split=split)
    return _to_cl(moments[:, : cfg.z_dim])


def decode(vae: WanVAE, cfg: VAEConfig, z):
    """unscaled latents (B, L, h, w, z) -> video (B, 4L-3, 8h, 8w, 3), unclamped."""
    dec = vae.decoder
    x = causal_conv3d(vae.conv2, _to_cf(z))
    x = causal_conv3d(dec.conv1, x)
    x = residual_block(dec.middle[0], x)
    x = attention_block(dec.middle[1], x)
    x = residual_block(dec.middle[2], x)
    x = _run_plan(decoder_plan(cfg), dec.upsamples, x)
    x = causal_conv3d(dec.head[2], norm_silu(dec.head[0], x))
    return _to_cl(x)


def latent_scale(cfg: VAEConfig, dtype, device):
    if cfg.z_dim == 16:
        mean = torch.tensor(VAE_LATENT_MEAN, dtype=dtype, device=device)
        std = torch.tensor(VAE_LATENT_STD, dtype=dtype, device=device)
    else:  # tiny/test configs
        mean = torch.zeros(cfg.z_dim, dtype=dtype, device=device)
        std = torch.ones(cfg.z_dim, dtype=dtype, device=device)
    return mean, std


def encode_video(vae: WanVAE, cfg: VAEConfig, video, split=None):
    """Scaled encode: (mu - mean) / std (of a rank's block under a spatial split)."""
    mu = encode(vae, cfg, video, split)
    mean, std = latent_scale(cfg, mu.dtype, mu.device)
    return (mu - mean) / std


def decode_video(vae: WanVAE, cfg: VAEConfig, latents):
    """Scaled decode, clamped to [-1, 1]."""
    mean, std = latent_scale(cfg, latents.dtype, latents.device)
    return torch.clamp(decode(vae, cfg, latents * std + mean), -1.0, 1.0)


# ---------------------------------------------------------------------------
# Spatially tiled encode/decode
# ---------------------------------------------------------------------------

def _blend_mask_1d(length: int, left_bound: bool, right_bound: bool, border: int) -> np.ndarray:
    x = np.ones((length,), np.float32)
    if not left_bound:
        x[:border] = (np.arange(border) + 1) / border
    if not right_bound:
        x[-border:] = np.flip((np.arange(border) + 1) / border)
    return x


def _tile_tasks(size: int, tile: int, stride: int):
    out = []
    for a in range(0, size, stride):
        if a - stride >= 0 and a - stride + tile >= size:
            continue
        out.append((a, a + tile))
    return out


def tiled_apply(fn, x, tile_hw, stride_hw, scale: float, out_channels: int, out_t: int):
    """Overlap-blend spatial tiling shared by encode (scale=1/8) and decode (scale=8).
    x: (B, T, H, W, C); fn maps a spatial crop to its coded counterpart."""
    b, t, H, W, _ = x.shape
    oh, ow = int(H * scale), int(W * scale)
    values = torch.zeros((b, out_t, oh, ow, out_channels), dtype=torch.float32, device=x.device)
    weight = torch.zeros((1, 1, oh, ow, 1), dtype=torch.float32, device=x.device)
    th, tw = tile_hw
    sh, sw = stride_hw
    for h0, h1 in _tile_tasks(H, th, sh):
        for w0, w1 in _tile_tasks(W, tw, sw):
            out = fn(x[:, :, h0:min(h1, H), w0:min(w1, W), :]).float()
            bh, bw = int((th - sh) * scale), int((tw - sw) * scale)
            mh = _blend_mask_1d(out.shape[2], h0 == 0, h1 >= H, bh)
            mw = _blend_mask_1d(out.shape[3], w0 == 0, w1 >= W, bw)
            mask = torch.from_numpy(np.minimum(mh[:, None], mw[None, :])[None, None, :, :, None]
                                    ).to(x.device)
            to_h, to_w = int(h0 * scale), int(w0 * scale)
            values[:, :, to_h:to_h + out.shape[2], to_w:to_w + out.shape[3]] += out * mask
            weight[:, :, to_h:to_h + out.shape[2], to_w:to_w + out.shape[3]] += mask
            del out
    return values / weight


def encode_video_tiled(vae: WanVAE, cfg: VAEConfig, video, tile_size=(34, 34),
                       tile_stride=(18, 16)):
    """Tile sizes in latent units."""
    f = cfg.upsampling_factor
    out_t = (video.shape[1] + 3) // 4
    return tiled_apply(lambda crop: encode_video(vae, cfg, crop), video,
                       (tile_size[0] * f, tile_size[1] * f),
                       (tile_stride[0] * f, tile_stride[1] * f), 1.0 / f, cfg.z_dim, out_t)


def decode_video_tiled(vae: WanVAE, cfg: VAEConfig, latents, tile_size=(34, 34),
                       tile_stride=(18, 16)):
    out_t = latents.shape[1] * 4 - 3
    out = tiled_apply(lambda crop: decode_video(vae, cfg, crop), latents, tile_size,
                      tile_stride, float(cfg.upsampling_factor), 3, out_t)
    return torch.clamp(out, -1.0, 1.0)


# ---------------------------------------------------------------------------
# Random init (the JAX package's distributions)
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_vae(cfg: VAEConfig, gen: torch.Generator, dtype=torch.float32, *,
             device) -> WanVAE:
    """Uniform +-1/sqrt(fan_in) conv weights, zero biases, unit gammas, zero-init
    attention projections."""
    vae = empty_module(WanVAE, cfg, dtype=dtype, device=device)
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
