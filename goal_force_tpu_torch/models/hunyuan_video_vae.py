"""HunyuanVideo 3D causal VAE (16 channels, 8x spatial, 4x temporal) in PyTorch.

Port of ``goal_force_tpu/models/hunyuan_video_vae.py``: CausalConv3d with replicate
padding (k - 1 leading frames, k // 2 on each spatial side), the strided causal
downsamples, the nearest upsample that leaves frame 0 un-repeated in time, the causal
ResNet blocks, the mid block's single-head attention over all (T, H, W) tokens under a
frame-causal mask (plain torch, as JAX computes it in XLA; chunked over query rows, which
keeps each row's softmax whole), the [128, 256, 512, 512] encoder and decoder stacks,
scaling factor 0.476986, and the overlap-blend tiled encode and decode.

The public functions take and return channels-last (B, T, H, W, C) tensors, as JAX's;
inside, activations are channels-first (B, C, T, H, W), the layout torch's conv3d takes.
As in JAX, a conv runs in its input's dtype (the weights cast to it) and a matmul in
the promoted dtype of input and weights: a float32 video encodes in float32 with bf16
weights, and bf16 latents decode in bf16.
The modules hold the parameters under the reference ("diffsynth") encoder and decoder
state-dict names that JAX ``hunyuan_vae_{encoder,decoder}_params_from_torch`` read
(``encoder.*`` + ``quant_conv``, ``decoder.*`` + ``post_quant_conv``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from goal_force_tpu_torch.models.vae import masked_mid_attention
from goal_force_tpu_torch.models.wan_dit import LayerNormAffine, empty_module


@dataclasses.dataclass(frozen=True)
class HunyuanVAEConfig:
    in_channels: int = 3
    z_dim: int = 16
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    num_groups: int = 32
    eps: float = 1e-6
    time_ratio: int = 4
    spatial_ratio: int = 8
    scaling_factor: float = 0.476986


def tiny_hunyuan_vae_config():
    return HunyuanVAEConfig(block_out_channels=(8, 8, 16, 16), layers_per_block=1,
                            num_groups=4)


# ---------------------------------------------------------------------------
# Modules (parameter holders under the reference names)
# ---------------------------------------------------------------------------

class CausalConv(nn.Module):
    """The reference CausalConv3d: its Conv3d under ``.conv``."""

    def __init__(self, cin: int, cout: int, k: int = 3):
        super().__init__()
        self.conv = nn.Conv3d(cin, cout, k)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = LayerNormAffine(cin)
        self.conv1 = CausalConv(cin, cout)
        self.norm2 = LayerNormAffine(cout)
        self.conv2 = CausalConv(cout, cout)
        if cin != cout:
            self.conv_shortcut = CausalConv(cin, cout, 1)


class MidAttention(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.group_norm = LayerNormAffine(c)
        self.to_q = nn.Linear(c, c)
        self.to_k = nn.Linear(c, c)
        self.to_v = nn.Linear(c, c)
        self.to_out = nn.ModuleList([nn.Linear(c, c)])


class MidBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(c, c), ResnetBlock(c, c)])
        self.attentions = nn.ModuleList([MidAttention(c)])


class Resample(nn.Module):
    """``downsamplers.0`` / ``upsamplers.0``: a causal conv under ``.conv``."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = CausalConv(c, c)


class Stage(nn.Module):
    def __init__(self, cin: int, cout: int, n_res: int, resample: str = ""):
        super().__init__()
        self.resnets = nn.ModuleList(ResnetBlock(cin if j == 0 else cout, cout)
                                     for j in range(n_res))
        if resample:
            setattr(self, resample, nn.ModuleList([Resample(cout)]))


def _stage_plan(cfg: HunyuanVAEConfig) -> List[Tuple[int, bool, bool]]:
    """Per level (out_channels, spatial resample, temporal resample): spatial on the
    first log2(spatial_ratio) levels, temporal on the log2(time_ratio) levels before
    the last; the last level never resamples. The decoder walks the same plan on the
    reversed channels."""
    n = len(cfg.block_out_channels)
    n_sp = int(math.log2(cfg.spatial_ratio))
    n_t = int(math.log2(cfg.time_ratio))
    return [(cfg.block_out_channels[i], i < n_sp, (i >= n - 1 - n_t) and i != n - 1)
            for i in range(n)]


class Encoder(nn.Module):
    def __init__(self, cfg: HunyuanVAEConfig):
        super().__init__()
        ch = cfg.block_out_channels
        self.conv_in = CausalConv(cfg.in_channels, ch[0])
        stages, cin = [], ch[0]
        for cout, sp, tm in _stage_plan(cfg):
            stages.append(Stage(cin, cout, cfg.layers_per_block,
                                "downsamplers" if sp or tm else ""))
            cin = cout
        self.down_blocks = nn.ModuleList(stages)
        self.mid_block = MidBlock(ch[-1])
        self.conv_norm_out = LayerNormAffine(ch[-1])
        self.conv_out = CausalConv(ch[-1], 2 * cfg.z_dim)


class Decoder(nn.Module):
    def __init__(self, cfg: HunyuanVAEConfig):
        super().__init__()
        ch = tuple(reversed(cfg.block_out_channels))
        self.conv_in = CausalConv(cfg.z_dim, ch[0])
        self.mid_block = MidBlock(ch[0])
        stages, cin = [], ch[0]
        for i, (_, sp, tm) in enumerate(_stage_plan(cfg)):
            stages.append(Stage(cin, ch[i], cfg.layers_per_block + 1,
                                "upsamplers" if sp or tm else ""))
            cin = ch[i]
        self.up_blocks = nn.ModuleList(stages)
        self.conv_norm_out = LayerNormAffine(ch[-1])
        self.conv_out = CausalConv(ch[-1], cfg.in_channels)


class HunyuanVAEEncoder(nn.Module):
    def __init__(self, cfg: HunyuanVAEConfig):
        super().__init__()
        self.encoder = Encoder(cfg)
        self.quant_conv = nn.Conv3d(2 * cfg.z_dim, 2 * cfg.z_dim, 1)


class HunyuanVAEDecoder(nn.Module):
    def __init__(self, cfg: HunyuanVAEConfig):
        super().__init__()
        self.decoder = Decoder(cfg)
        self.post_quant_conv = nn.Conv3d(cfg.z_dim, cfg.z_dim, 1)


# ---------------------------------------------------------------------------
# Primitives (channels-first inside)
# ---------------------------------------------------------------------------

GROUP_NORM_F32_BYTES = 1 << 30    # the float32 copy of the groups normalized at once


def _group_norm(p: LayerNormAffine, x: torch.Tensor, groups: int, eps: float) -> torch.Tensor:
    """GroupNorm over (C/groups, T, H, W) in float32, the affine in float32. A tensor
    whose float32 copy passes ``GROUP_NORM_F32_BYTES`` goes a few groups at a time into
    its output, so its float32 temporaries stay near that size (CogVideoX's untiled
    decode holds 4.3e9-element activations)."""
    shape = (1, x.shape[1]) + (1,) * (x.dim() - 2)
    w, b = p.weight.reshape(shape), p.bias.reshape(shape)
    step = max(1, groups * GROUP_NORM_F32_BYTES // (4 * x.numel()))
    if step >= groups:
        return _norm_groups(x, w, b, groups, eps)
    out = torch.empty_like(x)
    cg = x.shape[1] // groups
    for g0 in range(0, groups, step):
        ch = slice(g0 * cg, min(groups, g0 + step) * cg)
        out[:, ch] = _norm_groups(x[:, ch], w[:, ch], b[:, ch], min(step, groups - g0), eps)
    return out


def _norm_groups(x, w, b, groups: int, eps: float):
    xf = x.float().reshape(x.shape[0], groups, -1)
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    xf = ((xf - mu) * torch.rsqrt(var + eps)).reshape(x.shape)
    return (xf * w + b).to(x.dtype)


def _dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x @ w.T + b in the promoted dtype of x and w (JAX's matmul promotion)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return F.linear(x.to(dt), w.to(dt), b.to(dt))


def causal_conv3d(p: CausalConv, x: torch.Tensor, stride=(1, 1, 1)) -> torch.Tensor:
    """Replicate pad (k - 1, 0) in time and (k // 2, k // 2) spatially, then the conv."""
    w = p.conv.weight
    kt, kh, kw = w.shape[2:]
    if kt > 1 or kh > 1 or kw > 1:
        x = F.pad(x, (kw // 2, kw // 2, kh // 2, kh // 2, kt - 1, 0), mode="replicate")
    return F.conv3d(x, w.to(x.dtype), p.conv.bias.to(x.dtype), stride)


def _silu_norm(p, x, cfg):
    return F.silu(_group_norm(p, x, cfg.num_groups, cfg.eps))


def _resnet(p: ResnetBlock, x, cfg: HunyuanVAEConfig):
    h = causal_conv3d(p.conv1, _silu_norm(p.norm1, x, cfg))
    h = causal_conv3d(p.conv2, _silu_norm(p.norm2, h, cfg))
    if hasattr(p, "conv_shortcut"):
        x = causal_conv3d(p.conv_shortcut, x)
    return x + h


def _mid_attention(p: MidAttention, x, cfg: HunyuanVAEConfig):
    """Single-head attention over all tokens; token i sees the tokens of its own frame
    and the frames before it (logits elsewhere at float32's finfo.min)."""
    b, c, t, h, w = x.shape
    tokens = _group_norm(p.group_norm, x, cfg.num_groups, cfg.eps)
    tokens = tokens.reshape(b, c, t * h * w).transpose(1, 2)
    q = _dense(tokens, p.to_q.weight, p.to_q.bias)
    k = _dense(tokens, p.to_k.weight, p.to_k.bias)
    v = _dense(tokens, p.to_v.weight, p.to_v.bias)
    frame = torch.arange(t * h * w, device=x.device) // (h * w)
    out = masked_mid_attention(q, k, v, 1.0 / math.sqrt(c),
                               lambda s0, s1: frame[None, :] <= frame[s0:s1, None])
    out = _dense(out, p.to_out[0].weight, p.to_out[0].bias)
    return x + out.transpose(1, 2).reshape(b, c, t, h, w)


def _mid_block(p: MidBlock, x, cfg: HunyuanVAEConfig):
    x = _resnet(p.resnets[0], x, cfg)
    for attn, res in zip(p.attentions, p.resnets[1:]):
        x = _mid_attention(attn, x, cfg)
        x = _resnet(res, x, cfg)
    return x


def _upsample(p: Resample, x, factor):
    """Nearest upsample: frame 0 only spatially, the rest by the full (t, h, w) factor;
    then the causal conv."""
    ft, fh, fw = factor
    x = x.repeat_interleave(fh, dim=3).repeat_interleave(fw, dim=4)
    if x.shape[2] > 1 and ft > 1:
        x = torch.cat([x[:, :, :1], x[:, :, 1:].repeat_interleave(ft, dim=2)], dim=2)
    return causal_conv3d(p.conv, x)


def _to_cf(x):
    return x.permute(0, 4, 1, 2, 3)


def _to_cl(x):
    return x.permute(0, 2, 3, 4, 1)


def hunyuan_vae_encode(model: HunyuanVAEEncoder, video: torch.Tensor,
                       cfg: HunyuanVAEConfig = HunyuanVAEConfig()) -> torch.Tensor:
    """(B, T, H, W, 3) in [-1, 1] -> (B, (T-1)//4+1, H/8, W/8, 16) scaled means."""
    enc = model.encoder
    x = causal_conv3d(enc.conv_in, _to_cf(video))
    for blk, (_, sp, tm) in zip(enc.down_blocks, _stage_plan(cfg)):
        for res in blk.resnets:
            x = _resnet(res, x, cfg)
        if hasattr(blk, "downsamplers"):
            x = causal_conv3d(blk.downsamplers[0].conv, x,
                              (2 if tm else 1, 2 if sp else 1, 2 if sp else 1))
    x = _mid_block(enc.mid_block, x, cfg)
    x = causal_conv3d(enc.conv_out, _silu_norm(enc.conv_norm_out, x, cfg))
    # quant_conv is a plain (non-causal) 1x1x1 Conv3d
    qc = model.quant_conv
    x = _dense(_to_cl(x), qc.weight[:, :, 0, 0, 0], qc.bias)
    return x[..., :cfg.z_dim] * cfg.scaling_factor


def hunyuan_vae_decode(model: HunyuanVAEDecoder, latents: torch.Tensor,
                       cfg: HunyuanVAEConfig = HunyuanVAEConfig()) -> torch.Tensor:
    """(B, lt, h, w, 16) -> (B, (lt-1)*4+1, 8h, 8w, 3), unclamped."""
    dec = model.decoder
    pq = model.post_quant_conv
    x = _dense(latents / cfg.scaling_factor, pq.weight[:, :, 0, 0, 0], pq.bias)
    x = causal_conv3d(dec.conv_in, _to_cf(x))
    x = _mid_block(dec.mid_block, x, cfg)
    for blk, (_, sp, tm) in zip(dec.up_blocks, _stage_plan(cfg)):
        for res in blk.resnets:
            x = _resnet(res, x, cfg)
        if hasattr(blk, "upsamplers"):
            x = _upsample(blk.upsamplers[0], x, (2 if tm else 1, 2 if sp else 1,
                                                 2 if sp else 1))
    return _to_cl(causal_conv3d(dec.conv_out, _silu_norm(dec.conv_norm_out, x, cfg)))


# ---------------------------------------------------------------------------
# Tiled encode/decode (overlap-blend)
# ---------------------------------------------------------------------------

def _blend_mask(shape, is_bound, border) -> np.ndarray:
    def ramp(n, left_b, right_b, bw):
        m = np.ones((n,), np.float32)
        bw = max(1, min(bw, n))
        if not left_b:
            m[:bw] = (np.arange(bw) + 1) / bw
        if not right_b:
            m[-bw:] = np.flip((np.arange(bw) + 1) / bw)
        return m

    t, h, w = shape
    mt = ramp(t, is_bound[0], is_bound[1], border[0])
    mh = ramp(h, is_bound[2], is_bound[3], border[1])
    mw = ramp(w, is_bound[4], is_bound[5], border[2])
    return np.minimum.reduce(np.broadcast_arrays(
        mt[:, None, None], mh[None, :, None], mw[None, None, :]))[..., None]


def _tile_starts(size: int, tile: int, stride: int) -> List[int]:
    """Tile origins every `stride`, without a tile that the one before already covers
    to the end."""
    return [a for a in range(0, size, stride) if not (a - stride >= 0 and a - stride + tile >= size)]


def _tiled(fn, x, tile_size, tile_stride, out_shape, scale_t, scale_s, border):
    """Overlap-blend of fn over (T, H, W) tiles of x (B, T, H, W, C): a tile past the
    first in time drops its first output frame; float32 sums on x's device."""
    b, T, H, W, _ = x.shape
    st, sh, sw = tile_size
    rt, rh, rw = tile_stride
    values = torch.zeros((b, *out_shape), dtype=torch.float32, device=x.device)
    weight = torch.zeros((1, *out_shape[:3], 1), dtype=torch.float32, device=x.device)
    for t0 in _tile_starts(T, st, rt):
        for h0 in _tile_starts(H, sh, rh):
            for w0 in _tile_starts(W, sw, rw):
                out = fn(x[:, t0:t0 + st, h0:h0 + sh, w0:w0 + sw]).float()
                if t0 > 0:
                    out = out[:, 1:]
                mask = torch.from_numpy(_blend_mask(
                    out.shape[1:4], (t0 == 0, t0 + st >= T, h0 == 0, h0 + sh >= H,
                                     w0 == 0, w0 + sw >= W), border)).to(x.device)
                tt = 0 if t0 == 0 else scale_t(t0)
                th, tw = int(h0 * scale_s), int(w0 * scale_s)
                region = (slice(None), slice(tt, tt + out.shape[1]),
                          slice(th, th + out.shape[2]), slice(tw, tw + out.shape[3]))
                values[region] += out * mask
                weight[region] += mask
                del out
    return values / weight


def hunyuan_vae_encode_tiled(model: HunyuanVAEEncoder, video, cfg=HunyuanVAEConfig(),
                             tile_size=(65, 256, 256), tile_stride=(48, 192, 192)):
    """Overlap-blend in latent space; a temporally overlapping tile drops its first
    latent frame. Returns float32 latents on video's device."""
    b, T, H, W, _ = video.shape
    st, sh, sw = tile_size
    rt, rh, rw = tile_stride
    out_shape = ((T - 1) // 4 + 1, H // 8, W // 8, cfg.z_dim)
    return _tiled(lambda tile: hunyuan_vae_encode(model, tile, cfg), video, tile_size,
                  tile_stride, out_shape, lambda t0: t0 // 4 + 1, 1 / 8,
                  ((st - rt) // 4, (sh - rh) // 8, (sw - rw) // 8))


def hunyuan_vae_decode_tiled(model: HunyuanVAEDecoder, latents, cfg=HunyuanVAEConfig(),
                             tile_size=(17, 32, 32), tile_stride=(12, 24, 24)):
    """Overlap-blend in pixel space; a temporally overlapping tile drops its first
    frame. Returns float32 frames on latents' device."""
    b, LT, LH, LW, _ = latents.shape
    st, sh, sw = tile_size
    rt, rh, rw = tile_stride
    out_shape = ((LT - 1) * 4 + 1, LH * 8, LW * 8, 3)
    return _tiled(lambda tile: hunyuan_vae_decode(model, tile, cfg), latents, tile_size,
                  tile_stride, out_shape, lambda t0: t0 * 4 + 1, 8,
                  ((st - rt) * 4, (sh - rh) * 8, (sw - rw) * 8))


# ---------------------------------------------------------------------------
# Random init (the JAX package has none: its weights come from a file)
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_hunyuan_vae(cls, cfg: HunyuanVAEConfig, gen: torch.Generator, dtype=torch.float32,
                     *, device):
    """`cls` (HunyuanVAEEncoder or HunyuanVAEDecoder) with uniform +-1/sqrt(fan_in)
    conv and linear weights, zero biases, unit norms; drawn from `gen`."""
    model = empty_module(cls, cfg, dtype=dtype, device=device)
    for m in model.modules():
        if isinstance(m, (nn.Conv3d, nn.Linear)):
            s = 1.0 / math.sqrt(m.weight[0].numel())
            m.weight.uniform_(-s, s, generator=gen)
            m.bias.zero_()
        elif isinstance(m, LayerNormAffine):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return model.eval().requires_grad_(False)


def vae_halves(sd) -> Tuple[bool, bool]:
    """(encoder, decoder): which halves a reference-format state dict holds."""
    return (any(k.startswith("encoder.") for k in sd),
            any(k.startswith("decoder.") for k in sd))
