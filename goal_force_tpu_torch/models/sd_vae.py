"""The SD-1.5 / SDXL / SD3 / Flux image VAE (8x spatial), channels-last.

Port of ``goal_force_tpu/models/sd_vae.py``: one block plan per half (``("res", in,
out)``, ``("vattn", ch)``, ``("downe", ch)``, ``("up", ch)``) run over the primitives of
``models/sd_unet.py``; the single-head, projection-only mid attention (``_vae_attn``); the
encoder's downsampler, an asymmetric (0, 1, 0, 1) pad and a VALID stride-2 conv; the
decoder's nearest 2x upsample and conv.

  - ``sd_vae_encode`` / ``sd_vae_decode``: 4-channel latents, ``quant_conv`` /
    ``post_quant_conv``, scaling 0.18215 (SDXL's VAE is the same with 0.13025);
  - ``sd3_vae_encode`` / ``sd3_vae_decode``: the 16-channel SD3 / Flux head (no quant
    convs, 32 moment channels), ``(x - shift) * scaling`` with ``SD3_SCALING`` or
    ``FLUX_SCALING``.

The encoders return the distribution's mean (the first half of the moment channels),
never a sample. The halves hold their weights under the reference ("diffsynth") names
(``conv_in``, ``blocks.{i}.*``, ``conv_norm_out``, ``conv_out``, the quant convs), so a
diffsynth file loads strictly; ``state_dict_from_civitai`` renames an LDM / civitai VAE
(``encoder.down.{i}.block.{j}``, ``mid.attn_1``, 1x1-conv attention weights, ...) into
them. As in JAX, the weights may be bf16 while the images and latents are float32: each
conv and linear casts its weights to the input's dtype.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from goal_force_tpu_torch.models.sd_unet import (
    Attention,
    ResnetBlock,
    _attention,
    _resnet,
    conv2d,
    group_norm,
)
from goal_force_tpu_torch.models.wan_dit import LayerNormAffine, empty_module

SCALING_FACTOR = 0.18215
SDXL_SCALING_FACTOR = 0.13025
SD3_SCALING = (1.5305, 0.0609)   # (scaling, shift)
FLUX_SCALING = (0.3611, 0.1159)

SD_VAE_ENCODER_PLAN: Tuple[Tuple, ...] = (
    ("res", 128, 128), ("res", 128, 128), ("downe", 128),
    ("res", 128, 256), ("res", 256, 256), ("downe", 256),
    ("res", 256, 512), ("res", 512, 512), ("downe", 512),
    ("res", 512, 512), ("res", 512, 512),
    ("res", 512, 512), ("vattn", 512), ("res", 512, 512),
)

SD_VAE_DECODER_PLAN: Tuple[Tuple, ...] = (
    ("res", 512, 512), ("vattn", 512), ("res", 512, 512),
    ("res", 512, 512), ("res", 512, 512), ("res", 512, 512), ("up", 512),
    ("res", 512, 512), ("res", 512, 512), ("res", 512, 512), ("up", 512),
    ("res", 512, 256), ("res", 256, 256), ("res", 256, 256), ("up", 256),
    ("res", 256, 128), ("res", 128, 128), ("res", 128, 128),
)


class VAEAttentionBlock(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.norm = LayerNormAffine(ch)
        self.transformer_blocks = nn.ModuleList([Attention(ch)])


class Resample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3)


def _plan_blocks(plan) -> nn.ModuleList:
    make = {"res": lambda s: ResnetBlock(s[1], s[2]), "vattn": lambda s: VAEAttentionBlock(s[1]),
            "downe": lambda s: Resample(s[1]), "up": lambda s: Resample(s[1])}
    return nn.ModuleList(make[spec[0]](spec) for spec in plan)


class SDVAEEncoder(nn.Module):
    """An encoder half: 2 x latent_channels moment channels out (8 for SD, 32 for the
    SD3 / Flux head), with SD's 1x1 ``quant_conv`` where `quant`."""

    def __init__(self, plan: Sequence[Tuple] = SD_VAE_ENCODER_PLAN, latent_channels: int = 4,
                 quant: bool = True, in_channels: int = 3):
        super().__init__()
        self.plan = tuple(plan)
        moments = 2 * latent_channels
        self.conv_in = nn.Conv2d(in_channels, plan[0][1], 3)
        self.blocks = _plan_blocks(plan)
        self.conv_norm_out = LayerNormAffine(plan[-1][-1])
        self.conv_out = nn.Conv2d(plan[-1][-1], moments, 3)
        if quant:
            self.quant_conv = nn.Conv2d(moments, moments, 1)


class SDVAEDecoder(nn.Module):
    """A decoder half from latent_channels (4 for SD, 16 for SD3 / Flux), with SD's 1x1
    ``post_quant_conv`` where `quant`."""

    def __init__(self, plan: Sequence[Tuple] = SD_VAE_DECODER_PLAN, latent_channels: int = 4,
                 quant: bool = True, out_channels: int = 3):
        super().__init__()
        self.plan = tuple(plan)
        if quant:
            self.post_quant_conv = nn.Conv2d(latent_channels, latent_channels, 1)
        self.conv_in = nn.Conv2d(latent_channels, plan[0][1], 3)
        self.blocks = _plan_blocks(plan)
        self.conv_norm_out = LayerNormAffine(plan[-1][-1])
        self.conv_out = nn.Conv2d(plan[-1][-1], out_channels, 3)


def _vae_attn(p: VAEAttentionBlock, x: torch.Tensor, groups: int, eps: float = 1e-6):
    b, h, w, c = x.shape
    t = group_norm(p.norm, x, groups, eps=eps).reshape(b, h * w, c)
    t = _attention(p.transformer_blocks[0], t, t, num_heads=1)
    return t.reshape(b, h, w, c) + x


def _run_plan(model: nn.Module, x: torch.Tensor, groups: int) -> torch.Tensor:
    for spec, p in zip(model.plan, model.blocks):
        kind = spec[0]
        if kind == "res":
            x = _resnet(p, x, None, groups)
        elif kind == "vattn":
            x = _vae_attn(p, x, groups)
        elif kind == "downe":
            x = conv2d(p.conv, F.pad(x, (0, 0, 0, 1, 0, 1)), stride=2, padding="VALID")
        elif kind == "up":
            b, h, w, c = x.shape
            x = x[:, :, None, :, None].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)
            x = conv2d(p.conv, x)
        else:
            raise ValueError(spec)
    return x


def _encode_moments(model: SDVAEEncoder, images: torch.Tensor, groups: int) -> torch.Tensor:
    x = conv2d(model.conv_in, images)
    x = _run_plan(model, x, groups)
    x = F.silu(group_norm(model.conv_norm_out, x, groups, eps=1e-6))
    return conv2d(model.conv_out, x)


def _decode(model: SDVAEDecoder, x: torch.Tensor, groups: int) -> torch.Tensor:
    x = conv2d(model.conv_in, x)
    x = _run_plan(model, x, groups)
    x = F.silu(group_norm(model.conv_norm_out, x, groups, eps=1e-5))
    return conv2d(model.conv_out, x)


def sd_vae_encode(model: SDVAEEncoder, images: torch.Tensor, groups: int = 32,
                  scaling: float = SCALING_FACTOR) -> torch.Tensor:
    """(B, H, W, 3) in [-1, 1] -> (B, H/8, W/8, 4) scaled latent means."""
    x = conv2d(model.quant_conv, _encode_moments(model, images, groups))
    return x[..., :4] * scaling


def sd_vae_decode(model: SDVAEDecoder, latents: torch.Tensor, groups: int = 32,
                  scaling: float = SCALING_FACTOR) -> torch.Tensor:
    """(B, h, w, 4) scaled latents -> (B, 8h, 8w, 3) images in [-1, 1]."""
    return _decode(model, conv2d(model.post_quant_conv, latents / scaling), groups)


def sd3_vae_encode(model: SDVAEEncoder, images: torch.Tensor,
                   scaling_shift: Tuple[float, float] = SD3_SCALING,
                   groups: int = 32) -> torch.Tensor:
    """(B, H, W, 3) -> (B, H/8, W/8, 16): the 16 means of the 32 moment channels, then
    (x - shift) * scaling."""
    scaling, shift = scaling_shift
    return (_encode_moments(model, images, groups)[..., :16] - shift) * scaling


def sd3_vae_decode(model: SDVAEDecoder, latents: torch.Tensor,
                   scaling_shift: Tuple[float, float] = SD3_SCALING,
                   groups: int = 32) -> torch.Tensor:
    """(B, h, w, 16) -> (B, 8h, 8w, 3): z / scaling + shift, no post_quant_conv."""
    scaling, shift = scaling_shift
    return _decode(model, latents / scaling + shift, groups)


# ---------------------------------------------------------------------------
# civitai / LDM naming -> the reference names
# ---------------------------------------------------------------------------

def _ldm_prefixes(plan, is_encoder: bool):
    """The LDM prefix of each plan entry. Encoder: ``down.{i}.block.{j}`` with
    ``down.{i}.downsample`` after each level; decoder: ``up.{i}`` from the highest level
    down, with ``up.{i}.upsample``; ``mid.block_1`` / ``mid.attn_1`` / ``mid.block_2`` for
    the (res, vattn, res) at the encoder's tail or the decoder's head."""
    n_levels = sum(1 for s in plan if s[0] in ("downe", "up")) + 1
    mid = tuple(s[0] for s in (plan[-3:] if is_encoder else plan[:3]))
    if mid != ("res", "vattn", "res"):
        raise ValueError(f"LDM mapping expects a (res, vattn, res) mid section, got {mid}")
    mid_start = len(plan) - 3 if is_encoder else 0
    out, level, j = [], 0 if is_encoder else n_levels - 1, 0
    for i, spec in enumerate(plan):
        if mid_start <= i < mid_start + 3:
            out.append({"res": f"mid.block_{1 if i == mid_start else 2}",
                        "vattn": "mid.attn_1"}[spec[0]])
        elif spec[0] in ("downe", "up"):
            out.append(f"{'down' if is_encoder else 'up'}.{level}."
                       f"{'downsample' if is_encoder else 'upsample'}")
            level += 1 if is_encoder else -1
            j = 0
        else:
            out.append(f"{'down' if is_encoder else 'up'}.{level}.block.{j}")
            j += 1
    return out


def state_dict_from_civitai(sd: Dict[str, torch.Tensor], plan, is_encoder: bool
                            ) -> Dict[str, torch.Tensor]:
    """The keys of an LDM / civitai VAE (or of a whole SD checkpoint, under
    ``first_stage_model.``) that one half reads, renamed to the reference names: the
    norms, convs and shortcuts (``nin_shortcut``) per block, the mid attention's 1x1-conv
    ``q``/``k``/``v``/``proj_out`` as linears, ``norm_out`` as ``conv_norm_out``, and
    ``quant_conv`` / ``post_quant_conv`` from the top level."""
    pre0 = "first_stage_model." if any(k.startswith("first_stage_model.") for k in sd) else ""
    side = pre0 + ("encoder." if is_encoder else "decoder.")
    out: Dict[str, torch.Tensor] = {}

    def take(dst: str, src: str, squeeze: bool = False):
        for suffix in ("weight", "bias"):
            w = sd[f"{src}.{suffix}"]
            out[f"{dst}.{suffix}"] = w[:, :, 0, 0] if squeeze and suffix == "weight" else w

    take("conv_in", side + "conv_in")
    for i, (spec, base) in enumerate(zip(plan, _ldm_prefixes(plan, is_encoder))):
        src, dst = side + base, f"blocks.{i}"
        if spec[0] == "res":
            for name in ("norm1", "conv1", "norm2", "conv2"):
                take(f"{dst}.{name}", f"{src}.{name}")
            if f"{src}.nin_shortcut.weight" in sd:
                take(f"{dst}.conv_shortcut", f"{src}.nin_shortcut")
        elif spec[0] == "vattn":
            take(f"{dst}.norm", f"{src}.norm")
            for ldm, ref in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"), ("proj_out", "to_out")):
                take(f"{dst}.transformer_blocks.0.{ref}", f"{src}.{ldm}", squeeze=True)
        else:
            take(f"{dst}.conv", f"{src}.conv")
    take("conv_norm_out", side + "norm_out")
    take("conv_out", side + "conv_out")
    take("quant_conv" if is_encoder else "post_quant_conv",
         pre0 + ("quant_conv" if is_encoder else "post_quant_conv"))
    return out


@torch.no_grad()
def init_sd_vae(cls, plan, gen: torch.Generator, dtype=torch.float32, *, device,
                latent_channels: int = 16, quant: bool = False) -> nn.Module:
    """Random weights from `gen` with the JAX pipelines' VAE distributions: convs and
    attention linears N(0, 0.02²), zero biases, unit norms. The defaults are the SD3 /
    Flux head (16 latent channels, no quant convs)."""
    model = empty_module(cls, plan, latent_channels, quant, dtype=dtype, device=device)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            m.weight.normal_(generator=gen).mul_(0.02)
            m.bias.zero_()
        elif isinstance(m, LayerNormAffine):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return model.eval().requires_grad_(False)


# the JAX pipelines' tiny SD VAE (8 channels, 3 levels: factor 8, 4 groups) for tests
TINY_SD_VAE_ENCODER_PLAN: Tuple[Tuple, ...] = (
    ("res", 8, 8), ("downe", 8), ("res", 8, 8), ("downe", 8), ("res", 8, 8), ("downe", 8),
    ("vattn", 8))
TINY_SD_VAE_DECODER_PLAN: Tuple[Tuple, ...] = (
    ("vattn", 8), ("res", 8, 8), ("up", 8), ("res", 8, 8), ("up", 8), ("res", 8, 8),
    ("up", 8))
TINY_SD_VAE_GROUPS = 4


def init_tiny_sd_vae(gen: torch.Generator, dtype=torch.float32, *, device):
    """(encoder, decoder) of JAX ``pipelines/sd.py::_init_tiny_vae``'s plans with SD's
    4-channel head and quant convs, drawn from `gen`."""
    return tuple(init_sd_vae(cls, plan, gen, dtype, device=device, latent_channels=4,
                             quant=True)
                 for cls, plan in ((SDVAEEncoder, TINY_SD_VAE_ENCODER_PLAN),
                                   (SDVAEDecoder, TINY_SD_VAE_DECODER_PLAN)))
