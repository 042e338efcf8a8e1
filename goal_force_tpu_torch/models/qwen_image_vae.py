"""The Qwen-Image VAE: the Wan2.1 causal video VAE applied to single images.

Port of ``goal_force_tpu/models/qwen_image_vae.py``: the model is the port's
``models/vae.py::WanVAE`` at Wan2.1's geometry (base 96, z 16, dim_mult (1, 2, 4, 4),
temporal downsampling (False, True, True), Wan's latent mean and std), with an image API
that adds and removes the one-frame time axis (``qwen_image_vae_encode`` /
``qwen_image_vae_decode``, the decode unclamped; the pipeline runs ``encode_video`` /
``decode_video`` and their tiled forms on the same module), and the translation of the
diffusers-style checkpoint names into the Wan layout (``qwen_vae_rename``; the 1x1
``quant_conv`` / ``post_quant_conv`` become Wan's ``conv1`` / ``conv2`` in
``qwen_image_vae_state_dict``).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import torch

from goal_force_tpu_torch.configs import VAEConfig
from goal_force_tpu_torch.models.vae import WanVAE, decode, encode, latent_scale

QWEN_IMAGE_VAE_CONFIG = VAEConfig()   # Wan2.1's geometry


def qwen_image_vae_encode(vae: WanVAE, image: torch.Tensor,
                          cfg: VAEConfig = QWEN_IMAGE_VAE_CONFIG) -> torch.Tensor:
    """(B, H, W, 3) in [-1, 1] -> scaled latents (B, H/8, W/8, 16)."""
    mu = encode(vae, cfg, image[:, None])[:, 0]
    mean, std = latent_scale(cfg, mu.dtype, mu.device)
    return (mu - mean) / std


def qwen_image_vae_decode(vae: WanVAE, latents: torch.Tensor,
                          cfg: VAEConfig = QWEN_IMAGE_VAE_CONFIG) -> torch.Tensor:
    """(B, h, w, 16) scaled latents -> (B, 8h, 8w, 3), unclamped."""
    mean, std = latent_scale(cfg, latents.dtype, latents.device)
    return decode(vae, cfg, (latents * std + mean)[:, None])[:, 0]


def _res_suffix(rest: str) -> str:
    table = {"norm1": "residual.0", "conv1": "residual.2", "norm2": "residual.3",
             "conv2": "residual.6", "conv_shortcut": "shortcut"}
    head, _, tail = rest.partition(".")
    return table[head] + "." + tail


def qwen_vae_rename(sd: Mapping) -> Dict:
    """diffusers-style Qwen-Image VAE keys -> the Wan layout (JAX's table: the encoder's
    flat ``down_blocks`` list, the decoder's ``up_blocks.{i}`` of three resnets and an
    upsampler flattened into ``upsamples.{4i + j}``, the mid block into ``middle.{0,1,2}``,
    ``conv_in`` / ``norm_out`` / ``conv_out`` into ``conv1`` / ``head.0`` / ``head.2``)."""
    out = {}
    for k, v in sd.items():
        m = re.match(r"(encoder|decoder)\.(.*)", k)
        if not m:
            out[k] = v
            continue
        side, rest = m.groups()
        if rest.startswith("conv_in."):
            out[f"{side}.conv1." + rest[len("conv_in."):]] = v
        elif rest.startswith("norm_out."):
            out[f"{side}.head.0." + rest[len("norm_out."):]] = v
        elif rest.startswith("conv_out."):
            out[f"{side}.head.2." + rest[len("conv_out."):]] = v
        elif rest.startswith("mid_block."):
            kind, idx, tail = re.match(r"mid_block\.(resnets|attentions)\.(\d)\.(.*)",
                                       rest).groups()
            if kind == "attentions":
                out[f"{side}.middle.1.{tail}"] = v
            else:
                out[f"{side}.middle.{'0' if idx == '0' else '2'}." + _res_suffix(tail)] = v
        elif rest.startswith("down_blocks."):
            idx, tail = re.match(r"down_blocks\.(\d+)\.(.*)", rest).groups()
            if tail.startswith(("resample.", "time_conv.")):
                out[f"{side}.downsamples.{idx}.{tail}"] = v
            else:
                out[f"{side}.downsamples.{idx}." + _res_suffix(tail)] = v
        elif rest.startswith("up_blocks."):
            blk, kind, j, tail = re.match(
                r"up_blocks\.(\d+)\.(resnets|upsamplers)\.(\d+)\.(.*)", rest).groups()
            base = int(blk) * 4
            if kind == "resnets":
                out[f"{side}.upsamples.{base + int(j)}." + _res_suffix(tail)] = v
            else:
                out[f"{side}.upsamples.{base + 3}.{tail}"] = v
        else:
            out[k] = v
    return out


_QUANT = {"quant_conv.weight": "conv1.weight", "quant_conv.bias": "conv1.bias",
          "post_quant_conv.weight": "conv2.weight", "post_quant_conv.bias": "conv2.bias"}


def qwen_image_vae_state_dict(sd: Mapping) -> Dict:
    """A reference-format Qwen-Image VAE file -> ``WanVAE``'s state dict."""
    return qwen_vae_rename({_QUANT.get(k, k): v for k, v in sd.items()})
