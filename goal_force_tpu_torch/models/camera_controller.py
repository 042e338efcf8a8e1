"""Wan camera controller: Plücker ray embeddings and the SimpleAdapter.

Port of ``goal_force_tpu/models/camera_controller.py``:

- ``generate_camera_coordinates``: walk a 19-number pose entry by a per-frame speed
  along the chosen direction;
- ``plucker_embedding``: aspect-corrected intrinsics, first-frame-relative camera-to-world
  poses, normalised pixel ray directions and the Plücker (o x d, d) 6-vector per pixel,
  in float64 on the host as the JAX package computes it;
- ``SimpleAdapter`` under the reference's keys (``conv``, ``residual_blocks.{i}.conv1``
  and ``.conv2``) and ``simple_adapter_apply``: per frame a pixel-unshuffle by 8 (torch's
  channel order (c, fh, fw), which the JAX package reproduces), a strided conv and
  ReLU-conv residual blocks.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

DEFAULT_ORIGIN = (0, 0.532139961, 0.946026558, 0.5, 0.5, 0, 0, 1, 0, 0, 0, 0,
                  1, 0, 0, 0, 0, 1, 0)


def generate_camera_coordinates(direction: str, length: int, speed: float = 1 / 54,
                                origin=DEFAULT_ORIGIN) -> List[List[float]]:
    coords = [list(origin)]
    while len(coords) < length:
        c = coords[-1].copy()
        if "Left" in direction:
            c[9] += speed
        if "Right" in direction:
            c[9] -= speed
        if "Up" in direction:
            c[13] += speed
        if "Down" in direction:
            c[13] -= speed
        if "In" in direction:
            c[18] -= speed
        if "Out" in direction:
            c[18] += speed
        coords.append(c)
    return coords


def _relative_poses(entries: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(V, 19) pose entries -> intrinsics (V, 4) and first-frame-relative c2w (V, 4, 4)."""
    fxy = entries[:, 1:5].astype(np.float64)
    w2c = np.tile(np.eye(4)[None], (len(entries), 1, 1))
    w2c[:, :3, :] = entries[:, 7:].reshape(-1, 3, 4)
    c2w = np.linalg.inv(w2c)
    rel = np.concatenate([np.eye(4)[None], np.einsum("ij,vjk->vik", w2c[0], c2w[1:])], axis=0)
    return fxy, rel.astype(np.float64)


def plucker_embedding(entries: Sequence[Sequence[float]], width: int, height: int,
                      original_pose_width: int = 1280,
                      original_pose_height: int = 720) -> np.ndarray:
    """(V, 19) pose entries -> (V, H, W, 6) float32 Plücker embedding."""
    entries = np.asarray(entries, np.float64)
    fxy, c2w = _relative_poses(entries)
    fx, fy, cx, cy = fxy[:, 0].copy(), fxy[:, 1].copy(), fxy[:, 2], fxy[:, 3]
    sample_ratio = width / height
    pose_ratio = original_pose_width / original_pose_height
    if pose_ratio > sample_ratio:
        fx = height * pose_ratio * fx / width
    else:
        fy = (width / pose_ratio) * fy / height
    fx, fy = fx * width, fy * height
    cxp, cyp = cx * width, cy * height
    j, i = np.meshgrid(np.arange(height, dtype=np.float64),
                       np.arange(width, dtype=np.float64), indexing="ij")
    i = i.reshape(-1) + 0.5
    j = j.reshape(-1) + 0.5
    xs = (i[None] - cxp[:, None]) / fx[:, None]
    ys = (j[None] - cyp[:, None]) / fy[:, None]
    d = np.stack([xs, ys, np.ones_like(xs)], axis=-1)                    # (V, HW, 3)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    rays_d = np.einsum("vpj,vkj->vpk", d, c2w[:, :3, :3])
    rays_o = np.broadcast_to(c2w[:, None, :3, 3], rays_d.shape)
    plucker = np.concatenate([np.cross(rays_o, rays_d), rays_d], axis=-1)
    return plucker.reshape(len(entries), height, width, 6).astype(np.float32)


def camera_control_embedding(direction: str, length: int, height: int, width: int,
                             speed: float = 1 / 54, origin=DEFAULT_ORIGIN) -> np.ndarray:
    """(length, H, W, 6) embedding of a camera moving in `direction`."""
    return plucker_embedding(generate_camera_coordinates(direction, length, speed, origin),
                             width, height)


# ---------------------------------------------------------------------------
# SimpleAdapter
# ---------------------------------------------------------------------------

class ResidualBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv1 = nn.Conv2d(dim, dim, 3, padding=1)
        self.conv2 = nn.Conv2d(dim, dim, 3, padding=1)


class SimpleAdapter(nn.Module):
    """The reference's keys: conv (after PixelUnshuffle(8), so in_dim * 64 input
    channels) and residual_blocks.{i}.conv1/conv2."""

    def __init__(self, out_dim: int, in_dim: int = 24, kernel: int = 2,
                 num_residual_blocks: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_dim * 64, out_dim, kernel, kernel)
        self.residual_blocks = nn.Sequential(*(ResidualBlock(out_dim)
                                               for _ in range(num_residual_blocks)))


def simple_adapter_apply(adapter: SimpleAdapter, x: torch.Tensor, stride: int) -> torch.Tensor:
    """(V, H, W, C) control frames -> (V, H', W', out_dim) features, in x's dtype."""
    h = F.pixel_unshuffle(x.permute(0, 3, 1, 2), 8)
    h = F.conv2d(h, adapter.conv.weight.to(h.dtype), adapter.conv.bias.to(h.dtype),
                 stride=stride)
    for blk in adapter.residual_blocks:
        r = F.relu(F.conv2d(h, blk.conv1.weight.to(h.dtype), blk.conv1.bias.to(h.dtype),
                            padding=1))
        h = h + F.conv2d(r, blk.conv2.weight.to(h.dtype), blk.conv2.bias.to(h.dtype),
                         padding=1)
    return h.permute(0, 2, 3, 1)


def simple_adapter_from_state_dict(sd, dtype=torch.float32, *, device) -> SimpleAdapter:
    """A SimpleAdapter shaped by a reference-format state dict and loaded from it
    strictly (a missing, unexpected or mis-shaped key raises)."""
    from goal_force_tpu_torch.models.wan_dit import empty_module
    from goal_force_tpu_torch.pipelines.goal_force import load_state_dict_strict

    w = sd["conv.weight"]
    n = 0
    while f"residual_blocks.{n}.conv1.weight" in sd:
        n += 1
    mod = empty_module(SimpleAdapter, w.shape[0], w.shape[1] // 64, w.shape[2], n,
                       dtype=dtype, device=device)
    load_state_dict_strict(mod, sd, "camera adapter")
    return mod.eval().requires_grad_(False)


@torch.no_grad()
def init_simple_adapter(out_dim: int, gen: torch.Generator, in_dim: int = 24, kernel: int = 2,
                        num_residual_blocks: int = 1, dtype=torch.float32, *,
                        device) -> SimpleAdapter:
    """Random weights with the JAX init's distributions: uniform +-1/sqrt(fan_in) kernels,
    zero biases."""
    from goal_force_tpu_torch.models.wan_dit import empty_module

    mod = empty_module(SimpleAdapter, out_dim, in_dim, kernel, num_residual_blocks,
                       dtype=dtype, device=device)
    for conv in mod.modules():
        if isinstance(conv, nn.Conv2d):
            s = 1.0 / math.sqrt(conv.weight[0].numel())
            conv.weight.uniform_(-s, s, generator=gen)
            conv.bias.zero_()
    return mod.eval().requires_grad_(False)
