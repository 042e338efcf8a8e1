"""Spatially tiled inference over 2D feature maps.

Port of ``goal_force_tpu/utils/tiler.py`` (the reference's TileWorker as the SD/SDXL
VAEs tile): tiles on the stride grid, the last of a row or column cut short at the
border, the tiles past one that already reached it skipped; each output weighted by a
ramp min(x + 1, H - x, y + 1, W - y) / border clipped to [0, 1], and the weighted sums
divided by the summed weights (at least 1e-6). The sums keep fn's output dtype, as in
JAX. Tensors are channels-last (B, H, W, C).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def tile_mask(height: int, width: int, border_width: int) -> np.ndarray:
    """(H, W) blend mask: 1 in the centre, a linear ramp at the borders."""
    x = np.arange(height)[:, None] * np.ones((1, width))
    y = np.ones((height, 1)) * np.arange(width)[None]
    m = np.stack([x + 1, height - x, y + 1, width - y]).min(axis=0)
    return (m / border_width).clip(0, 1).astype(np.float32)


def tiled_forward_2d(forward_fn: Callable, x: torch.Tensor, tile_size: int,
                     tile_stride: int, scale: int = 1, out_channels: int = None,
                     border_width: int = None) -> torch.Tensor:
    """forward_fn over overlapping (tile_size x tile_size) crops of x (B, H, W, C),
    blended; scale is the output-to-input resolution ratio (8 for a VAE decoder)."""
    b, h, w, _ = x.shape
    border_width = (tile_size - tile_stride) * scale if border_width is None else border_width
    tasks = []
    for hi in range(0, h, tile_stride):
        if hi - tile_stride >= 0 and hi - tile_stride + tile_size >= h:
            continue
        for wi in range(0, w, tile_stride):
            if wi - tile_stride >= 0 and wi - tile_stride + tile_size >= w:
                continue
            tasks.append((hi, min(hi + tile_size, h), wi, min(wi + tile_size, w)))

    values = weight = None
    for (h0, h1, w0, w1) in tasks:
        out = forward_fn(x[:, h0:h1, w0:w1])
        if values is None:
            oc = out.shape[-1] if out_channels is None else out_channels
            values = torch.zeros((b, h * scale, w * scale, oc), dtype=out.dtype, device=out.device)
            weight = torch.zeros((1, h * scale, w * scale, 1), dtype=out.dtype, device=out.device)
        th, tw = out.shape[1], out.shape[2]
        m = torch.from_numpy(tile_mask(th, tw, max(border_width, 1)))[None, :, :, None].to(
            device=out.device, dtype=out.dtype)
        values[:, h0 * scale:h0 * scale + th, w0 * scale:w0 * scale + tw] += out * m
        weight[:, h0 * scale:h0 * scale + th, w0 * scale:w0 * scale + tw] += m
    return values / weight.clamp_min(1e-6)
