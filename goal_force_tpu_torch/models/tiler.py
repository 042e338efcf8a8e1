"""Spatial tiling of 3D tensors with full temporal extent per tile.

Port of ``tiled_forward_2d_to_3d`` of ``goal_force_tpu/models/tiler.py`` (the reference's
TileWorker2Dto3D, which the CogVideoX VAE tiles with): edge-clamped tile tasks on the
stride grid, each tile's output weighted by a ramp that is flat on the tensor's own
borders, and the weighted sums divided by the summed weights. The 2D tilers of that
module wait for the families that use them (ROADMAP queue 1, M14a).

Tensors are channels-last (B, T, H, W, C), as in JAX; the sums are float32 on the
input's device.
"""

from __future__ import annotations

import numpy as np
import torch


def _clamped_tasks(H: int, W: int, th: int, tw: int, sh: int, sw: int) -> list:
    """Tile origins on the stride grid, the last tile of a row or column shifted back to
    end at the border, and the tiles past one that already reached it skipped."""
    tasks = []
    for h in range(0, H, sh):
        for w in range(0, W, sw):
            if ((h - sh >= 0 and h - sh + th >= H)
                    or (w - sw >= 0 and w - sw + tw >= W)):
                continue
            h0, h1 = h, h + th
            w0, w1 = w, w + tw
            if h1 > H:
                h0, h1 = max(H - th, 0), H
            if w1 > W:
                w0, w1 = max(W - tw, 0), W
            tasks.append((h0, h1, w0, w1))
    return tasks


def _bound_mask_3d(t: int, h: int, w: int, is_bound, border_width) -> np.ndarray:
    """The distance to the nearest tile side that is not a border of the tensor, clipped
    to [1, border_width] and divided by it."""
    border_width = (h + w) // 4 if border_width is None else border_width
    tt = np.broadcast_to(np.arange(t)[:, None, None], (t, h, w))
    hh = np.broadcast_to(np.arange(h)[None, :, None], (t, h, w))
    ww = np.broadcast_to(np.arange(w)[None, None, :], (t, h, w))
    pad = np.full((t, h, w), border_width, np.int64)
    mask = np.stack([
        pad if is_bound[0] else tt + 1,
        pad if is_bound[1] else t - tt,
        pad if is_bound[2] else hh + 1,
        pad if is_bound[3] else h - hh,
        pad if is_bound[4] else ww + 1,
        pad if is_bound[5] else w - ww,
    ]).min(axis=0)
    mask = np.clip(mask, 1, max(border_width, 1))
    return (mask / max(border_width, 1)).astype(np.float32)


def tiled_forward_2d_to_3d(fn, x: torch.Tensor, tile_size, tile_stride,
                           border_width=None, scales=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """fn over spatial tiles of x (B, T, H, W, C), each with every frame. scales =
    (C, T, H, W) output-to-input ratios of fn. Returns (B, T·sT, H·sH, W·sW, C·sC)
    float32 on x's device."""
    B, T, H, W, C = x.shape
    sC, sT, sH, sW = scales
    th, tw = tile_size
    sh, sw = tile_stride
    out_t = int(T * sT)
    values = torch.zeros((B, out_t, int(H * sH), int(W * sW), int(C * sC)),
                         dtype=torch.float32, device=x.device)
    weight = torch.zeros((1, out_t, int(H * sH), int(W * sW), 1), dtype=torch.float32,
                         device=x.device)
    for (h0, h1, w0, w1) in _clamped_tasks(H, W, th, tw, sh, sw):
        out = fn(x[:, :, h0:h1, w0:w1, :]).float()
        mask = torch.from_numpy(_bound_mask_3d(
            out_t, int((h1 - h0) * sH), int((w1 - w0) * sW),
            (True, True, h0 == 0, h1 >= H, w0 == 0, w1 >= W),
            border_width)[None, :, :, :, None]).to(x.device)
        ph, pw = int(h0 * sH), int(w0 * sW)
        region = (slice(None), slice(None), slice(ph, ph + out.shape[2]),
                  slice(pw, pw + out.shape[3]))
        values[region] += out * mask
        weight[region] += mask
        del out
    return values / weight
