"""Spatial tiling for 2D image models and for 3D tensors with full temporal extent.

Port of ``goal_force_tpu/models/tiler.py`` (the reference's three tilers):

  - ``tiled_forward_2d`` (TileWorker): tiles on the unfold grid, which must cover the
    extent exactly (JAX raises where the reference would divide 0 by 0), each tile's
    output weighted by a ramp to the tile's nearest side, the weighted sums divided by
    the summed weights;
  - ``tiled_forward_2d_shift`` (FastTileWorker): edge-clamped tile tasks, each weighted
    by a ramp that is flat on the tensor's own borders; fn gets the tile's coordinates;
  - ``tiled_forward_2d_to_3d`` (TileWorker2Dto3D, which the CogVideoX VAE tiles with):
    the same clamped tasks over (H, W) with every frame in each tile.

Tensors are channels-last ((B, H, W, C) or (B, T, H, W, C)), as in JAX; the sums are
float32 on the input's device.
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


def _unfold_positions(extent: int, size: int, stride: int) -> list:
    """Tile origins 0, stride, ... while origin + size <= extent; the tiles must cover
    the extent exactly."""
    if size > extent:
        raise ValueError(f"tile size {size} exceeds extent {extent}")
    if (extent - size) % stride != 0:
        raise ValueError(
            f"extent {extent} is not covered by tiles of size {size} at stride "
            f"{stride}: (extent - size) must be a multiple of stride (the "
            "reference TileWorker produces NaNs on this geometry)")
    return list(range(0, extent - size + 1, stride))


def _ramp_mask(h: int, w: int, border_width: int) -> np.ndarray:
    """The distance to the tile's nearest side over border_width, clipped to (0, 1]."""
    x = np.arange(h)[:, None]
    y = np.arange(w)[None, :]
    m = np.minimum(np.minimum(x + 1, h - x), np.minimum(y + 1, w - y))
    return np.clip(m / max(border_width, 1), 0.0, 1.0).astype(np.float32)


def _bound_mask(h: int, w: int, is_bound, border_width=None) -> np.ndarray:
    """``_ramp_mask`` flat (= border_width) on the sides flagged as the tensor's border
    (top, bottom, left, right), clipped to [1, border_width] and divided by it."""
    border_width = (h + w) // 4 if border_width is None else border_width
    x = np.arange(h)[:, None] * np.ones((1, w), np.int64)
    y = np.ones((h, 1), np.int64) * np.arange(w)[None, :]
    pad = np.full((h, w), border_width, np.int64)
    mask = np.stack([
        pad if is_bound[0] else x + 1,
        pad if is_bound[1] else h - x,
        pad if is_bound[2] else y + 1,
        pad if is_bound[3] else w - y,
    ]).min(axis=0)
    mask = np.clip(mask, 1, max(border_width, 1))
    return (mask / max(border_width, 1)).astype(np.float32)


def _mask_tensor(mask: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(mask)[None, :, :, None].to(device)


def tiled_forward_2d(fn, x: torch.Tensor, tile_size: int, tile_stride: int,
                     border_width=None, batch: int = 1) -> torch.Tensor:
    """fn over overlapping (tile_size, tile_size) tiles of x (B, H, W, C), blended by the
    ramp mask. fn maps (B, t, t, C) to (B, t·s, t·s, C') for one io scale s, read from the
    first tile's output. batch: up to this many tiles go through one call of fn, stacked
    on the batch axis (only for an fn that maps each row on its own, such as a VAE half).
    Returns (B, H·s, W·s, C') float32 on x's device."""
    B, H, W, _ = x.shape
    border_width = int(tile_stride * 0.5) if border_width is None else border_width
    origins = [(h0, w0) for h0 in _unfold_positions(H, tile_size, tile_stride)
               for w0 in _unfold_positions(W, tile_size, tile_stride)]
    values = weight = mask = None
    for i in range(0, len(origins), batch):
        chunk = origins[i:i + batch]
        tiles = [x[:, h0:h0 + tile_size, w0:w0 + tile_size, :] for h0, w0 in chunk]
        outs = fn(torch.cat(tiles) if len(tiles) > 1 else tiles[0]).float().split(B)
        for (h0, w0), out in zip(chunk, outs):
            if values is None:
                io_scale = out.shape[1] / tile_size
                oth = int(tile_size * io_scale)
                values = torch.zeros((B, int(H * io_scale), int(W * io_scale), out.shape[-1]),
                                     dtype=torch.float32, device=x.device)
                weight = torch.zeros((1,) + values.shape[1:3] + (1,), dtype=torch.float32,
                                     device=x.device)
                mask = _mask_tensor(_ramp_mask(oth, oth, int(border_width * io_scale)),
                                    x.device)
            th, tw = int(h0 * io_scale), int(w0 * io_scale)
            values[:, th:th + oth, tw:tw + oth] += out * mask
            weight[:, th:th + oth, tw:tw + oth] += mask
        del outs
    return values / weight


def tiled_forward_2d_shift(fn, shape, tile_size: int, tile_stride: int,
                           border_width=None, io_scale: float = 1.0) -> torch.Tensor:
    """fn(h0, h1, w0, w1) -> (B, (h1 - h0)·s, (w1 - w0)·s, C') over the edge-clamped
    tasks of an input of shape (B, H, W), each weighted by ``_bound_mask``. Returns
    (B, H·s, W·s, C') float32 on fn's device."""
    B, H, W = shape
    values = weight = None
    for (h0, h1, w0, w1) in _clamped_tasks(H, W, tile_size, tile_size, tile_stride, tile_stride):
        out = fn(h0, h1, w0, w1).float()
        if values is None:
            values = torch.zeros((B, int(H * io_scale), int(W * io_scale), out.shape[-1]),
                                 dtype=torch.float32, device=out.device)
            weight = torch.zeros((1,) + values.shape[1:3] + (1,), dtype=torch.float32,
                                 device=out.device)
        mask = _mask_tensor(_bound_mask(out.shape[1], out.shape[2],
                                        (h0 == 0, h1 >= H, w0 == 0, w1 >= W), border_width),
                            out.device)
        th, tw = int(h0 * io_scale), int(w0 * io_scale)
        values[:, th:th + out.shape[1], tw:tw + out.shape[2]] += out * mask
        weight[:, th:th + out.shape[1], tw:tw + out.shape[2]] += mask
        del out
    return values / weight


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
