"""Regional prompting ("local prompts") for the image pipelines.

Port of ``goal_force_tpu/pipelines/regional.py``: each local prompt gets its own
denoiser pass, and the global prediction is blended with the local ones through
per-pixel weights made once from the user's masks: resized to the latent grid
(``jax.image.resize``'s antialiased bilinear, copied here in numpy), thresholded at 0.5,
blurred by a reflect-padded Gaussian (kernel 33, sigma 10) and scaled:

    merged = (pred_global + sum_i pred_i * w_i) / (1 + sum_i w_i)
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _gaussian_kernel1d(kernel_size: int, sigma: float) -> np.ndarray:
    half = (kernel_size - 1) / 2
    x = np.arange(kernel_size, dtype=np.float64) - half
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _blur_reflect(img: np.ndarray, kernel_size: int, sigma: float) -> np.ndarray:
    """Separable Gaussian blur with reflect padding (torchvision GaussianBlur's)."""
    if kernel_size <= 1:
        return img
    pad = kernel_size // 2
    if pad >= min(img.shape):
        raise ValueError(
            f"blur kernel {kernel_size} too large for mask geometry "
            f"{img.shape}; pass a smaller blur_kernel_size")
    k = _gaussian_kernel1d(kernel_size, sigma)
    out = np.pad(img, ((pad, pad), (0, 0)), mode="reflect")
    out = np.stack([np.convolve(out[:, j], k, mode="valid")
                    for j in range(out.shape[1])], axis=1)
    out = np.pad(out, ((0, 0), (pad, pad)), mode="reflect")
    out = np.stack([np.convolve(out[i, :], k, mode="valid")
                    for i in range(out.shape[0])], axis=0)
    return out.astype(np.float32)


def _bilinear_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in, out) float32 weights of ``jax.image.resize(..., "bilinear")`` along one axis:
    the triangle kernel widened by the downscale factor (antialiasing), normalised per
    output sample, zero for samples outside the input."""
    inv = np.float32(in_size / out_size)
    sample = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None])
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x / max(inv, np.float32(1.0)))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def resize_bilinear(m: np.ndarray, height: int, width: int) -> np.ndarray:
    """A (H, W) float32 map resized to (height, width), antialiased as JAX resizes."""
    wh = _bilinear_weights(m.shape[0], height)
    ww = _bilinear_weights(m.shape[1], width)
    return (wh.T @ np.asarray(m, np.float32) @ ww).astype(np.float32)


def local_prompt_weights(masks: Sequence[np.ndarray], mask_scales: Sequence[float],
                         height: int, width: int, blur_kernel_size: int = 33,
                         blur_sigma: float = 10.0) -> np.ndarray:
    """masks: (H, W) or (H, W, C) float arrays in [0, 1] -> (L, height, width, 1) float32
    blend weights: blur(resize(mask) > 0.5) x scale."""
    ws = []
    for mask, scale in zip(masks, mask_scales):
        m = np.asarray(mask, np.float32)
        if m.ndim == 3:
            m = m.mean(axis=-1)
        m = (resize_bilinear(m, height, width) > 0.5).astype(np.float32)
        ws.append(_blur_reflect(m, blur_kernel_size, blur_sigma) * float(scale))
    return np.stack(ws, axis=0)[..., None]


def blend_local_predictions(pred_global: torch.Tensor, pred_locals: torch.Tensor,
                            weights: torch.Tensor) -> torch.Tensor:
    """(1, h, w, C) global + (L, h, w, C) local predictions with (L, h, w, 1) weights ->
    (1, h, w, C)."""
    num = pred_global + (pred_locals * weights).sum(0, keepdim=True)
    return num / (1.0 + weights.sum(0, keepdim=True))
