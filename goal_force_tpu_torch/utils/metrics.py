"""Fidelity metrics: PSNR and SSIM per frame, and the comparison of two clips.

Port of ``goal_force_tpu/utils/metrics.py`` (numpy on the host, float64 throughout):
``psnr``, ``ssim`` (channel-averaged, over 8 x 8 box windows) and ``compare_videos``
(per-frame values and their mean and minimum).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB of two arrays of one shape; inf where equal."""
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(data_range**2 / mse)


def _box8(x: np.ndarray) -> np.ndarray:
    """Means over every 8 x 8 window of (H, W, C), from a summed-area table."""
    k = 8
    c = np.pad(np.cumsum(np.cumsum(x, axis=0), axis=1), ((1, 0), (1, 0), (0, 0)))
    hh, ww = x.shape[0] - k + 1, x.shape[1] - k + 1
    return (c[k:k + hh, k:k + ww] - c[:hh, k:k + ww] - c[k:k + hh, :ww] + c[:hh, :ww]) / (k * k)


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    """SSIM of two (H, W, C) images over 8 x 8 box windows, averaged over windows and
    channels."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a, mu_b = _box8(a), _box8(b)
    var_a = _box8(a * a) - mu_a**2
    var_b = _box8(b * b) - mu_b**2
    cov = _box8(a * b) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2))
    return float(np.mean(s))


def compare_videos(ours: np.ndarray, reference: np.ndarray) -> Dict:
    """Per-frame PSNR and SSIM of two (F, H, W, 3) float clips in [0, 1], with
    ``psnr_mean``, ``psnr_min`` and ``ssim_mean``."""
    if ours.shape != reference.shape:
        raise ValueError(f"clips differ in shape: {ours.shape} vs {reference.shape}")
    per_frame = [{"frame": i, "psnr": psnr(ours[i], reference[i]),
                  "ssim": ssim(ours[i], reference[i])} for i in range(ours.shape[0])]
    psnrs = [f["psnr"] for f in per_frame]
    return {
        "per_frame": per_frame,
        "psnr_mean": float(np.mean(psnrs)),
        "psnr_min": float(np.min(psnrs)),
        "ssim_mean": float(np.mean([f["ssim"] for f in per_frame])),
    }
