"""Force/mass control-signal rendering (host side).

Port of ``goal_force_tpu/data/control_signal.py`` with both of its backends: the C++
windowed renderer (``native/control_render.cpp``, the default where it builds) and the
separable numpy path. They agree to ~1e-6 (float32 rounding; the native path zeroes the
numerically dead tail beyond 7 radii), and each equals the JAX package's same backend.

  channel 0: a radius-20 Gaussian blob travelling from the projectile position along the
             direct-force angle; travel distance lerps width/8 -> width/2 with normalized
             force magnitude.
  channel 1: the same for the goal (target indirect) force at the target position.
  channel 2: static Gaussian blobs at each object's position whose radius lerps 5 -> 40
             with normalized mass.

force == -1 masks channel 0, target_force == -1 masks channel 1; otherwise one of the two
may be dropped at random with the configured probabilities. The mass channel is dropped
with p_mask_out_masses, and the [0, 1] clamp applies only when it is rendered.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np

BLOB_RADIUS = 20.0
MIN_MASS_RADIUS = 5.0
MAX_MASS_RADIUS = 40.0


@dataclasses.dataclass
class ControlSpec:
    """One CSV row's control-signal parameters."""

    # Direct force on the projectile. force == -1 means unspecified (masked).
    force: float
    angle_deg: float
    x_pos: float               # normalized [0,1], origin bottom-left (y up)
    y_pos: float
    # Goal ("indirect") force the target should experience. -1 => no collision (masked).
    target_force: float
    target_angle_deg: float
    target_x_pos: float
    target_y_pos: float
    # Masses in pixel coordinates (origin top-left; y flipped inside the renderer).
    projectile_mass: float = -1.0
    projectile_xy_px: Tuple[float, float] = (0.0, 0.0)
    target_mass: float = -1.0
    target_xy_px: Tuple[float, float] = (0.0, 0.0)
    distractor_masses: Sequence[float] = ()
    distractor_xy_px: Sequence[Tuple[float, float]] = ()


def gaussian_blob(
    xs: np.ndarray, ys: np.ndarray, radius, height: int, width: int, amplitude: float = 1.0
) -> np.ndarray:
    """Batched Gaussian blobs: centers (N,), radius scalar or (N,) -> (N, H, W).

    amplitude * exp(-d^2 / (2 r^2)), computed separably as the outer product of the
    x and y factors.
    """
    xs = np.asarray(xs, dtype=np.float32).reshape(-1, 1)
    ys = np.asarray(ys, dtype=np.float32).reshape(-1, 1)
    radius = np.asarray(radius, dtype=np.float32).reshape(-1, 1)
    inv = 1.0 / (2.0 * radius**2)
    gx = np.exp(-((np.arange(width, dtype=np.float32)[None, :] - xs) ** 2) * inv)   # (N, W)
    gy = np.exp(-((np.arange(height, dtype=np.float32)[None, :] - ys) ** 2) * inv)  # (N, H)
    return amplitude * np.einsum("nh,nw->nhw", gy, gx)


def _moving_blob_path(
    x_start: float, y_start: float, angle_deg: float, norm_force: float,
    num_frames: int, width: int,
):
    """Per-frame centers of the travelling blob."""
    disp_max = width / 2.0
    disp_min = width / 8.0
    disp = disp_min + (disp_max - disp_min) * norm_force
    x_end = x_start + disp * math.cos(angle_deg * math.pi / 180.0)
    y_end = y_start - disp * math.sin(angle_deg * math.pi / 180.0)
    t = np.arange(num_frames, dtype=np.float32) / max(num_frames - 1, 1)
    return (x_start * (1 - t) + x_end * t).astype(np.float32), \
           (y_start * (1 - t) + y_end * t).astype(np.float32)


def mass_blob_radius(mass: float, min_mass: float, max_mass: float) -> float:
    """Radius lerp 5 -> 40 by normalized mass."""
    t = (mass - min_mass) / (max_mass - min_mass)
    return (1 - t) * MIN_MASS_RADIUS + t * MAX_MASS_RADIUS


def render_control_video(
    spec: ControlSpec,
    num_frames: int,
    height: int,
    width: int,
    min_force: float,
    max_force: float,
    min_mass: float = 1.0,
    max_mass: float = 4.0,
    min_indirect_force: Optional[float] = None,
    max_indirect_force: Optional[float] = None,
    p_mask_out_direct: float = 0.0,
    p_mask_out_indirect: float = 0.0,
    p_mask_out_masses: float = 0.0,
    rng: Optional[np.random.Generator] = None,
    backend: str = "auto",
) -> np.ndarray:
    """Render the (num_frames, height, width, 3) float32 control video in [0, 1].

    backend: "auto" renders with the native library where it builds, else with numpy;
    "native" raises where it does not build; "numpy" never uses it."""
    if min_indirect_force is None:
        min_indirect_force = min_force
    if max_indirect_force is None:
        max_indirect_force = max_force
    rng = rng or np.random.default_rng()

    lib = None
    if backend in ("auto", "native"):
        from goal_force_tpu_torch import native as nat

        lib = nat.native()
        if lib is None and backend == "native":
            raise RuntimeError(f"native renderer unavailable: {nat.build_error}")
    out = np.zeros((num_frames, height, width, 3), dtype=np.float32)

    if spec.force == -1:
        mask_direct, mask_indirect = True, False
    elif spec.target_force == -1:
        mask_direct, mask_indirect = False, True
    else:
        mask_direct = mask_indirect = False
        u = rng.uniform(0.0, 1.0)
        if u < p_mask_out_direct:
            mask_direct = True
        elif p_mask_out_direct <= u <= p_mask_out_direct + p_mask_out_indirect:
            mask_indirect = True

    def render_moving(channel, x0, y0, angle, norm):
        xs, ys = _moving_blob_path(x0, y0, angle, norm, num_frames, width)
        if lib is not None:
            lib.gf_add_moving_blob(out, num_frames, height, width, 3, channel,
                                   np.ascontiguousarray(xs), np.ascontiguousarray(ys),
                                   BLOB_RADIUS, 1.0)
        else:
            out[..., channel] = gaussian_blob(xs, ys, BLOB_RADIUS, height, width)

    if not mask_direct:
        norm = (spec.force - min_force) / (max_force - min_force)
        render_moving(0, spec.x_pos * width, (1 - spec.y_pos) * height, spec.angle_deg, norm)
    if not mask_indirect:
        norm = (spec.target_force - min_indirect_force) / (max_indirect_force - min_indirect_force)
        render_moving(1, spec.target_x_pos * width, (1 - spec.target_y_pos) * height,
                      spec.target_angle_deg, norm)

    mask_masses = rng.uniform(0.0, 1.0) < p_mask_out_masses
    if not mask_masses:
        xs, ys, radii = [], [], []
        entries = [
            (spec.projectile_mass, spec.projectile_xy_px),
            (spec.target_mass, spec.target_xy_px),
            *zip(spec.distractor_masses, spec.distractor_xy_px),
        ]
        for mass, (cx, cy) in entries:
            if mass is None or mass <= -1:
                continue
            xs.append(cx)
            ys.append(height - cy)   # pixel y flip
            radii.append(mass_blob_radius(mass, min_mass, max_mass))
        if xs and lib is not None:
            lib.gf_add_static_blobs(out, num_frames, height, width, 3, 2,
                                    np.asarray(xs, np.float32), np.asarray(ys, np.float32),
                                    np.asarray(radii, np.float32), len(xs), 1.0)
        elif xs:
            mass_map = gaussian_blob(np.array(xs), np.array(ys), np.array(radii),
                                     height, width)
            out[..., 2] = mass_map.sum(axis=0)[None]  # static across frames
        if lib is not None:
            lib.gf_clamp01(out, out.size)
        else:
            np.clip(out, 0.0, 1.0, out=out)

    return out
