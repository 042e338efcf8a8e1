"""Force-prompt visualization: a circle and an arrow drawn on output videos.

Port of ``goal_force_tpu/data/viz.py``: red for the direct force, green for the goal
force, arrow length 10 + 90 * normalized force, drawn on the first
``num_frames_with_signal`` frames. It draws with OpenCV, imported when called.
"""

from __future__ import annotations

import math

import numpy as np


def add_force_prompt_to_video(
    video: np.ndarray,          # (F, H, W, 3) float [0, 1]
    force_normalized: float,
    angle_deg: float,
    x_pos: float,               # [0, 1], top-left y convention (caller passes 1-y_pos)
    y_pos: float,
    circle_radius: int = 20,
    num_frames_with_signal: int = 1,
    color=(255, 255, 255),
) -> np.ndarray:
    import cv2

    out = video.copy()
    _, h, w, _ = video.shape
    cx, cy = int(x_pos * w), int(y_pos * h)
    ang = math.radians(angle_deg)
    arrow_len = 10 + 90 * force_normalized
    ex = int(cx + arrow_len * math.cos(ang))
    ey = int(cy - arrow_len * math.sin(ang))
    for i in range(min(num_frames_with_signal, out.shape[0])):
        frame = (out[i] * 255).astype(np.uint8)
        cv2.circle(frame, (cx, cy), circle_radius, color, 2)
        cv2.arrowedLine(frame, (cx, cy), (ex, ey), color, 2, tipLength=0.3)
        out[i] = frame / 255.0
    return out
