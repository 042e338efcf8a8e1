"""Training-sample checks.

Port of ``goal_force_tpu/data/datasets.py::should_skip``. The CSV/mp4 datasets of the
JAX package need video decoding and data files and are not ported; the trainer takes
any indexable of dicts with ``video`` and ``control_video`` ((T, H, W, 3) in [0, 1])
and a ``prompt``.
"""

from __future__ import annotations

from typing import Dict, Optional


def should_skip(sample: Optional[Dict], num_frames: int, height: int, width: int) -> bool:
    """True for a missing sample or one whose control video is absent or mis-shaped."""
    if sample is None:
        return True
    cv = sample.get("control_video")
    return cv is None or tuple(cv.shape) != (num_frames, height, width, 3)
