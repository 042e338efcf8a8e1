"""TeaCache: skip the block stack while the timestep embedding barely moves.

Port of ``goal_force_tpu/pipelines/teacache.py``. Each step adds the relative L1 drift
of the modulated timestep input (t_mod) since the previous step, rescaled by a
per-model polynomial, to an accumulator; while the accumulator stays under the
threshold the step skips the DiT blocks and adds the cached token residual
(tokens after the blocks minus tokens before them) of the last computed step instead.
The first and last steps are always computed.

The decision is made on the host in numpy: the pipeline fetches t_mod once per step.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

TEACACHE_COEFFICIENTS = {
    "Wan2.1-T2V-1.3B": [-5.21862437e04, 9.23041404e03, -5.28275948e02, 1.36987616e01, -4.99875664e-02],
    "Wan2.1-T2V-14B": [-3.03318725e05, 4.90537029e04, -2.65530556e03, 5.87365115e01, -3.15583525e-01],
    "Wan2.1-I2V-14B-480P": [2.57151496e05, -3.54229917e04, 1.40286849e03, -1.35890334e01, 1.32517977e-01],
    "Wan2.1-I2V-14B-720P": [8.10705460e03, 2.13393892e03, -3.72934672e02, 1.66203073e01, -4.17769401e-02],
    "FLUX.1-dev": [4.98651651e02, -2.83781631e02, 5.58554382e01, -3.82021401e00, 2.64230861e-01],
    "HunyuanVideo": [7.33226126e02, -4.01131952e02, 6.75869174e01, -3.14987800e00, 9.61237896e-02],
}


class TeaCache:
    def __init__(self, num_inference_steps: int, rel_l1_thresh: float, model_id: str):
        if model_id not in TEACACHE_COEFFICIENTS:
            raise ValueError(
                f"{model_id} is not a supported TeaCache model id. Choose one of "
                f"{', '.join(TEACACHE_COEFFICIENTS)}.")
        self.num_inference_steps = num_inference_steps
        self.rel_l1_thresh = rel_l1_thresh
        self.coefficients = TEACACHE_COEFFICIENTS[model_id]
        self.step = 0
        self.accumulated = 0.0
        self.prev_t_mod: Optional[np.ndarray] = None
        self.residual = None  # device tensor (tokens_post - tokens_pre)

    def should_skip(self, t_mod) -> bool:
        """t_mod: (B, 6, D) as a numpy array (or anything ``np.asarray`` takes)."""
        t_mod = np.asarray(t_mod, np.float32)
        if self.step == 0 or self.step == self.num_inference_steps - 1:
            should_calc = True
            self.accumulated = 0.0
        else:
            rescale = np.poly1d(self.coefficients)
            rel = np.abs(t_mod - self.prev_t_mod).mean() / np.abs(self.prev_t_mod).mean()
            self.accumulated += float(rescale(rel))
            if self.accumulated < self.rel_l1_thresh:
                should_calc = False
            else:
                should_calc = True
                self.accumulated = 0.0
        self.prev_t_mod = t_mod
        self.step += 1
        if self.step == self.num_inference_steps:
            self.step = 0
        return not should_calc

    def store(self, tokens_pre, tokens_post):
        self.residual = tokens_post - tokens_pre
