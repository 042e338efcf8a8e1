"""DDIM scheduler (CogVideoX's), host tables and stateless step arithmetic.

Port of ``goal_force_tpu/schedulers/ddim.py``: scaled-linear (or linear) betas built in
float64 on the host, timesteps spread over 999..0, epsilon or v prediction, the optional
zero-terminal-SNR rescale, and the step, add-noise, training-target and
return-to-timestep formulas. Each formula takes its weights as Python floats from the
float64 table, so it works on tensors and arrays of any dtype alike.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    timesteps: np.ndarray        # (N,) float32, descending
    alphas_cumprod: np.ndarray   # (num_train_timesteps,) float64
    prediction_type: str = "epsilon"

    def __len__(self):
        return int(self.timesteps.shape[0])


def make_ddim_schedule(
    num_inference_steps: int = 10,
    num_train_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    beta_schedule: str = "scaled_linear",
    prediction_type: str = "epsilon",
    rescale_zero_terminal_snr: bool = False,
    denoising_strength: float = 1.0,
) -> DDIMSchedule:
    if beta_schedule == "scaled_linear":
        betas = np.linspace(math.sqrt(beta_start), math.sqrt(beta_end),
                            num_train_timesteps, dtype=np.float64) ** 2
    elif beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
    else:
        raise NotImplementedError(beta_schedule)
    acp = np.cumprod(1.0 - betas)
    if rescale_zero_terminal_snr:
        s = np.sqrt(acp)
        s0, s_t = s[0], s[-1]
        s = (s - s_t) * (s0 / (s0 - s_t))
        acp = s**2
    max_t = max(round(num_train_timesteps * denoising_strength) - 1, 0)
    n = min(num_inference_steps, max_t + 1)
    if n == 1:
        ts = np.array([max_t], np.float32)
    else:
        step_len = max_t / (n - 1)
        ts = np.array([round(max_t - i * step_len) for i in range(n)], np.float32)
    return DDIMSchedule(ts, acp.astype(np.float64), prediction_type)


def _acp(schedule: DDIMSchedule, t) -> float:
    return float(schedule.alphas_cumprod[int(t)])


def ddim_step(schedule: DDIMSchedule, model_output, step_id: int, sample, to_final=False):
    """The sample at the next timestep (or the clean sample after the last step)."""
    a_t = _acp(schedule, schedule.timesteps[step_id])
    if to_final or step_id + 1 >= len(schedule):
        a_prev = 1.0
    else:
        a_prev = _acp(schedule, schedule.timesteps[step_id + 1])
    if schedule.prediction_type == "epsilon":
        w_e = math.sqrt(1 - a_prev) - math.sqrt(a_prev * (1 - a_t) / a_t)
        w_x = math.sqrt(a_prev / a_t)
    elif schedule.prediction_type == "v_prediction":
        w_e = -math.sqrt(a_prev * (1 - a_t)) + math.sqrt(a_t * (1 - a_prev))
        w_x = math.sqrt(a_t * a_prev) + math.sqrt((1 - a_t) * (1 - a_prev))
    else:
        raise NotImplementedError(schedule.prediction_type)
    return sample * w_x + model_output * w_e


def ddim_return_to_timestep(schedule: DDIMSchedule, step_id: int, sample,
                            sample_stabilized):
    """The epsilon that steers `sample` at step_id toward the clean `sample_stabilized`."""
    a_t = _acp(schedule, schedule.timesteps[step_id])
    return (sample - math.sqrt(a_t) * sample_stabilized) / math.sqrt(1 - a_t)


def ddim_add_noise(schedule: DDIMSchedule, x0, noise, timestep: int):
    a = _acp(schedule, timestep)
    return math.sqrt(a) * x0 + math.sqrt(1 - a) * noise


def ddim_training_target(schedule: DDIMSchedule, x0, noise, timestep: int):
    if schedule.prediction_type == "epsilon":
        return noise
    a = _acp(schedule, timestep)
    return math.sqrt(a) * noise - math.sqrt(1 - a) * x0
