"""Rectified-flow (flow matching) schedule.

Port of ``goal_force_tpu/schedulers/flow_match.py``. The table is built on the host in
float64 numpy and stored as float32, so sigmas and timesteps equal the JAX arrays
exactly; the step functions act on torch tensors.

  - shifted sigmas  sigma' = s*sigma / (1 + (s-1)*sigma)
  - Euler step      x_next = x + v * (sigma_next - sigma)
  - add_noise       x_t = (1-sigma)*x0 + sigma*eps
  - target          v = eps - x0
  - training weights: Gaussian bell over timestep values (``training=True``)
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FlowMatchSchedule:
    sigmas: np.ndarray        # (N,) float32, descending for generation
    timesteps: np.ndarray     # (N,) float32, sigmas * num_train_timesteps
    num_train_timesteps: int
    final_sigma: float = 0.0  # 1.0 for inverse/reversed schedules
    training_weights: np.ndarray | None = None  # (N,) float32 when training

    def __len__(self) -> int:
        return int(self.sigmas.shape[0])

    def sigma_next(self, i: int) -> float:
        """sigma after step i (final_sigma at the end)."""
        return float(self.sigmas[i + 1]) if i + 1 < len(self) else self.final_sigma


def make_schedule(
    num_steps: int = 50,
    shift: float = 5.0,
    sigma_min: float = 0.0,
    sigma_max: float = 1.0,
    extra_one_step: bool = True,
    denoising_strength: float = 1.0,
    num_train_timesteps: int = 1000,
    training: bool = False,
    exponential_shift: bool = False,
    exponential_shift_mu: float | None = None,
    shift_terminal: float | None = None,
    dynamic_shift_len: int | None = None,
    inverse_timesteps: bool = False,
    reverse_sigmas: bool = False,
) -> FlowMatchSchedule:
    """Build the sigma/timestep table (defaults: the goal-force inference schedule)."""
    sigma_start = sigma_min + (sigma_max - sigma_min) * denoising_strength
    if extra_one_step:
        sigmas = np.linspace(sigma_start, sigma_min, num_steps + 1, dtype=np.float64)[:-1]
    else:
        sigmas = np.linspace(sigma_start, sigma_min, num_steps, dtype=np.float64)
    if inverse_timesteps:
        sigmas = sigmas[::-1].copy()
    if exponential_shift:
        if exponential_shift_mu is not None:
            mu = exponential_shift_mu
        elif dynamic_shift_len is not None:
            mu = calculate_shift(dynamic_shift_len)
        else:
            mu = 0.0
        sigmas = math.exp(mu) / (math.exp(mu) + (1.0 / sigmas - 1.0))
    else:
        sigmas = shift * sigmas / (1.0 + (shift - 1.0) * sigmas)
    if shift_terminal is not None:
        one_minus = 1.0 - sigmas
        scale = one_minus[-1] / (1.0 - shift_terminal)
        sigmas = 1.0 - one_minus / scale
    if reverse_sigmas:
        sigmas = 1.0 - sigmas
    timesteps = sigmas * num_train_timesteps
    weights = None
    if training:
        # Gaussian bell over timestep values, normalised to sum num_steps (num_steps is
        # also the bell's scale, as in the JAX package).
        y = np.exp(-2.0 * ((timesteps - num_steps / 2.0) / num_steps) ** 2)
        y_shifted = y - y.min()
        weights = (y_shifted * (num_steps / y_shifted.sum())).astype(np.float32)
    return FlowMatchSchedule(
        sigmas=sigmas.astype(np.float32),
        timesteps=timesteps.astype(np.float32),
        num_train_timesteps=num_train_timesteps,
        final_sigma=1.0 if (inverse_timesteps or reverse_sigmas) else 0.0,
        training_weights=weights,
    )


def calculate_shift(image_seq_len: int, base_seq_len: int = 256,
                    max_seq_len: int = 8192, base_shift: float = 0.5,
                    max_shift: float = 0.9) -> float:
    """Sequence-length-dependent exponential-shift mu."""
    m = (max_shift - base_shift) / (max_seq_len - base_seq_len)
    return image_seq_len * m + (base_shift - m * base_seq_len)


def _scalar(value, like: torch.Tensor) -> torch.Tensor:
    """A 0-d tensor of `like`'s dtype: the scalar is rounded to that dtype first."""
    return torch.as_tensor(float(value), dtype=like.dtype, device=like.device)


def euler_step(sample: torch.Tensor, velocity: torch.Tensor, sigma, sigma_next) -> torch.Tensor:
    """x_{t+1} = x_t + v * (sigma_next - sigma), in the sample's dtype."""
    return sample + velocity * (_scalar(sigma_next, sample) - _scalar(sigma, sample))


def add_noise(x0: torch.Tensor, noise: torch.Tensor, sigma) -> torch.Tensor:
    """x_t = (1-sigma)*x0 + sigma*eps."""
    sigma = _scalar(sigma, x0)
    return (1.0 - sigma) * x0 + sigma * noise


def training_target(x0: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """v-target = eps - x0."""
    return noise - x0


def timestep_to_id(schedule: FlowMatchSchedule, timestep: float) -> int:
    """Nearest-timestep lookup."""
    return int(np.argmin(np.abs(schedule.timesteps - timestep)))
