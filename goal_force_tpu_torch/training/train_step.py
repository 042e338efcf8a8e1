"""ControlNet training: loss, optimizer and the train step.

Port of ``goal_force_tpu/training/train_step.py`` (ControlNet-only training):

  - one timestep id per step, uniform in [min_b, max_b) x 1000 of the 1000-entry
    descending training schedule (shift 5; boundary 0.358 by default);
  - x_t = (1 - sigma) x0 + sigma eps, target v = eps - x0, Gaussian-bell step weight;
  - global-norm clip 1.0, then AdamW (lr 1e-5, betas (0.9, 0.999), eps 1e-8, weight
    decay 0.01), optionally averaging k micro-steps first (``optax.MultiSteps``);
  - only the ControlNet trains; the DiT, T5 and VAE stay frozen.

The JAX step is one jitted function; here it is eager PyTorch: the three VAE encodes and
the T5 encode run under ``no_grad``, the denoiser forward runs with a checkpoint per
block, ``torch.autograd.grad`` takes the ControlNet's gradients, and the optimizer
updates the parameters and its state in place. On CUDA every differentiated attention
goes through ``FlashAttentionFn`` (K3 forward, K4/K5 backward).
"""

from __future__ import annotations

import dataclasses
import time
from contextlib import contextmanager
from typing import Callable, Dict, Optional

import numpy as np
import torch

from goal_force_tpu_torch.configs import ControlNetConfig, T5Config, VAEConfig, WanDiTConfig
from goal_force_tpu_torch.models import t5 as t5m
from goal_force_tpu_torch.models import vae as vaem
from goal_force_tpu_torch.pipelines.goal_force import build_i2v_mask, resolve_device
from goal_force_tpu_torch.pipelines.model_fn import denoise_forward
from goal_force_tpu_torch.schedulers import flow_match as fm

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    params: torch.nn.Module            # the trainable ControlNet
    opt_state: Tensors                 # AdamW.init(...) of its parameters
    step: int = 0


def trainable_params(module: torch.nn.Module) -> Tensors:
    return {n: p for n, p in module.named_parameters() if p.requires_grad}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32."""
    return torch.stack([t.float().square().sum() for t in tensors]).sum().sqrt()


B1, B2, EPS = 0.9, 0.999, 1e-8      # AdamW betas and epsilon (the JAX optimizer's)


class AdamW:
    """optax.chain(clip_by_global_norm(grad_clip), adamw(lr, B1, B2, EPS, weight_decay)),
    wrapped in optax.MultiSteps(every_k_schedule=grad_accum_steps) when that is > 1.

    The state is a flat dict of tensors: ``count`` (applied updates), ``exp_avg.<name>``
    and ``exp_avg_sq.<name>`` in the parameters' dtype, and with accumulation
    ``mini_step`` and ``acc_grads.<name>``. Arithmetic is float32; moments and
    parameters are rounded back to their dtype. The clip has no epsilon: gradients are
    scaled by grad_clip / norm only when norm >= grad_clip, as optax does.
    """

    def __init__(self, lr: float = 1e-5, weight_decay: float = 0.01, grad_clip: float = 1.0,
                 grad_accum_steps: int = 1):
        self.lr, self.weight_decay, self.grad_clip = lr, weight_decay, grad_clip
        self.grad_accum_steps = grad_accum_steps

    def init(self, params: Tensors) -> Tensors:
        device = next(iter(params.values())).device
        state = {"count": torch.zeros((), dtype=torch.int64, device=device)}
        for n, p in params.items():
            state[f"exp_avg.{n}"] = torch.zeros_like(p)
            state[f"exp_avg_sq.{n}"] = torch.zeros_like(p)
        if self.grad_accum_steps > 1:
            state["mini_step"] = torch.zeros((), dtype=torch.int64, device=device)
            for n, p in params.items():
                state[f"acc_grads.{n}"] = torch.zeros_like(p)
        return state

    @torch.no_grad()
    def update(self, grads: Tensors, state: Tensors, params: Tensors) -> bool:
        """Apply one (micro-)step in place; True when the parameters were updated."""
        k = self.grad_accum_steps
        if k > 1:
            n_acc = int(state["mini_step"])
            for n, g in grads.items():
                acc = state[f"acc_grads.{n}"]
                acc.copy_(acc.float() + (g.float() - acc.float()) / (n_acc + 1))
            if n_acc < k - 1:
                state["mini_step"].add_(1)
                return False
            state["mini_step"].zero_()
            grads = {n: state[f"acc_grads.{n}"].clone() for n in grads}
            for n in grads:
                state[f"acc_grads.{n}"].zero_()
        self._adamw(grads, state, params)
        return True

    def _adamw(self, grads: Tensors, state: Tensors, params: Tensors) -> None:
        norm = global_norm(grads.values())
        clipped = norm >= self.grad_clip                   # a device tensor: no host sync
        state["count"].add_(1)
        count = state["count"].float()
        f32 = dict(dtype=torch.float32, device=count.device)
        bc1 = 1.0 - torch.tensor(B1, **f32) ** count
        bc2 = 1.0 - torch.tensor(B2, **f32) ** count
        for n, p in params.items():
            g = grads[n].float()
            g = torch.where(clipped, g / norm * self.grad_clip, g)
            mu, nu = state[f"exp_avg.{n}"], state[f"exp_avg_sq.{n}"]
            mu.copy_((1.0 - B1) * g + B1 * mu.float())
            nu.copy_((1.0 - B2) * g.square() + B2 * nu.float())
            u = (mu.float() / bc1) / ((nu.float() / bc2).sqrt() + EPS)
            u = u + self.weight_decay * p.float()
            p.copy_(p.float() + (-self.lr) * u)


def make_optimizer(lr: float = 1e-5, weight_decay: float = 0.01, grad_clip: float = 1.0,
                   grad_accum_steps: int = 1) -> AdamW:
    """AdamW with global-norm clipping; grad_accum_steps > 1 averages that many
    micro-steps' gradients and updates only on the last of them."""
    return AdamW(lr, weight_decay, grad_clip, grad_accum_steps)


def training_loss(dit, cn, dit_cfg: WanDiTConfig, cn_cfg: Optional[ControlNetConfig],
                  x0, noise, sigma, timestep, weight, context, y, control_latents,
                  attn_impl: str = "auto", remat: bool = True) -> torch.Tensor:
    """Weighted v-MSE of the denoiser (float32 scalar)."""
    latents = fm.add_noise(x0, noise, sigma)
    target = fm.training_target(x0, noise)
    v = denoise_forward(dit, dit_cfg, latents, timestep, context, y=y, controlnet=cn,
                        controlnet_cfg=cn_cfg, control_latents=control_latents,
                        attn_impl=attn_impl, remat=remat)
    loss = (v.float() - target.float()).square().mean()
    return loss * weight


@contextmanager
def _stage(timings: Optional[Dict[str, float]], name: str, device: torch.device):
    """If timings is a dict: adds the stage's seconds (synchronised) to timings[name] and,
    on CUDA, its peak allocated memory to timings[name + "_peak_gb"] (this resets the
    device's peak-memory counter)."""
    if timings is None:
        yield
        return
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    yield
    if cuda:
        torch.cuda.synchronize(device)
        timings[name + "_peak_gb"] = torch.cuda.max_memory_allocated(device) / 2**30
    timings[name] = timings.get(name, 0.0) + time.perf_counter() - t0


def make_train_step(
    dit_cfg: WanDiTConfig,
    t5_cfg: T5Config,
    vae_cfg: VAEConfig,
    cn_cfg: Optional[ControlNetConfig],
    optimizer: AdamW,
    num_frames: int = 81,
    max_timestep_boundary: float = 0.358,
    min_timestep_boundary: float = 0.0,
    attn_impl: str = "auto",
    train_lora: bool = False,
    lora_alpha: Optional[float] = None,
    pp_microbatches: Optional[int] = None,
) -> Callable:
    """Returns step(state, frozen, batch, generator=None, *, tid=None, noise=None,
    timings=None) -> (state, metrics), which updates `state` in place.

    frozen: {"dit", "t5", "vae"} modules. batch (device tensors, channels-last):
      video, control: (B, T, H, W, 3) in [-1, 1]; ids, mask: (B, text_len) ints.
    generator: a torch.Generator on the batch's device; the timestep id (in
    [min_b, max_b) x 1000) is drawn from it first, then the noise. tid= and noise= give
    both explicitly instead (a test feeds JAX's draws). timings: a dict that collects the
    seconds of each stage (encodes, t5, forward_backward, optimizer), synchronised, and on
    CUDA each stage's peak memory.
    metrics: loss, grad_norm (before clipping) and timestep, as floats.
    """
    if train_lora or lora_alpha is not None:
        raise NotImplementedError("LoRA training is not ported yet")
    if pp_microbatches:
        raise NotImplementedError("pipeline-parallel training is not ported yet")
    schedule = fm.make_schedule(num_steps=1000, shift=5.0, sigma_min=0.0,
                                extra_one_step=True, training=True)
    lo = int(min_timestep_boundary * schedule.num_train_timesteps)
    hi = int(max_timestep_boundary * schedule.num_train_timesteps)

    def step(state: TrainState, frozen: Dict[str, torch.nn.Module], batch: Tensors,
             generator: Optional[torch.Generator] = None, *, tid: Optional[int] = None,
             noise: Optional[torch.Tensor] = None,
             timings: Optional[Dict[str, float]] = None):
        dit, t5, vae = frozen["dit"], frozen["t5"], frozen["vae"]
        video = batch["video"]
        device = video.device
        b, t = video.shape[:2]
        if t != num_frames:
            raise ValueError(f"batch has {t} frames, the step was made for {num_frames}")
        with torch.no_grad():
            # Encode in the VAE's own dtype (float32 pixels would run it in float32).
            vae_dtype = next(vae.parameters()).dtype
            video = video.to(vae_dtype)
            with _stage(timings, "vae_encode_video", device):
                x0 = vaem.encode_video(vae, vae_cfg, video)
            with _stage(timings, "vae_encode_control", device):
                control_latents = vaem.encode_video(vae, vae_cfg, batch["control"].to(vae_dtype))
            with _stage(timings, "vae_encode_first_frame", device):
                first = torch.cat([video[:, :1], torch.zeros_like(video[:, 1:])], dim=1)
                cond = vaem.encode_video(vae, vae_cfg, first)
                del first
            lat_f = (t - 1) // 4 + 1
            mask = torch.from_numpy(build_i2v_mask(t, lat_f, cond.shape[2], cond.shape[3]))
            y = torch.cat([mask.to(device)[None].expand(*cond.shape[:-1], 4), cond.float()],
                          dim=-1)
            with _stage(timings, "t5", device):
                context = t5m.t5_encode(t5, t5_cfg, batch["ids"], batch["mask"])
                context = context * (batch["mask"][..., None] > 0)

        if tid is None:
            if generator is None:
                raise ValueError("pass a generator, or tid= and noise=")
            tid = int(torch.randint(lo, hi, (1,), generator=generator, device=device))
        if not lo <= tid < hi:
            raise ValueError(f"tid {tid} outside [{lo}, {hi})")
        if noise is None:
            if generator is None:
                raise ValueError("pass a generator, or tid= and noise=")
            noise = torch.randn(x0.shape, generator=generator, device=device, dtype=x0.dtype)
        noise = noise.to(device=device, dtype=x0.dtype)
        sigma = float(schedule.sigmas[tid])
        timestep = torch.full((b,), float(schedule.timesteps[tid]), dtype=x0.dtype,
                              device=device)
        weight = float(schedule.training_weights[tid])

        params = trainable_params(state.params)
        with _stage(timings, "forward_backward", device):
            with torch.enable_grad():
                loss = training_loss(dit, state.params, dit_cfg, cn_cfg, x0, noise, sigma,
                                     timestep, weight, context, y, control_latents,
                                     attn_impl=attn_impl, remat=True)
                grads = torch.autograd.grad(loss, list(params.values()))
        grads = dict(zip(params, grads))
        with _stage(timings, "optimizer", device):
            gnorm = global_norm(grads.values())
            optimizer.update(grads, state.opt_state, params)
        state.step += 1
        metrics = {"loss": float(loss.detach()), "grad_norm": float(gnorm),
                   "timestep": float(schedule.timesteps[tid])}
        return state, metrics

    return step


def host_batch(video: np.ndarray, control: np.ndarray, ids: np.ndarray, mask: np.ndarray,
               device="cuda") -> Tensors:
    """Device tensors from host arrays (pixels already in [-1, 1])."""
    device = resolve_device(device)
    return {"video": torch.as_tensor(video, device=device),
            "control": torch.as_tensor(control, device=device),
            "ids": torch.as_tensor(ids, device=device),
            "mask": torch.as_tensor(mask, device=device)}
