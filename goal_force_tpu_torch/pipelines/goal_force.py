"""GoalForcePipeline: prompt + first-frame image + force/mass control video -> frames.

Port of the main path of ``goal_force_tpu/pipelines/goal_force.py::_generate``:
tokenize and T5-encode the prompt and the fixed negative prompt, VAE-encode the first
frame (with the 4-channel i2v mask) and the control video, run the flow-match Euler
loop with merged CFG (posi/nega as a batch of 2) and the expert switch at
``boundary * 1000`` (high-noise DiT + ControlNet above it, low-noise pair below), then
VAE-decode. ``__call__`` returns (F, H, W, 3) float32 frames in [0, 1].

Low-precision serving: pack the block linears of the four DiT/ControlNet models with
``ops.quant.quantize_linear_modules(pipe.models[name], ("self_attn", "cross_attn",
"ffn"))`` and set ``attn_impl="flash_int8"`` (K6); a pipeline so changed answers requests
as before.

Everything runs on the pipeline's device, which is CUDA unless the caller asks for the
CPU. Arguments of the JAX ``_generate`` that this port does not cover raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from goal_force_tpu_torch import configs
from goal_force_tpu_torch.configs import (
    ControlNetConfig,
    PipelineConfig,
    T5Config,
    VAEConfig,
    WanDiTConfig,
)
from goal_force_tpu_torch.models import controlnet as cnm
from goal_force_tpu_torch.models import t5 as t5m
from goal_force_tpu_torch.models import vae as vaem
from goal_force_tpu_torch.models import wan_dit
from goal_force_tpu_torch.models.tokenizer import load_tokenizer
from goal_force_tpu_torch.ops import quant
from goal_force_tpu_torch.pipelines.model_fn import denoise_forward
from goal_force_tpu_torch.schedulers import flow_match as fm

_NOT_PORTED = (
    "end_image", "input_video", "fun_control_video", "reference_image",
    "camera_control_direction", "camera_control_origin", "motion_bucket_id",
    "vace_video", "vace_video_mask", "vace_reference_image", "tea_cache_l1_thresh",
    "sliding_window_size", "sliding_window_stride", "height", "width",
    "camera_control_speed", "vace_scale", "tea_cache_model_id", "progress",
)
# Values of unported JAX arguments that select nothing, so passing them is harmless.
_JAX_DEFAULTS = {"camera_control_speed": 1 / 54, "vace_scale": 1.0,
                 "tea_cache_model_id": "Wan2.1-I2V-14B-480P", "progress": False}


def resolve_device(device) -> torch.device:
    """The requested device; CUDA (the default) must be present, never replaced."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return device


def build_i2v_mask(num_frames: int, lat_f: int, lat_h: int, lat_w: int) -> np.ndarray:
    """The 4-channel temporal mask: frame 0 repeated 4x then zeros, regrouped
    (T+3)//4 x 4 into latent-frame channels."""
    msk = np.zeros((num_frames,), np.float32)
    msk[0] = 1.0
    ext = np.concatenate([np.repeat(msk[:1], 4), msk[1:]]).reshape(lat_f, 4)
    return np.ascontiguousarray(np.broadcast_to(ext[:, None, None, :], (lat_f, lat_h, lat_w, 4)))


@dataclasses.dataclass
class GoalForcePipeline:
    dit_cfg: WanDiTConfig
    t5_cfg: T5Config
    vae_cfg: VAEConfig
    cn_cfg: Optional[ControlNetConfig]
    pipe_cfg: PipelineConfig
    models: Dict[str, torch.nn.Module]   # dit, dit2, t5, vae (+ controlnet, controlnet2)
    tokenizer: object
    dtype: torch.dtype = torch.float32
    device: torch.device = torch.device("cuda")
    attn_impl: str = "auto"

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------

    @classmethod
    def init_random(
        cls,
        seed: int = 0,
        dit_cfg: Optional[WanDiTConfig] = None,
        t5_cfg: Optional[T5Config] = None,
        vae_cfg: Optional[VAEConfig] = None,
        cn_cfg: Optional[ControlNetConfig] = ControlNetConfig(),
        pipe_cfg: Optional[PipelineConfig] = None,
        dtype: torch.dtype = torch.float32,
        device="cuda",
    ) -> "GoalForcePipeline":
        """Random weights drawn on `device` from one generator seeded with `seed`."""
        device = resolve_device(device)
        if dit_cfg is None and t5_cfg is None and vae_cfg is None:
            dit_cfg, t5_cfg, vae_cfg, tiny_cn = configs.tiny_pipeline_configs()
            if cn_cfg == ControlNetConfig():
                cn_cfg = tiny_cn
        dit_cfg = dit_cfg or configs.tiny_dit()
        t5_cfg = t5_cfg or configs.tiny_t5()
        vae_cfg = vae_cfg or configs.tiny_vae()
        gen = torch.Generator(device).manual_seed(seed)
        models = {
            "dit": wan_dit.init_wan_dit(dit_cfg, gen, dtype, device=device),
            "dit2": wan_dit.init_wan_dit(dit_cfg, gen, dtype, device=device),
            "t5": t5m.init_t5(t5_cfg, gen, dtype, device=device),
            "vae": vaem.init_vae(vae_cfg, gen, dtype, device=device),
        }
        if cn_cfg is not None:
            models["controlnet"] = cnm.init_from_dit(models["dit"], dit_cfg, cn_cfg, gen,
                                                     dtype, device=device)
            models["controlnet2"] = cnm.init_from_dit(models["dit2"], dit_cfg, cn_cfg, gen,
                                                      dtype, device=device)
        return cls(dit_cfg, t5_cfg, vae_cfg, cn_cfg, pipe_cfg or PipelineConfig(), models,
                   load_tokenizer(None, t5_cfg.vocab, t5_cfg.text_len), dtype, device)

    @classmethod
    def from_state_dicts(
        cls,
        state_dicts: Dict[str, Dict[str, torch.Tensor]],
        dit_cfg: WanDiTConfig,
        t5_cfg: T5Config,
        vae_cfg: VAEConfig,
        cn_cfg: Optional[ControlNetConfig],
        pipe_cfg: Optional[PipelineConfig] = None,
        dtype: torch.dtype = torch.float32,
        device="cuda",
    ) -> "GoalForcePipeline":
        """Build from reference-format state dicts keyed dit/dit2/t5/vae
        (+ controlnet/controlnet2). Linears that a state dict holds as int8/fp8 packs
        (``ops/quant.py``) are packed in the empty module before it loads."""
        device = resolve_device(device)
        ctors = {"dit": (wan_dit.WanDiT, dit_cfg), "dit2": (wan_dit.WanDiT, dit_cfg),
                 "t5": (t5m.T5Encoder, t5_cfg), "vae": (vaem.WanVAE, vae_cfg)}
        if cn_cfg is not None:
            ctors["controlnet"] = ctors["controlnet2"] = (
                cnm.GoalForceControlNet, dit_cfg, cn_cfg)
        models = {}
        for name, (cls_, *cfgs) in ctors.items():
            mod = wan_dit.empty_module(cls_, *cfgs, dtype=dtype, device=device)
            quant.pack_like_state_dict(mod, state_dicts[name])
            mod.load_state_dict(state_dicts[name])
            models[name] = mod.eval().requires_grad_(False)
        return cls(dit_cfg, t5_cfg, vae_cfg, cn_cfg, pipe_cfg or PipelineConfig(), models,
                   load_tokenizer(None, t5_cfg.vocab, t5_cfg.text_len), dtype, device)

    # ------------------------------------------------------------------
    # Conditioning
    # ------------------------------------------------------------------

    @torch.no_grad()
    def encode_prompts(self, prompts) -> torch.Tensor:
        """(len(prompts), text_len, dim) embeddings, zero past each prompt's length."""
        ids, mask = self.tokenizer(prompts)
        ids = torch.from_numpy(ids).to(self.device)
        mask = torch.from_numpy(mask).to(self.device)
        emb = t5m.t5_encode(self.models["t5"], self.t5_cfg, ids, mask)
        return emb * (mask[..., None] > 0)

    def _vae_encode_px(self, x: torch.Tensor) -> torch.Tensor:
        """(B, F, H, W, 3) pixels in [-1, 1] -> latents; tiled above one tile."""
        pc = self.pipe_cfg
        if pc.tiled and (x.shape[2] // 8 > pc.tile_size[0] or x.shape[3] // 8 > pc.tile_size[1]):
            return vaem.encode_video_tiled(self.models["vae"], self.vae_cfg, x,
                                           pc.tile_size, pc.tile_stride)
        return vaem.encode_video(self.models["vae"], self.vae_cfg, x)

    def _vae_decode_full(self, latents: torch.Tensor) -> torch.Tensor:
        pc = self.pipe_cfg
        if pc.tiled and (latents.shape[2] > pc.tile_size[0] or latents.shape[3] > pc.tile_size[1]):
            return vaem.decode_video_tiled(self.models["vae"], self.vae_cfg, latents,
                                           pc.tile_size, pc.tile_stride)
        return vaem.decode_video(self.models["vae"], self.vae_cfg, latents)

    @torch.no_grad()
    def encode_first_frame(self, image: np.ndarray, num_frames: int) -> torch.Tensor:
        """image (H, W, 3) float in [0, 1] -> y (1, L, h, w, 4 + z) in the pipeline dtype."""
        h, w = image.shape[:2]
        img = torch.as_tensor(np.asarray(image, np.float32), device=self.device)[None, None]
        vae_in = torch.cat([img * 2.0 - 1.0,
                            torch.zeros((1, num_frames - 1, h, w, 3), device=self.device)], dim=1)
        cond = self._vae_encode_px(vae_in)
        lat_f = (num_frames - 1) // 4 + 1
        mask = build_i2v_mask(num_frames, lat_f, cond.shape[2], cond.shape[3])
        y = torch.cat([torch.from_numpy(mask).to(self.device)[None], cond.float()], dim=-1)
        return y.to(self.dtype)

    @torch.no_grad()
    def encode_control_video(self, control_video: np.ndarray) -> torch.Tensor:
        """(F, H, W, 3) in [0, 1] -> latents (1, L, h, w, z) in the pipeline dtype."""
        x = torch.as_tensor(np.asarray(control_video, np.float32), device=self.device)[None]
        return self._vae_encode_px(x * 2.0 - 1.0).to(self.dtype)

    # ------------------------------------------------------------------
    # Generation
    # ------------------------------------------------------------------

    def _expert(self, low_noise: bool):
        if low_noise and "dit2" in self.models:
            return self.models["dit2"], self.models.get("controlnet2")
        return self.models["dit"], self.models.get("controlnet")

    @torch.no_grad()
    def denoise_step(self, dit, cn, latents, t_val: float, sigma: float, sigma_next: float,
                     context, y, control_latents, cfg_scale: float) -> torch.Tensor:
        """One Euler step. With cfg_scale != 1 the posi/nega branches run as one batch of
        2 (context rows [posi, nega]); the timestep takes the latents' dtype."""
        b = latents.shape[0]
        merged = cfg_scale != 1.0
        x = torch.cat([latents, latents]) if merged else latents
        tstep = torch.full((x.shape[0],), t_val, dtype=latents.dtype, device=latents.device)
        v = denoise_forward(
            dit, self.dit_cfg, x, tstep, context if merged else context[:1],
            y=None if y is None else (torch.cat([y, y]) if merged else y),
            controlnet=cn, controlnet_cfg=self.cn_cfg,
            control_latents=None if cn is None else (
                torch.cat([control_latents, control_latents]) if merged else control_latents),
            attn_impl=self.attn_impl)
        if merged:
            v = v[b:] + cfg_scale * (v[:b] - v[b:])
        return fm.euler_step(latents, v.to(latents.dtype), sigma, sigma_next)

    def __call__(self, *args, **kwargs) -> np.ndarray:
        return self._generate(*args, **kwargs)

    @torch.no_grad()
    def _generate(
        self,
        prompt: str,
        input_image: Optional[np.ndarray] = None,         # (H, W, 3) float [0, 1]
        control_signal_video: Optional[np.ndarray] = None,  # (F, H, W, 3) float [0, 1]
        negative_prompt: Optional[str] = None,
        denoising_strength: float = 1.0,
        seed: int = 0,
        noise: Optional[torch.Tensor] = None,             # (1, L, h, w, z) initial latents
        num_frames: Optional[int] = None,
        num_inference_steps: Optional[int] = None,
        cfg_scale: Optional[float] = None,
        sigma_shift: Optional[float] = None,
        switch_dit_boundary: Optional[float] = None,
        controlnet: bool = True,
        tiled: Optional[bool] = None,
        tile_size: Optional[tuple] = None,
        tile_stride: Optional[tuple] = None,
        **unported,
    ) -> np.ndarray:
        """Returns (F, H, W, 3) float32 frames in [0, 1].

        noise: the initial latents; by default drawn with torch.randn from a generator
        seeded with `seed` on the pipeline's device.
        """
        given = {k: v for k, v in unported.items()
                 if v is not None and v != _JAX_DEFAULTS.get(k, None)}
        if given:
            bad = sorted(given)
            known = [k for k in bad if k in _NOT_PORTED]
            raise NotImplementedError(
                f"not ported yet: {known}" if known else f"unknown arguments: {bad}")
        if input_image is None:
            raise NotImplementedError("text-to-video (input_image=None) is not ported yet")
        overrides = {k: v for k, v in (("tiled", tiled), ("tile_size", tile_size),
                                       ("tile_stride", tile_stride)) if v is not None}
        saved = self.pipe_cfg
        self.pipe_cfg = dataclasses.replace(saved, **overrides)
        try:
            return self._generate_i2v(
                prompt, input_image, control_signal_video, negative_prompt,
                denoising_strength, seed, noise, num_frames, num_inference_steps, cfg_scale,
                sigma_shift, switch_dit_boundary, controlnet)
        finally:
            self.pipe_cfg = saved

    def _generate_i2v(self, prompt, input_image, control_signal_video, negative_prompt,
                      denoising_strength, seed, noise, num_frames, num_inference_steps,
                      cfg_scale, sigma_shift, switch_dit_boundary, controlnet):
        pc = self.pipe_cfg
        num_frames = num_frames or pc.num_frames
        steps = num_inference_steps or pc.num_inference_steps
        cfg_scale = pc.cfg_scale if cfg_scale is None else cfg_scale
        shift = sigma_shift or pc.sigma_shift
        boundary = switch_dit_boundary or pc.switch_dit_boundary
        negative_prompt = pc.negative_prompt if negative_prompt is None else negative_prompt
        schedule = fm.make_schedule(num_steps=steps, shift=shift, sigma_min=0.0,
                                    extra_one_step=True, denoising_strength=denoising_strength)

        ctx = self.encode_prompts([prompt, negative_prompt])       # (2, L, text_dim)
        y = self.encode_first_frame(input_image, num_frames)
        h, w = input_image.shape[:2]
        use_cn = (controlnet and control_signal_video is not None
                  and "controlnet" in self.models)
        if use_cn and control_signal_video.shape[0] != num_frames:
            raise ValueError(f"control_signal_video has {control_signal_video.shape[0]} "
                             f"frames, expected num_frames={num_frames}")
        control_latents = self.encode_control_video(control_signal_video) if use_cn else None

        shape = (1, (num_frames - 1) // 4 + 1, h // 8, w // 8, self.vae_cfg.z_dim)
        if noise is None:
            gen = torch.Generator(self.device).manual_seed(seed)
            latents = torch.randn(shape, generator=gen, device=self.device, dtype=torch.float32)
        else:
            latents = torch.as_tensor(noise, device=self.device)
            if tuple(latents.shape) != shape:
                raise ValueError(f"noise has shape {tuple(latents.shape)}, expected {shape}")
        latents = latents.to(self.dtype)

        switch_t = boundary * schedule.num_train_timesteps
        for i in range(len(schedule)):
            t_val = float(schedule.timesteps[i])
            dit, cn = self._expert(low_noise=t_val < switch_t)
            latents = self.denoise_step(dit, cn if use_cn else None, latents, t_val,
                                        float(schedule.sigmas[i]), schedule.sigma_next(i),
                                        ctx, y, control_latents, cfg_scale)

        video = self._vae_decode_full(latents.float())
        return ((video[0] + 1.0) / 2.0).float().cpu().numpy()
