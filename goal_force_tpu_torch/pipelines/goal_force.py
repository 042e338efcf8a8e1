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

Construction: ``from_pretrained`` reads the reference's files (the high- and low-noise
experts as a safetensors path, glob or list of shards, the umt5 encoder and the Wan2.1
VAE as ``.pth`` or safetensors, a ``step-K.safetensors`` ControlNet checkpoint and a
tokenizer directory); ``init_random`` and ``from_state_dicts`` build from a seed or from
state dicts. ``host_stage_experts()`` keeps only the active expert and its ControlNet on
the device and the standby pair in host memory, swapped once per crossing of the
boundary (``parallel/host_staging.py``): that is how full A14B depth fits one 80 GB card
in bf16.

Serving options of the JAX loop that the port runs as JAX does: ``tea_cache_l1_thresh``
(TeaCache, ``pipelines/teacache.py``: with merged CFG, a step whose accumulated
timestep-embedding drift stays under the threshold skips the blocks and adds the last
computed step's token residual; the residual carries across the expert switch) and
``sliding_window_size``/``sliding_window_stride`` (each step denoises overlapping
windows of latent frames, each with its ControlNet, and blends them).

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
from goal_force_tpu_torch.parallel.host_staging import ExpertStager, stage_to_host
from goal_force_tpu_torch.pipelines.model_fn import (
    denoise_forward,
    denoise_forward_skip,
    temporal_tiled_forward,
)
from goal_force_tpu_torch.pipelines.teacache import TeaCache
from goal_force_tpu_torch.schedulers import flow_match as fm

_NOT_PORTED = (
    "end_image", "input_video", "fun_control_video", "reference_image",
    "camera_control_direction", "camera_control_origin", "motion_bucket_id",
    "vace_video", "vace_video_mask", "vace_reference_image", "height", "width",
    "camera_control_speed", "vace_scale",
)
# Values of unported JAX arguments that select nothing, so passing them is harmless.
_JAX_DEFAULTS = {"camera_control_speed": 1 / 54, "vace_scale": 1.0}


def resolve_device(device) -> torch.device:
    """The requested device; CUDA (the default) must be present, never replaced."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return device


def load_weights(path) -> Dict[str, torch.Tensor]:
    """A state dict from a ``.pth``/``.pt`` pickle or from safetensors (one file, a glob
    or a list of shards), its tensors on the CPU in the file's dtypes."""
    from goal_force_tpu_torch.io.safetensors_io import load_safetensors, load_torch_pth

    if str(path).endswith((".pth", ".pt")):
        return load_torch_pth(path)
    return load_safetensors(path)


def load_state_dict_strict(module: torch.nn.Module, sd: Dict[str, torch.Tensor],
                           what: str) -> None:
    """Copy `sd` into `module` (cast to its dtype). A missing or unexpected key, or a
    shape that does not fit, raises an error naming it: nothing is left at its initial
    value."""
    want = module.state_dict()
    missing, unexpected = sorted(set(want) - set(sd)), sorted(set(sd) - set(want))
    if missing or unexpected:
        raise KeyError(f"{what}: {len(missing)} missing keys {missing[:8]}, "
                       f"{len(unexpected)} unexpected keys {unexpected[:8]}")
    bad = [(k, tuple(sd[k].shape), tuple(v.shape)) for k, v in want.items()
           if tuple(sd[k].shape) != tuple(v.shape)]
    if bad:
        raise ValueError(f"{what}: shapes (file, model) do not fit: {bad[:8]}")
    module.load_state_dict(sd)


def vae_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Strip the ``model.`` prefix that the reference's converter puts on the VAE."""
    return {k[len("model."):] if k.startswith("model.") else k: v for k, v in sd.items()}


def _progress_bar(total: int):
    from tqdm import tqdm

    return tqdm(total=total, desc="denoising")


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
    _stager: Optional[ExpertStager] = dataclasses.field(default=None, repr=False)
    _stager_low: bool = dataclasses.field(default=False, repr=False)

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------

    @classmethod
    def from_pretrained(
        cls,
        high_noise_model,                 # safetensors path, glob or list (civitai names)
        low_noise_model=None,
        t5_path: Optional[str] = None,    # .pth or .safetensors
        vae_path: Optional[str] = None,
        controlnet_checkpoint: Optional[str] = None,
        controlnet_num_layers: int = 10,
        controlnet_stride: Optional[int] = None,
        tokenizer_path: Optional[str] = None,
        vace_path: Optional[str] = None,
        vace_layers: Optional[tuple] = None,
        motion_controller_path: Optional[str] = None,
        camera_adapter_path: Optional[str] = None,
        dit_cfg: Optional[WanDiTConfig] = None,
        t5_cfg: Optional[T5Config] = None,
        vae_cfg: Optional[VAEConfig] = None,
        pipe_cfg: Optional[PipelineConfig] = None,
        dtype: torch.dtype = torch.bfloat16,
        seed: int = 0,
        device="cuda",
        host_stage_experts: bool = False,
    ) -> "GoalForcePipeline":
        """Build the pipeline from reference-format weight files.

        Both ControlNets are initialised from their experts' first blocks with zero
        convs and one patch embedding drawn from `seed` (the JAX package draws both
        from one key); a checkpoint overlays only ``controlnet`` (the high-noise one),
        as the reference loads it. With `host_stage_experts` the low-noise expert and
        its ControlNet are read into host memory and never placed on the device; the
        first crossing of the boundary swaps them in.
        """
        device = resolve_device(device)
        for name, value in (("controlnet_stride", controlnet_stride), ("vace_path", vace_path),
                            ("vace_layers", vace_layers),
                            ("motion_controller_path", motion_controller_path),
                            ("camera_adapter_path", camera_adapter_path)):
            if value is not None:
                raise NotImplementedError(f"{name} is not ported yet")
        dit_cfg = dit_cfg or configs.WAN22_A14B
        t5_cfg = t5_cfg or configs.UMT5_XXL
        vae_cfg = vae_cfg or configs.WAN21_VAE
        cn_cfg = (ControlNetConfig(num_layers=controlnet_num_layers, in_channels=vae_cfg.z_dim)
                  if controlnet_num_layers > 0 else None)
        stage = host_stage_experts and low_noise_model is not None
        host = torch.device("cpu") if stage else device

        def load(cls_, cfg, path, on, transform=None):
            sd = load_weights(path)
            if transform is not None:
                sd = transform(sd)
            mod = wan_dit.empty_module(cls_, cfg, dtype=dtype, device=on)
            if on.type == "cpu" and device.type == "cuda":
                stage_to_host({"m": mod}, pin_memory=True)   # pinned, then filled
            load_state_dict_strict(mod, sd, str(path))
            return mod.eval().requires_grad_(False)

        gen = torch.Generator(device).manual_seed(seed)
        models = {"dit": load(wan_dit.WanDiT, dit_cfg, high_noise_model, device)}
        if cn_cfg is not None:
            models["controlnet"] = cnm.init_from_dit(models["dit"], dit_cfg, cn_cfg, gen,
                                                     dtype, device=device)
        if low_noise_model is not None:
            models["dit2"] = load(wan_dit.WanDiT, dit_cfg, low_noise_model, host)
            if cn_cfg is not None:
                cn2 = cnm.init_from_dit(models["dit2"], dit_cfg, cn_cfg, torch.Generator(host),
                                        dtype, device=host)
                cn2.controlnet_patch_embedding.load_state_dict(
                    models["controlnet"].controlnet_patch_embedding.state_dict())
                if stage:
                    stage_to_host({"controlnet": cn2}, pin_memory=device.type == "cuda")
                models["controlnet2"] = cn2
        if cn_cfg is not None and controlnet_checkpoint is not None:
            from goal_force_tpu_torch.io.safetensors_io import load_goalforce_controlnet

            load_state_dict_strict(models["controlnet"],
                                   load_goalforce_controlnet(controlnet_checkpoint),
                                   str(controlnet_checkpoint))
        if t5_path is not None:
            models["t5"] = load(t5m.T5Encoder, t5_cfg, t5_path, device)
        if vae_path is not None:
            models["vae"] = load(vaem.WanVAE, vae_cfg, vae_path, device, vae_state_dict)
        tok = load_tokenizer(tokenizer_path, t5_cfg.vocab, t5_cfg.text_len)
        pipe = cls(dit_cfg, t5_cfg, vae_cfg, cn_cfg, pipe_cfg or PipelineConfig(), models,
                   tok, dtype, device)
        return pipe.host_stage_experts() if stage else pipe

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
        tok = load_tokenizer(None, t5_cfg.vocab, t5_cfg.text_len, quiet=True)
        return cls(dit_cfg, t5_cfg, vae_cfg, cn_cfg, pipe_cfg or PipelineConfig(), models,
                   tok, dtype, device)

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
        tok = load_tokenizer(None, t5_cfg.vocab, t5_cfg.text_len, quiet=True)
        return cls(dit_cfg, t5_cfg, vae_cfg, cn_cfg, pipe_cfg or PipelineConfig(), models,
                   tok, dtype, device)

    def host_stage_experts(self) -> "GoalForcePipeline":
        """Keep the high-noise expert and its ControlNet on the device and the
        low-noise pair in host memory (pinned on CUDA); ``_expert`` swaps them once per
        crossing of the boundary. A pipeline with one expert stays as it is."""
        if "dit2" in self.models:
            active, standby = {"dit": self.models["dit"]}, {"dit": self.models["dit2"]}
            if "controlnet" in self.models:
                active["controlnet"] = self.models["controlnet"]
            if "controlnet2" in self.models:
                standby["controlnet"] = self.models["controlnet2"]
            self._stager = ExpertStager(active, standby, self.device)
            self._stager_low = False
        return self

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
        """(dit, controlnet) of the requested expert; with host staging, the standby
        pair is swapped in at most once per crossing of the boundary."""
        if self._stager is None:
            if low_noise and "dit2" in self.models:
                return self.models["dit2"], self.models.get("controlnet2")
            return self.models["dit"], self.models.get("controlnet")
        if low_noise != self._stager_low:
            self._stager.swap()
            self._stager_low = low_noise
        active = self._stager.active
        return active["dit"], active.get("controlnet")

    @torch.no_grad()
    def denoise_step(self, dit, cn, latents, t_val: float, sigma: float, sigma_next: float,
                     context, y, control_latents, cfg_scale: float,
                     return_residual: bool = False):
        """One Euler step. With cfg_scale != 1 the posi/nega branches run as one batch of
        2 (context rows [posi, nega]); the timestep takes the latents' dtype.
        return_residual: also return the blocks' token residual (TeaCache's full step)."""
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
            attn_impl=self.attn_impl, return_token_states=return_residual)
        if return_residual:
            v, (pre, post) = v
        if merged:
            v = v[b:] + cfg_scale * (v[:b] - v[b:])
        out = fm.euler_step(latents, v.to(latents.dtype), sigma, sigma_next)
        return (out, post - pre) if return_residual else out

    @torch.no_grad()
    def _t_mod(self, dit, t_val: float, batch: int) -> np.ndarray:
        """The DiT's modulated timestep input (batch, 6, D) on the host, in float32."""
        tstep = torch.full((batch,), t_val, dtype=self.dtype, device=self.device)
        return wan_dit.time_embed(dit, self.dit_cfg, tstep)[1].float().cpu().numpy()

    @torch.no_grad()
    def denoise_step_skip(self, dit, latents, t_val: float, sigma: float, sigma_next: float,
                          y, residual, cfg_scale: float) -> torch.Tensor:
        """TeaCache's skipped merged-CFG step: the cached residual replaces the blocks."""
        b = latents.shape[0]
        x = torch.cat([latents, latents])
        tstep = torch.full((2 * b,), t_val, dtype=latents.dtype, device=latents.device)
        v = denoise_forward_skip(dit, self.dit_cfg, x, tstep,
                                 None if y is None else torch.cat([y, y]), residual)
        v = v[b:] + cfg_scale * (v[:b] - v[b:])
        return fm.euler_step(latents, v.to(latents.dtype), sigma, sigma_next)

    @torch.no_grad()
    def sliding_window_step(self, dit, cn, latents, t_val: float, sigma: float,
                            sigma_next: float, context, y, control_latents, cfg_scale: float,
                            window: int, stride: int) -> torch.Tensor:
        """One Euler step over temporal windows of the latents (merged CFG in each
        window, whatever cfg_scale is, as in the JAX package); the ControlNet runs inside
        each window on its slice of the control latents."""
        b = latents.shape[0]
        t2 = torch.full((2 * b,), t_val, dtype=latents.dtype, device=latents.device)

        def window_fn(lat_w, y_w, cl_w):
            x2 = torch.cat([lat_w, lat_w])
            y2 = None if y_w is None else torch.cat([y_w, y_w])
            cl2 = None if cl_w is None else torch.cat([cl_w, cl_w])
            v = denoise_forward(dit, self.dit_cfg, x2, t2, context, y=y2,
                                controlnet=cn if cl2 is not None else None,
                                controlnet_cfg=self.cn_cfg, control_latents=cl2,
                                attn_impl=self.attn_impl)
            return v[b:] + cfg_scale * (v[:b] - v[b:])

        v = temporal_tiled_forward(window_fn, latents, y, window, stride,
                                   control_latents if cn is not None else None)
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
        tea_cache_l1_thresh: Optional[float] = None,
        tea_cache_model_id: str = "Wan2.1-I2V-14B-480P",
        sliding_window_size: Optional[int] = None,
        sliding_window_stride: Optional[int] = None,
        tiled: Optional[bool] = None,
        tile_size: Optional[tuple] = None,
        tile_stride: Optional[tuple] = None,
        progress: bool = False,
        **unported,
    ) -> np.ndarray:
        """Returns (F, H, W, 3) float32 frames in [0, 1].

        noise: the initial latents; by default drawn with torch.randn from a generator
        seeded with `seed` on the pipeline's device. progress: show each denoising step
        (through tqdm); the frames are the same.
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
                sigma_shift, switch_dit_boundary, controlnet, progress,
                tea_cache_l1_thresh, tea_cache_model_id, sliding_window_size,
                sliding_window_stride)
        finally:
            self.pipe_cfg = saved

    def _generate_i2v(self, prompt, input_image, control_signal_video, negative_prompt,
                      denoising_strength, seed, noise, num_frames, num_inference_steps,
                      cfg_scale, sigma_shift, switch_dit_boundary, controlnet, progress,
                      tea_cache_l1_thresh, tea_cache_model_id, sliding_window_size,
                      sliding_window_stride):
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

        tea_cache = (TeaCache(steps, tea_cache_l1_thresh, tea_cache_model_id)
                     if tea_cache_l1_thresh is not None else None)
        switch_t = boundary * schedule.num_train_timesteps
        bar = _progress_bar(len(schedule)) if progress else None
        for i in range(len(schedule)):
            t_val = float(schedule.timesteps[i])
            dit, cn = self._expert(low_noise=t_val < switch_t)
            cn = cn if use_cn else None
            sig, sig_n = float(schedule.sigmas[i]), schedule.sigma_next(i)
            if sliding_window_size is not None and sliding_window_stride is not None:
                latents = self.sliding_window_step(
                    dit, cn, latents, t_val, sig, sig_n, ctx, y, control_latents, cfg_scale,
                    sliding_window_size, sliding_window_stride)
            elif tea_cache is not None and cfg_scale != 1.0:
                t_mod = self._t_mod(dit, t_val, 2 * latents.shape[0])
                if tea_cache.should_skip(t_mod) and tea_cache.residual is not None:
                    latents = self.denoise_step_skip(dit, latents, t_val, sig, sig_n, y,
                                                     tea_cache.residual, cfg_scale)
                else:
                    latents, tea_cache.residual = self.denoise_step(
                        dit, cn, latents, t_val, sig, sig_n, ctx, y, control_latents,
                        cfg_scale, return_residual=True)
            else:
                latents = self.denoise_step(dit, cn, latents, t_val, sig, sig_n, ctx, y,
                                            control_latents, cfg_scale)
            if bar is not None:
                bar.update(1)
        if bar is not None:
            bar.close()

        video = self._vae_decode_full(latents.float())
        return ((video[0] + 1.0) / 2.0).float().cpu().numpy()
