"""S2VPipeline: speech-to-video (Wan2.2-S2V-14B) on the port.

Port of ``goal_force_tpu/pipelines/s2v.py``: T5-encode the prompt and the negative
prompt, VAE-encode the input image into the reference latent (frame 0), optionally the
pose video (``s2v_pose_video``, padded with -1 to num_frames - 1 frames, frame 0
repeated in front, its first latent frame dropped) and a 73-frame motion video (whose
19 latent frames are packed into extra tokens), then run the flow-match Euler loop with
two batch-1 forwards per step under CFG (the negative branch with the negative prompt and
zeroed audio) and re-pin the reference latent after every step. With a motion video the
motion latents lead the decoded latents, in place of the reference frame. The encodes and
the decode are untiled and in float32, as JAX's.

The port's additions: ``noise=`` (the initial latents; the two packages' random streams
differ), ``device`` (CUDA unless the CPU is asked for) and ``dtype``; ``attn_impl`` takes
the port's names ("auto", "plain", "flash", "flash_int8", "ring"). ``input_audio=`` raises a
``TypeError`` as the JAX package does (its ``audio_features`` passes ``batch_frames`` to
``Wav2Vec2Features.extract``, which has no such parameter): pass ``audio_embeds``, from
``models/audio.py`` (``Wav2Vec2Features.extract`` and ``get_audio_embed_bucket_fps``).

Under a mesh (the ``mesh`` field, or ``shard(mesh)``; every rank calls the pipeline
alike) a request runs with the mesh ambient, as JAX's ``__call__`` does: every S2V
attention then splits its heads over ("sp", "tp") and its batch rows over "dp" and
gathers them back, or with ``attn_impl="ring"`` rings its tokens over "sp"
(``ops/attention.py::attention``); the linears, the audio injection's projections and
the VAE stay replicated, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from goal_force_tpu_torch import configs
from goal_force_tpu_torch.configs import PipelineConfig, T5Config, VAEConfig
from goal_force_tpu_torch.models import s2v as s2vm
from goal_force_tpu_torch.models import t5 as t5m
from goal_force_tpu_torch.models import vae as vaem
from goal_force_tpu_torch.models import wan_dit
from goal_force_tpu_torch.models.s2v import S2VConfig
from goal_force_tpu_torch.models.tokenizer import load_tokenizer
from goal_force_tpu_torch.pipelines.goal_force import (
    _progress_bar,
    initial_latents,
    load_state_dict_strict,
    load_weights,
    resolve_device,
    t5_encode_prompts,
    vae_state_dict,
)
from goal_force_tpu_torch.schedulers import flow_match as fm

MOTION_FRAMES = 73  # frames of a motion video (19 latent frames)


@dataclasses.dataclass
class S2VPipeline:
    cfg: S2VConfig
    t5_cfg: T5Config
    vae_cfg: VAEConfig
    pipe_cfg: PipelineConfig
    models: Dict[str, torch.nn.Module]   # s2v, t5, vae
    tokenizer: object
    dtype: torch.dtype = torch.bfloat16
    device: torch.device = torch.device("cuda")
    attn_impl: str = "auto"
    mesh: Optional[object] = None

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------

    @classmethod
    def from_pretrained(
        cls,
        s2v_model,                        # safetensors path/glob/list, or a state dict
        t5_path=None,                     # .pth / safetensors path, or a state dict
        vae_path=None,
        tokenizer_path: Optional[str] = None,
        cfg: Optional[S2VConfig] = None,
        t5_cfg: Optional[T5Config] = None,
        vae_cfg: Optional[VAEConfig] = None,
        pipe_cfg: Optional[PipelineConfig] = None,
        dtype: torch.dtype = torch.bfloat16,
        device="cuda",
    ) -> "S2VPipeline":
        """Read the S2V DiT, umt5 and the Wan2.1 VAE (``model.`` stripped) strictly: a
        missing, unexpected or mis-shaped key raises."""
        device = resolve_device(device)
        cfg = cfg or S2VConfig()
        t5_cfg = t5_cfg or configs.UMT5_XXL
        vae_cfg = vae_cfg or configs.WAN21_VAE

        def read(src):
            return src if isinstance(src, dict) else load_weights(src)

        def build(cls_, c, src, what, transform=None):
            sd = read(src)
            if transform is not None:
                sd = transform(sd)
            mod = wan_dit.empty_module(cls_, c, dtype=dtype, device=device)
            load_state_dict_strict(mod, sd, what)
            return mod.eval().requires_grad_(False)

        models = {"s2v": build(s2vm.WanS2V, cfg, s2v_model, "s2v")}
        if t5_path is not None:
            models["t5"] = build(t5m.T5Encoder, t5_cfg, t5_path, "t5")
        if vae_path is not None:
            models["vae"] = build(vaem.WanVAE, vae_cfg, vae_path, "vae", vae_state_dict)
        tok = load_tokenizer(tokenizer_path, t5_cfg.vocab, t5_cfg.text_len)
        return cls(cfg, t5_cfg, vae_cfg, pipe_cfg or PipelineConfig(), models, tok, dtype,
                   device)

    @classmethod
    def init_random(cls, seed: int = 0, cfg: Optional[S2VConfig] = None,
                    t5_cfg: Optional[T5Config] = None, vae_cfg: Optional[VAEConfig] = None,
                    pipe_cfg: Optional[PipelineConfig] = None,
                    dtype: torch.dtype = torch.float32, device="cuda") -> "S2VPipeline":
        """Random weights drawn on `device` from one generator seeded with `seed` (tiny
        configs by default; the S2V DiT's in_dim and cond_dim must be the VAE's z)."""
        device = resolve_device(device)
        cfg = cfg or s2vm.tiny_s2v()
        t5_cfg = t5_cfg or configs.tiny_t5()
        vae_cfg = vae_cfg or configs.tiny_vae()
        gen = torch.Generator(device).manual_seed(seed)
        models = {"s2v": s2vm.init_s2v(cfg, gen, dtype, device=device),
                  "t5": t5m.init_t5(t5_cfg, gen, dtype, device=device),
                  "vae": vaem.init_vae(vae_cfg, gen, dtype, device=device)}
        tok = load_tokenizer(None, t5_cfg.vocab, t5_cfg.text_len, quiet=True)
        return cls(cfg, t5_cfg, vae_cfg, pipe_cfg or PipelineConfig(), models, tok, dtype,
                   device)

    # ------------------------------------------------------------------
    # Stages
    # ------------------------------------------------------------------

    def encode_prompts(self, prompts) -> torch.Tensor:
        return t5_encode_prompts(self.models["t5"], self.t5_cfg, self.tokenizer, prompts,
                                 self.device)

    @torch.no_grad()
    def _encode_px(self, video_01: np.ndarray) -> torch.Tensor:
        """(F, H, W, 3) in [0, 1] -> (1, L, h, w, z), untiled in float32."""
        x = torch.as_tensor(np.asarray(video_01, np.float32), device=self.device)[None]
        return vaem.encode_video(self.models["vae"], self.vae_cfg,
                                 x * 2.0 - 1.0).to(self.dtype)

    @torch.no_grad()
    def _decode(self, latents: torch.Tensor) -> torch.Tensor:
        return vaem.decode_video(self.models["vae"], self.vae_cfg, latents.float())

    @torch.no_grad()
    def _pose_latents(self, s2v_pose_video: np.ndarray, num_frames: int,
                      h: int, w: int) -> torch.Tensor:
        """(<= F - 1, H, W, 3) -> (1, L - 1, h, w, z): padded with -1 to num_frames - 1
        frames, frame 0 repeated in front, encoded, the first latent frame dropped."""
        infer_frames = num_frames - 1
        pose = np.asarray(s2v_pose_video, np.float32)[:infer_frames] * 2.0 - 1.0
        if pose.shape[0] < infer_frames:
            pad = -np.ones((infer_frames - pose.shape[0], h, w, 3), np.float32)
            pose = np.concatenate([pose, pad], axis=0)
        pose = np.concatenate([pose[:1], pose], axis=0)
        x = torch.as_tensor(pose, device=self.device)[None]
        lat = vaem.encode_video(self.models["vae"], self.vae_cfg, x)
        return lat[:, 1:].to(self.dtype)

    def audio_features(self, input_audio: np.ndarray, audio_sample_rate: int,
                       num_frames: int, fps: int = 16,
                       wav2vec_path: Optional[str] = None) -> np.ndarray:
        """Raw waveform -> stacked wav2vec2 features: refused as the JAX package refuses
        it (its call passes batch_frames=num_frames - 1 to ``Wav2Vec2Features.extract``,
        which has no such parameter)."""
        raise TypeError("Wav2Vec2Features.extract() got an unexpected keyword argument "
                        "'batch_frames': S2VPipeline.audio_features cannot run (as in the "
                        "JAX package); pass audio_embeds from Wav2Vec2Features.extract and "
                        "get_audio_embed_bucket_fps instead")

    @torch.no_grad()
    def denoise_step(self, latents, ref_lat, timestep, sigma: float, sigma_next: float,
                     ctx_posi, ctx_nega, audio, motion_latents, pose_cond,
                     cfg_scale: Optional[float]) -> torch.Tensor:
        """One Euler step over latents (1, L, h, w, z) whose frame 0 is re-pinned to
        ref_lat before and after."""
        x = torch.cat([ref_lat, latents[:, 1:]], dim=1)
        model = self.models["s2v"]
        v = s2vm.wan_s2v_forward(model, self.cfg, x, timestep, ctx_posi, audio,
                                 motion_latents, pose_cond, self.attn_impl)
        if cfg_scale is not None:
            v_nega = s2vm.wan_s2v_forward(model, self.cfg, x, timestep, ctx_nega,
                                          torch.zeros_like(audio), motion_latents,
                                          pose_cond, self.attn_impl)
            v = v_nega + cfg_scale * (v - v_nega)
        stepped = fm.euler_step(x, v.to(x.dtype), sigma, sigma_next)
        return torch.cat([ref_lat, stepped[:, 1:]], dim=1)

    # ------------------------------------------------------------------
    # Generation
    # ------------------------------------------------------------------

    def shard(self, mesh) -> "S2VPipeline":
        """Serve over `mesh` (``parallel/mesh.py::make_mesh``): sets the ``mesh`` field and
        returns the pipeline. The weights stay whole on every rank; the attentions split
        their work (see the module docstring)."""
        self.mesh = mesh
        return self

    def __call__(self, *args, **kwargs) -> np.ndarray:
        """Generate one clip (see ``_generate``), with the pipeline's mesh ambient."""
        from goal_force_tpu_torch.parallel.mesh import use_mesh

        with use_mesh(self.mesh):
            return self._generate(*args, **kwargs)

    @torch.no_grad()
    def _generate(
        self,
        prompt: str,
        input_image: np.ndarray,                      # (H, W, 3) float [0, 1]
        audio_embeds: Optional[np.ndarray] = None,    # (1, layers, C, F - 1)
        input_audio: Optional[np.ndarray] = None,     # raw waveform (refused, see above)
        audio_sample_rate: int = 16000,
        wav2vec_path: Optional[str] = None,
        s2v_pose_video: Optional[np.ndarray] = None,  # (<= F - 1, H, W, 3) float [0, 1]
        motion_video: Optional[np.ndarray] = None,    # (73, H, W, 3) float [0, 1]
        negative_prompt: Optional[str] = None,
        seed: int = 0,
        num_frames: Optional[int] = None,
        num_inference_steps: Optional[int] = None,
        cfg_scale: Optional[float] = None,
        sigma_shift: Optional[float] = None,
        progress: bool = False,
        noise: Optional[torch.Tensor] = None,         # (1, L, h, w, z) initial latents
    ) -> np.ndarray:
        """Returns (F, H, W, 3) float32 frames in [0, 1] (with a motion video, 72 + F
        frames: the motion latents' decode leads). noise: the initial latents; by
        default drawn with torch.randn from a generator seeded with `seed` on the
        pipeline's device."""
        pc = self.pipe_cfg
        num_frames = num_frames or pc.num_frames
        steps = num_inference_steps or pc.num_inference_steps
        cfg_scale = pc.cfg_scale if cfg_scale is None else cfg_scale
        shift = sigma_shift or pc.sigma_shift
        negative_prompt = pc.negative_prompt if negative_prompt is None else negative_prompt
        h, w = input_image.shape[:2]

        if audio_embeds is None:
            if input_audio is None:
                raise ValueError("pass audio_embeds or input_audio")
            audio_embeds = self.audio_features(input_audio, audio_sample_rate, num_frames,
                                               wav2vec_path=wav2vec_path)
        audio = torch.as_tensor(np.asarray(audio_embeds), device=self.device).to(self.dtype)

        ctx = self.encode_prompts([prompt, negative_prompt])
        ctx_posi, ctx_nega = ctx[:1], ctx[1:]
        ref_lat = self._encode_px(input_image[None])              # (1, 1, h, w, z)

        motion_latents = None
        if motion_video is not None:
            if motion_video.shape[0] != MOTION_FRAMES:
                raise ValueError(f"motion_video must have {MOTION_FRAMES} frames, "
                                 f"got {motion_video.shape[0]}")
            motion_latents = self._encode_px(motion_video)
            packer_c = self.models["s2v"].frame_packer.proj.weight.shape[1]
            if motion_latents.shape[-1] != packer_c:
                raise ValueError(
                    f"motion latents have {motion_latents.shape[-1]} channels but the "
                    f"frame packer expects {packer_c} (VAE z_dim mismatch)")
        pose_cond = (self._pose_latents(s2v_pose_video, num_frames, h, w)
                     if s2v_pose_video is not None else None)

        schedule = fm.make_schedule(num_steps=steps, shift=shift, sigma_min=0.0,
                                    extra_one_step=True)
        lat_f = (num_frames - 1) // 4 + 1
        latents = initial_latents((1, lat_f, h // 8, w // 8, self.vae_cfg.z_dim), seed, noise,
                                  self.device, self.dtype)

        cfg_arg = None if cfg_scale == 1.0 else cfg_scale
        bar = _progress_bar(len(schedule)) if progress else None
        for i in range(len(schedule)):
            tstep = torch.full((1,), float(schedule.timesteps[i]), dtype=self.dtype,
                               device=self.device)
            latents = self.denoise_step(latents, ref_lat, tstep, float(schedule.sigmas[i]),
                                        schedule.sigma_next(i), ctx_posi, ctx_nega, audio,
                                        motion_latents, pose_cond, cfg_arg)
            if bar is not None:
                bar.update(1)
        if bar is not None:
            bar.close()
        if motion_latents is not None:
            latents = torch.cat([motion_latents, latents[:, 1:]], dim=1)
        video = self._decode(latents)
        return ((video[0] + 1.0) / 2.0).float().cpu().numpy()
