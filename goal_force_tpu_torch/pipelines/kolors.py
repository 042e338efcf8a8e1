"""Kolors text-to-image pipeline in PyTorch: ChatGLM3 over SDXL's UNet.

Port of ``goal_force_tpu/pipelines/kolors.py``: ChatGLM3's ``hidden_states[-2]`` as the
4,096-wide prompt embedding (projected to 2,048 inside the UNet by
``text_intermediate_proj``) and its last pre-norm token as the pooled embedding of the
5,632-wide add embedding; the DDIM schedule at ``beta_end=0.014`` and
``num_train_timesteps=1100``; classifier-free guidance as ONE merged batch a step; the
SD VAE at SDXL's scaling 0.13025, encode and decode in float32 over the pipeline's
weights.

The request paths: text-to-image, image-to-image (``input_image`` in [0, 1] with
``denoising_strength``), regional prompts and ``tiled`` (the encode on pixel tiles of
``tile_size`` x 8, the decode on latent tiles of ``min(tile_size, h, w)``). Without
``tokenize`` the ids are JAX's 32 hash ids a prompt (``models/tokenizer.py::hash_ids``).

The port adds ``noise=`` and ``device``; entry points run on the card unless
``device="cpu"`` is passed. ``__call__`` returns (H, W, 3) float32 numpy in [0, 1].
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from goal_force_tpu_torch.models import sd_vae as sv
from goal_force_tpu_torch.models.kolors_text_encoder import (
    ChatGLMConfig,
    ChatGLMModel,
    chatglm_encode,
    init_chatglm,
)
from goal_force_tpu_torch.models.sd_unet import SDUNet
from goal_force_tpu_torch.models.sdxl_unet import init_sdxl_unet, sdxl_unet_apply
from goal_force_tpu_torch.models.tiler import tiled_forward_2d
from goal_force_tpu_torch.models.tokenizer import hash_ids
from goal_force_tpu_torch.pipelines.goal_force import resolve_device
from goal_force_tpu_torch.pipelines.sd import encode_batch, guided, initial_noise, local_weights
from goal_force_tpu_torch.pipelines.sdxl import size_ids
from goal_force_tpu_torch.schedulers.ddim import ddim_add_noise, ddim_step, make_ddim_schedule

KOLORS_BETA_END = 0.014
KOLORS_TRAIN_STEPS = 1100


def tiny_kolors_configs():
    """JAX's tiny (ChatGLM config, UNet plan) for tests."""
    glm_cfg = ChatGLMConfig(hidden_size=32, ffn_hidden_size=48, num_layers=2, num_heads=4,
                            kv_channels=8, kv_groups=2, vocab=96)
    plan = (("res", 8, 8), ("push",), ("down", 8), ("push",),
            ("res", 8, 16), ("attn", 2, 8, 16, 24, 2), ("res", 16, 16),
            ("pop",), ("res", 24, 16), ("attn", 2, 8, 16, 24, 2),
            ("up", 16), ("pop",), ("res", 24, 8))
    return glm_cfg, plan


@dataclasses.dataclass
class KolorsPipeline:
    unet: SDUNet
    glm: ChatGLMModel
    vae_encoder: Optional[sv.SDVAEEncoder]
    vae_decoder: sv.SDVAEDecoder
    glm_cfg: ChatGLMConfig
    groups: int = 32
    vae_groups: int = 32
    vae_factor: int = 8
    vae_scaling: float = sv.SDXL_SCALING_FACTOR
    tokenize: Optional[Callable] = None
    dtype: torch.dtype = torch.bfloat16

    @property
    def plan(self):
        return self.unet.plan

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    @classmethod
    def from_pretrained(cls, unet_path, text_encoder_path=None, vae_encoder_path=None,
                        vae_decoder_path=None, tokenizer="vendored", glm_length: int = 256,
                        plan=None, groups: int = 32, vae_plans=None, dtype=torch.bfloat16,
                        glm_num_heads=None, device="cuda") -> "KolorsPipeline":
        """Kolors' files read strictly (``io/auto.py::load_model``): the SDXL-architecture
        UNet (raises on any other kind, as JAX does), ChatGLM3 and the VAE halves
        (vae_plans: (encoder plan, decoder plan, groups)); the vendored ChatGLM3 tokenizer
        at glm_length. Without ChatGLM the tiny one is drawn from seed 0 (JAX draws it
        from ``PRNGKey(0)``)."""
        from goal_force_tpu_torch.io.auto import load_model
        from goal_force_tpu_torch.models.sdxl_unet import SDXL_PLAN

        device = resolve_device(device)
        load = lambda path, **kw: load_model(path, dtype=dtype, device=device, **kw)
        unet = load(unet_path, plan=plan or SDXL_PLAN)
        if unet["kind"] != "sdxl_unet":
            raise ValueError(f"{unet_path} detected as {unet['kind']!r}")
        if text_encoder_path is not None:
            r = load(text_encoder_path, num_heads=glm_num_heads)
            glm_cfg, glm = r["config"], r["model"]
        else:
            glm_cfg = tiny_kolors_configs()[0]
            glm = init_chatglm(glm_cfg, torch.Generator(device).manual_seed(0), dtype,
                               device=device)
        enc_plan, dec_plan, vgroups = vae_plans or (sv.SD_VAE_ENCODER_PLAN,
                                                    sv.SD_VAE_DECODER_PLAN, 32)
        enc = dec = None
        if vae_encoder_path is not None:
            enc = load(vae_encoder_path, kind="sd_vae_encoder", plan=enc_plan)["model"]
        if vae_decoder_path is not None:
            dec = load(vae_decoder_path, kind="sd_vae_decoder", plan=dec_plan)["model"]
        tok = tokenizer
        if tokenizer == "vendored":
            from goal_force_tpu_torch.prompters import kolors_tokenizer

            tok = kolors_tokenizer(length=glm_length)
        return cls(unet=unet["model"], glm=glm, vae_encoder=enc, vae_decoder=dec,
                   glm_cfg=glm_cfg, groups=groups, vae_groups=vgroups, tokenize=tok,
                   dtype=dtype)

    @classmethod
    def init_random(cls, seed: int = 0, dtype=torch.float32,
                    device="cuda") -> "KolorsPipeline":
        """JAX's tiny pipeline, random weights from `seed`."""
        device = resolve_device(device)
        gen = torch.Generator(device).manual_seed(seed)
        glm_cfg, plan = tiny_kolors_configs()
        unet = init_sdxl_unet(plan, gen, dtype, device=device, model_dim=8, time_dim=16,
                              add_embed_in=glm_cfg.hidden_size + 6 * 256,
                              text_proj=(glm_cfg.hidden_size, 24))
        enc, dec = sv.init_tiny_sd_vae(gen, dtype, device=device)
        return cls(unet=unet, glm=init_chatglm(glm_cfg, gen, dtype, device=device),
                   vae_encoder=enc, vae_decoder=dec, glm_cfg=glm_cfg, groups=4, vae_groups=4,
                   dtype=dtype)

    def _ids(self, prompts) -> torch.Tensor:
        ids = np.stack([np.asarray(self.tokenize(p)) if self.tokenize
                        else hash_ids(p, self.glm_cfg.vocab, 32) for p in prompts])
        return torch.as_tensor(ids, dtype=torch.long, device=self.device)

    def _encode_text(self, ids: torch.Tensor):
        return chatglm_encode(self.glm, self.glm_cfg, ids, clip_skip=2)

    def _denoise_cfg(self, latents, t: float, ctx2, pooled2, add_time_id, cfg_scale: float,
                     local_w=None):
        """The guided epsilon of one merged [posi, nega, local_1..L] batch."""
        b = latents.shape[0]
        n = ctx2.shape[0] // b
        eps = sdxl_unet_apply(self.unet, torch.cat([latents] * n),
                              torch.full((n * b,), t, dtype=latents.dtype, device=latents.device),
                              ctx2, add_time_id, pooled2, groups=self.groups)
        return guided(eps, b, cfg_scale, local_w)

    def _encode(self, img: torch.Tensor) -> torch.Tensor:
        return sv.sd_vae_encode(self.vae_encoder, img, self.vae_groups, self.vae_scaling)

    def _decode(self, z: torch.Tensor) -> torch.Tensor:
        return sv.sd_vae_decode(self.vae_decoder, z, self.vae_groups, self.vae_scaling)

    @torch.no_grad()
    def __call__(self, prompt: str, negative_prompt: str = "", cfg_scale: float = 7.5,
                 height: int = 1024, width: int = 1024, num_inference_steps: int = 20,
                 seed: int = 0, input_image: Optional[np.ndarray] = None,
                 denoising_strength: float = 1.0, local_prompts=None, masks=None,
                 mask_scales=None, local_blur_kernel_size: int = 33,
                 local_blur_sigma: float = 10.0, tiled: bool = False, tile_size: int = 64,
                 tile_stride: int = 32, progress: bool = False, return_latents: bool = False,
                 noise=None) -> np.ndarray:
        dev, dtype = self.device, self.dtype
        schedule = make_ddim_schedule(num_inference_steps, beta_end=KOLORS_BETA_END,
                                      num_train_timesteps=KOLORS_TRAIN_STEPS,
                                      denoising_strength=denoising_strength
                                      if input_image is not None else 1.0)
        local_prompts = list(local_prompts or [])
        ctx2, pooled2 = self._encode_text(self._ids([prompt, negative_prompt] + local_prompts))
        ctx2, pooled2 = ctx2.to(dtype), pooled2.to(dtype)
        h, w = height // self.vae_factor, width // self.vae_factor
        local_w = None
        if local_prompts:
            local_w = local_weights(masks, mask_scales, h, w, local_blur_kernel_size,
                                    local_blur_sigma, dev)
        latents = initial_noise(noise, seed, (1, h, w, 4), dev, dtype)
        if input_image is not None:
            img = torch.as_tensor(np.asarray(input_image, np.float32) * 2.0 - 1.0,
                                  device=dev)[None]
            px = tile_size * self.vae_factor
            z = (tiled_forward_2d(self._encode, img, px, tile_stride * self.vae_factor,
                                  batch=encode_batch(px)) if tiled else self._encode(img))
            latents = ddim_add_noise(schedule, z.to(dtype), latents,
                                     int(schedule.timesteps[0])).to(dtype)
        add_time_id = size_ids(height, width, dev).repeat(2 + len(local_prompts))
        steps = range(len(schedule))
        if progress:
            import tqdm

            steps = tqdm.tqdm(steps)
        for i in steps:
            eps = self._denoise_cfg(latents, float(schedule.timesteps[i]), ctx2, pooled2,
                                    add_time_id, cfg_scale, local_w=local_w)
            latents = ddim_step(schedule, eps.to(latents.dtype), i, latents)
        if return_latents:
            return latents.float().cpu().numpy()
        z = latents.float()
        img = (tiled_forward_2d(self._decode, z, min(tile_size, h, w), tile_stride) if tiled
               else self._decode(z))
        return ((img[0] + 1.0) / 2.0).float().cpu().numpy().clip(0.0, 1.0)
