"""Stable Diffusion 3 / 3.5 text-to-image and image-to-image pipeline in PyTorch.

Port of ``goal_force_tpu/pipelines/sd3.py``: the prompt embedding is the sequence
concatenation of (CLIP-L's and bigG's hidden states side by side, zero-padded to the
DiT's text width) and T5 v1.1 XXL's states (zeros where the pipeline has no T5); the
pooled embedding is cat(CLIP-L's pooled, bigG's projected pooled) (2048); the flow-match
Euler schedule (shift 3.0, sigma_min 0.003 / 1.002, no extra step; ``denoising_strength``
with an input image); classifier-free guidance as ONE merged forward over the rows
(prompt, negative prompt, each local prompt); the 16-channel SD3 VAE with SD3's
(scaling, shift), run in float32 over the pipeline's weights as JAX runs it.

Every argument of JAX ``SD3Pipeline.__call__`` is here: ``sigma_shift``, ``input_image``
with ``denoising_strength``, regional prompting (``local_prompts``, ``masks``,
``mask_scales`` and the blur: ``pipelines/regional.py``), ``tiled`` (the whole DiT per
latent tile of ``tile_size`` at ``tile_stride``, the encode per pixel tile of
``tile_size`` x the VAE factor, the decode per latent tile), ``progress`` and
``return_latents``. The port adds ``noise=`` (the initial latents in place of the seeded
draw: the two packages' RNG streams differ) and ``device``.

Entry points run on the card unless ``device="cpu"`` is passed; ``__call__`` returns
(H, W, 3) float32 numpy in [0, 1].
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from goal_force_tpu_torch.configs import T5Config
from goal_force_tpu_torch.models import sd3_dit as sd3
from goal_force_tpu_torch.models import sd_vae as sv
from goal_force_tpu_torch.models import t5 as t5m
from goal_force_tpu_torch.models.clip import CLIPConfig, CLIPTextModel, init_clip_text
from goal_force_tpu_torch.models.sd_text_encoder import (
    SD_TEXT_CONFIG,
    SDXL_TEXT2_CONFIG,
    sd3_text1_encode,
    sdxl_text2_encode,
)
from goal_force_tpu_torch.models.tiler import tiled_forward_2d
from goal_force_tpu_torch.models.tokenizer import hash_ids
from goal_force_tpu_torch.pipelines.flux import _factor, tiny_sd3_vae_plans
from goal_force_tpu_torch.pipelines.goal_force import resolve_device
from goal_force_tpu_torch.schedulers import flow_match as fm

SD3_SHIFT = 3.0
SD3_SIGMA_MIN = 0.003 / 1.002


def tiny_sd3_configs():
    """JAX's tiny configs for tests: (DiT, T5, CLIP-L, bigG)."""
    dit_cfg = sd3.SD3DiTConfig(dim=64, num_layers=3, num_dual_blocks=1, use_rms_norm=True,
                               pos_embed_max_size=16, text_dim=48, pooled_dim=40,
                               freq_dim=32)
    t5_cfg = T5Config(vocab=128, dim=48, dim_attn=48, dim_ffn=96, num_heads=4,
                      num_layers=2, shared_pos=True, text_len=16)
    clip1 = dataclasses.replace(SD_TEXT_CONFIG, text_dim=16, text_heads=2, text_layers=2)
    clip2 = dataclasses.replace(SDXL_TEXT2_CONFIG, text_dim=24, text_heads=2, text_layers=2)
    return dit_cfg, t5_cfg, clip1, clip2


def init_bigg(cfg: CLIPConfig, gen: torch.Generator, dtype=torch.float32, *,
              device) -> CLIPTextModel:
    """A random bigG-shaped tower (final LN, a square bias-free projection)."""
    return init_clip_text(cfg, gen, dtype, device=device, projection=True,
                          proj_dim=cfg.text_dim)


@dataclasses.dataclass
class SD3Pipeline:
    dit: sd3.SD3DiT
    clip1: CLIPTextModel
    clip2: CLIPTextModel
    t5: Optional[t5m.T5Encoder]
    vae_encoder: Optional[sv.SDVAEEncoder]
    vae_decoder: sv.SDVAEDecoder
    dit_cfg: sd3.SD3DiTConfig
    t5_cfg: T5Config
    clip1_cfg: CLIPConfig = SD_TEXT_CONFIG
    clip2_cfg: CLIPConfig = SDXL_TEXT2_CONFIG
    vae_scaling: Tuple[float, float] = sv.SD3_SCALING
    vae_groups: int = 32
    vae_factor: int = 8
    tokenize_clip: Optional[Callable] = None
    tokenize_clip2: Optional[Callable] = None   # bigG's (pads differently); else CLIP-L's
    tokenize_t5: Optional[Callable] = None
    dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "auto"

    @property
    def device(self) -> torch.device:
        return self.dit.proj_out.weight.device

    @classmethod
    def init_random(cls, seed: int = 0, dtype=torch.float32, device="cuda") -> "SD3Pipeline":
        """Random weights from `seed` at the tiny configs and VAE plans."""
        device = resolve_device(device)
        dit_cfg, t5_cfg, clip1_cfg, clip2_cfg = tiny_sd3_configs()
        enc_plan, dec_plan, groups = tiny_sd3_vae_plans()
        gen = torch.Generator(device).manual_seed(seed)
        return cls(
            dit=sd3.init_sd3_dit(dit_cfg, gen, dtype, device=device),
            clip1=init_clip_text(clip1_cfg, gen, dtype, device=device),
            clip2=init_bigg(clip2_cfg, gen, dtype, device=device),
            t5=t5m.init_t5(t5_cfg, gen, dtype, device=device),
            vae_encoder=sv.init_sd_vae(sv.SDVAEEncoder, enc_plan, gen, dtype, device=device),
            vae_decoder=sv.init_sd_vae(sv.SDVAEDecoder, dec_plan, gen, dtype, device=device),
            dit_cfg=dit_cfg, t5_cfg=t5_cfg, clip1_cfg=clip1_cfg, clip2_cfg=clip2_cfg,
            vae_groups=groups, vae_factor=_factor(enc_plan), dtype=dtype)

    @classmethod
    def from_pretrained(
        cls,
        dit_path,
        text_encoder_path=None,            # CLIP-L (reference naming)
        text_encoder_2_path=None,          # bigG with its projection
        text_encoder_3_path=None,          # T5 v1.1 XXL (optional)
        vae_encoder_path=None,
        vae_decoder_path=None,
        tokenizer="vendored",              # CLIP ids for both towers; None -> hash ids
        tokenizer_t5="vendored",
        t5_length: int = 128,
        vae_plans=None,                    # (enc_plan, dec_plan, groups)
        dtype: torch.dtype = torch.bfloat16,
        clip_num_heads=None,
        t5_num_heads=None,
        device="cuda",
    ) -> "SD3Pipeline":
        """Load the reference-format files strictly (``io/auto.py::load_model``), every
        model in `dtype` on `device`. A missing CLIP tower is drawn at random (seed 0), as
        JAX draws it (bigG with its projection, which JAX's draw lacks); without a T5 the
        prompt's T5 rows are zeros, as in JAX."""
        from goal_force_tpu_torch.io.auto import load_model

        device = resolve_device(device)
        load = lambda path, **kw: load_model(path, dtype=dtype, device=device, **kw)
        dit = load(dit_path)
        if dit["kind"] != "sd3_dit":
            raise ValueError(f"{dit_path} detected as {dit['kind']!r}, not sd3_dit")
        enc_plan, dec_plan, groups = vae_plans or (sv.SD_VAE_ENCODER_PLAN,
                                                   sv.SD_VAE_DECODER_PLAN, 32)
        gen = torch.Generator(device).manual_seed(0)
        clip1_cfg, clip1 = SD_TEXT_CONFIG, None
        if text_encoder_path is not None:
            r = load(text_encoder_path, num_heads=clip_num_heads)
            clip1_cfg, clip1 = r["config"], r["model"]
        clip2_cfg, clip2 = SDXL_TEXT2_CONFIG, None
        if text_encoder_2_path is not None:
            r = load(text_encoder_2_path, num_heads=clip_num_heads)
            clip2_cfg, clip2 = r["config"], r["model"]
        t5_cfg, t5 = None, None
        if text_encoder_3_path is not None:
            r = load(text_encoder_3_path, num_heads=t5_num_heads)
            t5_cfg, t5 = dataclasses.replace(r["config"], text_len=t5_length), r["model"]
        vae_enc = vae_dec = None
        if vae_encoder_path is not None:
            vae_enc = load(vae_encoder_path, plan=enc_plan)["model"]
        if vae_decoder_path is not None:
            vae_dec = load(vae_decoder_path, plan=dec_plan)["model"]

        tok_clip, tok_clip2, tok_t5 = tokenizer, None, tokenizer_t5
        if tokenizer == "vendored" or tokenizer_t5 == "vendored":
            from goal_force_tpu_torch.prompters import sd3_tokenizers

            v1, v2, v3 = sd3_tokenizers(t5_length=t5_length)
            if tokenizer == "vendored":
                tok_clip, tok_clip2 = v1, v2
            tok_t5 = v3 if tokenizer_t5 == "vendored" else tokenizer_t5
        return cls(
            dit=dit["model"],
            clip1=clip1 if clip1 is not None else init_clip_text(clip1_cfg, gen, dtype,
                                                                 device=device),
            clip2=clip2 if clip2 is not None else init_bigg(clip2_cfg, gen, dtype,
                                                            device=device),
            t5=t5, vae_encoder=vae_enc, vae_decoder=vae_dec, dit_cfg=dit["config"],
            t5_cfg=t5_cfg or tiny_sd3_configs()[1], clip1_cfg=clip1_cfg, clip2_cfg=clip2_cfg,
            vae_groups=groups, vae_factor=_factor(enc_plan), tokenize_clip=tok_clip,
            tokenize_clip2=tok_clip2, tokenize_t5=tok_t5, dtype=dtype)

    # ------------------------------------------------------------------
    # Stages
    # ------------------------------------------------------------------

    def _ids(self, prompts):
        tok2 = self.tokenize_clip2 or self.tokenize_clip
        clip_ids = np.stack([np.asarray(self.tokenize_clip(p)) if self.tokenize_clip
                             else hash_ids(p, self.clip1_cfg.vocab_size, 77) for p in prompts])
        clip2_ids = np.stack([np.asarray(tok2(p)) if tok2
                              else hash_ids(p, self.clip2_cfg.vocab_size, 77) for p in prompts])
        t5_ids = np.stack([np.asarray(self.tokenize_t5(p)) if self.tokenize_t5
                           else hash_ids(p, self.t5_cfg.vocab, self.t5_cfg.text_len)
                           for p in prompts])
        as_ids = lambda a: torch.as_tensor(a, dtype=torch.long, device=self.device)
        return as_ids(clip_ids), as_ids(clip2_ids), as_ids(t5_ids)

    def _encode_text(self, prompts):
        """(prompt states (B, 77 + L_t5, text_dim), pooled (B, 2048)) in the pipeline's
        dtype."""
        clip_ids, clip2_ids, t5_ids = self._ids(prompts)
        pooled1, hidden1 = sd3_text1_encode(self.clip1, clip_ids, self.clip1_cfg)
        pooled2, hidden2 = sdxl_text2_encode(self.clip2, clip2_ids, self.clip2_cfg)
        clip_hidden = torch.cat([hidden1, hidden2], dim=-1)
        clip_hidden = torch.nn.functional.pad(
            clip_hidden, (0, self.dit_cfg.text_dim - clip_hidden.shape[-1]))
        if self.t5 is not None:
            t5_emb = t5m.t5_encode(self.t5, self.t5_cfg, t5_ids, torch.ones_like(t5_ids))
        else:
            t5_emb = clip_hidden.new_zeros((clip_ids.shape[0], t5_ids.shape[1],
                                            self.dit_cfg.text_dim))
        prompt_emb = torch.cat([clip_hidden, t5_emb.to(clip_hidden.dtype)], dim=1)
        pooled = torch.cat([pooled1, pooled2], dim=-1)
        return prompt_emb.to(self.dtype), pooled.to(self.dtype)

    def _encode(self, img: torch.Tensor) -> torch.Tensor:
        return sv.sd3_vae_encode(self.vae_encoder, img, self.vae_scaling, self.vae_groups)

    def _decode(self, z: torch.Tensor) -> torch.Tensor:
        return sv.sd3_vae_decode(self.vae_decoder, z, self.vae_scaling, self.vae_groups)

    def _forward(self, x, t, prompt_emb, pooled):
        return sd3.sd3_dit_forward(self.dit, self.dit_cfg, x, t, prompt_emb, pooled,
                                   attn_impl=self.attn_impl)

    def _velocity(self, latents, timestep, prompt_emb, pooled, cfg_scale: float,
                  tile_ctx=None, local_w=None):
        """One merged forward over every prompt row (prompt, negative, locals), then the
        regional blend and the guidance; with tile_ctx (tile, stride) the whole DiT per
        latent tile."""
        b = latents.shape[0]
        n = prompt_emb.shape[0] // b
        x = torch.cat([latents] * n)
        t = torch.cat([timestep] * n)
        if tile_ctx is not None:
            v = tiled_forward_2d(lambda xt: self._forward(xt, t, prompt_emb, pooled), x,
                                 *tile_ctx).to(x.dtype)
        else:
            v = self._forward(x, t, prompt_emb, pooled)
        v_pos, v_neg = v[:b], v[b:2 * b]
        if local_w is not None:
            from goal_force_tpu_torch.pipelines.regional import blend_local_predictions

            v_pos = blend_local_predictions(v_pos, v[2 * b:], local_w)
        return v_neg + cfg_scale * (v_pos - v_neg)

    @torch.no_grad()
    def __call__(
        self,
        prompt: str,
        negative_prompt: str = "",
        cfg_scale: float = 7.0,
        height: int = 1024,
        width: int = 1024,
        num_inference_steps: int = 28,
        sigma_shift: Optional[float] = None,
        seed: int = 0,
        input_image: Optional[np.ndarray] = None,    # (H, W, 3) in [0, 1]
        denoising_strength: float = 1.0,
        local_prompts=None,
        masks=None,
        mask_scales=None,
        local_blur_kernel_size: int = 33,
        local_blur_sigma: float = 10.0,
        progress: bool = False,
        tiled: bool = False,
        tile_size: int = 128,
        tile_stride: int = 64,
        return_latents: bool = False,
        noise=None,                                  # (1, h, w, 16) initial latents
    ) -> np.ndarray:
        """Returns (H, W, 3) float32 in [0, 1] (the latents with return_latents)."""
        dev, dtype = self.device, self.dtype
        schedule = fm.make_schedule(
            num_steps=num_inference_steps,
            shift=SD3_SHIFT if sigma_shift is None else sigma_shift,
            sigma_min=SD3_SIGMA_MIN, extra_one_step=False,
            denoising_strength=denoising_strength if input_image is not None else 1.0)
        local_prompts = list(local_prompts or [])
        prompt_emb, pooled = self._encode_text([prompt, negative_prompt] + local_prompts)

        h, w = height // self.vae_factor, width // self.vae_factor
        local_w = None
        if local_prompts:
            from goal_force_tpu_torch.pipelines.regional import local_prompt_weights

            local_w = torch.as_tensor(local_prompt_weights(
                masks, mask_scales, h, w, local_blur_kernel_size, local_blur_sigma),
                device=dev)
        shape = (1, h, w, 16)
        if noise is None:
            gen = torch.Generator(dev).manual_seed(seed)
            noise = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        noise = (noise if torch.is_tensor(noise) else torch.from_numpy(
            np.array(noise, np.float32))).to(dev, torch.float32)
        if tuple(noise.shape) != shape:
            raise ValueError(f"noise has shape {tuple(noise.shape)}, expected {shape}")
        latents = noise.to(dtype)
        if input_image is not None:
            img = torch.as_tensor(np.asarray(input_image, np.float32) * 2.0 - 1.0,
                                  device=dev)[None]
            if tiled:
                z = tiled_forward_2d(self._encode, img, tile_size * self.vae_factor,
                                     tile_stride * self.vae_factor)
            else:
                z = self._encode(img)
            latents = fm.add_noise(z.to(dtype), latents, schedule.sigmas[0]).to(dtype)
        steps = range(len(schedule))
        if progress:
            import tqdm

            steps = tqdm.tqdm(steps)
        for i in steps:
            tstep = torch.full((1,), float(schedule.timesteps[i]), dtype=dtype, device=dev)
            v = self._velocity(latents, tstep, prompt_emb, pooled, cfg_scale,
                               tile_ctx=(tile_size, tile_stride) if tiled else None,
                               local_w=local_w)
            latents = fm.euler_step(latents, v.to(latents.dtype), schedule.sigmas[i],
                                    schedule.sigma_next(i))
        if return_latents:
            return latents.float().cpu().numpy()
        z = latents.float()
        img = tiled_forward_2d(self._decode, z, tile_size, tile_stride) if tiled \
            else self._decode(z)
        return ((img[0] + 1.0) / 2.0).float().cpu().numpy().clip(0.0, 1.0)
