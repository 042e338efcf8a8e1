"""OmniGen image generation in PyTorch.

Port of ``goal_force_tpu/pipelines/omnigen_image.py``: flow matching with inverted
timesteps (shift 1, one train step: sigmas 0 .. 1), the sequence [text (with each
reference image's latents spliced in), time token, output image], the attention mask
``omnigen_attention_mask`` (causal over the text and the time token, the output image
seeing everything, each reference image's span bidirectional), guidance over two branches
(text) or three (text and image: uncond + img_cfg * (img_cond - uncond) + cfg * (cond -
img_cond)), image-to-image, the SD VAE at SDXL's scaling 0.13025 run in float32 over the
pipeline's weights, and ``tiled`` (the encode per pixel tile, the decode per latent tile).

``use_kv_cache``: each branch's first step runs its whole sequence and keeps its
condition prefix's keys and values (after rope); later steps feed only [time token, image]
with the mask's rows for them (every column kept: ``mask_crop``) and their absolute
positions (``pos_crop``), the rope tables chosen by the whole length. Without
``tokenize`` the ids are the port's ``hash_ids(text, vocab, 24)`` (JAX's ``_hash_ids``).
The port adds ``noise=`` (the initial latents in place of the seeded draw) and
``device``.

Entry points run on the card unless ``device="cpu"`` is passed; ``__call__`` returns (H,
W, 3) float32 numpy in [0, 1].
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from goal_force_tpu_torch.models import sd_vae as sv
from goal_force_tpu_torch.models.omnigen import (
    OmniGen,
    OmniGenConfig,
    init_omnigen,
    omnigen_forward,
)
from goal_force_tpu_torch.models.tiler import tiled_forward_2d
from goal_force_tpu_torch.models.tokenizer import hash_ids
from goal_force_tpu_torch.pipelines.goal_force import resolve_device
from goal_force_tpu_torch.schedulers import flow_match


def tiny_omnigen_config() -> OmniGenConfig:
    """JAX's tiny config for tests (a 64-position window: long sequences take the long
    factors where given)."""
    return OmniGenConfig(hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=4,
                         intermediate_size=48, vocab=96, original_max_positions=64,
                         max_positions=64, pos_embed_max_size=16)


def omnigen_attention_mask(text_len: int, num_img_tokens: int,
                           image_spans: Sequence[Tuple[int, int]] = ()) -> np.ndarray:
    """(1, S, S) float32 0/1: causal over the text and the time token, the output image's
    rows open to every column, each reference image's span open within itself."""
    l = text_len + 1
    s = l + num_img_tokens
    m = np.zeros((s, s), np.float32)
    m[:l, :l] = np.tril(np.ones((l, l), np.float32))
    m[l:, :] = 1.0
    for (s0, s1) in image_spans:
        m[s0:s1, s0:s1] = 1.0
    return m[None]


@dataclasses.dataclass
class OmniGenImagePipeline:
    transformer: OmniGen
    vae_encoder: Optional[sv.SDVAEEncoder]
    vae_decoder: sv.SDVAEDecoder
    cfg: OmniGenConfig
    vae_groups: int = 32
    vae_scaling: float = sv.SDXL_SCALING_FACTOR
    vae_factor: int = 8
    tokenize: Optional[Callable] = None
    dtype: torch.dtype = torch.bfloat16

    @property
    def device(self) -> torch.device:
        return self.transformer.x_embedder.proj.weight.device

    @classmethod
    def from_pretrained(cls, transformer_path, vae_encoder_path=None, vae_decoder_path=None,
                        tokenizer_dir=None, vae_plans=None, dtype: torch.dtype = torch.bfloat16,
                        device="cuda", **infer_kw) -> "OmniGenImagePipeline":
        """The OmniGen file (``infer_kw``: head count and the LongRoPE factors, which the
        weights cannot show), the SD VAE halves (``vae_plans`` = (encoder plan, decoder
        plan, groups)) and the Phi-3 tokenizer that ships with the checkpoint, strictly."""
        from goal_force_tpu_torch.io.auto import load_model

        device = resolve_device(device)
        load = lambda path, **kw: load_model(path, dtype=dtype, device=device, **kw)
        tf = load(transformer_path, **infer_kw)
        if tf["kind"] != "omnigen":
            raise ValueError(f"{transformer_path} detected as {tf['kind']!r}")
        enc_plan, dec_plan, groups = vae_plans or (sv.SD_VAE_ENCODER_PLAN,
                                                   sv.SD_VAE_DECODER_PLAN, 32)
        vae_enc = vae_dec = None
        if vae_encoder_path is not None:
            vae_enc = load(vae_encoder_path, kind="sd_vae_encoder", plan=enc_plan)["model"]
        if vae_decoder_path is not None:
            vae_dec = load(vae_decoder_path, kind="sd_vae_decoder", plan=dec_plan)["model"]
        tok = None
        if tokenizer_dir is not None:
            from goal_force_tpu_torch.prompters import load_text_tokenizer

            tok = load_text_tokenizer(tokenizer_dir, 128).encode   # unpadded id lists
        return cls(transformer=tf["model"], vae_encoder=vae_enc, vae_decoder=vae_dec,
                   cfg=tf["config"], vae_groups=groups, tokenize=tok, dtype=dtype)

    @classmethod
    def init_random(cls, seed: int = 0, dtype=torch.float32,
                    device="cuda") -> "OmniGenImagePipeline":
        """JAX's tiny pipeline: the tiny Phi-3 and the tiny SD VAE (4 groups), from `seed`."""
        device = resolve_device(device)
        gen = torch.Generator(device).manual_seed(seed)
        cfg = tiny_omnigen_config()
        enc, dec = sv.init_tiny_sd_vae(gen, dtype, device=device)
        return cls(transformer=init_omnigen(cfg, gen, dtype, device=device), vae_encoder=enc,
                   vae_decoder=dec, cfg=cfg, vae_groups=sv.TINY_SD_VAE_GROUPS, dtype=dtype)

    def _ids(self, text: str, length: int = 24) -> List[int]:
        if self.tokenize is not None:
            return list(self.tokenize(text))
        return [int(i) for i in hash_ids(text, self.cfg.vocab, length)]

    def _encode(self, img: torch.Tensor) -> torch.Tensor:
        return sv.sd_vae_encode(self.vae_encoder, img, self.vae_groups, self.vae_scaling)

    def _decode(self, z: torch.Tensor) -> torch.Tensor:
        return sv.sd_vae_decode(self.vae_decoder, z, self.vae_groups, self.vae_scaling)

    def _branches(self, prompt: str, reference_images, n_img: int):
        """Each branch's (full call, cached call) over the transformer: the text with the
        references spliced in, the empty prompt, and with references the references
        alone."""
        dev = self.device
        ref_latents, spans, cond_ids = [], [], self._ids(prompt)
        for img in reference_images:
            lat = self._encode(torch.as_tensor(np.asarray(img, np.float32), device=dev)[None])
            size = (lat.shape[1] // 2) * (lat.shape[2] // 2)
            spans.append((len(cond_ids), len(cond_ids) + size))
            cond_ids = cond_ids + [0] * size
            ref_latents.append(lat.to(self.dtype))
        branches = [(cond_ids, ref_latents, spans), (self._ids(""), [], [])]
        if ref_latents:
            ic_ids, ic_spans = self._ids(""), []
            for lat in ref_latents:
                size = (lat.shape[1] // 2) * (lat.shape[2] // 2)
                ic_spans.append((len(ic_ids), len(ic_ids) + size))
                ic_ids = ic_ids + [0] * size
            branches.append((ic_ids, ref_latents, ic_spans))

        fns = []
        for ids, refs, sp in branches:
            mask_np = omnigen_attention_mask(len(ids), n_img, sp)
            mask = torch.as_tensor(mask_np, device=dev)
            mask_crop = torch.as_tensor(mask_np[:, -(n_img + 1):, :], device=dev)
            id_arr = torch.as_tensor(np.asarray(ids)[None], dtype=torch.long, device=dev)
            pos = torch.arange(len(ids) + 1 + n_img, device=dev)[None]
            pos_crop = pos[:, -(n_img + 1):]
            slices = [(0, s0, s1) for (s0, s1) in sp]

            def full(lat, t, keep, _ids=id_arr, _m=mask, _p=pos, _r=refs, _s=slices):
                return omnigen_forward(self.transformer, self.cfg, lat, t, _ids, _m,
                                       input_img_latents=_r, image_slices=_s, position_ids=_p,
                                       return_past_kv=keep)

            def cached(lat, t, kv, _m=mask_crop, _p=pos_crop):
                return omnigen_forward(self.transformer, self.cfg, lat, t, None, _m,
                                       position_ids=_p, past_kv=kv)

            fns.append((full, cached))
        return fns

    @torch.no_grad()
    def __call__(
        self,
        prompt: str,
        reference_images: Sequence[np.ndarray] = (),  # (H, W, 3) each, as the VAE takes it
        cfg_scale: float = 2.5,
        image_cfg_scale: float = 1.6,
        height: int = 1024,
        width: int = 1024,
        num_inference_steps: int = 20,
        seed: int = 0,
        input_image: Optional[np.ndarray] = None,    # (H, W, 3) in [-1, 1]
        denoising_strength: float = 1.0,
        use_kv_cache: bool = True,                   # cache the condition's keys/values
        tiled: bool = False,
        tile_size: int = 64,
        tile_stride: int = 32,
        return_latents: bool = False,
        noise=None,                                  # (1, h, w, 4) initial latents
    ) -> np.ndarray:
        """Returns (H, W, 3) float32 in [0, 1] (the latents with return_latents)."""
        dev, dtype = self.device, self.dtype
        schedule = flow_match.make_schedule(
            num_inference_steps, shift=1.0, sigma_min=0.0, sigma_max=1.0,
            extra_one_step=False, inverse_timesteps=True, num_train_timesteps=1,
            denoising_strength=denoising_strength if input_image is not None else 1.0)
        h, w = height // self.vae_factor, width // self.vae_factor
        n_img = (h // 2) * (w // 2)
        shape = (1, h, w, 4)
        if noise is None:
            gen = torch.Generator(dev).manual_seed(seed)
            noise = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        noise = (noise if torch.is_tensor(noise) else torch.from_numpy(
            np.array(noise, np.float32))).to(dev, torch.float32)
        if tuple(noise.shape) != shape:
            raise ValueError(f"noise has shape {tuple(noise.shape)}, expected {shape}")
        latents = noise.to(dtype)
        if input_image is not None:
            img = torch.as_tensor(np.asarray(input_image, np.float32), device=dev)[None]
            if tiled:
                z = tiled_forward_2d(self._encode, img, tile_size * self.vae_factor,
                                     tile_stride * self.vae_factor)
            else:
                z = self._encode(img)
            latents = flow_match.add_noise(z.to(dtype), latents, schedule.sigmas[0]).to(dtype)

        fns = self._branches(prompt, reference_images, n_img)
        caches = [None] * len(fns)
        for i in range(len(schedule)):
            t = torch.full((1,), float(schedule.timesteps[i]), dtype=dtype, device=dev)
            outs = []
            for j, (full, cached) in enumerate(fns):
                if use_kv_cache and caches[j] is not None:
                    outs.append(cached(latents, t, caches[j]))
                elif use_kv_cache:
                    o, caches[j] = full(latents, t, True)
                    outs.append(o)
                else:
                    outs.append(full(latents, t, False))
            if len(outs) == 3:
                cond, uncond, img_cond = outs
                v = uncond + image_cfg_scale * (img_cond - uncond) \
                    + cfg_scale * (cond - img_cond)
            else:
                cond, uncond = outs
                v = uncond + cfg_scale * (cond - uncond)
            latents = flow_match.euler_step(latents, v.to(latents.dtype), schedule.sigmas[i],
                                            schedule.sigma_next(i))
        if return_latents:
            return latents.float().cpu().numpy()
        z = latents.float()
        img = tiled_forward_2d(self._decode, z, min(tile_size, h, w), tile_stride) if tiled \
            else self._decode(z)
        return ((img[0] + 1.0) / 2.0).float().cpu().numpy().clip(0.0, 1.0)
