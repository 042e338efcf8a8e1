"""Stable Diffusion 1.5 text-to-image and image-to-image pipeline in PyTorch.

Port of ``goal_force_tpu/pipelines/sd.py``: CLIP-L's token states (``clip_skip``),
classifier-free guidance over the epsilon-predicting UNet as ONE merged batch a step
([prompt, negative prompt, each local prompt]), the DDIM update by host weights ``w_x``
and ``w_e``, the SD VAE (scaling 0.18215) in the pipeline's dtype.

Every request path of JAX ``SDPipeline.__call__`` is here:

  - text-to-image, and image-to-image (``input_image`` in [0, 255], noised to the first
    timestep of the ``denoising_strength`` schedule by ``ddim_add_noise``);
  - long prompts: each prompt cut into 77-token sentences with ONE sentence count for the
    batch; a row's keys past its natural length are masked (``ctx_len``), so a padded row
    computes what the row alone would;
  - regional prompts (``local_prompts``, ``masks``, ``mask_scales`` and the blur:
    ``pipelines/regional.py``);
  - ``controlnet={"model": SDControlNet}`` with ``controlnet_image`` (H, W, 3) in [0, 1]:
    its residuals inside each step for every row;
  - ``ipadapter=`` (``models/ipadapter.py``'s module) with ``ipadapter_image_emb``;
  - ``tiled``: the VAE encode on pixel tiles of ``tile_size`` at ``tile_stride`` (in
    batches of tiles, ``ENCODE_BATCH_PIXELS``), the decode on latent tiles of the same
    numbers, and each UNet transformer block on tiles of its resolution
    (``sd_unet_apply(tile_ctx=)``).

Without ``tokenize`` the ids are JAX's hash fallback: numpy seeded with
``abs(hash(prompt)) % 2**32``, Python's salted string hash, so the same within one process
(both packages) and not across processes unless ``PYTHONHASHSEED`` is set.

``from_pretrained`` reads diffsynth-format files strictly, or one bundled civitai
checkpoint detected as ``sd_civitai`` (``sd_pipeline_from_civitai``). The port adds
``noise=`` (the initial latents in place of the seeded draw: the two packages' RNG
streams differ) and ``device``; entry points run on the card unless ``device="cpu"`` is
passed. ``__call__`` returns (H, W, 3) float32 numpy in [0, 1].
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from goal_force_tpu_torch.models import sd_vae as sv
from goal_force_tpu_torch.models.clip import CLIPConfig, CLIPTextModel, init_clip_text
from goal_force_tpu_torch.models.sd_text_encoder import SD_TEXT_CONFIG, sd_text_encode
from goal_force_tpu_torch.models.sd_unet import (
    SD15_PLAN,
    SDUNet,
    init_sd_unet,
    sd_unet_apply,
    tiny_sd_plan,
)
from goal_force_tpu_torch.models.tiler import tiled_forward_2d
from goal_force_tpu_torch.pipelines.goal_force import resolve_device
from goal_force_tpu_torch.schedulers.ddim import DDIMSchedule, ddim_add_noise, make_ddim_schedule

# The tiled VAE encode sends its tiles through the encoder in batches of up to this many
# pixels: each tile is encoded on its own as before, with fewer calls (SD's encode tiles
# are tile_size pixels wide: 961 of 32 at 512²).
ENCODE_BATCH_PIXELS = 512 * 512


def encode_batch(tile_px: int) -> int:
    return max(1, ENCODE_BATCH_PIXELS // (tile_px * tile_px))


TINY_SD_TEXT_CONFIG = CLIPConfig(vocab_size=64, text_dim=32, text_heads=4, text_layers=2,
                                 max_positions=12, image_size=14, patch_size=7, vision_dim=16,
                                 vision_heads=2, vision_layers=1, proj_dim=16)


def prompt_ids(tokenize, prompt: str, cfg: CLIPConfig) -> np.ndarray:
    """(1, L) int32 ids of `tokenize`; without it JAX's hash fallback: (1, max_positions)
    ids in [1, vocab - 1) from numpy seeded with ``abs(hash(prompt)) % 2**32``."""
    if tokenize is None:
        rng = np.random.default_rng(abs(hash(prompt)) % (2**32))
        return rng.integers(1, cfg.vocab_size - 1, (1, cfg.max_positions)).astype(np.int32)
    return np.asarray(tokenize(prompt)).reshape(1, -1).astype(np.int32)


def ipadapter_kwargs(plan, ipadapter, image_emb, scale: float, device) -> Optional[Dict]:
    """``sd_unet_apply(ipadapter=)`` for one image embedding, or None without the adapter
    or the embedding."""
    if ipadapter is None or image_emb is None:
        return None
    from goal_force_tpu_torch.models.ipadapter import ipadapter_kwargs_for_plan

    emb = torch.as_tensor(np.asarray(image_emb, np.float32), device=device)
    return ipadapter_kwargs_for_plan(plan, ipadapter, emb, scale=scale)


def ddim_weights(schedule: DDIMSchedule, i: int):
    """(w_x, w_e) of the epsilon DDIM update from step i, from the float64 table."""
    acp = schedule.alphas_cumprod
    a_t = float(acp[int(schedule.timesteps[i])])
    a_prev = 1.0 if i + 1 >= len(schedule) else float(acp[int(schedule.timesteps[i + 1])])
    return (math.sqrt(a_prev / a_t),
            math.sqrt(1 - a_prev) - math.sqrt(a_prev * (1 - a_t) / a_t))


def initial_noise(noise, seed: int, shape, device, dtype) -> torch.Tensor:
    """The given (1, h, w, 4) noise, or a float32 draw from a generator seeded with
    `seed`, in `dtype`."""
    if noise is None:
        gen = torch.Generator(device).manual_seed(seed)
        noise = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    noise = (noise if torch.is_tensor(noise) else torch.from_numpy(
        np.array(noise, np.float32))).to(device, torch.float32)
    if tuple(noise.shape) != tuple(shape):
        raise ValueError(f"noise has shape {tuple(noise.shape)}, expected {tuple(shape)}")
    return noise.to(dtype)


def merged_rows(latents: torch.Tensor, ctx: torch.Tensor, t: float, ctx_len):
    """The merged batch: latents repeated once per prompt row of ctx, the timestep in
    the latents' dtype, ctx_len repeated over the latents' batch."""
    b = latents.shape[0]
    n = ctx.shape[0] // b
    x2 = torch.cat([latents] * n)
    tfull = torch.full((n * b,), t, dtype=latents.dtype, device=latents.device)
    if ctx_len is not None:
        ctx_len = torch.as_tensor(ctx_len, device=latents.device).repeat_interleave(b)
    return x2, tfull, ctx_len, n


def guided(eps: torch.Tensor, b: int, cfg_scale: float, local_w=None) -> torch.Tensor:
    """Classifier-free guidance over [positive, negative, locals...] rows, the locals
    mask-blended into the positive first."""
    eps_pos, eps_neg = eps[:b], eps[b:2 * b]
    if local_w is not None:
        from goal_force_tpu_torch.pipelines.regional import blend_local_predictions

        eps_pos = blend_local_predictions(eps_pos, eps[2 * b:], local_w)
    return eps_neg + cfg_scale * (eps_pos - eps_neg)


def local_weights(masks, mask_scales, h: int, w: int, kernel: int, sigma: float, device):
    from goal_force_tpu_torch.pipelines.regional import local_prompt_weights

    return torch.as_tensor(local_prompt_weights(masks, mask_scales, h, w, kernel, sigma),
                           device=device)


@dataclasses.dataclass
class SDPipeline:
    unet: SDUNet
    text_encoder: CLIPTextModel
    vae_encoder: Optional[sv.SDVAEEncoder]
    vae_decoder: sv.SDVAEDecoder
    text_cfg: CLIPConfig = SD_TEXT_CONFIG
    groups: int = 32
    vae_groups: int = 32
    tokenize: Optional[Callable[[str], np.ndarray]] = None
    dtype: torch.dtype = torch.float32

    @property
    def plan(self):
        return self.unet.plan

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    # one CFG step: the merged (posi, nega, local_1..L) batch in one UNet call
    def _denoise_cfg(self, latents, t: float, ctx_pos, ctx_neg, cfg_scale: float, w_x: float,
                     w_e: float, ipadapter=None, tile_ctx=None, ctx_locals=None, local_w=None,
                     cn=None, cn_cond=None, ctx_len=None):
        rows = [ctx_pos, ctx_neg] + ([ctx_locals] if ctx_locals is not None else [])
        ctx = torch.cat(rows)
        x2, tfull, ctx_len, n = merged_rows(latents, ctx, t, ctx_len)
        cn_res = None
        if cn is not None:
            from goal_force_tpu_torch.models.sd_controlnet import sd_controlnet_apply

            cn_res = sd_controlnet_apply(cn, x2, tfull, ctx, torch.cat([cn_cond] * n),
                                         groups=self.groups, ctx_len=ctx_len)
        eps = sd_unet_apply(self.unet, x2, tfull, ctx, groups=self.groups, ipadapter=ipadapter,
                            controlnet_res=cn_res, tile_ctx=tile_ctx, ctx_len=ctx_len)
        return latents * w_x + guided(eps, latents.shape[0], cfg_scale, local_w) * w_e

    def _ids(self, prompt: str) -> np.ndarray:
        return prompt_ids(self.tokenize, prompt, self.text_cfg)

    def _long_ids(self, prompts: Sequence[str]):
        """(num_sentence, 77) chunks per prompt with a SHARED sentence count, and each
        prompt's natural context length in tokens (without a chunking tokenizer, one row
        of ``_ids`` each)."""
        from goal_force_tpu_torch.prompters import tokenize_long_prompt

        if self.tokenize is None or not hasattr(self.tokenize, "encode"):
            ids = [self._ids(p) for p in prompts]
            return ids, [i.shape[-1] for i in ids]
        chunked = [tokenize_long_prompt(self.tokenize, p) for p in prompts]
        nat_len = [c.size for c in chunked]
        ns = max(c.shape[0] for c in chunked)
        if ns > 1:
            chunked = [tokenize_long_prompt(self.tokenize, p, num_sentences=ns)
                       for p in prompts]
        return chunked, nat_len

    def _encode_text(self, ids: np.ndarray, clip_skip: int) -> torch.Tensor:
        ids = torch.as_tensor(np.asarray(ids), dtype=torch.long, device=self.device)
        return sd_text_encode(self.text_encoder, ids, self.text_cfg, clip_skip=clip_skip)

    def _ctx(self, ids: np.ndarray, clip_skip: int) -> torch.Tensor:
        """(num_sentence, 77) ids -> (1, num_sentence·77, dim): per-sentence encode, then
        flattened."""
        h = self._encode_text(ids, clip_skip)
        return h.reshape(1, -1, h.shape[-1])

    def _encode_img(self, img: torch.Tensor) -> torch.Tensor:
        return sv.sd_vae_encode(self.vae_encoder, img, self.vae_groups)

    def _decode(self, z: torch.Tensor) -> torch.Tensor:
        return sv.sd_vae_decode(self.vae_decoder, z, self.vae_groups)

    @torch.no_grad()
    def __call__(self,
                 prompt: str,
                 negative_prompt: str = "",
                 height: int = 512,
                 width: int = 512,
                 num_inference_steps: int = 20,
                 cfg_scale: float = 7.5,
                 clip_skip: int = 1,
                 input_image: Optional[np.ndarray] = None,    # (H, W, 3) in [0, 255]
                 denoising_strength: float = 1.0,
                 seed: int = 0,
                 ipadapter=None,
                 ipadapter_image_emb: Optional[np.ndarray] = None,
                 ipadapter_scale: float = 1.0,
                 local_prompts: Optional[Sequence[str]] = None,
                 masks: Optional[Sequence[np.ndarray]] = None,
                 mask_scales: Optional[Sequence[float]] = None,
                 local_blur_kernel_size: int = 33,
                 local_blur_sigma: float = 10.0,
                 controlnet: Optional[Dict] = None,            # {"model": SDControlNet}
                 controlnet_image: Optional[np.ndarray] = None,  # (H, W, 3) in [0, 1]
                 tiled: bool = False,
                 tile_size: int = 64,
                 tile_stride: int = 32,
                 return_latents: bool = False,
                 noise=None) -> np.ndarray:                    # (1, H/8, W/8, 4)
        dev, dtype = self.device, self.dtype
        sched = make_ddim_schedule(num_inference_steps, denoising_strength=denoising_strength
                                   if input_image is not None else 1.0)
        h8, w8 = height // 8, width // 8
        latents = initial_noise(noise, seed, (1, h8, w8, 4), dev, dtype)
        if input_image is not None:
            img = torch.as_tensor(np.asarray(input_image, np.float32) / 127.5 - 1.0,
                                  device=dev).to(dtype)[None]
            z = (tiled_forward_2d(self._encode_img, img, tile_size, tile_stride,
                                  batch=encode_batch(tile_size)).to(dtype)
                 if tiled else self._encode_img(img))
            latents = ddim_add_noise(sched, z, latents, int(sched.timesteps[0])).to(dtype)

        all_ids, nat_len = self._long_ids([prompt, negative_prompt, *(local_prompts or [])])
        ctx_len = nat_len if len(set(nat_len)) > 1 else None
        ctx_pos = self._ctx(all_ids[0], clip_skip).to(dtype)
        ctx_neg = self._ctx(all_ids[1], 1).to(dtype)
        ctx_locals = local_w = None
        if local_prompts:
            ctx_locals = torch.cat([self._ctx(ids, clip_skip) for ids in all_ids[2:]]).to(dtype)
            local_w = local_weights(masks, mask_scales, h8, w8, local_blur_kernel_size,
                                    local_blur_sigma, dev)
        cn = cn_cond = None
        if controlnet is not None and controlnet_image is not None:
            cn = controlnet["model"]
            cn_cond = torch.as_tensor(np.asarray(controlnet_image, np.float32),
                                      device=dev)[None].to(dtype)
        ip_kwargs = ipadapter_kwargs(self.plan, ipadapter, ipadapter_image_emb,
                                     ipadapter_scale, dev)
        for i in range(len(sched)):
            w_x, w_e = ddim_weights(sched, i)
            latents = self._denoise_cfg(latents, float(sched.timesteps[i]), ctx_pos, ctx_neg,
                                        float(cfg_scale), w_x, w_e, ip_kwargs,
                                        tile_ctx=(tile_size, tile_stride) if tiled else None,
                                        ctx_locals=ctx_locals, local_w=local_w, cn=cn,
                                        cn_cond=cn_cond, ctx_len=ctx_len)
        if return_latents:
            return latents.float().cpu().numpy()
        image = (tiled_forward_2d(self._decode, latents, tile_size, tile_stride) if tiled
                 else self._decode(latents))
        return np.clip((image[0].float().cpu().numpy() + 1.0) / 2.0, 0.0, 1.0)

    @classmethod
    def from_pretrained(cls, unet_path, text_encoder_path=None, vae_encoder_path=None,
                        vae_decoder_path=None, tokenizer="vendored", plan=None,
                        groups: int = 32, vae_plans=None, dtype=torch.float32,
                        clip_num_heads=None, device="cuda") -> "SDPipeline":
        """One bundled civitai checkpoint (split by prefix), or diffsynth-format files
        read strictly (``io/auto.py::load_model``); the vendored CLIP tokenizer by default.
        vae_plans: (encoder plan, decoder plan, groups). Without a text tower one is drawn
        at SD's size from seed 0 on the device (JAX draws it from ``PRNGKey(0)``)."""
        from goal_force_tpu_torch.io.auto import load_model, load_weights
        from goal_force_tpu_torch.io.detect import detect_model_kind

        device = resolve_device(device)
        tok = tokenizer
        if tokenizer == "vendored":
            from goal_force_tpu_torch.prompters import sd_clip_tokenizer

            tok = sd_clip_tokenizer()
        sd = load_weights(unet_path)
        if detect_model_kind(sd) == "sd_civitai":
            return sd_pipeline_from_civitai(sd, tokenize=tok, dtype=dtype, device=device)
        load = lambda path, **kw: load_model(path, dtype=dtype, device=device, **kw)
        plan = plan or SD15_PLAN
        enc_plan, dec_plan, vgroups = vae_plans or (sv.SD_VAE_ENCODER_PLAN,
                                                    sv.SD_VAE_DECODER_PLAN, 32)
        unet = load(sd, plan=plan)
        text_cfg, text = SD_TEXT_CONFIG, None
        if text_encoder_path is not None:
            r = load(text_encoder_path, num_heads=clip_num_heads)
            text_cfg, text = r["config"], r["model"]
        enc = dec = None
        if vae_encoder_path is not None:
            enc = load(vae_encoder_path, kind="sd_vae_encoder", plan=enc_plan)["model"]
        if vae_decoder_path is not None:
            dec = load(vae_decoder_path, kind="sd_vae_decoder", plan=dec_plan)["model"]
        if text is None:
            text = init_clip_text(text_cfg, torch.Generator(device).manual_seed(0), dtype,
                                  device=device)
        return cls(unet=unet["model"], text_encoder=text, vae_encoder=enc, vae_decoder=dec,
                   text_cfg=text_cfg, groups=groups, vae_groups=vgroups, tokenize=tok,
                   dtype=dtype)

    @classmethod
    def init_random(cls, seed: int = 0, tiny: bool = True, dtype=torch.float32,
                    device="cuda") -> "SDPipeline":
        """Random weights from `seed`: JAX's tiny pipeline (plan, 32-wide CLIP, 4
        groups, the tiny VAE), or with tiny=False the released 860 M geometry with
        CLIP-L and the SD VAE."""
        device = resolve_device(device)
        gen = torch.Generator(device).manual_seed(seed)
        if tiny:
            text_cfg, groups = TINY_SD_TEXT_CONFIG, 4
            unet = init_sd_unet(tiny_sd_plan(ctx_dim=32), gen, dtype, device=device,
                                model_dim=8, time_dim=16)
            enc, dec = sv.init_tiny_sd_vae(gen, dtype, device=device)
        else:
            text_cfg, groups = SD_TEXT_CONFIG, 32
            unet = init_sd_unet(SD15_PLAN, gen, dtype, device=device)
            enc, dec = (sv.init_sd_vae(c, p, gen, dtype, device=device, latent_channels=4,
                                       quant=True)
                        for c, p in ((sv.SDVAEEncoder, sv.SD_VAE_ENCODER_PLAN),
                                     (sv.SDVAEDecoder, sv.SD_VAE_DECODER_PLAN)))
        return cls(unet=unet, text_encoder=init_clip_text(text_cfg, gen, dtype, device=device),
                   vae_encoder=enc, vae_decoder=dec, text_cfg=text_cfg, groups=groups,
                   vae_groups=groups, dtype=dtype)


def sd_pipeline_from_civitai(path, tokenize=None, dtype=torch.float32, device="cuda",
                             plan=None, groups: int = 32,
                             text_cfg: CLIPConfig = SD_TEXT_CONFIG,
                             vae_plans=None) -> SDPipeline:
    """An ``SDPipeline`` from ONE bundled civitai SD 1.5 checkpoint (safetensors, a
    torch pickle or a loaded dict): ``model.diffusion_model.*`` (the UNet),
    ``cond_stage_model.*`` (CLIP-L) and ``first_stage_model.*`` (the VAE), split by prefix
    and read strictly. plan, groups, text_cfg and vae_plans (encoder plan, decoder plan,
    groups) default to the released geometry, the only one JAX reads."""
    from goal_force_tpu_torch.io.auto import _strict, load_weights
    from goal_force_tpu_torch.models.sd_text_encoder import sd_text_state_dict_from_civitai
    from goal_force_tpu_torch.models.sd_unet import state_dict_from_civitai, unet_from_state_dict

    device = resolve_device(device)
    sd = load_weights(path)
    plan = plan or SD15_PLAN
    enc_plan, dec_plan, vgroups = vae_plans or (sv.SD_VAE_ENCODER_PLAN,
                                                sv.SD_VAE_DECODER_PLAN, 32)

    def vae(cls, p, encoder):
        return _strict(lambda pl: cls(pl, 4, True), p, sv.state_dict_from_civitai(sd, p, encoder),
                       "sd_civitai vae", dtype, device)

    return SDPipeline(
        unet=unet_from_state_dict(state_dict_from_civitai(sd, plan), plan, "sd_civitai unet",
                                  dtype, device),
        text_encoder=_strict(CLIPTextModel, text_cfg,
                             sd_text_state_dict_from_civitai(sd, text_cfg), "sd_civitai text",
                             dtype, device),
        vae_encoder=vae(sv.SDVAEEncoder, enc_plan, True),
        vae_decoder=vae(sv.SDVAEDecoder, dec_plan, False),
        text_cfg=text_cfg, groups=groups, vae_groups=vgroups, tokenize=tokenize, dtype=dtype)
