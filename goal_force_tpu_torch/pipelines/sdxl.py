"""SDXL text-to-image and image-to-image pipeline in PyTorch.

Port of ``goal_force_tpu/pipelines/sdxl.py``: two CLIP towers (CLIP-L's raw states at
``clip_skip`` 1 and bigG's states at ``clip_skip_2`` 2, side by side: a 2048-wide context;
bigG's projected pooled vector of the first sentence as the add embedding's text), the
size ids (h, w, 0, 0, h, w), classifier-free guidance as ONE merged batch a step, the
epsilon DDIM update by host weights, the SD VAE at SDXL's scaling 0.13025 in the
pipeline's dtype.

The request paths are SD's (``pipelines/sd.py``): image-to-image (``input_image`` in
[0, 1]; ``tiled`` encodes on pixel tiles of ``tile_size`` x 8), long prompts (both
tokenizers chunked to ONE shared sentence count, each prompt's natural length the smaller
of the two towers' and its keys past it masked), regional prompts, the union ControlNet
(``controlnet={"model": SDXLControlNetUnion, "task_id": ...}``, task 3 by default), the
IP-Adapter and ``tiled``; the hash fallback is SD's (``abs(hash(prompt)) % 2**32``).

``from_pretrained`` reads diffsynth files strictly and raises on a UNet detected as
anything but ``sdxl_unet`` (as JAX does); towers it is not given are drawn from seed 0
(bigG with its projection). The port adds ``noise=`` and ``device``; entry points run on
the card unless ``device="cpu"`` is passed. ``__call__`` returns (H, W, 3) float32 numpy
in [0, 1].
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from goal_force_tpu_torch.models import sd_vae as sv
from goal_force_tpu_torch.models.clip import CLIPConfig, CLIPTextModel, init_clip_text
from goal_force_tpu_torch.models.sd_text_encoder import (
    SDXL_TEXT2_CONFIG,
    SDXL_TEXT_CONFIG,
    sdxl_text2_encode,
    sdxl_text_encode,
)
from goal_force_tpu_torch.models.sd_unet import SDUNet
from goal_force_tpu_torch.models.sdxl_unet import SDXL_PLAN, init_sdxl_unet, sdxl_unet_apply
from goal_force_tpu_torch.models.tiler import tiled_forward_2d
from goal_force_tpu_torch.pipelines.goal_force import resolve_device
from goal_force_tpu_torch.pipelines.sd import (
    ddim_weights,
    encode_batch,
    guided,
    initial_noise,
    ipadapter_kwargs,
    local_weights,
    merged_rows,
    prompt_ids,
)
from goal_force_tpu_torch.pipelines.sd3 import init_bigg
from goal_force_tpu_torch.schedulers.ddim import ddim_add_noise, make_ddim_schedule

TINY_SDXL_PLAN = (("res", 8, 8), ("push",), ("down", 8), ("push",),
                  ("res", 8, 16), ("attn", 2, 8, 16, 24, 2), ("res", 16, 16),
                  ("pop",), ("res", 24, 16), ("attn", 2, 8, 16, 24, 2),
                  ("up", 16), ("pop",), ("res", 24, 8))
TINY_SDXL_TEXT_CONFIG = CLIPConfig(vocab_size=64, text_dim=8, text_heads=2, text_layers=2,
                                   max_positions=12, image_size=14, patch_size=7,
                                   vision_dim=16, vision_heads=2, vision_layers=1, proj_dim=8)
TINY_SDXL_TEXT2_CONFIG = CLIPConfig(vocab_size=64, text_dim=16, text_heads=2, text_layers=3,
                                    max_positions=12, hidden_act="gelu",
                                    text_pooling="argmax", image_size=14, patch_size=7,
                                    vision_dim=16, vision_heads=2, vision_layers=1,
                                    proj_dim=16)


def size_ids(height: int, width: int, device) -> torch.Tensor:
    return torch.tensor([height, width, 0, 0, height, width], dtype=torch.float32,
                        device=device)


@dataclasses.dataclass
class SDXLPipeline:
    unet: SDUNet
    text_encoder: CLIPTextModel
    text_encoder_2: CLIPTextModel
    vae_decoder: sv.SDVAEDecoder
    vae_encoder: Optional[sv.SDVAEEncoder] = None
    text_cfg: CLIPConfig = SDXL_TEXT_CONFIG
    text2_cfg: CLIPConfig = SDXL_TEXT2_CONFIG
    groups: int = 32
    vae_groups: int = 32
    vae_scaling: float = sv.SDXL_SCALING_FACTOR
    tokenize: Optional[Callable[[str], np.ndarray]] = None
    # bigG's tokenizer pads differently; falls back to `tokenize` when unset
    tokenize_2: Optional[Callable[[str], np.ndarray]] = None
    dtype: torch.dtype = torch.float32

    @property
    def plan(self):
        return self.unet.plan

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    def _encode_prompt(self, ids: np.ndarray, ids2: np.ndarray, clip_skip: int,
                       clip_skip_2: int):
        """(num_sentence, 77) ids of each tower -> ((1, num_sentence·77, 2048) context,
        (1, 1280) pooled of the FIRST sentence)."""
        as_ids = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.long, device=self.device)
        h1 = sdxl_text_encode(self.text_encoder, as_ids(ids), self.text_cfg, clip_skip=clip_skip)
        pooled, h2 = sdxl_text2_encode(self.text_encoder_2, as_ids(ids2), self.text2_cfg,
                                       clip_skip=clip_skip_2)
        ctx = torch.cat([h1, h2], dim=-1)
        return ctx.reshape(1, -1, ctx.shape[-1]), pooled[0:1]

    def _denoise_cfg(self, latents, t: float, ctx_pos, ctx_neg, pool_pos, pool_neg, add_ids,
                     cfg_scale: float, w_x: float, w_e: float, tile_ctx=None, ipadapter=None,
                     ctx_locals=None, pool_locals=None, local_w=None, cn=None, cn_cond=None,
                     cn_task: int = 3, ctx_len=None):
        """One merged (posi, nega, local_1..L) CFG step."""
        has_locals = ctx_locals is not None
        ctx = torch.cat([ctx_pos, ctx_neg] + ([ctx_locals] if has_locals else []))
        pool = torch.cat([pool_pos, pool_neg] + ([pool_locals] if has_locals else []))
        x2, tfull, ctx_len, n = merged_rows(latents, ctx, t, ctx_len)
        ids = add_ids.repeat(n * latents.shape[0])
        cn_res = None
        if cn is not None:
            from goal_force_tpu_torch.models.sd_controlnet import sdxl_controlnet_apply

            cn_res = sdxl_controlnet_apply(cn, x2, tfull, ctx, torch.cat([cn_cond] * n), ids,
                                           pool, task_id=cn_task, groups=self.groups,
                                           ctx_len=ctx_len)
        eps = sdxl_unet_apply(self.unet, x2, tfull, ctx, ids, pool, groups=self.groups,
                              controlnet_res=cn_res, ipadapter=ipadapter, tile_ctx=tile_ctx,
                              ctx_len=ctx_len)
        return latents * w_x + guided(eps, latents.shape[0], cfg_scale, local_w) * w_e

    def _ids(self, prompt: str) -> np.ndarray:
        return prompt_ids(self.tokenize, prompt, self.text_cfg)

    def _ids2(self, prompt: str) -> np.ndarray:
        tok = self.tokenize if self.tokenize_2 is None else self.tokenize_2
        return prompt_ids(tok, prompt, self.text_cfg)

    def _long_ids(self, prompts):
        """[(ids1, ids2), ...]: both tokenizers chunked with ONE sentence count shared
        across tokenizers and prompts, and each prompt's natural length (the smaller of
        the two towers' sentence counts x 77)."""
        from goal_force_tpu_torch.prompters import tokenize_long_prompt

        toks = (self.tokenize, self.tokenize_2)
        if any(t is None or not hasattr(t, "encode") for t in toks):
            ids = [(self._ids(p), self._ids2(p)) for p in prompts]
            return ids, [i[0].shape[-1] for i in ids]
        c1, c2 = ([tokenize_long_prompt(t, p) for p in prompts] for t in toks)
        nat_len = [min(a.shape[0], b.shape[0]) * a.shape[1] for a, b in zip(c1, c2)]
        ns = max(c.shape[0] for c in c1 + c2)
        if ns > 1:
            c1, c2 = ([tokenize_long_prompt(t, p, num_sentences=ns) for p in prompts]
                      for t in toks)
        return list(zip(c1, c2)), nat_len

    def _encode_img(self, img: torch.Tensor) -> torch.Tensor:
        return sv.sd_vae_encode(self.vae_encoder, img, self.vae_groups, self.vae_scaling)

    def _decode(self, z: torch.Tensor) -> torch.Tensor:
        return sv.sd_vae_decode(self.vae_decoder, z, self.vae_groups, self.vae_scaling)

    @torch.no_grad()
    def __call__(self, prompt: str, negative_prompt: str = "", height: int = 1024,
                 width: int = 1024, num_inference_steps: int = 20, cfg_scale: float = 7.5,
                 clip_skip: int = 1, clip_skip_2: int = 2, seed: int = 0,
                 input_image: Optional[np.ndarray] = None,   # (H, W, 3) in [0, 1]
                 denoising_strength: float = 1.0, ipadapter=None,
                 ipadapter_image_emb: Optional[np.ndarray] = None,
                 ipadapter_scale: float = 1.0, local_prompts=None, masks=None,
                 mask_scales=None, local_blur_kernel_size: int = 33,
                 local_blur_sigma: float = 10.0, controlnet: Optional[Dict] = None,
                 controlnet_image: Optional[np.ndarray] = None, tiled: bool = False,
                 tile_size: int = 64, tile_stride: int = 32, return_latents: bool = False,
                 noise=None) -> np.ndarray:
        dev, dtype = self.device, self.dtype
        sched = make_ddim_schedule(num_inference_steps, denoising_strength=denoising_strength
                                   if input_image is not None else 1.0)
        h8, w8 = height // 8, width // 8
        latents = initial_noise(noise, seed, (1, h8, w8, 4), dev, dtype)
        if input_image is not None:
            img = torch.as_tensor(np.asarray(input_image, np.float32) * 2.0 - 1.0,
                                  device=dev).to(dtype)[None]
            z = (tiled_forward_2d(self._encode_img, img, tile_size * 8, tile_stride * 8,
                                  batch=encode_batch(tile_size * 8)).to(dtype)
                 if tiled else self._encode_img(img))
            latents = ddim_add_noise(sched, z, latents, int(sched.timesteps[0])).to(dtype)
        all_ids, nat_len = self._long_ids([prompt, negative_prompt, *(local_prompts or [])])
        ctx_len = nat_len if len(set(nat_len)) > 1 else None
        encs = [self._encode_prompt(i1, i2, clip_skip, clip_skip_2) for i1, i2 in all_ids]
        (ctx_p, pool_p), (ctx_n, pool_n) = encs[:2]
        ctx_l = pool_l = local_w = None
        if local_prompts:
            ctx_l = torch.cat([e[0] for e in encs[2:]]).to(dtype)
            pool_l = torch.cat([e[1] for e in encs[2:]]).to(dtype)
            local_w = local_weights(masks, mask_scales, h8, w8, local_blur_kernel_size,
                                    local_blur_sigma, dev)
        ip_kwargs = ipadapter_kwargs(self.plan, ipadapter, ipadapter_image_emb,
                                     ipadapter_scale, dev)
        cn = cn_cond = None
        cn_task = 3
        if controlnet is not None and controlnet_image is not None:
            cn, cn_task = controlnet["model"], controlnet.get("task_id", 3)
            cn_cond = torch.as_tensor(np.asarray(controlnet_image, np.float32),
                                      device=dev)[None].to(dtype)
        add_ids = size_ids(height, width, dev)
        for i in range(len(sched)):
            w_x, w_e = ddim_weights(sched, i)
            latents = self._denoise_cfg(
                latents, float(sched.timesteps[i]), ctx_p.to(dtype), ctx_n.to(dtype),
                pool_p.to(dtype), pool_n.to(dtype), add_ids, float(cfg_scale), w_x, w_e,
                tile_ctx=(tile_size, tile_stride) if tiled else None, ipadapter=ip_kwargs,
                ctx_locals=ctx_l, pool_locals=pool_l, local_w=local_w, cn=cn,
                cn_cond=cn_cond, cn_task=cn_task, ctx_len=ctx_len)
        if return_latents:
            return latents.float().cpu().numpy()
        image = (tiled_forward_2d(self._decode, latents, tile_size, tile_stride) if tiled
                 else self._decode(latents))
        return np.clip((image[0].float().cpu().numpy() + 1.0) / 2.0, 0.0, 1.0)

    @classmethod
    def from_pretrained(cls, unet_path, text_encoder_path=None, text_encoder_2_path=None,
                        vae_decoder_path=None, tokenizer="vendored", tokenizer_2="vendored",
                        plan=None, groups: int = 32, vae_dec_plan=None, vae_groups: int = 32,
                        dtype=torch.float32, clip_num_heads=None,
                        device="cuda") -> "SDXLPipeline":
        """Reference-format SDXL files read strictly (``io/auto.py::load_model``): the
        UNet, CLIP-L (no final LN), bigG (with its projection) and the VAE decoder; the
        vendored CLIP-L and bigG tokenizers by default."""
        from goal_force_tpu_torch.io.auto import load_model

        device = resolve_device(device)
        load = lambda path, **kw: load_model(path, dtype=dtype, device=device, **kw)
        plan = plan or SDXL_PLAN
        unet = load(unet_path, plan=plan)
        if unet["kind"] != "sdxl_unet":
            raise ValueError(f"{unet_path} detected as {unet['kind']!r}")
        gen = torch.Generator(device).manual_seed(0)
        te1_cfg, te2_cfg = SDXL_TEXT_CONFIG, SDXL_TEXT2_CONFIG
        if text_encoder_path is not None:
            r = load(text_encoder_path, num_heads=clip_num_heads)
            te1_cfg, te1 = r["config"], r["model"]
        else:
            te1 = init_clip_text(te1_cfg, gen, dtype, device=device, final_norm=False)
        if text_encoder_2_path is not None:
            r = load(text_encoder_2_path, num_heads=clip_num_heads)
            te2_cfg, te2 = r["config"], r["model"]
        else:
            te2 = init_bigg(te2_cfg, gen, dtype, device=device)
        dec = None
        dec_plan = vae_dec_plan or sv.SD_VAE_DECODER_PLAN
        if vae_decoder_path is not None:
            dec = load(vae_decoder_path, kind="sd_vae_decoder", plan=dec_plan)["model"]
        tok1, tok2 = tokenizer, tokenizer_2
        if tokenizer == "vendored" or tokenizer_2 == "vendored":
            from goal_force_tpu_torch.prompters import sdxl_tokenizers

            v1, v2 = sdxl_tokenizers()
            tok1 = v1 if tokenizer == "vendored" else tokenizer
            tok2 = v2 if tokenizer_2 == "vendored" else tokenizer_2
        return cls(unet=unet["model"], text_encoder=te1, text_encoder_2=te2, vae_decoder=dec,
                   text_cfg=te1_cfg, text2_cfg=te2_cfg, groups=groups, vae_groups=vae_groups,
                   tokenize=tok1, tokenize_2=tok2, dtype=dtype)

    @classmethod
    def init_random(cls, seed: int = 0, tiny: bool = True, dtype=torch.float32,
                    device="cuda") -> "SDXLPipeline":
        """Random weights from `seed`: JAX's tiny pipeline (its plan, CLIP-L 8 wide and
        bigG 16 wide, 4 groups, the tiny VAE decoder; the tiny encoder too, which JAX's
        leaves out), or with tiny=False the released geometry and both VAE halves."""
        device = resolve_device(device)
        gen = torch.Generator(device).manual_seed(seed)
        if tiny:
            t1, t2, groups = TINY_SDXL_TEXT_CONFIG, TINY_SDXL_TEXT2_CONFIG, 4
            unet = init_sdxl_unet(TINY_SDXL_PLAN, gen, dtype, device=device, model_dim=8,
                                  time_dim=16, add_embed_in=16 + 6 * 256)
            enc, dec = sv.init_tiny_sd_vae(gen, dtype, device=device)
        else:
            t1, t2, groups = SDXL_TEXT_CONFIG, SDXL_TEXT2_CONFIG, 32
            unet = init_sdxl_unet(SDXL_PLAN, gen, dtype, device=device)
            enc, dec = (sv.init_sd_vae(c, p, gen, dtype, device=device, latent_channels=4,
                                       quant=True)
                        for c, p in ((sv.SDVAEEncoder, sv.SD_VAE_ENCODER_PLAN),
                                     (sv.SDVAEDecoder, sv.SD_VAE_DECODER_PLAN)))
        return cls(unet=unet,
                   text_encoder=init_clip_text(t1, gen, dtype, device=device, final_norm=False),
                   text_encoder_2=init_bigg(t2, gen, dtype, device=device), vae_decoder=dec,
                   vae_encoder=enc, text_cfg=t1, text2_cfg=t2, groups=groups,
                   vae_groups=groups, dtype=dtype)
