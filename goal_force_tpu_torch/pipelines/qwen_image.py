"""Qwen-Image (and Qwen-Image-Edit) text-to-image pipeline in PyTorch.

Port of ``goal_force_tpu/pipelines/qwen_image.py``: the prompt through Qwen2.5-VL's text
tower inside the chat template, the template's first 34 states dropped (64 with the edit
template, whose one ``<|image_pad|>`` expands to one token per merged patch of the edit
image, the vision tower's features spliced in, and ``get_rope_index``'s 3D positions);
the flow-match schedule with the exponential shift (mu from the latent sequence length,
or ``exponential_shift_mu``), ``shift_terminal`` 0.02 and the extra step; classifier-free
guidance as TWO forwards a step (prompt, then negative prompt), the shorter context padded
with zero rows and no mask, as JAX pads it; and the Wan-architecture 16-channel VAE.

Every argument of JAX ``QwenImagePipeline.__call__`` is here: ``input_image`` with
``denoising_strength``, the blockwise ControlNet (``controlnet`` the module,
``controlnet_image``), ``edit_image`` (auto-resized to about 1024² unless
``edit_image_auto_resize=False``; ``edit_rope_interpolation``), ``context_image``,
``inpaint_mask`` (resized with PIL, blurred with cv2 where it imports, else scipy; the
velocity blended toward the input on protected pixels), EliGen (``eligen_entity_prompts``
with ``eligen_entity_masks``, ``eligen_enable_on_negative``), ``exponential_shift_mu``,
``tiled`` (the VAE in tiles of ``tile_size`` / the VAE factor latents) and
``return_latents``. The port adds ``noise=`` (the initial latents in place of the seeded
draw) and ``device``. Without a tokenizer the prompt takes JAX's 48 hash ids; the edit
template then has no ``<|image_pad|>`` id and raises, as in JAX: pass ``tokenize``.

Entry points run on the card unless ``device="cpu"`` is passed; ``__call__`` returns
(H, W, 3) float32 numpy in [0, 1].
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from goal_force_tpu_torch.configs import VAEConfig
from goal_force_tpu_torch.models import qwen_image_dit as qd
from goal_force_tpu_torch.models import qwen_vl as qv
from goal_force_tpu_torch.models import vae as vm
from goal_force_tpu_torch.models.tokenizer import hash_ids
from goal_force_tpu_torch.pipelines.goal_force import resolve_device
from goal_force_tpu_torch.schedulers import flow_match as fm

QWEN_IMAGE_TEMPLATE = (
    "<|im_start|>system\nDescribe the image by detailing the color, shape, "
    "size, texture, quantity, text, spatial relationships of the objects and "
    "background:<|im_end|>\n<|im_start|>user\n{}<|im_end|>\n"
    "<|im_start|>assistant\n")
QWEN_IMAGE_DROP_IDX = 34
QWEN_IMAGE_EDIT_TEMPLATE = (
    "<|im_start|>system\nDescribe the key features of the input image (color, "
    "shape, size, texture, objects, background), then explain how the user's "
    "text instruction should alter or modify the image. Generate a new image "
    "that meets the user's requirements while maintaining consistency with "
    "the original input where appropriate.<|im_end|>\n<|im_start|>user\n"
    "<|vision_start|><|image_pad|><|vision_end|>{}<|im_end|>\n"
    "<|im_start|>assistant\n")
QWEN_IMAGE_EDIT_DROP_IDX = 64
QWEN_VISION_START_ID = 151652
QWEN_IMAGE_PAD_ID = 151655


def tiny_qwen_image_configs():
    """JAX ``init_random``'s tiny configs: (DiT, text tower, VAE)."""
    dit_cfg = qd.QwenImageDiTConfig(dim=48, num_heads=3, head_dim=16, num_layers=2,
                                    text_dim=24, axes_dim=(4, 6, 6))
    txt_cfg = qv.QwenVLTextConfig(hidden_size=24, num_layers=2, num_heads=2, num_kv_heads=2,
                                  intermediate_size=32, vocab=128, mrope_section=(3, 2, 1))
    vae_cfg = VAEConfig(dim=8, z_dim=dit_cfg.in_dim // 4, dim_mult=(1, 2), num_res_blocks=1,
                        temporal_downsample=(False,), upsampling_factor=2)
    return dit_cfg, txt_cfg, vae_cfg


@dataclasses.dataclass
class QwenImagePipeline:
    dit: qd.QwenImageDiT
    text_encoder: qv.QwenVLTextModel
    vae_encoder: Optional[vm.WanVAE]
    vae_decoder: vm.WanVAE
    dit_cfg: qd.QwenImageDiTConfig
    text_cfg: qv.QwenVLTextConfig
    vae_cfg: VAEConfig = None
    tokenize: Optional[Callable] = None
    dtype: torch.dtype = torch.bfloat16
    vae_factor: int = 8
    vision_encoder: Optional[qv.QwenVLVisionModel] = None   # Qwen-Image-Edit
    vision_cfg: Optional[qv.QwenVLVisionConfig] = None
    image_pad_id: int = QWEN_IMAGE_PAD_ID
    vision_start_id: int = QWEN_VISION_START_ID

    @property
    def device(self) -> torch.device:
        return self.dit.proj_out.weight.device

    @classmethod
    def init_random(cls, seed: int = 0, dtype=torch.float32,
                    device="cuda") -> "QwenImagePipeline":
        """Random weights from `seed` at the tiny configs."""
        device = resolve_device(device)
        dit_cfg, txt_cfg, vae_cfg = tiny_qwen_image_configs()
        gen = torch.Generator(device).manual_seed(seed)
        vae = vm.init_vae(vae_cfg, gen, dtype, device=device)
        return cls(dit=qd.init_qwen_image_dit(dit_cfg, gen, dtype, device=device),
                   text_encoder=qv.init_qwen_vl_text(txt_cfg, gen, dtype, device=device),
                   vae_encoder=vae, vae_decoder=vae, dit_cfg=dit_cfg, text_cfg=txt_cfg,
                   vae_cfg=vae_cfg, dtype=dtype,
                   vae_factor=2 ** (len(vae_cfg.dim_mult) - 1))

    @classmethod
    def from_pretrained(
        cls,
        dit_path,
        text_encoder_path=None,            # Qwen2.5-VL (its text tower; the vision too)
        vae_path=None,                     # the Wan-architecture 16-channel VAE
        vae_cfg=None,
        tokenizer_dir=None,                # the Qwen tokenizer shipped with the weights
        qwen_length: int = 512,
        dtype: torch.dtype = torch.bfloat16,
        text_num_heads=None,
        load_vision: bool = False,         # Qwen-Image-Edit: the vision tower too
        vision_cfg=None,
        device="cuda",
        **infer_kw,                        # axes_dim for tiny DiT files
    ) -> "QwenImagePipeline":
        """Load the reference-format files strictly, every model in `dtype` on `device`;
        with load_vision the vision tower is read from the text encoder's file (its
        ``visual.`` keys, under any prefix)."""
        from goal_force_tpu_torch.io.auto import _strict, load_model, load_weights

        device = resolve_device(device)
        dit = load_model(dit_path, dtype=dtype, device=device, **infer_kw)
        if dit["kind"] != "qwen_image_dit":
            raise ValueError(f"{dit_path} detected as {dit['kind']!r}")
        if text_encoder_path is None:
            raise ValueError("text_encoder_path is required (the DiT consumes Qwen2.5-VL "
                             "hidden states)")
        r = load_model(text_encoder_path, dtype=dtype, device=device, num_heads=text_num_heads)
        text_cfg, text = r["config"], r["model"]
        vision, vcfg_vis = None, None
        if load_vision:
            sd = load_weights(text_encoder_path)
            vis_keys = [k for k in sd if "visual." in k]
            if not vis_keys:
                raise ValueError(f"{text_encoder_path} has no visual.* weights; "
                                 "Qwen-Image-Edit needs the full Qwen2.5-VL checkpoint")
            vprefix = vis_keys[0].split("visual.")[0] + "visual."
            sd_vis = {k[len(vprefix):]: v for k, v in sd.items() if k.startswith(vprefix)}
            vcfg_vis = vision_cfg or qv.QwenVLVisionConfig()
            vision = _strict(qv.QwenVLVisionModel, vcfg_vis, sd_vis, "qwen_vl_vision", dtype,
                             device)
        vae, vcfg = None, vae_cfg
        if vae_path is not None:
            from goal_force_tpu_torch.models.qwen_image_vae import QWEN_IMAGE_VAE_CONFIG

            vcfg = vae_cfg or QWEN_IMAGE_VAE_CONFIG
            vae = load_model(vae_path, kind="qwen_image_vae", dtype=dtype, device=device,
                             vae_cfg=vcfg)["model"]
        tok = None
        if tokenizer_dir is not None:
            from goal_force_tpu_torch.prompters import load_text_tokenizer

            tok = load_text_tokenizer(tokenizer_dir, qwen_length)
        return cls(dit=dit["model"], text_encoder=text, vae_encoder=vae, vae_decoder=vae,
                   dit_cfg=dit["config"], text_cfg=text_cfg, vae_cfg=vcfg, tokenize=tok,
                   dtype=dtype, vae_factor=2 ** (len(vcfg.dim_mult) - 1) if vcfg else 8,
                   vision_encoder=vision, vision_cfg=vcfg_vis)

    # ------------------------------------------------------------------
    # Stages
    # ------------------------------------------------------------------

    def _forward(self, latents, t, ctx, **kw):
        return qd.qwen_image_dit_forward(self.dit, self.dit_cfg, latents, t, ctx, **kw)

    def _denoise(self, latents, t, ctx_p, ctx_n, cfg_scale: float, controlnet=None,
                 cn_cond=None, extra_latents=None, ent_p=None, ent_n=None, ent_masks=None,
                 rope_interpolate: bool = False):
        """Guidance over two forwards: the prompt's, then the negative prompt's."""
        common = dict(controlnet=controlnet, controlnet_cond=cn_cond,
                      extra_latents=extra_latents, rope_interpolate=rope_interpolate)
        vp = self._forward(latents, t, ctx_p, entity_prompt_embs=ent_p,
                           entity_masks=ent_masks if ent_p else None, **common)
        vn = self._forward(latents, t, ctx_n, entity_prompt_embs=ent_n,
                           entity_masks=ent_masks if ent_n else None, **common)
        return vn + cfg_scale * (vp - vn)

    def _encode_image_prompt(self, edit_image):
        """The vision tower over the edit image: (features, grid_thw)."""
        if self.vision_encoder is None:
            raise ValueError("edit_image prompt encoding needs the Qwen2.5-VL vision tower: "
                             "from_pretrained(..., load_vision=True)")
        patches, grid = qv.preprocess_image_for_vision(np.asarray(edit_image, np.float32),
                                                       self.vision_cfg)
        feats = qv.qwen_vl_vision_forward(
            self.vision_encoder, self.vision_cfg,
            torch.as_tensor(patches, device=self.device).to(self.dtype), [grid])
        return feats, grid

    def _encode_prompt(self, prompt: str, edit_image=None, image_prompt=None) -> torch.Tensor:
        """Qwen2.5-VL's hidden states for the templated prompt past the template's drop;
        with edit_image the edit template and the vision tokens (image_prompt: the
        vision tower's (features, grid) of that image, computed once for both
        branches)."""
        img_feats, grid = None, []
        if edit_image is None:
            text, drop_idx = QWEN_IMAGE_TEMPLATE.format(prompt), QWEN_IMAGE_DROP_IDX
        else:
            text, drop_idx = QWEN_IMAGE_EDIT_TEMPLATE.format(prompt), QWEN_IMAGE_EDIT_DROP_IDX
            img_feats, g = image_prompt or self._encode_image_prompt(edit_image)
            grid = [g]
        if self.tokenize is not None:
            ids = np.asarray(self.tokenize(text), np.int64)
        else:
            ids = hash_ids(text, self.text_cfg.vocab, 48).astype(np.int64)
        if edit_image is not None:
            where = np.nonzero(ids == self.image_pad_id)[0]
            if len(where) != 1:
                raise ValueError(
                    "tokenizer did not produce exactly one <|image_pad|> id "
                    f"({self.image_pad_id}); found {len(where)}: pass the Qwen2.5-VL "
                    "tokenizer dir shipped with the text encoder")
            n_img = (grid[0][1] * grid[0][2]) // self.vision_cfg.spatial_merge_size ** 2
            ids = np.concatenate([ids[:where[0]], np.full((n_img,), self.image_pad_id, np.int64),
                                  ids[where[0] + 1:]])
        pos = qv.get_rope_index(ids[None], grid, image_token_id=self.image_pad_id,
                                vision_start_token_id=self.vision_start_id)
        dev = self.device
        ids_t = torch.as_tensor(ids[None], device=dev)
        emb = qv.qwen_vl_embed(self.text_encoder, ids_t, img_feats, self.image_pad_id)
        hidden = qv.qwen_vl_text_forward(self.text_encoder, self.text_cfg, emb.to(self.dtype),
                                         torch.ones_like(ids_t),
                                         torch.as_tensor(pos, device=dev))
        return hidden[:, min(drop_idx, hidden.shape[1] - 1):]

    def _enc(self, img01, tiled: bool, tile_size: int, tile_stride: int) -> torch.Tensor:
        x = (torch.as_tensor(np.asarray(img01, np.float32), device=self.device)[None]
             * 2.0 - 1.0).to(next(self.vae_encoder.parameters()).dtype)
        lt = lambda v: (max(v // self.vae_factor, 1),) * 2
        if tiled:
            z = vm.encode_video_tiled(self.vae_encoder, self.vae_cfg, x[:, None],
                                      lt(tile_size), lt(tile_stride))
        else:
            z = vm.encode_video(self.vae_encoder, self.vae_cfg, x[:, None])
        return z[:, 0].to(self.dtype)

    def _decode(self, latents, tiled: bool, tile_size: int, tile_stride: int) -> torch.Tensor:
        z = latents.float().to(next(self.vae_decoder.parameters()).dtype)[:, None]
        lt = lambda v: (max(v // self.vae_factor, 1),) * 2
        if tiled:
            return vm.decode_video_tiled(self.vae_decoder, self.vae_cfg, z, lt(tile_size),
                                         lt(tile_stride))[:, 0]
        return vm.decode_video(self.vae_decoder, self.vae_cfg, z)[:, 0]

    @torch.no_grad()
    def __call__(
        self,
        prompt: str,
        negative_prompt: str = "",
        cfg_scale: float = 4.0,
        height: int = 1328,
        width: int = 1328,
        num_inference_steps: int = 30,
        seed: int = 0,
        input_image: Optional[np.ndarray] = None,    # (H, W, 3) in [0, 1]
        denoising_strength: float = 1.0,
        controlnet=None,                             # QwenImageControlNet
        controlnet_image: Optional[np.ndarray] = None,
        edit_image: Optional[np.ndarray] = None,     # Qwen-Image-Edit (H, W, 3)
        edit_image_auto_resize: bool = True,
        edit_rope_interpolation: bool = False,
        context_image: Optional[np.ndarray] = None,  # in-context control
        inpaint_mask: Optional[np.ndarray] = None,   # (H, W) float in [0, 1]
        inpaint_blur_size: Optional[int] = None,
        inpaint_blur_sigma: Optional[float] = None,
        eligen_entity_prompts=None,                  # list[str]
        eligen_entity_masks=None,                    # (M, H, W) float in [0, 1]
        eligen_enable_on_negative: bool = False,
        exponential_shift_mu: Optional[float] = None,
        tiled: bool = False,
        tile_size: int = 128,
        tile_stride: int = 64,
        return_latents: bool = False,
        noise=None,                                  # (1, h, w, 16) initial latents
    ) -> np.ndarray:
        """Returns (H, W, 3) float32 in [0, 1] (the latents with return_latents)."""
        dev, dtype = self.device, self.dtype
        schedule = fm.make_schedule(
            num_inference_steps, sigma_min=0.0, sigma_max=1.0, extra_one_step=True,
            exponential_shift=True, shift_terminal=0.02, denoising_strength=denoising_strength,
            exponential_shift_mu=exponential_shift_mu,
            dynamic_shift_len=(height // 16) * (width // 16))
        if edit_image is not None and edit_image_auto_resize:
            edit_image = _edit_auto_resize(edit_image)
        # the edit template (and the vision tokens) go into both guidance branches
        image_prompt = None if edit_image is None else self._encode_image_prompt(edit_image)
        ctx_p = self._encode_prompt(prompt, edit_image, image_prompt).to(dtype)
        ctx_n = self._encode_prompt(negative_prompt, edit_image, image_prompt).to(dtype)
        if ctx_p.shape[1] != ctx_n.shape[1]:
            length = max(ctx_p.shape[1], ctx_n.shape[1])
            pad = lambda c: torch.nn.functional.pad(c, (0, 0, 0, length - c.shape[1]))
            ctx_p, ctx_n = pad(ctx_p), pad(ctx_n)

        h, w = height // self.vae_factor, width // self.vae_factor
        shape = (1, h, w, self.dit_cfg.in_dim // 4)
        if noise is None:
            gen = torch.Generator(dev).manual_seed(seed)
            noise = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        noise = (noise if torch.is_tensor(noise) else torch.from_numpy(
            np.array(noise, np.float32))).to(dev, torch.float32)
        if tuple(noise.shape) != shape:
            raise ValueError(f"noise has shape {tuple(noise.shape)}, expected {shape}")
        latents = noise.to(dtype)
        enc = lambda img: self._enc(img, tiled, tile_size, tile_stride)

        input_latents = None
        if input_image is not None:
            input_latents = enc(input_image)
            latents = fm.add_noise(input_latents, latents, schedule.sigmas[0])
        im = None
        if inpaint_mask is not None:
            if input_latents is None:
                raise ValueError("inpaint_mask requires input_image")
            im = _inpaint_mask_latent(inpaint_mask, h, w, inpaint_blur_size, inpaint_blur_sigma)
            im = torch.as_tensor(im, device=dev)[None, ..., None]

        # context and edit images ride as extra image tokens, context first
        extra = [enc(img) for img in (context_image, edit_image) if img is not None] or None

        ent_p = ent_n = ent_masks = None
        if eligen_entity_prompts:
            ent_p = [self._encode_prompt(p).to(dtype) for p in eligen_entity_prompts]
            masks = np.asarray(eligen_entity_masks, np.float32)
            yi = np.minimum(np.floor((np.arange(h) + 0.5) * masks.shape[1] / h).astype(int),
                            masks.shape[1] - 1)
            xi = np.minimum(np.floor((np.arange(w) + 0.5) * masks.shape[2] / w).astype(int),
                            masks.shape[2] - 1)
            ent_masks = torch.as_tensor((masks[:, yi][:, :, xi] > 0.5).astype(np.float32)[None],
                                        device=dev)
            if eligen_enable_on_negative and cfg_scale != 1.0:
                ent_n = [ctx_n] * len(ent_p)

        cn_cond = None
        if controlnet is not None and controlnet_image is not None:
            cn_cond = qd.patchify2d(enc(controlnet_image)).to(dtype)

        gh, gw = h // 2, w // 2
        for i in range(len(schedule)):
            sigma = schedule.sigmas[i]
            t = torch.full((1,), float(sigma), dtype=dtype, device=dev)
            tok = self._denoise(latents, t, ctx_p, ctx_n, float(cfg_scale), controlnet, cn_cond,
                                extra, ent_p, ent_n, ent_masks,
                                rope_interpolate=edit_rope_interpolation)
            v = qd.qwen_unpatchify(tok, gh * 16, gw * 16, latents.shape[-1]).to(latents.dtype)
            if im is not None:
                # the velocity toward the input on the protected pixels
                v_keep = (latents - input_latents).float() / float(sigma)
                v = v_keep * (1 - im) + v * im
            latents = fm.euler_step(latents, v.to(latents.dtype), sigma, schedule.sigma_next(i))
        if return_latents:
            return latents.float().cpu().numpy()
        img = self._decode(latents, tiled, tile_size, tile_stride)
        return ((img[0] + 1.0) / 2.0).float().cpu().numpy().clip(0.0, 1.0)


def _edit_auto_resize(image01: np.ndarray) -> np.ndarray:
    """About 1024² pixels at the image's aspect, sides multiples of 32 (PIL's default
    resampling)."""
    from PIL import Image

    h0, w0 = image01.shape[:2]
    ratio = w0 / h0
    w = math.sqrt(1024 * 1024 * ratio)
    h = w / ratio
    w, h = round(w / 32) * 32, round(h / 32) * 32
    pil = Image.fromarray((np.clip(image01, 0, 1) * 255).astype(np.uint8))
    return np.asarray(pil.resize((w, h)), np.float32) / 255.0


def _inpaint_mask_latent(mask01: np.ndarray, h: int, w: int, blur_size: Optional[int],
                         blur_sigma: Optional[float]) -> np.ndarray:
    """(H, W) pixel mask -> (h, w) latent mask (PIL resize), Gaussian-blurred where
    blur_size and blur_sigma are given: cv2 where it imports, else scipy's filter with
    the same support."""
    from PIL import Image

    m = np.asarray(mask01, np.float32)
    if m.ndim == 3:
        m = m.mean(axis=-1)
    pil = Image.fromarray((np.clip(m, 0, 1) * 255).astype(np.uint8))
    m = np.asarray(pil.resize((w, h)), np.float32) / 255.0
    if blur_size is not None and blur_sigma is not None:
        try:
            import cv2

            k = blur_size * 2 + 1
            m = cv2.GaussianBlur(m, (k, k), blur_sigma)
        except ImportError:
            from scipy.ndimage import gaussian_filter

            m = gaussian_filter(m, blur_sigma, truncate=blur_size / blur_sigma)
    return m
