"""HunyuanDiT text-to-image and image-to-image pipeline in PyTorch.

Port of ``goal_force_tpu/pipelines/hunyuan_image.py``: DDIM with v-prediction (betas
0.00085 .. 0.03), the dual text conditioning (HunyuanDiT's BERT tower at 77 tokens and
mT5's encoder at 256, each with its mask), the image-size vector (width first: [w, h, w,
h, 0, 0]), classifier-free guidance as ONE merged forward over [prompt, negative prompt,
each local prompt], regional prompting (``pipelines/regional.py``), image-to-image
(``input_image`` with ``denoising_strength``), the SD VAE at SDXL's scaling 0.13025 run in
float32 over the pipeline's weights, and ``tiled`` (the encode per pixel tile of
``tile_size`` x the VAE factor, the decode per latent tile).

Without ``encode_prompt`` the embeddings are stand-ins drawn from a torch generator seeded
with the sum of the prompt's hash ids, as JAX seeds ``jax.random`` with it (the two
packages' random streams differ; the parity tests pass ``encode_prompt``). The port adds
``noise=`` (the initial latents in place of the seeded draw) and ``device``.

Entry points run on the card unless ``device="cpu"`` is passed; ``__call__`` returns (H,
W, 3) float32 numpy in [0, 1].
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from goal_force_tpu_torch.models import sd_vae as sv
from goal_force_tpu_torch.models.hunyuan_dit import (
    HunyuanDiT,
    HunyuanDiTConfig,
    hunyuan_dit_forward,
    init_hunyuan_dit,
)
from goal_force_tpu_torch.models.tiler import tiled_forward_2d
from goal_force_tpu_torch.models.tokenizer import hash_ids
from goal_force_tpu_torch.pipelines.goal_force import resolve_device
from goal_force_tpu_torch.schedulers.ddim import (
    ddim_add_noise,
    ddim_step,
    make_ddim_schedule,
)


def tiny_hunyuan_dit_config() -> HunyuanDiTConfig:
    """JAX's tiny DiT config for tests."""
    return HunyuanDiTConfig(dim=16, num_heads=2, num_layers_down=4, num_layers_up=2,
                            text_dim=12, t5_dim=16, text_len=8, t5_len=6)


def make_prompt_encoder(cfg: HunyuanDiTConfig, bert, bert_cfg, tokenize_bert, t5=None,
                        t5_cfg=None) -> Callable:
    """prompt -> (clip_emb, clip_mask, t5_emb, t5_mask), each with B = 1: the BERT tower
    over `tokenize_bert`'s ids (mask: id != 0), mT5's encoder over hash ids at the mT5
    length (zeros and a zero mask without mT5)."""
    from goal_force_tpu_torch.models import t5 as t5m
    from goal_force_tpu_torch.models.text_encoders import bert_encode

    device = bert.embeddings.word_embeddings.weight.device
    as_ids = lambda a: torch.as_tensor(np.asarray(a)[None], dtype=torch.long, device=device)

    def encode_prompt(prompt):
        ids = as_ids(tokenize_bert(prompt))
        mask = (ids != 0).to(torch.int32)
        clip_emb = bert_encode(bert, bert_cfg, ids, mask)
        if t5 is not None:
            tids = as_ids(hash_ids(prompt, t5_cfg.vocab, cfg.t5_len))
            tmask = (tids != 0).to(torch.int32)
            t5_emb = t5m.t5_encode(t5, t5_cfg, tids, tmask)
        else:
            t5_emb = clip_emb.new_zeros((1, cfg.t5_len, cfg.t5_dim))
            tmask = torch.zeros((1, cfg.t5_len), dtype=torch.int32, device=device)
        return clip_emb, mask, t5_emb, tmask

    return encode_prompt


@dataclasses.dataclass
class HunyuanImagePipeline:
    dit: HunyuanDiT
    vae_decoder: sv.SDVAEDecoder
    cfg: HunyuanDiTConfig
    vae_encoder: Optional[sv.SDVAEEncoder] = None
    vae_groups: int = 32
    vae_scaling: float = sv.SDXL_SCALING_FACTOR
    vae_factor: int = 8
    # encode_prompt(prompt) -> (clip_emb, clip_mask, t5_emb, t5_mask), each with B = 1
    encode_prompt: Optional[Callable] = None
    dtype: torch.dtype = torch.bfloat16

    @property
    def device(self) -> torch.device:
        return self.dit.style_embedder.device

    @classmethod
    def from_pretrained(cls, dit_path, bert_path=None, t5_path=None, vae_decoder_path=None,
                        vae_encoder_path=None, tokenizer="vendored", vae_plans=None,
                        vae_groups: int = 32, dtype: torch.dtype = torch.bfloat16,
                        bert_num_heads=None, t5_num_heads=None, device="cuda",
                        **infer_kw) -> "HunyuanImagePipeline":
        """The reference-format files, strictly (``io/auto.py::load_model``): the DiT, the
        BERT tower with the vendored tokenizer at the DiT's text length, mT5's encoder
        (hash ids at the mT5 length; zeros and a zero mask without it), the SD VAE halves
        (``vae_plans`` = (encoder plan, decoder plan), the released ones by default)."""
        from goal_force_tpu_torch.io.auto import load_model

        device = resolve_device(device)
        load = lambda path, **kw: load_model(path, dtype=dtype, device=device, **kw)
        dit = load(dit_path, **infer_kw)
        if dit["kind"] != "hunyuan_dit":
            raise ValueError(f"{dit_path} detected as {dit['kind']!r}")
        cfg = dit["config"]

        encode_prompt = None
        if bert_path is not None:
            rb = load(bert_path, num_heads=bert_num_heads)
            rt = load(t5_path, num_heads=t5_num_heads) if t5_path is not None else {}
            tok_bert = tokenizer
            if tokenizer == "vendored":
                from goal_force_tpu_torch.prompters import hunyuan_dit_tokenizers

                tok_bert = hunyuan_dit_tokenizers()[0].with_length(cfg.text_len)
            encode_prompt = make_prompt_encoder(cfg, rb["model"], rb["config"], tok_bert,
                                                rt.get("model"), rt.get("config"))

        enc_plan, dec_plan = vae_plans or (sv.SD_VAE_ENCODER_PLAN, sv.SD_VAE_DECODER_PLAN)
        vae_enc = vae_dec = None
        if vae_encoder_path is not None:
            vae_enc = load(vae_encoder_path, kind="sd_vae_encoder", plan=enc_plan)["model"]
        if vae_decoder_path is not None:
            vae_dec = load(vae_decoder_path, kind="sd_vae_decoder", plan=dec_plan)["model"]
        return cls(dit=dit["model"], vae_decoder=vae_dec, cfg=cfg, vae_encoder=vae_enc,
                   vae_groups=vae_groups, encode_prompt=encode_prompt, dtype=dtype)

    @classmethod
    def init_random(cls, seed: int = 0, dtype=torch.float32,
                    device="cuda") -> "HunyuanImagePipeline":
        """JAX's tiny pipeline: the tiny DiT and the tiny SD VAE (4 groups), from `seed`."""
        device = resolve_device(device)
        gen = torch.Generator(device).manual_seed(seed)
        cfg = tiny_hunyuan_dit_config()
        enc, dec = sv.init_tiny_sd_vae(gen, dtype, device=device)
        return cls(dit=init_hunyuan_dit(cfg, gen, dtype, device=device), vae_decoder=dec,
                   cfg=cfg, vae_encoder=enc, vae_groups=sv.TINY_SD_VAE_GROUPS, dtype=dtype)

    def _embeds(self, prompts):
        """(clip (B, 77, 1024), clip mask, mT5 (B, 256, 2048), mT5 mask) over the prompt
        rows, the embeddings in the pipeline's dtype."""
        dev = self.device
        if self.encode_prompt is not None:
            encs = [self.encode_prompt(p) for p in prompts]
        else:   # stand-in embeddings drawn from the hash ids' sum (not JAX's draw)
            def emb(text, dim, length):
                gen = torch.Generator().manual_seed(int(hash_ids(text, 997, length).sum()))
                return torch.randn((1, length, dim), generator=gen)

            c = self.cfg
            encs = [(emb(p, c.text_dim, c.text_len), torch.ones((1, c.text_len)),
                     emb(p, c.t5_dim, c.t5_len), torch.ones((1, c.t5_len))) for p in prompts]
        cat = lambda i: torch.cat([torch.as_tensor(e[i]).to(dev) for e in encs])
        return cat(0).to(self.dtype), cat(1), cat(2).to(self.dtype), cat(3)

    def _velocity(self, latents, t, embeds, size_emb, cfg_scale: float, local_w=None):
        """One merged forward over every prompt row, the regional blend, the guidance."""
        clip, clip_mask, t5, t5_mask = embeds
        b = latents.shape[0]
        n = clip.shape[0] // b
        pred = hunyuan_dit_forward(self.dit, self.cfg, torch.cat([latents] * n), clip, t5,
                                   clip_mask, t5_mask, torch.cat([t] * n), size_emb)
        p_pos, p_neg = pred[:b], pred[b:2 * b]
        if local_w is not None:
            from goal_force_tpu_torch.pipelines.regional import blend_local_predictions

            p_pos = blend_local_predictions(p_pos, pred[2 * b:], local_w)
        return p_neg + cfg_scale * (p_pos - p_neg)

    def _encode(self, img: torch.Tensor) -> torch.Tensor:
        return sv.sd_vae_encode(self.vae_encoder, img, self.vae_groups, self.vae_scaling)

    def _decode(self, z: torch.Tensor) -> torch.Tensor:
        return sv.sd_vae_decode(self.vae_decoder, z, self.vae_groups, self.vae_scaling)

    @torch.no_grad()
    def __call__(
        self,
        prompt: str,
        negative_prompt: str = "",
        cfg_scale: float = 7.5,
        height: int = 1024,
        width: int = 1024,
        num_inference_steps: int = 30,
        seed: int = 0,
        input_image: Optional[np.ndarray] = None,    # (H, W, 3) in [0, 1]
        denoising_strength: float = 1.0,
        local_prompts=None,
        masks=None,
        mask_scales=None,
        local_blur_kernel_size: int = 33,
        local_blur_sigma: float = 10.0,
        tiled: bool = False,
        tile_size: int = 64,
        tile_stride: int = 32,
        return_latents: bool = False,
        noise=None,                                  # (1, h, w, 4) initial latents
    ) -> np.ndarray:
        """Returns (H, W, 3) float32 in [0, 1] (the latents with return_latents)."""
        dev, dtype = self.device, self.dtype
        schedule = make_ddim_schedule(
            num_inference_steps, beta_start=0.00085, beta_end=0.03,
            prediction_type="v_prediction",
            denoising_strength=denoising_strength if input_image is not None else 1.0)
        local_prompts = list(local_prompts or [])
        embeds = self._embeds([prompt, negative_prompt] + local_prompts)
        size_emb = torch.tensor([[width, height, width, height, 0, 0]], dtype=torch.float32,
                                device=dev).repeat(2 + len(local_prompts), 1)

        h, w = height // self.vae_factor, width // self.vae_factor
        local_w = None
        if local_prompts:
            from goal_force_tpu_torch.pipelines.regional import local_prompt_weights

            local_w = torch.as_tensor(local_prompt_weights(
                masks, mask_scales, h, w, local_blur_kernel_size, local_blur_sigma),
                device=dev)
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
            img = torch.as_tensor(np.asarray(input_image, np.float32) * 2.0 - 1.0,
                                  device=dev)[None]
            if tiled:
                z = tiled_forward_2d(self._encode, img, tile_size * self.vae_factor,
                                     tile_stride * self.vae_factor)
            else:
                z = self._encode(img)
            latents = ddim_add_noise(schedule, z.to(dtype), latents,
                                     int(schedule.timesteps[0])).to(dtype)
        for i in range(len(schedule)):
            t = torch.full((1,), float(schedule.timesteps[i]), dtype=dtype, device=dev)
            pred = self._velocity(latents, t, embeds, size_emb, float(cfg_scale), local_w)
            latents = ddim_step(schedule, pred.to(latents.dtype), i, latents)
        if return_latents:
            return latents.float().cpu().numpy()
        z = latents.float()
        img = tiled_forward_2d(self._decode, z, min(tile_size, h, w), tile_stride) if tiled \
            else self._decode(z)
        return ((img[0] + 1.0) / 2.0).float().cpu().numpy().clip(0.0, 1.0)
