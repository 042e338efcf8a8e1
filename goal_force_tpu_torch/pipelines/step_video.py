"""StepVideo text-to-video pipeline in PyTorch.

Port of ``goal_force_tpu/pipelines/step_video.py``: the flow-match schedule with shift 13,
``sigma_min`` 0, ``extra_one_step``, reversed sigmas and ``num_train_timesteps=1``; latents
(1, F // 17 * 3, H / 16, W / 16, 64) in the pipeline's dtype; the two text streams (BERT,
HunyuanDiT's CLIP tower, at 77 tokens and Step-1 at 320) through
``make_stepvideo_prompt_encoder``; CFG as two forwards per step (B = 1 each, then
``vn + s * (vp - vn)``); the decode untiled with the seam mix (``smooth_scale``) or tiled,
then ``(x + 1) / 2`` clipped to [0, 1].

``noise=`` takes the initial latents in place of the seeded draw (the two packages'
random streams differ). Without ``encode_prompt`` JAX draws stand-in embeddings with
``jax.random`` from a key of the hash ids' sum, which the port cannot reproduce: the port
draws its own from a torch generator seeded the same way (ROADMAP queue 3).

Entry points run on the card unless ``device="cpu"`` is passed; ``__call__`` returns
float32 numpy frames (T, H, W, 3) in [0, 1], or latents with ``return_latents``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from goal_force_tpu_torch.models import stepvideo_vae as sv
from goal_force_tpu_torch.models.stepvideo_dit import (
    StepVideoConfig,
    StepVideoDiT,
    init_stepvideo_dit,
    stepvideo_dit_forward,
)
from goal_force_tpu_torch.models.tokenizer import hash_ids
from goal_force_tpu_torch.pipelines.goal_force import resolve_device
from goal_force_tpu_torch.pipelines.hunyuan_video import _np
from goal_force_tpu_torch.schedulers import flow_match


def tiny_stepvideo_configs():
    """The JAX package's tiny DiT and a tiny VAE whose z matches its in_channels."""
    dit_cfg = StepVideoConfig(num_heads=4, head_dim=16, num_layers=2, in_channels=8,
                              caption_dim=32, clip_dim=16, rope_split=(8, 4, 4))
    vae_cfg = dataclasses.replace(sv.tiny_stepvideo_vae_config(), z_dim=dit_cfg.in_channels)
    return dit_cfg, vae_cfg


def make_stepvideo_prompt_encoder(bert, bert_cfg, step1, step1_cfg, tokenize_bert=None,
                                  tokenize_step1=None, clip_len: int = 77,
                                  llm_len: int = 320):
    """encode(prompt, positive) -> (clip_emb (1, 77, bert_dim), llm_emb (1, 320, llm_dim)):
    BERT on its ids with the mask ids != 0, Step-1 on its ids unmasked; hash ids
    (``models/tokenizer.py::hash_ids``) where a tokenizer is not given."""
    from goal_force_tpu_torch.models.text_encoders import bert_encode, step1_encode

    device = bert.embeddings.word_embeddings.weight.device

    def ids(tokenize, prompt, vocab, length):
        a = np.asarray(tokenize(prompt)) if tokenize is not None else hash_ids(prompt, vocab,
                                                                                length)
        return torch.as_tensor(a[None], dtype=torch.long, device=device)

    def encode(prompt: str, positive: bool = True):
        bids = ids(tokenize_bert, prompt, bert_cfg.vocab, clip_len)
        clip_emb = bert_encode(bert, bert_cfg, bids, (bids != 0).to(torch.int32))
        llm_emb = step1_encode(step1, step1_cfg, ids(tokenize_step1, prompt, step1_cfg.vocab,
                                                     llm_len))
        return clip_emb, llm_emb

    return encode


@dataclasses.dataclass
class StepVideoPipeline:
    dit: StepVideoDiT
    vae: Optional[sv.StepVideoVAE]
    dit_cfg: StepVideoConfig
    vae_cfg: sv.StepVideoVAEConfig
    # encode_prompt(prompt, positive) -> (clip_emb (B, Lc, clip_dim), llm_emb (B, L, dim))
    encode_prompt: Optional[Callable] = None
    dtype: torch.dtype = torch.bfloat16

    @property
    def device(self) -> torch.device:
        return self.dit.proj_out.weight.device

    @classmethod
    def init_random(cls, seed: int = 0, dtype=torch.float32, device="cuda"):
        """The tiny DiT and VAE decoder (``tiny_stepvideo_configs``), random weights from
        `seed`."""
        device = resolve_device(device)
        dit_cfg, vae_cfg = tiny_stepvideo_configs()
        gen = torch.Generator(device).manual_seed(seed)
        return cls(dit=init_stepvideo_dit(dit_cfg, gen, dtype, device=device),
                   vae=sv.init_stepvideo_vae(vae_cfg, gen, dtype, device=device,
                                             encoder=False),
                   dit_cfg=dit_cfg, vae_cfg=vae_cfg, dtype=dtype)

    @classmethod
    def from_pretrained(
        cls,
        dit_path,
        vae_path=None,
        vae_cfg=None,                      # StepVideoVAEConfig; default: the released one
        encode_prompt=None,                # (prompt, positive) -> (clip, llm)
        bert_path=None,                    # HunyuanDiT's CLIP tower (BERT)
        step1_path=None,                   # the Step-1 LLM
        bert_tokenizer="vendored",
        step1_tokenizer_dir=None,          # ships with the LLM's checkpoint
        dtype: torch.dtype = torch.bfloat16,
        bert_num_heads=None,
        step1_num_heads=None,
        device="cuda",
    ) -> "StepVideoPipeline":
        """Load the reference-format files strictly (``io/auto.py::load_model``), every
        model in `dtype` on `device`. With bert_path and step1_path (and no
        encode_prompt) the prompt encoder is built from them: BERT with the vendored
        WordPiece tokenizer at 77 tokens, Step-1 with step1_tokenizer_dir's at 320 (hash
        ids without one)."""
        from goal_force_tpu_torch.io.auto import load_model

        device = resolve_device(device)
        load = lambda path, **kw: load_model(path, dtype=dtype, device=device, **kw)
        dit = load(dit_path)
        if dit["kind"] != "stepvideo_dit":
            raise ValueError(f"{dit_path} detected as {dit['kind']!r}")
        vcfg = vae_cfg or sv.StepVideoVAEConfig()
        vae = None if vae_path is None else load(vae_path, kind="stepvideo_vae",
                                                 config=vcfg)["model"]
        if encode_prompt is None and bert_path is not None and step1_path is not None:
            rb = load(bert_path, num_heads=bert_num_heads)
            rs = load(step1_path, num_heads=step1_num_heads)
            tok_bert = bert_tokenizer
            if bert_tokenizer == "vendored":
                from goal_force_tpu_torch.prompters import hunyuan_dit_tokenizers

                tok_bert, _ = hunyuan_dit_tokenizers()
            tok_step1 = None
            if step1_tokenizer_dir is not None:
                from goal_force_tpu_torch.prompters import load_text_tokenizer

                tok_step1 = load_text_tokenizer(step1_tokenizer_dir, 320)
            encode_prompt = make_stepvideo_prompt_encoder(
                rb["model"], rb["config"], rs["model"], rs["config"],
                tokenize_bert=tok_bert, tokenize_step1=tok_step1)
        return cls(dit=dit["model"], vae=vae, dit_cfg=dit["config"], vae_cfg=vcfg,
                   encode_prompt=encode_prompt, dtype=dtype)

    def _velocity(self, latents, t, llm_p, clip_p, llm_n, clip_n, cfg_scale: float):
        """CFG as two forwards of B = 1: the prompt's, then the negative prompt's."""
        fwd = lambda llm, clip: stepvideo_dit_forward(self.dit, self.dit_cfg, latents, t, llm,
                                                      clip)
        vp = fwd(llm_p, clip_p)
        vn = fwd(llm_n, clip_n)
        return vn + cfg_scale * (vp - vn)

    def _prompts(self, prompt, negative_prompt):
        if self.encode_prompt is not None:
            clip_p, llm_p = self.encode_prompt(prompt, True)
            clip_n, llm_n = self.encode_prompt(negative_prompt, False)
        else:   # stand-in embeddings drawn from the hash ids' sum (not JAX's draw)
            def emb(text, dim, length):
                gen = torch.Generator().manual_seed(int(hash_ids(text, 997, length).sum()))
                return torch.randn((1, length, dim), generator=gen).to(self.device)

            clip_p = emb(prompt, self.dit_cfg.clip_dim, 4)
            clip_n = emb(negative_prompt, self.dit_cfg.clip_dim, 4)
            llm_p = emb(prompt, self.dit_cfg.caption_dim, 8)
            llm_n = emb(negative_prompt, self.dit_cfg.caption_dim, 8)
        return tuple(x.to(self.device, self.dtype) for x in (llm_p, clip_p, llm_n, clip_n))

    def _decode(self, latents, tiled: bool, tile_size, tile_stride, smooth_scale: float):
        if tiled:
            return sv.stepvideo_vae_decode_tiled(self.vae, latents, self.vae_cfg,
                                                 tuple(tile_size), tuple(tile_stride))
        return sv.stepvideo_vae_decode(self.vae, latents, self.vae_cfg,
                                       smooth_scale=smooth_scale)

    @torch.no_grad()
    def __call__(
        self,
        prompt: str,
        negative_prompt: str = "",
        cfg_scale: float = 9.0,
        height: int = 544,
        width: int = 992,
        num_frames: int = 204,
        num_inference_steps: int = 30,
        seed: int = 0,
        smooth_scale: float = 0.6,
        tiled: bool = False,
        tile_size=(34, 34),
        tile_stride=(16, 16),
        return_latents: bool = False,
        noise=None,
    ) -> np.ndarray:
        """Frames (T, H, W, 3) in [0, 1]. tiled: the decode in spatial tiles given in
        latent units (no seam mix). noise: (1, num_frames // 17 * 3, height / 16,
        width / 16, in_channels) in place of the seeded draw."""
        dev = self.device
        schedule = flow_match.make_schedule(
            num_inference_steps, shift=13.0, sigma_min=0.0, extra_one_step=True,
            reverse_sigmas=True, num_train_timesteps=1)
        llm_p, clip_p, llm_n, clip_n = self._prompts(prompt, negative_prompt)

        f = max(num_frames // self.vae_cfg.frame_len * self.vae_cfg.latent_len, 1)
        shape = (1, f, height // 16, width // 16, self.dit_cfg.in_channels)
        if noise is None:
            gen = torch.Generator(dev).manual_seed(seed)
            noise = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        noise = (noise if torch.is_tensor(noise) else torch.from_numpy(
            np.array(noise, np.float32))).to(dev, torch.float32)
        if tuple(noise.shape) != shape:
            raise ValueError(f"noise has shape {tuple(noise.shape)}, expected {shape}")
        latents = noise.to(self.dtype)
        for i in range(len(schedule)):
            t = torch.full((1,), float(schedule.timesteps[i]), dtype=self.dtype, device=dev)
            v = self._velocity(latents, t, llm_p, clip_p, llm_n, clip_n, float(cfg_scale))
            latents = flow_match.euler_step(latents, v.to(latents.dtype), schedule.sigmas[i],
                                            schedule.sigma_next(i))
        if return_latents:
            return _np(latents)
        video = self._decode(latents.float(), tiled, tile_size, tile_stride, smooth_scale)
        return np.clip((_np(video[0]) + 1.0) / 2.0, 0.0, 1.0)
