"""CogVideoX text-to-video pipeline in PyTorch.

Port of ``goal_force_tpu/pipelines/cog_video.py``: zero-terminal-SNR DDIM with
v-prediction, CFG always run as one merged batch of 2 (the prompt's row, then the
negative prompt's), 49-frame 480x720 defaults, T5 v1.1 conditioning at 226 tokens (the
vendored ``spiece.model`` through ``prompters.py::cog_tokenizer``), video-to-video through
``ddim_add_noise``, and an optional spatially tiled VAE. ``noise=`` takes the initial
latents in place of the seeded draw (the RNG streams of the two packages differ, so
tests pass JAX's draw in).

Entry points run on the card unless ``device="cpu"`` is passed; ``__call__`` returns
float32 numpy frames (B, T, H, W, 3) in [-1, 1] from the decoder, or latents without one.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from goal_force_tpu_torch.configs import T5Config
from goal_force_tpu_torch.models import t5 as t5m
from goal_force_tpu_torch.models.cog_dit import (
    CogDiT,
    CogDiTConfig,
    cog_dit_forward,
    init_cog_dit,
)
from goal_force_tpu_torch.models.tokenizer import hash_ids
from goal_force_tpu_torch.pipelines.goal_force import resolve_device
from goal_force_tpu_torch.pipelines.hunyuan_video import _np
from goal_force_tpu_torch.schedulers.ddim import ddim_add_noise, ddim_step, make_ddim_schedule


def tiny_cog_configs():
    # rope_dim must split 1/4 + 3/8 + 3/8 into even dims -> head_dim 16
    dit_cfg = CogDiTConfig(dim=64, cond_dim=32, num_heads=4, num_blocks=2,
                           text_dim=32, freq_dim=32, rope_dim=16)
    t5_cfg = T5Config(vocab=128, dim=32, dim_attn=32, dim_ffn=64, num_heads=4,
                      num_layers=2, shared_pos=True, text_len=16)
    return dit_cfg, t5_cfg


def cog_vae_codec(model, cfg, side: str):
    """encode_video or decode_video over one Cog VAE half, taking ``tiled``,
    ``tile_size`` and ``tile_stride`` keywords as the pipeline passes them."""
    from goal_force_tpu_torch.models import cog_vae as cv

    plain, tiled = ((cv.cog_vae_decode, cv.cog_vae_decode_tiled) if side == "decoder"
                    else (cv.cog_vae_encode, cv.cog_vae_encode_tiled))
    return lambda x, **tk: (tiled(model, x, cfg, tk["tile_size"], tk["tile_stride"])
                            if tk.get("tiled") else plain(model, x, cfg))


@dataclasses.dataclass
class CogVideoPipeline:
    dit: CogDiT
    t5: Optional[t5m.T5Encoder]
    dit_cfg: CogDiTConfig
    t5_cfg: Optional[T5Config] = None
    tokenize: Optional[Callable] = None
    decode_video: Optional[Callable] = None   # latents -> (B, T, H, W, 3) in [-1, 1]
    encode_video: Optional[Callable] = None   # (B, T, H, W, 3) in [-1, 1] -> latents
    dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "auto"

    @property
    def device(self) -> torch.device:
        return self.dit.proj_out.weight.device

    @classmethod
    def init_random(cls, seed: int = 0, dtype=torch.float32, device="cuda"):
        """The tiny DiT and T5 (``tiny_cog_configs``) with random weights from `seed`."""
        device = resolve_device(device)
        dit_cfg, t5_cfg = tiny_cog_configs()
        gen = torch.Generator(device).manual_seed(seed)
        return cls(dit=init_cog_dit(dit_cfg, gen, dtype, device=device),
                   t5=t5m.init_t5(t5_cfg, gen, dtype, device=device),
                   dit_cfg=dit_cfg, t5_cfg=t5_cfg, dtype=dtype)

    @classmethod
    def from_pretrained(
        cls,
        dit_path,
        text_encoder_path=None,            # T5 v1.1 (reference naming)
        vae_encoder_path=None,
        vae_decoder_path=None,
        vae_cfg=None,                      # CogVAEConfig; default: the released 5B
        tokenizer="vendored",              # cog spiece, 226 tokens
        t5_length: int = 226,
        dtype: torch.dtype = torch.bfloat16,
        t5_num_heads=None,
        device="cuda",
        **infer_kw,                        # rope_dim for tiny DiT files
    ) -> "CogVideoPipeline":
        """Load the reference-format files strictly (``io/auto.py::load_model``), every
        model in `dtype` on `device`."""
        from goal_force_tpu_torch.io.auto import load_model
        from goal_force_tpu_torch.models import cog_vae as cv

        device = resolve_device(device)
        load = lambda path, **kw: load_model(path, dtype=dtype, device=device, **kw)
        dit = load(dit_path, **infer_kw)
        if dit["kind"] != "cog_dit":
            raise ValueError(f"{dit_path} detected as {dit['kind']!r}")
        t5_cfg, t5 = None, None
        if text_encoder_path is not None:
            r = load(text_encoder_path, num_heads=t5_num_heads)
            t5_cfg, t5 = dataclasses.replace(r["config"], text_len=t5_length), r["model"]
        vcfg = vae_cfg or cv.CogVAEConfig()
        codecs = {}
        for side, path in (("decoder", vae_decoder_path), ("encoder", vae_encoder_path)):
            if path is not None:
                r = load(path, kind="cog_vae", config=vcfg)
                if cv.cog_vae_side(r["model"].state_dict()) != side:
                    raise ValueError(f"{path} holds the Cog VAE's other half, not its {side}")
                codecs[side] = cog_vae_codec(r["model"], vcfg, side)
        tok = tokenizer
        if tokenizer == "vendored":
            from goal_force_tpu_torch.prompters import cog_tokenizer

            tok = cog_tokenizer(length=t5_length)
        return cls(dit=dit["model"], t5=t5, dit_cfg=dit["config"],
                   t5_cfg=t5_cfg or tiny_cog_configs()[1], tokenize=tok,
                   decode_video=codecs.get("decoder"), encode_video=codecs.get("encoder"),
                   dtype=dtype)

    def _ids(self, prompts) -> torch.Tensor:
        ids = np.stack([np.asarray(self.tokenize(p)) if self.tokenize
                        else hash_ids(p, self.t5_cfg.vocab, self.t5_cfg.text_len)
                        for p in prompts])
        return torch.as_tensor(ids, dtype=torch.long, device=self.device)

    def _encode_text(self, prompts) -> torch.Tensor:
        ids = self._ids(prompts)
        return t5m.t5_encode(self.t5, self.t5_cfg, ids, torch.ones_like(ids))

    def _velocity(self, latents, timestep, emb2, cfg_scale: float):
        """The merged-CFG velocity: both rows in one forward, then the guidance."""
        b = latents.shape[0]
        v = cog_dit_forward(self.dit, self.dit_cfg, torch.cat([latents, latents]),
                            torch.cat([timestep, timestep]), emb2, attn_impl=self.attn_impl)
        return v[b:] + cfg_scale * (v[:b] - v[b:])

    @torch.no_grad()
    def __call__(
        self,
        prompt: str,
        negative_prompt: str = "",
        cfg_scale: float = 7.0,
        input_video: Optional[np.ndarray] = None,   # (B, T, H, W, 3) in [-1, 1]
        denoising_strength: float = 1.0,
        num_frames: int = 49,
        height: int = 480,
        width: int = 720,
        num_inference_steps: int = 20,
        seed: int = 0,
        progress: bool = False,
        tiled: bool = False,
        tile_size=(60, 90),
        tile_stride=(30, 45),
        noise=None,
    ) -> np.ndarray:
        """Frames (B, T, H, W, 3) when a decoder is present, else latents. tiled: the VAE
        in spatial tiles given in latent units. input_video + denoising_strength < 1:
        v2v (encode, noise to the schedule's first timestep). noise: (1, num_frames // 4
        + 1, height / 8, width / 8, 16) in place of the seeded draw."""
        dev = self.device
        tk = dict(tiled=tiled, tile_size=tuple(tile_size),
                  tile_stride=tuple(tile_stride)) if tiled else {}
        schedule = make_ddim_schedule(num_inference_steps, prediction_type="v_prediction",
                                      rescale_zero_terminal_snr=True,
                                      denoising_strength=denoising_strength)
        emb = self._encode_text([prompt, negative_prompt]).to(self.dtype)

        shape = (1, num_frames // 4 + 1, height // 8, width // 8, self.dit_cfg.in_channels)
        if noise is None:
            gen = torch.Generator(dev).manual_seed(seed)
            noise = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        noise = (noise if torch.is_tensor(noise) else torch.from_numpy(
            np.array(noise, np.float32))).to(dev, torch.float32)
        if tuple(noise.shape) != shape:
            raise ValueError(f"noise has shape {tuple(noise.shape)}, expected {shape}")
        latents = noise.to(self.dtype)
        if denoising_strength != 1.0 and input_video is not None:
            if self.encode_video is None:
                raise ValueError("input_video requires encode_video")
            video = torch.as_tensor(np.asarray(input_video, np.float32)).to(dev)
            z = self.encode_video(video, **tk).to(self.dtype)
            latents = ddim_add_noise(schedule, z, latents, int(schedule.timesteps[0]))

        steps = range(len(schedule))
        if progress:
            import tqdm

            steps = tqdm.tqdm(steps)
        for i in steps:
            ts = torch.full((1,), float(schedule.timesteps[i]), dtype=self.dtype, device=dev)
            v = self._velocity(latents, ts, emb, cfg_scale)
            latents = ddim_step(schedule, v.to(latents.dtype), i, latents)
        if self.decode_video is not None:
            return _np(self.decode_video(latents, **tk))
        return _np(latents)
