"""Flux.1 text-to-image and image-to-image pipeline in PyTorch.

Port of ``goal_force_tpu/pipelines/flux.py``: CLIP-L's pooled embedding and T5 v1.1 XXL's
states (the vendored tokenizers, T5 at 512 tokens), the flow-match Euler schedule (shift
3.0, sigma_min 0.003 / 1.002, no extra step, ``denoising_strength`` for image-to-image),
embedded guidance (FLUX.1-dev), optional true CFG as one merged batch of 2 (the prompt's
row, then the negative prompt's), and the 16-channel SD3-architecture VAE with Flux's
(scaling, shift), run in float32 over the pipeline's weights as JAX runs it.

Every argument of JAX ``FluxPipeline.__call__`` is here: ``tiled`` (the whole DiT per
latent tile, and the VAE in tiles; refused with the extras, as JAX refuses them), the
ControlNet (``controlnet={"model", "cfg"}``, a mode, InfiniteYou's identity tokens as its
prompt), Kontext, Step1X (``step1x={"model", "cfg"}``), the IP-Adapter, ``flex_condition``
with its stop timestep, EliGen (two forwards a step), ``prompt_emb_override``, the value
controller's and the LoRA encoder's tokens (the positive branch only; refused under CFG),
TeaCache with FLUX.1-dev's coefficients, and ``rope_tables_override``. The port adds
``noise=`` (the initial latents in place of the seeded draw: the two packages' RNG
streams differ) and ``device``.

Entry points run on the card unless ``device="cpu"`` is passed; ``__call__`` returns
(H, W, 3) float32 numpy in [0, 1].
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from goal_force_tpu_torch.configs import FluxDiTConfig, T5Config
from goal_force_tpu_torch.models import flux_dit as fd
from goal_force_tpu_torch.models import sd_vae as sv
from goal_force_tpu_torch.models import t5 as t5m
from goal_force_tpu_torch.models.clip import CLIPConfig, CLIPTextModel, init_clip_text
from goal_force_tpu_torch.models.sd_text_encoder import SD_TEXT_CONFIG, sd3_text1_encode
from goal_force_tpu_torch.models.tiler import tiled_forward_2d
from goal_force_tpu_torch.models.tokenizer import hash_ids
from goal_force_tpu_torch.models.wan_dit import linear
from goal_force_tpu_torch.pipelines.goal_force import resolve_device
from goal_force_tpu_torch.schedulers import flow_match as fm

FLUX_SIGMA_MIN = 0.003 / 1.002
FLUX_SHIFT = 3.0

def tiny_flux_configs():
    """Mutually consistent tiny configs for tests (axes_dim sums to head_dim)."""
    dit_cfg = FluxDiTConfig(dim=64, num_heads=4, num_joint_blocks=2, num_single_blocks=2,
                            text_dim=32, pooled_dim=48, freq_dim=32, axes_dim=(4, 6, 6))
    t5_cfg = T5Config(vocab=128, dim=32, dim_attn=32, dim_ffn=64, num_heads=4,
                      num_layers=2, shared_pos=True, text_len=16)
    clip_cfg = dataclasses.replace(SD_TEXT_CONFIG, text_dim=48, text_heads=4, text_layers=2)
    return dit_cfg, t5_cfg, clip_cfg


def tiny_sd3_vae_plans():
    """Small SD3-architecture VAE plans for tests (every block kind, one 2x level)."""
    enc = (("res", 8, 8), ("downe", 8), ("res", 8, 16),
           ("res", 16, 16), ("vattn", 16), ("res", 16, 16))
    dec = (("res", 16, 16), ("vattn", 16), ("res", 16, 16),
           ("res", 16, 8), ("up", 8), ("res", 8, 8))
    return enc, dec, 4


def _factor(enc_plan) -> int:
    return 2 ** sum(1 for b in enc_plan if b[0] == "downe")


def _tile2(t: Optional[torch.Tensor], dim: int = 0) -> Optional[torch.Tensor]:
    return None if t is None else torch.cat([t, t], dim=dim)


@dataclasses.dataclass
class FluxPipeline:
    dit: fd.FluxDiT
    clip: CLIPTextModel
    t5: t5m.T5Encoder
    vae_encoder: Optional[sv.SDVAEEncoder]
    vae_decoder: sv.SDVAEDecoder
    dit_cfg: FluxDiTConfig
    t5_cfg: T5Config
    clip_cfg: CLIPConfig = SD_TEXT_CONFIG
    vae_scaling: Tuple[float, float] = sv.FLUX_SCALING
    vae_groups: int = 32
    vae_factor: int = 8                       # spatial down/up factor of the plans
    tokenize_clip: Optional[Callable] = None  # str -> (77,) ids
    tokenize_t5: Optional[Callable] = None    # str -> (L,) ids
    dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "auto"

    @property
    def device(self) -> torch.device:
        return self.dit.x_embedder.weight.device

    @classmethod
    def init_random(cls, seed: int = 0, dit_cfg=None, t5_cfg=None, clip_cfg=None,
                    vae_plans=None, dtype=torch.float32, device="cuda") -> "FluxPipeline":
        """Random weights from `seed`: the tiny configs and VAE plans unless given."""
        device = resolve_device(device)
        if dit_cfg is None:
            dit_cfg, t5_cfg, clip_cfg = tiny_flux_configs()
        enc_plan, dec_plan, groups = vae_plans or tiny_sd3_vae_plans()
        gen = torch.Generator(device).manual_seed(seed)
        return cls(
            dit=fd.init_flux_dit(dit_cfg, gen, dtype, device=device),
            clip=init_clip_text(clip_cfg, gen, dtype, device=device),
            t5=t5m.init_t5(t5_cfg, gen, dtype, device=device),
            vae_encoder=sv.init_sd_vae(sv.SDVAEEncoder, enc_plan, gen, dtype, device=device),
            vae_decoder=sv.init_sd_vae(sv.SDVAEDecoder, dec_plan, gen, dtype, device=device),
            dit_cfg=dit_cfg, t5_cfg=t5_cfg, clip_cfg=clip_cfg, vae_groups=groups,
            vae_factor=_factor(enc_plan), dtype=dtype)

    @classmethod
    def from_pretrained(
        cls,
        dit_path,
        text_encoder_path=None,            # CLIP-L (reference naming)
        text_encoder_2_path=None,          # T5 v1.1 XXL (reference naming)
        vae_encoder_path=None,
        vae_decoder_path=None,
        tokenizer_1="vendored",            # None -> hash fallback (warned)
        tokenizer_2="vendored",
        t5_length: int = 512,
        vae_plans=None,                    # (enc_plan, dec_plan, groups)
        dtype: torch.dtype = torch.bfloat16,
        clip_num_heads=None,
        t5_num_heads=None,
        device="cuda",
        **infer_kw,                        # e.g. num_heads / axes_dim for the DiT
    ) -> "FluxPipeline":
        """Load the reference-format files strictly (``io/auto.py::load_model``), every
        model in `dtype` on `device`. A missing text tower is drawn at random (seed 0), as
        JAX does; the tokenizers default to the vendored Flux ones."""
        from goal_force_tpu_torch.io.auto import load_model

        device = resolve_device(device)
        load = lambda path, **kw: load_model(path, dtype=dtype, device=device, **kw)
        dit = load(dit_path, **infer_kw)
        if dit["kind"] != "flux_dit":
            raise ValueError(f"{dit_path} detected as {dit['kind']!r}, not flux_dit")
        enc_plan, dec_plan, groups = vae_plans or (sv.SD_VAE_ENCODER_PLAN,
                                                   sv.SD_VAE_DECODER_PLAN, 32)
        gen = torch.Generator(device).manual_seed(0)
        clip_cfg, clip = SD_TEXT_CONFIG, None
        if text_encoder_path is not None:
            r = load(text_encoder_path, num_heads=clip_num_heads)
            clip_cfg, clip = r["config"], r["model"]
        t5_cfg, t5 = None, None
        if text_encoder_2_path is not None:
            r = load(text_encoder_2_path, num_heads=t5_num_heads)
            t5_cfg, t5 = dataclasses.replace(r["config"], text_len=t5_length), r["model"]
        vae_enc = vae_dec = None
        if vae_encoder_path is not None:
            vae_enc = load(vae_encoder_path, plan=enc_plan)["model"]
        if vae_decoder_path is not None:
            vae_dec = load(vae_decoder_path, plan=dec_plan)["model"]

        if tokenizer_1 == "vendored" or tokenizer_2 == "vendored":
            from goal_force_tpu_torch.prompters import flux_tokenizers

            v1, v2 = flux_tokenizers(t5_length=t5_length)
            tok_clip = v1 if tokenizer_1 == "vendored" else tokenizer_1
            tok_t5 = v2 if tokenizer_2 == "vendored" else tokenizer_2
        else:
            tok_clip, tok_t5 = tokenizer_1, tokenizer_2
        if tok_clip is None or tok_t5 is None:
            import warnings

            warnings.warn(
                "FluxPipeline.from_pretrained without real tokenizers: prompts "
                "will be HASHED into ids (garbage embeddings). Pass "
                "tokenizer_1/tokenizer_2='vendored' or callables.", stacklevel=2)
        return cls(
            dit=dit["model"],
            clip=clip if clip is not None else init_clip_text(clip_cfg, gen, dtype, device=device),
            t5=t5 if t5 is not None else t5m.init_t5(t5_cfg or T5Config(), gen, dtype,
                                                     device=device),
            vae_encoder=vae_enc, vae_decoder=vae_dec, dit_cfg=dit["config"],
            t5_cfg=t5_cfg or T5Config(), clip_cfg=clip_cfg, vae_groups=groups,
            vae_factor=_factor(enc_plan), tokenize_clip=tok_clip, tokenize_t5=tok_t5,
            dtype=dtype)

    # ------------------------------------------------------------------
    # Stages
    # ------------------------------------------------------------------

    def _ids(self, prompts):
        clip_ids = np.stack([np.asarray(self.tokenize_clip(p)) if self.tokenize_clip
                             else hash_ids(p, self.clip_cfg.vocab_size, 77) for p in prompts])
        t5_ids = np.stack([np.asarray(self.tokenize_t5(p)) if self.tokenize_t5
                           else hash_ids(p, self.t5_cfg.vocab, self.t5_cfg.text_len)
                           for p in prompts])
        as_ids = lambda a: torch.as_tensor(a, dtype=torch.long, device=self.device)
        return as_ids(clip_ids), as_ids(t5_ids)

    def _encode_text(self, prompts):
        """(T5 states (B, L, dim), CLIP pooled (B, 768)) in the pipeline's dtype."""
        clip_ids, t5_ids = self._ids(prompts)
        emb = t5m.t5_encode(self.t5, self.t5_cfg, t5_ids, torch.ones_like(t5_ids))
        pooled, _ = sd3_text1_encode(self.clip, clip_ids, self.clip_cfg)
        return emb.to(self.dtype), pooled.to(self.dtype)

    def _encode(self, img: torch.Tensor) -> torch.Tensor:
        return sv.sd3_vae_encode(self.vae_encoder, img, self.vae_scaling, self.vae_groups)

    def _decode(self, z: torch.Tensor) -> torch.Tensor:
        return sv.sd3_vae_decode(self.vae_decoder, z, self.vae_scaling, self.vae_groups)

    def _image(self, image) -> torch.Tensor:
        """(H, W, 3) in [0, 1] -> (1, H, W, 3) float32 in [-1, 1] on the device."""
        return torch.as_tensor(np.asarray(image, np.float32), device=self.device)[None] * 2.0 - 1.0

    def _forward(self, x, t, prompt_emb, pooled, guidance, **kw):
        return fd.flux_dit_forward(self.dit, self.dit_cfg, x, t, prompt_emb, pooled, guidance,
                                   attn_impl=self.attn_impl, **kw)

    def _velocity(self, model_in, timestep, prompt_emb, pooled, guidance, cfg_scale: float,
                  use_cfg: bool, tile_ctx=None, cn_res=None, cn_single_res=None, kontext=None,
                  ip=None, rope_override=None, return_tokens: bool = False):
        """The DiT's velocity: under CFG both rows in one merged forward of 2, then the
        guidance; with tile_ctx (tile, stride) the whole DiT per latent tile."""
        b = model_in.shape[0]
        if use_cfg:
            model_in, timestep, guidance = (torch.cat([a, a]) for a in
                                            (model_in, timestep, guidance))
            cn_res, cn_single_res = _tile2(cn_res, 1), _tile2(cn_single_res, 1)
            kontext = _tile2(kontext)
        else:
            prompt_emb, pooled = prompt_emb[:b], pooled[:b]
        if tile_ctx is not None:
            v = tiled_forward_2d(lambda xt: self._forward(xt, timestep, prompt_emb, pooled,
                                                          guidance),
                                 model_in, *tile_ctx).to(model_in.dtype)
        else:
            v = self._forward(model_in, timestep, prompt_emb, pooled, guidance,
                              controlnet_res=cn_res, controlnet_single_res=cn_single_res,
                              kontext_latents=kontext, ipadapter=ip,
                              rope_tables_override=rope_override, return_tokens=return_tokens)
        if return_tokens:
            v, *tokens = v
        if use_cfg:
            v = v[b:] + cfg_scale * (v[:b] - v[b:])
        return (v, *tokens) if return_tokens else v

    @torch.no_grad()
    def __call__(
        self,
        prompt: str,
        negative_prompt: str = "",
        cfg_scale: float = 1.0,
        embedded_guidance: float = 3.5,
        input_image: Optional[np.ndarray] = None,   # (H, W, 3) float [0, 1]
        denoising_strength: float = 1.0,
        height: int = 1024,
        width: int = 1024,
        num_inference_steps: int = 30,
        sigma_shift: Optional[float] = None,
        seed: int = 0,
        progress: bool = False,
        controlnet: Optional[Dict] = None,          # {"model": FluxControlNet, "cfg"}
        controlnet_image: Optional[np.ndarray] = None,   # (H, W, 3) in [0, 1]
        controlnet_mode: Optional[int] = None,
        kontext_image: Optional[np.ndarray] = None,      # (H, W, 3) in [0, 1]
        id_embeds: Optional[np.ndarray] = None,     # (B, N, 512) ArcFace tokens
        infiniteyou=None,                           # InfiniteYouProjector
        infiniteyou_guidance: float = 1.0,
        step1x: Optional[Dict] = None,              # {"model": Step1xConnector, "cfg"}
        step1x_llm_embedding: Optional[np.ndarray] = None,  # (B, S, 3584)
        step1x_mask: Optional[np.ndarray] = None,           # (B, S)
        flex_condition=None,                        # (1, h, w, C) extra channels
        flex_uncondition=None,
        flex_control_stop_timestep: float = 0.0,
        eligen_entity_prompts=None,                 # list[str]
        eligen_entity_masks=None,                   # (M, H, W) float [0, 1]
        eligen_enable_on_negative: bool = False,
        prompt_emb_override=None,                   # (B, S, text_dim) array or tensor
        tea_cache_thresh: float = 0.0,              # > 0 enables TeaCache
        ipadapter=None,                             # FluxIpAdapter
        ipadapter_image_emb: Optional[np.ndarray] = None,   # (B, siglip_dim)
        ipadapter_scale: float = 1.0,
        rope_tables_override=None,                  # (cos, sin)
        tiled: bool = False,
        tile_size: int = 128,
        tile_stride: int = 64,
        value_controller=None,                      # list of SingleValueEncoder
        value_controller_inputs=None,               # list of floats (or None)
        lora_encoder=None,                          # FluxLoRAEncoder or {"model", ...}
        lora_encoder_inputs=None,                   # list of LoRA state dicts
        lora_encoder_scale: float = 1.0,
        noise=None,                                 # (1, h, w, 16) initial latents
    ) -> np.ndarray:
        """Returns (H, W, 3) float32 in [0, 1]."""
        dev, dtype = self.device, self.dtype
        schedule = fm.make_schedule(
            num_steps=num_inference_steps,
            shift=FLUX_SHIFT if sigma_shift is None else sigma_shift,
            sigma_min=FLUX_SIGMA_MIN, extra_one_step=False,
            denoising_strength=denoising_strength)
        use_cfg = cfg_scale != 1.0
        prompt_emb, pooled = self._encode_text([prompt, negative_prompt] if use_cfg else [prompt])
        if prompt_emb_override is not None:
            ov = prompt_emb_override if torch.is_tensor(prompt_emb_override) \
                else torch.as_tensor(np.asarray(prompt_emb_override))
            ov = ov.to(dev, dtype)
            prompt_emb = ov.expand((prompt_emb.shape[0],) + tuple(ov.shape[1:]))

        # extra conditioning tokens on the positive prompt only
        extra_tokens = []
        if value_controller is not None and value_controller_inputs is not None:
            from goal_force_tpu_torch.models.flux_adapters import multi_value_embedding

            vals = value_controller_inputs
            vals = vals if isinstance(vals, (list, tuple)) else [vals]
            extra_tokens.append(multi_value_embedding(value_controller, vals)[None])
        if lora_encoder is not None and lora_encoder_inputs is not None:
            from goal_force_tpu_torch.models.flux_adapters import flux_lora_encode

            le_model, le_kw = lora_encoder, {}
            if isinstance(lora_encoder, dict):
                le_model = lora_encoder["model"]
                le_kw = {k: v for k, v in lora_encoder.items()
                         if k in ("patterns", "heads", "num_special")}
            loras = lora_encoder_inputs
            loras = loras if isinstance(loras, (list, tuple)) else [loras]
            le = torch.cat([flux_lora_encode(le_model, lo, **le_kw) for lo in loras], dim=1)
            extra_tokens.append(le * lora_encoder_scale)
        if extra_tokens:
            if use_cfg:
                raise NotImplementedError(
                    "value_controller/lora_encoder tokens compose with the "
                    "embedded-guidance path (cfg_scale == 1) only")
            prompt_emb = torch.cat([prompt_emb] + [t.to(dtype) for t in extra_tokens], dim=1)

        if tiled and (controlnet is not None or kontext_image is not None
                      or step1x is not None or ipadapter is not None
                      or flex_condition is not None or eligen_entity_prompts is not None
                      or rope_tables_override is not None or tea_cache_thresh > 0):
            raise NotImplementedError("tiled=True composes with the base/CFG path only")

        h, w = height // self.vae_factor, width // self.vae_factor
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
            img = self._image(input_image)
            if tiled:
                z = tiled_forward_2d(self._encode, img, tile_size, tile_stride)
            else:
                z = self._encode(img)
            latents = fm.add_noise(z.to(dtype), latents, schedule.sigmas[0])

        guidance = torch.full((1,), embedded_guidance, dtype=dtype, device=dev)

        cn_fn = None
        if controlnet is not None and controlnet_image is not None:
            from goal_force_tpu_torch.models.flux_controlnet import flux_controlnet_forward

            cond_lat = self._encode(self._image(controlnet_image)).to(dtype)
            cn_model, cn_cfg = controlnet["model"], controlnet["cfg"]
            # InfiniteYou: the ControlNet takes the projected identity tokens as its
            # prompt, with its own guidance
            cn_prompt, cn_guidance = prompt_emb[:1], guidance
            if id_embeds is not None and infiniteyou is not None:
                from goal_force_tpu_torch.models.flux_adapters import infiniteyou_projector

                cn_prompt = infiniteyou_projector(
                    infiniteyou, torch.as_tensor(np.asarray(id_embeds), device=dev)).to(dtype)
                cn_guidance = torch.full((1,), infiniteyou_guidance, dtype=dtype, device=dev)

            def cn_fn(lat, t):
                return flux_controlnet_forward(cn_model, cn_cfg, lat, cond_lat, t, cn_prompt,
                                               pooled[:1], cn_guidance, mode_id=controlnet_mode,
                                               attn_impl=self.attn_impl)

        step1x_fn = None
        if step1x is not None and step1x_llm_embedding is not None:
            from goal_force_tpu_torch.models.step1x_connector import step1x_connector_forward

            s1_emb = torch.as_tensor(np.asarray(step1x_llm_embedding), device=dev)
            s1_mask = (torch.as_tensor(np.asarray(step1x_mask), device=dev)
                       if step1x_mask is not None
                       else torch.ones(s1_emb.shape[:2], dtype=torch.int32, device=dev))

            def step1x_fn(t):
                # the connector takes timestep / 1000
                return step1x_connector_forward(step1x["model"], step1x["cfg"], s1_emb,
                                                t / 1000.0, s1_mask)

        ip = None
        if ipadapter is not None and ipadapter_image_emb is not None:
            from goal_force_tpu_torch.models.flux_adapters import flux_ip_kwargs

            c = self.dit_cfg
            ip = flux_ip_kwargs(ipadapter, torch.as_tensor(np.asarray(ipadapter_image_emb),
                                                           device=dev).to(dtype),
                                num_heads=c.num_heads, head_dim=c.head_dim,
                                scale=ipadapter_scale, num_joint=c.num_joint_blocks,
                                num_single=c.num_single_blocks)

        kontext = None
        if kontext_image is not None:
            kontext = self._encode(self._image(kontext_image)).to(dtype)

        eligen = None
        if eligen_entity_prompts is not None and eligen_entity_masks is not None:
            if (cn_fn is not None or kontext is not None or step1x is not None
                    or ip is not None or rope_tables_override is not None
                    or flex_condition is not None or tea_cache_thresh > 0):
                raise NotImplementedError("EliGen composes with the base/CFG path only here")
            ent_emb = self._encode_text(list(eligen_entity_prompts))[0][None]  # (1, M, L, D)
            # PIL-NEAREST resize to the latent grid, then binarise
            masks = np.asarray(eligen_entity_masks, np.float32)
            yi = np.minimum(np.floor((np.arange(h) + 0.5) * masks.shape[1] / h).astype(int),
                            masks.shape[1] - 1)
            xi = np.minimum(np.floor((np.arange(w) + 0.5) * masks.shape[2] / w).astype(int),
                            masks.shape[2] - 1)
            masks_lat = torch.as_tensor((masks[:, yi][:, :, xi] > 0.5).astype(np.float32)[None],
                                        device=dev)
            ent_emb_nega = None
            if eligen_enable_on_negative and use_cfg:
                # the negative branch takes the negative prompt for every entity
                ent_emb_nega = prompt_emb[1:2][:, None].expand(-1, ent_emb.shape[1], -1, -1)
            eligen = (ent_emb, masks_lat, ent_emb_nega)

        tc = None
        if tea_cache_thresh > 0:
            from goal_force_tpu_torch.pipelines.teacache import TeaCache

            if cn_fn is not None or kontext is not None or step1x is not None \
                    or ipadapter is not None or rope_tables_override is not None:
                raise ValueError("TeaCache composes only with the base path")
            tc = TeaCache(num_inference_steps, tea_cache_thresh, "FLUX.1-dev")

        rope_override = None if rope_tables_override is None else tuple(rope_tables_override)
        steps = range(len(schedule))
        if progress:
            import tqdm

            steps = tqdm.tqdm(steps)
        for i in steps:
            tstep = torch.full((1,), float(schedule.timesteps[i]), dtype=dtype, device=dev)
            sigma, sigma_next = schedule.sigmas[i], schedule.sigma_next(i)
            if tc is not None:
                t_mod = fd.flux_dit_mod_input(self.dit, self.dit_cfg, latents, tstep, pooled[:1],
                                              guidance)
                if tc.should_skip(t_mod.float().cpu().numpy()) and tc.residual is not None:
                    v = self._teacache_skip(latents, tstep, pooled, guidance, cfg_scale,
                                            use_cfg, tc.residual)
                else:
                    v, x_in, x_out = self._velocity(latents, tstep, prompt_emb, pooled, guidance,
                                                    cfg_scale, use_cfg, return_tokens=True)
                    tc.store(x_in, x_out)
            elif eligen is not None:
                ent_emb, ent_masks, ent_emb_nega = eligen
                v = self._forward(latents, tstep, prompt_emb[:1], pooled[:1], guidance,
                                  entity_prompt_emb=ent_emb, entity_masks=ent_masks)
                if use_cfg:
                    nega = ent_emb_nega is not None
                    v_n = self._forward(latents, tstep, prompt_emb[1:2], pooled[1:2], guidance,
                                        entity_prompt_emb=ent_emb_nega if nega else None,
                                        entity_masks=ent_masks if nega else None)
                    v = v_n + cfg_scale * (v - v_n)
            else:
                cn_res = cn_single_res = None
                if cn_fn is not None:
                    cn_res, cn_single_res = cn_fn(latents, tstep)
                step_prompt, step_pooled = prompt_emb, pooled
                if step1x_fn is not None:
                    s1_tokens, s1_glob = step1x_fn(tstep)
                    reps = prompt_emb.shape[0] // s1_tokens.shape[0]
                    step_prompt = s1_tokens.to(dtype).repeat(reps, 1, 1)
                    step_pooled = s1_glob.to(dtype).repeat(reps, 1)
                model_in = latents
                if flex_condition is not None:
                    # the uncondition below the stop timestep
                    use_cond = float(schedule.timesteps[i]) >= flex_control_stop_timestep
                    flex = flex_condition if use_cond else flex_uncondition
                    model_in = torch.cat([latents, torch.as_tensor(np.asarray(flex), device=dev)
                                          .to(latents.dtype)], dim=-1)
                v = self._velocity(model_in, tstep, step_prompt, step_pooled, guidance,
                                   cfg_scale, use_cfg,
                                   tile_ctx=(tile_size, tile_stride) if tiled else None,
                                   cn_res=cn_res, cn_single_res=cn_single_res, kontext=kontext,
                                   ip=ip, rope_override=rope_override)
            latents = fm.euler_step(latents, v.to(latents.dtype), sigma, sigma_next)
        z = latents.float()
        img = tiled_forward_2d(self._decode, z, tile_size, tile_stride) if tiled \
            else self._decode(z)
        return ((img[0] + 1.0) / 2.0).float().cpu().numpy().clip(0.0, 1.0)

    def _teacache_skip(self, latents, tstep, pooled, guidance, cfg_scale, use_cfg, residual):
        """A skipped step's velocity: the head over the embedded tokens plus the cached
        residual."""
        b = latents.shape[0]
        x2, t2, g2 = latents, tstep, guidance
        if use_cfg:
            x2, t2, g2 = (torch.cat([a, a]) for a in (latents, tstep, guidance))
        temb = fd.time_cond(self.dit, self.dit_cfg, t2, pooled[:x2.shape[0]], g2)
        x_in = linear(self.dit.x_embedder, fd.patchify2d(x2))
        v = fd.flux_dit_head(self.dit, self.dit_cfg, x_in + residual.to(x_in.dtype), temb,
                             latents.shape[1] // 2, latents.shape[2] // 2)
        if use_cfg:
            v = v[b:] + cfg_scale * (v[:b] - v[b:])
        return v
