"""HunyuanVideo text-to-video and HunyuanVideo-I2V pipeline in PyTorch.

Port of ``goal_force_tpu/pipelines/hunyuan_video.py``: the flow-match Euler schedule with shift 7, sigma_min 0 and
extra_one_step, embedded guidance (the DiT's ``guidance_in``), optional true CFG with the
negative prompt as a second row of one merged batch (masks padded to one length),
v2v (``input_video`` + ``denoising_strength``), I2V stability and token replace,
``step_processor``, TeaCache on the positive stream, tiled and
untiled decode, and ``noise=`` (the RNG streams of the two packages differ, so tests pass
JAX's draw in).

The text side is pluggable, as in JAX: ``encode_prompt(prompt) -> (emb (1, L, text_dim),
mask (1, L), pooled (1, 768))``. ``from_pretrained`` builds it from the Llama tower
(hidden states with the last 2 layers skipped, ``models/text_encoders.py``) and the CLIP-L
pooled embedding (``models/sd_text_encoder.py::sd3_text1_encode`` over the vendored CLIP
BPE tokenizer). Without a Llama tokenizer directory the prompt goes through the
sha256-seeded hash ids (``models/tokenizer.py::hash_ids``), as JAX does. With no encoder
at all, ``_embed`` draws a prompt embedding from the prompt's hash ids (JAX's fallback).
A LLaVA checkpoint (HunyuanVideo-I2V's MLLM, ``models/llava.py``) gives
``make_llava_prompt_encoder``: with the request's image, the I2V template runs through
the vision tower and the decoder and ``crop_mllm_hidden_states`` keeps every fourth image
feature and the user's text; without one, the text template runs on the tower's Llama.
Under CFG the I2V row carries more tokens than the negative one, and ``__call__`` pads
both rows to one length (masked positions are inert).

Entry points run on the card unless ``device="cpu"`` is passed; ``__call__`` returns
float32 numpy frames (B, T, H, W, 3) from the decoder (or latents without one).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from goal_force_tpu_torch.models.hunyuan_video_dit import (
    HunyuanVideoDiT,
    HunyuanVideoDiTConfig,
    hunyuan_video_dit_forward,
    hunyuan_video_head,
    hunyuan_video_prelude,
    hunyuan_video_teacache_signal,
    hunyuan_video_trunk,
    init_hunyuan_video_dit,
)
from goal_force_tpu_torch.models.tokenizer import hash_ids
from goal_force_tpu_torch.pipelines.goal_force import resolve_device
from goal_force_tpu_torch.schedulers import flow_match as fm


def _accepts_images(encode_prompt) -> bool:
    """Whether an injected encode_prompt callable takes (prompt, images)."""
    import inspect

    try:
        return len(inspect.signature(encode_prompt).parameters) >= 2
    except (TypeError, ValueError):
        return False


def tiny_hunyuan_config():
    return HunyuanVideoDiTConfig(dim=144, num_double_blocks=2, num_single_blocks=2,
                                 text_dim=32, rope_dims=(2, 2, 2))


def _np(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def vae_codecs(vae, cfg):
    """(encode_video, decode_video) over a VAE encoder, decoder, or {"encoder",
    "decoder"} (None for a missing half), each taking ``tiled``, ``tile_size`` and
    ``tile_stride`` keywords as the pipeline passes them."""
    from goal_force_tpu_torch.models import hunyuan_video_vae as hv

    halves = vae if isinstance(vae, dict) else {
        "encoder" if isinstance(vae, hv.HunyuanVAEEncoder) else "decoder": vae}
    enc, dec = halves.get("encoder"), halves.get("decoder")
    encode_video = decode_video = None
    if dec is not None:
        decode_video = lambda z, **tk: (
            hv.hunyuan_vae_decode_tiled(dec, z, cfg, tk["tile_size"], tk["tile_stride"])
            if tk.get("tiled") else hv.hunyuan_vae_decode(dec, z, cfg))
    if enc is not None:
        encode_video = lambda v, **tk: (
            hv.hunyuan_vae_encode_tiled(enc, v, cfg, tk["tile_size"], tk["tile_stride"])
            if tk.get("tiled") else hv.hunyuan_vae_encode(enc, v, cfg))
    return encode_video, decode_video


@dataclasses.dataclass
class HunyuanVideoPipeline:
    dit: HunyuanVideoDiT
    dit_cfg: HunyuanVideoDiTConfig
    encode_prompt: Optional[Callable] = None   # str -> (emb, mask, pooled)
    decode_video: Optional[Callable] = None    # latents -> (B, T, H, W, 3) frames
    encode_video: Optional[Callable] = None    # (B, T, H, W, 3) in [-1, 1] -> latents
    dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "auto"

    @property
    def device(self) -> torch.device:
        return self.dit.final_layer.linear.weight.device

    @classmethod
    def from_pretrained(
        cls,
        dit_path,
        llama_path=None,                   # Llama text tower (HF names) or LLaVA
        clip_path=None,                    # CLIP-L (diffsynth SD text encoder names)
        vae_decoder_path=None,
        vae_cfg=None,                      # HunyuanVAEConfig
        llama_tokenizer_dir=None,          # ships with the text encoder checkpoint
        clip_tokenizer="vendored",         # hunyuan_video/tokenizer_1
        txt_len: int = 256,
        dtype: torch.dtype = torch.bfloat16,
        llama_num_heads=None,
        clip_num_heads=None,
        device="cuda",
        **infer_kw,                        # num_heads / rope_dims for tiny DiTs
    ) -> "HunyuanVideoPipeline":
        """Load the reference-format files strictly (``io/auto.py::load_model``), every
        model in `dtype` on `device`. The Llama tokenizer is not vendored: pass the text
        encoder's tokenizer directory as `llama_tokenizer_dir`, or the prompt goes
        through the hash ids (an image-conditioned prompt needs the tokenizer). A LLaVA
        file at `llama_path` (HunyuanVideo-I2V's text_encoder_2) routes a request's
        image into the prompt."""
        from goal_force_tpu_torch.io.auto import load_model

        device = resolve_device(device)
        load = lambda path, **kw: load_model(path, dtype=dtype, device=device, **kw)
        dit = load(dit_path, **infer_kw)
        if dit["kind"] != "hunyuan_video_dit":
            raise ValueError(f"{dit_path} detected as {dit['kind']!r}")

        encode_prompt = None
        if llama_path is not None:
            r = load(llama_path, num_heads=llama_num_heads)
            if r["kind"] not in ("llama", "llava"):
                raise ValueError(f"{llama_path} detected as {r['kind']!r}")
            clip = clip_cfg = None
            if clip_path is not None:
                rc = load(clip_path, num_heads=clip_num_heads)
                clip, clip_cfg = rc["model"], rc["config"]
            tok_llama = None
            if llama_tokenizer_dir is not None:
                from goal_force_tpu_torch.prompters import load_text_tokenizer

                tok_llama = load_text_tokenizer(llama_tokenizer_dir, txt_len)
            tok_clip = clip_tokenizer
            if clip_tokenizer == "vendored":
                from goal_force_tpu_torch.prompters import hunyuan_video_clip_tokenizer

                tok_clip = hunyuan_video_clip_tokenizer()
            make = make_llava_prompt_encoder if r["kind"] == "llava" else \
                make_llama_prompt_encoder
            encode_prompt = make(r["model"], r["config"], clip, clip_cfg, txt_len,
                                 tokenize_llama=tok_llama, tokenize_clip=tok_clip)

        decode_video = encode_video = None
        if vae_decoder_path is not None:
            r = load(vae_decoder_path, vae_cfg=vae_cfg)
            encode_video, decode_video = vae_codecs(r["model"], r["config"])

        return cls(dit=dit["model"], dit_cfg=dit["config"], encode_prompt=encode_prompt,
                   decode_video=decode_video, encode_video=encode_video, dtype=dtype)

    @classmethod
    def init_random(cls, seed: int = 0, dit_cfg=None, dtype=torch.float32, device="cuda"):
        """Random DiT weights (``init_hunyuan_video_dit``) drawn from `seed`."""
        device = resolve_device(device)
        dit_cfg = dit_cfg or tiny_hunyuan_config()
        gen = torch.Generator(device).manual_seed(seed)
        return cls(dit=init_hunyuan_video_dit(dit_cfg, gen, dtype, device=device),
                   dit_cfg=dit_cfg, dtype=dtype)

    def _embed(self, prompt: str, seed: int = 0, input_images=None):
        if self.encode_prompt is not None:
            if input_images is not None and _accepts_images(self.encode_prompt):
                return self.encode_prompt(prompt, input_images)
            return self.encode_prompt(prompt)
        cfg = self.dit_cfg
        ids = hash_ids(prompt, 1 << 30, cfg.txt_len)
        rng = np.random.default_rng(abs(int(ids[0])) % (1 << 31))
        emb = rng.normal(size=(1, cfg.txt_len, cfg.text_dim)).astype(np.float32)
        mask = np.zeros((1, cfg.txt_len), np.int32)
        mask[:, :max(1, len(prompt.split()))] = 1
        pooled = rng.normal(size=(1, cfg.pooled_dim)).astype(np.float32)
        dev = self.device
        return (torch.from_numpy(emb).to(dev), torch.from_numpy(mask).to(dev),
                torch.from_numpy(pooled).to(dev))

    # -- one step ----------------------------------------------------------------------

    def _velocity(self, latents, timestep, emb, mask, pooled, guidance, cfg_scale=1.0,
                  image_latents=None, use_cfg=False, token_replace=False):
        """(latents the DiT saw, velocity): rows of emb/mask/pooled are [posi(, nega)],
        merged into one forward; with token_replace the first latent frame is the clean
        image every step."""
        if token_replace:
            latents = torch.cat([image_latents.to(latents.dtype), latents[:, 1:]], dim=1)
        b = latents.shape[0]
        n = 2 if use_cfg else 1
        v = hunyuan_video_dit_forward(
            self.dit, self.dit_cfg, torch.cat([latents] * n), torch.cat([timestep] * n),
            emb, mask, pooled, torch.cat([guidance] * n), attn_impl=self.attn_impl,
            token_replace=token_replace)
        if use_cfg:
            v = v[b:] + cfg_scale * (v[:b] - v[b:])
        return latents, v.to(latents.dtype)

    def _step(self, latents, timestep, sigma, sigma_next, emb, mask, pooled, guidance,
              cfg_scale=1.0, image_latents=None, use_cfg=False, token_replace=False):
        latents, v = self._velocity(latents, timestep, emb, mask, pooled, guidance, cfg_scale,
                                    image_latents, use_cfg, token_replace)
        return fm.euler_step(latents, v, sigma, sigma_next)

    # -- TeaCache (positive stream only): signal, full trunk with residual, skip ---------

    def _prelude(self, latents, timestep, emb, mask, pooled, guidance, token_replace):
        return hunyuan_video_prelude(self.dit, self.dit_cfg, latents, timestep, emb, mask,
                                     pooled, guidance, token_replace=token_replace)

    def _tc_signal(self, pre):
        return hunyuan_video_teacache_signal(self.dit, self.dit_cfg, pre["img"], pre["vec"])

    def _tc_full(self, pre, latents, sigma, sigma_next):
        img = hunyuan_video_trunk(self.dit, self.dit_cfg, pre, attn_impl=self.attn_impl)
        residual = img - pre["img"]
        v = hunyuan_video_head(self.dit, self.dit_cfg, img, pre["vec"], latents.shape)
        return fm.euler_step(latents, v.to(latents.dtype), sigma, sigma_next), residual

    def _tc_skip(self, pre, latents, sigma, sigma_next, residual):
        v = hunyuan_video_head(self.dit, self.dit_cfg, pre["img"] + residual, pre["vec"],
                               latents.shape)
        return fm.euler_step(latents, v.to(latents.dtype), sigma, sigma_next)

    # -- the request -------------------------------------------------------------------

    @torch.no_grad()
    def __call__(
        self,
        prompt: str,
        negative_prompt: str = "",
        cfg_scale: float = 1.0,
        input_video: Optional[np.ndarray] = None,    # (T, H, W, 3) [0, 1]
        input_images: Optional[np.ndarray] = None,   # (H, W, 3) [0, 1] (i2v)
        i2v_stability: bool = True,
        denoising_strength: float = 1.0,
        height: int = 720,
        width: int = 1280,
        num_frames: int = 129,
        num_inference_steps: int = 30,
        embedded_guidance: float = 6.0,
        sigma_shift: Optional[float] = None,
        seed: int = 0,
        tea_cache_l1_thresh: Optional[float] = None,
        tiled: bool = False,
        tile_size=(17, 30, 30),
        tile_stride=(12, 20, 20),
        step_processor: Optional[Callable] = None,
        progress: bool = False,
        noise=None,
    ) -> np.ndarray:
        """Frames (B, T, H, W, 3) when a decoder is present, else latents (1, T, h, w, 16).

        cfg_scale != 1 runs true CFG with negative_prompt as one merged batch.
        input_video + denoising_strength: v2v (encode, add noise, shortened schedule).
        input_images: HunyuanVideo-I2V with a text-only encoder: i2v_stability blends the
        image latents into the initial noise, and each step clamps the first latent frame
        to the image and runs the token-replace forward. step_processor: frames -> frames,
        applied to the rendered x0 every step. tea_cache_l1_thresh: TeaCache on the
        positive stream (without CFG). noise: (1, lt, height/8, width/8, 16) in place of
        the seeded draw."""
        cfg = self.dit_cfg
        dev = self.device
        schedule = fm.make_schedule(
            num_steps=num_inference_steps, shift=7.0 if sigma_shift is None else sigma_shift,
            sigma_min=0.0, extra_one_step=True,
            denoising_strength=denoising_strength if input_video is not None else 1.0)
        use_cfg = cfg_scale != 1.0
        emb, mask, pooled = self._embed(prompt, seed, input_images=input_images)
        if use_cfg:
            emb_n, mask_n, pooled_n = self._embed(negative_prompt, seed)
            length = max(emb.shape[1], emb_n.shape[1])
            pad = lambda e, m: (torch.nn.functional.pad(e, (0, 0, 0, length - e.shape[1])),
                                torch.nn.functional.pad(m, (0, length - m.shape[1])))
            emb, mask = pad(emb, mask)
            emb_n, mask_n = pad(emb_n, mask_n)
            emb = torch.cat([emb, emb_n])
            mask = torch.cat([mask, mask_n])
            pooled = torch.cat([pooled, pooled_n])
        emb, pooled, mask = emb.to(dev, self.dtype), pooled.to(dev, self.dtype), mask.to(dev)
        tk = dict(tiled=tiled, tile_size=tuple(tile_size),
                  tile_stride=tuple(tile_stride)) if tiled else {}

        lt = (num_frames - 1) // 4 + 1
        shape = (1, lt, height // 8, width // 8, cfg.in_channels)
        if noise is None:
            gen = torch.Generator(dev).manual_seed(seed)
            noise = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        noise = (noise if torch.is_tensor(noise) else torch.from_numpy(
            np.array(noise, np.float32))).to(dev, torch.float32)
        if tuple(noise.shape) != shape:
            raise ValueError(f"noise has shape {tuple(noise.shape)}, expected {shape}")
        noise = noise.to(self.dtype)
        image_latents = None
        if input_images is not None:
            if self.encode_video is None:
                raise ValueError("input_images requires encode_video")
            img = torch.as_tensor(np.asarray(input_images, np.float32) * 2.0 - 1.0)
            image_latents = self.encode_video(img.to(dev)[None, None]).to(self.dtype)
        if input_video is not None:
            if self.encode_video is None:
                raise ValueError("input_video requires encode_video")
            vid = torch.as_tensor(np.asarray(input_video, np.float32) * 2.0 - 1.0)
            z = self.encode_video(vid.to(dev)[None], **tk).to(self.dtype)
            latents = fm.add_noise(z, noise, schedule.sigmas[0])
        elif image_latents is not None and i2v_stability:
            t999 = 0.999
            latents = noise * t999 + image_latents.expand(noise.shape).to(noise.dtype) * (1 - t999)
        else:
            latents = noise
        guidance = torch.full((1,), embedded_guidance, dtype=self.dtype, device=dev)
        token_replace = image_latents is not None

        tea = None
        if tea_cache_l1_thresh is not None:
            from goal_force_tpu_torch.pipelines.teacache import TeaCache

            tea = TeaCache(num_inference_steps, tea_cache_l1_thresh, "HunyuanVideo")

        steps = range(len(schedule))
        if progress:
            import tqdm

            steps = tqdm.tqdm(steps)
        for i in steps:
            ts = torch.full((1,), float(schedule.timesteps[i]), dtype=self.dtype, device=dev)
            sigma, sigma_next = schedule.sigmas[i], schedule.sigma_next(i)
            if step_processor is not None:
                # render x0, post-process the frames on the host, and step toward the
                # processed video through its velocity
                if self.decode_video is None or self.encode_video is None:
                    raise ValueError("step_processor requires encode_video and decode_video")
                lat_in, v = self._velocity(latents, ts, emb, mask, pooled, guidance,
                                           float(cfg_scale), image_latents, use_cfg,
                                           token_replace)
                x0 = lat_in - float(sigma) * v
                frames = _np(self.decode_video(x0.float(), **tk))
                frames01 = ((frames[0] + 1.0) / 2.0).clip(0.0, 1.0)
                processed = np.asarray(step_processor(frames01), np.float32)
                target = self.encode_video(torch.as_tensor(processed * 2.0 - 1.0).to(dev)[None],
                                           **tk).to(lat_in.dtype)
                v2 = (lat_in - target) / float(sigma)
                latents = fm.euler_step(lat_in, v2, sigma, sigma_next)
            elif tea is not None and not use_cfg:
                lat_in = latents
                if token_replace:
                    lat_in = torch.cat([image_latents.to(latents.dtype), latents[:, 1:]], dim=1)
                pre = self._prelude(lat_in, ts, emb, mask, pooled, guidance, token_replace)
                if tea.should_skip(_np(self._tc_signal(pre))):
                    latents = self._tc_skip(pre, lat_in, sigma, sigma_next, tea.residual)
                else:
                    latents, tea.residual = self._tc_full(pre, lat_in, sigma, sigma_next)
            else:
                latents = self._step(latents, ts, sigma, sigma_next, emb, mask, pooled,
                                     guidance, float(cfg_scale), image_latents, use_cfg,
                                     token_replace)
        if self.decode_video is not None:
            return _np(self.decode_video(latents, **tk))
        return _np(latents)


# Conditioning templates wrapped around the user prompt before the LLM runs, and the
# token offsets that crop the scaffold back out of the hidden states (checkpoint-defined
# data of the reference prompter, required for parity).
_TPL_IMAGE = (
    "<|start_header_id|>system<|end_header_id|>\n\nDescribe the image by "
    "detailing the color, shape, size, texture, quantity, text, spatial "
    "relationships of the objects and background:<|eot_id|>"
    "<|start_header_id|>user<|end_header_id|>\n\n{}<|eot_id|>")
_TPL_VIDEO = (
    "<|start_header_id|>system<|end_header_id|>\n\nDescribe the video by "
    "detailing the following aspects: "
    "1. The main content and theme of the video."
    "2. The color, shape, size, texture, quantity, text, and spatial "
    "relationships of the objects."
    "3. Actions, events, behaviors temporal relationships, physical movement "
    "changes of the objects."
    "4. background environment, light, style and atmosphere."
    "5. camera angles, movements, and transitions used in the video:<|eot_id|>"
    "<|start_header_id|>user<|end_header_id|>\n\n{}<|eot_id|>")
_TPL_IMAGE_I2V = (
    "<|start_header_id|>system<|end_header_id|>\n\n<image>\nDescribe the "
    "image by detailing the color, shape, size, texture, quantity, text, "
    "spatial relationships of the objects and background:<|eot_id|>"
    "<|start_header_id|>user<|end_header_id|>\n\n{}<|eot_id|>"
    "<|start_header_id|>assistant<|end_header_id|>\n\n")
_TPL_VIDEO_I2V = (
    "<|start_header_id|>system<|end_header_id|>\n\n<image>\nDescribe the "
    "video by detailing the following aspects according to the reference "
    "image: "
    "1. The main content and theme of the video."
    "2. The color, shape, size, texture, quantity, text, and spatial "
    "relationships of the objects."
    "3. Actions, events, behaviors temporal relationships, physical movement "
    "changes of the objects."
    "4. background environment, light, style and atmosphere."
    "5. camera angles, movements, and transitions used in the video:"
    "<|eot_id|>\n\n"
    "<|start_header_id|>user<|end_header_id|>\n\n{}<|eot_id|>"
    "<|start_header_id|>assistant<|end_header_id|>\n\n")

HUNYUAN_PROMPT_TEMPLATES = {
    "image": {"template": _TPL_IMAGE, "crop_start": 36},
    "video": {"template": _TPL_VIDEO, "crop_start": 95},
    "image-i2v": {"template": _TPL_IMAGE_I2V, "crop_start": 36,
                  "image_emb_start": 5, "image_emb_end": 581,
                  "image_emb_len": 576, "double_return_token_id": 271},
    "video-i2v": {"template": _TPL_VIDEO_I2V, "crop_start": 103,
                  "image_emb_start": 5, "image_emb_end": 581,
                  "image_emb_len": 576, "double_return_token_id": 271},
}


def crop_mllm_hidden_states(hidden, input_ids, attention_mask, tpl,
                            image_embed_interleave: int = 4):
    """Reassemble the MLLM output into [image tokens ; prompt tokens].

    `hidden` is the LLaVA decoder output, where the one ``<image>`` placeholder has
    already expanded into `image_emb_len` positions; `input_ids` and `attention_mask` are
    the unexpanded (B, S) arrays. Keeps (a) the projected image features at
    [image_emb_start, image_emb_end), every `image_embed_interleave`-th, and (b) the user
    text after the template's scaffold, without the 4-token assistant header that
    follows the LAST double-return token (id 271) of each row. A prompt truncated to the
    length loses the assistant's double return but keeps the scaffold's, which all lie
    at or before crop_start: a row whose last one lies there anchors the assistant crop
    at the end of the sequence. Returns (emb (B, L, D), mask (B, L) int32)."""
    ids = np.asarray(input_ids)
    mask = np.asarray(attention_mask)
    b, s = ids.shape
    crop = tpl["crop_start"]
    img_len = tpl["image_emb_len"]
    text_start = crop - 1 + img_len
    img_h = hidden[:, tpl["image_emb_start"]:tpl["image_emb_end"]:image_embed_interleave]
    rows_h, rows_m = [], []
    for i in range(b):
        hits = np.nonzero(ids[i] == tpl["double_return_token_id"])[0]
        last = int(hits[-1]) if len(hits) else s
        if last <= crop:
            last = s
        a_start, a_end = last - 1 + img_len - 4, last - 1 + img_len
        rows_h.append(torch.cat([hidden[i, text_start:a_start], hidden[i, a_end:]]))
        rows_m.append(np.concatenate([mask[i, crop:last - 4], mask[i, last:]]))
    text_m = np.stack(rows_m).astype(np.int32)
    m = np.concatenate([np.ones((b, img_h.shape[1]), np.int32), text_m], axis=1)
    return (torch.cat([img_h, torch.stack(rows_h)], dim=1),
            torch.as_tensor(m, device=hidden.device))


def make_llava_prompt_encoder(llava, llava_cfg, clip, clip_cfg, txt_len: int,
                              tokenize_llama=None, tokenize_clip=None,
                              hidden_state_skip_layer: int = 2, data_type: str = "video",
                              image_embed_interleave: int = 4,
                              template: Optional[dict] = None,
                              text_template: Optional[dict] = None):
    """encode(prompt, images=None) -> (emb, mask, pooled) over HunyuanVideo-I2V's LLaVA
    tower (``models/llava.py``), on its device. With `images` (one (H, W, 3) image in
    [0, 1], a PIL image, or a list of them, one per row) the I2V template, whose system
    turn holds ``<image>``, runs through ``llava_encode`` and ``crop_mllm_hidden_states``
    cuts the scaffold out; without, the text template runs on the tower's own Llama
    (``make_llama_prompt_encoder``), as JAX does: the reference's text-only branch binds
    the mask to the pixels and fails."""
    from goal_force_tpu_torch.models.llava import clip_preprocess_image, llava_encode

    text_enc = make_llama_prompt_encoder(
        llava.language_model.model, llava_cfg.text, clip, clip_cfg, txt_len,
        tokenize_llama=tokenize_llama, tokenize_clip=tokenize_clip,
        hidden_state_skip_layer=hidden_state_skip_layer, data_type=data_type,
        template=text_template)
    pooled_fn = make_clip_pooled_encoder(clip, clip_cfg, tokenize_clip)
    tpl = template or HUNYUAN_PROMPT_TEMPLATES[data_type + "-i2v"]
    dev = llava.multi_modal_projector.linear_1.weight.device

    def encode(prompt: str, images=None):
        if images is None:
            return text_enc(prompt)
        if tokenize_llama is None:
            raise ValueError("image-conditioned prompts need a real llama tokenizer "
                             "(pass llama_tokenizer_dir)")
        text = tpl["template"].format(prompt)
        length = txt_len + tpl["crop_start"]
        raw = tokenize_llama.with_length(length)
        ids = np.asarray(raw(text))[None]
        n_real = min(len(raw.encode(text)), length)
        mask = np.zeros((1, length), np.int32)
        mask[:, :n_real] = 1
        if not isinstance(images, (list, tuple)):
            images = [images]
        pixels = torch.from_numpy(np.stack(
            [clip_preprocess_image(im, llava_cfg.vision.image_size) for im in images]))
        hidden = llava_encode(llava, llava_cfg, ids, pixels.to(dev),
                              torch.as_tensor(mask, device=dev),
                              hidden_state_skip_layer=hidden_state_skip_layer)
        emb, m = crop_mllm_hidden_states(hidden, ids, mask, tpl, image_embed_interleave)
        pooled = pooled_fn(prompt)
        if pooled is None:
            pooled = torch.zeros((1, emb.shape[-1]), dtype=emb.dtype, device=dev)
        return emb, m, pooled

    return encode


def make_llama_prompt_encoder(llama, llama_cfg, clip, clip_cfg, txt_len: int,
                              tokenize_llama=None, tokenize_clip=None,
                              hidden_state_skip_layer: int = 2, data_type: str = "video",
                              template: Optional[dict] = None):
    """encode(prompt) -> (emb, mask, pooled) from the Llama tower (skip-2 hidden states)
    and the CLIP pooled embedding, on the towers' device.

    With a real tokenizer the prompt is wrapped in the conditioning template and the
    scaffold prefix is cropped back out of the hidden states; the hash-id fallback skips
    the template (its crop offsets are tokenizer semantics that hash ids do not have)."""
    from goal_force_tpu_torch.models.text_encoders import llama_encode

    pooled_fn = make_clip_pooled_encoder(clip, clip_cfg, tokenize_clip)
    tpl = template or HUNYUAN_PROMPT_TEMPLATES[data_type]
    dev = llama.embed_tokens.weight.device

    def encode(prompt: str):
        if tokenize_llama is not None:
            text = tpl["template"].format(prompt)
            crop = tpl["crop_start"]
            length = txt_len + crop
            raw = tokenize_llama.with_length(length)
            ids = np.asarray(raw(text))[None]
            n_real = min(len(raw.encode(text)), length)
            mask = np.zeros((1, length), np.int32)
            mask[:, :n_real] = 1
        else:
            ids = hash_ids(prompt, llama_cfg.vocab, txt_len)[None]
            crop = 0
            mask = np.asarray(ids > 0, np.int32)
        ids = torch.as_tensor(ids, dtype=torch.long, device=dev)
        mask = torch.as_tensor(mask, device=dev)
        emb = llama_encode(llama, llama_cfg, ids, mask,
                           hidden_state_skip_layer=hidden_state_skip_layer)
        emb, mask = emb[:, crop:], mask[:, crop:]
        pooled = pooled_fn(prompt)
        if pooled is None:
            pooled = torch.zeros((1, emb.shape[-1]), dtype=emb.dtype, device=dev)
        return emb, mask, pooled

    return encode


def make_clip_pooled_encoder(clip, clip_cfg, tokenize_clip=None):
    """prompt -> the pooled CLIP-L embedding of the raw (untemplated) prompt, or None
    without a CLIP tower: ``clip_encode_text`` where the tower has a projection, else the
    plain text model's final-LN argmax-pooled output (``sd3_text1_encode``)."""

    def pooled_fn(prompt: str):
        if clip is None:
            return None
        cids = np.asarray(tokenize_clip(prompt))[None] if tokenize_clip is not None \
            else hash_ids(prompt, clip_cfg.vocab_size, clip_cfg.max_positions)[None]
        cids = torch.as_tensor(cids, dtype=torch.long, device=clip.token_embedding.weight.device)
        if hasattr(clip, "text_projection"):
            from goal_force_tpu_torch.models.clip import clip_encode_text

            return clip_encode_text(clip, clip_cfg, cids)
        from goal_force_tpu_torch.models.sd_text_encoder import sd3_text1_encode

        return sd3_text1_encode(clip, cids, clip_cfg)[0]

    return pooled_fn

