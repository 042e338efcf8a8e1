"""Auto-loading: weight file -> detected kind -> inferred config -> module.

Port of the frame of ``goal_force_tpu/io/auto.py``: ``load_weights`` (safetensors file,
glob or list, a torch pickle, or a state dict) and ``load_model``, which detects the kind
(``io/detect.py``), recovers the config from the shapes present (only what weights cannot
reveal, head counts and RoPE axis splits, takes keyword defaults sized for the released
checkpoints) and builds the port's module, loaded strictly: a missing or unexpected key,
or a shape that does not fit, raises. The kinds:

  - ``hunyuan_video_dit`` (``infer_hunyuan_video_config``), ``hunyuan_video_vae`` (the
    encoder half, the decoder half, or both as {"encoder", "decoder"}), ``llama``
    (``infer_llama_config``; keys with or without ``model.``), ``llava``
    (``infer_llava_config``; either key layout, the ``lm_head`` dropped) and ``clip_text``
    (``infer_clip_config``);
  - ``cog_dit`` (``infer_cog_config``), ``cog_vae`` (one half in the reference layout:
    its decoder or its encoder; the config from ``config=`` or ``vae_cfg=``, else the
    released one) and ``t5_encoder`` (T5 v1.1: ``infer_t5_v11_config``);
  - ``stepvideo_dit`` (``infer_stepvideo_config``), ``stepvideo_vae`` (the encoder, the
    decoder or both, in one module; the config from ``config=`` or ``vae_cfg=``, else the
    released one), ``step1_llm`` (Step-1: JAX's config, ``ffn_hidden_size`` read from the
    fused ``w1`` with ``multiple_of=1``) and ``bert`` (``infer_bert_config``; the HF
    position-id buffer and pooler, which the tower never reads, are dropped);
  - ``flux_dit`` (``infer_flux_config``), ``flux_controlnet`` (JAX's config of the
    shapes, or its DiT config from ``dit_cfg=``), the plan-format image VAE halves
    ``sd_vae_encoder`` / ``sd_vae_decoder`` (4 channels, quant convs) and
    ``sd3_vae_encoder`` / ``sd3_vae_decoder`` (the 16-channel SD3 / Flux head; the
    config {"plan": ...} from ``plan=``, else the released plan) and
    ``step1x_connector`` (JAX's config, ``config=`` or the released one; the module
    built from the file's widths and depth);
  - ``sd3_dit`` (``infer_sd3_config``) and ``clip_text`` with SDXL's variants: bigG
    with its projection (the module's projection as wide as the file's) and CLIP-L cut
    without a final LayerNorm;
  - ``qwen_image_dit`` (``infer_qwen_image_config``), ``qwen_vl_text``
    (``infer_qwen_vl_text_config``; keys with or without ``model.``; a whole Qwen2.5-VL
    file's ``visual.*`` and ``lm_head`` keys dropped), ``qwen_image_vae`` (the
    diffusers-style names renamed into ``WanVAE``'s; JAX's config, ``config=`` or
    ``vae_cfg=``, None where neither is given, the module at Wan2.1's geometry then;
    JAX's detection names such a file otherwise, so the caller passes the kind) and
    ``qwen_image_controlnet`` (JAX's config of the shapes); with ``lm_head=True`` the
    ``qwen_vl_text`` module keeps the file's LM head (Nexus-Gen's generation), and q/k/v
    without biases (a Llama-style stack) build a module without them;
  - ``hunyuan_dit`` (``infer_hunyuan_dit_config``) and ``omnigen``
    (``infer_omnigen_config``; the LongRoPE factors, which weights cannot show, as
    keywords);
  - the UNet families: ``sd_unet`` and ``sdxl_unet`` (SDXL's add embedding and Kolors'
    ``text_intermediate_proj`` where the file has them; the config {"plan": ...} from
    ``plan=``, else the released plan), ``sd_controlnet`` and ``sdxl_controlnet`` (the
    same), ``ipadapter`` (config None; a raw diffusers bundle renamed by ``load_weights``)
    and ``chatglm`` (``infer_chatglm_config``; an HF file's ``transformer.`` prefix, rotary
    buffer and LM head dropped). ``sd_civitai``, ``sdxl_civitai`` and
    ``sd_vae_diffusers`` raise JAX's ValueError: their pipelines read them by prefix
    (``pipelines/sd.py::sd_pipeline_from_civitai``);
  - the Wan kinds, through the port's own loaders (``io/detect.py::convert_detected``).

Every other detected kind raises ``NotImplementedError`` naming its ROADMAP item.
``load_model`` returns {"kind", "config", "model"}. A Cog VAE half in the reference layout
is detected here (a 5-D ``conv_in`` and ``blocks.0.conv1``): JAX's detection, which the port
keeps whole, names it a 2D VAE half, and JAX's pipeline reads it through its converters
without detection.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import torch

from goal_force_tpu_torch.io.detect import _shape, convert_detected, detect_model_kind

WAN_KINDS = ("wan_dit", "umt5_xxl", "wan_vae", "wan_vae38", "wan_image_encoder",
             "motion_controller", "goal_force_controlnet", "lora", "wan_s2v", "vace")

# The ROADMAP item that ports each detected kind not ported yet.
ROADMAP_ITEMS = {
    **{k: "M14d (AnimateDiff, SVD)" for k in ("svd_unet", "svd_vae", "sd_motion")},
    **{k: "M14e (the extensions)" for k in (
        "hf_clip", "open_clip", "image_reward", "esrgan", "rife")},
    **{k: "M14f (prompt refiners)" for k in ("bloom", "marian")},
}


def load_weights(path: Union[str, Mapping]) -> Dict[str, torch.Tensor]:
    """A state dict from safetensors (file, glob or list), a ``.pth``/``.pt``/``.bin``/
    ``.ckpt`` pickle, or a mapping (its values as tensors). A raw diffusers IP-Adapter
    bundle ({"ip_adapter": {...}, "image_proj": {...}}) comes back under the reference
    names."""
    from goal_force_tpu_torch.io.safetensors_io import load_safetensors, load_torch_pth

    if isinstance(path, Mapping):
        sd = path
    elif str(path).endswith((".pth", ".pt", ".bin", ".ckpt")):
        sd = load_torch_pth(path)
    else:
        return load_safetensors(path)
    if isinstance(sd.get("ip_adapter"), Mapping):
        from goal_force_tpu_torch.models.ipadapter import flatten_diffusers_bundle

        return flatten_diffusers_bundle(sd)
    return {k: torch.as_tensor(v) for k, v in sd.items()}


def _max_index(sd, prefix: str) -> int:
    idx = [int(k[len(prefix):].split(".")[0]) for k in sd
           if k.startswith(prefix) and k[len(prefix):].split(".")[0].isdigit()]
    return max(idx) + 1 if idx else 0


def _default_axes(head_dim: int):
    """RoPE axis split: (16, 56, 56) at head_dim 128 (the released models); any other
    head size falls back to the (d/4, 3d/8, 3d/8) proportion rounded to even."""
    if head_dim == 128:
        return (16, 56, 56)
    a = max(2, (head_dim // 4) & ~1)
    rest = head_dim - a
    return (a, rest // 2, rest - rest // 2)


def infer_flux_config(sd, num_heads: Optional[int] = None, axes_dim=None):
    from goal_force_tpu_torch.configs import FluxDiTConfig

    dim, in_dim = _shape(sd, "x_embedder.weight")
    heads = num_heads or max(1, dim // 128)
    return FluxDiTConfig(
        dim=dim, num_heads=heads,
        num_joint_blocks=_max_index(sd, "blocks."),
        num_single_blocks=_max_index(sd, "single_blocks."),
        in_dim=in_dim,
        out_dim=_shape(sd, "final_proj_out.weight")[0],
        text_dim=_shape(sd, "context_embedder.weight")[1],
        pooled_dim=_shape(sd, "pooled_text_embedder.0.weight")[1],
        freq_dim=_shape(sd, "time_embedder.timestep_embedder.0.weight")[1],
        axes_dim=tuple(axes_dim) if axes_dim else _default_axes(dim // heads),
        guidance_embed="guidance_embedder.timestep_embedder.0.weight" in sd,
    )


def infer_flux_controlnet_config(sd, dit_cfg=None, num_heads: Optional[int] = None,
                                 axes_dim=None):
    """JAX's FluxControlNetConfig of the shapes: the DiT config from `dit_cfg` or the
    trunk's widths, the extra control channels beyond the patchified latents."""
    from goal_force_tpu_torch.configs import FluxDiTConfig
    from goal_force_tpu_torch.models.flux_controlnet import FluxControlNetConfig

    if dit_cfg is None:
        dim, in_dim = _shape(sd, "x_embedder.weight")
        heads = num_heads or max(1, dim // 128)
        dit_cfg = FluxDiTConfig(
            dim=dim, num_heads=heads, in_dim=in_dim,
            text_dim=_shape(sd, "context_embedder.weight")[1],
            pooled_dim=_shape(sd, "pooled_text_embedder.0.weight")[1],
            freq_dim=_shape(sd, "time_embedder.timestep_embedder.0.weight")[1],
            axes_dim=tuple(axes_dim or _default_axes(dim // heads)),
            guidance_embed="guidance_embedder.timestep_embedder.0.weight" in sd)
    extra = 0
    if "controlnet_x_embedder.weight" in sd:
        extra = max(0, _shape(sd, "controlnet_x_embedder.weight")[1] - dit_cfg.in_dim)
    mode = "controlnet_mode_embedder.weight"
    return FluxControlNetConfig(
        dit=dit_cfg, num_joint_blocks=_max_index(sd, "blocks."),
        num_single_blocks=_max_index(sd, "single_blocks."),
        num_mode=_shape(sd, mode)[0] if mode in sd else 0, additional_input_dim=extra)


def infer_hunyuan_video_config(sd, num_heads: Optional[int] = None, rope_dims=None):
    from goal_force_tpu_torch.models.hunyuan_video_dit import HunyuanVideoDiTConfig

    w = _shape(sd, "img_in.proj.weight")
    dim = w[0]
    heads = num_heads or max(1, dim // 128)
    return HunyuanVideoDiTConfig(
        dim=dim, in_channels=w[1], patch=w[2:],
        num_heads=heads,
        num_double_blocks=_max_index(sd, "double_blocks."),
        num_single_blocks=_max_index(sd, "single_blocks."),
        text_dim=_shape(sd, "txt_in.input_embedder.weight")[1],
        pooled_dim=_shape(sd, "vector_in.0.weight")[1],
        guidance_embed="guidance_in.timestep_embedder.0.weight" in sd,
        freq_dim=_shape(sd, "txt_in.t_embedder.timestep_embedder.0.weight")[1],
        rope_dims=tuple(rope_dims) if rope_dims else _default_axes(dim // heads),
    )


def infer_llama_config(sd, num_heads: Optional[int] = None, prefix: str = ""):
    from goal_force_tpu_torch.models.text_encoders import LlamaConfig

    vocab, hidden = _shape(sd, prefix + "embed_tokens.weight")
    heads = num_heads or max(1, hidden // 128)
    head_dim = hidden // heads
    return LlamaConfig(
        hidden_size=hidden, vocab=vocab, num_heads=heads,
        num_layers=_max_index(sd, prefix + "layers."),
        num_kv_heads=_shape(sd, prefix + "layers.0.self_attn.k_proj.weight")[0] // head_dim,
        intermediate_size=_shape(sd, prefix + "layers.0.mlp.gate_proj.weight")[0],
    )


def infer_llava_config(sd, num_heads: Optional[int] = None,
                       image_token_id: Optional[int] = None):
    """LlavaConfig from the shapes: the vision tower's geometry from its embeddings, the
    Llama core through ``infer_llama_config``."""
    from goal_force_tpu_torch.models.clip import CLIPConfig
    from goal_force_tpu_torch.models.llava import LlavaConfig, llava_layout

    lm, vt, _ = llava_layout(sd)
    vision_dim, _, patch_size, _ = _shape(sd, vt + "vision_model.embeddings.patch_embedding.weight")
    n_pos = _shape(sd, vt + "vision_model.embeddings.position_embedding.weight")[0]
    vision = CLIPConfig(
        image_size=int(round((n_pos - 1) ** 0.5)) * patch_size, patch_size=patch_size,
        vision_dim=vision_dim, vision_heads=max(1, vision_dim // 64),
        vision_layers=_max_index(sd, vt + "vision_model.encoder.layers."),
        hidden_act="quick_gelu")
    extra = {} if image_token_id is None else {"image_token_id": image_token_id}
    return LlavaConfig(text=infer_llama_config(sd, num_heads=num_heads, prefix=lm),
                       vision=vision, **extra)


def infer_cog_config(sd, rope_dim: Optional[int] = None):
    """CogDiTConfig from the shapes. The head count comes from the per-head q norm (JAX
    keeps the default 48, which fits only the released width); rope_dim defaults to JAX's
    guess from the width."""
    from goal_force_tpu_torch.models.cog_dit import CogDiTConfig

    dim = _shape(sd, "patchify.proj.weight")[0]
    return CogDiTConfig(
        dim=dim, num_heads=dim // _shape(sd, "blocks.0.norm_q.weight")[0],
        cond_dim=_shape(sd, "time_embedder.timestep_embedder.0.weight")[0],
        num_blocks=_max_index(sd, "blocks."),
        text_dim=_shape(sd, "context_embedder.weight")[1],
        freq_dim=_shape(sd, "time_embedder.timestep_embedder.0.weight")[1],
        rope_dim=rope_dim if rope_dim else (64 if dim % 48 == 0 else 16),
    )


def infer_t5_v11_config(sd, num_heads: Optional[int] = None):
    from goal_force_tpu_torch.configs import T5Config

    vocab, dim = _shape(sd, "token_embedding.weight")
    dim_attn = _shape(sd, "blocks.0.attn.q.weight")[0]
    gate = "blocks.0.ffn.gate.0.weight"
    return T5Config(
        vocab=vocab, dim=dim, dim_attn=dim_attn,
        dim_ffn=_shape(sd, gate)[0] if gate in sd else _shape(sd, "blocks.0.ffn.fc1.weight")[0],
        num_heads=num_heads or max(1, dim_attn // 64),
        num_layers=_max_index(sd, "blocks."),
        num_buckets=_shape(sd, "pos_embedding.embedding.weight")[0],
        shared_pos=True,
    )


def infer_stepvideo_config(sd):
    """StepVideoConfig from the shapes: heads from the per-head q norm, the rope split
    (hd/2, hd/4, hd/4)."""
    from goal_force_tpu_torch.models.stepvideo_dit import StepVideoConfig

    w = _shape(sd, "pos_embed.proj.weight")
    head_dim = _shape(sd, "transformer_blocks.0.attn1.q_norm.weight")[0]
    return StepVideoConfig(
        num_heads=w[0] // head_dim, head_dim=head_dim,
        num_layers=_max_index(sd, "transformer_blocks."),
        in_channels=w[1],
        caption_dim=_shape(sd, "caption_projection.linear_1.weight")[1],
        clip_dim=_shape(sd, "clip_projection.weight")[1],
        rope_split=(head_dim // 2, head_dim // 4, head_dim // 4),
    )


def infer_bert_config(sd, num_heads: Optional[int] = None, prefix: str = ""):
    from goal_force_tpu_torch.models.text_encoders import BertConfig

    vocab, hidden = _shape(sd, prefix + "embeddings.word_embeddings.weight")
    return BertConfig(
        hidden_size=hidden, vocab=vocab,
        num_heads=num_heads or max(1, hidden // 64),
        num_layers=_max_index(sd, prefix + "encoder.layer."),
        intermediate_size=_shape(sd, prefix + "encoder.layer.0.intermediate.dense.weight")[0],
        max_positions=_shape(sd, prefix + "embeddings.position_embeddings.weight")[0],
        type_vocab=_shape(sd, prefix + "embeddings.token_type_embeddings.weight")[0],
    )


def infer_step1_config(sd, num_heads: Optional[int] = None):
    """JAX's Step1Config of the shapes: heads hidden / 128 unless given, groups from the
    fused wqkv, ``ffn_hidden_size`` the fused w1's rows (twice the FFN's width) with
    ``multiple_of=1``, as JAX reads it (its forward never uses the field)."""
    from goal_force_tpu_torch.models.text_encoders import Step1Config

    vocab, hidden = _shape(sd, "tok_embeddings.word_embeddings.weight")
    heads = num_heads or max(1, hidden // 128)
    qkv_out = _shape(sd, "transformer.layers.0.attention.wqkv.weight")[0]
    return Step1Config(
        hidden_size=hidden, vocab=vocab, num_heads=heads,
        num_groups=(qkv_out - hidden) // (2 * (hidden // heads)),
        num_layers=_max_index(sd, "transformer.layers."),
        ffn_hidden_size=_shape(sd, "transformer.layers.0.feed_forward.w1.weight")[0],
        multiple_of=1,
    )


def infer_qwen_image_config(sd, axes_dim=None):
    from goal_force_tpu_torch.models.qwen_image_dit import QwenImageDiTConfig

    dim, in_dim = _shape(sd, "img_in.weight")
    head_dim = _shape(sd, "transformer_blocks.0.attn.norm_added_q.weight")[0]
    return QwenImageDiTConfig(
        dim=dim, head_dim=head_dim,
        num_heads=_shape(sd, "transformer_blocks.0.attn.to_q.weight")[0] // head_dim,
        num_layers=_max_index(sd, "transformer_blocks."),
        in_dim=in_dim, text_dim=_shape(sd, "txt_in.weight")[1],
        freq_dim=_shape(sd, "time_text_embed.timestep_embedder.linear_1.weight")[1],
        axes_dim=tuple(axes_dim) if axes_dim else _default_axes(head_dim),
    )


def infer_qwen_vl_text_config(sd, num_heads: Optional[int] = None, prefix: str = "model."):
    """QwenVLTextConfig of the shapes: heads hidden / 128 unless given, the M-RoPE
    sections scaled with head_dim ((16, 24, 24) at the released 128)."""
    from goal_force_tpu_torch.models.qwen_vl import QwenVLTextConfig

    vocab, hidden = _shape(sd, prefix + "embed_tokens.weight")
    heads = num_heads or max(1, hidden // 128)
    head_dim = hidden // heads
    a = max(1, head_dim // 8)
    b = (head_dim // 2 - a) // 2
    return QwenVLTextConfig(
        hidden_size=hidden, vocab=vocab, num_heads=heads,
        num_layers=_max_index(sd, prefix + "layers."),
        num_kv_heads=_shape(sd, prefix + "layers.0.self_attn.k_proj.weight")[0] // head_dim,
        intermediate_size=_shape(sd, prefix + "layers.0.mlp.gate_proj.weight")[0],
        mrope_section=(a, b, head_dim // 2 - a - b),
    )


def infer_hunyuan_dit_config(sd, num_heads: Optional[int] = None):
    """HunyuanDiTConfig of the shapes: heads dim / 88 unless given, the up blocks those
    with a skip linear."""
    from goal_force_tpu_torch.models.hunyuan_dit import HunyuanDiTConfig

    dim = _shape(sd, "patch_embedder.proj.weight")[0]
    t5_len = _shape(sd, "t5_pooler.positional_embedding")[0] - 1
    pad = _shape(sd, "text_emb_padding")
    n = _max_index(sd, "blocks.")
    n_up = sum(1 for i in range(n) if f"blocks.{i}.skip_linear.weight" in sd)
    return HunyuanDiTConfig(
        dim=dim, num_heads=num_heads or max(1, dim // 88),
        num_layers_down=n - n_up, num_layers_up=n_up,
        text_dim=pad[1], t5_dim=_shape(sd, "t5_embedder.0.weight")[1],
        text_len=pad[0] - t5_len, t5_len=t5_len,
        mlp_ratio=_shape(sd, "blocks.0.mlp.0.weight")[0] / dim,
    )


def infer_omnigen_config(sd, num_heads: Optional[int] = None, **kw):
    """OmniGenConfig of the shapes: heads hidden / 96 unless given (the released Phi-3:
    3072 / 32); `kw` carries what weights cannot show (the LongRoPE factors and
    windows)."""
    from goal_force_tpu_torch.models.omnigen import OmniGenConfig

    vocab, hidden = _shape(sd, "llm.embed_tokens.weight")
    heads = num_heads or max(1, hidden // 96)
    head_dim = hidden // heads
    qkv_out = _shape(sd, "llm.layers.0.self_attn.qkv_proj.weight")[0]
    xw = _shape(sd, "x_embedder.proj.weight")
    return OmniGenConfig(
        hidden_size=hidden, vocab=vocab,
        num_layers=_max_index(sd, "llm.layers."),
        num_heads=heads,
        num_kv_heads=(qkv_out - hidden) // (2 * head_dim),
        intermediate_size=_shape(sd, "llm.layers.0.mlp.gate_up_proj.weight")[0] // 2,
        in_channels=xw[1], patch_size=xw[2],
        **kw,
    )


def infer_chatglm_config(sd, num_heads: Optional[int] = None):
    from goal_force_tpu_torch.models.kolors_text_encoder import ChatGLMConfig

    vocab, hidden = _shape(sd, "embedding.word_embeddings.weight")
    heads = num_heads or max(1, hidden // 128)
    kv_ch = hidden // heads
    qkv_out = _shape(sd, "encoder.layers.0.self_attention.query_key_value.weight")[0]
    return ChatGLMConfig(
        hidden_size=hidden, vocab=vocab,
        num_layers=_max_index(sd, "encoder.layers."),
        num_heads=heads, kv_channels=kv_ch,
        kv_groups=(qkv_out - hidden) // (2 * kv_ch),
        ffn_hidden_size=_shape(sd, "encoder.layers.0.mlp.dense_h_to_4h.weight")[0] // 2,
    )


def _is_cog_vae(sd) -> bool:
    """A Cog VAE half in the reference layout: 3D ``conv_in`` and ``blocks.0.conv1``."""
    return all(k in sd and len(_shape(sd, k)) == 5
               for k in ("conv_in.weight", "blocks.0.conv1.weight"))


def infer_clip_config(sd, num_heads: Optional[int] = None):
    """CLIPConfig of a CLIP text tower in the reference naming: with a projection (SDXL's
    and SD3's bigG) exact GELU and argmax pooling, else quick GELU (JAX's config; its
    ``proj_dim`` stays the default whatever the projection's width)."""
    from goal_force_tpu_torch.models.clip import CLIPConfig

    vocab, dim = _shape(sd, "token_embedding.weight")
    with_projection = "text_projection.weight" in sd
    return CLIPConfig(
        vocab_size=vocab, text_dim=dim,
        text_heads=num_heads or max(1, dim // 64),
        text_layers=_max_index(sd, "encoders."),
        max_positions=_shape(sd, "position_embeds")[1],
        hidden_act="gelu" if with_projection else "quick_gelu",
        **({"text_pooling": "argmax"} if with_projection else {}),
    )


def infer_sd3_config(sd):
    from goal_force_tpu_torch.models.sd3_dit import SD3DiTConfig

    w = _shape(sd, "pos_embedder.proj.weight")
    n = _max_index(sd, "blocks.")
    return SD3DiTConfig(
        dim=w[0], in_channels=w[1], patch=w[2], num_layers=n,
        num_dual_blocks=sum(1 for i in range(n) if f"blocks.{i}.attn2.a_to_qkv.weight" in sd),
        use_rms_norm="blocks.0.attn.norm_q_a.weight" in sd,
        pos_embed_max_size=_shape(sd, "pos_embedder.pos_embed")[1],
        text_dim=_shape(sd, "context_embedder.weight")[1],
        pooled_dim=_shape(sd, "pooled_text_embedder.0.weight")[1],
        freq_dim=_shape(sd, "time_embedder.timestep_embedder.0.weight")[1],
    )


def _strict(cls, cfg, sd, kind: str, dtype, device):
    from goal_force_tpu_torch.models.wan_dit import empty_module
    from goal_force_tpu_torch.pipelines.goal_force import load_state_dict_strict

    mod = empty_module(cls, cfg, dtype=dtype, device=device)
    load_state_dict_strict(mod, sd, kind)
    return mod.eval().requires_grad_(False)


def load_model(path_or_sd, kind: Optional[str] = None, config=None, dtype=None,
               device="cuda", **infer_kw) -> Dict:
    """Detect, infer and load one weight file (or state dict) into the port's module on
    `device`, in `dtype` (default: the file's floating dtype). Returns {"kind", "config",
    "model"}. `infer_kw` goes to the family's config inference (e.g. num_heads /
    rope_dims for tiny checkpoints, vae_cfg for the HunyuanVideo VAE)."""
    from goal_force_tpu_torch.pipelines.goal_force import resolve_device

    device = resolve_device(device)
    sd = load_weights(path_or_sd)
    kind = kind or ("cog_vae" if _is_cog_vae(sd) else detect_model_kind(sd))
    if dtype is None:
        dtype = next((v.dtype for v in sd.values() if v.is_floating_point()), torch.float32)

    def out(cfg, model):
        return {"kind": kind, "config": cfg, "model": model}

    if kind == "hunyuan_video_dit":
        from goal_force_tpu_torch.models.hunyuan_video_dit import HunyuanVideoDiT

        cfg = config or infer_hunyuan_video_config(sd, **infer_kw)
        return out(cfg, _strict(HunyuanVideoDiT, cfg, sd, kind, dtype, device))
    if kind == "hunyuan_video_vae":
        from goal_force_tpu_torch.models import hunyuan_video_vae as hv

        cfg = config or infer_kw.get("vae_cfg") or hv.HunyuanVAEConfig()
        enc, dec = hv.vae_halves(sd)
        halves = {}
        for name, cls, pre in (("encoder", hv.HunyuanVAEEncoder, ("encoder.", "quant_conv.")),
                               ("decoder", hv.HunyuanVAEDecoder,
                                ("decoder.", "post_quant_conv."))):
            if {"encoder": enc, "decoder": dec}[name]:
                part = {k: v for k, v in sd.items() if k.startswith(pre)}
                halves[name] = _strict(cls, cfg, part, f"{kind} {name}", dtype, device)
        rest = sorted(k for k in sd if not k.startswith(("encoder.", "quant_conv.", "decoder.",
                                                         "post_quant_conv.")))
        if rest:
            raise KeyError(f"{kind}: {len(rest)} unexpected keys {rest[:8]}")
        return out(cfg, halves if len(halves) == 2 else next(iter(halves.values())))
    if kind == "llama":
        from goal_force_tpu_torch.models.text_encoders import LlamaModel

        prefix = "model." if "model.embed_tokens.weight" in sd else ""
        cfg = config or infer_llama_config(sd, prefix=prefix, **infer_kw)
        sd = {k[len(prefix):] if k.startswith(prefix) else k: v for k, v in sd.items()}
        return out(cfg, _strict(LlamaModel, cfg, sd, kind, dtype, device))
    if kind == "llava":
        from goal_force_tpu_torch.models.llava import LlavaModel, llava_state_dict

        cfg = config or infer_llava_config(sd, **infer_kw)
        return out(cfg, _strict(LlavaModel, cfg, llava_state_dict(sd), kind, dtype, device))
    if kind == "cog_dit":
        from goal_force_tpu_torch.models.cog_dit import CogDiT

        cfg = config or infer_cog_config(sd, **infer_kw)
        return out(cfg, _strict(CogDiT, cfg, sd, kind, dtype, device))
    if kind == "cog_vae":
        from goal_force_tpu_torch.models import cog_vae as cv

        cfg = config or infer_kw.get("vae_cfg") or cv.CogVAEConfig()
        cls = cv.CogVAEDecoder if cv.cog_vae_side(sd) == "decoder" else cv.CogVAEEncoder
        return out(cfg, _strict(cls, cfg, sd, kind, dtype, device))
    if kind == "t5_encoder":
        from goal_force_tpu_torch.models.t5 import T5Encoder

        cfg = config or infer_t5_v11_config(sd, **infer_kw)
        return out(cfg, _strict(T5Encoder, cfg, sd, kind, dtype, device))
    if kind == "stepvideo_dit":
        from goal_force_tpu_torch.models.stepvideo_dit import StepVideoDiT

        cfg = config or infer_stepvideo_config(sd)
        return out(cfg, _strict(StepVideoDiT, cfg, sd, kind, dtype, device))
    if kind == "stepvideo_vae":
        import functools

        from goal_force_tpu_torch.models import stepvideo_vae as sv
        from goal_force_tpu_torch.models.hunyuan_video_vae import vae_halves

        cfg = config or infer_kw.get("vae_cfg") or sv.StepVideoVAEConfig()
        enc, dec = vae_halves(sd)
        cls = functools.partial(sv.StepVideoVAE, encoder=enc, decoder=dec)
        return out(cfg, _strict(cls, cfg, sd, kind, dtype, device))
    if kind == "step1_llm":
        import dataclasses

        from goal_force_tpu_torch.models.text_encoders import Step1Model

        cfg = config or infer_step1_config(sd, **infer_kw)
        # the module's FFN width is the file's (half the fused w1's rows), whatever the
        # config's ffn_hidden_size says
        ff = _shape(sd, "transformer.layers.0.feed_forward.w2.weight")[1]
        build = dataclasses.replace(cfg, ffn_hidden_size=ff, multiple_of=1)
        return out(cfg, _strict(Step1Model, build, sd, kind, dtype, device))
    if kind == "bert":
        from goal_force_tpu_torch.models.text_encoders import BERT_UNUSED, BertModel

        cfg = config or infer_bert_config(sd, **infer_kw)
        sd = {k: v for k, v in sd.items() if not k.startswith(BERT_UNUSED)}
        return out(cfg, _strict(BertModel, cfg, sd, kind, dtype, device))
    if kind == "clip_text":
        import functools

        from goal_force_tpu_torch.models.clip import CLIPTextModel

        cfg = config or infer_clip_config(sd, **infer_kw)
        proj = "text_projection.weight" in sd
        cls = functools.partial(CLIPTextModel, projection=proj,
                                final_norm="final_layer_norm.weight" in sd,
                                proj_dim=_shape(sd, "text_projection.weight")[0] if proj
                                else None)
        return out(cfg, _strict(cls, cfg, sd, kind, dtype, device))
    if kind == "sd3_dit":
        from goal_force_tpu_torch.models.sd3_dit import SD3DiT

        cfg = config or infer_sd3_config(sd)
        return out(cfg, _strict(SD3DiT, cfg, sd, kind, dtype, device))
    if kind == "flux_dit":
        from goal_force_tpu_torch.models.flux_dit import FluxDiT

        cfg = config or infer_flux_config(sd, **infer_kw)
        return out(cfg, _strict(FluxDiT, cfg, sd, kind, dtype, device))
    if kind == "flux_controlnet":
        from goal_force_tpu_torch.models.flux_controlnet import FluxControlNet

        cfg = config or infer_flux_controlnet_config(sd, **infer_kw)
        return out(cfg, _strict(FluxControlNet, cfg, sd, kind, dtype, device))
    if kind in ("sd_vae_encoder", "sd_vae_decoder", "sd3_vae_encoder", "sd3_vae_decoder"):
        import functools

        from goal_force_tpu_torch.models import sd_vae as V

        encoder = kind.endswith("encoder")
        plan = tuple(infer_kw.get("plan") or (V.SD_VAE_ENCODER_PLAN if encoder
                                              else V.SD_VAE_DECODER_PLAN))
        sd3 = kind.startswith("sd3")
        cls = functools.partial(V.SDVAEEncoder if encoder else V.SDVAEDecoder,
                                latent_channels=16 if sd3 else 4, quant=not sd3)
        return out({"plan": plan}, _strict(cls, plan, sd, kind, dtype, device))
    if kind == "step1x_connector":
        import dataclasses

        from goal_force_tpu_torch.models.step1x_connector import (
            Step1xConnector,
            Step1xConnectorConfig,
        )

        cfg = config or Step1xConnectorConfig()
        d, d_in = _shape(sd, "S.input_embedder.weight")
        build = dataclasses.replace(
            cfg, in_channels=d_in, hidden_size=d,
            depth=_max_index(sd, "S.individual_token_refiner.blocks."),
            mlp_ratio=_shape(sd, "S.individual_token_refiner.blocks.0.mlp.fc1.weight")[0] / d)
        return out(cfg, _strict(Step1xConnector, build, sd, kind, dtype, device))
    if kind == "qwen_image_dit":
        from goal_force_tpu_torch.models.qwen_image_dit import QwenImageDiT

        cfg = config or infer_qwen_image_config(sd, **infer_kw)
        return out(cfg, _strict(QwenImageDiT, cfg, sd, kind, dtype, device))
    if kind == "qwen_vl_text":
        import functools

        from goal_force_tpu_torch.models.qwen_vl import QwenVLTextModel

        lm_head = infer_kw.pop("lm_head", False) and "lm_head.weight" in sd
        prefix = "model." if "model.embed_tokens.weight" in sd else ""
        cfg = config or infer_qwen_vl_text_config(sd, prefix=prefix, **infer_kw)
        # a whole Qwen2.5-VL file also holds the vision tower (and Nexus-Gen's heads),
        # which the text stack never reads; its LM head (outside the prefix) is kept only
        # with lm_head=True (generation)
        body = {k[len(prefix):]: v for k, v in sd.items()
                if k.startswith(prefix) and "visual." not in k
                and not k.startswith("lm_head.")}
        if lm_head:
            body["lm_head.weight"] = sd["lm_head.weight"]
        cls = functools.partial(QwenVLTextModel, lm_head=lm_head,
                                qkv_bias="layers.0.self_attn.q_proj.bias" in body)
        return out(cfg, _strict(cls, cfg, body, kind, dtype, device))
    if kind == "hunyuan_dit":
        from goal_force_tpu_torch.models.hunyuan_dit import HunyuanDiT

        cfg = config or infer_hunyuan_dit_config(sd, **infer_kw)
        return out(cfg, _strict(HunyuanDiT, cfg, sd, kind, dtype, device))
    if kind == "omnigen":
        from goal_force_tpu_torch.models.omnigen import OmniGen

        cfg = config or infer_omnigen_config(sd, **infer_kw)
        return out(cfg, _strict(OmniGen, cfg, sd, kind, dtype, device))
    if kind == "qwen_image_vae":
        from goal_force_tpu_torch.models import qwen_image_vae as qiv
        from goal_force_tpu_torch.models.vae import WanVAE

        cfg = config or infer_kw.get("vae_cfg")
        return out(cfg, _strict(WanVAE, cfg or qiv.QWEN_IMAGE_VAE_CONFIG,
                                qiv.qwen_image_vae_state_dict(sd), kind, dtype, device))
    if kind == "qwen_image_controlnet":
        import dataclasses

        from goal_force_tpu_torch.models import qwen_image_controlnet as qcn

        cfg = config or qcn.QwenImageControlNetConfig(
            dim=_shape(sd, "controlnet_blocks.0.input_proj.weight")[1],
            num_layers=_max_index(sd, "controlnet_blocks."))
        # the module takes the file's img_in width, whatever the config's split says
        build = dataclasses.replace(cfg, additional_in_dim=_shape(sd, "img_in.weight")[1]
                                    - cfg.in_dim)
        return out(cfg, _strict(qcn.QwenImageControlNet, build, sd, kind, dtype, device))
    if kind == "qwen_vl_vision":
        raise NotImplementedError(
            f"{kind}: load_model has no branch for the vision tower (as in JAX); "
            "QwenImagePipeline.from_pretrained(load_vision=True) reads it from the "
            "Qwen2.5-VL file")
    if kind == "chatglm":
        from goal_force_tpu_torch.models.kolors_text_encoder import ChatGLMModel, chatglm_state_dict

        sd = chatglm_state_dict(sd)
        cfg = config or infer_chatglm_config(sd, **infer_kw)
        return out(cfg, _strict(ChatGLMModel, cfg, sd, kind, dtype, device))
    if kind in ("sd_unet", "sdxl_unet"):
        from goal_force_tpu_torch.models.sd_unet import SD15_PLAN, unet_from_state_dict
        from goal_force_tpu_torch.models.sdxl_unet import SDXL_PLAN

        plan = tuple(infer_kw.get("plan") or (SD15_PLAN if kind == "sd_unet" else SDXL_PLAN))
        return out({"plan": plan}, unet_from_state_dict(sd, plan, kind, dtype, device))
    if kind in ("sd_controlnet", "sdxl_controlnet"):
        from goal_force_tpu_torch.models import sd_controlnet as scn

        sd_kind = kind == "sd_controlnet"
        plan = tuple(infer_kw.get("plan") or (scn.SD_CONTROLNET_PLAN if sd_kind
                                              else scn.SDXL_CONTROLNET_PLAN))
        load = scn.sd_controlnet_from_state_dict if sd_kind else scn.sdxl_controlnet_from_state_dict
        return out({"plan": plan}, load(sd, plan, dtype=dtype, device=device))
    if kind == "ipadapter":
        from goal_force_tpu_torch.models.ipadapter import ipadapter_from_state_dict

        return out(None, ipadapter_from_state_dict(sd, dtype=dtype, device=device))
    if kind in WAN_KINDS or kind in ("sd_civitai", "sdxl_civitai", "sd_vae_diffusers"):
        # the last three raise as in JAX: they are read by their pipelines, not here
        return convert_detected(sd, kind=kind, dtype=dtype, device=device,
                                **({"config": config} if config else {}))
    raise NotImplementedError(
        f"detected {kind!r}: not ported yet (ROADMAP {ROADMAP_ITEMS.get(kind, 'M14')})")
