"""Structural model detection: state dict -> model kind (+ the Wan DiT's config).

Port of ``goal_force_tpu/io/detect.py``, whole: ``detect_model_kind`` names the family
of a raw (torch-layout, reference-format) state dict from the keys only that family has
and, where families share keys, from shapes, by the JAX package's rules in its order
(``_detect_zoo`` first), so the port names every kind as JAX does; ``infer_dit_config``
recovers a WanDiTConfig from a Wan DiT's shapes; ``convert_detected`` builds a Wan-family
module through the port's loaders. The state dict's values may be torch tensors or
numpy arrays (only their shapes are read).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional


def _shape(sd: Mapping, k: str):
    return tuple(sd[k].shape)


def _has(sd: Mapping, *keys: str) -> bool:
    return all(k in sd for k in keys)


def detect_model_kind(sd: Mapping) -> str:
    """Name the model family of a raw (torch-layout) state dict.

    Returns one of: goal_force_controlnet, lora, wan_s2v, wan_dit, wan_vae,
    wan_vae38, umt5_xxl, wan_image_encoder, motion_controller, vace,
    sd_civitai (bundled LDM checkpoint), sd_unet (diffsynth format),
    hf_clip, open_clip, image_reward, esrgan, rife — or raises ValueError.
    """
    keys = set(sd.keys())
    zoo = _detect_zoo(sd, keys)
    if zoo is not None:
        return zoo
    if any(k.startswith("pipe.controlnet.") for k in keys):
        return "goal_force_controlnet"          # our/their trained export
    if any(".lora_A." in k or ".lora_B." in k or k.endswith("lora_A.weight")
           or "lora_A.default" in k for k in keys):
        return "lora"
    if _has(sd, "casual_audio_encoder.weights", "cond_encoder.weight"):
        return "wan_s2v"
    if any(k.startswith("vace_blocks.") for k in keys):
        return "vace"
    if _has(sd, "controlnet_patch_embedding.patch_embedding.weight"):
        return "goal_force_controlnet"
    if _has(sd, "patch_embedding.weight", "blocks.0.self_attn.q.weight"):
        return "wan_dit"
    if any(k.startswith("model.diffusion_model.") for k in keys):
        # civitai/LDM SD checkpoint (bundles unet + text encoder + vae)
        return "sd_civitai"
    if _has(sd, "conv_in.weight", "blocks.1.proj_in.weight",
            "time_embedding.0.weight"):
        return "sd_unet"
    if _has(sd, "token_embedding.weight",
            "blocks.0.pos_embedding.embedding.weight"):
        return "umt5_xxl"
    # VAEs: reference files may or may not carry the 'model.' prefix
    for pre in ("", "model."):
        if pre + "encoder.conv1.weight" in keys:
            # 2.1 VAE: conv1 maps 3->96; 3.8 (TI2V-5B) VAE: 12->160 after
            # pixel-space patchify(2) — detect by input channels
            in_ch = _shape(sd, pre + "encoder.conv1.weight")[1]
            return "wan_vae" if in_ch == 3 else "wan_vae38"
    if any(k.startswith(("model.visual.", "visual.transformer.0.")) for k in keys):
        return "wan_image_encoder"
    if _has(sd, "linear.0.weight", "linear.2.weight", "linear.4.weight") \
            and len(keys) <= 8:
        return "motion_controller"
    if any(k.startswith("text_model.embeddings.") for k in keys):
        return "hf_clip"
    if _has(sd, "visual.conv1.weight", "token_embedding.weight"):
        return "open_clip"
    if any(k.startswith("blip.visual_encoder.") for k in keys):
        return "image_reward"
    if any(".rdb1.conv1." in k for k in keys):
        return "esrgan"
    if any(k.startswith(("block0.conv0.", "module.block0.")) for k in keys):
        return "rife"
    raise ValueError(
        f"unrecognized state dict ({len(keys)} keys; sample: "
        f"{sorted(keys)[:5]})")


def _detect_zoo(sd: Mapping, keys: set) -> Optional[str]:
    """Structural signatures for the non-Wan model families (the reference
    covers these via MD5 key-hash entries in diffsynth/configs/model_config.py:
    141-178; here each family is identified by keys only it has). The naming
    matched is the reference module state-dict ("diffsynth") format that the
    per-family converters consume."""
    if any(k.startswith(("controlnet_blocks.", "controlnet_x_embedder."))
           for k in keys) and "single_blocks.0.to_qkv_mlp.weight" in keys:
        return "flux_controlnet"
    if _has(sd, "single_blocks.0.to_qkv_mlp.weight", "x_embedder.weight"):
        return "flux_dit"
    if _has(sd, "double_blocks.0.component_a.to_qkv.weight", "img_in.proj.weight"):
        return "hunyuan_video_dit"
    if _has(sd, "patch_embedder.proj.weight", "t5_pooler.q_proj.weight"):
        return "hunyuan_dit"
    if _has(sd, "pos_embedder.proj.weight", "blocks.0.attn.a_to_qkv.weight"):
        return "sd3_dit"
    if _has(sd, "txt_norm.weight", "transformer_blocks.0.attn.norm_added_q.weight"):
        return "qwen_image_dit"
    if _has(sd, "patchify.proj.weight", "blocks.0.attn1.to_q.weight"):
        return "cog_dit"
    if _has(sd, "pos_embed.proj.weight", "scale_shift_table"):
        return "stepvideo_dit"
    if _has(sd, "llm.embed_tokens.weight", "llm.norm.weight"):
        return "omnigen"
    if _has(sd, "embedding.word_embeddings.weight",
            "encoder.layers.0.self_attention.query_key_value.weight"):
        return "chatglm"
    if any(k.startswith("conditioner.embedders.") for k in keys):
        return "sdxl_civitai"               # bundled SDXL LDM checkpoint
    if _has(sd, "motion_modules.0.norm.weight",
            "motion_modules.0.transformer_blocks.0.norm1.weight"):
        return "sd_motion"                  # AnimateDiff temporal modules
    if _has(sd, "controlnet_blocks.0.x_rms.weight"):
        return "qwen_image_controlnet"
    if _has(sd, "controlnet_blocks.0.weight", "conv_in.weight",
            "time_embedding.0.weight"):
        # 2D SD/SDXL ControlNet (zero-conv heads over the unet encoder)
        return "sdxl_controlnet" if "add_time_embedding.0.weight" in keys \
            else "sd_controlnet"
    if any(k.startswith("ipadapter_modules.") for k in keys) \
            or "ip_adapter" in keys:
        return "ipadapter"
    if any(k.startswith("S.individual_token_refiner.") for k in keys):
        return "step1x_connector"
    if _has(sd, "add_time_embedding.0.weight", "conv_in.weight"):
        # SVD carries learned temporal-mix factors on its blocks; SDXL doesn't
        if any(k.endswith(".mix_factor") for k in keys):
            return "svd_unet"
        return "sdxl_unet"
    if _has(sd, "multi_modal_projector.linear_1.weight") or \
            _has(sd, "model.multi_modal_projector.linear_1.weight"):
        return "llava"          # HunyuanVideo-I2V's LLaVA MLLM prompt tower
    if _has(sd, "model.layers.0.self_attn.q_proj.weight",
            "model.embed_tokens.weight") or \
            _has(sd, "layers.0.self_attn.q_proj.weight", "embed_tokens.weight"):
        # Llama-family decoder (HunyuanVideo text tower) vs Qwen2.5-VL text
        # (Qwen carries q/k/v biases)
        qb = "model.layers.0.self_attn.q_proj.bias" in keys or \
            "layers.0.self_attn.q_proj.bias" in keys
        return "qwen_vl_text" if qb else "llama"
    if any(k.startswith("visual.blocks.") for k in keys) and \
            "visual.merger.ln_q.weight" in keys or \
            _has(sd, "blocks.0.attn.qkv.weight", "patch_embed.proj.weight",
                 "merger.ln_q.weight"):
        return "qwen_vl_vision"
    if _has(sd, "embeddings.word_embeddings.weight",
            "embeddings.token_type_embeddings.weight"):
        return "bert"
    if "word_embeddings_layernorm.weight" in keys or \
            "transformer.word_embeddings_layernorm.weight" in keys:
        # the post-embedding LayerNorm is unique to BLOOM (BeautifulPrompt
        # refiner backbone, reference prompt_refiners.py:6-28)
        return "bloom"
    if _has(sd, "shared.weight", "encoder.layers.0.self_attn.k_proj.weight") \
            or _has(sd, "model.shared.weight",
                    "model.encoder.layers.0.self_attn.k_proj.weight"):
        # MarianMT opus-mt (Translator refiner backbone,
        # reference prompt_refiners.py:31-54)
        return "marian"
    if _has(sd, "tok_embeddings.word_embeddings.weight",
            "transformer.layers.0.attention_norm.weight"):
        return "step1_llm"
    if _has(sd, "encoders.0.attn.to_q.weight", "token_embedding.weight"):
        return "clip_text"      # SD/SDXL CLIP towers (diffsynth naming);
        # final_layer_norm/text_projection presence tells the variants apart
    if _has(sd, "token_embedding.weight", "pos_embedding.embedding.weight",
            "blocks.0.attn.q.weight"):
        return "t5_encoder"     # shared-relative-pos T5 v1.1 (Flux/SD3/Cog)
    if any(k.endswith(".mix_factor") for k in keys) \
            and "conv_in.weight" in keys:
        return "svd_vae"        # temporal-mix decoder (blocks.N.mix_factor)
    if _has(sd, "conv_in.weight", "blocks.0.norm1.weight") and \
            "time_embedding.0.weight" not in keys:
        # plan-format 2D VAE half (diffsynth SDVAEEncoder/Decoder naming,
        # also the SD3/Flux 16-channel heads without quant convs)
        if "quant_conv.weight" in keys:
            return "sd_vae_encoder"
        if "post_quant_conv.weight" in keys:
            return "sd_vae_decoder"
        out_ch = _shape(sd, "conv_out.weight")[0]
        return "sd3_vae_decoder" if out_ch == 3 else "sd3_vae_encoder"
    # --- VAE variants (all keyed encoder./decoder. with family-specific
    # block naming) ---
    if any(".nin_shortcut.conv.weight" in k for k in keys):
        return "stepvideo_vae"
    if any(".conv_shortcut.conv.weight" in k for k in keys):
        return "hunyuan_video_vae"
    if _has(sd, "encoder.conv_in.conv.weight") or _has(sd, "decoder.conv_in.conv.weight"):
        return "qwen_image_vae"
    if any(k.startswith(("encoder.down_blocks.", "decoder.up_blocks.")) for k in keys):
        dims = [len(_shape(sd, k)) for k in keys
                if k.endswith("conv_in.weight") or k.endswith("conv1.weight")]
        if any(d == 5 for d in dims):
            return "cog_vae"
        # SD/SDXL/SD3/Flux 2D VAE (diffusers naming); moments channels tell
        # the head apart but the family is one loader
        return "sd_vae_diffusers"
    return None


def infer_dit_config(sd: Mapping, head_dim: int = 128):
    """WanDiTConfig fields from a WanModel state dict's shapes. `head_dim` is the one
    quantity weights cannot reveal; it is 128 across the Wan family."""
    from goal_force_tpu_torch.configs import WanDiTConfig

    dim, in_dim = _shape(sd, "patch_embedding.weight")[:2]
    num_layers = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("blocks."))
    ffn_dim = _shape(sd, "blocks.0.ffn.0.weight")[0]
    out_dim = _shape(sd, "head.head.weight")[0] // 4  # patch (1,2,2) -> x4
    text_dim = _shape(sd, "text_embedding.0.weight")[1]
    freq_dim = _shape(sd, "time_embedding.0.weight")[1]
    return WanDiTConfig(
        dim=dim, in_dim=in_dim, ffn_dim=ffn_dim, out_dim=out_dim,
        text_dim=text_dim, freq_dim=freq_dim, num_heads=dim // head_dim,
        num_layers=num_layers,
        has_image_input=any(k.startswith("img_emb.") for k in sd))


def convert_detected(sd: Mapping, kind: Optional[str] = None, dtype=None, device="cuda",
                     **cfg_overrides) -> Dict:
    """Detect (or take) the kind and build the Wan-family module through the port's own
    loader, strictly, the config inferred from shapes where JAX infers it. Returns
    {"kind", "config", "model"}. The kinds JAX leaves to their own loaders raise its
    ValueError, naming the port's."""
    import torch

    from goal_force_tpu_torch import configs
    from goal_force_tpu_torch.models import wan_dit
    from goal_force_tpu_torch.pipelines.goal_force import (
        load_state_dict_strict,
        resolve_device,
        vae_state_dict,
    )

    kind = kind or detect_model_kind(sd)
    device = resolve_device(device)
    sd = {k: torch.as_tensor(v) for k, v in sd.items()}
    dtype = dtype or next(v.dtype for v in sd.values() if v.is_floating_point())
    cfg = cfg_overrides.get("config")

    def build(cls, cfg, state, *args, **kw):
        mod = wan_dit.empty_module(cls, cfg, *args, dtype=dtype, device=device, **kw)
        load_state_dict_strict(mod, state, kind)
        return {"kind": kind, "config": cfg, "model": mod.eval().requires_grad_(False)}

    if kind == "wan_dit":
        cfg = cfg or infer_dit_config(sd)
        return build(wan_dit.WanDiT, cfg, sd, **wan_dit.dit_kwargs(sd))
    if kind == "umt5_xxl":
        from goal_force_tpu_torch.models.t5 import T5Encoder

        vocab, dim = _shape(sd, "token_embedding.weight")
        num_layers = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("blocks."))
        ffn = _shape(sd, "blocks.0.ffn.gate.0.weight")[0] \
            if "blocks.0.ffn.gate.0.weight" in sd else None
        cfg = cfg or configs.T5Config(vocab=vocab, dim=dim, dim_attn=dim, num_layers=num_layers,
                                      **({"dim_ffn": ffn} if ffn else {}))
        return build(T5Encoder, cfg, sd)
    if kind == "wan_vae":
        from goal_force_tpu_torch.models.vae import WanVAE

        return build(WanVAE, cfg or configs.VAEConfig(), vae_state_dict(sd))
    if kind == "wan_vae38":
        from goal_force_tpu_torch.models.vae38 import WAN22_VAE38, vae38_from_state_dict

        cfg = cfg or WAN22_VAE38
        return {"kind": kind, "config": cfg,
                "model": vae38_from_state_dict(sd, cfg, dtype, device=device)}
    if kind == "wan_image_encoder":
        from goal_force_tpu_torch.models.image_encoder import VIT_H_14, vit_from_state_dict

        cfg = cfg or VIT_H_14
        return {"kind": kind, "config": cfg,
                "model": vit_from_state_dict(sd, cfg, dtype, device=device)}
    if kind == "motion_controller":
        from goal_force_tpu_torch.models.adapters import motion_controller_from_state_dict

        return {"kind": kind, "config": None,
                "model": motion_controller_from_state_dict(sd, dtype, device=device)}
    raise ValueError(
        f"detected {kind!r}: load it through its dedicated loader "
        "(goal_force_controlnet -> io.safetensors_io.load_goalforce_controlnet, "
        "lora -> lora.lora_from_peft, wan_s2v -> models.s2v.s2v_from_state_dict, vace -> "
        "models.adapters.vace_from_state_dict)")
