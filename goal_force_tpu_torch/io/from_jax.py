"""The JAX package's parameter tree (as numpy arrays) -> the port's state dicts.

``params_from_jax(tree)`` takes ``{dit, dit2, controlnet, controlnet2, t5, vae}`` (and
the adapters ``vace``, ``motion_controller``, ``camera_adapter`` where present) as
``GoalForcePipeline.init_random(...).params`` holds it in the JAX package (after
``tree_map(np.asarray, ...)``), an S2V pipeline's ``{s2v, t5, vae}``, and trees named
``vae38`` and ``image_encoder``, and returns one reference-format state dict per entry:

  - stacked ``blocks`` leaves (leading layer axis) -> ``blocks.{i}.*``;
  - (in, out) linear weights -> torch's (out, in);
  - (C*pf*ph*pw, D) patch embeddings -> Conv3d (D, C, pf, ph, pw), feature order (c, dy, dx);
  - (kt, kh, kw, Cin, Cout) conv weights -> (Cout, Cin, kt, kh, kw), (kh, kw, Cin, Cout) ->
    (Cout, Cin, kh, kw);
  - stacked zero convs (L, in, out) -> ``controlnet_zero_convs_after.{i}`` Conv1d (out, in, 1);
  - an I2V DiT's image branch: ``img_emb`` -> ``img_emb.proj.{0,1,3,4}`` (+ ``emb_pos``
    (1, T, clip_dim)) and each block's ``k_img``/``v_img``/``norm_k_img``;
  - ``vae38`` (the Wan2.2 VAE) -> ``encoder.downsamples.{i}.downsamples.{j}`` and
    ``decoder.upsamples.{i}.upsamples.{j}`` (residual blocks, then the stage's
    ``resample.1``/``time_conv``), as ``vae38_params_from_torch`` reads them;
  - ``image_encoder`` (the CLIP ViT-H/14 vision tower) -> ``model.visual.*``;
  - ``s2v`` (speech-to-video) -> the WanS2V keys of ``s2v_params_from_torch``, the
    causal conv1d kernels (k, in, out) -> (out, in, k) under ``*.conv``, the frame packer's
    patch matmuls -> Conv3d kernels of (1, 2, 2), (2, 4, 4) and (4, 8, 8);
  - the adapters: a DiT's Fun-Reference ``ref_conv`` -> Conv2d (D, z, 2, 2); ``vace`` ->
    ``vace_blocks.{i}`` (+ ``before_proj`` on block 0, ``after_proj`` on each) and
    ``vace_patch_embedding``; ``motion_controller`` -> ``linear.0/2/4``;
    ``camera_adapter`` (SimpleAdapter) -> ``conv`` and ``residual_blocks.{i}.conv1/2``;
  - int8 / fp8 packs ``{"w_i8"|"w_f8", "w_scale", "b"}`` (``quantize_linear_tree[_fp8]``)
    -> ``weight`` codes (out, in), ``weight_scale`` (out,) and ``bias``, the state dict
    of ``ops/quant.py``'s ``Int8Linear`` / ``Fp8Linear``; the codes are carried, not
    re-quantized;
  - the HunyuanVideo path's trees, as JAX's converters build them from reference files:
    ``hunyuan_video_dit`` (stacked double/single/refiner blocks, the (C*1*2*2, D) patch
    matmul -> Conv3d), ``llama`` (HF LlamaModel keys, the final norm as ones),
    ``clip_text`` (the SD text encoder's ``encoders.{i}``), ``hunyuan_vae_encoder`` and
    ``hunyuan_vae_decoder`` (``*.conv`` under each causal conv, the 1x1x1
    ``quant_conv``/``post_quant_conv``);
  - ``llava`` (the HF CLIP vision names under ``vision_tower.vision_model.``, the
    projector, ``language_model.model.*`` with the final norm), ``cog_dit``,
    ``cog_vae_encoder`` / ``cog_vae_decoder`` (a resample's (kh, kw, C, C) conv ->
    ``blocks.{i}.conv``) and ``t5_v1_1`` (the one shared ``pos_embedding``);
  - SD3's and Qwen-Image's trees (in ``FLUX_CONVERTERS`` too): ``sd3_dit`` (dual, plain
    and final blocks renumbered in order), ``qwen_image_dit``, ``qwen_image_controlnet``,
    ``qwen_vl_text`` (with its ``lm_head`` where the tree has one) and ``qwen_vl_vision``
    (HF names without the ``model.`` / ``visual.`` prefixes) and ``qwen_image_vae`` (the
    Wan layout, as ``vae``); a ``clip_text`` tree without ``ln_final`` (SDXL's first
    tower) gives no final norm;
  - Nexus-Gen's ``nexus_gen_heads``, ``nexus_gen_adapter`` and ``nexus_gen_merger``,
    ``hunyuan_dit`` (stacked ``down_blocks`` then ``up_blocks`` -> ``blocks.{i}``) and
    ``omnigen`` (``llm.layers.{i}``, the patch matmuls -> Conv2d) (in
    ``FLUX_CONVERTERS`` too);
  - the Flux path's trees (``FLUX_CONVERTERS``): ``flux_dit`` and ``flux_controlnet``
    (stacked joint / single blocks -> ``blocks.{i}`` / ``single_blocks.{i}``, the fused
    projections as they are), the SD / SD3 VAE halves (``sd_vae_encoder``, ...: HWIO
    convs, the mid attention's linears), ``step1x_connector``, ``infiniteyou``,
    ``value_encoder``, ``flux_lora_encoder`` and ``flux_ipadapter``.

``lora_from_jax(tree)`` carries a JAX LoRA adapter tree (``goal_force_tpu/lora.py``,
``{target: {"a": (L, in, r), "b": (L, r, out)}}``) into the port's ``lora.py``, whose
tree has the same layout.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a))


def _codes(a) -> torch.Tensor:
    """(in, out) int8 or float8_e4m3fn codes -> (out, in) tensor of the same dtype
    (torch does not read numpy's float8 arrays: they cross as their bytes)."""
    a = np.ascontiguousarray(np.asarray(a).T)
    if a.dtype == np.int8:
        return torch.from_numpy(a)
    return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)


def _lin(sd: StateDict, prefix: str, p: Mapping, bias: bool = True) -> None:
    if "w_i8" in p or "w_f8" in p:
        sd[prefix + ".weight"] = _codes(p["w_i8"] if "w_i8" in p else p["w_f8"])
        sd[prefix + ".weight_scale"] = _t(p["w_scale"])
    else:
        sd[prefix + ".weight"] = _t(np.asarray(p["w"]).T)
    if bias:
        sd[prefix + ".bias"] = _t(p["b"])


def _patch(w, b, patch_size: Tuple[int, int, int]):
    w = np.asarray(w)
    d = w.shape[1]
    c = w.shape[0] // int(np.prod(patch_size))
    return _t(w.T.reshape(d, c, *patch_size)), _t(b)


def _layer(tree, i: int):
    return {k: (_layer(v, i) if isinstance(v, Mapping) else np.asarray(v)[i])
            for k, v in tree.items()}


def _attention(sd: StateDict, prefix: str, a: Mapping) -> None:
    for proj in ("q", "k", "v", "o", "k_img", "v_img"):
        if proj in a:
            _lin(sd, f"{prefix}.{proj}", a[proj])
    for norm in ("norm_q", "norm_k", "norm_k_img"):
        if norm in a:
            sd[f"{prefix}.{norm}.weight"] = _t(a[norm]["w"])


def _block(sd: StateDict, prefix: str, p: Mapping) -> None:
    for name in ("self_attn", "cross_attn"):
        _attention(sd, f"{prefix}.{name}", p[name])
    sd[f"{prefix}.norm3.weight"] = _t(p["norm3"]["w"])
    sd[f"{prefix}.norm3.bias"] = _t(p["norm3"]["b"])
    _lin(sd, f"{prefix}.ffn.0", p["ffn"]["fc0"])
    _lin(sd, f"{prefix}.ffn.2", p["ffn"]["fc2"])
    sd[f"{prefix}.modulation"] = _t(np.asarray(p["modulation"])[None])


def _num_layers(blocks: Mapping) -> int:
    return int(np.asarray(blocks["modulation"]).shape[0])


def dit_state_dict(p: Mapping, patch_size=(1, 2, 2)) -> StateDict:
    sd: StateDict = {}
    sd["patch_embedding.weight"], sd["patch_embedding.bias"] = _patch(
        p["patch_embedding"]["w"], p["patch_embedding"]["b"], patch_size)
    _lin(sd, "text_embedding.0", p["text_embedding"]["fc0"])
    _lin(sd, "text_embedding.2", p["text_embedding"]["fc2"])
    _lin(sd, "time_embedding.0", p["time_embedding"]["fc0"])
    _lin(sd, "time_embedding.2", p["time_embedding"]["fc2"])
    _lin(sd, "time_projection.1", p["time_projection"])
    for i in range(_num_layers(p["blocks"])):
        _block(sd, f"blocks.{i}", _layer(p["blocks"], i))
    _lin(sd, "head.head", p["head"])
    sd["head.modulation"] = _t(np.asarray(p["head"]["modulation"])[None])
    if "ref_conv" in p:   # (z*4, D), features (c, dy, dx) -> Conv2d (D, z, 2, 2)
        w = np.asarray(p["ref_conv"]["w"])
        sd["ref_conv.weight"] = _t(w.T.reshape(w.shape[1], -1, 2, 2))
        sd["ref_conv.bias"] = _t(p["ref_conv"]["b"])
    if "img_emb" in p:
        e = p["img_emb"]
        for i, name in ((0, "norm_in"), (4, "norm_out")):
            sd[f"img_emb.proj.{i}.weight"] = _t(e[name]["w"])
            sd[f"img_emb.proj.{i}.bias"] = _t(e[name]["b"])
        _lin(sd, "img_emb.proj.1", e["fc0"])
        _lin(sd, "img_emb.proj.3", e["fc2"])
        if "emb_pos" in e:
            sd["img_emb.emb_pos"] = _t(np.asarray(e["emb_pos"])[None])
    return sd


def vace_state_dict(p: Mapping, patch_size=(1, 2, 2)) -> StateDict:
    sd: StateDict = {}
    sd["vace_patch_embedding.weight"], sd["vace_patch_embedding.bias"] = _patch(
        p["patch_embedding"]["w"], p["patch_embedding"]["b"], patch_size)
    _lin(sd, "vace_blocks.0.before_proj", p["before_proj"])
    aw, ab = np.asarray(p["after_proj"]["w"]), np.asarray(p["after_proj"]["b"])
    for i in range(_num_layers(p["blocks"])):
        _block(sd, f"vace_blocks.{i}", _layer(p["blocks"], i))
        _lin(sd, f"vace_blocks.{i}.after_proj", {"w": aw[i], "b": ab[i]})
    return sd


def motion_controller_state_dict(p: Mapping) -> StateDict:
    sd: StateDict = {}
    for i, name in ((0, "fc0"), (2, "fc1"), (4, "fc2")):
        _lin(sd, f"linear.{i}", p[name])
    return sd


def camera_adapter_state_dict(p: Mapping) -> StateDict:
    """SimpleAdapter: conv and residual_blocks.{i}.conv1/conv2, (kh, kw, Cin, Cout)
    kernels -> (Cout, Cin, kh, kw)."""
    sd: StateDict = {}
    _conv2d(sd, "conv", p["conv"])
    for i, blk in enumerate(p["res_blocks"]):
        _conv2d(sd, f"residual_blocks.{i}.conv1", blk["conv1"])
        _conv2d(sd, f"residual_blocks.{i}.conv2", blk["conv2"])
    return sd


def controlnet_state_dict(p: Mapping, patch_size=(1, 2, 2)) -> StateDict:
    sd: StateDict = {}
    pre = "controlnet_patch_embedding.patch_embedding"
    sd[pre + ".weight"], sd[pre + ".bias"] = _patch(
        p["patch_embedding"]["w"], p["patch_embedding"]["b"], patch_size)
    zw, zb = np.asarray(p["zero_convs"]["w"]), np.asarray(p["zero_convs"]["b"])
    for i in range(_num_layers(p["blocks"])):
        _block(sd, f"controlnet_dit.blocks.{i}", _layer(p["blocks"], i))
        sd[f"controlnet_zero_convs_after.{i}.weight"] = _t(zw[i].T[:, :, None])
        sd[f"controlnet_zero_convs_after.{i}.bias"] = _t(zb[i])
    return sd


def t5_state_dict(p: Mapping, shared_pos: bool = False) -> StateDict:
    """umt5's tree, or with `shared_pos` T5 v1.1's, whose one relative-position table is
    layer 0's (the other layers' tables are unused)."""
    sd: StateDict = {"token_embedding.weight": _t(p["token_embedding"]),
                     "norm.weight": _t(p["norm"]["w"])}
    blocks = p["blocks"]
    if shared_pos:
        sd["pos_embedding.embedding.weight"] = _t(np.asarray(blocks["pos_embedding"])[0])
    for i in range(int(np.asarray(blocks["norm1"]["w"]).shape[0])):
        b, pre = _layer(blocks, i), f"blocks.{i}"
        sd[f"{pre}.norm1.weight"] = _t(b["norm1"]["w"])
        sd[f"{pre}.norm2.weight"] = _t(b["norm2"]["w"])
        for proj in ("q", "k", "v", "o"):
            _lin(sd, f"{pre}.attn.{proj}", b["attn"][proj], bias=False)
        _lin(sd, f"{pre}.ffn.gate.0", b["ffn"]["gate"], bias=False)
        _lin(sd, f"{pre}.ffn.fc1", b["ffn"]["fc1"], bias=False)
        _lin(sd, f"{pre}.ffn.fc2", b["ffn"]["fc2"], bias=False)
        if not shared_pos:
            sd[f"{pre}.pos_embedding.embedding.weight"] = _t(b["pos_embedding"])
    return sd


def _conv3d(sd: StateDict, prefix: str, p: Mapping) -> None:
    sd[prefix + ".weight"] = _t(np.asarray(p["w"]).transpose(4, 3, 0, 1, 2))
    sd[prefix + ".bias"] = _t(p["b"])


def _conv2d(sd: StateDict, prefix: str, p: Mapping) -> None:
    sd[prefix + ".weight"] = _t(np.asarray(p["w"]).transpose(3, 2, 0, 1))
    sd[prefix + ".bias"] = _t(p["b"])


def _norm(sd: StateDict, prefix: str, p: Mapping, images: bool = False) -> None:
    g = np.asarray(p["gamma"])
    sd[prefix + ".gamma"] = _t(g.reshape((-1, 1, 1) if images else (-1, 1, 1, 1)))


def _res(sd: StateDict, prefix: str, p: Mapping) -> None:
    _norm(sd, prefix + ".residual.0", p["norm1"])
    _conv3d(sd, prefix + ".residual.2", p["conv1"])
    _norm(sd, prefix + ".residual.3", p["norm2"])
    _conv3d(sd, prefix + ".residual.6", p["conv2"])
    if "shortcut" in p:
        _conv3d(sd, prefix + ".shortcut", p["shortcut"])


def _attn(sd: StateDict, prefix: str, p: Mapping) -> None:
    _norm(sd, prefix + ".norm", p["norm"], images=True)
    _conv2d(sd, prefix + ".to_qkv", p["to_qkv"])
    _conv2d(sd, prefix + ".proj", p["proj"])


def _plan(sd: StateDict, prefix: str, mods) -> None:
    for i, p in enumerate(mods):
        if "norm1" in p:
            _res(sd, f"{prefix}.{i}", p)
        else:
            _conv2d(sd, f"{prefix}.{i}.resample.1", p["conv"])
            if "time_conv" in p:
                _conv3d(sd, f"{prefix}.{i}.time_conv", p["time_conv"])


def vae_state_dict(p: Mapping) -> StateDict:
    sd: StateDict = {}
    for side, key in (("encoder", "down"), ("decoder", "up")):
        q = p[side]
        _conv3d(sd, f"{side}.conv1", q["conv1"])
        _plan(sd, f"{side}.{'downsamples' if key == 'down' else 'upsamples'}", q[key])
        _res(sd, f"{side}.middle.0", q["mid_res1"])
        _attn(sd, f"{side}.middle.1", q["mid_attn"])
        _res(sd, f"{side}.middle.2", q["mid_res2"])
        _norm(sd, f"{side}.head.0", q["head_norm"])
        _conv3d(sd, f"{side}.head.2", q["head_conv"])
    _conv3d(sd, "conv1", p["conv1"])
    _conv3d(sd, "conv2", p["conv2"])
    return sd


def _vae38_side(sd: StateDict, side: str, q: Mapping) -> None:
    seq = "downsamples" if side == "encoder" else "upsamples"
    _conv3d(sd, f"{side}.conv1", q["conv1"])
    for i, stage in enumerate(q["stages"]):
        pre = f"{side}.{seq}.{i}.{seq}"
        for j, res in enumerate(stage["res"]):
            _res(sd, f"{pre}.{j}", res)
        if "resample" in stage:
            rs, j = stage["resample"], len(stage["res"])
            _conv2d(sd, f"{pre}.{j}.resample.1", rs["conv"])
            if "time_conv" in rs:
                _conv3d(sd, f"{pre}.{j}.time_conv", rs["time_conv"])
    _res(sd, f"{side}.middle.0", q["mid_res1"])
    _attn(sd, f"{side}.middle.1", q["mid_attn"])
    _res(sd, f"{side}.middle.2", q["mid_res2"])
    _norm(sd, f"{side}.head.0", q["head_norm"])
    _conv3d(sd, f"{side}.head.2", q["head_conv"])


def vae38_state_dict(p: Mapping) -> StateDict:
    """JAX ``init_vae38`` / ``vae38_params_from_torch`` tree -> the Wan2.2 VAE's keys."""
    sd: StateDict = {}
    _vae38_side(sd, "encoder", p["encoder"])
    _vae38_side(sd, "decoder", p["decoder"])
    _conv3d(sd, "conv1", p["conv1"])
    _conv3d(sd, "conv2", p["conv2"])
    return sd


def vit_state_dict(p: Mapping, prefix: str = "model.visual.") -> StateDict:
    """JAX ``init_vit`` / ``vit_params_from_torch`` tree -> the vision tower's keys."""
    sd: StateDict = {}
    w = np.asarray(p["patch_embedding"]["w"])                 # (3 p p, dim), (c, dy, dx)
    ps = int(round((w.shape[0] // 3) ** 0.5))
    sd[prefix + "patch_embedding.weight"] = _t(w.T.reshape(w.shape[1], 3, ps, ps))
    sd[prefix + "cls_embedding"] = _t(np.asarray(p["cls_embedding"])[None])
    sd[prefix + "pos_embedding"] = _t(np.asarray(p["pos_embedding"])[None])
    for name in ("weight", "bias"):
        sd[prefix + "pre_norm." + name] = _t(p["pre_norm"]["w" if name == "weight" else "b"])
    blocks = p["blocks"]
    for i in range(int(np.asarray(blocks["norm1"]["w"]).shape[0])):
        b, pre = _layer(blocks, i), f"{prefix}transformer.{i}"
        for norm in ("norm1", "norm2"):
            sd[f"{pre}.{norm}.weight"] = _t(b[norm]["w"])
            sd[f"{pre}.{norm}.bias"] = _t(b[norm]["b"])
        _lin(sd, f"{pre}.attn.to_qkv", b["attn"]["to_qkv"])
        _lin(sd, f"{pre}.attn.proj", b["attn"]["proj"])
        _lin(sd, f"{pre}.mlp.0", b["mlp_fc1"])
        _lin(sd, f"{pre}.mlp.2", b["mlp_fc2"])
    return sd


def _conv1d(sd: StateDict, prefix: str, p: Mapping) -> None:
    sd[prefix + ".conv.weight"] = _t(np.asarray(p["w"]).transpose(2, 1, 0))
    sd[prefix + ".conv.bias"] = _t(p["b"])


def s2v_state_dict(p: Mapping, patch_size=(1, 2, 2)) -> StateDict:
    """JAX ``s2v_params_from_torch`` tree -> the WanS2V keys it reads."""
    sd: StateDict = {}
    for name in ("patch_embedding", "cond_encoder"):
        sd[name + ".weight"], sd[name + ".bias"] = _patch(p[name]["w"], p[name]["b"],
                                                          patch_size)
    _lin(sd, "text_embedding.0", p["text_embedding"]["fc0"])
    _lin(sd, "text_embedding.2", p["text_embedding"]["fc2"])
    _lin(sd, "time_embedding.0", p["time_embedding"]["fc0"])
    _lin(sd, "time_embedding.2", p["time_embedding"]["fc2"])
    _lin(sd, "time_projection.1", p["time_projection"])
    for i in range(_num_layers(p["blocks"])):
        _block(sd, f"blocks.{i}", _layer(p["blocks"], i))
    _lin(sd, "head.head", p["head"])
    sd["head.modulation"] = _t(np.asarray(p["head"]["modulation"])[None])
    sd["trainable_cond_mask.weight"] = _t(p["trainable_cond_mask"])
    enc, pre = p["audio_encoder"], "casual_audio_encoder"
    sd[pre + ".weights"] = _t(enc["weights"])
    for name in ("conv1_local", "conv2", "conv3", "conv1_global"):
        if name in enc["encoder"]:
            _conv1d(sd, f"{pre}.encoder.{name}", enc["encoder"][name])
    if "final_linear" in enc["encoder"]:
        _lin(sd, pre + ".encoder.final_linear", enc["encoder"]["final_linear"])
    sd[pre + ".encoder.padding_tokens"] = _t(np.asarray(enc["encoder"]["padding_tokens"])
                                             [None, None])
    inj = p["audio_injector"]
    for k in range(int(np.asarray(inj["adain"]["linear"]["w"]).shape[0])):
        layer = _layer(inj, k)
        _attention(sd, f"audio_injector.injector.{k}", layer["injector"])
        _lin(sd, f"audio_injector.injector_adain_layers.{k}.linear", layer["adain"]["linear"])
    for name, patch in (("proj", (1, 2, 2)), ("proj_2x", (2, 4, 4)), ("proj_4x", (4, 8, 8))):
        q = p["frame_packer"][name]
        sd[f"frame_packer.{name}.weight"], sd[f"frame_packer.{name}.bias"] = _patch(
            q["w"], q["b"], patch)
    return sd


# ---------------------------------------------------------------------------
# The HunyuanVideo path: the DiT, the Llama and CLIP-L text towers, the VAE halves
# ---------------------------------------------------------------------------

def _ln(sd: StateDict, prefix: str, p: Mapping) -> None:
    sd[prefix + ".weight"] = _t(p["scale"])
    sd[prefix + ".bias"] = _t(p["bias"])


def _mlp01(sd: StateDict, prefix: str, p: Mapping) -> None:
    _lin(sd, prefix + ".0", p["fc0"])
    _lin(sd, prefix + ".2", p["fc2"])


def hunyuan_video_dit_state_dict(p: Mapping, patch=(1, 2, 2)) -> StateDict:
    """JAX ``hunyuan_video_dit_params_from_torch``'s tree -> the reference DiT keys."""
    sd: StateDict = {}
    sd["img_in.proj.weight"], sd["img_in.proj.bias"] = _patch(p["img_in"]["w"],
                                                              p["img_in"]["b"], patch)
    t = p["txt_in"]
    _lin(sd, "txt_in.input_embedder", t["input_emb"])
    _mlp01(sd, "txt_in.t_embedder.timestep_embedder", t["t_emb"])
    _mlp01(sd, "txt_in.c_embedder", t["c_emb"])
    for i in range(int(np.asarray(t["blocks"]["norm1"]["scale"]).shape[0])):
        b, pre = _layer(t["blocks"], i), f"txt_in.blocks.{i}"
        _ln(sd, pre + ".norm1", b["norm1"])
        _lin(sd, pre + ".self_attn_qkv", b["qkv"])
        _lin(sd, pre + ".self_attn_proj", b["proj"])
        _ln(sd, pre + ".norm2", b["norm2"])
        _mlp01(sd, pre + ".mlp", b["mlp"])
        _lin(sd, pre + ".adaLN_modulation.1", b["ada"])
    _mlp01(sd, "time_in.timestep_embedder", p["time_in"])
    _mlp01(sd, "vector_in", p["vector_in"])
    if "guidance_in" in p:
        _mlp01(sd, "guidance_in.timestep_embedder", p["guidance_in"])

    def qkv_block(pre, c):
        _lin(sd, pre + ".mod.linear", c["mod"])
        _lin(sd, pre + ".to_qkv", c["qkv"])
        sd[pre + ".norm_q.weight"] = _t(c["norm_q"]["w"])
        sd[pre + ".norm_k.weight"] = _t(c["norm_k"]["w"])
        _lin(sd, pre + ".to_out", c["out"])

    for i in range(int(np.asarray(p["double_blocks"]["a"]["qkv"]["w"]).shape[0])):
        b = _layer(p["double_blocks"], i)
        for side in ("a", "b"):
            pre = f"double_blocks.{i}.component_{side}"
            qkv_block(pre, b[side])
            _mlp01(sd, pre + ".ff", b[side]["ff"])
    for i in range(int(np.asarray(p["single_blocks"]["qkv"]["w"]).shape[0])):
        b, pre = _layer(p["single_blocks"], i), f"single_blocks.{i}"
        qkv_block(pre, b)
        _lin(sd, pre + ".ff.0", b["ff_fc0"])
        _lin(sd, pre + ".ff.2", b["ff_fc2"], bias=False)
    _lin(sd, "final_layer.linear", p["final"]["linear"])
    _lin(sd, "final_layer.adaLN_modulation.1", p["final"]["ada"])
    return sd


def llama_state_dict(p: Mapping) -> StateDict:
    """JAX ``llama_params_from_torch``'s tree -> HF LlamaModel keys. The tree holds no
    final norm (the skip-layer hidden states never use it): ``norm.weight`` comes back
    as ones."""
    emb = np.asarray(p["word_emb"])
    sd: StateDict = {"embed_tokens.weight": _t(emb),
                     "norm.weight": torch.ones(emb.shape[1], dtype=_t(emb).dtype)}
    names = {"q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
             "o": "self_attn.o_proj", "gate": "mlp.gate_proj", "up": "mlp.up_proj",
             "down": "mlp.down_proj"}
    for i in range(int(np.asarray(p["blocks"]["q"]["w"]).shape[0])):
        b, pre = _layer(p["blocks"], i), f"layers.{i}"
        sd[pre + ".input_layernorm.weight"] = _t(b["norm1"]["w"])
        sd[pre + ".post_attention_layernorm.weight"] = _t(b["norm2"]["w"])
        for k, name in names.items():
            _lin(sd, f"{pre}.{name}", b[k], bias=False)
    return sd


def clip_text_state_dict(p: Mapping) -> StateDict:
    """JAX ``sd_text_params_from_torch``'s tree ({"text": ...}, and "text_proj" where the
    tower projects) -> the reference SD text encoder keys."""
    t = p["text"]
    sd: StateDict = {"token_embedding.weight": _t(t["tok_emb"]),
                     "position_embeds": _t(np.asarray(t["pos_emb"])[None])}
    for i in range(int(np.asarray(t["blocks"]["fc1_w"]).shape[0])):
        b, pre = _layer(t["blocks"], i), f"encoders.{i}"
        _ln(sd, pre + ".layer_norm1", b["ln1"])
        _ln(sd, pre + ".layer_norm2", b["ln2"])
        for proj, name in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"), ("o", "to_out")):
            _lin(sd, f"{pre}.attn.{name}", {"w": b["attn"][proj + "_w"],
                                             "b": b["attn"][proj + "_b"]})
        for fc in ("fc1", "fc2"):
            _lin(sd, f"{pre}.{fc}", {"w": b[fc + "_w"], "b": b[fc + "_b"]})
    if "ln_final" in t:           # SDXL's first tower has none
        _ln(sd, "final_layer_norm", t["ln_final"])
    if "text_proj" in p:
        sd["text_projection.weight"] = _t(np.asarray(p["text_proj"]).T)
    return sd


def _hf_clip_vision(sd: StateDict, prefix: str, v: Mapping) -> None:
    """JAX's CLIP vision tree -> HF ``CLIPVisionTransformer`` keys under `prefix`."""
    sd[prefix + "embeddings.patch_embedding.weight"] = _t(
        np.asarray(v["patch_w"]).transpose(3, 2, 0, 1))
    sd[prefix + "embeddings.class_embedding"] = _t(v["cls_emb"])
    sd[prefix + "embeddings.position_embedding.weight"] = _t(v["pos_emb"])
    _ln(sd, prefix + "pre_layrnorm", v["ln_pre"])
    _ln(sd, prefix + "post_layernorm", v["ln_post"])
    for i in range(int(np.asarray(v["blocks"]["fc1_w"]).shape[0])):
        b, pre = _layer(v["blocks"], i), f"{prefix}encoder.layers.{i}"
        _ln(sd, pre + ".layer_norm1", b["ln1"])
        _ln(sd, pre + ".layer_norm2", b["ln2"])
        for proj, name in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "out_proj")):
            _lin(sd, f"{pre}.self_attn.{name}", {"w": b["attn"][proj + "_w"],
                                                  "b": b["attn"][proj + "_b"]})
        for fc in ("fc1", "fc2"):
            _lin(sd, f"{pre}.mlp.{fc}", {"w": b[fc + "_w"], "b": b[fc + "_b"]})


def llava_state_dict(p: Mapping) -> StateDict:
    """JAX ``llava_params_from_torch``'s tree -> the on-disk LLaVA keys
    (``vision_tower.*``, ``multi_modal_projector.*``, ``language_model.model.*``)."""
    sd: StateDict = {}
    _hf_clip_vision(sd, "vision_tower.vision_model.", p["vision"])
    for i in (1, 2):
        _lin(sd, f"multi_modal_projector.linear_{i}", {"w": p["proj"][f"w{i}"],
                                                       "b": p["proj"][f"b{i}"]})
    lm = llama_state_dict(p["llama"])
    lm["norm.weight"] = _t(p["final_norm"]["w"])
    sd.update({"language_model.model." + k: v for k, v in lm.items()})
    return sd


def cog_dit_state_dict(p: Mapping, patch: int = 2) -> StateDict:
    """JAX ``cog_dit_params_from_torch``'s tree -> the reference CogVideoX DiT keys (the
    (C*P*P, D) patch matmul -> Conv3d (D, C, 1, P, P))."""
    w = np.asarray(p["patchify"]["w"])
    sd: StateDict = {"patchify.proj.weight": _t(w.T.reshape(w.shape[1], -1, 1, patch, patch)),
                     "patchify.proj.bias": _t(p["patchify"]["b"])}
    _mlp01(sd, "time_embedder.timestep_embedder", p["time_emb"])
    _lin(sd, "context_embedder", p["context_embedder"])
    for i in range(int(np.asarray(p["blocks"]["norm_q"]["scale"]).shape[0])):
        b, pre = _layer(p["blocks"], i), f"blocks.{i}"
        for name in ("norm1", "norm2"):
            _lin(sd, f"{pre}.{name}.linear", b[name]["linear"])
            _ln(sd, f"{pre}.{name}.norm", b[name]["norm"])
        for proj, name in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"), ("o", "to_out")):
            _lin(sd, f"{pre}.attn1.{name}", {"w": b["attn"][proj + "_w"],
                                             "b": b["attn"][proj + "_b"]})
        _ln(sd, pre + ".norm_q", b["norm_q"])
        _ln(sd, pre + ".norm_k", b["norm_k"])
        _mlp01(sd, pre + ".ff", b["ff"])
    _ln(sd, "norm_final", p["norm_final"])
    _lin(sd, "norm_out.linear", p["norm_out"]["linear"])
    _ln(sd, "norm_out.norm", p["norm_out"]["norm"])
    _lin(sd, "proj_out", p["proj_out"])
    return sd


def cog_vae_state_dict(p: Mapping) -> StateDict:
    """JAX ``cog_vae_{decoder,encoder}_params_from_torch``'s tree (or its initialiser's)
    -> the reference keys of that half."""
    sd: StateDict = {}

    def norm(prefix, q):
        if "norm_layer" in q:
            _ln(sd, prefix + ".norm_layer", q["norm_layer"])
            _conv3d(sd, prefix + ".conv_y", q["conv_y"])
            _conv3d(sd, prefix + ".conv_b", q["conv_b"])
        else:
            _ln(sd, prefix, q)

    _conv3d(sd, "conv_in", p["conv_in"])
    for i, b in enumerate(p["blocks"]):
        pre = f"blocks.{i}"
        if "conv1" not in b:
            _conv2d(sd, pre + ".conv", b)
            continue
        norm(pre + ".norm1", b["norm1"])
        norm(pre + ".norm2", b["norm2"])
        _conv3d(sd, pre + ".conv1", b["conv1"])
        _conv3d(sd, pre + ".conv2", b["conv2"])
        if "shortcut" in b:
            _conv3d(sd, pre + ".conv_shortcut", b["shortcut"])
    norm("norm_out", p["norm_out"])
    _conv3d(sd, "conv_out", p["conv_out"])
    return sd


def _hv_conv(sd: StateDict, prefix: str, p: Mapping) -> None:
    _conv3d(sd, prefix + ".conv", p)


def _hv_res(sd: StateDict, prefix: str, p: Mapping) -> None:
    _ln(sd, prefix + ".norm1", p["norm1"])
    _hv_conv(sd, prefix + ".conv1", p["conv1"])
    _ln(sd, prefix + ".norm2", p["norm2"])
    _hv_conv(sd, prefix + ".conv2", p["conv2"])
    if "shortcut" in p:
        _hv_conv(sd, prefix + ".conv_shortcut", p["shortcut"])


def _hv_mid(sd: StateDict, prefix: str, p: Mapping) -> None:
    for i, r in enumerate(p["resnets"]):
        _hv_res(sd, f"{prefix}.resnets.{i}", r)
    for i, a in enumerate(p["attentions"]):
        pre = f"{prefix}.attentions.{i}"
        _ln(sd, pre + ".group_norm", a["norm"])
        for proj, name in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"), ("o", "to_out.0")):
            _lin(sd, f"{pre}.{name}", {"w": a[proj + "_w"], "b": a[proj + "_b"]})


def _hv_1x1(sd: StateDict, prefix: str, p: Mapping) -> None:
    sd[prefix + ".weight"] = _t(np.asarray(p["w"]).T[:, :, None, None, None])
    sd[prefix + ".bias"] = _t(p["b"])


def hunyuan_vae_encoder_state_dict(p: Mapping) -> StateDict:
    """JAX ``hunyuan_vae_encoder_params_from_torch``'s tree -> the reference keys."""
    sd: StateDict = {}
    _hv_conv(sd, "encoder.conv_in", p["conv_in"])
    for i, blk in enumerate(p["down_blocks"]):
        for j, r in enumerate(blk["resnets"]):
            _hv_res(sd, f"encoder.down_blocks.{i}.resnets.{j}", r)
        if "down" in blk:
            _hv_conv(sd, f"encoder.down_blocks.{i}.downsamplers.0.conv", blk["down"])
    _hv_mid(sd, "encoder.mid_block", p["mid"])
    _ln(sd, "encoder.conv_norm_out", p["conv_norm_out"])
    _hv_conv(sd, "encoder.conv_out", p["conv_out"])
    _hv_1x1(sd, "quant_conv", p["quant_conv"])
    return sd


def hunyuan_vae_decoder_state_dict(p: Mapping) -> StateDict:
    """JAX ``hunyuan_vae_decoder_params_from_torch``'s tree -> the reference keys."""
    sd: StateDict = {}
    _hv_1x1(sd, "post_quant_conv", p["post_quant_conv"])
    _hv_conv(sd, "decoder.conv_in", p["conv_in"])
    _hv_mid(sd, "decoder.mid_block", p["mid"])
    for i, blk in enumerate(p["up_blocks"]):
        for j, r in enumerate(blk["resnets"]):
            _hv_res(sd, f"decoder.up_blocks.{i}.resnets.{j}", r)
        if "up" in blk:
            _hv_conv(sd, f"decoder.up_blocks.{i}.upsamplers.0.conv", blk["up"]["conv"])
    _ln(sd, "decoder.conv_norm_out", p["conv_norm_out"])
    _hv_conv(sd, "decoder.conv_out", p["conv_out"])
    return sd


# ---------------------------------------------------------------------------
# The StepVideo path: the DiT, the VAE, BERT and Step-1
# ---------------------------------------------------------------------------

def _linb(sd: StateDict, prefix: str, p: Mapping) -> None:
    _lin(sd, prefix, p, bias="b" in p)


def _unfuse(w, parts: int, head_dim: int) -> torch.Tensor:
    """JAX's (in, parts * n * hd) fused weight, columns (part, head, hd) -> the reference's
    (n * parts * hd, in), rows (head, part, hd)."""
    w = np.asarray(w)
    n = w.shape[1] // (parts * head_dim)
    w = w.reshape(w.shape[0], parts, n, head_dim).transpose(0, 2, 1, 3)
    return _t(np.ascontiguousarray(w.reshape(w.shape[0], -1).T))


def stepvideo_dit_state_dict(p: Mapping) -> StateDict:
    """JAX ``stepvideo_dit_params_from_torch``'s (or ``init_stepvideo_dit``'s) tree ->
    the reference StepVideo DiT keys."""
    w = np.asarray(p["patch_in"]["w"])
    sd: StateDict = {"pos_embed.proj.weight": _t(w.T[:, :, None, None]),
                     "pos_embed.proj.bias": _t(p["patch_in"]["b"])}
    _linb(sd, "adaln_single.emb.timestep_embedder.linear_1", p["time_emb"]["fc0"])
    _linb(sd, "adaln_single.emb.timestep_embedder.linear_2", p["time_emb"]["fc2"])
    _linb(sd, "adaln_single.linear", p["adaln_linear"])
    _linb(sd, "caption_projection.linear_1", p["caption_proj"]["fc0"])
    _linb(sd, "caption_projection.linear_2", p["caption_proj"]["fc2"])
    if "clip_proj" in p:
        _linb(sd, "clip_projection", p["clip_proj"])
    blocks = p["blocks"]
    for i in range(int(np.asarray(blocks["scale_shift_table"]).shape[0])):
        b, pre = _layer(blocks, i), f"transformer_blocks.{i}"
        hd = int(b["attn1"]["q_norm"]["w"].shape[0])
        for norm in ("norm1", "norm2"):
            sd[f"{pre}.{norm}.weight"] = _t(b[norm]["w"])
            sd[f"{pre}.{norm}.bias"] = _t(b[norm]["b"])
        sd[pre + ".attn1.wqkv.weight"] = _unfuse(b["attn1"]["qkv"]["w"], 3, hd)
        sd[pre + ".attn2.wkv.weight"] = _unfuse(b["attn2"]["kv"]["w"], 2, hd)
        _linb(sd, pre + ".attn1.wo", b["attn1"]["o"])
        _linb(sd, pre + ".attn2.wq", b["attn2"]["q"])
        _linb(sd, pre + ".attn2.wo", b["attn2"]["o"])
        for a in ("attn1", "attn2"):
            for norm in ("q_norm", "k_norm"):
                sd[f"{pre}.{a}.{norm}.weight"] = _t(b[a][norm]["w"])
        _linb(sd, pre + ".ff.net.0.proj", b["ff"]["fc0"])
        _linb(sd, pre + ".ff.net.2", b["ff"]["fc2"])
        sd[pre + ".scale_shift_table"] = _t(b["scale_shift_table"])
    sd["scale_shift_table"] = _t(p["scale_shift_table"])
    _linb(sd, "proj_out", p["proj_out"])
    return sd


def _sv_conv(sd: StateDict, prefix: str, p: Mapping) -> None:
    _conv3d(sd, prefix + ".conv", p)


def _sv_res(sd: StateDict, prefix: str, p: Mapping) -> None:
    _ln(sd, prefix + ".norm1", p["norm1"])
    _sv_conv(sd, prefix + ".conv1", p["conv1"])
    _ln(sd, prefix + ".norm2", p["norm2"])
    _sv_conv(sd, prefix + ".conv2", p["conv2"])
    if "shortcut" in p:
        _sv_conv(sd, prefix + ".nin_shortcut", p["shortcut"])


def _sv_mid(sd: StateDict, prefix: str, p: Mapping) -> None:
    _sv_res(sd, prefix + ".block_1", p["mid_block1"])
    _sv_res(sd, prefix + ".block_2", p["mid_block2"])
    a, pre = p["mid_attn"], prefix + ".attn_1"
    _ln(sd, pre + ".norm", a["norm"])
    for proj, name in (("q", "q"), ("k", "k"), ("v", "v"), ("proj", "proj_out")):
        _sv_conv(sd, f"{pre}.{name}", a[proj])


def stepvideo_vae_state_dict(p: Mapping) -> StateDict:
    """JAX ``stepvideo_vae_params_from_torch``'s tree ({"encoder", "decoder"}, or one of
    them) -> the reference ``encoder.*`` / ``decoder.*`` keys."""
    sd: StateDict = {}
    if "encoder" in p:
        e = p["encoder"]
        _sv_conv(sd, "encoder.conv_in", e["conv_in"])
        for i, lvl in enumerate(e["down"]):
            for j, r in enumerate(lvl["blocks"]):
                _sv_res(sd, f"encoder.down.{i}.block.{j}", r)
            if "downsample" in lvl:
                w = lvl["downsample"]
                if np.asarray(w["w"]).ndim == 5:
                    _sv_conv(sd, f"encoder.down.{i}.downsample.conv", w)
                else:
                    _conv2d(sd, f"encoder.down.{i}.downsample.conv", w)
        _sv_mid(sd, "encoder.mid", e)
        _ln(sd, "encoder.norm_out", e["norm_out"])
        _sv_conv(sd, "encoder.conv_patchify.conv", e["conv_patchify"])
        _sv_conv(sd, "encoder.conv_out", e["conv_out"])
    if "decoder" in p:
        d = p["decoder"]
        _sv_conv(sd, "decoder.conv_in", d["conv_in"])
        _sv_conv(sd, "decoder.conv_unpatchify.conv", d["conv_unpatchify"])
        _sv_mid(sd, "decoder.mid", d)
        for i, lvl in enumerate(d["up"]):
            for j, r in enumerate(lvl["blocks"]):
                _sv_res(sd, f"decoder.up.{i}.block.{j}", r)
            up = lvl.get("upsample")
            if up is not None and "conv3d" in up:
                pre, u = f"decoder.up.{i}.upsample.conv3d", up["conv3d"]
                _sv_conv(sd, pre + ".conv1", u["conv1"])
                _sv_conv(sd, pre + ".conv2", u["conv2"])
                _ln(sd, pre + ".norm1", u["norm1"])
                _ln(sd, pre + ".norm2", u["norm2"])
            elif up is not None:
                _conv2d(sd, f"decoder.up.{i}.upsample.conv", up)
        _ln(sd, "decoder.norm_out", d["norm_out"])
        _sv_conv(sd, "decoder.conv_out", d["conv_out"])
    return sd


def bert_state_dict(p: Mapping) -> StateDict:
    """JAX ``bert_params_from_torch``'s tree -> HF BertModel keys."""
    sd: StateDict = {"embeddings.word_embeddings.weight": _t(p["word_emb"]),
                     "embeddings.position_embeddings.weight": _t(p["pos_emb"]),
                     "embeddings.token_type_embeddings.weight": _t(p["type_emb"])}
    _ln(sd, "embeddings.LayerNorm", p["emb_ln"])
    names = {"q": "attention.self.query", "k": "attention.self.key",
             "v": "attention.self.value", "o": "attention.output.dense",
             "fc1": "intermediate.dense", "fc2": "output.dense"}
    for i in range(int(np.asarray(p["blocks"]["q"]["w"]).shape[0])):
        b, pre = _layer(p["blocks"], i), f"encoder.layer.{i}"
        for k, name in names.items():
            _lin(sd, f"{pre}.{name}", b[k])
        _ln(sd, pre + ".attention.output.LayerNorm", b["attn_ln"])
        _ln(sd, pre + ".output.LayerNorm", b["out_ln"])
    return sd


def step1_state_dict(p: Mapping) -> StateDict:
    """JAX ``step1_params_from_torch``'s tree -> the Step-1 reference keys."""
    sd: StateDict = {"tok_embeddings.word_embeddings.weight": _t(p["word_emb"])}
    for i in range(int(np.asarray(p["blocks"]["wqkv"]["w"]).shape[0])):
        b, pre = _layer(p["blocks"], i), f"transformer.layers.{i}"
        sd[pre + ".attention_norm.weight"] = _t(b["attn_norm"]["w"])
        sd[pre + ".ffn_norm.weight"] = _t(b["ffn_norm"]["w"])
        for k, name in (("wqkv", "attention.wqkv"), ("wo", "attention.wo"),
                        ("w1", "feed_forward.w1"), ("w2", "feed_forward.w2")):
            _lin(sd, f"{pre}.{name}", b[k], bias=False)
    return sd


# ---------------------------------------------------------------------------
# The Flux path: the DiT, its ControlNet, the SD / SD3 VAE halves, Step1X's connector and
# the Flux adapters
# ---------------------------------------------------------------------------

def _w(sd: StateDict, prefix: str, w) -> None:
    """A bias-free (in, out) weight -> ``{prefix}.weight`` (out, in)."""
    sd[prefix + ".weight"] = _t(np.asarray(w).T)


def _flux_trunk(sd: StateDict, p: Mapping) -> None:
    _lin(sd, "x_embedder", p["x_embedder"])
    _lin(sd, "context_embedder", p["context_embedder"])
    _mlp01(sd, "time_embedder.timestep_embedder", p["time_in"])
    _mlp01(sd, "pooled_text_embedder", p["vector_in"])
    if "guidance_in" in p:
        _mlp01(sd, "guidance_embedder.timestep_embedder", p["guidance_in"])
    joint = p["joint_blocks"]
    for i in range(np.asarray(joint["norm1_a"]["w"]).shape[0]):
        q, pre = _layer(joint, i), f"blocks.{i}"
        for name in ("norm1_a", "norm1_b"):
            _lin(sd, f"{pre}.{name}.linear", q[name])
        a = q["attn"]
        for jax_name, ref in (("a_qkv", "a_to_qkv"), ("b_qkv", "b_to_qkv"),
                              ("a_out", "a_to_out"), ("b_out", "b_to_out")):
            _lin(sd, f"{pre}.attn.{ref}", a[jax_name])
        for norm in ("norm_q_a", "norm_k_a", "norm_q_b", "norm_k_b"):
            sd[f"{pre}.attn.{norm}.weight"] = _t(a[norm]["w"])
        _mlp01(sd, f"{pre}.ff_a", q["ff_a"])
        _mlp01(sd, f"{pre}.ff_b", q["ff_b"])
    single = p.get("single_blocks")
    for i in range(0 if single is None else np.asarray(single["norm"]["w"]).shape[0]):
        q, pre = _layer(single, i), f"single_blocks.{i}"
        _lin(sd, f"{pre}.norm.linear", q["norm"])
        _lin(sd, f"{pre}.to_qkv_mlp", q["qkv_mlp"])
        sd[f"{pre}.norm_q_a.weight"] = _t(q["norm_q"]["w"])
        sd[f"{pre}.norm_k_a.weight"] = _t(q["norm_k"]["w"])
        _lin(sd, f"{pre}.proj_out", q["proj_out"])


def flux_dit_state_dict(p: Mapping) -> StateDict:
    """JAX ``flux_dit_params_from_torch``'s tree (stacked joint / single blocks) -> the
    reference FluxDiT keys."""
    sd: StateDict = {}
    _flux_trunk(sd, p)
    _lin(sd, "final_norm_out.linear", p["final_norm"])
    _lin(sd, "final_proj_out", p["final_proj"])
    return sd


def flux_controlnet_state_dict(p: Mapping) -> StateDict:
    """JAX ``flux_controlnet_params_from_torch``'s tree -> the reference FluxControlNet
    keys (the trunk, ``controlnet_x_embedder``, the stacked residual linears, the mode
    embedder)."""
    sd: StateDict = {}
    _flux_trunk(sd, p)
    _lin(sd, "controlnet_x_embedder", p["controlnet_x_embedder"])
    for name in ("controlnet_blocks", "controlnet_single_blocks"):
        if name in p:
            for i in range(np.asarray(p[name]["w"]).shape[0]):
                _lin(sd, f"{name}.{i}", _layer(p[name], i))
    if "mode_embedder" in p:
        sd["controlnet_mode_embedder.weight"] = _t(p["mode_embedder"])
    return sd


def sd_vae_state_dict(p: Mapping) -> StateDict:
    """JAX ``sd[3]_vae_{encoder,decoder}_params_from_torch``'s tree -> the reference
    SDVAEEncoder / SDVAEDecoder keys (HWIO convs -> (out, in, kh, kw))."""
    sd: StateDict = {}
    for name in ("post_quant_conv", "conv_in", "conv_out", "quant_conv"):
        if name in p:
            _conv2d(sd, name, p[name])
    _ln(sd, "conv_norm_out", p["conv_norm_out"])
    for i, b in enumerate(p["blocks"]):
        pre = f"blocks.{i}"
        if "norm1" in b:
            for name in ("norm1", "norm2"):
                _ln(sd, f"{pre}.{name}", b[name])
            for jax_name, ref in (("conv1", "conv1"), ("conv2", "conv2"),
                                  ("shortcut", "conv_shortcut")):
                if jax_name in b:
                    _conv2d(sd, f"{pre}.{ref}", b[jax_name])
        elif "attn" in b:
            _ln(sd, f"{pre}.norm", b["norm"])
            a = b["attn"]
            for x, ref in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"), ("o", "to_out")):
                _lin(sd, f"{pre}.transformer_blocks.0.{ref}", {"w": a[x + "_w"], "b": a[x + "_b"]})
        else:
            _conv2d(sd, f"{pre}.conv", b["conv"])
    return sd


def step1x_connector_state_dict(p: Mapping) -> StateDict:
    """JAX ``step1x_connector_params_from_torch``'s tree -> the reference keys."""
    sd: StateDict = {}
    _lin(sd, "S.input_embedder", p["input_embedder"])
    _mlp01(sd, "S.t_embedder.mlp", p["t_embedder"])
    _lin(sd, "S.c_embedder.linear_1", p["c_embedder"]["fc0"])
    _lin(sd, "S.c_embedder.linear_2", p["c_embedder"]["fc2"])
    for i, b in enumerate(p["blocks"]):
        pre = f"S.individual_token_refiner.blocks.{i}"
        _ln(sd, pre + ".norm1", b["norm1"])
        _ln(sd, pre + ".norm2", b["norm2"])
        for jax_name, ref in (("qkv", "self_attn_qkv"), ("proj", "self_attn_proj"),
                              ("mlp_fc0", "mlp.fc1"), ("mlp_fc2", "mlp.fc2"),
                              ("ada", "adaLN_modulation.1")):
            _lin(sd, f"{pre}.{ref}", b[jax_name])
    _lin(sd, "global_proj_out", p["global_proj"])
    sd["scale_factor"] = _t(p["scale_factor"])
    return sd


def infiniteyou_state_dict(p: Mapping) -> StateDict:
    """JAX ``infiniteyou_params_from_torch``'s tree -> InfiniteYouImageProjector keys."""
    sd: StateDict = {"latents": _t(p["latents"])}
    for name in ("proj_in", "proj_out"):
        _lin(sd, name, p[name])
    _ln(sd, "norm_out", p["norm_out"])
    for i, layer in enumerate(p["layers"]):
        a, pre = layer["attn"], f"layers.{i}"
        _ln(sd, pre + ".0.norm1", a["norm1"])
        _ln(sd, pre + ".0.norm2", a["norm2"])
        for x, ref in (("q_w", "to_q"), ("kv_w", "to_kv"), ("o_w", "to_out")):
            _w(sd, f"{pre}.0.{ref}", a[x])
        _ln(sd, pre + ".1.0", layer["ff_norm"])
        _w(sd, pre + ".1.1", layer["ff0_w"])
        _w(sd, pre + ".1.3", layer["ff2_w"])
    return sd


def value_encoder_state_dict(p: Mapping) -> StateDict:
    """JAX ``value_encoder_params_from_torch``'s tree -> SingleValueEncoder keys."""
    sd: StateDict = {"positional_embedding": _t(p["pos"])}
    _mlp01(sd, "prefer_value_embedder", p)
    return sd


def flux_lora_encoder_state_dict(p: Mapping) -> StateDict:
    """JAX ``flux_lora_encoder_params_from_torch``'s tree -> FluxLoRAEncoder keys."""
    sd: StateDict = {"special_embeds": _t(p["special"])}
    for name, blk in p["model"].items():
        pre = "embedder.model_dict." + name.replace(".", "___")
        sd[pre + ".x"] = _t(blk["x"])
        _ln(sd, pre + ".layer_norm", blk["ln"])
    for typ, proj in p["proj"].items():
        _lin(sd, "embedder.proj_dict." + typ.replace(".", "___"), proj)
    for i, e in enumerate(p["encoders"]):
        pre = f"encoders.{i}"
        _ln(sd, pre + ".layer_norm1", e["norm1"])
        _ln(sd, pre + ".layer_norm2", e["norm2"])
        for x, ref in (("q", "attn.to_q"), ("k", "attn.to_k"), ("v", "attn.to_v"),
                       ("o", "attn.to_out"), ("fc1", "fc1"), ("fc2", "fc2")):
            _lin(sd, f"{pre}.{ref}", {"w": e[x + "_w"], "b": e[x + "_b"]})
    _ln(sd, "final_layer_norm", p["final_norm"])
    _lin(sd, "final_linear", {"w": p["final_w"], "b": p["final_b"]})
    return sd


def flux_ipadapter_state_dict(p: Mapping) -> StateDict:
    """The tree ``flux_ip_kwargs`` reads ({"image_proj": {proj0, proj2, norm},
    "modules": [{k_w, v_w}]}) -> the reference FluxIpAdapter keys."""
    sd: StateDict = {}
    ip = p["image_proj"]
    _lin(sd, "image_proj.proj.0", ip["proj0"])
    _lin(sd, "image_proj.proj.2", ip["proj2"])
    _ln(sd, "image_proj.norm", ip["norm"])
    for i, m in enumerate(p["modules"]):
        _w(sd, f"ipadapter_modules.{i}.to_k_ip", m["k_w"])
        _w(sd, f"ipadapter_modules.{i}.to_v_ip", m["v_w"])
    return sd


# ---------------------------------------------------------------------------
# SD3 and Qwen-Image: the SD3 MMDiT, the Qwen-Image DiT, its blockwise ControlNet, the
# Qwen2.5-VL text and vision towers
# ---------------------------------------------------------------------------

def _sd3_attn(sd: StateDict, prefix: str, a: Mapping) -> None:
    for jax_name, ref in (("a_qkv", "a_to_qkv"), ("a_out", "a_to_out"),
                          ("b_qkv", "b_to_qkv"), ("b_out", "b_to_out")):
        if jax_name in a:
            _lin(sd, f"{prefix}.{ref}", a[jax_name])
    for norm in ("norm_q_a", "norm_k_a", "norm_q_b", "norm_k_b"):
        if norm in a:
            sd[f"{prefix}.{norm}.weight"] = _t(a[norm]["w"])


def _sd3_block(sd: StateDict, prefix: str, q: Mapping) -> None:
    for name in ("norm1_a", "norm1_b"):
        _lin(sd, f"{prefix}.{name}.linear", q[name])
    _sd3_attn(sd, prefix + ".attn", q["attn"])
    if "attn2" in q:
        _sd3_attn(sd, prefix + ".attn2", q["attn2"])
    for ff in ("ff_a", "ff_b"):
        if ff in q:
            _mlp01(sd, f"{prefix}.{ff}", q[ff])


def sd3_dit_state_dict(p: Mapping, patch: int = 2) -> StateDict:
    """JAX ``sd3_dit_params_from_torch``'s tree (stacked dual and plain blocks, the final
    block apart) -> the reference SD3DiT keys: the blocks renumbered dual first, the
    (C*P*P, D) patch matmul -> Conv2d (D, C, P, P), the (M, M, D) table -> (1, M, M, D)."""
    pe = p["pos_embedder"]
    w = np.asarray(pe["proj"]["w"])
    sd: StateDict = {"pos_embedder.proj.weight": _t(w.T.reshape(w.shape[1], -1, patch, patch)),
                     "pos_embedder.proj.bias": _t(pe["proj"]["b"]),
                     "pos_embedder.pos_embed": _t(np.asarray(pe["pos_embed"])[None])}
    _mlp01(sd, "time_embedder.timestep_embedder", p["time_in"])
    _mlp01(sd, "pooled_text_embedder", p["vector_in"])
    _lin(sd, "context_embedder", p["context_embedder"])
    i = 0
    for name in ("dual_blocks", "blocks"):
        if name in p:
            for j in range(np.asarray(p[name]["norm1_a"]["w"]).shape[0]):
                _sd3_block(sd, f"blocks.{i}", _layer(p[name], j))
                i += 1
    _sd3_block(sd, f"blocks.{i}", p["final_block"])
    _lin(sd, "norm_out.linear", p["norm_out"])
    _lin(sd, "proj_out", p["proj_out"])
    return sd


def qwen_image_dit_state_dict(p: Mapping) -> StateDict:
    """JAX ``qwen_image_dit_params_from_torch``'s tree -> the reference QwenImageDiT
    keys."""
    sd: StateDict = {"txt_norm.weight": _t(p["txt_norm"]["w"])}
    for name in ("img_in", "txt_in", "proj_out"):
        _lin(sd, name, p[name])
    _lin(sd, "norm_out.linear", p["norm_out"])
    _lin(sd, "time_text_embed.timestep_embedder.linear_1", p["time_in"]["fc0"])
    _lin(sd, "time_text_embed.timestep_embedder.linear_2", p["time_in"]["fc2"])
    names = {"to_q": "to_q", "to_k": "to_k", "to_v": "to_v", "add_q": "add_q_proj",
             "add_k": "add_k_proj", "add_v": "add_v_proj", "to_out": "to_out.0",
             "to_add_out": "to_add_out"}
    for i in range(np.asarray(p["blocks"]["img_mod"]["w"]).shape[0]):
        q, pre = _layer(p["blocks"], i), f"transformer_blocks.{i}"
        _lin(sd, pre + ".img_mod.1", q["img_mod"])
        _lin(sd, pre + ".txt_mod.1", q["txt_mod"])
        for jax_name, ref in names.items():
            _lin(sd, f"{pre}.attn.{ref}", q["attn"][jax_name])
        for norm in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            sd[f"{pre}.attn.{norm}.weight"] = _t(q["attn"][norm]["w"])
        for mlp in ("img_mlp", "txt_mlp"):
            _lin(sd, f"{pre}.{mlp}.net.0.proj", q[mlp]["fc0"])
            _lin(sd, f"{pre}.{mlp}.net.2", q[mlp]["fc2"])
    return sd


def qwen_image_controlnet_state_dict(p: Mapping) -> StateDict:
    """JAX ``qwen_image_controlnet_params_from_torch``'s tree -> the reference
    blockwise ControlNet keys."""
    sd: StateDict = {}
    _lin(sd, "img_in", p["img_in"])
    for i in range(np.asarray(p["blocks"]["in"]["w"]).shape[0]):
        q, pre = _layer(p["blocks"], i), f"controlnet_blocks.{i}"
        sd[pre + ".x_rms.weight"] = _t(q["x_rms"]["w"])
        sd[pre + ".y_rms.weight"] = _t(q["y_rms"]["w"])
        _lin(sd, pre + ".input_proj", q["in"])
        _lin(sd, pre + ".output_proj", q["out"])
    return sd


def _qwen_layers(sd: StateDict, blocks: Mapping) -> None:
    """Stacked Qwen2 decoder blocks -> ``layers.{i}.*`` (q/k/v biases where present)."""
    names = {"q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
             "o": "self_attn.o_proj", "gate": "mlp.gate_proj", "up": "mlp.up_proj",
             "down": "mlp.down_proj"}
    for i in range(np.asarray(blocks["q"]["w"]).shape[0]):
        b, pre = _layer(blocks, i), f"layers.{i}"
        sd[pre + ".input_layernorm.weight"] = _t(b["norm1"]["w"])
        sd[pre + ".post_attention_layernorm.weight"] = _t(b["norm2"]["w"])
        for k, name in names.items():
            _lin(sd, f"{pre}.{name}", b[k], bias="b" in b[k])


def qwen_vl_text_state_dict(p: Mapping) -> StateDict:
    """JAX ``qwen_vl_text_params_from_torch``'s tree -> the HF Qwen2.5-VL text keys
    without the ``model.`` prefix, and ``lm_head`` where the tree has one."""
    sd: StateDict = {"embed_tokens.weight": _t(p["wte"]),
                     "norm.weight": _t(p["final_norm"]["w"])}
    _qwen_layers(sd, p["blocks"])
    if "lm_head" in p:
        _w(sd, "lm_head", p["lm_head"]["w"])
    return sd


def nexus_gen_heads_state_dict(p: Mapping) -> StateDict:
    """JAX ``nexus_gen_ar_heads_from_torch``'s tree -> ``vision_head`` and
    ``image_prefill_embeds``."""
    sd: StateDict = {"image_prefill_embeds.weight": _t(p["image_prefill"])}
    _w(sd, "vision_head", p["vision_head"]["w"])
    return sd


def nexus_gen_adapter_state_dict(p: Mapping) -> StateDict:
    """JAX ``nexus_gen_adapter_params_from_torch``'s tree -> ``adapter.{0,1,3,4}``."""
    sd: StateDict = {}
    _lin(sd, "adapter.0", p["fc0"])
    _lin(sd, "adapter.3", p["fc1"])
    for i, name in (("1", "ln0"), ("4", "ln1")):
        sd[f"adapter.{i}.weight"] = _t(p[name]["scale"])
        sd[f"adapter.{i}.bias"] = _t(p[name]["bias"])
    return sd


def nexus_gen_merger_state_dict(p: Mapping) -> StateDict:
    """JAX ``nexus_gen_merger_params_from_torch``'s tree -> ``layers.{i}.*`` and
    ``projector.{0,1,2,4,5}``."""
    sd: StateDict = {}
    _qwen_layers(sd, p["blocks"])
    for i, name in (("0", "proj_norm0"), ("2", "proj_norm1"), ("5", "proj_norm2")):
        sd[f"projector.{i}.weight"] = _t(p[name]["w"])
    _lin(sd, "projector.1", p["proj_fc0"])
    _lin(sd, "projector.4", p["proj_fc1"])
    return sd


def hunyuan_dit_state_dict(p: Mapping) -> StateDict:
    """JAX ``hunyuan_dit_params_from_torch``'s tree (stacked ``down_blocks`` and
    ``up_blocks``) -> the reference HunyuanDiT keys, the up blocks numbered after the
    down blocks; the (C*2*2, D) patch matmul -> a Conv2d (D, C, 2, 2)."""
    sd: StateDict = {"text_emb_padding": _t(p["text_emb_padding"]),
                     "style_embedder": _t(p["style"])}
    _lin(sd, "t5_embedder.0", p["t5_embedder"]["fc0"])
    _lin(sd, "t5_embedder.2", p["t5_embedder"]["fc2"])
    pool = p["t5_pooler"]
    sd["t5_pooler.positional_embedding"] = _t(pool["pos"])
    for name in ("q", "k", "v", "c"):      # the pool's weights are in torch's layout
        sd[f"t5_pooler.{name}_proj.weight"] = _t(pool[f"{name}_w"])
        sd[f"t5_pooler.{name}_proj.bias"] = _t(pool[f"{name}_b"])
    w = np.asarray(p["patch_embedder"]["w"])
    sd["patch_embedder.proj.weight"] = _t(w.T.reshape(w.shape[1], -1, 2, 2))
    sd["patch_embedder.proj.bias"] = _t(p["patch_embedder"]["b"])
    _mlp01(sd, "timestep_embedder.mlp", p["time_emb"])
    _mlp01(sd, "extra_embedder", p["extra_emb"])
    n_down = int(np.asarray(p["down_blocks"]["norm1"]["w"]).shape[0])
    for stack, base in (("down_blocks", 0), ("up_blocks", n_down)):
        for i in range(np.asarray(p[stack]["norm1"]["w"]).shape[0]):
            b, pre = _layer(p[stack], i), f"blocks.{base + i}"
            norms = {name: b[name] for name in ("norm1", "norm2", "norm3", "skip_norm")
                     if name in b}
            norms.update({f"{r}.{n}": b[r][n] for r in ("rota1", "rota2")
                          for n in ("q_norm", "k_norm")})
            for name, q in norms.items():
                sd[f"{pre}.{name}.weight"], sd[f"{pre}.{name}.bias"] = _t(q["w"]), _t(q["b"])
            for attn in ("attn1", "attn2"):
                for proj, ref in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"), ("o", "to_out")):
                    _lin(sd, f"{pre}.{attn}.{ref}", {"w": b[attn][f"{proj}_w"],
                                                     "b": b[attn][f"{proj}_b"]})
            _lin(sd, f"{pre}.modulation.1", b["modulation"])
            _mlp01(sd, f"{pre}.mlp", b["mlp"])
            if "skip_linear" in b:
                _lin(sd, f"{pre}.skip_linear", b["skip_linear"])
    _lin(sd, "final_layer.linear", p["final"]["linear"])
    _lin(sd, "final_layer.adaLN_modulation.1", p["final"]["ada"])
    return sd


def omnigen_state_dict(p: Mapping, patch: int = 2) -> StateDict:
    """JAX ``omnigen_params_from_torch``'s tree -> the OmniGen checkpoint keys (``llm.*``,
    the patch matmuls -> Conv2d (D, C, p, p))."""
    sd: StateDict = {"llm.embed_tokens.weight": _t(p["wte"]),
                     "llm.norm.weight": _t(p["final_norm"]["w"])}
    for i in range(np.asarray(p["blocks"]["qkv"]["w"]).shape[0]):
        b, pre = _layer(p["blocks"], i), f"llm.layers.{i}"
        sd[pre + ".input_layernorm.weight"] = _t(b["norm1"]["w"])
        sd[pre + ".post_attention_layernorm.weight"] = _t(b["norm2"]["w"])
        for k, name in (("qkv", "self_attn.qkv_proj"), ("o", "self_attn.o_proj"),
                        ("gate_up", "mlp.gate_up_proj"), ("down", "mlp.down_proj")):
            _w(sd, f"{pre}.{name}", b[k]["w"])
    for name in ("x_embedder", "input_x_embedder"):
        w = np.asarray(p[name]["w"])
        sd[f"{name}.proj.weight"] = _t(w.T.reshape(w.shape[1], -1, patch, patch))
        sd[f"{name}.proj.bias"] = _t(p[name]["b"])
    for name in ("time_token", "t_embedder"):
        _mlp01(sd, f"{name}.mlp", p[name])
    _lin(sd, "final_layer.adaLN_modulation.1", p["final_ada"])
    _lin(sd, "final_layer.linear", p["final_linear"])
    return sd


def qwen_vl_vision_state_dict(p: Mapping, patch=(2, 14, 14)) -> StateDict:
    """JAX ``qwen_vl_vision_params_from_torch``'s tree -> the HF Qwen2.5-VL vision keys
    without the ``visual.`` prefix (the (C*T*P*P, D) patch matmul -> a bias-free Conv3d
    (D, C, T, P, P))."""
    w = np.asarray(p["patch_embed"]["w"])
    sd: StateDict = {"patch_embed.proj.weight": _t(w.T.reshape(w.shape[1], -1, *patch)),
                     "merger.ln_q.weight": _t(p["merger"]["ln_q"]["w"])}
    _lin(sd, "merger.mlp.0", p["merger"]["fc0"])
    _lin(sd, "merger.mlp.2", p["merger"]["fc2"])
    for i in range(np.asarray(p["blocks"]["norm1"]["w"]).shape[0]):
        b, pre = _layer(p["blocks"], i), f"blocks.{i}"
        sd[pre + ".norm1.weight"] = _t(b["norm1"]["w"])
        sd[pre + ".norm2.weight"] = _t(b["norm2"]["w"])
        _lin(sd, pre + ".attn.qkv", b["attn"]["qkv"])
        _lin(sd, pre + ".attn.proj", b["attn"]["proj"])
        for name in ("gate", "up", "down"):
            _lin(sd, f"{pre}.mlp.{name}_proj", b[name])
    return sd


FLUX_CONVERTERS = {
    "flux_dit": flux_dit_state_dict, "flux_controlnet": flux_controlnet_state_dict,
    "sd_vae_encoder": sd_vae_state_dict, "sd_vae_decoder": sd_vae_state_dict,
    "sd3_vae_encoder": sd_vae_state_dict, "sd3_vae_decoder": sd_vae_state_dict,
    "step1x_connector": step1x_connector_state_dict, "infiniteyou": infiniteyou_state_dict,
    "value_encoder": value_encoder_state_dict, "flux_lora_encoder": flux_lora_encoder_state_dict,
    "flux_ipadapter": flux_ipadapter_state_dict,
    "sd3_dit": sd3_dit_state_dict, "qwen_image_dit": qwen_image_dit_state_dict,
    "qwen_image_controlnet": qwen_image_controlnet_state_dict,
    "qwen_vl_text": qwen_vl_text_state_dict, "qwen_vl_vision": qwen_vl_vision_state_dict,
    "qwen_image_vae": vae_state_dict,
    "nexus_gen_heads": nexus_gen_heads_state_dict,
    "nexus_gen_adapter": nexus_gen_adapter_state_dict,
    "nexus_gen_merger": nexus_gen_merger_state_dict,
    "hunyuan_dit": hunyuan_dit_state_dict, "omnigen": omnigen_state_dict,
}


def params_from_jax(tree: Mapping, patch_size=(1, 2, 2)) -> Dict[str, StateDict]:
    """State dicts for every entry of the JAX pipeline's params tree."""
    out: Dict[str, StateDict] = {}
    for name, p in tree.items():
        if name in ("dit", "dit2"):
            out[name] = dit_state_dict(p, patch_size)
        elif name in ("controlnet", "controlnet2"):
            out[name] = controlnet_state_dict(p, patch_size)
        elif name == "t5":
            out[name] = t5_state_dict(p)
        elif name == "vae":
            out[name] = vae_state_dict(p)
        elif name == "vae38":
            out[name] = vae38_state_dict(p)
        elif name == "image_encoder":
            out[name] = vit_state_dict(p)
        elif name == "s2v":
            out[name] = s2v_state_dict(p, patch_size)
        elif name == "vace":
            out[name] = vace_state_dict(p, patch_size)
        elif name == "motion_controller":
            out[name] = motion_controller_state_dict(p)
        elif name == "camera_adapter":
            out[name] = camera_adapter_state_dict(p)
        elif name == "hunyuan_video_dit":
            out[name] = hunyuan_video_dit_state_dict(p, patch_size)
        elif name == "llama":
            out[name] = llama_state_dict(p)
        elif name == "clip_text":
            out[name] = clip_text_state_dict(p)
        elif name == "hunyuan_vae_encoder":
            out[name] = hunyuan_vae_encoder_state_dict(p)
        elif name == "hunyuan_vae_decoder":
            out[name] = hunyuan_vae_decoder_state_dict(p)
        elif name == "llava":
            out[name] = llava_state_dict(p)
        elif name == "cog_dit":
            out[name] = cog_dit_state_dict(p)
        elif name in ("cog_vae_encoder", "cog_vae_decoder"):
            out[name] = cog_vae_state_dict(p)
        elif name == "t5_v1_1":
            out[name] = t5_state_dict(p, shared_pos=True)
        elif name == "stepvideo_dit":
            out[name] = stepvideo_dit_state_dict(p)
        elif name == "stepvideo_vae":
            out[name] = stepvideo_vae_state_dict(p)
        elif name == "bert":
            out[name] = bert_state_dict(p)
        elif name == "step1":
            out[name] = step1_state_dict(p)
        elif name in FLUX_CONVERTERS:
            out[name] = FLUX_CONVERTERS[name](p)
        else:
            raise NotImplementedError(f"no converter for params[{name!r}]")
    return out


def lora_from_jax(tree: Mapping) -> Dict[str, Dict[str, torch.Tensor]]:
    """A JAX adapter tree (numpy leaves) as tensors of the same layout and dtype."""
    return {name: {k: _t(v) for k, v in ab.items()} for name, ab in tree.items()}
