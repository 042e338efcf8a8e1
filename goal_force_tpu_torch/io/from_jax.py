"""The JAX package's parameter tree (as numpy arrays) -> the port's state dicts.

``params_from_jax(tree)`` takes ``{dit, dit2, controlnet, controlnet2, t5, vae}`` (and
the adapters ``vace``, ``motion_controller``, ``camera_adapter`` where present) as
``GoalForcePipeline.init_random(...).params`` holds it in the JAX package (after
``tree_map(np.asarray, ...)``) and returns one reference-format state dict per entry:

  - stacked ``blocks`` leaves (leading layer axis) -> ``blocks.{i}.*``;
  - (in, out) linear weights -> torch's (out, in);
  - (C*pf*ph*pw, D) patch embeddings -> Conv3d (D, C, pf, ph, pw), feature order (c, dy, dx);
  - (kt, kh, kw, Cin, Cout) conv weights -> (Cout, Cin, kt, kh, kw), (kh, kw, Cin, Cout) ->
    (Cout, Cin, kh, kw);
  - stacked zero convs (L, in, out) -> ``controlnet_zero_convs_after.{i}`` Conv1d (out, in, 1);
  - the adapters: a DiT's Fun-Reference ``ref_conv`` -> Conv2d (D, z, 2, 2); ``vace`` ->
    ``vace_blocks.{i}`` (+ ``before_proj`` on block 0, ``after_proj`` on each) and
    ``vace_patch_embedding``; ``motion_controller`` -> ``linear.0/2/4``;
    ``camera_adapter`` (SimpleAdapter) -> ``conv`` and ``residual_blocks.{i}.conv1/2``;
  - int8 / fp8 packs ``{"w_i8"|"w_f8", "w_scale", "b"}`` (``quantize_linear_tree[_fp8]``)
    -> ``weight`` codes (out, in), ``weight_scale`` (out,) and ``bias``, the state dict
    of ``ops/quant.py``'s ``Int8Linear`` / ``Fp8Linear``; the codes are carried, not
    re-quantized.

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


def _block(sd: StateDict, prefix: str, p: Mapping) -> None:
    for name in ("self_attn", "cross_attn"):
        a = p[name]
        for proj in ("q", "k", "v", "o"):
            _lin(sd, f"{prefix}.{name}.{proj}", a[proj])
        sd[f"{prefix}.{name}.norm_q.weight"] = _t(a["norm_q"]["w"])
        sd[f"{prefix}.{name}.norm_k.weight"] = _t(a["norm_k"]["w"])
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


def t5_state_dict(p: Mapping) -> StateDict:
    sd: StateDict = {"token_embedding.weight": _t(p["token_embedding"]),
                     "norm.weight": _t(p["norm"]["w"])}
    blocks = p["blocks"]
    for i in range(int(np.asarray(blocks["norm1"]["w"]).shape[0])):
        b, pre = _layer(blocks, i), f"blocks.{i}"
        sd[f"{pre}.norm1.weight"] = _t(b["norm1"]["w"])
        sd[f"{pre}.norm2.weight"] = _t(b["norm2"]["w"])
        for proj in ("q", "k", "v", "o"):
            _lin(sd, f"{pre}.attn.{proj}", b["attn"][proj], bias=False)
        _lin(sd, f"{pre}.ffn.gate.0", b["ffn"]["gate"], bias=False)
        _lin(sd, f"{pre}.ffn.fc1", b["ffn"]["fc1"], bias=False)
        _lin(sd, f"{pre}.ffn.fc2", b["ffn"]["fc2"], bias=False)
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
        elif name == "vace":
            out[name] = vace_state_dict(p, patch_size)
        elif name == "motion_controller":
            out[name] = motion_controller_state_dict(p)
        elif name == "camera_adapter":
            out[name] = camera_adapter_state_dict(p)
        else:
            raise NotImplementedError(f"no converter for params[{name!r}]")
    return out


def lora_from_jax(tree: Mapping) -> Dict[str, Dict[str, torch.Tensor]]:
    """A JAX adapter tree (numpy leaves) as tensors of the same layout and dtype."""
    return {name: {k: _t(v) for k, v in ab.items()} for name, ab in tree.items()}
