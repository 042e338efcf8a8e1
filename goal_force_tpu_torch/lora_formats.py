"""LoRA format converters: the kohya / civitai and PEFT / diffsynth namings, and the
fusing of dense deltas into reference-format state dicts before a model is loaded.

Port of ``goal_force_tpu/lora_formats.py`` over torch state dicts (tensors in, tensors
out):

  - ``civitai_lora_deltas``: kohya ``lora_up`` / ``lora_down`` pairs (the key flattened
    with ``_``, undone by the SD / SDXL / Flux special-key tables) or PEFT ``lora_A`` /
    ``lora_B`` pairs -> {model key: alpha * up @ down}, each product in float32 (a 1x1
    conv LoRA squeezed, multiplied and unsqueezed);
  - ``fuse_deltas``: W += delta for every key the state dict has, in W's dtype;
  - ``flux_lora_to_kohya`` / ``flux_lora_from_kohya``: the diffsynth PEFT Flux keys and
    kohya's double / single block keys, with a per-pair ``alpha`` scalar on the way out;
  - ``fuse_flux_lora``: a Flux LoRA in either format fused into a diffsynth FluxDiT
    state dict.

The fused state dict loads through the port's loaders (``io/auto.py::load_model``), so
every family takes LoRA weights without code of its own.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

SD_SPECIAL_KEYS = {
    "down.blocks": "down_blocks",
    "up.blocks": "up_blocks",
    "mid.block": "mid_block",
    "proj.in": "proj_in",
    "proj.out": "proj_out",
    "transformer.blocks": "transformer_blocks",
    "to.q": "to_q",
    "to.k": "to_k",
    "to.v": "to_v",
    "to.out": "to_out",
    "text.model": "text_model",
    "self.attn.q.proj": "self_attn.q_proj",
    "self.attn.k.proj": "self_attn.k_proj",
    "self.attn.v.proj": "self_attn.v_proj",
    "self.attn.out.proj": "self_attn.out_proj",
    "input.blocks": "model.diffusion_model.input_blocks",
    "middle.block": "model.diffusion_model.middle_block",
    "output.blocks": "model.diffusion_model.output_blocks",
}

SDXL_SPECIAL_KEYS = dict(SD_SPECIAL_KEYS)
SDXL_SPECIAL_KEYS.update({
    "text.model": "conditioner.embedders.0.transformer.text_model",
    "2conditioner.embedders.0.transformer.text_model.encoder.layers":
        "text_model.encoder.layers",
})

FLUX_SPECIAL_KEYS = {
    "single.blocks": "single_blocks",
    "double.blocks": "double_blocks",
    "img.attn": "img_attn",
    "img.mlp": "img_mlp",
    "img.mod": "img_mod",
    "txt.attn": "txt_attn",
    "txt.mlp": "txt_mlp",
    "txt.mod": "txt_mod",
}


def civitai_lora_deltas(lora_sd: Mapping[str, torch.Tensor],
                        lora_prefix: str = "lora_unet_",
                        alpha: float = 1.0,
                        special_keys: Optional[Dict[str, str]] = None,
                        renamed_prefix: str = "") -> Dict[str, torch.Tensor]:
    """kohya (``lora_up`` / ``lora_down``) or PEFT (``lora_A`` / ``lora_B``) state dict
    -> {model key: dense float32 delta}."""
    if any(".lora_up" in k for k in lora_sd):
        return _deltas_up_down(lora_sd, lora_prefix, alpha, special_keys or {},
                               renamed_prefix)
    return _deltas_ab(lora_sd, lora_prefix, alpha)


def _mm(up: torch.Tensor, down: torch.Tensor, alpha: float) -> torch.Tensor:
    up, down = torch.as_tensor(up), torch.as_tensor(down)
    if up.dim() == 4:   # a 1x1 conv LoRA
        return (alpha * (up[..., 0, 0].float() @ down[..., 0, 0].float()))[..., None, None]
    return alpha * (up.float() @ down.float())


def _deltas_up_down(lora_sd, lora_prefix, alpha, special_keys, renamed_prefix):
    out = {}
    for key in lora_sd:
        if ".lora_up" not in key or not key.startswith(lora_prefix):
            continue
        down = lora_sd[key.replace(".lora_up", ".lora_down")]
        target = (key.split(".")[0].replace(lora_prefix, renamed_prefix)
                  .replace("_", ".") + ".weight")
        for sk, repl in special_keys.items():
            target = target.replace(sk, repl)
        out[target] = _mm(lora_sd[key], down, alpha)
    return out


def _deltas_ab(lora_sd, lora_prefix, alpha):
    out = {}
    for key in lora_sd:
        if ".lora_B." not in key or not key.startswith(lora_prefix):
            continue
        down = lora_sd[key.replace(".lora_B.", ".lora_A.")]
        keys = key.split(".")
        keys.pop(keys.index("lora_B"))
        out[".".join(keys)[len(lora_prefix):]] = _mm(lora_sd[key], down, alpha)
    return out


def fuse_deltas(sd: Dict[str, torch.Tensor], deltas: Mapping[str, torch.Tensor]) -> int:
    """W += delta for every key `sd` has (in W's dtype); returns the number of tensors
    updated. Delta keys `sd` lacks are left alone, so a caller can try several
    namings."""
    n = 0
    for name, delta in deltas.items():
        if name in sd:
            base = torch.as_tensor(sd[name])
            sd[name] = base + torch.as_tensor(delta).reshape(base.shape).to(base.dtype)
            n += 1
    return n


# ---------------------------------------------------------------------------
# Flux: kohya <-> diffsynth PEFT
# ---------------------------------------------------------------------------

_FLUX_MIDDLE = {
    "norm.linear": "modulation_lin",
    "to_qkv_mlp": "linear1",
    "proj_out": "linear2",
    "norm1_a.linear": "img_mod_lin",
    "norm1_b.linear": "txt_mod_lin",
    "attn.a_to_qkv": "img_attn_qkv",
    "attn.b_to_qkv": "txt_attn_qkv",
    "attn.a_to_out": "img_attn_proj",
    "attn.b_to_out": "txt_attn_proj",
    "ff_a.0": "img_mlp_0",
    "ff_a.2": "img_mlp_2",
    "ff_b.0": "txt_mlp_0",
    "ff_b.2": "txt_mlp_2",
}
_FLUX_MIDDLE_INV = {v: k for k, v in _FLUX_MIDDLE.items()}


def flux_lora_to_kohya(state_dict: Mapping[str, torch.Tensor],
                       alpha: Optional[float] = None) -> Dict[str, torch.Tensor]:
    """diffsynth PEFT Flux LoRA keys -> kohya's, with an ``alpha`` scalar per pair (the
    rank unless given)."""
    prefix_rename = {"single_blocks": "lora_unet_single_blocks",
                     "blocks": "lora_unet_double_blocks"}
    suffix_rename = {"lora_B.weight": "lora_up.weight",
                     "lora_A.weight": "lora_down.weight"}
    out = {}
    for name, param in state_dict.items():
        names = name.split(".")
        if names[-2] != "lora_A" and names[-2] != "lora_B":
            names.pop(-2)  # the PEFT adapter's name
        prefix, block_id = names[0], names[1]
        middle = ".".join(names[2:-2])
        suffix = ".".join(names[-2:])
        if middle not in _FLUX_MIDDLE or prefix not in prefix_rename:
            continue
        rename = (prefix_rename[prefix] + "_" + block_id + "_"
                  + _FLUX_MIDDLE[middle] + "." + suffix_rename[suffix])
        out[rename] = torch.as_tensor(param)
        if rename.endswith("lora_up.weight"):
            lora_alpha = alpha if alpha is not None else param.shape[-1]
            out[rename.replace("lora_up.weight", "alpha")] = torch.tensor(
                float(lora_alpha), dtype=torch.float32)
    return out


def flux_lora_from_kohya(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """kohya Flux LoRA keys -> diffsynth PEFT keys; other keys pass through."""
    updown = {"lora_down": "lora_A", "lora_up": "lora_B"}
    out = {}
    for name, param in state_dict.items():
        parsed = _parse_kohya_flux(name)
        if parsed is None:
            out[name] = torch.as_tensor(param)
            continue
        stream, block_id, middle, ud = parsed
        prefix = "single_blocks" if stream == "single" else "blocks"
        out[f"{prefix}.{block_id}.{_FLUX_MIDDLE_INV[middle]}."
            f"{updown[ud]}.default.weight"] = torch.as_tensor(param)
    return out


def _parse_kohya_flux(name: str):
    for stream in ("single", "double"):
        pre = f"lora_unet_{stream}_blocks_"
        if not name.startswith(pre):
            continue
        block_id, _, tail = name[len(pre):].partition("_")
        if not block_id.isdigit():
            continue
        middle, _, suffix = tail.partition(".")
        if suffix.startswith("lora_down"):
            return stream, block_id, middle, "lora_down"
        if suffix.startswith("lora_up"):
            return stream, block_id, middle, "lora_up"
    return None


def fuse_flux_lora(sd: Dict[str, torch.Tensor], lora_sd: Mapping[str, torch.Tensor],
                   alpha: float = 1.0) -> int:
    """Fuse a Flux LoRA (kohya or diffsynth PEFT) into a diffsynth FluxDiT state dict;
    returns the number of tensors updated."""
    if any(_parse_kohya_flux(k) for k in lora_sd):
        lora_sd = flux_lora_from_kohya(lora_sd)
    lora_sd = {k.replace(".default.", "."): v for k, v in lora_sd.items()}
    return fuse_deltas(sd, _deltas_ab(lora_sd, "", alpha))
