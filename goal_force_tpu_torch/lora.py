"""LoRA adapters on the DiT's block linears: init, merge, and PEFT-format checkpoints.

Port of ``goal_force_tpu/lora.py``. The adapters keep the JAX package's tree,
``{target: {"a": (L, in, r), "b": (L, r, out)}}`` in float32, one stacked pair per
target linear over the L blocks, so a JAX adapter tree (``io/from_jax.py``) and a PEFT
checkpoint map onto it directly. A merged weight is ``W + (alpha / r) * A @ B`` cast to
W's dtype (torch's (out, in) layout takes the transpose): with bf16 base weights the
cast rounds away a delta under half an ulp of W, as it does in the JAX package.

Training never merges the whole tree: ``merged_block`` builds one block's merged
weights inside that block's remat region (``wan_dit.run_blocks(block_weights=...)``),
so one block's merged weights are alive at a time and the backward recomputes them.
"""

from __future__ import annotations

import copy
import re
from typing import Dict, Mapping, Optional, Sequence

import torch

from goal_force_tpu_torch.models.wan_dit import WanBlock, WanDiT

Adapters = Dict[str, Dict[str, torch.Tensor]]

# target name -> (group, linear) under a DiT block; the reference's target module
# names, and the module path that PEFT keys name (blocks.{i}.{group}.{linear}).
TARGETS = {
    "q": ("self_attn", "q"),
    "k": ("self_attn", "k"),
    "v": ("self_attn", "v"),
    "o": ("self_attn", "o"),
    "cross_q": ("cross_attn", "q"),
    "cross_k": ("cross_attn", "k"),
    "cross_v": ("cross_attn", "v"),
    "cross_o": ("cross_attn", "o"),
    "ffn.0": ("ffn", "0"),
    "ffn.2": ("ffn", "2"),
}
DEFAULT_TARGETS = ("q", "k", "v", "o", "ffn.0", "ffn.2")


def _linear(blk: WanBlock, target: str) -> torch.nn.Linear:
    grp, leaf = TARGETS[target]
    layer = blk.get_submodule(f"{grp}.{leaf}")
    if type(layer) is not torch.nn.Linear:
        raise TypeError(f"LoRA needs a plain nn.Linear at {grp}.{leaf}, found "
                        f"{type(layer).__name__}")
    return layer


def init_lora(gen: torch.Generator, dit: WanDiT, rank: int = 32,
              targets: Sequence[str] = DEFAULT_TARGETS, dtype=torch.float32) -> Adapters:
    """A ~ N(0, 1) / rank, B = 0 (the merged DiT starts as the base), drawn from `gen`
    target by target on its device: {target: {"a": (L, in, r), "b": (L, r, out)}}."""
    out = {}
    n_layers = len(dit.blocks)
    for name in targets:
        d_out, d_in = _linear(dit.blocks[0], name).weight.shape
        a = torch.randn((n_layers, d_in, rank), generator=gen, device=gen.device) / rank
        out[name] = {"a": a.to(dtype),
                     "b": torch.zeros((n_layers, rank, d_out), dtype=dtype, device=gen.device)}
    return out


def lora_rank(lora: Adapters) -> int:
    return next(iter(lora.values()))["a"].shape[-1]


def merged_weight(weight: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """W (out, in) + (scale * a @ b) cast to W's dtype, transposed to (out, in)."""
    return weight + ((a @ b) * scale).to(weight.dtype).T


class _Linear:
    """A weight and bias that ``wan_dit.linear`` reads like an ``nn.Linear``."""

    def __init__(self, weight, bias):
        self.weight, self.bias = weight, bias


class _View:
    """A module's attributes and items, some of them replaced."""

    def __init__(self, module, replaced: Dict):
        self._module, self._replaced = module, replaced

    def __getattr__(self, name):
        return self._replaced[name] if name in self._replaced else getattr(self._module, name)

    def __getitem__(self, i):
        return self._replaced[str(i)] if str(i) in self._replaced else self._module[i]


def merged_block(blk: WanBlock, lora: Adapters, i: int, alpha: Optional[float] = None,
                 rank: Optional[int] = None):
    """DiT block i with its adapters merged (what ``dit_block`` reads); the block itself
    is unchanged. alpha defaults to the rank (scale 1)."""
    r = rank or lora_rank(lora)
    scale = (alpha or r) / r
    groups: Dict[str, Dict] = {}
    for name, ab in lora.items():
        grp, leaf = TARGETS[name]
        layer = _linear(blk, name)
        groups.setdefault(grp, {})[leaf] = _Linear(
            merged_weight(layer.weight, ab["a"][i], ab["b"][i], scale), layer.bias)
    return _View(blk, {g: _View(getattr(blk, g), leaves) for g, leaves in groups.items()})


@torch.no_grad()
def merge_lora(dit: WanDiT, lora: Adapters, alpha: float = 1.0,
               rank: Optional[int] = None) -> WanDiT:
    """A copy of `dit` with W += (alpha / r) * A @ B fused into every target (the
    reference loader's semantics; alpha 1.0 as in the JAX function)."""
    out = copy.deepcopy(dit)
    for name, ab in lora.items():
        r = rank or ab["a"].shape[-1]
        for i, blk in enumerate(out.blocks):
            layer = _linear(blk, name)
            layer.weight.copy_(merged_weight(layer.weight, ab["a"][i].to(layer.weight.device),
                                             ab["b"][i].to(layer.weight.device), alpha / r))
    return out


# ---------------------------------------------------------------------------
# PEFT checkpoints
# ---------------------------------------------------------------------------

_KEY_RE = re.compile(
    r"blocks\.(\d+)\.(self_attn|cross_attn|ffn)\.(q|k|v|o|0|2)\.lora_(A|B)(?:\.default)?\.weight$")


def lora_from_peft(sd: Mapping[str, torch.Tensor], num_layers: int,
                   dtype=torch.float32) -> Adapters:
    """PEFT ``lora_A``/``lora_B`` keys (with or without ``.default``, with or without a
    leading ``diffusion_model.``) -> the stacked adapter tree. PEFT's lora_A (r, in)
    and lora_B (out, r) become a (in, r) and b (r, out); other keys are ignored."""
    per_target: Dict[str, Dict[int, Dict[str, torch.Tensor]]] = {}
    for key, val in sd.items():
        k = key[len("diffusion_model."):] if key.startswith("diffusion_model.") else key
        m = _KEY_RE.search(k)
        if not m:
            continue
        layer, grp, leaf, ab = int(m.group(1)), m.group(2), m.group(3), m.group(4)
        name = {"ffn": f"ffn.{leaf}", "self_attn": leaf}.get(grp, f"cross_{leaf}")
        per_target.setdefault(name, {}).setdefault(layer, {})[ab] = torch.as_tensor(val)
    return {name: {"a": torch.stack([layers[i]["A"].T for i in range(num_layers)]).to(dtype),
                   "b": torch.stack([layers[i]["B"].T for i in range(num_layers)]).to(dtype)}
            for name, layers in per_target.items()}


def lora_to_peft(lora: Adapters, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The adapter tree as PEFT keys, ``{prefix}blocks.{i}.{group}.{linear}.lora_A.
    default.weight`` (r, in) and ``lora_B.default.weight`` (out, r), float32 on the CPU."""
    out = {}
    for name, ab in lora.items():
        grp, leaf = TARGETS[name]
        a = ab["a"].detach().to("cpu", torch.float32)
        b = ab["b"].detach().to("cpu", torch.float32)
        for i in range(a.shape[0]):
            base = f"{prefix}blocks.{i}.{grp}.{leaf}"
            out[f"{base}.lora_A.default.weight"] = a[i].T.contiguous()
            out[f"{base}.lora_B.default.weight"] = b[i].T.contiguous()
    return out

