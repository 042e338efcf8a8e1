"""The SD / SDXL IP-Adapter (image prompt), wired into a UNet's block plan.

Port of ``goal_force_tpu/models/ipadapter.py``:

  - the image projection: a linear from the CLIP image embedding to tokens x ctx, then
    ``models/flux_adapters.py::image_tokens`` (the batch folded into tokens, a LayerNorm
    at eps 1e-5; the Flux projection shares it);
  - one (``to_k_ip``, ``to_v_ip``) pair per cross-attention transformer unit: in the
    attention the same queries also attend over these image keys, and the result, scaled,
    is added before the output projection (``models/sd_unet.py::_attention``);
  - ``attn_unit_schedule``: the units of a plan in the reference's module order, the
    down units, then the up units, then the mid units LAST; ``ip_plan_assignments`` maps
    module ids onto (plan index, depth); ``sdxl_less_adapter_ids`` keeps ids 34..43
    (SDXL's "less" adapter).

``SDIpAdapter`` holds the reference names (``ipadapter_modules.{i}.to_{k,v}_ip``,
``image_proj.proj``, ``image_proj.norm``); ``ipadapter_from_state_dict`` reads them
strictly, or the raw diffusers bundle {"ip_adapter": {"{2i+1}.to_k_ip.weight", ...},
"image_proj": {...}} after ``flatten_diffusers_bundle``.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import torch
from torch import nn

from goal_force_tpu_torch.models.flux_adapters import IpAdapterModule, _load, image_tokens
from goal_force_tpu_torch.models.sd_unet import _depth, linear, normal_init_
from goal_force_tpu_torch.models.wan_dit import LayerNormAffine, empty_module


# ---------------------------------------------------------------------------
# Plan schedule: which attention units exist, in checkpoint module order
# ---------------------------------------------------------------------------

def attn_unit_schedule(plan: Sequence[Tuple]) -> List[Tuple[int, int]]:
    """[(plan index, depth index), ...] of a plan's cross-attention transformer units in
    the reference's checkpoint order: down units, up units, then mid units. A unit's
    position in the list is its adapter module id."""
    first_pop = next(i for i, s in enumerate(plan) if s[0] == "pop")
    last_push = max(i for i, s in enumerate(plan) if s[0] == "push")
    downs, mids, ups = [], [], []
    for i, spec in enumerate(plan):
        if spec[0] != "attn":
            continue
        units = [(i, d) for d in range(_depth(spec))]
        if i < last_push:
            downs += units
        elif i < first_pop:
            mids += units
        else:
            ups += units
    return downs + ups + mids


def ip_plan_assignments(plan: Sequence[Tuple], module_ids: Sequence[int] = None
                        ) -> Dict[int, Dict[int, int]]:
    """{plan index: {depth index: module id}} for the selected module ids (all by
    default)."""
    sched = attn_unit_schedule(plan)
    keep = set(range(len(sched))) if module_ids is None else set(module_ids)
    out: Dict[int, Dict[int, int]] = {}
    for j, (pi, di) in enumerate(sched):
        if j in keep:
            out.setdefault(pi, {})[di] = j
    return out


def sdxl_less_adapter_ids(plan: Sequence[Tuple]) -> List[int]:
    """The reference's ``set_less_adapter``: checkpoint ids 34..43 (SDXL's second
    up-level attention block's units)."""
    return list(range(34, 44))


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class ImageProjModel(nn.Module):
    def __init__(self, clip_dim: int, ctx_dim: int, tokens: int):
        super().__init__()
        self.proj = nn.Linear(clip_dim, tokens * ctx_dim)
        self.norm = LayerNormAffine(ctx_dim)


class SDIpAdapter(nn.Module):
    """One K/V module per attention unit (out_dims: each unit's width, in module order)
    over the projected image embedding."""

    def __init__(self, out_dims: Sequence[int], ctx_dim: int, clip_dim: int, tokens: int = 4):
        super().__init__()
        self.ipadapter_modules = nn.ModuleList(IpAdapterModule(ctx_dim, d) for d in out_dims)
        self.image_proj = ImageProjModel(clip_dim, ctx_dim, tokens)


def ip_image_proj_apply(p: ImageProjModel, image_embeds: torch.Tensor) -> torch.Tensor:
    """(B, clip_dim) -> (1, B·tokens, ctx_dim) image prompt tokens."""
    return image_tokens(p.norm, linear(p.proj, image_embeds))


def ip_adapter_apply(model: SDIpAdapter, image_embeds: torch.Tensor,
                     scale: float = 1.0) -> List[Dict]:
    """[{"k": (1, T, out), "v": (1, T, out), "scale": s}, ...] in module order."""
    tokens = ip_image_proj_apply(model.image_proj, image_embeds)
    return [{"k": linear(m.to_k_ip, tokens), "v": linear(m.to_v_ip, tokens), "scale": scale}
            for m in model.ipadapter_modules]


def ipadapter_kwargs_for_plan(plan: Sequence[Tuple], model: SDIpAdapter,
                              image_embeds: torch.Tensor, scale: float = 1.0,
                              module_ids: Sequence[int] = None) -> Dict:
    """{plan index: {depth: {"k", "v", "scale"}}} for ``sd_unet_apply(ipadapter=)``."""
    kvs = ip_adapter_apply(model, image_embeds, scale)
    return {pi: {di: kvs[j] for di, j in dm.items()}
            for pi, dm in ip_plan_assignments(plan, module_ids).items()}


# ---------------------------------------------------------------------------
# Loading and random weights
# ---------------------------------------------------------------------------

def flatten_diffusers_bundle(sd: Mapping) -> Dict[str, torch.Tensor]:
    """The raw diffusers two-dict bundle -> the reference names: module ``{2i+1}`` of
    "ip_adapter" is ``ipadapter_modules.{i}``, "image_proj" goes under ``image_proj.``."""
    flat = {}
    for name, w in sd["ip_adapter"].items():
        head, rest = name.split(".", 1)
        flat[f"ipadapter_modules.{int(head) // 2}.{rest}"] = torch.as_tensor(w)
    for name, w in sd["image_proj"].items():
        flat["image_proj." + name] = torch.as_tensor(w)
    return flat


def ipadapter_from_state_dict(sd: Mapping[str, torch.Tensor], dtype=None,
                              device=None) -> SDIpAdapter:
    """An ``SDIpAdapter`` read strictly from the reference names (or a diffusers bundle),
    its sizes from the shapes, in `dtype` on `device` (default: the file's)."""
    if "ip_adapter" in sd:
        sd = flatten_diffusers_bundle(sd)
    n = 0
    while f"ipadapter_modules.{n}.to_k_ip.weight" in sd:
        n += 1
    dims = [sd[f"ipadapter_modules.{i}.to_k_ip.weight"].shape[0] for i in range(n)]
    ctx = sd["image_proj.norm.weight"].shape[0]
    out, clip_dim = sd["image_proj.proj.weight"].shape
    return _load(SDIpAdapter, dict(sd), "ipadapter", dims, ctx, clip_dim, out // ctx,
                 dtype=dtype, device=device)


def init_ip_adapter(plan: Sequence[Tuple], ctx_dim: int, clip_dim: int,
                    gen: torch.Generator, tokens: int = 4, dtype=torch.float32, *,
                    device) -> SDIpAdapter:
    """An adapter sized to a block plan with JAX ``init_ip_adapter``'s distributions
    (N(0, 0.02²) weights, zero bias, a unit LayerNorm)."""
    dims = [plan[pi][3] for pi, _ in attn_unit_schedule(plan)]
    model = empty_module(SDIpAdapter, dims, ctx_dim, clip_dim, tokens, dtype=dtype,
                         device=device)
    return normal_init_(model, gen)
