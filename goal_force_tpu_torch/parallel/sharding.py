"""Tensor-parallel placement of the DiT and ControlNet parameters.

Port of ``goal_force_tpu/parallel/sharding.py``'s inference half
(``inference_param_specs``, ``place``; its training half, ``fsdp_specs``, is in
``parallel/fsdp.py``). A spec is one entry per dimension of the parameter: "tp" where the
dimension is split over the tensor axis, None where it is whole. The rules are JAX's,
matched on the JAX leaf names through the names of the port (torch's (out, in) weights):

  column-parallel (the output dimension split): q, k, v of self- and cross-attention,
  and every ``fc0`` -- the FFN's ``ffn.0``, and, as JAX's name match also takes them, the
  text, time and image embeddings' first linears;
  row-parallel (the input dimension split): o, and every ``fc2`` (``ffn.2`` and the
  embeddings' second linears).

Every other parameter is replicated; so are all biases and the q/k RMSNorm weights,
which JAX's names do not match either: the forward takes this rank's columns of a
replicated column bias or norm weight, and adds a row-parallel bias after the sum. With
a mesh, a spec whose split dimension does not divide by the axis is replicated, as JAX's
``_divisible`` falls back.

``place`` replaces each split parameter by this rank's slice and marks it (``TP_SPLIT``:
the split dimension, the axis size and the rank), which the forward functions read
under a mesh.

On a mesh with a "pp" axis (pipeline parallel), JAX also pins the stacked layer axis of
the main DiT's blocks to "pp" where the axis divides the layers, not the ControlNet's
(``inference_param_specs``, JAX ``sharding.py:58-82``): block i lives on stage
i // (L / pp). The port's blocks are modules of their own, so such a spec is a
``StageSpec``, the dimensions' spec with the stage that holds the parameter; ``place``
keeps it (with its "tp" slice) on that stage's ranks only and leaves it without storage
elsewhere (``PP_STAGE`` on the block names the stage, and ``run_blocks`` refuses a block
of another stage).
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from goal_force_tpu_torch.parallel.mesh import axis_sizes

Spec = Tuple[Optional[str], ...]

TP_SPLIT = "_gf_tp_split"
PP_STAGE = "_gf_pp_stage"    # on a block pinned to one pipeline stage: that stage


class StageSpec(tuple):
    """The spec of a parameter that lives on one pipeline stage only: one entry per
    dimension, as any spec, and ``stage``, the index along "pp" of the ranks that hold
    it (JAX's "pp" on the stacked layer axis)."""

    def __new__(cls, dims, stage: int):
        spec = super().__new__(cls, dims)
        spec.stage = stage
        return spec


_BLOCK = re.compile(r"^blocks\.(\d+)\.")


def pp_stage(module: nn.Module, name: str, sizes: Dict[str, int]) -> Optional[int]:
    """The pipeline stage that holds parameter `name` of `module` on a mesh of `sizes`:
    for a block of a main DiT (``WanDiT``; JAX's pipelined "dit" trees) where "pp" > 1
    divides the layers, its block's index // (L / pp); None elsewhere."""
    from goal_force_tpu_torch.models.wan_dit import WanDiT

    pp = sizes.get("pp", 1)
    m = _BLOCK.match(name)
    if pp == 1 or m is None or not isinstance(module, WanDiT) or len(module.blocks) % pp:
        return None
    return int(m.group(1)) // (len(module.blocks) // pp)


def drop_storage(t: torch.Tensor) -> torch.Tensor:
    """An empty tensor of t's dtype and device: what a rank keeps of a parameter that
    another pipeline stage holds."""
    return t.new_empty((0,))

_EMBED = r"(text_embedding|time_embedding)"
_COLUMN = re.compile(rf"(\.(q|k|v)|(^|\.)ffn\.0|(^|\.){_EMBED}\.0|(^|\.)img_emb\.proj\.1)\.weight$")
_ROW = re.compile(rf"(\.o|(^|\.)ffn\.2|(^|\.){_EMBED}\.2|(^|\.)img_emb\.proj\.3)\.weight$")


def leaf_spec(name: str, ndim: int) -> Spec:
    """The tensor-parallel spec of one DiT/ControlNet parameter by its name."""
    spec = [None] * ndim
    if ndim == 2 and _COLUMN.search(name):
        spec[0] = "tp"
    elif ndim == 2 and _ROW.search(name):
        spec[1] = "tp"
    return tuple(spec)


def _divisible(spec: Spec, shape, sizes: Dict[str, int]) -> Spec:
    for d, axis in enumerate(spec):
        if axis is not None and shape[d] % sizes[axis] != 0:
            return (None,) * len(spec)
    return spec


def inference_param_specs(module: nn.Module, mesh=None) -> Dict[str, Spec]:
    """{parameter name: spec} of a DiT or ControlNet module; with `mesh`, specs that do
    not divide fall back to replicated, and on a "pp" axis a main DiT's blocks take
    ``StageSpec``s."""
    sizes = axis_sizes(mesh) if mesh is not None else None
    out = {}
    for name, p in module.named_parameters():
        spec = leaf_spec(name, p.ndim)
        if sizes is not None:
            spec = _divisible(spec, p.shape, sizes)
            stage = pp_stage(module, name, sizes)
            if stage is not None:
                spec = StageSpec(spec, stage)
        out[name] = spec
    return out


def mark_stage(module: nn.Module, name: str, stage: int) -> None:
    """Mark the block of parameter `name` ("blocks.<i>. ...") as held by `stage`."""
    owner = module.get_submodule(_BLOCK.match(name).group(0)[:-1])
    owner.__dict__[PP_STAGE] = stage


@torch.no_grad()
def place(module: nn.Module, mesh, specs: Optional[Dict[str, Spec]] = None) -> nn.Module:
    """Keep this rank's slice of every split parameter of `module` (in the memory it
    is in; a slice is a copy, so the whole tensor is freed) and mark it with its split.
    A parameter placed for the same split stays as it is (the host stager's pairs and
    the pipeline's models share modules); one placed over an axis of one holds the
    whole tensor and takes the new split; one that holds a slice of another split
    raises ValueError. W8A8/fp8 packs (``ops/quant.py``) split as JAX splits theirs: a
    column-parallel pack its codes' rows and its per-output scales, a row-parallel pack
    its codes' columns only (each output's scale is the amax over its whole input row);
    the pack module carries the mark. Returns the module."""
    from goal_force_tpu_torch.ops.quant import QuantLinear

    specs = inference_param_specs(module, mesh) if specs is None else specs
    sizes = axis_sizes(mesh)
    packs = {n: m for n, m in module.named_modules() if isinstance(m, QuantLinear)}
    mine = mesh.get_local_rank("pp") if sizes.get("pp", 1) > 1 else 0

    def elsewhere(name, stage):
        """True where another stage holds the parameter (its block marked)."""
        if stage is None:
            return False
        mark_stage(module, name, stage)
        return stage != mine

    def split_of(spec):
        dims = [d for d, axis in enumerate(spec) if axis is not None]
        if not dims:
            return None
        axis = spec[dims[0]]
        return (dims[0], sizes[axis], mesh.get_local_rank(axis))

    def settle(name, placed, split):
        """True where the tensor needs no new slice."""
        if placed == split:
            return True
        if placed is not None and placed[1] > 1:
            raise ValueError(f"{name} holds rank {placed[2]}'s slice of {placed[1]} along "
                             f"dim {placed[0]}, not the split {split}: place a module "
                             "that holds whole tensors")
        return False

    for name, p in module.named_parameters():
        if elsewhere(name, getattr(specs[name], "stage", None)):
            p.data = drop_storage(p.data)
            continue
        split = split_of(specs[name])
        if settle(name, getattr(p, TP_SPLIT, None), split):
            continue
        if split is None:
            delattr(p, TP_SPLIT)
            continue
        d, n, rank = split
        if n > 1:
            per = p.shape[d] // n
            p.data = p.data.narrow(d, rank * per, per).clone()
        setattr(p, TP_SPLIT, split)
    for prefix, pack in packs.items():
        name = f"{prefix}.weight"
        if elsewhere(name, pp_stage(module, name, sizes)):
            pack.weight, pack.weight_scale = drop_storage(pack.weight), drop_storage(pack.weight_scale)
            continue
        spec = _divisible(leaf_spec(name, 2), pack.weight.shape, sizes)
        split = split_of(spec)
        if settle(name, getattr(pack, TP_SPLIT, None), split):
            continue
        if split is not None and split[1] > 1:
            d, n, rank = split
            per = pack.weight.shape[d] // n
            pack.weight = pack.weight.narrow(d, rank * per, per).clone()
            if d == 0:
                pack.weight_scale = pack.weight_scale.narrow(0, rank * per, per).clone()
        setattr(pack, TP_SPLIT, split)
    return module


def tp_dim(layer) -> Optional[int]:
    """The split dimension of a placed linear's weight (or pack) under the ambient
    mesh."""
    from goal_force_tpu_torch.parallel.mesh import current_mesh

    if current_mesh() is None:
        return None
    split = getattr(layer, TP_SPLIT, None) or getattr(layer.weight, TP_SPLIT, None)
    return None if split is None else split[0]
