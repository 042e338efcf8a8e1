"""FSDP placement of the training state: ``fsdp_specs`` and the gathered views.

Port of ``goal_force_tpu/parallel/sharding.py::fsdp_specs`` and of what GSPMD does with
its specs inside the jitted train step, without DTensor and without
``torch.distributed.fsdp``:

- ``fsdp_specs(module, mesh)``: JAX's rules, as a pure function of each parameter's name,
  shape and the axis sizes. JAX applies them to its own leaves (stacked blocks with a
  leading layer axis, (in, out) linears, (C*pf*ph*pw, D) patch embeddings); the port's
  modules are per block and hold torch's layouts, so each parameter is first read as
  the JAX leaf it comes from (``jax_leaf``), the rule picks a JAX dimension, and the spec
  names the port's dimension it maps to. A leaf under ``min_size`` elements stays
  replicated, as does a kernel of 4 or more dimensions and every ``modulation``; a
  stacked block's layer axis is never split; the largest other dimension is split over
  ("dp", "sp") where that group's size divides it, else the leaf stays replicated.
- ``place_fsdp(module, mesh, specs)``: each rank keeps its slice of every split
  parameter (the parameter object stays, its data becomes the slice); the splits are
  recorded on the owning submodules (``FSDP``: (dim or None, group size, rank, axes)),
  so a deep copy keeps them.
- ``gathered(*modules, skip=())``: what the forward functions read in place of a placed
  module: one all-gather over the ("dp", "sp") group rebuilds the whole of every split
  parameter of the modules (their submodules under `skip` excepted), in one flat buffer
  per dtype. Under grad the gather's backward reduce-scatters the gradient back to the
  shards, summed over the group. The callers gather a block inside its checkpoint, so
  the recompute gathers again and one block's whole weights are alive at a time. In the
  same view the tensor-parallel linears of a DiT block (``sharding.leaf_spec``) hold
  this rank's "tp" slice, marked as ``sharding.place`` marks a stored one, so the
  block's tensor-parallel path runs on them. A module that was never placed is
  returned as it is.
- ``full_tensor`` and ``shard_tensor``: the whole tensor of a shard on every rank of the
  group (checkpoints), and this rank's shard of a whole tensor (resume).

On a mesh with a "pp" axis (pipeline parallel) JAX's pins hold too: a main DiT's
stacked block leaves (not under ``min_size``, not 4-D, not a modulation) take "pp" on
their layer axis (``pin_pp_layers``, a ``sharding.StageSpec`` here: block i on stage
i // (L / pp)) and stay whole within the stage's group, or with ``pp_stage_fsdp`` are
split over ("dp", "sp") within it as well; every other leaf splits over `axes` as
given, "pp" included where it divides (``axes=("pp", "dp", "sp")``), else over them
without "pp". ``place_fsdp`` keeps a pinned parameter on its stage's ranks only (no
storage elsewhere) and records each split with the axes it is over, so ``gathered``,
``full_tensor`` and the train step use that group.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Iterable, Optional, Tuple

import torch
from torch import nn

from goal_force_tpu_torch.parallel import collectives as col
from goal_force_tpu_torch.parallel.mesh import axes_rank, axis_sizes, current_mesh, use_mesh
from goal_force_tpu_torch.parallel.sharding import (
    TP_SPLIT,
    StageSpec,
    drop_storage,
    leaf_spec,
    mark_stage,
    pp_stage,
)

AXES = ("dp", "sp")
FSDP = "_gf_fsdp"          # on a submodule: {parameter name: (dim or None, n, rank, axes)}
MIN_SIZE = 2**15
ALIGN = 128                # elements between tensors of a flat gather buffer

Spec = Tuple[Optional[Tuple[str, ...]], ...]

_LIST = re.compile(r"(^|\.)(blocks|vace_blocks|controlnet_zero_convs_after)\.(\d+)\.")
_PATCH = re.compile(r"(patch_embedding|ref_conv)$")


def _owner(module: nn.Module, name: str):
    path, _, leaf = name.rpartition(".")
    return (module.get_submodule(path) if path else module), path, leaf


def _stack(module: nn.Module, name: str):
    """(layers, whether JAX treats the leaf as a stacked block) where JAX keeps the
    parameter in an array over the layers of its ModuleList: the blocks of the DiT, the
    ControlNet, T5 and VACE are stacked blocks; the ControlNet's zero convs and VACE's
    after_proj are arrays whose layer axis JAX does not skip; VACE's one before_proj is
    no array. None elsewhere."""
    m = _LIST.search(name)
    if m is None:
        return None
    rest = name[m.end():]
    if m.group(2) == "vace_blocks" and rest.startswith("before_proj."):
        return None
    layers = len(module.get_submodule(name[:m.start(3) - 1]))
    stacked = m.group(2) != "controlnet_zero_convs_after" and not rest.startswith("after_proj.")
    return layers, stacked


def jax_leaf(module: nn.Module, name: str, shape) -> Tuple[tuple, list, bool]:
    """The JAX leaf a parameter of `module` is read from: (its shape, for each JAX
    dimension the port's dimension it maps to (None for a layer axis), whether JAX
    treats it as a stacked block)."""
    owner, path, leaf = _owner(module, name)
    shape = tuple(shape)
    if isinstance(owner, (nn.Linear, nn.Conv1d)) and leaf == "weight":
        jshape, dims = (shape[1], shape[0]), [1, 0]        # (in, out)
    elif isinstance(owner, (nn.Conv2d, nn.Conv3d)) and _PATCH.search(path) and leaf == "weight":
        jshape, dims = (math.prod(shape[1:]), shape[0]), [1, 0]   # (C * patch, D)
    elif isinstance(owner, (nn.Linear, nn.Embedding, nn.Conv1d, nn.Conv2d, nn.Conv3d)):
        jshape, dims = shape, list(range(len(shape)))
    else:                                  # (1, 6, D) modulations, (C, 1, 1, 1) gammas
        dims = [d for d, s in enumerate(shape) if s != 1] or [0]
        jshape = tuple(shape[d] for d in dims)
    stack = _stack(module, name)
    if stack is None:
        return jshape, dims, False
    return (stack[0],) + jshape, [None] + dims, stack[1]


def _group_size(sizes: Dict[str, int], axes) -> int:
    return math.prod(sizes.get(a, 1) for a in axes)


def fsdp_specs(module: nn.Module, mesh, axes=AXES, min_size: int = MIN_SIZE,
               pp_stage_fsdp: bool = False, pin_pp_layers: bool = True) -> Dict[str, Spec]:
    """{parameter name: spec} of `module`: per port dimension, the axes tuple it is split
    over, or None (JAX's ``fsdp_specs`` read through ``jax_leaf``). `mesh` is a mesh or
    anything with ``mesh_dim_names`` and ``shape``. On a "pp" axis a main DiT's pinned
    block leaves get ``StageSpec``s (`pin_pp_layers`; split within the stage too with
    `pp_stage_fsdp`), and a "pp" in `axes` splits the other leaves over it too where it
    divides them."""
    sizes = axis_sizes(mesh)
    axes_full = tuple(axes)                           # the unpinned leaves' axes
    axes = tuple(a for a in axes_full if a != "pp")   # "pp" is the pinned leaves' layer axis
    n, n_full = _group_size(sizes, axes), _group_size(sizes, axes_full)
    out = {}
    for name, p in module.named_parameters():
        out[name] = (None,) * p.ndim
        if p.numel() == 0:         # another stage's block, placed before: nothing to split
            continue
        jshape, dims, stacked = jax_leaf(module, name, p.shape)
        if math.prod(jshape) < min_size or len(jshape) == 0 or len(jshape) >= 4:
            continue
        if "modulation" in name:
            continue
        start = 1 if (stacked and len(jshape) > 1) else 0
        cand = list(range(start, len(jshape)))
        if not cand:
            continue
        stage = pp_stage(module, name, sizes) if pin_pp_layers and stacked else None
        if stage is not None and not pp_stage_fsdp:
            out[name] = StageSpec(out[name], stage)
            continue
        best = max(cand, key=lambda d: jshape[d])
        group = axes
        if stage is None and "pp" in axes_full and jshape[best] % n_full == 0:
            group = axes_full              # an unpinned leaf over every axis, "pp" too
        elif jshape[best] % n != 0:
            group = None
        port = dims[best]
        # a JAX split of a layer axis (never at these sizes), or of a patch embedding over
        # C * patch where C does not divide, stays whole
        if group is None or port is None or p.shape[port] % _group_size(sizes, group) != 0:
            group = None
        spec = [None] * p.ndim
        if group is not None:
            spec[port] = group
        out[name] = tuple(spec) if stage is None else StageSpec(spec, stage)
    return out


def _split_dim(spec: Spec) -> Optional[int]:
    dims = [d for d, a in enumerate(spec) if a is not None]
    return dims[0] if dims else None


def _split_axes(spec: Spec) -> Optional[Tuple[str, ...]]:
    d = _split_dim(spec)
    return None if d is None else tuple(spec[d])


@torch.no_grad()
def place_fsdp(module: nn.Module, mesh, specs: Optional[Dict[str, Spec]] = None,
               axes=AXES) -> nn.Module:
    """Keep this rank's slice of every split parameter of `module` (the spec's dimension
    over the group of the spec's axes, in ``axes_rank`` order) and record each split on
    its owning submodule; a parameter of a ``StageSpec`` of another pipeline stage keeps
    no storage. Parameters placed before stay as they are (for the same group size and
    rank; another raises ValueError). Returns the module."""
    specs = fsdp_specs(module, mesh, axes) if specs is None else specs
    sizes = axis_sizes(mesh)
    with use_mesh(mesh):
        mine = axes_rank("pp")
        groups = {_split_axes(sp) for sp in specs.values()} | {tuple(axes)}
        ranks = {g: axes_rank(g) for g in groups if g}
    for name, p in module.named_parameters():
        owner, _, leaf = _owner(module, name)
        rec = owner.__dict__.setdefault(FSDP, {})
        spec = specs[name]
        group = _split_axes(spec) or tuple(axes)
        want = (_split_dim(spec), _group_size(sizes, group), ranks[group], group)
        stage = getattr(spec, "stage", None)
        if stage is not None:
            mark_stage(module, name, stage)
            if stage != mine:
                want = (None, 1, 0, ())
        if leaf in rec:                # placed before: its shard stays
            if rec[leaf][1:3] != want[1:3]:
                raise ValueError(f"{name} is placed as rank {rec[leaf][2]} of {rec[leaf][1]}, "
                                 f"not rank {want[2]} of {want[1]}")
            continue
        if stage is not None and stage != mine:
            p.data = drop_storage(p.data)
        elif want[0] is not None and want[1] > 1:
            d, n, rank = want[:3]
            per = p.shape[d] // n
            p.data = p.data.narrow(d, rank * per, per).clone()
        rec[leaf] = want
    return module


def is_placed(module: nn.Module) -> bool:
    return FSDP in module.__dict__ or any(FSDP in m.__dict__ for m in module.modules())


class View:
    """A module's attributes and items, some replaced (tensors, or views of its
    submodules); everything else is read from the module."""

    def __init__(self, module, replaced: Dict):
        self._module, self._replaced = module, replaced

    def __getattr__(self, name):
        replaced = self.__dict__["_replaced"]
        return replaced[name] if name in replaced else getattr(self.__dict__["_module"], name)

    def __getitem__(self, i):
        return self._replaced[str(i)] if str(i) in self._replaced else self._module[i]


def _walk(module: nn.Module, skip: Iterable[str], prefix: str = ""):
    """(path, submodule) of `module` and its submodules, those under `skip` left out."""
    yield prefix, module
    for name, child in module.named_children():
        if name in skip and not prefix:
            continue
        yield from _walk(child, (), f"{prefix}{name}.")


def _tp_slice(name: str, t: torch.Tensor) -> torch.Tensor:
    """This rank's tensor-parallel slice of a whole DiT-block linear weight, marked with
    its split, where ``leaf_spec`` splits it and the axis divides it; else `t`."""
    spec = leaf_spec(name, t.ndim)
    dims = [d for d, a in enumerate(spec) if a is not None]
    sizes = axis_sizes(current_mesh())
    if not dims or t.shape[dims[0]] % sizes["tp"] != 0:
        return t
    out = col.shard_of(t, dims[0], "tp")
    setattr(out, TP_SPLIT, (dims[0], sizes["tp"], axes_rank("tp")))
    return out


def gathered(*modules: nn.Module, skip: Iterable[str] = (), tp: bool = True):
    """Views of `modules` with every FSDP-split parameter whole (one all-gather per dtype
    and group of axes, ("dp", "sp") unless placed otherwise, for all of them; under grad
    its backward reduce-scatters)
    and, with `tp`, the tensor-parallel linears holding this rank's "tp" slice. Without
    a mesh, or for modules never placed, the modules themselves. Returns one view for one
    module, else a tuple."""
    if current_mesh() is None or not any(is_placed(m) for m in modules):
        return modules[0] if len(modules) == 1 else modules
    skip = tuple(skip)
    entries = []        # (module index, path, submodule, leaf, parameter, record)
    for mi, mod in enumerate(modules):
        for path, sub in _walk(mod, skip):
            rec = sub.__dict__.get(FSDP, {})
            for leaf, p in sub._parameters.items():
                if p is not None:
                    entries.append((mi, path, sub, leaf, p, rec.get(leaf)))
    whole = {}
    split = [e for e in entries if e[5] is not None and e[5][0] is not None]
    for dtype, axes in sorted({(e[4].dtype, e[5][3]) for e in split}, key=str):
        group = [e for e in split if e[4].dtype == dtype and e[5][3] == axes]
        pieces, index = [], []
        for e in group:
            flat = e[4].reshape(-1)
            pad = -flat.numel() % ALIGN
            index.append(len(pieces))
            pieces += [flat, flat.new_zeros(pad)] if pad else [flat]
        g = col.all_gather_flat(torch.cat(pieces), axes)          # (n, total)
        # one split: its backward writes the gradient buffer once (slices would each
        # add a buffer of zeros)
        parts = g.split([t.numel() for t in pieces], dim=1)
        for e, i in zip(group, index):
            p, d, n = e[4], e[5][0], e[5][1]
            t = parts[i].reshape(n, *p.shape).movedim(0, d)
            shape = list(p.shape)
            shape[d] *= n
            whole[id(e[4])] = t.reshape(shape)
    views = []
    for mi, mod in enumerate(modules):
        tree: Dict[str, Dict] = {}
        for e in entries:
            if e[0] != mi:
                continue
            _, path, sub, leaf, p, _ = e
            t = whole.get(id(p), p)
            full_name = f"{path}{leaf}"
            if tp:
                t = _tp_slice(full_name, t)
            if t is p:
                continue
            node = tree
            for part in path.rstrip(".").split(".") if path else ():
                node = node.setdefault(part, {})
            node[leaf] = t
        views.append(_build(mod, tree))
    return views[0] if len(views) == 1 else tuple(views)


def _build(module, tree: Dict):
    if not tree:
        return module
    replaced = {}
    for k, v in tree.items():
        replaced[k] = _build(getattr(module, k), v) if isinstance(v, dict) else v
    return View(module, replaced)


# ---------------------------------------------------------------------------
# Whole tensors of a placed module (checkpoints) and shards from whole ones (resume)
# ---------------------------------------------------------------------------

def split_of(module: nn.Module, name: str):
    """(dim or None, n, rank, axes) of a parameter of a placed module; None where the
    module was never placed."""
    owner, _, leaf = _owner(module, name)
    return owner.__dict__.get(FSDP, {}).get(leaf)


@torch.no_grad()
def full_tensor(t: torch.Tensor, split) -> torch.Tensor:
    """The whole tensor of which `t` is this rank's shard (``split`` from ``split_of``);
    all ranks of the split's group call it together."""
    if split is None or split[0] is None:
        return t
    d, n = split[0], split[1]
    g = col.all_gather_flat(t.reshape(-1).contiguous(), split[3])
    shape = list(t.shape)
    shape[d] *= n
    return g.reshape(n, *t.shape).movedim(0, d).reshape(shape)


def shard_tensor(t: torch.Tensor, split) -> torch.Tensor:
    """This rank's shard of a whole tensor (a copy), by ``split``."""
    if split is None or split[0] is None or split[1] == 1:
        return t
    d, n, rank = split[:3]
    per = t.shape[d] // n
    return t.narrow(d, rank * per, per).clone()
