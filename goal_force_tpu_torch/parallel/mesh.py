"""The device mesh of the port: ``(dp, sp, tp)``, or ``(pp, dp, sp, tp)``, over
``torch.distributed``.

Port of ``goal_force_tpu/parallel/mesh.py``. One process runs per device; the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the first ``pp * dp * sp * tp`` ranks,
with the axes

  pp: pipeline stages of the DiT trunk (``models/wan_dit.py::pp_run_blocks``), present
      only where pp > 1, outermost: the rank at mesh index (a, b, c, d) is
      ((a * dp + b) * sp + c) * tp + d, JAX's device order;
  dp: data (the batch rows: merged CFG's two branches, or generate_batch's clips);
  sp: sequence (tokens between blocks; heads inside self-attention, Ulysses);
  tp: tensor (attention heads and FFN columns; the row-parallel outputs are summed).

JAX hands the collectives to GSPMD through ``constrain`` hints inside its jitted model.
The port has no counterpart of ``constrain``: its forward functions call the explicit
collectives of ``parallel/collectives.py`` wherever JAX's layout changes, and
``parallel/sharding.py`` gives each parameter its local shard. ``use_mesh`` makes a
mesh ambient for those functions, as in JAX. An axis that the mesh lacks has size 1 and
index 0 (``axis_size``, ``axis_rank``).

A launcher sets each process's rank: ``torchrun --nproc_per_node=N`` on one node.
``make_mesh`` starts the process group from its environment where none exists; a
caller without a launcher starts the group itself (``init_process_group`` with its own
rendezvous) before it calls ``make_mesh``.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from typing import Dict

import torch
import torch.distributed as dist

MESH_AXES = ("dp", "sp", "tp")
MESH_AXES_PP = ("pp", "dp", "sp", "tp")

_current_mesh: contextvars.ContextVar = contextvars.ContextVar("gf_torch_mesh",
                                                                default=None)


def _world_size() -> int:
    """Processes in the default group, or in the launcher's environment before one
    exists (1 without either)."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def _init_process_group(device: torch.device) -> None:
    """NCCL on CUDA, gloo on the CPU, from the launcher's environment (``env://``)."""
    if dist.is_initialized():
        return
    if "MASTER_ADDR" not in os.environ:
        raise RuntimeError("no process group: run under torchrun, or call "
                           "torch.distributed.init_process_group before make_mesh")
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")


def make_mesh(dp: int = 1, sp: int = 1, tp: int = 1, pp: int = 1, device="cuda"):
    """A DeviceMesh named ("dp", "sp", "tp") over the first dp * sp * tp ranks, or with
    pp > 1 one named ("pp", "dp", "sp", "tp") over the first pp * dp * sp * tp, the
    process group started first where none exists. Raises ValueError when the world
    is smaller than that."""
    n = dp * sp * tp * pp
    have = _world_size()
    if have < n:
        raise ValueError(f"need {n} devices, have {have}")
    from torch.distributed.device_mesh import DeviceMesh

    device = torch.device(device)
    _init_process_group(device)
    if pp == 1:
        return DeviceMesh(device.type, torch.arange(n).reshape(dp, sp, tp),
                          mesh_dim_names=MESH_AXES)
    return DeviceMesh(device.type, torch.arange(n).reshape(pp, dp, sp, tp),
                      mesh_dim_names=MESH_AXES_PP)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make `mesh` ambient: the forward functions shard over it."""
    token = _current_mesh.set(mesh)
    try:
        yield mesh
    finally:
        _current_mesh.reset(token)


def current_mesh():
    return _current_mesh.get()


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a mesh (anything with ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_size(axis: str) -> int:
    """The size of `axis` on the ambient mesh; 1 without one or where it lacks the
    axis."""
    mesh = current_mesh()
    return 1 if mesh is None else axis_sizes(mesh).get(axis, 1)


def axis_rank(axis: str) -> int:
    """This process's index along `axis` of the ambient mesh; 0 without one or where it
    lacks the axis."""
    mesh = current_mesh()
    if mesh is None or axis not in mesh.mesh_dim_names:
        return 0
    return mesh.get_local_rank(axis)


def axis_group(axis: str):
    """The process group of `axis` of the ambient mesh."""
    return current_mesh().get_group(axis)


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axes_size(axes) -> int:
    """The product of the sizes of `axes` on the ambient mesh; 1 without one."""
    n = 1
    for a in _axes(axes):
        n *= axis_size(a)
    return n


def axes_rank(axes) -> int:
    """This process's index in the group of `axes` (the first axis major, as JAX
    orders a spec's axis tuple); 0 without a mesh."""
    r = 0
    for a in _axes(axes):
        r = r * axis_size(a) + axis_rank(a)
    return r


def axes_group(axes):
    """The process group of the ranks that differ from this one only along `axes`
    (several axes at once, e.g. FSDP's ("dp", "sp")). Axes of size one are dropped, and
    so are axes the mesh lacks, so one axis left is that axis's group; a group of several
    is made on first use by its own members (``use_local_synchronization``) and kept on
    the mesh."""
    mesh = current_mesh()
    present = tuple(a for a in _axes(axes) if a in mesh.mesh_dim_names)
    axes = tuple(a for a in present if axis_size(a) > 1) or present[:1]
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    cache = mesh.__dict__.setdefault("_gf_axes_groups", {})
    if axes not in cache:
        names = list(mesh.mesh_dim_names)
        dims = [names.index(a) for a in axes]
        rest = [d for d in range(len(names)) if d not in dims]
        me = dist.get_rank()
        row = next(r for r in mesh.mesh.permute(*rest, *dims).reshape(-1, axes_size(axes)).tolist()
                   if me in r)
        cache[axes] = dist.new_group(ranks=row, use_local_synchronization=True)
    return cache[axes]
