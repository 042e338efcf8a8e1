"""The explicit collectives of sharded serving: what GSPMD inserts in the JAX package.

Each function acts over one axis of the ambient mesh (``parallel/mesh.py``) and calls
its collective whatever the axis's size: over a group of one it is a copy, so a world
of one process runs the same code as a multi-GPU one. ``counts`` counts the calls by
kind ("all_to_all", "all_gather", "all_reduce", "broadcast"), for the launch checks of
``chip_smoke.py``.

Layouts: tokens are split over "sp" between blocks, padded at the end to a multiple of
the axis size (``split_seq``; ``valid_tokens()`` then holds the real count, and the
padded keys are masked in attention); inside self-attention ``seq_to_heads`` trades
tokens for heads (Ulysses) and ``heads_to_seq`` trades them back; the outputs of the
row-parallel linears are summed over "tp" (``all_reduce``); batch rows are split over
"dp" (``split_batch``) and gathered at the end (``gather_batch``).
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
from typing import Optional

import torch
import torch.distributed as dist

from goal_force_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size

counts: collections.Counter = collections.Counter()

_valid_tokens: contextvars.ContextVar = contextvars.ContextVar("gf_valid_tokens",
                                                               default=None)


@contextlib.contextmanager
def sequence_split(n_tokens: int):
    """Within the block, `n_tokens` of the padded token sequence are real."""
    token = _valid_tokens.set(n_tokens)
    try:
        yield
    finally:
        _valid_tokens.reset(token)


def valid_tokens() -> Optional[int]:
    return _valid_tokens.get()


def split_seq(x: torch.Tensor, dim: int = 1, axis: str = "sp") -> torch.Tensor:
    """This rank's contiguous slice of `x` along `dim`, zero-padded at the end to a
    multiple of the axis size first."""
    n = axis_size(axis)
    size = x.shape[dim]
    per = -(-size // n)
    if per * n != size:
        pad = list(x.shape)
        pad[dim] = per * n - size
        x = torch.cat([x, x.new_zeros(pad)], dim=dim)
    return x.narrow(dim, axis_rank(axis) * per, per)


def gather_seq(x: torch.Tensor, n_tokens: Optional[int] = None, dim: int = 1,
               axis: str = "sp") -> torch.Tensor:
    """Every rank's slice along `dim`, concatenated, the padding past `n_tokens`
    dropped."""
    out = torch.cat(_all_gather(x, axis), dim=dim)
    return out if n_tokens is None else out.narrow(dim, 0, n_tokens)


def _all_gather(x: torch.Tensor, axis: str):
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(axis_size(axis))]
    dist.all_gather(parts, x, group=axis_group(axis))
    counts["all_gather"] += 1
    return parts


def seq_to_heads(x: torch.Tensor, axis: str = "sp") -> torch.Tensor:
    """(B, S/n, N, H), this rank's tokens of every head -> (B, S, N/n, H), every token
    of this rank's heads, contiguous (the kernels' tensor maps need the layout)."""
    n = axis_size(axis)
    b, s, heads, h = x.shape
    src = x.reshape(b, s, n, heads // n, h).permute(2, 0, 1, 3, 4).contiguous()
    out = torch.empty_like(src)                  # out[j]: rank j's tokens, my heads
    dist.all_to_all_single(out, src, group=axis_group(axis))
    counts["all_to_all"] += 1
    return out.permute(1, 0, 2, 3, 4).reshape(b, n * s, heads // n, h)


def heads_to_seq(x: torch.Tensor, axis: str = "sp") -> torch.Tensor:
    """The inverse of ``seq_to_heads``: (B, S, N/n, H) -> (B, S/n, N, H)."""
    n = axis_size(axis)
    b, s_all, hl, h = x.shape
    s = s_all // n
    src = x.reshape(b, n, s, hl, h).permute(1, 0, 2, 3, 4).contiguous()
    out = torch.empty_like(src)                  # out[j]: my tokens, rank j's heads
    dist.all_to_all_single(out, src, group=axis_group(axis))
    counts["all_to_all"] += 1
    return out.permute(1, 2, 0, 3, 4).reshape(b, s, n * hl, h)


def all_reduce(x: torch.Tensor, axis: str = "tp") -> torch.Tensor:
    """The sum over the axis, in place."""
    dist.all_reduce(x, group=axis_group(axis))
    counts["all_reduce"] += 1
    return x


def shard_of(x: torch.Tensor, dim: int, axis: str = "tp") -> torch.Tensor:
    """This rank's slice of a replicated tensor along `dim` (the axis size divides it)."""
    per = x.shape[dim] // axis_size(axis)
    return x.narrow(dim, axis_rank(axis) * per, per)


def gather_cols(x: torch.Tensor, axis: str = "tp") -> torch.Tensor:
    """Every rank's columns (last dim), concatenated."""
    return torch.cat(_all_gather(x, axis), dim=-1)


def split_batch(x: Optional[torch.Tensor], axis: str = "dp") -> Optional[torch.Tensor]:
    """This rank's rows of the batch (the axis size divides it)."""
    return None if x is None else shard_of(x, 0, axis)


def gather_batch(x: torch.Tensor, axis: str = "dp") -> torch.Tensor:
    return torch.cat(_all_gather(x, axis), dim=0)


def broadcast_from_first(x: torch.Tensor) -> torch.Tensor:
    """Rank 0's `x` on every rank of the world, in place (host decisions that every
    rank must take alike)."""
    dist.broadcast(x, src=0)
    counts["broadcast"] += 1
    return x
