"""The explicit collectives of sharded serving and training: what GSPMD inserts in the
JAX package.

Each function acts over one axis of the ambient mesh (``parallel/mesh.py``), or over
several at once (the FSDP group ``("dp", "sp")``), and calls its collective whatever
the axis's size: over a group of one it is a copy, so a world of one process runs the
same code as a multi-GPU one. ``counts`` counts the calls by kind ("all_to_all",
"all_gather", "all_reduce", "reduce_scatter", "broadcast", "shift"), backward calls
included, for the launch checks of ``chip_smoke.py``.

Layouts: tokens are split over "sp" between blocks, padded at the end to a multiple of
the axis size (``split_seq``; ``valid_tokens()`` then holds the real count, and the
padded keys are masked in attention); inside self-attention ``seq_to_heads`` trades
tokens for heads (Ulysses) and ``heads_to_seq`` trades them back; the outputs of the
row-parallel linears are summed over "tp" (``all_reduce``); batch rows are split over
"dp" (``split_batch``) and gathered at the end (``gather_batch``). ``shift`` hands each
rank its neighbour's tensor along one axis (JAX's ``ppermute`` by one): with wraparound
the K/V blocks of ring attention (``parallel/ring_attention.py``), without it the halo
rows and columns of the VAE's spatial split (``parallel/spatial.py``) and the
activations handed from one pipeline stage to the next (``models/wan_dit.py::
pp_run_blocks``), whose stages take their layers' injections with ``stage_take``.

Gradients. Every collective is an ``autograd.Function`` whose backward is its
transpose; under ``no_grad`` (serving) it records nothing and issues the same one
collective. The rules keep one invariant per axis:

  - over "tp" every rank holds the whole gradient of a replicated tensor: the row-
    parallel sum has an identity backward (its consumer is replicated), ``copy_to`` (the
    replicated input of a column-parallel linear) sums its gradient over the axis,
    ``shard_of`` (this rank's slice of a replicated tensor) gathers it, and the q/k
    norms' mean of squares sums its gradient (each rank's columns use it);
  - over "dp" and "sp" each rank holds its own rows' and tokens' part of a gradient
    (``split_seq`` and ``split_batch`` are plain slices, the padded tokens get none;
    ``gather_seq`` and ``gather_batch``, whose consumer is replicated, hand each rank
    its slice back), and the training step sums the parts over the FSDP group once;
  - over "pp" (the pipeline's stages) every rank holds the whole gradient of the
    replicated ControlNet's injections (``stage_take``), and the training step sums
    the LoRA adapters' gradients, which only their block's stage computes.

A backward runs on autograd's device thread, where the caller's context variables (the
ambient mesh, the token split) are not set: each collective's forward keeps its group,
size and rank for its backward, and ``carry_context`` gives a checkpointed block's
recompute the context of its forward.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
from typing import Optional

import torch
import torch.distributed as dist

from goal_force_tpu_torch.parallel.mesh import (
    axes_group,
    axes_rank,
    axes_size,
    current_mesh,
    use_mesh,
)

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


class _Axis:
    """The group, size and this rank's index of one axis (or several) of the ambient
    mesh, read when a collective is called and kept for its backward."""

    __slots__ = ("group", "n", "rank")

    def __init__(self, axis):
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        self.group, self.n, self.rank = axes_group(axes), axes_size(axes), axes_rank(axes)


def carry_context(fn):
    """`fn` run under the caller's ambient mesh and token split, also where the backward
    recomputes it (a checkpointed block) on autograd's device thread."""
    mesh, valid = current_mesh(), valid_tokens()

    def run(*args, **kwargs):
        with use_mesh(mesh), sequence_split(valid):
            return fn(*args, **kwargs)
    return run


def split_seq(x: torch.Tensor, dim: int = 1, axis: str = "sp") -> torch.Tensor:
    """This rank's contiguous slice of `x` along `dim`, zero-padded at the end to a
    multiple of the axis size first. Differentiable as a slice: the rank's tokens get
    their gradient, the padding none."""
    ax = _Axis(axis)
    size = x.shape[dim]
    per = -(-size // ax.n)
    if per * ax.n != size:
        pad = list(x.shape)
        pad[dim] = per * ax.n - size
        x = torch.cat([x, x.new_zeros(pad)], dim=dim)
    return x.narrow(dim, ax.rank * per, per)


def _all_gather(x: torch.Tensor, ax: _Axis):
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(ax.n)]
    dist.all_gather(parts, x, group=ax.group)
    counts["all_gather"] += 1
    return parts


class _Gather(torch.autograd.Function):
    """Every rank's slice along `dim`, concatenated; the consumer is replicated, so the
    backward hands each rank its own slice of the (whole, equal) gradient."""

    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.rank, ctx.size = dim, ax.rank, x.shape[dim]
        return torch.cat(_all_gather(x, ax), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None


def _gather(x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
    return _Gather.apply(x, dim, _Axis(axis))


def gather_seq(x: torch.Tensor, n_tokens: Optional[int] = None, dim: int = 1,
               axis: str = "sp") -> torch.Tensor:
    """Every rank's slice along `dim`, concatenated, the padding past `n_tokens`
    dropped."""
    out = _gather(x, dim, axis)
    return out if n_tokens is None else out.narrow(dim, 0, n_tokens)


def _seq_to_heads(x: torch.Tensor, ax: _Axis) -> torch.Tensor:
    n = ax.n
    b, s, heads, h = x.shape
    src = x.reshape(b, s, n, heads // n, h).permute(2, 0, 1, 3, 4).contiguous()
    out = torch.empty_like(src)                  # out[j]: rank j's tokens, my heads
    dist.all_to_all_single(out, src, group=ax.group)
    counts["all_to_all"] += 1
    return out.permute(1, 0, 2, 3, 4).reshape(b, n * s, heads // n, h)


def _heads_to_seq(x: torch.Tensor, ax: _Axis) -> torch.Tensor:
    n = ax.n
    b, s_all, hl, h = x.shape
    s = s_all // n
    src = x.reshape(b, n, s, hl, h).permute(1, 0, 2, 3, 4).contiguous()
    out = torch.empty_like(src)                  # out[j]: my tokens, rank j's heads
    dist.all_to_all_single(out, src, group=ax.group)
    counts["all_to_all"] += 1
    return out.permute(1, 2, 0, 3, 4).reshape(b, s, n * hl, h)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return _seq_to_heads(x, ax)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(g, ctx.ax), None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return _heads_to_seq(x, ax)

    @staticmethod
    def backward(ctx, g):
        # contiguous, as the backward kernels' tensor maps need their do
        return _seq_to_heads(g, ctx.ax), None


def seq_to_heads(x: torch.Tensor, axis: str = "sp") -> torch.Tensor:
    """(B, S/n, N, H), this rank's tokens of every head -> (B, S, N/n, H), every token
    of this rank's heads, contiguous (the kernels' tensor maps need the layout). Its
    backward is ``heads_to_seq``."""
    return _SeqToHeads.apply(x, _Axis(axis))


def heads_to_seq(x: torch.Tensor, axis: str = "sp") -> torch.Tensor:
    """The inverse of ``seq_to_heads``: (B, S, N/n, H) -> (B, S/n, N, H). Its backward
    is ``seq_to_heads``, which hands the attention's backward a contiguous gradient."""
    return _HeadsToSeq.apply(x, _Axis(axis))


def _all_reduce(x: torch.Tensor, ax: _Axis) -> torch.Tensor:
    dist.all_reduce(x, group=ax.group)
    counts["all_reduce"] += 1
    return x


class _SumReplicated(torch.autograd.Function):
    """The sum over the axis of each rank's part, in place, consumed alike by every
    rank: the gradient of each part is the (equal) gradient of the sum."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.mark_dirty(x)
        return _all_reduce(x, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumShared(torch.autograd.Function):
    """The sum over the axis of each rank's part, in place, where each rank's consumer
    uses the sum for its own share of the work: the gradient of each part is the sum of
    every rank's gradient."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        ctx.mark_dirty(x)
        return _all_reduce(x, ax)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.ax), None


def all_reduce(x: torch.Tensor, axis: str = "tp", shared: bool = False) -> torch.Tensor:
    """The sum over the axis, in place. By default its consumer is replicated (the
    row-parallel output), so its backward is the identity; shared=True where each rank
    uses the sum on its own share (the q/k norms' mean of squares over their columns):
    its backward sums the gradients over the axis."""
    return (_SumShared if shared else _SumReplicated).apply(x, _Axis(axis))


def all_reduce_max(x: torch.Tensor, axis: str = "tp") -> torch.Tensor:
    """The elementwise max over the axis, in place (the activation scales of a
    row-parallel W8A8 linear; inference only)."""
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=_Axis(axis).group)
    counts["all_reduce"] += 1
    return x


class _CopyTo(torch.autograd.Function):
    """A replicated tensor that each rank consumes with its own columns (the input of
    a column-parallel linear): identity forward, its gradient summed over the axis."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.ax), None


def copy_to(x: torch.Tensor, axis: str = "tp") -> torch.Tensor:
    """`x` as the input of this rank's share of a column-parallel product: the same
    tensor, whose gradient the backward sums over the axis."""
    return _CopyTo.apply(x, _Axis(axis))


class _ShardOf(torch.autograd.Function):
    """This rank's slice of a replicated tensor: the backward gathers every rank's
    slice of the gradient, so each holds the whole."""

    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        per = x.shape[dim] // ax.n
        return x.narrow(dim, ax.rank * per, per)

    @staticmethod
    def backward(ctx, g):
        return torch.cat(_all_gather(g, ctx.ax), dim=ctx.dim), None, None


def shard_of(x: torch.Tensor, dim: int, axis: str = "tp") -> torch.Tensor:
    """This rank's slice of a replicated tensor along `dim` (the axis size divides it);
    its backward gathers the whole gradient on every rank."""
    return _ShardOf.apply(x, dim, _Axis(axis))


class _FirstRankBias(torch.autograd.Function):
    """A replicated bias added once to a sum over the axis: the axis's first rank adds
    it, the others add zeros; each rank's gradient of its term is the whole gradient
    of the bias (the consumer of the sum is replicated), and is returned as such."""

    @staticmethod
    def forward(ctx, b, first):
        return b.view_as(b) if first else torch.zeros_like(b)

    @staticmethod
    def backward(ctx, g):
        return g, None


def first_rank_bias(b: Optional[torch.Tensor], axis: str = "tp") -> Optional[torch.Tensor]:
    """The bias of a row-parallel linear, added by the axis's first rank only (zeros on
    the others, so that every rank's gradient of the bias is the whole)."""
    return None if b is None else _FirstRankBias.apply(b, _Axis(axis).rank == 0)


def gather_cols(x: torch.Tensor, axis: str = "tp") -> torch.Tensor:
    """Every rank's columns (last dim), concatenated (consumed alike by every rank)."""
    return _gather(x, x.dim() - 1, axis)


def split_batch(x: Optional[torch.Tensor], axis: str = "dp") -> Optional[torch.Tensor]:
    """This rank's rows of the batch (the axis size divides it); a plain slice."""
    if x is None:
        return None
    ax = _Axis(axis)
    per = x.shape[0] // ax.n
    return x.narrow(0, ax.rank * per, per)


def gather_batch(x: torch.Tensor, axis: str = "dp") -> torch.Tensor:
    return _gather(x, 0, axis)


def _shift(x: torch.Tensor, step: int, wrap: bool, ax: _Axis) -> torch.Tensor:
    """Rank r's result is rank (r - step)'s x; without wrap, zeros where that rank lies
    outside the axis. One batch of point-to-point sends and receives over the axis."""
    n, r = ax.n, ax.rank
    src, dst = r - step, r + step
    if wrap:
        if n == 1:
            return x.view_as(x)
        src, dst = src % n, dst % n
    x = x.contiguous()
    out = torch.empty_like(x) if 0 <= src < n else torch.zeros_like(x)
    peer = lambda i: dist.get_global_rank(ax.group, i)
    ops = ([dist.P2POp(dist.isend, x, peer(dst), ax.group)] if 0 <= dst < n else []) + \
          ([dist.P2POp(dist.irecv, out, peer(src), ax.group)] if 0 <= src < n else [])
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        counts["shift"] += 1
    return out


class _Shift(torch.autograd.Function):
    """Each rank's x handed to the rank `step` further along the axis; the backward hands
    the gradient back the other way (with the same wraparound)."""

    @staticmethod
    def forward(ctx, x, step, wrap, ax):
        ctx.step, ctx.wrap, ctx.ax = step, wrap, ax
        return _shift(x, step, wrap, ax)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, -ctx.step, ctx.wrap, ctx.ax), None, None, None


def shift(x: torch.Tensor, axis: str = "sp", step: int = 1, wrap: bool = True) -> torch.Tensor:
    """The tensor of the rank `step` places before this one along `axis` (every rank's x
    has one shape): with wrap, around the ring (over one rank, x itself); without it, the
    ranks that have no such neighbour get zeros (the edge's zero padding; over one rank,
    zeros). Its backward is the shift the other way."""
    return _Shift.apply(x, step, wrap, _Axis(axis))


class _StageTake(torch.autograd.Function):
    """Stage r's `per` consecutive tensors of a list that every rank of the axis holds
    alike (indices [r * per, (r + 1) * per) that exist), and a zero scalar. The list is
    replicated over the axis and each tensor used by one stage only, so the backward
    hands each tensor's gradient from the stage that took it to every rank of the axis
    (one broadcast per tensor, in the list's order): every rank holds the whole
    gradient, as over "tp"."""

    @staticmethod
    def forward(ctx, ax, per, *xs):
        ctx.ax, ctx.per, ctx.n = ax, per, len(xs)
        ctx.like = dict(size=xs[0].shape, dtype=xs[0].dtype, device=xs[0].device)
        lo = ax.rank * per
        return (xs[0].new_zeros(()), *(x.view_as(x) for x in xs[lo:lo + per]))

    @staticmethod
    def backward(ctx, g_anchor, *gs):
        ax, per = ctx.ax, ctx.per
        lo = ax.rank * per
        out = []
        for i in range(ctx.n):
            owner = i // per
            g = gs[i - lo].contiguous() if owner == ax.rank else torch.empty(**ctx.like)
            dist.broadcast(g, src=dist.get_global_rank(ax.group, owner), group=ax.group)
            counts["broadcast"] += 1
            out.append(g)
        return (None, None, *out)


def stage_take(xs, per: int, axis: str = "pp"):
    """(anchor, *mine): this rank's `per` tensors of the list `xs` (equal shapes, alike on
    every rank of the axis), stage-major: rank r of the axis takes [r * per, (r + 1) *
    per), fewer or none where the list ends, as JAX's pipeline takes its stage's layers
    of the zero-padded injections. Under grad, where `xs` require it, anchor is a zero
    scalar tied to every tensor of `xs` (a stage adds it to its outputs, so its
    hand-offs take part in the backward also where it took no tensor), and the backward
    broadcasts each tensor's gradient from its stage; otherwise anchor is None and
    nothing is recorded."""
    ax = _Axis(axis)
    if not (torch.is_grad_enabled() and any(x.requires_grad for x in xs)):
        return (None, *xs[ax.rank * per:(ax.rank + 1) * per])
    return _StageTake.apply(ax, per, *xs)


def broadcast_from_first(x: torch.Tensor) -> torch.Tensor:
    """Rank 0's `x` on every rank of the world, in place (host decisions that every
    rank must take alike)."""
    dist.broadcast(x, src=0)
    counts["broadcast"] += 1
    return x


# ---------------------------------------------------------------------------
# FSDP: one flat buffer over several axes
# ---------------------------------------------------------------------------

# the flat collectives' names in this torch, and in older ones
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


class _AllGatherFlat(torch.autograd.Function):
    """(L,) -> (n, L): every rank's flat buffer over the group of `axes`; the backward
    reduce-scatters (sums) the gradient back to each rank's buffer."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return _all_gather_flat(x, ax)

    @staticmethod
    def backward(ctx, g):
        ax = ctx.ax
        g = g.contiguous()
        if dist.get_backend(ax.group) == "gloo":
            # gloo has no reduce-scatter: the sum everywhere, then this rank's row
            dist.all_reduce(g, group=ax.group)
            out = g[ax.rank].clone()
        else:
            out = torch.empty(g.shape[1:], dtype=g.dtype, device=g.device)
            _REDUCE_SCATTER(out, g.reshape(-1), group=ax.group)
        counts["reduce_scatter"] += 1
        return out, None


def _all_gather_flat(x: torch.Tensor, ax: _Axis) -> torch.Tensor:
    out = torch.empty(ax.n * x.numel(), dtype=x.dtype, device=x.device)
    _ALL_GATHER(out, x.contiguous(), group=ax.group)
    counts["all_gather"] += 1
    return out.view(ax.n, x.numel())


def all_gather_flat(x: torch.Tensor, axes=("dp", "sp")) -> torch.Tensor:
    """(L,) flat buffer -> (n, L), row r rank r's buffer in the group of `axes` (in the
    order of ``axes_rank``); its backward is a reduce-scatter."""
    return _AllGatherFlat.apply(x, _Axis(axes))


def sum_over(x: torch.Tensor, axes=("dp", "sp")) -> torch.Tensor:
    """The sum of `x` over the group of `axes`, in place (no autograd)."""
    return _all_reduce(x, _Axis(axes))


def barrier() -> None:
    """Every rank of the ambient mesh waits for the others (one barrier per axis in
    turn, which together reach every rank of the mesh)."""
    for axis in current_mesh().mesh_dim_names:
        dist.barrier(group=_Axis(axis).group)
