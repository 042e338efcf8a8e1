"""Ring attention: the tokens stay split over "sp" and the K/V blocks rotate.

Port of ``goal_force_tpu/parallel/ring_attention.py`` (``attention(impl="ring")``). Each
rank holds a contiguous slice of the queries and of the keys; the K/V blocks move one rank
along the axis at a time (``collectives.shift`` with wraparound, JAX's ``ppermute``), so
after ``sp - 1`` shifts every rank has seen every block. Each block gives its partial
attention and logsumexp (K3, ``flash_attention_fwd_lse``, where the kernel accepts the
block; its plain version elsewhere), and the partials merge by a streaming logsumexp in
float32, exactly as the JAX function merges them.

The backward (``_RingFn``) walks the ring again with the merged output and logsumexp:
p = exp(s - lse) of a block is then the row's global softmax, so K5
(``flash_attention_bwd_dq``) gives the block's exact share of dq and K4
(``flash_attention_bwd_dkv``) this rank's queries' share of the block's dk and dv. Those
shares travel on around the ring, each rank adding its own, until they reach the rank that
owns the block.

The per-rank work is written as functions of the rank's queries and of the K/V blocks in
the order the rotation delivers them (its own block first, then the block of the rank
before it, and so on): ``ring_forward`` and ``ring_backward``. The shift is the only
collective, so a caller can also feed them blocks it holds itself (``chip_smoke.py``
does, for virtual ranks on one card).
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple

import torch

from goal_force_tpu_torch.ops import flash_attention as fa
from goal_force_tpu_torch.ops.attention import kernel_accepts
from goal_force_tpu_torch.parallel import collectives as col


def block_attention_with_lse(q, k, v, scale: float):
    """(o, lse) of q against one K/V block: o like q, lse (B, N, Sq) float32."""
    if kernel_accepts(q):
        return fa.flash_attention_fwd_lse(q, k, v, scale)
    return fa.flash_attention_fwd_lse_plain(q, k, v, scale)


def _per_row(x):
    """(B, N, Sq) -> (B, Sq, N, 1), to scale an output of layout (B, Sq, N, H)."""
    return x.permute(0, 2, 1)[..., None]


def ring_forward(q, blocks: Iterable[Tuple[torch.Tensor, torch.Tensor]], scale: float):
    """This rank's attention output (like q) and logsumexp ((B, N, Sq) float32) over every
    (k, v) block of `blocks`, merged in float32: m the running max of the blocks' lse,
    l the running sum of exp(lse_i - m), acc the outputs weighted alike."""
    it = iter(blocks)
    k, v = next(it)
    o, m = block_attention_with_lse(q, k, v, scale)
    acc = o.float()
    l = torch.ones_like(m)
    for k, v in it:
        o, lse = block_attention_with_lse(q, k, v, scale)
        m_new = torch.maximum(m, lse)
        c_old, c_new = torch.exp(m - m_new), torch.exp(lse - m_new)
        acc = acc * _per_row(c_old) + o.float() * _per_row(c_new)
        l = l * c_old + c_new
        m = m_new
    return (acc / _per_row(l)).to(q.dtype), m + torch.log(l)


def ring_backward(q, o, lse, do, blocks: Iterable[Tuple[torch.Tensor, torch.Tensor]],
                  scale: float, block_grads: Optional[Callable] = None):
    """dq of this rank's queries, given the merged output o, its logsumexp lse and the
    output's gradient do, over the (k, v) blocks of `blocks`: K5 per block, summed in
    float32. With `block_grads`, K4 gives each block's dk and dv from these queries
    and ``block_grads(i, dk, dv)`` receives them for the i-th block."""
    kern = kernel_accepts(q)
    dq = None
    for i, (k, v) in enumerate(blocks):
        args = (q, k, v, o, do, lse, scale)
        part = fa.flash_attention_bwd_dq(*args) if kern else fa.flash_attention_bwd_dq_plain(*args)
        dq = part.float() if dq is None else dq.add_(part.float())
        if block_grads is not None:
            block_grads(i, *(fa.flash_attention_bwd_dkv(*args) if kern
                             else fa.flash_attention_bwd_dkv_plain(*args)))
    return dq.to(q.dtype)


def _rotation(k, v, ax):
    """The K/V blocks as the ring delivers them to this rank: its own, then after each
    shift by one along the axis the previous rank's."""
    for i in range(ax.n):
        if i:
            k, v = col._shift(k, 1, True, ax), col._shift(v, 1, True, ax)
        yield k, v


class _RingFn(torch.autograd.Function):
    """Ring attention under grad: the forward saves q, this rank's k and v, the merged o
    and lse; the backward walks the ring again, and the dk/dv shares of each block
    travel behind it to the block's owner: the share of the block delivered i-th
    (i >= 1) joins the running sum that arrives with the shift, so after the last block
    one more shift brings each rank its own block's sum of every other rank's share, to
    which it adds its own (i = 0)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, ax):
        o, lse = ring_forward(q, _rotation(k, v, ax), scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.ax = scale, ax
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        ax = ctx.ax
        do = do.to(q.dtype).contiguous()
        shares = {}

        def block_grads(i, dk, dv):
            if i == 0:
                shares["own"] = (dk, dv)
            elif "sum" not in shares:
                shares["sum"] = [dk.float(), dv.float()]
            else:
                shares["sum"] = [col._shift(s, 1, True, ax) + g.float()
                                 for s, g in zip(shares["sum"], (dk, dv))]

        need_kv = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        dq = ring_backward(q, o, lse, do, _rotation(k, v, ax), ctx.scale,
                           block_grads if need_kv else None)
        dk = dv = None
        if need_kv:
            dk, dv = shares["own"]
            if "sum" in shares:                       # more than one rank
                dk, dv = ((col._shift(s, 1, True, ax) + g.float()).to(g.dtype)
                          for s, g in zip(shares["sum"], (dk, dv)))
        return dq, dk, dv, None, None


def ring_attention(q, k, v, scale: float, axis: str = "sp") -> torch.Tensor:
    """q, k, v: this rank's slices (B, S/n, N, H) of the queries and keys, contiguous
    along the sequence, the rank's index along `axis` (of size n > 1) giving the
    slice -> this rank's output over every key. Differentiable (``_RingFn``)."""
    ax = col._Axis(axis)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _RingFn.apply(q, k, v, scale, ax)
    return ring_forward(q, _rotation(k, v, ax), scale)[0]
