"""Attention dispatch.

Port of ``goal_force_tpu/ops/attention.py``: the plain einsum attention (float32
softmax, optional additive bias, prefix-valid ``kv_len``) and the choice between it and
the flash kernels. ``impl="auto"`` takes a kernel only where the kernel accepts the
call: a CUDA tensor, head_dim exactly 128 (the JAX dispatch tests ``% 128``, but its
kernel takes only 128), at least 256 queries and no bias. Everything else, such as the
tiny test configs, uses the plain attention, as JAX uses XLA attention for them.

The port names JAX's impls by what runs: JAX "xla" is "plain", "pallas" is "flash" and
"pallas_int8" is "flash_int8" (K6, int8 q and k, inference only); "ring" keeps its name.

Under an ambient mesh (``parallel/mesh.py``) the functions differ by the layout their
inputs arrive in:

  - ``attention`` takes whole (replicated) tensors, as JAX's ``attention`` under a mesh:
    "ring" runs the ring over slices of the tokens where JAX's condition holds
    (``ring_applies``), and otherwise, as JAX's ``_pallas_sharded``, each rank takes its
    heads over ("sp", "tp") and its batch rows over "dp", runs the dispatch on them and
    gathers the heads and rows back (the whole attention where they do not divide);
  - ``sharded_attention`` takes this rank's tokens (self-attention between the DiT's
    blocks): the ring over them, or the Ulysses exchange;
  - ``sharded_cross_attention`` takes this rank's queries and every key (the DiT's
    text and image cross-attention): the ring over slices of the keys, or the local
    dispatch;
  - ``local_attention`` is the dispatch on the tensors as given, with no collective.
"""

from __future__ import annotations

import torch

from goal_force_tpu_torch.ops import flash_attention as fa

IMPLS = ("auto", "plain", "flash", "flash_int8", "ring")


PLAIN_LOGITS_BYTES = 2 << 30   # the float32 logits of one block of query rows


def plain_attention(q, k, v, scale: float, bias=None, kv_len=None) -> torch.Tensor:
    """(B, S, N, H) einsum attention with float32 softmax.

    The float32 logits of all rows may not fit the card (CogVideoX's merged CFG batch:
    2 x 48 heads x 17,776² x 4 B = 113 GiB), so the query rows go in blocks whose logits
    take at most ``PLAIN_LOGITS_BYTES``. Each row's softmax stays whole, so the function
    is the same; below the budget it is one block. A bias whose query axis has the
    queries' length is cut with the rows."""
    b, sq, n, _ = q.shape
    rows = max(1, PLAIN_LOGITS_BYTES // (4 * b * n * k.shape[1]))
    valid = None if kv_len is None else fa._kv_valid(kv_len, b, k.shape[1], q.device)
    kf = k.float()
    if rows >= sq:
        return _plain_rows(q, kf, v, scale, bias, valid)
    cut = bias is not None and bias.dim() >= 2 and bias.shape[-2] == sq
    return torch.cat([_plain_rows(q[:, s0:s0 + rows], kf, v, scale,
                                  bias[..., s0:s0 + rows, :] if cut else bias, valid)
                      for s0 in range(0, sq, rows)], dim=1)


def _plain_rows(q, kf, v, scale, bias, valid):
    logits = torch.einsum("bsnh,btnh->bnst", q.float(), kf) * scale
    if bias is not None:
        logits = logits + bias.float()
    if valid is not None:
        logits = logits.masked_fill(~valid[:, None, None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    del logits
    return torch.einsum("bnst,btnh->bsnh", probs, v)


def kernel_accepts(q, bias=None) -> bool:
    return (q.device.type == "cuda" and bias is None and q.shape[-1] == fa.HEAD_DIM
            and q.shape[1] >= 256 and q.dtype in fa.DTYPES)


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


def local_attention(q, k, v, impl: str = "auto", scale: float | None = None,
                    bias=None, bounded: bool = False, kv_len=None) -> torch.Tensor:
    """q: (B, Sq, N, H); k/v: (B, Skv, N, H) -> (B, Sq, N, H), on the tensors as given.

    impl: "auto" | "plain" | "flash" | "flash_int8" | "ring". "flash" always calls the
    flash wrappers (which compute their plain versions on CPU tensors); under grad they go
    through ``FlashAttentionFn`` (K3 forward, K4/K5 backward). "flash_int8" calls
    ``flash_attention_int8`` (K6 on CUDA tensors; raises under grad); a bias or a kv_len
    sends it to the plain attention, as JAX sends "pallas_int8" to XLA. "plain" always the
    einsum path, differentiated by autograd. "ring" here is "auto" (a ring of one rank).
    bounded: the caller's logits are small by construction, so the flash path takes
    K1 with its saturating clamp and skips the runtime bound.
    """
    _check_impl(impl)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if impl in ("auto", "ring"):
        impl = "flash" if kernel_accepts(q, bias) else "plain"
    if impl == "flash" and bias is None:
        return fa.flash_attention(q, k, v, scale=scale,
                                  dispatch="nomax" if bounded else "auto", kv_len=kv_len)
    if impl == "flash_int8" and bias is None and kv_len is None:
        return fa.flash_attention_int8(q, k, v, scale=scale)
    return plain_attention(q, k, v, scale, bias, kv_len)


def ring_applies(sq: int, skv: int, kv_len=None) -> bool:
    """JAX's condition for the ring (``attention.py:59-67``): an ambient mesh whose "sp"
    exceeds 1, no kv_len, and both global lengths divisible by "sp"."""
    from goal_force_tpu_torch.parallel.mesh import axis_size, current_mesh

    n = axis_size("sp")
    return (current_mesh() is not None and n > 1 and kv_len is None
            and sq % n == 0 and skv % n == 0)


def attention(q, k, v, impl: str = "auto", scale: float | None = None,
              bias=None, bounded: bool = False, kv_len=None) -> torch.Tensor:
    """q: (B, Sq, N, H); k/v: (B, Skv, N, H) -> (B, Sq, N, H).

    Without an ambient mesh, ``local_attention``. Under one, q, k and v are whole
    tensors that every rank holds alike (S2V's attentions), and so is the output:

      - impl "ring" where ``ring_applies``: each rank takes its slice of the queries and
        of the keys over "sp", its heads over "tp" and its batch rows over "dp" where
        those axes exceed 1 and divide, runs ``ring_attention`` and gathers the output
        back (JAX's ``_ring_sharded``); elsewhere "ring" is "auto";
      - otherwise each rank takes its heads over ("sp", "tp") and its batch rows over
        "dp" and runs ``local_attention`` on them, then the heads and rows are gathered
        (JAX's ``_pallas_sharded``). "auto" takes the runtime logit bound on the rank's
        own heads, as JAX's per-shard ``lax.cond`` does, so ranks may run different
        kernels (K1 or K2). Where the heads or the batch rows do not divide, every rank
        computes the whole attention.

    A bias sends every impl to the plain attention on the whole tensors, as in JAX.
    Inference only under a mesh: the gathers hand each rank the gradient of its own
    heads and rows.
    """
    from goal_force_tpu_torch.parallel.mesh import current_mesh

    _check_impl(impl)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if bias is not None:
        return plain_attention(q, k, v, scale, bias, kv_len)
    if current_mesh() is None:
        return local_attention(q, k, v, impl, scale, bounded=bounded, kv_len=kv_len)
    if impl == "ring" and ring_applies(q.shape[1], k.shape[1], kv_len):
        return _ring_replicated(q, k, v, scale)
    return _heads_sharded(q, k, v, impl, scale, bounded, kv_len)


def _heads_sharded(q, k, v, impl, scale, bounded, kv_len):
    from goal_force_tpu_torch.parallel import collectives as col
    from goal_force_tpu_torch.parallel.mesh import axes_rank, axes_size, axis_size

    heads = ("sp", "tp")
    b, n = q.shape[0], q.shape[2]
    per = n // axes_size(heads)
    if n % axes_size(heads) or b % axis_size("dp"):
        return local_attention(q, k, v, impl, scale, bounded=bounded, kv_len=kv_len)
    if torch.is_tensor(kv_len) and kv_len.dim() and kv_len.shape[0] == b:
        kv_len = col.split_batch(kv_len)
    lo = axes_rank(heads) * per
    q, k, v = (col.split_batch(t).narrow(2, lo, per) for t in (q, k, v))
    out = local_attention(q, k, v, impl, scale, bounded=bounded, kv_len=kv_len)
    return col.gather_batch(col._gather(out, 2, heads))


def _ring_replicated(q, k, v, scale):
    from goal_force_tpu_torch.parallel import collectives as col
    from goal_force_tpu_torch.parallel.mesh import axis_size
    from goal_force_tpu_torch.parallel.ring_attention import ring_attention

    rows = axis_size("dp") > 1 and q.shape[0] % axis_size("dp") == 0
    heads = axis_size("tp") > 1 and q.shape[2] % axis_size("tp") == 0
    if rows:
        q, k, v = (col.split_batch(t) for t in (q, k, v))
    if heads:
        q, k, v = (col.shard_of(t, 2) for t in (q, k, v))
    out = col.gather_seq(ring_attention(*(col.split_seq(t) for t in (q, k, v)), scale))
    if heads:
        out = col._gather(out, 2, "tp")
    return col.gather_batch(out) if rows else out


def sharded_cross_attention(q, k, v, impl: str = "auto", scale: float | None = None,
                            bounded: bool = False) -> torch.Tensor:
    """q (B, S/sp, N', H) holding this rank's tokens (split over "sp" of the ambient mesh,
    padded at the end), k and v (B, T, N', H) every key of its N' heads -> the output in
    q's layout. With impl "ring" where ``ring_applies`` to the real tokens and T, the keys
    split over "sp" and rotate (JAX's ``_ring_sharded`` of the cross-attention); otherwise
    ``local_attention``, with no collective. Without a mesh it is ``local_attention``."""
    from goal_force_tpu_torch.parallel import collectives as col
    from goal_force_tpu_torch.parallel.mesh import axis_rank, axis_size
    from goal_force_tpu_torch.parallel.ring_attention import ring_attention

    if scale is None:
        scale = q.shape[-1] ** -0.5
    if impl == "ring":
        n = axis_size("sp")
        valid = col.valid_tokens()
        if ring_applies(q.shape[1] * n if valid is None else valid, k.shape[1]):
            per = k.shape[1] // n
            lo = axis_rank("sp") * per
            return ring_attention(q, k.narrow(1, lo, per), v.narrow(1, lo, per), scale)
    return local_attention(q, k, v, impl, scale, bounded=bounded)


def _attend(q, k, v, impl, scale, bounded, kv_len):
    """``attention`` with the keys past kv_len masked. Under grad the training kernels
    (K3, K4/K5) take no kv_len: the valid tokens, a prefix, attend among themselves and
    the padded rows' output is zero (their gradient is dropped with them), which is the
    same function on every valid row."""
    if kv_len is not None and torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        out = local_attention(q[:, :kv_len], k[:, :kv_len], v[:, :kv_len], impl, scale,
                              bounded=bounded)
        pad = out.new_zeros((q.shape[0], q.shape[1] - kv_len, *out.shape[2:]))
        return torch.cat([out, pad], dim=1)
    return local_attention(q, k, v, impl, scale, bounded=bounded, kv_len=kv_len)


def sharded_attention(q, k, v, impl: str = "auto", scale: float | None = None,
                      bounded: bool = False) -> torch.Tensor:
    """Self-attention of q, k, v (B, S/sp, N', H) holding this rank's tokens (split
    over "sp" of the ambient mesh, padded at the end) of its N' heads -> the output in
    the same layout.

    impl "ring" where ``ring_applies`` (no padded token): ``ring_attention`` over the
    rank's own tokens (K3 per block; K4/K5 per block in the backward). Elsewhere "ring"
    is "auto", and: where "sp" divides N' the tokens are traded for heads
    (``seq_to_heads``), the dispatch of ``local_attention`` runs on this rank's N'/sp
    heads over every token (K1, or K2 through "auto", on a contiguous buffer; K3, then
    K4/K5 in the backward, under grad, whose backward exchanges hand the kernels a
    contiguous gradient) and ``heads_to_seq`` trades back. Where it does not, JAX
    computes plain attention on the whole tensor; here every rank gathers every token
    and runs the same dispatch on every head, then keeps its tokens (under grad, every
    rank's gradient of them). Padded keys (past ``collectives.valid_tokens()``) are
    masked (``_attend``). Without a mesh it is ``local_attention``."""
    from goal_force_tpu_torch.parallel import collectives as col
    from goal_force_tpu_torch.parallel.mesh import axis_size, current_mesh
    from goal_force_tpu_torch.parallel.ring_attention import ring_attention

    if scale is None:
        scale = q.shape[-1] ** -0.5
    if current_mesh() is None:
        return local_attention(q, k, v, impl, scale, bounded=bounded)
    n = axis_size("sp")
    valid = col.valid_tokens()
    kv_len = valid if valid is not None and valid != q.shape[1] * n else None
    if impl == "ring" and ring_applies(q.shape[1] * n, k.shape[1] * n, kv_len):
        return ring_attention(q, k, v, scale)
    if q.shape[2] % n == 0:
        q, k, v = (col.seq_to_heads(t) for t in (q, k, v))
        return col.heads_to_seq(_attend(q, k, v, impl, scale, bounded, kv_len))
    # the gathered tokens are the padded sequence, so each rank's slice is a plain
    # shard: under grad its backward gathers the whole gradient, as the replicated
    # attention before it needs
    q, k, v = (col.gather_seq(t) for t in (q, k, v))
    return col.shard_of(_attend(q, k, v, impl, scale, bounded, kv_len), 1, "sp")
