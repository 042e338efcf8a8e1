"""Attention dispatch.

Port of ``goal_force_tpu/ops/attention.py``: the plain einsum attention (float32
softmax, optional additive bias, prefix-valid ``kv_len``) and the choice between it and
the flash kernels. ``impl="auto"`` takes a kernel only where the kernel accepts the
call: a CUDA tensor, head_dim exactly 128 (the JAX dispatch tests ``% 128``, but its
kernel takes only 128), at least 256 queries and no bias. Everything else, such as the
tiny test configs, uses the plain attention, as JAX uses XLA attention for them.

The port names JAX's impls by what runs: JAX "xla" is "plain", "pallas" is "flash" and
"pallas_int8" is "flash_int8" (K6, int8 q and k, inference only).

``sharded_attention`` is the counterpart of JAX's ``_pallas_sharded``: under a mesh each
rank runs the kernel on its own heads over the whole sequence (Ulysses).
"""

from __future__ import annotations

import torch

from goal_force_tpu_torch.ops import flash_attention as fa


def plain_attention(q, k, v, scale: float, bias=None, kv_len=None) -> torch.Tensor:
    """(B, S, N, H) einsum attention with float32 softmax."""
    logits = torch.einsum("bsnh,btnh->bnst", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    if kv_len is not None:
        valid = fa._kv_valid(kv_len, q.shape[0], k.shape[1], q.device)
        logits = logits.masked_fill(~valid[:, None, None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bnst,btnh->bsnh", probs, v)


def kernel_accepts(q, bias=None) -> bool:
    return (q.device.type == "cuda" and bias is None and q.shape[-1] == fa.HEAD_DIM
            and q.shape[1] >= 256 and q.dtype in fa.DTYPES)


def attention(q, k, v, impl: str = "auto", scale: float | None = None,
              bias=None, bounded: bool = False, kv_len=None) -> torch.Tensor:
    """q: (B, Sq, N, H); k/v: (B, Skv, N, H) -> (B, Sq, N, H).

    impl: "auto" | "plain" | "flash" | "flash_int8". "flash" always calls the flash wrappers
    (which compute their plain versions on CPU tensors); under grad they go through
    ``FlashAttentionFn`` (K3 forward, K4/K5 backward). "flash_int8" calls
    ``flash_attention_int8`` (K6 on CUDA tensors; raises under grad); a bias or a kv_len
    sends it to the plain attention, as JAX sends "pallas_int8" to XLA. "plain" always the
    einsum path, differentiated by autograd.
    bounded: the caller's logits are small by construction, so the flash path takes
    K1 with its saturating clamp and skips the runtime bound.
    """
    if impl not in ("auto", "plain", "flash", "flash_int8"):
        raise ValueError(f"impl must be 'auto', 'plain', 'flash' or 'flash_int8', got {impl!r}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if impl == "auto":
        impl = "flash" if kernel_accepts(q, bias) else "plain"
    if impl == "flash" and bias is None:
        return fa.flash_attention(q, k, v, scale=scale,
                                  dispatch="nomax" if bounded else "auto", kv_len=kv_len)
    if impl == "flash_int8" and bias is None and kv_len is None:
        return fa.flash_attention_int8(q, k, v, scale=scale)
    return plain_attention(q, k, v, scale, bias, kv_len)


def _attend(q, k, v, impl, scale, bounded, kv_len):
    """``attention`` with the keys past kv_len masked. Under grad the training kernels
    (K3, K4/K5) take no kv_len: the valid tokens, a prefix, attend among themselves and
    the padded rows' output is zero (their gradient is dropped with them), which is the
    same function on every valid row."""
    if kv_len is not None and torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        out = attention(q[:, :kv_len], k[:, :kv_len], v[:, :kv_len], impl=impl, scale=scale,
                        bounded=bounded)
        pad = out.new_zeros((q.shape[0], q.shape[1] - kv_len, *out.shape[2:]))
        return torch.cat([out, pad], dim=1)
    return attention(q, k, v, impl=impl, scale=scale, bounded=bounded, kv_len=kv_len)


def sharded_attention(q, k, v, impl: str = "auto", scale: float | None = None,
                      bounded: bool = False) -> torch.Tensor:
    """Self-attention of q, k, v (B, S/sp, N', H) holding this rank's tokens (split
    over "sp" of the ambient mesh, padded at the end) of its N' heads -> the output in
    the same layout.

    Where "sp" divides N' the tokens are traded for heads (``seq_to_heads``), the
    dispatch of ``attention`` runs on this rank's N'/sp heads over every token (K1, or
    K2 through "auto", on a contiguous buffer; K3, then K4/K5 in the backward, under
    grad, whose backward exchanges hand the kernels a contiguous gradient) and
    ``heads_to_seq`` trades back. Where it does not, JAX computes plain attention on the
    whole tensor; here every rank gathers every token and runs the same dispatch on
    every head, then keeps its tokens (under grad, every rank's gradient of them). Padded keys (past ``collectives.valid_tokens()``)
    are masked (``_attend``). Without a mesh it is ``attention``."""
    from goal_force_tpu_torch.parallel import collectives as col
    from goal_force_tpu_torch.parallel.mesh import axis_size, current_mesh

    if current_mesh() is None:
        return attention(q, k, v, impl=impl, scale=scale, bounded=bounded)
    n = axis_size("sp")
    valid = col.valid_tokens()
    kv_len = valid if valid is not None and valid != q.shape[1] * n else None
    if q.shape[2] % n == 0:
        q, k, v = (col.seq_to_heads(t) for t in (q, k, v))
        return col.heads_to_seq(_attend(q, k, v, impl, scale, bounded, kv_len))
    # the gathered tokens are the padded sequence, so each rank's slice is a plain
    # shard: under grad its backward gathers the whole gradient, as the replicated
    # attention before it needs
    q, k, v = (col.gather_seq(t) for t in (q, k, v))
    return col.shard_of(_attend(q, k, v, impl, scale, bounded, kv_len), 1, "sp")
