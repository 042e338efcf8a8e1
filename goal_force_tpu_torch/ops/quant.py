"""Quantized linear layers: W8A8 int8 and fp8 e4m3 packs.

Port of ``goal_force_tpu/ops/quant.py`` with the same arithmetic:

- weights: one float32 scale per output channel, the amax over the input axis,
  ``max(amax, 1e-8) / 127`` (int8, codes ``round(w / scale)``, half to even) or
  ``/ FP8_MAX`` (e4m3, codes ``(w / scale)`` rounded to e4m3);
- activations: one dynamic scale per token (row), computed the same way;
- the product: int8 x int8 -> int32 (``torch._int_mm``) or e4m3 x e4m3 -> float32
  (``torch._scaled_mm`` with unit scales), then ``acc.float() * x_scale * w_scale``,
  multiplied in that order, ``+ bias.float()``, and a cast to x's dtype.

The products are plain matrix products, as in the JAX package (``lax.dot_general``
outside any Pallas kernel), so they go to the library. A pack is an ``nn.Module``
holding ``weight`` (codes, torch's (out, in) layout), a float32 ``weight_scale`` (out,)
and ``bias``; ``quantize_linear_modules`` puts packs in place of the ``nn.Linear``s
under the named children, the counterpart of ``quantize_linear_tree`` and
``quantize_linear_tree_fp8``. Norm weights are never packed: only ``nn.Linear``s are
replaced (the JAX fp8 walk lacks the int8 walk's ``norm*`` guard; this port does not
carry that over).
"""

from __future__ import annotations

from typing import Iterable, Mapping

import torch
from torch import nn

FP8_MAX = 448.0                  # float8_e4m3fn finite max
FP8 = torch.float8_e4m3fn
CHUNK_BYTES = 1 << 30            # float32 bytes of one row chunk of the product
MIN_CUDA_ROWS = 17               # torch._int_mm on CUDA wants more than 16 rows


def _weight_scale(w: torch.Tensor, qmax: float) -> torch.Tensor:
    """(out, in) -> (out,) float32: max(amax over the input axis, 1e-8) / qmax."""
    return w.float().abs().amax(dim=-1).clamp(min=1e-8) / qmax


def quantize_weight_int8(w: torch.Tensor):
    """(out, in) weight -> (int8 codes (out, in), float32 scales (out,))."""
    scale = _weight_scale(w, 127.0)
    return torch.round(w.float() / scale[:, None]).to(torch.int8), scale


def quantize_weight_fp8(w: torch.Tensor):
    """(out, in) weight -> (e4m3 codes (out, in), float32 scales (out,))."""
    scale = _weight_scale(w, FP8_MAX)
    return (w.float() / scale[:, None]).to(FP8), scale


def _rows_per_chunk(k: int, n: int) -> int:
    return max(1, CHUNK_BYTES // (4 * max(k, n)))


def _matmul_codes(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """(M, K) codes x (N, K) codes -> (M, N): int32 for int8, float32 for e4m3."""
    m = xq.shape[0]
    if xq.dtype != torch.int8:
        one = torch.ones((), dtype=torch.float32, device=xq.device)
        return torch._scaled_mm(xq, wq.t(), one, one, out_dtype=torch.float32)
    pad = MIN_CUDA_ROWS - m if xq.is_cuda and m < MIN_CUDA_ROWS else 0
    if pad:
        xq = torch.cat([xq, xq.new_zeros((pad, xq.shape[1]))])
    acc = torch._int_mm(xq, wq.t())
    return acc[:m] if pad else acc


def _quant_linear(x, weight, weight_scale, bias, qmax: float, code_dtype,
                  row_amax=None, reduce=None) -> torch.Tensor:
    """The W8A8 / fp8 linear on (..., K) x, chunked over rows: each row has its own
    activation scale, so chunking computes the same function. A row-parallel linear
    under a mesh, whose x holds some of each row's columns and whose codes the matching
    input columns, passes row_amax (..., 1), each row's amax over the whole row, and
    `reduce`, which sums each chunk's accumulator over the ranks (exact for int8's
    int32) before the rescale."""
    k, n = x.shape[-1], weight.shape[0]
    rows = x.reshape(-1, k)
    amax = None if row_amax is None else row_amax.reshape(-1, 1)

    def chunk(xs: torch.Tensor, am) -> torch.Tensor:
        xf = xs.float()
        if am is None:
            am = xf.abs().amax(dim=-1, keepdim=True)
        x_scale = am.clamp(min=1e-8) / qmax
        xf = xf / x_scale
        xq = torch.round(xf).to(code_dtype) if code_dtype == torch.int8 else xf.to(code_dtype)
        del xf
        acc = _matmul_codes(xq, weight)
        if reduce is not None:
            acc = reduce(acc)
        y = acc.float() * x_scale * weight_scale
        if bias is not None:
            y = y + bias.float()
        return y.to(x.dtype)

    step = _rows_per_chunk(k, n)
    if rows.shape[0] <= step:
        return chunk(rows, amax).reshape(*x.shape[:-1], n)
    out = torch.empty((rows.shape[0], n), dtype=x.dtype, device=x.device)
    for r0 in range(0, rows.shape[0], step):
        out[r0:r0 + step] = chunk(rows[r0:r0 + step],
                                  None if amax is None else amax[r0:r0 + step])
    return out.reshape(*x.shape[:-1], n)


def int8_linear(x, weight, weight_scale, bias=None, row_amax=None, reduce=None) -> torch.Tensor:
    """W8A8: per-token dynamic int8 activations, int8 x int8 -> int32, rescale."""
    return _quant_linear(x, weight, weight_scale, bias, 127.0, torch.int8, row_amax, reduce)


def fp8_linear(x, weight, weight_scale, bias=None, row_amax=None, reduce=None) -> torch.Tensor:
    """scaled_mm semantics: per-token dynamic e4m3 activations, float32 accumulation,
    rescale by x_scale * w_scale."""
    return _quant_linear(x, weight, weight_scale, bias, FP8_MAX, FP8, row_amax, reduce)


class QuantLinear(nn.Module):
    """A packed linear: ``weight`` codes (out, in), float32 ``weight_scale`` (out,),
    ``bias`` in the model dtype (or None)."""

    code_dtype: torch.dtype          # set by the subclasses, with quantize and forward_fn

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("weight", torch.empty((out_features, in_features),
                                                   dtype=self.code_dtype, device=device))
        self.register_buffer("weight_scale", torch.empty((out_features,), dtype=torch.float32,
                                                         device=device))
        self.bias = (nn.Parameter(torch.empty(out_features, dtype=dtype, device=device),
                                  requires_grad=False) if bias else None)

    @classmethod
    @torch.no_grad()
    def from_linear(cls, lin: nn.Linear) -> "QuantLinear":
        pack = cls(lin.in_features, lin.out_features, lin.bias is not None,
                   dtype=lin.weight.dtype, device="meta")
        pack.weight, pack.weight_scale = cls.quantize(lin.weight)
        if lin.bias is not None:
            pack.bias = nn.Parameter(lin.bias.detach(), requires_grad=False)
        return pack

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_fn(x, self.weight, self.weight_scale, self.bias)

    def _apply(self, fn, recurse=True):
        # Module.to(dtype) casts every floating-point tensor, and e4m3 codes and the
        # float32 scales count as floating point: they keep their dtype and only move.
        kept = {name: self._buffers.pop(name) for name in ("weight", "weight_scale")}
        try:
            super()._apply(fn, recurse)
        finally:
            for name, t in kept.items():
                probe = fn(t.new_empty(0))
                self._buffers[name] = fn(t) if probe.dtype == t.dtype else t.to(probe.device)
        return self

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"bias={self.bias is not None}")


class Int8Linear(QuantLinear):
    code_dtype = torch.int8
    quantize = staticmethod(quantize_weight_int8)
    forward_fn = staticmethod(int8_linear)


class Fp8Linear(QuantLinear):
    code_dtype = FP8
    quantize = staticmethod(quantize_weight_fp8)
    forward_fn = staticmethod(fp8_linear)


PACKS = {"int8": Int8Linear, "fp8": Fp8Linear}


def _replace_linears(module: nn.Module, paths, make, in_target: bool = False) -> None:
    for name, child in module.named_children():
        if isinstance(child, nn.Linear) and in_target:
            setattr(module, name, make(child))
        else:
            _replace_linears(child, paths, make, in_target or name in paths)


@torch.no_grad()
def quantize_linear_modules(module: nn.Module, paths: Iterable[str] = ("ffn",),
                            kind: str = "int8") -> nn.Module:
    """Replace, in place, every ``nn.Linear`` under a child named in ``paths`` with an
    ``Int8Linear`` (kind "int8") or ``Fp8Linear`` (kind "fp8") pack of its weights. One
    linear at a time, so a quantized model never holds two copies of its weights."""
    if kind not in PACKS:
        raise ValueError(f"kind must be 'int8' or 'fp8', got {kind!r}")
    _replace_linears(module, set(paths), PACKS[kind].from_linear)
    return module


def pack_like_state_dict(module: nn.Module, state_dict: Mapping[str, torch.Tensor]) -> nn.Module:
    """Replace, in place, the ``nn.Linear``s that ``state_dict`` holds as packs (a
    ``<prefix>.weight_scale`` entry) with empty packs of the kind their codes' dtype
    names, so that ``load_state_dict`` then loads the packed weights."""
    kinds = {cls.code_dtype: cls for cls in PACKS.values()}

    def walk(mod: nn.Module, prefix: str) -> None:
        for name, child in mod.named_children():
            key = f"{prefix}{name}"
            if isinstance(child, nn.Linear) and f"{key}.weight_scale" in state_dict:
                codes = state_dict[f"{key}.weight"]
                if codes.dtype not in kinds:
                    raise ValueError(f"{key}.weight: no pack holds {codes.dtype} codes")
                setattr(mod, name, kinds[codes.dtype](
                    child.in_features, child.out_features, child.bias is not None,
                    dtype=child.weight.dtype, device=child.weight.device))
            else:
                walk(child, key + ".")

    walk(module, "")
    return module
