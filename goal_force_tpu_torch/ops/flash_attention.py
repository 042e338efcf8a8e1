"""Flash attention: the CUDA kernels K1-K6, their plain versions and the autograd rule.

K1 (``flash_attention_nomax``) replaces ``goal_force_tpu/ops/flash_attention.py::
_fa_kernel_nomax`` and K2 (``flash_attention_max``) replaces ``_fa_kernel``; both
kernels live in ``csrc/flash_attention.cu``. Layout (B, S, N, 128) in and out,
non-causal, with an optional per-batch count of valid (prefix) keys ``kv_len``.

The training kernels live in ``csrc/flash_attention_bwd.cu``: K3
(``flash_attention_fwd_lse``, replaces ``_fa_kernel_fwd``) returns o and the
logsumexp (B, N, Sq) f32, K4 (``flash_attention_bwd_dkv``, replaces ``_fa_kernel_dkv``)
dK and dV, K5 (``flash_attention_bwd_dq``, replaces ``_fa_kernel_dq``) dQ. They follow
the JAX kernels' arithmetic: s = (q.k^T)*scale in f32 with no fold, natural exp,
lse = m + log(max(l, 1e-30)); p = exp(s - lse); di = rowsum(o*do) in f32;
dv += bf16(p)^T.do; ds = p*(do.v^T - di)*scale, rounded to q's dtype for dk and to
k's dtype for dq; sums in f32, outputs in the input dtypes. ``FlashAttentionFn`` is
the autograd rule of ``jax.custom_vjp`` ``_flash``: ``flash_attention`` takes it
whenever grad mode is on and q, k or v requires grad (K3 forward, K4 + K5 backward);
otherwise K1/K2 as below. K4 is skipped when neither k nor v needs a gradient.

Semantics shared by the kernels and their plain versions:
  - scale*log2(e) is rounded to q's dtype, multiplied into q and the product rounded
    to q's dtype (the JAX wrapper's fold); logits are then in the log2 domain;
  - K1: p = exp2(min(s, clamp)) with no running max (clamp = NOMAX_CLAMP under
    dispatch "nomax", none under "auto"); K2: online max, p = exp2(s - m);
  - keys at index >= kv_len contribute exactly 0, and a row with no valid key is 0;
  - p is cast to V's dtype before the PV product; sums are float32; the output has
    q's dtype.

K6 (``flash_attention_int8``, replaces ``_fa_kernel_int8``; ``csrc/flash_attention_int8.cu``)
is the inference-only int8-QK variant: ``quantize_tiles`` turns q and k into int8 codes
with one float32 scale per (batch, head, tile of ``block`` rows); the kernel computes
s = float(q_i8.k_i8) * ((scale*s_q)*s_k) per (row, key), the online max with the natural
exp, p rounded to V's dtype, float32 sums and o = acc * (1/l).

Every kernel computes 4 (K1, K2, K3, K6), 6 (K5) or 8 (K4) products of Sq x Skv x 128
per (batch, head) on O(S x 128) bytes, so it is bound by the tensor cores, which only
``wgmma`` drives at their full rate. The bf16 K1, K2, K3 and K6 therefore run on the
Hopper forward skeleton of ``csrc/flash_attention_sm90.cuh`` (a producer warp issues TMA
loads into an mbarrier ring, two consumer warpgroups run both products with wgmma and
take turns at the softmax), each as a policy that adds its softmax; K3's natural exp is
``ex2.approx`` of s*(scale*log2 e) - m*(scale*log2 e), which differs from JAX's exp only
in the float32 rounding of the argument. Their host-side geometry (tiles, grid, tensor
maps, shared memory) is computed here by ``sm90_geometry``, where the CPU tests reach
it, and passed to the C entry point, which only checks it, encodes the maps and launches.
The bf16 K4 and K5 run on the backward's Hopper roles
(``csrc/flash_attention_bwd_sm90.cuh``) after a pass that writes lse*log2(e) and di into
a float32 scratch; their geometry comes from ``sm90_bwd_geometry`` in the same way. The
float32 kernels are plain FMA loops, for exact checks.

A wrapper given CPU tensors computes the plain version (that is how the CPU tests run);
given CUDA tensors it launches its kernel or raises. ``launch_counts`` counts kernel
launches, so a run can show that it went through the kernels.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from goal_force_tpu_torch.ops import _build

HEAD_DIM = 128
NOMAX_CLAMP = 90.0          # log2-domain saturation point of K1 under dispatch "nomax"
NOMAX_BOUND = 100.0         # "auto" takes K1 only below this Cauchy-Schwarz logit bound
LOG2E = 1.4426950408889634
DTYPES = (torch.float32, torch.bfloat16)

launch_counts = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0, "K6": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# ---------------------------------------------------------------------------
# Host-side geometry of the Hopper kernels
# ---------------------------------------------------------------------------

SM90_TILE = 128             # query rows per CTA and keys per tile
SM90_STAGES = 2             # K/V ring slots
SM90_THREADS = 384          # producer warpgroup + two consumer warpgroups
SWIZZLE_SPAN = 128          # bytes: the widest box row the 128-byte swizzle takes
SMEM_LIMIT = 232448         # dynamic shared memory one CTA may use on an H100


@dataclass(frozen=True)
class TensorMap:
    """A rank-4 TMA map over the packed (B, S, N, 128) layout, innermost first."""
    dims: Tuple[int, int, int, int]        # (128, N, S, B)
    strides: Tuple[int, int, int]          # bytes from one index of dims 1, 2, 3 to the next
    box: Tuple[int, int, int, int]         # elements of one copy along each dim
    itemsize: int

    def values(self):
        return [*self.dims, *self.strides, *self.box]


@dataclass(frozen=True)
class Sm90Geometry:
    bq: int
    bk: int
    stages: int
    threads: int
    grid: Tuple[int, int, int]             # (q tiles per batch row, N, B)
    smem_bytes: int
    q: TensorMap
    k: TensorMap
    v: TensorMap

    def as_array(self):
        """The int64 array the C entry points take (layout in flash_attention_sm90.cuh)."""
        vals = [self.bq, self.bk, self.stages, self.threads, *self.grid, self.smem_bytes,
                *self.q.values(), *self.k.values(), *self.v.values()]
        return (ctypes.c_longlong * len(vals))(*vals)


def _packed_map(b: int, s: int, n: int, itemsize: int, rows: int) -> TensorMap:
    row = HEAD_DIM * itemsize
    return TensorMap(dims=(HEAD_DIM, n, s, b), strides=(row, n * row, s * n * row),
                     box=(SWIZZLE_SPAN // itemsize, 1, rows, 1), itemsize=itemsize)


def sm90_geometry(kernel: str, b: int, sq: int, skv: int, n: int) -> Sm90Geometry:
    """Tiles, grid, tensor maps and shared memory of a kernel on the Hopper forward
    skeleton: "K1", "K2" or "K3" (bf16 q/k/v) or "K6" (int8 q/k codes, bf16 v). One CTA
    per (128 query rows, head, batch row); each map is rank 4 so that TMA clips at each
    batch row's own end. Shared memory: 1024 bytes of alignment slack, the Q tile, per
    ring slot a K tile, a V tile and (K6) a table of 128 float32 k scales, and 1 + 3 x
    stages mbarriers of 8 bytes."""
    if kernel not in ("K1", "K2", "K3", "K6"):
        raise ValueError(f"sm90_geometry: unknown kernel {kernel!r}")
    qk_size = 1 if kernel == "K6" else 2
    t = SM90_TILE
    extra = 4 * t if kernel == "K6" else 0
    q_tile, k_tile, v_tile = t * HEAD_DIM * qk_size, t * HEAD_DIM * qk_size, t * HEAD_DIM * 2
    smem = 1024 + q_tile + SM90_STAGES * (k_tile + v_tile + extra) + 8 * (1 + 3 * SM90_STAGES)
    return Sm90Geometry(bq=t, bk=t, stages=SM90_STAGES, threads=SM90_THREADS,
                        grid=(-(-sq // t), n, b), smem_bytes=smem,
                        q=_packed_map(b, sq, n, qk_size, t), k=_packed_map(b, skv, n, qk_size, t),
                        v=_packed_map(b, skv, n, 2, t))


SM90_BWD = {"K4": (64, 128, 4, 256),   # (q rows per tile, keys per tile, ring slots, threads)
            "K5": (128, 64, 4, 384)}
SCRATCH_ROWS = 128          # the backward's lse*log2(e) / di scratch: Sq rounded up to this


@dataclass(frozen=True)
class Sm90BwdGeometry(Sm90Geometry):
    do: TensorMap = None
    scratch_rows: int = 0                  # rows per (batch, head) of the lse*log2e/di scratch

    def as_array(self):
        """The int64 array the C entry points take (layout in flash_attention_bwd_sm90.cuh)."""
        vals = [self.bq, self.bk, self.stages, self.threads, *self.grid, self.smem_bytes,
                *self.q.values(), *self.do.values(), *self.k.values(), *self.v.values(),
                self.scratch_rows]
        return (ctypes.c_longlong * len(vals))(*vals)


def sm90_bwd_geometry(kernel: str, b: int, sq: int, skv: int, n: int) -> Sm90BwdGeometry:
    """Tiles, grid, tensor maps (q, do, k, v; all bf16) and shared memory of the Hopper K4
    ("K4": one CTA per 128 keys, a ring of 64-row Q/dO tiles) or K5 ("K5": one CTA per
    128 q rows, a ring of 64-key K/V tiles). Shared memory: 1024 bytes of alignment slack,
    the CTA's two resident tiles, per ring slot two tiles (and for K4 a table of 64 lse and
    64 di float32 values), and 1 + 2 x stages mbarriers of 8 bytes. The (2, B, N,
    scratch_rows) float32 scratch holds lse*log2(e) and di, padded to SCRATCH_ROWS rows
    so that every 64-row table is one aligned bulk copy."""
    if kernel not in SM90_BWD:
        raise ValueError(f"sm90_bwd_geometry: unknown kernel {kernel!r}")
    bq, bk, stages, threads = SM90_BWD[kernel]
    tile = lambda rows: rows * HEAD_DIM * 2
    if kernel == "K4":
        smem = 1024 + 2 * tile(bk) + stages * (2 * tile(bq) + 8 * bq) + 8 * (1 + 2 * stages)
        grid = (-(-skv // bk), n, b)
    else:
        smem = 1024 + 2 * tile(bq) + stages * 2 * tile(bk) + 8 * (1 + 2 * stages)
        grid = (-(-sq // bq), n, b)
    return Sm90BwdGeometry(bq=bq, bk=bk, stages=stages, threads=threads, grid=grid,
                           smem_bytes=smem, q=_packed_map(b, sq, n, 2, bq),
                           do=_packed_map(b, sq, n, 2, bq), k=_packed_map(b, skv, n, 2, bk),
                           v=_packed_map(b, skv, n, 2, bk),
                           scratch_rows=-(-sq // SCRATCH_ROWS) * SCRATCH_ROWS)


def _check_tma_aligned(name: str, tensors) -> None:
    """TMA reads from 16-byte-aligned base addresses; the kernels take no other."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name} loads by TMA: its tensors must be 16-byte aligned")


def fold_constant(scale: float, dtype: torch.dtype) -> float:
    """scale*log2(e) rounded to `dtype` (the JAX fold multiplies by a weakly typed
    scalar, which takes q's dtype)."""
    return float(torch.tensor(scale * LOG2E, dtype=dtype))


def fold_q(q: torch.Tensor, scale: float) -> torch.Tensor:
    """q * scale*log2(e), rounded to q's dtype."""
    return (q.float() * fold_constant(scale, q.dtype)).to(q.dtype)


def _kv_valid(kv_len, b: int, skv: int, device) -> torch.Tensor:
    """(B, Skv) bool mask of valid keys."""
    col = torch.arange(skv, device=device)
    if kv_len is None:
        return torch.ones((b, skv), dtype=torch.bool, device=device)
    lens = torch.as_tensor(kv_len, dtype=torch.int64, device=device).expand(b)
    return col[None, :] < lens[:, None]


def _row_chunk(b: int, n: int, skv: int) -> int:
    """Query rows per step of the plain versions: keeps one f32 logit block <= 2 GiB."""
    return max(1, (1 << 29) // max(1, b * n * skv))


def _plain(q, k, v, scale, kv_len, clamp, online_max: bool):
    b, sq, n, _ = q.shape
    skv = k.shape[1]
    qs = fold_q(q, scale)
    kf, vf = k.float(), v.float()
    valid = _kv_valid(kv_len, b, skv, q.device)[:, None, None, :]     # (B,1,1,Skv)
    out = torch.empty_like(q)
    step = _row_chunk(b, n, skv)
    for s0 in range(0, sq, step):
        s = torch.einsum("bsnh,btnh->bnst", qs[:, s0:s0 + step].float(), kf)
        if online_max:
            s = s.masked_fill(~valid, float("-inf"))
            m = s.amax(dim=-1, keepdim=True)
            m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
            p = torch.exp2(s - m)
        else:
            if clamp is not None:
                s = s.clamp(max=clamp)
            p = torch.exp2(s).masked_fill(~valid, 0.0)
        l = p.sum(dim=-1)                                               # (B,N,s)
        acc = torch.einsum("bnst,btnh->bsnh", p.to(v.dtype).float(), vf)
        inv = torch.where(l == 0, torch.ones_like(l), 1.0 / l).permute(0, 2, 1)
        out[:, s0:s0 + step] = (acc * inv[..., None]).to(q.dtype)
    return out


def flash_attention_nomax_plain(q, k, v, scale: float, kv_len=None,
                                clamp: Optional[float] = NOMAX_CLAMP) -> torch.Tensor:
    """Plain torch version of K1 (float32 intermediates, chunked over query rows)."""
    return _plain(q, k, v, scale, kv_len, clamp, online_max=False)


def flash_attention_max_plain(q, k, v, scale: float, kv_len=None) -> torch.Tensor:
    """Plain torch version of K2. The max is taken over the whole row at once; the
    kernel's running max gives the same function."""
    return _plain(q, k, v, scale, kv_len, None, online_max=True)


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention expects (B, S, N, H) tensors")
    b, _, n, h = q.shape
    if h != HEAD_DIM:
        raise ValueError(f"flash attention requires head_dim={HEAD_DIM}, got {h}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES:
        raise ValueError(f"flash attention takes float32 or bfloat16 q/k/v of one dtype, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")


def _kernel_args(q, k, v, kv_len):
    if q.device.type != "cuda":
        raise RuntimeError(f"flash attention kernels run on CUDA tensors, got {q.device}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    b, sq, n, _ = q.shape
    skv = k.shape[1]
    if kv_len is None:
        lens = torch.full((b,), skv, dtype=torch.int32, device=q.device)
    else:
        lens = torch.as_tensor(kv_len, dtype=torch.int32).to(q.device).expand(b).contiguous()
    out = torch.empty_like(q)
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (q, k, v, out, lens)]
    dims = [ctypes.c_int(x) for x in (b, sq, skv, n)]
    return (q, k, v, lens), out, ptrs, dims, stream


def _fwd_geometry(name: str, q, k, v):
    """bf16: the skeleton's geometry array, after TMA's alignment check; float32: None."""
    if q.dtype != torch.bfloat16:
        return None
    _check_tma_aligned(name, (q, k, v))
    return sm90_geometry(name, q.shape[0], q.shape[1], k.shape[1], q.shape[2]).as_array()


def _lib():
    lib = _build.load("flash_attention")
    if not getattr(lib, "_gf_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        g = ctypes.POINTER(ctypes.c_longlong)
        lib.gf_fa_nomax.argtypes = [i, p, p, p, p, p, i, i, i, i, f, i, f, g, p]
        lib.gf_fa_nomax.restype = i
        lib.gf_fa_max.argtypes = [i, p, p, p, p, p, i, i, i, i, f, g, p]
        lib.gf_fa_max.restype = i
        lib._gf_typed = True
    return lib


def flash_attention_nomax(q, k, v, scale: float, kv_len=None,
                          clamp: Optional[float] = NOMAX_CLAMP) -> torch.Tensor:
    """K1: max-free flash attention (clamp=None: no saturation)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_nomax_plain(q, k, v, scale, kv_len, clamp)
    keep, out, ptrs, dims, stream = _kernel_args(q, k, v, kv_len)
    geom = _fwd_geometry("K1", *keep[:3])
    rc = _lib().gf_fa_nomax(int(q.dtype == torch.bfloat16), *ptrs, *dims,
                            fold_constant(scale, q.dtype), int(clamp is not None),
                            float(clamp or 0.0), geom, stream)
    if rc != 0:
        raise RuntimeError(f"K1 flash-attention launch failed: CUDA error {rc}")
    launch_counts["K1"] += 1
    return out


def flash_attention_max(q, k, v, scale: float, kv_len=None) -> torch.Tensor:
    """K2: online-max flash attention."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_max_plain(q, k, v, scale, kv_len)
    keep, out, ptrs, dims, stream = _kernel_args(q, k, v, kv_len)
    rc = _lib().gf_fa_max(int(q.dtype == torch.bfloat16), *ptrs, *dims,
                          fold_constant(scale, q.dtype), _fwd_geometry("K2", *keep[:3]), stream)
    if rc != 0:
        raise RuntimeError(f"K2 flash-attention launch failed: CUDA error {rc}")
    launch_counts["K2"] += 1
    return out


# ---------------------------------------------------------------------------
# Training: K3 (forward with logsumexp), K4 (dK, dV), K5 (dQ)
# ---------------------------------------------------------------------------

def flash_attention_fwd_lse_plain(q, k, v, scale: float):
    """Plain torch version of K3: (o, lse) with lse (B, N, Sq) float32. The max is
    taken over the whole row at once; the kernel's running max gives the same function."""
    b, sq, n, _ = q.shape
    kf, vf = k.float(), v.float()
    out = torch.empty_like(q)
    lse = torch.empty((b, n, sq), dtype=torch.float32, device=q.device)
    step = _row_chunk(b, n, k.shape[1])
    for s0 in range(0, sq, step):
        s = torch.einsum("bsnh,btnh->bnst", q[:, s0:s0 + step].float(), kf) * scale
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1)                                               # (B,N,s)
        acc = torch.einsum("bnst,btnh->bsnh", p.to(v.dtype).float(), vf)
        inv = torch.where(l == 0, torch.ones_like(l), 1.0 / l).permute(0, 2, 1)
        out[:, s0:s0 + step] = (acc * inv[..., None]).to(q.dtype)
        lse[:, :, s0:s0 + step] = m[..., 0] + torch.log(torch.clamp(l, min=1e-30))
    return out, lse


def _bwd_plain(q, k, v, o, do, lse, scale: float, dkv: bool):
    """Plain torch version of K4 (dkv=True: returns dk, dv) or K5 (returns dq)."""
    b, sq, n, _ = q.shape
    kf, vf = k.float(), v.float()
    di = (o.float() * do.float()).sum(dim=-1).permute(0, 2, 1)        # (B,N,Sq)
    if dkv:
        dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    else:
        dq = torch.empty_like(q)
    step = _row_chunk(b, n, k.shape[1])
    for s0 in range(0, sq, step):
        qs, dos = q[:, s0:s0 + step].float(), do[:, s0:s0 + step]
        s = torch.einsum("bsnh,btnh->bnst", qs, kf) * scale
        p = torch.exp(s - lse[:, :, s0:s0 + step, None])
        dp = torch.einsum("bsnh,btnh->bnst", dos.float(), vf)
        ds = p * (dp - di[:, :, s0:s0 + step, None]) * scale
        if dkv:
            dv += torch.einsum("bnst,bsnh->btnh", p.to(do.dtype).float(), dos.float())
            dk += torch.einsum("bnst,bsnh->btnh", ds.to(q.dtype).float(), qs)
        else:
            dq[:, s0:s0 + step] = torch.einsum(
                "bnst,btnh->bsnh", ds.to(k.dtype).float(), kf).to(q.dtype)
    return (dk.to(k.dtype), dv.to(v.dtype)) if dkv else dq


def flash_attention_bwd_dkv_plain(q, k, v, o, do, lse, scale: float):
    """Plain torch version of K4: (dk, dv)."""
    return _bwd_plain(q, k, v, o, do, lse, scale, dkv=True)


def flash_attention_bwd_dq_plain(q, k, v, o, do, lse, scale: float):
    """Plain torch version of K5: dq."""
    return _bwd_plain(q, k, v, o, do, lse, scale, dkv=False)


def _check_bwd(q, k, v, o, do, lse):
    _check(q, k, v)
    b, sq, n, _ = q.shape
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"o and do must match q {tuple(q.shape)} {q.dtype}, got "
                         f"{tuple(o.shape)} {o.dtype} and {tuple(do.shape)} {do.dtype}")
    if tuple(lse.shape) != (b, n, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 {(b, n, sq)}, got {lse.dtype} {tuple(lse.shape)}")
    if any(t.device != q.device for t in (o, do, lse)):
        raise ValueError("all flash-attention operands must lie on one device")


def _bwd_lib():
    lib = _build.load("flash_attention_bwd")
    if not getattr(lib, "_gf_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        g = ctypes.POINTER(ctypes.c_longlong)
        lib.gf_fa_fwd_lse.argtypes = [i, p, p, p, p, p, i, i, i, i, f, g, p]
        lib.gf_fa_bwd_dkv.argtypes = [i, p, p, p, p, p, p, p, p, p, i, i, i, i, f, g, p]
        lib.gf_fa_bwd_dq.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, i, f, g, p]
        for fn in (lib.gf_fa_fwd_lse, lib.gf_fa_bwd_dkv, lib.gf_fa_bwd_dq):
            fn.restype = i
        lib._gf_typed = True
    return lib


def flash_attention_fwd_lse(q, k, v, scale: float):
    """K3: (o, lse) with o like q and lse (B, N, Sq) float32."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_fwd_lse_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash attention kernels run on CUDA tensors, got {q.device}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    b, sq, n, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, n, sq), dtype=torch.float32, device=q.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    rc = _bwd_lib().gf_fa_fwd_lse(int(q.dtype == torch.bfloat16),
                                  *[ctypes.c_void_p(t.data_ptr()) for t in (q, k, v, o, lse)],
                                  b, sq, k.shape[1], n, float(scale),
                                  _fwd_geometry("K3", q, k, v), stream)
    if rc != 0:
        raise RuntimeError(f"K3 flash-attention launch failed: CUDA error {rc}")
    launch_counts["K3"] += 1
    return o, lse


def _launch_bwd(name: str, fn, q, k, v, o, do, lse, outs, scale: float) -> None:
    """K4 or K5 on CUDA tensors. bf16 runs the Hopper kernel: the wrapper checks TMA's
    alignment, allocates the lse*log2(e) / di scratch the C side fills first and passes
    the geometry of ``sm90_bwd_geometry``; float32 takes neither."""
    if q.device.type != "cuda":
        raise RuntimeError(f"flash attention kernels run on CUDA tensors, got {q.device}")
    b, sq, n, _ = q.shape
    scratch, geom = None, None
    if q.dtype == torch.bfloat16:
        _check_tma_aligned(name, (q, k, v, o, do))
        g = sm90_bwd_geometry(name, b, sq, k.shape[1], n)
        scratch = torch.empty((2, b, n, g.scratch_rows), dtype=torch.float32, device=q.device)
        geom = g.as_array()
    ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    rc = fn(int(q.dtype == torch.bfloat16),
            *[ptr(t) for t in (q, k, v, o, do, lse, scratch, *outs)],
            b, sq, k.shape[1], n, float(scale), geom, stream)
    if rc != 0:
        raise RuntimeError(f"{name} flash-attention launch failed: CUDA error {rc}")
    launch_counts[name] += 1


def flash_attention_bwd_dkv(q, k, v, o, do, lse, scale: float):
    """K4: (dk, dv) in k's and v's dtype."""
    _check_bwd(q, k, v, o, do, lse)
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_plain(q, k, v, o, do, lse, scale)
    q, k, v, o, do, lse = (t.contiguous() for t in (q, k, v, o, do, lse))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("K4", _bwd_lib().gf_fa_bwd_dkv, q, k, v, o, do, lse, (dk, dv), scale)
    return dk, dv


def flash_attention_bwd_dq(q, k, v, o, do, lse, scale: float):
    """K5: dq in q's dtype."""
    _check_bwd(q, k, v, o, do, lse)
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, o, do, lse, scale)
    q, k, v, o, do, lse = (t.contiguous() for t in (q, k, v, o, do, lse))
    dq = torch.empty_like(q)
    _launch_bwd("K5", _bwd_lib().gf_fa_bwd_dq, q, k, v, o, do, lse, (dq,), scale)
    return dq


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable flash attention: K3 forward saving (q, k, v, o, lse), then K4
    (skipped when neither k nor v needs a gradient) and K5 in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_attention_fwd_lse(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        dq = dk = dv = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dk, dv = flash_attention_bwd_dkv(q, k, v, o, do, lse, ctx.scale)
        if ctx.needs_input_grad[0]:
            dq = flash_attention_bwd_dq(q, k, v, o, do, lse, ctx.scale)
        return dq, dk, dv, None


# ---------------------------------------------------------------------------
# Inference with int8 q and k: K6
# ---------------------------------------------------------------------------

def int8_blocks(sq: int, skv: int, block_q: int = 1024, block_k: int = 1024):
    """The quantization tiles JAX's flash_attention_int8 takes: min(block, max(128, S))."""
    return min(block_q, max(HEAD_DIM, sq)), min(block_k, max(HEAD_DIM, skv))


def quantize_tiles(x: torch.Tensor, block: int):
    """(B, S, N, H) -> int8 codes (B, S, N, H) and float32 scales (B, N, ceil(S/block)).

    One scale per (batch, head, tile of `block` rows): max(amax, 1e-6)/127 with the amax
    over the tile's rows and all H lanes (rows past S are zero, as JAX pads them); codes
    round(x / scale), half to even. The counterpart of JAX ``_quantize_tiles``."""
    b, s, n, h = x.shape
    t = -(-s // block)
    xf = x.new_zeros((b, t * block, n, h), dtype=torch.float32)
    xf[:, :s] = x
    xt = xf.view(b, t, block, n, h)
    amax = torch.maximum(xt.amax(dim=(2, 4)), -xt.amin(dim=(2, 4)))       # (B, T, N)
    sc = amax.clamp(min=1e-6) / 127.0
    xt.div_(sc[:, :, None, :, None]).round_()
    return xf[:, :s].to(torch.int8).contiguous(), sc.transpose(1, 2).contiguous()


def _int8_plain(qi, sqs, ki, sks, v, scale: float, block_q: int, block_k: int):
    """Plain torch version of K6 on codes and scales: float32 einsums chunked over query
    rows (the integer products are exact in float32)."""
    b, sq, n, _ = qi.shape
    skv = ki.shape[1]
    qrow = scale * sqs[:, :, torch.arange(sq, device=qi.device) // block_q]   # (B,N,Sq)
    kcol = sks[:, :, torch.arange(skv, device=qi.device) // block_k]         # (B,N,Skv)
    kf, vf = ki.float(), v.float()
    out = torch.empty(qi.shape, dtype=v.dtype, device=v.device)
    step = _row_chunk(b, n, skv)
    for s0 in range(0, sq, step):
        s = torch.einsum("bsnh,btnh->bnst", qi[:, s0:s0 + step].float(), kf)
        s = s * (qrow[:, :, s0:s0 + step, None] * kcol[:, :, None, :])
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        l = p.sum(dim=-1)                                               # (B,N,s)
        acc = torch.einsum("bnst,btnh->bsnh", p.to(v.dtype).float(), vf)
        inv = torch.where(l == 0, torch.ones_like(l), 1.0 / l).permute(0, 2, 1)
        out[:, s0:s0 + step] = (acc * inv[..., None]).to(v.dtype)
    return out


def _check_int8(q, k, v):
    _check(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError("flash_attention_int8 is inference-only (not differentiable)")


def flash_attention_int8_plain(q, k, v, scale: float, block_q: int = 1024,
                               block_k: int = 1024) -> torch.Tensor:
    """Plain torch version of the int8-QK attention (the quantize step, then K6's
    arithmetic with the max over the whole row; the kernel's running max gives the same
    function)."""
    _check_int8(q, k, v)
    bq, bk = int8_blocks(q.shape[1], k.shape[1], block_q, block_k)
    qi, sqs = quantize_tiles(q, bq)
    ki, sks = quantize_tiles(k, bk)
    return _int8_plain(qi, sqs, ki, sks, v, scale, bq, bk)


def _int8_lib():
    lib = _build.load("flash_attention_int8")
    if not getattr(lib, "_gf_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        g = ctypes.POINTER(ctypes.c_longlong)
        lib.gf_fa_int8.argtypes = [i, p, p, p, p, p, p, i, i, i, i, i, i, i, i, f, g, p]
        lib.gf_fa_int8.restype = i
        lib._gf_typed = True
    return lib


def flash_attention_int8_codes(qi, sqs, ki, sks, v, scale: float, block_q: int,
                               block_k: int) -> torch.Tensor:
    """K6 on int8 codes (B, S, N, 128) and their tile scales (B, N, T) from
    ``quantize_tiles(., block_q|block_k)``; v (B, Skv, N, 128) f32 or bf16 -> o like v."""
    b, sq, n, h = qi.shape
    skv = ki.shape[1]
    tq, tk = -(-sq // block_q), -(-skv // block_k)
    if (qi.dtype != torch.int8 or ki.dtype != torch.int8 or h != HEAD_DIM
            or tuple(ki.shape) != (b, skv, n, h) or v.shape != ki.shape or v.dtype not in DTYPES
            or tuple(sqs.shape) != (b, n, tq) or tuple(sks.shape) != (b, n, tk)
            or sqs.dtype != torch.float32 or sks.dtype != torch.float32):
        raise ValueError(f"K6 takes int8 q {tuple(qi.shape)}, k {tuple(ki.shape)} with float32 "
                         f"tile scales {tuple(sqs.shape)}, {tuple(sks.shape)} and f32/bf16 v "
                         f"{tuple(v.shape)} {v.dtype}")
    if qi.device.type == "cpu":
        return _int8_plain(qi, sqs, ki, sks, v, scale, block_q, block_k)
    if qi.device.type != "cuda":
        raise RuntimeError(f"flash attention kernels run on CUDA tensors, got {qi.device}")
    tensors = [t.contiguous() for t in (qi, ki, v)]
    _check_tma_aligned("K6", tensors)
    geom = (sm90_geometry("K6", b, sq, skv, n).as_array() if v.dtype == torch.bfloat16
            else None)
    out = torch.empty(qi.shape, dtype=v.dtype, device=v.device)
    tensors += [out, sqs.contiguous(), sks.contiguous()]
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in tensors]
    stream = ctypes.c_void_p(torch.cuda.current_stream(qi.device).cuda_stream)
    rc = _int8_lib().gf_fa_int8(int(v.dtype == torch.bfloat16), *ptrs, b, sq, skv, n, tq, tk,
                                block_q, block_k, float(scale), geom, stream)
    if rc != 0:
        raise RuntimeError(f"K6 flash-attention launch failed: CUDA error {rc}")
    launch_counts["K6"] += 1
    return out


def flash_attention_int8(q, k, v, scale: float, block_q: int = 1024,
                         block_k: int = 1024) -> torch.Tensor:
    """Int8-QK flash attention (inference only): q: (B, Sq, N, 128); k/v: (B, Skv, N, 128).

    The counterpart of JAX ``flash_attention_int8``: the tiles are clamped as there
    (``int8_blocks``), q and k are quantized with ``quantize_tiles`` (torch ops), then K6
    runs on CUDA tensors; CPU tensors take the plain version. Raises under grad."""
    _check_int8(q, k, v)
    bq, bk = int8_blocks(q.shape[1], k.shape[1], block_q, block_k)
    qi, sqs = quantize_tiles(q, bq)
    ki, sks = quantize_tiles(k, bk)
    return flash_attention_int8_codes(qi, sqs, ki, sks, v, scale, bq, bk)


def logit_bound(q, k, v, scale: float) -> torch.Tensor:
    """Cauchy-Schwarz bound on every log2-domain logit plus log2(max|v|): below
    NOMAX_BOUND the max-free kernel provably keeps l and acc inside float32."""
    qs = fold_q(q, scale).float()
    qmax = qs.square().sum(-1).amax().sqrt()
    kmax = k.float().square().sum(-1).amax().sqrt()
    vmax = v.float().abs().amax()
    return qmax * kmax + torch.log2(torch.clamp(vmax, min=1.0))


def flash_attention(q, k, v, scale: float, dispatch: str = "auto", kv_len=None) -> torch.Tensor:
    """q: (B, Sq, N, 128); k/v: (B, Skv, N, 128) -> (B, Sq, N, 128).

    Under grad (grad mode on and q, k or v requiring grad) the call goes through
    ``FlashAttentionFn`` (K3, then K4/K5 in the backward) whatever the dispatch, as the
    JAX custom VJP's forward rule does; kv_len is then refused (inference only).
    Otherwise, dispatch "nomax": K1 with the saturating clamp (callers whose logits are
    bounded by construction, e.g. qk-RMS-normed attention). "auto": the logit bound is
    computed on the device (one host sync) and selects K1 without clamp below
    NOMAX_BOUND, else K2.
    """
    if dispatch not in ("auto", "nomax"):
        raise ValueError(f"dispatch must be 'auto' or 'nomax', got {dispatch!r}")
    _check(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if kv_len is not None:
            raise ValueError("flash attention with kv_len is inference-only (not differentiable)")
        return FlashAttentionFn.apply(q, k, v, scale)
    if dispatch == "nomax":
        return flash_attention_nomax(q, k, v, scale, kv_len, clamp=NOMAX_CLAMP)
    if float(logit_bound(q, k, v, scale)) < NOMAX_BOUND:
        return flash_attention_nomax(q, k, v, scale, kv_len, clamp=None)
    return flash_attention_max(q, k, v, scale, kv_len)
