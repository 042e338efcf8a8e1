"""The Hopper K1-K6: their host-side geometry, and their plain versions at the tiles'
edges against the JAX Pallas kernels (interpret mode, CPU).

``sm90_geometry`` computes the tiles, grid, tensor maps and shared memory that the C
entry points only check, encode and launch with; here a small model of a TMA box copy
(coordinates within the map's dims, zero fill outside, byte strides) reads the packed
layout through each map, so a wrong stride, box or rank fails on the CPU. The kernels'
tiles are 128 query rows by 128 keys, so Sq and Skv of 127 and 129 put a ragged tile
at every batch row's end; the plain versions are held to JAX there, with kv_len on both
sides of a tile edge. The kernels themselves are held against the plain versions on the
card in test_torch_kernels_cuda.py and by chip_smoke.py.
"""

import math
import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from goal_force_tpu.ops.flash_attention import _fa_forward, _flash_bwd
from goal_force_tpu.ops.flash_attention import flash_attention as jax_flash
from goal_force_tpu.ops.flash_attention import flash_attention_int8 as jax_int8

from goal_force_tpu_torch.ops import _build
from goal_force_tpu_torch.ops import flash_attention as tfa

H = 128
EDGES = [(127, 127), (127, 129), (129, 127), (129, 129)]


def _rand(shape, seed, mult=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * mult).astype(np.float32)


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sq,tiles", [(127, 1), (128, 1), (129, 2), (1000, 8), (1560, 13),
                                      (32760, 256)])
@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K6"])
def test_q_tiles_per_batch_row(kernel, sq, tiles):
    g = tfa.sm90_geometry(kernel, 2, sq, 512, 40)
    assert g.grid == (tiles, 40, 2)
    assert g.bq == g.bk == 128 and g.threads == 384


@pytest.mark.parametrize("kernel,qk_size", [("K1", 2), ("K2", 2), ("K3", 2), ("K6", 1)])
def test_maps_are_rank4_over_the_packed_layout(kernel, qk_size):
    b, sq, skv, n = 2, 32760, 512, 40
    g = tfa.sm90_geometry(kernel, b, sq, skv, n)
    for m, s, size in ((g.q, sq, qk_size), (g.k, skv, qk_size), (g.v, skv, 2)):
        row = H * size
        assert m.itemsize == size
        assert m.dims == (H, n, s, b)                       # rank 4: B is a dim of its own
        assert m.strides == (row, n * row, s * n * row)     # bytes: head, row, batch row
        assert all(st % 16 == 0 for st in m.strides)         # TMA's stride rule
        assert m.box[0] * size == tfa.SWIZZLE_SPAN           # one 128-byte swizzle span
        assert m.box[1:] == (1, 128, 1)
        assert len(m.values()) == 11


@pytest.mark.parametrize("kernel,smem", [("K1", 1024 + 32768 + 2 * 65536 + 56),
                                         ("K2", 1024 + 32768 + 2 * 65536 + 56),
                                         ("K3", 1024 + 32768 + 2 * 65536 + 56),
                                         ("K6", 1024 + 16384 + 2 * (16384 + 32768 + 512) + 56)])
def test_shared_memory_budget(kernel, smem):
    g = tfa.sm90_geometry(kernel, 1, 300, 300, 2)
    assert g.smem_bytes == smem <= tfa.SMEM_LIMIT
    assert len(g.as_array()) == 8 + 3 * 11


def test_geometry_agrees_with_the_header():
    """The C side checks the array against its own constants: they must be the same."""
    text = (_build.CSRC / "flash_attention_sm90.cuh").read_text()
    const = {name: int(val) for name, val in
             re.findall(r"constexpr (?:int|long long) (\w+) = (\d+);", text)}
    assert const["BQ"] == const["BK"] == tfa.SM90_TILE
    assert const["STAGES"] == tfa.SM90_STAGES
    assert const["THREADS"] == tfa.SM90_THREADS
    assert const["SMEM_LIMIT"] == tfa.SMEM_LIMIT


def test_an_edited_header_rebuilds(tmp_path, monkeypatch):
    """The library's name hashes the source, every csrc/*.cuh header and the flags; nvcc
    finds the headers through -I csrc and links libcuda (-lcuda) for the tensor maps."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    first = _build.library_path("k")
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build.library_path("k") != first
    assert _build.library_path("k").name.startswith("k-")
    cmd = _build.nvcc_command(tmp_path / "k.cu", tmp_path / "k.so")
    assert cmd[cmd.index("-I") + 1] == str(tmp_path)
    assert "-lcuda" in cmd and "arch=compute_90a,code=sm_90a" in cmd


def test_unknown_kernel_is_refused():
    with pytest.raises(ValueError):
        tfa.sm90_geometry("K7", 1, 128, 128, 1)


def _tma_box(flat: np.ndarray, m, coords):
    """What a TMA copy of one box at `coords` (innermost first) reads from the bytes
    `flat` through map `m`: elements at coordinates inside m.dims, zeros elsewhere."""
    idx = np.meshgrid(*[c + np.arange(n) for c, n in zip(coords, m.box)], indexing="ij")
    inside = np.ones(idx[0].shape, bool)
    for i, d in zip(idx, m.dims):
        inside &= (i >= 0) & (i < d)
    off = idx[0] * m.itemsize + sum(i * st for i, st in zip(idx[1:], m.strides))
    off = np.where(inside, off, 0)
    out = np.zeros(idx[0].shape + (m.itemsize,), np.uint8)
    for byte in range(m.itemsize):
        out[..., byte] = np.where(inside, flat[off + byte], 0)
    return out


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K6"])
@pytest.mark.parametrize("sq,skv", [(129, 127), (127, 129)])
def test_boxes_read_each_batch_rows_own_tiles(kernel, sq, skv):
    """Every q, k and v box of every batch row reads exactly that batch row's rows of
    the packed tensor, zero-filled past its end (never the next batch row's first)."""
    _check_boxes(kernel, 2, sq, skv, 3)


# Speech-to-video's audio injection attends each latent frame's 1,560 video tokens (a batch
# row per frame, B = 20) to its 5 audio keys: fewer keys than one 128-key tile, so TMA
# zero-fills most of the only key box and the kernels' mask alone keeps keys 5-127 out.
AUDIO_SKV = (1, 2, 5, 127)


@pytest.mark.parametrize("skv", AUDIO_SKV)
@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_audio_shape_geometry(kernel, skv):
    g = tfa.sm90_geometry(kernel, 20, 1560, skv, 40)
    assert g.grid == (13, 40, 20)            # the last q tile holds 1560 - 12 * 128 = 24 rows
    for m, s in ((g.q, 1560), (g.k, skv), (g.v, skv)):
        assert m.dims == (H, 40, s, 20)
        assert m.strides == (H * 2, 40 * H * 2, s * 40 * H * 2)
        assert m.box[1:] == (1, 128, 1)


@pytest.mark.parametrize("skv", AUDIO_SKV)
@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_audio_shape_boxes_zero_fill_past_the_keys(kernel, skv):
    """At B = 20, Sq = 1,560: every key box holds its batch row's skv keys and zeros after
    them (never the next frame's keys), and the last q box 24 rows and zeros."""
    _check_boxes(kernel, 20, 1560, skv, 1)


def _check_boxes(kernel, b, sq, skv, n):
    g = tfa.sm90_geometry(kernel, b, sq, skv, n)
    for m, s in ((g.q, sq), (g.k, skv), (g.v, skv)):
        x = np.random.default_rng(s).integers(1, 255, size=(b, s, n, H * m.itemsize),
                                              dtype=np.uint8)
        flat = x.reshape(-1)
        cols = m.box[0] * m.itemsize
        for bi in range(b):
            for h in range(n):
                for row0 in range(0, s, 128):
                    for c0 in range(0, H, m.box[0]):
                        got = _tma_box(flat, m, (c0, h, row0, bi))[:, 0, :, 0]
                        got = got.transpose(1, 0, 2).reshape(128, cols)
                        want = np.zeros((128, cols), np.uint8)
                        rows = x[bi, row0:row0 + 128, h, c0 * m.itemsize:c0 * m.itemsize + cols]
                        want[:rows.shape[0]] = rows
                        np.testing.assert_array_equal(got, want)


def test_wrappers_check_alignment_before_launch():
    """TMA takes 16-byte-aligned base addresses only; the check raises (no fallback)."""
    t = torch.zeros(4 * H + 1, dtype=torch.bfloat16)[1:].view(1, 4, 1, H)
    assert t.data_ptr() % 16 != 0
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa._check_tma_aligned("K1", [t])
    tfa._check_tma_aligned("K1", [torch.zeros(1, 4, 1, H, dtype=torch.bfloat16)])


# ---------------------------------------------------------------------------
# Plain versions against JAX at the tiles' edges
# ---------------------------------------------------------------------------

def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


def _k1_cases():
    for sq, skv in EDGES:
        for lens in ([(0, 127)] if skv == 127 else [(0, 129), (127, 128)]):
            yield sq, skv, lens


@pytest.mark.parametrize("sq,skv,lens", list(_k1_cases()))
def test_k1_plain_matches_jax_at_tile_edges(sq, skv, lens):
    """kv_len 0, 127, 128 and 129: no key, one short of a tile, exactly one tile, one
    key into the next tile. Float32, the tolerance of test_torch_flash_attention.py."""
    B, N = 2, 2
    (q, k, v), (tq, tk, tv) = _both(_rand((B, sq, N, H), 0), _rand((B, skv, N, H), 1),
                                    _rand((B, skv, N, H), 2))
    with pltpu.force_tpu_interpret_mode():
        ref = jax_flash(q, k, v, scale=H**-0.5, block_q=128, block_k=128, dispatch="nomax",
                        kv_len=jnp.asarray(lens, jnp.int32))
    got = tfa.flash_attention_nomax(tq, tk, tv, H**-0.5, kv_len=torch.tensor(lens)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=2e-5, atol=2e-5)
    if lens[0] == 0:
        assert (got[0] == 0).all()


@pytest.mark.parametrize("sq,skv", EDGES)
def test_k1_plain_without_clamp_matches_jax_at_tile_edges(sq, skv):
    """Dispatch "auto" on bounded inputs: K1 without the clamp, every key valid."""
    B, N = 2, 2
    (q, k, v), (tq, tk, tv) = _both(_rand((B, sq, N, H), 3), _rand((B, skv, N, H), 4),
                                    _rand((B, skv, N, H), 5))
    with pltpu.force_tpu_interpret_mode():
        ref = jax_flash(q, k, v, scale=H**-0.5, block_q=128, block_k=128)
    got = tfa.flash_attention_nomax(tq, tk, tv, H**-0.5, clamp=None).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("sq,skv,lens", list(_k1_cases()))
def test_k2_plain_matches_jax_at_tile_edges(sq, skv, lens):
    """x40 inputs put the logit bound past NOMAX_BOUND, so "auto" takes JAX's _fa_kernel
    and the port's K2, with kv_len 0, 127, 128 and 129. Float32; the logits reach ~1e4 in
    the log2 domain, where float32 sums in another order differ by ~1e-3, so the limit is
    that of test_torch_flash_attention.py for x40 inputs (2e-3)."""
    B, N = 2, 2
    (q, k, v), (tq, tk, tv) = _both(_rand((B, sq, N, H), 9, 40.0), _rand((B, skv, N, H), 10, 40.0),
                                    _rand((B, skv, N, H), 11))
    assert float(tfa.logit_bound(tq, tk, tv, H**-0.5)) >= tfa.NOMAX_BOUND
    with pltpu.force_tpu_interpret_mode():
        ref = jax_flash(q, k, v, scale=H**-0.5, block_q=128, block_k=128,
                        kv_len=jnp.asarray(lens, jnp.int32))
    got = tfa.flash_attention(tq, tk, tv, H**-0.5, kv_len=torch.tensor(lens)).numpy()
    np.testing.assert_array_equal(
        got, tfa.flash_attention_max(tq, tk, tv, H**-0.5, kv_len=torch.tensor(lens)).numpy())
    np.testing.assert_allclose(got, np.asarray(ref), rtol=2e-5, atol=2e-3)
    if lens[0] == 0:
        assert (got[0] == 0).all()


@pytest.mark.parametrize("skv", AUDIO_SKV[:3])
@pytest.mark.parametrize("path", ["K1 auto", "K1 nomax kv_len", "K2 kv_len"])
def test_plain_versions_match_jax_below_one_key_tile(path, skv):
    """Skv of 1, 2 and 5 (the audio injection's 5 keys): K1 through "auto" (no clamp,
    every key), K1 with its clamp and kv_len (0, skv), K2 (x40 inputs) with kv_len (1,
    skv); against JAX's kernels in interpret mode, float32, the limits above."""
    B, N, sq = 2, 2, 129
    mult = 40.0 if path.startswith("K2") else 1.0
    (q, k, v), (tq, tk, tv) = _both(_rand((B, sq, N, H), 12, mult),
                                    _rand((B, skv, N, H), 13, mult), _rand((B, skv, N, H), 14))
    lens = None if path == "K1 auto" else ((0, skv) if path.startswith("K1") else (1, skv))
    kw = {} if lens is None else dict(kv_len=jnp.asarray(lens, jnp.int32))
    with pltpu.force_tpu_interpret_mode():
        ref = jax_flash(q, k, v, scale=H**-0.5, block_q=128, block_k=128,
                        dispatch="nomax" if path == "K1 nomax kv_len" else "auto", **kw)
    tkv = None if lens is None else torch.tensor(lens)
    if path == "K1 auto":
        got = tfa.flash_attention(tq, tk, tv, H**-0.5)
        np.testing.assert_array_equal(
            got.numpy(), tfa.flash_attention_nomax(tq, tk, tv, H**-0.5, clamp=None).numpy())
    elif path == "K1 nomax kv_len":
        got = tfa.flash_attention(tq, tk, tv, H**-0.5, dispatch="nomax", kv_len=tkv)
    else:
        assert float(tfa.logit_bound(tq, tk, tv, H**-0.5)) >= tfa.NOMAX_BOUND
        got = tfa.flash_attention(tq, tk, tv, H**-0.5, kv_len=tkv)
        np.testing.assert_array_equal(
            got.numpy(), tfa.flash_attention_max(tq, tk, tv, H**-0.5, kv_len=tkv).numpy())
    atol = 2e-3 if path.startswith("K2") else 2e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=atol)
    if lens is not None and lens[0] == 0:
        assert (got[0] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block", [128, 300])
@pytest.mark.parametrize("sq,skv", EDGES)
def test_k6_plain_matches_jax_at_tile_edges(sq, skv, block, dtype):
    """Quantization tiles of 128 (clamped to S = 129 for 300): a tile edge one row from
    the end. The tolerances of test_torch_flash_attention_int8.py: 2e-5 in float32, two
    bf16 ulps of the largest |o| in bf16."""
    B, N = 2, 2
    q, k, v = _rand((B, sq, N, H), 6), _rand((B, skv, N, H), 7), _rand((B, skv, N, H), 8)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_int8(jq, jk, jv, scale=H**-0.5, block_q=block, block_k=block),
                         np.float32)
    tq, tk, tv = (torch.from_numpy(np.array(a, np.float32)).to(tdt) for a in (jq, jk, jv))
    got = tfa.flash_attention_int8(tq, tk, tv, H**-0.5, block_q=block, block_k=block)
    assert got.dtype == tdt and got.shape == tq.shape
    atol = 2e-5 if dtype == "float32" else \
        2 * 2.0 ** (math.floor(math.log2(float(np.abs(ref).max()))) - 7)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2e-5 if dtype == "float32" else 0,
                               atol=atol)


# ---------------------------------------------------------------------------
# The training backward's Hopper K4 (dK, dV) and K5 (dQ)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sq,skv", [(127, 127), (129, 40), (1000, 777), (32760, 32760),
                                    (32760, 512)])
def test_backward_tiles_per_batch_row(sq, skv):
    """K4: one CTA per 128 keys walking ceil(Sq/64) q tiles; K5: one CTA per 128 q rows
    walking ceil(Skv/64) key tiles. The scratch pads Sq to whole 128-row blocks."""
    k4 = tfa.sm90_bwd_geometry("K4", 2, sq, skv, 40)
    k5 = tfa.sm90_bwd_geometry("K5", 2, sq, skv, 40)
    assert (k4.bq, k4.bk, k4.threads) == (64, 128, 256)
    assert (k5.bq, k5.bk, k5.threads) == (128, 64, 384)
    assert k4.grid == (-(-skv // 128), 40, 2) and k5.grid == (-(-sq // 128), 40, 2)
    assert k4.scratch_rows == k5.scratch_rows == -(-sq // 128) * 128
    assert k4.scratch_rows % k4.bq == 0          # every q tile's table is one whole copy


@pytest.mark.parametrize("kernel", ["K4", "K5"])
def test_backward_maps_are_rank4_over_the_packed_layout(kernel):
    b, sq, skv, n = 1, 32760, 512, 40
    g = tfa.sm90_bwd_geometry(kernel, b, sq, skv, n)
    for m, s, rows in ((g.q, sq, g.bq), (g.do, sq, g.bq), (g.k, skv, g.bk), (g.v, skv, g.bk)):
        assert m.itemsize == 2
        assert m.dims == (H, n, s, b)
        assert m.strides == (2 * H, 2 * H * n, 2 * H * n * s)
        assert m.box == (64, 1, rows, 1)
    vals = list(g.as_array())
    assert len(vals) == 8 + 4 * 11 + 1 and vals[-1] == g.scratch_rows
    assert vals[8 + 11:8 + 22] == g.do.values()          # q, do, k, v in that order


@pytest.mark.parametrize("kernel,smem", [
    ("K4", 1024 + 2 * 32768 + 4 * (2 * 16384 + 512) + 8 * 9),
    ("K5", 1024 + 2 * 32768 + 4 * 2 * 16384 + 8 * 9)])
def test_backward_shared_memory_budget(kernel, smem):
    g = tfa.sm90_bwd_geometry(kernel, 2, 129, 127, 2)
    assert g.smem_bytes == smem <= tfa.SMEM_LIMIT


def test_backward_geometry_agrees_with_its_header():
    """The C side checks the array against the backward header's constants."""
    text = (_build.CSRC / "flash_attention_bwd_sm90.cuh").read_text()
    const = {name: int(val) for name, val in
             re.findall(r"constexpr (?:int|long long) (\w+) = (\d+);", text)}
    assert (const["KV_QROWS"], const["KV_KEYS"], const["KV_STAGES"],
            const["KV_THREADS"]) == tfa.SM90_BWD["K4"]
    assert (const["Q_ROWS"], const["Q_KEYS"], const["Q_STAGES"],
            const["THREADS"]) == tfa.SM90_BWD["K5"]
    assert const["SCRATCH_ROWS"] == tfa.SCRATCH_ROWS
    assert const["SMEM_LIMIT"] == tfa.SMEM_LIMIT
    assert tfa.SCRATCH_ROWS % const["KV_QROWS"] == 0 and tfa.SCRATCH_ROWS % const["Q_ROWS"] == 0


def test_backward_unknown_kernel_is_refused():
    with pytest.raises(ValueError):
        tfa.sm90_bwd_geometry("K3", 1, 128, 128, 1)


@pytest.mark.parametrize("kernel", ["K4", "K5"])
@pytest.mark.parametrize("sq,skv", [(129, 127), (127, 129), (129, 40)])
def test_backward_boxes_read_each_batch_rows_own_tiles(kernel, sq, skv):
    """Every q, do, k and v box of every batch row reads that batch row's rows of the
    packed tensor, zero-filled past its end, never the next batch row's first rows."""
    b, n = 2, 3
    g = tfa.sm90_bwd_geometry(kernel, b, sq, skv, n)
    for m, s in ((g.q, sq), (g.do, sq), (g.k, skv), (g.v, skv)):
        rows = m.box[2]
        x = np.random.default_rng(s + rows).integers(1, 255, size=(b, s, n, H * 2),
                                                     dtype=np.uint8)
        flat = x.reshape(-1)
        for bi in range(b):
            for h in range(n):
                for row0 in range(0, s, rows):
                    for c0 in (0, 64):
                        got = _tma_box(flat, m, (c0, h, row0, bi))[:, 0, :, 0]
                        got = got.transpose(1, 0, 2).reshape(rows, 128)
                        want = np.zeros((rows, 128), np.uint8)
                        part = x[bi, row0:row0 + rows, h, c0 * 2:c0 * 2 + 128]
                        want[:part.shape[0]] = part
                        np.testing.assert_array_equal(got, want)


def _jax_backward(q, k, v, do, scale):
    """JAX's forward with lse and _flash_bwd (interpret mode), lse as (B, N, Sq)."""
    b, sq, n, _ = q.shape
    with pltpu.force_tpu_interpret_mode():
        o, lse = _fa_forward(q, k, v, scale, 128, 128, with_lse=True)
        dq, dk, dv = _flash_bwd(scale, 128, 128, "auto", (q, k, v, o, lse), do)
    return o, np.asarray(lse)[:, :sq, 0].reshape(b, n, sq), dq, dk, dv


def _to_np(x):
    return np.array(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,skv", EDGES + [(129, 40)])
def test_k4_k5_plain_match_jax_backward_at_tile_edges(sq, skv, dtype):
    """K4 (dk, dv) and K5 (dq) plain versions against JAX _flash_bwd at B = 2 with ragged
    last tiles, from the same (q, k, v, o, lse, do). The tolerances of
    test_torch_flash_attention_bwd.py: 5e-5 in float32 (another summation order), in
    bf16 two bf16 ulps of each output's largest value (the same float32 sums rounded)."""
    B, N = 2, 2
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    arrs = [_rand((B, s, N, H), seed) for s, seed in ((sq, 20), (skv, 21), (skv, 22), (sq, 23))]
    q, k, v, do = (jnp.asarray(a).astype(jdt) for a in arrs)
    o, lse, dq, dk, dv = _jax_backward(q, k, v, do, H**-0.5)
    tq, tk, tv, tdo, to = (torch.from_numpy(_to_np(x)).to(tdt) for x in (q, k, v, do, o))
    tlse = torch.from_numpy(lse.copy())
    tdk, tdv = tfa.flash_attention_bwd_dkv(tq, tk, tv, to, tdo, tlse, H**-0.5)
    tdq = tfa.flash_attention_bwd_dq(tq, tk, tv, to, tdo, tlse, H**-0.5)
    for got, ref in ((tdq, dq), (tdk, dk), (tdv, dv)):
        ref = _to_np(ref)
        assert got.dtype == tdt and got.shape == ref.shape
        atol = 5e-5 if dtype == "float32" else \
            2 * 2.0 ** (math.floor(math.log2(float(np.abs(ref).max()))) - 7)
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# The training forward's Hopper K3
# ---------------------------------------------------------------------------

def _jax_forward_lse(q, k, v, scale):
    """JAX's K3 (_fa_forward with lse, interpret mode): o, and lse as (B, N, Sq)."""
    b, sq, n, _ = q.shape
    with pltpu.force_tpu_interpret_mode():
        o, lse = _fa_forward(q, k, v, scale, 128, 128, with_lse=True)
    return _to_np(o), np.asarray(lse)[:, :sq, 0].reshape(b, n, sq)


def _two_bf16_ulps(ref):
    return 2 * 2.0 ** (math.floor(math.log2(float(np.abs(ref).max()))) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,skv", EDGES + [(129, 40)])
def test_k3_plain_matches_jax_forward_at_tile_edges(sq, skv, dtype):
    """K3's plain version (o, lse) against JAX _fa_forward(with_lse=True) at B = 2 with
    ragged last q and key tiles (Skv = 40: one short key tile). The tolerances of
    test_torch_flash_attention_bwd.py: o to 2e-5 in float32 and to two bf16 ulps of the
    largest |o| in bf16 (the same float32 sums rounded), lse to 1e-5 (float32 logs of
    float32 sums)."""
    B, N = 2, 2
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    q, k, v = (jnp.asarray(_rand((B, s, N, H), seed)).astype(jdt)
               for s, seed in ((sq, 24), (skv, 25), (skv, 26)))
    o_ref, lse_ref = _jax_forward_lse(q, k, v, H**-0.5)
    tq, tk, tv = (torch.from_numpy(_to_np(x)).to(tdt) for x in (q, k, v))
    o, lse = tfa.flash_attention_fwd_lse(tq, tk, tv, H**-0.5)
    assert o.dtype == tdt and tuple(lse.shape) == (B, N, sq) and lse.dtype == torch.float32
    atol = 2e-5 if dtype == "float32" else _two_bf16_ulps(o_ref)
    np.testing.assert_allclose(o.float().numpy(), o_ref, rtol=0, atol=atol)
    np.testing.assert_allclose(lse.numpy(), lse_ref, rtol=0, atol=1e-5)


def _k3_exp2_model(q, k, v, scale):
    """The card's K3 arithmetic in torch float32: raw float32 logits s and their row max m;
    c = fl(scale*log2 e); p = exp2(fl(s*c - fl(m*c))), the FFMA modelled in float64 (the
    product of two float32 values is exact there) and rounded once to float32; l =
    rowsum(p); o = (bf16(p) v) / l in q's dtype; lse = fl(m*scale) + log(max(l, 1e-30)).
    torch's exp2 stands in for ex2.approx (which is within 2 float32 ulps of it)."""
    f32 = torch.float32
    s = torch.einsum("bsnh,btnh->bnst", q.float(), k.float())
    m = s.amax(dim=-1, keepdim=True)
    c = torch.tensor(scale * tfa.LOG2E, dtype=f32)
    p = torch.exp2((s.double() * c.double() - (m * c).double()).to(f32))
    l = p.sum(dim=-1)
    acc = torch.einsum("bnst,btnh->bsnh", p.to(v.dtype).float(), v.float())
    o = (acc / l.permute(0, 2, 1)[..., None]).to(q.dtype)
    lse = m[..., 0] * torch.tensor(scale, dtype=f32) + torch.log(l.clamp(min=1e-30))
    return o, lse


@pytest.mark.parametrize("mult", [1.0, 8.0])
def test_k3_exp2_form_stays_within_the_cards_limits(mult):
    """The card's K3 takes p = ex2.approx(fma(s, c, -m*c)) with c = scale*log2 e where JAX
    takes exp(s*scale - m*scale): the two differ in the float32 rounding of the argument,
    which grows with the logits. A model of the card's form in bf16 at 1000x777, with q
    and k x1 and x8 (logits up to ~200), stays within the limits chip_smoke.py holds the
    card's K3 to, here against JAX's form: o within two bf16 ulps of the largest |o| with a
    mean signed error under 5e-4 of the mean |o|, lse within 1e-5 + 1e-5 |lse|."""
    q, k, v = (jnp.asarray(_rand(s, seed, m)).astype(jnp.bfloat16)
               for s, seed, m in (((1, 1000, 2, H), 30, mult), ((1, 777, 2, H), 31, mult),
                                  ((1, 777, 2, H), 32, 1.0)))
    o_ref, lse_ref = _jax_forward_lse(q, k, v, H**-0.5)
    o, lse = _k3_exp2_model(*(torch.from_numpy(_to_np(x)).to(torch.bfloat16) for x in (q, k, v)),
                            H**-0.5)
    err = o.float().numpy() - o_ref
    assert np.abs(err).max() <= _two_bf16_ulps(o_ref)
    assert abs((err * np.sign(o_ref)).mean()) <= 5e-4 * np.abs(o_ref).mean()
    np.testing.assert_allclose(lse.numpy(), lse_ref, rtol=1e-5, atol=1e-5)
