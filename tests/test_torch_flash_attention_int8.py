"""The port's int8-QK attention (K6's path) against JAX flash_attention_int8 (CPU).

JAX runs its Pallas kernel in interpret mode; the port's wrapper, given CPU tensors,
computes K6's plain version. The quantization tiles (quantize_tiles) must give JAX's
codes and scales exactly; then the two attentions differ only by float32 rounding. The
CUDA kernel itself is held against the plain version in test_torch_kernels_cuda.py and
by chip_smoke.py.
"""

import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from goal_force_tpu.ops.attention import _xla_attention
from goal_force_tpu.ops.flash_attention import _pad_to, _quantize_tiles, _to_bn
from goal_force_tpu.ops.flash_attention import flash_attention_int8 as jax_int8

from goal_force_tpu_torch.ops import attention as tattn
from goal_force_tpu_torch.ops import flash_attention as tfa

H = 128


def _rand(shape, seed, mult=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * mult).astype(np.float32)


@pytest.mark.parametrize("s,block", [(256, 128), (300, 300), (300, 128), (40, 128), (1000, 300)])
def test_quantize_tiles_equal_jax(s, block):
    """One scale per (batch, head, tile of `block` rows) over the tile's rows and all 128
    lanes; rows past S are zero. Codes and scales equal JAX's bit for bit."""
    b, n = 2, 3
    x = _rand((b, s, n, H), 0)
    x[1, :, 2] = 0.0                                  # an all-zero head: the 1e-6 floor
    codes, scales = tfa.quantize_tiles(torch.from_numpy(x), block)
    ref_codes, ref_scales = _quantize_tiles(_pad_to(_to_bn(jnp.asarray(x)), 1, block), block)
    ref_codes = np.asarray(ref_codes)[:, :s].reshape(b, n, s, H).transpose(0, 2, 1, 3)
    assert codes.dtype == torch.int8 and tuple(scales.shape) == (b, n, -(-s // block))
    np.testing.assert_array_equal(codes.numpy(), ref_codes)
    np.testing.assert_array_equal(scales.numpy(), np.asarray(ref_scales).reshape(b, n, -1))


def _bf16_ulps(ref: np.ndarray, n: int = 2) -> float:
    """n bf16 ulps at the largest |ref|."""
    return n * 2.0 ** (math.floor(math.log2(float(np.abs(ref).max()))) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,skv,block", [(256, 256, 128), (300, 300, 300), (300, 40, 128),
                                         (128, 512, 128)])
def test_matches_jax_kernel(dtype, s, skv, block):
    """Same codes and scales, the same integer logits; what differs is float32 rounding
    (the kernel's running max against the plain version's row max, exp, summation
    order): 2e-5 in float32. In bf16 a p can round to its neighbour and the output's
    float32 value can round to the neighbouring bf16 value: two bf16 ulps of the largest
    |o|."""
    B, N = 1, 2
    q, k, v = _rand((B, s, N, H), 0), _rand((B, skv, N, H), 1), _rand((B, skv, N, H), 2)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_int8(jq, jk, jv, scale=H**-0.5, block_q=block, block_k=block),
                         np.float32)
    tq, tk, tv = (torch.from_numpy(np.array(a, np.float32)).to(tdt) for a in (jq, jk, jv))
    before = dict(tfa.launch_counts)
    got = tfa.flash_attention_int8(tq, tk, tv, H**-0.5, block_q=block, block_k=block)
    assert tfa.launch_counts == before              # CPU tensors: plain version, no launch
    assert got.dtype == tdt and got.shape == tq.shape
    atol = 2e-5 if dtype == "float32" else _bf16_ulps(ref)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2e-5 if dtype == "float32" else 0,
                               atol=atol)


def test_close_to_exact_attention_within_jax_bounds():
    """tests/test_flash_attention.py::test_int8_variant_close_to_exact's bounds."""
    B, S, N = 1, 256, 2
    q, k, v = _rand((B, S, N, H), 0), _rand((B, S, N, H), 1), _rand((B, S, N, H), 2)
    ref = np.asarray(_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), H**-0.5))
    got = tfa.flash_attention_int8(*(torch.from_numpy(a) for a in (q, k, v)), H**-0.5,
                                   block_q=128, block_k=128).numpy()
    err = np.abs(got - ref)
    assert err.max() < 0.05, err.max()
    assert err.mean() < 0.005, err.mean()


def test_blocks_clamp_like_jax():
    assert tfa.int8_blocks(32760, 32760) == (1024, 1024)
    assert tfa.int8_blocks(32760, 512) == (1024, 512)
    assert tfa.int8_blocks(40, 300, 128, 128) == (128, 128)
    assert tfa.int8_blocks(640, 16) == (640, 128)


def test_scales_are_looked_up_per_row_and_key():
    """Tiles of 300 rows: rows 299 and 300 belong to different tiles. Scaling the second
    q tile and the last k tile by 4 (an exact power of two) leaves the codes unchanged
    and multiplies the scales, so the output equals the unscaled one computed with
    logits multiplied per (row, key) by 4 or 16 where the tiles meet."""
    q, k, v = (torch.from_numpy(_rand((1, 700, 1, H), i, 0.3)) for i in range(3))
    q2, k2 = q.clone(), k.clone()
    q2[:, 300:600] *= 4
    k2[:, 600:] *= 4
    got = tfa.flash_attention_int8(q2, k2, v, H**-0.5, block_q=300, block_k=300)
    mult = torch.ones(700, 700)
    mult[300:600] *= 4
    mult[:, 600:] *= 4
    qi, sq = tfa.quantize_tiles(q, 300)
    ki, sk = tfa.quantize_tiles(k, 300)
    rows = torch.arange(700) // 300
    logits = (torch.einsum("sh,th->st", qi[0, :, 0].float(), ki[0, :, 0].float())
              * ((H**-0.5 * sq[0, 0, rows])[:, None] * sk[0, 0, rows][None, :]) * mult)
    ref = torch.softmax(logits, dim=-1) @ v[0, :, 0]
    np.testing.assert_allclose(got[0, :, 0].numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


def test_rejects_head_dim_and_grad():
    q = torch.zeros((1, 256, 2, 64))
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention_int8(q, q, q, 1.0)
    x = torch.randn((1, 256, 2, H), requires_grad=True)
    with pytest.raises(RuntimeError, match="not differentiable"):
        tfa.flash_attention_int8(x, x, x, 1.0)
    with pytest.raises(RuntimeError, match="not differentiable"):
        tattn.attention(x, x, x, impl="flash_int8")
    with torch.no_grad():
        assert tfa.flash_attention_int8(x, x, x, 1.0).shape == x.shape


def test_kernel_wrapper_refuses_non_cuda_devices():
    meta = torch.empty((1, 256, 1, H), device="meta", dtype=torch.int8)
    sc = torch.empty((1, 1, 1), device="meta")
    v = torch.empty((1, 256, 1, H), device="meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        tfa.flash_attention_int8_codes(meta, sc, meta, sc, v, 1.0, 256, 256)
