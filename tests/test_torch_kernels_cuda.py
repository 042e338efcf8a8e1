"""The port's CUDA kernels K1-K6 against their plain versions, on the card.

This file imports neither JAX nor the JAX package, so it also runs where only the port's
dependencies are installed. Every test needs a CUDA device and skips without one; on a
machine with a card and without JAX run it as

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py
"""

import math

import pytest
import torch

from goal_force_tpu_torch.ops import attention as tattn
from goal_force_tpu_torch.ops import flash_attention as tfa

H = 128


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _qkv(device, dtype, b, s, skv, n, seed=0):
    g = torch.Generator(device).manual_seed(seed)
    return [torch.randn((b, m, n, H), generator=g, device=device).to(dtype) for m in (s, skv, skv)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_on_card(cuda_device, dtype):
    q, k, v = _qkv(cuda_device, dtype, 2, 1000, 777, 4)
    lens = torch.tensor([0, 700], device=cuda_device)
    # bf16: |o| < 0.5 with 700 keys, so one bf16 ulp of the output is <= 2e-3.
    tol = dict(atol=2e-5, rtol=2e-5) if dtype == torch.float32 else dict(atol=5e-3, rtol=0)
    for kern, plain in ((tfa.flash_attention_nomax, tfa.flash_attention_nomax_plain),
                        (tfa.flash_attention_max, tfa.flash_attention_max_plain)):
        got = kern(q, k, v, H**-0.5, kv_len=lens)
        ref = plain(q, k, v, H**-0.5, kv_len=lens)
        torch.testing.assert_close(got.float(), ref.float(), **tol)
        assert (got[0] == 0).all()


@pytest.mark.cuda
def test_bounded_attention_launches_k1(cuda_device):
    """The DiT's call, attention(bounded=True) at head_dim 128, goes through K1 once."""
    q, k, v = _qkv(cuda_device, torch.bfloat16, 2, 300, 40, 2, seed=1)
    before = dict(tfa.launch_counts)
    got = tattn.attention(q, k, v, bounded=True)
    assert tfa.launch_counts["K1"] == before["K1"] + 1
    assert tfa.launch_counts["K2"] == before["K2"]
    ref = tfa.flash_attention_nomax_plain(q, k, v, H**-0.5)
    # 40 keys: |o| exceeds 1, where one bf16 ulp is 7.8e-3.
    torch.testing.assert_close(got.float(), ref.float(), atol=2e-2, rtol=0)


def _bf16_limit(ref):
    """Two bf16 ulps at the largest |ref|: kernel and plain version round float32 sums that
    differ only in summation order."""
    top = float(ref.float().abs().max())
    return 2.0 ** (math.floor(math.log2(top)) - 6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_training_kernels_match_plain_on_card(cuda_device, dtype):
    """K3 (o, lse), K4 (dk, dv) and K5 (dq) on a padded q tile and a partly masked kv tile."""
    q, k, v = _qkv(cuda_device, dtype, 1, 1000, 777, 4, seed=2)
    do = _qkv(cuda_device, dtype, 1, 1000, 1, 4, seed=3)[0]
    scale = H**-0.5
    o, lse = tfa.flash_attention_fwd_lse(q, k, v, scale)
    o_ref, lse_ref = tfa.flash_attention_fwd_lse_plain(q, k, v, scale)
    torch.testing.assert_close(lse, lse_ref, atol=1e-5, rtol=1e-5)
    got = [o, *tfa.flash_attention_bwd_dkv(q, k, v, o_ref, do, lse_ref, scale),
           tfa.flash_attention_bwd_dq(q, k, v, o_ref, do, lse_ref, scale)]
    ref = [o_ref, *tfa.flash_attention_bwd_dkv_plain(q, k, v, o_ref, do, lse_ref, scale),
           tfa.flash_attention_bwd_dq_plain(q, k, v, o_ref, do, lse_ref, scale)]
    for g, r in zip(got, ref):
        assert g.dtype == dtype
        # float32: another summation order over <= 1000 terms
        tol = dict(atol=1e-4, rtol=1e-4) if dtype == torch.float32 else \
            dict(atol=_bf16_limit(r), rtol=0)
        torch.testing.assert_close(g.float(), r.float(), **tol)


@pytest.mark.cuda
def test_grad_through_attention_launches_k3_k4_k5(cuda_device):
    q, k, v = (t.requires_grad_(True) for t in _qkv(cuda_device, torch.bfloat16, 1, 300, 260, 2))
    before = dict(tfa.launch_counts)
    out = tattn.attention(q, k, v, bounded=True)
    out.float().square().sum().backward()
    delta = {n: tfa.launch_counts[n] - before[n] for n in before}
    assert delta == {"K1": 0, "K2": 0, "K3": 1, "K4": 1, "K5": 1, "K6": 0}
    assert all(bool(torch.isfinite(t.grad.float()).all()) for t in (q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block", [128, 300])
def test_int8_kernel_matches_plain_on_card(cuda_device, dtype, block):
    """K6 on the same int8 codes and tile scales as its plain version; tiles of 300 put a
    q scale boundary inside a 16-row fragment and a k scale boundary inside a key tile."""
    q, k, v = _qkv(cuda_device, dtype, 2, 1000, 777, 4, seed=4)
    bq, bk = tfa.int8_blocks(1000, 777, block, block)
    qi, sq = tfa.quantize_tiles(q, bq)
    ki, sk = tfa.quantize_tiles(k, bk)
    got = tfa.flash_attention_int8_codes(qi, sq, ki, sk, v, H**-0.5, bq, bk)
    ref = tfa._int8_plain(qi, sq, ki, sk, v, H**-0.5, bq, bk)
    assert got.dtype == dtype
    # float32: the same integer logits, float32 sums in another order
    tol = dict(atol=2e-5, rtol=2e-5) if dtype == torch.float32 else \
        dict(atol=_bf16_limit(ref), rtol=0)
    torch.testing.assert_close(got.float(), ref.float(), **tol)


# The Hopper K1/K2/K6 tiles are 128 query rows by 128 keys: Sq and Skv of 127 and 129 make
# the last q and key tiles of every batch row ragged; kv_len lands on both sides of a
# tile edge (no key, one short of a tile, exactly one tile, one key past it).
EDGES = [((127, 127), (0, 127)), ((127, 129), (128, 129)), ((129, 127), (127, 1)),
         ((129, 129), (0, 128))]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,lens", EDGES)
def test_k1_matches_plain_at_tile_edges(cuda_device, shape, lens):
    sq, skv = shape
    q, k, v = _qkv(cuda_device, torch.bfloat16, 2, sq, skv, 2, seed=6)
    kv_len = torch.tensor(lens, device=cuda_device)
    for kw in (dict(kv_len=kv_len), dict(clamp=None)):
        got = tfa.flash_attention_nomax(q, k, v, H**-0.5, **kw)
        ref = tfa.flash_attention_nomax_plain(q, k, v, H**-0.5, **kw)
        torch.testing.assert_close(got.float(), ref.float(), atol=_bf16_limit(ref), rtol=0)
    if lens[0] == 0:
        assert (tfa.flash_attention_nomax(q, k, v, H**-0.5, kv_len=kv_len)[0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,lens", EDGES)
def test_k2_matches_plain_at_tile_edges(cuda_device, shape, lens):
    sq, skv = shape
    q, k, v = _qkv(cuda_device, torch.bfloat16, 2, sq, skv, 2, seed=10)
    kv_len = torch.tensor(lens, device=cuda_device)
    for kw in (dict(kv_len=kv_len), {}):
        got = tfa.flash_attention_max(q, k, v, H**-0.5, **kw)
        ref = tfa.flash_attention_max_plain(q, k, v, H**-0.5, **kw)
        torch.testing.assert_close(got.float(), ref.float(), atol=_bf16_limit(ref), rtol=0)
    if lens[0] == 0:
        assert (tfa.flash_attention_max(q, k, v, H**-0.5, kv_len=kv_len)[0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("block", [128, 300])
@pytest.mark.parametrize("shape,lens", EDGES)
def test_k6_matches_plain_at_tile_edges(cuda_device, shape, lens, block):
    sq, skv = shape
    q, k, v = _qkv(cuda_device, torch.bfloat16, 2, sq, skv, 2, seed=7)
    bq, bk = tfa.int8_blocks(sq, skv, block, block)
    qi, sq_ = tfa.quantize_tiles(q, bq)
    ki, sk = tfa.quantize_tiles(k, bk)
    got = tfa.flash_attention_int8_codes(qi, sq_, ki, sk, v, H**-0.5, bq, bk)
    ref = tfa._int8_plain(qi, sq_, ki, sk, v, H**-0.5, bq, bk)
    torch.testing.assert_close(got.float(), ref.float(), atol=_bf16_limit(ref), rtol=0)


@pytest.mark.cuda
def test_flash_int8_attention_launches_k6_only(cuda_device):
    """attention(impl="flash_int8") on CUDA tensors goes through K6 once and nothing
    else; a kv_len takes the plain attention and launches nothing."""
    q, k, v = _qkv(cuda_device, torch.bfloat16, 2, 300, 40, 2, seed=5)
    before = dict(tfa.launch_counts)
    tattn.attention(q, k, v, impl="flash_int8")
    delta = {n: tfa.launch_counts[n] - before[n] for n in before}
    assert delta == {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0, "K6": 1}
    tattn.attention(q, k, v, impl="flash_int8", kv_len=torch.tensor([20, 40]))
    assert tfa.launch_counts["K6"] == before["K6"] + 1


# The Hopper K4 takes 128 keys per CTA and walks 64-row q tiles, K5 takes 128 q rows per CTA
# and walks 64-key tiles: Sq and Skv of 127 and 129 leave ragged tiles at every batch row's
# end, Skv = 40 leaves K4's second warpgroup without a key and K5's only key tile short.
@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv", [(127, 127), (127, 129), (129, 127), (129, 129), (129, 40)])
def test_k3_matches_plain_at_tile_edges(cuda_device, sq, skv):
    """K3 takes 128 q rows per CTA and walks 128-key tiles: ragged last tiles at every batch
    row's end, and Skv = 40 a single short key tile."""
    q, k, v = _qkv(cuda_device, torch.bfloat16, 2, sq, skv, 2, seed=11)
    o, lse = tfa.flash_attention_fwd_lse(q, k, v, H**-0.5)
    o_ref, lse_ref = tfa.flash_attention_fwd_lse_plain(q, k, v, H**-0.5)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=_bf16_limit(o_ref), rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv", [(127, 127), (127, 129), (129, 127), (129, 129), (129, 40)])
def test_backward_kernels_match_plain_at_tile_edges(cuda_device, sq, skv):
    q, k, v = _qkv(cuda_device, torch.bfloat16, 2, sq, skv, 2, seed=8)
    do = _qkv(cuda_device, torch.bfloat16, 2, sq, 1, 2, seed=9)[0]
    scale = H**-0.5
    o, lse = tfa.flash_attention_fwd_lse_plain(q, k, v, scale)
    got = [*tfa.flash_attention_bwd_dkv(q, k, v, o, do, lse, scale),
           tfa.flash_attention_bwd_dq(q, k, v, o, do, lse, scale)]
    ref = [*tfa.flash_attention_bwd_dkv_plain(q, k, v, o, do, lse, scale),
           tfa.flash_attention_bwd_dq_plain(q, k, v, o, do, lse, scale)]
    for g, r in zip(got, ref):
        torch.testing.assert_close(g.float(), r.float(), atol=_bf16_limit(r), rtol=0)
