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


@pytest.mark.cuda
def test_expert_swap_holds_one_pair_on_the_card(cuda_device):
    """The standby pair waits in pinned host memory, and a swap exchanges the pairs
    tensor by tensor: the card's peak during it stays within the resident pair plus its
    largest tensor (and 2 MiB for the allocator's rounding), and no value changes."""
    from torch import nn

    from goal_force_tpu_torch.parallel.host_staging import ExpertStager

    def pair(seed):
        g = torch.Generator(cuda_device).manual_seed(seed)
        lin = lambda n: nn.Sequential(*[nn.Linear(2048, 2048, device=cuda_device,
                                                  dtype=torch.bfloat16) for _ in range(n)])
        out = {"dit": lin(8), "controlnet": lin(2)}
        out["controlnet"].register_buffer(   # a W8A8 pack is a buffer
            "codes", torch.randint(-127, 128, (2048, 2048), generator=g, device=cuda_device,
                                   dtype=torch.int8))
        for m in out.values():
            for p in m.parameters():
                p.requires_grad_(False).normal_(generator=g)
        return out

    def snapshot(p):
        return {k: {n: t.cpu() for n, t in m.state_dict().items()} for k, m in p.items()}

    def tensors(p):
        return [t for m in p.values() for t in m.state_dict().values()]

    a, b = pair(0), pair(1)
    ref_a, ref_b = snapshot(a), snapshot(b)
    stager = ExpertStager(a, b, "cuda")
    assert all(t.device.type == "cpu" and t.is_pinned() for t in tensors(b))
    largest = max(t.numel() * t.element_size() for t in tensors(a))
    for incoming, ref in ((b, ref_b), (a, ref_a)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        assert stager.swap() is incoming
        peak = torch.cuda.max_memory_allocated()
        assert peak <= base + largest + (2 << 20), (peak - base, largest)
        assert torch.cuda.memory_allocated() <= base + (2 << 20)
        assert all(t.is_cuda for t in tensors(incoming))
        outgoing = a if incoming is b else b
        assert all(t.device.type == "cpu" and t.is_pinned() for t in tensors(outgoing))
        got = snapshot(incoming)
        assert all(torch.equal(got[k][n], ref[k][n]) for k in ref for n in ref[k])


@pytest.mark.cuda
def test_lora_merge_inside_remat_holds_one_block_of_merged_weights(cuda_device):
    """LoRA training merges each block's adapters inside its remat region: the peak of a
    forward + backward above the same run without adapters stays within a few blocks'
    merged weights (the merged weights, their gradient and its float32 cast of the
    block being recomputed), while merging all 16 blocks first adds at least all 16."""
    from goal_force_tpu_torch import configs
    from goal_force_tpu_torch.lora import init_lora, merged_block
    from goal_force_tpu_torch.models import wan_dit

    cfg = configs.WanDiTConfig(dim=1024, ffn_dim=4096, num_heads=8, num_layers=16,
                               text_dim=1024, freq_dim=256)
    gen = torch.Generator(cuda_device).manual_seed(0)
    dit = wan_dit.init_wan_dit(cfg, gen, torch.bfloat16, device=cuda_device)
    lora = init_lora(gen, dit, rank=8)
    for ab in lora.values():
        ab["b"].normal_(generator=gen).mul_(0.01)
        for t in ab.values():
            t.requires_grad_(True)
    x = torch.randn((1, 1024, cfg.dim), generator=gen, device=cuda_device).to(torch.bfloat16)
    ctx = torch.randn((1, 64, cfg.dim), generator=gen, device=cuda_device).to(torch.bfloat16)
    _, t_mod = wan_dit.time_embed(dit, cfg, torch.full((1,), 500.0, device=cuda_device))
    cos, sin = wan_dit.rope_for_grid(cfg, (4, 16, 16), cuda_device)
    block_bytes = sum(2 * p.numel() for blk in dit.blocks[:1] for n, p in blk.named_parameters()
                      if n.split(".weight")[0] in ("self_attn.q", "self_attn.k", "self_attn.v",
                                                  "self_attn.o", "ffn.0", "ffn.2"))

    def peak(block_weights, inputs_grad):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        xi = x.clone().requires_grad_(inputs_grad)
        weights = block_weights() if callable(block_weights) else None
        out = wan_dit.run_blocks(dit.blocks, xi, ctx, t_mod, cos, sin, cfg, remat=True,
                                 block_weights=weights)
        out.float().square().mean().backward()
        del out, weights
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base

    plain = peak(None, True)
    inside = peak(lambda: (lambda i, blk: merged_block(blk, lora, i)), False)

    def whole():
        merged = [merged_block(blk, lora, i) for i, blk in enumerate(dit.blocks)]
        return lambda i, blk: merged[i]

    upfront = peak(whole, False)
    assert inside - plain <= 6 * block_bytes, (inside - plain, block_bytes)
    assert upfront - plain >= cfg.num_layers * block_bytes, (upfront - plain, block_bytes)
