"""K3/K4/K5 of the port (training flash attention) against the JAX Pallas kernels.

On CPU tensors the port's wrappers compute their plain versions; the JAX side runs
``_fa_forward(with_lse=True)`` and ``_flash_bwd`` in interpret mode, at
(1,300,2,128) queries x (1,260,2,128) keys (block 128: a padded q tile and a padded,
straddling kv tile). The CUDA kernels are held against the same plain versions in
test_torch_kernels_cuda.py and by chip_smoke.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from goal_force_tpu.ops.attention import _xla_attention
from goal_force_tpu.ops.flash_attention import _fa_forward, _flash_bwd
from goal_force_tpu.ops.flash_attention import flash_attention as jax_flash

from goal_force_tpu_torch.ops import attention as tattn
from goal_force_tpu_torch.ops import flash_attention as tfa

B, SQ, SKV, N, H = 1, 300, 260, 2, 128
SCALE = H**-0.5
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _rand(shape, seed, mult=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * mult).astype(np.float32)


def _inputs(dtype_name, seed=0):
    jdt, tdt = DTYPES[dtype_name]
    arrs = [_rand((B, SQ, N, H), seed), _rand((B, SKV, N, H), seed + 1),
            _rand((B, SKV, N, H), seed + 2), _rand((B, SQ, N, H), seed + 3)]
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _np(x):
    return np.array(jnp.asarray(x, jnp.float32)) if isinstance(x, jax.Array) \
        else x.float().numpy()


def _jax_fwd_bwd(q, k, v, do):
    with pltpu.force_tpu_interpret_mode():
        o, lse = _fa_forward(q, k, v, SCALE, 128, 128, with_lse=True)
        dq, dk, dv = _flash_bwd(SCALE, 128, 128, "auto", (q, k, v, o, lse), do)
    lse = np.asarray(lse)[:, :SQ, 0].reshape(B, N, SQ)    # lanes replicated, rows padded
    return o, lse, dq, dk, dv


# Tolerances. float32: another summation order (~1e-6 relative). bfloat16: both sides
# round the same float32 sums to bf16, so they differ by about one bf16 ulp of the
# output (|o| < 0.5 -> 2e-3; |dq|, |dk|, |dv| < 4 -> 1.6e-2), plus a p or ds that rounds
# the other way where exp differs in its last float32 bit; lse stays float32 but is the
# log of a sum of bf16-input logits, so it matches to float32 rounding (1e-5).
TOL = {"float32": dict(o=2e-5, lse=1e-5, grad=5e-5),
       "bfloat16": dict(o=4e-3, lse=1e-5, grad=3.2e-2)}


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_k3_plain_matches_pallas_forward_with_lse(dtype_name):
    (q, k, v, _), (tq, tk, tv, _) = _inputs(dtype_name)
    o, lse, *_ = _jax_fwd_bwd(q, k, v, jnp.zeros_like(q))
    to, tlse = tfa.flash_attention_fwd_lse(tq, tk, tv, SCALE)
    assert to.dtype == tq.dtype and tlse.dtype == torch.float32
    assert tuple(tlse.shape) == (B, N, SQ)
    np.testing.assert_allclose(_np(to), _np(o), atol=TOL[dtype_name]["o"], rtol=0)
    np.testing.assert_allclose(tlse.numpy(), lse, atol=TOL[dtype_name]["lse"], rtol=0)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_k4_k5_plain_match_pallas_backward(dtype_name):
    """dK/dV and dQ from the same (q, k, v, o, lse, do) as the Pallas backward gets."""
    (q, k, v, do), (tq, tk, tv, tdo) = _inputs(dtype_name, seed=10)
    o, lse, dq, dk, dv = _jax_fwd_bwd(q, k, v, do)
    to = torch.from_numpy(_np(o)).to(tq.dtype)
    tlse = torch.from_numpy(lse.copy())
    tdk, tdv = tfa.flash_attention_bwd_dkv(tq, tk, tv, to, tdo, tlse, SCALE)
    tdq = tfa.flash_attention_bwd_dq(tq, tk, tv, to, tdo, tlse, SCALE)
    tol = TOL[dtype_name]["grad"]
    for got, ref in ((tdq, dq), (tdk, dk), (tdv, dv)):
        assert got.dtype == tq.dtype
        np.testing.assert_allclose(_np(got), _np(ref), atol=tol, rtol=0)


def test_k3_does_not_fold_the_scale_into_q():
    """K3 multiplies float32 logits by the scale; folding scale*log2e into bf16 q (as K1
    and K2 do) rounds q and moves the result by more than the bf16 limit above."""
    (q, k, v, _), (tq, tk, tv, _) = _inputs("bfloat16", seed=20)
    o, lse, *_ = _jax_fwd_bwd(q, k, v, jnp.zeros_like(q))
    to, tlse = tfa.flash_attention_fwd_lse(tq, tk, tv, SCALE)
    folded = tfa.flash_attention_max_plain(tq, tk, tv, SCALE)
    err_lse = np.abs(tlse.numpy() - lse).max()
    # the fold's logits carry bf16 rounding of q (~4e-3 relative): lse moves by ~1e-2
    folded_lse = torch.logsumexp(torch.einsum(
        "bsnh,btnh->bnst", tfa.fold_q(tq, SCALE).float(), tk.float()) / tfa.LOG2E, -1)
    assert err_lse <= 1e-5 < np.abs(folded_lse.numpy() - lse).max()
    assert np.abs(_np(folded) - _np(o)).max() > 0


def test_flash_attention_fn_gradients_match_jax_grad():
    """test_backward_matches_xla's setting: jax.grad through the custom VJP in interpret
    mode against torch.autograd through FlashAttentionFn (plain K3/K4/K5 on CPU)."""
    g = _rand((1, 300, 2, 128), 3)
    qn, kn, vn = _rand((1, 300, 2, 128), 0), _rand((1, 260, 2, 128), 1), _rand((1, 260, 2, 128), 2)

    def loss_fa(q, k, v):
        return jnp.sum(jax_flash(q, k, v, scale=SCALE, block_q=128, block_k=128) * g)

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(loss_fa, argnums=(0, 1, 2))(*map(jnp.asarray, (qn, kn, vn)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (qn, kn, vn))
    out = tattn.attention(tq, tk, tv, impl="flash", bounded=True)
    (out * torch.from_numpy(g)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)
    xla = jax.grad(lambda q, k, v: jnp.sum(_xla_attention(q, k, v, SCALE) * g),
                   argnums=(0, 1, 2))(*map(jnp.asarray, (qn, kn, vn)))
    for got, want in zip((tq.grad, tk.grad, tv.grad), xla):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)


@pytest.fixture
def spy(monkeypatch):
    """Records which wrapper the dispatch calls (CPU tensors launch no kernel)."""
    calls = []
    for name in ("flash_attention_nomax", "flash_attention_max", "flash_attention_fwd_lse",
                 "flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
        real = getattr(tfa, name)

        def wrapped(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(tfa, name, wrapped)
    return calls


@pytest.mark.parametrize("dispatch", ["auto", "nomax"])
def test_dispatch_takes_k3_only_under_grad(spy, dispatch):
    q, k, v = (torch.from_numpy(_rand(s, i)) for i, s in
               enumerate(((1, 256, 1, 128), (1, 64, 1, 128), (1, 64, 1, 128))))
    tfa.flash_attention(q, k, v, SCALE, dispatch=dispatch)
    assert spy == ["flash_attention_nomax"]
    spy.clear()
    qg = q.clone().requires_grad_(True)
    with torch.no_grad():
        tfa.flash_attention(qg, k, v, SCALE, dispatch=dispatch)
    assert spy == ["flash_attention_nomax"]          # no grad mode: K1 as in serving
    spy.clear()
    out = tfa.flash_attention(qg, k, v, SCALE, dispatch=dispatch)
    assert spy == ["flash_attention_fwd_lse"]        # under grad: K3 whatever the dispatch
    out.sum().backward()
    # k and v need no gradient (as in DiT cross-attention): K4 is skipped
    assert spy == ["flash_attention_fwd_lse", "flash_attention_bwd_dq"]
    spy.clear()
    kg = k.clone().requires_grad_(True)
    tfa.flash_attention(qg, kg, v, SCALE, dispatch=dispatch).sum().backward()
    assert spy == ["flash_attention_fwd_lse", "flash_attention_bwd_dkv",
                   "flash_attention_bwd_dq"]


def test_grad_with_kv_len_is_refused():
    q = torch.zeros((1, 256, 1, 128), requires_grad=True)
    with pytest.raises(ValueError, match="inference-only"):
        tfa.flash_attention(q, q, q, SCALE, kv_len=torch.tensor([10]))


def test_backward_wrappers_check_their_operands():
    q = torch.zeros((1, 8, 1, 128))
    lse = torch.zeros((1, 1, 8))
    with pytest.raises(ValueError):
        tfa.flash_attention_bwd_dq(q, q, q, q, q, lse.double(), SCALE)
    with pytest.raises(ValueError):
        tfa.flash_attention_bwd_dkv(q, q, q, q[:, :4], q, lse, SCALE)
    meta = torch.empty((1, 256, 1, 128), device="meta")
    with pytest.raises(RuntimeError):
        tfa.flash_attention_fwd_lse(meta, meta, meta, SCALE)
