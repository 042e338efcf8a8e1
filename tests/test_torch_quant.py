"""The port's W8A8 int8 and fp8 packs (ops/quant.py) against the JAX package (CPU).

Weights and inputs are made with numpy from a seed. The packs cross from JAX through
io/from_jax.py, so both sides run the same codes; the port's own quantizer is held to the
JAX quantizer's codes and scales bit for bit.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from goal_force_tpu import configs as jcfg
from goal_force_tpu.models import wan_dit as jdit
from goal_force_tpu.ops import quant as jq

from goal_force_tpu_torch import configs as tcfg
from goal_force_tpu_torch.io.from_jax import dit_state_dict
from goal_force_tpu_torch.models import wan_dit as tdit
from goal_force_tpu_torch.ops import quant as tq

QPATHS = ("self_attn", "cross_attn", "ffn")
JAX_QUANTIZE = {"int8": (jq.quantize_weight_int8, "w_i8"), "fp8": (jq.quantize_weight_fp8, "w_f8")}
PORT_QUANTIZE = {"int8": tq.quantize_weight_int8, "fp8": tq.quantize_weight_fp8}
JAX_TREE = {"int8": jq.quantize_linear_tree, "fp8": jq.quantize_linear_tree_fp8}


def _codes(t: torch.Tensor) -> np.ndarray:
    """Codes as comparable numpy: int8 as is, e4m3 as its bytes."""
    return (t.view(torch.uint8) if t.dtype == tq.FP8 else t).numpy()


def _jax_codes(a) -> np.ndarray:
    a = np.asarray(a)
    return a if a.dtype == np.int8 else a.view(np.uint8)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_codes_and_scales_equal_jax(kind, dtype):
    """One scale per output channel (the amax over the input axis), codes rounded the same
    way: both equal JAX's bit for bit, in float32 and from bf16 weights."""
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(96, 40)) * 0.05).astype(np.float32)
    w[:, 7] = 0.0                                   # an all-zero channel: the 1e-8 floor
    jw = jnp.asarray(w).astype(dtype)
    fn, key = JAX_QUANTIZE[kind]
    ref = fn(jw)
    codes, scale = PORT_QUANTIZE[kind](torch.from_numpy(np.asarray(jw, np.float32).T.copy())
                                       .to(torch.bfloat16 if dtype != np.float32 else torch.float32))
    np.testing.assert_array_equal(_codes(codes), _jax_codes(ref[key]).T)
    np.testing.assert_array_equal(scale.numpy(), np.asarray(ref["w_scale"]))


def _tiny_dit(num_layers=2):
    cfg = jcfg.tiny_dit(num_layers=num_layers)
    return cfg, jdit.init_wan_dit(jax.random.PRNGKey(3), cfg, jnp.float32)


def _port_dit(params, cfg):
    """The port's WanDiT loaded from a JAX params tree (packed or not)."""
    sd = dit_state_dict(jax.tree_util.tree_map(np.asarray, params), cfg.patch_size)
    model = tdit.empty_module(tdit.WanDiT, tcfg.WanDiTConfig(**dataclasses.asdict(cfg)),
                              device="cpu")
    tq.pack_like_state_dict(model, sd)
    model.load_state_dict(sd)
    return model.eval().requires_grad_(False), sd


@pytest.mark.parametrize("kind,paths", [("int8", QPATHS), ("fp8", ("ffn",))])
def test_linears_match_jax_on_carried_packs(kind, paths):
    """A JAX pack carried by from_jax gives the port the same codes, and the port's
    int8_linear / fp8_linear give JAX's output: the activation codes, the int32 (or
    exact e4m3-product) sums and the float32 epilogue are the same arithmetic, so only
    the order of a float32 sum can differ (1e-6 of the largest output)."""
    cfg, params = _tiny_dit()
    params = dict(params, blocks=JAX_TREE[kind](params["blocks"], paths=paths))
    model, sd = _port_dit(params, cfg)
    rng = np.random.default_rng(1)
    for path in (("ffn", "fc0"), ("ffn", "fc2")) + ((("self_attn", "q"), ("cross_attn", "o"))
                                                   if kind == "int8" else ()):
        jp = jax.tree_util.tree_map(lambda a: a[1], params["blocks"][path[0]][path[1]])
        layer = getattr(model.blocks[1], path[0])
        layer = layer[{"fc0": 0, "fc2": 2}[path[1]]] if path[0] == "ffn" else getattr(layer, path[1])
        assert isinstance(layer, tq.PACKS[kind])
        np.testing.assert_array_equal(_codes(layer.weight), _jax_codes(jp[JAX_QUANTIZE[kind][1]]).T)
        np.testing.assert_array_equal(layer.weight_scale.numpy(), np.asarray(jp["w_scale"]))
        x = rng.normal(size=(2, 7, layer.in_features)).astype(np.float32)
        ref = np.asarray(jdit.linear(jp, jnp.asarray(x)))
        got = tdit.linear(layer, torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("kind,paths", [("int8", QPATHS), ("fp8", ("ffn",))])
def test_quantize_linear_modules_matches_quantize_linear_tree(kind, paths):
    """quantize_linear_modules on the whole DiT equals the JAX walk on its stacked block
    tree: the same codes and scales per layer, the norms and the non-block linears
    untouched, and run_blocks agreeing with JAX's on the quantized stack (plain
    attention on both sides; 1e-5 of the largest output: float32 sums in another order)."""
    cfg, params = _tiny_dit()
    model, _ = _port_dit(params, cfg)
    norms = {k: v.clone() for k, v in model.state_dict().items() if ".norm" in k}
    tq.quantize_linear_modules(model, paths, kind)
    qblocks = JAX_TREE[kind](params["blocks"], paths=paths)
    key = JAX_QUANTIZE[kind][1]
    for i, blk in enumerate(model.blocks):
        for name in paths:
            mod = getattr(blk, name)
            pairs = ([(mod[0], "fc0"), (mod[2], "fc2")] if name == "ffn" else
                     [(getattr(mod, p), p) for p in ("q", "k", "v", "o")])
            for layer, leaf in pairs:
                ref = qblocks[name][leaf]
                assert isinstance(layer, tq.PACKS[kind])
                np.testing.assert_array_equal(_codes(layer.weight), _jax_codes(ref[key])[i].T)
                np.testing.assert_array_equal(layer.weight_scale.numpy(),
                                              np.asarray(ref["w_scale"])[i])
    for k, v in model.state_dict().items():
        if k in norms:
            assert v.dtype == torch.float32 and torch.equal(v, norms[k]), k
    assert type(model.text_embedding[0]) is torch.nn.Linear
    assert type(model.head.head) is torch.nn.Linear

    rng = np.random.default_rng(2)
    grid = (2, 2, 2)
    x = rng.normal(size=(2, 8, cfg.dim)).astype(np.float32)
    ctx = rng.normal(size=(2, 5, cfg.dim)).astype(np.float32)
    tmod = (rng.normal(size=(2, 6, cfg.dim)) * 0.02).astype(np.float32)
    from goal_force_tpu.ops.rope import assemble_rope, rope_tables_3d
    from goal_force_tpu_torch.ops import rope as trope

    cos, sin = assemble_rope(rope_tables_3d(cfg.head_dim, cfg.rope_max_len), *grid)
    ref, _ = jdit.run_blocks(qblocks, jnp.asarray(x), jnp.asarray(ctx), jnp.asarray(tmod),
                             cos, sin, cfg, attn_impl="xla")
    tc, ts = trope.assemble_rope(trope.rope_tables_3d(cfg.head_dim, cfg.rope_max_len), *grid,
                                 device="cpu")
    with torch.no_grad():
        got = tdit.run_blocks(model.blocks, torch.from_numpy(x), torch.from_numpy(ctx),
                              torch.from_numpy(tmod), tc, ts, model.cfg, attn_impl="plain")
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_fp8_never_packs_a_norm():
    """The JAX fp8 walk lacks the int8 walk's norm* guard: on a stacked tree it packs the
    (L, dim) q/k-norm weights, which rms_norm then cannot read. The port replaces only
    nn.Linear modules, so its norms stay float weights and the blocks still run."""
    cfg, params = _tiny_dit()
    jtree = jq.quantize_linear_tree_fp8(params["blocks"], paths=("self_attn",))
    assert "w_f8" in jtree["self_attn"]["norm_q"]          # the JAX quirk, not carried over
    model, _ = _port_dit(params, cfg)
    tq.quantize_linear_modules(model, ("self_attn", "cross_attn", "ffn"), "fp8")
    for blk in model.blocks:
        for attn in (blk.self_attn, blk.cross_attn):
            assert isinstance(attn.q, tq.Fp8Linear)
            assert attn.norm_q.weight.dtype == torch.float32
            assert attn.norm_k.weight.dtype == torch.float32
        assert blk.norm3.weight.dtype == torch.float32
    x = torch.randn(1, 2, 4, 6, 16, generator=torch.Generator().manual_seed(0))
    y = torch.randn(1, 2, 4, 6, cfg.in_dim - 16, generator=torch.Generator().manual_seed(1))
    ctx = torch.randn(1, 7, cfg.text_dim, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        out = tdit.wan_dit_forward(model, model.cfg, x, torch.tensor([900.0]), ctx, y=y)
    assert bool(torch.isfinite(out).all())


def test_packs_keep_their_dtypes_under_to():
    """Module.to(dtype) casts floating-point tensors, and e4m3 codes and float32 scales
    count as such: the packs keep theirs, and only the bias takes the new dtype."""
    lin = torch.nn.Linear(32, 16)
    for kind, cls in tq.PACKS.items():
        pack = cls.from_linear(lin).to(torch.bfloat16)
        assert pack.weight.dtype == cls.code_dtype
        assert pack.weight_scale.dtype == torch.float32
        assert pack.bias.dtype == torch.bfloat16
        pack = pack.float().to("cpu", torch.float64)
        assert pack.weight.dtype == cls.code_dtype and pack.weight_scale.dtype == torch.float32
        ref_codes, ref_scale = PORT_QUANTIZE[kind](lin.weight.detach())
        assert torch.equal(_codes_t(pack.weight), _codes_t(ref_codes))
        assert torch.equal(pack.weight_scale, ref_scale)


def _codes_t(t):
    return t.view(torch.uint8) if t.dtype == tq.FP8 else t


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_row_chunks_compute_the_same_function(kind, monkeypatch):
    """Each row has its own activation scale, so the product chunked over rows is the
    same function, bit for bit."""
    lin = torch.nn.Linear(64, 48)
    pack = tq.PACKS[kind].from_linear(lin)
    x = torch.randn(3, 37, 64, generator=torch.Generator().manual_seed(4))
    whole = pack(x)
    monkeypatch.setattr(tq, "CHUNK_BYTES", 4 * 64 * 10)          # 10 rows per chunk
    np.testing.assert_array_equal(pack(x).numpy(), whole.numpy())


def test_quantize_rejects_unknown_kind():
    with pytest.raises(ValueError):
        tq.quantize_linear_modules(torch.nn.Linear(4, 4), ("ffn",), kind="int4")
