"""The low-precision serving slice on the port against the JAX package (CPU, float32).

JAX's block linears are packed by quantize_linear_tree (W8A8, paths self_attn,
cross_attn and ffn, as scripts/measure_int8_step.py packs them) and carried to the port
by io/from_jax.py, so both sides run the same int8 codes; "pallas_int8" (the Pallas
kernel in interpret mode) is held against "flash_int8" (K6's plain version on CPU
tensors). The W8A8 tiny pipeline against JAX's is test_torch_pipeline.py's
test_w8a8_pipeline_frames_match_jax, which shares that file's pipelines.

Tolerances. Both sides compute every int8 product exactly; they differ by float32
rounding (~1e-7 relative) in norms, softmax and sums. Where such a difference puts an
activation on the other side of a rounding boundary of the next linear's per-token
quantization, that code moves by one step, which moves the linear's output by one code
step: x_amax / 127 times a weight. The bounds below are derived from that step.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from goal_force_tpu import configs as jcfg
from goal_force_tpu.models import controlnet as jcn
from goal_force_tpu.models import wan_dit as jdit
from goal_force_tpu.ops.quant import quantize_linear_tree
from goal_force_tpu.pipelines.model_fn import denoise_forward as jdenoise

from goal_force_tpu_torch import configs as tcfg
from goal_force_tpu_torch.io.from_jax import controlnet_state_dict, dit_state_dict
from goal_force_tpu_torch.models.controlnet import GoalForceControlNet
from goal_force_tpu_torch.models.wan_dit import WanDiT, empty_module
from goal_force_tpu_torch.ops import attention as tattn
from goal_force_tpu_torch.ops import flash_attention as tfa
from goal_force_tpu_torch.ops import quant as tq
from goal_force_tpu_torch.pipelines.model_fn import denoise_forward

QPATHS = ("self_attn", "cross_attn", "ffn")


def _load(cls, sd, *cfgs):
    m = empty_module(cls, *cfgs, device="cpu")
    tq.pack_like_state_dict(m, sd)
    m.load_state_dict(sd)
    return m.eval().requires_grad_(False)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_denoise_forward_int8_matches_jax_pallas_int8():
    """One merged-CFG denoise_forward at dim 256 with 2 heads of 128, W8A8 packs in the
    DiT and the ControlNet: JAX "pallas_int8" (interpret mode) against the port's
    "flash_int8". Every block linear and attention quantizes its input, so one float32
    ulp upstream can flip a code: moving the port's own latents by one ulp moves its
    velocity by up to 1.1e-3 (4.4e-5 on average), as much as it differs from JAX. A
    flipped code moves a linear's output by one code step, at most 1/127 of the largest
    output it can give: the velocity is held to one code step of its largest value, and
    to 1e-4 of it on average, which is under half of what the packs themselves change.
    The unpacked model is the control, at the 1e-4 of float32 rounding."""
    dit_cfg = jcfg.WanDiTConfig(dim=256, in_dim=36, ffn_dim=512, out_dim=16, text_dim=32,
                                freq_dim=32, num_heads=2, num_layers=2, rope_max_len=64)
    cn_cfg = jcfg.ControlNetConfig(num_layers=1, in_channels=16)
    tdc = tcfg.WanDiTConfig(**{k: getattr(dit_cfg, k) for k in dit_cfg.__dataclass_fields__})
    tcc = tcfg.ControlNetConfig(num_layers=1, in_channels=16)
    dit = jdit.init_wan_dit(jax.random.PRNGKey(0), dit_cfg, jnp.float32)
    cn = jcn.init_from_dit(jax.random.PRNGKey(1), dit, dit_cfg, cn_cfg, jnp.float32)
    rng = np.random.default_rng(3)
    cn["zero_convs"] = {k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32) * 0.05)
                        for k, v in cn["zero_convs"].items()}
    arr = lambda *s: rng.normal(size=s).astype(np.float32)
    lat = np.repeat(arr(1, 2, 8, 12, 16), 2, axis=0)
    inp = dict(latents=lat, timestep=np.full((2,), 937.5, np.float32),
               context=arr(2, 7, 32), y=arr(2, 2, 8, 12, 20), control_latents=arr(2, 2, 8, 12, 16))
    results = {}
    for packed in (False, True):
        jd, jc = dit, cn
        if packed:
            jd = dict(dit, blocks=quantize_linear_tree(dit["blocks"], paths=QPATHS))
            jc = dict(cn, blocks=quantize_linear_tree(cn["blocks"], paths=QPATHS))
        with pltpu.force_tpu_interpret_mode():
            ref = jdenoise(jd, dit_cfg, *(jnp.asarray(inp[k]) for k in ("latents", "timestep",
                                                                          "context")),
                           y=jnp.asarray(inp["y"]), controlnet_params=jc, controlnet_cfg=cn_cfg,
                           control_latents=jnp.asarray(inp["control_latents"]),
                           attn_impl="pallas_int8" if packed else "pallas")
        model = _load(WanDiT, dit_state_dict(_np(jd)), tdc)
        tcn = _load(GoalForceControlNet, controlnet_state_dict(_np(jc)), tdc, tcc)
        assert isinstance(model.blocks[1].ffn[2], tq.Int8Linear) == packed
        assert isinstance(tcn.controlnet_dit.blocks[0].self_attn.k, tq.Int8Linear) == packed
        t = {k: torch.from_numpy(v) for k, v in inp.items()}
        with torch.no_grad():
            got = denoise_forward(model, tdc, t["latents"], t["timestep"], t["context"], y=t["y"],
                                  controlnet=tcn, controlnet_cfg=tcc,
                                  control_latents=t["control_latents"],
                                  attn_impl="flash_int8" if packed else "flash").numpy()
        ref = np.asarray(ref)
        results[packed] = ref
        top = np.abs(ref).max()
        np.testing.assert_allclose(got, ref, rtol=0, atol=(1 / 127 if packed else 1e-4) * top)
        if packed:
            assert np.abs(got - ref).mean() <= 1e-4 * top
    assert np.abs(results[True] - results[False]).mean() > 2e-4 * top


def test_flash_int8_routing(monkeypatch):
    """"flash_int8" calls flash_attention_int8; a bias or a kv_len takes the plain
    attention instead, as JAX sends "pallas_int8" to XLA."""
    calls = []

    def spy(q, k, v, scale):
        calls.append(scale)
        return tfa.flash_attention_int8_plain(q, k, v, scale)

    monkeypatch.setattr(tfa, "flash_attention_int8", spy)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 130, 2, 128), generator=g) for _ in range(3))
    out = tattn.attention(q, k, v, impl="flash_int8")
    assert calls == [128**-0.5]
    np.testing.assert_array_equal(out.numpy(), tfa.flash_attention_int8_plain(q, k, v, 128**-0.5)
                                  .numpy())
    bias = torch.randn((2, 1, 130, 130), generator=g)
    got = tattn.attention(q, k, v, impl="flash_int8", bias=bias)
    np.testing.assert_array_equal(got.numpy(), tattn.plain_attention(q, k, v, 128**-0.5, bias)
                                  .numpy())
    lens = torch.tensor([100, 130])
    got = tattn.attention(q, k, v, impl="flash_int8", kv_len=lens)
    np.testing.assert_array_equal(got.numpy(), tattn.plain_attention(q, k, v, 128**-0.5,
                                                                     kv_len=lens).numpy())
    assert len(calls) == 1
    with pytest.raises(ValueError, match="impl"):
        tattn.attention(q, k, v, impl="pallas_int8")


@pytest.mark.parametrize("kind", [None, "int8"])
def test_feed_forward_chunks_compute_the_same_function(kind, monkeypatch):
    """dit_block's MLP runs over chunks of FFN_CHUNK_TOKENS tokens; it acts on each token
    alone, so 7-token chunks of 2 x 40 tokens give the unchunked result, bit for bit with
    packs (each row's codes and int32 sums do not depend on the others) and to float32
    rounding of the matmul without."""
    from goal_force_tpu_torch.models import wan_dit as tdit

    cfg = tcfg.tiny_dit(num_layers=1)
    blk = tdit.init_wan_dit(cfg, torch.Generator().manual_seed(0), torch.float32,
                            device="cpu").blocks[0]
    if kind:
        tq.quantize_linear_modules(blk, QPATHS, kind)
    h = torch.randn((2, 40, cfg.dim), generator=torch.Generator().manual_seed(1))
    whole = tdit.feed_forward(blk, h)
    monkeypatch.setattr(tdit, "FFN_CHUNK_TOKENS", 7)
    chunked = tdit.feed_forward(blk, h)
    if kind:
        np.testing.assert_array_equal(chunked.numpy(), whole.numpy())
    else:
        np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=1e-6, atol=1e-6)
