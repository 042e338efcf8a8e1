"""Flux's side modules in the port against the JAX package: the ControlNet forward with a
Union mode token and extra control channels, InfiniteYou's perceiver projector, the value
controller, the LoRA encoder, ``flux_ip_kwargs``, Step1X's connector (a padded mask) and
the regional-prompt helpers; each module's loader and its ``io/from_jax.py`` converter.

Weights are the port's random ones (``init_adapter``, offset so that no bias or norm is
trivial), read by JAX through its own converters. float32 limits as in the Flux tests:
~1e-6 relative per op, so 1e-4 x 1e-4 relative for the small modules, 5e-4 x 1e-3 for the
ControlNet's trunk; the regional weights to float32 rounding of JAX's resize."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from goal_force_tpu.models import flux_adapters as jad
from goal_force_tpu.models import flux_controlnet as jcn
from goal_force_tpu.models import step1x_connector as js1
from goal_force_tpu.pipelines import flux as jpipe
from goal_force_tpu.pipelines import regional as jreg

from goal_force_tpu_torch.io import auto as tauto
from goal_force_tpu_torch.io import from_jax
from goal_force_tpu_torch.models import flux_adapters as tad
from goal_force_tpu_torch.models import flux_controlnet as tcn
from goal_force_tpu_torch.models import step1x_connector as ts1
from goal_force_tpu_torch.pipelines import flux as tpipe
from goal_force_tpu_torch.pipelines import regional as treg

F32 = dict(rtol=1e-4, atol=1e-4)
DIT_TOL = dict(rtol=1e-3, atol=5e-4)
DIT_CFG = tpipe.tiny_flux_configs()[0]
JDIT_CFG = jpipe.tiny_flux_configs()[0]


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _perturb(model, seed):
    gen = _gen(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.05)
    return model


def _np_sd(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _same_state(model, sd):
    got = model.state_dict()
    assert sorted(got) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


def test_controlnet_with_a_mode_matches_jax():
    """1 joint + 2 single blocks, a Union mode embedder of 3 (mode 1 prepends one text
    token), 8 extra control channels (cond latents of 18 channels); B = 2 at 8x12 behind 5
    text tokens. The residual stacks repeat over intervals to the DiT's 2 + 2 blocks.
    ``load_model`` reads the file back with JAX's config; ``from_jax`` carries JAX's tree
    back to the same state dict."""
    cfg = tcn.FluxControlNetConfig(DIT_CFG, 1, 2, num_mode=3, additional_input_dim=8)
    jcfg = jcn.FluxControlNetConfig(JDIT_CFG, 1, 2, num_mode=3, additional_input_dim=8)
    cn = _perturb(tcn.init_flux_controlnet(cfg, _gen(1), torch.float32, device="cpu"), 2)
    sd = _np_sd(cn)
    params = jcn.flux_controlnet_params_from_torch(sd, jcfg)
    _same_state(cn, from_jax.params_from_jax({"flux_controlnet": params})["flux_controlnet"])
    rng = np.random.default_rng(3)
    args = (rng.normal(size=(2, 8, 12, 16)), rng.normal(size=(2, 8, 12, 18)),
            np.array([700.0, 200.0]), rng.normal(size=(2, 5, DIT_CFG.text_dim)),
            rng.normal(size=(2, DIT_CFG.pooled_dim)), np.array([3.5, 3.5]))
    args = tuple(a.astype(np.float32) for a in args)
    want = jax.jit(lambda p, *a: jcn.flux_controlnet_forward(p, jcfg, *a, mode_id=1))(
        _jnp(params), *args)
    got = tcn.flux_controlnet_forward(cn, cfg, *(_t(a) for a in args), mode_id=1)
    for g, w in zip(got, want):
        assert g.shape == (2, 2, 24, DIT_CFG.dim)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **DIT_TOL)
    stacks = [torch.full((1,), float(i)) for i in range(3)]
    for n in (3, 5, 7):
        assert tcn.align_res_stack(stacks, n).flatten().tolist() == \
            np.asarray(jcn.align_res_stack([jnp.full((1,), float(i)) for i in range(3)], n)
                       ).flatten().tolist()
    loaded = tauto.load_model(sd, dtype=torch.float32, device="cpu", dit_cfg=DIT_CFG)
    assert loaded["config"] == cfg


def test_infiniteyou_projector_matches_jax():
    """dim 32, 2 layers of 4 heads of 8, 3 queries over 5 ArcFace tokens of 16, out 24."""
    m = _perturb(tad.init_adapter(tad.InfiniteYouProjector, 32, 2, 32, 3, 16, 24, 64,
                                  gen=_gen(4), device="cpu"), 5)
    sd = _np_sd(m)
    params = jad.infiniteyou_params_from_torch(sd)
    _same_state(tad.infiniteyou_from_state_dict(_t_sd(sd)), sd)
    _same_state(m, from_jax.params_from_jax({"infiniteyou": params})["infiniteyou"])
    x = np.random.default_rng(6).normal(size=(2, 5, 16)).astype(np.float32)
    want = jax.jit(lambda p, a: jad.infiniteyou_projector(p, a, heads=4, head_dim=8))(
        _jnp(params), x)
    got = tad.infiniteyou_projector(m, _t(x), heads=4, head_dim=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def _t_sd(sd):
    return {k: _t(v) for k, v in sd.items()}


def test_value_controller_matches_jax():
    """Two encoders (in 256, hidden 16, out 24, 32 positions): values 0.7 and None (its
    block dropped), then 0.3 and 0.9."""
    encs = [_perturb(tad.init_adapter(tad.SingleValueEncoder, 256, 16, 24, 32, gen=_gen(7 + i),
                                      device="cpu"), 9 + i) for i in range(2)]
    params = [jad.value_encoder_params_from_torch(_np_sd(e)) for e in encs]
    for e, p in zip(encs, params):
        _same_state(tad.value_encoder_from_state_dict(_t_sd(_np_sd(e))), _np_sd(e))
        _same_state(e, from_jax.params_from_jax({"value_encoder": p})["value_encoder"])
    for values in ([0.7, None], [0.3, 0.9]):
        want = jax.jit(lambda ps: jad.multi_value_embedding(ps, values))(_jnp(params))
        got = tad.multi_value_embedding(encs, values)
        assert got.shape == (32 * sum(v is not None for v in values), 24)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


PATTERNS = [{"name": "blocks.0.attn.a_to_qkv", "dim": (8, 24), "type": "attn.a_to_qkv"},
            {"name": "blocks.0.ff_a.0", "dim": (8, 32), "type": "ff_a.0"},
            {"name": "blocks.1.attn.a_to_qkv", "dim": (8, 24), "type": "attn.a_to_qkv"}]


def test_lora_encoder_matches_jax():
    """Three LoRA targets of two types, 2 probes each, one CLIP layer of 2 heads of 8 over
    [1 special, 6 LoRA tokens], rank-4 LoRAs; the default patterns' count."""
    assert len(tad.flux_lora_patterns()) == len(jad.flux_lora_patterns()) == 19 * 10 + 38 * 3
    assert tad.flux_lora_patterns() == jad.flux_lora_patterns()
    m = _perturb(tad.init_adapter(tad.FluxLoRAEncoder, PATTERNS, 2, 16, 32, 1, 1,
                                  gen=_gen(11), device="cpu"), 12)
    sd = _np_sd(m)
    params = jad.flux_lora_encoder_params_from_torch(sd, PATTERNS)
    _same_state(tad.flux_lora_encoder_from_state_dict(_t_sd(sd), PATTERNS), sd)
    _same_state(m, from_jax.params_from_jax({"flux_lora_encoder": params})["flux_lora_encoder"])
    rng = np.random.default_rng(13)
    lora = {}
    for pat in PATTERNS:
        di, do = pat["dim"]
        lora[pat["name"] + ".lora_A.default.weight"] = rng.normal(size=(4, di)).astype(np.float32)
        lora[pat["name"] + ".lora_B.default.weight"] = rng.normal(size=(do, 4)).astype(np.float32)
    # JAX reads the LoRA through numpy: it enters the jit as a constant
    want = jax.jit(lambda p: jad.flux_lora_encode(p, lora, PATTERNS, heads=2, head_dim=8))(
        _jnp(params))
    got = tad.flux_lora_encode(m, lora, PATTERNS, heads=2)
    assert got.shape == (1, 1, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_flux_ip_kwargs_matches_jax():
    """A FluxIpAdapter of 5 blocks (2 joint + 3 single) at width 64 over 4 heads of 16;
    a SigLIP embedding of 16 -> 3 tokens of 24, B = 2; scale 0.6."""
    m = _perturb(tad.init_adapter(tad.FluxIpAdapter, 5, 64, 24, 16, 3, gen=_gen(14),
                                  device="cpu"), 15)
    sd = _np_sd(m)
    tree = {"image_proj": {"proj0": {"w": sd["image_proj.proj.0.weight"].T,
                                     "b": sd["image_proj.proj.0.bias"]},
                           "proj2": {"w": sd["image_proj.proj.2.weight"].T,
                                     "b": sd["image_proj.proj.2.bias"]},
                           "norm": {"scale": sd["image_proj.norm.weight"],
                                    "bias": sd["image_proj.norm.bias"]}},
            "modules": [{"k_w": sd[f"ipadapter_modules.{i}.to_k_ip.weight"].T,
                         "v_w": sd[f"ipadapter_modules.{i}.to_v_ip.weight"].T} for i in range(5)]}
    _same_state(tad.flux_ipadapter_from_state_dict(_t_sd(sd)), sd)
    _same_state(m, from_jax.params_from_jax({"flux_ipadapter": tree})["flux_ipadapter"])
    emb = np.random.default_rng(16).normal(size=(2, 16)).astype(np.float32)
    kw = dict(num_heads=4, head_dim=16, scale=0.6, num_joint=2, num_single=3)
    want = jax.jit(lambda p, e: jad.flux_ip_kwargs(p, e, **kw))(_jnp(tree), emb)
    got = tad.flux_ip_kwargs(m, _t(emb), **kw)
    for part in ("joint", "single"):
        for k in ("k", "v", "scale"):
            np.testing.assert_allclose(got[part][k].numpy(), np.asarray(want[part][k]), **F32)
    assert got["joint"]["k"].shape == (2, 1, 6, 4, 16)


def test_step1x_connector_matches_jax():
    """in 24, hidden 32 over 4 heads, 2 blocks at mlp ratio 2; B = 2 of 7 tokens, the
    second row padded after 4 (its padded rows still see column 0); t = timestep / 1000.
    The adaLN modulations start at zero: they are offset like every other weight."""
    cfg = ts1.Step1xConnectorConfig(in_channels=24, hidden_size=32, heads_num=4, depth=2,
                                    mlp_ratio=2.0)
    jcfg = js1.Step1xConnectorConfig(**dataclasses.asdict(cfg))
    m = _perturb(ts1.init_step1x_connector(cfg, _gen(17), device="cpu"), 18)
    sd = _np_sd(m)
    params = js1.step1x_connector_params_from_torch(sd, jcfg)
    _same_state(m, from_jax.params_from_jax({"step1x_connector": params})["step1x_connector"])
    rng = np.random.default_rng(19)
    x = rng.normal(size=(2, 7, 24)).astype(np.float32)
    t = np.array([0.9, 0.25], np.float32)
    mask = np.ones((2, 7), np.int32)
    mask[1, 4:] = 0
    want = jax.jit(lambda p, *a: js1.step1x_connector_forward(p, jcfg, *a))(
        _jnp(params), x, t, mask)
    got = ts1.step1x_connector_forward(m, cfg, _t(x), _t(t), _t(mask))
    for g, w, shape in zip(got, want, ((2, 7, 32), (2, 768))):
        assert g.shape == shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)


def test_regional_helpers_match_jax():
    """Two masks (one (H, W), one (H, W, 3)) at 40x56 resized to 24x32, thresholded,
    blurred (kernel 9, sigma 3) and scaled; then the blend of a global and two local
    predictions. A kernel as wide as the mask is refused, as in JAX."""
    rng = np.random.default_rng(20)
    m0 = np.zeros((40, 56), np.float32)
    m0[5:30, 3:25] = 1.0
    m1 = rng.uniform(size=(40, 56, 3)).astype(np.float32)
    want = jreg.local_prompt_weights([m0, m1], [0.8, 1.5], 24, 32, 9, 3.0)
    got = treg.local_prompt_weights([m0, m1], [0.8, 1.5], 24, 32, 9, 3.0)
    assert got.shape == (2, 24, 32, 1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    g, loc = rng.normal(size=(1, 24, 32, 4)), rng.normal(size=(2, 24, 32, 4))
    blend = treg.blend_local_predictions(_t(g), _t(loc), _t(got))
    np.testing.assert_allclose(blend.numpy(), jreg.blend_local_predictions(g, loc, want),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="too large"):
        treg.local_prompt_weights([m0], [1.0], 4, 4, 9, 3.0)
