"""The SD 1.5 and SDXL UNets of the port against the JAX package, at tiny plans.

``sd_unet_apply`` on ``tiny_sd_plan`` in each of its paths (plain, the long prompts'
``ctx_len`` key mask, ControlNet residuals, an IP-Adapter, ``tile_ctx`` and
``cross_frame_attention``), ``motion=`` refused, the diffsynth and civitai loaders against
JAX's converters, and the tiny SDXL UNet with its add embedding and Kolors'
``text_intermediate_proj``.

Weights are the port's random ones, offset so that no bias or norm is trivial; JAX reads
them through its own converters, and the port's modules are loaded from the JAX trees
carried back by ``io/from_jax.py`` (which must give the same state dicts bit for bit).
float32 limits: XLA and torch round the same convs, matmuls and reductions differently
(~1e-6 relative per op), so the UNet's output agrees to ~1e-6 (limit 2e-4 x 1e-3
relative). JAX's side is jitted once per case."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from goal_force_tpu.io import auto as jauto
from goal_force_tpu.models import ipadapter as jip
from goal_force_tpu.models import sd_unet as jsu
from goal_force_tpu.models import sd_vae as jvae
from goal_force_tpu.models import sdxl_unet as jsx

from goal_force_tpu_torch.io import auto as tauto
from goal_force_tpu_torch.io import from_jax
from goal_force_tpu_torch.models import ipadapter as tip
from goal_force_tpu_torch.models import sd_unet as tsu
from goal_force_tpu_torch.models import sd_vae as tvae
from goal_force_tpu_torch.models import sdxl_unet as tsx

TOL = dict(rtol=1e-3, atol=2e-4)
PLAN = tsu.tiny_sd_plan(24)
SDXL_PLAN = (("res", 8, 8), ("push",), ("down", 8), ("push",),
             ("res", 8, 16), ("attn", 2, 8, 16, 24, 2), ("res", 16, 16),
             ("pop",), ("res", 24, 16), ("attn", 2, 8, 16, 24, 2), ("up", 16),
             ("pop",), ("res", 24, 8))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _perturb(model, seed, scale=0.05):
    gen = _gen(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * scale)
    return model


def _np_sd(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def carried(model, tree, convert):
    """The port's module reloaded from the JAX tree through ``from_jax`` (which must give
    the module's own state dict back bit for bit), and the tree as JAX arrays."""
    sd = convert(jax.tree_util.tree_map(np.asarray, tree))
    own = model.state_dict()
    assert sorted(sd) == sorted(own)
    for k, v in own.items():
        np.testing.assert_array_equal(sd[k].numpy(), v.numpy(), err_msg=k)
    model.load_state_dict(sd, strict=True)
    return model, jax.tree_util.tree_map(jnp.asarray, tree)


def tiny_unet(seed=0):
    model = _perturb(tsu.init_sd_unet(PLAN, _gen(seed), device="cpu", model_dim=8,
                                      time_dim=16), seed + 1)
    return carried(model, jsu.sd_unet_params_from_torch(_np_sd(model), PLAN),
                   from_jax.sd_unet_state_dict)


def tiny_ipadapter(plan, ctx_dim, clip_dim, seed):
    model = _perturb(tip.init_ip_adapter(plan, ctx_dim, clip_dim, _gen(seed), device="cpu"),
                     seed + 1)
    return carried(model, jip.ip_adapter_params_from_torch(_np_sd(model)),
                   from_jax.ipadapter_state_dict)


def tiny_vae(seed=50):
    """((encoder, JAX params), (decoder, JAX params)) of the pipelines' tiny SD VAE."""
    enc, dec = (_perturb(m, seed + 1 + i, 0.02)
                for i, m in enumerate(tvae.init_tiny_sd_vae(_gen(seed), device="cpu")))
    return (carried(enc, jvae.sd_vae_encoder_params_from_torch(
                _np_sd(enc), tvae.TINY_SD_VAE_ENCODER_PLAN), from_jax.sd_vae_state_dict),
            carried(dec, jvae.sd_vae_decoder_params_from_torch(
                _np_sd(dec), tvae.TINY_SD_VAE_DECODER_PLAN), from_jax.sd_vae_state_dict))


@pytest.fixture(scope="module")
def unet():
    return tiny_unet()


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(2, 16, 16, 4)).astype(np.float32),
            np.array([900.0, 250.0], np.float32),
            rng.normal(size=(2, 7, 24)).astype(np.float32))


@pytest.mark.parametrize("case", ["plain", "ctx_len", "controlnet", "ipadapter", "tile_ctx",
                                  "cross_frame"])
def test_sd_unet_matches_jax(unet, case):
    """B = 2 rows at different timesteps on a 16x16 latent over 7 context tokens.
    ctx_len: rows of natural length 7 and 3 (the second's last 4 keys masked).
    controlnet: 3 residuals for a stack of 4 (conv_in's and three pushes): the hidden
    state takes the last at the first pop, the stack's first two entries the others and its
    last two stay as they are. ipadapter: 4 image tokens from a (1, 12) embedding into every
    attention unit at scale 0.7. tile_ctx: tiles of 8 at stride 4 (clamped to the 8x8
    level's size there). cross_frame: one sequence over both rows, the batch-mean
    context."""
    model, params = unet
    sample, t, ctx = _inputs()
    kw, tkw = {}, {}
    rng = np.random.default_rng(7)
    if case == "ctx_len":
        kw = tkw = {"ctx_len": np.array([7, 3], np.int32)}
    elif case == "controlnet":
        res = [rng.normal(size=s).astype(np.float32) * 0.5
               for s in ((2, 16, 16, 8), (2, 16, 16, 8), (2, 8, 8, 16))]
        kw, tkw = {"controlnet_res": res}, {"controlnet_res": [_t(r) for r in res]}
    elif case == "ipadapter":
        ipm, ipp = tiny_ipadapter(PLAN, 24, 12, seed=20)
        emb = rng.normal(size=(1, 12)).astype(np.float32)
        kw = {"ipadapter": jip.ipadapter_kwargs_for_plan(PLAN, ipp, jnp.asarray(emb), 0.7)}
        tkw = {"ipadapter": tip.ipadapter_kwargs_for_plan(PLAN, ipm, _t(emb), 0.7)}
    elif case == "tile_ctx":
        kw = tkw = {"tile_ctx": (8, 4)}
    elif case == "cross_frame":
        kw = tkw = {"cross_frame_attention": True}
    want = jax.jit(lambda p, s, tt, c: jsu.sd_unet_apply(p, PLAN, s, tt, c, groups=4, **kw))(
        params, sample, t, ctx)
    got = tsu.sd_unet_apply(model, _t(sample), _t(t), _t(ctx), groups=4, **tkw)
    assert got.shape == sample.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_motion_is_refused(unet):
    sample, t, ctx = _inputs()
    with pytest.raises(NotImplementedError, match="AnimateDiff"):
        tsu.sd_unet_apply(unet[0], _t(sample), _t(t), _t(ctx), groups=4,
                          motion={"modules": [], "call": {}})


def _civitai_names(sd, plan):
    """A diffsynth-named SDUNet state dict in the LDM / civitai layout (test-side
    renaming over JAX's ``_ldm_prefixes``; proj_in / proj_out as 1x1 convs)."""
    out = {}
    put = lambda dst, src: out.__setitem__("model.diffusion_model." + dst, sd[src])
    pair = lambda dst, src: [put(f"{dst}.{w}", f"{src}.{w}") for w in ("weight", "bias")]
    pair("time_embed.0", "time_embedding.0")
    pair("time_embed.2", "time_embedding.2")
    pair("input_blocks.0.0", "conv_in")
    pair("out.0", "conv_norm_out")
    pair("out.2", "conv_out")
    prefixes = iter(jsu._ldm_prefixes(plan))
    for i, spec in enumerate(plan):
        if spec[0] in ("push", "pop"):
            continue
        base, b = next(prefixes), f"blocks.{i}"
        if spec[0] == "res":
            for ldm, ref in (("in_layers.0", "norm1"), ("in_layers.2", "conv1"),
                             ("emb_layers.1", "time_emb_proj"), ("out_layers.0", "norm2"),
                             ("out_layers.3", "conv2"), ("skip_connection", "conv_shortcut")):
                if f"{b}.{ref}.weight" in sd:
                    pair(f"{base}.{ldm}", f"{b}.{ref}")
        elif spec[0] == "attn":
            pair(f"{base}.norm", f"{b}.norm")
            for proj in ("proj_in", "proj_out"):
                w = sd[f"{b}.{proj}.weight"]
                out[f"model.diffusion_model.{base}.{proj}.weight"] = w[:, :, None, None]
                put(f"{base}.{proj}.bias", f"{b}.{proj}.bias")
            for j in range(spec[5] if len(spec) > 5 else 1):
                src, tb = f"{base}.transformer_blocks.{j}", f"{b}.transformer_blocks.{j}"
                for a in ("attn1", "attn2"):
                    for q in ("to_q", "to_k", "to_v"):
                        put(f"{src}.{a}.{q}.weight", f"{tb}.{a}.{q}.weight")
                    pair(f"{src}.{a}.to_out.0", f"{tb}.{a}.to_out")
                for n in ("norm1", "norm2", "norm3"):
                    pair(f"{src}.{n}", f"{tb}.{n}")
                pair(f"{src}.ff.net.0.proj", f"{tb}.act_fn.proj")
                pair(f"{src}.ff.net.2", f"{tb}.ff")
        else:
            pair(f"{base}.{'op' if spec[0] == 'down' else 'conv'}", f"{b}.conv")
    return out


def test_loaders_match_jax(unet, tmp_path):
    """A diffsynth file read by ``load_model`` ("sd_unet", the plan as a keyword) and the
    same weights in the LDM / civitai layout renamed by ``state_dict_from_civitai``: both
    give the module's state dict bit for bit, as JAX's two converters give one tree."""
    from goal_force_tpu_torch.io.safetensors_io import save_safetensors

    model = unet[0]
    sd = _np_sd(model)
    path = str(tmp_path / "unet.safetensors")
    save_safetensors(model.state_dict(), path)
    got = tauto.load_model(path, device="cpu", plan=PLAN)
    want = jauto.load_model(sd, plan=PLAN)
    assert got["kind"] == want["kind"] == "sd_unet" and got["config"] == {"plan": PLAN}
    for k, v in got["model"].state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    civ = _civitai_names(sd, PLAN)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           jsu.sd_unet_params_from_civitai(civ, PLAN),
                           jsu.sd_unet_params_from_torch(sd, PLAN))
    renamed = tsu.state_dict_from_civitai({k: _t(v) for k, v in civ.items()}, PLAN)
    assert sorted(renamed) == sorted(sd)
    for k, v in renamed.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


def test_sdxl_unet_matches_jax():
    """The tiny SDXL plan (depth-2 transformer stacks) with a 6 x 256 + 16-wide add
    embedding and Kolors' text_intermediate_proj (32 -> 24): B = 2, add_time_id (12,)."""
    model = _perturb(tsx.init_sdxl_unet(SDXL_PLAN, _gen(30), device="cpu", model_dim=8,
                                        time_dim=16, add_embed_in=16 + 6 * 256,
                                        text_proj=(32, 24)), 31)
    model, params = carried(model, jsx.sdxl_unet_params_from_torch(_np_sd(model), SDXL_PLAN),
                            from_jax.sd_unet_state_dict)
    rng = np.random.default_rng(32)
    sample = rng.normal(size=(2, 16, 16, 4)).astype(np.float32)
    t = np.array([700.0, 40.0], np.float32)
    text = rng.normal(size=(2, 9, 32)).astype(np.float32)
    ids = np.tile(np.array([128, 96, 0, 0, 128, 96], np.float32), 2)
    pooled = rng.normal(size=(2, 16)).astype(np.float32)
    want = jax.jit(lambda p, *a: jsx.sdxl_unet_apply(p, SDXL_PLAN, *a, groups=4))(
        params, sample, t, text, ids, pooled)
    got = tsx.sdxl_unet_apply(model, *(_t(a) for a in (sample, t, text, ids, pooled)), groups=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    r = tauto.load_model(_np_sd(model), device="cpu", plan=SDXL_PLAN)
    assert r["kind"] == "sdxl_unet" and hasattr(r["model"], "text_intermediate_proj")
    assert tsx.SDXL_PLAN == jsx.SDXL_PLAN
    assert tsu.SD15_PLAN == jsu.SD15_PLAN and PLAN == jsu.tiny_sd_plan(24)

