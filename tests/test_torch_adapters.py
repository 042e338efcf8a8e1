"""The port's adapter modules and the adapter branches of denoise_forward against the
JAX package (CPU, float32, tiny widths).

Camera coordinates and Plücker embeddings are float64 numpy on both sides and must be
equal; module outputs (SimpleAdapter, the motion controller, VACE hints, the camera
patch projection) are held to 1e-5 of their scale. Adapter weights cross in both
directions: reference-format state dicts drawn by the port go through JAX's
``*_from_torch`` converters, and JAX's own random trees through ``io/from_jax.py`` into
the port's strict loaders. ``denoise_forward`` with each new branch (motion offset,
camera tokens, Fun-Reference tokens, the strided ControlNet and VACE, those two with
remat on and off) is held to 1e-4 of its output's scale.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from goal_force_tpu import configs as jcfg
from goal_force_tpu.io import torch_convert as tc
from goal_force_tpu.models import adapters as jad
from goal_force_tpu.models import camera_controller as jcam
from goal_force_tpu.pipelines import model_fn as jmf

from goal_force_tpu_torch import configs as tcfg
from goal_force_tpu_torch.io.from_jax import params_from_jax
from goal_force_tpu_torch.models import adapters as tad
from goal_force_tpu_torch.models import camera_controller as tcam
from goal_force_tpu_torch.models import controlnet as tcn
from goal_force_tpu_torch.models import wan_dit as tdit
from goal_force_tpu_torch.pipelines import model_fn as tmf
from goal_force_tpu_torch.pipelines.goal_force import load_state_dict_strict

from test_torch_variant_pipes import numpy_sd


def close(got, ref, rel=1e-5):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=rel * max(1e-6, float(np.abs(ref).max())))


def jtree(sd_to_tree, module):
    return jax.tree_util.tree_map(jnp.asarray, sd_to_tree(numpy_sd(module)))


@pytest.mark.parametrize("direction", ["Left", "Right", "Up", "Down", "In", "Out",
                                       "LeftUpIn", "Static"])
def test_camera_coordinates_and_plucker_equal_jax(direction):
    origin = tcam.DEFAULT_ORIGIN
    got = tcam.generate_camera_coordinates(direction, 9, 1 / 30, origin)
    assert got == jcam.generate_camera_coordinates(direction, 9, 1 / 30, origin)
    for w, h in ((48, 32), (32, 48)):   # both aspect branches of the intrinsics
        np.testing.assert_array_equal(tcam.plucker_embedding(got, w, h),
                                      jcam.plucker_embedding(got, w, h))
    np.testing.assert_array_equal(tcam.camera_control_embedding(direction, 5, 32, 48),
                                  jcam.camera_control_embedding(direction, 5, 32, 48))


def test_simple_adapter_equals_jax_both_ways():
    gen = torch.Generator().manual_seed(1)
    cam = tcam.init_simple_adapter(96, gen, num_residual_blocks=2, device="cpu")
    x = np.random.default_rng(2).normal(size=(3, 32, 48, 24)).astype(np.float32)
    ref = jcam.simple_adapter_apply(jtree(jcam.simple_adapter_params_from_torch, cam),
                                    jnp.asarray(x), stride=2)
    close(tcam.simple_adapter_apply(cam, torch.from_numpy(x), stride=2), ref)
    # a JAX-initialised adapter into the port's strict loader
    jp = jcam.init_simple_adapter(jax.random.PRNGKey(3), out_dim=96, in_dim=24, kernel=2)
    sd = params_from_jax({"camera_adapter": jax.tree_util.tree_map(np.asarray, jp)})
    loaded = tcam.simple_adapter_from_state_dict(sd["camera_adapter"], device="cpu")
    close(tcam.simple_adapter_apply(loaded, torch.from_numpy(x), stride=2),
          jcam.simple_adapter_apply(jp, jnp.asarray(x), stride=2))


def test_motion_controller_equals_jax_both_ways():
    gen = torch.Generator().manual_seed(4)
    mc = tad.init_motion_controller(gen, freq_dim=32, dim=96, device="cpu")
    assert not mc.linear[4].weight.any()
    with torch.no_grad():
        mc.linear[4].weight.normal_(generator=gen)
    ids = np.array([0.0, 17.0, 100.0], np.float32)
    ref = jad.motion_controller_apply(jtree(jad.motion_controller_from_torch, mc),
                                      jnp.asarray(ids), freq_dim=32)
    close(tad.motion_controller_apply(mc, torch.from_numpy(ids)), ref)
    jp = jad.init_motion_controller(jax.random.PRNGKey(5), freq_dim=32, dim=96)
    jp["fc2"]["w"] = jax.random.normal(jax.random.PRNGKey(6), jp["fc2"]["w"].shape)
    sd = params_from_jax({"motion_controller": jax.tree_util.tree_map(np.asarray, jp)})
    loaded = tad.motion_controller_from_state_dict(sd["motion_controller"], device="cpu")
    close(tad.motion_controller_apply(loaded, torch.from_numpy(ids)),
          jad.motion_controller_apply(jp, jnp.asarray(ids), freq_dim=32))


@pytest.fixture(scope="module")
def dit():
    """A 4-layer tiny DiT (port) with ref_conv, its JAX tree, and both configs."""
    tcfg_, jcfg_ = (dataclasses.replace(m.tiny_pipeline_configs(4)[0], in_dim=12)
                    for m in (tcfg, jcfg))
    gen = torch.Generator().manual_seed(7)
    model = tdit.init_wan_dit(tcfg_, gen, torch.float32, device="cpu")
    tdit.init_ref_conv_(model, 4, gen)
    return model, jtree(lambda sd: tc.dit_params_from_torch(sd, jcfg_), model), tcfg_, jcfg_


def _rope_inputs(cfg, tokens, seed):
    rng = np.random.default_rng(seed)
    ctx = rng.normal(size=(2, 8, cfg.dim)).astype(np.float32)
    t_mod = rng.normal(size=(2, 6, cfg.dim)).astype(np.float32) * 0.1
    grid = (2, 2, 3)
    cos, sin = tdit.rope_for_grid(cfg, grid, torch.device("cpu"))
    x = rng.normal(size=(2, tokens, cfg.dim)).astype(np.float32)
    return x, ctx, t_mod, cos, sin


def test_vace_hints_equal_jax_both_ways(dit):
    _, _, tc_, jc_ = dit
    gen = torch.Generator().manual_seed(8)
    vace = tad.init_vace(tc_, gen, (0, 2), vace_in_dim=72, device="cpu")
    assert hasattr(vace.vace_blocks[0], "before_proj")
    assert not hasattr(vace.vace_blocks[1], "before_proj")
    x, ctx, t_mod, cos, sin = _rope_inputs(tc_, 12, 9)
    vctx = np.random.default_rng(10).normal(size=(2, 2, 4, 6, 72)).astype(np.float32)
    jcos, jsin = jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy())
    ref = jad.vace_hints(jtree(lambda sd: jad.vace_from_torch(sd, jc_, (0, 2)), vace), jc_,
                         jnp.asarray(x), jnp.asarray(vctx), jnp.asarray(ctx),
                         jnp.asarray(t_mod), jcos, jsin, vace_layers=(0, 2))
    got = tad.vace_hints(vace, tc_, torch.from_numpy(x), torch.from_numpy(vctx),
                         torch.from_numpy(ctx), torch.from_numpy(t_mod), cos, sin)
    assert len(got) == 2
    for i in range(2):
        close(got[i], ref[i])
    # JAX's init -> from_jax -> the port's strict loader; a context of fewer tokens
    jp = jad.init_vace(jax.random.PRNGKey(11), jc_, (0, 2), vace_in_dim=72)
    sd = params_from_jax({"vace": jax.tree_util.tree_map(np.asarray, jp)})["vace"]
    loaded = tad.vace_from_state_dict(sd, tc_, 2, device="cpu")
    short = vctx[:, :1]
    ref = jad.vace_hints(jp, jc_, jnp.asarray(x), jnp.asarray(short), jnp.asarray(ctx),
                         jnp.asarray(t_mod), jcos, jsin, vace_layers=(0, 2))
    got = tad.vace_hints(loaded, tc_, torch.from_numpy(x), torch.from_numpy(short),
                         torch.from_numpy(ctx), torch.from_numpy(t_mod), cos, sin)
    for i in range(2):
        close(got[i], ref[i])
    del sd["vace_blocks.1.after_proj.bias"]
    with pytest.raises(KeyError, match=r"vace_blocks\.1\.after_proj\.bias"):
        tad.vace_from_state_dict(sd, tc_, 2, device="cpu")


def test_apply_vace_hints_equals_jax():
    x = np.ones((1, 3, 2), np.float32)
    hints = np.arange(12, dtype=np.float32).reshape(2, 1, 3, 2)
    for block in range(6):
        ref = jad.apply_vace_hints(block, jnp.asarray(x), jnp.asarray(hints), (1, 4), 0.5)
        got = tad.apply_vace_hints(block, torch.from_numpy(x), torch.from_numpy(hints),
                                   (1, 4), 0.5)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert tad.VACE_LAYERS_14B == jad.VACE_LAYERS_14B
    assert tad.VACE_LAYERS_1_3B == jad.VACE_LAYERS_1_3B


def test_plucker_rays_and_camera_adapter_apply_equal_jax():
    rng = np.random.default_rng(12)
    ext = np.tile(np.eye(4), (3, 1, 1))
    ext[:, :3, 3] = rng.normal(size=(3, 3))
    ext[1, :3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    np.testing.assert_array_equal(tad.plucker_rays(ext, 0.8, 1.1, 0.5, 0.45, 8, 12),
                                  jad.plucker_rays(ext, 0.8, 1.1, 0.5, 0.45, 8, 12))
    lin = torch.nn.Linear(6 * 4, 96)
    x = rng.normal(size=(2, 3, 8, 12, 6)).astype(np.float32)
    p = {"w": jnp.asarray(lin.weight.detach().numpy().T),
         "b": jnp.asarray(lin.bias.detach().numpy())}
    close(tad.camera_adapter_apply(lin, torch.from_numpy(x)),
          jad.camera_adapter_apply(p, jnp.asarray(x)))


def test_ref_conv_crosses_both_ways(dit):
    model, jparams, tc_, _ = dit
    sd = params_from_jax({"dit": jax.tree_util.tree_map(np.asarray, jparams)})["dit"]
    assert tdit.dit_kwargs(sd) == {"ref_conv_in": 4}
    back = tdit.empty_module(tdit.WanDiT, tc_, device="cpu", **tdit.dit_kwargs(sd))
    load_state_dict_strict(back, sd, "dit")
    for k, t in model.state_dict().items():
        assert torch.equal(t, back.state_dict()[k]), k


# ---------------------------------------------------------------------------
# denoise_forward's branches
# ---------------------------------------------------------------------------

def _forward_inputs(cfg, seed, frames=2):
    rng = np.random.default_rng(seed)
    lat = rng.normal(size=(2, frames, 4, 6, 4)).astype(np.float32)
    y = rng.normal(size=(2, frames, 4, 6, 8)).astype(np.float32)
    ctx = rng.normal(size=(2, 8, cfg.text_dim)).astype(np.float32)
    return lat, np.array([900.0, 300.0], np.float32), ctx, y


def _both_forwards(dit, jkw, tkw, seed=13, frames=2):
    model, jparams, tc_, jc_ = dit
    lat, ts, ctx, y = _forward_inputs(tc_, seed, frames)
    ref = jmf.denoise_forward(jparams, jc_, jnp.asarray(lat), jnp.asarray(ts),
                              jnp.asarray(ctx), y=jnp.asarray(y), **jkw)
    got = tmf.denoise_forward(model, tc_, torch.from_numpy(lat), torch.from_numpy(ts),
                              torch.from_numpy(ctx), y=torch.from_numpy(y), **tkw)
    return got, ref


def test_motion_camera_and_reference_branches_equal_jax(dit):
    _, _, tc_, _ = dit
    rng = np.random.default_rng(14)
    off = rng.normal(size=(2, 6, tc_.dim)).astype(np.float32) * 0.1
    cam = rng.normal(size=(2, 12, tc_.dim)).astype(np.float32) * 0.1
    ref_lat = rng.normal(size=(2, 4, 6, 4)).astype(np.float32)
    cases = (dict(t_mod_offset=off), dict(camera_embedding=cam),
             dict(reference_latents=ref_lat),
             dict(t_mod_offset=off, camera_embedding=cam, reference_latents=ref_lat))
    for case in cases:
        got, ref = _both_forwards(dit, {k: jnp.asarray(v) for k, v in case.items()},
                                  {k: torch.from_numpy(v) for k, v in case.items()})
        close(got, ref, rel=1e-4)
    plain, _ = _both_forwards(dit, {}, {})
    assert (got - plain).abs().max() > 1e-3


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_strided_controlnet_branch_equals_jax(dit, remat):
    """Stride 2, 2 ControlNet blocks (copies of DiT blocks 0 and 2) over 4 DiT blocks:
    raw states after blocks 0 and 2; LoRA's block_weights sees the global block index."""
    model, _, tc_, jc_ = dit
    cfg_t = tcfg.ControlNetConfig(num_layers=2, stride=2, in_channels=4)
    cfg_j = jcfg.ControlNetConfig(num_layers=2, stride=2, in_channels=4)
    cn = tcn.init_from_dit(model, tc_, cfg_t, torch.Generator().manual_seed(15), torch.float32,
                           device="cpu")
    jcn = jtree(lambda sd: tc.controlnet_params_from_torch(sd, cfg_j), cn)
    cl = np.random.default_rng(16).normal(size=(2, 2, 4, 6, 4)).astype(np.float32)
    seen = []

    def block_weights(i, blk):
        seen.append(i)
        return blk

    got, ref = _both_forwards(
        dit, dict(controlnet_params=jcn, controlnet_cfg=cfg_j, control_latents=jnp.asarray(cl),
                  remat=remat),
        dict(controlnet=cn, controlnet_cfg=cfg_t, control_latents=torch.from_numpy(cl),
             remat=remat, block_weights=block_weights))
    close(got, ref, rel=1e-4)
    assert seen == [0, 1, 2, 3]


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_vace_branch_equals_jax(dit, remat):
    model, _, tc_, jc_ = dit
    vace = tad.init_vace(tc_, torch.Generator().manual_seed(17), (1, 2), vace_in_dim=72,
                         device="cpu")
    jv = jtree(lambda sd: jad.vace_from_torch(sd, jc_, (1, 2)), vace)
    vctx = np.random.default_rng(18).normal(size=(2, 2, 4, 6, 72)).astype(np.float32)
    got, ref = _both_forwards(
        dit, dict(vace_params=jv, vace_context=jnp.asarray(vctx), vace_scale=0.5,
                  vace_layers=(1, 2), remat=remat),
        dict(vace=vace, vace_context=torch.from_numpy(vctx), vace_scale=0.5,
             vace_layers=(1, 2), remat=remat))
    close(got, ref, rel=1e-4)


def test_forward_refuses_what_jax_refuses(dit):
    model, jparams, tc_, jc_ = dit
    cfg_t, cfg_j = tcfg.ControlNetConfig(1, None, 4), jcfg.ControlNetConfig(1, None, 4)
    cn = tcn.init_from_dit(model, tc_, cfg_t, torch.Generator().manual_seed(19), torch.float32,
                           device="cpu")
    jcn = jtree(lambda sd: tc.controlnet_params_from_torch(sd, cfg_j), cn)
    vace = tad.init_vace(tc_, torch.Generator().manual_seed(20), (0,), 72, device="cpu")
    jv = jtree(lambda sd: jad.vace_from_torch(sd, jc_, (0,)), vace)
    cl = np.zeros((2, 2, 4, 6, 4), np.float32)
    ref_lat = np.zeros((2, 4, 6, 4), np.float32)
    vctx = np.zeros((2, 2, 4, 6, 72), np.float32)
    cn_j = dict(controlnet_params=jcn, controlnet_cfg=cfg_j, control_latents=jnp.asarray(cl))
    cn_t = dict(controlnet=cn, controlnet_cfg=cfg_t, control_latents=torch.from_numpy(cl))
    for jkw, tkw, err in (
            (dict(cn_j, reference_latents=jnp.asarray(ref_lat)),
             dict(cn_t, reference_latents=torch.from_numpy(ref_lat)), NotImplementedError),
            (dict(cn_j, vace_params=jv, vace_context=jnp.asarray(vctx), vace_layers=(0,)),
             dict(cn_t, vace=vace, vace_context=torch.from_numpy(vctx), vace_layers=(0,)),
             NotImplementedError)):
        with pytest.raises(err):
            _both_forwards(dit, jkw, {})
        with pytest.raises(err):
            _both_forwards((model, jparams, tc_, jc_), {}, tkw)
    bare = tdit.init_wan_dit(tc_, torch.Generator().manual_seed(21), torch.float32, device="cpu")
    jbare = {k: v for k, v in jparams.items() if k != "ref_conv"}
    with pytest.raises(ValueError, match="ref_conv"):
        _both_forwards((bare, jbare, tc_, jc_), dict(reference_latents=jnp.asarray(ref_lat)), {})
    with pytest.raises(ValueError, match="ref_conv"):
        _both_forwards((bare, jbare, tc_, jc_), {},
                       dict(reference_latents=torch.from_numpy(ref_lat)))
