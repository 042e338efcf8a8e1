"""The port's host code, scheduler, T5, VAE, ControlNet and denoiser against the JAX
package (CPU, f32; weights converted from the JAX init by io/from_jax.py)."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from goal_force_tpu import configs as jcfg
from goal_force_tpu.data import control_signal as jcs
from goal_force_tpu.models import controlnet as jcn
from goal_force_tpu.models import t5 as jt5
from goal_force_tpu.models import vae as jvae
from goal_force_tpu.models import wan_dit as jdit
from goal_force_tpu.models.tokenizer import HashTokenizer as JaxHashTokenizer
from goal_force_tpu.pipelines.goal_force import build_i2v_mask as j_mask
from goal_force_tpu.pipelines.model_fn import denoise_forward as j_denoise
from goal_force_tpu.schedulers import flow_match as jfm

from goal_force_tpu_torch import configs as tcfg
from goal_force_tpu_torch.data import control_signal as tcs
from goal_force_tpu_torch.io import from_jax
from goal_force_tpu_torch.models import controlnet as tcn
from goal_force_tpu_torch.models import t5 as tt5
from goal_force_tpu_torch.models import vae as tvae
from goal_force_tpu_torch.models import wan_dit as tdit
from goal_force_tpu_torch.models.tokenizer import HashTokenizer
from goal_force_tpu_torch.pipelines.goal_force import build_i2v_mask
from goal_force_tpu_torch.pipelines.model_fn import denoise_forward
from goal_force_tpu_torch.schedulers import flow_match as tfm


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfg(cls, cfg):
    return cls(**dataclasses.asdict(cfg))


# --- host side --------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(num_steps=50), dict(num_steps=4), dict(num_steps=7, shift=3.0, denoising_strength=0.6),
    dict(num_steps=10, extra_one_step=False), dict(num_steps=8, exponential_shift=True,
                                                   dynamic_shift_len=4096),
    dict(num_steps=6, shift_terminal=0.1), dict(num_steps=5, inverse_timesteps=True)])
def test_schedule_equals_jax_exactly(kw):
    a, b = tfm.make_schedule(**kw), jfm.make_schedule(**kw)
    np.testing.assert_array_equal(a.sigmas, b.sigmas)
    np.testing.assert_array_equal(a.timesteps, b.timesteps)
    assert [a.sigma_next(i) for i in range(len(a))] == [b.sigma_next(i) for i in range(len(b))]
    assert tfm.timestep_to_id(a, 500.0) == jfm.timestep_to_id(b, 500.0)
    assert tfm.calculate_shift(4096) == jfm.calculate_shift(4096)


def test_main_path_timesteps():
    s = tfm.make_schedule(num_steps=4)
    np.testing.assert_allclose(s.timesteps, [1000.0, 937.5, 833.3333, 625.0], rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_euler_step_and_add_noise_match_jax(dtype):
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    rng = np.random.default_rng(0)
    x, v = rng.normal(size=(2, 3, 4)).astype(np.float32), rng.normal(size=(2, 3, 4)).astype(np.float32)
    sig, sig_n = np.float32(0.9375), np.float32(0.8333333)
    ref = jfm.euler_step(jnp.asarray(x, jd), jnp.asarray(v, jd), sig, sig_n)
    got = tfm.euler_step(torch.from_numpy(x).to(dtype), torch.from_numpy(v).to(dtype), sig, sig_n)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))
    ref = jfm.add_noise(jnp.asarray(x, jd), jnp.asarray(v, jd), sig)
    got = tfm.add_noise(torch.from_numpy(x).to(dtype), torch.from_numpy(v).to(dtype), sig)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))


def test_hash_tokenizer_ids_equal_jax():
    texts = ["a red ball  rolls &amp; hits\ta cup", "", tcfg.PipelineConfig().negative_prompt]
    for a, b in zip(HashTokenizer(256384, 512)(texts), JaxHashTokenizer(256384, 512)(texts)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("masses", [True, False])
def test_control_render_equals_jax_numpy_backend(masses):
    kw = dict(force=200, angle_deg=30, x_pos=0.3, y_pos=0.5, target_force=100,
              target_angle_deg=90, target_x_pos=0.7, target_y_pos=0.4)
    if masses:
        kw.update(projectile_mass=2.0, projectile_xy_px=(15, 16), target_mass=3.0,
                  target_xy_px=(33, 12), distractor_masses=(1.5,), distractor_xy_px=((5, 5),))
    a = tcs.render_control_video(tcs.ControlSpec(**kw), 9, 32, 48, 30, 400,
                                 rng=np.random.default_rng(1), p_mask_out_direct=0.3,
                                 backend="numpy")
    b = jcs.render_control_video(jcs.ControlSpec(**kw), 9, 32, 48, 30, 400,
                                 rng=np.random.default_rng(1), p_mask_out_direct=0.3,
                                 backend="numpy")
    np.testing.assert_array_equal(a, b)


def test_i2v_mask_equals_jax():
    np.testing.assert_array_equal(build_i2v_mask(81, 21, 6, 7), j_mask(81, 21, 6, 7))


# --- T5 ------------------------------------------------------------------------

def test_t5_matches_jax():
    cfg = jcfg.tiny_t5()
    params = jt5.init_t5(jax.random.PRNGKey(0), cfg, jnp.float32)
    model = tdit.empty_module(tt5.T5Encoder, _cfg(tcfg.T5Config, cfg), device="cpu")
    model.load_state_dict(from_jax.t5_state_dict(_np(params)))
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab, size=(2, cfg.text_len)).astype(np.int32)
    mask = np.zeros_like(ids)
    mask[0, :9], mask[1, :16] = 1, 1
    ref = jt5.t5_encode(params, cfg, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        got = tt5.t5_encode(model, _cfg(tcfg.T5Config, cfg), torch.from_numpy(ids),
                            torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tt5.relative_buckets(16, 16), jt5.relative_buckets(16, 16))


# --- VAE -----------------------------------------------------------------------

@pytest.fixture(scope="module")
def vaes():
    cfg = jcfg.tiny_vae()
    params = jax.jit(lambda k: jvae.init_vae(k, cfg, jnp.float32))(jax.random.PRNGKey(0))
    # non-zero attention projections so the mid-block attention matters
    for side in ("encoder", "decoder"):
        w = params[side]["mid_attn"]["proj"]["w"]
        params[side]["mid_attn"]["proj"]["w"] = jax.random.normal(jax.random.PRNGKey(3), w.shape) * 0.1
    model = tdit.empty_module(tvae.WanVAE, _cfg(tcfg.VAEConfig, cfg), device="cpu")
    model.load_state_dict(from_jax.vae_state_dict(_np(params)))
    return cfg, params, model


def test_vae_plans_equal_jax():
    for cfg in (jcfg.tiny_vae(), jcfg.WAN21_VAE):
        tc = _cfg(tcfg.VAEConfig, cfg)
        assert tvae.encoder_plan(tc) == jvae.encoder_plan(cfg)
        assert tvae.decoder_plan(tc) == jvae.decoder_plan(cfg)


def test_vae_encode_decode_match_jax(vaes):
    cfg, params, model = vaes
    tc = _cfg(tcfg.VAEConfig, cfg)
    video = np.random.default_rng(0).uniform(-1, 1, size=(1, 9, 32, 48, 3)).astype(np.float32)
    ref = jvae.encode_video(params, cfg, jnp.asarray(video))
    with torch.no_grad():
        got = tvae.encode_video(model, tc, torch.from_numpy(video))
    assert got.shape == (1, 3, 4, 6, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    ref_d = jvae.decode_video(params, cfg, ref)
    with torch.no_grad():
        got_d = tvae.decode_video(model, tc, torch.tensor(np.asarray(ref)))
    assert got_d.shape == (1, 9, 32, 48, 3)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(ref_d), rtol=1e-4, atol=1e-4)


def test_vae_tiled_match_jax(vaes):
    cfg, params, model = vaes
    tc = _cfg(tcfg.VAEConfig, cfg)
    video = np.random.default_rng(1).uniform(-1, 1, size=(1, 5, 48, 64, 3)).astype(np.float32)
    tile, stride = (4, 4), (2, 3)
    ref = jvae.encode_video_tiled(params, cfg, jnp.asarray(video), tile, stride)
    with torch.no_grad():
        got = tvae.encode_video_tiled(model, tc, torch.from_numpy(video), tile, stride)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    ref_d = jvae.decode_video_tiled(params, cfg, ref, tile, stride)
    with torch.no_grad():
        got_d = tvae.decode_video_tiled(model, tc, torch.tensor(np.asarray(ref)), tile, stride)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(ref_d), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tvae._blend_mask_1d(10, False, True, 4),
                                  jvae._blend_mask_1d(10, False, True, 4))


# --- ControlNet + denoiser ------------------------------------------------------

@pytest.fixture(scope="module")
def denoiser():
    dit_cfg, _, _, cn_cfg = jcfg.tiny_pipeline_configs(num_layers=3, cn_layers=2)
    dit = jdit.init_wan_dit(jax.random.PRNGKey(0), dit_cfg, jnp.float32)
    cn = jcn.init_from_dit(jax.random.PRNGKey(1), dit, dit_cfg, cn_cfg, jnp.float32)
    tdit_cfg = _cfg(tcfg.WanDiTConfig, dit_cfg)
    tcn_cfg = _cfg(tcfg.ControlNetConfig, cn_cfg)
    model = tdit.empty_module(tdit.WanDiT, tdit_cfg, device="cpu")
    model.load_state_dict(from_jax.dit_state_dict(_np(dit)))
    rng = np.random.default_rng(0)
    z = cn_cfg.in_channels
    inputs = dict(
        latents=rng.normal(size=(2, 2, 4, 6, z)).astype(np.float32),
        timestep=np.asarray([937.5, 937.5], np.float32),
        context=rng.normal(size=(2, 5, dit_cfg.text_dim)).astype(np.float32),
        y=rng.normal(size=(2, 2, 4, 6, dit_cfg.in_dim - z)).astype(np.float32),
        control_latents=rng.normal(size=(2, 2, 4, 6, z)).astype(np.float32))
    return dit_cfg, cn_cfg, dit, cn, tdit_cfg, tcn_cfg, model, inputs


def _port_cn(cn_params, dit_cfg, cn_cfg):
    m = tdit.empty_module(tcn.GoalForceControlNet, dit_cfg, cn_cfg, device="cpu")
    m.load_state_dict(from_jax.controlnet_state_dict(_np(cn_params)))
    return m


def _run_port(model, dit_cfg, inputs, cn=None, cn_cfg=None):
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    with torch.no_grad():
        return denoise_forward(model, dit_cfg, t["latents"], t["timestep"], t["context"],
                               y=t["y"], controlnet=cn, controlnet_cfg=cn_cfg,
                               control_latents=t["control_latents"] if cn is not None else None
                               ).numpy()


def test_zero_convs_give_exactly_the_dit_output(denoiser):
    dit_cfg, cn_cfg, dit, cn, tdc, tcc, model, inputs = denoiser
    with_cn = _run_port(model, tdc, inputs, _port_cn(cn, tdc, tcc), tcc)
    np.testing.assert_array_equal(with_cn, _run_port(model, tdc, inputs))
    fresh = tcn.init_from_dit(model, tdc, tcc, torch.Generator().manual_seed(0),
                              dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(_run_port(model, tdc, inputs, fresh, tcc), with_cn)


def test_nonzero_zero_convs_match_jax(denoiser):
    dit_cfg, cn_cfg, dit, cn, tdc, tcc, model, inputs = denoiser
    rng = np.random.default_rng(7)
    cn = dict(cn, zero_convs={k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32) * 0.05)
                              for k, v in cn["zero_convs"].items()})
    ref = j_denoise(dit, dit_cfg, *(jnp.asarray(inputs[k]) for k in ("latents", "timestep",
                                                                       "context")),
                    y=jnp.asarray(inputs["y"]), controlnet_params=cn, controlnet_cfg=cn_cfg,
                    control_latents=jnp.asarray(inputs["control_latents"]))
    got = _run_port(model, tdc, inputs, _port_cn(cn, tdc, tcc), tcc)
    assert got.shape == (2, 2, 4, 6, dit_cfg.out_dim)
    assert np.abs(got - _run_port(model, tdc, inputs)).max() > 1e-3   # the ControlNet acts
    np.testing.assert_allclose(got, np.asarray(ref), rtol=2e-4, atol=2e-4)


def test_strided_init_copies_strided_blocks(denoiser):
    dit_cfg, cn_cfg, dit, cn, tdc, tcc, model, inputs = denoiser
    strided = dataclasses.replace(tcc, stride=2)
    port = tcn.init_from_dit(model, tdc, strided, torch.Generator().manual_seed(0),
                             dtype=torch.float32, device="cpu")
    ref = jcn.init_from_dit(jax.random.PRNGKey(1), dit, dit_cfg,
                            dataclasses.replace(cn_cfg, stride=2), jnp.float32)
    for i in range(cn_cfg.num_layers):
        np.testing.assert_array_equal(
            port.controlnet_dit.blocks[i].ffn[0].weight.numpy(),
            np.asarray(ref["blocks"]["ffn"]["fc0"]["w"][i]).T)
        np.testing.assert_array_equal(port.controlnet_dit.blocks[i].modulation.numpy()[0],
                                      np.asarray(ref["blocks"]["modulation"][i]))
    assert not port.controlnet_zero_convs_after[0].weight.any()
