"""TeaCache, the skip path and sliding windows of the port against the JAX package
(CPU, float32, the tiny configs).

The JAX pipeline is built from the port's random weights (through the JAX package's
own torch converter) and the port is given the noise that JAX draws for the same seed, so both run the
same function on the same inputs. Frames are held to 1e-3, as the plain pipeline is in
test_torch_pipeline.py; the forwards to 1e-4 of their outputs' scale (float32 with
another summation order)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from goal_force_tpu import configs as jcfg
from goal_force_tpu.configs import PipelineConfig
from goal_force_tpu.data import ControlSpec, render_control_video
from goal_force_tpu.io import torch_convert as tc
from goal_force_tpu.models.tokenizer import load_tokenizer
from goal_force_tpu.pipelines import GoalForcePipeline as JaxPipeline
from goal_force_tpu.pipelines import model_fn as jmf
from goal_force_tpu.pipelines.teacache import TEACACHE_COEFFICIENTS as JAX_COEFFICIENTS
from goal_force_tpu.pipelines.teacache import TeaCache as JaxTeaCache

from goal_force_tpu_torch.pipelines import model_fn as tmf
from goal_force_tpu_torch.pipelines.goal_force import GoalForcePipeline
from goal_force_tpu_torch.pipelines.teacache import TEACACHE_COEFFICIENTS, TeaCache

FRAMES, H, W = 17, 32, 48          # 5 latent frames of 4 x 6


def jax_params(models, cfgs):
    """The JAX package's params tree of the port's weights (its own torch converter)."""
    dit_cfg, t5_cfg, vae_cfg, cn_cfg = cfgs
    conv = {"dit": (tc.dit_params_from_torch, dit_cfg), "dit2": (tc.dit_params_from_torch, dit_cfg),
            "t5": (tc.t5_params_from_torch, t5_cfg), "vae": (tc.vae_params_from_torch, vae_cfg),
            "controlnet": (tc.controlnet_params_from_torch, cn_cfg),
            "controlnet2": (tc.controlnet_params_from_torch, cn_cfg)}
    return {name: jax.tree_util.tree_map(jnp.asarray, f(
                {k: v.detach().numpy() for k, v in models[name].state_dict().items()}, cfg))
            for name, (f, cfg) in conv.items() if name in models}


@pytest.fixture(scope="module")
def pipes():
    """The port's tiny pipeline (random weights, non-zero zero convs) and a JAX pipeline
    on the same weights."""
    tpipe = GoalForcePipeline.init_random(seed=2, device="cpu")
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for name in ("controlnet", "controlnet2"):
            for zc in tpipe.models[name].controlnet_zero_convs_after:
                zc.weight.copy_(torch.randn(zc.weight.shape, generator=gen) * 0.05)
                zc.bias.copy_(torch.randn(zc.bias.shape, generator=gen) * 0.05)
    cfgs = jcfg.tiny_pipeline_configs()
    jpipe = JaxPipeline(*cfgs, PipelineConfig(), jax_params(tpipe.models, cfgs),
                        load_tokenizer(None, cfgs[1].vocab, cfgs[1].text_len, quiet=True),
                        jnp.float32)
    return jpipe, tpipe


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(1)
    image = rng.uniform(size=(H, W, 3)).astype(np.float32)
    spec = ControlSpec(force=250, angle_deg=120, x_pos=0.4, y_pos=0.6, target_force=90,
                       target_angle_deg=10, target_x_pos=0.6, target_y_pos=0.3,
                       projectile_mass=1.5, projectile_xy_px=(18, 14), target_mass=2.5,
                       target_xy_px=(30, 20))
    cv = render_control_video(spec, FRAMES, H, W, min_force=30, max_force=400, backend="numpy")
    return image, cv


def _drift_sequence(scale, n=50, seed=0):
    """A t_mod trajectory whose step-to-step relative L1 drift is ~scale."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(2, 6, 64)).astype(np.float32) + 3.0
    seq = [base]
    for _ in range(1, n):
        step = rng.normal(size=base.shape).astype(np.float32)
        step *= scale * np.abs(seq[-1]).mean() / np.abs(step).mean()
        seq.append(seq[-1] + step)
    return seq


@pytest.mark.parametrize("scale", [1e-4, 2e-3, 6e-3, 2e-2, 0.1, 1.0])
@pytest.mark.parametrize("thresh", [0.19, 0.26])
def test_should_skip_equals_jax(scale, thresh):
    """The same decisions over the drift regimes of test_teacache_parity.py: near-zero
    drift (every middle step skips), the trained regime (mixed) and random-init drift
    (none), over two 50-step requests (the counter wraps)."""
    ours = TeaCache(50, thresh, "Wan2.1-I2V-14B-480P")
    ref = JaxTeaCache(50, thresh, "Wan2.1-I2V-14B-480P")
    seq = _drift_sequence(scale) * 2
    got = [ours.should_skip(t) for t in seq]
    assert got == [ref.should_skip(t) for t in seq]
    assert ours.accumulated == ref.accumulated and ours.step == ref.step == 0


def test_teacache_ids_and_store():
    assert TEACACHE_COEFFICIENTS == JAX_COEFFICIENTS
    drift = np.linspace(0.0, 5.0, 500001)
    assert np.poly1d(TEACACHE_COEFFICIENTS["Wan2.1-I2V-14B-480P"])(drift).min() > 0.03
    with pytest.raises(ValueError, match="not a supported"):
        TeaCache(4, 0.1, "nope")
    tc = TeaCache(4, 0.1, "Wan2.1-T2V-14B")
    tc.store(torch.ones(2), torch.full((2,), 3.0))
    assert torch.equal(tc.residual, torch.full((2,), 2.0))


def _forward_inputs(pipe, seed=3, b=2):
    cfg = pipe.dit_cfg
    rng = np.random.default_rng(seed)
    z = pipe.vae_cfg.z_dim
    arr = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(latents=arr(b, 3, 4, 6, z), timestep=np.full((b,), 812.5, np.float32),
                context=arr(b, pipe.t5_cfg.text_len, cfg.text_dim),
                y=arr(b, 3, 4, 6, cfg.in_dim - z), control=arr(b, 3, 4, 6, z))


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def test_token_states_and_skip_path_equal_jax(pipes):
    """return_token_states gives JAX's (v, (tokens_pre, tokens_post)) with the
    ControlNet's injections in tokens_post; denoise_forward_skip on that residual gives
    JAX's skip output, and equals the full forward (same t) up to rounding."""
    jpipe, tpipe = pipes
    inp = _forward_inputs(tpipe)
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    jv, (jpre, jpost) = jmf.denoise_forward(
        jpipe.params["dit"], jpipe.dit_cfg, j["latents"], j["timestep"], j["context"],
        y=j["y"], controlnet_params=jpipe.params["controlnet"], controlnet_cfg=jpipe.cn_cfg,
        control_latents=j["control"], return_token_states=True)
    with torch.no_grad():
        tv, (tpre, tpost) = tmf.denoise_forward(
            tpipe.models["dit"], tpipe.dit_cfg, t["latents"], t["timestep"], t["context"],
            y=t["y"], controlnet=tpipe.models["controlnet"], controlnet_cfg=tpipe.cn_cfg,
            control_latents=t["control"], return_token_states=True)
        plain = tmf.denoise_forward(
            tpipe.models["dit"], tpipe.dit_cfg, t["latents"], t["timestep"], t["context"],
            y=t["y"], controlnet=tpipe.models["controlnet"], controlnet_cfg=tpipe.cn_cfg,
            control_latents=t["control"])
    assert torch.equal(tv, plain)
    for got, want in ((tv, jv), (tpre, jpre), (tpost, jpost)):
        assert tuple(got.shape) == want.shape
        _close(got, want)
    jskip = jmf.denoise_forward_skip(jpipe.params["dit"], jpipe.dit_cfg, j["latents"],
                                     j["timestep"], j["y"], jpost - jpre)
    with torch.no_grad():
        tskip = tmf.denoise_forward_skip(tpipe.models["dit"], tpipe.dit_cfg, t["latents"],
                                         t["timestep"], t["y"], tpost - tpre)
    _close(tskip, jskip)
    _close(tskip, tv, rel=1e-4)


def _toy(scale):
    """A model function that depends on all three window inputs (numpy/JAX or torch)."""
    def fn(lat, y, cl):
        return lat * scale + y[..., :1] - 0.5 * cl
    return fn


@pytest.mark.parametrize("window,stride", [(2, 2), (3, 2), (6, 3), (30, 25), (4, 1)],
                         ids=["border0", "border1", "border3", "window_past_end", "stride1"])
def test_temporal_tiled_forward_equals_jax(window, stride):
    rng = np.random.default_rng(window * 7 + stride)
    lat = rng.normal(size=(2, 9, 3, 4, 5)).astype(np.float32)
    y = rng.normal(size=(2, 9, 3, 4, 3)).astype(np.float32)
    cl = rng.normal(size=(2, 9, 3, 4, 5)).astype(np.float32)
    calls_j, calls_t = [], []

    def jfn(a, b, c):
        calls_j.append(a.shape[1])
        return _toy(1.5)(a, b, c) * (1.0 + 0.1 * len(calls_j))

    def tfn(a, b, c):
        calls_t.append(a.shape[1])
        return _toy(1.5)(a, b, c) * (1.0 + 0.1 * len(calls_t))

    want = jmf.temporal_tiled_forward(jfn, jnp.asarray(lat), jnp.asarray(y), window, stride,
                                      jnp.asarray(cl))
    got = tmf.temporal_tiled_forward(tfn, torch.from_numpy(lat), torch.from_numpy(y), window,
                                     stride, torch.from_numpy(cl))
    assert calls_t == calls_j
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def _jax_noise(seed, z):
    shape = (1, (FRAMES - 1) // 4 + 1, H // 8, W // 8, z)
    return torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(seed), shape,
                                                       jnp.float32)))


def _count_skips(tpipe):
    """Wrap the pipeline's two TeaCache steps so each call is logged ("skip"/"full")."""
    log = []
    full, skip = tpipe.denoise_step, tpipe.denoise_step_skip

    def full_(*a, **k):
        log.append("full" if k.get("return_residual") else "plain")
        return full(*a, **k)

    def skip_(*a, **k):
        log.append("skip")
        return skip(*a, **k)

    tpipe.denoise_step, tpipe.denoise_step_skip = full_, skip_
    return log


# 5 steps: t = 1000, 952.4, 882.4 on the high-noise expert, then 769.2 and 555.6 on the
# low-noise one. 1e12 skips every middle step (the first and last are always computed),
# so the 4th step, on the low-noise expert, replays the high-noise residual.
# The I2V-480P rescale polynomial is at least 0.037 for every drift >= 0, so 0.03
# computes every step.
@pytest.mark.parametrize("thresh,expected", [
    (1e12, ["full", "skip", "skip", "skip", "full"]),
    (0.03, ["full"] * 5)], ids=["skipping", "not_skipping"])
def test_teacache_pipeline_equals_jax(pipes, inputs, thresh, expected):
    jpipe, tpipe = pipes
    image, cv = inputs
    kw = dict(seed=4, num_frames=FRAMES, num_inference_steps=5, tea_cache_l1_thresh=thresh)
    ref = jpipe("a ball rolls left", image, control_signal_video=cv, **kw)
    log = _count_skips(tpipe)
    try:
        got = tpipe("a ball rolls left", image, control_signal_video=cv,
                    noise=_jax_noise(4, tpipe.vae_cfg.z_dim), **kw)
    finally:
        tpipe.__dict__.pop("denoise_step")
        tpipe.__dict__.pop("denoise_step_skip")
    assert log == expected
    assert got.shape == (FRAMES, H, W, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-3)


def test_teacache_without_skips_equals_the_plain_loop(pipes, inputs):
    _, tpipe = pipes
    image, cv = inputs
    kw = dict(noise=_jax_noise(4, tpipe.vae_cfg.z_dim), num_frames=FRAMES,
              num_inference_steps=5, control_signal_video=cv)
    np.testing.assert_array_equal(tpipe("x", image, tea_cache_l1_thresh=0.03, **kw),
                                  tpipe("x", image, **kw))
    # cfg_scale 1 has no merged batch: TeaCache does not apply, as in JAX
    np.testing.assert_array_equal(
        tpipe("x", image, tea_cache_l1_thresh=1e6, cfg_scale=1.0, **kw),
        tpipe("x", image, cfg_scale=1.0, **kw))


@pytest.mark.parametrize("window,stride", [(3, 2), (5, 5)], ids=["two_windows", "one_window"])
def test_sliding_window_pipeline_equals_jax(pipes, inputs, window, stride):
    """Windows of 3 latent frames every 2 over 5 (the ControlNet inside each window),
    and one window over all of them."""
    jpipe, tpipe = pipes
    image, cv = inputs
    kw = dict(seed=5, num_frames=FRAMES, num_inference_steps=3,
              sliding_window_size=window, sliding_window_stride=stride)
    ref = jpipe("a ball rolls up", image, control_signal_video=cv, **kw)
    got = tpipe("a ball rolls up", image, control_signal_video=cv,
                noise=_jax_noise(5, tpipe.vae_cfg.z_dim), **kw)
    assert got.shape == (FRAMES, H, W, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-3)
    if window >= 5:          # one window over every frame: the merged-CFG step itself
        plain = tpipe("a ball rolls up", image, control_signal_video=cv,
                      noise=_jax_noise(5, tpipe.vae_cfg.z_dim), seed=5, num_frames=FRAMES,
                      num_inference_steps=3)
        np.testing.assert_allclose(got, plain, atol=1e-5)
