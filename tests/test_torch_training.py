"""ControlNet training on the port against the JAX package (CPU, float32).

Both packages hold the same random weights (the port's draw, converted to JAX by the
JAX package's torch converter and loaded back through io/from_jax.py); every input is
made with numpy from a seed and handed to both. The
zero convs are set nonzero, so the ControlNet blocks get a gradient (at their zero
init only the zero convs do).
"""

import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
from jax.experimental.pallas import tpu as pltpu

from goal_force_tpu import configs as jcfg
from goal_force_tpu.pipelines.model_fn import denoise_forward as jdenoise
from goal_force_tpu.schedulers import flow_match as jfm
from goal_force_tpu.training import train_step as jts

from goal_force_tpu_torch import configs as tcfg
from goal_force_tpu_torch.io.from_jax import controlnet_state_dict, params_from_jax
from goal_force_tpu_torch.models.controlnet import GoalForceControlNet
from goal_force_tpu_torch.models.t5 import T5Encoder
from goal_force_tpu_torch.models.vae import WanVAE
from goal_force_tpu_torch.models.wan_dit import WanDiT, empty_module
from goal_force_tpu_torch.schedulers import flow_match as tfm
from goal_force_tpu_torch.training import train_step as tts


def _small_head128_configs(jax_side: bool):
    """A head_dim-128 DiT (2 heads) over the tiny T5/VAE, so attention takes the kernels."""
    mod = jcfg if jax_side else tcfg
    _, t5_cfg, vae_cfg, cn_cfg = mod.tiny_pipeline_configs()
    dit_cfg = mod.WanDiTConfig(dim=256, in_dim=2 * vae_cfg.z_dim + 4, ffn_dim=512,
                               out_dim=vae_cfg.z_dim, text_dim=t5_cfg.dim, freq_dim=32,
                               num_heads=2, num_layers=2, rope_max_len=64)
    return dit_cfg, t5_cfg, vae_cfg, cn_cfg


def _build(configs_fn, seed=0):
    """JAX params (nonzero zero convs) and the port's modules with the same weights. The
    weights are the port's random draw, carried into JAX by the JAX package's own torch
    converter (goal_force_tpu/io/torch_convert.py) and back through io/from_jax.py, which
    the port's modules load: jitting JAX's init of the tiny models costs a minute of
    compiling on a loaded CPU."""
    from goal_force_tpu.io import torch_convert as tc
    from goal_force_tpu_torch.models import controlnet as tcn_init
    from goal_force_tpu_torch.models import t5 as tt5_init
    from goal_force_tpu_torch.models import vae as tvae_init
    from goal_force_tpu_torch.models import wan_dit as tdit_init

    dit_cfg, t5_cfg, vae_cfg, cn_cfg = configs_fn(True)
    t_cfgs = configs_fn(False)
    gen = torch.Generator().manual_seed(seed)
    f32 = torch.float32
    dit = tdit_init.init_wan_dit(t_cfgs[0], gen, f32, device="cpu")
    src = {"dit": dit, "t5": tt5_init.init_t5(t_cfgs[1], gen, f32, device="cpu"),
           "vae": tvae_init.init_vae(t_cfgs[2], gen, f32, device="cpu"),
           "controlnet": tcn_init.init_from_dit(dit, t_cfgs[0], t_cfgs[3], gen, f32,
                                                device="cpu")}
    rng = np.random.default_rng(seed + 4)
    with torch.no_grad():
        for zc in src["controlnet"].controlnet_zero_convs_after:
            for t in (zc.weight, zc.bias):
                t.copy_(torch.from_numpy(rng.normal(size=t.shape).astype(np.float32) * 0.05))
    np_sd = lambda m: {k: v.numpy() for k, v in m.state_dict().items()}
    conv = {"dit": lambda sd: tc.dit_params_from_torch(sd, dit_cfg),
            "t5": lambda sd: tc.t5_params_from_torch(sd, t5_cfg),
            "vae": lambda sd: tc.vae_params_from_torch(sd, vae_cfg),
            "controlnet": lambda sd: tc.controlnet_params_from_torch(sd, cn_cfg)}
    params = {k: jax.tree_util.tree_map(jnp.asarray, conv[k](np_sd(m))) for k, m in src.items()}
    tree = jax.tree_util.tree_map(np.asarray, params)
    sds = params_from_jax(tree)
    ctors = {"dit": (WanDiT, t_cfgs[0]), "t5": (T5Encoder, t_cfgs[1]),
             "vae": (WanVAE, t_cfgs[2]), "controlnet": (GoalForceControlNet, t_cfgs[0], t_cfgs[3])}
    mods = {}
    for name, (cls, *cfgs) in ctors.items():
        m = empty_module(cls, *cfgs, dtype=torch.float32, device="cpu")
        m.load_state_dict(sds[name])
        mods[name] = m.eval().requires_grad_(False)
    return params, mods, (dit_cfg, t5_cfg, vae_cfg, cn_cfg), t_cfgs


@pytest.fixture(scope="module")
def tiny():
    return _build(lambda jax_side: (jcfg if jax_side else tcfg).tiny_pipeline_configs())


@pytest.fixture(scope="module")
def head128():
    return _build(_small_head128_configs)


def _loss_inputs(dit_cfg, t5_cfg, vae_cfg, seed=1, lat=(2, 4, 6)):
    rng = np.random.default_rng(seed)
    z = vae_cfg.z_dim
    f, h, w = lat
    arr = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(x0=arr(1, f, h, w, z), noise=arr(1, f, h, w, z), sigma=0.93,
                timestep=np.full((1,), 930.0, np.float32), weight=1.7,
                context=arr(1, t5_cfg.text_len, t5_cfg.dim), y=arr(1, f, h, w, 4 + z),
                control_latents=arr(1, f, h, w, z))


def _jax_loss_and_grads(params, cfgs, inp, attn_impl):
    """JAX training_loss, composed without remat for the Pallas interpreter (whose
    callbacks jax.checkpoint cannot wrap); remat changes no value."""
    dit_cfg, _, _, cn_cfg = cfgs
    j = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in inp.items()}

    def f(cn):
        if attn_impl == "auto":
            return jts.training_loss(params["dit"], cn, dit_cfg, cn_cfg, j["x0"], j["noise"],
                                     j["sigma"], j["timestep"], j["weight"], j["context"],
                                     j["y"], j["control_latents"], attn_impl=attn_impl)
        v = jdenoise(params["dit"], dit_cfg, jfm.add_noise(j["x0"], j["noise"], j["sigma"]),
                     j["timestep"], j["context"], y=j["y"], controlnet_params=cn,
                     controlnet_cfg=cn_cfg, control_latents=j["control_latents"],
                     attn_impl=attn_impl)
        target = jfm.training_target(j["x0"], j["noise"])
        return jnp.mean((v - target) ** 2) * j["weight"]

    loss, grads = jax.value_and_grad(f)(params["controlnet"])
    return float(loss), controlnet_state_dict(jax.tree_util.tree_map(np.asarray, grads))


def _port_loss_and_grads(mods, t_cfgs, inp, attn_impl, remat=True):
    dit_cfg, _, _, cn_cfg = t_cfgs
    t = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in inp.items()}
    cn = mods["controlnet"].requires_grad_(True)
    try:
        loss = tts.training_loss(mods["dit"], cn, dit_cfg, cn_cfg, t["x0"], t["noise"],
                                 t["sigma"], t["timestep"], t["weight"], t["context"], t["y"],
                                 t["control_latents"], attn_impl=attn_impl, remat=remat)
        params = tts.trainable_params(cn)
        grads = torch.autograd.grad(loss, list(params.values()))
    finally:
        cn.requires_grad_(False)
    return float(loss.detach()), dict(zip(params, grads))


def _assert_grads_close(got, ref, rtol):
    """Each parameter's gradient within rtol of that gradient's largest element."""
    assert set(got) == set(ref)
    for name, g in got.items():
        r = ref[name].numpy()
        scale = max(float(np.abs(r).max()), 1e-12)
        err = float(np.abs(g.numpy() - r).max())
        assert err <= rtol * scale, f"{name}: max err {err} vs max |grad| {scale}"


def test_training_weights_and_target_equal_jax():
    j = jfm.make_schedule(num_steps=1000, shift=5.0, sigma_min=0.0, extra_one_step=True,
                          training=True)
    t = tfm.make_schedule(num_steps=1000, shift=5.0, sigma_min=0.0, extra_one_step=True,
                          training=True)
    np.testing.assert_array_equal(t.training_weights, j.training_weights)
    np.testing.assert_array_equal(t.sigmas, j.sigmas)
    assert tfm.make_schedule(num_steps=10).training_weights is None
    rng = np.random.default_rng(0)
    x0, eps = rng.normal(size=(2, 3)).astype(np.float32), rng.normal(size=(2, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tfm.training_target(torch.from_numpy(x0), torch.from_numpy(eps)).numpy(),
        np.asarray(jfm.training_target(jnp.asarray(x0), jnp.asarray(eps))))


def test_training_loss_and_controlnet_grads_match_jax_tiny(tiny):
    params, mods, cfgs, t_cfgs = tiny
    inp = _loss_inputs(cfgs[0], cfgs[1], cfgs[2])
    ref_loss, ref_grads = _jax_loss_and_grads(params, cfgs, inp, "auto")
    loss, grads = _port_loss_and_grads(mods, t_cfgs, inp, "auto")
    # float32 on both sides, another summation order: ~1e-6 relative
    assert loss == pytest.approx(ref_loss, rel=1e-5)
    _assert_grads_close(grads, ref_grads, rtol=1e-4)
    block_grads = [g for n, g in grads.items() if n.startswith("controlnet_dit.")]
    assert all(float(g.abs().max()) > 0 for g in block_grads)


def test_training_loss_through_kernels_matches_jax_pallas(head128):
    """head_dim 128: the port's FlashAttentionFn (plain K3/K4/K5 on CPU) against JAX's
    custom-VJP Pallas kernels in interpret mode."""
    params, mods, cfgs, t_cfgs = head128
    inp = _loss_inputs(cfgs[0], cfgs[1], cfgs[2], seed=2, lat=(2, 8, 16))
    with pltpu.force_tpu_interpret_mode():
        ref_loss, ref_grads = _jax_loss_and_grads(params, cfgs, inp, "pallas")
    loss, grads = _port_loss_and_grads(mods, t_cfgs, inp, "flash")
    assert loss == pytest.approx(ref_loss, rel=1e-5)
    _assert_grads_close(grads, ref_grads, rtol=1e-4)


def test_remat_equals_no_remat(head128):
    _, mods, cfgs, t_cfgs = head128
    inp = _loss_inputs(cfgs[0], cfgs[1], cfgs[2], seed=3, lat=(2, 8, 16))
    loss_a, grads_a = _port_loss_and_grads(mods, t_cfgs, inp, "flash", remat=True)
    loss_b, grads_b = _port_loss_and_grads(mods, t_cfgs, inp, "flash", remat=False)
    assert loss_a == loss_b           # recomputation repeats the same CPU arithmetic
    for name in grads_a:
        torch.testing.assert_close(grads_a[name], grads_b[name], rtol=0, atol=0)


def _batch(t5_cfg, t=5, h=32, w=32, seed=0):
    rng = np.random.default_rng(seed)
    return {"video": rng.uniform(-1, 1, (1, t, h, w, 3)).astype(np.float32),
            "control": rng.uniform(-1, 1, (1, t, h, w, 3)).astype(np.float32),
            "ids": rng.integers(2, t5_cfg.vocab, (1, t5_cfg.text_len)).astype(np.int32),
            "mask": np.ones((1, t5_cfg.text_len), np.int32)}


def _port_state(mods, opt):
    cn = copy.deepcopy(mods["controlnet"]).requires_grad_(True)
    return tts.TrainState(cn, opt.init(tts.trainable_params(cn)), 0)


def test_train_step_matches_jax_on_jax_draws(tiny):
    params, mods, cfgs, t_cfgs = tiny
    dit_cfg, t5_cfg, vae_cfg, cn_cfg = cfgs
    batch = _batch(t5_cfg)
    jopt = jts.make_optimizer()
    jstep = jts.make_train_step(dit_cfg, t5_cfg, vae_cfg, cn_cfg, jopt, num_frames=5)
    cn_dev = jax.tree_util.tree_map(jnp.array, params["controlnet"])
    jstate = jts.TrainState(cn_dev, jopt.init(cn_dev), jnp.zeros((), jnp.int32))
    frozen = {k: params[k] for k in ("dit", "t5", "vae")}
    rng = jax.random.PRNGKey(1)
    jstate, jm = jstep(jstate, frozen, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    # the JAX step's own draws: tid from the first key, the noise from the second
    k_t, k_n = jax.random.split(rng)
    tid = int(jax.random.randint(k_t, (), 0, 358))
    noise = np.array(jax.random.normal(k_n, (1, 2, 4, 4, vae_cfg.z_dim), jnp.float32))

    opt = tts.make_optimizer()
    step = tts.make_train_step(*t_cfgs, opt, num_frames=5)
    state = _port_state(mods, opt)
    tb = tts.host_batch(*(batch[k] for k in ("video", "control", "ids", "mask")), device="cpu")
    frozen_t = {k: mods[k] for k in ("dit", "t5", "vae")}
    state, m = step(state, frozen_t, tb, tid=tid, noise=torch.from_numpy(noise))
    assert state.step == 1
    assert m["timestep"] == float(jm["timestep"])
    assert m["loss"] == pytest.approx(float(jm["loss"]), rel=1e-4)
    assert m["grad_norm"] == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
    mu = controlnet_state_dict(jax.tree_util.tree_map(np.asarray, jstate.opt_state[1][0].mu))
    _assert_grads_close({n: state.opt_state[f"exp_avg.{n}"] for n in mu}, mu, rtol=1e-3)
    # Adam's first step moves every weight by ~lr (1e-5) along sign(g); elements whose
    # gradient is noise-level (|g| ~ eps) may move differently, by at most ~2 lr.
    new = controlnet_state_dict(jax.tree_util.tree_map(np.asarray, jstate.params))
    for name, p in state.params.state_dict().items():
        np.testing.assert_allclose(p.numpy(), new[name].numpy(), atol=2e-5, rtol=0)
        assert np.mean(np.abs(p.numpy() - new[name].numpy()) > 1e-7) < 1e-3, name


def test_train_step_changes_only_the_controlnet(tiny):
    _, mods, cfgs, t_cfgs = tiny
    opt = tts.make_optimizer(lr=1e-3)
    step = tts.make_train_step(*t_cfgs, opt, num_frames=5)
    state = _port_state(mods, opt)
    before = {k: {n: p.clone() for n, p in mods[k].state_dict().items()}
              for k in ("dit", "t5", "vae", "controlnet")}
    tb = tts.host_batch(*(_batch(t_cfgs[1], seed=5)[k] for k in ("video", "control", "ids",
                                                                  "mask")), device="cpu")
    timings = {}
    state, m = step(state, {k: mods[k] for k in ("dit", "t5", "vae")}, tb,
                    torch.Generator().manual_seed(3), timings=timings)
    for k in ("dit", "t5", "vae", "controlnet"):      # the caller's modules are untouched
        for n, p in mods[k].state_dict().items():
            assert torch.equal(p, before[k][n]), f"{k}.{n} changed"
    changed = [not torch.equal(p, before["controlnet"][n])
               for n, p in state.params.state_dict().items()]
    assert all(changed)
    sched = tfm.make_schedule(num_steps=1000, shift=5.0, sigma_min=0.0, training=True)
    assert float(sched.timesteps[357]) <= m["timestep"] <= 1000.0
    assert np.isfinite(m["loss"]) and m["grad_norm"] > 0
    assert set(timings) == {"vae_encode_video", "vae_encode_control", "vae_encode_first_frame",
                            "t5", "forward_backward", "optimizer"}
    with pytest.raises(ValueError):
        step(state, {k: mods[k] for k in ("dit", "t5", "vae")}, tb)     # no draws given


@pytest.mark.parametrize("clip", [1e-3, 1e3], ids=["clipped", "unclipped"])
def test_adamw_and_clip_match_optax(clip):
    rng = np.random.default_rng(0)
    shapes = {"a": (4, 3), "b": (5,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    jopt = jts.make_optimizer(lr=1e-2, grad_clip=clip)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jst = jopt.init(jp)
    opt = tts.make_optimizer(lr=1e-2, grad_clip=clip)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    st = opt.init(tp)
    for i in range(3):
        g = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        up, jst = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jst, jp)
        jp = optax.apply_updates(jp, up)
        assert opt.update({k: torch.from_numpy(v) for k, v in g.items()}, st, tp)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(st[f"exp_avg_sq.{k}"].numpy(),
                                       np.asarray(jst[1][0].nu[k]), rtol=1e-5, atol=1e-12)
    assert int(st["count"]) == 3


def test_grad_accumulation_matches_optax_multisteps():
    rng = np.random.default_rng(1)
    params = {"w": rng.normal(size=(6,)).astype(np.float32)}
    jopt = jts.make_optimizer(lr=1e-2, grad_clip=100.0, grad_accum_steps=2)
    jp = {"w": jnp.asarray(params["w"])}
    jst = jopt.init(jp)
    opt = tts.make_optimizer(lr=1e-2, grad_clip=100.0, grad_accum_steps=2)
    tp = {"w": torch.from_numpy(params["w"].copy())}
    st = opt.init(tp)
    for i in range(4):
        g = {"w": rng.normal(size=(6,)).astype(np.float32)}
        up, jst = jopt.update({"w": jnp.asarray(g["w"])}, jst, jp)
        jp = optax.apply_updates(jp, up)
        applied = opt.update({"w": torch.from_numpy(g["w"])}, st, tp)
        assert applied == (i % 2 == 1)
        np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]), rtol=1e-6, atol=1e-7)
    assert int(st["count"]) == 2 and int(st["mini_step"]) == 0


def test_unported_training_options_raise(tiny):
    """pp_microbatches is ported (a step without a "pp" mesh runs run_blocks, as JAX's):
    what stays refused is pipelining a strided ControlNet, with JAX's error, raised by
    the step's denoiser before its trunk; and the CUDA default without a card."""
    import dataclasses

    _, mods, _, t_cfgs = tiny
    dit_cfg, t5_cfg, vae_cfg, cn_cfg = t_cfgs
    opt = tts.make_optimizer()
    step = tts.make_train_step(dit_cfg, t5_cfg, vae_cfg, dataclasses.replace(cn_cfg, stride=2),
                               opt, num_frames=5, pp_microbatches=2)
    batch = _batch(t5_cfg)
    tb = tts.host_batch(*(batch[k] for k in ("video", "control", "ids", "mask")), device="cpu")
    with pytest.raises(NotImplementedError, match="pp_microbatches cannot be combined"):
        step(_port_state(mods, opt), {k: mods[k] for k in ("dit", "t5", "vae")}, tb, tid=10,
             noise=torch.zeros(1, 2, 4, 4, vae_cfg.z_dim))
    if not torch.cuda.is_available():     # the default device is CUDA: refused without one
        with pytest.raises(RuntimeError, match="CUDA"):
            tts.host_batch(np.zeros(1), np.zeros(1), np.zeros(1), np.zeros(1))
