"""Training a strided ControlNet on the port against the JAX train step (CPU, float32).

A tiny 4-block expert and a 2-block ControlNet of stride 2 (blocks copied from expert
blocks 0 and 2, raw states added after them, no zero convs), drawn by the port and read
by JAX through its own converters. One train step on JAX's own draws: loss and gradient
norm to 1e-4 relative, Adam's first moment (the gradients) to 1e-3 of each tensor's
scale, the zero convs' gradients zero on both sides; the segments run under remat.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from goal_force_tpu.training import train_step as jts

from goal_force_tpu_torch.io.from_jax import controlnet_state_dict
from goal_force_tpu_torch.models import controlnet as tcn
from goal_force_tpu_torch.training import train_step as tts

from test_torch_variant_pipes import configs, jax_params


@pytest.fixture(scope="module")
def models():
    (tdit, tt5, tvae, tcn_cfg), jcfgs = configs(num_layers=4, cn_layers=2, stride=2)
    from goal_force_tpu_torch.pipelines.goal_force import GoalForcePipeline

    pipe = GoalForcePipeline.init_random(3, tdit, tt5, tvae, None, device="cpu")
    mods = {k: pipe.models[k] for k in ("dit", "t5", "vae")}
    mods["controlnet"] = tcn.init_from_dit(mods["dit"], tdit, tcn_cfg,
                                           torch.Generator().manual_seed(4), torch.float32,
                                           device="cpu")
    params = jax_params(mods, *jcfgs)
    return mods, params, (tdit, tt5, tvae, tcn_cfg), jcfgs


def test_strided_train_step_matches_jax(models):
    mods, params, t_cfgs, (dit_cfg, t5_cfg, vae_cfg, cn_cfg) = models
    assert cn_cfg.stride == t_cfgs[3].stride == 2
    assert torch.equal(mods["controlnet"].controlnet_dit.blocks[1].self_attn.q.weight,
                       mods["dit"].blocks[2].self_attn.q.weight)
    rng = np.random.default_rng(0)
    batch = {"video": rng.uniform(-1, 1, (1, 5, 32, 32, 3)).astype(np.float32),
             "control": rng.uniform(-1, 1, (1, 5, 32, 32, 3)).astype(np.float32),
             "ids": rng.integers(2, t5_cfg.vocab, (1, t5_cfg.text_len)).astype(np.int32),
             "mask": np.ones((1, t5_cfg.text_len), np.int32)}
    jopt = jts.make_optimizer()
    jstep = jts.make_train_step(dit_cfg, t5_cfg, vae_cfg, cn_cfg, jopt, num_frames=5)
    cn_dev = jax.tree_util.tree_map(jnp.array, params["controlnet"])
    jstate = jts.TrainState(cn_dev, jopt.init(cn_dev), jnp.zeros((), jnp.int32))
    frozen = {k: params[k] for k in ("dit", "t5", "vae")}
    key = jax.random.PRNGKey(2)
    jstate, jm = jstep(jstate, frozen, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    k_t, k_n = jax.random.split(key)
    tid = int(jax.random.randint(k_t, (), 0, 358))
    noise = np.array(jax.random.normal(k_n, (1, 2, 4, 4, vae_cfg.z_dim), jnp.float32))

    opt = tts.make_optimizer()
    step = tts.make_train_step(*t_cfgs, opt, num_frames=5)
    cn = copy.deepcopy(mods["controlnet"]).requires_grad_(True)
    state = tts.TrainState(cn, opt.init(tts.trainable_params(cn)), 0)
    tb = tts.host_batch(*(batch[k] for k in ("video", "control", "ids", "mask")), device="cpu")
    state, m = step(state, {k: mods[k] for k in ("dit", "t5", "vae")}, tb, tid=tid,
                    noise=torch.from_numpy(noise))
    assert m["timestep"] == float(jm["timestep"])
    assert m["loss"] == pytest.approx(float(jm["loss"]), rel=1e-4)
    assert m["grad_norm"] == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
    mu = controlnet_state_dict(jax.tree_util.tree_map(np.asarray, jstate.opt_state[1][0].mu))
    for name, ref in mu.items():
        got = state.opt_state[f"exp_avg.{name}"].numpy()
        ref = ref.numpy()
        if name.startswith("controlnet_zero_convs_after."):
            assert not got.any() and not ref.any(), name
            continue
        scale = max(float(np.abs(ref).max()), 1e-12)
        assert float(np.abs(got - ref).max()) <= 1e-3 * scale, name
    assert float(np.abs(mu["controlnet_dit.blocks.0.ffn.0.weight"].numpy()).max()) > 0


def test_strided_remat_equals_plain_grads(models):
    """The strided segments under remat give the same loss and gradients as without."""
    mods, _, t_cfgs, _ = models
    dit_cfg, t5_cfg, vae_cfg, cn_cfg = t_cfgs
    rng = np.random.default_rng(5)
    arr = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    z = vae_cfg.z_dim
    inp = (arr(1, 2, 4, 6, z), arr(1, 2, 4, 6, z), 0.9, torch.full((1,), 900.0), 1.3,
           arr(1, t5_cfg.text_len, t5_cfg.dim), arr(1, 2, 4, 6, 4 + z), arr(1, 2, 4, 6, z))
    out = []
    for remat in (False, True):
        cn = copy.deepcopy(mods["controlnet"]).requires_grad_(True)
        loss = tts.training_loss(mods["dit"], cn, dit_cfg, cn_cfg, *inp, remat=remat)
        params = tts.trainable_params(cn)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        out.append((loss, dict(zip(params, grads))))
    assert torch.equal(out[0][0], out[1][0])
    for name, g in out[0][1].items():
        h = out[1][1][name]
        assert (g is None) == (h is None) == name.startswith("controlnet_zero_convs_after.")
        if g is not None:
            torch.testing.assert_close(g, h, rtol=0, atol=0)

