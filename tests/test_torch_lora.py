"""LoRA on the port against the JAX package (CPU, float32, the tiny configs).

The JAX params are the port's random weights (through the JAX package's torch
converter) and the JAX adapters are carried across with io/from_jax.py::lora_from_jax,
so both sides merge and train the same tensors. Merged weights are held to float32 rounding (1e-6 of the
weights' scale); a train step to the bounds of test_torch_training.py's ControlNet step
(loss and gradient norm to 1e-4 relative, first moments to 1e-3 of each tensor's
largest, parameters to 2e-5 after an Adam step of lr 1e-5)."""

import copy
import glob
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from goal_force_tpu import configs as jcfg
from goal_force_tpu import lora as jlora
from goal_force_tpu.io import torch_convert as tc
from goal_force_tpu.training import train_step as jts

from goal_force_tpu_torch import configs as tcfg
from goal_force_tpu_torch import lora as tlora
from goal_force_tpu_torch.io import safetensors_io as tio
from goal_force_tpu_torch.io.from_jax import controlnet_state_dict, dit_state_dict, lora_from_jax
from goal_force_tpu_torch.models.tokenizer import load_tokenizer
from goal_force_tpu_torch.pipelines.goal_force import GoalForcePipeline
from goal_force_tpu_torch.training import train_step as tts
from goal_force_tpu_torch.training.trainer import TrainerConfig, train

RANK = 4


@pytest.fixture(scope="module")
def tiny():
    """The port's tiny modules (random weights, non-zero zero convs) and the JAX params of
    the same weights (the JAX package's torch converter); JAX adapters with non-zero B
    and the port's copy of them."""
    pipe = GoalForcePipeline.init_random(seed=3, device="cpu")
    mods = {k: pipe.models[k] for k in ("dit", "t5", "vae", "controlnet")}
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for zc in mods["controlnet"].controlnet_zero_convs_after:
            zc.weight.copy_(torch.randn(zc.weight.shape, generator=gen) * 0.05)
            zc.bias.copy_(torch.randn(zc.bias.shape, generator=gen) * 0.05)
    cfgs = jcfg.tiny_pipeline_configs()
    np_sd = lambda m: {k: v.numpy() for k, v in m.state_dict().items()}
    params = {"dit": tc.dit_params_from_torch(np_sd(mods["dit"]), cfgs[0]),
              "t5": tc.t5_params_from_torch(np_sd(mods["t5"]), cfgs[1]),
              "vae": tc.vae_params_from_torch(np_sd(mods["vae"]), cfgs[2]),
              "controlnet": tc.controlnet_params_from_torch(np_sd(mods["controlnet"]), cfgs[3])}
    params = jax.tree_util.tree_map(jnp.asarray, params)
    lora = jlora.init_lora(jax.random.PRNGKey(4), params["dit"], rank=RANK)
    rng = np.random.default_rng(5)
    for ab in lora.values():         # B = 0 would make the merge an identity
        ab["b"] = jnp.asarray(rng.normal(size=ab["b"].shape).astype(np.float32) * 0.1)
    jl = jax.tree_util.tree_map(np.asarray, lora)
    return params, jl, mods, lora_from_jax(jl), cfgs, tcfg.tiny_pipeline_configs()


def test_init_lora_shapes_and_zero_b(tiny):
    mods = tiny[2]
    dit = mods["dit"]
    lora = tlora.init_lora(torch.Generator().manual_seed(0), dit, rank=8)
    assert set(lora) == set(tlora.DEFAULT_TARGETS) == set(jlora.DEFAULT_TARGETS)
    assert set(tlora.TARGETS) == set(jlora.TARGETS)
    n, dim, ffn = len(dit.blocks), dit.cfg.dim, dit.cfg.ffn_dim
    for name, ab in lora.items():
        d_in, d_out = {"ffn.0": (dim, ffn), "ffn.2": (ffn, dim)}.get(name, (dim, dim))
        assert ab["a"].shape == (n, d_in, 8) and ab["b"].shape == (n, 8, d_out)
        assert ab["a"].dtype == ab["b"].dtype == torch.float32
        assert not ab["b"].any() and 0.05 < float(ab["a"].std() * 8) < 2.0
    again = tlora.init_lora(torch.Generator().manual_seed(0), dit, rank=8)
    assert all(torch.equal(lora[k]["a"], again[k]["a"]) for k in lora)
    # B = 0: the merged DiT is the base DiT
    merged = tlora.merge_lora(dit, lora)
    for k, v in merged.state_dict().items():
        assert torch.equal(v, dit.state_dict()[k]), k


@pytest.mark.parametrize("alpha", [1.0, 2.5])
def test_merge_lora_equals_jax(tiny, alpha):
    params, jl, mods, tl, _, _ = tiny
    want = dit_state_dict(jax.tree_util.tree_map(
        np.asarray, jlora.merge_lora(params["dit"], jax.tree_util.tree_map(jnp.asarray, jl),
                                     alpha=alpha)))
    got = tlora.merge_lora(mods["dit"], tl, alpha=alpha).state_dict()
    assert got.keys() == want.keys()
    scale = max(float(v.abs().max()) for v in want.values())
    changed = 0
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=1e-6 * scale)
        changed += not torch.equal(got[k], mods["dit"].state_dict()[k])
    assert changed == len(mods["dit"].blocks) * len(tlora.DEFAULT_TARGETS)
    # one block merged on its own (the training path) reads the same weights
    blk = tlora.merged_block(mods["dit"].blocks[1], tl, 1, alpha=alpha)
    for name in ("q", "o"):
        torch.testing.assert_close(getattr(blk.self_attn, name).weight,
                                   got[f"blocks.1.self_attn.{name}.weight"], rtol=0, atol=0)
    torch.testing.assert_close(blk.ffn[2].weight, got["blocks.1.ffn.2.weight"], rtol=0, atol=0)
    assert blk.ffn[1] is mods["dit"].blocks[1].ffn[1] and blk.norm3 is mods["dit"].blocks[1].norm3


def test_merge_rounds_deltas_in_the_weights_dtype():
    """bf16 weights: W + bf16(delta) as JAX computes it, so a delta under half an ulp of
    W leaves W as it is."""
    w = torch.full((4, 3), 1.0, dtype=torch.bfloat16)
    a = torch.full((3, 1), 1e-3)
    b = torch.ones((1, 4))
    assert torch.equal(tlora.merged_weight(w, a, b, 1.0), w)        # ulp(1) / 2 = 3.9e-3
    assert not torch.equal(tlora.merged_weight(w, a * 8, b, 1.0), w)
    jw = jnp.ones((3, 4), jnp.bfloat16)
    jd = jnp.einsum("ir,ro->io", jnp.asarray(a.numpy() * 8), jnp.asarray(b.numpy()))
    np.testing.assert_array_equal(
        tlora.merged_weight(w, a * 8, b, 1.0).float().numpy(),
        np.asarray((jw + jd.astype(jnp.bfloat16)).astype(jnp.float32)).T)


def test_peft_export_and_import_equal_jax(tiny):
    _, jl, _, tl, _, _ = tiny
    for prefix in ("", "diffusion_model."):
        want = jlora.lora_to_peft(jl, prefix=prefix)
        got = tlora.lora_to_peft(tl, prefix=prefix)
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), v)
    peft = jlora.lora_to_peft(jl)
    # both key shapes: ".default" and without it, with the diffusion_model. prefix, and
    # keys that are not LoRA's (ignored)
    plain = {"diffusion_model." + k.replace(".default", ""): torch.from_numpy(v)
             for k, v in peft.items()}
    plain["diffusion_model.blocks.0.norm3.weight"] = torch.ones(3)
    n = len(tl["q"]["a"])
    for sd in ({k: torch.from_numpy(v) for k, v in peft.items()}, plain):
        got = tlora.lora_from_peft(sd, n)
        want = jlora.lora_from_peft({k: np.asarray(v) for k, v in sd.items()}, n)
        assert got.keys() == want.keys() == tl.keys()
        for name in want:
            for ab in ("a", "b"):
                np.testing.assert_array_equal(got[name][ab].numpy(), np.asarray(want[name][ab]))
                assert torch.equal(got[name][ab], tl[name][ab])


def _batch(t5_cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {"video": rng.uniform(-1, 1, (1, 5, 32, 32, 3)).astype(np.float32),
            "control": rng.uniform(-1, 1, (1, 5, 32, 32, 3)).astype(np.float32),
            "ids": rng.integers(2, t5_cfg.vocab, (1, t5_cfg.text_len)).astype(np.int32),
            "mask": np.ones((1, t5_cfg.text_len), np.int32)}


def _flat(jparams):
    """A JAX {"lora"[, "controlnet"]} tree flattened to the port's trainable names."""
    out = {f"lora.{t}.{k}": torch.from_numpy(np.array(v))
           for t, ab in jparams["lora"].items() for k, v in ab.items()}
    if "controlnet" in jparams:
        sd = controlnet_state_dict(jax.tree_util.tree_map(np.asarray, jparams["controlnet"]))
        out.update({f"controlnet.{k}": v for k, v in sd.items()})
    return out


@pytest.mark.parametrize("with_cn", [True, False], ids=["with_controlnet", "lora_only"])
def test_lora_train_step_equals_jax(tiny, with_cn):
    """One make_train_step(train_lora=True) step on JAX's own draws: loss, gradient norm
    over the whole trainable set, first moments and updated tensors."""
    params, jl, mods, tl, cfgs, t_cfgs = tiny
    dit_cfg, t5_cfg, vae_cfg, cn_cfg = cfgs
    batch = _batch(t5_cfg)
    jopt = jts.make_optimizer()
    jstep = jts.make_train_step(dit_cfg, t5_cfg, vae_cfg, cn_cfg, jopt, num_frames=5,
                                train_lora=True)
    jtrain = {"lora": jax.tree_util.tree_map(jnp.array, jl)}
    if with_cn:
        jtrain["controlnet"] = jax.tree_util.tree_map(jnp.array, params["controlnet"])
    jstate = jts.TrainState(jtrain, jopt.init(jtrain), jnp.zeros((), jnp.int32))
    rng = jax.random.PRNGKey(2)
    jstate, jm = jstep(jstate, {k: params[k] for k in ("dit", "t5", "vae")},
                       {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    k_t, k_n = jax.random.split(rng)
    tid = int(jax.random.randint(k_t, (), 0, 358))
    noise = np.array(jax.random.normal(k_n, (1, 2, 4, 4, vae_cfg.z_dim), jnp.float32))

    opt = tts.make_optimizer()
    step = tts.make_train_step(*t_cfgs, opt, num_frames=5, train_lora=True)
    lora = {t: {k: v.clone().requires_grad_(True) for k, v in ab.items()} for t, ab in tl.items()}
    tparams = {"lora": lora}
    if with_cn:
        tparams["controlnet"] = copy.deepcopy(mods["controlnet"]).requires_grad_(True)
    state = tts.TrainState(tparams, opt.init(tts.trainable_params(tparams)), 0)
    base = {k: v.clone() for k, v in mods["dit"].state_dict().items()}
    tb = tts.host_batch(*(batch[k] for k in ("video", "control", "ids", "mask")), device="cpu")
    state, m = step(state, {k: mods[k] for k in ("dit", "t5", "vae")}, tb, tid=tid,
                    noise=torch.from_numpy(noise))
    assert m["timestep"] == float(jm["timestep"])
    assert m["loss"] == pytest.approx(float(jm["loss"]), rel=1e-4)
    assert m["grad_norm"] == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
    mu = _flat(jstate.opt_state[1][0].mu)
    new = _flat(jstate.params)
    got = tts.trainable_params(state.params)
    assert got.keys() == mu.keys() == new.keys()
    for n, ref in mu.items():
        g = state.opt_state[f"exp_avg.{n}"]
        scale = float(ref.abs().max())
        assert scale > 0, n
        torch.testing.assert_close(g, ref, rtol=0, atol=1e-3 * scale)
        np.testing.assert_allclose(got[n].detach().numpy(), new[n].numpy(), atol=2e-5, rtol=0)
    for k, v in mods["dit"].state_dict().items():          # the base never updates
        assert torch.equal(v, base[k]), k


def test_lora_from_jax_carries_the_tree(tiny):
    _, jl, _, tl, _, _ = tiny
    assert tl.keys() == jl.keys()
    for name, ab in jl.items():
        for k, v in ab.items():
            assert tl[name][k].dtype == torch.float32
            np.testing.assert_array_equal(tl[name][k].numpy(), v)


@pytest.fixture(scope="module")
def trainer_setup(tiny):
    _, _, mods, _, _, t_cfgs = tiny
    rng = np.random.default_rng(1)
    dataset = [{"video": rng.uniform(0, 1, (5, 32, 32, 3)).astype(np.float32),
                "control_video": rng.uniform(0, 1, (5, 32, 32, 3)).astype(np.float32),
                "prompt": "a ball rolls"} for _ in range(3)]
    tok = load_tokenizer(None, t_cfgs[1].vocab, t_cfgs[1].text_len, quiet=True)
    return mods, t_cfgs, dataset, tok


def _train(setup, out_dir, cn=True, num_epochs=5, **kw):
    mods, t_cfgs, dataset, tok = setup
    cfg = TrainerConfig(output_dir=str(out_dir), num_epochs=num_epochs, save_steps=2,
                        log_every=1, num_frames=5, height=32, width=32, lr=1e-3,
                        train_lora=True, lora_rank=RANK, keep_last_states=5)
    return train(cfg, *t_cfgs, {k: mods[k] for k in ("dit", "t5", "vae")},
                 mods["controlnet"] if cn else None, dataset, tok, device="cpu", **kw)


def test_lora_checkpoint_save_and_resume(trainer_setup, tmp_path):
    """step-K holds exactly the PEFT keys of the adapters plus the ControlNet's; a resume
    from the full state repeats an uninterrupted run bit for bit; one from step-K alone
    reloads the adapters (the ControlNet restarts from its init, as in JAX)."""
    mods = trainer_setup[0]
    base = {k: v.clone() for k, v in mods["dit"].state_dict().items()}
    full = _train(trainer_setup, tmp_path / "a", max_steps=3)
    _train(trainer_setup, tmp_path / "b", max_steps=2)
    resumed = _train(trainer_setup, tmp_path / "b", resume=True, max_steps=1)
    assert full.step == resumed.step == 3
    a, b = tts.trainable_params(full.params), tts.trainable_params(resumed.params)
    assert a.keys() == b.keys()
    for n in a:
        assert torch.equal(a[n], b[n]), n
    for n, t in full.opt_state.items():
        assert torch.equal(t, resumed.opt_state[n]), n
    assert any(bool(ab["b"].any()) for ab in full.params["lora"].values())  # B moved
    for k, v in mods["dit"].state_dict().items():
        assert torch.equal(v, base[k]), k
    sd = tio.load_safetensors(str(tmp_path / "b" / "step-2.safetensors"))
    want = set(tlora.lora_to_peft(full.params["lora"])) | set(
        tio.export_goalforce_controlnet(mods["controlnet"]))
    assert set(sd) == want
    # step-K alone (no epoch left to run): the adapters come back from the PEFT keys
    for p in glob.glob(str(tmp_path / "b" / "state-*.safetensors")):
        os.remove(p)
    back = tlora.lora_from_peft(tio.load_safetensors(str(tmp_path / "b" / "step-3.safetensors")),
                                len(mods["dit"].blocks))
    again = _train(trainer_setup, tmp_path / "b", resume=True, num_epochs=0)
    assert again.step == 3
    for t, ab in again.params["lora"].items():
        for k in ab:
            assert torch.equal(ab[k].detach(), back[t][k]), (t, k)


def test_lora_alone_trains_without_a_controlnet(trainer_setup, tmp_path):
    state = _train(trainer_setup, tmp_path, cn=False, max_steps=1)
    assert set(state.params) == {"lora"}
    sd = tio.load_safetensors(str(tmp_path / "step-1.safetensors"))
    assert set(sd) == set(tlora.lora_to_peft(state.params["lora"]))
    with pytest.raises(ValueError, match="controlnet"):
        train(TrainerConfig(output_dir=str(tmp_path / "x")), *trainer_setup[1],
              {}, None, [], None, device="cpu")
