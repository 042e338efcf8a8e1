"""The port's trainer, checkpoints and safetensors files (CPU, tiny configs).

Mirrors tests/test_trainer_resume.py for the port, and holds the port's files against
the JAX package's: a step-K.safetensors written by the port loads through JAX
``load_goalforce_controlnet`` and equals JAX ``export_goalforce_controlnet`` of the same
parameters, and the port's reader and writer agree with the ``safetensors`` package.
"""

import copy
import glob
import json
import os

import numpy as np
import pytest

import jax
import torch
from safetensors.numpy import load_file, save_file

from goal_force_tpu import configs as jcfg
from goal_force_tpu.data.datasets import should_skip as jax_should_skip
from goal_force_tpu.io import safetensors_io as jio

from goal_force_tpu_torch.data.datasets import should_skip
from goal_force_tpu_torch.io import safetensors_io as tio
from goal_force_tpu_torch.pipelines.goal_force import GoalForcePipeline
from goal_force_tpu_torch.training import train_step as tts
from goal_force_tpu_torch.training.trainer import (
    MetricsLogger,
    TrainerConfig,
    step_generator,
    train,
)


@pytest.fixture(scope="module")
def setup():
    pipe = GoalForcePipeline.init_random(seed=0, device="cpu")
    frozen = {k: pipe.models[k] for k in ("dit", "t5", "vae")}
    rng = np.random.default_rng(0)
    dataset = [{"video": rng.uniform(0, 1, (5, 32, 32, 3)).astype(np.float32),
                "control_video": rng.uniform(0, 1, (5, 32, 32, 3)).astype(np.float32),
                "prompt": "a ball rolls"} for _ in range(3)]
    dataset.append({"video": dataset[0]["video"], "control_video": np.zeros((4, 32, 32, 3)),
                    "prompt": "a bad sample"})                # skipped: wrong frame count
    return pipe, frozen, pipe.models["controlnet"], dataset


def _cfg(out_dir, **kw):
    kw = {"save_steps": 2, **kw}
    return TrainerConfig(output_dir=str(out_dir), num_epochs=10, log_every=1, num_frames=5,
                         height=32, width=32, lr=1e-3, **kw)


def _run(setup, out_dir, **kw):
    pipe, frozen, cn0, dataset = setup
    cfg_kw = {k: kw.pop(k) for k in list(kw) if k in TrainerConfig.__dataclass_fields__}
    return train(_cfg(out_dir, **cfg_kw), pipe.dit_cfg, pipe.t5_cfg, pipe.vae_cfg, pipe.cn_cfg,
                 frozen, cn0, dataset, pipe.tokenizer, device="cpu", **kw)


def test_train_save_resume_continues_from_checkpoint(setup, tmp_path):
    cn0 = setup[2]
    before = {n: p.clone() for n, p in cn0.state_dict().items()}
    history = []
    state = _run(setup, tmp_path, max_steps=2, history=history)
    assert state.step == 2
    assert [h["step"] for h in history] == [1, 2]
    assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0 for h in history)
    assert {"forward_backward", "optimizer", "t5"} <= set(history[0])
    for n, p in cn0.state_dict().items():                  # the caller's ControlNet is kept
        assert torch.equal(p, before[n])
    first = tio.find_latest_checkpoint(str(tmp_path))
    assert first is not None and tio.checkpoint_step(first) == 2
    recs = [json.loads(ln) for ln in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in recs] == [1, 2] and "loss" in recs[0]
    trained = {n: p.clone() for n, p in state.params.state_dict().items()}

    # resume from step-2 alone (the full state removed): reloads the ControlNet, counts on
    os.remove(tio.train_state_path(str(tmp_path), 2))
    state2 = _run(setup, tmp_path, resume=True, max_steps=1)
    assert state2.step == 3
    assert any(tio.checkpoint_step(p) == 3 for p in glob.glob(str(tmp_path / "step-*")))
    back = tio.load_goalforce_controlnet(first)
    for n, p in trained.items():
        torch.testing.assert_close(back[n], p, rtol=0, atol=0)


def test_full_state_resume_is_bit_identical(setup, tmp_path):
    state_a = _run(setup, tmp_path / "uninterrupted", max_steps=4)
    _run(setup, tmp_path / "resumed", max_steps=2)
    assert os.path.exists(tio.train_state_path(str(tmp_path / "resumed"), 2))
    state_b = _run(setup, tmp_path / "resumed", resume=True, max_steps=2)
    assert state_a.step == state_b.step == 4
    for (n, a), b in zip(state_a.params.state_dict().items(),
                         state_b.params.state_dict().values()):
        assert torch.equal(a, b), n
    assert state_a.opt_state.keys() == state_b.opt_state.keys()
    for n, a in state_a.opt_state.items():
        assert torch.equal(a, state_b.opt_state[n]), n


def test_train_state_roundtrip_and_mismatch_guard(setup, tmp_path):
    cn = copy.deepcopy(setup[2]).requires_grad_(True)
    opt = tts.make_optimizer(1e-3)
    params = tts.trainable_params(cn)
    state = tts.TrainState(cn, opt.init(params), 7)
    for i, t in enumerate(state.opt_state.values()):
        t.fill_(i)
    path = str(tmp_path / "state-7.safetensors")
    tio.save_train_state(state, path)
    fresh = tts.TrainState(cn, opt.init(params), 0)
    tio.load_train_state(path, fresh)
    assert fresh.step == 7
    for n, t in state.opt_state.items():
        assert torch.equal(t, fresh.opt_state[n]), n
    accum = tts.make_optimizer(1e-3, grad_accum_steps=2)
    with pytest.raises(KeyError):
        tio.load_train_state(path, tts.TrainState(cn, accum.init(params), 0))
    bf16 = tts.TrainState(cn, {k: v.to(torch.bfloat16) if v.is_floating_point() else v
                               for k, v in opt.init(params).items()}, 0)
    with pytest.raises(ValueError):
        tio.load_train_state(path, bf16)


def test_state_checkpoints_are_pruned(setup, tmp_path):
    _run(setup, tmp_path, max_steps=4, save_steps=1, keep_last_states=2)
    states = sorted(glob.glob(str(tmp_path / "state-*.safetensors")))
    steps = glob.glob(str(tmp_path / "step-*.safetensors"))
    assert [os.path.basename(p) for p in states] == ["state-3.safetensors",
                                                     "state-4.safetensors"]
    assert len(steps) == 4


def test_step_checkpoint_loads_through_jax_and_equals_jax_export(setup, tmp_path):
    """The port's step-K file is the reference format the JAX package reads and writes."""
    cn = setup[2]
    path = str(tmp_path / "step-1.safetensors")
    tio.save_safetensors(tio.export_goalforce_controlnet(cn), path)
    _, _, _, cn_cfg = jcfg.tiny_pipeline_configs()
    jparams = jio.load_goalforce_controlnet(path, cn_cfg)
    ref = jio.export_goalforce_controlnet(jax.tree_util.tree_map(np.asarray, jparams), cn_cfg)
    got = load_file(path)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], ref[k])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int64, torch.int32])
def test_safetensors_io_agrees_with_the_safetensors_package(tmp_path, dtype):
    import safetensors.torch as st

    g = torch.Generator().manual_seed(0)
    tensors = {"a.weight": (torch.randn((3, 5), generator=g) * 100).to(dtype),
               "b": torch.tensor(7).to(dtype), "c": torch.zeros((0, 4), dtype=dtype)}
    mine, theirs = str(tmp_path / "mine.safetensors"), str(tmp_path / "theirs.safetensors")
    tio.save_safetensors(tensors, mine)
    st.save_file(tensors, theirs)
    for path in (mine, theirs):
        for reader in (tio.load_safetensors, st.load_file):
            back = reader(path)
            assert back.keys() == tensors.keys()
            for k, t in tensors.items():
                assert back[k].dtype == dtype and torch.equal(back[k], t), (path, k)


def test_safetensors_io_refuses_other_dtypes(tmp_path):
    with pytest.raises(ValueError):
        tio.save_safetensors({"x": torch.zeros(2, dtype=torch.float16)}, str(tmp_path / "x"))
    save_file({"x": np.zeros(2, np.float16)}, str(tmp_path / "y"))
    with pytest.raises(ValueError):
        tio.load_safetensors(str(tmp_path / "y"))


@pytest.mark.parametrize("sample", [
    None, {"video": 0}, {"control_video": np.zeros((5, 32, 32, 3))},
    {"control_video": np.zeros((5, 32, 30, 3))}, {"control_video": np.zeros((4, 32, 32, 3))}])
def test_should_skip_matches_jax(sample):
    assert should_skip(sample, 5, 32, 32) == jax_should_skip(sample, 5, 32, 32)


def test_step_generators_differ_by_seed_and_step():
    draw = lambda seed, step: torch.randn(4, generator=step_generator(seed, step, "cpu"))
    assert torch.equal(draw(0, 1), draw(0, 1))
    assert not torch.equal(draw(0, 1), draw(0, 2))
    assert not torch.equal(draw(0, 1), draw(1, 1))


def test_metrics_logger_writes_every_nth_step(tmp_path):
    log = MetricsLogger(str(tmp_path), log_every=2)
    for s in range(1, 5):
        log.log(s, {"loss": torch.tensor(0.5 * s)})
    recs = [json.loads(ln) for ln in open(tmp_path / "metrics.jsonl")]
    assert recs == [{"step": 2, "loss": 1.0}, {"step": 4, "loss": 2.0}]


def test_trainer_needs_cuda_unless_cpu_is_asked(setup, tmp_path):
    pipe, frozen, cn0, dataset = setup
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        train(_cfg(tmp_path), pipe.dit_cfg, pipe.t5_cfg, pipe.vae_cfg, pipe.cn_cfg, frozen,
              cn0, dataset, pipe.tokenizer, max_steps=1)
    with pytest.raises(NotImplementedError):
        _run(setup, tmp_path, pp_microbatches=2)
