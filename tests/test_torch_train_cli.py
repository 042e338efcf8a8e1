"""The port's training datasets, training CLI and the inference CLI's canny_edge branch,
against the JAX package (CPU, tiny configs).

Clips are mp4s that cv2 writes to tmp_path; the port's and the JAX datasets read the
same files with generators of the same seed, and their samples must be equal (frames,
prompt, spec, file_id and the control video, which both packages render with the same
native renderer). The CLI's functions train LoRA adapters jointly
with the ControlNet at the tiny configs and write a step-K whose keys equal the JAX
package's export for the same shapes.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from goal_force_tpu import configs as jcfg
from goal_force_tpu import lora as jlora
from goal_force_tpu.data import datasets as jds
from goal_force_tpu.io import safetensors_io as jio
from goal_force_tpu.models import controlnet as jcn
from goal_force_tpu.models import wan_dit as jdit

from goal_force_tpu_torch import configs as tcfg
from goal_force_tpu_torch.data import datasets as tds
from goal_force_tpu_torch.data import video_io as tvio
from goal_force_tpu_torch.io import safetensors_io as sio
from goal_force_tpu_torch.pipelines.goal_force import GoalForcePipeline
from goal_force_tpu_torch.scripts import infer
from goal_force_tpu_torch.scripts import train as tcli

cv2 = pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F, H, W = 5, 32, 32          # the trainer's clips: 5 frames of 32 x 32
BALLS_HEADER = ("video,caption,projectile_force_magnitude,projectile_force_angle,"
                "projectile_coordx,projectile_coordy,width,height,"
                "target_indirect_force_magnitude,target_indirect_force_angle,target_coordx,"
                "target_coordy,projectile_mass,target_mass")
PLANTS_HEADER = "video,caption,force,angle,coordx,coordy,width,height"


def _clip(path, n, h, w, seed):
    """An mp4 of n frames: a moving gradient plus noise, written by the port's writer."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = [np.clip(np.stack([(xx + 3 * t) % w / w, yy / h, 0.5 + 0.0 * xx], -1)
                      + 0.1 * rng.uniform(size=(h, w, 3)), 0, 1) for t in range(n)]
    tvio.save_video(np.stack(frames), str(path), fps=15)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Balls (clips at twice the frame rate), Dominos and Plants (a carnation clip at
    240 x 320 whose crop keeps the force point 50 px inside, another plant) training
    sets, and canny-edge clips."""
    d = tmp_path_factory.mktemp("train_data")
    for sub in ("balls", "dominos", "plants", "canny"):
        (d / sub).mkdir()
    rows = []
    for i in range(2):
        _clip(d / "balls" / f"ball{i}.mp4", 2 * F + 1, H, W, i)
        rows.append(f"ball{i}.mp4,a ball {i} rolls,{150 + 50 * i},{30 * i},{10 + i},{12},"
                    f"{W},{H},{80 + 60 * i},45,20,8,{1.5 + i},2.0")
    rows.append("missing.mp4,gone,100,0,1,1,32,32,-1,0,0,0,1,1")     # filtered out
    (d / "balls" / "train.csv").write_text(BALLS_HEADER + "\n" + "\n".join(rows) + "\n")
    _clip(d / "dominos" / "domino0.mp4", F + 2, H, W, 5)
    _clip(d / "dominos" / "domino1.mp4", F, H, W, 10)
    (d / "dominos" / "train.csv").write_text(
        BALLS_HEADER + "\ndomino0.mp4,dominoes fall,220,90,16,16,32,32,60,10,8,8,2,2\n"
        "domino1.mp4,a domino tips,120,270,8,20,32,32,130,200,24,4,1,2\n")
    _clip(d / "plants" / "carnation_0.mp4", F, 240, 320, 6)
    _clip(d / "plants" / "ivy_0.mp4", F, H, W, 7)
    (d / "plants" / "train.csv").write_text(
        PLANTS_HEADER + "\ncarnation_0.mp4,a carnation sways,40,100,160,120,320,240\n"
        "ivy_0.mp4,ivy sways,80,200,16,10,32,32\n")
    _clip(d / "canny" / "a.mp4", F + 1, 40, 60, 8)
    _clip(d / "canny" / "b.mp4", F, 32, 32, 9)
    (d / "canny" / "empty.mp4").write_bytes(b"")                       # unreadable
    return d


def _pair(kind, data, seed):
    """The port's and the JAX dataset of one kind over the same files and seed."""
    shape = dict(num_frames=F, height=H, width=W)
    masks = dict(p_mask_out_direct_force=0.3, p_mask_out_indirect_force=0.3,
                 p_mask_out_masses=0.5)
    out = []
    for mod in (tds, jds):
        rng = np.random.default_rng(seed)
        if kind == "canny":
            paths = [str(data / "canny" / n) for n in ("a.mp4", "b.mp4", "empty.mp4")]
            out.append(mod.CannyEdgeDataset(paths, ["edges a", "edges b", "none"], **shape))
        elif kind == "plants":
            out.append(mod.PlantsDataset(str(data / "plants"), str(data / "plants" / "train.csv"),
                                         rng=rng, **shape))
        else:
            cls = {"balls": mod.BallsDataset, "dominos": mod.DominosDataset}[kind]
            out.append(cls(str(data / kind), str(data / kind / "train.csv"), rng=rng,
                           **masks, **shape))
    return out


@pytest.mark.parametrize("kind", ["balls", "dominos", "plants", "canny"])
def test_training_samples_equal_jax(data, kind):
    t, j = _pair(kind, data, seed=3)
    assert len(t) == len(j) > 0
    for rep in range(2):                     # the generators advance alike
        for i in range(len(t)):
            got, want = t[i], j[i]
            if want is None:
                assert got is None
                continue
            assert got.keys() == want.keys()
            assert got["video"].shape == want["video"].shape == (F, H, W, 3)
            assert got["video"].dtype == np.float32
            np.testing.assert_array_equal(got["video"], want["video"])
            np.testing.assert_array_equal(got["control_video"], want["control_video"])
            assert got["prompt"] == want["prompt"] and got["file_id"] == want["file_id"]
            if "spec" in want:
                assert dataclasses.asdict(got["spec"]) == dataclasses.asdict(want["spec"])
    if kind == "canny":
        assert t[2] is None                       # the empty clip
        assert set(np.unique(t[0]["control_video"])) <= {0.0, 1.0}


def test_carnation_crop_keeps_the_point_inside(data):
    t, j = _pair("plants", data, seed=11)
    frames = tvio.load_video(str(data / "plants" / "carnation_0.mp4"))
    got = t._carnation_crop(frames, 160.0, 120.0)
    want = j._carnation_crop(frames, 160.0, 120.0)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    assert got[0].shape == (F, H, W, 3) and 0 < got[1] < 1 and 0 < got[2] < 1


def test_concat_collate_and_batches_equal_jax(data):
    t = tds.ConcatDataset(_pair("balls", data, 0)[:1] + _pair("dominos", data, 0)[:1])
    j = jds.ConcatDataset(_pair("balls", data, 0)[1:] + _pair("dominos", data, 0)[1:])
    assert len(t) == len(j) == 4
    assert t[2]["file_id"] == j[2]["file_id"] == "domino0"
    with pytest.raises(IndexError):
        t[4]
    assert tds.safe_collate([None, t[1], t[0]])["file_id"] == "ball1"
    assert tds.safe_collate([None]) is jds.safe_collate([None]) is None
    ids = lambda it: [[s["file_id"] for s in b] for b in it]
    for kw in (dict(batch_size=2, seed=4), dict(batch_size=2, seed=4, drop_remainder=False),
               dict(batch_size=1, shuffle=False)):
        assert ids(tds.batch_iterator(t, **kw)) == ids(jds.batch_iterator(j, **kw))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Tiny reference-format weight files: two experts (safetensors), umt5 and the VAE
    (.pth, the VAE under "model.")."""
    d = tmp_path_factory.mktemp("tiny_weights")
    dit_cfg, t5_cfg, vae_cfg, cn_cfg = tcfg.tiny_pipeline_configs()
    src = GoalForcePipeline.init_random(seed=4, dit_cfg=dit_cfg, t5_cfg=t5_cfg,
                                        vae_cfg=vae_cfg, cn_cfg=cn_cfg, device="cpu")
    sio.save_safetensors(src.models["dit"].state_dict(), str(d / "high.safetensors"))
    sio.save_safetensors(src.models["dit2"].state_dict(), str(d / "low.safetensors"))
    torch.save(src.models["t5"].state_dict(), d / "t5.pth")
    torch.save({"model." + k: v for k, v in src.models["vae"].state_dict().items()},
               d / "vae.pth")
    return d


def _train_argv(weights, data, out, *extra):
    return ["--high_noise_model", str(weights / "high.safetensors"),
            "--t5_path", str(weights / "t5.pth"), "--vae_path", str(weights / "vae.pth"),
            "--balls_base_path", str(data / "balls"),
            "--balls_metadata_path", str(data / "balls" / "train.csv"),
            "--dominos_base_path", str(data / "dominos"),
            "--dominos_metadata_path", str(data / "dominos" / "train.csv"),
            "--plants_base_path", str(data / "plants"),
            "--plants_metadata_path", str(data / "plants" / "train.csv"),
            "--num_frames", str(F), "--height", str(H), "--width", str(W),
            "--controlnet_num_layers", "1", "--output_path", str(out), *extra]


def test_train_cli_writes_jax_keys(weights, data, tmp_path):
    """--train_lora with the ControlNet for 2 steps: step-2 holds the PEFT keys and the
    ControlNet's keys that JAX lora_to_peft and export_goalforce_controlnet write for the
    same shapes; the frozen expert is the file's, unchanged."""
    args = tcli.parse_args(_train_argv(weights, data, tmp_path / "run", "--train_lora",
                                       "--lora_rank", "4", "--save_steps", "2",
                                       "--max_steps", "2", "--device", "cpu"))
    dit_cfg, t5_cfg, vae_cfg, _ = tcfg.tiny_pipeline_configs()
    models = tcli.load_models(args, dtype=torch.float32, dit_cfg=dit_cfg, t5_cfg=t5_cfg,
                              vae_cfg=vae_cfg)
    dataset = tcli.build_datasets(args, seed=0)
    assert len(dataset) == 6                         # 2 balls, 2 dominos, 2 plants
    history = []
    state = tcli.run(args, models, dataset, history=history)
    assert state.step == 2 and [h["step"] for h in history] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in history)
    high = sio.load_safetensors(str(weights / "high.safetensors"))
    for k, v in models["frozen"]["dit"].state_dict().items():
        assert torch.equal(v, high[k]), k
    got = set(sio.load_safetensors(str(tmp_path / "run" / "step-2.safetensors")))

    jd, _, _, jcn_cfg = jcfg.tiny_pipeline_configs()
    jdit_p = jax.eval_shape(lambda: jdit.init_wan_dit(jax.random.PRNGKey(0), jd, jnp.float32))
    jdit_p = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), jdit_p)
    jcn_cfg = dataclasses.replace(jcn_cfg, num_layers=1)
    want = set(jlora.lora_to_peft(jlora.init_lora(jax.random.PRNGKey(1), jdit_p, rank=4)))
    cn = jcn.init_from_dit(jax.random.PRNGKey(2), jdit_p, jd, jcn_cfg, jnp.float32)
    want |= set(jio.export_goalforce_controlnet(jax.tree_util.tree_map(np.asarray, cn),
                                                jcn_cfg, dit_patch=jd.patch_size))
    assert got == want


def test_train_cli_refuses_what_is_not_ported(weights, data, tmp_path):
    argv = _train_argv(weights, data, tmp_path / "x")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tcli.main(argv)
    # --dp and --pp are ported: without a launcher's world of 2 they raise make_mesh's
    # error
    for axis in ("--dp", "--pp"):
        with pytest.raises(ValueError, match="need 2 devices, have 1"):
            tcli.main(argv + ["--device", "cpu", axis, "2"])
    with pytest.raises(ValueError, match="no datasets"):
        tcli.build_datasets(tcli.parse_args(argv[:6] + ["--device", "cpu"]))
    assert "does not fit one 80 GB card" in tcli.__doc__


def test_train_cli_trains_a_strided_controlnet(weights, data, tmp_path):
    """--controlnet_stride 2 for one step: the ControlNet copies expert block 0, its
    blocks move, its zero convs (unused in strided mode) stay zero, and step-1 holds the
    keys of JAX's export for the same shapes."""
    args = tcli.parse_args(_train_argv(weights, data, tmp_path / "run", "--controlnet_stride",
                                       "2", "--save_steps", "1", "--max_steps", "1",
                                       "--device", "cpu"))
    dit_cfg, t5_cfg, vae_cfg, _ = tcfg.tiny_pipeline_configs()
    models = tcli.load_models(args, dtype=torch.float32, dit_cfg=dit_cfg, t5_cfg=t5_cfg,
                              vae_cfg=vae_cfg)
    assert models["cn_cfg"].stride == 2
    before = {k: v.clone() for k, v in models["controlnet"].state_dict().items()}
    state = tcli.run(args, models, tcli.build_datasets(args, seed=0))
    assert state.step == 1
    after = state.params.state_dict()
    assert not torch.equal(after["controlnet_dit.blocks.0.ffn.0.weight"],
                           before["controlnet_dit.blocks.0.ffn.0.weight"])
    assert not after["controlnet_zero_convs_after.0.weight"].any()
    got = set(sio.load_safetensors(str(tmp_path / "run" / "step-1.safetensors")))
    jd, _, _, jcn_cfg = jcfg.tiny_pipeline_configs()
    jcn_cfg = dataclasses.replace(jcn_cfg, num_layers=1, stride=2)
    jdit_p = jax.eval_shape(lambda: jdit.init_wan_dit(jax.random.PRNGKey(0), jd, jnp.float32))
    jdit_p = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), jdit_p)
    cn = jcn.init_from_dit(jax.random.PRNGKey(2), jdit_p, jd, jcn_cfg, jnp.float32)
    assert got == set(jio.export_goalforce_controlnet(jax.tree_util.tree_map(np.asarray, cn),
                                                      jcn_cfg, dit_patch=jd.patch_size))


def _infer_argv(weights, csv, out):
    return ["--high_noise_model", str(weights / "high.safetensors"),
            "--low_noise_model", str(weights / "low.safetensors"),
            "--t5_path", str(weights / "t5.pth"), "--vae_path", str(weights / "vae.pth"),
            "--example_paths", str(csv), "--output_dir", str(out), "--num_frames", str(F),
            "--height", str(H), "--width", "48", "--num_inference_steps", "2",
            "--controlnet_num_layers", "1", "--config_preset", "tiny", "--seed", "3",
            "--control_signal_type", "canny_edge"]


def test_canny_edge_cli_writes_the_jax_artifacts(weights, data, tmp_path, monkeypatch):
    d = tmp_path / "examples"
    (d / "images").mkdir(parents=True)
    (d / "canny-videos").mkdir()
    rng = np.random.default_rng(2)
    tvio.save_image(rng.uniform(size=(40, 60, 3)), str(d / "images" / "first.png"))
    _clip(d / "canny-videos" / "scene_canny.mp4", F + 2, 40, 60, 3)
    (d / "rows.csv").write_text("image,control_video,caption\n"
                                "first.png,scene_canny.mp4,edges of a scene\n")
    outs = infer.main(_infer_argv(weights, d / "rows.csv", tmp_path / "port")
                      + ["--device", "cpu"])
    assert [os.path.basename(o) for o in outs] == ["scene-canny-output.mp4"]
    monkeypatch.syspath_prepend(REPO)
    monkeypatch.setattr(sys, "argv", ["infer.py"] + _infer_argv(weights, d / "rows.csv",
                                                                tmp_path / "jax"))
    from scripts import infer as jinfer

    jinfer.main()
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == [
        "scene-canny-control-signal.mp4", "scene-canny-output.mp4",
        "scene-image-condition.png"]
    video = tvio.load_video(outs[0])
    assert video.shape == (F, H, 48, 3)


def _wandb_stub(calls):
    import types

    class Run:
        def log(self, rec, step=None):
            calls.append(("log", rec, step))

    def init(**kw):
        calls.append(("init", kw))
        return Run()

    stub = types.ModuleType("wandb")
    stub.init = init
    return stub


@pytest.mark.parametrize("installed", [True, False], ids=["wandb", "no_wandb"])
def test_metrics_logger_with_use_wandb_equals_jax(tmp_path, monkeypatch, capsys, installed):
    """With a (stub) wandb module, ``init`` gets JAX's arguments and every logged record
    reaches wandb and the JSONL file; without one, both loggers say so and write JSONL
    only. The CLI hands --use_wandb/--wandb_project/--run_name to the trainer's config."""
    from goal_force_tpu.training.trainer import MetricsLogger as JaxLogger

    from goal_force_tpu_torch.training import trainer as ttrainer

    calls = {"jax": [], "port": []}
    args = dict(log_every=2, use_wandb=True, project="goal_force_tpu", run_name="r1",
                config={"lr": 1e-5, "seed": 0})
    for which, cls in (("jax", JaxLogger), ("port", ttrainer.MetricsLogger)):
        if installed:
            monkeypatch.setitem(sys.modules, "wandb", _wandb_stub(calls[which]))
        else:
            monkeypatch.setitem(sys.modules, "wandb", None)   # import raises ImportError
        logger = cls(str(tmp_path / which), **args)
        for step in (1, 2, 3, 4):
            logger.log(step, {"loss": 0.5 / step, "grad_norm": np.float32(2.0)})
    assert calls["port"] == calls["jax"]
    if installed:
        assert calls["port"][0] == ("init", {"project": "goal_force_tpu", "name": "r1",
                                             "config": args["config"]})
        assert [c[2] for c in calls["port"][1:]] == [2, 4]
    else:
        assert calls["port"] == []
        assert capsys.readouterr().out.count("wandb not installed") == 2
    jsonl = [open(tmp_path / w / "metrics.jsonl").read() for w in ("jax", "port")]
    assert jsonl[0] == jsonl[1] and jsonl[1].count("\n") == 2
    if installed:
        import json

        assert [c[1] for c in calls["port"][1:]] == [json.loads(line) for line in
                                                     jsonl[1].splitlines()]

    seen = {}
    monkeypatch.setattr(ttrainer, "train", lambda cfg, *a, **k: seen.setdefault("cfg", cfg))
    cli = tcli.parse_args(["--high_noise_model", "h", "--t5_path", "t", "--vae_path", "v",
                           "--use_wandb", "--wandb_project", "proj", "--run_name", "r2"])
    tcli.run(cli, dict.fromkeys(("dit_cfg", "t5_cfg", "vae_cfg", "cn_cfg", "frozen",
                                 "controlnet", "tokenizer")), None)
    cfg = seen["cfg"]
    assert (cfg.use_wandb, cfg.wandb_project, cfg.run_name) == (True, "proj", "r2")
