"""The port's inference CLI and what it reads, against the JAX package (CPU).

BallsDataset samples from a CSV written to tmp_path (image, control video, prompt, spec,
file_id), the training rows' specs with distractors and their calibration, the PNG
reader and writer against JAX load_image, and main() at the tiny preset: it writes the
JAX CLI's five artifacts under the JAX CLI's names, and its video is the port pipeline's
answer to the same sample.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from goal_force_tpu.data import datasets as jds
from goal_force_tpu.data import video_io as jvio

from goal_force_tpu_torch import configs as tcfg
from goal_force_tpu_torch.data import datasets as tds
from goal_force_tpu_torch.data import video_io as tvio
from goal_force_tpu_torch.io import safetensors_io as sio
from goal_force_tpu_torch.pipelines.goal_force import GoalForcePipeline
from goal_force_tpu_torch.scripts import infer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, FRAMES = 32, 48, 9
HEADER = ("image,caption,projectile_force_magnitude,projectile_force_angle,"
          "projectile_coordx,projectile_coordy,width,height,target_indirect_force_magnitude,"
          "target_indirect_force_angle,target_coordx,target_coordy,projectile_mass,"
          "target_mass")
ROWS = [
    'ball.png,"a red ball, rolling",200,30,15,16,48,32,100,90,33,12,2.0,3',
    "grey.png,a grey scene,123.0,45.5,10.0,20,48,32,-1,0,0,0,1,-1",
    "gone.png,no such image,50,0,1,1,48,32,-1,0,0,0,1,1",
    "broken.png,a corrupt file,50,0,1,1,48,32,-1,0,0,0,1,1",
]


@pytest.fixture(scope="module")
def csv_dir(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("examples")
    (d / "images").mkdir()
    rng = np.random.default_rng(0)
    tvio.save_image(rng.uniform(size=(H, W, 3)), str(d / "images" / "ball.png"))
    grey = (rng.uniform(size=(40, 60)) * 255).astype(np.uint8)    # resized to 48x32
    Image.fromarray(grey, "L").save(d / "images" / "grey.png")
    (d / "images" / "broken.png").write_bytes(b"\x89PNG\r\n\x1a\n" + b"\0" * 30)
    (d / "rows.csv").write_text(HEADER + "\n" + "\n".join(ROWS) + "\n")
    return d


def _datasets(csv_dir, seed=0):
    kw = dict(is_validation_dataset=True, num_frames=FRAMES, height=H, width=W)
    out = []
    for mod in (tds, jds):
        ds = mod.BallsDataset(str(csv_dir), str(csv_dir / "rows.csv"),
                              rng=np.random.default_rng(seed), **kw)
        ds.set_calibration(30.0, 400.0, 1.0, 4.0)
        out.append(ds)
    return out


def test_balls_dataset_samples_equal_jax(csv_dir):
    tds_, jds_ = _datasets(csv_dir)
    assert len(tds_) == len(jds_) == 3     # gone.png is not in images/
    for i in range(3):
        got, want = tds_[i], jds_[i]
        if want is None:                   # the corrupt file
            assert got is None
            continue
        np.testing.assert_array_equal(got["video"], want["video"])
        np.testing.assert_array_equal(got["control_video"], want["control_video"])
        assert got["control_video"].shape == (FRAMES, H, W, 3)
        assert got["prompt"] == want["prompt"] and got["file_id"] == want["file_id"]
        assert dataclasses.asdict(got["spec"]) == dataclasses.asdict(want["spec"])
    assert tds_[0]["prompt"] == "a red ball, rolling"
    assert tds_[1]["spec"].projectile_xy_px == (10, 20)   # "10.0" read as pandas reads it


TRAIN_HEADER = ("video,caption,projectile_force_magnitude,projectile_force_angle,"
                "projectile_coordx,projectile_coordy,width,height,"
                "target_indirect_force_magnitude,target_indirect_force_angle,target_coordx,"
                "target_coordy,projectile_mass,target_mass," + ",".join(
                    f"distractor_{i}_mass,distractor_{i}_coordx,distractor_{i}_coordy"
                    for i in range(jds.MAX_NUM_DISTRACTORS)))


def test_training_rows_specs_and_calibration_equal_jax(tmp_path):
    rng = np.random.default_rng(3)
    lines = [TRAIN_HEADER]
    for r in range(4):
        dis = []
        for i in range(jds.MAX_NUM_DISTRACTORS):
            m = -1 if (i + r) % 3 == 0 else round(float(rng.uniform(1, 4)), 2)
            dis += [m, int(rng.integers(0, W)), f"{int(rng.integers(0, H))}.0"]
        tgt = -1 if r == 2 else round(float(rng.uniform(30, 400)), 1)
        lines.append(",".join(map(str, [
            f"clip{r}.mp4", f"clip {r}", round(float(rng.uniform(30, 400)), 1),
            int(rng.integers(0, 360)), int(rng.integers(0, W)), int(rng.integers(0, H)), W, H,
            tgt, 45, 20, 10, round(float(rng.uniform(1, 4)), 2), 2.5, *dis])))
    (tmp_path / "train.csv").write_text("\n".join(lines) + "\n")
    for r in range(4):
        (tmp_path / f"clip{r}.mp4").write_bytes(b"")    # rows whose clip is present
    kw = dict(num_frames=FRAMES, height=H, width=W)
    t = tds.BallsDataset(str(tmp_path), str(tmp_path / "train.csv"), **kw)
    j = jds.BallsDataset(str(tmp_path), str(tmp_path / "train.csv"), **kw)
    assert len(t) == len(j) == 4
    for f in ("min_force", "max_force", "min_mass", "max_mass", "min_indirect_force",
              "max_indirect_force"):
        assert getattr(t, f) == getattr(j, f), f
    for i in range(4):
        got, want = t._spec_from_row(t.df.iloc[i]), j._spec_from_row(j.df.iloc[i])
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert len(got.distractor_masses) > 0
    assert t[0] is None and j[0] is None   # an empty mp4 is a corrupt sample


@pytest.mark.parametrize("case", ["none", "no-control", "wrong-shape", "right-shape"])
def test_should_skip_equals_jax(case):
    video = np.zeros((FRAMES, H, W, 3), np.float32)
    sample = {"none": None, "no-control": {"control_video": None},
              "wrong-shape": {"control_video": video[:, :-1]},
              "right-shape": {"control_video": video}}[case]
    got = tds.should_skip(sample, FRAMES, H, W)
    assert got == jds.should_skip(sample, FRAMES, H, W)
    assert got == (case != "right-shape")


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P"])
@pytest.mark.parametrize("size", [None, (20, 12)], ids=["as-is", "resized"])
def test_png_reader_equals_jax_load_image(tmp_path, mode, size):
    from PIL import Image

    rng = np.random.default_rng(1)
    px = rng.integers(0, 256, size=(21, 33, 4), dtype=np.uint8)
    px[5:9] = px[4]                        # runs that PIL filters with Up and Sub
    img = Image.fromarray(px, "RGBA")
    img = img.convert(mode) if mode != "P" else img.convert("RGB").quantize(64)
    path = str(tmp_path / f"{mode}.png")
    img.save(path)
    got = tvio.load_image(path, size=size)
    want = jvio.load_image(path, size=size)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_png_writer_round_trips_through_jax_reader(tmp_path):
    rng = np.random.default_rng(2)
    px = rng.integers(0, 256, size=(17, 29, 3), dtype=np.uint8)
    tvio.save_image(px, str(tmp_path / "x.png"))
    for reader in (jvio.load_image, tvio.load_image):
        np.testing.assert_array_equal(reader(str(tmp_path / "x.png")), px / np.float32(255))


def test_video_roundtrip_matches_jax_reader(tmp_path):
    pytest.importorskip("cv2")
    frames = np.random.default_rng(4).uniform(size=(5, H, W, 3)).astype(np.float32)
    tvio.save_video(frames, str(tmp_path / "v.mp4"), fps=5)
    got = tvio.load_video(str(tmp_path / "v.mp4"))
    np.testing.assert_array_equal(got, jvio.load_video(str(tmp_path / "v.mp4")))
    assert got.shape == frames.shape


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny_weights")
    dit_cfg, t5_cfg, vae_cfg, cn_cfg = tcfg.tiny_pipeline_configs()
    src = GoalForcePipeline.init_random(seed=4, dit_cfg=dit_cfg, t5_cfg=t5_cfg,
                                        vae_cfg=vae_cfg, cn_cfg=cn_cfg, device="cpu")
    sio.save_safetensors(src.models["dit"].state_dict(), str(d / "high.safetensors"))
    sio.save_safetensors(src.models["dit2"].state_dict(), str(d / "low.safetensors"))
    torch.save(src.models["t5"].state_dict(), d / "t5.pth")
    torch.save(src.models["vae"].state_dict(), d / "vae.pth")
    g = torch.Generator().manual_seed(8)
    ckpt = {sio.CKPT_PREFIX + k: v + 0.05 * torch.randn(v.shape, generator=g)
            for k, v in src.models["controlnet"].state_dict().items()}
    sio.save_safetensors(ckpt, str(d / "ckpt" / "step-7.safetensors"))
    return d


def _argv(weights, csv_paths, out_dir, *extra):
    return ["--high_noise_model", str(weights / "high.safetensors"),
            "--low_noise_model", str(weights / "low.safetensors"),
            "--t5_path", str(weights / "t5.pth"), "--vae_path", str(weights / "vae.pth"),
            "--model_ckpt_path", str(weights / "ckpt" / "step-7.safetensors"),
            "--example_paths", *csv_paths, "--output_dir", str(out_dir),
            "--num_frames", str(FRAMES), "--height", str(H), "--width", str(W),
            "--num_inference_steps", "2", "--controlnet_num_layers", "1",
            "--config_preset", "tiny", "--seed", "5", *extra]


def test_main_writes_the_jax_clis_artifacts(weights, csv_dir, tmp_path, monkeypatch):
    pytest.importorskip("cv2")
    argv = _argv(weights, [str(csv_dir / "rows.csv")], tmp_path / "port")
    answered = []                           # the frames main() answers, row by row
    answer_row = infer.answer_row
    monkeypatch.setattr(infer, "answer_row", lambda *a, **k: answered.append(
        answer_row(*a, **k)) or answered[-1])
    bases = infer.main(argv + ["--device", "cpu"])
    assert len(bases) == 2                  # ball.png and grey.png
    # the JAX CLI on the same files writes the same names
    monkeypatch.syspath_prepend(REPO)
    jax_argv = _argv(weights, [str(csv_dir / "rows.csv")], tmp_path / "jax")
    monkeypatch.setattr(sys, "argv", ["infer.py"] + jax_argv)
    from scripts import infer as jinfer

    jinfer.main()
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert len(names) == 10 and all(
        any(n.endswith(s) for s in infer.ARTIFACTS) for n in names)
    # the written video is the pipeline's own answer to the same sample: the same
    # writer on those frames writes a file that decodes to the same frames
    args = infer.parse_args(argv + ["--device", "cpu"])
    pipe = infer.load_pipeline(args)
    assert len(answered) == len(bases)
    for base, frames, sample in zip(bases, answered, infer.row_samples(
            str(csv_dir / "rows.csv"), args, pipe.pipe_cfg)):
        assert os.path.basename(base).startswith(f"step-7_{sample['file_id']}__prj_force_")
        want = pipe(sample["prompt"], sample["video"][0],
                    control_signal_video=sample["control_video"], seed=5)
        assert frames.shape == (FRAMES, H, W, 3)
        np.testing.assert_array_equal(frames, want)
        tvio.save_video(want, str(tmp_path / "want.mp4"), fps=15, quality=5)
        np.testing.assert_array_equal(tvio.load_video(base + ".mp4"),
                                      tvio.load_video(str(tmp_path / "want.mp4")))
        png = tvio.load_image(base + "-image_condition.png")
        want_png = (sample["video"][0] * 255).astype(np.uint8) / np.float32(255)
        np.testing.assert_array_equal(png, want_png)
        assert tvio.load_video(base + "-control-signal.mp4").shape == (FRAMES, H, W, 3)


def test_sharding_takes_this_process_csvs(weights, csv_dir, tmp_path):
    other = tmp_path / "other.csv"
    other.write_text(HEADER + "\n" + ROWS[0].replace("ball.png", "gone.png") + "\n")
    argv = _argv(weights, [str(other), str(csv_dir / "rows.csv")], tmp_path / "out",
                 "--world_size", "2", "--device_id", "0", "--device", "cpu")
    assert infer.split_contiguous([1, 2, 3], 2, 1) == [3]
    assert infer.main(argv) == []           # rank 0 takes other.csv, whose image is gone


def test_cli_defaults_to_cuda_and_refuses_unported_modes(weights, csv_dir, tmp_path):
    argv = _argv(weights, [str(csv_dir / "rows.csv")], tmp_path / "out")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            infer.main(argv)
        with pytest.raises(RuntimeError, match="CUDA"):
            infer.main(argv + ["--control_signal_type", "canny_edge"])
    assert infer.parse_args(argv).host_stage_experts is None
