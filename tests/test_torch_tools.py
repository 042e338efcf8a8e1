"""The port's goal-force tools and generic dataset against the JAX package's (CPU).

``utils/metrics.py`` to float64 rounding; ``data/ops.py`` (the ``>>`` DSL and
``UnifiedDataset``) on the cases of ``test_datasets.py``, record for record; the
first-frame and Canny-edge extractors bit for bit against the root scripts' functions
on an mp4 that OpenCV writes; ``compare_videos``' report; and the base-model demo's
frames against JAX's demo call on the same tiny weights (``io/from_jax.py``) and
JAX's noise, within the tiny pipeline's tolerance (1e-3).
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from goal_force_tpu import configs as jcfg
from goal_force_tpu.configs import PipelineConfig as JaxPipelineConfig
from goal_force_tpu.data import ops as jops
from goal_force_tpu.models import t5 as jt5
from goal_force_tpu.io.torch_convert import vae_params_from_torch
from goal_force_tpu.models import wan_dit as jdit
from goal_force_tpu.models.tokenizer import load_tokenizer
from goal_force_tpu.pipelines import GoalForcePipeline as JaxPipeline
from goal_force_tpu.utils import metrics as jmetrics

from goal_force_tpu_torch import configs as tcfg
from goal_force_tpu_torch.data import ops as tops
from goal_force_tpu_torch.data import video_io as tvio
from goal_force_tpu_torch.io.from_jax import params_from_jax
from goal_force_tpu_torch.models import vae as tvae_mod
from goal_force_tpu_torch.pipelines.goal_force import GoalForcePipeline
from goal_force_tpu_torch.scripts import compare_videos as tcompare
from goal_force_tpu_torch.scripts import demo as tdemo
from goal_force_tpu_torch.scripts import extract_canny_edges as tcanny
from goal_force_tpu_torch.scripts import extract_first_frame as tfirst
from goal_force_tpu_torch.utils import metrics as tmetrics

ROOT_SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "scripts")


def _root_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(ROOT_SCRIPTS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A 7-frame 40 x 56 mp4 of moving squares over noise (OpenCV's writer)."""
    rng = np.random.default_rng(5)
    frames = rng.uniform(0.0, 0.3, size=(7, 40, 56, 3)).astype(np.float32)
    for i, f in enumerate(frames):
        f[8 + i:20 + i, 10 + 2 * i:30 + 2 * i] = [0.9, 0.2, 0.6]
    path = str(tmp_path_factory.mktemp("clip") / "clip.mp4")
    tvio.save_video(frames, path, fps=15)
    return path


def test_metrics_equal_jax():
    rng = np.random.default_rng(1)
    a = rng.uniform(size=(3, 24, 32, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.05, size=a.shape), 0, 1).astype(np.float32)
    for fn in ("psnr", "ssim"):
        np.testing.assert_allclose(getattr(tmetrics, fn)(a[0], b[0]),
                                   getattr(jmetrics, fn)(a[0], b[0]), rtol=1e-13)
    assert tmetrics.psnr(a, a) == jmetrics.psnr(a, a) == float("inf")
    got, ref = tmetrics.compare_videos(a, b), jmetrics.compare_videos(a, b)
    assert got.keys() == ref.keys() and len(got["per_frame"]) == 3
    for g, r in zip(got["per_frame"], ref["per_frame"]):
        assert g["frame"] == r["frame"]
        np.testing.assert_allclose([g["psnr"], g["ssim"]], [r["psnr"], r["ssim"]], rtol=1e-13)
    for k in ("psnr_mean", "psnr_min", "ssim_mean"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-13)
    with pytest.raises(ValueError, match="shape"):
        tmetrics.compare_videos(a, b[:2])


def _dsl_cases(ops, d):
    """test_datasets.py's DSL cases, run through one package's ops."""
    op = ops.ToAbsolutePath(str(d)) >> ops.LoadImage() >> ops.ImageCropAndResize(32, 48)
    routed = ops.RouteByType([(str, op), (list, ops.SequencialProcess(op))])
    by_ext = ops.RouteByExtensionName([
        (("jpg", "jpeg", "png", "webp"), ops.LoadImage() >> ops.ToList())])
    out = {"compose": op("x.png"), "routed": routed(["x.png", "x.png"]),
           "ext": by_ext(str(d / "y.webp")),
           "free": ops.ImageCropAndResize(max_pixels=900)(ops.LoadImage()(str(d / "x.png"))),
           "gif": ops.LoadGIF(num_frames=6)(str(d / "z.gif")),
           "video": ops.LoadVideo(num_frames=8)(str(d / "z.gif"))}
    with pytest.raises(ValueError):
        by_ext("z.xyz")
    with pytest.raises(TypeError):
        routed(3)
    rows = {}
    for meta in ("m.csv", "m.json", "m.jsonl"):
        ds = ops.UnifiedDataset(base_path=str(d), metadata_path=str(d / meta), repeat=2,
                                data_file_keys=("image",), main_data_operator=op)
        rows[meta] = [ds[i] for i in range(len(ds))]
    return out, rows


def _pixels(x):
    if isinstance(x, list):
        return [_pixels(i) for i in x]
    return np.asarray(x)


def test_data_ops_equal_jax(tmp_path):
    import pandas
    from PIL import Image

    rng = np.random.default_rng(2)
    Image.fromarray(rng.integers(0, 255, (37, 53, 3), dtype=np.uint8)).save(tmp_path / "x.png")
    Image.fromarray(rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)).save(tmp_path / "y.webp")
    gif = [Image.fromarray(rng.integers(0, 255, (12, 20, 3), dtype=np.uint8))
           for _ in range(7)]
    gif[0].save(tmp_path / "z.gif", save_all=True, append_images=gif[1:])
    rows = [{"prompt": "hi", "image": "x.png"}, {"prompt": "bad", "image": "none.png"}]
    pandas.DataFrame(rows).to_csv(tmp_path / "m.csv", index=False)
    (tmp_path / "m.json").write_text(json.dumps(rows))
    (tmp_path / "m.jsonl").write_text("\n".join(json.dumps(r) for r in rows) + "\n")

    got, got_rows = _dsl_cases(tops, tmp_path)
    ref, ref_rows = _dsl_cases(jops, tmp_path)
    assert got["compose"].size == (48, 32) and len(got["gif"]) == 5 and len(got["video"]) == 5
    for k in got:
        g, r = _pixels(got[k]), _pixels(ref[k])
        assert np.array_equal(np.asarray(g), np.asarray(r)), k
    for meta in got_rows:
        assert len(got_rows[meta]) == 4
        for g, r in zip(got_rows[meta], ref_rows[meta]):
            if r is None:
                assert g is None
                continue
            assert g.keys() == r.keys() and g["prompt"] == r["prompt"]
            assert np.array_equal(np.asarray(g["image"]), np.asarray(r["image"]))
    assert len(tops.UnifiedDataset()) == 0


def test_extract_first_frame_equals_jax(clip, tmp_path):
    jax_first = _root_script("extract_first_frame")
    ref = jax_first.extract_first_frame(clip, str(tmp_path / "jax" / "f.png"), 24, 40)
    got = tfirst.extract_first_frame(clip, str(tmp_path / "port" / "f.png"), 24, 40)
    assert got.dtype == np.uint8 and got.shape == (24, 40, 3)
    np.testing.assert_array_equal(got, ref)
    import cv2

    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "port" / "f.png")),
                                  cv2.imread(str(tmp_path / "jax" / "f.png")))
    with pytest.raises(SystemExit):
        tfirst.main(["-i", str(tmp_path / "missing.mp4"), "-o", str(tmp_path / "o.png")])


def test_extract_canny_edges_equals_jax(clip, tmp_path):
    jax_canny = _root_script("extract_canny_edges")
    ref = jax_canny.extract_canny_edges(clip, str(tmp_path / "jax.mp4"), 6, 32, 48, 50, 150)
    tcanny.main(["-i", clip, "-o", str(tmp_path / "port.mp4"), "-n", "6", "--height", "32",
                 "--width", "48", "--low", "50", "--high", "150"])
    got = tcanny.extract_canny_edges(clip, str(tmp_path / "port2.mp4"), 6, 32, 48, 50, 150)
    assert got.shape == (5, 32, 48, 3) and got.dtype == np.float32 and got.max() == 1.0
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(tvio.load_video(str(tmp_path / "port.mp4")),
                                  tvio.load_video(str(tmp_path / "jax.mp4")))


def test_compare_videos_report_equals_jax(clip, tmp_path, monkeypatch, capsys):
    other = str(tmp_path / "other.mp4")
    frames = tvio.load_video(clip)
    tvio.save_video(np.clip(frames[:5] + 0.1, 0, 1), other)
    monkeypatch.setattr(sys, "argv", ["compare_videos.py", clip, other, "--json",
                                      str(tmp_path / "jax.json")])
    _root_script("compare_videos").main()
    report = tcompare.main([clip, other, "--json", str(tmp_path / "port.json")])
    out = capsys.readouterr().out
    assert out.count("frames compared: 5") == 2
    ref = json.loads((tmp_path / "jax.json").read_text())
    assert json.loads((tmp_path / "port.json").read_text()) == ref
    assert report["psnr_mean"] == ref["psnr_mean"]


FRAMES, H, W, STEPS = 5, 32, 48, 2


def test_demo_frames_match_jax(tmp_path):
    """The demo without a ControlNet: JAX's demo call (``pipe(prompt, image,
    controlnet=False, seed=)``) against the port's ``generate`` on the same weights and
    JAX's noise; then the tiny random demo end to end on the CPU, and its refusal
    without a card."""
    dit_cfg, t5_cfg, vae_cfg, _ = jcfg.tiny_pipeline_configs()
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    f32 = jnp.float32
    init = jax.jit(lambda k: dict(dit=jdit.init_wan_dit(k[0], dit_cfg, f32),
                                  dit2=jdit.init_wan_dit(k[1], dit_cfg, f32),
                                  t5=jt5.init_t5(k[2], t5_cfg, f32)))
    params = init(ks)
    # JAX's own tiny VAE init compiles for ~20 s: take the port's draw instead
    tvae = tvae_mod.init_vae(tcfg.tiny_vae(), torch.Generator().manual_seed(0),
                             torch.float32, device="cpu")
    params["vae"] = jax.tree_util.tree_map(jnp.asarray, vae_params_from_torch(
        {k: v.numpy() for k, v in tvae.state_dict().items()}, vae_cfg))
    pc = JaxPipelineConfig(height=H, width=W, num_frames=FRAMES, num_inference_steps=STEPS)
    jpipe = JaxPipeline(dit_cfg, t5_cfg, vae_cfg, None, pc, params,
                        load_tokenizer(None, t5_cfg.vocab, t5_cfg.text_len, quiet=True), f32)
    argv = ["--height", str(H), "--width", str(W), "--num_frames", str(FRAMES),
            "--num_inference_steps", str(STEPS), "--seed", "4", "--device", "cpu",
            "--output", str(tmp_path / "demo.mp4")]
    args = tdemo.parse_args(argv)
    image = tdemo.first_frame(args)
    ref = jpipe(args.prompt, image, controlnet=False, seed=args.seed)

    t_cfgs = tcfg.tiny_pipeline_configs()[:3]
    tpipe = GoalForcePipeline.from_state_dicts(
        params_from_jax(jax.tree_util.tree_map(np.asarray, params)), *t_cfgs, None,
        pipe_cfg=tcfg.PipelineConfig(height=H, width=W, num_frames=FRAMES,
                                     num_inference_steps=STEPS),
        dtype=torch.float32, device="cpu")
    shape = (1, (FRAMES - 1) // 4 + 1, H // 8, W // 8, vae_cfg.z_dim)
    noise = np.array(jax.random.normal(jax.random.PRNGKey(args.seed), shape, f32))
    got = tdemo.generate(tpipe, args, image, noise=torch.from_numpy(noise))
    assert got.shape == (FRAMES, H, W, 3)
    np.testing.assert_allclose(got, ref, atol=1e-3)
    assert tvio.load_video(args.output).shape == (FRAMES, H, W, 3)

    out = tdemo.main(["--tiny_random", *argv[:-1], str(tmp_path / "tiny.mp4")])
    assert out.shape == (FRAMES, H, W, 3) and np.isfinite(out).all()
    assert os.path.getsize(tmp_path / "tiny.mp4") > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tdemo.main(["--tiny_random"])
