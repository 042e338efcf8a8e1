"""The port's GoalForcePipeline.from_pretrained against the JAX package's, on the same
reference-format files (CPU, float32, the tiny configs).

One random tiny state dict in the civitai names is written as the reference ships it:
the high-noise expert as one safetensors file, the low-noise one as two shards (read
through a glob and through a list), umt5 as a .pth under ``model_state``, the VAE as a
.pth under the ``model.`` prefix, and a ``step-K.safetensors`` ControlNet checkpoint with
non-zero zero convs. Both packages load the same files; every parameter is equal, and
the frames are equal within test_torch_pipeline.py's tolerance on JAX's noise.
"""

import glob
import pathlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from goal_force_tpu import configs as jcfg
from goal_force_tpu.pipelines import GoalForcePipeline as JaxPipeline

from goal_force_tpu_torch import configs as tcfg
from goal_force_tpu_torch.data import ControlSpec, render_control_video
from goal_force_tpu_torch.io import safetensors_io as sio
from goal_force_tpu_torch.io.from_jax import params_from_jax
from goal_force_tpu_torch.pipelines.goal_force import GoalForcePipeline

FRAMES, H, W, STEPS = 9, 32, 48, 4


def _split(sd, n):
    keys = sorted(sd)
    return [{k: sd[k] for k in keys[i::n]} for i in range(n)]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Reference-format files of one random tiny pipeline, and its state dicts."""
    d = tmp_path_factory.mktemp("weights")
    dit_cfg, t5_cfg, vae_cfg, cn_cfg = tcfg.tiny_pipeline_configs()
    src = GoalForcePipeline.init_random(seed=3, dit_cfg=dit_cfg, t5_cfg=t5_cfg,
                                        vae_cfg=vae_cfg, cn_cfg=cn_cfg, device="cpu")
    sds = {k: {n: t.clone() for n, t in m.state_dict().items()} for k, m in src.models.items()}
    g = torch.Generator().manual_seed(11)
    ckpt = sds["controlnet"]
    for n in ckpt:   # a trained checkpoint: every tensor moved, zero convs non-zero
        ckpt[n] = ckpt[n] + 0.05 * torch.randn(ckpt[n].shape, generator=g)
    sio.save_safetensors(sds["dit"], str(d / "high.safetensors"))
    for i, shard in enumerate(_split(sds["dit2"], 2)):
        sio.save_safetensors(shard, str(d / f"low-0000{i + 1}-of-00002.safetensors"))
    torch.save({"model_state": sds["t5"]}, d / "umt5.pth")
    torch.save({"model." + k: v for k, v in sds["vae"].items()}, d / "vae.pth")
    sio.save_safetensors({sio.CKPT_PREFIX + k: v for k, v in ckpt.items()},
                         str(d / "step-5.safetensors"))
    paths = dict(high=str(d / "high.safetensors"),
                 low=str(d / "low-*-of-00002.safetensors"), t5=str(d / "umt5.pth"),
                 vae=str(d / "vae.pth"), ckpt=str(d / "step-5.safetensors"))
    return paths, sds


def _load_port(paths, **kw):
    args = dict(low_noise_model=paths["low"], t5_path=paths["t5"], vae_path=paths["vae"],
                controlnet_checkpoint=paths["ckpt"], controlnet_num_layers=1,
                dit_cfg=tcfg.tiny_pipeline_configs()[0], t5_cfg=tcfg.tiny_t5(),
                vae_cfg=tcfg.tiny_vae(), dtype=torch.float32, device="cpu")
    args.update(kw)
    return GoalForcePipeline.from_pretrained(paths["high"], **args)


@pytest.fixture(scope="module")
def pipes(files):
    paths, _ = files
    dit_cfg, t5_cfg, vae_cfg, _ = jcfg.tiny_pipeline_configs()
    with pytest.warns(UserWarning, match="HashTokenizer"):
        jpipe = JaxPipeline.from_pretrained(
            paths["high"], low_noise_model=paths["low"], t5_path=paths["t5"],
            vae_path=paths["vae"], controlnet_checkpoint=paths["ckpt"],
            controlnet_num_layers=1, dit_cfg=dit_cfg, t5_cfg=t5_cfg, vae_cfg=vae_cfg,
            dtype=jnp.float32)
    with pytest.warns(UserWarning, match="HashTokenizer"):
        tpipe = _load_port(paths)
    return jpipe, tpipe


def _jax_state_dicts(jpipe):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jpipe.params))


PATCH = "controlnet_patch_embedding.patch_embedding."


@pytest.mark.parametrize("name", ["dit", "dit2", "t5", "vae", "controlnet", "controlnet2"])
def test_parameters_equal_jax(pipes, files, name):
    """Every tensor equals JAX's, but controlnet2's randomly initialised patch
    embedding, which no checkpoint overlays: its output is multiplied by zero convs."""
    jpipe, tpipe = pipes
    ref = _jax_state_dicts(jpipe)[name]
    got = tpipe.models[name].state_dict()
    assert set(got) == set(ref)
    for k, t in got.items():
        if name == "controlnet2" and k.startswith(PATCH):
            continue
        np.testing.assert_array_equal(t.numpy(), ref[k].numpy(), err_msg=f"{name}.{k}")
    if name in ("dit", "dit2", "t5", "vae"):   # and both equal the files' tensors
        for k, t in got.items():
            assert torch.equal(t, files[1][name][k]), k


def test_zero_convs_and_checkpoint_overlay(pipes, files):
    jpipe, tpipe = pipes
    _, sds = files
    zc = jpipe.params["controlnet2"]["zero_convs"]
    assert not np.asarray(zc["w"]).any() and not np.asarray(zc["b"]).any()
    cn2 = tpipe.models["controlnet2"]
    for m in cn2.controlnet_zero_convs_after:
        assert not m.weight.any() and not m.bias.any()
    for k, t in tpipe.models["controlnet"].state_dict().items():
        assert torch.equal(t, sds["controlnet"][k]), k
    assert tpipe.models["controlnet"].controlnet_zero_convs_after[0].weight.abs().min() > 0
    # both ControlNets start from one patch embedding, as JAX draws both from one key
    with pytest.warns(UserWarning, match="HashTokenizer"):
        fresh = _load_port(files[0], controlnet_checkpoint=None)
    a = fresh.models["controlnet"].controlnet_patch_embedding.state_dict()
    b = fresh.models["controlnet2"].controlnet_patch_embedding.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not fresh.models["controlnet"].controlnet_zero_convs_after[0].weight.any()


def test_frames_match_jax(pipes):
    jpipe, tpipe = pipes
    rng = np.random.default_rng(0)
    image = rng.uniform(size=(H, W, 3)).astype(np.float32)
    spec = ControlSpec(force=200, angle_deg=30, x_pos=0.3, y_pos=0.5, target_force=100,
                       target_angle_deg=90, target_x_pos=0.7, target_y_pos=0.4,
                       projectile_mass=2.0, projectile_xy_px=(15, 16), target_mass=3.0,
                       target_xy_px=(33, 12))
    cv = render_control_video(spec, FRAMES, H, W, min_force=30, max_force=400)
    kw = dict(seed=0, num_frames=FRAMES, num_inference_steps=STEPS)
    ref = jpipe("a ball rolls right", image, control_signal_video=cv, **kw)
    shape = (1, (FRAMES - 1) // 4 + 1, H // 8, W // 8, tpipe.vae_cfg.z_dim)
    noise = np.array(jax.random.normal(jax.random.PRNGKey(0), shape, jnp.float32))
    got = tpipe("a ball rolls right", image, control_signal_video=cv,
                noise=torch.from_numpy(noise), **kw)
    assert got.shape == (FRAMES, H, W, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-3)


def test_host_staged_load_equals_the_resident_load(pipes, files):
    """host_stage_experts=True reads the low-noise pair straight into host memory (on
    the CPU: plain CPU memory) and answers as the resident pipeline does."""
    _, tpipe = pipes
    with pytest.warns(UserWarning, match="HashTokenizer"):
        staged = _load_port(files[0], host_stage_experts=True)
    assert staged._stager is not None
    assert staged._stager.standby["dit"] is staged.models["dit2"]
    for name, mod in tpipe.models.items():
        ref = mod.state_dict()
        for k, t in staged.models[name].state_dict().items():
            assert torch.equal(t, ref[k]), (name, k)
    rng = np.random.default_rng(1)
    image = rng.uniform(size=(H, W, 3)).astype(np.float32)
    cv = rng.uniform(size=(FRAMES, H, W, 3)).astype(np.float32)
    kw = dict(control_signal_video=cv, seed=3, num_frames=FRAMES, num_inference_steps=STEPS)
    np.testing.assert_array_equal(staged("x", image, **kw), tpipe("x", image, **kw))
    assert staged._stager_low


def test_shards_by_glob_and_by_list_read_the_same(files):
    paths, sds = files
    shards = sorted(glob.glob(paths["low"]))
    assert len(shards) == 2
    by_glob, by_list = sio.load_safetensors(paths["low"]), sio.load_safetensors(shards)
    assert set(by_glob) == set(by_list) == set(sds["dit2"])
    for k in by_glob:
        assert torch.equal(by_glob[k], by_list[k]) and torch.equal(by_glob[k], sds["dit2"][k])
    with pytest.warns(UserWarning, match="HashTokenizer"):
        pipe = _load_port(paths, low_noise_model=shards)
    for k, t in pipe.models["dit2"].state_dict().items():
        assert torch.equal(t, sds["dit2"][k]), k


def test_pathlib_paths_read_as_strings_do(files):
    """A pathlib.Path to a .pth goes to the pickle reader, as JAX's str(path) test
    sends it, and a Path to safetensors to the safetensors reader."""
    paths, sds = files
    as_paths = {k: v if "*" in v else pathlib.Path(v) for k, v in paths.items()}
    with pytest.warns(UserWarning, match="HashTokenizer"):
        pipe = _load_port(as_paths)
    for name in ("dit", "t5", "vae"):
        for k, t in pipe.models[name].state_dict().items():
            assert torch.equal(t, sds[name][k]), (name, k)


def test_pth_keeps_dtypes_with_and_without_model_state(tmp_path):
    sd = {"a": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
          "b": torch.tensor([1.5, -2.0]), "c": torch.arange(3)}
    for i, obj in enumerate((sd, {"model_state": sd})):
        torch.save(obj, tmp_path / f"w{i}.pth")
        back = sio.load_torch_pth(str(tmp_path / f"w{i}.pth"))
        assert set(back) == set(sd)
        for k in sd:
            assert back[k].dtype == sd[k].dtype and torch.equal(back[k], sd[k])


def _with(paths, tmp_path, name, sd):
    out = dict(paths)
    out[name] = str(tmp_path / f"{name}.safetensors")
    sio.save_safetensors(sd, out[name])
    return out


@pytest.mark.parametrize("case", ["missing", "unexpected", "shape"])
def test_a_key_that_does_not_fit_raises_naming_it(files, tmp_path, case):
    paths, sds = files
    sd = dict(sds["dit"])
    key = "blocks.1.ffn.2.bias"
    if case == "missing":
        del sd[key]
    elif case == "unexpected":
        key = "blocks.9.ffn.2.bias"
        sd[key] = torch.zeros(3)
    else:
        sd[key] = torch.zeros(sd[key].numel() + 1)
    bad = _with(paths, tmp_path, "high", sd)
    with pytest.raises((KeyError, ValueError), match=key.replace(".", r"\.")):
        _load_port(bad)


def test_checkpoint_and_vae_keys_are_strict(files, tmp_path):
    paths, sds = files
    ckpt = {sio.CKPT_PREFIX + k: v for k, v in sds["controlnet"].items()
            if not k.startswith("controlnet_zero_convs_after.0.")}
    bad = _with(paths, tmp_path, "ckpt", ckpt)
    with pytest.raises(KeyError, match=r"controlnet_zero_convs_after\.0\.bias"):
        _load_port(bad)
    vae = {"model." + k: v for k, v in sds["vae"].items()}
    vae["model.decoder.extra.weight"] = torch.zeros(2)
    with pytest.raises(KeyError, match=r"decoder\.extra\.weight"):
        _load_port(_with(paths, tmp_path, "vae", vae))


def test_missing_files_raise(files, tmp_path):
    paths, _ = files
    for name, missing in (("low", str(tmp_path / "nothing-*.safetensors")),
                          ("t5", str(tmp_path / "absent.pth")),
                          ("high", str(tmp_path / "absent.safetensors"))):
        with pytest.raises(FileNotFoundError):
            _load_port(dict(paths, **{name: missing}))


def test_from_pretrained_needs_cuda_unless_cpu_is_asked(files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    paths, _ = files
    with pytest.raises(RuntimeError, match="CUDA"):
        GoalForcePipeline.from_pretrained(paths["high"], t5_path=paths["t5"],
                                          vae_path=paths["vae"])


def _adapter_files(d, arg):
    """Reference-format files of one adapter drawn at the tiny width, and what a request
    with it adds: (from_pretrained keywords, request keywords)."""
    from goal_force_tpu_torch.models import adapters as adm
    from goal_force_tpu_torch.models import camera_controller as camm

    dit_cfg = tcfg.tiny_pipeline_configs()[0]
    gen = torch.Generator().manual_seed(21)
    rng = np.random.default_rng(22)
    if arg == "controlnet_stride":
        return dict(controlnet_stride=2), dict(control_signal_video=rng.uniform(
            size=(FRAMES, H, W, 3)).astype(np.float32))
    if arg == "vace_path":   # no vace_layers: JAX's default by depth (the 1.3B set, 15)
        vace = adm.init_vace(dit_cfg, gen, adm.VACE_LAYERS_1_3B, 2 * 4 + 64, device="cpu")
        sio.save_safetensors(vace.state_dict(), str(d / "vace.safetensors"))
        mask = (rng.uniform(size=(FRAMES, H, W)) > 0.5).astype(np.float32)
        return (dict(vace_path=str(d / "vace.safetensors")),
                dict(vace_video=rng.uniform(size=(FRAMES, H, W, 3)).astype(np.float32),
                     vace_video_mask=mask, controlnet=False))
    if arg == "motion_controller_path":
        mc = adm.init_motion_controller(gen, dit_cfg.freq_dim, dit_cfg.dim, device="cpu")
        with torch.no_grad():
            mc.linear[4].weight.normal_(generator=gen).mul_(0.05)
        torch.save(mc.state_dict(), d / "motion.pth")
        return dict(motion_controller_path=str(d / "motion.pth")), dict(motion_bucket_id=7)
    cam = camm.init_simple_adapter(dit_cfg.dim, gen, device="cpu")
    sd = cam.state_dict()
    sio.save_safetensors(sd, str(d / "camera.safetensors"))
    # a camera model's file: the adapter under "control_adapter." beside the DiT's keys
    model = {"control_adapter." + k: v for k, v in sd.items()}
    model["blocks.0.modulation"] = torch.zeros(1, 6, dit_cfg.dim)
    sio.save_safetensors(model, str(d / "camera_model.safetensors"))
    return (dict(camera_adapter_path=str(d / "camera.safetensors")),
            dict(camera_control_direction="Right"))


@pytest.mark.parametrize("arg", ["controlnet_stride", "vace_path", "motion_controller_path",
                                 "camera_adapter_path"])
def test_adapter_files_match_jax(files, tmp_path, arg):
    """Each adapter file and controlnet_stride through both packages' from_pretrained on
    the same files: every adapter tensor equal, and the frames of a request that uses it
    equal within 1e-3 on JAX's noise. The camera adapter reads the same from its bare
    file and from a camera model's file."""
    paths, _ = files
    load_kw, req = _adapter_files(tmp_path, arg)
    dit_cfg, t5_cfg, vae_cfg, _ = jcfg.tiny_pipeline_configs()
    with pytest.warns(UserWarning, match="HashTokenizer"):
        jpipe = JaxPipeline.from_pretrained(
            paths["high"], low_noise_model=paths["low"], t5_path=paths["t5"],
            vae_path=paths["vae"], controlnet_checkpoint=paths["ckpt"],
            controlnet_num_layers=1, dit_cfg=dit_cfg, t5_cfg=t5_cfg, vae_cfg=vae_cfg,
            dtype=jnp.float32, **load_kw)
    with pytest.warns(UserWarning, match="HashTokenizer"):
        tpipe = _load_port(paths, **load_kw)
    assert tpipe.vace_layers == jpipe.vace_layers
    ref_sds = _jax_state_dicts(jpipe)
    for name in ("vace", "motion_controller", "camera_adapter", "controlnet"):
        if name in ref_sds:
            got = tpipe.models[name].state_dict()
            assert set(got) == set(ref_sds[name]), name
            for k, t in got.items():
                np.testing.assert_array_equal(t.numpy(), ref_sds[name][k].numpy(), err_msg=k)
    if arg == "controlnet_stride":
        assert tpipe.cn_cfg.stride == jpipe.cn_cfg.stride == 2
        # controlnet2's patch embedding is drawn at random by each package from its own
        # generator, and in strided mode its raw states reach the low-noise expert: give
        # the port JAX's draw
        pe = {k[len(PATCH):]: v for k, v in ref_sds["controlnet2"].items()
              if k.startswith(PATCH)}
        cn2 = tpipe.models["controlnet2"].controlnet_patch_embedding
        cn2.patch_embedding.load_state_dict(pe)
    if arg == "camera_adapter_path":
        with pytest.warns(UserWarning, match="HashTokenizer"):
            other = _load_port(paths,
                               camera_adapter_path=str(tmp_path / "camera_model.safetensors"))
        for k, t in other.models["camera_adapter"].state_dict().items():
            assert torch.equal(t, tpipe.models["camera_adapter"].state_dict()[k]), k
    image = np.random.default_rng(23).uniform(size=(H, W, 3)).astype(np.float32)
    kw = dict(seed=0, num_frames=FRAMES, num_inference_steps=2, **req)
    ref = jpipe("a ball rolls right", image, **kw)
    shape = (1, (FRAMES - 1) // 4 + 1, H // 8, W // 8, tpipe.vae_cfg.z_dim)
    noise = np.array(jax.random.normal(jax.random.PRNGKey(0), shape, jnp.float32))
    got = tpipe("a ball rolls right", image, noise=torch.from_numpy(noise), **kw)
    np.testing.assert_allclose(got, ref, atol=1e-3)
    if arg == "vace_path":   # host staging leaves the adapter resident, for both experts
        with pytest.warns(UserWarning, match="HashTokenizer"):
            staged = _load_port(paths, host_stage_experts=True, **load_kw)
        assert "vace" in staged.models and "vace" not in staged._stager.standby
        np.testing.assert_array_equal(
            staged("a ball rolls right", image, noise=torch.from_numpy(noise), **kw), got)


def test_init_random_reads_a_tokenizer_directory_as_jax(tmp_path, monkeypatch):
    """init_random(tokenizer_path=) tokenizes through the directory's SentencePiece
    model in both packages. JAX's random weights are irrelevant to the ids, so its
    initialisers are stubbed out (its eager tiny VAE init alone takes ~30 s)."""
    import os
    import shutil

    from goal_force_tpu import prompters as jprompters
    from goal_force_tpu.models import controlnet as jcn
    from goal_force_tpu.models import t5 as jt5
    from goal_force_tpu.models import vae as jvae
    from goal_force_tpu.models import wan_dit as jdit

    src = os.path.join(os.path.dirname(jprompters.__file__), "tokenizer_assets",
                       "cog", "tokenizer", "spiece.model")
    d = tmp_path / "umt5_tokenizer"
    d.mkdir()
    shutil.copy(src, d / "spiece.model")
    for mod, name in ((jdit, "init_wan_dit"), (jt5, "init_t5"), (jvae, "init_vae"),
                      (jcn, "init_from_dit")):
        monkeypatch.setattr(mod, name, lambda *a, **k: {})
    jpipe = JaxPipeline.init_random(cn_cfg=None, tokenizer_path=str(d))
    tpipe = GoalForcePipeline.init_random(cn_cfg=None, tokenizer_path=str(d), device="cpu")
    prompts = ["a red ball rolls to the right", "a domino falls onto the next one"]
    ids, mask = tpipe.tokenizer(prompts)
    rids, rmask = jpipe.tokenizer(prompts)
    np.testing.assert_array_equal(ids, rids)
    np.testing.assert_array_equal(mask, rmask)
    hashed, _ = GoalForcePipeline.init_random(cn_cfg=None, device="cpu").tokenizer(prompts)
    assert not np.array_equal(ids, hashed)
