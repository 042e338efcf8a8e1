"""The port stands alone: it imports without JAX, never imports goal_force_tpu, keeps
config values equal to the JAX copy, and its entry points refuse to run without CUDA
unless the CPU is asked for."""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import goal_force_tpu.configs as jcfg
import goal_force_tpu_torch
import goal_force_tpu_torch.configs as tcfg

PKG = Path(goal_force_tpu_torch.__file__).resolve().parent
REPO = PKG.parent
MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
    for p in PKG.rglob("*.py"))


# Packages the card's machine may lack: the port imports each only inside the function
# that needs it, so importing any module of the port must not need them.
BLOCKED = ("jax", "pandas", "PIL", "cv2", "imageio", "tqdm", "safetensors", "transformers",
           "tokenizers")


def test_every_module_imports_with_jax_blocked():
    code = ("import sys, importlib\n"
            f"for b in {BLOCKED!r}:\n"
            "    sys.modules[b] = None\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'goal_force_tpu' or k.startswith('goal_force_tpu.')\n"
            "               for k in sys.modules), 'goal_force_tpu was imported'\n"
            "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_training_modules_are_in_the_blocked_import():
    for m in ("goal_force_tpu_torch.training", "goal_force_tpu_torch.training.train_step",
              "goal_force_tpu_torch.training.trainer", "goal_force_tpu_torch.io.safetensors_io",
              "goal_force_tpu_torch.data.datasets"):
        assert m in MODULES


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")), ids=lambda p: p.name)
def test_no_jax_or_reference_package_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "goal_force_tpu", "flax"), f"{path}: {name}"


def test_checkpoint_cli_and_staging_modules_are_in_the_blocked_import():
    for m in ("goal_force_tpu_torch.models.spm", "goal_force_tpu_torch.prompters",
              "goal_force_tpu_torch.models.tokenizer", "goal_force_tpu_torch.parallel.host_staging",
              "goal_force_tpu_torch.data.video_io", "goal_force_tpu_torch.data.viz",
              "goal_force_tpu_torch.data.datasets", "goal_force_tpu_torch.scripts.infer"):
        assert m in MODULES


def test_teacache_lora_and_training_cli_modules_are_in_the_blocked_import():
    for m in ("goal_force_tpu_torch.pipelines.teacache", "goal_force_tpu_torch.lora",
              "goal_force_tpu_torch.scripts.train", "goal_force_tpu_torch.pipelines.model_fn",
              "goal_force_tpu_torch.io.from_jax"):
        assert m in MODULES


def test_variant_modules_are_in_the_blocked_import():
    for m in ("goal_force_tpu_torch.native", "goal_force_tpu_torch.models.adapters",
              "goal_force_tpu_torch.models.camera_controller"):
        assert m in MODULES
    assert (PKG / "native" / "control_render.cpp").is_file()


def test_low_precision_modules_are_in_the_blocked_import():
    for m in ("goal_force_tpu_torch.ops.quant", "goal_force_tpu_torch.ops.flash_attention",
              "goal_force_tpu_torch.ops.attention"):
        assert m in MODULES
    assert (PKG / "csrc" / "flash_attention_int8.cu").is_file()


def test_speech_to_video_image_and_vae38_modules_are_in_the_blocked_import():
    for m in ("goal_force_tpu_torch.models.s2v", "goal_force_tpu_torch.models.audio",
              "goal_force_tpu_torch.models.image_encoder", "goal_force_tpu_torch.models.vae38",
              "goal_force_tpu_torch.pipelines.s2v"):
        assert m in MODULES


def test_multi_gpu_and_tool_modules_are_in_the_blocked_import():
    for m in ("goal_force_tpu_torch.parallel.mesh", "goal_force_tpu_torch.parallel.collectives",
              "goal_force_tpu_torch.parallel.sharding", "goal_force_tpu_torch.utils.metrics",
              "goal_force_tpu_torch.data.ops", "goal_force_tpu_torch.scripts.demo",
              "goal_force_tpu_torch.scripts.compare_videos",
              "goal_force_tpu_torch.scripts.extract_first_frame",
              "goal_force_tpu_torch.scripts.extract_canny_edges"):
        assert m in MODULES


def test_hunyuan_video_modules_are_in_the_blocked_import():
    for m in ("goal_force_tpu_torch.models.clip_bpe", "goal_force_tpu_torch.models.clip",
              "goal_force_tpu_torch.models.sd_text_encoder",
              "goal_force_tpu_torch.models.text_encoders",
              "goal_force_tpu_torch.models.hunyuan_video_dit",
              "goal_force_tpu_torch.models.hunyuan_video_vae",
              "goal_force_tpu_torch.pipelines.hunyuan_video", "goal_force_tpu_torch.io.detect",
              "goal_force_tpu_torch.io.auto"):
        assert m in MODULES


def test_stepvideo_modules_are_in_the_blocked_import():
    for m in ("goal_force_tpu_torch.models.stepvideo_dit",
              "goal_force_tpu_torch.models.stepvideo_vae",
              "goal_force_tpu_torch.pipelines.step_video",
              "goal_force_tpu_torch.prompters"):
        assert m in MODULES


def test_spawned_children_import_no_jax():
    """The multi-process tests' children (tests/torch_parallel_children.py) import the
    port alone; they also check sys.modules at their end."""
    path = Path(__file__).resolve().parent / "torch_parallel_children.py"
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "goal_force_tpu", "flax"), name


def test_speech_to_video_image_and_vae38_presets_equal_jax():
    from goal_force_tpu.models import image_encoder as jvit
    from goal_force_tpu.models import s2v as js2v
    from goal_force_tpu.models import vae38 as jv38
    from goal_force_tpu_torch.models import image_encoder as tvit
    from goal_force_tpu_torch.models import s2v as ts2v
    from goal_force_tpu_torch.models import vae38 as tv38

    pairs = [(ts2v.WAN22_S2V_14B, js2v.S2VConfig()), (ts2v.tiny_s2v(), js2v.tiny_s2v()),
             (tv38.WAN22_VAE38, jv38.VAE38Config()), (tv38.tiny_vae38(), jv38.tiny_vae38()),
             (tvit.VIT_H_14, jvit.VIT_H_14)]
    for a, b in pairs:
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    from goal_force_tpu.pipelines import s2v as jpipe
    from goal_force_tpu_torch.pipelines import s2v as tpipe

    assert tpipe.MOTION_FRAMES == jpipe.MOTION_FRAMES == 73


@pytest.mark.parametrize("name", ["WAN22_A14B", "WAN21_1_3B", "UMT5_XXL", "WAN21_VAE"])
def test_config_presets_equal_jax(name):
    assert dataclasses.asdict(getattr(tcfg, name)) == dataclasses.asdict(getattr(jcfg, name))


def test_tiny_and_pipeline_configs_equal_jax():
    for a, b in zip(tcfg.tiny_pipeline_configs(), jcfg.tiny_pipeline_configs()):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert dataclasses.asdict(tcfg.PipelineConfig()) == dataclasses.asdict(jcfg.PipelineConfig())
    assert tcfg.VAE_LATENT_MEAN == jcfg.VAE_LATENT_MEAN
    assert tcfg.VAE_LATENT_STD == jcfg.VAE_LATENT_STD


def test_entry_points_need_cuda_unless_cpu_is_asked():
    from goal_force_tpu_torch.pipelines.goal_force import GoalForcePipeline

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        GoalForcePipeline.init_random()
    with pytest.raises(RuntimeError, match="CUDA"):
        GoalForcePipeline.from_state_dicts({}, *tcfg.tiny_pipeline_configs())
    pipe = GoalForcePipeline.init_random(device="cpu")
    assert pipe.device.type == "cpu"
