"""The port's goal-force pipeline against the JAX pipeline at the tiny configs (CPU, f32).

The port is built from the JAX pipeline's own weights (io/from_jax.py) and given the
exact noise JAX draws, so both run the same function on the same inputs. Four steps
cross the expert switch (t = 1000, 937.5 | 833.3, 625). The same holds with W8A8 packs in
the four DiT/ControlNet models, within a bound derived from one activation code step.
"""

import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from goal_force_tpu import configs as jcfg
from goal_force_tpu.configs import PipelineConfig
from goal_force_tpu.data import ControlSpec, render_control_video
from goal_force_tpu.models import controlnet as jcn
from goal_force_tpu.models import t5 as jt5
from goal_force_tpu.models import vae as jvae
from goal_force_tpu.models import wan_dit as jdit
from goal_force_tpu.models.tokenizer import load_tokenizer
from goal_force_tpu.ops.quant import quantize_linear_tree
from goal_force_tpu.pipelines import GoalForcePipeline as JaxPipeline

from goal_force_tpu_torch import configs as tcfg
from goal_force_tpu_torch.io.from_jax import params_from_jax
from goal_force_tpu_torch.ops.quant import Int8Linear, quantize_linear_modules
from goal_force_tpu_torch.pipelines.goal_force import GoalForcePipeline

FRAMES, H, W, STEPS = 9, 32, 48, 4
QPATHS = ("self_attn", "cross_attn", "ffn")


@pytest.fixture(scope="module")
def pipes():
    dit_cfg, t5_cfg, vae_cfg, cn_cfg = jcfg.tiny_pipeline_configs()
    # the JAX package's own random init, jitted (eager, the VAE init alone takes ~30 s)
    ks = jax.random.split(jax.random.PRNGKey(0), 6)
    f32 = jnp.float32
    init = jax.jit(lambda k: dict(dit=jdit.init_wan_dit(k[0], dit_cfg, f32),
                                  dit2=jdit.init_wan_dit(k[1], dit_cfg, f32),
                                  t5=jt5.init_t5(k[2], t5_cfg, f32),
                                  vae=jvae.init_vae(k[3], vae_cfg, f32)))
    params = init(ks)
    for name, dit, k in (("controlnet", "dit", ks[4]), ("controlnet2", "dit2", ks[5])):
        params[name] = jcn.init_from_dit(k, params[dit], dit_cfg, cn_cfg, f32)
    jpipe = JaxPipeline(dit_cfg, t5_cfg, vae_cfg, cn_cfg, PipelineConfig(), params,
                        load_tokenizer(None, t5_cfg.vocab, t5_cfg.text_len, quiet=True), f32)
    # non-zero zero convs, so the ControlNet changes the result
    rng = np.random.default_rng(4)
    for name in ("controlnet", "controlnet2"):
        zc = jpipe.params[name]["zero_convs"]
        zc["w"] = jnp.asarray(rng.normal(size=zc["w"].shape).astype(np.float32) * 0.05)
        zc["b"] = jnp.asarray(rng.normal(size=zc["b"].shape).astype(np.float32) * 0.05)
    tree = jax.tree_util.tree_map(np.asarray, jpipe.params)
    t_cfgs = tcfg.tiny_pipeline_configs()
    tpipe = GoalForcePipeline.from_state_dicts(params_from_jax(tree), *t_cfgs,
                                               dtype=torch.float32, device="cpu")
    return jpipe, tpipe


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    image = rng.uniform(size=(H, W, 3)).astype(np.float32)
    spec = ControlSpec(
        force=200, angle_deg=30, x_pos=0.3, y_pos=0.5,
        target_force=100, target_angle_deg=90, target_x_pos=0.7, target_y_pos=0.4,
        projectile_mass=2.0, projectile_xy_px=(15, 16),
        target_mass=3.0, target_xy_px=(33, 12),
    )
    cv = render_control_video(spec, FRAMES, H, W, min_force=30, max_force=400, backend="numpy")
    return image, cv


def _jax_noise(seed, z):
    shape = (1, (FRAMES - 1) // 4 + 1, H // 8, W // 8, z)
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))


def test_frames_match_jax_across_expert_switch(pipes, inputs):
    jpipe, tpipe = pipes
    image, cv = inputs
    kw = dict(seed=0, num_frames=FRAMES, num_inference_steps=STEPS)
    ref = jpipe("a ball rolls right", image, control_signal_video=cv, **kw)
    got = tpipe("a ball rolls right", image, control_signal_video=cv,
                noise=torch.from_numpy(_jax_noise(0, tpipe.vae_cfg.z_dim)), **kw)
    assert got.shape == (FRAMES, H, W, 3) and got.dtype == np.float32
    assert 0.0 <= got.min() and got.max() <= 1.0
    np.testing.assert_allclose(got, ref, atol=1e-3)


def test_cfg_one_and_no_controlnet_match_jax(pipes, inputs):
    """The single-branch (cfg_scale 1) path and the path without ControlNet."""
    jpipe, tpipe = pipes
    image, cv = inputs
    noise = torch.from_numpy(_jax_noise(3, tpipe.vae_cfg.z_dim))
    for kw in (dict(cfg_scale=1.0, control_signal_video=cv), dict(controlnet=False)):
        ref = jpipe("x", image, seed=3, num_frames=FRAMES, num_inference_steps=2, **kw)
        got = tpipe("x", image, noise=noise, num_frames=FRAMES, num_inference_steps=2, **kw)
        np.testing.assert_allclose(got, ref, atol=1e-3)


def _quantized_jax_pipe(jpipe):
    q = copy.copy(jpipe)
    q.params = dict(jpipe.params)
    for name in ("dit", "dit2", "controlnet", "controlnet2"):
        q.params[name] = dict(jpipe.params[name],
                              blocks=quantize_linear_tree(jpipe.params[name]["blocks"], QPATHS))
    return q


def test_w8a8_pipeline_frames_match_jax(pipes, inputs):
    """The pipeline with W8A8 block linears (quantize_linear_tree, paths self_attn,
    cross_attn and ffn) in all four DiT/ControlNet models, against JAX pipe(...) on JAX's
    noise, by two routes that must give the same frames bit for bit: the JAX packs loaded
    through from_state_dicts, and the port's own quantize_linear_modules on the unpacked
    pipeline. Attention is plain on both sides (tiny head_dim 24); the packs-off pipeline
    matches at 1e-3 (above).

    Both sides compute every int8 product exactly, but float32 rounding that differs
    between XLA and torch can put an activation on the other side of a rounding boundary
    of the next linear's per-token quantization: that code moves by one step, which moves
    the linear's output by up to 1/127 of its range (test_torch_lowp.py holds one step to
    that). Every later step starts from latents that differ by that much and flips codes
    of its own: a one-ulp move of the port's own noise moves its frames by up to 1.8e-3,
    and runs of JAX and the port differ by up to 1.1e-2 (8e-4 on average). The frames are
    held to 3e-2, and to 2e-3 on average."""
    jpipe, tpipe = pipes
    image, cv = inputs
    kw = dict(seed=0, num_frames=FRAMES, num_inference_steps=4)
    qj = _quantized_jax_pipe(jpipe)
    ref = qj("a ball rolls right", image, control_signal_video=cv, **kw)
    noise = torch.from_numpy(_jax_noise(0, tpipe.vae_cfg.z_dim))
    loaded = GoalForcePipeline.from_state_dicts(
        params_from_jax(jax.tree_util.tree_map(np.asarray, qj.params)),
        *tcfg.tiny_pipeline_configs(), dtype=torch.float32, device="cpu")
    in_place = copy.deepcopy(tpipe)
    for name in ("dit", "dit2", "controlnet", "controlnet2"):
        quantize_linear_modules(in_place.models[name], QPATHS)
    frames = []
    for pipe in (loaded, in_place):
        assert isinstance(pipe.models["dit2"].blocks[0].cross_attn.v, Int8Linear)
        assert isinstance(pipe.models["controlnet"].controlnet_dit.blocks[0].ffn[0],
                          Int8Linear)
        frames.append(pipe("a ball rolls right", image, control_signal_video=cv, noise=noise,
                           **kw))
    np.testing.assert_array_equal(frames[0], frames[1])
    got = frames[0]
    assert got.shape == ref.shape and 0.0 <= got.min() and got.max() <= 1.0
    np.testing.assert_allclose(got, ref, atol=3e-2)
    assert np.abs(got - ref).mean() <= 2e-3


def test_seeded_noise_is_deterministic(pipes, inputs):
    _, tpipe = pipes
    image, cv = inputs
    kw = dict(control_signal_video=cv[:5], num_frames=5, num_inference_steps=1)
    a = tpipe("x", image, seed=7, **kw)
    b = tpipe("x", image, seed=7, **kw)
    c = tpipe("x", image, seed=8, **kw)
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 1e-4


# Each argument that an earlier slice refused, now held against JAX pipe(...) on JAX's
# noise: (pipeline pair, positional arguments, keywords) per argument.
def _argument_case(arg):
    from test_torch_variant_pipes import FRAMES, H, W, images, pair

    img, vid = images(30), images(31, frames=FRAMES)
    if arg == "fun_control_video":      # Fun-Control: in_dim 3z + 4
        return pair(seed=7, in_dim=16, controlnet=False), (img,), dict(fun_control_video=vid)
    if arg == "reference_image":        # Fun-Reference: a DiT with ref_conv, no ControlNet
        return (pair(seed=8, adapters=("ref_conv",)), (img,),
                dict(reference_image=images(32), controlnet=False))
    if arg == "end_image":              # first-last-frame, with the ControlNet
        return pair(seed=9), (img,), dict(end_image=images(33), control_signal_video=vid)
    if arg == "vace_video":             # VACE on a t2v model, with a mask
        mask = (np.random.default_rng(34).uniform(size=(FRAMES, H, W)) > 0.5).astype(np.float32)
        return (pair(seed=10, in_dim=4, controlnet=False, adapters=("vace",),
                     vace_layers=(1,)), (),
                dict(height=H, width=W, vace_video=vid, vace_video_mask=mask))
    if arg == "motion_bucket_id":       # the motion controller's t_mod offset
        return (pair(seed=11, adapters=("motion_controller",)), (img,),
                dict(motion_bucket_id=42.0, control_signal_video=vid))
    # v2v: the input video's untiled latents noised to the first sigma
    return pair(seed=12), (img,), dict(input_video=vid, denoising_strength=0.7)


@pytest.mark.parametrize("arg", ["fun_control_video", "reference_image", "end_image",
                                 "vace_video", "motion_bucket_id", "input_video"])
def test_argument_matches_jax(arg):
    """Frames of each argument's request against JAX pipe(...) at 1e-3, and different
    from the same request without it (for Fun-Control, whose model needs its video,
    with another video)."""
    from test_torch_variant_pipes import FRAMES, both, images

    pipes, args, kw = _argument_case(arg)
    ref, got = both(*pipes, "a ball rolls right", *args, **kw)
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-3)
    plain = {k: v for k, v in kw.items() if k != arg and not k.startswith("vace_video")
             and k != "denoising_strength"}
    if arg == "fun_control_video":
        plain[arg] = images(35, frames=FRAMES)
    _, without = both(*pipes, "a ball rolls right", *args, **plain)
    assert np.abs(got - without).max() > 1e-3
