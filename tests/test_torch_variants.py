"""The port's Wan variants against the JAX pipeline (CPU, float32, the tiny configs).

Each pair of pipelines holds the same random weights (tests/test_torch_variant_pipes.py) and
the port is given the noise that JAX draws for the same seed, so both run the same
function on the same inputs; frames are held to 1e-3, as the plain pipeline is in
test_torch_pipeline.py. Covered: text-to-video, Fun-Control without a first frame,
camera control on both of its y paths, VACE with a reference image, the strided
ControlNet, ``generate_batch`` (against JAX and against the port's own single calls)
and every combination that JAX refuses. (end_image, v2v, Fun-Control with a first
frame, Fun-Reference, the motion controller and VACE with video and mask are in
test_torch_pipeline.py; ``from_pretrained``'s adapter files in
test_torch_from_pretrained.py; the strided ControlNet's training step and the training
CLI in test_torch_strided_training.py.)
"""

import numpy as np
import pytest
import torch

from test_torch_variant_pipes import FRAMES, H, W, both, images, jax_noise, pair

ATOL = 1e-3


@pytest.fixture(scope="module")
def i2v():
    """The i2v pipeline (in_dim 2z + 4) with the ControlNet, ref_conv, the motion
    controller and the camera adapter."""
    return pair(seed=2, adapters=("ref_conv", "motion_controller", "camera_adapter"))


@pytest.fixture(scope="module")
def t2v():
    """A t2v pipeline (in_dim z) with VACE hints after blocks 0 and 1, and a ControlNet
    (for the refusal of VACE with it)."""
    return pair(seed=3, in_dim=4, adapters=("vace",), vace_layers=(0, 1))


def test_t2v_matches_jax(t2v):
    ref, got = both(*t2v, "a ball rolls", height=H, width=W)
    assert got.shape == (FRAMES, H, W, 3)
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_vace_with_a_reference_image_matches_jax(t2v):
    """The reference frame's latents lead the context, the last noise frame rolls to
    the front, and the first latent frame is dropped before the decode."""
    vv = images(4, frames=FRAMES)
    mask = (np.random.default_rng(5).uniform(size=(FRAMES, H, W, 1)) > 0.5).astype(np.float32)
    ref, got = both(*t2v, "a ball", height=H, width=W, vace_video=vv, vace_video_mask=mask,
                    vace_reference_image=images(6), vace_scale=0.7, extra_frame=True)
    assert got.shape == (FRAMES, H, W, 3)
    np.testing.assert_allclose(got, ref, atol=ATOL)
    plain, _ = both(*t2v, "a ball", height=H, width=W)
    assert np.abs(got - plain).max() > 1e-3


def test_vace_reference_with_v2v_matches_jax(t2v):
    """v2v under a VACE reference image: the reference frame's untiled latents lead the
    input video's."""
    ref, got = both(*t2v, "a ball", height=H, width=W, vace_reference_image=images(7),
                    input_video=images(8, frames=FRAMES), denoising_strength=0.8,
                    extra_frame=True)
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("with_image", [False, True], ids=["t2v", "i2v"])
def test_fun_control_matches_jax(with_image):
    """Fun-Control (in_dim 3z + 4): the control latents lead y; without a first frame
    the rest of y is zero."""
    jp, tp = pair(seed=4, in_dim=16, controlnet=False)
    args = (images(9),) if with_image else ()
    kw = {} if with_image else dict(height=H, width=W)
    ref, got = both(jp, tp, "x", *args, fun_control_video=images(10, frames=FRAMES), **kw)
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_camera_matches_jax_on_the_i2v_y(i2v):
    ref, got = both(*i2v, "x", images(11), camera_control_direction="Left",
                    camera_control_speed=1 / 20, controlnet=False)
    np.testing.assert_allclose(got, ref, atol=ATOL)
    plain, _ = both(*i2v, "x", images(11), controlnet=False)
    assert np.abs(got - plain).max() > 1e-3


def test_camera_model_takes_the_maskless_y():
    """A camera model (in_dim 2z): y is zeros with frame 0 the single-frame encode of
    the input image; the origin can be given."""
    jp, tp = pair(seed=5, in_dim=8, controlnet=False, adapters=("camera_adapter",))
    origin = (0, 0.5, 0.9, 0.5, 0.5, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0)
    ref, got = both(jp, tp, "x", images(12), camera_control_direction="UpIn",
                    camera_control_origin=origin)
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_strided_controlnet_matches_jax():
    """Stride 2 over 4 DiT blocks: ControlNet blocks copy DiT blocks 0 and 2, and their
    raw states (no zero convs) land after blocks 0 and 2."""
    jp, tp = pair(seed=6, num_layers=4, cn_layers=2, stride=2)
    cn = tp.models["controlnet"].controlnet_dit.blocks
    assert torch.equal(cn[1].ffn[0].weight, tp.models["dit"].blocks[2].ffn[0].weight)
    cv = images(13, frames=FRAMES)
    ref, got = both(jp, tp, "x", images(14), control_signal_video=cv)
    np.testing.assert_allclose(got, ref, atol=ATOL)
    off, _ = both(jp, tp, "x", images(14))
    assert np.abs(got - off).max() > 1e-3


@pytest.fixture(scope="module")
def batch_inputs():
    return images(15, n=2), [images(16, frames=FRAMES), images(17, frames=FRAMES)]


def test_generate_batch_matches_jax(i2v, batch_inputs):
    jp, tp = i2v
    imgs, cvs = batch_inputs
    kw = dict(control_signal_videos=cvs, seeds=[0, 1], num_frames=FRAMES,
              num_inference_steps=2)
    ref = jp.generate_batch(["a ball", "a cat"], np.stack(imgs), **kw)
    shape = (1, (FRAMES - 1) // 4 + 1, H // 8, W // 8, tp.vae_cfg.z_dim)
    noise = torch.cat([jax_noise(s, shape) for s in (0, 1)])
    got = tp.generate_batch(["a ball", "a cat"], np.stack(imgs), noise=noise, **kw)
    assert got.shape == (2, FRAMES, H, W, 3)
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_generate_batch_equals_single_calls(i2v, batch_inputs):
    """Each clip of a batch is the single call's (same seed draws, same function),
    within float32 summation order."""
    _, tp = i2v
    imgs, cvs = batch_inputs
    kw = dict(num_frames=FRAMES, num_inference_steps=2)
    got = tp.generate_batch(["a ball", "a cat"], imgs, control_signal_videos=cvs,
                            seeds=[3, 4], **kw)
    for i, (p, s) in enumerate((("a ball", 3), ("a cat", 4))):
        single = tp(p, imgs[i], control_signal_video=cvs[i], seed=s, **kw)
        np.testing.assert_allclose(got[i], single, atol=1e-5)


def _refusal(kind, i2v, t2v):
    img, cv = images(18), images(19, frames=FRAMES)
    vv = images(20, frames=FRAMES)
    base = dict(num_frames=FRAMES, num_inference_steps=1)
    cases = {
        "t2v_needs_image": (i2v, ("x",), dict(height=H, width=W)),
        "t2v_needs_height_width": (t2v, ("x",), {}),
        "fun_control_frames": (i2v, ("x", img), dict(fun_control_video=vv[:3])),
        "control_frames": (i2v, ("x", img), dict(control_signal_video=cv[:3])),
        "motion_without_weights": (t2v, ("x",), dict(height=H, width=W, motion_bucket_id=3)),
        "camera_without_weights": (t2v, ("x",), dict(height=H, width=W,
                                                     camera_control_direction="Left")),
        "vace_without_weights": (i2v, ("x", img), dict(vace_video=vv)),
        "vace_video_frames": (t2v, ("x",), dict(height=H, width=W, vace_video=vv[:3])),
        "vace_mask_frames": (t2v, ("x",), dict(height=H, width=W,
                                               vace_video_mask=vv[:3, ..., 0])),
        "adapter_with_windows": (i2v, ("x", img), dict(motion_bucket_id=3,
                                                       sliding_window_size=1,
                                                       sliding_window_stride=1)),
        "adapter_with_teacache": (i2v, ("x", img), dict(motion_bucket_id=3,
                                                        tea_cache_l1_thresh=0.1)),
        "adapter_with_fun_control": (i2v, ("x", img), dict(motion_bucket_id=3,
                                                           fun_control_video=vv)),
        "vace_reference_with_first_frame": (t2v, ("x", img),
                                            dict(vace_reference_image=img)),
        "reference_with_controlnet": (i2v, ("x", img), dict(reference_image=img,
                                                            control_signal_video=cv)),
        "reference_without_ref_conv": (t2v, ("x",), dict(height=H, width=W,
                                                         reference_image=img)),
        "vace_with_controlnet": (t2v, ("x",), dict(height=H, width=W, vace_video=vv,
                                                   control_signal_video=cv)),
    }
    pipes, args, kw = cases[kind]
    return pipes, args, dict(base, **kw)


REFUSALS = ["t2v_needs_image", "t2v_needs_height_width", "fun_control_frames",
            "control_frames", "motion_without_weights", "camera_without_weights",
            "vace_without_weights", "vace_video_frames", "vace_mask_frames",
            "adapter_with_windows", "adapter_with_teacache", "adapter_with_fun_control",
            "vace_reference_with_first_frame", "reference_with_controlnet",
            "reference_without_ref_conv", "vace_with_controlnet"]


@pytest.mark.parametrize("kind", REFUSALS)
def test_refuses_what_jax_refuses(i2v, t2v, kind):
    (jp, tp), args, kw = _refusal(kind, i2v, t2v)
    with pytest.raises((ValueError, NotImplementedError)) as jax_err:
        jp(*args, seed=0, **kw)
    with pytest.raises(jax_err.type):
        tp(*args, seed=0, **kw)


def test_unknown_keyword_fails_as_in_jax(i2v):
    jp, tp = i2v
    for pipe in (jp, tp):
        with pytest.raises(TypeError, match="no_such_argument"):
            pipe("x", images(21), num_frames=FRAMES, no_such_argument=1)
