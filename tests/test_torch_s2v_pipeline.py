"""The port's S2VPipeline against the JAX package's (CPU, float32, tiny configs).

One seeded state dict per model (the S2V DiT drawn as in test_torch_s2v.py, umt5 and
the Wan2.1 VAE from the port's initialisers) goes into both packages through their
``from_pretrained``; the port gets JAX's initial noise (``noise=``). Frames agree within
1e-3 for plain, pose and motion requests with CFG on and off, and both packages refuse
the same requests.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from goal_force_tpu import configs as jcfg
from goal_force_tpu.configs import PipelineConfig as JaxPipelineConfig
from goal_force_tpu.models import s2v as js2v
from goal_force_tpu.pipelines.s2v import S2VPipeline as JaxS2V

from goal_force_tpu_torch import configs as tcfg
from goal_force_tpu_torch.models import s2v as ts2v
from goal_force_tpu_torch.models import t5 as tt5
from goal_force_tpu_torch.models import vae as tvae
from goal_force_tpu_torch.pipelines.s2v import MOTION_FRAMES, S2VPipeline
from test_torch_s2v import random_state_dict

FRAMES, H, W, STEPS = 5, 64, 64, 2     # 64 px: motion latents of 8 rows (the packer's 8)
ATOL = 1e-3


@pytest.fixture(scope="module")
def pipes():
    # one block with its audio injection: JAX compiles each request's step anew
    cfg = dataclasses.replace(js2v.tiny_s2v(num_layers=1), audio_inject_layers=(0,))
    tcfg_s2v = ts2v.S2VConfig(**dataclasses.asdict(cfg))
    gen = torch.Generator().manual_seed(7)
    sds = {"s2v": random_state_dict(tcfg_s2v, seed=8),
           "t5": {k: v.numpy() for k, v in
                  tt5.init_t5(tcfg.tiny_t5(), gen, torch.float32,
                              device="cpu").state_dict().items()},
           "vae": {k: v.numpy() for k, v in
                   tvae.init_vae(tcfg.tiny_vae(), gen, device="cpu").state_dict().items()}}
    jpipe = JaxS2V.from_pretrained(sds["s2v"], sds["t5"], sds["vae"], cfg=cfg,
                                   t5_cfg=jcfg.tiny_t5(), vae_cfg=jcfg.tiny_vae(),
                                   pipe_cfg=JaxPipelineConfig(), dtype=jnp.float32)
    tsd = {k: {n: torch.from_numpy(v) for n, v in sd.items()} for k, sd in sds.items()}
    tpipe = S2VPipeline.from_pretrained(tsd["s2v"], tsd["t5"], tsd["vae"], cfg=tcfg_s2v,
                                        t5_cfg=tcfg.tiny_t5(), vae_cfg=tcfg.tiny_vae(),
                                        dtype=torch.float32, device="cpu")
    return jpipe, tpipe


def inputs(seed, h=H, w=W):
    rng = np.random.default_rng(seed)
    return dict(
        image=rng.uniform(size=(h, w, 3)).astype(np.float32),
        audio=rng.normal(size=(1, 25, 16, FRAMES - 1)).astype(np.float32),
        pose=rng.uniform(size=(FRAMES - 2, h, w, 3)).astype(np.float32),   # padded with -1
        motion=rng.uniform(size=(MOTION_FRAMES, h, w, 3)).astype(np.float32))


@pytest.mark.parametrize("cfg_scale", [5.0, 1.0])
@pytest.mark.parametrize("kind", ["plain", "pose", "motion"])
def test_frames_match_jax(pipes, kind, cfg_scale):
    jpipe, tpipe = pipes
    x = inputs(1)
    kw = dict(audio_embeds=x["audio"], seed=3, num_frames=FRAMES, num_inference_steps=STEPS,
              cfg_scale=cfg_scale)
    if kind == "pose":
        kw["s2v_pose_video"] = x["pose"]
    if kind == "motion":
        kw["motion_video"] = x["motion"]
    ref = jpipe("a person speaks", x["image"], **kw)
    lat_f = (FRAMES - 1) // 4 + 1
    noise = torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(3), (1, lat_f, H // 8, W // 8, 4), jnp.float32)))
    got = tpipe("a person speaks", x["image"], noise=noise, **kw)
    frames = FRAMES + (MOTION_FRAMES - 1 if kind == "motion" else 0)
    assert got.shape == ref.shape == (frames, H, W, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_motion_video_of_the_wrong_length_is_refused(pipes):
    jpipe, tpipe = pipes
    x = inputs(2)
    kw = dict(audio_embeds=x["audio"], num_frames=FRAMES, num_inference_steps=1,
              motion_video=x["motion"][:70])
    with pytest.raises(ValueError, match="73 frames"):
        jpipe("p", x["image"], **kw)
    with pytest.raises(ValueError, match="73 frames"):
        tpipe("p", x["image"], **kw)


def test_motion_at_a_height_that_does_not_divide_by_8_is_refused(pipes):
    """48 px: 6 latent rows, as a 480-pixel motion video has 60."""
    jpipe, tpipe = pipes
    x = inputs(3, h=48)
    kw = dict(audio_embeds=x["audio"], num_frames=FRAMES, num_inference_steps=1,
              motion_video=x["motion"])
    with pytest.raises(TypeError):
        jpipe("p", x["image"], **kw)
    with pytest.raises(TypeError, match="divide by 8"):
        tpipe("p", x["image"], **kw)


def test_input_audio_is_refused_as_in_jax(pipes, tmp_path):
    """JAX's audio_features passes batch_frames to Wav2Vec2Features.extract, which has no
    such parameter: both packages raise TypeError on input_audio."""
    from test_torch_audio import tiny_wav2vec

    jpipe, tpipe = pipes
    path = tiny_wav2vec(tmp_path)
    x = inputs(4)
    wav = np.random.default_rng(5).normal(size=(4000,)).astype(np.float32)
    kw = dict(input_audio=wav, wav2vec_path=path, num_frames=FRAMES, num_inference_steps=1)
    with pytest.raises(TypeError, match="batch_frames"):
        jpipe("p", x["image"], **kw)
    with pytest.raises(TypeError, match="batch_frames"):
        tpipe("p", x["image"], **kw)
    with pytest.raises(ValueError, match="audio_embeds or input_audio"):
        tpipe("p", x["image"], num_frames=FRAMES)


def test_noise_of_the_wrong_shape_is_refused(pipes):
    _, tpipe = pipes
    x = inputs(6)
    with pytest.raises(ValueError, match="noise has shape"):
        tpipe("p", x["image"], audio_embeds=x["audio"], num_frames=FRAMES,
              num_inference_steps=1, noise=torch.zeros(1, 1, 8, 8, 4))
