"""The port's Wan2.2 VAE (VAE38) against the JAX package's (CPU, float32, tiny_vae38).

The port's ``init_vae38`` draws the weights with JAX's distributions (the zero-initialised
attention projections then set to small random values, so the mid-block attention
counts); JAX reads them through its own ``vae38_params_from_torch``, which is faster here
than its jitted initialiser. encode_video and decode_video agree to 1e-4 of max|JAX| at
1 and 5 frames, and the JAX tree goes back through ``io/from_jax.py`` to the same keys.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from goal_force_tpu.models import vae38 as jv

from goal_force_tpu_torch.io.from_jax import params_from_jax, vae38_state_dict
from goal_force_tpu_torch.models import vae38 as tv

H, W = 32, 48
RTOL = 1e-4


@pytest.fixture(scope="module")
def tiny():
    jcfg, cfg = jv.tiny_vae38(), tv.tiny_vae38()
    model = tv.init_vae38(cfg, torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for side in (model.encoder, model.decoder):
            proj = side.middle[1].proj
            proj.weight.copy_(0.2 * torch.randn(proj.weight.shape, generator=gen))
            proj.bias.copy_(0.1 * torch.randn(proj.bias.shape, generator=gen))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    tree = jv.vae38_params_from_torch(sd, jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, cfg, sd, tree, params, model


def close(got, ref):
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=RTOL * float(np.abs(ref).max()))


@pytest.mark.parametrize("frames", [1, 5])
def test_encode_matches_jax(tiny, frames):
    jcfg, cfg, _, _, params, model = tiny
    video = np.random.default_rng(frames).uniform(-1, 1, (1, frames, H, W, 3))
    video = video.astype(np.float32)
    ref = jax.jit(lambda p, v: jv.encode_video(p, jcfg, v))(params, jnp.asarray(video))
    with torch.no_grad():
        got = tv.encode_video(model, cfg, torch.from_numpy(video))
    assert got.shape == (1, (frames - 1) // 4 + 1, H // 16, W // 16, cfg.z_dim)
    close(got, ref)


@pytest.mark.parametrize("latent_frames", [1, 2])
def test_decode_matches_jax(tiny, latent_frames):
    jcfg, cfg, _, _, params, model = tiny
    lat = np.random.default_rng(10 + latent_frames).standard_normal(
        (1, latent_frames, H // 16, W // 16, cfg.z_dim)).astype(np.float32)
    ref = jax.jit(lambda p, z: jv.decode_video(p, jcfg, z))(params, jnp.asarray(lat))
    with torch.no_grad():
        got = tv.decode_video(model, cfg, torch.from_numpy(lat))
    assert got.shape == (1, 4 * latent_frames - 3, H, W, 3)
    close(got, ref)


def test_pixel_patchify_and_resamplers_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 5, 8, 12, 3)).astype(np.float32)
    p = tv.pixel_patchify(torch.from_numpy(x))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jv.pixel_patchify(jnp.asarray(x))))
    np.testing.assert_array_equal(tv.pixel_unpatchify(p).numpy(), x)
    y = rng.standard_normal((1, 5, 4, 6, 8)).astype(np.float32)   # channels-last
    cf = torch.from_numpy(y).permute(0, 4, 1, 2, 3)
    for ft, fs, out in ((2, 2, 16), (1, 2, 8), (1, 1, 8)):
        ref = jv.avg_down3d(jnp.asarray(y), ft, fs, out)
        got = tv.avg_down3d(cf, ft, fs, out).permute(0, 2, 3, 4, 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    for ft, out in ((2, 4), (1, 8)):
        ref = jv.dup_up3d(jnp.asarray(y), ft, 2, out, first_chunk=True)
        got = tv.dup_up3d(cf, ft, 2, out, first_chunk=True).permute(0, 2, 3, 4, 1)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_reference_keys_round_trip_through_jax(tiny):
    """The port's module has the reference's keys: JAX's converter reads every one, and
    io/from_jax.py gives them back from JAX's tree."""
    jcfg, cfg, sd, tree, _, _ = tiny
    back = params_from_jax({"vae38": jax.tree_util.tree_map(np.asarray, tree)})["vae38"]
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    prefixed = jv.vae38_params_from_torch({"model." + k: v for k, v in sd.items()}, jcfg)
    assert sorted(vae38_state_dict(prefixed)) == sorted(sd)
    loaded = tv.vae38_from_state_dict({"model." + k: v for k, v in back.items()}, cfg,
                                      device="cpu")
    for k, v in loaded.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    with pytest.raises(KeyError, match="decoder.head.2.bias"):
        tv.vae38_from_state_dict({k: v for k, v in back.items() if k != "decoder.head.2.bias"},
                                 cfg, device="cpu")


def test_full_config_shapes_equal_jax():
    """The Wan2.2 preset's module shapes are JAX's (a structure check, no weights)."""
    assert tv.VAE38Config() == tv.WAN22_VAE38
    assert tv.enc_stages(tv.WAN22_VAE38) == jv._enc_stages(jv.VAE38Config())
    assert tv.dec_stages(tv.WAN22_VAE38) == jv._dec_stages(jv.VAE38Config())
    assert tv.VAE38_MEAN == jv.VAE38_MEAN and tv.VAE38_STD == jv.VAE38_STD
    with torch.device("meta"):
        model = tv.WanVAE38(tv.WAN22_VAE38)
    n = sum(p.numel() for p in model.parameters())
    shapes = jax.eval_shape(functools.partial(jv.init_vae38, cfg=jv.VAE38Config()),
                            jax.random.PRNGKey(0))
    assert n == sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
