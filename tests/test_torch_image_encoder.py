"""The CLIP image encoder and the DiT's image branch of the port against the JAX
package's (CPU, float32, small configs).

1. The ViT-H/14 vision tower at a small ViTConfig: weights drawn by the port (its norms
   perturbed), read by JAX through ``vit_params_from_torch``; ``preprocess_image`` bit for
   bit, ``vit_encode`` and ``encode_image`` to 1e-4 of max|JAX|, the loader's keys.
2. ``wan_dit_forward(clip_feature=)`` at tiny_dit with the image branch (``img_emb``,
   ``k_img``/``v_img``/``norm_k_img``), with and without ``emb_pos``, for both values of
   ``has_image_input``; a Wan2.1-I2V-shaped DiT file through both packages'
   ``from_pretrained``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from goal_force_tpu import configs as jcfg
from goal_force_tpu.io.torch_convert import dit_params_from_torch
from goal_force_tpu.models import image_encoder as jvit
from goal_force_tpu.models import wan_dit as jdit
from goal_force_tpu.pipelines import GoalForcePipeline as JaxPipeline

from goal_force_tpu_torch import configs as tcfg
from goal_force_tpu_torch.io import safetensors_io as sio
from goal_force_tpu_torch.io.from_jax import dit_state_dict, params_from_jax
from goal_force_tpu_torch.models import image_encoder as tvit
from goal_force_tpu_torch.models import wan_dit as tdit
from goal_force_tpu_torch.pipelines.goal_force import GoalForcePipeline

RTOL = 1e-4
VIT = dict(image_size=28, patch_size=14, dim=32, mlp_ratio=2, num_heads=2, num_layers=3,
           use_blocks=2)
CLIP_DIM = 48


def close(got, ref):
    ref = np.asarray(ref)
    got = got.detach().numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=RTOL * float(np.abs(ref).max()))


@torch.no_grad()
def perturb_norms(model, seed):
    gen = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        if "norm" in name:
            p.add_(0.1 * torch.randn(p.shape, generator=gen))


@pytest.fixture(scope="module")
def vit():
    cfg, jc = tvit.ViTConfig(**VIT), jvit.ViTConfig(**VIT)
    model = tvit.init_vit(cfg, torch.Generator().manual_seed(0), device="cpu")
    perturb_norms(model, 1)
    sd = {"model.visual." + k: v.numpy() for k, v in model.state_dict().items()}
    params = jax.tree_util.tree_map(jnp.asarray, jvit.vit_params_from_torch(sd, jc))
    return cfg, jc, sd, params, model


def test_preprocess_image_equals_jax():
    img = np.random.default_rng(2).uniform(size=(48, 80, 3)).astype(np.float32)
    np.testing.assert_array_equal(tvit.preprocess_image(img), jvit.preprocess_image(img))
    np.testing.assert_array_equal(tvit.preprocess_image(img, 28),
                                  jvit.preprocess_image(img, 28))


def test_vit_encode_matches_jax(vit):
    cfg, jc, _, params, model = vit
    x = np.random.default_rng(3).normal(size=(2, 28, 28, 3)).astype(np.float32)
    ref = jax.jit(lambda p, a: jvit.vit_encode(p, jc, a))(params, jnp.asarray(x))
    with torch.no_grad():
        got = tvit.vit_encode(model, cfg, torch.from_numpy(x))
    assert got.shape == (2, cfg.num_tokens, cfg.dim)
    close(got, ref)


def test_encode_image_matches_jax(vit):
    cfg, jc, _, params, model = vit
    img = np.random.default_rng(4).uniform(size=(40, 64, 3)).astype(np.float32)
    close(tvit.encode_image(model, img, cfg), jvit.encode_image(params, img, jc))


def test_state_dict_round_trip_and_loader(vit):
    """vit_state_dict gives back the keys JAX's converter read; the loader takes them
    under model.visual. or visual., ignores the keys JAX ignores and refuses a missing
    or mis-shaped one."""
    cfg, _, sd, params, _ = vit
    back = params_from_jax({"image_encoder": jax.tree_util.tree_map(np.asarray, params)})
    back = back["image_encoder"]
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    extra = {"model.textual.token_embedding.weight": torch.zeros(3, 4),
             "model.visual.post_norm.weight": torch.ones(cfg.dim),
             "model.log_scale": torch.ones(())}
    loaded = tvit.vit_from_state_dict({**back, **extra}, cfg, device="cpu")
    for k, v in loaded.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd["model.visual." + k], err_msg=k)
    bare = {k[len("model."):]: v for k, v in back.items()}
    tvit.vit_from_state_dict(bare, cfg, device="cpu")
    with pytest.raises(KeyError, match="pre_norm.bias"):
        tvit.vit_from_state_dict({k: v for k, v in back.items() if "pre_norm.bias" not in k},
                                 cfg, device="cpu")
    with pytest.raises(ValueError, match="pos_embedding"):
        tvit.vit_from_state_dict({**back, "model.visual.pos_embedding": torch.zeros(1, 3, 3)},
                                 cfg, device="cpu")


def test_vit_h_14_equals_jax():
    assert dataclasses.asdict(tvit.VIT_H_14) == dataclasses.asdict(jvit.VIT_H_14)
    assert tvit.VIT_H_14.num_tokens == 257 and tvit.VIT_H_14.dim // 16 == 80
    assert tvit.CLIP_MEAN == jvit.CLIP_MEAN and tvit.CLIP_STD == jvit.CLIP_STD


# ---------------------------------------------------------------------------
# The DiT's image branch
# ---------------------------------------------------------------------------

def image_dit(pos_len, seed=5, cfg=None):
    """A tiny DiT with the image branch; its reference-format state dict (numpy)."""
    cfg = cfg or tcfg.tiny_dit()
    gen = torch.Generator().manual_seed(seed)
    model = tdit.init_wan_dit(cfg, gen, torch.float32, device="cpu")
    tdit.init_image_branch_(model, gen, clip_dim=CLIP_DIM, pos_len=pos_len)
    perturb_norms(model, seed + 1)
    return model, {k: v.numpy() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("has_image_input", [True, False])
@pytest.mark.parametrize("pos_len", [0, 6])
def test_forward_with_clip_feature_matches_jax(has_image_input, pos_len):
    tc_ = dataclasses.replace(tcfg.tiny_dit(num_layers=1), has_image_input=has_image_input)
    jc = dataclasses.replace(jcfg.tiny_dit(num_layers=1), has_image_input=has_image_input)
    model, sd = image_dit(pos_len, cfg=tc_)
    params = jax.tree_util.tree_map(jnp.asarray, dit_params_from_torch(sd, jc))
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 2, 4, 6, 16)).astype(np.float32)
    y = rng.normal(size=(2, 2, 4, 6, 20)).astype(np.float32)
    ctx = rng.normal(size=(2, 5, jc.text_dim)).astype(np.float32)
    clip = rng.normal(size=(2, pos_len or 4, CLIP_DIM)).astype(np.float32)
    t = np.array([900.0, 300.0], np.float32)
    fwd = jax.jit(lambda p, *a: jdit.wan_dit_forward(p, jc, *a[:4], clip_feature=a[4]))
    ref = fwd(params, *map(jnp.asarray, (x, t, ctx, y, clip)))
    with torch.no_grad():
        got = tdit.wan_dit_forward(model, tc_, *map(torch.from_numpy, (x, t, ctx, y)),
                                   clip_feature=torch.from_numpy(clip))
        plain = tdit.wan_dit_forward(model, tc_, *map(torch.from_numpy, (x, t, ctx, y)))
    close(got, ref)
    # the image tokens move the velocity exactly when the config takes them
    assert bool((got != plain).any()) == has_image_input


def test_dit_state_dict_carries_the_image_branch():
    model, sd = image_dit(6)
    assert tdit.dit_kwargs(sd) == {"clip_dim": CLIP_DIM, "img_pos_len": 6}
    tree = jax.tree_util.tree_map(np.asarray, dit_params_from_torch(sd, jcfg.tiny_dit()))
    back = dit_state_dict(tree)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    again = tdit.empty_module(tdit.WanDiT, tcfg.tiny_dit(), device="cpu",
                              **tdit.dit_kwargs(sd))
    again.load_state_dict(back)


def test_an_i2v_dit_file_loads_in_both_packages(tmp_path):
    """A Wan2.1-I2V-shaped DiT file (img_emb and k_img/v_img in every block) through
    both packages' from_pretrained; the ControlNet copies the blocks without their image
    keys, and the loaded DiTs agree with a clip_feature."""
    tc_ = dataclasses.replace(tcfg.tiny_dit(), has_image_input=True)
    jc = dataclasses.replace(jcfg.tiny_dit(), has_image_input=True)
    _, sd = image_dit(0, seed=9, cfg=tc_)
    path = str(tmp_path / "i2v.safetensors")
    sio.save_safetensors({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    tpipe = GoalForcePipeline.from_pretrained(path, controlnet_num_layers=1, dit_cfg=tc_,
                                              dtype=torch.float32, device="cpu")
    jpipe = JaxPipeline.from_pretrained(path, controlnet_num_layers=1, dit_cfg=jc,
                                        dtype=jnp.float32)
    dit = tpipe.models["dit"]
    assert hasattr(dit, "img_emb") and hasattr(dit.blocks[0].cross_attn, "k_img")
    assert not any("k_img" in k for k in tpipe.models["controlnet"].state_dict())
    np.testing.assert_array_equal(dit.blocks[1].cross_attn.v_img.weight.numpy(),
                                  sd["blocks.1.cross_attn.v_img.weight"])
    rng = np.random.default_rng(8)
    x = rng.normal(size=(1, 1, 4, 4, 16)).astype(np.float32)
    y = rng.normal(size=(1, 1, 4, 4, 20)).astype(np.float32)
    ctx = rng.normal(size=(1, 3, jc.text_dim)).astype(np.float32)
    clip = rng.normal(size=(1, 4, CLIP_DIM)).astype(np.float32)
    t = np.array([500.0], np.float32)
    ref = jdit.wan_dit_forward(jpipe.params["dit"], jc, *map(jnp.asarray, (x, t, ctx, y)),
                               clip_feature=jnp.asarray(clip))
    with torch.no_grad():
        got = tdit.wan_dit_forward(dit, tc_, *map(torch.from_numpy, (x, t, ctx, y)),
                                   clip_feature=torch.from_numpy(clip))
    close(got, ref)
