"""Kolors in the port against the JAX package: ChatGLM3 at a tiny width, the loaders of
the UNet families, and the tiny Kolors pipeline.

``chatglm_encode`` (the prompt embedding ``hidden_states[-2]`` and the pooled last token
of the pre-final-norm output) on two rows; the rope tables equal JAX's exactly;
``infer_chatglm_config``; ``load_model("chatglm")``, ``("sd_unet")`` and ``("sdxl_unet")``
through reference-named files; and two tiny Kolors requests (text-to-image; image-to-image
with a regional prompt and ``tiled``), JAX's noise passed in.

Weights are the port's random ones, offset so that no bias or norm is trivial, carried to
JAX through its converters and back through ``io/from_jax.py`` bit for bit. float32
limits 1e-4 (ChatGLM) and 5e-4 x 1e-3 relative (the requests), as the other pipelines'."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from goal_force_tpu.io import auto as jauto
from goal_force_tpu.models import kolors_text_encoder as jglm
from goal_force_tpu.models import sd_unet as jsu
from goal_force_tpu.models import sdxl_unet as jsx
from goal_force_tpu.pipelines import kolors as jpipe

from goal_force_tpu_torch.io import auto as tauto
from goal_force_tpu_torch.io import from_jax
from goal_force_tpu_torch.models import kolors_text_encoder as tglm
from goal_force_tpu_torch.models import sd_unet as tsu
from goal_force_tpu_torch.models import sdxl_unet as tsx
from goal_force_tpu_torch.models import sd_vae as tvae
from goal_force_tpu_torch.pipelines import kolors as tpipe

from test_torch_sd_unet import _gen, _np_sd, _perturb, _t, carried, tiny_vae

F32 = dict(rtol=1e-4, atol=1e-4)
PIPE_TOL = dict(rtol=1e-3, atol=5e-4)
GLM_CFG, PLAN = tpipe.tiny_kolors_configs()
JGLM_CFG, JPLAN = jpipe.tiny_kolors_configs()


def _glm(seed=0):
    model = _perturb(tglm.init_chatglm(GLM_CFG, _gen(seed), device="cpu"), seed + 1)
    return carried(model, jglm.chatglm_params_from_torch(_np_sd(model), JGLM_CFG),
                   from_jax.chatglm_state_dict)


def _unet(seed=10):
    model = _perturb(tsx.init_sdxl_unet(PLAN, _gen(seed), device="cpu", model_dim=8,
                                        time_dim=16, add_embed_in=GLM_CFG.hidden_size + 6 * 256,
                                        text_proj=(GLM_CFG.hidden_size, 24)), seed + 1)
    return carried(model, jsx.sdxl_unet_params_from_torch(_np_sd(model), PLAN),
                   from_jax.sd_unet_state_dict)


@pytest.fixture(scope="module")
def models():
    return {"glm": _glm(), "unet": _unet(), "vae": tiny_vae(60)}


def test_configs_and_rope_tables_equal_jax():
    assert dataclasses.asdict(GLM_CFG) == dataclasses.asdict(JGLM_CFG) and PLAN == JPLAN
    assert dataclasses.asdict(tglm.ChatGLMConfig()) == dataclasses.asdict(jglm.ChatGLMConfig())
    assert GLM_CFG.rot_dim == JGLM_CFG.rot_dim
    for args in ((256, 64), (10, 4), (7, 8)):
        for a, b in zip(tglm._glm_rope(*args), jglm._glm_rope(*args)):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)


def test_chatglm_encode_matches_jax(models):
    """B = 2 rows of 10 ids (the causal mask, the rope on the first 4 of each head's 8
    dims, 2 K/V groups for 4 heads): hidden_states[-2] and the pooled last token before
    the final norm."""
    model, params = models["glm"]
    ids = np.random.default_rng(3).integers(0, GLM_CFG.vocab, size=(2, 10))
    want = jax.jit(lambda p, x: jglm.chatglm_encode(p, JGLM_CFG, x, clip_skip=2))(params, ids)
    got = tglm.chatglm_encode(model, GLM_CFG, _t(ids), clip_skip=2)
    for g, w, shape in zip(got, want, ((2, 10, 32), (2, 32))):
        assert g.shape == w.shape == shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)


def test_load_model_reads_reference_files(models, tmp_path):
    """ChatGLM (with an HF file's rotary buffer and LM head, which the encoder never
    reads), the SD UNet and the Kolors UNet as safetensors files: kinds, configs and plans
    as JAX's, weights strict."""
    from goal_force_tpu_torch.io.safetensors_io import save_safetensors

    glm = models["glm"][0]
    sd_unet = tsu.init_sd_unet(tsu.tiny_sd_plan(24), _gen(20), device="cpu", model_dim=8,
                               time_dim=16)
    files = {"chatglm": (glm, {"num_heads": 4}), "sd_unet": (sd_unet, {"plan": tsu.tiny_sd_plan(24)}),
             "sdxl_unet": (models["unet"][0], {"plan": PLAN})}
    for kind, (model, kw) in files.items():
        state = dict(model.state_dict())
        if kind == "chatglm":
            state["rotary_pos_emb.inv_freq"] = torch.ones(2)
            state["output_layer.weight"] = torch.zeros(GLM_CFG.vocab, GLM_CFG.hidden_size)
        path = str(tmp_path / f"{kind}.safetensors")
        save_safetensors(state, path)
        got = tauto.load_model(path, device="cpu", **kw)
        want = jauto.load_model(_np_sd(model), **kw)
        assert got["kind"] == want["kind"] == kind and kind not in tauto.ROADMAP_ITEMS
        if kind == "chatglm":
            assert dataclasses.asdict(got["config"]) == dataclasses.asdict(want["config"])
            assert dataclasses.asdict(tauto.infer_chatglm_config(_np_sd(model), 4)) == \
                dataclasses.asdict(jauto.infer_chatglm_config(_np_sd(model), 4))
        else:
            assert got["config"] == want["config"]
        for k, v in got["model"].state_dict().items():
            np.testing.assert_array_equal(v.numpy(), model.state_dict()[k].numpy(), err_msg=k)


@pytest.fixture(scope="module")
def pipes(models):
    (glm, jg), (unet, ju) = models["glm"], models["unet"]
    (enc, je), (dec, jd) = models["vae"]
    jp = jpipe.KolorsPipeline(unet=ju, glm=jg, vae_encoder=je, vae_decoder=jd,
                              glm_cfg=JGLM_CFG, plan=JPLAN, groups=4,
                              vae_enc_plan=tvae.TINY_SD_VAE_ENCODER_PLAN,
                              vae_dec_plan=tvae.TINY_SD_VAE_DECODER_PLAN, vae_groups=4,
                              dtype=jnp.float32)
    tp = tpipe.KolorsPipeline(unet=unet, glm=glm, vae_encoder=enc, vae_decoder=dec,
                              glm_cfg=GLM_CFG, groups=4, vae_groups=4, dtype=torch.float32)
    return jp, tp


def _noise(seed, shape):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))


@pytest.mark.parametrize("case", ["t2i", "i2i_regional_tiled"])
def test_kolors_pipeline_matches_jax(pipes, case):
    """t2i: merged CFG 3.0 on hash ids (32 a prompt), 3 steps at 32x48 (4x6 latents).
    i2i_regional_tiled: strength 0.7 from a 32x48 image, one local prompt with a mask
    and scale 0.8 (blur 3 / 1.0), tiled at tile 4, stride 2 (the encode on 32-pixel tiles at
    stride 16, the decode on 4-latent tiles)."""
    jp, tp = pipes
    kw = dict(prompt="a red ball on a table", negative_prompt="blurry", cfg_scale=3.0,
              height=32, width=48, num_inference_steps=3, seed=9)
    if case == "i2i_regional_tiled":
        mask = np.zeros((32, 48), np.float32)
        mask[:, 20:] = 1.0
        kw.update(input_image=np.random.default_rng(4).uniform(size=(32, 48, 3)),
                  denoising_strength=0.7, local_prompts=["a blue cup"], masks=[mask],
                  mask_scales=[0.8], local_blur_kernel_size=3, local_blur_sigma=1.0,
                  tiled=True, tile_size=4, tile_stride=2)
    want = jp(**kw)
    got = tp(**kw, noise=_noise(9, (1, 4, 6, 4)))
    assert got.shape == want.shape == (32, 48, 3)
    np.testing.assert_allclose(got, want, **PIPE_TOL)
    assert tsu.SD15_PLAN == jsu.SD15_PLAN
