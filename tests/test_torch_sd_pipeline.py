"""The SD 1.5 and SDXL pipelines of the port against the JAX package, at tiny configs.

Three requests a family, which between them take every path of ``__call__``: a long
prompt of two sentences against a one-sentence negative (the vendored CLIP tokenizers at
12 tokens a sentence: the shared sentence count and the ``ctx_len`` key mask; SDXL with
the union ControlNet); image-to-image with a regional prompt and the IP-Adapter; and
``tiled`` (SD with its ControlNet). Then ``sd_pipeline_from_civitai`` on a synthetic
bundle in the LDM layout, read as JAX's civitai converters read it.

Weights are the port's random ones, offset so that no bias or norm is trivial, carried to
JAX through its converters and back through ``io/from_jax.py`` bit for bit; the text
towers are 49,408 ids wide so real token ids fit. Without a tokenizer both packages draw
the same hash ids (Python's ``hash`` is salted per process, and both run in this one).
JAX's noise is passed in. float32 limit 5e-4 x 1e-3 relative, as the other pipelines'."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from goal_force_tpu import prompters as jprompt
from goal_force_tpu.io import detect as jdetect
from goal_force_tpu.models import ipadapter as jip
from goal_force_tpu.models import sd_controlnet as jcn
from goal_force_tpu.models import sd_text_encoder as jsd
from goal_force_tpu.models import sd_unet as jsu
from goal_force_tpu.models import sd_vae as jvae
from goal_force_tpu.models import sdxl_unet as jsx
from goal_force_tpu.pipelines import sd as jpipe
from goal_force_tpu.pipelines import sdxl as jxpipe

from goal_force_tpu_torch import prompters as tprompt
from goal_force_tpu_torch.io import from_jax
from goal_force_tpu_torch.models import clip as tclip
from goal_force_tpu_torch.models import ipadapter as tip
from goal_force_tpu_torch.models import sd_controlnet as tcn
from goal_force_tpu_torch.models import sd_unet as tsu
from goal_force_tpu_torch.models import sd_vae as tvae
from goal_force_tpu_torch.models import sdxl_unet as tsx
from goal_force_tpu_torch.pipelines import sd as tpipe
from goal_force_tpu_torch.pipelines import sdxl as txpipe

from test_torch_sd_unet import _gen, _np_sd, _perturb, carried, tiny_vae

TOL = dict(rtol=1e-3, atol=5e-4)
SD_PLAN = tsu.tiny_sd_plan(ctx_dim=32)
SD_CN_PLAN = (("res", 8, 8), ("attn", 2, 4, 8, 32), ("push",), ("down", 8), ("push",),
              ("res", 8, 16), ("push",), ("res", 16, 16), ("attn", 2, 8, 16, 32),
              ("res", 16, 16), ("push",))
XL_PLAN = txpipe.TINY_SDXL_PLAN
XL_CN_PLAN = (("res", 8, 8), ("push",), ("down", 8), ("push",), ("res", 8, 16),
              ("attn", 2, 8, 16, 24, 2), ("res", 16, 16), ("push",))
WIDE = dict(vocab_size=49408)
SD_TEXT = dataclasses.replace(tpipe.TINY_SD_TEXT_CONFIG, **WIDE)
XL_TEXT1 = dataclasses.replace(txpipe.TINY_SDXL_TEXT_CONFIG, **WIDE)
XL_TEXT2 = dataclasses.replace(txpipe.TINY_SDXL_TEXT2_CONFIG, **WIDE)
LONG = ("a red ball rolls across a long wooden table, hits a small blue cup and the cup "
        "tips over")


def _jcfg(cfg):
    from goal_force_tpu.models.clip import CLIPConfig

    return CLIPConfig(**dataclasses.asdict(cfg))


def _tower(cfg, seed, **kw):
    model = _perturb(tclip.init_clip_text(cfg, _gen(seed), device="cpu", **kw), seed + 1)
    sd = _np_sd(model)
    if kw.get("projection"):
        tree = jsd.sdxl_text_params_from_torch(sd, _jcfg(cfg), with_projection=True)
    elif not kw.get("final_norm", True):
        tree = jsd.sdxl_text_params_from_torch(sd, _jcfg(cfg))
    else:
        tree = jsd.sd_text_params_from_torch(sd, _jcfg(cfg))
    return carried(model, tree, from_jax.clip_text_state_dict)


def _ip(plan, ctx, seed):
    model = _perturb(tip.init_ip_adapter(plan, ctx, 12, _gen(seed), device="cpu"), seed + 1)
    return carried(model, jip.ip_adapter_params_from_torch(_np_sd(model)),
                   from_jax.ipadapter_state_dict)


def _noise(seed, shape):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))


@pytest.fixture(scope="module")
def sd_pipes():
    unet = _perturb(tsu.init_sd_unet(SD_PLAN, _gen(0), device="cpu", model_dim=8,
                                     time_dim=16), 1)
    unet, ju = carried(unet, jsu.sd_unet_params_from_torch(_np_sd(unet), SD_PLAN),
                       from_jax.sd_unet_state_dict)
    cn = _perturb(tcn.init_sd_controlnet(SD_CN_PLAN, _gen(2), device="cpu", model_dim=8,
                                         time_dim=16, cond_channels=(3, 4, 4, 6, 6)), 3)
    cn, jc = carried(cn, jcn.sd_controlnet_params_from_torch(_np_sd(cn), SD_CN_PLAN),
                     from_jax.sd_controlnet_state_dict)
    text, jt = _tower(SD_TEXT, 4)
    (enc, je), (dec, jd) = tiny_vae(6)
    jp = jpipe.SDPipeline(unet=ju, text_encoder=jt, vae_encoder=je, vae_decoder=jd,
                          plan=SD_PLAN, text_cfg=_jcfg(SD_TEXT), groups=4,
                          vae_enc_plan=tvae.TINY_SD_VAE_ENCODER_PLAN,
                          vae_dec_plan=tvae.TINY_SD_VAE_DECODER_PLAN, vae_groups=4)
    tp = tpipe.SDPipeline(unet=unet, text_encoder=text, vae_encoder=enc, vae_decoder=dec,
                          text_cfg=SD_TEXT, groups=4, vae_groups=4)
    return jp, tp, (jc, cn), _ip(SD_PLAN, 32, 8)


@pytest.fixture(scope="module")
def xl_pipes():
    unet = _perturb(tsx.init_sdxl_unet(XL_PLAN, _gen(10), device="cpu", model_dim=8,
                                       time_dim=16, add_embed_in=16 + 6 * 256), 11)
    unet, ju = carried(unet, jsx.sdxl_unet_params_from_torch(_np_sd(unet), XL_PLAN),
                       from_jax.sd_unet_state_dict)
    cn = _perturb(tcn.init_sdxl_controlnet(XL_CN_PLAN, _gen(12), device="cpu", model_dim=8,
                                           time_dim=16, add_text_dim=16,
                                           cond_channels=(3, 4, 4, 6, 6)), 13)
    cn, jc = carried(cn, jcn.sdxl_controlnet_params_from_torch(_np_sd(cn), XL_CN_PLAN),
                     from_jax.sd_controlnet_state_dict)
    jc["cn_transformer"]["n_head"] = 8      # a Python int, as JAX's converter gives it
    t1, j1 = _tower(XL_TEXT1, 14, final_norm=False)
    t2, j2 = _tower(XL_TEXT2, 16, projection=True, proj_dim=XL_TEXT2.text_dim)
    (enc, je), (dec, jd) = tiny_vae(18)
    jp = jxpipe.SDXLPipeline(unet=ju, text_encoder=j1, text_encoder_2=j2, vae_decoder=jd,
                             vae_encoder=je, vae_enc_plan=tvae.TINY_SD_VAE_ENCODER_PLAN,
                             plan=XL_PLAN, text_cfg=_jcfg(XL_TEXT1), text2_cfg=_jcfg(XL_TEXT2),
                             groups=4, vae_dec_plan=tvae.TINY_SD_VAE_DECODER_PLAN,
                             vae_groups=4)
    tp = txpipe.SDXLPipeline(unet=unet, text_encoder=t1, text_encoder_2=t2, vae_decoder=dec,
                             vae_encoder=enc, text_cfg=XL_TEXT1, text2_cfg=XL_TEXT2, groups=4,
                             vae_groups=4)
    return jp, tp, (jc, cn), _ip(XL_PLAN, 24, 20)


def _regional(h, w):
    mask = np.zeros((h, w), np.float32)
    mask[:, w // 2:] = 1.0
    return dict(local_prompts=["a blue cup"], masks=[mask], mask_scales=[0.7],
                local_blur_kernel_size=3, local_blur_sigma=1.0)


@pytest.mark.parametrize("family", ["sd", "sdxl"])
@pytest.mark.parametrize("case", ["long_prompt", "i2i_regional_ipadapter", "tiled"])
def test_pipeline_matches_jax(sd_pipes, xl_pipes, family, case):
    """long_prompt: CFG 4.0, 2 steps at 128x128 (16x16 latents), the prompt 2 sentences
    and the negative 1 (its keys past 12 masked); SDXL adds the union ControlNet (task 1)
    and its condition image. i2i_regional_ipadapter: strength 0.6 (SD's image in [0, 255],
    SDXL's in [0, 1]), a local prompt (blur 3 / 1.0), the IP-Adapter at scale 0.8 from a
    (1, 12) embedding, 3 steps, hash ids. tiled: image-to-image at strength 0.8, 2 steps;
    SDXL: tiles of 8 latents at stride 4 for the UNet's transformer blocks and the decode
    (3 x 3), the encode on 64-pixel tiles at stride 32 (9, batched); SD (with its
    ControlNet): tiles of 16 at stride 8, so its encode runs on 225 16-pixel tiles in
    batches (the UNet's tiling has its own test in test_torch_sd_unet.py)."""
    jp, tp, (jcn_p, cn), (ipm, ipp) = sd_pipes if family == "sd" else xl_pipes
    rng = np.random.default_rng(30)
    kw = dict(prompt="a red ball", negative_prompt="blurry", cfg_scale=4.0, height=128,
              width=128, num_inference_steps=2, seed=3)
    jkw, tkw = {}, {}
    if case == "long_prompt":
        kw["prompt"] = LONG
        if family == "sd":
            jp = dataclasses.replace(jp, tokenize=jprompt.sd_clip_tokenizer(12))
            tp = dataclasses.replace(tp, tokenize=tprompt.sd_clip_tokenizer(12))
        else:
            (j1, j2), (t1, t2) = jprompt.sdxl_tokenizers(12), tprompt.sdxl_tokenizers(12)
            jp = dataclasses.replace(jp, tokenize=j1, tokenize_2=j2)
            tp = dataclasses.replace(tp, tokenize=t1, tokenize_2=t2)
            kw["controlnet_image"] = rng.uniform(size=(128, 128, 3)).astype(np.float32)
            jkw["controlnet"] = {"params": jcn_p, "plan": XL_CN_PLAN, "task_id": 1}
            tkw["controlnet"] = {"model": cn, "task_id": 1}
        assert len(tp._long_ids([LONG, "blurry"])[0][0]) == 2
    elif case == "i2i_regional_ipadapter":
        img = rng.uniform(size=(128, 128, 3)).astype(np.float32)
        emb = rng.normal(size=(1, 12)).astype(np.float32)
        kw.update(input_image=img * 255.0 if family == "sd" else img, denoising_strength=0.6,
                  num_inference_steps=3, ipadapter_image_emb=emb, ipadapter_scale=0.8,
                  **_regional(128, 128))
        jkw["ipadapter"], tkw["ipadapter"] = ipp, ipm
    else:
        # image-to-image too: SD encodes tile_size-pixel tiles (225 of 16, in batches),
        # SDXL tile_size x 8 ones (9 of 64)
        img = rng.uniform(size=(128, 128, 3)).astype(np.float32)
        kw.update(tiled=True, tile_size=16 if family == "sd" else 8,
                  tile_stride=8 if family == "sd" else 4, denoising_strength=0.8,
                  input_image=img * 255.0 if family == "sd" else img)
        if family == "sd":
            kw["controlnet_image"] = rng.uniform(size=(128, 128, 3)).astype(np.float32)
            jkw["controlnet"] = {"params": jcn_p, "plan": SD_CN_PLAN}
            tkw["controlnet"] = {"model": cn}
    want = jp(**kw, **jkw)
    got = tp(**kw, **tkw, noise=_noise(3, (1, 16, 16, 4)))
    assert got.shape == want.shape == (128, 128, 3)
    np.testing.assert_allclose(got, want, **TOL)


def _hf_text(sd, pre="cond_stage_model.transformer.text_model."):
    """The SD text tower's state dict under the HF CLIP names of a civitai bundle."""
    out = {pre + "embeddings.token_embedding.weight": sd["token_embedding.weight"],
           pre + "embeddings.position_embedding.weight": sd["position_embeds"][0],
           pre + "final_layer_norm.weight": sd["final_layer_norm.weight"],
           pre + "final_layer_norm.bias": sd["final_layer_norm.bias"]}
    names = (("layer_norm1", "layer_norm1"), ("layer_norm2", "layer_norm2"),
             ("self_attn.q_proj", "attn.to_q"), ("self_attn.k_proj", "attn.to_k"),
             ("self_attn.v_proj", "attn.to_v"), ("self_attn.out_proj", "attn.to_out"),
             ("mlp.fc1", "fc1"), ("mlp.fc2", "fc2"))
    for i in range(SD_TEXT.text_layers):
        for hf, ref in names:
            for w in ("weight", "bias"):
                out[f"{pre}encoder.layers.{i}.{hf}.{w}"] = sd[f"encoders.{i}.{ref}.{w}"]
    return out


def test_sd_pipeline_from_civitai_bundle(sd_pipes):
    """One synthetic bundle: the tiny UNet under ``model.diffusion_model.``, the text
    tower under ``cond_stage_model.transformer.text_model.``, random VAE halves under
    ``first_stage_model.``. Every module of the port's pipeline equals JAX's civitai
    converters' trees carried back, bit for bit; ``load_model`` refuses the bundle with
    JAX's ValueError (the pipeline reads it by prefix)."""
    from goal_force_tpu_torch.io import auto as tauto
    from test_torch_flux import _ldm_vae
    from test_torch_sd_unet import _civitai_names
    from zoo_ckpts import TINY_VAE_DEC_PLAN, TINY_VAE_ENC_PLAN

    _, tp, _, _ = sd_pipes
    rng = np.random.default_rng(40)
    enc_plan, dec_plan = TINY_VAE_ENC_PLAN, TINY_VAE_DEC_PLAN    # with an LDM mid section
    bundle = {**_civitai_names(_np_sd(tp.unet), SD_PLAN), **_hf_text(_np_sd(tp.text_encoder)),
              **_ldm_vae(enc_plan, True, rng), **_ldm_vae(dec_plan, False, rng)}
    pipe = tpipe.sd_pipeline_from_civitai(bundle, device="cpu", plan=SD_PLAN, groups=4,
                                          text_cfg=SD_TEXT, vae_plans=(enc_plan, dec_plan, 4))
    wants = {"unet": from_jax.sd_unet_state_dict(jsu.sd_unet_params_from_civitai(bundle, SD_PLAN)),
             "text_encoder": from_jax.clip_text_state_dict(
                 jsd.sd_text_params_from_civitai(bundle, _jcfg(SD_TEXT))),
             "vae_encoder": from_jax.sd_vae_state_dict(
                 jvae.sd_vae_encoder_params_from_civitai(bundle, enc_plan)),
             "vae_decoder": from_jax.sd_vae_state_dict(
                 jvae.sd_vae_decoder_params_from_civitai(bundle, dec_plan))}
    for name, want in wants.items():
        got = getattr(pipe, name).state_dict()
        assert sorted(got) == sorted(want), name
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=f"{name} {k}")
    assert jdetect.detect_model_kind(bundle) == "sd_civitai"
    with pytest.raises(ValueError, match="sd_civitai"):
        tauto.load_model(bundle, device="cpu")


@pytest.mark.parametrize("pipeline", ["sd", "sdxl", "kolors"])
def test_entry_points_need_cuda_unless_cpu_is_asked(pipeline):
    """``init_random`` runs on the card by default and raises without one; with
    device="cpu" it builds JAX's tiny pipeline on the CPU."""
    import torch

    from goal_force_tpu_torch.pipelines import kolors as tkpipe

    cls = {"sd": tpipe.SDPipeline, "sdxl": txpipe.SDXLPipeline,
           "kolors": tkpipe.KolorsPipeline}[pipeline]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cls.init_random()
    pipe = cls.init_random(device="cpu")
    assert pipe.device.type == "cpu" and pipe.unet.plan == pipe.plan
