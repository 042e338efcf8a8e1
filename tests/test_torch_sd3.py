"""SD3 / SD3.5 and the SDXL CLIP towers in the port against the JAX package, at tiny
configs: both SDXL towers (clip_skip 1 and 2) and their civitai converters, the SD3 DiT
with and without dual blocks and RMS norms, ``load_model``'s new kinds, three pipeline
requests (merged CFG; image-to-image with ``tiled=True``; regional prompting) and
``from_pretrained``.

Weights are the port's random ones, offset so that no bias or norm weight is trivial; JAX
reads them through its own converters, and the port's modules are loaded from the JAX
trees carried back by ``io/from_jax.py`` (which must give the same state dicts bit for
bit). JAX's noise is passed in. float32 limits: XLA and torch round the same matmuls and
reductions differently (~1e-6 relative per op): the towers agree to ~1e-6 (limit 1e-4 x
1e-4 relative), the DiT and a few Euler steps to ~1e-6 (limit 5e-4 x 1e-3 relative), as
the Flux tests. JAX's side is jitted."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from goal_force_tpu.io import auto as jauto
from goal_force_tpu.io.torch_convert import t5_params_from_torch
from goal_force_tpu.models import sd3_dit as jdit
from goal_force_tpu.models import sd_text_encoder as jsd
from goal_force_tpu.models import sd_vae as jvae
from goal_force_tpu.pipelines import sd3 as jpipe

from goal_force_tpu_torch.io import auto as tauto
from goal_force_tpu_torch.io import from_jax
from goal_force_tpu_torch.models import clip as tclip
from goal_force_tpu_torch.models import sd3_dit as tdit
from goal_force_tpu_torch.models import sd_text_encoder as tsd
from goal_force_tpu_torch.models import t5 as tt5
from goal_force_tpu_torch.pipelines import sd3 as tpipe

from zoo_ckpts import TINY_VAE_DEC_PLAN, TINY_VAE_ENC_PLAN, build_sd3_vae_pair

F32 = dict(rtol=1e-4, atol=1e-4)
DIT_TOL = dict(rtol=1e-3, atol=5e-4)
DIT_CFG, T5_CFG, CLIP1_CFG, CLIP2_CFG = tpipe.tiny_sd3_configs()
JDIT_CFG, JT5_CFG, JCLIP1_CFG, JCLIP2_CFG = jpipe.tiny_sd3_configs()
# SDXL's first tower at a tiny width: CLIP-L's layout cut to 3 layers, no final LN
SDXL1_CFG = dataclasses.replace(tsd.SDXL_TEXT_CONFIG, text_dim=16, text_heads=2, text_layers=3)
JSDXL1_CFG = dataclasses.replace(jsd.SDXL_TEXT_CONFIG, text_dim=16, text_heads=2, text_layers=3)
BIGG_CFG = dataclasses.replace(CLIP2_CFG, text_layers=3)
JBIGG_CFG = dataclasses.replace(JCLIP2_CFG, text_layers=3)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _perturb(model, seed):
    gen = _gen(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.05)
    return model


def _np_sd(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _carried(model, tree, convert):
    """The port's module rebuilt from the JAX tree through ``from_jax`` (which must give
    the module's own state dict back bit for bit), and the tree as JAX arrays."""
    sd = convert(jax.tree_util.tree_map(np.asarray, tree))
    own = model.state_dict()
    assert sorted(sd) == sorted(own)
    for k, v in own.items():
        np.testing.assert_array_equal(sd[k].numpy(), v.numpy(), err_msg=k)
    model.load_state_dict(sd, strict=True)
    return model, _jnp(tree)


def _dit(cfg, seed):
    model = _perturb(tdit.init_sd3_dit(cfg, _gen(seed), torch.float32, device="cpu"), seed + 1)
    # a position table that is not zero, so the centre crop shows
    with torch.no_grad():
        model.pos_embedder.pos_embed.normal_(generator=_gen(seed + 2))
    jcfg = jdit.SD3DiTConfig(**dataclasses.asdict(cfg))
    return _carried(model, jdit.sd3_dit_params_from_torch(_np_sd(model), jcfg),
                    from_jax.sd3_dit_state_dict)


def _clip(cfg, seed, **kw):
    model = _perturb(tclip.init_clip_text(cfg, _gen(seed), device="cpu", **kw), seed + 1)
    sd = _np_sd(model)
    if kw.get("projection"):
        tree = jsd.sdxl_text_params_from_torch(sd, cfg, with_projection=True)
    elif not kw.get("final_norm", True):
        tree = jsd.sdxl_text_params_from_torch(sd, cfg)
    else:
        tree = jsd.sd_text_params_from_torch(sd, cfg)
    return _carried(model, tree, from_jax.clip_text_state_dict)


@pytest.fixture(scope="module")
def models():
    """(port module, JAX params) of the tiny DiT, both CLIP towers, T5 and the SD3 VAE."""
    enc_sd, dec_sd, _ = build_sd3_vae_pair(seed=3)
    t5 = _perturb(tt5.init_t5(T5_CFG, _gen(6), torch.float32, device="cpu"), 7)
    load = lambda sd, plan: tauto.load_model(sd, dtype=torch.float32, device="cpu",
                                             plan=plan)["model"]
    return {
        "dit": _dit(DIT_CFG, 0),
        "clip1": _clip(CLIP1_CFG, 4),
        "clip2": _clip(CLIP2_CFG, 8, projection=True, proj_dim=CLIP2_CFG.text_dim),
        "t5": (t5, _jnp(t5_params_from_torch(_np_sd(t5), JT5_CFG))),
        "enc": (load(enc_sd, TINY_VAE_ENC_PLAN),
                _jnp(jvae.sd3_vae_encoder_params_from_torch(enc_sd, TINY_VAE_ENC_PLAN))),
        "dec": (load(dec_sd, TINY_VAE_DEC_PLAN),
                _jnp(jvae.sd3_vae_decoder_params_from_torch(dec_sd, TINY_VAE_DEC_PLAN))),
    }


def test_configs_equal_jax():
    for a, b in zip(tpipe.tiny_sd3_configs(), jpipe.tiny_sd3_configs()):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for name in ("SDXL_TEXT_CONFIG", "SDXL_TEXT2_CONFIG", "SD_TEXT_CONFIG"):
        assert dataclasses.asdict(getattr(tsd, name)) == dataclasses.asdict(getattr(jsd, name))
    assert dataclasses.asdict(tdit.SD3DiTConfig()) == dataclasses.asdict(jdit.SD3DiTConfig())
    for cfg, dim, depth, dual, pos in ((tdit.SD35_LARGE, 2432, 38, 0, 192),
                                       (tdit.SD35_MEDIUM, 1536, 24, 13, 384)):
        assert (cfg.dim, cfg.num_layers, cfg.num_dual_blocks, cfg.pos_embed_max_size,
                cfg.num_heads, cfg.head_dim, cfg.use_rms_norm) == (dim, depth, dual, pos,
                                                                   dim // 64, 64, True)


@pytest.mark.parametrize("clip_skip", [1, 2])
def test_sdxl_towers_match_jax(clip_skip):
    """The first tower's raw states (no final LN) and bigG's (pooled, hidden) on B = 2
    rows of 77 ids whose argmax sits at different positions; clip_skip 1 runs every
    layer, 2 stops one early (tower 1) or records the states one layer from the end
    (bigG)."""
    rng = np.random.default_rng(30 + clip_skip)
    ids = rng.integers(1, 1000, size=(2, 77))
    ids[0, 9], ids[1, 40] = 49407, 49407
    t1, p1 = _clip(SDXL1_CFG, 32, final_norm=False)
    t2, p2 = _clip(BIGG_CFG, 34, projection=True, proj_dim=BIGG_CFG.text_dim)
    assert not hasattr(t1, "final_layer_norm")
    want1 = jax.jit(lambda p, x: jsd.sdxl_text_encode(p, x, JSDXL1_CFG, clip_skip))(p1, ids)
    want2 = jax.jit(lambda p, x: jsd.sdxl_text2_encode(p, x, JBIGG_CFG, clip_skip))(p2, ids)
    got1 = tsd.sdxl_text_encode(t1, _t(ids), SDXL1_CFG, clip_skip)
    got2 = tsd.sdxl_text2_encode(t2, _t(ids), BIGG_CFG, clip_skip)
    np.testing.assert_allclose(got1.detach().numpy(), np.asarray(want1), **F32)
    for a, b in zip(got2, want2):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **F32)


def _civitai(tower, rng):
    """A bundled SDXL checkpoint's tower at the tiny widths (one layer past the config and
    a final LN in tower 1, as the released 12-layer CLIP-L carries)."""
    sd = {}
    put = lambda k, *shape: sd.__setitem__(k, rng.normal(size=shape).astype(np.float32))
    if tower == 1:
        pre, d = "conditioner.embedders.0.transformer.text_model.", SDXL1_CFG.text_dim
        put(pre + "embeddings.token_embedding.weight", 64, d)
        put(pre + "embeddings.position_embedding.weight", 77, d)
        for i in range(SDXL1_CFG.text_layers + 1):
            b = f"{pre}encoder.layers.{i}."
            for name, shape in (("layer_norm1", (d,)), ("layer_norm2", (d,)),
                                ("self_attn.q_proj", (d, d)), ("self_attn.k_proj", (d, d)),
                                ("self_attn.v_proj", (d, d)), ("self_attn.out_proj", (d, d)),
                                ("mlp.fc1", (4 * d, d)), ("mlp.fc2", (d, 4 * d))):
                put(b + name + ".weight", *shape)
                put(b + name + ".bias", shape[0])
        put(pre + "final_layer_norm.weight", d)
        put(pre + "final_layer_norm.bias", d)
        return sd
    pre, d = "conditioner.embedders.1.model.", BIGG_CFG.text_dim
    put(pre + "token_embedding.weight", 64, d)
    put(pre + "positional_embedding", 77, d)
    put(pre + "text_projection", d, d)
    put(pre + "ln_final.weight", d)
    put(pre + "ln_final.bias", d)
    for i in range(BIGG_CFG.text_layers):
        b = f"{pre}transformer.resblocks.{i}."
        for name, shape in (("attn.in_proj", (3 * d, d)), ("attn.out_proj", (d, d)),
                            ("ln_1", (d,)), ("ln_2", (d,)), ("mlp.c_fc", (4 * d, d)),
                            ("mlp.c_proj", (d, 4 * d))):
            put(b + name + "_weight" if name == "attn.in_proj" else b + name + ".weight",
                *shape)
            put(b + name + "_bias" if name == "attn.in_proj" else b + name + ".bias", shape[0])
    return sd


@pytest.mark.parametrize("tower", [1, 2])
def test_sdxl_civitai_converters_match_jax(tower):
    """A bundled checkpoint's tower renamed by the port equals JAX's civitai converter's
    tree carried back by ``from_jax``, key for key and bit for bit, and loads strictly as
    its kind."""
    sd = _civitai(tower, np.random.default_rng(40 + tower))
    if tower == 1:
        tree = jsd.sdxl_text_params_from_civitai(sd, JSDXL1_CFG)
        got = tsd.sdxl_text_state_dict_from_civitai({k: _t(v) for k, v in sd.items()},
                                                    SDXL1_CFG)
    else:
        tree = jsd.sdxl_text2_params_from_civitai(sd, JBIGG_CFG)
        got = tsd.sdxl_text2_state_dict_from_civitai({k: _t(v) for k, v in sd.items()},
                                                     BIGG_CFG)
    want = from_jax.clip_text_state_dict(tree)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    r = tauto.load_model(got, dtype=torch.float32, device="cpu", num_heads=2)
    assert r["kind"] == "clip_text" and r["config"].text_layers == 3


@pytest.mark.parametrize("case", ["dual_rms", "plain"])
def test_sd3_dit_matches_jax(models, case):
    """B = 2 rows at different timesteps on an 8x12 latent (24 image tokens, the image
    stream first, then 5 text tokens), the position table cropped from 16x16. dual_rms:
    the tiny SD3.5-Medium-shaped config (a dual block, RMS q/k norms, the final block);
    plain: SD3-Medium's kind (no dual block, no norms)."""
    if case == "dual_rms":
        (model, params), cfg = models["dit"], DIT_CFG
    else:
        cfg = dataclasses.replace(DIT_CFG, num_dual_blocks=0, use_rms_norm=False)
        model, params = _dit(cfg, 20)
    jcfg = jdit.SD3DiTConfig(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(11)
    lat = rng.normal(size=(2, 8, 12, 16)).astype(np.float32)
    t = np.array([900.0, 350.0], np.float32)
    txt = rng.normal(size=(2, 5, cfg.text_dim)).astype(np.float32)
    pooled = rng.normal(size=(2, cfg.pooled_dim)).astype(np.float32)
    want = jax.jit(lambda p, *a: jdit.sd3_dit_forward(p, jcfg, *a))(params, lat, t, txt, pooled)
    got = tdit.sd3_dit_forward(model, cfg, *(_t(a) for a in (lat, t, txt, pooled)))
    assert got.shape == lat.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **DIT_TOL)



def test_remat_keeps_the_forward_and_its_gradients(models):
    """remat=True (a checkpoint per block, the final block too) gives the same velocity
    and the same weight gradients as the plain forward, as JAX's ``jax.checkpoint``
    does."""
    model, _ = models["dit"]
    rng = np.random.default_rng(23)
    args = [_t(a.astype(np.float32)) for a in (
        rng.normal(size=(1, 8, 12, 16)), np.array([500.0]),
        rng.normal(size=(1, 5, DIT_CFG.text_dim)), rng.normal(size=(1, DIT_CFG.pooled_dim)))]
    w = model.blocks[0].attn2.a_to_qkv.weight       # the dual block's second attention
    w.requires_grad_(True)
    try:
        outs = [tdit.sd3_dit_forward(model, DIT_CFG, *args, remat=r) for r in (False, True)]
        grads = [torch.autograd.grad(o.square().sum(), w)[0] for o in outs]
    finally:
        w.requires_grad_(False)
    np.testing.assert_array_equal(outs[0].detach().numpy(), outs[1].detach().numpy())
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(), rtol=1e-6, atol=1e-7)

def test_load_model_kinds_give_jax_configs(models):
    """sd3_dit, and clip_text as bigG (with its projection) and as SDXL's first tower (no
    final LN): the configs equal JAX's, the weights load strictly, and sd3_dit is out of
    the refusal table."""
    assert "sd3_dit" not in tauto.ROADMAP_ITEMS
    t1, _ = _clip(SDXL1_CFG, 50, final_norm=False)
    files = {"sd3_dit": (_np_sd(models["dit"][0]), {}),
             "bigg": (_np_sd(models["clip2"][0]), dict(num_heads=2)),
             "sdxl1": (_np_sd(t1), dict(num_heads=2))}
    for name, (sd, kw) in files.items():
        want = jauto.load_model(sd, **kw)
        got = tauto.load_model(sd, dtype=torch.float32, device="cpu", **kw)
        assert got["kind"] == want["kind"] == ("sd3_dit" if name == "sd3_dit" else "clip_text")
        assert dataclasses.asdict(got["config"]) == dataclasses.asdict(want["config"])
        for k, v in got["model"].state_dict().items():
            np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    assert tauto.load_model(files["sd3_dit"][0], device="cpu")["config"] == DIT_CFG


# ---------------------------------------------------------------------------
# Pipeline requests
# ---------------------------------------------------------------------------

def _noise(seed, shape):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))


@pytest.fixture(scope="module")
def pipes(models):
    (dit, jd), (c1, jc1), (c2, jc2) = models["dit"], models["clip1"], models["clip2"]
    (t5, jt5), (enc, jenc), (dec, jdec) = models["t5"], models["enc"], models["dec"]
    jp = jpipe.SD3Pipeline(dit=jd, clip1=jc1, clip2=jc2, t5=jt5, vae_encoder=jenc,
                           vae_decoder=jdec, dit_cfg=JDIT_CFG, t5_cfg=JT5_CFG,
                           clip1_cfg=JCLIP1_CFG, clip2_cfg=JCLIP2_CFG,
                           vae_enc_plan=TINY_VAE_ENC_PLAN, vae_dec_plan=TINY_VAE_DEC_PLAN,
                           vae_groups=4, vae_factor=2, dtype=jnp.float32)
    tp = tpipe.SD3Pipeline(dit=dit, clip1=c1, clip2=c2, t5=t5, vae_encoder=enc, vae_decoder=dec,
                           dit_cfg=DIT_CFG, t5_cfg=T5_CFG, clip1_cfg=CLIP1_CFG,
                           clip2_cfg=CLIP2_CFG, vae_groups=4, vae_factor=2, dtype=torch.float32)
    return jp, tp


@pytest.mark.parametrize("case", ["cfg", "i2i_tiled", "regional"])
def test_pipeline_matches_jax(pipes, case):
    """cfg: merged CFG 2.0 on hash ids (the CLIP states padded to the text width, T5's 16
    after them), 3 steps at 16x24. i2i_tiled: image-to-image at strength 0.6 from a 16x24
    image, tiled=True at tile 8, stride 4 (the encode on 16-pixel tiles at stride 8, the
    tile times the VAE factor 2; the DiT and the decode on 8-latent tiles at stride 4:
    1 x 2 tiles each).
    regional: two local prompts with masks and scales, the blur at 5 / 1.5: 4 rows in
    one forward a step."""
    jp, tp = pipes
    kw = dict(prompt="a red ball on a table", negative_prompt="blurry", cfg_scale=2.0,
              height=16, width=24, num_inference_steps=3, seed=5)
    if case == "i2i_tiled":
        img = np.random.default_rng(17).uniform(size=(16, 24, 3)).astype(np.float32)
        kw.update(input_image=img, denoising_strength=0.6, tiled=True, tile_size=8,
                  tile_stride=4)
    elif case == "regional":
        masks = [np.zeros((16, 24), np.float32), np.zeros((16, 24, 3), np.float32)]
        masks[0][:, :10] = 1.0
        masks[1][5:, 13:] = 1.0
        kw.update(local_prompts=["a red ball", "a wooden table"], masks=masks,
                  mask_scales=[1.0, 0.5], local_blur_kernel_size=5, local_blur_sigma=1.5)
    want = jp(**kw)
    got = tp(**kw, noise=_noise(5, (1, 8, 12, 16)))
    assert got.shape == want.shape == (16, 24, 3)
    np.testing.assert_allclose(got, want, **DIT_TOL)


def test_from_pretrained_reads_reference_files(models, tmp_path):
    """The DiT, CLIP-L, bigG, a T5 and the VAE halves as safetensors files:
    ``from_pretrained`` detects each kind, reads them strictly and answers as a pipeline
    built from the same modules does (hash ids without tokenizers); without a T5 its
    rows of the prompt are zeros, as in JAX."""
    from goal_force_tpu_torch.io.safetensors_io import save_safetensors

    mods = {name: models[name][0] for name in ("dit", "clip1", "clip2", "t5", "enc", "dec")}
    paths = {}
    for name, m in mods.items():
        paths[name] = str(tmp_path / f"{name}.safetensors")
        save_safetensors(m.state_dict(), paths[name])
    kw = dict(text_encoder_path=paths["clip1"], text_encoder_2_path=paths["clip2"],
              text_encoder_3_path=paths["t5"], vae_encoder_path=paths["enc"],
              vae_decoder_path=paths["dec"], tokenizer=None, tokenizer_t5=None, t5_length=16,
              vae_plans=(TINY_VAE_ENC_PLAN, TINY_VAE_DEC_PLAN, 4), dtype=torch.float32,
              clip_num_heads=2, t5_num_heads=4, device="cpu")
    pipe = tpipe.SD3Pipeline.from_pretrained(paths["dit"], **kw)
    assert pipe.dit_cfg == DIT_CFG and pipe.vae_factor == 2
    assert pipe.clip2_cfg.hidden_act == "gelu" and pipe.clip2_cfg.text_pooling == "argmax"
    want = tpipe.SD3Pipeline(dit=mods["dit"], clip1=mods["clip1"], clip2=mods["clip2"],
                             t5=mods["t5"], vae_encoder=mods["enc"], vae_decoder=mods["dec"],
                             dit_cfg=DIT_CFG, t5_cfg=T5_CFG, clip1_cfg=CLIP1_CFG,
                             clip2_cfg=CLIP2_CFG, vae_groups=4, vae_factor=2,
                             dtype=torch.float32)
    req = dict(height=16, width=24, num_inference_steps=2, noise=_noise(7, (1, 8, 12, 16)))
    np.testing.assert_array_equal(pipe("a red ball", **req), want("a red ball", **req))
    no_t5 = tpipe.SD3Pipeline.from_pretrained(paths["dit"], **{**kw, "text_encoder_3_path": None})
    emb, _ = no_t5._encode_text(["a red ball"])
    assert no_t5.t5 is None and emb.shape == (1, 77 + 16, DIT_CFG.text_dim)
    assert not emb[:, 77:].any()
