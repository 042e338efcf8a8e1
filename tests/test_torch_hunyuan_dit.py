"""HunyuanDiT (image) in the port against the JAX package, at tiny configs: the rope
tables (square, wide and tall grids), the DiT forward with its long skips (B = 2, padded
text masks), ``load_model`` through reference-named weights with
``infer_hunyuan_dit_config``, and the pipeline's requests (merged CFG; image-to-image
with the tiled encode and decode; regional prompts), with the same ``encode_prompt``
outputs given to both packages and JAX's noise passed in.

Weights are the port's random ones, offset so that no bias or norm weight is trivial; JAX
reads them through its own converters, and the port's DiT is rebuilt from the JAX tree by
``io/from_jax.py`` (which must give the same state dict bit for bit). Rope tables and
configs must be equal exactly. float32 limits: the DiT within 1e-4 x 1e-4 relative; the
requests (a few DDIM steps and the VAE) 5e-4 x 1e-3 relative, as the Flux tests. JAX's
side is jitted."""

import dataclasses
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from goal_force_tpu.io import auto as jauto
from goal_force_tpu.models import hunyuan_dit as jdit
from goal_force_tpu.models import sd_vae as jvae
from goal_force_tpu.pipelines import hunyuan_image as jpipe

from goal_force_tpu_torch.io import auto as tauto
from goal_force_tpu_torch.io import from_jax
from goal_force_tpu_torch.models import hunyuan_dit as tdit
from goal_force_tpu_torch.models import sd_vae as tvae
from goal_force_tpu_torch.pipelines import hunyuan_image as tpipe

F32 = dict(rtol=1e-4, atol=1e-4)
DIT_TOL = dict(rtol=1e-3, atol=5e-4)
CFG = dataclasses.replace(tpipe.tiny_hunyuan_dit_config(), dim=32)
JCFG = jdit.HunyuanDiTConfig(**dataclasses.asdict(CFG))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _perturb(model, seed, scale=0.05):
    gen = _gen(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * scale)
    return model


def _np_sd(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def models():
    """(port module, JAX params) of the tiny DiT and the tiny SD VAE halves."""
    dit = _perturb(tdit.init_hunyuan_dit(CFG, _gen(0), torch.float32, device="cpu"), 1)
    tree = jdit.hunyuan_dit_params_from_torch(_np_sd(dit), JCFG)
    sd = from_jax.hunyuan_dit_state_dict(jax.tree_util.tree_map(np.asarray, tree))
    own = dit.state_dict()
    assert sorted(sd) == sorted(own)
    for k, v in own.items():
        np.testing.assert_array_equal(sd[k].numpy(), v.numpy(), err_msg=k)
    dit.load_state_dict(sd, strict=True)
    enc, dec = (_perturb(m, 3 + i, 0.02) for i, m in enumerate(
        tvae.init_tiny_sd_vae(_gen(2), device="cpu")))
    jenc = jvae.sd_vae_encoder_params_from_torch(_np_sd(enc), tvae.TINY_SD_VAE_ENCODER_PLAN)
    jdec = jvae.sd_vae_decoder_params_from_torch(_np_sd(dec), tvae.TINY_SD_VAE_DECODER_PLAN)
    for m, vtree in ((enc, jenc), (dec, jdec)):
        back = from_jax.sd_vae_state_dict(jax.tree_util.tree_map(np.asarray, vtree))
        for k, v in m.state_dict().items():
            np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)
    return {"dit": (dit, _jnp(tree)), "enc": (enc, _jnp(jenc)), "dec": (dec, _jnp(jdec))}


def test_config_and_rope_tables_equal_jax():
    assert dataclasses.asdict(tdit.HunyuanDiTConfig()) == dataclasses.asdict(
        jdit.HunyuanDiTConfig())
    for args in ((64, 64, 88), (4, 6, 8), (6, 4, 16), (48, 80, 88)):
        for a, b in zip(tdit.hunyuan_dit_rope(*args), jdit.hunyuan_dit_rope(*args)):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)


def _text(rng, b):
    clip = rng.normal(size=(b, CFG.text_len, CFG.text_dim)).astype(np.float32)
    t5 = rng.normal(size=(b, CFG.t5_len, CFG.t5_dim)).astype(np.float32)
    mask = np.ones((b, CFG.text_len), np.int32)
    mask[0, 5:] = 0
    mask_t5 = np.ones((b, CFG.t5_len), np.int32)
    mask_t5[-1, 2:] = 0
    return clip, t5, mask, mask_t5


def test_dit_forward_matches_jax(models):
    """B = 2 on an 8x12 latent (24 tokens), timesteps 300 and 800, masks with padding
    (the learned padding embedding), 4 down and 2 up blocks: down outputs 0 and 1 popped
    by the up blocks."""
    (dit, jp), rng = models["dit"], np.random.default_rng(10)
    lat = rng.normal(size=(2, 8, 12, 4)).astype(np.float32)
    clip, t5, mask, mask_t5 = _text(rng, 2)
    ts = np.array([300.0, 800.0], np.float32)
    size = np.tile(np.array([[96.0, 64.0, 96.0, 64.0, 0.0, 0.0]], np.float32), (2, 1))
    want = jax.jit(lambda p, *a: jdit.hunyuan_dit_forward(p, JCFG, *a))(
        jp, lat, clip, t5, mask, mask_t5, ts, size)
    with torch.no_grad():
        got = tdit.hunyuan_dit_forward(dit, CFG, *(_t(a) for a in (lat, clip, t5, mask,
                                                                     mask_t5, ts, size)))
    assert got.shape == (2, 8, 12, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_load_model_gives_jax_config(models):
    """A reference-named file: the kind, ``infer_hunyuan_dit_config``'s config (heads
    given, as the tiny width hides them) equal JAX's, the weights load strictly, and
    hunyuan_dit is out of the refusal table."""
    assert "hunyuan_dit" not in tauto.ROADMAP_ITEMS
    sd = _np_sd(models["dit"][0])
    want = jauto.load_model(sd, num_heads=2)
    got = tauto.load_model(sd, dtype=torch.float32, device="cpu", num_heads=2)
    assert got["kind"] == want["kind"] == "hunyuan_dit"
    assert dataclasses.asdict(got["config"]) == dataclasses.asdict(want["config"])
    assert dataclasses.asdict(tauto.infer_hunyuan_dit_config(sd, 2)) == dataclasses.asdict(
        jauto.infer_hunyuan_dit_config(sd, 2))
    for k, v in got["model"].state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


# ---------------------------------------------------------------------------
# Pipeline requests
# ---------------------------------------------------------------------------

def _noise(seed, shape):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))


def _encode_np(prompt):
    """Fixed text conditioning per prompt (crc32-seeded), the masks padded by length."""
    rng = np.random.default_rng(zlib.crc32(prompt.encode()))
    clip, t5, _, _ = _text(rng, 1)
    mask = (np.arange(CFG.text_len) < 3 + len(prompt) % 5).astype(np.int32)[None]
    mask_t5 = (np.arange(CFG.t5_len) < 2 + len(prompt) % 4).astype(np.int32)[None]
    return clip, mask, t5, mask_t5


@pytest.fixture(scope="module")
def jitted():
    """JAX's pipeline runs its VAE coders eagerly (an XLA compile per op): jit them for
    the module, so the requests share their compiles."""
    mp = pytest.MonkeyPatch()
    for name in ("sd_vae_encode", "sd_vae_decode"):
        mp.setattr(jvae, name, jax.jit(getattr(jvae, name), static_argnums=(2,),
                                       static_argnames=("groups", "scaling")))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def pipes(models, jitted):
    (dit, jd), (enc, je), (dec, jde) = models["dit"], models["enc"], models["dec"]
    jp = jpipe.HunyuanImagePipeline(
        dit=jd, vae_decoder=jde, cfg=JCFG, vae_encoder=je,
        vae_enc_plan=tvae.TINY_SD_VAE_ENCODER_PLAN, vae_dec_plan=tvae.TINY_SD_VAE_DECODER_PLAN,
        vae_groups=4, encode_prompt=lambda p: tuple(jnp.asarray(a) for a in _encode_np(p)),
        dtype=jnp.float32)
    tp = tpipe.HunyuanImagePipeline(
        dit=dit, vae_decoder=dec, cfg=CFG, vae_encoder=enc, vae_groups=4,
        encode_prompt=lambda p: tuple(_t(a) for a in _encode_np(p)), dtype=torch.float32)
    return jp, tp


@pytest.mark.parametrize("case", ["cfg", "i2i_tiled", "regional"])
def test_pipeline_matches_jax(pipes, case):
    """32x48 (a 4x6 latent), 3 DDIM steps, CFG 5.0 merged. i2i_tiled: image-to-image at
    strength 0.6 from a 32x48 image, the encode in 16-pixel tiles at stride 8 and the
    decode in 2-latent tiles at stride 1. regional: two local prompts with masks, scales
    and a 3/1.0 blur (a merged batch of 4 rows)."""
    jp, tp = pipes
    kw = dict(prompt="a red ball on a wooden table", negative_prompt="blurry",
              cfg_scale=5.0, height=32, width=48, num_inference_steps=3, seed=7)
    if case == "i2i_tiled":
        img = np.random.default_rng(11).uniform(size=(32, 48, 3)).astype(np.float32)
        kw.update(input_image=img, denoising_strength=0.6, tiled=True, tile_size=2,
                  tile_stride=1)
    elif case == "regional":
        masks = [np.zeros((32, 48), np.float32), np.zeros((32, 48), np.float32)]
        masks[0][:, :20] = 1.0
        masks[1][12:, 24:] = 1.0
        kw.update(local_prompts=["a red ball", "a wooden table"], masks=masks,
                  mask_scales=[1.0, 0.5], local_blur_kernel_size=3, local_blur_sigma=1.0)
    want = jp(**kw)
    got = tp(**kw, noise=_noise(7, (1, 4, 6, 4)))
    assert got.shape == want.shape == (32, 48, 3)
    np.testing.assert_allclose(got, want, **DIT_TOL)


def test_stand_in_embeddings_and_init_random():
    """Without encode_prompt the pipeline draws seeded stand-ins (the same for the same
    prompt); init_random's tiny pipeline answers a finite request on the CPU."""
    pipe = tpipe.HunyuanImagePipeline.init_random(device="cpu")
    a, b = pipe._embeds(["a cat"]), pipe._embeds(["a cat"])
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert a[0].shape == (1, pipe.cfg.text_len, pipe.cfg.text_dim)
    img = pipe("a cat", height=16, width=16, num_inference_steps=2,
               noise=_noise(1, (1, 2, 2, 4)))
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()


def test_from_pretrained_reads_reference_files(models, tmp_path):
    """The DiT, a BERT tower, mT5's encoder and the SD VAE halves as safetensors files:
    ``from_pretrained`` reads each strictly and answers a request as a pipeline built
    from the same modules through ``make_prompt_encoder`` does."""
    from goal_force_tpu_torch.configs import T5Config
    from goal_force_tpu_torch.io.safetensors_io import save_safetensors
    from goal_force_tpu_torch.models import t5 as tt5
    from goal_force_tpu_torch.models import text_encoders as tte

    bert_cfg = tte.BertConfig(hidden_size=CFG.text_dim, num_layers=1, num_heads=2,
                              intermediate_size=16, vocab=50, max_positions=16)
    t5_cfg = T5Config(vocab=64, dim=CFG.t5_dim, dim_attn=CFG.t5_dim, dim_ffn=24, num_heads=2,
                      num_layers=1, shared_pos=True, text_len=CFG.t5_len)
    bert = _perturb(tte.init_bert(bert_cfg, _gen(30), device="cpu"), 31)
    t5 = _perturb(tt5.init_t5(t5_cfg, _gen(32), torch.float32, device="cpu"), 33)
    (dit, _), (enc, _), (dec, _) = models["dit"], models["enc"], models["dec"]
    paths = {}
    for name, mod in (("dit", dit), ("bert", bert), ("t5", t5), ("enc", enc), ("dec", dec)):
        paths[name] = str(tmp_path / f"{name}.safetensors")
        save_safetensors(mod.state_dict(), paths[name])
    tokenize = lambda text: [(3 + len(w)) % 50 for w in text.split()][:CFG.text_len] + \
        [0] * max(0, CFG.text_len - len(text.split()))
    pipe = tpipe.HunyuanImagePipeline.from_pretrained(
        paths["dit"], bert_path=paths["bert"], t5_path=paths["t5"],
        vae_decoder_path=paths["dec"], vae_encoder_path=paths["enc"], tokenizer=tokenize,
        vae_plans=(tvae.TINY_SD_VAE_ENCODER_PLAN, tvae.TINY_SD_VAE_DECODER_PLAN),
        vae_groups=4, dtype=torch.float32, device="cpu", num_heads=2, bert_num_heads=2,
        t5_num_heads=2)
    want = tpipe.HunyuanImagePipeline(
        dit=dit, vae_decoder=dec, cfg=pipe.cfg, vae_encoder=enc, vae_groups=4,
        dtype=torch.float32, encode_prompt=tpipe.make_prompt_encoder(
            pipe.cfg, bert, bert_cfg, tokenize, t5, t5_cfg))
    req = dict(prompt="a red ball", negative_prompt="blurry", height=32, width=48,
               num_inference_steps=2, noise=_noise(8, (1, 4, 6, 4)))
    np.testing.assert_array_equal(pipe(**req), want(**req))
