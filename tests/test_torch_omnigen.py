"""OmniGen in the port against the JAX package, at tiny configs: Phi-3's LongRoPE tables
(short and long factors either side of a small ``original_max_positions``, and none), the
2D position embedding, the attention mask with reference spans, ``phi3_run`` with and
without a cached prefix, a cached denoising step against the same step uncached,
``load_model`` with ``infer_omnigen_config``, and the pipeline's requests (without a
reference image: two branches; with one: three; image-to-image, tiled), the condition
cache on, JAX's noise passed in.

Weights are the port's random ones, offset so that no bias or norm weight is trivial; JAX
reads them through its own converters, and the port's model is rebuilt from the JAX tree
by ``io/from_jax.py`` (which must give the same state dict bit for bit). Rope tables,
position embeddings, masks and configs must be equal exactly. The test config's window
is 32 positions with factors given, so the requests cross it: without a reference the
sequence is 29 tokens (short factors), with one 33 (long). float32 limits: the stack and
a step within 1e-4 x 1e-4 relative, a cached step against the uncached one in the port
within 1e-5; the requests 5e-4 x 1e-3 relative, as the Flux tests. JAX's side is
jitted."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from goal_force_tpu.io import auto as jauto
from goal_force_tpu.models import omnigen as jom
from goal_force_tpu.models import sd_vae as jvae
from goal_force_tpu.pipelines import omnigen_image as jpipe

from goal_force_tpu_torch.io import auto as tauto
from goal_force_tpu_torch.io import from_jax
from goal_force_tpu_torch.models import omnigen as tom
from goal_force_tpu_torch.models import sd_vae as tvae
from goal_force_tpu_torch.pipelines import omnigen_image as tpipe

F32 = dict(rtol=1e-4, atol=1e-4)
DIT_TOL = dict(rtol=1e-3, atol=5e-4)
SHORT, LONG = (1.0, 1.5, 2.5, 4.0), (1.2, 3.0, 6.0, 12.0)
CFG = dataclasses.replace(tpipe.tiny_omnigen_config(), original_max_positions=32,
                          max_positions=128, rope_short_factor=SHORT, rope_long_factor=LONG)
JCFG = jom.OmniGenConfig(**dataclasses.asdict(CFG))


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
    """(port module, JAX params) of the tiny OmniGen and the tiny SD VAE halves."""
    tf = _perturb(tom.init_omnigen(CFG, _gen(0), torch.float32, device="cpu"), 1)
    tree = jom.omnigen_params_from_torch(_np_sd(tf), JCFG)
    sd = from_jax.omnigen_state_dict(jax.tree_util.tree_map(np.asarray, tree))
    own = tf.state_dict()
    assert sorted(sd) == sorted(own)
    for k, v in own.items():
        np.testing.assert_array_equal(sd[k].numpy(), v.numpy(), err_msg=k)
    tf.load_state_dict(sd, strict=True)
    enc, dec = (_perturb(m, 3 + i, 0.02) for i, m in enumerate(
        tvae.init_tiny_sd_vae(_gen(2), device="cpu")))
    jenc = jvae.sd_vae_encoder_params_from_torch(_np_sd(enc), tvae.TINY_SD_VAE_ENCODER_PLAN)
    jdec = jvae.sd_vae_decoder_params_from_torch(_np_sd(dec), tvae.TINY_SD_VAE_DECODER_PLAN)
    return {"tf": (tf, _jnp(tree)), "enc": (enc, _jnp(jenc)), "dec": (dec, _jnp(jdec))}


def test_rope_pos_embed_and_mask_equal_jax():
    """The LongRoPE tables at 20 and 31 tokens (short factors), 33 and 40 (long), without
    factors, and at the released window's edges; the position embedding's centre crops;
    the mask with two reference spans."""
    assert dataclasses.asdict(tom.OmniGenConfig()) == dataclasses.asdict(jom.OmniGenConfig())
    plain = dataclasses.replace(CFG, rope_short_factor=None, rope_long_factor=None)
    released = tom.OmniGenConfig()
    for cfg, lens in ((CFG, (20, 31, 32, 33, 40)), (plain, (20, 40)), (released, (4096, 4097))):
        jcfg = jom.OmniGenConfig(**dataclasses.asdict(cfg))
        for n in lens:
            for a, b in zip(tom._su_rope_tables(cfg, n), jom._su_rope_tables(jcfg, n)):
                assert a.dtype == b.dtype == np.float32
                np.testing.assert_array_equal(a, b)
    assert not np.array_equal(tom._su_rope_tables(CFG, 32)[0][:20],
                              tom._su_rope_tables(CFG, 33)[0][:20])
    for hw in ((8, 8), (4, 12), (16, 6)):
        np.testing.assert_array_equal(tom.cropped_pos_embed(CFG, *hw),
                                      np.asarray(jom.cropped_pos_embed(JCFG, *hw)))
    for args in ((6, 4, ()), (10, 9, ((2, 5), (6, 9)))):
        np.testing.assert_array_equal(tpipe.omnigen_attention_mask(*args),
                                      jpipe.omnigen_attention_mask(*args))


def _mask(n_text, n_img, spans=()):
    return tpipe.omnigen_attention_mask(n_text, n_img, spans)


def test_phi3_run_with_and_without_the_cache_matches_jax(models):
    """B = 1, 36 tokens (long factors): the whole sequence keeping a 20-token prefix,
    then the last 16 tokens against that prefix with their rows of the mask and their
    absolute positions; each against JAX, and the cached rows against the whole run's."""
    (tf, jp), rng = models["tf"], np.random.default_rng(10)
    x = rng.normal(size=(1, 36, CFG.hidden_size)).astype(np.float32)
    mask = _mask(19, 16, ((3, 8),))
    pos = np.arange(36)[None]
    want, want_pre = jax.jit(lambda p, e, m, q: jom.phi3_run(p, JCFG, e, m, q, keep_prefix=20))(
        jp, x, mask, pos)
    want_c = jax.jit(lambda p, e, m, q, kv: jom.phi3_run(p, JCFG, e, m, q, past_kv=kv))(
        jp, x[:, 20:], mask[:, 20:], pos[:, 20:], want_pre)
    with torch.no_grad():
        got, pre = tom.phi3_run(tf.llm, CFG, _t(x), _t(mask), _t(pos), keep_prefix=20)
        got_c = tom.phi3_run(tf.llm, CFG, _t(x[:, 20:]), _t(mask[:, 20:]), _t(pos[:, 20:]),
                             past_kv=pre)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    for (k, v), (jk, jv) in zip(pre, want_pre):
        np.testing.assert_allclose(k.numpy(), np.asarray(jk), **F32)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), **F32)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), **F32)
    np.testing.assert_allclose(got_c.numpy(), got[:, 20:].numpy(), rtol=1e-5, atol=1e-5)


def test_cached_step_equals_the_uncached_step(models):
    """omnigen_forward on an 8x8 latent (16 image tokens) behind 16 ids with a 4-token
    reference span (a 4x4 reference latent): a first call at t = 0.2 keeps the prefix; a
    second at t = 0.7 on new latents through the cache (the time token and the image
    only) equals the same call uncached, and JAX's cached call."""
    (tf, jp), rng = models["tf"], np.random.default_rng(11)
    ids = rng.integers(2, CFG.vocab, (1, 16))
    ref = rng.normal(size=(1, 4, 4, 4)).astype(np.float32)
    lat1, lat2 = (rng.normal(size=(1, 8, 8, 4)).astype(np.float32) for _ in range(2))
    mask = _mask(16, 16, ((4, 8),))
    pos = np.arange(33)[None]
    slices, crop = [(0, 4, 8)], slice(-17, None)
    t1, t2 = np.array([0.2], np.float32), np.array([0.7], np.float32)
    with torch.no_grad():
        full = lambda lat, t, keep: tom.omnigen_forward(
            tf, CFG, _t(lat), _t(t), _t(ids), _t(mask), [_t(ref)], slices, _t(pos),
            return_past_kv=keep)
        _, kv = full(lat1, t1, True)
        cached = tom.omnigen_forward(tf, CFG, _t(lat2), _t(t2), None, _t(mask[:, crop]),
                                     position_ids=_t(pos[:, crop]), past_kv=kv)
        uncached = full(lat2, t2, False)
    jfull = jax.jit(lambda p, lat, t: jom.omnigen_forward(
        p, JCFG, lat, t, ids, mask, [ref], slices, pos, return_past_kv=True))
    _, jkv = jfull(jp, lat1, t1)
    want = jax.jit(lambda p, lat, t, kv: jom.omnigen_forward(
        p, JCFG, lat, t, None, mask[:, crop], position_ids=pos[:, crop], past_kv=kv))(
        jp, lat2, t2, jkv)
    assert cached.shape == (1, 8, 8, 4)
    np.testing.assert_allclose(cached.numpy(), uncached.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cached.numpy(), np.asarray(want), **F32)


def test_load_model_gives_jax_config(models):
    """An OmniGen file: the kind and ``infer_omnigen_config``'s config (heads and the rope
    keywords given) equal JAX's; the weights load strictly; omnigen is out of the refusal
    table."""
    assert "omnigen" not in tauto.ROADMAP_ITEMS
    sd = _np_sd(models["tf"][0])
    kw = dict(num_heads=4, original_max_positions=32, max_positions=128,
              rope_short_factor=SHORT, rope_long_factor=LONG, pos_embed_max_size=16)
    want = jauto.load_model(sd, **kw)
    got = tauto.load_model(sd, dtype=torch.float32, device="cpu", **kw)
    assert got["kind"] == want["kind"] == "omnigen"
    assert dataclasses.asdict(got["config"]) == dataclasses.asdict(want["config"])
    assert got["config"] == CFG
    for k, v in got["model"].state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


# ---------------------------------------------------------------------------
# Pipeline requests
# ---------------------------------------------------------------------------

def _noise(seed, shape):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))


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
    (tf, jt), (enc, je), (dec, jd) = models["tf"], models["enc"], models["dec"]
    jp = jpipe.OmniGenImagePipeline(
        transformer=jt, vae_encoder=je, vae_decoder=jd, cfg=JCFG,
        vae_enc_plan=tvae.TINY_SD_VAE_ENCODER_PLAN, vae_dec_plan=tvae.TINY_SD_VAE_DECODER_PLAN,
        vae_groups=4, dtype=jnp.float32)
    tp = tpipe.OmniGenImagePipeline(transformer=tf, vae_encoder=enc, vae_decoder=dec, cfg=CFG,
                                    vae_groups=4, dtype=torch.float32)
    return jp, tp


@pytest.mark.parametrize("case", ["text", "reference", "i2i_tiled"])
def test_pipeline_matches_jax(pipes, case):
    """32x32 (a 4x4 latent: 4 image tokens), 3 steps, the condition cache on. text: two
    branches, CFG 2.5. reference: one 32x32 reference image (4 spliced tokens: the
    sequence passes the 32-position window), three branches with image CFG 1.6.
    i2i_tiled: image-to-image at strength 0.7, the encode in 16-pixel tiles at stride 8,
    the decode in 2-latent tiles at stride 1."""
    jp, tp = pipes
    rng = np.random.default_rng(12)
    kw = dict(prompt="a red ball on a wooden table", height=32, width=32,
              num_inference_steps=3, seed=9)
    if case == "reference":
        kw["reference_images"] = [rng.uniform(-1, 1, size=(32, 32, 3)).astype(np.float32)]
    elif case == "i2i_tiled":
        kw.update(input_image=rng.uniform(-1, 1, size=(32, 32, 3)).astype(np.float32),
                  denoising_strength=0.7, tiled=True, tile_size=2, tile_stride=1)
    want = jp(**kw)
    got = tp(**kw, noise=_noise(9, (1, 4, 4, 4)))
    assert got.shape == want.shape == (32, 32, 3)
    np.testing.assert_allclose(got, want, **DIT_TOL)


def test_init_random_answers_on_the_cpu():
    pipe = tpipe.OmniGenImagePipeline.init_random(device="cpu")
    img = pipe("a cat", height=16, width=16, num_inference_steps=2,
               noise=_noise(1, (1, 2, 2, 4)))
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()


def test_from_pretrained_reads_reference_files(models, pipes, tmp_path):
    """The OmniGen file (the rope keywords given) and the SD VAE halves as safetensors
    files: ``from_pretrained`` reads each strictly and answers a request as the pipeline
    built from the same modules does."""
    from goal_force_tpu_torch.io.safetensors_io import save_safetensors

    paths = {}
    for name in ("tf", "enc", "dec"):
        paths[name] = str(tmp_path / f"{name}.safetensors")
        save_safetensors(models[name][0].state_dict(), paths[name])
    pipe = tpipe.OmniGenImagePipeline.from_pretrained(
        paths["tf"], vae_encoder_path=paths["enc"], vae_decoder_path=paths["dec"],
        vae_plans=(tvae.TINY_SD_VAE_ENCODER_PLAN, tvae.TINY_SD_VAE_DECODER_PLAN, 4),
        dtype=torch.float32, device="cpu", num_heads=4, original_max_positions=32,
        max_positions=128, rope_short_factor=SHORT, rope_long_factor=LONG,
        pos_embed_max_size=16)
    assert pipe.cfg == CFG
    req = dict(prompt="a red ball", height=32, width=32, num_inference_steps=2,
               noise=_noise(4, (1, 4, 4, 4)))
    np.testing.assert_array_equal(pipe(**req), pipes[1](**req))
