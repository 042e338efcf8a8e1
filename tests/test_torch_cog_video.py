"""CogVideoX text-to-video in the port against the JAX package, at tiny configs: T5 v1.1's
shared relative position bias, the DDIM tables and step formulas (float64), the
query-chunked ``plain_attention`` against the unchunked one (bias, kv_len, gradient), the
DiT forward, the VAE (encode and decode, untiled and in spatial tiles), two pipeline
requests (merged CFG on hash ids; v2v through ``from_pretrained`` on reference-format
files with the vendored ``spiece.model`` ids, decoded), ``load_model``'s ``cog_dit``,
``cog_vae`` and ``t5_encoder`` kinds, and the converters.

Weights are the port's random ones, offset so that no bias or norm weight is trivial,
read by JAX through its own converters; JAX's noise is passed in. float32 limits: XLA and
torch round the same matmuls, convs and reductions differently (~1e-6 relative per op):
the towers and the VAE agree to ~1e-5 (limit 1e-4 x 1e-4 relative), the DiT and two DDIM
steps to ~1e-4 (limit 5e-4 x 1e-3 relative), as the HunyuanVideo tests."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from goal_force_tpu.io import auto as jauto
from goal_force_tpu.io.torch_convert import t5_params_from_torch
from goal_force_tpu.models import cog_dit as jdit
from goal_force_tpu.models import cog_vae as jvae
from goal_force_tpu.models import t5 as jt5
from goal_force_tpu.pipelines import cog_video as jpipe
from goal_force_tpu.prompters import cog_tokenizer as jcog_tokenizer
from goal_force_tpu.schedulers import ddim as jddim

from goal_force_tpu_torch.io import auto as tauto
from goal_force_tpu_torch.io import from_jax
from goal_force_tpu_torch.io.safetensors_io import save_safetensors
from goal_force_tpu_torch.models import cog_dit as tdit
from goal_force_tpu_torch.models import cog_vae as tvae
from goal_force_tpu_torch.models import t5 as tt5
from goal_force_tpu_torch.ops import attention as tattn
from goal_force_tpu_torch.pipelines import cog_video as tpipe
from goal_force_tpu_torch.prompters import cog_tokenizer
from goal_force_tpu_torch.schedulers import ddim as tddim

F32 = dict(rtol=1e-4, atol=1e-4)
DIT_TOL = dict(rtol=1e-3, atol=5e-4)
DIT_CFG, T5_CFG = tpipe.tiny_cog_configs()
JDIT_CFG, JT5_CFG = jpipe.tiny_cog_configs()
VCFG = tvae.tiny_cog_vae_config()
JVCFG = jvae.tiny_cog_vae_config()


def _perturb(model, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.05)
    return model


def _np_sd(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module")
def models():
    """(port module, JAX params) of the tiny DiT, T5 v1.1 and both VAE halves."""
    dit = _perturb(tdit.init_cog_dit(DIT_CFG, _gen(0), torch.float32, device="cpu"), 1)
    t5 = _perturb(tt5.init_t5(T5_CFG, _gen(2), torch.float32, device="cpu"), 3)
    enc = _perturb(tvae.init_cog_vae(tvae.CogVAEEncoder, VCFG, _gen(4), device="cpu"), 5)
    dec = _perturb(tvae.init_cog_vae(tvae.CogVAEDecoder, VCFG, _gen(6), device="cpu"), 7)
    return {"dit": (dit, _jnp(jdit.cog_dit_params_from_torch(_np_sd(dit), JDIT_CFG))),
            "t5": (t5, _jnp(t5_params_from_torch(_np_sd(t5), JT5_CFG))),
            "enc": (enc, _jnp(jvae.cog_vae_encoder_params_from_torch(_np_sd(enc), JVCFG))),
            "dec": (dec, _jnp(jvae.cog_vae_decoder_params_from_torch(_np_sd(dec), JVCFG)))}


def test_t5_shared_position_bias_matches_jax(models):
    """One relative-position table, computed once and added in both layers; a padded
    row."""
    t5, params = models["t5"]
    rng = np.random.default_rng(8)
    ids = rng.integers(0, T5_CFG.vocab, size=(2, 16))
    mask = np.ones((2, 16), np.int32)
    mask[1, 11:] = 0
    want = jax.jit(lambda p, i, m: jt5.t5_encode(p, JT5_CFG, i, m))(params, ids, mask)
    got = tt5.t5_encode(t5, T5_CFG, torch.from_numpy(ids), torch.from_numpy(mask))
    assert "pos_embedding.embedding.weight" in t5.state_dict()
    assert not any(k.startswith("blocks.0.pos_embedding") for k in t5.state_dict())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("kw", [
    dict(num_inference_steps=20, prediction_type="v_prediction", rescale_zero_terminal_snr=True),
    dict(num_inference_steps=7, denoising_strength=0.6),
    dict(num_inference_steps=1, beta_schedule="linear", prediction_type="v_prediction"),
])
def test_ddim_matches_jax_in_float64(kw):
    want = jddim.make_ddim_schedule(**kw)
    got = tddim.make_ddim_schedule(**kw)
    np.testing.assert_array_equal(got.timesteps, want.timesteps)
    np.testing.assert_array_equal(got.alphas_cumprod, want.alphas_cumprod)
    rng = np.random.default_rng(9)
    x, e, s = (rng.normal(size=(2, 3, 4)) for _ in range(3))
    tx, te, ts = (torch.from_numpy(a) for a in (x, e, s))
    t = int(want.timesteps[0])
    for i in range(len(want)):
        np.testing.assert_allclose(tddim.ddim_step(got, te, i, tx).numpy(),
                                   jddim.ddim_step(want, e, i, x), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(
            tddim.ddim_return_to_timestep(got, i, tx, ts).numpy(),
            jddim.ddim_return_to_timestep(want, i, x, s), rtol=1e-12, atol=1e-12)
    for fn in ("ddim_add_noise", "ddim_training_target"):
        np.testing.assert_allclose(getattr(tddim, fn)(got, tx, te, t).numpy(),
                                   getattr(jddim, fn)(want, x, e, t), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tddim.ddim_step(got, te, 0, tx, to_final=True).numpy(),
                               jddim.ddim_step(want, e, 0, x, to_final=True), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("bias_shape", [None, (2, 3, 37, 29), (1, 1, 1, 29)])
def test_chunked_plain_attention_equals_unchunked(monkeypatch, bias_shape):
    """A logit budget of 5 rows' worth splits 37 query rows into 8 blocks (the last one
    short); with a full or broadcast bias and per-row kv_len, and under grad. Each row's
    softmax is whole in both, so the limit is float32 rounding of the blocked matmuls."""
    rng = np.random.default_rng(10)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).requires_grad_()
               for s in ((2, 37, 3, 16), (2, 29, 3, 16), (2, 29, 3, 16)))
    bias = None if bias_shape is None else torch.from_numpy(
        rng.normal(size=bias_shape).astype(np.float32))
    kv_len = torch.tensor([29, 17])
    want = tattn.plain_attention(q, k, v, 0.25, bias, kv_len)
    want_grads = torch.autograd.grad(want.square().sum(), (q, k, v))
    monkeypatch.setattr(tattn, "PLAIN_LOGITS_BYTES", 4 * 2 * 3 * 29 * 5)
    got = tattn.plain_attention(q, k, v, 0.25, bias, kv_len)
    grads = torch.autograd.grad(got.square().sum(), (q, k, v))
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=1e-6, atol=1e-6)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-5)


def test_group_norm_in_group_chunks_equals_whole(monkeypatch):
    """The VAEs' GroupNorm over a few groups at a time (a float32 budget of 3 groups'
    worth of 8) gives the whole pass's values; each group's statistics are its own."""
    from goal_force_tpu_torch.models import hunyuan_video_vae as hv

    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.normal(size=(2, 16, 3, 5, 7)).astype(np.float32))
    p = tvae.LayerNormAffine(16)
    with torch.no_grad():
        p.weight.copy_(torch.from_numpy(rng.normal(size=16).astype(np.float32)))
        p.bias.copy_(torch.from_numpy(rng.normal(size=16).astype(np.float32)))
    want = hv._group_norm(p, x, 8, 1e-6)
    monkeypatch.setattr(hv, "GROUP_NORM_F32_BYTES", 3 * 4 * x.numel() // 8)
    got = hv._group_norm(p, x, 8, 1e-6)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=1e-6, atol=1e-6)


def test_dit_forward_matches_jax(models):
    """B = 2 rows at different timesteps, 3 latent frames of 4x6 (18 image tokens with
    RoPE) behind 16 text tokens."""
    dit, params = models["dit"]
    rng = np.random.default_rng(11)
    lat = rng.normal(size=(2, 3, 4, 6, 16)).astype(np.float32)
    t = np.array([999.0, 250.0], np.float32)
    emb = rng.normal(size=(2, 16, 32)).astype(np.float32)
    want = jax.jit(lambda p, *a: jdit.cog_dit_forward(p, JDIT_CFG, *a))(params, lat, t, emb)
    got = tdit.cog_dit_forward(dit, DIT_CFG, *(torch.from_numpy(a) for a in (lat, t, emb)))
    assert got.shape == lat.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DIT_TOL)


@pytest.mark.parametrize("case", ["decode", "encode", "decode_tiled", "encode_tiled"])
def test_vae_matches_jax(models, case):
    """Untiled at 3 latent frames of 4x6 (9 frames of 32x48), and in 2x4-latent tiles at
    a stride of 1x2 (6 tiles, overlapping both ways, clamped at the far borders)."""
    enc, jenc = models["enc"]
    dec, jdec = models["dec"]
    rng = np.random.default_rng(12)
    latents = rng.normal(size=(1, 3, 4, 6, 4)).astype(np.float32)
    video = rng.uniform(-1, 1, size=(1, 9, 32, 48, 3)).astype(np.float32)
    tiles = ((2, 4), (1, 2))
    if case == "decode":
        want = jax.jit(lambda p, z: jvae.cog_vae_decode(p, z, JVCFG))(jdec, latents)
        got = tvae.cog_vae_decode(dec, torch.from_numpy(latents), VCFG)
    elif case == "encode":
        want = jax.jit(lambda p, x: jvae.cog_vae_encode(p, x, JVCFG))(jenc, video)
        got = tvae.cog_vae_encode(enc, torch.from_numpy(video), VCFG)
    elif case == "decode_tiled":
        want = jvae.cog_vae_decode_tiled(jdec, latents, JVCFG, *tiles)
        got = tvae.cog_vae_decode_tiled(dec, torch.from_numpy(latents), VCFG, *tiles)
    else:
        want = jvae.cog_vae_encode_tiled(jenc, video, JVCFG, *tiles)
        got = tvae.cog_vae_encode_tiled(enc, torch.from_numpy(video), VCFG, *tiles)
    assert got.shape == np.asarray(want).shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def _noise(seed, shape):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))


def test_pipeline_cfg_matches_jax(models):
    """Merged CFG 6.0 (the prompt and the negative prompt as one batch of 2) on hash ids,
    3 DDIM steps with v-prediction and zero-terminal SNR; latents out."""
    dit, jdit_p = models["dit"]
    t5, jt5_p = models["t5"]
    jp = jpipe.CogVideoPipeline(dit=jdit_p, t5=jt5_p, dit_cfg=JDIT_CFG, t5_cfg=JT5_CFG,
                                dtype=jnp.float32)
    tp = tpipe.CogVideoPipeline(dit=dit, t5=t5, dit_cfg=DIT_CFG, t5_cfg=T5_CFG,
                                dtype=torch.float32)
    kw = dict(prompt="a ball rolls left", negative_prompt="blurry", cfg_scale=6.0,
              num_frames=9, height=32, width=48, num_inference_steps=3, seed=4)
    want = jp(**kw)
    got = tp(**kw, noise=_noise(4, (1, 3, 4, 6, 16)))
    assert got.shape == want.shape == (1, 3, 4, 6, 16)
    np.testing.assert_allclose(got, want, **DIT_TOL)


# the from_pretrained files: a 16-channel VAE (the DiT's in_channels), a T5 v1.1 over
# the vendored spiece's 32,128 ids
FP_VCFG = dataclasses.replace(VCFG, latent_dim=16)
JFP_VCFG = dataclasses.replace(JVCFG, latent_dim=16)
FP_T5 = dataclasses.replace(T5_CFG, vocab=32128)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("cog_files")
    sds = {"dit": _perturb(tdit.init_cog_dit(DIT_CFG, _gen(20), torch.float32, device="cpu"),
                           21).state_dict(),
           "t5": _perturb(tt5.init_t5(FP_T5, _gen(22), torch.float32, device="cpu"),
                          23).state_dict(),
           "enc": _perturb(tvae.init_cog_vae(tvae.CogVAEEncoder, FP_VCFG, _gen(24),
                                             device="cpu"), 25).state_dict(),
           "dec": _perturb(tvae.init_cog_vae(tvae.CogVAEDecoder, FP_VCFG, _gen(26),
                                             device="cpu"), 27).state_dict()}
    paths = {}
    for name, sd in sds.items():
        paths[name] = str(root / f"{name}.safetensors")
        save_safetensors(sd, paths[name])
    return paths, sds


def test_from_pretrained_v2v_matches_jax(files):
    """Both packages' from_pretrained on the same files and the vendored tokenizer (226
    ids, equal): a v2v request (denoising_strength 0.7: encode, noise to the first of
    the shortened schedule's timesteps), 2 steps of merged CFG, decoded. JAX's VAE runs
    through jitted copies of its encode and decode (eager JAX compiles every op)."""
    paths, _ = files
    common = dict(dit_path=paths["dit"], text_encoder_path=paths["t5"],
                  vae_encoder_path=paths["enc"], vae_decoder_path=paths["dec"],
                  t5_num_heads=4)
    # JAX's infer_cog_config keeps 48 heads at any width: its tiny file takes the config
    jp = jpipe.CogVideoPipeline.from_pretrained(**common, vae_cfg=JFP_VCFG, dtype=jnp.float32,
                                                config=JDIT_CFG)
    jenc = _jnp(jvae.cog_vae_encoder_params_from_torch(jauto.load_weights(paths["enc"]), JFP_VCFG))
    jdec = _jnp(jvae.cog_vae_decoder_params_from_torch(jauto.load_weights(paths["dec"]), JFP_VCFG))
    jp.encode_video = jax.jit(lambda v: jvae.cog_vae_encode(jenc, v, JFP_VCFG))
    jp.decode_video = jax.jit(lambda z: jvae.cog_vae_decode(jdec, z, JFP_VCFG))
    tp = tpipe.CogVideoPipeline.from_pretrained(**common, vae_cfg=FP_VCFG, dtype=torch.float32,
                                                device="cpu")
    assert tp.dit_cfg == DIT_CFG and tp.t5_cfg.text_len == 226
    prompt = "A golden retriever chases a red ball across a sunny lawn."
    np.testing.assert_array_equal(tp.tokenize(prompt), jp.tokenize(prompt))
    np.testing.assert_array_equal(cog_tokenizer()(prompt), jcog_tokenizer()(prompt))
    video = np.random.default_rng(13).uniform(-1, 1, size=(1, 9, 32, 48, 3)).astype(np.float32)
    kw = dict(prompt=prompt, negative_prompt="", num_frames=9, height=32, width=48,
              num_inference_steps=2, input_video=video, denoising_strength=0.7, seed=5)
    want = np.asarray(jp(**kw))
    got = tp(**kw, noise=_noise(5, (1, 3, 4, 6, 16)))
    assert got.shape == want.shape == (1, 9, 32, 48, 3)
    np.testing.assert_allclose(got, want, **DIT_TOL)


def test_load_model_kinds(files):
    """cog_dit, cog_vae (each half, detected by the port) and t5_encoder load strictly;
    the T5 config equals JAX's, the DiT's equals the tiny config (JAX's keeps 48 heads)."""
    paths, sds = files
    dit = tauto.load_model(paths["dit"], device="cpu")
    jd = jauto.load_model(paths["dit"])
    assert dit["kind"] == jd["kind"] == "cog_dit"
    assert dit["config"] == DIT_CFG
    assert dataclasses.replace(dit["config"], num_heads=48) == \
        tdit.CogDiTConfig(**dataclasses.asdict(jd["config"]))
    t5 = tauto.load_model(paths["t5"], device="cpu", num_heads=4)
    jt = jauto.load_model(paths["t5"], num_heads=4)
    assert t5["kind"] == jt["kind"] == "t5_encoder"
    assert dataclasses.asdict(t5["config"]) == dataclasses.asdict(jt["config"])
    for name, cls in (("enc", tvae.CogVAEEncoder), ("dec", tvae.CogVAEDecoder)):
        r = tauto.load_model(paths[name], device="cpu", vae_cfg=FP_VCFG)
        assert r["kind"] == "cog_vae" and isinstance(r["model"], cls)
        for k, v in sds[name].items():
            assert torch.equal(r["model"].state_dict()[k], v), k
    with pytest.raises(KeyError, match="missing"):
        tauto.load_model({k: v for k, v in sds["dec"].items() if "blocks.3." not in k},
                         device="cpu", vae_cfg=FP_VCFG)


def test_converters_round_trip(models):
    """port state dict -> JAX converter -> from_jax -> the same tensors."""
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    back = from_jax.params_from_jax({"cog_dit": np_tree(models["dit"][1]),
                                     "t5_v1_1": np_tree(models["t5"][1]),
                                     "cog_vae_encoder": np_tree(models["enc"][1]),
                                     "cog_vae_decoder": np_tree(models["dec"][1])})
    for key, name in (("dit", "cog_dit"), ("t5", "t5_v1_1"), ("enc", "cog_vae_encoder"),
                      ("dec", "cog_vae_decoder")):
        want, sd = models[key][0].state_dict(), back[name]
        assert set(sd) == set(want), name
        for k, v in want.items():
            assert torch.equal(sd[k], v), k
