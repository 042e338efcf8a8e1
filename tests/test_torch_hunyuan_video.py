"""The HunyuanVideo text-to-video path of the port against the JAX package, at the tiny
configs: the DiT forward (padded text masks, guidance, token replace), the VAE (encode
and decode, untiled and tiled), the pipeline (JAX's noise passed in: merged CFG, a
TeaCache skip, and v2v with token replace through from_pretrained on reference-format
files that both packages read), the loader's detection and strictness, and the weight
converters. Weights are the port's random ones (offset so that no bias or norm weight is
trivial), read by JAX through its own converters.

float32 limits: XLA and torch round the same float32 matmuls and reductions differently,
~1e-6 relative per op; through the tiny DiT's 4 blocks and a few Euler steps the outputs
(|x| up to ~5) agree to ~1e-4, so the DiT and pipeline limits are 5e-4 (x 1e-3 relative);
the VAE's GroupNorms and convs agree to ~1e-5, limit 1e-4."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from goal_force_tpu.io import auto as jauto
from goal_force_tpu.io import detect as jdetect
from goal_force_tpu.models import hunyuan_video_dit as jdit
from goal_force_tpu.models import hunyuan_video_vae as jvae
from goal_force_tpu.pipelines import hunyuan_video as jpipe

from goal_force_tpu_torch.io import auto as tauto
from goal_force_tpu_torch.io import detect as tdetect
from goal_force_tpu_torch.io import from_jax
from goal_force_tpu_torch.io.safetensors_io import save_safetensors
from goal_force_tpu_torch.models import clip as tclip
from goal_force_tpu_torch.models import hunyuan_video_dit as tdit
from goal_force_tpu_torch.models import hunyuan_video_vae as tvae
from goal_force_tpu_torch.models import text_encoders as tte
from goal_force_tpu_torch.pipelines import hunyuan_video as tpipe

DIT_TOL = dict(rtol=1e-3, atol=5e-4)
VAE_TOL = dict(rtol=1e-3, atol=1e-4)
CFG = tpipe.tiny_hunyuan_config()
JCFG = jpipe.tiny_hunyuan_config()
VCFG = tvae.tiny_hunyuan_vae_config()
JVCFG = jvae.tiny_hunyuan_vae_config()


def _np_sd(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _perturb(model, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.05)
    return model


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def dit_pair():
    model = _perturb(tdit.init_hunyuan_video_dit(CFG, torch.Generator().manual_seed(0),
                                                 torch.float32, device="cpu"), 1)
    return model, _jnp(jdit.hunyuan_video_dit_params_from_torch(_np_sd(model), JCFG))


@pytest.fixture(scope="module")
def vae_pair():
    enc = _perturb(tvae.init_hunyuan_vae(tvae.HunyuanVAEEncoder, VCFG,
                                         torch.Generator().manual_seed(2), device="cpu"), 3)
    dec = _perturb(tvae.init_hunyuan_vae(tvae.HunyuanVAEDecoder, VCFG,
                                         torch.Generator().manual_seed(4), device="cpu"), 5)
    return (enc, dec, _jnp(jvae.hunyuan_vae_encoder_params_from_torch(_np_sd(enc), JVCFG)),
            _jnp(jvae.hunyuan_vae_decoder_params_from_torch(_np_sd(dec), JVCFG)))


def _dit_inputs(seed=0):
    rng = np.random.default_rng(seed)
    b, length = 2, CFG.txt_len
    mask = np.zeros((b, length), np.int32)
    mask[0, :5] = 1
    mask[1, :17] = 1
    return (rng.normal(size=(b, 2, 4, 6, 16)).astype(np.float32),
            np.array([700.0, 300.0], np.float32),
            rng.normal(size=(b, length, CFG.text_dim)).astype(np.float32), mask,
            rng.normal(size=(b, CFG.pooled_dim)).astype(np.float32),
            np.array([6.0, 3.5], np.float32))


def test_dit_forward_matches_jax(dit_pair):
    """Two rows with 5 and 17 valid text tokens of 256 (per-row kv_len), 12 image tokens,
    the I2V token replace and no guidance. (The forward without token replace and with
    embedded guidance is held to JAX's inside test_pipeline_t2v_cfg_matches_jax.)"""
    model, params = dit_pair
    lat, t, emb, mask, pooled, _ = _dit_inputs()
    want = jax.jit(lambda *a: jdit.hunyuan_video_dit_forward(
        params, JCFG, *a, token_replace=True))(lat, t, emb, mask, pooled)
    got = tdit.hunyuan_video_dit_forward(
        model, CFG, *(torch.from_numpy(a) for a in (lat, t, emb, mask, pooled)),
        token_replace=True)
    assert got.shape == lat.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DIT_TOL)


# One tile shape each way; the untiled cases run at that shape, so JAX compiles its
# encoder and decoder once (its tiled functions jit per tile shape through
# _jit_hv_encode/_jit_hv_decode, which the untiled cases reuse).
ENC_TILES, DEC_TILES = ((5, 32, 32), (4, 16, 16)), ((2, 4, 4), (1, 2, 2))


@pytest.mark.parametrize("case", ["encode", "decode", "encode_tiled", "decode_tiled"])
def test_vae_matches_jax(vae_pair, case):
    """Untiled, and tiled with 8 tiles overlapping in time, height and width (the later
    tiles in time drop their first frame; the blend ramps over the overlaps)."""
    enc, dec, jenc, jdec = vae_pair
    rng = np.random.default_rng(7)
    if case == "encode":
        video = rng.uniform(-1, 1, size=(1, 5, 32, 32, 3)).astype(np.float32)
        want = jvae._jit_hv_encode(JVCFG)(jenc, video)
        got = tvae.hunyuan_vae_encode(enc, torch.from_numpy(video), VCFG)
    elif case == "decode":
        latents = rng.normal(size=(1, 2, 4, 4, 16)).astype(np.float32)
        want = jvae._jit_hv_decode(JVCFG)(jdec, latents)
        got = tvae.hunyuan_vae_decode(dec, torch.from_numpy(latents), VCFG)
    elif case == "encode_tiled":
        video = rng.uniform(-1, 1, size=(1, 9, 48, 48, 3)).astype(np.float32)
        want = jvae.hunyuan_vae_encode_tiled(jenc, video, JVCFG, *ENC_TILES)
        got = tvae.hunyuan_vae_encode_tiled(enc, torch.from_numpy(video), VCFG, *ENC_TILES)
    else:
        latents = rng.normal(size=(1, 3, 6, 6, 16)).astype(np.float32)
        want = jvae.hunyuan_vae_decode_tiled(jdec, latents, JVCFG, *DEC_TILES)
        got = tvae.hunyuan_vae_decode_tiled(dec, torch.from_numpy(latents), VCFG, *DEC_TILES)
    assert got.shape == np.asarray(want).shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VAE_TOL)


def _noise(seed, shape):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))


REQUEST = dict(height=32, width=32, num_frames=5, seed=3)
LATENT_SHAPE = (1, 2, 4, 4, 16)


def test_pipeline_t2v_cfg_matches_jax(dit_pair):
    """Merged CFG (the negative prompt as a second row, its own hash-embedding and mask),
    embedded guidance, 3 steps; latents out (no decoder)."""
    model, params = dit_pair
    jp = jpipe.HunyuanVideoPipeline(dit=params, dit_cfg=JCFG, dtype=jnp.float32)
    tp = tpipe.HunyuanVideoPipeline(dit=model, dit_cfg=CFG, dtype=torch.float32)
    kw = dict(REQUEST, prompt="a ball rolls left", negative_prompt="blurry static",
              cfg_scale=5.0, num_inference_steps=3, embedded_guidance=4.5)
    want = jp(**kw)
    got = tp(**kw, noise=_noise(REQUEST["seed"], LATENT_SHAPE))
    assert got.shape == want.shape == LATENT_SHAPE
    np.testing.assert_allclose(got, want, **DIT_TOL)


def test_pipeline_teacache_skip_matches_jax(dit_pair, monkeypatch):
    """TeaCache at an unreachable threshold over 3 steps: the middle step replays the
    first step's residual through the head (one skip), as in JAX."""
    model, params = dit_pair
    jp = jpipe.HunyuanVideoPipeline(dit=params, dit_cfg=JCFG, dtype=jnp.float32)
    tp = tpipe.HunyuanVideoPipeline(dit=model, dit_cfg=CFG, dtype=torch.float32)
    skips = []
    skip = tp._tc_skip
    monkeypatch.setattr(tp, "_tc_skip", lambda *a: skips.append(1) or skip(*a))
    kw = dict(REQUEST, prompt="a ball rolls left", num_inference_steps=3,
              tea_cache_l1_thresh=1e12)
    want = jp(**kw)
    got = tp(**kw, noise=_noise(REQUEST["seed"], LATENT_SHAPE))
    assert len(skips) == 1
    np.testing.assert_allclose(got, want, **DIT_TOL)


# ---------------------------------------------------------------------------
# from_pretrained on reference-format files, detection, strictness
# ---------------------------------------------------------------------------

FP_CFG = dataclasses.replace(CFG, pooled_dim=32)
LLAMA_CFG = tte.LlamaConfig(hidden_size=32, num_layers=3, num_heads=4, num_kv_heads=2,
                            intermediate_size=64, vocab=1000)
CLIP_CFG = tclip.CLIPConfig(vocab_size=49408, text_dim=32, text_heads=4, text_layers=2,
                            max_positions=77)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Reference-format safetensors of a DiT (pooled_dim 32), a 3-layer GQA Llama, a
    2-layer CLIP-L-shaped text tower and both VAE halves in one file, and the state dicts
    written."""
    root = tmp_path_factory.mktemp("hunyuan_files")
    gen = lambda s: torch.Generator().manual_seed(s)
    vae = {}
    for cls, s in ((tvae.HunyuanVAEEncoder, 14), (tvae.HunyuanVAEDecoder, 15)):
        vae.update(_perturb(tvae.init_hunyuan_vae(cls, VCFG, gen(s), device="cpu"), s).state_dict())
    sds = {"dit": _perturb(tdit.init_hunyuan_video_dit(FP_CFG, gen(10), torch.float32,
                                                       device="cpu"), 11).state_dict(),
           "llama": _perturb(tte.init_llama(LLAMA_CFG, gen(12), torch.float32,
                                            device="cpu"), 13).state_dict(),
           "clip": _perturb(tclip.init_clip_text(CLIP_CFG, gen(16), device="cpu"),
                            17).state_dict(),
           "vae": vae}
    paths = {}
    for name, sd in sds.items():
        paths[name] = str(root / f"{name}.safetensors")
        save_safetensors(sd, paths[name])
    return paths, sds


def test_from_pretrained_v2v_token_replace_matches_jax(files, monkeypatch):
    """Both packages' from_pretrained on the same files (the Llama prompt through hash ids,
    CLIP-L through the vendored BPE tokenizer, the VAE's two halves from one file): the
    prompt embeddings, then a v2v request (denoising_strength 0.7) with an input image
    (token replace, the first latent frame clamped to the image), decoded; 2 steps.

    JAX's towers and VAE run jitted here (the same functions; eager JAX compiles every
    op anew and takes ~30 s at these sizes): its text encoders through jitted copies of
    llama_encode and sd3_text1_encode, its VAE through its own per-shape jits, whose
    shapes the VAE tests compiled."""
    from goal_force_tpu.models import sd_text_encoder as jsd
    from goal_force_tpu.models import text_encoders as jte

    monkeypatch.setattr(jte, "llama_encode", jax.jit(
        jte.llama_encode, static_argnums=(1,), static_argnames=("hidden_state_skip_layer",)))
    monkeypatch.setattr(jsd, "sd3_text1_encode", jax.jit(
        jsd.sd3_text1_encode, static_argnums=(2,), static_argnames=("clip_skip",)))
    paths, _ = files
    common = dict(dit_path=paths["dit"], llama_path=paths["llama"], clip_path=paths["clip"],
                  vae_decoder_path=paths["vae"], llama_num_heads=4, clip_num_heads=4,
                  num_heads=24, rope_dims=(2, 2, 2))
    jp = jpipe.HunyuanVideoPipeline.from_pretrained(**common, vae_cfg=JVCFG, dtype=jnp.float32)
    jv = jauto.load_model(paths["vae"], vae_cfg=JVCFG)["params"]
    jv = _jnp(jv)
    jp.encode_video = lambda v: jvae._jit_hv_encode(JVCFG)(jv["encoder"], v)
    jp.decode_video = lambda z: jvae._jit_hv_decode(JVCFG)(jv["decoder"], z)
    tp = tpipe.HunyuanVideoPipeline.from_pretrained(**common, vae_cfg=VCFG, dtype=torch.float32,
                                                    device="cpu")
    assert tp.dit_cfg == FP_CFG and tp.encode_video is not None
    for got, want in zip(tp.encode_prompt("a ball rolls left"), jp.encode_prompt("a ball rolls left")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **DIT_TOL)
    rng = np.random.default_rng(9)
    kw = dict(REQUEST, prompt="a ball rolls left", num_inference_steps=2,
              input_video=rng.uniform(0, 1, size=(5, 32, 32, 3)).astype(np.float32),
              input_images=rng.uniform(0, 1, size=(32, 32, 3)).astype(np.float32),
              denoising_strength=0.7)
    want = np.asarray(jp(**kw))
    got = tp(**kw, noise=_noise(REQUEST["seed"], LATENT_SHAPE))
    assert got.shape == want.shape == (1, 5, 32, 32, 3)
    np.testing.assert_allclose(got, want, **DIT_TOL)


def test_detect_model_kind_equals_jax(files, dit_pair, vae_pair):
    _, sds = files
    enc, dec, _, _ = vae_pair
    cases = {**sds, "tiny_dit": dit_pair[0].state_dict(), "vae_encoder": enc.state_dict(),
             "vae_decoder": dec.state_dict(),
             "llama_prefixed": {"model." + k: v for k, v in sds["llama"].items()}}
    want_kind = {"dit": "hunyuan_video_dit", "tiny_dit": "hunyuan_video_dit", "llama": "llama",
                 "llama_prefixed": "llama", "clip": "clip_text"}
    for name, sd in cases.items():
        kind = tdetect.detect_model_kind(sd)
        assert kind == jdetect.detect_model_kind({k: v.numpy() for k, v in sd.items()}), name
        assert kind == want_kind.get(name, "hunyuan_video_vae"), name


def test_load_model_matches_jax_config_and_is_strict(files):
    paths, sds = files
    for name, kw in (("dit", dict(num_heads=24, rope_dims=(2, 2, 2))), ("llama", {"num_heads": 4}),
                     ("clip", {"num_heads": 4})):
        got = tauto.load_model(paths[name], device="cpu", **kw)
        want = jauto.load_model(paths[name], **kw)
        assert got["kind"] == want["kind"]
        assert dataclasses.asdict(got["config"]) == dataclasses.asdict(want["config"])
    prefixed = tauto.load_model({"model." + k: v for k, v in sds["llama"].items()},
                                device="cpu", num_heads=4)
    assert torch.equal(prefixed["model"].layers[2].mlp.down_proj.weight,
                       sds["llama"]["layers.2.mlp.down_proj.weight"])
    extra = {**sds["dit"], "final_layer.extra.weight": torch.zeros(2)}
    with pytest.raises(KeyError, match="unexpected"):
        tauto.load_model(extra, device="cpu", num_heads=24, rope_dims=(2, 2, 2))
    missing = {k: v for k, v in sds["llama"].items() if k != "layers.1.mlp.up_proj.weight"}
    with pytest.raises(KeyError, match="missing"):
        tauto.load_model(missing, device="cpu", num_heads=4)


def test_unported_kinds_and_llava_raise(files):
    """A LLaVA checkpoint (HunyuanVideo-I2V's MLLM) loads since the LLaVA slice, so one
    that lacks its vision tower raises KeyError, through load_model and from_pretrained
    (tests/test_torch_llava.py loads whole ones); the zoo kinds not ported raise
    NotImplementedError naming their ROADMAP item; the kinds JAX leaves to their own
    loaders raise its ValueError."""
    paths, sds = files
    llava = {"multi_modal_projector.linear_1.weight": torch.zeros(4, 4),
             **{"language_model.model." + k: v for k, v in sds["llama"].items()}}
    assert tdetect.detect_model_kind(llava) == "llava"
    with pytest.raises(KeyError, match="vision_tower"):
        tauto.load_model(llava, device="cpu")
    with pytest.raises(KeyError, match="vision_tower"):
        tpipe.HunyuanVideoPipeline.from_pretrained(paths["dit"], llama_path=llava,
                                                   device="cpu", num_heads=24,
                                                   rope_dims=(2, 2, 2))
    # StepVideo (M14b) and every M14c family load since their slices
    # (tests/test_torch_stepvideo.py, test_torch_flux.py, test_torch_sd3.py,
    # test_torch_qwen_image.py, test_torch_hunyuan_dit.py, test_torch_omnigen.py); SDXL
    # (M14d) and ESRGAN (M14e) wait
    sdxl = {"add_time_embedding.0.weight": torch.zeros(2), "conv_in.weight": torch.zeros(2)}
    with pytest.raises(NotImplementedError, match="M14d"):
        tauto.load_model(sdxl, device="cpu")
    esrgan = {"body.0.rdb1.conv1.weight": torch.zeros(2)}
    assert tdetect.detect_model_kind(esrgan) == "esrgan"
    with pytest.raises(NotImplementedError, match="M14e"):
        tauto.load_model(esrgan, device="cpu")
    with pytest.raises(ValueError, match="dedicated loader"):
        tauto.load_model({"vace_blocks.0.x": torch.zeros(2)}, device="cpu")


def test_entry_points_need_cuda_unless_cpu_is_asked(files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    paths, _ = files
    with pytest.raises(RuntimeError, match="CUDA"):
        tpipe.HunyuanVideoPipeline.init_random()
    with pytest.raises(RuntimeError, match="CUDA"):
        tauto.load_model(paths["llama"], num_heads=4)
    assert tpipe.HunyuanVideoPipeline.init_random(device="cpu").device.type == "cpu"


def test_converters_round_trip(dit_pair, vae_pair):
    """port state dict -> JAX converter -> params_from_jax -> the same tensors."""
    enc, dec, jenc, jdec = vae_pair
    model, params = dit_pair
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    back = from_jax.params_from_jax({"hunyuan_video_dit": np_tree(params),
                                     "hunyuan_vae_encoder": np_tree(jenc),
                                     "hunyuan_vae_decoder": np_tree(jdec)})
    for mod, name in ((model, "hunyuan_video_dit"), (enc, "hunyuan_vae_encoder"),
                      (dec, "hunyuan_vae_decoder")):
        want, sd = mod.state_dict(), back[name]
        assert set(sd) == set(want), name
        for k, v in want.items():
            assert torch.equal(sd[k], v), k
