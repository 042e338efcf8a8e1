"""The HunyuanVideo path's text side against the JAX package: the CLIP BPE tokenizer on
the vendored CLIP directories (ids equal), the hash ids and the sinusoidal timestep
embedding, the CLIP-L text tower (SD encode, the SD3/HunyuanVideo pooled branch, the
projected features) and the Llama tower (GQA, a padded mask), the configs, and the
converters between the two packages' weight layouts. The towers are tiny (2 layers) and
their weights are the port's random ones, read by JAX through its own converters."""

import dataclasses
import os
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from goal_force_tpu import prompters as jprompters
from goal_force_tpu.models import clip as jclip
from goal_force_tpu.models import sd_text_encoder as jsd
from goal_force_tpu.models import text_encoders as jte
from goal_force_tpu.models.sd_unet import timestep_embedding as jtemb
from goal_force_tpu.pipelines.flux import _hash_ids

from goal_force_tpu_torch import prompters as tprompters
from goal_force_tpu_torch.io import from_jax
from goal_force_tpu_torch.models import clip as tclip
from goal_force_tpu_torch.models import sd_text_encoder as tsd
from goal_force_tpu_torch.models import text_encoders as tte
from goal_force_tpu_torch.models.tokenizer import hash_ids
from goal_force_tpu_torch.models.wan_dit import sinusoidal_embedding

PROMPTS = [
    "a red ball rolls across a wooden table and hits a blue cup",
    "Ein Ball rollt über den Tisch – 小球滚过桌面, naïve café №5 🎾",
    "  extra   spaces\tand &amp; html &lt;b&gt; don't <|endoftext|> inside  ",
    "",
    " ".join(["a marble is flicked towards a stack of dominoes"] * 12),   # > 77 tokens
]
# float32 limits: the same weights and inputs through XLA and torch differ by float32
# rounding of the matmuls and reductions (|outputs| ~ 1-10).
F32 = dict(rtol=1e-4, atol=1e-4)


def _np_sd(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _perturb(model, seed):
    """Small random offsets on every parameter, so biases and norm weights are not the
    init's zeros and ones."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.05)
    return model


@pytest.mark.parametrize("rel", ["hunyuan_video/tokenizer_1", "stable_diffusion/tokenizer",
                                 "flux/tokenizer_1"])
def test_clip_bpe_ids_equal_jax(rel):
    tok = tprompters.load_text_tokenizer(tprompters.asset_path(*rel.split("/")), 77)
    ref = jprompters.load_text_tokenizer(jprompters.asset_path(*rel.split("/")), 77)
    assert tok.pad_id == ref.pad_id and tok.force_last == ref.force_last
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # the long prompt is truncated in both
        for prompt in PROMPTS:
            assert tok.encode(prompt) == ref.encode(prompt)
            np.testing.assert_array_equal(tok(prompt), ref(prompt))
    if rel.startswith("hunyuan_video"):
        np.testing.assert_array_equal(tprompters.hunyuan_video_clip_tokenizer()(PROMPTS[0]),
                                      jprompters.hunyuan_video_clip_tokenizer()(PROMPTS[0]))


def test_hash_ids_and_timestep_embedding_equal_jax():
    for prompt in PROMPTS:
        for vocab, length in ((1 << 30, 256), (128320, 256), (49408, 77)):
            got = hash_ids(prompt, vocab, length)
            assert got.dtype == np.int64
            np.testing.assert_array_equal(got, _hash_ids(prompt, vocab, length))
    # JAX's frequencies are float32 exp()s, the port's float32 pow()s: they may round an
    # ulp or so apart, so an angle t * f differs by up to ~t * 2**-23, its cos/sin by as much
    t = np.array([0.0, 1.0, 437.5, 999.0, 6000.0], np.float32)
    got = sinusoidal_embedding(256, torch.from_numpy(t)).numpy()
    want = np.asarray(jtemb(jnp.asarray(t), 256))
    assert (np.abs(got - want) <= 2e-6 + 4 * t[:, None] * 2.0**-23).all()


def test_configs_equal_jax():
    from goal_force_tpu.models import hunyuan_video_dit as jdit
    from goal_force_tpu.models import hunyuan_video_vae as jvae
    from goal_force_tpu.pipelines import hunyuan_video as jpipe
    from goal_force_tpu_torch.models import hunyuan_video_dit as tdit
    from goal_force_tpu_torch.models import hunyuan_video_vae as tvae
    from goal_force_tpu_torch.pipelines import hunyuan_video as tpipe

    pairs = [(tclip.CLIPConfig(), jclip.CLIPConfig()), (tclip.CLIP_L_14, jclip.CLIP_L_14),
             (tclip.CLIP_H_14, jclip.CLIP_H_14), (tsd.SD_TEXT_CONFIG, jsd.SD_TEXT_CONFIG),
             (tte.LlamaConfig(), jte.LlamaConfig()),
             (tdit.HunyuanVideoDiTConfig(), jdit.HunyuanVideoDiTConfig()),
             (tpipe.tiny_hunyuan_config(), jpipe.tiny_hunyuan_config()),
             (tvae.HunyuanVAEConfig(), jvae.HunyuanVAEConfig()),
             (tvae.tiny_hunyuan_vae_config(), jvae.tiny_hunyuan_vae_config())]
    for a, b in pairs:
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert tpipe.HUNYUAN_PROMPT_TEMPLATES == jpipe.HUNYUAN_PROMPT_TEMPLATES


CLIP_CFG = tclip.CLIPConfig(vocab_size=49408, text_dim=32, text_heads=4, text_layers=2,
                            max_positions=77, proj_dim=24)


@pytest.fixture(scope="module")
def clip_pair():
    model = _perturb(tclip.init_clip_text(CLIP_CFG, torch.Generator().manual_seed(3),
                                          device="cpu", projection=True), 4)
    sd = _np_sd(model)
    params = jsd.sd_text_params_from_torch(sd, jclip.CLIPConfig(**dataclasses.asdict(CLIP_CFG)))
    params["text_proj"] = sd["text_projection.weight"].T
    tok = tprompters.hunyuan_video_clip_tokenizer()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ids = np.stack([tok(p) for p in PROMPTS])
    return model, params, ids


def test_clip_text_tower_matches_jax(clip_pair):
    """sd_text_encode at clip_skip 2, sd3_text1_encode (the pooled embedding HunyuanVideo
    conditions on, and the hidden states) and clip_encode_text (EOS pooling, GELU, the
    projection); float32."""
    model, params, ids = clip_pair
    jcfg = jclip.CLIPConfig(**dataclasses.asdict(CLIP_CFG))
    tid, jid = torch.from_numpy(ids).long(), jnp.asarray(ids)
    want = jax.jit(lambda p, i: jsd.sd_text_encode(p, i, jcfg, 2))(params, jid)
    np.testing.assert_allclose(tsd.sd_text_encode(model, tid, CLIP_CFG, 2).numpy(),
                               np.asarray(want), **F32)
    pooled, hidden = tsd.sd3_text1_encode(model, tid, CLIP_CFG)
    jpooled, jhidden = jax.jit(lambda p, i: jsd.sd3_text1_encode(p, i, jcfg))(params, jid)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled), **F32)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(jhidden), **F32)
    cfg = dataclasses.replace(CLIP_CFG, text_pooling="eos_token", hidden_act="gelu")
    feats, toks = tclip.clip_encode_text(model, cfg, tid, return_tokens=True)
    jcfg = jclip.CLIPConfig(**dataclasses.asdict(cfg))
    jfeats, jtoks = jax.jit(lambda p, i: jclip.clip_encode_text(
        p, jcfg, i, return_tokens=True))(params, jid)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), **F32)
    np.testing.assert_allclose(toks.numpy(), np.asarray(jtoks), **F32)


LLAMA_CFG = tte.LlamaConfig(hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
                            intermediate_size=64, vocab=1000)


@pytest.fixture(scope="module")
def llama_pair():
    model = _perturb(tte.init_llama(LLAMA_CFG, torch.Generator().manual_seed(5),
                                    torch.float32, device="cpu"), 6)
    params = jte.llama_params_from_torch(_np_sd(model),
                                         jte.LlamaConfig(**dataclasses.asdict(LLAMA_CFG)))
    return model, params


def test_llama_tower_matches_jax(llama_pair):
    """Two rows of hash ids, one padded after 3 tokens (the rows past the mask attend to
    the valid keys, a fully masked row spreads evenly, as in JAX); skip 0 and 1 layers."""
    model, params = llama_pair
    jcfg = jte.LlamaConfig(**dataclasses.asdict(LLAMA_CFG))
    ids = np.stack([hash_ids(PROMPTS[0], LLAMA_CFG.vocab, 16),
                    hash_ids("three word prompt", LLAMA_CFG.vocab, 16)])
    mask = (ids > 0).astype(np.int32)
    mask[1, 0] = 0      # a row whose first key is masked: its first query sees no key
    for skip in (0, 1):
        got = tte.llama_encode(model, LLAMA_CFG, torch.from_numpy(ids), torch.from_numpy(mask),
                               hidden_state_skip_layer=skip)
        want = jax.jit(lambda p, i, m: jte.llama_encode(p, jcfg, i, m,
                                                        hidden_state_skip_layer=skip))(
            params, jnp.asarray(ids), jnp.asarray(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_text_tower_converters_round_trip(clip_pair, llama_pair):
    """port state dict -> JAX converter -> params_from_jax -> the same tensors (the Llama
    tree has no final norm: it comes back as the init's ones)."""
    clip, clip_params, _ = clip_pair
    llama, llama_params = llama_pair
    back = from_jax.params_from_jax({"clip_text": clip_params, "llama": llama_params})
    for model, sd in ((clip, back["clip_text"]), (llama, back["llama"])):
        want = model.state_dict()
        if model is llama:
            want = {**want, "norm.weight": torch.ones_like(want["norm.weight"])}
        assert set(sd) == set(want)
        for k, v in want.items():
            assert sd[k].shape == v.shape and torch.equal(sd[k].to(v.dtype), v), k


def test_asset_path_reads_the_vendored_files_by_path():
    path = tprompters.asset_path("hunyuan_video", "tokenizer_1")
    assert os.path.isfile(os.path.join(path, "vocab.json"))
    assert os.path.realpath(path) == os.path.realpath(
        jprompters.asset_path("hunyuan_video", "tokenizer_1"))
