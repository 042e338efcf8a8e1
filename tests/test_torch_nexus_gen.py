"""Nexus-Gen and Qwen2.5-VL's KV-cached decoding in the port against the JAX package, at
tiny configs: the prefill and a decode step (hidden states and caches), greedy generation
(an LM head, tied embeddings, an eos stop), the editing merger with its fractional
positions, the adapter, the target embeddings against the cached AR loop (in the port,
and each against JAX), the image positions and editing rope tables, ``load_model`` with
the LM head, and one ``__call__`` and one ``edit`` of the tiny pipeline over Flux.

Weights are the port's random ones, offset so that no bias or norm weight is trivial; JAX
reads them through its own converters, and the port's modules are rebuilt from the JAX
trees by ``io/from_jax.py`` (which must give the same state dicts bit for bit). Ids,
positions, rope tables and generated tokens must be equal exactly: the test checks that
every greedy step's top two logits stand more than 1e-4 apart, so float32 rounding cannot
flip a token. float32 limits: the stacks within 1e-4 x 1e-4 relative; the pipeline
requests (a few Flux steps) 5e-4 x 1e-3 relative, as the Flux tests. JAX's side is
jitted."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from goal_force_tpu.io import auto as jauto
from goal_force_tpu.io.torch_convert import t5_params_from_torch
from goal_force_tpu.models import flux_dit as jdit
from goal_force_tpu.models import nexus_gen as jng
from goal_force_tpu.models import qwen_vl as jvl
from goal_force_tpu.models import sd_text_encoder as jsd
from goal_force_tpu.models import sd_vae as jvae
from goal_force_tpu.pipelines import flux as jflux
from goal_force_tpu.pipelines import nexus_gen as jpipe

from goal_force_tpu_torch.io import auto as tauto
from goal_force_tpu_torch.io import from_jax
from goal_force_tpu_torch.models import clip as tclip
from goal_force_tpu_torch.models import flux_dit as tdit
from goal_force_tpu_torch.models import nexus_gen as tng
from goal_force_tpu_torch.models import qwen_vl as tvl
from goal_force_tpu_torch.models import t5 as tt5
from goal_force_tpu_torch.pipelines import flux as tflux
from goal_force_tpu_torch.pipelines import nexus_gen as tpipe

from zoo_ckpts import TINY_VAE_DEC_PLAN, TINY_VAE_ENC_PLAN, build_sd3_vae_pair

F32 = dict(rtol=1e-4, atol=1e-4)
DIT_TOL = dict(rtol=1e-3, atol=5e-4)
CFG = tpipe.tiny_nexus_gen_config()
JCFG = jvl.QwenVLTextConfig(**dataclasses.asdict(CFG))
FLUX_CFG, T5_CFG, CLIP_CFG = tflux.tiny_flux_configs()
JFLUX_CFG, JT5_CFG, JCLIP_CFG = jflux.tiny_flux_configs()
MERGER_CFG = tng.NexusGenMergerConfig(text=CFG, num_layers=1, out_channel=FLUX_CFG.text_dim,
                                      expand_ratio=2)
JMERGER_CFG = jng.NexusGenMergerConfig(text=JCFG, num_layers=1,
                                       out_channel=FLUX_CFG.text_dim, expand_ratio=2)
GRID, N_IMG = (1, 6, 6), 9


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


@pytest.fixture(scope="module")
def jitted():
    """JAX's prefill and forward run eagerly (an XLA compile per op): jit them for the
    module."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jvl, "qwen_vl_text_prefill",
               jax.jit(jvl.qwen_vl_text_prefill, static_argnums=(1, 4)))
    mp.setattr(jvl, "qwen_vl_text_forward",
               jax.jit(jvl.qwen_vl_text_forward, static_argnums=(1,)))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def models(jitted):
    """(port module, JAX params) of the AR stack with an LM head and without one (tied),
    the heads, the adapter and the merger."""
    def text(seed, lm_head, qkv_bias=True):
        m = _perturb(tvl.init_qwen_vl_text(CFG, _gen(seed), torch.float32, device="cpu",
                                           lm_head=lm_head, qkv_bias=qkv_bias), seed + 1)
        return _carried(m, jvl.qwen_vl_text_params_from_torch(_np_sd(m), JCFG, prefix=""),
                        from_jax.qwen_vl_text_state_dict)

    heads = _perturb(tng.init_nexus_gen_heads(CFG.hidden_size, N_IMG, _gen(4), torch.float32,
                                              device="cpu"), 5, 0.3)
    adapter = _perturb(tng.init_nexus_gen_adapter(CFG.hidden_size, FLUX_CFG.text_dim,
                                                  _gen(6), torch.float32, device="cpu"), 7)
    merger = _perturb(tng.init_nexus_gen_merger(MERGER_CFG, _gen(8), torch.float32,
                                                device="cpu"), 9)
    return {
        "lm": text(0, True), "tied": text(2, False), "no_bias": text(12, True, False),
        "heads": _carried(heads, jng.nexus_gen_ar_heads_from_torch(_np_sd(heads)),
                          from_jax.nexus_gen_heads_state_dict),
        "adapter": _carried(adapter, jng.nexus_gen_adapter_params_from_torch(_np_sd(adapter)),
                            from_jax.nexus_gen_adapter_state_dict),
        "merger": _carried(merger, jng.nexus_gen_merger_params_from_torch(_np_sd(merger),
                                                                          JMERGER_CFG),
                           from_jax.nexus_gen_merger_state_dict),
    }


def test_prefill_and_decode_step_match_jax(models):
    """A causal prefill of 6 tokens (B = 2) into caches of 9 rows, then one decode step
    at index 6: the hidden states and both caches (zero past the written rows)."""
    (text, jp), rng = models["lm"], np.random.default_rng(10)
    emb = rng.normal(size=(2, 6, CFG.hidden_size)).astype(np.float32)
    pos = np.broadcast_to(np.arange(6, dtype=np.int32)[None, None], (3, 2, 6)).copy()
    step = rng.normal(size=(2, 1, CFG.hidden_size)).astype(np.float32)
    jcos, jsin = jvl.mrope_tables(JCFG, jnp.full((3, 2, 1), 6, jnp.int32))
    jh, jk, jv = jvl.qwen_vl_text_prefill(jp, JCFG, emb, pos, 9)
    jh2, jk2, jv2 = jax.jit(lambda p, e, c, s, k, v: jvl.qwen_vl_text_decode_step(
        p, JCFG, e, c, s, k, v, 6))(jp, step, jcos, jsin, jk, jv)
    with torch.no_grad():
        h, k, v = tvl.qwen_vl_text_prefill(text, CFG, _t(emb), _t(pos), 9)
        want_k, want_v = (np.asarray(a) for a in (jk, jv))
        for got, want in ((h, jh), (k, want_k), (v, want_v)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
        cos, sin = tvl.mrope_tables(CFG, torch.full((3, 2, 1), 6))
        h2, k2, v2 = tvl.qwen_vl_text_decode_step(text, CFG, _t(step), cos, sin, k, v, 6)
    assert not k2[:, :, 7:].any() and not v2[:, :, 7:].any()
    for got, want in ((h2, jh2), (k2, jk2), (v2, jv2)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def _margins(text, ids, toks):
    """The top-two logit gap at every greedy step, read from the uncached forward over
    the prompt and the generated tokens (whose argmaxes must be those tokens)."""
    seq = torch.as_tensor(np.concatenate([ids[0], toks[:-1]])[None])
    s = seq.shape[1]
    with torch.no_grad():
        h = tvl.qwen_vl_text_forward(text, CFG, text.embed_tokens.weight[seq],
                                     torch.ones((1, s)), torch.arange(s)[None, None]
                                     .expand(3, 1, s))
        logits = tvl._lm_logits(text, h[0, ids.shape[1] - 1:])
    top = logits.topk(2, dim=-1)
    assert top.indices[:, 0].tolist() == list(toks)
    return (top.values[:, 0] - top.values[:, 1]).min().item()


@pytest.mark.parametrize("case", ["lm_head", "tied", "eos", "no_bias"])
def test_generate_matches_jax(models, case):
    """Greedy generation of 8 tokens from a 5-token prompt: through the LM head, through
    the tied embedding (no LM head), with an eos id (the third token of the LM-head run:
    the tokens stop before it), and on a stack without q/k/v biases (a Llama-style
    checkpoint on the same stack). The tokens must equal JAX's exactly."""
    text, jp = models[{"tied": "tied", "no_bias": "no_bias"}.get(case, "lm")]
    ids = np.array([[3, 17, 42, 8, 29]])
    eos = ()
    if case == "eos":
        eos = (tvl.qwen_vl_text_generate(text, CFG, ids, 8)[2],)
    got = tvl.qwen_vl_text_generate(text, CFG, ids, 8, eos_ids=eos)
    want = jvl.qwen_vl_text_generate(jp, JCFG, ids, 8, eos_ids=eos)
    assert got == want
    if case == "eos":
        assert eos[0] not in got and len(got) < 8
    else:
        assert len(got) == 8 and _margins(text, ids, got) > 1e-4


def test_merger_and_its_positions_match_jax(models):
    """The fractional positions of a 6x6 and a 4x4 grid equal JAX's exactly; the merger
    over 9 target embeddings alone and with 4 reference embeddings behind them."""
    (merger, jp), rng = models["merger"], np.random.default_rng(11)
    for grid in ((1, 6, 6), (1, 4, 4), (1, 36, 36)):
        np.testing.assert_array_equal(tng.merger_position_ids(grid, MERGER_CFG),
                                      jng.merger_position_ids(grid, JMERGER_CFG))
    emb = rng.normal(size=(1, 9, CFG.hidden_size)).astype(np.float32)
    ref = rng.normal(size=(1, 4, CFG.hidden_size)).astype(np.float32)
    run = jax.jit(lambda p, e, r=None: jng.nexus_gen_merger_forward(
        p, JMERGER_CFG, e, GRID, r, None if r is None else (1, 4, 4)))
    with torch.no_grad():
        for r in (None, ref):
            got = tng.nexus_gen_merger_forward(merger, MERGER_CFG, _t(emb), GRID,
                                               None if r is None else _t(r),
                                               None if r is None else (1, 4, 4))
            want = run(jp, emb) if r is None else run(jp, emb, r)
            assert got.shape == (1, 9 if r is None else 13, FLUX_CFG.text_dim)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_adapter_matches_jax(models):
    (adapter, jp), rng = models["adapter"], np.random.default_rng(12)
    x = rng.normal(size=(2, 5, CFG.hidden_size)).astype(np.float32)
    want = jax.jit(jng.nexus_gen_adapter_forward)(jp, x)
    with torch.no_grad():
        got = tng.nexus_gen_adapter_forward(adapter, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_target_embeddings_equal_the_ar_loop_and_jax(models):
    """A 5-token prompt then the 9-entry table: the one teacher-forced forward and the
    prefill + 8 cached steps agree in the port (float32 within 1e-5), and each matches
    its JAX function."""
    (text, jp), (heads, jh) = models["lm"], models["heads"]
    rng = np.random.default_rng(13)
    prompt = rng.normal(size=(1, 5, CFG.hidden_size)).astype(np.float32)
    ppos = np.tile(np.arange(5, dtype=np.int32)[None, None], (3, 1, 1))
    embeds = np.concatenate([prompt, np.asarray(jh["image_prefill"])[None]], axis=1)
    pos = np.concatenate([ppos, jng.nexus_ar_image_positions(5, GRID, 2)], axis=2)
    want_tf = jng.nexus_gen_target_embeddings(jp, JCFG, jh, embeds, pos, N_IMG)
    want_ar = jax.jit(lambda p, h, e, q: jng.nexus_gen_ar_generate(p, JCFG, h, e, q, GRID, 2))(
        jp, jh, prompt, ppos)
    with torch.no_grad():
        tf = tng.nexus_gen_target_embeddings(text, CFG, heads, _t(embeds), _t(pos), N_IMG)
        ar = tng.nexus_gen_ar_generate(text, CFG, heads, _t(prompt), _t(ppos), GRID, 2)
    assert tf.shape == ar.shape == (1, N_IMG, CFG.hidden_size)
    np.testing.assert_allclose(ar.numpy(), tf.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tf.numpy(), np.asarray(want_tf), **F32)
    np.testing.assert_allclose(ar.numpy(), np.asarray(want_ar), **F32)


def test_positions_and_editing_rope_tables_equal_jax():
    for args in ((5, (1, 18, 18), 2), (12, (1, 6, 6), 2), (7, (2, 4, 8), 2)):
        np.testing.assert_array_equal(tng.nexus_ar_image_positions(*args),
                                      jng.nexus_ar_image_positions(*args))
    for args in ((64, 64, (18, 18), (36, 36), (16, 56, 56), 1e4),
                 (4, 6, (6, 6), (4, 4), (4, 6, 6), 1e4)):
        for a, b in zip(tng.nexus_editing_rope_tables(*args),
                        jng.nexus_editing_rope_tables(*args)):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)


def test_load_model_keeps_the_lm_head(models):
    """A whole AR file (``model.`` keys, the LM head, Nexus-Gen's heads): lm_head=True
    keeps the head and gives JAX's config; the adapter and heads load from the same
    file, the merger from its own."""
    text, heads, adapter = models["lm"][0], models["heads"][0], models["adapter"][0]
    sd = {("" if k.startswith("lm_head") else "model.") + k: v
          for k, v in _np_sd(text).items()}
    sd.update(_np_sd(heads))
    sd.update(_np_sd(adapter))
    got = tauto.load_model(sd, dtype=torch.float32, device="cpu", num_heads=4, lm_head=True)
    assert got["kind"] == "qwen_vl_text" and got["model"].lm_head is not None
    jax_cfg = jauto.load_model(sd, num_heads=4)["config"]
    assert dataclasses.asdict(got["config"]) == dataclasses.asdict(jax_cfg)
    for k, v in text.state_dict().items():
        np.testing.assert_array_equal(got["model"].state_dict()[k].numpy(), v.numpy())
    plain = tauto.load_model(sd, dtype=torch.float32, device="cpu", num_heads=4)
    assert not hasattr(plain["model"], "lm_head")
    merger = models["merger"][0]
    got_h = tng.nexus_gen_heads_from_state_dict(sd, device="cpu")
    got_a = tng.nexus_gen_adapter_from_state_dict(sd, device="cpu")
    got_m = tng.nexus_gen_merger_from_state_dict(_np_sd(merger), MERGER_CFG, device="cpu")
    for mod, want in ((got_h, heads), (got_a, adapter), (got_m, merger)):
        for k, v in want.state_dict().items():
            np.testing.assert_array_equal(mod.state_dict()[k].numpy(), v.numpy())


# ---------------------------------------------------------------------------
# Pipeline requests
# ---------------------------------------------------------------------------

def _noise(seed, shape):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))


@pytest.fixture(scope="module")
def pipes(models):
    """JAX's NexusGenPipeline and the port's over the same AR stack, heads, adapter and
    tiny Flux pipeline (the Flux test's VAE plans, factor 2)."""
    dit = _perturb(tdit.init_flux_dit(FLUX_CFG, _gen(20), torch.float32, device="cpu"), 21)
    clip = _perturb(tclip.init_clip_text(CLIP_CFG, _gen(22), device="cpu"), 23)
    t5 = _perturb(tt5.init_t5(T5_CFG, _gen(24), torch.float32, device="cpu"), 25)
    enc_sd, dec_sd, _ = build_sd3_vae_pair(seed=26)
    enc = tauto.load_model(enc_sd, dtype=torch.float32, device="cpu",
                           plan=TINY_VAE_ENC_PLAN)["model"]
    dec = tauto.load_model(dec_sd, dtype=torch.float32, device="cpu",
                           plan=TINY_VAE_DEC_PLAN)["model"]
    clip_jcfg = JCLIP_CFG.__class__(**dataclasses.asdict(CLIP_CFG))
    jf = jflux.FluxPipeline(
        dit=_jnp(jdit.flux_dit_params_from_torch(_np_sd(dit), JFLUX_CFG)),
        clip=_jnp(jsd.sd_text_params_from_torch(_np_sd(clip), clip_jcfg)),
        t5=_jnp(t5_params_from_torch(_np_sd(t5), JT5_CFG)),
        vae_encoder=_jnp(jvae.sd3_vae_encoder_params_from_torch(enc_sd, TINY_VAE_ENC_PLAN)),
        vae_decoder=_jnp(jvae.sd3_vae_decoder_params_from_torch(dec_sd, TINY_VAE_DEC_PLAN)),
        dit_cfg=JFLUX_CFG, t5_cfg=JT5_CFG, clip_cfg=JCLIP_CFG, vae_enc_plan=TINY_VAE_ENC_PLAN,
        vae_dec_plan=TINY_VAE_DEC_PLAN, vae_groups=4, vae_factor=2, dtype=jnp.float32)
    tf = tflux.FluxPipeline(dit=dit, clip=clip, t5=t5, vae_encoder=enc, vae_decoder=dec,
                            dit_cfg=FLUX_CFG, t5_cfg=T5_CFG, clip_cfg=CLIP_CFG, vae_groups=4,
                            vae_factor=2, dtype=torch.float32)
    (text, jt), (heads, jh), (adapter, ja) = models["lm"], models["heads"], models["adapter"]
    jp = jpipe.NexusGenPipeline(ar_params=jt, ar_cfg=JCFG, heads=jh, wte=jt["wte"],
                                adapter=ja, flux=jf, grid_thw=GRID)
    tp = tpipe.NexusGenPipeline(ar_model=text, ar_cfg=CFG, heads=heads, adapter=adapter,
                                flux=tf, grid_thw=GRID)
    return jp, tp


@pytest.mark.parametrize("case", ["call", "edit"])
def test_pipeline_matches_jax(models, pipes, case):
    """16x16, 2 Flux steps on JAX's noise. call: the prompt's 12 hash ids, then the table;
    edit: 4 reference embeddings (grid 4x4) and the 9 target ones through the merger,
    Flux with the editing rope tables."""
    jp, tp = pipes
    kw = dict(height=16, width=16, num_inference_steps=2, seed=3)
    noise = _noise(3, (1, 8, 8, 16))
    if case == "call":
        want = jp("a lighthouse at dusk", **kw)
        got = tp("a lighthouse at dusk", **kw, noise=noise)
    else:
        ref = np.random.default_rng(14).normal(size=(1, 4, CFG.hidden_size)).astype(np.float32)
        (merger, jm) = models["merger"]
        want = jp.edit("make it night", ref, (1, 4, 4), jm, JMERGER_CFG, **kw)
        got = tp.edit("make it night", ref, (1, 4, 4), merger, MERGER_CFG, **kw, noise=noise)
    assert got.shape == want.shape == (16, 16, 3)
    np.testing.assert_allclose(got, np.asarray(want), **DIT_TOL)


def test_init_random_answers_on_the_cpu():
    """init_random's tiny pipeline: a 16x16 request on its own noise, finite, in [0, 1]."""
    pipe = tpipe.NexusGenPipeline.init_random(device="cpu")
    img = pipe("a lighthouse at dusk", height=16, width=16, num_inference_steps=2,
               noise=_noise(1, (1, 8, 8, 16)))
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()


def test_from_pretrained_reads_a_whole_ar_file(models, pipes, tmp_path):
    """One safetensors file with the text stack (``model.`` keys), the LM head, the heads
    and the adapter: ``from_pretrained`` over the tiny Flux pipeline keeps the LM head and
    answers a request as the pipeline built from the same modules does."""
    from goal_force_tpu_torch.io.safetensors_io import save_safetensors

    text, heads, adapter = models["lm"][0], models["heads"][0], models["adapter"][0]
    sd = {("" if k.startswith("lm_head") else "model.") + k: v
          for k, v in text.state_dict().items()}
    sd.update(heads.state_dict())
    sd.update(adapter.state_dict())
    path = str(tmp_path / "nexus_gen.safetensors")
    save_safetensors(sd, path)
    tp = pipes[1]
    pipe = tpipe.NexusGenPipeline.from_pretrained(path, flux=tp.flux, grid_thw=GRID,
                                                  dtype=torch.float32, ar_num_heads=4,
                                                  device="cpu")
    assert pipe.ar_cfg == CFG and pipe.ar_model.lm_head is not None
    req = dict(height=16, width=16, num_inference_steps=2, noise=_noise(5, (1, 8, 8, 16)))
    np.testing.assert_array_equal(pipe("a lighthouse", **req), tp("a lighthouse", **req))
