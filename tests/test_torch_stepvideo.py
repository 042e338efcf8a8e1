"""StepVideo text-to-video in the port against the JAX package, at the tiny configs: the
rope tables, the DiT forward (with and without the CLIP stream, from a reference-layout
state dict whose fused wqkv / wkv the port splits per head and JAX reorders on load), the
VAE (an encode chunk, a decode chunk, the chunked decode with its seam mix over two
chunks, the tiled decode; the first and third again with the memory budgets cut so that
every chunked path splits), two pipeline requests (CFG untiled with encode_prompt built
from tiny BERT and Step-1 towers; tiled through the port's from_pretrained on
reference-format files, BERT on the vendored WordPiece ids, against JAX's pipeline on the
same state dicts), load_model's four StepVideo
kinds with JAX's configs, and the converters.

Weights are the port's random ones, offset so that no bias or norm weight is trivial,
read by JAX through its own converters; JAX's noise is passed in. float32 limits: XLA and
torch round the same matmuls, convs and reductions differently (~1e-6 relative per op):
the VAE agrees to ~1e-5 (limit 1e-4 x 1e-3 relative), the DiT and the pipelines (two
Euler steps of two forwards each) to ~1e-4 (limit 5e-4 x 1e-3 relative). JAX's side is
jitted (its eager VAE compiles every op)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from goal_force_tpu.io import auto as jauto
from goal_force_tpu.models import stepvideo_dit as jdit
from goal_force_tpu.models import stepvideo_vae as jvae
from goal_force_tpu.models import text_encoders as jte
from goal_force_tpu.pipelines import step_video as jpipe

from goal_force_tpu_torch.io import auto as tauto
from goal_force_tpu_torch.io import from_jax
from goal_force_tpu_torch.io.safetensors_io import save_safetensors
from goal_force_tpu_torch.models import stepvideo_dit as tdit
from goal_force_tpu_torch.models import stepvideo_vae as tvae
from goal_force_tpu_torch.models import text_encoders as tte
from goal_force_tpu_torch.pipelines import step_video as tpipe

VAE_TOL = dict(rtol=1e-3, atol=1e-4)
DIT_TOL = dict(rtol=1e-3, atol=5e-4)
CFG, VCFG = tpipe.tiny_stepvideo_configs()
JCFG = jdit.StepVideoConfig(**dataclasses.asdict(CFG))
JVCFG = jvae.StepVideoVAEConfig(**dataclasses.asdict(VCFG))
# the prompt towers: BERT over the vendored WordPiece vocabulary (47,020 ids, 77
# positions) at the DiT's clip_dim, Step-1 at its caption_dim with 2 groups of 4 heads
BERT = tte.BertConfig(hidden_size=16, num_layers=2, num_heads=2, intermediate_size=24,
                      max_positions=80)
STEP1 = tte.Step1Config(hidden_size=32, num_layers=2, num_heads=4, num_groups=2,
                        ffn_hidden_size=24, vocab=96, multiple_of=8)


def _np_sd_of(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _np_sd(model):
    return _np_sd_of(model.state_dict())


def _perturb(model, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.05)
    return model


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _jax_config(cls, cfg):
    return cls(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module", autouse=True)
def jitted_jax():
    """JAX's chunk decode and its prompt towers jitted in place for this module: JAX's
    chunked decode and its pipelines call them eagerly, and each jitted one compiles once
    for the module's shapes."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvae, "stepvideo_decode_chunk",
                   jax.jit(jvae.stepvideo_decode_chunk, static_argnums=(2,)))
        mp.setattr(jte, "bert_encode", jax.jit(jte.bert_encode, static_argnums=(1, 4)))
        mp.setattr(jte, "step1_encode", jax.jit(jte.step1_encode, static_argnums=(1,)))
        yield


@pytest.fixture(scope="module")
def models():
    """(port module, JAX params) of the tiny DiT, the tiny VAE (both halves), BERT and
    Step-1."""
    dit = _perturb(tdit.init_stepvideo_dit(CFG, _gen(0), torch.float32, device="cpu"), 1)
    vae = _perturb(tvae.init_stepvideo_vae(VCFG, _gen(2), device="cpu"), 3)
    bert = _perturb(tte.init_bert(BERT, _gen(4), device="cpu"), 5)
    step1 = _perturb(tte.init_step1(STEP1, _gen(6), torch.float32, device="cpu"), 7)
    return {"dit": (dit, _jnp(jdit.stepvideo_dit_params_from_torch(_np_sd(dit), JCFG))),
            "vae": (vae, _jnp(jvae.stepvideo_vae_params_from_torch(_np_sd(vae), JVCFG))),
            "bert": (bert, _jnp(jte.bert_params_from_torch(
                _np_sd(bert), _jax_config(jte.BertConfig, BERT)))),
            "step1": (step1, _jnp(jte.step1_params_from_torch(
                _np_sd(step1), _jax_config(jte.Step1Config, STEP1))))}


@pytest.mark.parametrize("grid,split", [((3, 4, 6), (8, 4, 4)), ((2, 5, 3), (64, 32, 32))])
def test_rope_tables_equal_jax(grid, split):
    got = tdit.stepvideo_rope_tables(*grid, split)
    want = jdit.stepvideo_rope_tables(*grid, split)
    assert len(got) == len(want) == 3
    for (gc, gs), (wc, ws) in zip(got, want):
        assert gc.dtype == np.float32
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gs, ws)


@pytest.mark.parametrize("with_clip", [True, False], ids=["clip", "no_clip"])
def test_dit_forward_matches_jax(models, with_clip):
    """3 latent frames of 4x6 (72 tokens with 3D RoPE), 9 caption tokens behind 5 CLIP
    tokens (or none), t = 0.7."""
    dit, params = models["dit"]
    rng = np.random.default_rng(8)
    lat = rng.normal(size=(1, 3, 4, 6, 8)).astype(np.float32)
    t = np.array([0.7], np.float32)
    cap = rng.normal(size=(1, 9, 32)).astype(np.float32)
    clip = rng.normal(size=(1, 5, 16)).astype(np.float32) if with_clip else None
    want = jax.jit(lambda p, *a: jdit.stepvideo_dit_forward(p, JCFG, *a))(
        params, lat, t, cap, *([clip] if with_clip else []))
    got = tdit.stepvideo_dit_forward(dit, CFG, *(torch.from_numpy(a) for a in (lat, t, cap)),
                                     None if clip is None else torch.from_numpy(clip))
    assert got.shape == lat.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DIT_TOL)


@pytest.mark.parametrize("case", ["encode_chunk", "decode_chunk", "decode_seams",
                                  "decode_tiled"])
def test_vae_matches_jax(models, case):
    """An encode chunk (17 frames of 16x32) and its chunked encode's mean; a decode chunk
    (3 latent frames of 1x2); the chunked decode of 6 latent frames (2 chunks, 34 frames,
    the seam frames 16 and 17 mixed 0.6/0.4); the tiled decode of 3 latent frames of 2x3
    in tiles of 2x2 at a stride of 1x1 (2 tiles overlapping in width; the tiled pipeline
    request's 4 tiles overlap both ways)."""
    vae, params = models["vae"]
    rng = np.random.default_rng(9)
    if case == "encode_chunk":
        video = rng.uniform(-1, 1, size=(1, 17, 16, 32, 3)).astype(np.float32)
        want = jax.jit(lambda p, v: jvae.stepvideo_encode_chunk(p["encoder"], v, JVCFG))(
            params, video)
        got = tvae.stepvideo_encode_chunk(vae, torch.from_numpy(video), VCFG)
        mean = tvae.stepvideo_vae_encode(vae, torch.from_numpy(video), VCFG)
        np.testing.assert_array_equal(mean.numpy(), got[..., :VCFG.z_dim].numpy())
    elif case == "decode_tiled":
        z = rng.normal(size=(1, 3, 2, 3, VCFG.z_dim)).astype(np.float32)
        want = jvae.stepvideo_vae_decode_tiled(params, z, JVCFG, (2, 2), (1, 1))
        got = tvae.stepvideo_vae_decode_tiled(vae, torch.from_numpy(z), VCFG, (2, 2), (1, 1))
    else:
        chunks = 1 if case == "decode_chunk" else 2
        z = rng.normal(size=(1, 3 * chunks, 1, 2, VCFG.z_dim)).astype(np.float32)
        want = (jvae.stepvideo_decode_chunk(params["decoder"], z, JVCFG) if chunks == 1
                else jvae.stepvideo_vae_decode(params, z, JVCFG))
        got = (tvae.stepvideo_decode_chunk(vae, torch.from_numpy(z), VCFG) if chunks == 1
               else tvae.stepvideo_vae_decode(vae, torch.from_numpy(z), VCFG))
        assert got.shape == (1, 17 * chunks, 16, 32, 3)
    assert got.shape == np.asarray(want).shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VAE_TOL)


@pytest.fixture(scope="module")
def jax_vae_wants(models):
    """JAX's encode chunk of 17 frames of 16x32 and chunked decode of 6 latent frames of
    1x2, computed once for the module."""
    _, params = models["vae"]
    rng = np.random.default_rng(10)
    video = rng.uniform(-1, 1, size=(1, 17, 16, 32, 3)).astype(np.float32)
    z = rng.normal(size=(1, 6, 1, 2, VCFG.z_dim)).astype(np.float32)
    enc = jax.jit(lambda p, v: jvae.stepvideo_encode_chunk(p["encoder"], v, JVCFG))(
        params, video)
    return {"encode_chunk": (video, np.asarray(enc)),
            "decode_seams": (z, np.asarray(jvae.stepvideo_vae_decode(params, z, JVCFG)))}


@pytest.mark.parametrize("budget", [1, 48 << 10], ids=["one_frame", "few_frames"])
@pytest.mark.parametrize("case", ["encode_chunk", "decode_seams"])
def test_vae_budgets_split_work_without_changing_it(models, jax_vae_wants, case, budget,
                                                    monkeypatch):
    """The VAE's memory budgets cut to `budget` bytes, so the per-frame norm, the causal
    convs (the stride-2 Downsample3D's input windows and the time padding at the first
    chunk included) and the per-frame 2D ops run over chunks of one frame, or of a few
    frames whose seams fall elsewhere at each level, and the mid attention over blocks of
    7 query rows (the encoder's mid and each decode chunk's hold 40 tokens). Held to JAX at
    the module's limits, and to the port's unsplit result to float32 rounding (the same
    ops on fewer frames or keys; measured <= 1.2e-6 on outputs up to 1.6, limit 1e-5 x
    1e-5 relative)."""
    from goal_force_tpu_torch.models import vae as tvae_shared

    vae, _ = models["vae"]
    x, want = jax_vae_wants[case]
    fn = tvae.stepvideo_encode_chunk if case == "encode_chunk" else tvae.stepvideo_vae_decode
    # hundreds of tiny convs: one thread each, so that they stay cheap beside other workers
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        whole = fn(vae, torch.from_numpy(x), VCFG)
        monkeypatch.setattr(tvae, "NORM_F32_BYTES", budget)
        monkeypatch.setattr(tvae, "CONV_BYTES", budget)
        monkeypatch.setattr(tvae_shared, "MID_ATTENTION_ROWS", 7)
        got = fn(vae, torch.from_numpy(x), VCFG)
    finally:
        torch.set_num_threads(threads)
    assert got.shape == whole.shape == want.shape
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, **VAE_TOL)


def test_encode_sample_draws_from_the_generator(models):
    """With a generator the chunked encode returns mean + exp(logvar / 2) * eps, eps the
    generator's standard normal draw of the mean's shape (JAX draws from its key)."""
    vae, _ = models["vae"]
    video = torch.from_numpy(np.random.default_rng(10).uniform(
        -1, 1, size=(1, 17, 16, 32, 3)).astype(np.float32))
    mean, logvar = tvae.stepvideo_encode_chunk(vae, video, VCFG).chunk(2, dim=-1)
    got = tvae.stepvideo_vae_encode(vae, video, VCFG, generator=_gen(11))
    eps = torch.randn(mean.shape, generator=_gen(11))
    torch.testing.assert_close(got, mean + torch.exp(0.5 * logvar.clamp(-30, 20)) * eps)


def _noise(seed, shape):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))


def test_pipeline_cfg_untiled_matches_jax(models):
    """CFG 9.0 as two forwards a step, 2 Euler steps of the shift-13 reversed schedule,
    encode_prompt from the tiny BERT and Step-1 through make_stepvideo_prompt_encoder (hash
    ids at 77 and 320), 34 frames at 16x32 (6 latent frames of 1x2: the decode's two
    chunks and their seam mix), frames in [0, 1]."""
    (dit, jd), (vae, jv), (bert, jb), (step1, js) = (
        models[k] for k in ("dit", "vae", "bert", "step1"))
    bert_j, step1_j = _jax_config(jte.BertConfig, BERT), _jax_config(jte.Step1Config, STEP1)
    jp = jpipe.StepVideoPipeline(
        dit=jd, vae=jv, dit_cfg=JCFG, vae_cfg=JVCFG, dtype=jnp.float32,
        encode_prompt=jpipe.make_stepvideo_prompt_encoder(jb, bert_j, js, step1_j))
    tp = tpipe.StepVideoPipeline(
        dit=dit, vae=vae, dit_cfg=CFG, vae_cfg=VCFG, dtype=torch.float32,
        encode_prompt=tpipe.make_stepvideo_prompt_encoder(bert, BERT, step1, STEP1))
    kw = dict(prompt="a ball rolls left and hits a cup", negative_prompt="blurry",
              num_frames=34, height=16, width=32, num_inference_steps=2, seed=4)
    want = jp(**kw)
    got = tp(**kw, noise=_noise(4, (1, 6, 1, 2, 8)))
    assert got.shape == want.shape == (34, 16, 32, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **DIT_TOL)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Reference-format safetensors of the DiT, both VAE halves in one file, BERT over
    the vendored vocabulary and Step-1, and the state dicts written."""
    root = tmp_path_factory.mktemp("stepvideo_files")
    sds = {"dit": _perturb(tdit.init_stepvideo_dit(CFG, _gen(20), torch.float32,
                                                   device="cpu"), 21).state_dict(),
           "vae": _perturb(tvae.init_stepvideo_vae(VCFG, _gen(22), device="cpu"),
                           23).state_dict(),
           "bert": _perturb(tte.init_bert(BERT, _gen(24), device="cpu"), 25).state_dict(),
           "step1": _perturb(tte.init_step1(STEP1, _gen(26), torch.float32, device="cpu"),
                             27).state_dict()}
    paths = {}
    for name, sd in sds.items():
        paths[name] = str(root / f"{name}.safetensors")
        save_safetensors(sd, paths[name])
    return paths, sds


def test_from_pretrained_tiled_matches_jax(models, files):
    """The port's from_pretrained on reference-format files (BERT on the vendored
    WordPiece ids at 77 tokens, Step-1 on hash ids at 320) against JAX's pipeline on the
    same state dicts through JAX's converters, with the same BERT ids (held to JAX's
    tokenizer in tests/test_torch_tokenizer.py): a tiled request, 17 frames at 48x48 (3
    latent frames of 3x3 in tiles of 2x2 at a stride of 1x1: 4 tiles overlapping both
    ways), 2 steps of CFG 7.5."""
    from goal_force_tpu_torch.prompters import hunyuan_dit_tokenizers

    paths, sds = files
    tp = tpipe.StepVideoPipeline.from_pretrained(
        paths["dit"], vae_path=paths["vae"], bert_path=paths["bert"], step1_path=paths["step1"],
        bert_num_heads=2, step1_num_heads=4, vae_cfg=VCFG, dtype=torch.float32, device="cpu")
    assert tp.dit_cfg == CFG
    bert_j, step1_j = _jax_config(jte.BertConfig, BERT), _jax_config(jte.Step1Config, STEP1)
    jp = jpipe.StepVideoPipeline(
        dit=_jnp(jdit.stepvideo_dit_params_from_torch(_np_sd_of(sds["dit"]), JCFG)),
        vae=_jnp(jvae.stepvideo_vae_params_from_torch(_np_sd_of(sds["vae"]), JVCFG)),
        dit_cfg=JCFG, vae_cfg=JVCFG, dtype=jnp.float32,
        encode_prompt=jpipe.make_stepvideo_prompt_encoder(
            _jnp(jte.bert_params_from_torch(_np_sd_of(sds["bert"]), bert_j)), bert_j,
            _jnp(jte.step1_params_from_torch(_np_sd_of(sds["step1"]), step1_j)), step1_j,
            tokenize_bert=hunyuan_dit_tokenizers()[0]))
    kw = dict(prompt="小球滚过桌面, a red ball rolls", negative_prompt="", cfg_scale=7.5,
              num_frames=17, height=48, width=48, num_inference_steps=2, seed=5, tiled=True,
              tile_size=(2, 2), tile_stride=(1, 1))
    want = jp(**kw)
    got = tp(**kw, noise=_noise(5, (1, 3, 3, 3, 8)))
    assert got.shape == want.shape == (17, 48, 48, 3)
    np.testing.assert_allclose(got, want, **DIT_TOL)


def test_load_model_kinds(files):
    """stepvideo_dit, stepvideo_vae, step1_llm and bert load strictly, with configs equal
    to JAX's (Step-1's ffn_hidden_size is the fused w1's rows, multiple_of 1, as JAX reads
    it); a VAE half alone loads into a module with only that half; a missing key raises."""
    paths, sds = files
    for name, kind, kw in (("dit", "stepvideo_dit", {}), ("bert", "bert", {"num_heads": 2}),
                           ("step1", "step1_llm", {"num_heads": 4}),
                           ("vae", "stepvideo_vae", {"vae_cfg": VCFG})):
        got = tauto.load_model(paths[name], device="cpu", **kw)
        jkw = {"vae_cfg": JVCFG} if name == "vae" else kw
        want = jauto.load_model(paths[name], **jkw)
        assert got["kind"] == want["kind"] == kind
        assert dataclasses.asdict(got["config"]) == dataclasses.asdict(want["config"])
        msd = got["model"].state_dict()
        assert set(msd) == set(sds[name])
        for k, v in sds[name].items():
            assert torch.equal(msd[k], v), k
    assert tauto.load_model(paths["step1"], device="cpu", num_heads=4)["config"] \
        .ffn_hidden_size == 2 * STEP1.ff_dim
    dec = {k: v for k, v in sds["vae"].items() if k.startswith("decoder.")}
    model = tauto.load_model(dec, device="cpu", vae_cfg=VCFG)["model"]
    assert hasattr(model, "decoder") and not hasattr(model, "encoder")
    with pytest.raises(KeyError, match="missing"):
        tauto.load_model({k: v for k, v in sds["dit"].items() if ".attn2.wkv." not in k},
                         device="cpu")


def test_converters_round_trip(models):
    """port state dict -> JAX converter -> from_jax -> the same tensors (the DiT's fused
    projections back in the reference's per-head layout)."""
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    back = from_jax.params_from_jax({"stepvideo_dit": np_tree(models["dit"][1]),
                                     "stepvideo_vae": np_tree(models["vae"][1]),
                                     "bert": np_tree(models["bert"][1]),
                                     "step1": np_tree(models["step1"][1])})
    for key, name in (("dit", "stepvideo_dit"), ("vae", "stepvideo_vae"), ("bert", "bert"),
                      ("step1", "step1")):
        want, sd = models[key][0].state_dict(), back[name]
        assert set(sd) == set(want), name
        for k, v in want.items():
            assert torch.equal(sd[k], v), k


def test_configs_equal_jax():
    """The released defaults and the tiny configs equal JAX's, field for field."""
    pairs = [(tdit.StepVideoConfig(), jdit.StepVideoConfig()),
             (tvae.StepVideoVAEConfig(), jvae.StepVideoVAEConfig()),
             (tvae.tiny_stepvideo_vae_config(), jvae.tiny_stepvideo_vae_config()),
             (tte.BertConfig(), jte.BertConfig()), (tte.Step1Config(), jte.Step1Config())]
    for got, want in pairs:
        assert dataclasses.asdict(got) == dataclasses.asdict(want), type(got).__name__
    assert tdit.StepVideoConfig().dim == 6144 and tte.Step1Config().ff_dim == 16384
    # JAX builds its tiny DiT config inside init_random: held by value
    assert CFG == tdit.StepVideoConfig(num_heads=4, head_dim=16, num_layers=2, in_channels=8,
                                       caption_dim=32, clip_dim=16, rope_split=(8, 4, 4))


def test_entry_points_need_cuda_unless_cpu_is_asked(files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    paths, _ = files
    with pytest.raises(RuntimeError, match="CUDA"):
        tpipe.StepVideoPipeline.init_random()
    with pytest.raises(RuntimeError, match="CUDA"):
        tpipe.StepVideoPipeline.from_pretrained(paths["dit"])
    pipe = tpipe.StepVideoPipeline.init_random(device="cpu")
    assert pipe.device.type == "cpu" and not hasattr(pipe.vae, "encoder")
