"""HunyuanVideo-I2V's LLaVA prompt tower in the port against the JAX package: CLIP's vision
side (intermediate hidden states, projected image features, the similarity matrix),
the CLIP image preprocessing (exact), ``llava_encode`` (one and two rows, skip 0 and 2;
the image id lies past the tiny vocabulary, so both gathers clamp), the MLLM crop (with
and without truncation, exact), the LLaVA prompt encoder with and without an image,
``load_model``'s ``llava`` kind in both key layouts, the converters, and one tiny I2V
request with CFG through ``from_pretrained`` on reference-format files (a synthetic
``tokenizer.json`` that maps ``<image>`` to 128257 and the double return to 271).

Weights are the port's random ones, offset so that no bias or norm weight is trivial,
read by JAX through its own converters. float32 limits: XLA and torch round the same
matmuls and reductions differently (~1e-6 relative per op); through a few layers the
outputs (|x| up to ~5) agree to ~1e-5, limit 1e-4 (x 1e-4 relative); through the DiT and
two Euler steps 5e-4 (x 1e-3 relative), as the HunyuanVideo tests."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from goal_force_tpu.io import auto as jauto
from goal_force_tpu.models import clip as jclip
from goal_force_tpu.models import hunyuan_video_vae as jvae
from goal_force_tpu.models import llava as jllava
from goal_force_tpu.models import text_encoders as jte
from goal_force_tpu.pipelines import hunyuan_video as jpipe
from goal_force_tpu.prompters import load_text_tokenizer as jload_text_tokenizer

from goal_force_tpu_torch.io import auto as tauto
from goal_force_tpu_torch.io import from_jax
from goal_force_tpu_torch.io.safetensors_io import save_safetensors
from goal_force_tpu_torch.models import clip as tclip
from goal_force_tpu_torch.models import hunyuan_video_dit as tdit
from goal_force_tpu_torch.models import hunyuan_video_vae as tvae
from goal_force_tpu_torch.models import llava as tllava
from goal_force_tpu_torch.models import text_encoders as tte
from goal_force_tpu_torch.pipelines import hunyuan_video as tpipe
from goal_force_tpu_torch.prompters import load_text_tokenizer

F32 = dict(rtol=1e-4, atol=1e-4)
DIT_TOL = dict(rtol=1e-3, atol=5e-4)

# 336 px at patch 14: the released 576 image tokens, which the I2V template's crop
# offsets assume; the tower is narrow and 3 layers deep
VISION = tclip.CLIPConfig(image_size=336, patch_size=14, vision_dim=128, vision_heads=2,
                          vision_layers=3, hidden_act="quick_gelu")
TEXT = tte.LlamaConfig(hidden_size=32, num_layers=3, num_heads=4, num_kv_heads=2,
                       intermediate_size=64, vocab=1000)
CFG = tllava.LlavaConfig(text=TEXT, vision=VISION)
CLIP_TEXT = tclip.CLIPConfig(vocab_size=49408, text_dim=32, text_heads=4, text_layers=2,
                             max_positions=77)
DIT_CFG = dataclasses.replace(tpipe.tiny_hunyuan_config(), pooled_dim=32)
VCFG = tvae.tiny_hunyuan_vae_config()
JVCFG = jvae.tiny_hunyuan_vae_config()
PROMPT = "a red ball rolls across the table and hits a blue cup"


def _perturb(model, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.05)
    return model


def _np_sd(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _new_layout(sd):
    """The transformers >= 4.52 key layout of an on-disk LLaVA state dict, with a head."""
    out = {}
    for k, v in sd.items():
        for old, new in (("language_model.model.", "model.language_model."),
                         ("vision_tower.", "model.vision_tower."),
                         ("multi_modal_projector.", "model.multi_modal_projector.")):
            if k.startswith(old):
                out[new + k[len(old):]] = v
    out["lm_head.weight"] = torch.zeros(TEXT.vocab, TEXT.hidden_size)
    return out


@pytest.fixture(scope="module")
def llava_pair():
    model = _perturb(tllava.init_llava(CFG, torch.Generator().manual_seed(0), torch.float32,
                                       device="cpu"), 1)
    sd = _np_sd(model.state_dict())
    jcfg = jauto.infer_llava_config(sd, num_heads=TEXT.num_heads)
    return model, _jnp(jllava.llava_params_from_torch(sd, jcfg)), jcfg


def _hf_clip_state_dict(text: tclip.CLIPTextModel, vision: tclip.CLIPVisionModel):
    """An HF ``CLIPModel`` state dict from the port's text tower (SD names) and vision
    tower (HF names)."""
    sd = {"text_model.embeddings.token_embedding.weight": text.token_embedding.weight,
          "text_model.embeddings.position_embedding.weight": text.position_embeds[0],
          "text_model.final_layer_norm.weight": text.final_layer_norm.weight,
          "text_model.final_layer_norm.bias": text.final_layer_norm.bias,
          "text_projection.weight": text.text_projection.weight,
          "visual_projection.weight": vision.visual_projection.weight,
          "logit_scale": torch.tensor(2.3)}
    for k, v in text.state_dict().items():
        if k.startswith("encoders."):
            i, rest = k[len("encoders."):].split(".", 1)
            rest = (rest.replace("attn.to_q", "self_attn.q_proj").replace("attn.to_k", "self_attn.k_proj")
                    .replace("attn.to_v", "self_attn.v_proj").replace("attn.to_out", "self_attn.out_proj")
                    .replace("fc1", "mlp.fc1").replace("fc2", "mlp.fc2"))
            sd[f"text_model.encoder.layers.{i}.{rest}"] = v
    sd.update(vision.state_dict())
    return _np_sd({k: v.detach() for k, v in sd.items()})


def test_clip_vision_matches_jax():
    """Hidden states of layers -2 and 1, the projected image features (with every
    post-LN token) and the similarity matrix, with narrow 2-layer towers."""
    small = dict(text_dim=64, text_heads=2, text_layers=2, image_size=56, patch_size=14,
                 vision_dim=128, vision_heads=2, vision_layers=2, proj_dim=48)
    cfg = tclip.CLIPConfig(**small)
    gen = torch.Generator().manual_seed(3)
    text = _perturb(tclip.init_clip_text(cfg, gen, device="cpu", projection=True), 4)
    vision = _perturb(tclip.init_clip_vision(cfg, gen, device="cpu", projection=True), 5)
    jcfg = jclip.CLIPConfig(**small)
    params = _jnp(jclip.clip_params_from_hf(_hf_clip_state_dict(text, vision), jcfg))
    rng = np.random.default_rng(6)
    pixels = rng.normal(size=(2, 56, 56, 3)).astype(np.float32)
    ids = rng.integers(1, 49000, size=(3, 9))
    ids[:, -1] = cfg.eos_token_id
    tp = torch.from_numpy(pixels)
    for layer in (-2, 1):
        want = jax.jit(lambda p, x: jclip.clip_vision_hidden_states(p, jcfg, x, layer))(params, pixels)
        got = tclip.clip_vision_hidden_states(vision, cfg, tp, layer)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    want_f, want_t = jax.jit(lambda p, x: jclip.clip_encode_image(p, jcfg, x, True))(params, pixels)
    got_f, got_t = tclip.clip_encode_image(vision, cfg, tp, return_tokens=True)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), **F32)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), **F32)
    np.testing.assert_allclose(tclip.clip_encode_image(vision, cfg, tp).numpy(),
                               np.asarray(want_f), **F32)
    want = jax.jit(lambda p, x, i: jclip.clip_similarity(p, jcfg, x, i))(params, pixels, ids)
    got = tclip.clip_similarity(text, vision, cfg, tp, torch.from_numpy(ids), 2.3)
    assert got.shape == (3, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_clip_preprocess_image_is_exact():
    from PIL import Image

    rng = np.random.default_rng(7)
    u8 = rng.integers(0, 256, size=(300, 420, 3), dtype=np.uint8)
    for image in (u8, rng.uniform(0, 1, size=(500, 333, 3)).astype(np.float32),
                  Image.fromarray(u8[:200]).convert("L")):
        want = jllava.clip_preprocess_image(image, 336)
        got = tllava.clip_preprocess_image(image, 336)
        assert got.shape == (336, 336, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def _llava_inputs(rows, seed=8):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, TEXT.vocab, size=(rows, 12))
    mask = np.ones((rows, 12), np.int32)
    for i in range(rows):
        ids[i, 3 + 2 * i] = CFG.image_token_id
        mask[i, 9 - i:] = 0
    return ids, mask, rng.normal(size=(rows, 336, 336, 3)).astype(np.float32)


@pytest.mark.parametrize("rows,skip", [(1, 2), (2, 2), (2, 0)])
def test_llava_encode_matches_jax(llava_pair, rows, skip):
    model, params, jcfg = llava_pair
    ids, mask, pixels = _llava_inputs(rows)
    encode = jax.jit(lambda p, x, m: jllava.llava_encode(p, jcfg, ids, x, m, skip))
    want = encode(params, pixels, mask)
    got = tllava.llava_encode(model, CFG, ids, torch.from_numpy(pixels), torch.from_numpy(mask),
                              hidden_state_skip_layer=skip)
    assert got.shape == (rows, 12 - 1 + 576, TEXT.hidden_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_crop_mllm_hidden_states_matches_jax():
    """Row 0 ends with the assistant's double return; row 1 was truncated, so its only
    double returns are the scaffold's, at or before crop_start."""
    tpl = jpipe.HUNYUAN_PROMPT_TEMPLATES["video-i2v"]
    s = 140
    ids = np.full((2, s), 9, np.int64)
    ids[:, [2, 40, tpl["crop_start"]]] = 271
    ids[0, 120] = 271
    mask = np.ones((2, s), np.int32)
    mask[0, 125:] = 0
    hidden = np.random.default_rng(9).normal(size=(2, s - 1 + 576, 8)).astype(np.float32)
    want_h, want_m = jpipe.crop_mllm_hidden_states(jnp.asarray(hidden), ids, mask, tpl)
    got_h, got_m = tpipe.crop_mllm_hidden_states(torch.from_numpy(hidden), ids, mask, tpl)
    assert got_h.shape == (2, 144 + s - tpl["crop_start"] - 4, 8)
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


WORDS = ("a red ball rolls across the table and hits blue cup system user assistant "
         "Describe video by detailing following aspects according to reference image "
         "The main content theme of").split()


def _write_tokenizer(root):
    """A word-level tokenizer.json over a dense vocabulary of 128,258 ids: the Llama
    template's special tokens, <image> = 128257 and the double return = 271 matched
    verbatim, a few words, every other word <unk>."""
    from tokenizers import AddedToken, Tokenizer, models, pre_tokenizers

    specials = {"<unk>": 0, "<pad>": 1, "<|start_header_id|>": 2, "<|end_header_id|>": 3,
                "<|eot_id|>": 4, "\n\n": 271, "<image>": CFG.image_token_id}
    named = {**specials, **{w: 10 + i for i, w in enumerate(WORDS)}}
    by_id = {i: t for t, i in named.items()}
    vocab = {by_id.get(i, f"<f{i}>"): i for i in range(CFG.image_token_id + 1)}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.add_special_tokens([AddedToken(s, normalized=False) for s in specials
                            if s not in ("<unk>", "<pad>")])
    root.mkdir()
    tok.save(str(root / "tokenizer.json"))
    return str(root)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Reference-format safetensors of the tiny LLaVA (both key layouts), a DiT with
    pooled_dim 32, a 2-layer CLIP-L-shaped text tower and both VAE halves, and the
    synthetic Llama tokenizer directory."""
    root = tmp_path_factory.mktemp("llava_files")
    gen = lambda s: torch.Generator().manual_seed(s)
    llava = _perturb(tllava.init_llava(CFG, gen(20), torch.float32, device="cpu"), 21)
    vae = {}
    for cls, s in ((tvae.HunyuanVAEEncoder, 24), (tvae.HunyuanVAEDecoder, 25)):
        vae.update(_perturb(tvae.init_hunyuan_vae(cls, VCFG, gen(s), device="cpu"), s).state_dict())
    sds = {"llava": llava.state_dict(), "llava_new": _new_layout(llava.state_dict()),
           "dit": _perturb(tdit.init_hunyuan_video_dit(DIT_CFG, gen(22), torch.float32,
                                                       device="cpu"), 23).state_dict(),
           "clip": _perturb(tclip.init_clip_text(CLIP_TEXT, gen(26), device="cpu"), 27).state_dict(),
           "vae": vae}
    paths = {}
    for name, sd in sds.items():
        paths[name] = str(root / f"{name}.safetensors")
        save_safetensors(sd, paths[name])
    paths["tokenizer"] = _write_tokenizer(root / "llama_tokenizer")
    return paths, sds


@pytest.fixture(scope="module")
def jitted_jax_towers():
    """JAX's LLaVA and Llama paths jitted (eager JAX compiles every op anew: ~20 s more).
    The same functions, looked up by name where the JAX pipeline calls them."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jllava, "llama_layers", jax.jit(jllava.llama_layers, static_argnums=(1, 4)))
    mp.setattr(jllava, "clip_vision_hidden_states",
               jax.jit(jllava.clip_vision_hidden_states, static_argnums=(1, 3)))
    mp.setattr(jte, "llama_encode", jax.jit(
        jte.llama_encode, static_argnums=(1,), static_argnames=("hidden_state_skip_layer",)))
    yield
    mp.undo()


def test_llava_prompt_encoder_matches_jax(files, jitted_jax_towers):
    """With an image: the I2V template through the vision tower and the decoder, then the
    crop (144 image features + the prompt's 252 text positions). Without: the text
    template on the tower's Llama (256 positions)."""
    paths, _ = files
    tmodel = tauto.load_model(paths["llava"], device="cpu", num_heads=4)
    jr = jauto.load_model(paths["llava"], num_heads=4)
    tok_t = load_text_tokenizer(paths["tokenizer"], 256)
    tok_j = jload_text_tokenizer(paths["tokenizer"], 256)
    tenc = tpipe.make_llava_prompt_encoder(tmodel["model"], tmodel["config"], None, None, 256,
                                           tokenize_llama=tok_t)
    jenc = jpipe.make_llava_prompt_encoder(_jnp(jr["params"]), jr["config"], None, None, 256,
                                           tokenize_llama=tok_j)
    image = np.random.default_rng(10).uniform(0, 1, size=(40, 56, 3)).astype(np.float32)
    for args, length in (((PROMPT, image), 144 + 252), ((PROMPT,), 256)):
        got, want = tenc(*args), jenc(*args)
        assert got[0].shape == (1, length, TEXT.hidden_size)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **F32)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def _noise(seed, shape):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))


def test_i2v_cfg_request_through_from_pretrained_matches_jax(files, jitted_jax_towers):
    """Both packages' from_pretrained on the same files with a LLaVA text encoder: an I2V
    request with CFG (the positive row's 396 tokens and the negative row's 256 padded to
    one length, so the rows' kv_len differ), i2v stability and token replace, 2 steps,
    latents out. JAX's VAE encode runs through its own per-shape jit."""
    paths, _ = files
    common = dict(dit_path=paths["dit"], llama_path=paths["llava"], clip_path=paths["clip"],
                  vae_decoder_path=paths["vae"], llama_tokenizer_dir=paths["tokenizer"],
                  llama_num_heads=4, clip_num_heads=4, num_heads=24, rope_dims=(2, 2, 2))
    jp = jpipe.HunyuanVideoPipeline.from_pretrained(**common, vae_cfg=JVCFG, dtype=jnp.float32)
    jv = _jnp(jauto.load_model(paths["vae"], vae_cfg=JVCFG)["params"])
    jp.encode_video = lambda v: jvae._jit_hv_encode(JVCFG)(jv["encoder"], v)
    jp.decode_video = None
    tp = tpipe.HunyuanVideoPipeline.from_pretrained(**common, vae_cfg=VCFG, dtype=torch.float32,
                                                    device="cpu")
    tp.decode_video = None
    seen = []
    embed = tp._embed
    tp._embed = lambda *a, **kw: seen.append(embed(*a, **kw)) or seen[-1]
    kw = dict(prompt=PROMPT, negative_prompt="blurry static", cfg_scale=5.0, height=32,
              width=32, num_frames=5, num_inference_steps=2, seed=3,
              input_images=np.random.default_rng(11).uniform(0, 1, size=(32, 32, 3))
              .astype(np.float32))
    want = np.asarray(jp(**kw))
    got = tp(**kw, noise=_noise(3, (1, 2, 4, 4, 16)))
    assert [e[0].shape[1] for e in seen] == [144 + 252, 256]
    assert got.shape == want.shape == (1, 2, 4, 4, 16)
    np.testing.assert_allclose(got, want, **DIT_TOL)


def test_load_model_llava_in_both_layouts(files):
    """The config equals JAX's, the transformers >= 4.52 layout (with its lm_head) gives
    the same weights, and a LLaVA file without its vision tower is refused."""
    paths, sds = files
    got = tauto.load_model(paths["llava"], device="cpu", num_heads=4)
    want = jauto.load_model(paths["llava"], num_heads=4)
    assert got["kind"] == want["kind"] == "llava"
    assert json.dumps(dataclasses.asdict(got["config"]), sort_keys=True) == \
        json.dumps(dataclasses.asdict(want["config"]), sort_keys=True)
    new = tauto.load_model(paths["llava_new"], device="cpu", num_heads=4)
    assert new["config"] == got["config"]
    for k, v in got["model"].state_dict().items():
        assert torch.equal(new["model"].state_dict()[k], v), k
    jnew = jauto.load_model(paths["llava_new"], num_heads=4)["params"]
    np.testing.assert_array_equal(np.asarray(jnew["proj"]["w2"]),
                                  np.asarray(want["params"]["proj"]["w2"]))
    partial = {k: v for k, v in sds["llava"].items() if not k.startswith("vision_tower.")}
    with pytest.raises(KeyError):
        tauto.load_model(partial, device="cpu", num_heads=4, config=got["config"])


def test_llava_converter_round_trips(llava_pair):
    """port state dict -> JAX converter -> from_jax -> the same tensors."""
    model, params, _ = llava_pair
    back = from_jax.params_from_jax({"llava": jax.tree_util.tree_map(np.asarray, params)})
    want = model.state_dict()
    assert set(back["llava"]) == set(want)
    for k, v in want.items():
        assert torch.equal(back["llava"][k], v), k
