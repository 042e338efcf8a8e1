"""The port's tokenizer readers against the JAX package's, on the vendored tokenizer
files: the pure-Python SentencePiece reader (unigram T5 vocabularies and ChatGLM3's
byte-fallback BPE), load_text_tokenizer's dispatch (CLIP BPE included), and
load_tokenizer on directories (SentencePiece, HF fast-tokenizer, none). Ids and masks
must be equal."""

import os
import shutil
import warnings

import numpy as np
import pytest

from goal_force_tpu import prompters as jprompters
from goal_force_tpu.models import spm as jspm
from goal_force_tpu.models import tokenizer as jtok

from goal_force_tpu_torch import prompters as tprompters
from goal_force_tpu_torch.models import spm as tspm
from goal_force_tpu_torch.models import tokenizer as ttok

ASSETS = os.path.join(os.path.dirname(jprompters.__file__), "tokenizer_assets")
LENGTH = 32
PROMPTS = [
    "a red ball rolls across a wooden table and hits a blue cup",
    "Ein Ball rollt über den Tisch – 小球滚过桌面, naïve café №5 🎾",
    "  extra   spaces\tand &amp; html &lt;b&gt; <extra_id_3> inside  ",
    "",
    " ".join(["a marble is flicked towards a stack of dominoes"] * 12),   # > LENGTH
]
# (tokenizer file, add_eos): T5 / umt5-style unigram vocabularies with EOS, and
# ChatGLM3's BPE with byte fallback, which its prompter encodes without EOS
MODELS = [("cog/tokenizer/spiece.model", True), ("flux/tokenizer_2/spiece.model", True),
          ("stable_diffusion_3/tokenizer_3/spiece.model", True),
          ("kolors/tokenizer/tokenizer.model", False)]


def _asset(rel):
    return os.path.join(ASSETS, rel)


@pytest.fixture(scope="module", params=MODELS, ids=lambda m: m[0].split("/")[0])
def model(request):
    rel, add_eos = request.param
    path = _asset(rel)
    return (tspm.SentencePieceTokenizer.from_file(path),
            jspm.SentencePieceTokenizer.from_file(path), add_eos, path)


@pytest.mark.parametrize("prompt", PROMPTS, ids=["ascii", "unicode", "specials", "empty",
                                                 "long"])
def test_spm_ids_equal_jax(model, prompt):
    tok, ref, add_eos, _ = model
    got = tok.encode(prompt, add_eos=add_eos)
    assert got == ref.encode(prompt, add_eos=add_eos)
    assert tok.decode(got) == ref.decode(got)


def test_spm_model_fields_equal_jax(model):
    """Equal, but for the port reading a negative int32 id (-1: no such piece) as -1,
    where the JAX reader keeps its varint's 2**64 - 1."""
    tok, ref, _, _ = model
    assert tok.m.pieces == ref.m.pieces
    for f in ("model_type", "byte_fallback", "add_dummy_prefix",
              "remove_extra_whitespaces", "escape_whitespaces"):
        assert getattr(tok.m, f) == getattr(ref.m, f), f
    for f in ("unk_id", "bos_id", "eos_id", "pad_id"):
        want = getattr(ref.m, f)
        assert getattr(tok.m, f) == (want - 2**64 if want >= 2**63 else want), f
    assert tok.special == ref.special and len(tok) == len(ref)


def test_text_tokenizer_pads_and_truncates_as_jax(model):
    """ChatGLM3's model has no pad piece: the port pads with its unk id, and the JAX
    tokenizer, whose pad id is 2**64 - 1 there, fails on padding; it is held against
    the JAX encoding padded with the unk id."""
    _, jtok_spm, add_eos, path = model
    tok = tprompters.load_text_tokenizer(path, LENGTH, add_eos=add_eos)
    ref = jprompters.load_text_tokenizer(path, LENGTH, add_eos=add_eos)
    if jtok_spm.m.pad_id >= 2**63:
        assert tok.pad_id == jtok_spm.m.unk_id
        with pytest.raises(OverflowError):
            ref(PROMPTS[0])
        ref = jprompters.TextTokenizer(ref.encode, LENGTH, jtok_spm.m.unk_id)
    assert tok.pad_id == ref.pad_id
    for prompt in PROMPTS:
        with warnings.catch_warnings(record=True) as w_tok:
            warnings.simplefilter("always")
            got = tok(prompt)
        with warnings.catch_warnings(record=True) as w_ref:
            warnings.simplefilter("always")
            want = ref(prompt)
        assert got.dtype == np.int32 and got.shape == (LENGTH,)
        np.testing.assert_array_equal(got, want)
        assert len(w_tok) == len(w_ref)      # both warn on truncation, and only then
    assert len(w_tok) == 1


@pytest.mark.parametrize("rel", ["cog/tokenizer", "flux/tokenizer_2",
                                 "stable_diffusion_3/tokenizer_3"])
def test_load_text_tokenizer_dispatch_equals_jax(rel):
    """cog holds spiece.model only; flux and SD3 hold tokenizer.json (the tokenizers
    runtime) beside it."""
    if rel != "cog/tokenizer":
        pytest.importorskip("tokenizers")
    tok = tprompters.wan_umt5_tokenizer(_asset(rel), LENGTH)
    ref = jprompters.wan_umt5_tokenizer(_asset(rel), LENGTH)
    assert hasattr(tok, "spm") == hasattr(ref, "spm")
    for prompt in PROMPTS[:4]:
        np.testing.assert_array_equal(tok(prompt), ref(prompt))


@pytest.mark.parametrize("rel", ["flux/tokenizer_1", "hunyuan_dit/tokenizer"])
def test_unported_tokenizer_kinds_raise(rel):
    """Both kinds raised NotImplementedError before their branches were ported: Flux's CLIP
    BPE directory (vocab.json + merges.txt, models/clip_bpe.py) and HunyuanDiT's BERT
    WordPiece directory (vocab.txt, tokenizers.BertWordPieceTokenizer). Each now gives
    JAX's ids, pad id and truncation (BERT's without a forced last id)."""
    tok = tprompters.load_text_tokenizer(_asset(rel), LENGTH)
    ref = jprompters.load_text_tokenizer(_asset(rel), LENGTH)
    assert (tok.pad_id, tok.force_last) == (ref.pad_id, ref.force_last)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # the long prompt is truncated in both
        for prompt in PROMPTS:
            np.testing.assert_array_equal(tok(prompt), ref(prompt))


# BERT (HunyuanDiT's CLIP tower, StepVideo's first text stream) at 77 tokens
BERT_PROMPTS = [
    "a red ball rolls across a wooden table and hits a blue cup",
    "一只红色的小球滚过木桌，撞倒了蓝色的杯子",
    "Déjà vu: naïve café, Ångström, Straße, ÉCOLE",
    "Hello, world! (test) [MASK] don't -- 3.14; \"quoted\" & <b>tags</b>?",
    "",
    " ".join(["a marble is flicked towards a stack of dominoes"] * 12),   # > 77 tokens
]


@pytest.fixture(scope="module")
def bert_pair():
    return tprompters.hunyuan_dit_tokenizers(), jprompters.hunyuan_dit_tokenizers()


@pytest.mark.parametrize("prompt", BERT_PROMPTS, ids=["english", "chinese", "accents",
                                                      "punctuation", "empty", "long"])
def test_bert_ids_equal_jax(bert_pair, prompt):
    """[CLS] ... [SEP], pad id 0, 77 ids; the long prompt is cut at 77 with no [SEP]
    forced into the last slot, in both."""
    (tok, t5), (ref, rt5) = bert_pair
    assert t5 is None and rt5 is None
    assert (tok.length, tok.pad_id, tok.force_last) == (ref.length, ref.pad_id, None)
    assert tok.encode(prompt) == ref.encode(prompt)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got, want = tok(prompt), ref(prompt)
    assert got.dtype == np.int32 and got.shape == (77,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num_sentences", [None, 3])
def test_tokenize_long_prompt_equals_jax(bert_pair, num_sentences):
    """One encoding of the whole prompt, padded to a multiple of 77 and cut into rows (2
    rows needed; 3 forced: one all-pad row); fewer rows than needed raise in both."""
    (tok, _), (ref, _) = bert_pair
    got = tprompters.tokenize_long_prompt(tok, BERT_PROMPTS[-1], num_sentences)
    want = jprompters.tokenize_long_prompt(ref, BERT_PROMPTS[-1], num_sentences)
    assert got.dtype == np.int32 and got.shape == (num_sentences or 2, 77)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="sentences"):
        tprompters.tokenize_long_prompt(tok, BERT_PROMPTS[-1], 1)


@pytest.mark.parametrize("helper", ["sd_clip_tokenizer", "sdxl_tokenizers", "sd3_tokenizers",
                                    "flux_tokenizers", "kolors_tokenizer"])
def test_family_tokenizers_equal_jax(helper):
    """Each family helper over the vendored files: every tokenizer it returns gives JAX's
    ids (padding side, pad id and prefix included) on two prompts."""
    pytest.importorskip("tokenizers")
    got, want = getattr(tprompters, helper)(), getattr(jprompters, helper)()
    got, want = (got if isinstance(got, tuple) else (got,)), (
        want if isinstance(want, tuple) else (want,))
    assert len(got) == len(want)
    for tok, ref in zip(got, want):
        assert (tok.length, tok.pad_id, tok.pad_side) == (ref.length, ref.pad_id, ref.pad_side)
        for prompt in PROMPTS[:2]:
            np.testing.assert_array_equal(tok(prompt), ref(prompt))


def test_all_names_equal_jax():
    assert sorted(tprompters.__all__) == sorted(jprompters.__all__)
    assert all(hasattr(tprompters, name) for name in tprompters.__all__)


def _spiece_dir(tmp_path, rel):
    d = tmp_path / rel.replace("/", "_")
    d.mkdir()
    src = os.path.dirname(_asset(rel))
    for name in ("spiece.model", "added_tokens.json"):
        if os.path.exists(os.path.join(src, name)):
            shutil.copy(os.path.join(src, name), d / name)
    return str(d)


@pytest.mark.parametrize("rel", ["cog/tokenizer/spiece.model",
                                 "flux/tokenizer_2/spiece.model"])
def test_load_tokenizer_on_a_spiece_directory_equals_jax(tmp_path, rel):
    d = _spiece_dir(tmp_path, rel)
    tok = ttok.load_tokenizer(d, 256384, LENGTH)
    ref = jtok.load_tokenizer(d, 256384, LENGTH)
    assert isinstance(tok, ttok.SpmTokenizer)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # the long prompt is truncated in both
        ids, mask = tok(PROMPTS)
        rids, rmask = ref(PROMPTS)
    assert ids.dtype == mask.dtype == np.int32 and ids.shape == (len(PROMPTS), LENGTH)
    np.testing.assert_array_equal(ids, rids)
    np.testing.assert_array_equal(mask, rmask)
    assert mask[0].sum() == (ids[0] != tok.tok.pad_id).sum() and mask[-1].all()


def test_load_tokenizer_without_a_path_warns_and_hashes():
    with pytest.warns(UserWarning, match="HashTokenizer"):
        tok = ttok.load_tokenizer(None, 1000, 16)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        quiet = ttok.load_tokenizer(None, 1000, 16, quiet=True)
    ref = jtok.load_tokenizer(None, 1000, 16, quiet=True)
    for t in (tok, quiet):
        assert isinstance(t, ttok.HashTokenizer)
        for a, b in zip(t(PROMPTS[:3]), ref(PROMPTS[:3])):
            np.testing.assert_array_equal(a, b)


def test_hf_tokenizer_directory_equals_jax(tmp_path):
    """A directory with tokenizer.json and tokenizer_config.json goes to
    transformers.AutoTokenizer in both packages."""
    pytest.importorskip("transformers")
    d = tmp_path / "hf"
    d.mkdir()
    shutil.copy(_asset("flux/tokenizer_2/tokenizer.json"), d / "tokenizer.json")
    (d / "tokenizer_config.json").write_text(
        '{"tokenizer_class": "PreTrainedTokenizerFast", "pad_token": "<pad>", '
        '"eos_token": "</s>", "unk_token": "<unk>"}')
    tok = ttok.load_tokenizer(str(d), 256384, LENGTH)
    ref = jtok.load_tokenizer(str(d), 256384, LENGTH)
    assert isinstance(tok, ttok.HFTokenizer)
    for a, b in zip(tok(PROMPTS), ref(PROMPTS)):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
