"""Text tokenizers from a tokenizer directory, and each family's vendored tokenizers.

Port of ``goal_force_tpu/prompters.py``: ``TextTokenizer`` (encode, then pad or truncate
to a fixed length), ``tokenize_long_prompt`` (one encoding cut into rows of the context
length), ``load_text_tokenizer`` with its CLIP BPE (``vocab.json`` + ``merges.txt``,
through ``models/clip_bpe.py``), ``tokenizer.json`` (the ``tokenizers`` runtime),
``spiece.model`` and ``tokenizer.model`` (``models/spm.py``) and BERT WordPiece
(``vocab.txt``, through ``tokenizers.BertWordPieceTokenizer``, the engine of JAX's
``BertTokenizerFast``: ``[CLS] ... [SEP]``, pad id 0, truncation with no forced last id)
branches, and the family helpers over the vendored files (SD, SDXL, SD3, Flux, CogVideoX,
HunyuanDiT, HunyuanVideo, Kolors, Wan's umt5). The vendored tokenizer files are read from
the JAX package's ``tokenizer_assets`` directory by path (``asset_path``); nothing of that
package is imported. Optional packages (``tokenizers``) are imported where they are used.
"""

from __future__ import annotations

import os
import warnings
from typing import Callable, List, Optional

import numpy as np

ASSET_ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "goal_force_tpu", "tokenizer_assets")


def asset_path(*parts: str) -> str:
    """A vendored tokenizer file or directory, by its path under ``ASSET_ROOT``."""
    return os.path.join(ASSET_ROOT, *parts)


class TextTokenizer:
    """Uniform wrapper: __call__(text) -> (length,) int32 ids, padded/truncated.

    `encode(text)` returns the raw (unpadded) id list. `pad_id`, `length`,
    `pad_side` control the padding applied by __call__.
    """

    def __init__(self, encode_fn: Callable[[str], List[int]], length: int,
                 pad_id: int, pad_side: str = "right",
                 force_last: Optional[int] = None):
        self._encode = encode_fn
        self.length = length
        self.pad_id = pad_id
        self.pad_side = pad_side
        self.force_last = force_last   # id forced at the last slot on truncation

    def encode(self, text: str) -> List[int]:
        return list(self._encode(text))

    def __call__(self, text: str) -> np.ndarray:
        ids = self.encode(text)
        if len(ids) > self.length:
            warnings.warn(f"prompt of {len(ids)} tokens truncated to {self.length}",
                          stacklevel=2)
            ids = ids[:self.length]
            if self.force_last is not None:
                ids[-1] = self.force_last
        pad = [self.pad_id] * (self.length - len(ids))
        ids = pad + ids if self.pad_side == "left" else ids + pad
        return np.asarray(ids, np.int32)

    def with_length(self, length: int) -> "TextTokenizer":
        return TextTokenizer(self._encode, length, self.pad_id, self.pad_side,
                             self.force_last)


def tokenize_long_prompt(tok: TextTokenizer, text: str,
                         num_sentences: Optional[int] = None) -> np.ndarray:
    """(num_sentences, tok.length) int32: the whole prompt encoded once (its special
    tokens around the whole sequence), right-padded with the pad id to a multiple of the
    context length and cut into rows. `num_sentences` forces the row count (extra rows
    all padding); a prompt that needs more rows raises ValueError."""
    ids = tok.encode(text)
    length = tok.length
    ns = max(1, -(-len(ids) // length))
    if num_sentences is not None:
        if ns > num_sentences:
            raise ValueError(f"prompt needs {ns} sentences > requested {num_sentences}")
        ns = num_sentences
    ids = ids + [tok.pad_id] * (ns * length - len(ids))
    return np.asarray(ids, np.int32).reshape(ns, length)


def load_text_tokenizer(path: str, length: int = 77,
                        add_eos: bool = False) -> TextTokenizer:
    """A TextTokenizer from a tokenizer directory (or a ``.model`` file), dispatched on
    the directory's files in the JAX package's order."""
    if os.path.isfile(path) and path.endswith(".model"):
        return _spm_tokenizer(path, length, add_eos)
    files = set(os.listdir(path)) if os.path.isdir(path) else set()
    if "vocab.json" in files and "merges.txt" in files:
        return _clip_tokenizer(path, length)
    if "tokenizer.json" in files:
        return _fast_tokenizer(os.path.join(path, "tokenizer.json"), length)
    if "spiece.model" in files:
        return _spm_tokenizer(os.path.join(path, "spiece.model"), length, add_eos)
    if "tokenizer.model" in files:
        return _spm_tokenizer(os.path.join(path, "tokenizer.model"), length, add_eos)
    if "vocab.txt" in files:
        return _bert_tokenizer(path, length)
    raise ValueError(f"no recognizable tokenizer files in {path!r}: {sorted(files)}")


def _clip_tokenizer(path: str, length: int) -> TextTokenizer:
    """CLIP BPE over vocab.json/merges.txt (``models/clip_bpe.py``); the pad token comes
    from the directory's ``tokenizer_config.json`` (SD pads with eot 49407, SDXL's second
    tokenizer with '!' = 0), and truncation keeps eot in the last slot."""
    import json

    from goal_force_tpu_torch.models.clip_bpe import CLIPBPETokenizer

    tok = CLIPBPETokenizer.from_hf(os.path.join(path, "vocab.json"),
                                   os.path.join(path, "merges.txt"))
    pad_id = tok.eot_id
    cfg_file = os.path.join(path, "tokenizer_config.json")
    if os.path.exists(cfg_file):
        with open(cfg_file) as f:
            cfg = json.load(f)
        pad_tok = cfg.get("pad_token")
        if isinstance(pad_tok, dict):
            pad_tok = pad_tok.get("content")
        if isinstance(pad_tok, str) and pad_tok in tok.encoder:
            pad_id = tok.encoder[pad_tok]

    def encode(text: str) -> List[int]:
        return [tok.sot_id] + tok.encode(text) + [tok.eot_id]

    return TextTokenizer(encode, length, pad_id, force_last=tok.eot_id)


def _fast_tokenizer(json_path: str, length: int) -> TextTokenizer:
    from tokenizers import Tokenizer

    tok = Tokenizer.from_file(json_path)
    pad_id = tok.token_to_id("<pad>")
    if pad_id is None:
        pad_id = 0
    return TextTokenizer(lambda t: tok.encode(t).ids, length, pad_id)


def _spm_tokenizer(model_path: str, length: int, add_eos: bool) -> TextTokenizer:
    from goal_force_tpu_torch.models.spm import SentencePieceTokenizer

    tok = SentencePieceTokenizer.from_file(model_path)
    pad_id = tok.m.pad_id if tok.m.pad_id >= 0 else tok.m.unk_id
    tt = TextTokenizer(lambda t: tok.encode(t, add_eos=add_eos), length, pad_id)
    tt.spm = tok
    return tt


def _bert_tokenizer(path: str, length: int) -> TextTokenizer:
    """BERT WordPiece over ``vocab.txt`` with the directory's ``tokenizer_config.json``
    flags (lower case, accents, Chinese characters), as ``BertTokenizerFast`` reads them."""
    import json

    from tokenizers import BertWordPieceTokenizer

    cfg = {}
    cfg_file = os.path.join(path, "tokenizer_config.json")
    if os.path.exists(cfg_file):
        with open(cfg_file) as f:
            cfg = json.load(f)
    tok = BertWordPieceTokenizer(os.path.join(path, "vocab.txt"),
                                 lowercase=cfg.get("do_lower_case", True),
                                 strip_accents=cfg.get("strip_accents"),
                                 handle_chinese_chars=cfg.get("tokenize_chinese_chars", True),
                                 clean_text=True)
    return TextTokenizer(lambda t: tok.encode(t).ids, length, tok.token_to_id("[PAD]") or 0)


def sd_clip_tokenizer(length: int = 77) -> TextTokenizer:
    """SD-1.5's CLIP-L (``stable_diffusion/tokenizer``)."""
    return load_text_tokenizer(asset_path("stable_diffusion", "tokenizer"), length)


def sdxl_tokenizers(length: int = 77):
    """(CLIP-L, CLIP-G padded with '!' = 0) of SDXL."""
    tok1 = load_text_tokenizer(asset_path("stable_diffusion", "tokenizer"), length)
    tok2 = load_text_tokenizer(asset_path("stable_diffusion_xl", "tokenizer_2"), length)
    return tok1, tok2


def sd3_tokenizers(t5_length: int = 128):
    """(CLIP-L 77, CLIP-G 77, T5 at t5_length) of SD3."""
    tok1 = load_text_tokenizer(asset_path("stable_diffusion_3", "tokenizer_1"), 77)
    tok2 = load_text_tokenizer(asset_path("stable_diffusion_3", "tokenizer_2"), 77)
    tok3 = load_text_tokenizer(asset_path("stable_diffusion_3", "tokenizer_3"), t5_length)
    return tok1, tok2, tok3


def flux_tokenizers(t5_length: int = 512):
    """(CLIP-L 77, T5 at t5_length) of Flux."""
    tok1 = load_text_tokenizer(asset_path("flux", "tokenizer_1"), 77)
    tok2 = load_text_tokenizer(asset_path("flux", "tokenizer_2"), t5_length)
    return tok1, tok2


def hunyuan_dit_tokenizers(t5_length: int = 256):
    """(BERT at 77 tokens, None) of HunyuanDiT: the vendored ``tokenizer_t5`` directory
    holds configs only (its spiece ships with the weights), so the mT5 entry is None."""
    bert = load_text_tokenizer(asset_path("hunyuan_dit", "tokenizer"), 77)
    return bert, None


def kolors_tokenizer(length: int = 256) -> TextTokenizer:
    """ChatGLM3 (``kolors/tokenizer/tokenizer.model``): the ``[gMASK] sop`` prefix (the
    ids after the SentencePiece vocabulary's), left padding with the unk id."""
    tt = _spm_tokenizer(asset_path("kolors", "tokenizer", "tokenizer.model"), length,
                        add_eos=False)
    spm = tt.spm
    n = len(spm)
    gmask_id, sop_id = n + 1, n + 3

    def encode(text: str) -> List[int]:
        return [gmask_id, sop_id] + spm.encode(text)

    out = TextTokenizer(encode, length, pad_id=spm.m.unk_id, pad_side="left")
    out.spm = spm
    return out


def wan_umt5_tokenizer(path: str, length: int = 512) -> TextTokenizer:
    """umt5-xxl from a local tokenizer dir (HF files or spiece.model)."""
    return load_text_tokenizer(path, length, add_eos=True)


def hunyuan_video_clip_tokenizer(length: int = 77) -> TextTokenizer:
    """CLIP-L side of HunyuanVideo (``hunyuan_video/tokenizer_1``; the Llama side ships
    with its text-encoder checkpoint: pass that directory to load_text_tokenizer)."""
    return load_text_tokenizer(asset_path("hunyuan_video", "tokenizer_1"), length)


def cog_tokenizer(length: int = 226) -> TextTokenizer:
    """CogVideoX's T5 ``spiece.model`` (``cog/tokenizer``), EOS appended, 226 tokens."""
    return load_text_tokenizer(asset_path("cog", "tokenizer"), length, add_eos=True)


__all__ = [
    "ASSET_ROOT", "asset_path", "TextTokenizer", "load_text_tokenizer",
    "tokenize_long_prompt",
    "sd_clip_tokenizer", "sdxl_tokenizers", "sd3_tokenizers",
    "flux_tokenizers", "cog_tokenizer", "hunyuan_dit_tokenizers",
    "hunyuan_video_clip_tokenizer", "kolors_tokenizer", "wan_umt5_tokenizer",
]
