"""Prompt cleaning and tokenization for umt5-xxl.

Port of ``goal_force_tpu/models/tokenizer.py``: the optional ``ftfy`` fix and whitespace
cleaning, ``HFTokenizer`` (``transformers.AutoTokenizer``, pad to ``seq_len`` with
truncation), ``HashTokenizer`` (whitespace tokens hashed into the vocab, EOS=1, PAD=0;
the same ids as the JAX copy within one process) and ``load_tokenizer``, which reads a
local tokenizer directory (HF files, or a SentencePiece model through ``models/spm.py``)
and falls back, with a warning, to the hash tokenizer when given no path. ``hash_ids``
is the model zoo's sha256-seeded fallback (JAX ``pipelines/flux.py::_hash_ids``), equal
to JAX's in every process.
"""

from __future__ import annotations

import functools
import html
import os
import re
import warnings
from typing import Optional, Tuple

import numpy as np


@functools.lru_cache(maxsize=None)
def _ftfy_fix_text():
    try:
        import ftfy
    except ImportError:   # ftfy is optional; the basic cleaning still applies
        return None
    return ftfy.fix_text


def clean_whitespace(text: str) -> str:
    """ftfy's fix where ftfy imports, HTML-unescape twice, collapse whitespace, strip."""
    fix = _ftfy_fix_text()
    if fix is not None:
        text = fix(text)
    text = html.unescape(html.unescape(text))
    return re.sub(r"\s+", " ", text).strip()


class HFTokenizer:
    """AutoTokenizer wrapper, pad-to-max_length + truncation."""

    def __init__(self, path: str, seq_len: int = 512):
        from transformers import AutoTokenizer

        self.seq_len = seq_len
        self.tokenizer = AutoTokenizer.from_pretrained(path)

    def __call__(self, texts) -> Tuple[np.ndarray, np.ndarray]:
        if isinstance(texts, str):
            texts = [texts]
        texts = [clean_whitespace(t) for t in texts]
        enc = self.tokenizer(texts, return_tensors="np", padding="max_length",
                             truncation=True, max_length=self.seq_len)
        return enc["input_ids"].astype(np.int32), enc["attention_mask"].astype(np.int32)


class SpmTokenizer:
    """A SentencePiece directory's ``TextTokenizer`` over a batch of prompts: cleaned
    prompts -> (ids, mask), the mask 1 where the id is not the pad id."""

    def __init__(self, path: str, seq_len: int = 512):
        from goal_force_tpu_torch.prompters import load_text_tokenizer

        self.tok = load_text_tokenizer(path, seq_len, add_eos=True)

    def __call__(self, texts) -> Tuple[np.ndarray, np.ndarray]:
        if isinstance(texts, str):
            texts = [texts]
        ids = np.stack([self.tok(clean_whitespace(t)) for t in texts])
        return ids.astype(np.int32), (ids != self.tok.pad_id).astype(np.int32)


class HashTokenizer:
    """Deterministic stand-in tokenizer: whitespace tokens hashed into the vocab.

    Not a linguistic tokenizer; with random weights any fixed id map will do.
    """

    def __init__(self, vocab: int = 256384, seq_len: int = 512):
        self.vocab = vocab
        self.seq_len = seq_len

    def __call__(self, texts) -> Tuple[np.ndarray, np.ndarray]:
        if isinstance(texts, str):
            texts = [texts]
        ids = np.zeros((len(texts), self.seq_len), np.int32)
        mask = np.zeros((len(texts), self.seq_len), np.int32)
        for i, t in enumerate(texts):
            toks = clean_whitespace(t).split(" ")
            coded = [2 + (hash(w) % (self.vocab - 2)) for w in toks][: self.seq_len - 1]
            coded.append(1)  # EOS
            ids[i, : len(coded)] = coded
            mask[i, : len(coded)] = 1
        return ids, mask


def load_tokenizer(path: Optional[str], vocab: int = 256384, seq_len: int = 512,
                   quiet: bool = False):
    """The umt5 tokenizer of a local directory: ``HFTokenizer`` where it holds
    ``tokenizer.json`` or ``tokenizer_config.json``, else the SentencePiece model it
    holds. With no path, the hash tokenizer, with a warning unless `quiet`: hashed ids
    give meaningless embeddings, acceptable only for random weights."""
    if path is not None:
        files = set(os.listdir(path)) if os.path.isdir(path) else set()
        if "tokenizer.json" in files or "tokenizer_config.json" in files:
            return HFTokenizer(path, seq_len)
        return SpmTokenizer(path, seq_len)
    if not quiet:
        warnings.warn(
            "No tokenizer_path given: falling back to HashTokenizer - prompts are HASHED "
            "into ids and the text embeddings are garbage. Pass a local umt5 tokenizer "
            "directory for real inference.", stacklevel=2)
    return HashTokenizer(vocab, seq_len)


def hash_ids(text: str, vocab: int, length: int) -> np.ndarray:
    """(length,) int64 ids of the JAX package's ``pipelines/flux.py::_hash_ids``, bit
    for bit: one id in [2, vocab) per whitespace word (at least one), drawn by numpy from
    a generator seeded with the first 8 bytes of the text's sha256, zeros after."""
    import hashlib

    h = hashlib.sha256(text.encode()).digest()
    rng = np.random.default_rng(np.frombuffer(h[:8], np.uint64)[0])
    n = min(length, max(1, len(text.split())))
    ids = np.zeros((length,), np.int64)
    ids[:n] = rng.integers(2, vocab, (n,))
    return ids
