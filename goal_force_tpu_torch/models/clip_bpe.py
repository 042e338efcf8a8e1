"""CLIP byte-pair tokenizer.

Port of ``goal_force_tpu/models/clip_bpe.py``: the SimpleTokenizer-compatible BPE over
an openai-format merges list (``bpe_simple_vocab_16e6.txt.gz``) or the HF-format
``vocab.json`` + ``merges.txt`` that the vendored tokenizer directories hold. It needs
neither ``transformers`` nor ``tokenizers``:

  * byte -> printable-unicode table, merges list, vocab = bytes + bytes</w> + merged
    tokens + <|startoftext|>/<|endoftext|> (or the explicit ``vocab.json``);
  * text cleaning: HTML-unescape twice (ftfy's repair is not applied, as in the JAX
    copy), whitespace collapse, lowercase;
  * word regex with ``regex``'s \\p classes (contractions | letters | digit | other),
    falling back to ``re`` equivalents where ``regex`` is missing;
  * encode: per-word greedy lowest-rank pair merging with ``</w>`` on the final byte;
    ``__call__``: sot + ids + eot zero-padded to context_length 77, truncated with eot
    forced at the last position.
"""

from __future__ import annotations

import gzip
import html
from functools import lru_cache
from typing import Dict, Iterable, List, Sequence, Tuple, Union

import numpy as np

try:
    import regex as _re

    _WORD_PAT = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
        r"""|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _re.IGNORECASE)
except ImportError:  # regex is optional: re gives the same classes for ASCII text
    import re as _re

    _WORD_PAT = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
        r"""|[^\W\d_]+|\d|[^\s\w]+""",
        _re.IGNORECASE)


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Invertible byte -> printable unicode char table (GPT-2/CLIP standard)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _clean(text: str) -> str:
    # no ftfy.fix_text (the JAX copy applies none either); html-unescape twice like
    # open_clip's basic_clean, collapse whitespace.
    text = html.unescape(html.unescape(text))
    return " ".join(text.split()).strip().lower()


def _pairs(word: Tuple[str, ...]) -> set:
    return set(zip(word[:-1], word[1:]))


class CLIPBPETokenizer:
    """SimpleTokenizer-compatible BPE over an openai-format merges list."""

    SOT = "<|startoftext|>"
    EOT = "<|endoftext|>"

    def __init__(self, merges: Sequence[Tuple[str, str]]):
        byte_vocab = list(bytes_to_unicode().values())
        vocab = byte_vocab + [v + "</w>" for v in byte_vocab]
        vocab += ["".join(m) for m in merges]
        vocab += [self.SOT, self.EOT]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {c: b for b, c in self.byte_encoder.items()}
        self.sot_id = self.encoder[self.SOT]
        self.eot_id = self.encoder[self.EOT]
        self._cache: Dict[str, str] = {self.SOT: self.SOT, self.EOT: self.EOT}

    @classmethod
    def from_gzip(cls, path: str) -> "CLIPBPETokenizer":
        """Load `bpe_simple_vocab_16e6.txt.gz`: line 0 is a header; open_clip
        keeps merges[1 : 49152-256-2+1]."""
        lines = gzip.open(path).read().decode("utf-8").split("\n")
        lines = lines[1:49152 - 256 - 2 + 1]
        return cls([tuple(line.split()) for line in lines])

    @classmethod
    def from_hf(cls, vocab_json: str, merges_txt: str) -> "CLIPBPETokenizer":
        """Load HF-format CLIP tokenizer files (vocab.json + merges.txt), the
        layout the reference vendors under diffsynth/tokenizer_configs/*/
        tokenizer*/ . The explicit vocab mapping replaces the derived one (it
        can carry added tokens / different ordering)."""
        import json

        with open(merges_txt, encoding="utf-8") as f:
            lines = f.read().split("\n")
        if lines and lines[0].startswith("#"):
            lines = lines[1:]
        merges = [tuple(ln.split()) for ln in lines if len(ln.split()) == 2]
        tok = cls(merges)
        with open(vocab_json, encoding="utf-8") as f:
            tok.encoder = json.load(f)
        tok.decoder = {i: t for t, i in tok.encoder.items()}
        tok.sot_id = tok.encoder[cls.SOT]
        tok.eot_id = tok.encoder[cls.EOT]
        return tok

    def bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in _WORD_PAT.findall(_clean(text)):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(tok).split(" "))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def __call__(self, texts: Union[str, Sequence[str]],
                 context_length: int = 77) -> np.ndarray:
        """(n, context_length) int32, zero-padded; over-long prompts truncate
        with eot forced at the end (open_clip tokenize())."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot_id] + self.encode(text) + [self.eot_id]
            if len(ids) > context_length:
                ids = ids[:context_length]
                ids[-1] = self.eot_id
            out[i, :len(ids)] = ids
        return out
