"""Pure-Python SentencePiece encoder (unigram and BPE) over ``.model`` protos.

Port of ``goal_force_tpu/models/spm.py``, so a tokenizer directory that ships only a
SentencePiece model (umt5's and T5's ``spiece.model``, ChatGLM3's byte-fallback
``tokenizer.model``) encodes without the ``sentencepiece`` wheel:

  * a protobuf wire-format reader for ``sentencepiece_model.proto`` (the pieces, the
    trainer spec and the normalizer spec, by their public field numbers);
  * normalization: NFKC (approximating the precompiled nmt_nfkc charsmap), optional
    whitespace collapse, the dummy prefix and the escaping of spaces as ``\u2581``;
  * unigram: the Viterbi best path over the pieces' log-probabilities with an unk
    penalty;
  * BPE: repeated merge of the adjacent pair whose piece scores highest;
  * byte fallback to ``<0xNN>`` pieces where the model enables it;
  * user-defined and control pieces (and an ``added_tokens.json`` beside the model) are
    matched verbatim before normalization.

One departure from the JAX copy: the trainer spec's special ids are int32, and a
negative one (-1, "none") is read as -1, where the JAX copy reads 2**64 - 1. So a model
without a pad piece pads with its unk id here, where the JAX ``load_text_tokenizer``
fails on the oversized pad id (ChatGLM3's ``tokenizer.model``).
"""

from __future__ import annotations

import struct
import unicodedata
from typing import Dict, List, Optional, Tuple

_SPACE = "▁"  # ▁


# ---------------------------------------------------------------------------
# protobuf wire-format mini-reader
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = 0
    val = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _int32(val: int) -> int:
    """A proto int32 read as a varint: negative values (-1 for "no such piece") come as
    their 64-bit two's complement."""
    return val - (1 << 64) if val >= 1 << 63 else val


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a message buffer."""
    i = 0
    n = len(buf)
    while i < n:
        tag, i = _read_varint(buf, i)
        field, wire = tag >> 3, tag & 7
        if wire == 0:                      # varint
            val, i = _read_varint(buf, i)
        elif wire == 1:                    # 64-bit
            val = buf[i:i + 8]
            i += 8
        elif wire == 2:                    # length-delimited
            ln, i = _read_varint(buf, i)
            val = buf[i:i + ln]
            i += ln
        elif wire == 5:                    # 32-bit
            val = buf[i:i + 4]
            i += 4
        else:                              # groups unused by spm
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


class SentencePieceModel:
    """Parsed ModelProto: pieces (text, score, type) + the spec fields used."""

    NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6

    def __init__(self, blob: bytes):
        self.pieces: List[Tuple[str, float, int]] = []
        self.model_type = 1              # UNIGRAM
        self.unk_id, self.bos_id, self.eos_id, self.pad_id = 0, 1, 2, -1
        self.byte_fallback = False
        self.add_dummy_prefix = True
        self.remove_extra_whitespaces = True
        self.escape_whitespaces = True
        for field, wire, val in _fields(blob):
            if field == 1 and wire == 2:          # SentencePiece
                piece, score, typ = "", 0.0, self.NORMAL
                for f2, w2, v2 in _fields(val):
                    if f2 == 1:
                        piece = v2.decode("utf-8")
                    elif f2 == 2:
                        score = struct.unpack("<f", v2)[0]
                    elif f2 == 3:
                        typ = v2
                self.pieces.append((piece, score, typ))
            elif field == 2 and wire == 2:        # TrainerSpec
                for f2, w2, v2 in _fields(val):
                    if f2 == 3:
                        self.model_type = v2
                    elif f2 == 35:
                        self.byte_fallback = bool(v2)
                    elif f2 == 40:
                        self.unk_id = _int32(v2)
                    elif f2 == 41:
                        self.bos_id = _int32(v2)
                    elif f2 == 42:
                        self.eos_id = _int32(v2)
                    elif f2 == 43:
                        self.pad_id = _int32(v2)
            elif field == 3 and wire == 2:        # NormalizerSpec
                for f2, w2, v2 in _fields(val):
                    if f2 == 3:
                        self.add_dummy_prefix = bool(v2)
                    elif f2 == 4:
                        self.remove_extra_whitespaces = bool(v2)
                    elif f2 == 5:
                        self.escape_whitespaces = bool(v2)

    @classmethod
    def from_file(cls, path: str) -> "SentencePieceModel":
        with open(path, "rb") as f:
            return cls(f.read())


class SentencePieceTokenizer:
    """Encode/decode with a parsed spm model (unigram Viterbi or BPE merges)."""

    def __init__(self, model: SentencePieceModel):
        self.m = model
        self.vocab: Dict[str, int] = {}
        self.scores: Dict[str, float] = {}
        self.byte_ids: Dict[int, int] = {}
        self.special: List[str] = []   # user-defined/control pieces, longest first
        for i, (piece, score, typ) in enumerate(model.pieces):
            if piece not in self.vocab:
                self.vocab[piece] = i
            if typ in (model.NORMAL, model.USER_DEFINED):
                self.scores[piece] = score
            if typ == model.BYTE and len(piece) == 6:   # "<0xNN>"
                self.byte_ids[int(piece[3:5], 16)] = i
            if typ in (model.USER_DEFINED, model.CONTROL) and piece:
                self.special.append(piece)
        self.special.sort(key=len, reverse=True)
        self.max_piece_len = max((len(p) for p in self.scores), default=1)
        self.min_score = min(self.scores.values(), default=0.0)
        self.id_to_piece = [p for p, _, _ in model.pieces]
        self._added: Dict[int, str] = {}

    @classmethod
    def from_file(cls, path: str) -> "SentencePieceTokenizer":
        """Load `<dir>/spiece.model`; if an `added_tokens.json` sits next to it
        (HF format: piece -> id, e.g. T5's 100 `<extra_id_*>`), register those
        as verbatim-matched special tokens."""
        import json
        import os

        tok = cls(SentencePieceModel.from_file(path))
        added = os.path.join(os.path.dirname(path), "added_tokens.json")
        if os.path.exists(added):
            with open(added) as f:
                for piece, idx in json.load(f).items():
                    tok.add_special(piece, idx)
        return tok

    def add_special(self, piece: str, idx: int) -> None:
        """Register an out-of-proto token (HF 'added token') matched verbatim."""
        self.vocab[piece] = idx
        self._added[idx] = piece
        self.special.append(piece)
        self.special.sort(key=len, reverse=True)

    # -- normalization ------------------------------------------------------

    def _normalize(self, text: str) -> str:
        text = unicodedata.normalize("NFKC", text)
        if self.m.remove_extra_whitespaces:
            text = " ".join(text.split())
        if self.m.add_dummy_prefix and text:
            text = " " + text
        if self.m.escape_whitespaces:
            text = text.replace(" ", _SPACE)
        return text

    # -- encoders -----------------------------------------------------------

    def _encode_unigram(self, text: str) -> List[int]:
        n = len(text)
        NEG = float("-inf")
        unk_score = self.min_score - 10.0
        best = [NEG] * (n + 1)
        back: List[Optional[Tuple[int, int]]] = [None] * (n + 1)  # (start, id)
        best[0] = 0.0
        for i in range(n):
            if best[i] == NEG:
                continue
            hi = min(n, i + self.max_piece_len)
            for j in range(i + 1, hi + 1):
                sub = text[i:j]
                sc = self.scores.get(sub)
                if sc is not None and best[i] + sc > best[j]:
                    best[j] = best[i] + sc
                    back[j] = (i, self.vocab[sub])
            # unk fallback: single char
            j = i + 1
            if best[i] + unk_score > best[j]:
                best[j] = best[i] + unk_score
                back[j] = (i, -1)
        ids: List[int] = []
        j = n
        while j > 0:
            i, pid = back[j]
            if pid >= 0:
                ids.append(pid)
            elif self.m.byte_fallback:
                ids.extend(reversed(self._char_fallback(text[i:j])))
            elif not ids or ids[-1] != self.m.unk_id:
                # consecutive unknown chars fuse into ONE unk (spm semantics);
                # walking right-to-left, a run of unks collapses here
                ids.append(self.m.unk_id)
            j = i
        ids.reverse()
        return ids

    def _char_fallback(self, chars: str) -> List[int]:
        if self.m.byte_fallback:
            return [self.byte_ids[b] for b in chars.encode("utf-8")]
        return [self.m.unk_id]

    def _encode_bpe(self, text: str) -> List[int]:
        # start from single characters; merge the adjacent pair whose joined
        # piece has the highest score until no merge applies
        syms: List[str] = list(text)
        while len(syms) > 1:
            best_sc, best_i = None, -1
            for i in range(len(syms) - 1):
                sc = self.scores.get(syms[i] + syms[i + 1])
                if sc is not None and (best_sc is None or sc > best_sc):
                    best_sc, best_i = sc, i
            if best_i < 0:
                break
            syms[best_i:best_i + 2] = [syms[best_i] + syms[best_i + 1]]
        ids: List[int] = []
        for s in syms:
            if s in self.vocab and (s in self.scores or not self.m.byte_fallback):
                ids.append(self.vocab[s])
            else:
                ids.extend(self._char_fallback(s))
        return ids

    # -- public api ---------------------------------------------------------

    def encode(self, text: str, add_bos: bool = False, add_eos: bool = False) -> List[int]:
        ids: List[int] = []
        for chunk, is_special in self._split_special(text):
            if is_special:
                ids.append(self.vocab[chunk])
            elif chunk:
                norm = self._normalize(chunk)
                if norm:
                    ids.extend(self._encode_bpe(norm) if self.m.model_type == 2
                               else self._encode_unigram(norm))
        if add_bos:
            ids.insert(0, self.m.bos_id)
        if add_eos:
            ids.append(self.m.eos_id)
        return ids

    def _split_special(self, text: str):
        """Split on user-defined/control pieces (matched verbatim, pre-normalization)."""
        if not self.special:
            yield text, False
            return
        rest = text
        while rest:
            hit, pos = None, len(rest)
            for sp in self.special:
                p = rest.find(sp)
                if 0 <= p < pos:
                    hit, pos = sp, p
            if hit is None:
                yield rest, False
                return
            if pos:
                yield rest[:pos], False
            yield hit, True
            rest = rest[pos + len(hit):]

    def decode(self, ids) -> str:
        out: List[str] = []
        byte_buf: List[int] = []
        rev_bytes = {v: k for k, v in self.byte_ids.items()}

        def flush():
            if byte_buf:
                out.append(bytes(byte_buf).decode("utf-8", errors="replace"))
                byte_buf.clear()

        for i in ids:
            if i in rev_bytes:
                byte_buf.append(rev_bytes[i])
                continue
            flush()
            if i in self._added:
                out.append(self._added[i])
                continue
            piece, _, typ = self.m.pieces[i]
            if typ in (self.m.CONTROL, self.m.UNKNOWN):
                continue
            out.append(piece)
        flush()
        return "".join(out).replace(_SPACE, " ").strip()

    def __len__(self) -> int:
        return len(self.m.pieces)
