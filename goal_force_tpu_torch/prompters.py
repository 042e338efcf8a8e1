"""Text tokenizers from a tokenizer directory.

Port of ``goal_force_tpu/prompters.py`` for the umt5 and HunyuanVideo paths:
``TextTokenizer`` (encode, then pad or truncate to a fixed length),
``load_text_tokenizer`` with its CLIP BPE (``vocab.json`` + ``merges.txt``, through
``models/clip_bpe.py``), ``tokenizer.json`` (the ``tokenizers`` runtime), ``spiece.model``
and ``tokenizer.model`` (``models/spm.py``) branches, ``wan_umt5_tokenizer``,
``hunyuan_video_clip_tokenizer`` and ``cog_tokenizer``. The vendored tokenizer files are read from the JAX
package's ``tokenizer_assets`` directory by path (``asset_path``); nothing of that
package is imported. The BERT (``vocab.txt``) branch, HunyuanDiT's, and the other
families' helpers are not ported and raise ``NotImplementedError``.
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
        raise NotImplementedError(f"{path}: BERT WordPiece tokenizers (HunyuanDiT's) are "
                                  "not ported yet (ROADMAP M14c)")
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
