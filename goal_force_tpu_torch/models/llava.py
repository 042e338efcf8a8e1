"""The LLaVA multimodal text encoder of HunyuanVideo-I2V in PyTorch.

Port of ``goal_force_tpu/models/llava.py``: a CLIP-ViT-L/14 vision tower at 336 px (576
patches), a two-layer GELU projector and the llava-llama-3-8B decoder. The one
``<image>`` placeholder of a prompt splices out and the 576 projected patch features
splice in; the conditioning is the decoder's hidden state with the last
``hidden_state_skip_layer`` layers skipped.

``LlavaModel`` holds the parameters under the on-disk ``LlavaForConditionalGeneration``
names that JAX ``llava_params_from_torch`` reads: ``vision_tower.vision_model.*`` (the HF
CLIP vision names of ``models/clip.py::CLIPVisionModel``), ``multi_modal_projector.
linear_{1,2}`` and ``language_model.model.*`` (``models/text_encoders.py::LlamaModel``,
its final ``norm`` included). ``llava_state_dict`` maps the transformers >= 4.52 layout
(``model.language_model.*``, ``model.vision_tower.*``, ``model.multi_modal_projector.*``)
onto it and drops the ``lm_head``, which the encoder never reads.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from goal_force_tpu_torch.models.clip import (
    CLIPConfig,
    CLIPVisionModel,
    clip_vision_hidden_states,
    init_clip_vision,
)
from goal_force_tpu_torch.models.text_encoders import (
    LlamaConfig,
    LlamaModel,
    _rms,
    init_llama,
    llama_layers,
)
from goal_force_tpu_torch.models.wan_dit import empty_module, init_linear_

# OpenAI CLIP normalization (the vendored CLIPImageProcessor configuration of
# HunyuanVideo's tokenizer_2)
CLIP_IMAGE_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_IMAGE_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclasses.dataclass(frozen=True)
class LlavaConfig:
    """llava-llama-3-8b-text-encoder-tokenizer (HunyuanVideo-I2V): CLIP-L/14 at 336 px
    (24x24 = 576 patches) into a GELU MLP projector into the 8B Llama. `image_token_id`
    is the vendored tokenizer's ``<image>`` (128257)."""

    text: LlamaConfig = dataclasses.field(default_factory=LlamaConfig)
    vision: CLIPConfig = dataclasses.field(default_factory=lambda: CLIPConfig(
        image_size=336, patch_size=14, vision_dim=1024, vision_heads=16,
        vision_layers=24, hidden_act="quick_gelu"))
    image_token_id: int = 128257
    vision_feature_layer: int = -2

    @property
    def num_image_tokens(self) -> int:
        return (self.vision.image_size // self.vision.patch_size) ** 2


class MultiModalProjector(nn.Module):
    def __init__(self, d_vision: int, d_text: int):
        super().__init__()
        self.linear_1 = nn.Linear(d_vision, d_text)
        self.linear_2 = nn.Linear(d_text, d_text)


class LanguageModel(nn.Module):
    """``language_model``: the decoder under ``model`` (the head is not kept)."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.model = LlamaModel(cfg)


class LlavaModel(nn.Module):
    def __init__(self, cfg: LlavaConfig):
        super().__init__()
        self.vision_tower = CLIPVisionModel(cfg.vision)
        self.multi_modal_projector = MultiModalProjector(cfg.vision.vision_dim,
                                                         cfg.text.hidden_size)
        self.language_model = LanguageModel(cfg.text)


def llava_layout(sd) -> tuple:
    """(language model, vision tower, projector) key prefixes of a LLaVA state dict, in
    either layout."""
    if any(k.startswith("language_model.model.") for k in sd):
        return "language_model.model.", "vision_tower.", "multi_modal_projector."
    if any(k.startswith("model.language_model.") for k in sd):
        return "model.language_model.", "model.vision_tower.", "model.multi_modal_projector."
    raise KeyError("not a LLaVA state dict: no language_model.* keys")


def llava_state_dict(sd) -> Dict[str, torch.Tensor]:
    """`sd` in the on-disk layout of ``LlavaModel``, without the ``lm_head``."""
    lm, vt, mp = llava_layout(sd)
    out = {}
    for k, v in sd.items():
        for src, dst in ((lm, "language_model.model."), (vt, "vision_tower."),
                         (mp, "multi_modal_projector.")):
            if k.startswith(src):
                out[dst + k[len(src):]] = v
                break
        else:
            if not k.endswith("lm_head.weight"):
                out[k] = v
    return out


def clip_preprocess_image(image, size: int = 336) -> np.ndarray:
    """CLIPImageProcessor semantics: bicubic resize of the SHORTEST edge to `size`, centre
    crop, rescale to [0, 1], OpenAI-CLIP normalization. Takes a PIL image, a uint8 array
    or a float array in [0, 1]; returns (size, size, 3) float32 pixels."""
    from PIL import Image

    if not isinstance(image, Image.Image):
        arr = np.asarray(image)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0.0, 1.0) * 255.0).round().astype(np.uint8)
        image = Image.fromarray(arr)
    image = image.convert("RGB")
    w, h = image.size
    short = min(w, h)
    nw, nh = round(w * size / short), round(h * size / short)
    image = image.resize((nw, nh), Image.BICUBIC)
    left, top = (nw - size) // 2, (nh - size) // 2
    image = image.crop((left, top, left + size, top + size))
    arr = np.asarray(image, np.float32) / 255.0
    return (arr - CLIP_IMAGE_MEAN) / CLIP_IMAGE_STD


def llava_image_features(model: LlavaModel, cfg: LlavaConfig,
                         pixel_values: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) preprocessed pixels -> (B, 576, llama_dim) projected patch features:
    the penultimate vision layer, CLS dropped, then linear, exact-erf GELU, linear (each
    in the promoted dtype of its input and weight, as JAX's matmuls)."""
    feats = clip_vision_hidden_states(model.vision_tower, cfg.vision, pixel_values,
                                      cfg.vision_feature_layer)[:, 1:]
    p = model.multi_modal_projector

    def dense(x, m):
        dt = torch.promote_types(x.dtype, m.weight.dtype)
        return F.linear(x.to(dt), m.weight.to(dt), m.bias.to(dt))

    return dense(F.gelu(dense(feats, p.linear_1)), p.linear_2)


def llava_encode(model: LlavaModel, cfg: LlavaConfig, input_ids, pixel_values,
                 attention_mask, hidden_state_skip_layer: int = 2) -> torch.Tensor:
    """(B, S) ids with ONE ``<image>`` token per row + (B, H, W, 3) pixels + a 0/1 mask ->
    (B, S-1+576, D) hidden states with the last `hidden_state_skip_layer` decoder layers
    skipped. The image token splices out and the 576 projected features splice in,
    unmasked. The hidden state after the last layer is HF's only post-norm entry, so the
    final norm applies only with skip 0.

    The word embeddings are gathered with each id clamped to the vocabulary (JAX's
    gather clamps an index past the end; a CUDA gather would fault): the image id, which
    may lie past a small vocabulary, is spliced out in any case."""
    ids = np.asarray(input_ids.cpu() if torch.is_tensor(input_ids) else input_ids)
    lm = model.language_model.model
    dev = lm.embed_tokens.weight.device
    feats = llava_image_features(model, cfg, torch.as_tensor(pixel_values).to(dev))
    mask = torch.as_tensor(attention_mask).to(dev)
    vocab = lm.embed_tokens.weight.shape[0]
    emb_all = lm.embed_tokens.weight[torch.as_tensor(ids, dtype=torch.long).clamp(max=vocab - 1)
                                     .to(dev)]
    rows_emb, rows_mask = [], []
    for i in range(ids.shape[0]):
        hits = np.nonzero(ids[i] == cfg.image_token_id)[0]
        if len(hits) != 1:
            raise ValueError(f"row {i}: expected exactly one <image> token "
                             f"(id {cfg.image_token_id}), found {len(hits)}")
        pos = int(hits[0])
        emb = emb_all[i]
        rows_emb.append(torch.cat([emb[:pos], feats[i].to(emb.dtype), emb[pos + 1:]]))
        rows_mask.append(torch.cat([mask[i, :pos], mask.new_ones(feats.shape[1]),
                                    mask[i, pos + 1:]]))
    out = llama_layers(lm, cfg.text, torch.stack(rows_emb), torch.stack(rows_mask),
                       cfg.text.num_layers - hidden_state_skip_layer)
    if hidden_state_skip_layer == 0:
        out = _rms(out, lm.norm.weight, cfg.text.eps)
    return out


@torch.no_grad()
def init_llava(cfg: LlavaConfig, gen: torch.Generator, dtype=torch.bfloat16, *,
               device, language_model: LlamaModel = None) -> LlavaModel:
    """Random weights drawn from `gen`: the vision tower as ``init_clip_vision``, the
    decoder as ``init_llama`` (or `language_model`, a decoder already built), uniform
    +-1/sqrt(fan_in) projector linears."""
    with torch.device("meta"):
        model = LlavaModel(cfg)
    model.vision_tower = init_clip_vision(cfg.vision, gen, dtype, device=device)
    model.multi_modal_projector = empty_module(
        MultiModalProjector, cfg.vision.vision_dim, cfg.text.hidden_size, dtype=dtype,
        device=device)
    for m in (model.multi_modal_projector.linear_1, model.multi_modal_projector.linear_2):
        init_linear_(m, gen)
    model.language_model.model = language_model if language_model is not None else \
        init_llama(cfg.text, gen, dtype, device=device)
    return model.eval().requires_grad_(False)
