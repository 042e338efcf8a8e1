"""SD CLIP-L text encoder: the branch HunyuanVideo pools its prompt from.

Port of the SD side of ``goal_force_tpu/models/sd_text_encoder.py``: ``SD_TEXT_CONFIG``
(CLIP ViT-L/14's text tower), ``sd_text_encode`` (all 77 final-LN token states, with
``clip_skip``) and ``sd3_text1_encode`` (the full tower for the final-LN argmax-pooled
embedding, and the hidden states ``clip_skip`` layers before the end). The model is
``models/clip.py::CLIPTextModel`` under the reference SDTextEncoder's state-dict names
(``encoders.{i}.*``, ``position_embeds``, ``final_layer_norm``) that JAX
``sd_text_params_from_torch`` reads. The SDXL towers wait for SDXL.
"""

from __future__ import annotations

import torch

from goal_force_tpu_torch.models.clip import CLIPConfig, CLIPTextModel, _ln, _tower, embed_tokens

SD_TEXT_CONFIG = CLIPConfig(vocab_size=49408, text_dim=768, text_heads=12,
                            text_layers=12, max_positions=77,
                            hidden_act="quick_gelu")


def sd_text_encode(model: CLIPTextModel, input_ids: torch.Tensor,
                   cfg: CLIPConfig = SD_TEXT_CONFIG, clip_skip: int = 1) -> torch.Tensor:
    """(B, 77) ids -> (B, 77, 768) final-LN token states; clip_skip > 1 stops
    clip_skip - 1 layers before the end."""
    layers = model.encoders
    if clip_skip > 1:
        layers = layers[:cfg.text_layers - (clip_skip - 1)]
    x = _tower(layers, embed_tokens(model, input_ids), cfg.text_heads, cfg.hidden_act,
               cfg.eps, causal=True)
    return _ln(model.final_layer_norm, x, cfg.eps)


def sd3_text1_encode(model: CLIPTextModel, input_ids: torch.Tensor,
                     cfg: CLIPConfig = SD_TEXT_CONFIG, clip_skip: int = 2):
    """SD3/Flux/HunyuanVideo CLIP-L branch: the FULL tower runs for the final-LN
    argmax-pooled embedding; the hidden states are taken clip_skip - 1 layers before the
    end (pre-LN). Returns (pooled (B, 768), hidden (B, 77, 768))."""
    keep = cfg.text_layers - (clip_skip - 1)
    x = _tower(model.encoders[:keep], embed_tokens(model, input_ids), cfg.text_heads,
               cfg.hidden_act, cfg.eps, causal=True)
    hidden = x
    x = _tower(model.encoders[keep:], x, cfg.text_heads, cfg.hidden_act, cfg.eps, causal=True)
    x = _ln(model.final_layer_norm, x, cfg.eps)
    idx = torch.argmax(input_ids, dim=-1)
    pooled = x[torch.arange(x.shape[0], device=x.device), idx]
    return pooled, hidden
