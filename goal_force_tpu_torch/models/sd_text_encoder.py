"""SD CLIP-L text encoder: the branch HunyuanVideo pools its prompt from.

Port of the SD side of ``goal_force_tpu/models/sd_text_encoder.py``: ``SD_TEXT_CONFIG``
(CLIP ViT-L/14's text tower), ``sd_text_encode`` (all 77 final-LN token states, with
``clip_skip``) and ``sd3_text1_encode`` (the full tower for the final-LN argmax-pooled
embedding, and the hidden states ``clip_skip`` layers before the end). The model is
``models/clip.py::CLIPTextModel`` under the reference SDTextEncoder's state-dict names
(``encoders.{i}.*``, ``position_embeds``, ``final_layer_norm``) that JAX
``sd_text_params_from_torch`` reads.

The SDXL towers, which SD3 runs too: ``SDXL_TEXT_CONFIG`` (CLIP-L cut to 11 layers, no
final LayerNorm: ``CLIPTextModel(final_norm=False)``) with ``sdxl_text_encode`` (the raw
token states, ``clip_skip - 1`` layers early), and ``SDXL_TEXT2_CONFIG`` (OpenCLIP bigG:
1280 wide, 20 heads, 32 layers, exact GELU, argmax pooling, a bias-free 1280 x 1280
projection: ``CLIPTextModel(projection=True, proj_dim=1280)``) with ``sdxl_text2_encode``
(the states recorded ``clip_skip`` layers from the end before the final LayerNorm, the
final-LN output pooled at ``argmax(ids)`` and projected). JAX's diffsynth-format converter
``sdxl_text_params_from_torch`` reads the names the modules carry, so a diffsynth file
loads as it is (``io/auto.py``); the bundled civitai checkpoints' towers are renamed by
``sdxl_text_state_dict_from_civitai`` (HF CLIP names under
``conditioner.embedders.0.transformer.text_model.``) and
``sdxl_text2_state_dict_from_civitai`` (OpenCLIP names under
``conditioner.embedders.1.model.``: the fused ``in_proj`` split into q, k, v, and the
(in, out) ``text_projection`` transposed into a Linear weight); an SD 1.5 bundle's tower
(under ``cond_stage_model.transformer.text_model.``) by ``sd_text_state_dict_from_civitai``.
"""

from __future__ import annotations

import torch

from typing import Dict, Mapping

import torch.nn.functional as F

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


# ---------------------------------------------------------------------------
# SDXL text towers
# ---------------------------------------------------------------------------

SDXL_TEXT_CONFIG = CLIPConfig(vocab_size=49408, text_dim=768, text_heads=12,
                              text_layers=11, max_positions=77,
                              hidden_act="quick_gelu")
SDXL_TEXT2_CONFIG = CLIPConfig(vocab_size=49408, text_dim=1280, text_heads=20,
                               text_layers=32, max_positions=77,
                               hidden_act="gelu", text_pooling="argmax")


def sdxl_text_encode(model: CLIPTextModel, input_ids: torch.Tensor,
                     cfg: CLIPConfig = SDXL_TEXT_CONFIG, clip_skip: int = 2) -> torch.Tensor:
    """(B, 77) -> (B, 77, 768) raw token states (no final LN), stopping clip_skip - 1
    layers early (SDXL's default clip_skip is 2)."""
    layers = model.encoders
    if clip_skip > 1:
        layers = layers[:cfg.text_layers - (clip_skip - 1)]
    return _tower(layers, embed_tokens(model, input_ids), cfg.text_heads, cfg.hidden_act,
                  cfg.eps, causal=True)


def sdxl_text2_encode(model: CLIPTextModel, input_ids: torch.Tensor,
                      cfg: CLIPConfig = SDXL_TEXT2_CONFIG, clip_skip: int = 2):
    """(B, 77) -> (pooled (B, 1280), hidden (B, 77, 1280)): every layer runs; the states
    are recorded clip_skip layers from the end (before the final LN), and the final-LN
    output is pooled at argmax(ids) and projected."""
    split = cfg.text_layers - clip_skip + 1
    hidden = _tower(model.encoders[:split], embed_tokens(model, input_ids), cfg.text_heads,
                    cfg.hidden_act, cfg.eps, causal=True)
    x = _tower(model.encoders[split:], hidden, cfg.text_heads, cfg.hidden_act, cfg.eps,
               causal=True)
    x = _ln(model.final_layer_norm, x, cfg.eps)
    idx = torch.argmax(input_ids, dim=-1)
    pooled = x[torch.arange(x.shape[0], device=x.device), idx]
    return F.linear(pooled, model.text_projection.weight), hidden


def _hf_layer(sd: Dict[str, torch.Tensor], out: Dict[str, torch.Tensor], src: str, i: int):
    names = (("layer_norm1", "layer_norm1"), ("layer_norm2", "layer_norm2"),
             ("self_attn.q_proj", "attn.to_q"), ("self_attn.k_proj", "attn.to_k"),
             ("self_attn.v_proj", "attn.to_v"), ("self_attn.out_proj", "attn.to_out"),
             ("mlp.fc1", "fc1"), ("mlp.fc2", "fc2"))
    for hf, ref in names:
        for w in ("weight", "bias"):
            out[f"encoders.{i}.{ref}.{w}"] = sd[f"{src}encoder.layers.{i}.{hf}.{w}"]


def sd_text_state_dict_from_civitai(sd: Mapping[str, torch.Tensor],
                                    cfg: CLIPConfig = SD_TEXT_CONFIG
                                    ) -> Dict[str, torch.Tensor]:
    """A bundled SD checkpoint's text tower (HF CLIP names under
    ``cond_stage_model.transformer.text_model.``, or ``text_model.``) -> this module's
    names with the final LN (JAX ``sd_text_params_from_civitai``)."""
    pre = "cond_stage_model.transformer.text_model."
    if not any(k.startswith(pre) for k in sd):
        pre = "text_model."
    out = {"token_embedding.weight": sd[pre + "embeddings.token_embedding.weight"],
           "position_embeds": sd[pre + "embeddings.position_embedding.weight"][None],
           "final_layer_norm.weight": sd[pre + "final_layer_norm.weight"],
           "final_layer_norm.bias": sd[pre + "final_layer_norm.bias"]}
    for i in range(cfg.text_layers):
        _hf_layer(sd, out, pre, i)
    return out


def sdxl_text_state_dict_from_civitai(sd: Mapping[str, torch.Tensor],
                                      cfg: CLIPConfig = SDXL_TEXT_CONFIG
                                      ) -> Dict[str, torch.Tensor]:
    """A bundled SDXL checkpoint's first tower (HF CLIP names under
    ``conditioner.embedders.0.transformer.text_model.``) -> this module's names, the
    first ``cfg.text_layers`` layers and no final LN (JAX
    ``sdxl_text_params_from_civitai``)."""
    pre = "conditioner.embedders.0.transformer.text_model."
    out = {"token_embedding.weight": sd[pre + "embeddings.token_embedding.weight"],
           "position_embeds": sd[pre + "embeddings.position_embedding.weight"][None]}
    for i in range(cfg.text_layers):
        _hf_layer(sd, out, pre, i)
    return out


def sdxl_text2_state_dict_from_civitai(sd: Mapping[str, torch.Tensor],
                                       cfg: CLIPConfig = SDXL_TEXT2_CONFIG
                                       ) -> Dict[str, torch.Tensor]:
    """A bundled SDXL checkpoint's OpenCLIP bigG tower (under
    ``conditioner.embedders.1.model.``) -> this module's names (JAX
    ``sdxl_text2_params_from_civitai``): the fused ``in_proj`` split into q, k, v; the
    stored (in, out) ``text_projection`` transposed into a Linear weight."""
    pre = "conditioner.embedders.1.model."
    out = {"token_embedding.weight": sd[pre + "token_embedding.weight"],
           "position_embeds": sd[pre + "positional_embedding"][None],
           "final_layer_norm.weight": sd[pre + "ln_final.weight"],
           "final_layer_norm.bias": sd[pre + "ln_final.bias"],
           "text_projection.weight": sd[pre + "text_projection"].T.contiguous()}
    for i in range(cfg.text_layers):
        b = f"{pre}transformer.resblocks.{i}."
        for w in ("weight", "bias"):
            for part, name in zip(sd[b + f"attn.in_proj_{w}"].chunk(3, dim=0),
                                  ("to_q", "to_k", "to_v")):
                out[f"encoders.{i}.attn.{name}.{w}"] = part.contiguous()
            for src, ref in (("attn.out_proj", "attn.to_out"), ("ln_1", "layer_norm1"),
                             ("ln_2", "layer_norm2"), ("mlp.c_fc", "fc1"),
                             ("mlp.c_proj", "fc2")):
                out[f"encoders.{i}.{ref}.{w}"] = sd[f"{b}{src}.{w}"]
    return out
