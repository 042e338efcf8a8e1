"""The SDXL UNet (2.6 B) and Kolors' variant, channels-last.

Port of ``goal_force_tpu/models/sdxl_unet.py``: ``SDXL_PLAN`` (no 8x level, transformer
stacks of depth 2 at 640 channels and 10 at 1280, a 2048-wide context: CLIP-L's and
bigG's token states side by side) over the blocks of ``models/sd_unet.py``, and
``sdxl_unet_apply``, which adds the conditioning of the pooled text and the six size ids
to the time embedding:

    temb = time_embedding(sinusoid(t))
         + add_time_embedding(cat([pooled_text, sinusoid_256(add_time_ids).flat]))

Kolors' UNet carries ``text_intermediate_proj`` (ChatGLM's 4,096 -> 2,048), applied to
the text states first, and an add embedding of 4,096 + 6 x 256 = 5,632 inputs.

The module is ``SDUNet`` with ``add_embed_in`` (and ``text_proj`` for Kolors), under the
reference ("diffsynth") names, so a diffsynth file loads strictly as it is
(``io/auto.py``); ``models/sd_unet.py::state_dict_from_civitai`` renames an LDM / civitai
file, its add embedding at ``label_emb.0.{0,2}`` (JAX ``sdxl_unet_params_from_civitai``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from goal_force_tpu_torch.models.sd_unet import (
    BlockSpec,
    SDUNet,
    _refuse_motion,
    add_embedding,
    init_sd_unet,
    linear,
    time_embedding,
    unet_forward,
)

SDXL_CTX_DIM = 2048
SDXL_TIME_DIM = 1280
SDXL_ADD_EMBED_IN = 2816  # 1280 pooled text + 6 * 256 sinusoid ids

SDXL_PLAN = (
    # DownBlock2D
    ("res", 320, 320), ("push",), ("res", 320, 320), ("push",),
    ("down", 320), ("push",),
    # CrossAttnDownBlock2D (depth 2)
    ("res", 320, 640), ("attn", 10, 64, 640, 2048, 2), ("push",),
    ("res", 640, 640), ("attn", 10, 64, 640, 2048, 2), ("push",),
    ("down", 640), ("push",),
    # CrossAttnDownBlock2D (depth 10)
    ("res", 640, 1280), ("attn", 20, 64, 1280, 2048, 10), ("push",),
    ("res", 1280, 1280), ("attn", 20, 64, 1280, 2048, 10), ("push",),
    # mid
    ("res", 1280, 1280), ("attn", 20, 64, 1280, 2048, 10), ("res", 1280, 1280),
    # CrossAttnUpBlock2D (depth 10)
    ("pop",), ("res", 2560, 1280), ("attn", 20, 64, 1280, 2048, 10),
    ("pop",), ("res", 2560, 1280), ("attn", 20, 64, 1280, 2048, 10),
    ("pop",), ("res", 1920, 1280), ("attn", 20, 64, 1280, 2048, 10),
    ("up", 1280),
    # CrossAttnUpBlock2D (depth 2)
    ("pop",), ("res", 1920, 640), ("attn", 10, 64, 640, 2048, 2),
    ("pop",), ("res", 1280, 640), ("attn", 10, 64, 640, 2048, 2),
    ("pop",), ("res", 960, 640), ("attn", 10, 64, 640, 2048, 2),
    ("up", 640),
    # UpBlock2D
    ("pop",), ("res", 960, 320),
    ("pop",), ("res", 640, 320),
    ("pop",), ("res", 640, 320),
)


def sdxl_unet_apply(model: SDUNet, sample: torch.Tensor, timestep: torch.Tensor,
                    text_emb: torch.Tensor, add_time_id: torch.Tensor,
                    add_text_embeds: torch.Tensor, groups: int = 32,
                    controlnet_res: Optional[List[torch.Tensor]] = None,
                    ipadapter: Optional[Dict] = None, motion=None, video_batch: int = 1,
                    cross_frame_attention: bool = False, tile_ctx=None,
                    ctx_len=None) -> torch.Tensor:
    """sample (B, H, W, 4), timestep (B,), text_emb (B, S, 2048) (Kolors: (B, S, 4096)),
    add_time_id (6,) or (B·6,), add_text_embeds (B, pooled) -> (B, H, W, 4)."""
    _refuse_motion(motion)
    b = sample.shape[0]
    if hasattr(model, "text_intermediate_proj"):
        text_emb = linear(model.text_intermediate_proj, text_emb)
    temb = time_embedding(model, timestep, sample.dtype)
    temb = temb + add_embedding(model.add_time_embedding, add_time_id, add_text_embeds, b,
                                sample.dtype)
    return unet_forward(model, sample, temb, text_emb, groups, controlnet_res, ipadapter,
                        cross_frame_attention, tile_ctx, ctx_len)


def init_sdxl_unet(plan: Sequence[BlockSpec], gen: torch.Generator, dtype=torch.float32, *,
                   device, model_dim: int = 320, time_dim: int = SDXL_TIME_DIM,
                   add_embed_in: int = SDXL_ADD_EMBED_IN, text_proj=None) -> SDUNet:
    """An SDXL (or, with text_proj, Kolors) UNet of `plan` with random weights from
    `gen`: JAX ``init_sdxl_unet``'s distributions."""
    return init_sd_unet(plan, gen, dtype, device=device, model_dim=model_dim,
                        time_dim=time_dim, add_embed_in=add_embed_in, text_proj=text_proj)
