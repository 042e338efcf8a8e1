"""The SD 1.5 ControlNet and the SDXL ControlNet-Union, on the UNet's block machinery.

Port of ``goal_force_tpu/models/sd_controlnet.py``:

  - ``SDControlNet`` / ``sd_controlnet_apply``: the SD UNet's down and mid half
    (``SD_CONTROLNET_PLAN``) with a conditioning conv pyramid (``cond_layer_apply``: conv,
    SiLU, then (conv, SiLU, stride-2 conv, SiLU) per level, then a conv) added to
    ``conv_in``'s output, and one 1x1 zero conv per entry of the residual stack: 13
    residuals, mean-pooled under ``global_pool``;
  - ``SDXLControlNetUnion`` / ``sdxl_controlnet_apply``: the same over SDXL's down and
    mid half (``SDXL_CONTROLNET_PLAN``, 10 residuals), with SDXL's add embedding, the
    one-hot control type through the 256-wide sinusoid and ``control_type_embedding``,
    and the condition fused through a two-token ``_residual_attention`` (QuickGELU) and
    ``spatial_ch_projs`` (``SDXL_UNION_TASK_ID`` names the task ids).

``_residual_attention`` keeps torch ``nn.MultiheadAttention``'s ``batch_first=False``
convention, as JAX and the reference do: on the (B, 2, D) tokens it attends over axis 0,
so under merged CFG the rows of the batch attend to each other.

The residuals go to ``sd_unet_apply`` / ``sdxl_unet_apply(controlnet_res=)``. The
modules keep the reference ("diffsynth") names (``controlnet_conv_in.blocks.{2i}``,
``controlnet_blocks.{i}``, ``controlnet_transformer.attn.in_proj_weight``, ...); the
loaders read them strictly, the sizes from the shapes, a zero conv's bias where the file
has it (JAX reads a missing one as zeros).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from goal_force_tpu_torch.models.clip import _ln
from goal_force_tpu_torch.models.flux_adapters import _load
from goal_force_tpu_torch.models.sd_unet import (
    BlockSpec,
    add_embedding,
    conv2d,
    embedding_mlp,
    linear,
    normal_init_,
    plan_blocks,
    run_plan,
    time_embedding,
)
from goal_force_tpu_torch.models.wan_dit import Activation, LayerNormAffine, empty_module, \
    sinusoidal_embedding
from goal_force_tpu_torch.ops.attention import plain_attention

# The SD UNet's down stages and mid, each residual push mirrored.
SD_CONTROLNET_PLAN: Tuple[BlockSpec, ...] = (
    ("res", 320, 320), ("attn", 8, 40, 320, 768), ("push",),
    ("res", 320, 320), ("attn", 8, 40, 320, 768), ("push",),
    ("down", 320), ("push",),
    ("res", 320, 640), ("attn", 8, 80, 640, 768), ("push",),
    ("res", 640, 640), ("attn", 8, 80, 640, 768), ("push",),
    ("down", 640), ("push",),
    ("res", 640, 1280), ("attn", 8, 160, 1280, 768), ("push",),
    ("res", 1280, 1280), ("attn", 8, 160, 1280, 768), ("push",),
    ("down", 1280), ("push",),
    ("res", 1280, 1280), ("push",),
    ("res", 1280, 1280), ("push",),
    ("res", 1280, 1280), ("attn", 8, 160, 1280, 768), ("res", 1280, 1280),
    ("push",),
)

SDXL_CONTROLNET_PLAN: Tuple[BlockSpec, ...] = (
    ("res", 320, 320), ("push",),
    ("res", 320, 320), ("push",),
    ("down", 320), ("push",),
    ("res", 320, 640), ("attn", 10, 64, 640, 2048, 2), ("push",),
    ("res", 640, 640), ("attn", 10, 64, 640, 2048, 2), ("push",),
    ("down", 640), ("push",),
    ("res", 640, 1280), ("attn", 20, 64, 1280, 2048, 10), ("push",),
    ("res", 1280, 1280), ("attn", 20, 64, 1280, 2048, 10), ("push",),
    ("res", 1280, 1280), ("attn", 20, 64, 1280, 2048, 10), ("res", 1280, 1280),
    ("push",),
)

SDXL_UNION_TASK_ID = {
    "openpose": 0, "depth": 1, "softedge": 2, "canny": 3,
    "lineart": 3, "lineart_anime": 3, "tile": 6, "inpaint": 7,
}

COND_CHANNELS = (3, 16, 32, 96, 256)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class ConditioningLayer(nn.Module):
    """The conditioning pyramid over channels (image, ..., model_dim); SiLU slots keep
    the reference's indices (the convs at even indices)."""

    def __init__(self, channels: Sequence[int]):
        super().__init__()
        ch = tuple(channels)
        mods = [nn.Conv2d(ch[0], ch[1], 3), Activation()]
        for i in range(1, len(ch) - 2):
            mods += [nn.Conv2d(ch[i], ch[i], 3), Activation(),
                     nn.Conv2d(ch[i], ch[i + 1], 3), Activation()]
        mods.append(nn.Conv2d(ch[-2], ch[-1], 3))
        self.blocks = nn.ModuleList(mods)


def _stack_widths(plan: Sequence[BlockSpec], model_dim: int) -> List[int]:
    """The channels of each residual stack entry: conv_in's, then one per push."""
    widths, cur = [model_dim], model_dim
    for spec in plan:
        if spec[0] == "res":
            cur = spec[2]
        elif spec[0] == "attn":
            cur = spec[1] * spec[2]
        elif spec[0] == "push":
            widths.append(cur)
    return widths


class SDControlNet(nn.Module):
    def __init__(self, plan: Sequence[BlockSpec] = SD_CONTROLNET_PLAN, model_dim: int = 320,
                 time_dim: int = 1280, in_channels: int = 4,
                 cond_channels: Sequence[int] = COND_CHANNELS, zero_bias: bool = True):
        super().__init__()
        self.plan = tuple(tuple(s) for s in plan)
        self.time_embedding = embedding_mlp(model_dim, time_dim)
        self.conv_in = nn.Conv2d(in_channels, model_dim, 3)
        self.controlnet_conv_in = ConditioningLayer(tuple(cond_channels) + (model_dim,))
        self.blocks = plan_blocks(self.plan, time_dim)
        self.controlnet_blocks = nn.ModuleList(nn.Conv2d(c, c, 1, bias=zero_bias)
                                               for c in _stack_widths(self.plan, model_dim))


class MultiheadAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d))
        self.out_proj = nn.Linear(d, d)


class ResidualAttentionMLP(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.c_fc = nn.Linear(d, 4 * d)
        self.c_proj = nn.Linear(4 * d, d)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, d: int, n_head: int = 8):
        super().__init__()
        self.n_head = n_head
        self.attn = MultiheadAttention(d)
        self.ln_1 = LayerNormAffine(d)
        self.mlp = ResidualAttentionMLP(d)
        self.ln_2 = LayerNormAffine(d)


class SDXLControlNetUnion(SDControlNet):
    def __init__(self, plan: Sequence[BlockSpec] = SDXL_CONTROLNET_PLAN, model_dim: int = 320,
                 time_dim: int = 1280, in_channels: int = 4,
                 cond_channels: Sequence[int] = COND_CHANNELS, zero_bias: bool = True,
                 add_text_dim: int = 1280, n_head: int = 8, num_tasks: int = 8):
        super().__init__(plan, model_dim, time_dim, in_channels, cond_channels, zero_bias)
        self.add_time_embedding = embedding_mlp(add_text_dim + 6 * 256, time_dim)
        self.control_type_embedding = embedding_mlp(num_tasks * 256, time_dim)
        self.task_embedding = nn.Parameter(torch.empty(num_tasks, model_dim))
        self.controlnet_transformer = ResidualAttentionBlock(model_dim, n_head)
        self.spatial_ch_projs = nn.Linear(model_dim, model_dim)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def cond_layer_apply(p: ConditioningLayer, image: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) condition pixels -> (B, H/8, W/8, model_dim) (for three levels)."""
    convs = [m for m in p.blocks if isinstance(m, nn.Conv2d)]
    x = F.silu(conv2d(convs[0], image))
    for i in range(1, len(convs) - 1, 2):
        x = F.silu(conv2d(convs[i], x))
        x = F.silu(conv2d(convs[i + 1], x, stride=2))
    return conv2d(convs[-1], x)


def _run_controlnet_plan(model: SDControlNet, x, temb, text_emb, groups, tile_ctx=None,
                         ctx_len=None, global_pool: bool = False) -> List[torch.Tensor]:
    _, stack = run_plan(model, x, temb, text_emb, groups, tile_ctx=tile_ctx, ctx_len=ctx_len)
    out = [conv2d(p, s) for p, s in zip(model.controlnet_blocks, stack)]
    if global_pool:
        out = [o.mean(dim=(1, 2), keepdim=True) for o in out]
    return out


def sd_controlnet_apply(model: SDControlNet, sample: torch.Tensor, timestep: torch.Tensor,
                        text_emb: torch.Tensor, cond_image: torch.Tensor, groups: int = 32,
                        global_pool: bool = False, tile_ctx=None,
                        ctx_len=None) -> List[torch.Tensor]:
    """sample (B, H, W, 4), timestep (B,) or (), text_emb (B, T, 768), cond_image (B, 8H,
    8W, 3) in [0, 1] -> the 13 zero-conv residuals. As in JAX, ``tile_ctx`` does not reach
    this network's attention blocks (SDXL's union network takes it)."""
    temb = time_embedding(model, timestep, sample.dtype)
    x = conv2d(model.conv_in, sample) + cond_layer_apply(model.controlnet_conv_in, cond_image)
    return _run_controlnet_plan(model, x, temb, text_emb, groups, ctx_len=ctx_len,
                                global_pool=global_pool)


def _residual_attention(p: ResidualAttentionBlock, x: torch.Tensor) -> torch.Tensor:
    """The reference ResidualAttentionBlock over x (B, 2, D): multi-head attention over
    axis 0 (``batch_first=False``), then a QuickGELU MLP, each pre-LN and residual."""
    d = x.shape[-1]
    h = _ln(p.ln_1, x, 1e-5)
    qkv = F.linear(h, p.attn.in_proj_weight.to(x.dtype), p.attn.in_proj_bias.to(x.dtype))
    # the sequence is axis 0: (seq=B, batch=2, D) -> (2, B, heads, hd) for the attention
    q, k, v = (t.transpose(0, 1).reshape(x.shape[1], x.shape[0], p.n_head, d // p.n_head)
               for t in qkv.chunk(3, dim=-1))
    att = plain_attention(q, k, v, (d // p.n_head) ** -0.5).reshape(x.shape[1], x.shape[0], d)
    x = x + linear(p.attn.out_proj, att.transpose(0, 1))
    h = linear(p.mlp.c_fc, _ln(p.ln_2, x, 1e-5))
    h = h * torch.sigmoid(1.702 * h)
    return x + linear(p.mlp.c_proj, h)


def sdxl_controlnet_apply(model: SDXLControlNetUnion, sample: torch.Tensor,
                          timestep: torch.Tensor, text_emb: torch.Tensor,
                          cond_image: torch.Tensor, add_time_id: torch.Tensor,
                          add_text_embeds: torch.Tensor, task_id: int = 3, groups: int = 32,
                          global_pool: bool = False, tile_ctx=None,
                          ctx_len=None) -> List[torch.Tensor]:
    """sample (B, H, W, 4), text_emb (B, T, 2048), cond_image (B, 8H, 8W, 3), add_time_id
    (6,) or (B·6,), add_text_embeds (B, 1280) -> the 10 zero-conv residuals."""
    b, dtype = sample.shape[0], sample.dtype
    temb = time_embedding(model, timestep, dtype)
    add = add_embedding(model.add_time_embedding, add_time_id, add_text_embeds, b, dtype)
    control_type = torch.zeros((b, model.task_embedding.shape[0]), dtype=dtype,
                               device=sample.device)
    control_type[:, task_id] = 1.0
    mlp = model.control_type_embedding
    cemb = sinusoidal_embedding(256, control_type.reshape(-1)).reshape(b, -1)
    cemb = linear(mlp[2], F.silu(linear(mlp[0], cemb.to(dtype))))
    temb = temb + add + cemb

    x = conv2d(model.conv_in, sample)
    cond = cond_layer_apply(model.controlnet_conv_in, cond_image)
    feat_seq = cond.mean(dim=(1, 2)) + model.task_embedding[task_id].to(dtype)
    tokens = torch.stack([feat_seq, x.mean(dim=(1, 2))], dim=1)        # (B, 2, model_dim)
    tokens = _residual_attention(model.controlnet_transformer, tokens)
    alpha = linear(model.spatial_ch_projs, tokens[:, 0])
    x = x + (cond + alpha[:, None, None, :])
    return _run_controlnet_plan(model, x, temb, text_emb, groups, tile_ctx=tile_ctx,
                                ctx_len=ctx_len, global_pool=global_pool)


# ---------------------------------------------------------------------------
# Loading and random weights
# ---------------------------------------------------------------------------

def _sizes(sd) -> Dict:
    """The module's sizes from a state dict's shapes."""
    model_dim, in_channels = sd["conv_in.weight"].shape[:2]
    convs = sorted(int(k.split(".")[2]) for k in sd
                   if k.startswith("controlnet_conv_in.blocks.") and k.endswith(".weight"))
    w = [sd[f"controlnet_conv_in.blocks.{i}.weight"] for i in convs]
    channels = (w[0].shape[1], w[0].shape[0], *[w[2 * k].shape[0]
                                                for k in range(1, (len(w) - 2) // 2 + 1)])
    return dict(model_dim=model_dim, time_dim=sd["time_embedding.0.weight"].shape[0],
                in_channels=in_channels, cond_channels=channels,
                zero_bias="controlnet_blocks.0.bias" in sd)


def sd_controlnet_from_state_dict(sd: Dict[str, torch.Tensor],
                                  plan: Sequence[BlockSpec] = SD_CONTROLNET_PLAN, dtype=None,
                                  device=None) -> SDControlNet:
    """An ``SDControlNet`` of `plan` read strictly, in `dtype` on `device` (default: the
    file's)."""
    s = _sizes(sd)
    return _load(SDControlNet, sd, "sd_controlnet", plan, s["model_dim"], s["time_dim"],
                 s["in_channels"], s["cond_channels"], s["zero_bias"], dtype=dtype,
                 device=device)


def sdxl_controlnet_from_state_dict(sd: Dict[str, torch.Tensor],
                                    plan: Sequence[BlockSpec] = SDXL_CONTROLNET_PLAN,
                                    n_head: int = 8, dtype=None,
                                    device=None) -> SDXLControlNetUnion:
    """An ``SDXLControlNetUnion`` of `plan` read strictly (8 heads in the fusing
    attention, as JAX's converter sets)."""
    s = _sizes(sd)
    add_text = sd["add_time_embedding.0.weight"].shape[1] - 6 * 256
    return _load(SDXLControlNetUnion, sd, "sdxl_controlnet", plan, s["model_dim"],
                 s["time_dim"], s["in_channels"], s["cond_channels"], s["zero_bias"],
                 add_text, n_head, sd["task_embedding"].shape[0], dtype=dtype, device=device)


@torch.no_grad()
def _init(cls, gen, dtype, device, *args) -> nn.Module:
    """JAX's draws: N(0, 0.02²) weights (the task embedding and the fused in_proj too),
    zero biases, unit norms, and ZERO 1x1 controlnet blocks (a fresh network adds
    nothing)."""
    model = normal_init_(empty_module(cls, *args, dtype=dtype, device=device), gen)
    for m in model.controlnet_blocks:
        m.weight.zero_()
        if m.bias is not None:
            m.bias.zero_()
    if isinstance(model, SDXLControlNetUnion):
        attn = model.controlnet_transformer.attn
        attn.in_proj_weight.normal_(generator=gen).mul_(0.02)
        attn.in_proj_bias.zero_()
        model.task_embedding.normal_(generator=gen).mul_(0.02)
    return model


def init_sd_controlnet(plan: Sequence[BlockSpec], gen: torch.Generator, dtype=torch.float32,
                       *, device, model_dim: int = 320, time_dim: int = 1280,
                       cond_channels: Sequence[int] = COND_CHANNELS,
                       in_channels: int = 4) -> SDControlNet:
    return _init(SDControlNet, gen, dtype, device, plan, model_dim, time_dim, in_channels,
                 cond_channels)


def init_sdxl_controlnet(plan: Sequence[BlockSpec], gen: torch.Generator,
                         dtype=torch.float32, *, device, model_dim: int = 320,
                         time_dim: int = 1280, add_text_dim: int = 1280,
                         cond_channels: Sequence[int] = COND_CHANNELS,
                         n_head: int = 8) -> SDXLControlNetUnion:
    return _init(SDXLControlNetUnion, gen, dtype, device, plan, model_dim, time_dim, 4,
                 cond_channels, True, add_text_dim, n_head)
