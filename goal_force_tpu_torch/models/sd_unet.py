"""The Stable Diffusion 1.5 UNet (and the 2D primitives it shares), channels-last.

Port of ``goal_force_tpu/models/sd_unet.py``. The UNet is a declarative block plan
(``("res", in, out)``, ``("attn", heads, head_dim, ch, ctx_dim[, depth])``, ``("push",)``,
``("pop",)``, ``("down", ch)``, ``("up", ch)``) run by one function over the blocks of
``SDUNet``: ``SD15_PLAN`` (the released 860 M geometry), ``tiny_sd_plan`` (every block
kind at one down/up level, for tests). SDXL's and Kolors' UNet (``models/sdxl_unet.py``)
and the SD ControlNets (``models/sd_controlnet.py``) are the same module with other plans.

The primitives: GroupNorm in float32, the NHWC ``conv2d``, the projected multi-head
``_attention`` (its ``ctx_len`` key mask at float32's lowest finite value, its IP-Adapter
branch) and the ``_resnet`` block, which the image VAE (``models/sd_vae.py``) and the Flux
adapters read too. JAX's cos-first ``timestep_embedding`` is
``models/wan_dit.py::sinusoidal_embedding`` here (``tests/test_torch_text_towers.py`` holds
the two equal), its affine LayerNorm ``models/clip.py::_ln``.

``sd_unet_apply`` has JAX's paths: the ControlNet residuals added at the first ``pop``
(the hidden state takes the last, the stack's leading entries the rest), the IP-Adapter's
image keys per transformer unit, ``tile_ctx`` (each transformer block over
``tiled_forward_2d`` tiles of ``min(tile, h, w)``, the IP-Adapter ignored there, as in
JAX), ``cross_frame_attention`` (one sequence over the batch, the batch-mean context) and
``ctx_len`` (the long prompts' key mask). ``motion=`` (AnimateDiff) raises until
``sd_motion.py`` is ported.

JAX's dtype rules are kept: a conv or a linear casts its weights to the input's dtype,
and a norm's affine promotes to float32 before the cast back, so a float32 input over
bf16 weights computes in float32 over bf16-rounded weights, as XLA does.

Parameters live in modules under the reference ("diffsynth") names: ``time_embedding.{0,2}``,
``conv_in``, ``blocks.{i}.*`` (a resnet's ``norm1``/``conv1``/``time_emb_proj``/...; an
attention block's ``norm``, ``proj_in``, ``transformer_blocks.{j}.{norm1,attn1,norm2,attn2,
norm3,act_fn.proj,ff}``, ``proj_out``; a sampler's ``conv``), ``conv_norm_out``,
``conv_out``, so a diffsynth file loads strictly as it is (``io/auto.py``);
``state_dict_from_civitai`` renames an LDM / civitai UNet (``model.diffusion_model.*``)
into them, its prefixes derived from the plan (``_ldm_prefixes``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from goal_force_tpu_torch.models.clip import _ln
from goal_force_tpu_torch.models.wan_dit import (
    Activation,
    LayerNormAffine,
    empty_module,
    sinusoidal_embedding,
)
from goal_force_tpu_torch.ops.attention import plain_attention

# ---------------------------------------------------------------------------
# Block plans
# ---------------------------------------------------------------------------

# ("res", in_ch, out_ch) | ("attn", heads, head_dim, ch, ctx_dim[, depth])
# | ("push",) | ("pop",) | ("down", ch) | ("up", ch)   (depth defaults to 1)
BlockSpec = Tuple

SD15_PLAN: Tuple[BlockSpec, ...] = (
    # CrossAttnDownBlock2D x3, DownBlock2D, mid, UpBlock2D, CrossAttnUpBlock2D x3
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
    ("pop",), ("res", 2560, 1280),
    ("pop",), ("res", 2560, 1280),
    ("pop",), ("res", 2560, 1280), ("up", 1280),
    ("pop",), ("res", 2560, 1280), ("attn", 8, 160, 1280, 768),
    ("pop",), ("res", 2560, 1280), ("attn", 8, 160, 1280, 768),
    ("pop",), ("res", 1920, 1280), ("attn", 8, 160, 1280, 768), ("up", 1280),
    ("pop",), ("res", 1920, 640), ("attn", 8, 80, 640, 768),
    ("pop",), ("res", 1280, 640), ("attn", 8, 80, 640, 768),
    ("pop",), ("res", 960, 640), ("attn", 8, 80, 640, 768), ("up", 640),
    ("pop",), ("res", 960, 320), ("attn", 8, 40, 320, 768),
    ("pop",), ("res", 640, 320), ("attn", 8, 40, 320, 768),
    ("pop",), ("res", 640, 320), ("attn", 8, 40, 320, 768),
)

SD15_TIME_DIM = 1280
SD15_MODEL_DIM = 320


def tiny_sd_plan(ctx_dim: int = 24) -> Tuple[BlockSpec, ...]:
    """Structure-complete miniature (all block types, one down/up level)."""
    return (
        ("res", 8, 8), ("attn", 2, 4, 8, ctx_dim), ("push",),
        ("down", 8), ("push",),
        ("res", 8, 16), ("push",),
        ("res", 16, 16), ("attn", 2, 8, 16, ctx_dim), ("res", 16, 16),
        ("pop",), ("res", 32, 16),
        ("pop",), ("res", 24, 8), ("up", 8),
        ("pop",), ("res", 16, 8), ("attn", 2, 4, 8, ctx_dim),
    )


def _depth(spec: BlockSpec) -> int:
    return spec[5] if spec[0] == "attn" and len(spec) > 5 else 1


# ---------------------------------------------------------------------------
# Modules (parameter holders under the reference names)
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """The q, k, v and output projections of one attention: biased everywhere (the
    VAE's), or q/k/v without biases over a context of ctx_dim (the UNet's)."""

    def __init__(self, dim: int, ctx_dim: Optional[int] = None, qkv_bias: bool = True):
        super().__init__()
        ctx_dim = ctx_dim or dim
        self.to_q = nn.Linear(dim, dim, bias=qkv_bias)
        self.to_k = nn.Linear(ctx_dim, dim, bias=qkv_bias)
        self.to_v = nn.Linear(ctx_dim, dim, bias=qkv_bias)
        self.to_out = nn.Linear(dim, dim)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, temb_dim: int = 0):
        super().__init__()
        self.norm1 = LayerNormAffine(cin)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        if temb_dim:
            self.time_emb_proj = nn.Linear(temb_dim, cout)
        self.norm2 = LayerNormAffine(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.conv_shortcut = nn.Conv2d(cin, cout, 1)


class Resample(nn.Module):
    """A down or up sampler's 3x3 conv."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3)


class GEGLU(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * hidden)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, ctx_dim: int):
        super().__init__()
        self.norm1 = LayerNormAffine(dim)
        self.attn1 = Attention(dim, qkv_bias=False)
        self.norm2 = LayerNormAffine(dim)
        self.attn2 = Attention(dim, ctx_dim, qkv_bias=False)
        self.norm3 = LayerNormAffine(dim)
        self.act_fn = GEGLU(dim, 4 * dim)
        self.ff = nn.Linear(4 * dim, dim)


class AttentionBlock(nn.Module):
    def __init__(self, heads: int, head_dim: int, ch: int, ctx_dim: int, depth: int = 1):
        super().__init__()
        inner = heads * head_dim
        self.norm = LayerNormAffine(ch)
        self.proj_in = nn.Linear(ch, inner)
        self.transformer_blocks = nn.ModuleList(BasicTransformerBlock(inner, ctx_dim)
                                                for _ in range(depth))
        self.proj_out = nn.Linear(inner, ch)


def embedding_mlp(d_in: int, d_out: int) -> nn.ModuleList:
    """Linear, SiLU, Linear: the time and add embeddings (``*.0`` / ``*.2``)."""
    return nn.ModuleList([nn.Linear(d_in, d_out), Activation(), nn.Linear(d_out, d_out)])


def plan_blocks(plan: Sequence[BlockSpec], time_dim: int) -> nn.ModuleList:
    def block(spec):
        kind = spec[0]
        if kind == "res":
            return ResnetBlock(spec[1], spec[2], time_dim)
        if kind == "attn":
            return AttentionBlock(*spec[1:5], depth=_depth(spec))
        if kind in ("down", "up"):
            return Resample(spec[1])
        if kind in ("push", "pop"):
            return Activation()
        raise ValueError(spec)

    return nn.ModuleList(block(spec) for spec in plan)


class SDUNet(nn.Module):
    """The UNet of a block plan. SDXL's adds ``add_time_embedding`` (pooled text and
    six size ids, add_embed_in wide), Kolors' ``text_intermediate_proj`` (text_proj =
    (ChatGLM's width, the plan's context width))."""

    def __init__(self, plan: Sequence[BlockSpec] = SD15_PLAN, model_dim: int = SD15_MODEL_DIM,
                 time_dim: int = SD15_TIME_DIM, in_channels: int = 4, add_embed_in: int = 0,
                 text_proj: Optional[Tuple[int, int]] = None):
        super().__init__()
        self.plan = tuple(tuple(s) for s in plan)
        self.time_embedding = embedding_mlp(model_dim, time_dim)
        if add_embed_in:
            self.add_time_embedding = embedding_mlp(add_embed_in, time_dim)
        if text_proj is not None:
            self.text_intermediate_proj = nn.Linear(*text_proj)
        self.conv_in = nn.Conv2d(in_channels, model_dim, 3)
        self.blocks = plan_blocks(self.plan, time_dim)
        self.conv_norm_out = LayerNormAffine(model_dim)
        self.conv_out = nn.Conv2d(model_dim, in_channels, 3)


@torch.no_grad()
def normal_init_(model: nn.Module, gen: torch.Generator) -> nn.Module:
    """JAX's random draws for these families: every conv and linear weight N(0, 0.02²),
    zero biases, unit norms; the model in eval mode without gradients."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            m.weight.normal_(generator=gen).mul_(0.02)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, LayerNormAffine):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return model.eval().requires_grad_(False)


def init_sd_unet(plan: Sequence[BlockSpec], gen: torch.Generator, dtype=torch.float32, *,
                 device, model_dim: int = SD15_MODEL_DIM, time_dim: int = SD15_TIME_DIM,
                 in_channels: int = 4, **kw) -> SDUNet:
    """An ``SDUNet`` of `plan` with random weights from `gen` (``normal_init_``); `kw`
    (add_embed_in, text_proj) goes to the module."""
    model = empty_module(SDUNet, plan, model_dim, time_dim, in_channels, dtype=dtype,
                         device=device, **kw)
    return normal_init_(model, gen)


def unet_from_state_dict(sd: Dict[str, torch.Tensor], plan: Sequence[BlockSpec],
                         what: str = "sd_unet", dtype=None, device="cpu") -> SDUNet:
    """An ``SDUNet`` of `plan` read strictly from the reference names, its widths (and
    SDXL's add embedding, Kolors' text projection) from the shapes, in `dtype` (default:
    the file's) on `device`."""
    from goal_force_tpu_torch.io.auto import _strict

    model_dim, in_channels = sd["conv_in.weight"].shape[:2]
    kw = dict(model_dim=model_dim, time_dim=sd["time_embedding.0.weight"].shape[0],
              in_channels=in_channels)
    if "add_time_embedding.0.weight" in sd:
        kw["add_embed_in"] = sd["add_time_embedding.0.weight"].shape[1]
    if "text_intermediate_proj.weight" in sd:
        kw["text_proj"] = tuple(sd["text_intermediate_proj.weight"].shape[::-1])
    dtype = dtype or next(v.dtype for v in sd.values() if v.is_floating_point())
    return _strict(lambda p: SDUNet(p, **kw), tuple(plan), sd, what, dtype, device)


# ---------------------------------------------------------------------------
# Primitives (NHWC)
# ---------------------------------------------------------------------------

def _cast(t: Optional[torch.Tensor], like: torch.Tensor) -> Optional[torch.Tensor]:
    return None if t is None else t.to(like.dtype)


def linear(p: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``x @ W + b`` with the weights in x's dtype (JAX promotes a float32 input over
    bf16 weights to float32)."""
    return F.linear(x, p.weight.to(x.dtype), _cast(p.bias, x))


def group_norm(p: nn.Module, x: torch.Tensor, groups: int = 32,
               eps: float = 1e-5) -> torch.Tensor:
    """x (B, H, W, C): statistics over each group's (H, W, C/groups) in float32; the
    affine in float32; cast back to x's dtype."""
    b, h, w, c = x.shape
    xf = x.float().reshape(b, h * w, groups, c // groups)
    mu = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf - mu).square().mean(dim=(1, 3), keepdim=True)
    xf = ((xf - mu) * torch.rsqrt(var + eps)).reshape(b, h, w, c)
    return (xf * p.weight.float() + p.bias.float()).to(x.dtype)


def conv2d(p: nn.Conv2d, x: torch.Tensor, stride: int = 1, padding: str = "SAME") -> torch.Tensor:
    """x (B, H, W, Cin) -> (B, H', W', Cout). "SAME" pads (k - 1) // 2 on each side (the
    odd kernels here; at stride 2 that is JAX's explicit (1, 1)), "VALID" pads nothing.
    The NCHW view of the NHWC tensor is channels-last, so no copy is made on either side
    of the conv."""
    pad = (p.weight.shape[-1] - 1) // 2 if padding == "SAME" else 0
    out = F.conv2d(x.permute(0, 3, 1, 2), p.weight.to(x.dtype), _cast(p.bias, x), stride, pad)
    return out.permute(0, 2, 3, 1)


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    return x[:, :, None, :, None].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)


def _attention(p: Attention, x: torch.Tensor, ctx: torch.Tensor, num_heads: int, ip=None,
               ctx_len=None) -> torch.Tensor:
    """Multi-head attention of x (B, S, D) over ctx (B, T, Dc) with float32 softmax.

    ctx_len: (B,) valid context lengths; keys past a row's length get float32's lowest
    finite logit (as JAX's ``where``), so a row keeps a finite softmax even with none.
    ip: {"k", "v" (B or 1, T_ip, D), "scale"}: the same queries over the image tokens,
    scaled and added before the output projection (IP-Adapter). The logits are computed
    by ``ops/attention.py::plain_attention`` in blocks of query rows (the VAE's mid
    attention at 1024² is one head over 16,384 tokens: 1 GiB of float32 logits)."""
    b, s, _ = x.shape
    t = ctx.shape[1]
    # JAX's promotion: a float32 x (the latents after a regional blend) over a bf16
    # context takes q in float32 and k, v in bf16, then attends in float32
    dt = torch.promote_types(x.dtype, ctx.dtype)
    q = linear(p.to_q, x).reshape(b, s, num_heads, -1).to(dt)
    k = linear(p.to_k, ctx).reshape(b, t, num_heads, -1).to(dt)
    v = linear(p.to_v, ctx).reshape(b, t, num_heads, -1).to(dt)
    scale = q.shape[-1] ** -0.5
    bias = None
    if ctx_len is not None:
        keep = (torch.arange(t, device=x.device)[None]
                < torch.as_tensor(ctx_len, device=x.device).reshape(-1, 1))
        bias = torch.where(keep, 0.0, torch.finfo(torch.float32).min)[:, None, None, :]
    out = plain_attention(q, k, v, scale, bias).reshape(b, s, -1)
    if ip is not None:
        ti = ip["k"].shape[1]
        ipk = ip["k"].expand(b, ti, -1).reshape(b, ti, num_heads, -1).to(q.dtype)
        ipv = ip["v"].expand(b, ti, -1).reshape(b, ti, num_heads, -1).to(q.dtype)
        out = out + ip["scale"] * plain_attention(q, ipk, ipv, scale).reshape(b, s, -1)
    return linear(p.to_out, out)


def _resnet(p: ResnetBlock, x: torch.Tensor, temb=None, groups: int = 32,
            eps: float = 1e-5) -> torch.Tensor:
    h = F.silu(group_norm(p.norm1, x, groups, eps))
    h = conv2d(p.conv1, h)
    if temb is not None:
        h = h + linear(p.time_emb_proj, F.silu(temb))[:, None, None, :]
    h = F.silu(group_norm(p.norm2, h, groups, eps))
    h = conv2d(p.conv2, h)
    if hasattr(p, "conv_shortcut"):
        x = conv2d(p.conv_shortcut, x)
    return x + h


def _transformer_block(p: BasicTransformerBlock, x: torch.Tensor, ctx: torch.Tensor,
                       num_heads: int, ip=None, ctx_len=None) -> torch.Tensor:
    h = _ln(p.norm1, x, 1e-5)
    x = x + _attention(p.attn1, h, h, num_heads)
    x = x + _attention(p.attn2, _ln(p.norm2, x, 1e-5), ctx, num_heads, ip=ip, ctx_len=ctx_len)
    y, gate = linear(p.act_fn.proj, _ln(p.norm3, x, 1e-5)).chunk(2, dim=-1)
    return x + linear(p.ff, y * F.gelu(gate))


def _attn_block(p: AttentionBlock, x: torch.Tensor, ctx: torch.Tensor, num_heads: int,
                groups: int = 32, eps: float = 1e-6, ip=None, cross_frame: bool = False,
                tile_ctx: Optional[Tuple[int, int]] = None, ctx_len=None) -> torch.Tensor:
    """cross_frame: all frames (the batch) as ONE sequence, with the batch-mean context
    and no key mask. tile_ctx: (tile_size, tile_stride): each transformer block over
    overlapping (ts, ts) tiles of the grid, ts = min(tile_size, h, w), blended by the ramp
    mask; the IP-Adapter is ignored there, as in JAX."""
    b, h, w, c = x.shape
    res = x
    t = linear(p.proj_in, group_norm(p.norm, x, groups, eps=eps).reshape(b, h * w, c))
    if tile_ctx is not None:
        from goal_force_tpu_torch.models.tiler import tiled_forward_2d

        ts = min(tile_ctx[0], h, w)
        for tp in p.transformer_blocks:
            def fn(xt, tp=tp):
                return _transformer_block(tp, xt.reshape(xt.shape[0], -1, c), ctx, num_heads,
                                          ctx_len=ctx_len).reshape(xt.shape)

            t = tiled_forward_2d(fn, t.reshape(b, h, w, c), ts, tile_ctx[1]
                                 ).to(t.dtype).reshape(b, h * w, c)
    else:
        if cross_frame:
            t = t.reshape(1, b * h * w, c)
            ctx = ctx.mean(dim=0, keepdim=True)
            ctx_len = None
        for di, tp in enumerate(p.transformer_blocks):
            t = _transformer_block(tp, t, ctx, num_heads, ip=None if ip is None else ip.get(di),
                                   ctx_len=ctx_len)
        if cross_frame:
            t = t.reshape(b, h * w, c)
    return linear(p.proj_out, t).reshape(b, h, w, c) + res


def time_embedding(model: nn.Module, timestep: torch.Tensor, dtype) -> torch.Tensor:
    """The cos-first sinusoid of `timestep` as wide as ``conv_in``'s output, through
    ``time_embedding`` (Linear, SiLU, Linear)."""
    mlp = model.time_embedding
    temb = sinusoidal_embedding(model.conv_in.weight.shape[0], timestep.reshape(-1))
    temb = F.silu(linear(mlp[0], temb.to(dtype)))
    return linear(mlp[2], temb)


def add_embedding(mlp: nn.ModuleList, add_time_id: torch.Tensor, add_text_embeds: torch.Tensor,
                  b: int, dtype) -> torch.Tensor:
    """SDXL's add embedding: the pooled text beside the six size ids' 256-wide sinusoids
    (``add_time_id`` of shape (6,) or (B·6,)), through Linear, SiLU, Linear."""
    ids = sinusoidal_embedding(256, add_time_id.reshape(-1)).reshape(b, -1)
    add = torch.cat([add_text_embeds, ids.to(add_text_embeds.dtype)], dim=-1)
    add = F.silu(linear(mlp[0], add.to(dtype)))
    return linear(mlp[2], add)


def run_plan(model: nn.Module, x: torch.Tensor, temb: torch.Tensor, text_emb: torch.Tensor,
             groups: int = 32, controlnet_res: Optional[List[torch.Tensor]] = None,
             ipadapter: Optional[Dict] = None, cross_frame_attention: bool = False,
             tile_ctx=None, ctx_len=None):
    """The plan's blocks over x (after ``conv_in``). controlnet_res: at the first
    ``pop`` the hidden state takes res[-1] and the stack's leading entries res[:-1], the
    entries beyond them as they are. Returns (x, the residual stack)."""
    stack = [x]
    cn_applied = controlnet_res is None
    for i, (spec, p) in enumerate(zip(model.plan, model.blocks)):
        kind = spec[0]
        if kind == "pop" and not cn_applied:
            x = x + controlnet_res[-1].to(x.dtype)
            stack = ([s + r.to(s.dtype) for s, r in zip(stack, controlnet_res[:-1])]
                     + stack[len(controlnet_res) - 1:])
            cn_applied = True
        if kind == "res":
            x = _resnet(p, x, temb, groups)
        elif kind == "attn":
            x = _attn_block(p, x, text_emb, num_heads=spec[1], groups=groups,
                            ip=None if ipadapter is None else ipadapter.get(i),
                            cross_frame=cross_frame_attention, tile_ctx=tile_ctx,
                            ctx_len=ctx_len)
        elif kind == "push":
            stack.append(x)
        elif kind == "pop":
            x = torch.cat([x, stack.pop()], dim=-1)
        elif kind == "down":
            x = conv2d(p.conv, x, stride=2)
        elif kind == "up":
            x = conv2d(p.conv, upsample_nearest2x(x))
        else:
            raise ValueError(spec)
    return x, stack


def unet_forward(model: nn.Module, sample: torch.Tensor, temb: torch.Tensor,
                 text_emb: torch.Tensor, groups: int, *plan_args) -> torch.Tensor:
    """``conv_in``, the plan's blocks (``run_plan``, which takes `plan_args` after
    `groups`), the output GroupNorm, SiLU and ``conv_out``."""
    x, _ = run_plan(model, conv2d(model.conv_in, sample), temb, text_emb, groups, *plan_args)
    return conv2d(model.conv_out, F.silu(group_norm(model.conv_norm_out, x, groups)))


def _refuse_motion(motion) -> None:
    if motion is not None:
        raise NotImplementedError(
            "motion= (AnimateDiff's temporal modules, models/sd_motion.py) is not ported "
            "yet (ROADMAP queue 1, M14d: AnimateDiff)")


def sd_unet_apply(model: SDUNet, sample: torch.Tensor, timestep: torch.Tensor,
                  text_emb: torch.Tensor, groups: int = 32,
                  controlnet_res: Optional[List[torch.Tensor]] = None, motion=None,
                  video_batch: int = 1, ipadapter: Optional[Dict] = None,
                  cross_frame_attention: bool = False,
                  tile_ctx: Optional[Tuple[int, int]] = None, ctx_len=None) -> torch.Tensor:
    """sample (B, H, W, 4) NHWC latents + (B,) timestep + (B, T, ctx) text embeddings ->
    the predicted noise (B, H, W, 4). ipadapter: {plan index: {depth: {"k", "v",
    "scale"}}} (``models/ipadapter.py::ipadapter_kwargs_for_plan``)."""
    _refuse_motion(motion)
    temb = time_embedding(model, timestep, sample.dtype)
    return unet_forward(model, sample, temb, text_emb, groups, controlnet_res, ipadapter,
                        cross_frame_attention, tile_ctx, ctx_len)


# ---------------------------------------------------------------------------
# civitai / LDM naming -> the reference names
# ---------------------------------------------------------------------------

def _ldm_prefixes(plan: Sequence[BlockSpec]) -> List[str]:
    """The LDM (``model.diffusion_model.*``) module prefix of every entry of a plan but
    push and pop: each "push" closes one ``input_blocks.{i}``, the stretch between the last
    push and the first pop is ``middle_block``, each "pop" opens one ``output_blocks.{i}``
    (an "up" stays inside the current output block)."""
    first_pop = next(i for i, s in enumerate(plan) if s[0] == "pop")
    last_push = max(i for i, s in enumerate(plan) if s[0] == "push")
    prefixes: List[str] = []
    in_i, j = 1, 0
    for spec in plan[:last_push + 1]:
        if spec[0] == "push":
            in_i, j = in_i + 1, 0
        else:
            prefixes.append(f"input_blocks.{in_i}.{j}")
            j += 1
    for j, _ in enumerate(plan[last_push + 1:first_pop]):
        prefixes.append(f"middle_block.{j}")
    out_i, j = -1, 0
    for spec in plan[first_pop:]:
        if spec[0] == "pop":
            out_i, j = out_i + 1, 0
        else:
            prefixes.append(f"output_blocks.{out_i}.{j}")
            j += 1
    return prefixes


def state_dict_from_civitai(sd: Dict[str, torch.Tensor], plan: Sequence[BlockSpec] = SD15_PLAN
                            ) -> Dict[str, torch.Tensor]:
    """An LDM / civitai UNet (``model.diffusion_model.*`` or unprefixed: in_layers /
    emb_layers / out_layers resnets, SpatialTransformers with 1x1-conv proj_in / proj_out)
    renamed to ``SDUNet``'s keys (JAX ``sd_unet_params_from_civitai``); an SDXL file's
    ``label_emb.0.{0,2}`` becomes ``add_time_embedding.{0,2}``."""
    pre0 = "model.diffusion_model."
    if not any(k.startswith(pre0) for k in sd):
        pre0 = ""
    out: Dict[str, torch.Tensor] = {}

    def take(dst: str, src: str, flat: bool = False):
        for suffix in ("weight", "bias"):
            w = sd[f"{pre0}{src}.{suffix}"]
            out[f"{dst}.{suffix}"] = w.reshape(w.shape[0], -1) if flat and suffix == "weight" \
                else w

    def weight(dst: str, src: str):
        out[f"{dst}.weight"] = sd[f"{pre0}{src}.weight"]

    take("time_embedding.0", "time_embed.0")
    take("time_embedding.2", "time_embed.2")
    if f"{pre0}label_emb.0.0.weight" in sd:
        take("add_time_embedding.0", "label_emb.0.0")
        take("add_time_embedding.2", "label_emb.0.2")
    take("conv_in", "input_blocks.0.0")
    prefixes = iter(_ldm_prefixes(plan))
    for i, spec in enumerate(plan):
        kind, dst = spec[0], f"blocks.{i}"
        if kind in ("push", "pop"):
            continue
        base = next(prefixes)
        if kind == "res":
            for ref, ldm in (("norm1", "in_layers.0"), ("conv1", "in_layers.2"),
                             ("time_emb_proj", "emb_layers.1"), ("norm2", "out_layers.0"),
                             ("conv2", "out_layers.3")):
                take(f"{dst}.{ref}", f"{base}.{ldm}")
            if f"{pre0}{base}.skip_connection.weight" in sd:
                take(f"{dst}.conv_shortcut", f"{base}.skip_connection")
        elif kind == "attn":
            take(f"{dst}.norm", f"{base}.norm")
            take(f"{dst}.proj_in", f"{base}.proj_in", flat=True)
            take(f"{dst}.proj_out", f"{base}.proj_out", flat=True)
            for j in range(_depth(spec)):
                src, tb = f"{base}.transformer_blocks.{j}", f"{dst}.transformer_blocks.{j}"
                for a in ("attn1", "attn2"):
                    for proj in ("to_q", "to_k", "to_v"):
                        weight(f"{tb}.{a}.{proj}", f"{src}.{a}.{proj}")
                    take(f"{tb}.{a}.to_out", f"{src}.{a}.to_out.0")
                for n in ("norm1", "norm2", "norm3"):
                    take(f"{tb}.{n}", f"{src}.{n}")
                take(f"{tb}.act_fn.proj", f"{src}.ff.net.0.proj")
                take(f"{tb}.ff", f"{src}.ff.net.2")
        else:
            take(f"{dst}.conv", f"{base}.{'op' if kind == 'down' else 'conv'}")
    take("conv_norm_out", "out.0")
    take("conv_out", "out.2")
    return out
