"""The Stable Diffusion 2D primitives, channels-last.

Port of the primitives of ``goal_force_tpu/models/sd_unet.py`` that the image VAE
(``models/sd_vae.py``) and the Flux adapters read: GroupNorm in float32, the NHWC
``conv2d``, the projected multi-head ``_attention`` (its ``ctx_len`` key mask at
float32's lowest finite value, its IP-Adapter branch) and the ``_resnet`` block. JAX's
cos-first ``timestep_embedding`` is ``models/wan_dit.py::sinusoidal_embedding`` here
(``tests/test_torch_text_towers.py`` holds the two equal), its affine LayerNorm
``models/clip.py::_ln``. The SD UNet itself (its block
plans and ``sd_unet_apply``) waits for the UNet families (ROADMAP queue 1, M14d).

JAX's dtype rules are kept: a conv or a linear casts its weights to the input's dtype,
and a norm's affine promotes to float32 before the cast back, so a float32 input over
bf16 weights computes in float32 over bf16-rounded weights, as XLA does.

Parameters live in modules under the reference ("diffsynth") names: a norm holds
``weight``/``bias``, a conv is an ``nn.Conv2d`` (out, in, kh, kw), an attention
``to_q``/``to_k``/``to_v``/``to_out`` linears.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from goal_force_tpu_torch.models.wan_dit import LayerNormAffine
from goal_force_tpu_torch.ops.attention import plain_attention


class Attention(nn.Module):
    """The biased q, k, v and output projections of one attention (the VAE's)."""

    def __init__(self, dim: int):
        super().__init__()
        self.to_q = nn.Linear(dim, dim)
        self.to_k = nn.Linear(dim, dim)
        self.to_v = nn.Linear(dim, dim)
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
    odd kernels here), "VALID" pads nothing. The NCHW view of the NHWC tensor is
    channels-last, so no copy is made on either side of the conv."""
    pad = (p.weight.shape[-1] - 1) // 2 if padding == "SAME" else 0
    out = F.conv2d(x.permute(0, 3, 1, 2), p.weight.to(x.dtype), _cast(p.bias, x), stride, pad)
    return out.permute(0, 2, 3, 1)


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
    q = linear(p.to_q, x).reshape(b, s, num_heads, -1)
    k = linear(p.to_k, ctx).reshape(b, t, num_heads, -1)
    v = linear(p.to_v, ctx).reshape(b, t, num_heads, -1)
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
