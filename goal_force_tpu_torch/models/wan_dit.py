"""Wan video DiT in PyTorch.

Port of ``goal_force_tpu/models/wan_dit.py`` (main path, the Fun-Reference ``ref_conv``,
the CLIP image branch of the I2V-480P models (``img_emb`` and the cross-attention's
``k_img``/``v_img``/``norm_k_img``) and the int8/fp8 packs of ``ops/quant.py``; no
pipeline parallelism). Modules hold the parameters under the reference
("civitai") state-dict names that ``goal_force_tpu/io/torch_convert.py`` reads, so a
reference-format state dict loads directly. The computation is written as functions
over those modules, one per JAX function, with the same dtype steps:

- channels-last (B, F, H, W, C) latents; patchify is a reshape + matmul over flattened
  patches in (c, dy, dx) feature order (the Conv3d weight's own order);
- RMSNorm / LayerNorm statistics in float32, cast back before the weight multiply;
  GELU(tanh) and SiLU in float32;
- RoPE from float32 cos/sin tables; attention through ``ops.attention``.

Under a mesh (``parallel/mesh.py::use_mesh``, parameters placed by
``parallel/sharding.py::place``) the block functions take this rank's tokens and run the
layout JAX's ``constrain`` hints ask of GSPMD with explicit collectives
(``parallel/collectives.py``): q, k, v and ``ffn.0`` give this rank's tensor-parallel
columns (the q/k RMSNorm sums its squares over "tp" first, as it spans the whole
projection), self-attention trades tokens for heads over "sp" (Ulysses, in
``ops.attention.sharded_attention``), cross-attention keeps q token-split against every
text key (and, in the I2V image branch, against the replicated image keys, each rank on
its heads of them), and ``o`` and ``ffn.2`` sum their row-parallel outputs over "tp".
Under grad the collectives are differentiable (``parallel/collectives.py``), and a block
placed by ``parallel/fsdp.py`` gathers its whole weights inside its checkpoint, holding
the tensor-parallel slices in the same view.
"""

from __future__ import annotations

import math
from functools import partial
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from goal_force_tpu_torch.configs import WanDiTConfig
from goal_force_tpu_torch.ops.attention import sharded_attention, sharded_cross_attention
from goal_force_tpu_torch.ops.quant import QuantLinear
from goal_force_tpu_torch.ops.rope import apply_rope, assemble_rope, rope_tables_3d
from goal_force_tpu_torch.parallel import collectives as col
from goal_force_tpu_torch.parallel import fsdp
from goal_force_tpu_torch.parallel.mesh import axis_rank, axis_size, current_mesh
from goal_force_tpu_torch.parallel.sharding import PP_STAGE, tp_dim


# ---------------------------------------------------------------------------
# Primitive layers
# ---------------------------------------------------------------------------

def linear(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """An ``nn.Linear``, or an int8/fp8 pack (``ops/quant.py``), as JAX's ``linear``
    dispatches on its "w_i8"/"w_f8" leaves."""
    if isinstance(layer, QuantLinear):
        return layer(x)
    return F.linear(x, layer.weight, layer.bias)


def linear_col(layer: nn.Module, x: torch.Tensor, copied: bool = False) -> torch.Tensor:
    """``linear``; for a column-parallel weight placed on the ambient mesh, this rank's
    output columns (with its columns of the replicated bias). Under grad the replicated
    input's gradient is summed over "tp" (``copy_to``), unless the caller did so
    (`copied`) for several linears of one input."""
    if tp_dim(layer) == 0:
        x = x if copied else col.copy_to(x)
        if isinstance(layer, QuantLinear):
            return layer.forward_fn(x, layer.weight, layer.weight_scale,
                                    col.shard_of(layer.bias, 0))
        return F.linear(x, layer.weight, col.shard_of(layer.bias, 0))
    return linear(layer, x)


def linear_row(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``linear``; for a row-parallel weight placed on the ambient mesh, the sum over
    "tp" of every rank's partial product, the bias added by the axis's first rank (so
    over an axis of one the result is ``linear``'s, bit for bit). A W8A8/fp8 pack sums
    its accumulators instead, and rescales them as the whole product would be."""
    if tp_dim(layer) == 1:
        if isinstance(layer, QuantLinear):
            # the per-token activation scale is the amax over the whole input row, and
            # the ranks' accumulators are summed before the rescale (and the bias)
            return layer.forward_fn(x, layer.weight, layer.weight_scale, layer.bias,
                                    row_amax=_row_amax(x), reduce=col.all_reduce)
        return col.all_reduce(F.linear(x, layer.weight, col.first_rank_bias(layer.bias)))
    return linear(layer, x)


def _row_amax(x: torch.Tensor) -> torch.Tensor:
    """The amax of each row of x (..., K/tp) over the whole row, every rank's columns:
    one all-reduce (max) over "tp"."""
    amax = x.float().abs().amax(dim=-1, keepdim=True)
    return col.all_reduce_max(amax)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Normalize in float32, cast to x.dtype, then multiply by the weight."""
    xf = x.float()
    n = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return n.to(x.dtype) * w


def rms_norm_of(proj: nn.Module, x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """``rms_norm`` of `proj`'s output x. Where `proj` is column-parallel x holds this
    rank's columns: the mean of squares is the sum over "tp" of each rank's mean over
    its columns divided by the axis size, and the rank's columns of the replicated
    weight scale the result."""
    if tp_dim(proj) != 0:
        return rms_norm(x, w, eps)
    xf = x.float()
    ms = col.all_reduce(xf.square().mean(dim=-1, keepdim=True) / axis_size("tp"), shared=True)
    n = xf * torch.rsqrt(ms + eps)
    return n.to(x.dtype) * col.shard_of(w, 0)


def layer_norm(x: torch.Tensor, eps: float = 1e-6, w=None, b=None) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    out = ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)
    if w is not None:
        out = out * w + b
    return out


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    out = 0.5 * xf * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (xf + 0.044715 * xf**3)))
    return out.to(x.dtype)


def silu_f32(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x.float()).to(x.dtype)


def sinusoidal_embedding(dim: int, position: torch.Tensor) -> torch.Tensor:
    """float32 cos||sin table of the positions."""
    pos = position.float()
    half = dim // 2
    freqs = torch.pow(torch.tensor(10000.0, device=pos.device),
                      -torch.arange(half, dtype=torch.float32, device=pos.device) / half)
    sinusoid = torch.outer(pos, freqs)
    return torch.cat([torch.cos(sinusoid), torch.sin(sinusoid)], dim=1)


# ---------------------------------------------------------------------------
# Modules (parameter holders under the reference names)
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))


class LayerNormAffine(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


class Activation(nn.Module):
    """Parameter-free slot that keeps the reference's Sequential indices."""


class WanAttention(nn.Module):
    """image=True adds the image keys' projections of an I2V cross-attention."""

    def __init__(self, dim: int, image: bool = False):
        super().__init__()
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.o = nn.Linear(dim, dim)
        self.norm_q = RMSNorm(dim)
        self.norm_k = RMSNorm(dim)
        if image:
            self.k_img = nn.Linear(dim, dim)
            self.v_img = nn.Linear(dim, dim)
            self.norm_k_img = RMSNorm(dim)


class WanBlock(nn.Module):
    def __init__(self, cfg: WanDiTConfig, image: bool = False):
        super().__init__()
        self.self_attn = WanAttention(cfg.dim)
        self.cross_attn = WanAttention(cfg.dim, image)
        self.norm3 = LayerNormAffine(cfg.dim)
        self.ffn = nn.Sequential(nn.Linear(cfg.dim, cfg.ffn_dim), Activation(),
                                 nn.Linear(cfg.ffn_dim, cfg.dim))
        self.modulation = nn.Parameter(torch.zeros(1, 6, cfg.dim))


class WanHead(nn.Module):
    def __init__(self, cfg: WanDiTConfig):
        super().__init__()
        self.head = nn.Linear(cfg.dim, cfg.out_dim * math.prod(cfg.patch_size))
        self.modulation = nn.Parameter(torch.zeros(1, 2, cfg.dim))


class ImageEmbedding(nn.Module):
    """CLIP tokens -> DiT context tokens: LayerNorm, Linear, GELU(erf), Linear, LayerNorm
    under ``proj.{0,1,3,4}``, and an optional learned position embedding ``emb_pos``
    (1, pos_len, clip_dim) of the first-last-frame models."""

    def __init__(self, clip_dim: int, dim: int, pos_len: int = 0):
        super().__init__()
        self.proj = nn.Sequential(LayerNormAffine(clip_dim), nn.Linear(clip_dim, clip_dim),
                                  Activation(), nn.Linear(clip_dim, dim), LayerNormAffine(dim))
        if pos_len:
            self.emb_pos = nn.Parameter(torch.zeros(1, pos_len, clip_dim))


class WanDiT(nn.Module):
    """Optional parts, each present where a reference state dict has its keys
    (``dit_kwargs``): ref_conv_in > 0 adds the Fun-Reference ``ref_conv`` (Conv2d(ref_conv_in,
    dim, 2, stride 2)); clip_dim > 0 the I2V image branch, the image embedding ``img_emb``
    (with ``emb_pos`` when img_pos_len > 0) and the blocks' image-key projections."""

    def __init__(self, cfg: WanDiTConfig, ref_conv_in: int = 0, clip_dim: int = 0,
                 img_pos_len: int = 0):
        super().__init__()
        self.cfg = cfg
        if ref_conv_in:
            self.ref_conv = nn.Conv2d(ref_conv_in, cfg.dim, 2, 2)
        if clip_dim:
            self.img_emb = ImageEmbedding(clip_dim, cfg.dim, img_pos_len)
        self.patch_embedding = nn.Conv3d(cfg.in_dim, cfg.dim, cfg.patch_size, cfg.patch_size)
        self.text_embedding = nn.Sequential(nn.Linear(cfg.text_dim, cfg.dim), Activation(),
                                            nn.Linear(cfg.dim, cfg.dim))
        self.time_embedding = nn.Sequential(nn.Linear(cfg.freq_dim, cfg.dim), Activation(),
                                            nn.Linear(cfg.dim, cfg.dim))
        self.time_projection = nn.Sequential(Activation(), nn.Linear(cfg.dim, cfg.dim * 6))
        self.blocks = nn.ModuleList(WanBlock(cfg, clip_dim > 0) for _ in range(cfg.num_layers))
        self.head = WanHead(cfg)


# ---------------------------------------------------------------------------
# Patchify (Conv3d with kernel == stride is a matmul over flattened patches)
# ---------------------------------------------------------------------------

def patchify(conv: nn.Conv3d, x: torch.Tensor, patch_size: Tuple[int, int, int]):
    """x: (B, F, H, W, C) -> tokens (B, F*h*w, D), grid (F, h, w)."""
    pf, ph, pw = patch_size
    b, f, hh, ww, c = x.shape
    fo, ho, wo = f // pf, hh // ph, ww // pw
    x = x.reshape(b, fo, pf, ho, ph, wo, pw, c).permute(0, 1, 3, 5, 7, 2, 4, 6)
    x = x.reshape(b, fo * ho * wo, c * pf * ph * pw)
    w = conv.weight.reshape(conv.weight.shape[0], -1)
    return F.linear(x, w, conv.bias), (fo, ho, wo)


def unpatchify(x: torch.Tensor, grid, patch_size, out_dim: int) -> torch.Tensor:
    """(B, S, prod(patch)*out_dim) -> (B, F, H, W, C); feature order (pf, ph, pw, c)."""
    pf, ph, pw = patch_size
    b = x.shape[0]
    f, h, w = grid
    x = x.reshape(b, f, h, w, pf, ph, pw, out_dim).permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, f * pf, h * ph, w * pw, out_dim)


# ---------------------------------------------------------------------------
# DiT block
# ---------------------------------------------------------------------------

def _sharded_qkv(p: WanAttention, x, kv, num_heads: int, eps: float):
    """q of x and k, v of kv after their norms, and whether the columns are this rank's
    own. Under a mesh they are this rank's tensor-parallel columns (the q/k norms over
    the whole projection), or every column where a rank's columns would cut heads (then
    not its own); without one, every column."""
    xs = col.copy_to(x) if tp_dim(p.q) == 0 else x
    kvs = xs if kv is x else (col.copy_to(kv) if tp_dim(p.k) == 0 else kv)
    q = rms_norm_of(p.q, linear_col(p.q, xs, copied=True), p.norm_q.weight, eps)
    k = rms_norm_of(p.k, linear_col(p.k, kvs, copied=True), p.norm_k.weight, eps)
    v = linear_col(p.v, kvs, copied=True)
    own = tp_dim(p.q) != 0 or num_heads % axis_size("tp") == 0
    if not own:
        q, k, v = (col.gather_cols(u) for u in (q, k, v))
    return q, k, v, own


def self_attention(p: WanAttention, x, cos, sin, num_heads: int, eps: float,
                   attn_impl: str = "auto", bounded: bool = False):
    """Self-attention of x. Under a mesh x, cos and sin hold this rank's tokens: RoPE is
    applied before the Ulysses exchange of ``sharded_attention``, and o takes this
    rank's columns of the output."""
    b, s, d = x.shape
    hd = d // num_heads
    q, k, v, own = _sharded_qkv(p, x, x, num_heads, eps)
    q = apply_rope(q.reshape(b, s, -1, hd), cos, sin)
    k = apply_rope(k.reshape(b, s, -1, hd), cos, sin)
    out = sharded_attention(q, k, v.reshape(b, s, -1, hd), impl=attn_impl,
                            bounded=bounded).reshape(b, s, -1)
    return linear_row(p.o, out if own else col.shard_of(out, 2))


def cross_attention(p: WanAttention, x, context, num_heads: int, eps: float,
                    attn_impl: str = "auto", bounded: bool = False, num_img_tokens: int = 0):
    """Text cross-attention over every context token (no mask). With num_img_tokens > 0
    the first tokens of `context` are image tokens, attended through k_img/v_img with the
    same queries; the two attentions' outputs are added before ``o``. Under a mesh q
    keeps this rank's tokens against every text key: no exchange before the kernel (with
    attn_impl "ring", where JAX's condition holds, the keys split over "sp" and rotate:
    ``sharded_cross_attention``); the image keys are projected whole (their norm spans
    every head) and each rank keeps its heads of them."""
    b, s, d = x.shape
    img, ctx = context[:, :num_img_tokens], context[:, num_img_tokens:]
    t = ctx.shape[1]
    hd = d // num_heads
    q, k, v, own = _sharded_qkv(p, x, ctx, num_heads, eps)
    q = q.reshape(b, s, -1, hd)
    out = sharded_cross_attention(q, k.reshape(b, t, -1, hd), v.reshape(b, t, -1, hd),
                                  impl=attn_impl, bounded=bounded).reshape(b, s, -1)
    if num_img_tokens:
        k_img = rms_norm(linear(p.k_img, img), p.norm_k_img.weight, eps).reshape(
            b, num_img_tokens, num_heads, -1)
        v_img = linear(p.v_img, img).reshape(b, num_img_tokens, num_heads, -1)
        if own and q.shape[2] != num_heads:       # this rank's heads of the image keys
            k_img, v_img = col.shard_of(k_img, 2), col.shard_of(v_img, 2)
        out = out + sharded_cross_attention(q, k_img, v_img, impl=attn_impl,
                                            bounded=bounded).reshape(b, s, -1)
    return linear_row(p.o, out if own else col.shard_of(out, 2))


def dit_block(p: WanBlock, x, context, t_mod, cos, sin, cfg: WanDiTConfig,
              attn_impl: str = "auto", num_img_tokens: int = 0):
    """One DiT block with 6-way AdaLN modulation. t_mod: (B, 6, D)."""
    mod = p.modulation.to(t_mod.dtype) + t_mod                 # (B, 6, D)
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = (
        mod[:, i][:, None, :] for i in range(6))
    h = layer_norm(x, cfg.eps) * (1 + scale_msa) + shift_msa
    x = x + gate_msa * self_attention(p.self_attn, h, cos, sin, cfg.num_heads, cfg.eps,
                                      attn_impl, bounded=cfg.qk_bounded)
    x = x + cross_attention(p.cross_attn, layer_norm(x, cfg.eps, p.norm3.weight, p.norm3.bias),
                            context, cfg.num_heads, cfg.eps, attn_impl,
                            bounded=cfg.qk_bounded, num_img_tokens=num_img_tokens)
    h = layer_norm(x, cfg.eps) * (1 + scale_mlp) + shift_mlp
    return x + gate_mlp * feed_forward(p, h)


FFN_CHUNK_TOKENS = 16384


def feed_forward(p: WanBlock, h: torch.Tensor) -> torch.Tensor:
    """The block's GELU(tanh) MLP, over chunks of at most FFN_CHUNK_TOKENS tokens. It acts
    on each token alone, so the chunks compute the same function; only one chunk's float32
    GELU temporaries are alive at a time (XLA fuses the GELU and keeps none), which at
    65,520 tokens and ffn_dim 13,824 is 0.9 GB each instead of 3.6 GB. Under a mesh
    ``ffn.0`` is column- and ``ffn.2`` row-parallel: each chunk's output is summed over
    "tp"."""
    rows = h.reshape(-1, h.shape[-1])
    out = [linear_row(p.ffn[2], gelu_tanh(linear_col(p.ffn[0], c)))
           for c in rows.split(FFN_CHUNK_TOKENS)]
    return (out[0] if len(out) == 1 else torch.cat(out)).reshape(*h.shape[:-1], -1)


def _run_block(block_weights, i, blk, *args):
    """Block i on its whole weights (gathered here, inside the block's checkpoint, where
    the block is FSDP-placed: ``parallel/fsdp.py``), merged by `block_weights`."""
    blk = fsdp.gathered(blk)
    return dit_block(blk if block_weights is None else block_weights(i, blk), *args)


def _check_stage(blk, i: int) -> None:
    """Refuse a block that another pipeline stage holds (placed on a "pp" mesh)."""
    stage = blk.__dict__.get(PP_STAGE)
    if stage is not None and current_mesh() is not None and stage != axis_rank("pp"):
        raise ValueError(f"block {i} lives on pipeline stage {stage}, not on this rank's "
                         f"stage {axis_rank('pp')}: on a mesh with a \"pp\" axis the trunk "
                         "runs through pp_run_blocks (pp_microbatches)")


def run_blocks(blocks: Sequence[WanBlock], x, context, t_mod, cos, sin, cfg: WanDiTConfig,
               injections: Optional[List[torch.Tensor]] = None, attn_impl: str = "auto",
               remat: bool = False, block_weights=None, start: int = 0,
               stop: Optional[int] = None, num_img_tokens: int = 0):
    """Run x through blocks[start:stop]; injections[i] (the ControlNet outputs) is added
    after block i for every i < len(injections) where it is not None. Indices are the
    blocks' own in `blocks`, so a segment's block i still gets injections[i] and
    block_weights(i, ...).

    remat: recompute each block in the backward pass instead of keeping its activations
    (one non-reentrant checkpoint per block, as JAX checkpoints each scan body). The
    forward then already sees grad-requiring inputs, so attention takes K3 there too.
    block_weights: ``block_weights(i, blk)`` gives the block that runs in place of block
    i, called inside the block's checkpoint (LoRA's merged weights).
    num_img_tokens: the leading image tokens of `context` (the I2V image branch).
    """
    n_inj = 0 if injections is None else len(injections)
    for i in range(start, len(blocks) if stop is None else stop):
        blk = blocks[i]
        _check_stage(blk, i)
        fn = partial(_run_block, block_weights, i)
        if remat:
            if current_mesh() is not None:       # the recompute runs on autograd's thread
                fn = col.carry_context(fn)
            x = checkpoint(fn, blk, x, context, t_mod, cos, sin, cfg, attn_impl,
                           num_img_tokens, use_reentrant=False)
        else:
            x = fn(blk, x, context, t_mod, cos, sin, cfg, attn_impl, num_img_tokens)
        if i < n_inj and injections[i] is not None:
            x = x + injections[i].to(x.dtype)
    return x


class GPipeStage:
    """One stage of the GPipe schedule of ``pp_run_blocks`` (JAX ``wan_dit.py:283-460``):
    stage `stage` of `pp` runs blocks [stage * L/pp, (stage + 1) * L/pp) of `blocks`,
    one microbatch per tick, over n_micro + pp - 1 ticks.

    Microbatch j holds the strided rows {j, n_micro + j, ...} of x, context and t_mod.
    At tick t stage 0 takes microbatch t (t < n_micro) in place of what it received;
    stage s works on microbatch clip(t - s) and adds its own layers' injections for it;
    stage pp - 1 drains its output into slot t - (pp - 1). ``tick(t, received)`` returns
    what the stage hands to the next one (``gpipe`` runs the ticks; ``pp_run_blocks``
    moves the outputs with a shift over "pp", a one-card check of several virtual stages
    directly), ``drained()`` the (n_micro, mb, S, D) slots (zeros on the other stages).

    injections: this stage's layers' injections, in order ((B, S, D) each; fewer than
    L/pp where the ControlNet ends). anchor: under grad, a zero scalar added to every
    tick's output (``collectives.stage_take``'s), which ties each stage's hand-offs to
    the trained ControlNet also where the stage has no injection.

    Under grad every tick keeps JAX's 0/1 gates: each tick computes its blocks (a bubble
    tick, whose output no drain ever reads, too), the feed is g * x + (1 - g) * received
    and the drain w * out + (1 - w) * slot, so every received buffer and every output
    stays in the graph and the backward runs each hand-off's transpose on every rank, in
    the same order. Without grad (serving) a bubble tick skips its blocks and hands on
    what it received.
    """

    def __init__(self, blocks, x, context, t_mod, cos, sin, cfg: WanDiTConfig, stage: int,
                 pp: int, n_micro: int, injections=None, anchor=None, attn_impl="auto",
                 remat=False, block_weights=None, num_img_tokens: int = 0):
        self.per = cfg.num_layers // pp
        self.stage, self.pp, self.n_micro = stage, pp, n_micro
        self.ticks = n_micro + pp - 1
        self.lo = stage * self.per
        self.x, self.context, self.t_mod = x, context, t_mod
        self.injections = [None] * self.lo + list(injections or [])
        self.anchor = anchor
        self.grad = torch.is_grad_enabled()
        self.run = partial(run_blocks, blocks, cos=cos, sin=sin, cfg=cfg, attn_impl=attn_impl,
                           remat=remat, block_weights=block_weights, start=self.lo,
                           stop=self.lo + self.per, num_img_tokens=num_img_tokens)
        self.outs = [torch.zeros_like(self.rows(x, 0)) for _ in range(n_micro)]

    def rows(self, t, m: int):
        """Microbatch m's rows of t."""
        return t[m::self.n_micro]

    def blocks(self, buf, m: int):
        inj = [None if u is None else self.rows(u, m) for u in self.injections]
        out = self.run(buf, context=self.rows(self.context, m), t_mod=self.rows(self.t_mod, m),
                       injections=inj if self.injections else None)
        return out if self.anchor is None else out + self.anchor

    def tick(self, t: int, received):
        s, n = self.stage, self.n_micro
        m = min(max(t - s, 0), n - 1)
        feeding = s == 0 and t < n
        drain = s == self.pp - 1 and t >= self.pp - 1
        dst = min(max(t - (self.pp - 1), 0), n - 1)
        feed = lambda: self.rows(self.x, min(t, n - 1)).contiguous()
        if self.grad:
            g, w = float(feeding), float(drain)
            out = self.blocks(g * feed() + (1 - g) * received, m)
            self.outs[dst] = w * out + (1 - w) * self.outs[dst]
            return out
        buf = feed() if feeding else received
        if not 0 <= t - s < n:              # a bubble tick
            return buf
        out = self.blocks(buf, m)
        if drain:
            self.outs[dst] = out
        return out

    def drained(self):
        return torch.stack(self.outs)


def gpipe(stages: Sequence[GPipeStage], hand_off) -> List[torch.Tensor]:
    """Every tick of the schedule for `stages` (the ``GPipeStage``s this process runs, in
    stage order): each stage's tick on what it received, then ``hand_off(outs)`` gives
    what each receives at the next tick (zeros at the first). Returns each stage's
    drained slots."""
    received = [torch.zeros_like(st.rows(st.x, 0)) for st in stages]
    ticks = stages[0].ticks
    for t in range(ticks):
        outs = [st.tick(t, r) for st, r in zip(stages, received)]
        if t + 1 < ticks:
            received = hand_off(outs)
    return [st.drained() for st in stages]


def from_microbatches(outs: torch.Tensor) -> torch.Tensor:
    """(n_micro, mb, S, D) drained slots -> (B, S, D): microbatch m's rows back in place
    m, n_micro + m, ..."""
    return outs.transpose(0, 1).reshape(-1, *outs.shape[2:])


def pp_run_blocks(blocks: Sequence[WanBlock], x, context, t_mod, cos, sin, cfg: WanDiTConfig,
                  *, n_micro: int, injections: Optional[List[torch.Tensor]] = None,
                  remat: bool = False, attn_impl: str = "auto", block_weights=None,
                  num_img_tokens: int = 0):
    """The block trunk in a GPipe schedule over the ambient mesh's "pp" axis (JAX
    ``wan_dit.py::pp_run_blocks``); without a mesh, or with no "pp" axis or one of size
    1, ``run_blocks``. x (B, S, D), context, t_mod and the injections are this rank's rows
    and tokens, alike on every stage; the result too.

    n_micro becomes the largest divisor of B that is at most n_micro (B = 1: one
    microbatch walking the stages). This rank runs ``GPipeStage`` for its stage: its
    L/pp blocks (only those have storage here where the DiT was placed with stage pins),
    its layers' injections (``collectives.stage_take``, whose backward hands each
    injection's gradient from its stage to every stage); between ticks each stage's
    output goes to the next stage (``collectives.shift`` over "pp" without wraparound;
    its backward hands the gradient back), and the drained result, held by stage pp - 1
    alone, is summed over "pp" (JAX's psum), so every rank returns it. Raises ValueError
    where "pp" does not divide the layers."""
    pp = axis_size("pp")
    if pp == 1:
        return run_blocks(blocks, x, context, t_mod, cos, sin, cfg, injections=injections,
                          attn_impl=attn_impl, remat=remat, block_weights=block_weights,
                          num_img_tokens=num_img_tokens)
    if cfg.num_layers % pp:
        raise ValueError(f"num_layers {cfg.num_layers} not divisible by pp {pp}")
    b = x.shape[0]
    n_micro = max(1, min(n_micro, b))
    while b % n_micro:
        n_micro -= 1
    anchor, mine = None, None
    if injections:
        anchor, *mine = col.stage_take(list(injections), cfg.num_layers // pp)
    st = GPipeStage(blocks, x, context, t_mod, cos, sin, cfg, axis_rank("pp"), pp, n_micro,
                    mine, anchor, attn_impl, remat, block_weights, num_img_tokens)
    (drained,) = gpipe([st], lambda outs: [col.shift(outs[0], "pp", 1, wrap=False)])
    return from_microbatches(col.all_reduce(drained, "pp"))   # only stage pp - 1's is not 0


def head(p: WanHead, x, t, eps: float = 1e-6):
    """Final projection with 2-way modulation. t: (B, D)."""
    mod = p.modulation.to(t.dtype) + t[:, None, :]             # (B, 2, D)
    shift, scale = mod[:, 0][:, None, :], mod[:, 1][:, None, :]
    return linear(p.head, layer_norm(x, eps) * (1 + scale) + shift)


def time_embed(model: WanDiT, cfg: WanDiTConfig, timestep: torch.Tensor, dtype=None):
    """timestep (B,) -> t (B, D), t_mod (B, 6, D)."""
    emb = sinusoidal_embedding(cfg.freq_dim, timestep)
    emb = emb.to(dtype if dtype is not None else model.time_embedding[0].weight.dtype)
    t = linear_col(model.time_embedding[0], emb)
    t = linear_row(model.time_embedding[2], silu_f32(t))
    t_mod = linear(model.time_projection[1], silu_f32(t))
    return t, t_mod.reshape(t.shape[0], 6, cfg.dim)


def text_embed(model: WanDiT, x):
    return linear_row(model.text_embedding[2], gelu_tanh(linear_col(model.text_embedding[0], x)))


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return (0.5 * xf * (1.0 + torch.erf(xf / math.sqrt(2.0)))).to(x.dtype)


def img_embed(model: WanDiT, clip_feature: torch.Tensor) -> torch.Tensor:
    """CLIP tokens (B, T, clip_dim) -> image context tokens (B, T, D)."""
    p = model.img_emb
    x = clip_feature
    if hasattr(p, "emb_pos"):
        x = x + p.emb_pos[0].to(x.dtype)
    proj = p.proj
    x = layer_norm(x, 1e-5, proj[0].weight, proj[0].bias)
    x = linear_row(proj[3], gelu_erf(linear_col(proj[1], x)))
    return layer_norm(x, 1e-5, proj[4].weight, proj[4].bias)


def rope_for_grid(cfg: WanDiTConfig, grid, device):
    tables = rope_tables_3d(cfg.head_dim, cfg.rope_max_len)
    return assemble_rope(tables, *grid, device=device)


def wan_dit_forward(model: WanDiT, cfg: WanDiTConfig, x, timestep, context, y=None,
                    attn_impl: str = "auto", clip_feature=None):
    """Base-model velocity (B, F, H, W, out_dim) for latents x (B, F, H, W, C),
    timestep (B,), context (B, L, text_dim) and optional conditioning y. clip_feature
    (B, T, clip_dim), the image encoder's tokens, is used only where
    ``cfg.has_image_input``: its embedding goes in front of the text context. Under a
    mesh the batch splits over "dp" (where it divides) and the patch tokens over "sp",
    as in ``pipelines/model_fn.py::denoise_forward``; the image and text keys stay whole
    on every rank, and every rank returns the whole output."""
    mesh = current_mesh()
    dp_split = mesh is not None and x.shape[0] % axis_size("dp") == 0
    if dp_split:
        x, timestep, context, y, clip_feature = (col.split_batch(u) for u in (
            x, timestep, context, y, clip_feature))
    model = fsdp.gathered(model, skip=("blocks",))
    t, t_mod = time_embed(model, cfg, timestep)
    context = text_embed(model, context)
    num_img_tokens = 0
    if clip_feature is not None and cfg.has_image_input:
        img_ctx = img_embed(model, clip_feature)
        num_img_tokens = img_ctx.shape[1]
        context = torch.cat([img_ctx, context.to(img_ctx.dtype)], dim=1)
    if y is not None:
        x = torch.cat([x, y.to(x.dtype)], dim=-1)
    tokens, grid = patchify(model.patch_embedding, x, cfg.patch_size)
    cos, sin = rope_for_grid(cfg, grid, tokens.device)
    n_tokens = tokens.shape[1]
    if mesh is not None:
        tokens, cos, sin = (col.split_seq(u, d) for u, d in ((tokens, 1), (cos, 0), (sin, 0)))
    with col.sequence_split(n_tokens):
        tokens = run_blocks(model.blocks, tokens, context, t_mod, cos, sin, cfg,
                            attn_impl=attn_impl, num_img_tokens=num_img_tokens)
    if mesh is not None:
        tokens = col.gather_seq(tokens, n_tokens)
    out = unpatchify(head(model.head, tokens, t, cfg.eps), grid, cfg.patch_size, cfg.out_dim)
    return col.gather_batch(out) if dp_split else out


# ---------------------------------------------------------------------------
# Random init (the JAX package's distributions)
# ---------------------------------------------------------------------------

def empty_module(cls, *args, dtype=torch.float32, device, **kwargs):
    """Build a module without running its default initialisers."""
    with torch.device("meta"):
        mod = cls(*args, **kwargs)
    return mod.to(dtype=dtype).to_empty(device=device)


def init_linear_(layer: nn.Linear, gen: torch.Generator, d_in: Optional[int] = None):
    scale = 1.0 / math.sqrt(d_in or layer.weight.shape[1])
    layer.weight.uniform_(-scale, scale, generator=gen)
    if layer.bias is not None:
        layer.bias.zero_()


@torch.no_grad()
def init_block_(blk: WanBlock, gen: torch.Generator):
    for attn_mod in (blk.self_attn, blk.cross_attn):
        for lin in (attn_mod.q, attn_mod.k, attn_mod.v, attn_mod.o):
            init_linear_(lin, gen)
        attn_mod.norm_q.weight.fill_(1.0)
        attn_mod.norm_k.weight.fill_(1.0)
    blk.norm3.weight.fill_(1.0)
    blk.norm3.bias.zero_()
    init_linear_(blk.ffn[0], gen)
    init_linear_(blk.ffn[2], gen)
    dim = blk.modulation.shape[-1]
    blk.modulation.normal_(generator=gen).div_(dim**0.5)


@torch.no_grad()
def init_patch_embedding_(conv: nn.Conv3d, gen: torch.Generator):
    fan_in = conv.weight[0].numel()
    scale = 1.0 / math.sqrt(fan_in)
    conv.weight.uniform_(-scale, scale, generator=gen)
    conv.bias.zero_()


def dit_kwargs(sd) -> dict:
    """WanDiT's optional parts that a reference-format state dict holds."""
    kw = {}
    if "ref_conv.weight" in sd:
        kw["ref_conv_in"] = sd["ref_conv.weight"].shape[1]
    if "img_emb.proj.0.weight" in sd:
        kw["clip_dim"] = sd["img_emb.proj.0.weight"].shape[0]
    if "img_emb.emb_pos" in sd:
        kw["img_pos_len"] = sd["img_emb.emb_pos"].shape[1]
    return kw


def reference_tokens(conv: nn.Conv2d, latents: torch.Tensor) -> torch.Tensor:
    """Fun-Reference: latents (B, h, w, z) -> tokens (B, h/2 * w/2, D), each 2 x 2 patch
    flattened in (c, dy, dx) order through the 2 x 2 / stride-2 ``ref_conv``."""
    b, hh, ww, c = latents.shape
    r = latents.reshape(b, hh // 2, 2, ww // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
    r = r.reshape(b, (hh // 2) * (ww // 2), c * 4)
    return F.linear(r, conv.weight.reshape(conv.weight.shape[0], -1), conv.bias)


@torch.no_grad()
def init_ref_conv_(model: WanDiT, z_dim: int, gen: torch.Generator) -> WanDiT:
    """Give `model` a Fun-Reference ref_conv with uniform +-1/sqrt(fan_in) weights."""
    w = model.patch_embedding.weight
    model.ref_conv = nn.Conv2d(z_dim, model.cfg.dim, 2, 2, dtype=w.dtype, device=w.device)
    init_patch_embedding_(model.ref_conv, gen)
    model.ref_conv.requires_grad_(False)
    return model


@torch.no_grad()
def init_image_branch_(model: WanDiT, gen: torch.Generator, clip_dim: int = 1280,
                       pos_len: int = 0) -> WanDiT:
    """Give `model` the I2V image branch (``img_emb``, and ``k_img``/``v_img``/
    ``norm_k_img`` in every block) with uniform +-1/sqrt(fan_in) linears, zero biases,
    unit norms and, with pos_len, an N(0, 1/clip_dim) ``emb_pos``. The JAX package has no
    initialiser for it (its weights come from a file); this one feeds tests and the
    smoke."""
    w = model.patch_embedding.weight
    dim = model.cfg.dim
    like = dict(dtype=w.dtype, device=w.device)
    model.img_emb = empty_module(ImageEmbedding, clip_dim, dim, pos_len, **like)
    for norm in (model.img_emb.proj[0], model.img_emb.proj[4]):
        norm.weight.fill_(1.0)
        norm.bias.zero_()
    init_linear_(model.img_emb.proj[1], gen)
    init_linear_(model.img_emb.proj[3], gen)
    if pos_len:
        model.img_emb.emb_pos.normal_(generator=gen).div_(clip_dim**0.5)
    for blk in model.blocks:
        a = blk.cross_attn
        a.k_img = nn.Linear(dim, dim, **like)
        a.v_img = nn.Linear(dim, dim, **like)
        a.norm_k_img = RMSNorm(dim).to(**like)
        init_linear_(a.k_img, gen)
        init_linear_(a.v_img, gen)
    return model.requires_grad_(False)


@torch.no_grad()
def init_wan_dit(cfg: WanDiTConfig, gen: torch.Generator, dtype=torch.bfloat16, *,
                 device) -> WanDiT:
    """Random weights with the JAX init's distributions (uniform +-1/sqrt(fan_in) linears,
    zero biases, unit norms, N(0, 1/dim) modulations), drawn from `gen`."""
    model = empty_module(WanDiT, cfg, dtype=dtype, device=device)
    init_patch_embedding_(model.patch_embedding, gen)
    for lin in (model.text_embedding[0], model.text_embedding[2], model.time_embedding[0],
                model.time_embedding[2], model.time_projection[1], model.head.head):
        init_linear_(lin, gen)
    for blk in model.blocks:
        init_block_(blk, gen)
    model.head.modulation.normal_(generator=gen).div_(cfg.dim**0.5)
    return model.eval().requires_grad_(False)
