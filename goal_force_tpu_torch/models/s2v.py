"""WanS2V — the speech-to-video DiT (Wan2.2-S2V-14B), in PyTorch.

Port of ``goal_force_tpu/models/s2v.py``:

  - the bucketed RoPE tables, built on the host in float64 numpy as there (video tokens,
    the reference frame at time offset 30, the packed motion buckets at negative time
    offsets, whose angles are conjugated);
  - ``causal_conv1d`` (replicate-padded front), the motion encoder and the causal audio
    encoder (a SiLU-weighted mix of the wav2vec2 layers);
  - ``frame_pack_motion``: the 1x/2x/4x motion-latent packers as patch matmuls, with the
    JAX package's reshape semantics (the 4x packer needs the latent height and width to
    divide by 8);
  - ``s2v_block`` with its two-row modulation (row 0 for the video tokens, row 1, from a
    zero timestep, for the reference and motion tokens) and ``audio_inject`` (per-frame
    AdaLN on the global audio embedding, then cross-attention of each latent frame's
    tokens to its audio tokens, batched over frames);
  - ``wan_s2v_forward``.

Every attention goes through ``ops.attention.attention`` without ``bounded``, as JAX's
does: on the card each call takes the runtime logit bound (one host sync) and then K1
without clamp or K2. Under an ambient mesh (``S2VPipeline.mesh``) each attention splits
its heads over ("sp", "tp") and its batch rows over "dp", and each rank takes the bound
on its own heads (JAX's per-shard ``lax.cond``), so ranks may run different kernels;
with ``attn_impl="ring"`` the tokens ring over "sp" instead where the lengths divide.
Modules hold the parameters under the reference's names, the keys
that JAX's ``s2v_params_from_torch`` reads (including the reference's spelling
``casual_audio_encoder``); ``s2v_from_state_dict`` loads them strictly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from goal_force_tpu_torch.models.wan_dit import (
    Activation,
    WanAttention,
    WanBlock,
    WanHead,
    empty_module,
    feed_forward,
    gelu_tanh,
    head,
    init_block_,
    init_linear_,
    init_patch_embedding_,
    layer_norm,
    linear,
    patchify,
    rms_norm,
    silu_f32,
    sinusoidal_embedding,
    unpatchify,
)
from goal_force_tpu_torch.ops.attention import attention
from goal_force_tpu_torch.ops.rope import _axis_freqs, apply_rope


@dataclasses.dataclass(frozen=True)
class S2VConfig:
    """Defaults: the Wan2.2-S2V-14B preset."""

    dim: int = 5120
    in_dim: int = 16
    ffn_dim: int = 13824
    out_dim: int = 16
    text_dim: int = 4096
    freq_dim: int = 256
    eps: float = 1e-6
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    num_heads: int = 40
    num_layers: int = 40
    cond_dim: int = 16
    audio_dim: int = 1024
    num_audio_token: int = 4
    audio_encoder_layers: int = 25
    enable_adain: bool = True
    audio_inject_layers: Tuple[int, ...] = (0, 4, 8, 12, 16, 20, 24, 27, 30, 33, 36, 39)
    zip_frame_buckets: Tuple[int, int, int] = (1, 2, 16)

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads


WAN22_S2V_14B = S2VConfig()


def tiny_s2v(num_layers: int = 2) -> S2VConfig:
    # audio_encoder_layers stays 25: the reference fixes the audio encoder's layer count.
    return S2VConfig(dim=96, in_dim=4, ffn_dim=128, out_dim=4, text_dim=32, freq_dim=32,
                     num_heads=4, num_layers=num_layers, cond_dim=4, audio_dim=16,
                     num_audio_token=2, audio_inject_layers=(0, 1))


# ---------------------------------------------------------------------------
# Bucketed RoPE tables (host, float64 -> float32 cos/sin)
# ---------------------------------------------------------------------------

def _bucket_angles(head_dim: int, f_o: int, f: int, h: int, w: int,
                   t_f: int, t_h: int, t_w: int, max_len: int = 1024) -> np.ndarray:
    """(seq, head_dim // 2) angles of one grid bucket; a negative time offset f_o (motion
    history) negates (conjugates) the time angles."""
    c = head_dim // 2
    d_f, d_hw = c - 2 * (c // 3), c // 3
    ang_f = _axis_freqs(2 * d_f, max_len)
    ang_h = _axis_freqs(2 * d_hw, max_len)
    ang_w = _axis_freqs(2 * d_hw, max_len)
    seq_f, seq_h, seq_w = f - f_o, h, w
    if f_o >= 0:
        af = ang_f[np.linspace(f_o, t_f + f_o - 1, seq_f).astype(int)]
    else:
        af = -ang_f[np.linspace(-f_o, -t_f - f_o + 1, seq_f).astype(int)]
    h_sam = np.linspace(0, t_h - 1, seq_h).astype(int)
    w_sam = np.linspace(0, t_w - 1, seq_w).astype(int)
    grid = np.concatenate([
        np.broadcast_to(af[:, None, None, :], (seq_f, seq_h, seq_w, d_f)),
        np.broadcast_to(ang_h[h_sam][None, :, None, :], (seq_f, seq_h, seq_w, d_hw)),
        np.broadcast_to(ang_w[w_sam][None, None, :, :], (seq_f, seq_h, seq_w, d_hw)),
    ], axis=-1)
    return grid.reshape(seq_f * seq_h * seq_w, c)


def s2v_rope_tables(cfg: S2VConfig, grid_x: Tuple[int, int, int],
                    grid_ref: Tuple[int, int, int],
                    motion_grid: Optional[Tuple[int, int]] = None, *, device):
    """float32 cos/sin (S_total, head_dim // 2) on `device`, from float64 angles of [video
    tokens, reference tokens, motion tokens]: the reference frame sits at time offset 30;
    the motion buckets (1 frame at 1x, 2 frames at 2x, 16 at 4x) at negative offsets."""
    f, h, w = grid_x
    _, rh, rw = grid_ref
    angles = [
        _bucket_angles(cfg.head_dim, 0, f, h, w, f, h, w),
        _bucket_angles(cfg.head_dim, 30, 31, rh, rw, 1, rh, rw),
    ]
    if motion_grid is not None:
        lh, lw = motion_grid
        zb = cfg.zip_frame_buckets
        angles.append(_bucket_angles(cfg.head_dim, -zb[0], 0, lh // 2, lw // 2,
                                     zb[0], lh // 2, lw // 2))
        angles.append(_bucket_angles(cfg.head_dim, -(zb[0] + zb[1]),
                                     -(zb[0] + zb[1]) + zb[1] // 2, lh // 4, lw // 4,
                                     zb[1], lh // 2, lw // 2))
        angles.append(_bucket_angles(cfg.head_dim, -sum(zb), -sum(zb) + zb[2] // 4,
                                     lh // 8, lw // 8, zb[2], lh // 2, lw // 2))
    ang = np.concatenate(angles, axis=0)
    return (torch.from_numpy(np.cos(ang).astype(np.float32)).to(device),
            torch.from_numpy(np.sin(ang).astype(np.float32)).to(device))


# ---------------------------------------------------------------------------
# Modules (parameter holders under the reference names)
# ---------------------------------------------------------------------------

class CausalConv1d(nn.Module):
    def __init__(self, cin: int, cout: int, k: int = 3):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, k)


class MotionEncoder(nn.Module):
    """The reference's MotionEncoder_tc: per-head local path (+ a global path)."""

    def __init__(self, in_dim: int, hidden: int, num_heads: int, need_global: bool):
        super().__init__()
        self.conv1_local = CausalConv1d(in_dim, hidden // 4 * num_heads)
        if need_global:
            self.conv1_global = CausalConv1d(in_dim, hidden // 4)
            self.final_linear = nn.Linear(hidden, hidden)
        self.conv2 = CausalConv1d(hidden // 4, hidden // 2)
        self.conv3 = CausalConv1d(hidden // 2, hidden)
        self.padding_tokens = nn.Parameter(torch.zeros(1, 1, 1, hidden))


class CausalAudioEncoder(nn.Module):
    def __init__(self, cfg: S2VConfig):
        super().__init__()
        self.encoder = MotionEncoder(cfg.audio_dim, cfg.dim, cfg.num_audio_token,
                                     cfg.enable_adain)
        self.weights = nn.Parameter(torch.zeros(1, cfg.audio_encoder_layers, 1, 1))


class AdaIN(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.linear = nn.Linear(dim, 2 * dim)


class AudioInjector(nn.Module):
    def __init__(self, cfg: S2VConfig):
        super().__init__()
        n = len(cfg.audio_inject_layers)
        self.injector = nn.ModuleList(WanAttention(cfg.dim) for _ in range(n))
        self.injector_adain_layers = nn.ModuleList(AdaIN(cfg.dim) for _ in range(n))


class FramePacker(nn.Module):
    """Conv3d patch kernels of (1, 2, 2), (2, 4, 4) and (4, 8, 8) over motion latents."""

    def __init__(self, cfg: S2VConfig):
        super().__init__()
        c = cfg.in_dim
        self.proj = nn.Conv3d(c, cfg.dim, (1, 2, 2), (1, 2, 2))
        self.proj_2x = nn.Conv3d(c, cfg.dim, (2, 4, 4), (2, 4, 4))
        self.proj_4x = nn.Conv3d(c, cfg.dim, (4, 8, 8), (4, 8, 8))


class WanS2V(nn.Module):
    def __init__(self, cfg: S2VConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embedding = nn.Conv3d(cfg.in_dim, cfg.dim, cfg.patch_size, cfg.patch_size)
        self.cond_encoder = nn.Conv3d(cfg.cond_dim, cfg.dim, cfg.patch_size, cfg.patch_size)
        self.text_embedding = nn.Sequential(nn.Linear(cfg.text_dim, cfg.dim), Activation(),
                                            nn.Linear(cfg.dim, cfg.dim))
        self.time_embedding = nn.Sequential(nn.Linear(cfg.freq_dim, cfg.dim), Activation(),
                                            nn.Linear(cfg.dim, cfg.dim))
        self.time_projection = nn.Sequential(Activation(), nn.Linear(cfg.dim, cfg.dim * 6))
        self.blocks = nn.ModuleList(WanBlock(cfg) for _ in range(cfg.num_layers))
        self.head = WanHead(cfg)
        self.trainable_cond_mask = nn.Embedding(3, cfg.dim)
        self.casual_audio_encoder = CausalAudioEncoder(cfg)
        self.audio_injector = AudioInjector(cfg)
        self.frame_packer = FramePacker(cfg)


# ---------------------------------------------------------------------------
# Audio / motion encoders
# ---------------------------------------------------------------------------

def causal_conv1d(p: CausalConv1d, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x: (B, T, C) with its first frame repeated k - 1 times in front."""
    w = p.conv.weight
    k = w.shape[-1]
    x = torch.cat([x[:, :1].expand(-1, k - 1, -1), x], dim=1)
    out = F.conv1d(x.transpose(1, 2), w.to(x.dtype), stride=stride).transpose(1, 2)
    return out + p.conv.bias.to(x.dtype)


def _norm_silu(h: torch.Tensor, eps: float) -> torch.Tensor:
    return silu_f32(layer_norm(h, eps))


def motion_encoder_apply(p: MotionEncoder, x: torch.Tensor, num_heads: int,
                         need_global: bool, eps: float = 1e-6):
    """x: (B, T, C_in) -> local (B, T', num_heads + 1, H) [and global (B, T', 1, H)]."""
    b = x.shape[0]

    def stack(h):
        h = causal_conv1d(p.conv2, _norm_silu(h, eps), stride=2)
        h = causal_conv1d(p.conv3, _norm_silu(h, eps), stride=2)
        return _norm_silu(h, eps)

    loc = causal_conv1d(p.conv1_local, x)                  # (B, T, heads * H / 4)
    t = loc.shape[1]
    hq = loc.shape[-1] // num_heads
    loc = loc.reshape(b, t, num_heads, hq).permute(0, 2, 1, 3).reshape(b * num_heads, t, hq)
    loc = stack(loc)
    tp = loc.shape[1]
    loc = loc.reshape(b, num_heads, tp, -1).permute(0, 2, 1, 3)   # (B, T', n, H)
    pad = p.padding_tokens[0, 0].to(loc.dtype).expand(b, tp, 1, loc.shape[-1])
    x_local = torch.cat([loc, pad], dim=-2)
    if not need_global:
        return x_local
    g = linear(p.final_linear, stack(causal_conv1d(p.conv1_global, x)))
    return g.reshape(b, tp, 1, -1), x_local


def causal_audio_encoder_apply(p: CausalAudioEncoder, features: torch.Tensor,
                               num_token: int, need_global: bool):
    """features: (B, L, C, T) stacked wav2vec2 hidden states."""
    w = silu_f32(p.weights).to(features.dtype)             # (1, L, 1, 1)
    feat = (features * w / w.sum(dim=1, keepdim=True)).sum(dim=1)   # (B, C, T)
    return motion_encoder_apply(p.encoder, feat.transpose(1, 2), num_token, need_global)


def frame_pack_motion(p: FramePacker, cfg: S2VConfig, motion_latents: torch.Tensor):
    """motion_latents (B, T_m, H, W, C) -> packed tokens (B, S_m, dim): the last 19
    latent frames (zeros in front of fewer), split 16 | 2 | 1 and patched at 4x, 2x and
    1x. The JAX package reshapes into 8 x 8 patches for the 4x packer, which refuses a
    height or width that does not divide by 8 (a 480-pixel video's 60 latent rows);
    this raises there too."""
    b, tm, hh, ww, c = motion_latents.shape
    if hh % 8 or ww % 8:
        raise TypeError(f"frame_pack_motion: motion latents of height {hh} and width {ww}; "
                        "both must divide by 8 (the 4x packer's 8 x 8 patches, reshaped as "
                        "the JAX package does)")
    n1, n2, n4 = cfg.zip_frame_buckets
    total = n1 + n2 + n4
    overlap = min(total, tm)
    pad = motion_latents.new_zeros((b, total, hh, ww, c))
    pad[:, total - overlap:] = motion_latents[:, tm - overlap:]
    lat_4x, lat_2x, lat_post = pad[:, :n4], pad[:, n4:n4 + n2], pad[:, n4 + n2:]
    toks = [patchify(p.proj, lat_post, (1, 2, 2))[0],
            patchify(p.proj_2x, lat_2x, (2, 4, 4))[0],
            patchify(p.proj_4x, lat_4x, (4, 8, 8))[0]]
    return torch.cat(toks, dim=1)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _rows(h: torch.Tensor, n: int, fn) -> torch.Tensor:
    """fn(segment, row) on the first n tokens with row 0 and on the rest with row 1."""
    return torch.cat([fn(h[:, :n], 0), fn(h[:, n:], 1)], dim=1)


def s2v_block(p: WanBlock, x, context, t_mod2, seq_len_x: int, cos, sin, cfg: S2VConfig,
              attn_impl: str = "auto"):
    """t_mod2: (B, 6, 2, D); row 0 modulates the video tokens, row 1 the rest."""
    mod = p.modulation.to(t_mod2.dtype)[:, :, None, :] + t_mod2       # (B, 6, 2, D)
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = (
        mod[:, i] for i in range(6))                                    # each (B, 2, D)

    def affine(h, scale, shift):
        return _rows(h, seq_len_x, lambda s, r: s * (1 + scale[:, r:r + 1])
                     + shift[:, r:r + 1])

    def gated(y, gate):
        return _rows(y, seq_len_x, lambda s, r: gate[:, r:r + 1] * s)

    b, s, d = x.shape
    a = p.self_attn
    h = affine(layer_norm(x, cfg.eps), scale_msa, shift_msa)
    q = rms_norm(linear(a.q, h), a.norm_q.weight, cfg.eps).reshape(b, s, cfg.num_heads, -1)
    k = rms_norm(linear(a.k, h), a.norm_k.weight, cfg.eps).reshape(b, s, cfg.num_heads, -1)
    v = linear(a.v, h).reshape(b, s, cfg.num_heads, -1)
    del h
    out = attention(apply_rope(q, cos, sin), apply_rope(k, cos, sin), v, impl=attn_impl)
    x = x + gated(linear(a.o, out.reshape(b, s, d)), gate_msa)

    c = p.cross_attn
    hh = layer_norm(x, cfg.eps, p.norm3.weight, p.norm3.bias)
    t = context.shape[1]
    q = rms_norm(linear(c.q, hh), c.norm_q.weight, cfg.eps).reshape(b, s, cfg.num_heads, -1)
    k = rms_norm(linear(c.k, context), c.norm_k.weight, cfg.eps).reshape(
        b, t, cfg.num_heads, -1)
    v = linear(c.v, context).reshape(b, t, cfg.num_heads, -1)
    x = x + linear(c.o, attention(q, k, v, impl=attn_impl).reshape(b, s, d))

    h2 = affine(layer_norm(x, cfg.eps), scale_mlp, shift_mlp)
    return x + gated(feed_forward(p, h2), gate_mlp)


def audio_inject(inj: WanAttention, ada: AdaIN, x, audio_emb_global, audio_emb,
                 seq_len_x: int, cfg: S2VConfig, attn_impl: str = "auto"):
    """Audio cross-attention after an injection layer: each latent frame's video tokens
    (a batch of B * frames rows) attend to that frame's audio tokens."""
    b = x.shape[0]
    nf = audio_emb.shape[1]
    hidden = x[:, :seq_len_x].reshape(b * nf, seq_len_x // nf, cfg.dim)
    temb = audio_emb_global.reshape(b * nf, -1, cfg.dim)[:, 0]
    temb = linear(ada.linear, silu_f32(temb))
    shift, scale = temb.chunk(2, dim=1)
    hidden_n = layer_norm(hidden, 1e-5) * (1 + scale[:, None, :]) + shift[:, None, :]
    aud = audio_emb.reshape(b * nf, -1, cfg.dim)
    s, t = hidden_n.shape[1], aud.shape[1]
    q = rms_norm(linear(inj.q, hidden_n), inj.norm_q.weight, cfg.eps)
    k = rms_norm(linear(inj.k, aud), inj.norm_k.weight, cfg.eps)
    v = linear(inj.v, aud).reshape(b * nf, t, cfg.num_heads, -1)
    out = attention(q.reshape(b * nf, s, cfg.num_heads, -1),
                    k.reshape(b * nf, t, cfg.num_heads, -1), v,
                    impl=attn_impl).reshape(b * nf, s, cfg.dim)
    res = linear(inj.o, out).reshape(b, seq_len_x, cfg.dim)
    return torch.cat([x[:, :seq_len_x] + res, x[:, seq_len_x:]], dim=1)


# ---------------------------------------------------------------------------
# Full forward
# ---------------------------------------------------------------------------

def cal_audio_emb(model: WanS2V, cfg: S2VConfig, audio_input: torch.Tensor,
                  motion_frames=(73, 19)):
    """(B, L, C, T) -> global (B, T', 1, D), merged (B, T', n + 1, D): the first audio
    frame repeated 73 times in front, encoded, the first 19 outputs dropped."""
    first = audio_input[..., :1].expand(*audio_input.shape[:-1], motion_frames[0])
    audio_input = torch.cat([first, audio_input], dim=-1)
    g, loc = causal_audio_encoder_apply(model.casual_audio_encoder, audio_input,
                                        cfg.num_audio_token, True)
    return g[:, motion_frames[1]:], loc[:, motion_frames[1]:]


def wan_s2v_forward(model: WanS2V, cfg: S2VConfig, latents, timestep, context, audio_input,
                    motion_latents=None, pose_cond=None, attn_impl: str = "auto"):
    """Velocity (B, L, h, w, out_dim) with frame 0 passed through: latents (B, L, h, w, z)
    whose frame 0 is the reference latent, timestep (B,), context (B, L_txt, text_dim),
    audio_input (B, layers, audio_dim, T_audio), optional motion latents (B, T_m, h', w',
    z) and pose latents (B, L - 1, h, w, cond_dim)."""
    origin_ref = latents[:, :1]
    x_lat = latents[:, 1:]
    ctx = linear(model.text_embedding[2], gelu_tanh(linear(model.text_embedding[0], context)))
    audio_emb_global, merged_audio_emb = cal_audio_emb(model, cfg, audio_input)
    pose = torch.zeros_like(x_lat) if pose_cond is None else pose_cond

    x, (f, h, w) = patchify(model.patch_embedding, x_lat, cfg.patch_size)
    x = x + patchify(model.cond_encoder, pose, cfg.patch_size)[0]
    seq_len_x = x.shape[1]
    ref, grid_ref = patchify(model.patch_embedding, origin_ref, cfg.patch_size)
    parts, counts = [x, ref], [seq_len_x, ref.shape[1]]
    motion_grid = None
    if motion_latents is not None:
        mot = frame_pack_motion(model.frame_packer, cfg, motion_latents)
        parts.append(mot)
        counts.append(mot.shape[1])
        motion_grid = (motion_latents.shape[2], motion_latents.shape[3])
    x = torch.cat(parts, dim=1)
    cos, sin = s2v_rope_tables(cfg, (f, h, w), grid_ref, motion_grid, device=x.device)
    mask = torch.repeat_interleave(torch.arange(len(counts), device=x.device),
                                   torch.tensor(counts, device=x.device))
    x = x + model.trainable_cond_mask.weight[mask].to(x.dtype)

    # two-row timestep [t, 0]: the zero timestep modulates the reference/motion tokens
    t2 = torch.cat([timestep, timestep.new_zeros((1,))])
    emb = sinusoidal_embedding(cfg.freq_dim, t2).to(x.dtype)
    t_base = linear(model.time_embedding[0], emb)
    t_base = linear(model.time_embedding[2], silu_f32(t_base))
    t_mod = linear(model.time_projection[1], silu_f32(t_base))
    t_mod2 = t_mod.reshape(2, 6, cfg.dim).transpose(0, 1)[None]       # (1, 6, 2, D)

    inject = {layer: j for j, layer in enumerate(cfg.audio_inject_layers)}
    for i, blk in enumerate(model.blocks):
        x = s2v_block(blk, x, ctx, t_mod2, seq_len_x, cos, sin, cfg, attn_impl)
        if i in inject:
            j = inject[i]
            x = audio_inject(model.audio_injector.injector[j],
                             model.audio_injector.injector_adain_layers[j], x,
                             audio_emb_global, merged_audio_emb, seq_len_x, cfg, attn_impl)
    out = head(model.head, x[:, :seq_len_x], t_base[:1], cfg.eps)
    out = unpatchify(out, (f, h, w), cfg.patch_size, cfg.out_dim)
    return torch.cat([origin_ref, out], dim=1)


# ---------------------------------------------------------------------------
# Loading and random weights
# ---------------------------------------------------------------------------

def s2v_from_state_dict(sd: Dict[str, torch.Tensor], cfg: S2VConfig, dtype=torch.bfloat16,
                        *, device, what: str = "s2v") -> WanS2V:
    """WanS2V from a reference-format state dict, strictly: a missing or unexpected key,
    or a shape that does not fit, raises."""
    from goal_force_tpu_torch.pipelines.goal_force import load_state_dict_strict

    model = empty_module(WanS2V, cfg, dtype=dtype, device=device)
    load_state_dict_strict(model, sd, what)
    return model.eval().requires_grad_(False)


@torch.no_grad()
def init_s2v(cfg: S2VConfig, gen: torch.Generator, dtype=torch.bfloat16, *,
             device) -> WanS2V:
    """Random weights drawn from `gen` with the DiT's distributions (uniform
    +-1/sqrt(fan_in) linears and convs, zero biases, unit norms, N(0, 1/dim) modulations)
    for every module, N(0, 1/dim) padding tokens and condition-mask rows, and audio-layer
    weights of 0.01 as the reference initialises them. The JAX package has no S2V
    initialiser (its weights come from a file); this one feeds tests and the smoke."""
    model = empty_module(WanS2V, cfg, dtype=dtype, device=device)
    for name, mod in model.named_modules():
        if name.startswith("blocks."):
            continue
        if isinstance(mod, nn.Linear):
            init_linear_(mod, gen)
        elif isinstance(mod, (nn.Conv1d, nn.Conv3d)):
            init_patch_embedding_(mod, gen)
    for blk in model.blocks:
        init_block_(blk, gen)
    for attn_mod in model.audio_injector.injector:
        attn_mod.norm_q.weight.fill_(1.0)
        attn_mod.norm_k.weight.fill_(1.0)
    model.head.modulation.normal_(generator=gen).div_(cfg.dim**0.5)
    model.trainable_cond_mask.weight.normal_(generator=gen).div_(cfg.dim**0.5)
    model.casual_audio_encoder.encoder.padding_tokens.normal_(generator=gen).div_(
        cfg.dim**0.5)
    model.casual_audio_encoder.weights.fill_(0.01)
    return model.eval().requires_grad_(False)
