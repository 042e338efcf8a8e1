"""Typed model/pipeline configs for the PyTorch port.

A copy of the goal-force subset of ``goal_force_tpu/configs.py`` (the port never
imports the JAX package): the Wan DiT, umt5 encoder, Wan2.1 VAE, ControlNet and
pipeline dataclasses, the Flux.1 MMDiT's config, their presets and the tiny test
configs. The values must stay
equal to the JAX copy; ``tests/test_torch_import.py`` checks that they do.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class WanDiTConfig:
    """Wan video DiT (flow-matching transformer); defaults are the A14B expert."""

    dim: int = 5120
    in_dim: int = 36            # 16 latent + 20 y (4 mask + 16 first-frame latents)
    ffn_dim: int = 13824
    out_dim: int = 16
    text_dim: int = 4096
    freq_dim: int = 256
    eps: float = 1e-6
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    num_heads: int = 40
    num_layers: int = 40
    has_image_input: bool = False      # A14B: no CLIP branch
    rope_max_len: int = 1024
    # qk-RMS-norm keeps every softmax logit small, so attention statically takes
    # the max-free kernel (K1) with a saturating clamp. False selects the runtime
    # Cauchy-Schwarz dispatch between K1 (no clamp) and the online-max kernel (K2).
    qk_bounded: bool = True

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads


@dataclasses.dataclass(frozen=True)
class ControlNetConfig:
    """Force/mass ControlNet: patch-embed + N DiT-block copies + zero convs."""

    num_layers: int = 10
    stride: Optional[int] = None       # strided injection (block_id % stride)
    in_channels: int = 16              # VAE latent channels of the control video


@dataclasses.dataclass(frozen=True)
class T5Config:
    """umt5-xxl encoder-only."""

    vocab: int = 256384
    dim: int = 4096
    dim_attn: int = 4096
    dim_ffn: int = 10240
    num_heads: int = 64
    num_layers: int = 24
    num_buckets: int = 32
    rel_max_dist: int = 128
    shared_pos: bool = False           # umt5: per-layer relative position embeddings
    text_len: int = 512


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """Wan2.1 3D causal video VAE (spatial 8x, temporal 4x)."""

    dim: int = 96
    z_dim: int = 16
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    temporal_downsample: Tuple[bool, ...] = (False, True, True)
    upsampling_factor: int = 8

    @property
    def temporal_upsample(self) -> Tuple[bool, ...]:
        return tuple(reversed(self.temporal_downsample))


# Per-channel latent mean/std of the Wan2.1 VAE.
VAE_LATENT_MEAN = (
    -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921,
)
VAE_LATENT_STD = (
    2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
    3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160,
)


@dataclasses.dataclass(frozen=True)
class FluxDiTConfig:
    """Flux.1 MMDiT: double-stream (joint) blocks, then single-stream blocks. The
    defaults are FLUX.1-dev's (dim 3072, 24 heads, 19 joint + 38 single blocks, RoPE
    theta 10000 over axes (16, 56, 56), T5 context 4096, CLIP pooled 768, sinusoid 256,
    the guidance embedder present)."""

    dim: int = 3072
    num_heads: int = 24
    num_joint_blocks: int = 19
    num_single_blocks: int = 38
    in_dim: int = 64                  # 2x2-patchified 16-channel latents
    out_dim: int = 64
    text_dim: int = 4096              # T5-XXL hidden
    pooled_dim: int = 768             # CLIP-L pooled
    freq_dim: int = 256
    axes_dim: Tuple[int, ...] = (16, 56, 56)
    rope_theta: float = 10000.0
    guidance_embed: bool = True       # FLUX.1-dev; schnell has none
    eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Goal-force inference defaults."""

    height: int = 480
    width: int = 832
    num_frames: int = 81
    num_inference_steps: int = 50
    cfg_scale: float = 5.0
    sigma_shift: float = 5.0
    switch_dit_boundary: float = 0.875   # timestep < 0.875*1000 -> low-noise expert
    fps: int = 15
    # Spatial VAE tiling in latent units; inputs that fit one tile run untiled.
    tiled: bool = True
    tile_size: tuple = (30, 52)
    tile_stride: tuple = (15, 26)
    # Force/mass calibration pinned at inference.
    min_force: float = 30.0
    max_force: float = 400.0
    min_mass: float = 1.0
    max_mass: float = 4.0
    negative_prompt: str = (
        "色调艳丽，过曝，静态，细节模糊不清，字幕，风格，作品，画作，画面，静止，整体发灰，最差质量，"
        "低质量，JPEG压缩残留，丑陋的，残缺的，多余的手指，画得不好的手部，画得不好的脸部，畸形的，"
        "毁容的，形态畸形的肢体，手指融合，静止不动的画面，杂乱的背景，三条腿，背景人很多，倒着走"
    )

    @property
    def latent_frames(self) -> int:
        return (self.num_frames - 1) // 4 + 1

    @property
    def latent_height(self) -> int:
        return self.height // 8

    @property
    def latent_width(self) -> int:
        return self.width // 8

    @property
    def tokens(self) -> int:
        return self.latent_frames * (self.latent_height // 2) * (self.latent_width // 2)


WAN22_A14B = WanDiTConfig()
WAN21_1_3B = WanDiTConfig(dim=1536, in_dim=16, ffn_dim=8960, num_heads=12, num_layers=30)
UMT5_XXL = T5Config()
# google/t5-v1_1-xxl (CogVideoX, Flux, SD3): umt5-xxl's geometry with a 32,128-piece
# vocabulary and one relative position bias shared by every layer
T5_V1_1_XXL = T5Config(vocab=32128, shared_pos=True)
WAN21_VAE = VAEConfig()

FLUX_DEV = FluxDiTConfig()
FLUX_SCHNELL = FluxDiTConfig(guidance_embed=False)


def tiny_dit(num_layers: int = 2) -> WanDiTConfig:
    """Small config for unit tests (structure identical to A14B)."""
    return WanDiTConfig(
        dim=96, in_dim=36, ffn_dim=128, out_dim=16, text_dim=32, freq_dim=32,
        num_heads=4, num_layers=num_layers, rope_max_len=64,
    )


def tiny_t5(num_layers: int = 2) -> T5Config:
    return T5Config(
        vocab=128, dim=32, dim_attn=32, dim_ffn=64, num_heads=4,
        num_layers=num_layers, text_len=16,
    )


def tiny_vae() -> VAEConfig:
    return VAEConfig(dim=8, z_dim=4, dim_mult=(1, 2, 4, 4), num_res_blocks=1)


def tiny_pipeline_configs(num_layers: int = 2, cn_layers: int = 1):
    """Mutually consistent tiny configs for end-to-end pipeline tests.

    VAE z=4 -> DiT in_dim = z + 4 (mask) + z = 12, out_dim = z.
    """
    vae_cfg = tiny_vae()
    z = vae_cfg.z_dim
    t5_cfg = tiny_t5()
    dit_cfg = WanDiTConfig(
        dim=96, in_dim=2 * z + 4, ffn_dim=128, out_dim=z, text_dim=t5_cfg.dim,
        freq_dim=32, num_heads=4, num_layers=num_layers, rope_max_len=64,
    )
    cn_cfg = ControlNetConfig(num_layers=cn_layers, in_channels=z)
    return dit_cfg, t5_cfg, vae_cfg, cn_cfg
