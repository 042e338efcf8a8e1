"""Base-model demo: a short clip from a prompt and a first frame, with no ControlNet.

    python -m goal_force_tpu_torch.scripts.demo --high_noise_model high.safetensors \\
        --low_noise_model low.safetensors --t5_path umt5.pth --vae_path vae.pth \\
        --tokenizer_path google/umt5-xxl --image first.png --output demo.mp4
    python -m goal_force_tpu_torch.scripts.demo --tiny_random --device cuda

Port of ``scripts/demo.py`` (the reference's base-model demo): if it writes a video
that plays, the setup works. ``--tiny_random`` draws the tiny test configs' random
weights (``GoalForcePipeline.init_random``); otherwise the experts, umt5 and the VAE are
read by ``from_pretrained(..., controlnet_num_layers=0)``. Without ``--image`` the first
frame is uniform noise from ``--seed``. The port adds ``--device`` (``cuda`` by
default; a run without a card raises unless ``--device cpu`` is given).

``main`` is three steps that other scripts can call in turn: ``load_pipeline``,
``first_frame`` and ``generate`` (which takes ``noise=``, the initial latents).
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--prompt", default="a cat walks on the grass, realistic")
    p.add_argument("--image", default=None, help="first-frame image (random if omitted)")
    p.add_argument("--output", default="demo.mp4")
    p.add_argument("--num_frames", type=int, default=81)
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=832)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--high_noise_model", default=None)
    p.add_argument("--low_noise_model", default=None)
    p.add_argument("--t5_path", default=None)
    p.add_argument("--vae_path", default=None)
    p.add_argument("--tokenizer_path", default=None)
    p.add_argument("--tiny_random", action="store_true",
                   help="random tiny weights: environment smoke test only")
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda (the default) must be present")
    return p.parse_args(argv)


def load_pipeline(args):
    """The base pipeline of `args` (no ControlNet)."""
    from goal_force_tpu_torch import configs
    from goal_force_tpu_torch.configs import PipelineConfig
    from goal_force_tpu_torch.pipelines.goal_force import GoalForcePipeline

    pc = PipelineConfig(height=args.height, width=args.width, num_frames=args.num_frames,
                        num_inference_steps=args.num_inference_steps)
    if args.tiny_random:
        dit_cfg, t5_cfg, vae_cfg, _ = configs.tiny_pipeline_configs()
        return GoalForcePipeline.init_random(seed=0, dit_cfg=dit_cfg, t5_cfg=t5_cfg,
                                             vae_cfg=vae_cfg, cn_cfg=None, pipe_cfg=pc,
                                             device=args.device)
    if not args.high_noise_model:
        raise ValueError("--high_noise_model is required (or --tiny_random)")
    return GoalForcePipeline.from_pretrained(
        args.high_noise_model, low_noise_model=args.low_noise_model, t5_path=args.t5_path,
        vae_path=args.vae_path, controlnet_num_layers=0, tokenizer_path=args.tokenizer_path,
        pipe_cfg=pc, device=args.device)


def first_frame(args) -> np.ndarray:
    """(height, width, 3) float32 in [0, 1]: --image resized, or uniform noise."""
    if args.image:
        from goal_force_tpu_torch.data.video_io import load_image

        return load_image(args.image, size=(args.width, args.height))
    return np.random.default_rng(args.seed).uniform(
        size=(args.height, args.width, 3)).astype(np.float32)


def generate(pipe, args, image: np.ndarray, noise=None) -> np.ndarray:
    """The clip (F, H, W, 3) in [0, 1], without the ControlNet, written to --output."""
    from goal_force_tpu_torch.data.video_io import save_video

    video = pipe(args.prompt, image, controlnet=False, seed=args.seed, progress=True,
                 noise=noise)
    save_video(video, args.output, fps=pipe.pipe_cfg.fps, quality=5)
    print(f"wrote {args.output} - if this plays, your setup works")
    return video


def main(argv: Optional[List[str]] = None) -> np.ndarray:
    args = parse_args(argv)
    return generate(load_pipeline(args), args, first_frame(args))


if __name__ == "__main__":
    main()
