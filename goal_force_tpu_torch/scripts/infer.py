"""Goal-force inference CLI of the port.

    python -m goal_force_tpu_torch.scripts.infer \\
        --high_noise_model 'high/diffusion_pytorch_model-*.safetensors' \\
        --low_noise_model 'low/diffusion_pytorch_model-*.safetensors' \\
        --t5_path models_t5_umt5-xxl-enc-bf16.pth --vae_path Wan2.1_VAE.pth \\
        --tokenizer_path google/umt5-xxl --model_ckpt_path ckpt/step-3000.safetensors \\
        --example_paths examples/rows.csv

Port of ``scripts/infer.py`` with its flags and artifacts: each row of each CSV (first
frame under ``images/``, coordinates, forces, masses, caption) gives an 81-frame 832x480
video. Per row it writes ``<base>-control-signal.mp4``, ``<base>-image_condition.png``,
``<base>-text.json``, ``<base>.mp4`` and ``<base>-with-prompt.mp4`` (the force prompt
drawn on the output), with ``<base>`` named as the JAX CLI names it. CSVs are split
across processes by ``--world_size``/``--device_id``; ``--config_preset tiny`` loads
the tiny test geometry in float32.

The port adds ``--device`` (``cuda`` by default; a run without a card raises unless
``--device cpu`` is given) and ``--host_stage_experts`` (on by default for the a14b
preset in bf16 on CUDA: the low-noise expert and its ControlNet wait in pinned host
memory, so the bf16 A14B pair fits one 80 GB card).

``--control_signal_type canny_edge`` takes CSVs of (image, control_video, caption)
rows instead, with first frames under ``images/`` and precomputed Canny videos under
``canny-videos/``; per row it writes ``<root>-canny-control-signal.mp4``,
``<root>-image-condition.png`` and ``<root>-canny-output.mp4`` (``run_canny_edge``).

``main`` is three steps that other scripts can call in turn: ``load_pipeline``,
``answer_row`` (returns the frames) and ``write_row``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

ARTIFACTS = ("-control-signal.mp4", "-image_condition.png", "-text.json", ".mp4",
             "-with-prompt.mp4")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--control_signal_type", type=str, default="goal_force",
                   choices=["goal_force", "canny_edge"],
                   help="canny_edge: CSVs with (image, control_video, caption) rows and "
                        "precomputed canny videos")
    p.add_argument("--model_ckpt_path", type=str, default=None,
                   help="trained ControlNet step-K.safetensors (omit => base Wan2.2)")
    p.add_argument("--high_noise_model", type=str, required=True,
                   help="safetensors file or glob of shards")
    p.add_argument("--low_noise_model", type=str, default=None)
    p.add_argument("--t5_path", type=str, required=True)
    p.add_argument("--vae_path", type=str, required=True)
    p.add_argument("--tokenizer_path", type=str, default=None)
    p.add_argument("--example_paths", type=str, nargs="+", required=True, help="CSV files")
    p.add_argument("--output_dir", type=str, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_frames", type=int, default=81)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=832)
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--cfg_scale", type=float, default=5.0)
    p.add_argument("--controlnet_num_layers", type=int, default=10)
    p.add_argument("--device_id", type=int, default=0)
    p.add_argument("--world_size", type=int, default=1)
    p.add_argument("--config_preset", type=str, default="a14b", choices=["a14b", "tiny"],
                   help="'tiny' = test geometry for smoke runs on small weight fixtures")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cuda (the default) must be present")
    p.add_argument("--host_stage_experts", action=argparse.BooleanOptionalAction,
                   default=None, help="keep the standby expert pair in host memory "
                   "(default: on for the a14b preset in bf16 on CUDA)")
    return p.parse_args(argv)


def split_contiguous(items, world_size, rank):
    """Contiguous CSV sharding: rank r of world_size takes the r-th run of items."""
    n = len(items)
    per = (n + world_size - 1) // world_size
    return items[rank * per:(rank + 1) * per]


def load_pipeline(args, **configs_):
    """``GoalForcePipeline.from_pretrained`` on the files and settings of `args`;
    `configs_` (dit_cfg, t5_cfg, vae_cfg) replace the preset's, as for a checkpoint
    of cut depth."""
    from goal_force_tpu_torch import configs
    from goal_force_tpu_torch.pipelines.goal_force import GoalForcePipeline

    pipe_cfg = configs.PipelineConfig(height=args.height, width=args.width,
                                      num_frames=args.num_frames,
                                      num_inference_steps=args.num_inference_steps,
                                      cfg_scale=args.cfg_scale)
    preset = {"dtype": torch.bfloat16}
    if args.config_preset == "tiny":
        dit_cfg, t5_cfg, vae_cfg, _ = configs.tiny_pipeline_configs()
        preset = dict(dit_cfg=dit_cfg, t5_cfg=t5_cfg, vae_cfg=vae_cfg, dtype=torch.float32)
    preset.update(configs_)
    stage = args.host_stage_experts
    if stage is None:
        stage = (args.config_preset == "a14b" and preset["dtype"] == torch.bfloat16
                 and torch.device(args.device).type == "cuda")
    return GoalForcePipeline.from_pretrained(
        args.high_noise_model, low_noise_model=args.low_noise_model,
        t5_path=args.t5_path, vae_path=args.vae_path,
        controlnet_checkpoint=args.model_ckpt_path,
        controlnet_num_layers=args.controlnet_num_layers,
        tokenizer_path=args.tokenizer_path, pipe_cfg=pipe_cfg,
        device=args.device, host_stage_experts=stage, **preset)


def output_dir(args) -> Tuple[str, str]:
    """(the output directory, the checkpoint's step name), as the JAX CLI names them."""
    step = "base"
    if args.model_ckpt_path:
        step = os.path.basename(args.model_ckpt_path).split(".safetensors")[0].split("-")[-1]
    out_dir = args.output_dir or os.path.join(
        os.path.dirname(args.model_ckpt_path or "."), f"step-{step}-videos")
    return out_dir, step


def row_samples(csv_path: str, args, pipe_cfg) -> Iterator[Dict]:
    """The samples of one CSV's rows, calibrated as the training set was."""
    from goal_force_tpu_torch.data.datasets import BallsDataset

    ds = BallsDataset(os.path.dirname(csv_path), csv_path, is_validation_dataset=True,
                      num_frames=args.num_frames, height=args.height, width=args.width)
    ds.set_calibration(pipe_cfg.min_force, pipe_cfg.max_force, pipe_cfg.min_mass,
                       pipe_cfg.max_mass)
    for i in range(len(ds)):
        sample = ds[i]
        if sample is not None:
            yield sample


def answer_row(pipe, sample: Dict, args, progress: bool = True) -> np.ndarray:
    """The pipeline's (F, H, W, 3) frames for one sample."""
    return pipe(sample["prompt"], sample["video"][0],
                control_signal_video=sample["control_video"], seed=args.seed,
                controlnet=True, progress=progress)


def row_base(sample: Dict, args, out_dir: str, step: str) -> str:
    spec = sample["spec"]
    return os.path.join(out_dir, f"step-{step}_{sample['file_id']}"
                        f"__prj_force_{spec.force:.1f}__prj_angle_{spec.angle_deg:.1f}"
                        f"__tgt_force_{spec.target_force:.1f}__seed_{args.seed}")


def _annotate(video: np.ndarray, spec, pipe_cfg) -> np.ndarray:
    from goal_force_tpu_torch.data.viz import add_force_prompt_to_video

    span = pipe_cfg.max_force - pipe_cfg.min_force
    annotated = video
    if spec.force > -1:
        annotated = add_force_prompt_to_video(
            annotated, (spec.force - pipe_cfg.min_force) / span, spec.angle_deg,
            spec.x_pos, 1 - spec.y_pos, num_frames_with_signal=16, color=(255, 0, 0))
    if spec.target_force > -1:
        annotated = add_force_prompt_to_video(
            annotated, (spec.target_force - pipe_cfg.min_force) / span,
            spec.target_angle_deg, spec.target_x_pos, 1 - spec.target_y_pos,
            num_frames_with_signal=16, color=(0, 255, 0))
    return annotated


def write_row(sample: Dict, video: np.ndarray, base: str, pipe_cfg) -> None:
    """Write the row's five artifacts, ``base`` + each of ``ARTIFACTS``. The mp4s need
    imageio-ffmpeg or cv2, the overlay cv2 and the PNG PIL."""
    from goal_force_tpu_torch.data.video_io import save_image, save_video

    os.makedirs(os.path.dirname(os.path.abspath(base)), exist_ok=True)
    save_video(sample["control_video"], base + "-control-signal.mp4", fps=15, quality=5)
    save_image(sample["video"][0], base + "-image_condition.png")
    with open(base + "-text.json", "w") as f:
        json.dump({"text_prompt": sample["prompt"]}, f, indent=4)
    save_video(video, base + ".mp4", fps=15, quality=5)
    save_video(_annotate(video, sample["spec"], pipe_cfg), base + "-with-prompt.mp4",
               fps=15, quality=5)


def run_canny_edge(pipe, args, out_dir: str) -> List[str]:
    """Canny-edge control: each row of each CSV this process takes names a first frame
    under ``images/`` (resized by PIL to the run's size) and a Canny video under
    ``canny-videos/`` (its first ``num_frames`` frames, resized with cv2's INTER_AREA).
    Writes the control video, the first frame and the answer per row; returns the
    answers' paths."""
    import pandas as pd
    from PIL import Image

    from goal_force_tpu_torch.data.datasets import resize_area
    from goal_force_tpu_torch.data.video_io import load_video, save_image, save_video

    outs = []
    for csv in split_contiguous(args.example_paths, args.world_size, args.device_id):
        df = pd.read_csv(csv)
        base_path = os.path.dirname(csv)
        for _, row in df.iterrows():
            image = np.asarray(
                Image.open(os.path.join(base_path, "images", row["image"]))
                .convert("RGB").resize((args.width, args.height)), np.float32) / 255.0
            cv_name = row["control_video"]
            frames = load_video(os.path.join(base_path, "canny-videos", cv_name),
                                args.num_frames)
            cv = resize_area(frames, args.width, args.height)
            root = cv_name.split("_canny.mp4")[0].split(".mp4")[0]
            out = os.path.join(out_dir, f"{root}-canny-output.mp4")
            save_video(cv, os.path.join(out_dir, f"{root}-canny-control-signal.mp4"),
                       fps=15, quality=5)
            save_image(image, os.path.join(out_dir, f"{root}-image-condition.png"))
            video = pipe(row["caption"], image, control_signal_video=cv, seed=args.seed,
                         num_frames=args.num_frames, progress=True)
            save_video(video, out, fps=15, quality=5)
            print("wrote", out)
            outs.append(out)
    return outs


def main(argv: Optional[List[str]] = None) -> List[str]:
    """Answer every row of the CSVs this process takes; returns each row's ``base``
    (with ``canny_edge``, each answer's path)."""
    args = parse_args(argv)
    pipe = load_pipeline(args)
    out_dir, step = output_dir(args)
    os.makedirs(out_dir, exist_ok=True)
    if args.control_signal_type == "canny_edge":
        return run_canny_edge(pipe, args, out_dir)
    bases = []
    for csv_path in split_contiguous(args.example_paths, args.world_size, args.device_id):
        print("processing", csv_path)
        for sample in row_samples(csv_path, args, pipe.pipe_cfg):
            video = answer_row(pipe, sample, args)
            base = row_base(sample, args, out_dir, step)
            write_row(sample, video, base, pipe.pipe_cfg)
            print("wrote", base + ".mp4")
            bases.append(base)
    return bases


if __name__ == "__main__":
    main()
