"""Extract a Canny-edge control video from a video:

    python -m goal_force_tpu_torch.scripts.extract_canny_edges -i clip.mp4 -o canny.mp4

Port of ``scripts/extract_canny_edges.py``: the first --num_frames frames (rounded
down to 4k + 1, the dataset's time division), each resized to --height x --width with
area interpolation, their Canny edge maps (``data/datasets.py::canny_maps``, the same
``cv2.Canny`` call as JAX's canny annotator) written as an mp4 at 15 fps.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np


def extract_canny_edges(input_video_path: str, output_video_path: str,
                        num_frames: int, height: int = 480, width: int = 832,
                        low: int = 100, high: int = 200) -> np.ndarray:
    """Write the edge video; returns the maps, (T, height, width, 3) in {0, 1}."""
    from goal_force_tpu_torch.data.datasets import canny_maps, resize_area
    from goal_force_tpu_torch.data.video_io import load_video, save_video

    if not os.path.exists(input_video_path):
        raise FileNotFoundError(f"Input video file not found: {input_video_path}")
    out_dir = os.path.dirname(output_video_path)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    if num_frames % 4 != 1:
        num_frames = max(1, (num_frames // 4) * 4 + 1)
    frames = resize_area(load_video(input_video_path, num_frames), width, height)
    canny = canny_maps(frames, low, high)
    save_video((canny * 255).astype(np.uint8), output_video_path, fps=15, quality=5)
    print(f"Canny edge video shape: {canny.shape}")
    print(f"Successfully saved Canny edge video to: {output_video_path}")
    return canny


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--input", "-i", type=str, required=True)
    parser.add_argument("--output", "-o", type=str, required=True)
    parser.add_argument("--num_frames", "-n", type=int, default=81)
    parser.add_argument("--height", type=int, default=480)
    parser.add_argument("--width", type=int, default=832)
    parser.add_argument("--low", type=int, default=100)
    parser.add_argument("--high", type=int, default=200)
    args = parser.parse_args(argv)
    try:
        extract_canny_edges(args.input, args.output, args.num_frames,
                            args.height, args.width, args.low, args.high)
    except Exception as e:
        print(f"Error: {e}")
        sys.exit(1)


if __name__ == "__main__":
    main()
