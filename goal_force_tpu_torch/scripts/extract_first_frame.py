"""Extract the first frame of a video as the conditioning image:

    python -m goal_force_tpu_torch.scripts.extract_first_frame -i clip.mp4 -o first.png

Port of ``scripts/extract_first_frame.py``: frame 0, resized to --height x --width
(480 x 832 by default) with OpenCV's area interpolation, truncated to uint8 and
written with ``cv2.imwrite``.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np


def extract_first_frame(input_video_path: str, output_image_path: str,
                        height: int = 480, width: int = 832) -> np.ndarray:
    """Write the resized first frame; returns it as (height, width, 3) uint8 RGB."""
    from goal_force_tpu_torch.data.video_io import load_video

    if not os.path.exists(input_video_path):
        raise FileNotFoundError(f"Input video file not found: {input_video_path}")
    out_dir = os.path.dirname(output_image_path)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)

    import cv2

    frame = load_video(input_video_path, 1)[0]
    frame = cv2.resize(frame, (width, height), interpolation=cv2.INTER_AREA)
    rgb = (frame * 255).astype(np.uint8)
    cv2.imwrite(output_image_path, cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
    print(f"Successfully saved first frame to: {output_image_path}")
    return rgb


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--input", "-i", type=str, required=True)
    parser.add_argument("--output", "-o", type=str, required=True)
    parser.add_argument("--height", type=int, default=480)
    parser.add_argument("--width", type=int, default=832)
    args = parser.parse_args(argv)
    try:
        extract_first_frame(args.input, args.output, args.height, args.width)
    except Exception as e:
        print(f"Error: {e}")
        sys.exit(1)


if __name__ == "__main__":
    main()
