"""Per-frame fidelity of one video against another:

    python -m goal_force_tpu_torch.scripts.compare_videos ours.mp4 reference.mp4 \\
        [--json report.json]

Port of ``scripts/compare_videos.py``: both clips are read, cut to the shorter one's
frame count, and compared by ``utils/metrics.py::compare_videos`` (PSNR and SSIM per
frame); the means and the minimum PSNR are printed, and the whole report written as
JSON with ``--json``.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("ours")
    p.add_argument("reference")
    p.add_argument("--json", default=None)
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict:
    from goal_force_tpu_torch.data.video_io import load_video
    from goal_force_tpu_torch.utils.metrics import compare_videos

    args = parse_args(argv)
    a = load_video(args.ours)
    b = load_video(args.reference)
    n = min(a.shape[0], b.shape[0])
    report = compare_videos(a[:n], b[:n])
    print(f"frames compared: {n}")
    print(f"PSNR  mean {report['psnr_mean']:.2f} dB   min {report['psnr_min']:.2f} dB")
    print(f"SSIM  mean {report['ssim_mean']:.4f}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
        print("wrote", args.json)
    return report


if __name__ == "__main__":
    main()
