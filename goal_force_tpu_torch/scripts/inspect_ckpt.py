"""Identify loose weight files: the family, the inferred config, the size.

    python -m goal_force_tpu_torch.scripts.inspect_ckpt model.safetensors [more.pth ...]
        [--head_dim 128]

Port of the root ``scripts/inspect_ckpt.py`` over the port's ``io/detect.py`` and
``io/safetensors_io.py``: one line per file (its kind, its size on disk, its parameter
count and its number of keys; a Wan DiT's config below it), the same text for the same
file.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("paths", nargs="+")
    p.add_argument("--head_dim", type=int, default=128,
                   help="head_dim for DiT config inference (128 for all real Wan ckpts)")
    args = p.parse_args(argv)

    from goal_force_tpu_torch.io.detect import detect_model_kind, infer_dit_config
    from goal_force_tpu_torch.io.safetensors_io import load_safetensors, load_torch_pth

    for path in args.paths:
        if not os.path.exists(path):
            print(f"{path}: NOT FOUND")
            continue
        size_gb = os.path.getsize(path) / 1e9
        sd = (load_safetensors(path) if path.endswith(".safetensors")
              else load_torch_pth(path))
        n_params = sum(int(v.numel()) for v in sd.values())
        try:
            kind = detect_model_kind(sd)
        except ValueError as e:
            print(f"{path}: UNRECOGNIZED ({size_gb:.2f} GB, {len(sd)} keys) — {e}")
            continue
        line = (f"{path}: {kind}  ({size_gb:.2f} GB on disk, "
                f"{n_params/1e9:.2f}B params, {len(sd)} keys)")
        if kind == "wan_dit":
            c = infer_dit_config(sd, head_dim=args.head_dim)
            line += (f"\n  dim {c.dim}, layers {c.num_layers}, heads {c.num_heads}, "
                     f"ffn {c.ffn_dim}, in_dim {c.in_dim}, out_dim {c.out_dim}, "
                     f"image_input={c.has_image_input}")
        print(line)


if __name__ == "__main__":
    main()
