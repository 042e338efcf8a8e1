"""The goal-force CSV dataset and the training-sample checks.

Port of ``goal_force_tpu/data/datasets.py``: ``should_skip``, ``_CSVDataset`` and
``BallsDataset`` (force, goal force and masses, distractors in training rows). A row of
a validation CSV names a first-frame image under ``images/``; its sample is that image
(resized to the dataset's size), the caption, the rendered control video, the row's
``ControlSpec`` and its ``file_id``. Training rows name mp4 clips, whose reading is not
ported yet: loading one raises ``NotImplementedError``. The CSV is read with pandas,
imported when a dataset is built.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from goal_force_tpu_torch.data.control_signal import ControlSpec, render_control_video
from goal_force_tpu_torch.data.video_io import load_image

MAX_NUM_DISTRACTORS = 8


def should_skip(sample: Optional[Dict], num_frames: int, height: int, width: int) -> bool:
    """True for a missing sample or one whose control video is absent or mis-shaped."""
    if sample is None:
        return True
    cv = sample.get("control_video")
    return cv is None or tuple(cv.shape) != (num_frames, height, width, 3)


def _read_csv(path: str):
    import pandas

    return pandas.read_csv(path)


class _CSVDataset:
    """Shared CSV plumbing: row filtering by existing media + calibration stats."""

    media_type: str

    def __init__(self, base_path, metadata_path, *, is_validation_dataset=False,
                 num_frames=81, height=480, width=832, repeat=1):
        self.base_path = base_path
        self.metadata_path = metadata_path
        self.is_validation_dataset = is_validation_dataset
        self.num_frames = num_frames
        self.height = height
        self.width = width
        self.repeat = repeat
        self.media_type = "image" if is_validation_dataset else "video"
        self.df = _read_csv(metadata_path)
        media_dir = os.path.join(base_path, "images") if is_validation_dataset else base_path
        if os.path.isdir(media_dir):
            names = set(os.listdir(media_dir))
            self.df = self.df[self.df[self.media_type].map(lambda x: x in names)]
        self._calibrate()

    def _calibrate(self):
        pass

    def __len__(self):
        return len(self.df) * self.repeat

    def _media_path(self, file_name: str) -> str:
        sub = "images" if self.is_validation_dataset else ""
        return os.path.join(self.base_path, sub, file_name)

    def _load_media(self, file_name: str):
        """-> frames (T, H, W, 3) float32 [0,1]; validation: single image frame."""
        path = self._media_path(file_name)
        if self.is_validation_dataset:
            return load_image(path, size=(self.width, self.height))[None]
        raise NotImplementedError(f"{path}: reading training clips (mp4 frames) is not "
                                  "ported yet")


class BallsDataset(_CSVDataset):
    """Force/goal/mass control signals (the goal-force flagship dataset)."""

    def __init__(self, *args, p_mask_out_direct_force=0.0, p_mask_out_indirect_force=0.0,
                 p_mask_out_masses=0.0, rng: Optional[np.random.Generator] = None, **kwargs):
        if p_mask_out_direct_force + p_mask_out_indirect_force > 1:
            raise ValueError("p_mask_out_direct_force + p_mask_out_indirect_force > 1")
        if not 0.0 <= p_mask_out_masses <= 1.0:
            raise ValueError(f"p_mask_out_masses={p_mask_out_masses} is not in [0, 1]")
        self.p_direct = p_mask_out_direct_force
        self.p_indirect = p_mask_out_indirect_force
        self.p_masses = p_mask_out_masses
        self.rng = rng or np.random.default_rng()
        super().__init__(*args, **kwargs)

    def _calibrate(self):
        """min/max force and mass from the data in training; validation pins them later
        (``set_calibration``)."""
        if self.is_validation_dataset:
            self.min_force, self.max_force = 0.0, 1.0
            self.min_mass, self.max_mass = 0.0, 1.0
            self.min_indirect_force, self.max_indirect_force = 0.0, 1.0
            return
        df = self.df
        self.min_force = float(df["projectile_force_magnitude"].min())
        self.max_force = float(df["projectile_force_magnitude"].max())
        ind = df[df["target_indirect_force_magnitude"] > -1]
        self.min_indirect_force = float(ind["target_indirect_force_magnitude"].min())
        self.max_indirect_force = float(ind["target_indirect_force_magnitude"].max())
        self.min_mass = float(df["projectile_mass"].min())
        self.max_mass = float(df["projectile_mass"].max())

    def set_calibration(self, min_force, max_force, min_mass, max_mass):
        """Pin the inference calibration (the training set's ranges)."""
        self.min_force, self.max_force = min_force, max_force
        self.min_mass, self.max_mass = min_mass, max_mass
        self.min_indirect_force, self.max_indirect_force = min_force, max_force

    def _spec_from_row(self, item) -> ControlSpec:
        distract_m, distract_xy = [], []
        if not self.is_validation_dataset and "distractor_0_mass" in item:
            if f"distractor_{MAX_NUM_DISTRACTORS - 1}_mass" not in item:
                raise KeyError(f"distractor_{MAX_NUM_DISTRACTORS - 1}_mass")
            for i in range(MAX_NUM_DISTRACTORS):
                m = float(item[f"distractor_{i}_mass"])
                if m == -1:
                    continue
                distract_m.append(m)
                distract_xy.append((int(item[f"distractor_{i}_coordx"]),
                                    int(item[f"distractor_{i}_coordy"])))
        return ControlSpec(
            force=float(item["projectile_force_magnitude"]),
            angle_deg=float(item["projectile_force_angle"]),
            x_pos=float(item["projectile_coordx"]) / float(item["width"]),
            y_pos=float(item["projectile_coordy"]) / float(item["height"]),
            target_force=float(item["target_indirect_force_magnitude"]),
            target_angle_deg=float(item["target_indirect_force_angle"]),
            target_x_pos=float(item["target_coordx"]) / float(item["width"]),
            target_y_pos=float(item["target_coordy"]) / float(item["height"]),
            projectile_mass=float(item["projectile_mass"]),
            projectile_xy_px=(int(item["projectile_coordx"]), int(item["projectile_coordy"])),
            target_mass=float(item["target_mass"]),
            target_xy_px=(int(item["target_coordx"]), int(item["target_coordy"])),
            distractor_masses=distract_m,
            distractor_xy_px=distract_xy,
        )

    def __getitem__(self, idx) -> Optional[Dict]:
        item = self.df.iloc[idx % len(self.df)]
        try:
            frames = self._load_media(item[self.media_type])
        except (OSError, ValueError):
            return None      # a missing or corrupt file: the sample is skipped
        spec = self._spec_from_row(item)
        control = render_control_video(
            spec, self.num_frames, self.height, self.width,
            min_force=self.min_force, max_force=self.max_force,
            min_mass=self.min_mass, max_mass=self.max_mass,
            min_indirect_force=self.min_indirect_force,
            max_indirect_force=self.max_indirect_force,
            p_mask_out_direct=self.p_direct, p_mask_out_indirect=self.p_indirect,
            p_mask_out_masses=self.p_masses, rng=self.rng,
        )
        name = item[self.media_type]
        return {
            "video": frames,
            "prompt": item["caption"],
            "control_video": control,
            "file_id": os.path.splitext(name)[0],
            "spec": spec,
        }
