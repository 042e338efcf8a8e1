"""The goal-force training and validation datasets and the training-sample checks.

Port of ``goal_force_tpu/data/datasets.py``:

- ``BallsDataset`` (force, goal force and masses, distractors in training rows; clips
  at twice the frame rate, taken as frames[::2][-num_frames:]), ``DominosDataset``
  (the same channels, frames[:num_frames]) and ``PlantsDataset`` (direct force only,
  control channels 1-2 zeroed, a random crop-zoom of carnation clips drawn from the
  dataset's ``np.random.Generator`` as JAX draws it);
- ``CannyEdgeDataset`` (Canny edge maps of each frame as the control video),
  ``ConcatDataset``, ``should_skip``, ``safe_collate`` and ``batch_iterator``.

A row of a validation CSV names a first-frame image under ``images/``; its sample is
that image (resized to the dataset's size). A training row names an mp4 clip under the
base path, decoded by ``video_io`` (imageio-ffmpeg or cv2). A sample is a dict of the
frames ((T, H, W, 3) float32 in [0, 1]), the caption, the rendered control video, the
row's ``ControlSpec`` and its ``file_id``; a clip that cannot be read gives None. The
CSV is read with pandas and the crops are resized with cv2, each imported when used.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from goal_force_tpu_torch.data.control_signal import ControlSpec, render_control_video
from goal_force_tpu_torch.data.video_io import load_image, load_video, load_video_frames

MAX_NUM_DISTRACTORS = 8


# What a missing, empty or corrupt media file raises while it is read: its sample is
# None and the trainer skips it.
_UNREADABLE = (OSError, ValueError, RuntimeError)


def should_skip(sample: Optional[Dict], num_frames: int, height: int, width: int) -> bool:
    """True for a missing sample or one whose control video is absent or mis-shaped."""
    if sample is None:
        return True
    cv = sample.get("control_video")
    return cv is None or tuple(cv.shape) != (num_frames, height, width, 3)


def safe_collate(samples: List[Optional[Dict]]) -> Optional[Dict]:
    """The first valid sample (the loader's batch size is 1)."""
    for s in samples:
        if s is not None:
            return s
    return None


def batch_iterator(dataset, batch_size=1, shuffle=True, seed=0, drop_remainder=True):
    """Lists of `batch_size` valid samples, in an order shuffled by `seed`."""
    rng = np.random.default_rng(seed)
    order = np.arange(len(dataset))
    if shuffle:
        rng.shuffle(order)
    buf = []
    for i in order:
        s = dataset[int(i)]
        if s is None:
            continue
        buf.append(s)
        if len(buf) == batch_size:
            yield buf
            buf = []
    if buf and not drop_remainder:
        yield buf


def resize_area(frames: np.ndarray, width: int, height: int) -> np.ndarray:
    import cv2

    return np.stack([cv2.resize(f, (width, height), interpolation=cv2.INTER_AREA)
                     for f in frames])


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
        frames = self._subsample(load_video_frames(path))
        return np.stack([np.asarray(f, np.float32) / 255.0 for f in frames])

    def _subsample(self, frames: List):
        return frames[:self.num_frames]


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

    def _subsample(self, frames):
        return frames[::2][-self.num_frames:]

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
        except _UNREADABLE:
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


class DominosDataset(BallsDataset):
    """Balls' control channels; dominos clips are not frame-strided."""

    def _subsample(self, frames):
        return frames[:self.num_frames]


class PlantsDataset(_CSVDataset):
    """Direct force only, control channels 1-2 zeroed, and a random crop-zoom of the
    carnation clips in training."""

    def __init__(self, *args, rng: Optional[np.random.Generator] = None, **kwargs):
        self.rng = rng or np.random.default_rng()
        super().__init__(*args, **kwargs)

    def _calibrate(self):
        if self.is_validation_dataset:
            self.min_force, self.max_force = 0.0, 1.0
        else:
            self.min_force = float(self.df["force"].min())
            self.max_force = float(self.df["force"].max())

    def __getitem__(self, idx) -> Optional[Dict]:
        item = self.df.iloc[idx % len(self.df)]
        try:
            frames = self._load_media(item[self.media_type])
        except _UNREADABLE:
            return None
        file_id = os.path.splitext(item[self.media_type])[0]
        x_pos = float(item["coordx"]) / float(item["width"])
        y_pos = float(item["coordy"]) / float(item["height"])
        if not self.is_validation_dataset and file_id.startswith("carnation"):
            frames, x_pos, y_pos = self._carnation_crop(frames, float(item["coordx"]),
                                                        float(item["coordy"]))
        spec = ControlSpec(
            force=float(item["force"]), angle_deg=float(item["angle"]),
            x_pos=x_pos, y_pos=y_pos,
            target_force=-1.0, target_angle_deg=0.0, target_x_pos=0.0, target_y_pos=0.0,
        )
        control = render_control_video(
            spec, self.num_frames, self.height, self.width,
            min_force=self.min_force, max_force=self.max_force,
            p_mask_out_masses=1.0, rng=self.rng,  # the mass channel is always zero
        )
        control[..., 1:3] = 0.0
        return {"video": frames, "prompt": item["caption"], "control_video": control,
                "file_id": file_id, "spec": spec}

    def _carnation_crop(self, frames, coordx, coordy):
        """A random zoom in [1, 1.3) that keeps the force point ~50 px inside the crop,
        resized back to the dataset's size; returns the frames and the point's new
        relative (x, y), y measured from the bottom."""
        t, oh, ow, _ = frames.shape
        coordy_tl = oh - coordy
        zoom = self.rng.uniform(1.0, 1.3)
        nw, nh = int(ow / zoom), int(oh / zoom)
        min_x = max(0, int(coordx - nw + 50))
        max_x = min(ow - nw, int(coordx - 50))
        min_y = max(0, int(coordy_tl - nh + 50))
        max_y = min(oh - nh, int(coordy_tl - 50))
        if min_x >= max_x or min_y >= max_y:
            ox = self.rng.integers(0, ow - nw + 1)
            oy = self.rng.integers(0, oh - nh + 1)
        else:
            ox = self.rng.integers(min_x, max_x + 1)
            oy = self.rng.integers(min_y, max_y + 1)
        out = resize_area(frames[:, oy:oy + nh, ox:ox + nw], self.width, self.height)
        fx = ((coordx - ox) / nw) * self.width
        fy = ((coordy_tl - oy) / nh) * self.height
        return out, fx / self.width, 1.0 - fy / self.height


class CannyEdgeDataset:
    """Clips whose control video is the Canny edge map of each of their frames."""

    def __init__(self, video_paths: List[str], prompts: List[str],
                 num_frames=81, height=480, width=832,
                 low_threshold=100, high_threshold=200):
        if len(video_paths) != len(prompts):
            raise ValueError(f"{len(video_paths)} videos but {len(prompts)} prompts")
        self.video_paths = video_paths
        self.prompts = prompts
        self.num_frames = num_frames
        self.height = height
        self.width = width
        self.low = low_threshold
        self.high = high_threshold

    def __len__(self):
        return len(self.video_paths)

    def canny_control(self, frames: np.ndarray) -> np.ndarray:
        """(T, H, W, 3) in [0, 1] -> Canny maps (T, H, W, 3) in {0, 1}."""
        import cv2

        out = []
        for f in (frames * 255).astype(np.uint8):
            edges = cv2.Canny(f, self.low, self.high)
            out.append(np.repeat(edges[..., None], 3, axis=-1).astype(np.float32) / 255.0)
        return np.stack(out)

    def __getitem__(self, idx) -> Optional[Dict]:
        try:
            frames = load_video(self.video_paths[idx], self.num_frames)
        except _UNREADABLE:
            return None
        frames = resize_area(frames, self.width, self.height)
        return {
            "video": frames,
            "prompt": self.prompts[idx],
            "control_video": self.canny_control(frames),
            "file_id": os.path.splitext(os.path.basename(self.video_paths[idx]))[0],
        }


class ConcatDataset:
    """The datasets one after another (the trainer concatenates Balls, Dominos and
    Plants)."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.lengths = [len(d) for d in self.datasets]

    def __len__(self):
        return sum(self.lengths)

    def __getitem__(self, idx):
        for d, n in zip(self.datasets, self.lengths):
            if idx < n:
                return d[idx]
            idx -= n
        raise IndexError(idx)
