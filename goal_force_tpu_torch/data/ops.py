"""Composable data operators (``>>`` pipelines) and the generic ``UnifiedDataset``.

Port of ``goal_force_tpu/data/ops.py``, the reference's generic metadata dataset:
operators compose with ``>>``, route by Python type or file extension, and feed a
dataset whose rows come from a CSV, JSON or JSONL file, each file-valued key passed
through its operator. Host-side only; PIL, imageio and pandas are imported where used.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List


class DataProcessingOperator:
    def __call__(self, data):
        raise NotImplementedError

    def __rshift__(self, other: "DataProcessingOperator") -> "DataProcessingPipeline":
        return DataProcessingPipeline([self, other])


class DataProcessingPipeline(DataProcessingOperator):
    def __init__(self, operators: List[DataProcessingOperator]):
        self.operators = list(operators)

    def __call__(self, data):
        for op in self.operators:
            data = op(data)
        return data

    def __rshift__(self, other):
        if isinstance(other, DataProcessingPipeline):
            return DataProcessingPipeline(self.operators + other.operators)
        return DataProcessingPipeline(self.operators + [other])


class ToAbsolutePath(DataProcessingOperator):
    def __init__(self, base_path: str = ""):
        self.base_path = base_path

    def __call__(self, path: str) -> str:
        return os.path.join(self.base_path, path)


class LoadImage(DataProcessingOperator):
    def __call__(self, path: str):
        from PIL import Image

        return Image.open(path).convert("RGB")


def _drop_to_division(frames: list, div: int, rem: int) -> list:
    """Drop trailing frames until len % div == rem (or none are left)."""
    while len(frames) % div != rem and len(frames) > 0:
        frames.pop()
    return frames


class LoadVideo(DataProcessingOperator):
    """Up to num_frames PIL frames through imageio, then trailing frames dropped until
    the count is time_division_remainder modulo time_division_factor (81 frames, 4k + 1
    by default)."""

    def __init__(self, num_frames=81, time_division_factor=4, time_division_remainder=1,
                 frame_processor=None):
        self.num_frames = num_frames
        self.div = time_division_factor
        self.rem = time_division_remainder
        self.frame_processor = frame_processor or (lambda x: x)

    def __call__(self, path: str) -> list:
        import imageio
        import numpy as np
        from PIL import Image

        reader = imageio.get_reader(path)
        frames = []
        try:
            for i, frame in enumerate(reader):
                if i >= self.num_frames:
                    break
                frames.append(self.frame_processor(Image.fromarray(np.asarray(frame))))
        finally:
            reader.close()
        return _drop_to_division(frames, self.div, self.rem)


class LoadGIF(LoadVideo):
    def __call__(self, path: str) -> list:
        from PIL import Image

        gif = Image.open(path)
        frames = []
        try:
            for i in range(getattr(gif, "n_frames", 1)):
                if i >= self.num_frames:
                    break
                gif.seek(i)
                frames.append(self.frame_processor(gif.convert("RGB")))
        except EOFError:
            pass
        return _drop_to_division(frames, self.div, self.rem)


class ImageCropAndResize(DataProcessingOperator):
    """With height and width: scale to cover them (LANCZOS), then center-crop. Without:
    shrink to at most max_pixels and round each side down to its division factor."""

    def __init__(self, height=None, width=None, max_pixels=1920 * 1080,
                 height_division_factor=16, width_division_factor=16):
        self.height = height
        self.width = width
        self.max_pixels = max_pixels
        self.hdiv = height_division_factor
        self.wdiv = width_division_factor

    def __call__(self, image):
        from PIL import Image

        if self.height is not None and self.width is not None:
            th, tw = self.height, self.width
            w, h = image.size
            scale = max(tw / w, th / h)
            image = image.resize((round(w * scale), round(h * scale)),
                                 resample=Image.Resampling.LANCZOS)
            w, h = image.size
            left, top = (w - tw) // 2, (h - th) // 2
            return image.crop((left, top, left + tw, top + th))
        w, h = image.size
        if w * h > self.max_pixels:
            scale = (self.max_pixels / (w * h)) ** 0.5
            w, h = round(w * scale), round(h * scale)
        w = max(self.wdiv, w // self.wdiv * self.wdiv)
        h = max(self.hdiv, h // self.hdiv * self.hdiv)
        return image.resize((w, h), resample=Image.Resampling.LANCZOS)


class ToList(DataProcessingOperator):
    def __call__(self, data):
        return [data]


class SequencialProcess(DataProcessingOperator):
    """The operator applied to each item of a list (the reference's spelling)."""

    def __init__(self, op: DataProcessingOperator):
        self.op = op

    def __call__(self, data):
        return [self.op(d) for d in data]


class RouteByType(DataProcessingOperator):
    def __init__(self, operator_map):
        self.operator_map = operator_map

    def __call__(self, data):
        for typ, op in self.operator_map:
            if isinstance(data, typ):
                return op(data)
        raise TypeError(f"no route for {type(data)}")


class RouteByExtensionName(DataProcessingOperator):
    def __init__(self, operator_map):
        self.operator_map = operator_map

    def __call__(self, path: str):
        ext = os.path.splitext(path)[1].lstrip(".").lower()
        for exts, op in self.operator_map:
            if ext in exts:
                return op(path)
        raise ValueError(f"no route for extension .{ext}")


class UnifiedDataset:
    """Rows of a CSV, JSON or JSONL metadata file, `repeat` times over; each key of
    `data_file_keys` that a row holds goes through its operator in
    `special_operator_map`, else `main_data_operator`. A row whose operator raises
    gives None (the collate function drops it)."""

    def __init__(self, base_path="", metadata_path=None, repeat=1,
                 data_file_keys=("image", "video"), main_data_operator=lambda x: x,
                 special_operator_map=None):
        self.base_path = base_path
        self.repeat = repeat
        self.data_file_keys = data_file_keys
        self.main_data_operator = main_data_operator
        self.special_operator_map = special_operator_map or {}
        self.rows = self._load_metadata(metadata_path)

    @staticmethod
    def _load_metadata(path) -> List[Dict]:
        if path is None:
            return []
        if path.endswith(".json"):
            with open(path) as f:
                return json.load(f)
        if path.endswith(".jsonl"):
            with open(path) as f:
                return [json.loads(line) for line in f if line.strip()]
        import pandas

        return pandas.read_csv(path).to_dict("records")

    def __len__(self):
        return len(self.rows) * self.repeat

    def __getitem__(self, idx):
        row = dict(self.rows[idx % len(self.rows)])
        try:
            for key in self.data_file_keys:
                if key in row:
                    op = self.special_operator_map.get(key, self.main_data_operator)
                    row[key] = op(row[key])
        except Exception:
            return None
        return row
