"""Host-side image and video IO.

Port of ``goal_force_tpu/data/video_io.py``. Loaders return float32 frames in [0, 1],
channels last. ``save_video`` and ``load_video`` use imageio-ffmpeg where it imports,
else OpenCV, as the JAX package does; images go through PIL. Each function imports its
backend when called.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np


def _imageio_ffmpeg_available() -> bool:
    try:
        import imageio_ffmpeg  # noqa: F401
    except ImportError:
        return False
    return True


def _to_uint8(frame) -> np.ndarray:
    arr = np.asarray(frame)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
    return arr


def save_video(frames, path: str, fps: int = 15, quality: int = 5) -> None:
    """frames: (F, H, W, 3) float [0, 1] or uint8, or a list of such frames."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if _imageio_ffmpeg_available():
        import imageio

        writer = imageio.get_writer(path, fps=fps, quality=quality)
        try:
            for frame in frames:
                writer.append_data(_to_uint8(frame))
        finally:
            writer.close()
        return

    import cv2

    first = _to_uint8(frames[0])
    h, w = first.shape[:2]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not writer.isOpened():
        raise RuntimeError(f"cv2 VideoWriter failed to open {path}")
    try:
        for frame in frames:
            writer.write(cv2.cvtColor(_to_uint8(frame), cv2.COLOR_RGB2BGR))
    finally:
        writer.release()


def load_video(path: str, num_frames: Optional[int] = None) -> np.ndarray:
    """-> (F, H, W, 3) float32 in [0, 1]."""
    frames = []
    for i, frame in enumerate(_iter_frames(path)):
        if num_frames is not None and i >= num_frames:
            break
        frames.append(np.asarray(frame, np.float32) / 255.0)
    return np.stack(frames)


def load_video_frames(path: str) -> List[np.ndarray]:
    """Every frame of a clip as (H, W, 3) uint8 (the counterpart of JAX's
    ``load_video_pil``)."""
    return list(_iter_frames(path))


def _iter_frames(path: str):
    if _imageio_ffmpeg_available():
        import imageio

        reader = imageio.get_reader(path)
        try:
            for frame in reader:
                yield np.asarray(frame)
        finally:
            reader.close()
        return
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise RuntimeError(f"cv2 failed to open {path}")
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            yield cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
    finally:
        cap.release()


def load_image(path: str, size=None) -> np.ndarray:
    """-> (H, W, 3) float32 in [0, 1]; optional (width, height) LANCZOS resize."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if size is not None and img.size != tuple(size):
        img = img.resize(tuple(size), resample=Image.Resampling.LANCZOS)
    return np.asarray(img, np.float32) / 255.0


def save_image(image, path: str) -> None:
    """Write (H, W, 3) float in [0, 1] (scaled by 255 and truncated, as the JAX CLI
    writes its first frame) or uint8 as an image file, its format from the suffix."""
    from PIL import Image

    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = (arr * 255).astype(np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    Image.fromarray(arr).save(path)
