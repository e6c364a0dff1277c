"""Host-side video IO, as in the JAX package's ``data/video_io.py``: float
[-1, 1] channel-last frames → uint8 → mp4 with OpenCV, or ``.npy`` when
OpenCV or its codec is missing; and the readers of the training data
(mp4 through OpenCV, or ``.npy``) → uint8 RGB."""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def to_uint8(video: np.ndarray) -> np.ndarray:
    """float [-1,1] (T, H, W, 3) → uint8 RGB."""
    video = np.asarray(video, dtype=np.float32)
    video = (np.clip(video, -1.0, 1.0) + 1.0) * 127.5
    return video.astype(np.uint8)


def save_video(video: np.ndarray, path: str, fps: int = 8) -> str:
    """(T, H, W, 3) float [-1,1] or uint8 → mp4; falls back to .npy when no
    codec is available.  Returns the path written."""
    path = str(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arr = video if video.dtype == np.uint8 else to_uint8(video)
    _, h, w, _ = arr.shape
    if cv2 is not None:
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                                 fps, (w, h))
        if writer.isOpened():
            for frame in arr:
                writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
            writer.release()
            return path
    np.save(path + ".npy", arr)
    return path + ".npy"


def load_video(path: str, num_frames: Optional[int] = None,
               stride: int = 1) -> np.ndarray:
    """mp4 (or .npy) → (T, H, W, 3) uint8 RGB: every ``stride``-th frame,
    at most ``num_frames`` of them."""
    if str(path).endswith(".npy"):
        return np.load(path)
    if cv2 is None:
        raise RuntimeError("cv2 unavailable; cannot decode video")
    cap = cv2.VideoCapture(str(path))
    frames: List[np.ndarray] = []
    idx = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if idx % stride == 0:
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        idx += 1
        if num_frames is not None and len(frames) >= num_frames:
            break
    cap.release()
    if not frames:
        raise ValueError(f"No frames decoded from {path}")
    return np.stack(frames)


def load_image(path: str) -> np.ndarray:
    """Image (or .npy) → (H, W, 3) uint8 RGB."""
    if str(path).endswith(".npy"):
        return np.load(path)
    if cv2 is None:
        raise RuntimeError("cv2 unavailable")
    img = cv2.imread(str(path))
    if img is None:
        raise ValueError(f"Failed to read image {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
