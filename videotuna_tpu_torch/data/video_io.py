"""Host-side video IO: float [-1, 1] channel-last frames → uint8 → mp4 with
OpenCV, or ``.npy`` when OpenCV or its codec is missing (as in the JAX
package's ``data/video_io.py``)."""

from __future__ import annotations

import os

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
