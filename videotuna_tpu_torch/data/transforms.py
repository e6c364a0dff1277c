"""Host-side data transforms and dummy loaders with failure injection, the
counterpart of ``videotuna_tpu/data/transforms.py``: video load, resolution
checks, temporal random crop, center-crop-resize, normalize, image →
pseudo-video, and ``LoadDummyVideo(probs_fail=…)``.

All transforms take and return numpy (T, H, W, 3); ``Normalize`` maps uint8
[0, 255] → float32 [−1, 1].  The random draws are the JAX module's own: the
crop and flip use the ``random`` module (or a given ``random.Random``), and
a dummy video is drawn from ``np.random.default_rng(abs(hash(path)) %
2**31)``.  Python's ``hash`` of a string is salted per process, so dummy
videos agree between the two packages within one process only.  The fused
native crop-resize-normalize of the JAX package is not ported: the video
pipeline runs the Python pair it falls back to.
"""

from __future__ import annotations

import random
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

from videotuna_tpu_torch.data.video_io import load_image, load_video

Transform = Callable[[np.ndarray], np.ndarray]


class Compose:
    def __init__(self, transforms: Sequence[Transform]):
        self.transforms = list(transforms)

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


class LoadVideo:
    """Decode a video from its path → (T, H, W, 3) uint8."""

    def __init__(self, num_frames: Optional[int] = None, stride: int = 1):
        self.num_frames = num_frames
        self.stride = stride

    def __call__(self, path: str) -> np.ndarray:
        return load_video(path, self.num_frames, self.stride)


class LoadImage:
    def __call__(self, path: str) -> np.ndarray:
        return load_image(path)[None]  # (1, H, W, 3)


class LoadDummyVideo:
    """Random uint8 video, deterministic per path within a process, with a
    probability ``probs_fail`` of an injected decode failure."""

    def __init__(self, num_frames: int = 16, height: int = 256,
                 width: int = 256, probs_fail: float = 0.0):
        self.num_frames = num_frames
        self.height = height
        self.width = width
        self.probs_fail = probs_fail

    def __call__(self, path: str) -> np.ndarray:
        rng = np.random.default_rng(abs(hash(str(path))) % (2 ** 31))
        if rng.random() < self.probs_fail:
            raise RuntimeError(f"Injected decode failure for {path}")
        return rng.integers(0, 256,
                            (self.num_frames, self.height, self.width, 3),
                            dtype=np.uint8).astype(np.uint8)


class LoadDummyImage(LoadDummyVideo):
    def __init__(self, height: int = 256, width: int = 256,
                 probs_fail: float = 0.0):
        super().__init__(1, height, width, probs_fail)


class CheckVideo:
    """Reject a video with fewer frames or pixels than asked for."""

    def __init__(self, min_frames: int = 1,
                 min_size: Tuple[int, int] = (1, 1)):
        self.min_frames = min_frames
        self.min_size = min_size

    def __call__(self, video: np.ndarray) -> np.ndarray:
        t, h, w = video.shape[:3]
        if t < self.min_frames or h < self.min_size[0] or w < self.min_size[1]:
            raise ValueError(
                f"Video too small: {video.shape} < "
                f"({self.min_frames}, {self.min_size})")
        return video


class TemporalRandomCrop:
    """A uniformly placed window of ``num_frames`` frames, every
    ``frame_interval``-th; a shorter video is looped."""

    def __init__(self, num_frames: int, frame_interval: int = 1,
                 rng: Optional[random.Random] = None):
        self.num_frames = num_frames
        self.frame_interval = frame_interval
        self.rng = rng or random

    def __call__(self, video: np.ndarray) -> np.ndarray:
        t = video.shape[0]
        span = (self.num_frames - 1) * self.frame_interval + 1
        if t < span:
            idx = np.arange(self.num_frames) % t
            return video[idx]
        start = self.rng.randint(0, t - span)
        return video[start:start + span:self.frame_interval]


class CenterCropResize:
    """Resize preserving the aspect ratio (OpenCV, area when shrinking),
    then crop the center to ``size`` (H, W)."""

    def __init__(self, size: Tuple[int, int]):
        self.size = size

    def __call__(self, video: np.ndarray) -> np.ndarray:
        th, tw = self.size
        t, h, w = video.shape[:3]
        scale = max(th / h, tw / w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        if cv2 is not None and (nh, nw) != (h, w):
            video = np.stack([
                cv2.resize(f, (nw, nh), interpolation=cv2.INTER_AREA
                           if scale < 1 else cv2.INTER_LINEAR)
                for f in video])
        y0 = (video.shape[1] - th) // 2
        x0 = (video.shape[2] - tw) // 2
        return video[:, y0:y0 + th, x0:x0 + tw]


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5, rng: Optional[random.Random] = None):
        self.p = p
        self.rng = rng or random

    def __call__(self, video: np.ndarray) -> np.ndarray:
        if self.rng.random() < self.p:
            return video[:, :, ::-1].copy()
        return video


class Normalize:
    """uint8 [0, 255] → float32 [−1, 1]."""

    def __call__(self, video: np.ndarray) -> np.ndarray:
        return video.astype(np.float32) / 127.5 - 1.0


class ImageToVideo:
    """(1|H, W, 3) image → a pseudo-video of ``num_frames`` copies."""

    def __init__(self, num_frames: int):
        self.num_frames = num_frames

    def __call__(self, img: np.ndarray) -> np.ndarray:
        if img.ndim == 3:
            img = img[None]
        return np.repeat(img[:1], self.num_frames, axis=0)


def get_transforms_video(resolution: Tuple[int, int] = (256, 256),
                         num_frames: int = 16,
                         frame_interval: int = 1) -> Compose:
    """The default video pipeline: check, temporal crop, crop-resize,
    normalize."""
    return Compose([
        CheckVideo(min_frames=1),
        TemporalRandomCrop(num_frames, frame_interval),
        CenterCropResize(resolution),
        Normalize(),
    ])


def get_transforms_image(resolution: Tuple[int, int] = (256, 256),
                         num_frames: int = 1) -> Compose:
    return Compose([
        ImageToVideo(num_frames),
        CenterCropResize(resolution),
        Normalize(),
    ])
