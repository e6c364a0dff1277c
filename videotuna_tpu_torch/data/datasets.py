"""Datasets of the port: CSV-annotated videos and images, the file-list
format, and the epoch loader — the counterpart of
``videotuna_tpu/data/datasets.py``.

- ``DatasetFromCSV``: CSV of ``path,caption[,…]``, several CSVs
  concatenated, train/val split, bad-sample retry from a safe list,
  first-frame extraction; ``dummy=True`` swaps in the dummy loaders so a run
  needs no media.
- ``VideoDataset``: ``videos.txt`` + ``labels.txt``, frames cut to 4k+1.
- ``EpochLoader``: shuffling batcher of numpy batches, one shuffle per
  epoch from ``random.Random(seed + epoch)``, as the JAX loader draws it.
  ``resume_at(step)`` places it where a run that took ``step`` batches
  left it, so a resumed run reads the batches an unbroken run would.
"""

from __future__ import annotations

import csv
import os
import random
import tempfile
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

from videotuna_tpu_torch.core.registry import register
from videotuna_tpu_torch.data.transforms import (LoadDummyImage,
                                                 LoadDummyVideo, LoadImage,
                                                 LoadVideo,
                                                 get_transforms_image,
                                                 get_transforms_video)

VIDEO_EXTS = {".mp4", ".avi", ".mov", ".mkv", ".webm", ".npy"}
IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}

MAX_RETRIES = 100


def _read_csv(path: str) -> List[Dict[str, Any]]:
    with open(path, newline="") as f:
        return [dict(row) for row in csv.DictReader(f)]


@register("videotuna_tpu_torch.data.DatasetFromCSV",
          aliases=["videotuna.data.datasets.DatasetFromCSV"])
class DatasetFromCSV:
    """CSV-annotated dataset with a failure-tolerant ``__getitem__``.

    ``csv_path`` is one path or a list of them.  The media type is inferred
    per row from the extension.  Items are {"video": (T, H, W, 3) float32
    in [−1, 1], "caption", "path", "is_image"[, "cond_image"]}."""

    def __init__(self, csv_path, data_root: str = "", num_frames: int = 16,
                 frame_interval: int = 1, resolution=(256, 256),
                 split: str = "all", train_ratio: float = 0.9,
                 seed: int = 0, transform: Optional[Callable] = None,
                 image_transform: Optional[Callable] = None,
                 loader: Optional[Callable] = None,
                 image_loader: Optional[Callable] = None,
                 first_frame_as_cond: bool = False, dummy: bool = False,
                 dummy_probs_fail: float = 0.0):
        if dummy:
            loader = loader or LoadDummyVideo(
                num_frames=max(num_frames * 2, 8), height=resolution[0],
                width=resolution[1], probs_fail=dummy_probs_fail)
            image_loader = image_loader or LoadDummyImage(
                height=resolution[0], width=resolution[1],
                probs_fail=dummy_probs_fail)
        paths = [csv_path] if isinstance(csv_path, (str, Path)) \
            else list(csv_path)
        self.samples: List[Dict[str, Any]] = []
        for p in paths:
            self.samples.extend(_read_csv(str(p)))
        if split in ("train", "val"):
            idx = list(range(len(self.samples)))
            random.Random(seed).shuffle(idx)
            cut = int(len(idx) * train_ratio)
            sel = idx[:cut] if split == "train" else idx[cut:]
            self.samples = [self.samples[i] for i in sorted(sel)]
        self.data_root = data_root
        self.num_frames = num_frames
        self.resolution = tuple(resolution)
        self.transform = transform or get_transforms_video(
            self.resolution, num_frames, frame_interval)
        self.image_transform = image_transform or get_transforms_image(
            self.resolution, num_frames)
        self.loader = loader or LoadVideo()
        self.image_loader = image_loader or LoadImage()
        self.first_frame_as_cond = first_frame_as_cond
        self.safe_list: List[int] = []
        self._rng = random.Random(seed)

    def __len__(self) -> int:
        return len(self.samples)

    def _path_of(self, row: Dict[str, Any]) -> str:
        p = row.get("path") or row.get("video") or row.get("file")
        return os.path.join(self.data_root, p) if self.data_root else p

    def _load_one(self, index: int) -> Dict[str, Any]:
        row = self.samples[index]
        path = self._path_of(row)
        is_image = os.path.splitext(path)[1].lower() in IMAGE_EXTS
        if is_image:
            video = self.image_transform(self.image_loader(path))
        else:
            video = self.transform(self.loader(path))
        out = {"video": video.astype(np.float32),
               "caption": row.get("caption", row.get("text", "")),
               "path": path, "is_image": is_image}
        if self.first_frame_as_cond:
            out["cond_image"] = video[:1].copy()
        return out

    def __getitem__(self, index: int) -> Dict[str, Any]:
        """Retry up to MAX_RETRIES on decode or shape errors, drawing the
        next index from the safe list when it has one."""
        for _ in range(MAX_RETRIES):
            try:
                item = self._load_one(index)
                if index not in self.safe_list:
                    self.safe_list.append(index)
                return item
            except Exception:
                if self.safe_list:
                    index = self._rng.choice(self.safe_list)
                else:
                    index = self._rng.randrange(len(self.samples))
        raise RuntimeError(f"Failed to load a sample after {MAX_RETRIES} "
                           "retries")


@register("videotuna_tpu_torch.data.VideoDataset",
          aliases=["videotuna.data.cogvideo_dataset.VideoDataset"])
class VideoDataset(DatasetFromCSV):
    """File-list format: ``videos.txt`` + ``labels.txt`` (or
    ``prompts.txt``) under ``instance_data_root``; frames cut to 4k+1, as
    CogVideoX's causal VAE needs."""

    def __init__(self, instance_data_root: str, num_frames: int = 49,
                 **kwargs):
        root = Path(instance_data_root)
        videos = (root / "videos.txt").read_text().splitlines()
        labels_file = root / "labels.txt"
        lf = labels_file if labels_file.exists() else root / "prompts.txt"
        labels = lf.read_text().splitlines() if lf.exists() \
            else [""] * len(videos)
        nf = ((num_frames - 1) // 4) * 4 + 1
        tmp = tempfile.NamedTemporaryFile("w", suffix=".csv", delete=False,
                                          newline="")
        writer = csv.writer(tmp)
        writer.writerow(["path", "caption"])
        for v, l in zip(videos, labels):
            writer.writerow([v.strip(), l.strip()])
        tmp.close()
        super().__init__(tmp.name, data_root=str(root), num_frames=nf,
                         **kwargs)


class EpochLoader:
    """Shuffling batcher yielding dicts of stacked numpy arrays (lists for
    strings); ``drop_last`` keeps every batch the same shape."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0
        self._skip = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size

    def resume_at(self, step: int) -> None:
        """Make the next iteration continue after ``step`` batches."""
        n = max(len(self), 1)
        self._epoch, self._skip = divmod(step, n)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self._epoch).shuffle(idx)
        self._epoch += 1
        idx = idx[self._skip * self.batch_size:]
        self._skip = 0
        batch: List[Dict[str, Any]] = []
        for i in idx:
            batch.append(self.dataset[i])
            if len(batch) == self.batch_size:
                yield collate(batch)
                batch = []
        if batch and not self.drop_last:
            yield collate(batch)


def collate(items: List[Dict[str, Any]]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        out[k] = np.stack(vals) if isinstance(vals[0], np.ndarray) else vals
    return out


def make_toy_csv(path: str, n: int = 128, caption: str = "toy clip",
                 ext: str = ".mp4") -> str:
    """A toy annotation file of ``n`` rows."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["path", "caption"])
        for i in range(n):
            w.writerow([f"toy_videos/clip_{i:03d}{ext}", f"{caption} {i}"])
    return path
