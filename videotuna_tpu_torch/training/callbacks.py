"""Training callbacks, the counterpart of
``videotuna_tpu/training/callbacks.py``: plain callables
``(step, metrics, state)`` that the Trainer calls at its logging steps —
a metrics CSV, sample videos, throughput and device memory, the learning
rate."""

from __future__ import annotations

import csv
import json
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from videotuna_tpu_torch.core.monitor import device_memory_stats
from videotuna_tpu_torch.data.video_io import save_video

Callback = Callable[[int, Dict[str, Any], Any], None]


class CSVMetricsLogger:
    """``metrics.csv`` with the header of the first row."""

    def __init__(self, workdir: str, filename: str = "metrics.csv"):
        self.path = Path(workdir) / filename
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._header: Optional[List[str]] = None

    def __call__(self, step: int, metrics: Dict[str, Any], state=None):
        row = {"step": step,
               **{k: float(v) for k, v in metrics.items()
                  if np.isscalar(v) or getattr(v, "ndim", 1) == 0}}
        new = self._header is None
        if new:
            self._header = list(row)
        with open(self.path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._header,
                               extrasaction="ignore")
            if new:
                w.writeheader()
            w.writerow(row)


class SampleVideoLogger:
    """Every ``every_n_steps`` steps, ``sample_fn(state, step)`` → videos
    (B, T, H, W, 3) in [−1, 1], written as mp4s under ``workdir/samples``.
    A failing sample is reported and skipped."""

    def __init__(self, workdir: str, sample_fn: Callable,
                 every_n_steps: int = 500, fps: int = 8):
        self.dir = Path(workdir) / "samples"
        self.sample_fn = sample_fn
        self.every = every_n_steps
        self.fps = fps

    def __call__(self, step: int, metrics: Dict[str, Any], state=None):
        if step % self.every != 0:
            return
        try:
            videos = self.sample_fn(state, step)
            if isinstance(videos, torch.Tensor):
                videos = videos.detach().float().cpu().numpy()
            videos = np.asarray(videos)
        except Exception as e:  # noqa: BLE001 — a sample must not stop a run
            print(f"[sample-logger] skipped at step {step}: {e}")
            return
        self.dir.mkdir(parents=True, exist_ok=True)
        for i, v in enumerate(videos):
            save_video(v, str(self.dir / f"step{step:07d}_{i}.mp4"),
                       fps=self.fps)


class ThroughputMonitor:
    """Steps per second and device memory every ``every_n_steps`` steps,
    appended to ``throughput.jsonl``."""

    def __init__(self, workdir: str, every_n_steps: int = 50):
        self.path = Path(workdir) / "throughput.jsonl"
        self.every = every_n_steps
        self._last_time = time.perf_counter()
        self._last_step = 0

    def __call__(self, step: int, metrics: Dict[str, Any], state=None):
        if step % self.every != 0:
            return
        now = time.perf_counter()
        ds = max(step - self._last_step, 1)
        rec = {"step": step,
               "steps_per_sec": ds / max(now - self._last_time, 1e-9),
               "device_memory": device_memory_stats()}
        self._last_time, self._last_step = now, step
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


class LearningRateMonitor:
    """Records ``schedule(step)`` into the metrics and its history."""

    def __init__(self, schedule: Callable[[int], float]):
        self.schedule = schedule
        self.history: List[tuple] = []

    def __call__(self, step: int, metrics: Dict[str, Any], state=None):
        lr = float(self.schedule(step)) if callable(self.schedule) \
            else float(self.schedule)
        metrics["lr"] = lr
        self.history.append((step, lr))
