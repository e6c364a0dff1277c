"""Resource monitoring & run metrics: wall time, host RSS delta, and per-GPU
memory read with ``torch.cuda.max_memory_allocated`` (the counterpart of the
JAX package's per-device HBM stats).  ``psutil`` is optional."""

from __future__ import annotations

import functools
import json
import os
import time
from typing import Any, Callable, Dict, Optional

import torch

try:
    import psutil
except ImportError:  # pragma: no cover
    psutil = None


def device_memory_stats() -> Dict[str, Any]:
    """Allocated / peak-allocated / total bytes of every initialised GPU."""
    stats: Dict[str, Any] = {}
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return stats
    for i in range(torch.cuda.device_count()):
        stats[f"device_{i}"] = {
            "bytes_in_use": torch.cuda.memory_allocated(i),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(i),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return stats


def monitor_resources(return_metrics: bool = True) -> Callable:
    """Decorator capturing wall time / RSS delta / peak GPU memory per call."""

    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            rss0 = psutil.Process().memory_info().rss if psutil else 0
            t0 = time.perf_counter()
            result = fn(*args, **kwargs)
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            rss1 = psutil.Process().memory_info().rss if psutil else 0
            metrics = {
                "time_sec": round(elapsed, 3),
                "cpu_rss_delta_mb": round((rss1 - rss0) / 1e6, 1),
                "device_memory": device_memory_stats(),
            }
            if return_metrics:
                return result, metrics
            return result
        return wrapped

    return deco


def save_metrics(metrics: Dict[str, Any], savedir: str,
                 config: Optional[Dict[str, Any]] = None,
                 filename: str = "metric.json") -> str:
    """Write metric.json for a run."""
    os.makedirs(savedir, exist_ok=True)
    payload = dict(metrics)
    if config is not None:
        payload["config"] = _jsonable(config)
    path = os.path.join(savedir, filename)
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, default=str)
    return path


def _jsonable(obj: Any) -> Any:
    try:
        json.dumps(obj)
        return obj
    except TypeError:
        if isinstance(obj, dict):
            return {k: _jsonable(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return [_jsonable(v) for v in obj]
        return str(obj)
