"""Background batch preparation, the counterpart of
``videotuna_tpu/data/prefetch.py``.

A daemon thread runs the host pipeline (decode, transforms, collate), the
``prepare`` hook (the trainer's caption encode), this rank's block of the
batch on a mesh (``parallel/sharding.shard_batch``) and the copy to the
device, so that batch n+1 is ready while step n runs.  The thread issues
its work on the stream that was current where iteration began, the step's
own, so the stream's order alone makes each batch complete before a step
reads it and the results are exactly those of the loop without the
thread; what overlaps is the host's work: decoding, transforms,
tokenizing and launching.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Union

import numpy as np
import torch

from videotuna_tpu_torch.parallel.sharding import shard_batch, splits_batch


def to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """numpy arrays and tensors of ``batch`` on ``device``; other values
    (caption lists) as they are."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(v)
        if isinstance(v, torch.Tensor):
            v = v.to(device, non_blocking=True)
        out[k] = v
    return out


class DevicePrefetcher:
    """Wrap a host batch iterable; yields batches on ``device`` (this
    rank's block of each over ``mesh``'s dp×fsdp), at most ``depth`` of
    them prepared ahead.  ``split`` says of the batch just yielded whether
    the ranks took different blocks of it (False where each holds it
    whole).  An exception in the worker is raised
    in the consumer at the batch where it happened.  Leaving the iteration
    early stops the worker after the batch it is preparing."""

    def __init__(self, loader: Iterable, device: Union[str, torch.device],
                 depth: int = 2,
                 prepare: Optional[Callable[[Dict[str, Any]],
                                            Dict[str, Any]]] = None,
                 mesh=None):
        if depth < 1:
            raise ValueError(f"depth must be at least 1, got {depth}")
        self.loader = loader
        self.device = torch.device(device)
        self.depth = depth
        self.prepare = prepare
        self.mesh = mesh
        self.split = False

    def _stream_scope(self):
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        return torch.cuda.stream(torch.cuda.current_stream(self.device))

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        done = object()
        stop = threading.Event()
        stream_scope = self._stream_scope()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                with stream_scope:
                    for batch in self.loader:
                        if self.prepare is not None:
                            batch = self.prepare(batch)
                        split = (self.mesh is not None
                                 and splits_batch(batch, self.mesh))
                        if self.mesh is not None:
                            batch = shard_batch(batch, self.mesh)
                        if not put((to_device(batch, self.device), split)):
                            return
                put(done)
            except BaseException as e:  # noqa: BLE001 — to the consumer
                put(e)

        thread = threading.Thread(target=worker, daemon=True,
                                  name="DevicePrefetcher")
        thread.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    return
                if isinstance(item, BaseException):
                    raise item
                batch, self.split = item
                yield batch
        finally:
            stop.set()
            thread.join()
