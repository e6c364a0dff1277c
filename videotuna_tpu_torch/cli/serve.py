"""Inference server of the port, the counterpart of
``videotuna_tpu/cli/serve.py``: POST /generate → mp4.

One process owns the flow (weights resident on the card); requests are
served one at a time (``InferenceService``), coalesced by geometry into
one batched sampler call (``BatchingInferenceService``), or boarded onto a
rolling denoise batch at the next step (``ContinuousBatchingService``,
``serving/continuous.py``).

    python -m videotuna_tpu_torch.cli.serve --config configs/... \
        [--device cpu] [--port 8000]

    curl -X POST localhost:8000/generate \
         -H 'Content-Type: application/json' \
         -d '{"prompt": "a red panda", "seed": 3}'
    → {"videos": ["<path>"], "time_sec": ...}

    GET /healthz → {"status": "ok", "model": "<flow class>", ...}
    GET /metrics → served, rejected and timed-out counts, queue depth

Runs on ``cuda`` unless ``--device`` (``device=``) says otherwise.  Every
worker and request thread samples under ``torch.inference_mode()`` (grad
mode is local to a thread).  A mesh of more than one device raises: the
parallelism slice is ROADMAP.md queue 1, item 10.1.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import os
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict

import torch

from videotuna_tpu_torch.core.config import apply_inference_mapping, load_configs
from videotuna_tpu_torch.core.registry import instantiate, populate


class ServiceBusy(RuntimeError):
    """Raised when backpressure rejects a request (queue full): HTTP 429,
    so clients retry with backoff."""


class ServiceTimeout(RuntimeError):
    """Raised when a request exceeds the per-request deadline: HTTP 504."""


class ServiceBadRequest(ValueError):
    """Raised for client errors (e.g. a geometry mismatch in continuous
    mode): HTTP 400, not a server fault."""


class InferenceService:
    """Owns the flow; thread-safe ``generate()`` with a bounded in-flight
    depth and a per-request deadline.  ``flow`` is a pre-built flow (tests,
    embedding); otherwise the config's is built on ``device`` with seeded
    weights, then the checkpoint's (``flow.pretrained``)."""

    def __init__(self, config: Dict[str, Any], max_queue: int = 32,
                 request_timeout_s: float = 600.0, flow: Any = None,
                 device: str = "cuda"):
        inf = config.get("inference", {})
        # a mesh of one device (or none) is what the JAX package runs on
        # one chip
        mesh = dict(inf.get("mesh") or {})
        devices = math.prod(int(n) for n in mesh.values())
        if devices != 1:
            raise NotImplementedError(
                f"multi-device serving (a mesh of {devices} devices, "
                f"{mesh}) waits for the parallelism slice, ROADMAP.md queue "
                "1, item 10.1; on one card set each of its axes to 1")
        self.config = config
        if flow is not None:
            self.flow = flow
        else:
            populate()
            self.flow = instantiate(config["flow"], device=device)
            self.flow.init_params(seed=int(inf.get("seed", 0)))
            ckpt = config["flow"].get("pretrained")
            if ckpt:
                self.flow.from_pretrained(ckpt)
        if str(inf.get("quantize", "")) == "int8":
            # w8a8 serving: an int8-resident denoiser
            self.flow.quantize_int8()
        self.lock = threading.Lock()
        self.max_queue = max_queue
        self.request_timeout = request_timeout_s
        self.requests_served = 0
        self.requests_rejected = 0
        self.requests_timed_out = 0
        self._inflight = 0
        self._inflight_lock = threading.Lock()

    def _enter(self):
        with self._inflight_lock:
            if self._inflight >= self.max_queue:
                self.requests_rejected += 1
                raise ServiceBusy(
                    f"queue full ({self._inflight}/{self.max_queue})")
            self._inflight += 1

    def _exit(self):
        with self._inflight_lock:
            self._inflight -= 1

    @property
    def queue_depth(self) -> int:
        return self._inflight

    def generate(self, request: Dict[str, Any]) -> Dict[str, Any]:
        self._enter()
        try:
            cfg = {"inference": dict(self.config.get("inference", {}))}
            inf = cfg["inference"]
            for k in ("prompt", "seed", "height", "width", "frames",
                      "unconditional_guidance_scale", "negative_prompt",
                      "fps"):
                if k in request:
                    inf[k] = request[k]
            inf.setdefault("savedir", "results/serve")
            inf["bs"] = 1
            inf["n_samples_prompt"] = int(request.get("n_samples", 1))
            t0 = time.perf_counter()
            # a bounded wait for the card instead of an unbounded pile-up
            if not self.lock.acquire(timeout=self.request_timeout):
                self.requests_timed_out += 1
                raise ServiceTimeout(
                    f"no chip slot within {self.request_timeout}s")
            try:
                with torch.inference_mode():
                    result = self.flow.inference(cfg)
            finally:
                self.lock.release()
            self.requests_served += 1
            return {"videos": result["videos"],
                    "time_sec": round(time.perf_counter() - t0, 3)}
        finally:
            self._exit()


class BatchingInferenceService(InferenceService):
    """Micro-batching: concurrent requests with the SAME generation
    geometry (height/width/frames/cfg/negative prompt) that arrive within
    ``max_wait_ms`` coalesce into one batched sampler call.  Per-request
    seeds collapse to the leader's (one generator stream per batched
    run)."""

    def __init__(self, config: Dict[str, Any], max_batch: int = 4,
                 max_wait_ms: float = 50.0, max_queue: int = 32,
                 request_timeout_s: float = 600.0, flow: Any = None,
                 device: str = "cuda"):
        super().__init__(config, max_queue=max_queue,
                         request_timeout_s=request_timeout_s, flow=flow,
                         device=device)
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self._queue: Any = collections.deque()
        self._cv = threading.Condition()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._running = True
        self._worker.start()

    @staticmethod
    def _geom_key(req: Dict[str, Any]) -> tuple:
        return tuple(req.get(k) for k in (
            "height", "width", "frames", "unconditional_guidance_scale",
            "negative_prompt"))

    def generate(self, request: Dict[str, Any]) -> Dict[str, Any]:
        item = {"req": request, "event": threading.Event(),
                "result": None, "error": None, "abandoned": False}
        with self._cv:
            if len(self._queue) >= self.max_queue:
                self.requests_rejected += 1
                raise ServiceBusy(
                    f"queue full ({len(self._queue)}/{self.max_queue})")
            self._queue.append(item)
            self._cv.notify()
        if not item["event"].wait(timeout=self.request_timeout):
            item["abandoned"] = True     # the worker skips it
            self.requests_timed_out += 1
            raise ServiceTimeout(
                f"request exceeded {self.request_timeout}s deadline")
        if item["error"] is not None:
            raise RuntimeError(item["error"])
        return item["result"]

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    def shutdown(self):
        with self._cv:
            self._running = False
            self._cv.notify_all()
        self._worker.join(timeout=5)

    def _loop(self):
        with torch.inference_mode():
            while True:
                with self._cv:
                    while self._running and not self._queue:
                        self._cv.wait()
                    if not self._running and not self._queue:
                        return
                    leader = self._queue.popleft()
                self._run_batch(self._collect(leader))

    def _collect(self, leader):
        """The leader and its same-geometry followers inside the wait
        window, up to ``max_batch``."""
        key = self._geom_key(leader["req"])
        batch = [leader]
        deadline = time.monotonic() + self.max_wait
        while len(batch) < self.max_batch:
            with self._cv:
                remaining = deadline - time.monotonic()
                if not self._queue and remaining > 0:
                    self._cv.wait(timeout=remaining)
                matched = None
                for it in list(self._queue):
                    if self._geom_key(it["req"]) == key:
                        matched = it
                        self._queue.remove(it)
                        break
            if matched is not None:
                batch.append(matched)
            elif time.monotonic() >= deadline:
                break
        return batch

    def _run_batch(self, batch):
        batch = [it for it in batch if not it["abandoned"]]
        if not batch:
            return
        t0 = time.perf_counter()
        prompts = [str(it["req"].get("prompt", "")) for it in batch]
        merged = dict(batch[0]["req"])
        merged.pop("prompt", None)
        merged["prompts_list"] = prompts
        merged["bs"] = len(prompts)
        try:
            cfg = {"inference": dict(self.config.get("inference", {}))}
            inf = cfg["inference"]
            for k in ("seed", "height", "width", "frames",
                      "unconditional_guidance_scale", "negative_prompt",
                      "fps", "prompts_list", "bs"):
                if k in merged and merged[k] is not None:
                    inf[k] = merged[k]
            inf.setdefault("savedir", "results/serve")
            inf["n_samples_prompt"] = 1
            with self.lock:
                result = self._infer(cfg)
            dt = round(time.perf_counter() - t0, 3)
            vids = result["videos"]
            for i, it in enumerate(batch):
                it["result"] = {"videos": [vids[i]] if i < len(vids)
                                else vids,
                                "batched_with": len(batch),
                                "time_sec": dt}
                self.requests_served += 1
        except Exception as e:  # noqa: BLE001 — fail the whole batch
            for it in batch:
                it["error"] = str(e)
        finally:
            for it in batch:
                it["event"].set()

    def _infer(self, cfg):
        return self.flow.inference(cfg)


class ContinuousBatchingService(InferenceService):
    """Step-level continuous batching (``serving/continuous.py``):
    requests board the rolling denoise batch at the next step boundary
    instead of waiting for a whole batch run.  Geometry (height/width/
    frames/cfg) is fixed per deployment from the config; a request of
    another geometry is rejected with 400.  Each request's x_T is drawn
    from ``torch.Generator(device).manual_seed(seed)``."""

    def __init__(self, config: Dict[str, Any], slots: int = 4,
                 max_queue: int = 32, request_timeout_s: float = 600.0,
                 flow: Any = None, device: str = "cuda"):
        super().__init__(config, max_queue=max_queue,
                         request_timeout_s=request_timeout_s, flow=flow,
                         device=device)
        from videotuna_tpu_torch.serving import ContinuousBatchEngine
        inf = dict(self.config.get("inference", {}))
        self.geometry = {
            "height": int(inf.get("height", 256)),
            "width": int(inf.get("width", 256)),
            "frames": int(inf.get("frames", 16)),
        }
        self.cfg_scale = float(inf.get("unconditional_guidance_scale", 7.5))
        self.fps = int(inf.get("fps", 8))
        self.savedir = inf.get("savedir", "results/serve")
        if getattr(self.flow, "use_dynamic_cfg", False):
            raise NotImplementedError(
                "continuous batching applies a FIXED guidance scale per "
                "step; this flow's dynamic (cosine) CFG would silently "
                "diverge from batch inference — disable use_dynamic_cfg "
                "or use --max_batch micro-batching")
        self.engine = ContinuousBatchEngine(
            self.flow, slots=slots, frames=self.geometry["frames"],
            height=self.geometry["height"], width=self.geometry["width"],
            cfg_scale=self.cfg_scale)
        self._uncond_cache: Dict[str, Any] = {}
        self._pending: Any = collections.deque()
        self._slot_items: Dict[int, Dict[str, Any]] = {}
        self._cv = threading.Condition()
        self._running = True
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    @property
    def queue_depth(self) -> int:
        return len(self._pending) + self.engine.n_active

    def shutdown(self):
        with self._cv:
            self._running = False
            self._cv.notify_all()
        self._worker.join(timeout=10)

    def generate(self, request: Dict[str, Any]) -> Dict[str, Any]:
        for k, v in self.geometry.items():
            if k in request and int(request[k]) != v:
                raise ServiceBadRequest(
                    f"continuous serving runs fixed geometry "
                    f"{self.geometry}; got {k}={request[k]}")
        item = {"req": request, "event": threading.Event(),
                "result": None, "error": None, "abandoned": False,
                "t0": time.perf_counter()}
        with self._cv:
            if len(self._pending) >= self.max_queue:
                self.requests_rejected += 1
                raise ServiceBusy(
                    f"queue full ({len(self._pending)}/{self.max_queue})")
            self._pending.append(item)
            self._cv.notify()
        if not item["event"].wait(timeout=self.request_timeout):
            item["abandoned"] = True       # _admit skips it: no card time
            self.requests_timed_out += 1
            raise ServiceTimeout(
                f"request exceeded {self.request_timeout}s deadline")
        if item["error"] is not None:
            raise RuntimeError(item["error"])
        return item["result"]

    def _admit(self):
        """Board pending requests onto free slots (the text encode runs
        here, in turn with the step loop: one card)."""
        while self._pending and self.engine.n_active < self.engine.slots:
            with self._cv:
                if not self._pending:
                    return
                item = self._pending.popleft()
            if item["abandoned"]:
                continue
            try:
                req = item["req"]
                prompt = str(req.get("prompt", ""))
                cond = self.flow.encode_text([prompt])
                neg = str(req.get("negative_prompt", ""))
                uncond = self._uncond_cache.get(neg)
                if uncond is None:
                    uncond = self.flow.encode_text([neg])
                    if len(self._uncond_cache) < 64:
                        self._uncond_cache[neg] = uncond
                device = self.engine.device
                gen = torch.Generator(device).manual_seed(
                    int(req.get("seed", 0)))
                shape1 = self.flow.latent_shape(
                    1, self.geometry["frames"], self.geometry["height"],
                    self.geometry["width"])
                x_t = torch.randn(shape1, generator=gen, device=device)
                slot = self.engine.submit(x_t, cond, uncond)
                if slot is None:
                    raise RuntimeError("no free slot after the check")
                item["prompt"] = prompt
                self._slot_items[slot] = item
            except Exception as e:  # noqa: BLE001 — fail just this item
                item["error"] = str(e)
                item["event"].set()

    def _finish(self, slot: int, latents):
        from videotuna_tpu_torch.data.video_io import save_video
        from videotuna_tpu_torch.flows.generation import savename
        item = self._slot_items.pop(slot)
        try:
            vid = self.flow.decode_latents(latents)
            vid = vid.float().cpu().numpy()[0]
            os.makedirs(self.savedir, exist_ok=True)
            name = savename(item.get("prompt", ""), self.requests_served, 0)
            path = save_video(vid, os.path.join(self.savedir, name),
                              fps=self.fps)
            self.requests_served += 1
            item["result"] = {
                "videos": [path],
                "time_sec": round(time.perf_counter() - item["t0"], 3),
                "continuous": True}
        except Exception as e:  # noqa: BLE001
            item["error"] = str(e)
        finally:
            item["event"].set()

    def _loop(self):
        with torch.inference_mode():
            while True:
                with self._cv:
                    while self._running and not self._pending \
                            and not self.engine.n_active:
                        self._cv.wait()
                    if not self._running:
                        return
                self._admit()
                if self.engine.n_active:
                    self.engine.step()
                    for slot, z in self.engine.poll_completed():
                        self._finish(slot, z)


def make_handler(service: InferenceService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            # access logs quiet; real errors go through log_error below
            pass

        def log_error(self, fmt, *args):
            print(f"[videotuna-tpu-torch serve] {fmt % args}",
                  file=sys.stderr)

        def _json(self, code: int, payload: Dict[str, Any],
                  headers: Dict[str, str] = None):
            body = json.dumps(payload).encode()
            self.send_response(code)
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {
                    "status": "ok",
                    "model": type(service.flow).__name__,
                    "requests_served": service.requests_served,
                })
            elif self.path == "/metrics":
                self._json(200, {
                    "requests_served": service.requests_served,
                    "requests_rejected": service.requests_rejected,
                    "requests_timed_out": service.requests_timed_out,
                    "queue_depth": service.queue_depth,
                    "max_queue": service.max_queue,
                })
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/generate":
                self._json(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                request = json.loads(self.rfile.read(n) or b"{}")
                with torch.inference_mode():
                    result = service.generate(request)
                self._json(200, result)
            except ServiceBusy as e:
                self._json(429, {"error": str(e)}, {"Retry-After": "5"})
            except ServiceTimeout as e:
                self._json(504, {"error": str(e)})
            except ServiceBadRequest as e:
                self._json(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — report, keep serving
                self._json(500, {"error": str(e)})

    return Handler


def serve(config: Dict[str, Any], port: int = 8000,
          host: str = "127.0.0.1", max_batch: int = 1,
          max_wait_ms: float = 50.0, max_queue: int = 32,
          request_timeout_s: float = 600.0, continuous_slots: int = 0,
          device: str = "cuda", flow: Any = None) -> ThreadingHTTPServer:
    """The HTTP server (not yet serving) over the service the arguments
    select; ``server.service`` is the service."""
    kw = dict(max_queue=max_queue, request_timeout_s=request_timeout_s,
              flow=flow, device=device)
    if continuous_slots > 0:
        service: InferenceService = ContinuousBatchingService(
            config, slots=continuous_slots, **kw)
    elif max_batch > 1:
        service = BatchingInferenceService(
            config, max_batch=max_batch, max_wait_ms=max_wait_ms, **kw)
    else:
        service = InferenceService(config, **kw)
    server = ThreadingHTTPServer((host, port), make_handler(service))
    server.service = service
    return server


def main(argv=None):
    ap = argparse.ArgumentParser("videotuna-tpu-torch serve")
    ap.add_argument("--config", "-b", action="append", required=True)
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu must be asked for)")
    ap.add_argument("--max_batch", type=int, default=1,
                    help=">1 enables same-geometry micro-batching")
    ap.add_argument("--max_wait_ms", type=float, default=50.0)
    ap.add_argument("--max_queue", type=int, default=32,
                    help="backpressure: queued requests beyond this get "
                         "HTTP 429")
    ap.add_argument("--request_timeout_s", type=float, default=600.0,
                    help="per-request deadline → HTTP 504")
    ap.add_argument("--continuous_slots", type=int, default=0,
                    help=">0 enables STEP-LEVEL continuous batching with "
                         "this many rolling slots (fixed geometry)")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    config = apply_inference_mapping(load_configs(args.config,
                                                  args.overrides))
    server = serve(config, args.port, args.host, args.max_batch,
                   args.max_wait_ms, args.max_queue,
                   args.request_timeout_s, args.continuous_slots,
                   device=args.device)
    host, port = server.server_address[:2]
    print(f"[videotuna-tpu-torch] serving {config['flow']['target']} "
          f"on {host}:{port} ({args.device})", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
