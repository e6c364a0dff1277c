"""Step-level continuous batching for diffusion serving (torch), the
counterpart of ``videotuna_tpu/serving/continuous.py``.

A fixed batch of ``slots`` where every sample carries its own schedule
position: each step gathers the per-sample timestep and table entries on
the device, so requests join and leave at step boundaries while the batch
keeps its shape.  Inactive slots are kept by ``torch.where``, never
resized.  Two families: the flow-matching Euler step over
``FlowMatchSchedule.sigmas`` and DDIM with η = 0.

The slot buffers and the per-slot conditioning are inference tensors on
the flow's device: every method that creates or updates them runs under
``torch.inference_mode()``, which is local to the calling thread, as are
the attention options that ``flow._attn_scope()`` sets.  So the engine
enters both where a step runs, not where it is built.

One divergence from the JAX engine, on purpose: its step calls
``flow.denoise_apply`` outside ``flow._attn_scope()``, so an int8 flow
(whose interceptor that scope arms) fails there, and a flow with a fixed
softmax max runs the online one (the same function).  The port's step
enters the scope (ROADMAP.md queue 3).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import torch

from videotuna_tpu_torch.schedulers import DDIMSchedule, FlowMatchSchedule

Cond = Dict[str, torch.Tensor]


class ContinuousBatchEngine:
    """Fixed ``slots``-wide rolling denoise batch over a flow.

    Protocol:
      slot = engine.submit(x_T, cond, uncond)   # None if full
      engine.step()                             # one denoise step, all slots
      for slot, latents in engine.poll_completed(): ...

    ``cond`` / ``uncond`` are per-request dicts of the flow's
    ``denoise_apply`` conditioning with leading batch dim 1 (what
    ``encode_text`` returns for one prompt).
    """

    def __init__(self, flow, slots: int, frames: int, height: int,
                 width: int, cfg_scale: float = 7.5):
        self.flow = flow
        self.slots = slots
        self.cfg_scale = float(cfg_scale)
        sched = flow.scheduler
        if isinstance(sched, FlowMatchSchedule):
            self.family = "flow"
        elif isinstance(sched, DDIMSchedule):
            if float(sched.sigmas.abs().max()) != 0.0:
                raise NotImplementedError(
                    "continuous batching supports η=0 DDIM only (η>0 "
                    "needs per-slot noise streams)")
            self.family = "ddim"
        else:
            raise NotImplementedError(
                f"continuous batching: unsupported schedule "
                f"{type(sched).__name__}")
        self.n_steps = int(sched.num_steps)
        self.shape = flow.latent_shape(slots, frames, height, width)
        self.device = torch.device(flow.device)
        with torch.inference_mode():
            self.x = torch.zeros(self.shape, dtype=torch.float32,
                                 device=self.device)
            # steps COMPLETED per slot (0..n); the family maps it to a
            # table index
            self.k = torch.zeros((slots,), dtype=torch.int64,
                                 device=self.device)
            self.active = torch.zeros((slots,), dtype=torch.bool,
                                      device=self.device)
        self._k_host = [0] * slots            # python mirror, no syncs
        self._free: List[int] = list(range(slots))
        self._occupied: List[int] = []
        self._lock = threading.Lock()
        self.cond: Optional[Cond] = None      # shaped on the first submit
        self.uncond: Optional[Cond] = None

    # ------------------------------------------------------------- internals
    def _slotted(self, cond: Cond) -> Cond:
        return {k: torch.zeros((self.slots,) + tuple(v.shape[1:]),
                               dtype=v.dtype, device=self.device)
                for k, v in cond.items()}

    @staticmethod
    def _board(buf: Cond, slot: int, cond: Cond) -> None:
        for k, v in cond.items():
            buf[k][slot] = v[0]

    def _update(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One step's new (x, k) of every slot: the model at B = 2·slots
        (cond ‖ uncond), the CFG combine and the family's update, kept
        only where a slot is active."""
        sched = self.flow.scheduler
        n = self.n_steps
        kc = self.k.clamp(0, n - 1)
        i = kc if self.family == "flow" else (n - 1 - kc)
        t = sched.timesteps[i]
        if self.family == "flow":
            t = t.float()
        cc = {key: torch.cat([v, self.uncond[key]])
              for key, v in self.cond.items()}
        with self.flow._attn_scope():
            out = self.flow.denoise_apply(torch.cat([x, x]),
                                          torch.cat([t, t]), cc)
        b = x.shape[0]
        out = out[b:] + self.cfg_scale * (out[:b] - out[b:])
        bshape = (-1,) + (1,) * (x.ndim - 1)
        if self.family == "flow":
            dt = (sched.sigmas[i + 1] - sched.sigmas[i]).reshape(bshape)
            x2 = x + out * dt
        else:
            x0, eps = sched.base.to_x0_and_eps(x, t, out)
            a_prev = sched.alphas_prev[i].reshape(bshape)
            dir_xt = torch.sqrt((1.0 - a_prev).clamp_min(0.0)) * eps
            x2 = torch.sqrt(a_prev) * x0 + dir_xt        # η = 0
        keep = self.active.reshape(bshape)
        return (torch.where(keep, x2, x),
                torch.where(self.active, self.k + 1, self.k))

    # ------------------------------------------------------------------- API
    @property
    def n_active(self) -> int:
        return len(self._occupied)

    @torch.inference_mode()
    def submit(self, x_T: torch.Tensor, cond: Cond,
               uncond: Cond) -> Optional[int]:
        """Board one request (leading dim 1 everywhere); returns the slot
        id, or None when all slots are busy."""
        with self._lock:
            if not self._free:
                return None
            slot = self._free.pop(0)
            self._occupied.append(slot)
        if self.cond is None:
            self.cond, self.uncond = self._slotted(cond), self._slotted(uncond)
        self.x[slot] = x_T[0].to(self.x)
        self.k[slot] = 0
        self.active[slot] = True
        self._board(self.cond, slot, cond)
        self._board(self.uncond, slot, uncond)
        self._k_host[slot] = 0
        return slot

    @torch.inference_mode()
    def step(self) -> None:
        """One denoise step across all slots (no-op on inactive ones)."""
        if not self._occupied:
            return
        self.x, self.k = self._update(self.x)
        for s in self._occupied:
            self._k_host[s] += 1

    @torch.inference_mode()
    def poll_completed(self) -> List[Tuple[int, torch.Tensor]]:
        """[(slot, final latents (1, ...))] for slots that finished their
        n_steps; the slot is freed."""
        done = [s for s in self._occupied
                if self._k_host[s] >= self.n_steps]
        out = []
        for s in done:
            z = self.x[s:s + 1].clone()
            self.active[s] = False
            with self._lock:
                self._occupied.remove(s)
                self._free.append(s)
            out.append((s, z))
        return out

    def run_to_completion(self, max_steps: Optional[int] = None):
        """Drain every active slot; returns the completions in order."""
        results = []
        steps = 0
        while self._occupied:
            self.step()
            results.extend(self.poll_completed())
            steps += 1
            if max_steps is not None and steps > max_steps:
                raise RuntimeError("continuous engine failed to drain")
        return results
