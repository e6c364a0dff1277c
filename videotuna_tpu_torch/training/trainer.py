"""Training loop of the port, the counterpart of
``videotuna_tpu/training/trainer.py``: the optimizer chain, the train step,
EMA, gradient accumulation and clipping, checkpoint-every-N and resume.

Where the JAX package jits one pure ``train_step(state, frozen, batch,
key)``, the port runs eagerly: the flow's modules hold the weights, autograd
takes the gradients, and the optimizer updates dicts of f32 tensors in
place.

- Trainable weights are f32, the model computes in bf16 (flax's
  ``param_dtype`` f32 / ``dtype`` bf16 split).  A full fine-tune keeps an f32
  master copy of every trainable weight, copies it into the module before
  each step and casts the module's gradients to f32 for the optimizer, so a
  small update does not vanish under bf16 rounding.  LoRA deltas are f32
  leaves used by the side branch directly; base weights are frozen.
- The optimizer is optax's chain written out: ``clip_by_global_norm`` (scale
  by max/‖g‖ only when ‖g‖ ≥ max), AdamW (decoupled decay), the learning
  rate from ``warmup_cosine_decay_schedule(0, lr, warmup, max_steps)``
  evaluated at the update count (0 for the first update), and
  ``MultiSteps`` accumulation (a running mean of the micro-batch gradients,
  one update every N).
- Each step draws its noise from the generator of (seed, "train_step",
  step index), and ``fit`` places an ``EpochLoader`` where the resumed step
  left it, so a run resumed from a checkpoint takes the steps an unbroken
  run takes (the JAX loop draws its keys from a counter and restarts the
  epoch on resume).  The host-side augmentation draws (``random``) are not
  part of the checkpoint, as in the JAX package.
- ``fit`` prepares the batches (host pipeline, caption encode, copy to the
  device) in a ``DevicePrefetcher`` thread, on the step's CUDA stream, as
  the JAX trainer does; the losses are those of the plain loop.
- On a mesh (``core/mesh.py``) the trainable components go through FSDP2
  over the ``fsdp`` axis (``parallel/sharding.py``: replicated over ``dp``,
  small parameters whole on every rank), each rank takes its block of the
  batch over dp×fsdp and draws its own noise, and the f32 masters, the
  optimizer's moments and the EMA are each rank's blocks of the sharded
  weights; the global gradient norm sums the blocks over the ``fsdp``
  group, and the metrics are averaged over the batch's ranks.  ``fit``
  routes long self-attention through ``sequence_parallel`` when ``sp`` is
  above 1.  Rank 0 writes the whole state, and every rank reads it back and
  keeps its blocks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import os
import signal
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from videotuna_tpu_torch.core import checkpoint as ckpt_lib
from videotuna_tpu_torch.core.mesh import (Mesh, is_writer,
                                           single_device_mesh, use_mesh)
from videotuna_tpu_torch.core.prng import KeyChain
from videotuna_tpu_torch.data.prefetch import DevicePrefetcher, to_device
from videotuna_tpu_torch.parallel import sharding
from videotuna_tpu_torch.training.lora import (count_lora_params,
                                               default_match, flatten_tree,
                                               init_lora, lora_scope,
                                               lora_target)

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """The trainable tensors (flat names: "<component>/<param>" for a full
    fine-tune, "<component>/<flax path>/a|b" for LoRA), the optimizer's
    state and the EMA shadows."""
    step: int
    params: Params
    opt_state: Dict[str, Any]
    ema_params: Optional[Params] = None

    def state_dict(self) -> Dict[str, Any]:
        """The state's tensors, where they are (``Trainer.save`` gathers a
        sharded state whole and copies it to the host)."""
        return {"step": self.step, "params": self.params,
                "opt_state": self.opt_state, "ema_params": self.ema_params}

    @torch.no_grad()
    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Copy a saved state into this one's tensors, in place (the LoRA
        side branch and the optimizer keep referring to them)."""
        self.step = int(sd["step"])
        _copy_into(self.params, sd["params"])
        self.opt_state = _copy_into(self.opt_state, sd["opt_state"])
        if self.ema_params is not None and sd.get("ema_params") is not None:
            _copy_into(self.ema_params, sd["ema_params"])


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().clone()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    return obj


def _copy_into(dst, src):
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
        return dst
    if isinstance(dst, dict):
        if set(dst) != set(src):
            raise KeyError(f"checkpoint keys {sorted(src)[:4]}… do not match "
                           f"the state's {sorted(dst)[:4]}…")
        for k in dst:
            dst[k] = _copy_into(dst[k], src[k])
        return dst
    return src


@dataclasses.dataclass
class TrainConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 1e-2
    beta1: float = 0.9
    beta2: float = 0.999
    grad_clip: float = 1.0
    warmup_steps: int = 0
    max_steps: int = 1000
    ema_decay: Optional[float] = None        # e.g. 0.9999; None disables
    accumulate_grad_batches: int = 1
    optimizer: str = "adamw"                 # adamw (adafactor not ported)
    scale_lr_by_devices: bool = False
    log_every: int = 10
    ckpt_every: int = 500
    ckpt_keep: int = 3
    # {"rank": N, "alpha": a, "targets": [substr…]}: train low-rank deltas
    # of the trainable components; base weights stay frozen
    lora: Optional[Dict[str, Any]] = None


# ---------------------------------------------------------------- optimizer
def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """optax's: linear from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then cosine decay to ``end_value`` at
    ``decay_steps`` (which counts the warmup)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError("the cosine decay needs decay_steps > warmup_steps")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - max(count, 0) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cos_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / cos_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def global_norm(tensors: Dict[str, torch.Tensor]) -> torch.Tensor:
    """‖g‖ over every tensor, in f32."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors.values()))


class Optimizer:
    """optax's ``chain(clip_by_global_norm(max_norm), adamw(schedule, b1,
    b2, eps, weight_decay))``, inside ``MultiSteps(every_k)`` when
    ``every_k`` > 1, on dicts of f32 tensors.  ``init(params)`` → state;
    ``update(grads, state, params)`` → (updates, state), the state's
    tensors updated in place; ``apply_updates`` adds the updates."""

    def __init__(self, schedule: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4, max_norm: float = 1.0,
                 every_k: int = 1,
                 norm: Callable[[Params], torch.Tensor] = global_norm):
        self.schedule = schedule
        # ‖g‖ of a gradient dict; a sharded trainer sums its blocks over
        # the ranks
        self.global_norm = norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_norm = max_norm
        self.every_k = every_k

    def init(self, params: Params) -> Dict[str, Any]:
        state: Dict[str, Any] = {
            "count": 0,
            "mu": {k: torch.zeros_like(p) for k, p in params.items()},
            "nu": {k: torch.zeros_like(p) for k, p in params.items()}}
        if self.every_k > 1:
            state.update(mini_step=0, gradient_step=0,
                         acc={k: torch.zeros_like(p)
                              for k, p in params.items()})
        return state

    @torch.no_grad()
    def update(self, grads: Params, state: Dict[str, Any], params: Params
               ) -> Tuple[Params, Dict[str, Any]]:
        if self.every_k == 1:
            return self._adamw(grads, state, params), state
        n = state["mini_step"]
        for k, acc in state["acc"].items():   # Welford running mean
            acc.add_((grads[k] - acc) / (n + 1))
        if n < self.every_k - 1:
            state["mini_step"] = n + 1
            return {k: torch.zeros_like(p) for k, p in params.items()}, state
        updates = self._adamw(state["acc"], state, params)
        state["mini_step"] = 0
        state["gradient_step"] += 1
        for acc in state["acc"].values():
            acc.zero_()
        return updates, state

    def applied(self, state: Dict[str, Any]) -> bool:
        """Whether the last ``update`` changed the parameters."""
        return state.get("mini_step", 0) == 0

    def _adamw(self, grads: Params, state: Dict[str, Any],
               params: Params) -> Params:
        g_norm = self.global_norm(grads)
        clip = not bool(g_norm < self.max_norm)
        lr = self.schedule(state["count"])
        state["count"] += 1
        c = state["count"]
        bc1 = 1.0 - self.b1 ** c
        bc2 = 1.0 - self.b2 ** c
        updates = {}
        for k, g in grads.items():
            g = g.float()
            if clip:
                g = g / g_norm * self.max_norm
            mu, nu = state["mu"][k], state["nu"][k]
            mu.mul_(self.b1).add_((1.0 - self.b1) * g)
            nu.mul_(self.b2).add_((1.0 - self.b2) * (g * g))
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * params[k]
            updates[k] = u * -lr
        return updates


@torch.no_grad()
def apply_updates(params: Params, updates: Params) -> None:
    for k, u in updates.items():
        params[k].add_(u)


def make_optimizer(cfg: TrainConfig, num_devices: int = 1,
                   norm: Callable[[Params], torch.Tensor] = global_norm
                   ) -> Optimizer:
    if cfg.optimizer != "adamw":
        raise NotImplementedError(
            f"optimizer {cfg.optimizer!r} is not ported: the port has AdamW "
            "(adafactor waits in ROADMAP.md queue 1, item 9)")
    lr = cfg.learning_rate * (num_devices if cfg.scale_lr_by_devices else 1)
    if cfg.warmup_steps > 0:
        schedule = warmup_cosine_decay_schedule(
            0.0, lr, cfg.warmup_steps,
            max(cfg.max_steps, cfg.warmup_steps + 1))
    else:
        def schedule(count: int, lr=lr) -> float:
            return lr
    return Optimizer(schedule, b1=cfg.beta1, b2=cfg.beta2,
                     weight_decay=cfg.weight_decay, max_norm=cfg.grad_clip,
                     every_k=max(int(cfg.accumulate_grad_batches), 1),
                     norm=norm)


# ---------------------------------------------------------------- train step
LossFn = Callable[[Dict[str, Any], torch.Generator],
                  Tuple[torch.Tensor, Dict[str, Any]]]


def _leaf_grads(params: Params) -> Params:
    grads = {}
    for k, p in params.items():
        grads[k] = (p.grad if p.grad is not None
                    else torch.zeros_like(p)).float()
        p.grad = None
    return grads


def make_train_step(loss_fn: LossFn, optimizer: Optimizer,
                    ema_decay: Optional[float] = None,
                    bind: Optional[Callable[[Params], None]] = None,
                    grads_of: Optional[Callable[[Params], Params]] = None,
                    loss_ctx: Optional[Callable] = None) -> Callable:
    """The train step ``(state, batch, generator) → (state, metrics)``.

    ``bind(params)`` puts the trainable tensors where the loss reads them
    (a full fine-tune copies its f32 masters into the module), and
    ``grads_of(params)`` returns their f32 gradients (by default the
    leaves' own ``.grad``).  ``loss_ctx`` is a context-manager factory held
    open over the forward and the backward, which recomputes blocks under
    ``remat``.  EMA moves only when the optimizer applied an update (at
    the end of an accumulation)."""
    grads_of = grads_of or _leaf_grads

    def step(state: TrainState, batch: Dict[str, Any],
             generator: torch.Generator) -> Tuple[TrainState, Dict[str, Any]]:
        if bind is not None:
            bind(state.params)
        with (loss_ctx() if loss_ctx is not None
              else contextlib.nullcontext()):
            loss, aux = loss_fn(batch, generator)
            loss.backward()
        grads = grads_of(state.params)
        with torch.no_grad():
            gnorm = optimizer.global_norm(grads)
            updates, state.opt_state = optimizer.update(
                grads, state.opt_state, state.params)
            apply_updates(state.params, updates)
            if ema_decay is not None and state.ema_params is not None \
                    and optimizer.applied(state.opt_state):
                for k, e in state.ema_params.items():
                    e.mul_(ema_decay).add_((1 - ema_decay) * state.params[k])
        state.step += 1
        metrics = {**{k: v.detach() for k, v in aux.items()},
                   "loss": loss.detach(), "grad_norm": gnorm}
        return state, metrics

    return step


class Trainer:
    """Host-side loop: data, the train step, logging, checkpoints, signals,
    resume."""

    def __init__(self, flow, cfg: TrainConfig, workdir: str = "logs/run",
                 seed: int = 42, mesh: Optional[Mesh] = None):
        self.flow = flow
        self.cfg = cfg
        self.mesh = mesh or single_device_mesh(torch.device(flow.device).type)
        self.workdir = workdir
        self.keys = KeyChain(seed, flow.device)
        self.optimizer = make_optimizer(cfg, self.mesh.size,
                                        norm=self._global_norm)
        self.lora: Optional[Dict[str, Any]] = None
        self._trainable: Dict[str, torch.nn.Parameter] = {}
        # the trainable weights FSDP shards: the state holds this rank's
        # block of each
        self._sharded: Dict[str, torch.Tensor] = {}
        self._batch = sharding.batch_sharding(self.mesh)
        self.callbacks: list = []     # callables (step, metrics, state)
        self._step_fn = None
        self._want_ckpt = False
        self.metrics_history: list = []

    @property
    def lora_alpha(self) -> float:
        return float((self.cfg.lora or {}).get("alpha", 1.0))

    # ------------------------------------------------------------- state
    def init_state(self) -> TrainState:
        comps = self.flow.components()
        for module in comps.values():
            module.requires_grad_(False)
        trainable = [c for c in self.flow.trainable_components if c in comps]
        for c in trainable:   # a LoRA run's frozen base is sharded too
            sharding.shard_params(comps[c], self.mesh)
        if self.cfg.lora:
            lcfg = dict(self.cfg.lora)
            targets = lcfg.get("targets")
            match = lora_target(*targets) if targets else default_match
            self.lora = {c: init_lora(comps[c], rank=int(lcfg.get("rank", 16)),
                                      match=match,
                                      generator=self.keys("lora_init"))
                         for c in trainable}
            params = flatten_tree(self.lora)
        else:
            self._trainable = {f"{c}/{n}": p for c in trainable
                               for n, p in comps[c].named_parameters()}
            for p in self._trainable.values():
                p.requires_grad_(True)
            self._sharded = {k: p for k, p in self._trainable.items()
                             if sharding.is_sharded(p)}
            params = {k: sharding.local(p).detach().float().clone()
                      for k, p in self._trainable.items()}
        ema = ({k: v.detach().clone() for k, v in params.items()}
               if self.cfg.ema_decay else None)
        return TrainState(step=0, params=params,
                          opt_state=self.optimizer.init(params),
                          ema_params=ema)

    def num_trainable(self, state: TrainState) -> int:
        if self.lora is not None:
            return sum(count_lora_params(t) for t in self.lora.values())
        return sum(p.numel() for p in state.params.values())

    def maybe_resume(self, state: TrainState) -> TrainState:
        step_dir = ckpt_lib.latest_step_dir(self.workdir)
        if step_dir is None:
            return state
        saved = ckpt_lib.restore_components(step_dir, ["state"],
                                            map_location=self.flow.device)
        if "state" in saved:
            state.load_state_dict(self._map_sharded(
                saved["state"], sharding.local_shard))
        return state

    # ------------------------------------------------------- sharded state
    def _map_sharded(self, tree, fn):
        """``tree`` with fn(tensor, the sharded weight) applied to each
        tensor under the name of a weight FSDP shards (the masters, the
        moments, the EMA)."""
        if not self._sharded or not isinstance(tree, dict):
            return tree
        return {k: (fn(v, self._sharded[k])
                    if k in self._sharded and isinstance(v, torch.Tensor)
                    else self._map_sharded(v, fn))
                for k, v in tree.items()}

    def _global_norm(self, grads: Params) -> torch.Tensor:
        """‖g‖ over the whole weights: the blocks' squares summed over the
        ``fsdp`` group (dp replicas hold the same blocks)."""
        if not self._sharded:
            return global_norm(grads)
        sq = [(g.float() ** 2).sum() for k, g in grads.items()
              if k in self._sharded]
        whole = [(g.float() ** 2).sum() for k, g in grads.items()
                 if k not in self._sharded]
        blocks = torch.stack(sq).sum()
        group = self.mesh.group("fsdp")
        if group is not None:
            torch.distributed.all_reduce(blocks, group=group)
        return torch.sqrt(blocks + (torch.stack(whole).sum() if whole
                                    else 0.0))

    def _mean_over_batch(self, metrics: Dict[str, Any]) -> Dict[str, Any]:
        """Each scalar metric averaged over the ranks that split the batch
        (the loss of the whole batch, as the JAX step reports it)."""
        if self._batch.count == 1:
            return metrics
        return {k: (sharding.all_reduce_mean(v.detach().float().clone(),
                                             self.mesh)
                    if isinstance(v, torch.Tensor) and v.ndim == 0
                    and k != "grad_norm" else v)
                for k, v in metrics.items()}

    # ----------------------------------------------------------- running
    @torch.no_grad()
    def _bind(self, params: Params) -> None:
        """Copy the f32 masters into the module (full fine-tune): into
        this rank's block of a sharded weight."""
        for k, p in self._trainable.items():
            sharding.local(p).copy_(params[k])

    def _module_grads(self, params: Params) -> Params:
        """The f32 gradients of the module's weights (this rank's block of
        a sharded one, which FSDP averaged over the batch's ranks; a whole
        one averaged here)."""
        sharding.sync_replicated_grads(self._trainable.values(), self.mesh)
        grads = {}
        for k, p in self._trainable.items():
            grads[k] = (sharding.local(p.grad) if p.grad is not None
                        else torch.zeros_like(params[k])).float()
            p.grad = None
        return grads

    def _lora_grads(self, params: Params) -> Params:
        """The LoRA leaves' gradients, averaged over the batch's ranks."""
        grads = {}
        for k, p in params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            grads[k] = sharding.all_reduce_mean(g.float(), self.mesh)
            p.grad = None
        return grads

    def loss_scope(self) -> contextlib.ExitStack:
        """The scopes the loss runs in: the LoRA side branches and, for a
        qk-normed flow, the fixed-max attention softmax (whose LSE is the
        true one, so gradients are unchanged)."""
        stack = contextlib.ExitStack()
        if self.lora is not None:
            comps = self.flow.components()
            for c, tree in self.lora.items():
                stack.enter_context(lora_scope(comps[c], tree,
                                               self.lora_alpha))
        if getattr(self.flow, "attn_static_max", None) is not None:
            stack.enter_context(self.flow._attn_scope())
        return stack

    def compiled_step(self) -> Callable:
        if self._step_fn is None:
            full = self.lora is None
            step = make_train_step(
                self.flow.training_loss, self.optimizer, self.cfg.ema_decay,
                bind=self._bind if full else None,
                grads_of=(self._module_grads if full
                          else self._lora_grads if self._batch.count > 1
                          else None),
                loss_ctx=self.loss_scope)

            def step_fn(state, batch, generator):
                state, metrics = step(state, batch, generator)
                return state, self._mean_over_batch(metrics)
            self._step_fn = step_fn
        return self._step_fn

    def _train_stream(self, split: bool) -> str:
        """The noise stream of the step: a rank's own where the ranks split
        the batch (each draws for its samples), the same one where they
        hold the same samples (sp and tp ranks, and every rank when the
        batch does not divide over dp×fsdp and ``shard_batch`` replicated
        it: one draw, as on one device)."""
        if not split:
            return "train_step"
        return f"train_step/{self._batch.index}"

    @contextlib.contextmanager
    def signal_checkpoint(self):
        """SIGUSR1 → checkpoint at the next step boundary, inside the
        block.  The previous handler comes back after it: a handler left
        installed would keep this trainer, and its flow's weights on the
        device, alive after ``fit`` returns."""
        def handler(signum, frame):
            self._want_ckpt = True
        try:
            prev = signal.signal(signal.SIGUSR1, handler)
        except ValueError:   # not the main thread
            yield
            return
        try:
            yield
        finally:
            signal.signal(signal.SIGUSR1,
                          signal.SIG_DFL if prev is None else prev)

    def fit(self, loader, state: Optional[TrainState] = None,
            max_steps: Optional[int] = None, val_loader=None,
            val_every: int = 0) -> TrainState:
        state = state if state is not None else self.init_state()
        state = self.maybe_resume(state)
        step_fn = self.compiled_step()
        with self.mesh_scope():
            return self._fit(state, loader, step_fn, max_steps, val_loader,
                             val_every)

    def mesh_scope(self, **sp_options) -> contextlib.ExitStack:
        """The scopes a step runs in: ``use_mesh`` and, when ``sp`` is
        above 1, ``sequence_parallel`` (long self-attention through Ulysses
        SP in the forward and the backward; ``sp_options`` such as
        ``min_seq`` go to it).  Its batch axes are none: unlike the JAX
        package's global batch, a rank's batch is already its block over
        dp×fsdp, which the sp ranks of the block share."""
        scopes = contextlib.ExitStack()
        scopes.enter_context(use_mesh(self.mesh))
        if self.mesh.shape["sp"] > 1:
            from videotuna_tpu_torch.kernels.attention import \
                sequence_parallel
            scopes.enter_context(sequence_parallel(
                self.mesh, batch_axes=(), **sp_options))
        return scopes

    def _fit(self, state, loader, step_fn, max_steps, val_loader,
             val_every) -> TrainState:
        with self.signal_checkpoint():
            max_steps = max_steps or self.cfg.max_steps
            done = state.step
            if done and hasattr(loader, "resume_at"):
                loader.resume_at(done)
            t_last = time.perf_counter()
            while done < max_steps:
                epoch_start = done
                # only the batches the remaining steps take, so the host's
                # draws (augmentation, dummy clips) are those of the plain
                # loop and a resumed run continues them
                batches = DevicePrefetcher(
                    itertools.islice(loader, max_steps - done),
                    self.flow.device, prepare=self.prepare_batch,
                    mesh=self.mesh)
                for batch in batches:
                    state, metrics = step_fn(
                        state, batch,
                        self.keys.fixed(self._train_stream(batches.split),
                                        done))
                    done += 1
                    if done % self.cfg.log_every == 0:
                        m = {k: float(v) for k, v in metrics.items()}
                        m["step"] = done
                        m["steps_per_sec"] = self.cfg.log_every / (
                            time.perf_counter() - t_last)
                        t_last = time.perf_counter()
                        self.metrics_history.append(m)
                        for cb in self.callbacks:
                            cb(done, m, state)
                    if self._want_ckpt or done % self.cfg.ckpt_every == 0:
                        self.save(state, done)
                        self._want_ckpt = False
                    if val_loader is not None and val_every \
                            and done % val_every == 0:
                        vm = self.validate(state, val_loader)
                        vm["step"] = done
                        self.metrics_history.append(vm)
                    if done >= max_steps:
                        break
                if done == epoch_start:
                    raise RuntimeError(
                        f"data loader yielded no batches at step {done}; "
                        "pass a re-iterable dataset/loader (not an exhausted "
                        f"generator) to reach max_steps={max_steps}")
            self.save(state, done)
        return state

    @torch.no_grad()
    def validate(self, state: TrainState, val_loader,
                 max_batches: int = 8) -> Dict[str, float]:
        """Mean loss over the validation loader with the current weights;
        no gradients, no state change."""
        if self.lora is None:
            self._bind(state.params)
        losses = []
        with self.loss_scope():
            for i, batch in enumerate(val_loader):
                if i >= max_batches:
                    break
                batch = to_device(sharding.shard_batch(
                    self.prepare_batch(batch), self.mesh), self.flow.device)
                loss, _ = self.flow.training_loss(batch, self.keys("val_step"))
                losses.append(float(self._mean_over_batch(
                    {"loss": loss})["loss"]))
        return {"val_loss": sum(losses) / max(len(losses), 1),
                "val_batches": float(len(losses))}

    def prepare_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """Host batch → model batch: captions encoded by the frozen text
        encoder (on the flow's device), the other arrays left where they are
        for the caller's copy (``DevicePrefetcher`` in ``fit``)."""
        out = dict(batch)
        if "caption" in out and "text_states" not in out:
            cond = self.flow.encode_text(out.pop("caption"))
            out["text_states"] = cond["y"]
            if cond.get("mask") is not None:
                out["text_mask"] = cond["mask"]
            if cond.get("pooled") is not None:
                out["pooled_text"] = cond["pooled"]
        out.pop("path", None)
        out.pop("is_image", None)
        return out

    def save(self, state: TrainState, step: int) -> str:
        """``state.pt`` (and, for LoRA, ``lora.pt``, the delta tree that
        ``cli/inference.py --lora`` merges) under ``workdir/step_<step>``.
        A full fine-tune's module then holds the trained weights, as the
        JAX flow's params do; a LoRA run keeps its base weights, which the
        side branch reads.  On a mesh the sharded tensors are gathered
        whole, and rank 0 alone writes."""
        whole = self._map_sharded(state.state_dict(), sharding.full_tensor)
        step_dir = os.path.join(os.path.abspath(self.workdir),
                                f"step_{step}")
        if is_writer():
            comps: Dict[str, Any] = {"state": _to_cpu(whole)}
            if self.lora is not None:
                comps["lora"] = _to_cpu(self.lora)
            step_dir = ckpt_lib.save_components(self.workdir, step, comps,
                                                keep=self.cfg.ckpt_keep)
        if torch.distributed.is_initialized():
            torch.distributed.barrier()
        if self.lora is None:
            self._bind(state.params)
        return step_dir
