"""Ranks of a ``torch.distributed`` process group for the port's parallel
tests and for ``chip_smoke.py``: threads of this process over a threaded
group (``run_threaded``: every rank on the same device, the one card or the
CPU), or separate processes over gloo (``run_processes``: each process
joins through the port's ``initialize_distributed`` from the variables
``torchrun`` sets).

The threaded group is the one torch ships for its own tests
(``torch.testing._internal.distributed.multi_threaded_pg``): all-to-all,
all-gather, all-reduce, reduce-scatter and broadcast, no point-to-point,
which the port's ring does not need.  Its collectives run on the rank 0
thread, on that thread's current stream; the world is made thread-local and
autograd runs each backward on the thread that called it, so a rank's
backward issues its own collectives.  On the card the ranks' tensors come
from their own streams (FSDP2's copy-in and all-gather streams), so there
every collective of the group (backend "threaded_synced") synchronises the
device before and after it.
"""

from __future__ import annotations

import os
import socket
import tempfile
import threading
import time
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist


_SYNCED = None


def _synced_backend() -> str:
    """Register (once) the threaded group whose every collective
    synchronises the device before and after it; returns its name."""
    global _SYNCED
    if _SYNCED is None:
        from torch.testing._internal.distributed import \
            multi_threaded_pg as mtp

        def synced(fn):
            def collective(self, *a, **kw):
                torch.cuda.synchronize()
                work = fn(self, *a, **kw)
                torch.cuda.synchronize()
                return work
            return collective

        skip = {"size", "getBackendName", "pg_name", "group_name"}
        methods = {name: synced(fn)
                   for name, fn in vars(mtp.ProcessLocalGroup).items()
                   if callable(fn) and not name.startswith("__")
                   and not isinstance(fn, (classmethod, staticmethod))
                   and not name.startswith("_") and name not in skip}
        group_cls = type("SyncedThreadedGroup", (mtp.ProcessLocalGroup,),
                         methods)

        def create(prefix_store, rank, world_size, timeout):
            pg = group_cls(rank, world_size)
            dist.distributed_c10d._store_based_barrier(
                rank, prefix_store, "", world_size, timeout)
            return pg

        dist.Backend.register_backend("threaded_synced", create,
                                      devices=["cpu", "cuda"])
        _SYNCED = "threaded_synced"
    return _SYNCED


def run_threaded(world: int, fn: Callable[..., Any], *args,
                 timeout: float = 600.0) -> List[Any]:
    """fn(rank, *args) on ``world`` threads, each rank ``rank`` of a
    threaded process group of ``world`` ranks (the default group of its
    thread).  Returns the ranks' results; the first rank's exception is
    raised, the others stopped."""
    from torch.testing._internal.distributed import multi_threaded_pg as mtp
    mtp.ProcessLocalGroup.reset()
    if not hasattr(mtp.ThreadLocalWorld, "comms"):
        # torch 2.11's thread-local world lacks the list of communicators
        # that its destroy_process_group reads
        mtp.ThreadLocalWorld.comms = property(lambda self: [])
    mtp._install_threaded_pg()
    torch._C._distributed_c10d._set_thread_isolation_mode(True)
    store = dist.HashStore()
    results: List[Any] = [None] * world
    errors: List[BaseException] = []
    device = torch.cuda.current_device() if torch.cuda.is_available() \
        else None
    backend = "threaded" if device is None else _synced_backend()

    def worker(rank: int) -> None:
        try:
            if device is not None:
                torch.cuda.set_device(device)
            dist.init_process_group(backend, rank=rank, world_size=world,
                                    store=store)
            try:
                results[rank] = fn(rank, *args)
            finally:
                dist.destroy_process_group()
        except BaseException as e:   # noqa: BLE001 — to the caller
            if not isinstance(e, SystemExit):
                errors.append(e)
            mtp.ProcessLocalGroup.exception_handle(e)

    threads = [threading.Thread(target=worker, args=(r,), daemon=True,
                                name=f"rank{r}") for r in range(world)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout)
        if any(t.is_alive() for t in threads):
            mtp.ProcessLocalGroup.exception_handle(TimeoutError())
            raise TimeoutError(f"{world} threaded ranks did not finish in "
                               f"{timeout} s")
    finally:
        torch._C._distributed_c10d._set_thread_isolation_mode(False)
        mtp._uninstall_threaded_pg()
    if errors:
        raise errors[0]
    return results


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _process(rank: int, world: int, port: int, out_dir: str,
             fn: Callable[..., Any], args) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    from videotuna_tpu_torch.core.mesh import initialize_distributed
    initialize_distributed("cpu")
    try:
        torch.save(fn(rank, *args), os.path.join(out_dir, f"{rank}.pt"))
    finally:
        if dist.is_initialized():   # one process joins no group
            dist.destroy_process_group()


def run_processes(world: int, fn: Callable[..., Any], *args,
                  timeout: float = 300.0) -> List[Any]:
    """fn(rank, *args) in ``world`` spawned processes over gloo on the CPU,
    as ``torchrun`` would start them (each with this process's
    environment); fn must be importable and its result picklable by
    ``torch.save``."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.start_processes(_process, nprocs=world, join=False,
                                 start_method="spawn",
                                 args=(world, _free_port(), out_dir, fn,
                                       args))
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(max(deadline - time.monotonic(), 0.1)):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} processes did not finish "
                                       f"in {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        return [torch.load(os.path.join(out_dir, f"{r}.pt"),
                           weights_only=False) for r in range(world)]


def sp_attention_rank(rank: int, mesh_axes: dict, ulysses_axis, ring_axis,
                      q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      batch_axes=("dp", "fsdp"), device: str = "cpu"):
    """One rank of ``sp_attention`` over a mesh of ``mesh_axes`` on the
    global q, k, v: (the output, and the gradients of q, k, v of
    Σ out²)."""
    from videotuna_tpu_torch.core.mesh import MeshConfig, make_mesh
    from videotuna_tpu_torch.parallel.sequence import sp_attention
    mesh = make_mesh(MeshConfig(**mesh_axes), device)
    q, k, v = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out = sp_attention(mesh, q, k, v, ulysses_axis=ulysses_axis,
                       ring_axis=ring_axis, batch_axes=batch_axes)
    (out.float() ** 2).sum().backward()
    return out.detach(), q.grad, k.grad, v.grad


def train_step_rank(rank: int, mesh_axes: dict, flows, batch: dict,
                    draws: dict, workdir: str, device: str = "cpu",
                    min_seq: Optional[int] = None):
    """One rank's training step of ``flows[rank]`` (each rank its own copy
    of one flow) on a mesh of ``mesh_axes`` through the port's
    ``Trainer``: this rank's block of ``batch`` and of the explicit draws
    (σ, noise), inside the trainer's ``mesh_scope`` (``sequence_parallel``
    when sp is above 1, at ``min_seq`` when it is given).  Returns (the
    loss averaged over the batch's ranks, the gradient norm, {name: whole
    gradient} gathered from the ranks' blocks, the number of sharded
    weights)."""
    import functools
    from videotuna_tpu_torch.core.mesh import MeshConfig, make_mesh
    from videotuna_tpu_torch.parallel import sharding
    from videotuna_tpu_torch.training.trainer import TrainConfig, Trainer
    mesh = make_mesh(MeshConfig(**mesh_axes), torch.device(device).type)
    flow = flows[rank]
    trainer = Trainer(flow, TrainConfig(learning_rate=1e-3),
                      workdir=workdir, mesh=mesh)
    state = trainer.init_state()
    flow.training_loss = functools.partial(
        type(flow).training_loss, flow,
        **{k: torch.as_tensor(v).to(device)
           for k, v in sharding.shard_batch(draws, mesh).items()})
    seen = {}
    update = trainer.optimizer.update

    def spy(grads, opt_state, params):   # the gradients the optimizer gets
        seen.update(grads)
        return update(grads, opt_state, params)

    trainer.optimizer.update = spy
    step = trainer.compiled_step()
    local = {k: torch.as_tensor(v).to(device)
             for k, v in sharding.shard_batch(batch, mesh).items()}
    with trainer.mesh_scope(**({"min_seq": min_seq} if min_seq else {})):
        state, metrics = step(state, local, None)
    whole = {k: (sharding.full_tensor(g, trainer._sharded[k])
                 if k in trainer._sharded else g).cpu()
             for k, g in seen.items()}
    return (float(metrics["loss"]), float(metrics["grad_norm"]), whole,
            len(trainer._sharded))
