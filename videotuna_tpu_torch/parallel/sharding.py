"""Sharding of the port, the counterpart of
``videotuna_tpu/parallel/sharding.py``: parameters fully sharded over the
mesh's ``fsdp`` axis with FSDP2 (``fully_shard``), replicated over ``dp``
(an HSDP mesh when both are above 1), small parameters replicated; the
batch split over dp×fsdp; and the tensor-parallel specs of
``tensor_parallel.py``.

A spec is a tuple with one entry a tensor dimension: None, a mesh axis, or
a tuple of axes (the JAX ``PartitionSpec``'s layout, so the two compare
equal entry by entry).  In the port a tensor is already one rank's: where
the JAX package constrains a global array's layout (``constrain``), a
rank's tensor is what it is, and those calls return it unchanged.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn


class PartitionSpec(tuple):
    """One entry a tensor dimension: None, an axis name or a tuple of
    them."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def constrain(x: torch.Tensor, *spec_dims) -> torch.Tensor:
    """The JAX package pins a global array's layout here; a rank's tensor
    is already its own block, so it is returned as it is."""
    return x


def constrain_batch(x: torch.Tensor) -> torch.Tensor:
    return constrain(x, ("dp", "fsdp"))


def fsdp_spec(shape: Tuple[int, ...], fsdp_size: int,
              min_size: int = 2 ** 12) -> P:
    """The JAX package's choice for a parameter of ``shape``: the largest
    axis divisible by ``fsdp_size`` over "fsdp", replicated below
    ``min_size`` elements (norms, biases)."""
    if fsdp_size <= 1 or int(np.prod(shape)) < min_size:
        return P()
    dims = list(shape)
    for i in sorted(range(len(dims)), key=lambda i: -dims[i]):
        if dims[i] % fsdp_size == 0 and dims[i] >= fsdp_size:
            spec = [None] * len(dims)
            spec[i] = "fsdp"
            return P(*spec)
    return P()


def _fsdp_mesh(mesh):
    # above one dp replica FSDP2 takes the 2-D (replicate, shard) mesh
    if mesh.shape["dp"] > 1:
        return mesh.submesh("dp", "fsdp")
    return mesh.submesh("fsdp")


def shard_params(module: nn.Module, mesh, min_size: int = 2 ** 12
                 ) -> nn.Module:
    """FSDP over the mesh's ``fsdp`` axis (replicated over ``dp``): every
    block of a ``ModuleList`` and then the module itself go through FSDP2's
    ``fully_shard``, so a block's weights are gathered just before it runs
    and freed after.  Parameters of fewer than ``min_size`` elements stay
    whole on every rank, as the JAX package replicates them; their
    gradients are averaged by ``sync_replicated_grads``.  FSDP2 shards the
    first dimension where JAX takes the largest divisible one: the values
    are the same.  A mesh without dp or fsdp leaves the module as it is."""
    if mesh.extent("dp", "fsdp") == 1:
        return module
    from torch.distributed.fsdp import fully_shard
    dm = _fsdp_mesh(mesh)
    small = {p for p in module.parameters() if p.numel() < min_size}
    for sub in list(module.modules()):
        if isinstance(sub, nn.ModuleList):
            for block in sub:
                own = set(block.parameters())
                if own - small:
                    fully_shard(block, mesh=dm, ignored_params=own & small)
    fully_shard(module, mesh=dm, ignored_params=small)
    return module


def is_sharded(p: torch.Tensor) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(p, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local block, in place (under no_grad a view of its
    storage); any other tensor as it is."""
    return t.to_local() if is_sharded(t) else t


def full_tensor(t_local: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The whole tensor of which ``t_local`` is this rank's block, laid out
    as the DTensor ``like`` (a collective over its mesh)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t_local, like.device_mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride()).full_tensor()


def local_shard(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This rank's block of ``full`` laid out as the DTensor ``like``."""
    from torch.distributed.tensor import Shard
    dm = like.device_mesh
    for i, pl in enumerate(like.placements):
        if isinstance(pl, Shard):
            full = torch.chunk(full, dm.size(i), dim=pl.dim)[
                dm.get_local_rank(i)]
    return full.contiguous()


def all_reduce_mean(t: torch.Tensor, mesh, axes=("dp", "fsdp")
                    ) -> torch.Tensor:
    """t averaged over the ranks of ``axes``, in place."""
    for axis in axes:
        group = mesh.group(axis)
        if group is not None:
            dist.all_reduce(t, group=group)
            t.div_(mesh.shape[axis])
    return t


def sync_replicated_grads(params, mesh) -> None:
    """Average the gradients of parameters that FSDP does not manage (the
    small ones ``shard_params`` leaves whole) over the batch's ranks, as
    FSDP averages its own."""
    if mesh.extent("dp", "fsdp") == 1:
        return
    for p in params:
        if p.grad is not None and not is_sharded(p):
            all_reduce_mean(p.grad, mesh)


class BatchShard(NamedTuple):
    """Block ``index`` of ``count`` along a batch dimension."""
    index: int
    count: int


def batch_sharding(mesh) -> BatchShard:
    """The batch over (dp, fsdp): fsdp takes part in data parallelism for
    activations, as in ZeRO."""
    return BatchShard(mesh.index("dp", "fsdp"), mesh.extent("dp", "fsdp"))


def replicated(mesh) -> BatchShard:
    return BatchShard(0, 1)


def _divides(x, count: int) -> bool:
    return (count > 1 and hasattr(x, "shape") and len(x.shape) > 0
            and x.shape[0] % count == 0)


def shard_batch(batch: Dict[str, Any], mesh) -> Dict[str, Any]:
    """This rank's part of a host batch dict: each array's block of its
    first dimension over dp×fsdp, or the whole array when that dimension
    does not divide (the JAX package's ``ValueError`` branch replicates);
    values without a batch dimension as they are."""
    bs = batch_sharding(mesh)

    def place(x):
        if not _divides(x, bs.count):
            return x
        n = x.shape[0] // bs.count
        return x[bs.index * n:(bs.index + 1) * n]

    return {k: place(v) for k, v in batch.items()}


def splits_batch(batch: Dict[str, Any], mesh) -> bool:
    """Whether ``shard_batch`` gives the ranks of dp×fsdp different blocks
    of ``batch`` (False where each keeps it whole)."""
    count = batch_sharding(mesh).count
    return any(_divides(v, count) for v in batch.values())


# ---------------------------------------------------------------------------
# Tensor-parallel specs (Megatron column/row) — StepVideo-class DiTs
# ---------------------------------------------------------------------------

def tp_col_spec() -> P:
    """Column parallel: output features over tp (a flax (in, out) kernel)."""
    return P(None, "tp")


def tp_row_spec() -> P:
    """Row parallel: input features over tp."""
    return P("tp", None)


def logical_to_mesh(spec_tree: Any, mesh) -> Any:
    """Each spec of a tree → its DTensor placements on the mesh's
    ``DeviceMesh``: ``Shard(d)`` on the mesh dimension of the axis that
    names tensor dimension d, ``Replicate`` on the others."""
    from torch.distributed.tensor import Replicate, Shard
    from videotuna_tpu_torch.core.mesh import AXES

    def placements(spec):
        out = [Replicate()] * len(AXES)
        for d, names in enumerate(spec):
            for name in ((names,) if isinstance(names, str)
                         else tuple(names or ())):
                out[AXES.index(name)] = Shard(d)
        return tuple(out)

    if isinstance(spec_tree, PartitionSpec):
        return placements(spec_tree)
    if isinstance(spec_tree, dict):
        return {k: logical_to_mesh(v, mesh) for k, v in spec_tree.items()}
    return spec_tree
