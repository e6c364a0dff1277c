"""The device mesh of the port, the counterpart of
``videotuna_tpu/core/mesh.py``: one mesh with the named axes every kind of
parallelism reads,

- ``dp``   data parallel (the batch, parameters replicated),
- ``fsdp`` fully-sharded parameters and optimizer state (FSDP2), the batch
  split over it as well,
- ``sp``   sequence parallel (Ulysses and ring attention),
- ``tp``   tensor parallel (DTensor column/row sharding),

in that order, over the ranks of a ``torch.distributed`` process group.  A
``Mesh`` holds a ``DeviceMesh`` with those dimension names, the process
group of each axis and this rank's coordinate on each.  A mesh of one
device needs no process group and holds none: everything runs as on one
device.

Ranks above one start under ``torchrun``
(``python -m torch.distributed.run --nproc-per-node N -m videotuna_tpu_torch
<command> …``); ``initialize_distributed`` reads its ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import threading
import warnings
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

AXES = ("dp", "fsdp", "sp", "tp")

# Logical → mesh-axis rules (the JAX package's, for flax's logical
# partitioning): the batch over (dp, fsdp), the sequence over sp, heads and
# model dims over tp.
DEFAULT_RULES: Tuple[Tuple[str, Optional[Tuple[str, ...]]], ...] = (
    ("batch", ("dp", "fsdp")),
    ("seq", ("sp",)),
    ("heads", ("tp",)),
    ("embed", None),
    ("mlp", ("tp",)),
    ("kv", None),
    ("vocab", ("tp",)),
)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    dp: int = 1
    fsdp: int = 1
    sp: int = 1
    tp: int = 1

    @property
    def size(self) -> int:
        return self.dp * self.fsdp * self.sp * self.tp


class Mesh:
    """Axis sizes (``shape``, as the JAX mesh's), this rank's coordinate on
    each axis (``coords``) and, above one device, the ``DeviceMesh``
    (``device_mesh``) whose dimension groups carry the collectives.  The
    coordinates are read once, where the mesh is made, so that any thread
    of the rank (the trainer's prefetcher) can slice its batch; so are the
    groups."""

    def __init__(self, cfg: MeshConfig, device_type: str = "cuda",
                 device_mesh=None):
        self.cfg = cfg
        self.device_type = device_type
        self.device_mesh = device_mesh
        self.shape: Dict[str, int] = {a: getattr(cfg, a) for a in AXES}
        if device_mesh is None:
            self.coords = {a: 0 for a in AXES}
            self._groups = {}
        else:
            self.coords = {a: device_mesh.get_local_rank(a) for a in AXES}
            self._groups = {a: device_mesh.get_group(a) for a in AXES
                            if self.shape[a] > 1}

    @property
    def size(self) -> int:
        return self.cfg.size

    def extent(self, *axes: Optional[str]) -> int:
        """The product of the sizes of ``axes`` (None counts as 1)."""
        return math.prod(self.shape[a] for a in axes if a)

    def index(self, *axes: Optional[str]) -> int:
        """This rank's row-major coordinate over ``axes`` together, the
        index of its block when a dimension is split over them."""
        idx = 0
        for a in axes:
            if a:
                idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axis: str):
        """The process group of ``axis`` (None when its size is 1)."""
        return self._groups.get(axis)

    def submesh(self, *axes: str):
        """The ``DeviceMesh`` over ``axes`` (FSDP2's and DTensor's mesh)."""
        return self.device_mesh[axes if len(axes) > 1 else axes[0]]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, coords={self.coords})"


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_writer() -> bool:
    """Whether this process writes results: rank 0, or the only one."""
    return not dist.is_initialized() or dist.get_rank() == 0


def make_mesh(cfg: Optional[MeshConfig] = None,
              device_type: str = "cuda") -> Mesh:
    """Build the global mesh over the process group's ranks (one rank when
    no group is initialised).

    With no config, every rank goes on ``dp``.  The axis sizes must
    multiply to the world size, as the JAX package's ``make_mesh`` requires
    of the device count."""
    n = world_size()
    if cfg is None:
        cfg = MeshConfig(dp=n)
    if cfg.size != n:
        raise ValueError(
            f"Mesh axes dp×fsdp×sp×tp = {cfg.size} != device count {n}")
    if n == 1:
        return Mesh(cfg, device_type)
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh(device_type, (cfg.dp, cfg.fsdp, cfg.sp, cfg.tp),
                          mesh_dim_names=AXES)
    return Mesh(cfg, device_type, dm)


def single_device_mesh(device_type: str = "cuda") -> Mesh:
    return Mesh(MeshConfig(), device_type)


# the process's mesh (``set_mesh``), and the scoped one of ``use_mesh``,
# which is the thread's own: ranks that are threads of one process each
# enter theirs
_ACTIVE_MESH: Optional[Mesh] = None
_SCOPED = threading.local()


def get_mesh() -> Mesh:
    global _ACTIVE_MESH
    scoped = getattr(_SCOPED, "mesh", None)
    if scoped is not None:
        return scoped
    if _ACTIVE_MESH is None:
        _ACTIVE_MESH = make_mesh()
    return _ACTIVE_MESH


def set_mesh(mesh: Mesh) -> None:
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    prev = getattr(_SCOPED, "mesh", None)
    _SCOPED.mesh = mesh
    try:
        yield mesh
    finally:
        _SCOPED.mesh = prev


def build_mesh(mesh_cfg: Optional[Dict[str, int]],
               device: str = "cuda") -> Tuple[str, Mesh]:
    """A config's ``mesh`` dict ({dp, fsdp, sp, tp}; all ranks on ``dp``
    when empty) over the process group torchrun describes: (the device this
    rank computes on, the mesh)."""
    device = initialize_distributed(device)
    cfg = (MeshConfig(**{k: int(v) for k, v in mesh_cfg.items()})
           if mesh_cfg else None)
    return device, make_mesh(cfg, torch.device(device).type)


def initialize_distributed(device: str = "cuda") -> str:
    """Join the process group that ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``): NCCL
    on the card, each rank bound to ``cuda:LOCAL_RANK``, gloo for
    ``device="cpu"``.  With one process, or a group already initialised, it
    does nothing.  Returns the device this rank computes on."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or dist.is_initialized():
        return device
    if os.environ.get("PYTHONHASHSEED", "random") == "random":
        # the offline tokenizer and the dummy loader hash strings, which
        # Python salts per process
        warnings.warn("PYTHONHASHSEED is not set: each rank's offline "
                      "tokenizer and dummy videos differ; start torchrun "
                      "with PYTHONHASHSEED=0")
    rank = int(os.environ["RANK"])
    if torch.device(device).type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local)
        device = f"cuda:{local}"
        dist.init_process_group("nccl", rank=rank, world_size=world,
                                device_id=torch.device(device))
    else:
        dist.init_process_group("gloo", rank=rank, world_size=world)
    return device
