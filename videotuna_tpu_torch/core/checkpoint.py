"""Checkpoints of the port: one ``torch.save`` file per component under
``workdir/step_<n>/`` (``state.pt`` for the train state, ``lora.pt`` for a
LoRA-only delta tree), plus auto-resume discovery and pruning — the
counterpart of ``videotuna_tpu/core/checkpoint.py``.

The JAX package writes orbax directories (``step_<n>/<component>/``); the
port cannot read them, since orbax needs JAX.  Weights cross between the
packages as arrays through ``tools/from_jax.py`` instead.
"""

from __future__ import annotations

import os
import re
import shutil
from pathlib import Path
from typing import Any, Dict, Iterable, Optional, Union

import torch

STEP_RE = re.compile(r"^step_(\d+)$")


def save_components(root: str, step: int, components: Dict[str, Any],
                    keep: Optional[int] = None) -> str:
    """Save ``{name: object}`` as ``root/step_<step>/<name>.pt`` (each file
    written whole, then renamed into place); keep the newest ``keep``
    step dirs."""
    step_dir = Path(root).absolute() / f"step_{step}"
    step_dir.mkdir(parents=True, exist_ok=True)
    for name, obj in components.items():
        if obj is None:
            continue
        path = step_dir / f"{name}.pt"
        tmp = path.with_name(f".{name}.pt.tmp")
        torch.save(obj, tmp)
        os.replace(tmp, path)
    if keep:
        prune_old_steps(root, keep)
    return str(step_dir)


def restore_components(step_dir: str, names: Iterable[str],
                       map_location: Union[str, torch.device] = "cpu"
                       ) -> Dict[str, Any]:
    """{name: object} for each ``name`` saved under ``step_dir``."""
    out = {}
    for name in names:
        path = Path(step_dir) / f"{name}.pt"
        if path.is_file():
            out[name] = torch.load(path, map_location=map_location,
                                   weights_only=True)
    return out


def _steps(root: str):
    root_p = Path(root)
    if not root_p.is_dir():
        return []
    return sorted((int(m.group(1)), c) for c in root_p.iterdir()
                  if (m := STEP_RE.match(c.name)) and c.is_dir())


def latest_step_dir(root: str) -> Optional[str]:
    """The newest ``step_<n>`` dir under ``root`` (auto-resume), or None."""
    steps = _steps(root)
    return str(steps[-1][1]) if steps else None


def step_of(step_dir: str) -> int:
    m = STEP_RE.match(Path(step_dir).name)
    return int(m.group(1)) if m else 0


def prune_old_steps(root: str, keep: int) -> None:
    for _, child in _steps(root)[:-keep]:
        shutil.rmtree(child, ignore_errors=True)
