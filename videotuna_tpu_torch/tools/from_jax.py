"""Carry weights across from the JAX package: a flax parameter tree, as
nested dicts of numpy arrays (``jax.device_get(flow.params)``), is copied
into the port's modules in place.  This module imports neither jax nor the
JAX package; it reads plain arrays.

The port's modules carry the flax names, so the walk is by name.  What
changes is the layout of each leaf:

- ``Dense`` kernel (in, out) → ``Linear`` weight (out, in);
- ``DenseGeneral`` kernel (in, H, D) → ``Linear`` weight (H·D, in);
- ``Conv`` kernel (…spatial, I, O) → (O, I, …spatial);
- LayerNorm / GroupNorm / RMSNorm ``scale`` → ``weight``;
- ``Embed.embedding`` → ``Embedding.weight``;
- ``block_{i}`` → ``blocks[i]``, and the ``scan_blocks`` layout (every
  block leaf stacked on axis 0 under ``blocks``) is unstacked.

The copy is strict: a flax leaf with no counterpart, a shape mismatch, or a
module parameter left unassigned raises.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Set

import numpy as np
import torch
from torch import nn

from videotuna_tpu_torch.models.layers import LayerNorm, RMSNorm

_NORMS = (nn.LayerNorm, nn.GroupNorm, LayerNorm, RMSNorm)
_BLOCK = re.compile(r"^block_(\d+)$")


def _copy(param: torch.Tensor, arr: np.ndarray, where: str,
          done: Set[int]) -> None:
    value = torch.as_tensor(np.asarray(arr))
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(f"{where}: JAX shape {tuple(value.shape)} does not "
                         f"map onto {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(value.to(param.dtype))
    done.add(id(param))


def _load_leaf_module(m: nn.Module, tree: Mapping[str, Any], where: str,
                      done: Set[int]) -> None:
    for key, arr in tree.items():
        arr = np.asarray(arr)
        name = f"{where}.{key}"
        if isinstance(m, nn.Linear) and key == "kernel":
            _copy(m.weight, arr.reshape(arr.shape[0], -1).T, name, done)
        elif isinstance(m, (nn.Linear, nn.Conv2d, nn.Conv3d)) \
                and key == "bias":
            _copy(m.bias, arr.reshape(-1), name, done)
        elif isinstance(m, (nn.Conv2d, nn.Conv3d)) and key == "kernel":
            nd = arr.ndim
            _copy(m.weight, arr.transpose(nd - 1, nd - 2, *range(nd - 2)),
                  name, done)
        elif isinstance(m, _NORMS) and key in ("scale", "bias"):
            _copy(m.weight if key == "scale" else m.bias, arr, name, done)
        elif isinstance(m, nn.Embedding) and key == "embedding":
            _copy(m.weight, arr, name, done)
        else:
            raise KeyError(f"{name}: no counterpart in {type(m).__name__}")


def _child(module: nn.Module, key: str, where: str) -> nn.Module:
    if hasattr(module, key):
        return getattr(module, key)
    match = _BLOCK.match(key)
    if match and isinstance(getattr(module, "blocks", None), nn.ModuleList):
        return module.blocks[int(match.group(1))]
    raise KeyError(f"{where}.{key}: no counterpart in "
                   f"{type(module).__name__}")


def _load(module: nn.Module, tree: Mapping[str, Any], where: str,
          done: Set[int]) -> None:
    if isinstance(module, (nn.Linear, nn.Conv2d, nn.Conv3d, nn.Embedding)
                  + _NORMS):
        _load_leaf_module(module, tree, where, done)
        return
    for key, sub in tree.items():
        name = f"{where}.{key}"
        if not isinstance(sub, Mapping):
            param = getattr(module, key, None)
            if not isinstance(param, nn.Parameter):
                raise KeyError(f"{name}: no counterpart in "
                               f"{type(module).__name__}")
            _copy(param, sub, name, done)
        elif key == "blocks" and isinstance(getattr(module, "blocks", None),
                                            nn.ModuleList):
            for i, block in enumerate(module.blocks):
                _load(block, _index(sub, i), f"{name}[{i}]", done)
        else:
            _load(_child(module, key, where), sub, name, done)


def _index(tree: Mapping[str, Any], i: int) -> Dict[str, Any]:
    """The i-th slice of a tree whose leaves are stacked on axis 0."""
    return {k: _index(v, i) if isinstance(v, Mapping) else np.asarray(v)[i]
            for k, v in tree.items()}


def load_jax_params(module: nn.Module, tree: Mapping[str, Any],
                    name: str = "params") -> None:
    """Copy the flax tree ``tree`` into ``module`` in place (strict)."""
    done: Set[int] = set()
    _load(module, tree, name, done)
    missing = [n for n, p in module.named_parameters() if id(p) not in done]
    if missing:
        raise KeyError(f"{name}: parameters not set from the JAX tree: "
                       f"{missing[:8]}{' …' if len(missing) > 8 else ''}")


def load_flow_params(flow, params: Mapping[str, Any]) -> None:
    """Copy a JAX flow's ``params`` ({component: tree}) into a port flow."""
    for comp, module in flow.components().items():
        load_jax_params(module, params[comp], comp)
