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
- an int8 tree's ``kernel_q`` (in, *out) and ``kernel_scale`` (*out) →
  an ``Int8Linear``'s buffers (in, n) and (n,) (``tools/int8.py``: the
  JAX package's ``quantize_params_int8`` into a module quantized by the
  port's ``quantize_int8``);
- ``block_{i}`` → ``blocks[i]``, ``pair_{i}`` → ``pairs[i]`` (STDiT's
  paired layout), ``double_{i}`` → ``double_blocks[i]`` and ``single_{i}``
  → ``single_blocks[i]`` (the HunyuanVideo DiT); the ``scan_blocks``
  layouts (every leaf stacked on axis 0 under ``blocks``, ``pairs``,
  ``double_blocks`` or ``single_blocks``) are unstacked.

The copy is strict: a flax leaf with no counterpart, a shape mismatch, or a
module parameter left unassigned raises.

``load_jax_lora`` carries a LoRA delta tree of the JAX package's
``training/lora.py`` across: the port's tree has the same layout (plain
``a`` (din, r) / ``b`` (r, *out), and scan-stacked ``a`` (depth, din, r) /
``b`` (depth, r, *out)), so each leaf is copied as it is, after checking that
its path names a kernel of the module and its shapes fit that kernel.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Set

import numpy as np
import torch
from torch import nn

from videotuna_tpu_torch.models.layers import LayerNorm, RMSNorm
from videotuna_tpu_torch.tools.int8 import KERNEL_Q, KERNEL_SCALE, Int8Linear

_NORMS = (nn.LayerNorm, nn.GroupNorm, LayerNorm, RMSNorm)
_BLOCK = re.compile(r"^(block|pair|double|single)_(\d+)$")
_STACKS = {"block": "blocks", "pair": "pairs", "double": "double_blocks",
           "single": "single_blocks"}


def _copy(param: torch.Tensor, arr: np.ndarray, where: str,
          done: Set[int]) -> None:
    value = torch.as_tensor(np.array(arr))
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
        elif isinstance(m, Int8Linear) and key == KERNEL_Q:
            _copy(m.kernel_q, arr.reshape(arr.shape[0], -1), name, done)
        elif isinstance(m, Int8Linear) and key == KERNEL_SCALE:
            _copy(m.kernel_scale, arr.reshape(-1), name, done)
        elif isinstance(m, (nn.Linear, Int8Linear, nn.Conv2d, nn.Conv3d)) \
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
    if match:
        stack = getattr(module, _STACKS[match.group(1)], None)
        if isinstance(stack, nn.ModuleList):
            return stack[int(match.group(2))]
    raise KeyError(f"{where}.{key}: no counterpart in "
                   f"{type(module).__name__}")


def _load(module: nn.Module, tree: Mapping[str, Any], where: str,
          done: Set[int]) -> None:
    if isinstance(module, (nn.Linear, Int8Linear, nn.Conv2d, nn.Conv3d,
                           nn.Embedding) + _NORMS):
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
        elif key in _STACKS.values() \
                and isinstance(getattr(module, key, None), nn.ModuleList):
            for i, block in enumerate(getattr(module, key)):
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
    missing += [f"{n}.{b}" for n, m in module.named_modules()
                if isinstance(m, Int8Linear) for b in (KERNEL_Q, KERNEL_SCALE)
                if id(getattr(m, b)) not in done]
    if missing:
        raise KeyError(f"{name}: parameters not set from the JAX tree: "
                       f"{missing[:8]}{' …' if len(missing) > 8 else ''}")


def load_flow_params(flow, params: Mapping[str, Any]) -> None:
    """Copy a JAX flow's ``params`` ({component: tree}) into a port flow."""
    for comp, module in flow.components().items():
        load_jax_params(module, params[comp], comp)


def load_jax_lora(module: nn.Module, tree: Mapping[str, Any],
                  device=None) -> Dict[str, Any]:
    """The JAX LoRA delta tree ``tree`` (nested dicts of numpy ``a``/``b``)
    as the port's tree for ``module``: f32 leaves that require grad, on
    ``device`` (default: the module's).  Strict on paths and shapes."""
    from videotuna_tpu_torch.training.lora import kernels

    shapes = {path: shape for path, shape, _, _ in kernels(module)}
    out: Dict[str, Any] = {}

    def walk(node, path):
        if isinstance(node, Mapping) and "a" in node and "b" in node \
                and not isinstance(node["a"], Mapping):
            if path not in shapes:
                raise KeyError(f"LoRA entry {'/'.join(path)} has no kernel "
                               f"in {type(module).__name__}")
            shape = shapes[path]
            a, b = np.asarray(node["a"]), np.asarray(node["b"])
            lead = a.ndim - 2
            r = a.shape[-1]
            if a.shape != shape[:lead] + (shape[lead], r) \
                    or b.shape != shape[:lead] + (r,) + shape[lead + 1:]:
                raise ValueError(f"{'/'.join(path)}: a {a.shape}, b "
                                 f"{b.shape} do not fit the kernel {shape}")
            dev = device or next(module.parameters()).device
            leaf = out
            for p in path[:-1]:
                leaf = leaf.setdefault(p, {})
            leaf[path[-1]] = {
                k: torch.tensor(x, dtype=torch.float32,
                                device=dev).requires_grad_()
                for k, x in (("a", a), ("b", b))}
            return
        for k, v in node.items():
            walk(v, path + (str(k),))

    walk(tree, ())
    return out
