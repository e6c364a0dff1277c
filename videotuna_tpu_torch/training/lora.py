"""LoRA as separate parameter trees (torch), the counterpart of
``videotuna_tpu/training/lora.py``.

The delta tree has the JAX package's layout: one ``{"a": (din, r),
"b": (r, *out)}`` pair per matched projection kernel, nested by the flax
parameter path of that kernel, with ``a`` ~ N(0, 1/r) and ``b`` = 0; under a
scanned stack (``scan_blocks``: the blocks' parameters stacked on a leading
depth axis under ``blocks``) one pair per stack, ``a`` (depth, din, r) and
``b`` (depth, r, *out).  ``*out`` is the flax kernel's output shape: (dout,)
for ``Dense``, (heads, head_dim) for the ``DenseGeneral`` q/k/v projections,
which the port's ``nn.Linear`` flattens (they carry ``flax_features``).

The port's modules carry the flax names, so a module's flax kernel paths
are its ``nn.Linear`` names with ``blocks.<i>`` read as ``block_<i>``
(``pairs.<i>`` as ``pair_<i>``, HunyuanVideo's ``double_blocks.<i>`` and
``single_blocks.<i>`` as ``double_<i>`` and ``single_<i>``) or, when
scanned, as depth ``i`` of the stack.  The matching rules
(``default_match``, ``lora_target``) are the JAX package's, applied to the
flax path and kernel shape.

Two ways to apply a tree, as in the JAX package:

1. merge (inference): ``merge_lora(module, lora, alpha)`` adds α·(a @ b) to
   each matched weight in place;
2. side branch (training): inside ``lora_scope(module, lora, alpha)`` every
   matched ``nn.Linear`` computes y = xW + (x·a)(α·b), in x's dtype from
   the f32 ``a`` and ``b``, through a forward hook.  Neither a merged weight
   nor a full-size weight gradient is formed: backward makes only the
   rank-sized dA and dB.
"""

from __future__ import annotations

import contextlib
import math
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import torch
from torch import nn

MatchFn = Callable[[Tuple[str, ...], Tuple[int, ...]], bool]

# scanned stacks (plural, as in the JAX package); their kernels carry a
# leading depth axis
_SCAN_STACKS = ("blocks", "double_blocks", "single_blocks")
# port ModuleLists and the flax names of their unscanned members
_LISTS = {"blocks": "block", "pairs": "pair", "double_blocks": "double",
          "single_blocks": "single"}


def _is_stacked(path: Tuple[str, ...]) -> bool:
    return any(c in _SCAN_STACKS for c in path)


def _matchable(path: Tuple[str, ...], shape: Tuple[int, ...]) -> bool:
    """The JAX package's rule on a flax kernel (path, shape): every 2D
    kernel; 3D/4D under a scanned stack; a 3D ``DenseGeneral`` outside one
    unless the path names a conv."""
    if path[-1] != "kernel":
        return False
    if len(shape) == 2:
        return True
    if _is_stacked(path):
        return len(shape) in (3, 4)
    return len(shape) == 3 and not any("conv" in c.lower() for c in path)


def lora_target(*name_patterns: str) -> MatchFn:
    """Match projection kernels whose path contains any of the given
    substrings (e.g. 'q', 'k', 'v', 'out', 'fc1', 'fc2')."""
    def match(path: Tuple[str, ...], shape: Tuple[int, ...]) -> bool:
        if not _matchable(path, shape):
            return False
        joined = "/".join(path)
        return any(p in joined for p in name_patterns)
    return match


def default_match(path: Tuple[str, ...], shape: Tuple[int, ...]) -> bool:
    return _matchable(path, shape)


def kernels(module: nn.Module
            ) -> Iterator[Tuple[Tuple[str, ...], Tuple[int, ...], nn.Linear,
                                Optional[int]]]:
    """Every projection kernel of ``module`` as (flax path, flax shape, the
    port ``nn.Linear``, depth index in a scanned stack or None).  A scanned
    stack's kernels share one path and one shape with the leading depth
    axis.  (Conv kernels are 4D or 5D outside any stack: no rule matches
    them.)"""
    scan = bool(getattr(module, "scan_blocks", False))
    for name, m in module.named_modules():
        if not isinstance(m, nn.Linear):
            continue
        parts = name.split(".")
        path: List[str] = []
        index = depth = None
        i = 0
        while i < len(parts):
            p = parts[i]
            if p in _LISTS and i + 1 < len(parts) and parts[i + 1].isdigit():
                n = int(parts[i + 1])
                if scan:
                    if p not in _SCAN_STACKS:
                        raise NotImplementedError(
                            f"LoRA on the scanned '{p}' stack: the JAX "
                            "package does not treat it as a scan stack")
                    path.append(p)
                    index = n
                    depth = len(module.get_submodule(".".join(parts[:i + 1])))
                else:
                    path.append(f"{_LISTS[p]}_{n}")
                i += 2
            else:
                path.append(p)
                i += 1
        shape = (m.in_features,) + tuple(getattr(m, "flax_features",
                                                 (m.out_features,)))
        if index is not None:
            shape = (depth,) + shape
        yield tuple(path) + ("kernel",), shape, m, index


def _iter_pairs(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
                ) -> Iterator[Tuple[Tuple[str, ...], Dict[str, Any]]]:
    for k, v in tree.items():
        if isinstance(v, dict) and "a" in v and "b" in v \
                and not isinstance(v["a"], dict):
            yield prefix + (k,), v
        elif isinstance(v, dict):
            yield from _iter_pairs(v, prefix + (k,))


def _set(tree: Dict[str, Any], path: Sequence[str], value: Any) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def init_lora(module: nn.Module, rank: int = 16,
              match: Optional[MatchFn] = None,
              generator: Optional[torch.Generator] = None,
              dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """The LoRA delta tree of ``module``: for each matched kernel
    a ~ N(0, 1/r) and b = 0 (identity at step 0), on the module's device,
    leaves that require grad."""
    match = match or default_match
    tree: Dict[str, Any] = {}
    seen = set()
    for path, shape, m, index in kernels(module):
        if path in seen or not match(path, shape):
            continue
        seen.add(path)
        lead = shape[:1] if index is not None else ()
        din, out = shape[len(lead)], shape[len(lead) + 1:]
        dev = m.weight.device
        a = torch.randn(lead + (din, rank), generator=generator, device=dev,
                        dtype=dtype) / math.sqrt(rank)
        b = torch.zeros(lead + (rank,) + out, device=dev, dtype=dtype)
        _set(tree, path, {"a": a.requires_grad_(), "b": b.requires_grad_()})
    return tree


def _pairs_for(module: nn.Module, lora: Dict[str, Any]):
    """(``nn.Linear``, depth index, a, b) for every entry of ``lora``; an
    entry with no matching kernel raises."""
    targets: Dict[Tuple[str, ...], list] = {}
    for path, _, m, index in kernels(module):
        targets.setdefault(path, []).append((m, index))
    for path, ab in _iter_pairs(lora):
        if path not in targets:
            raise KeyError(f"LoRA entry {'/'.join(path)} has no kernel in "
                           f"{type(module).__name__}")
        for m, index in targets[path]:
            yield m, index, ab["a"], ab["b"]


def merge_lora(module: nn.Module, lora: Dict[str, Any],
               alpha: float = 1.0) -> nn.Module:
    """W ← W + α·(a @ b) wherever ``lora`` has an entry, in place (the
    delta is rounded to the weight's dtype first, as the JAX package
    does)."""
    with torch.no_grad():
        for m, index, a, b in _pairs_for(module, lora):
            if index is not None:
                a, b = a[index], b[index]
            r = a.shape[-1]
            a = a.to(m.weight.device)
            b = b.to(m.weight.device)
            delta = (a.float() @ b.float().reshape(r, -1)).to(m.weight.dtype)
            m.weight.copy_(m.weight + alpha * delta.T)
    return module


def count_lora_params(lora: Dict[str, Any]) -> int:
    return sum(ab["a"].numel() + ab["b"].numel()
               for _, ab in _iter_pairs(lora))


def _side_branch(a: torch.Tensor, b: torch.Tensor, alpha: float,
                 index: Optional[int]):
    def hook(mod: nn.Module, args, out: torch.Tensor) -> torch.Tensor:
        x = args[0]
        aa = a if index is None else a[index]
        bb = b if index is None else b[index]
        r = aa.shape[-1]
        d = (x @ aa.to(x.dtype)) @ (bb * alpha).reshape(r, -1).to(x.dtype)
        return out + d.reshape(out.shape).to(out.dtype)
    return hook


@contextlib.contextmanager
def lora_scope(module: nn.Module, lora: Dict[str, Any], alpha: float = 1.0):
    """Within the scope every matched ``nn.Linear`` of ``module`` adds the
    side branch (x·a)(α·b).  Hold it open over the backward too when the
    model recomputes blocks there (``remat``)."""
    handles = []
    try:
        for m, index, a, b in _pairs_for(module, lora):
            handles.append(m.register_forward_hook(
                _side_branch(a, b, alpha, index)))
        yield
    finally:
        for h in handles:
            h.remove()


def flatten_tree(tree: Dict[str, Any], prefix: str = ""
                 ) -> Dict[str, torch.Tensor]:
    """Nested dict of tensors → {"a/b/c": tensor} (the same tensors)."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten_tree(v, name + "/"))
        else:
            out[name] = v
    return out


def unflatten_tree(flat: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for name, v in flat.items():
        _set(tree, name.split("/"), v)
    return tree
