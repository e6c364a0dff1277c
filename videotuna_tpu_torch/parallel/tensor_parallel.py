"""Tensor parallelism of the port, the counterpart of
``videotuna_tpu/parallel/tensor_parallel.py``: Megatron column/row sharding
of the linear layers over the mesh's ``tp`` axis with DTensor's
``parallelize_module``.

The rules are the JAX package's (path regex → kind) applied to the port's
parameter names in flax's layout: ``blocks.0.self_q.weight`` reads as
``blocks/0/self_q/kernel``, and an ``nn.Linear``'s weight (out, in) as the
flax kernel (in, out), or (in, heads, head_dim) where the layer is the
port's ``dense_general``.  Attention q/k/v and MLP-in are column-sharded
(``ColwiseParallel``: output features, so the heads of a ``dense_general``),
the projections back row-sharded (``RowwiseParallel``: input features, then
one all-reduce), so each block needs one all-reduce after attention and one
after the MLP, the Megatron minimum.  A module whose q/k/v went column-wise
computes ``heads / tp`` heads: its ``heads`` is divided where one is set.
Where GSPMD lays out any placement for the JAX package, the port's layers
pass sharded activations only between a column layer and the row layer
that reads it: a column layer that feeds no row layer (StepVideo's
``t_block``, whose name the q/k/v rule matches) gathers its output, and a
row layer fed by no column layer splits its input itself.
"""

from __future__ import annotations

import re
from typing import Dict, Sequence, Tuple

from torch import nn

from videotuna_tpu_torch.parallel.sharding import P, fsdp_spec

# the column layers whose output a row layer of the same module reads
_FEEDS_ROW = re.compile(r"(ffn1|fc1|mlp1|wi_0|wi_1|gate|up|linear1)$")

DEFAULT_TP_RULES: Tuple[Tuple[str, str], ...] = (
    (r"(self_|cross_|img_|txt_)?(q|k|v)(_proj)?/kernel$", "col"),
    (r"(attn|self|cross)_out/kernel$", "row"),
    (r"(ffn1|fc1|mlp1|wi_0|wi_1|gate|up|linear1)/kernel$", "col"),
    (r"(ffn2|fc2|mlp2|wo|down|linear2)/kernel$", "row"),
)


def _spec_for(kind: str, ndim: int) -> P:
    if kind == "col":
        if ndim == 2:
            return P(None, "tp")
        if ndim == 3:             # DenseGeneral (in, heads, head_dim)
            return P(None, "tp", None)
    if kind == "row":
        if ndim == 2:
            return P("tp", None)
        if ndim == 3:             # (heads, head_dim, out)
            return P("tp", None, None)
    return P()


def _flax_leaves(module: nn.Module):
    """(port name, flax path, flax shape, owning module) of every
    parameter."""
    mods = dict(module.named_modules())
    for name, p in module.named_parameters():
        owner_name, _, leaf = name.rpartition(".")
        owner = mods[owner_name]
        shape = tuple(p.shape)
        if isinstance(owner, nn.Linear) and leaf == "weight":
            leaf = "kernel"
            shape = (shape[1],) + tuple(getattr(owner, "flax_features",
                                                (shape[0],)))
        path = "/".join(owner_name.split(".") + [leaf]) if owner_name \
            else leaf
        yield name, path, shape, owner


def tp_specs(module: nn.Module, tp_size: int,
             rules: Sequence[Tuple[str, str]] = DEFAULT_TP_RULES,
             fsdp_size: int = 1) -> Dict[str, P]:
    """{parameter name: spec of its flax kernel}: the TP rules first (a
    rule whose "tp" dimension does not divide is skipped), the FSDP choice
    for the rest — JAX ``tp_specs`` on the same tree."""
    out = {}
    for name, path, shape, _ in _flax_leaves(module):
        spec = None
        if tp_size > 1:
            for pattern, kind in rules:
                if re.search(pattern, path):
                    cand = _spec_for(kind, len(shape))
                    if all(dim % tp_size == 0
                           for dim, ax in zip(shape, cand) if ax == "tp"):
                        spec = cand
                        break
        out[name] = spec if spec is not None else fsdp_spec(shape,
                                                            fsdp_size)
    return out


def tp_plan(module: nn.Module, tp_size: int,
            rules: Sequence[Tuple[str, str]] = DEFAULT_TP_RULES
            ) -> Dict[str, str]:
    """{linear layer name: "col" or "row"} of the layers whose kernel a
    rule shards over tp."""
    specs = tp_specs(module, tp_size, rules)
    plan = {}
    for name, _, shape, owner in _flax_leaves(module):
        spec = specs[name]
        if isinstance(owner, nn.Linear) and name.endswith(".weight") \
                and "tp" in spec:
            plan[name[:-len(".weight")]] = ("col" if spec.index("tp") > 0
                                            else "row")
    return plan


def apply_tp(module: nn.Module, mesh,
             rules: Sequence[Tuple[str, str]] = DEFAULT_TP_RULES
             ) -> nn.Module:
    """Shard ``module``'s linear layers over the mesh's ``tp`` axis by the
    rules (in place), and give each module whose q/k/v were
    column-sharded its local head count.  Composing with FSDP over the
    same module is not done here: a mesh with fsdp above 1 raises."""
    tp = mesh.shape["tp"]
    if tp == 1:
        return module
    if mesh.extent("dp", "fsdp") > 1:
        raise NotImplementedError(
            "tensor parallelism together with dp/fsdp sharding of the same "
            "module is not ported (ROADMAP.md queue 1, item 10.1)")
    from torch.distributed.tensor.parallel import (ColwiseParallel,
                                                   RowwiseParallel,
                                                   parallelize_module)
    from torch.distributed.tensor import Replicate
    plan = tp_plan(module, tp, rules)
    mods = dict(module.named_modules())
    sharded_out = set()      # column layers that hand a row layer shards
    for name, kind in plan.items():
        if kind != "col":
            continue
        parent, _, leaf = name.rpartition(".")
        if hasattr(mods[name], "flax_features"):   # q/k/v over heads
            owner = mods[parent]
            if hasattr(owner, "heads") and not getattr(owner, "_tp_heads",
                                                       False):
                owner.heads //= tp
                owner._tp_heads = True
            sharded_out.add(name)
        elif _FEEDS_ROW.search(leaf):
            sharded_out.add(name)
    fed = {n.rpartition(".")[0] for n in sharded_out}
    styles = {}
    for name, kind in plan.items():
        if kind == "col":
            styles[name] = (ColwiseParallel() if name in sharded_out
                            else ColwiseParallel(output_layouts=Replicate()))
        else:
            styles[name] = (RowwiseParallel()
                            if name.rpartition(".")[0] in fed
                            else RowwiseParallel(input_layouts=Replicate()))
    parallelize_module(module, mesh.submesh("tp"), styles)
    return module
