"""w8a8 int8 serving quantization (torch), the counterpart of
``videotuna_tpu/tools/int8.py``.

The recipe is the JAX package's standard w8a8:

- weights: per-output-channel symmetric int8, the absmax over the input
  axis taken offline (``quantize_int8`` replaces each matched
  ``nn.Linear`` with an ``Int8Linear`` that holds the int8 kernel and its
  f32 scales, so the module is int8-resident);
- activations: per-row dynamic symmetric int8 (the absmax over the
  feature axis, at run time);
- int8 × int8 products accumulated in int32 (``torch._int_mm``), rescaled
  once in f32 by x_scale · w_scale.

Attention, norms, biases, convolutions and embeddings keep their dtype.
Where the JAX package reroutes the flax ``Dense`` calls through a method
interceptor inside the flow's ``_attn_scope``, the port swaps the modules
themselves, so a quantized module runs w8a8 in every caller.

The JAX package computes the product with ``dot_general`` outside any
Pallas kernel; the port takes the library's int8 GEMM for it, with the
quantise and rescale passes in plain PyTorch.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from videotuna_tpu_torch.training.lora import MatchFn, default_match, kernels

KERNEL_Q = "kernel_q"
KERNEL_SCALE = "kernel_scale"

# torch._int_mm on CUDA takes more than 16 rows and K, N multiples of 8
_CUDA_MIN_ROWS = 17
_CUDA_ROWS = 32


def int8_matmul(x: torch.Tensor, wq: torch.Tensor,
                ws: torch.Tensor) -> torch.Tensor:
    """w8a8 product: x (..., din) float, wq (din, n) int8, ws (n,) f32
    per-output-channel scales → (..., n) f32 (the caller casts).

    Each row of x is quantized by its own absmax; the int32 accumulator is
    rescaled once by x_scale · w_scale.  On CUDA a product of at most 16
    rows is padded with zero rows to 32, which ``torch._int_mm`` takes (a
    zero row quantizes to zeros and is dropped after), chosen from the
    shape before the call."""
    din, n = wq.shape
    lead = x.shape[:-1]
    xf = x.float().reshape(-1, din)
    xs = xf.abs().amax(dim=-1, keepdim=True)
    xs = xs.clamp_min(1e-8) * (1.0 / 127.0)
    xq = torch.round(xf / xs).clamp(-127, 127).to(torch.int8)
    rows = xq.shape[0]
    if xq.is_cuda:
        if din % 8 or n % 8:
            raise ValueError(f"int8 product of {din} → {n} features: "
                             "torch._int_mm on CUDA takes multiples of 8")
        if rows < _CUDA_MIN_ROWS:
            xq = F.pad(xq, (0, 0, 0, _CUDA_ROWS - rows))
    acc = torch._int_mm(xq, wq)[:rows]
    return (acc.float() * xs * ws).reshape(*lead, n)


def quantize_weight(weight: torch.Tensor):
    """An ``nn.Linear`` weight (n, din) → (int8 kernel (din, n), f32 scales
    (n,)), the JAX package's ``_quantize_leaf`` on the flax kernel
    (din, n): the absmax over the input axis, times 1/127, then the
    rounded quotient clipped to ±127.  The kernel is the transpose of an
    (n, din) row-major tensor, the layout cuBLASLt's int8 GEMM reads."""
    wf = weight.detach().float()
    amax = wf.abs().amax(dim=1)
    scale = amax.clamp_min(1e-12) * (1.0 / 127.0)
    wq = torch.round(wf / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return wq.t(), scale


class Int8Linear(nn.Module):
    """An ``nn.Linear`` quantized for w8a8: the int8 ``kernel_q`` (din, n)
    and f32 ``kernel_scale`` (n,) buffers, the bias kept as it was (and
    ``flax_features``, the flax kernel's output shape); the output in the
    input's dtype."""

    def __init__(self, linear: nn.Linear):
        super().__init__()
        self.in_features = linear.in_features
        self.out_features = linear.out_features
        wq, ws = quantize_weight(linear.weight)
        self.register_buffer(KERNEL_Q, wq)
        self.register_buffer(KERNEL_SCALE, ws)
        self.bias = linear.bias
        if hasattr(linear, "flax_features"):
            self.flax_features = linear.flax_features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = int8_matmul(x, self.kernel_q, self.kernel_scale)
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(x.dtype)


def quantize_int8(module: nn.Module,
                  match: Optional[MatchFn] = None) -> nn.Module:
    """Replace, in place, every projection of ``module`` that ``match``
    takes (the LoRA coverage rules on the flax path and kernel shape,
    ``training/lora.kernels``) with its ``Int8Linear``; everything else
    passes through.  A scanned stack's kernel is one flax leaf (depth,
    din, *out) whose per-depth scales are the scales of the port's
    per-block ``nn.Linear``s."""
    match = match or default_match
    parents = {id(child): (parent, name)
               for parent in module.modules()
               for name, child in parent.named_children()}
    for path, shape, linear, _ in list(kernels(module)):
        if match(path, shape):
            parent, name = parents[id(linear)]
            setattr(parent, name, Int8Linear(linear))
    return module


def tree_bytes(module: nn.Module) -> int:
    """Bytes of a module's parameters and buffers."""
    return sum(t.numel() * t.element_size()
               for t in (*module.parameters(), *module.buffers()))
