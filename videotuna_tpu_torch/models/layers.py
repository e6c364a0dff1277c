"""Shared building blocks (torch): the subset of the JAX package's
``models/layers.py`` that the CogVideoX MMDiT uses, plus the norms and the
random initialiser every module of the port shares.

Parameter names follow the flax modules (``fc1``, ``q_norm``, …) so that
``tools/from_jax.py`` maps a flax tree onto these modules by name.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding, [cos | sin], f32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class TimestepEmbedder(nn.Module):
    """MLP over the sinusoidal embedding → conditioning vector."""

    def __init__(self, hidden: int, freq_dim: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.freq_dim = freq_dim
        self.fc1 = nn.Linear(freq_dim, hidden, dtype=dtype)
        self.fc2 = nn.Linear(hidden, hidden, dtype=dtype)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        x = timestep_embedding(t, self.freq_dim).to(self.fc1.weight.dtype)
        return self.fc2(F.silu(self.fc1(x)))


class RMSNorm(nn.Module):
    """RMSNorm computed in f32, output in the input's dtype."""

    def __init__(self, dim: int, eps: float = 1e-6, use_scale: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.weight = (nn.Parameter(torch.ones(dim, dtype=dtype))
                       if use_scale else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + self.eps)
        if self.weight is not None:
            y = y * self.weight.float()
        return y.to(x.dtype)


class LayerNorm(nn.Module):
    """LayerNorm over the last dim computed in f32 (as flax does for low
    precision inputs), output in the input's dtype.  ``affine=False`` has
    neither scale nor bias."""

    def __init__(self, dim: int, eps: float = 1e-5, affine: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim = dim
        self.eps = eps
        self.weight = (nn.Parameter(torch.ones(dim, dtype=dtype))
                       if affine else None)
        self.bias = (nn.Parameter(torch.zeros(dim, dtype=dtype))
                     if affine else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.float() if self.weight is not None else None
        b = self.bias.float() if self.bias is not None else None
        return F.layer_norm(x.float(), (self.dim,), w, b,
                            self.eps).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., N, H, D); cos/sin: (N, D/2).  Interleaved-pair convention
    (pairs are adjacent channels)."""
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    c = cos[:, None, :]
    s = sin[:, None, :]
    o1 = x1 * c - x2 * s
    o2 = x1 * s + x2 * c
    return torch.stack([o1, o2], dim=-1).reshape(x.shape)


def split_rope_dims(head_dim: int) -> Tuple[int, int, int]:
    """Split head_dim into (t, h, w) rotary dims, ~(1/4, 3/8, 3/8), all
    even — the CogVideoX convention (64 → 16/24/24)."""
    if head_dim % 2:
        raise ValueError("head_dim must be even for RoPE")
    dh = (head_dim * 3 // 8) // 2 * 2
    return head_dim - 2 * dh, dh, dh


def rope_3d(dim_t: int, dim_h: int, dim_w: int, t: int, h: int, w: int,
            theta: float = 10000.0,
            temporal_scale: Optional[torch.Tensor] = None,
            device: Optional[torch.device] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Factorised 3D RoPE tables for a (t, h, w) grid flattened t-major →
    cos/sin (t·h·w, (dim_t+dim_h+dim_w)/2), f32."""

    def axis_tables(dim, n, scale=None):
        inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                            device=device) / dim))
        if scale is not None:
            inv = inv * scale
        freqs = torch.arange(n, dtype=torch.float32,
                             device=device)[:, None] * inv[None]
        return torch.cos(freqs), torch.sin(freqs)

    ct, st = axis_tables(dim_t, t, temporal_scale)
    ch, sh = axis_tables(dim_h, h)
    cw, sw = axis_tables(dim_w, w)

    def grid(tab_t, tab_h, tab_w):
        return torch.cat([
            tab_t[:, None, None, :].expand(t, h, w, dim_t // 2),
            tab_h[None, :, None, :].expand(t, h, w, dim_h // 2),
            tab_w[None, None, :, :].expand(t, h, w, dim_w // 2),
        ], dim=-1).reshape(t * h * w, -1)

    return grid(ct, ch, cw), grid(st, sh, sw)


def unpatchify_3d(x: torch.Tensor, grid: Tuple[int, int, int],
                  patch: Tuple[int, int, int], out_ch: int) -> torch.Tensor:
    """(B, T'·H'·W', pt·ph·pw·C) → (B, T, H, W, C)."""
    t, h, w = grid
    pt, ph, pw = patch
    b = x.shape[0]
    x = x.reshape(b, t, h, w, pt, ph, pw, out_ch)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, t * pt, h * ph, w * pw, out_ch)


# ---------------------------------------------------------------------------
# Random initialisation
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init in place, after flax's defaults: kernels
    N(0, 1/fan_in), zero biases, embeddings N(0, 1/dim), unit norm scales,
    N(0, 0.02²) for free parameters (pos_embed, rel_bias).  Draws come from
    ``generator`` only, in module order, so a seed fixes every weight."""
    done = set()
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.Conv3d)):
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, m.weight.shape[1] ** -0.5,
                             generator=generator)
        elif isinstance(m, (nn.GroupNorm, LayerNorm, RMSNorm)):
            if m.weight is not None:
                m.weight.fill_(1.0)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
        else:
            continue
        done.update(id(p) for p in m.parameters(recurse=False))
    for p in module.parameters():
        if id(p) not in done:
            p.normal_(0.0, 0.02, generator=generator)
