"""Shared building blocks (torch): the subset of the JAX package's
``models/layers.py`` that the CogVideoX MMDiT, the Open-Sora STDiT, the
HunyuanVideo, Wan and StepVideo DiTs and the LLaMA text encoder use, plus the
norms and the random initialiser every module of the port shares.

Parameter names follow the flax modules (``fc1``, ``q_norm``, …) so that
``tools/from_jax.py`` maps a flax tree onto these modules by name.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from videotuna_tpu_torch.kernels.attention import dot_product_attention


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
        # the bias carries the module's dtype: an int8-quantized fc1
        # (tools/int8.py) keeps it and has no weight
        x = timestep_embedding(t, self.freq_dim).to(self.fc1.bias.dtype)
        return self.fc2(F.silu(self.fc1(x)))


def dense_general(din: int, heads: int, head_dim: int, bias: bool = True,
                  dtype: torch.dtype = torch.float32) -> nn.Linear:
    """The port of flax ``DenseGeneral((heads, head_dim))``: an
    ``nn.Linear`` onto heads·head_dim features that records the flax
    kernel's output shape in ``flax_features``, for the LoRA tree."""
    lin = nn.Linear(din, heads * head_dim, bias=bias, dtype=dtype)
    lin.flax_features = (heads, head_dim)
    return lin


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


def modulate(x: torch.Tensor, shift: torch.Tensor,
             scale: torch.Tensor) -> torch.Tensor:
    """adaLN modulation: x·(1+scale)+shift, broadcasting (B,D)→(B,…,D)."""
    while shift.ndim < x.ndim:
        shift = shift[:, None]
        scale = scale[:, None]
    return x * (1.0 + scale) + shift


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """flax's default ``nn.gelu`` (tanh approximation)."""
    return F.gelu(x, approximate="tanh")


class Mlp(nn.Module):
    """fc1 → tanh GELU → fc2, back to ``dim``."""

    def __init__(self, dim: int, hidden: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, dtype=dtype)
        self.fc2 = nn.Linear(hidden, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu_tanh(self.fc1(x)))


class Attention(nn.Module):
    """Multi-head attention over the second-to-last axis, the counterpart of
    the JAX package's ``layers.Attention`` (``models/layers.py:244-291``):
    q, k, v projections over heads (flax ``DenseGeneral``), an optional
    ``context`` for cross-attention, a key-validity ``mask`` (B, Sk),
    per-head RMS ``q_norm`` / ``k_norm`` with ``qk_norm`` (which also
    declares bounded logits), optional RoPE tables, and the ``out``
    projection."""

    def __init__(self, dim: int, heads: int, head_dim: Optional[int] = None,
                 qkv_bias: bool = True, qk_norm: bool = False,
                 out_bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads = heads
        self.head_dim = head_dim or dim // heads
        self.qk_norm = qk_norm
        inner = heads * self.head_dim
        self.q = dense_general(dim, heads, self.head_dim, qkv_bias, dtype)
        self.k = dense_general(dim, heads, self.head_dim, qkv_bias, dtype)
        self.v = dense_general(dim, heads, self.head_dim, qkv_bias, dtype)
        if qk_norm:
            self.q_norm = RMSNorm(self.head_dim, dtype=dtype)
            self.k_norm = RMSNorm(self.head_dim, dtype=dtype)
        self.out = nn.Linear(inner, dim, bias=out_bias, dtype=dtype)

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None,
                rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = x if context is None else context
        heads = (self.heads, self.head_dim)
        q = self.q(x).unflatten(-1, heads)
        k = self.k(ctx).unflatten(-1, heads)
        v = self.v(ctx).unflatten(-1, heads)
        if self.qk_norm:
            q = self.q_norm(q)
            k = self.k_norm(k)
        if rope is not None:
            cos, sin = rope
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
        # the masked flash kernel writes zeros for a row with no valid key:
        # callers keep at least one valid key per row
        out = dot_product_attention(q, k, v, kv_valid=mask,
                                    bounded_logits=self.qk_norm)
        return self.out(out.flatten(-2))


class PatchEmbed3D(nn.Module):
    """(B, T, H, W, C) video latents → (B, T', H'·W' or merged tokens, D):
    a conv with stride = patch size (flax ``Conv`` "VALID"), channel-last in
    and out as in the JAX package."""

    def __init__(self, in_channels: int, dim: int,
                 patch: Sequence[int] = (1, 2, 2), flatten: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.flatten = flatten
        self.proj = nn.Conv3d(in_channels, dim, tuple(patch),
                              stride=tuple(patch), dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.proj(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
        return x.flatten(1, 3) if self.flatten else x


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(dim: int, positions: torch.Tensor,
                     theta: float = 10000.0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables: positions (N,) → (N, dim/2), f32."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    freqs = positions.float()[:, None] * inv[None]
    return torch.cos(freqs), torch.sin(freqs)

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


def apply_rope_half(x: torch.Tensor, cos: torch.Tensor,
                    sin: torch.Tensor) -> torch.Tensor:
    """x: (..., N, H, D); cos/sin: (N, D/2).  Rotate-half convention (the
    HF LLaMA one): channel i pairs with i + D/2."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    c = cos[:, None, :]
    s = sin[:, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def apply_rope_3d_grouped(x: torch.Tensor,
                          tables: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                          dims: Sequence[int],
                          interleaved: bool = False) -> torch.Tensor:
    """Per-axis RoPE on channel groups of x (StepVideo's RoPE3D): the
    channels split by ``dims``, each group rotated with its own axis's
    table, rotate-half by default.  x: (..., N, H, D), D = sum(dims);
    tables[i]: (cos, sin) each (N, dims[i]/2)."""
    fn = apply_rope if interleaved else apply_rope_half
    parts, off = [], 0
    for (c, s), d in zip(tables, dims):
        parts.append(fn(x[..., off:off + d], c, s))
        off += d
    return torch.cat(parts, dim=-1)


# HunyuanVideo's rope_dim_list at head_dim 128 (t, h, w), interleaved pairs
HUNYUAN_ROPE_DIMS: Tuple[int, int, int] = (16, 56, 56)

# StepVideo's rope_ch_split at head_dim 128 (t, h, w), rotate-half per group
STEPVIDEO_ROPE_DIMS: Tuple[int, int, int] = (64, 32, 32)


def split_rope_dims(head_dim: int) -> Tuple[int, int, int]:
    """Split head_dim into (t, h, w) rotary dims, ~(1/4, 3/8, 3/8), all
    even — the CogVideoX convention (64 → 16/24/24)."""
    if head_dim % 2:
        raise ValueError("head_dim must be even for RoPE")
    dh = (head_dim * 3 // 8) // 2 * 2
    return head_dim - 2 * dh, dh, dh


def wan_rope_dims(head_dim: int) -> Tuple[int, int, int]:
    """Wan 2.1's (t, h, w) split, (d − 4·⌊d/6⌋, 2·⌊d/6⌋, 2·⌊d/6⌋): 128 →
    44/42/42, interleaved pairs."""
    g = head_dim // 6
    return head_dim - 4 * g, 2 * g, 2 * g


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


def rope_3d_axis_tables(dims: Sequence[int], grid: Tuple[int, int, int],
                        theta: float = 10000.0,
                        temporal_scale: Optional[torch.Tensor] = None,
                        device: Optional[torch.device] = None
                        ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], ...]:
    """Per-axis cos/sin tables broadcast to the flattened (t·h·w) grid, for
    the grouped RoPE (StepVideo): ((cos_t, sin_t), (cos_h, sin_h), (cos_w,
    sin_w)), each (t·h·w, dims[i]/2), f32."""
    t, h, w = grid
    out = []
    for axis, (dim, n) in enumerate(zip(dims, grid)):
        inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                            device=device) / dim))
        if axis == 0 and temporal_scale is not None:
            inv = inv * temporal_scale
        freqs = torch.arange(n, dtype=torch.float32,
                             device=device)[:, None] * inv[None]
        shape = [1, 1, 1, dim // 2]
        shape[axis] = n
        tabs = tuple(f(freqs).reshape(shape).expand(t, h, w, dim // 2)
                     .reshape(t * h * w, -1) for f in (torch.cos, torch.sin))
        out.append(tabs)
    return tuple(out)


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
    N(0, 1/fan_in), zero biases, embeddings N(0, 1/dim), unit norm scales
    (``weight``, or ``gamma`` of the Wan VAE's RMS norm), zero weights
    where a module sets ``zero_init`` (flax's zeros initialiser),
    N(0, 0.02²) for free parameters (pos_embed, rel_bias).  Draws come from
    ``generator`` only, in module order, so a seed fixes every weight."""
    done = set()
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.Conv3d)):
            if getattr(m, "zero_init", False):   # flax's zeros initialiser
                m.weight.zero_()
            else:
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
        elif isinstance(getattr(m, "gamma", None), nn.Parameter):
            m.gamma.fill_(1.0)     # the Wan VAE's RMS norm scale
        else:
            continue
        done.update(id(p) for p in m.parameters(recurse=False))
    for p in module.parameters():
        if id(p) not in done:
            p.normal_(0.0, 0.02, generator=generator)
