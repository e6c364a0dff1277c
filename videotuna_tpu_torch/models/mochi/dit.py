"""Mochi-1 AsymmDiT (torch), the counterpart of
``videotuna_tpu/models/mochi/dit.py``: the 10B dual-stream joint-attention
DiT (visual stream 3072, text stream 1536, 48 blocks, 24 heads of d = 128).

- asymmetric streams: the text q, k, v are projected 1536 → 3072, so the
  joint attention over [visual; text] runs at the visual width;
- scale-only RMS modulation and tanh-gated, RMS-normalised residuals;
- a learned mixed-rotation RoPE: per-head angles from a (3, heads, d/2)
  frequency parameter and the centred (t, h, w) token coordinates, on the
  visual tokens only (interleaved pairs);
- SwiGLU feed-forwards (value · silu(gate)) without biases;
- the conditioning vector: the timestep embedding plus an 8-head attention
  pool of the T5 states (with an additive bias, so on the math path);
- the last block does not update the text stream.

The joint attention declares bounded logits (q and k are RMSNormed); under
the flow's fixed max 0 it takes route K4 with the key mask over the caption
padding (the visual keys always valid), or K3 unmasked.  Latents are
channel-last (B, T, H, W, C) in and f32 out.

``scan_blocks`` names the JAX parameter layout (the first depth − 1 blocks'
leaves stacked under ``blocks``, the last block ``block_{depth−1}``), which
``tools/from_jax.py`` reads; the port holds one module per block either
way.  ``remat`` recomputes the first depth − 1 blocks in the backward with
``torch.utils.checkpoint`` whenever autograd records.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from videotuna_tpu_torch.core.config import resolve_dtype
from videotuna_tpu_torch.core.registry import register
from videotuna_tpu_torch.kernels.attention import (dot_product_attention,
                                                   remat_contexts)
from videotuna_tpu_torch.models.layers import (LayerNorm, RMSNorm,
                                               TimestepEmbedder,
                                               dense_general, unpatchify_3d)


def _rms(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Parameter-free RMSNorm in f32, back in x's dtype."""
    xf = x.float()
    return (xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True)
                             + eps)).to(x.dtype)


def modulated_rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """RMSNorm(x) · (1 + scale), scale (B, D) over the sequence."""
    return _rms(x) * (1.0 + scale[:, None, :])


def residual_tanh_gated_rmsnorm(x: torch.Tensor, x_res: torch.Tensor,
                                gate: torch.Tensor) -> torch.Tensor:
    """x + tanh(gate) · RMSNorm(x_res)."""
    return x + torch.tanh(gate)[:, None, :] * _rms(x_res)


def mochi_positions(t: int, h: int, w: int, target_area: float = 36864.0,
                    device: Optional[torch.device] = None) -> torch.Tensor:
    """Centred (t, h, w) token coordinates (S, 3), t-major, the spatial
    axes rescaled so that the frame's area matches the 192×192-token
    training area."""
    scale = math.sqrt(target_area / (h * w))
    tt = torch.arange(t, dtype=torch.float32, device=device)
    hh = (torch.arange(h, dtype=torch.float32, device=device)
          - (h - 1) / 2.0) * scale
    ww = (torch.arange(w, dtype=torch.float32, device=device)
          - (w - 1) / 2.0) * scale
    grid = torch.stack(torch.meshgrid(tt, hh, ww, indexing="ij"), dim=-1)
    return grid.reshape(-1, 3)


def mochi_rope(pos_frequencies: torch.Tensor, pos: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Learned mixed rotation: freqs (3, H, D/2) ⊗ pos (S, 3) → per-head
    angles (S, H, D/2) → (cos, sin), f32."""
    angles = torch.einsum("sd,dhf->shf", pos, pos_frequencies.float())
    return torch.cos(angles), torch.sin(angles)


def apply_rope_perhead(x: torch.Tensor, cos: torch.Tensor,
                       sin: torch.Tensor) -> torch.Tensor:
    """Interleaved-pair rotation with per-head tables, in f32: x (B, S, H,
    D), cos/sin (S, H, D/2)."""
    x1, x2 = x[..., 0::2].float(), x[..., 1::2].float()
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                       dim=-1).reshape(x.shape).to(x.dtype)


class MochiAttentionPool(nn.Module):
    """The T5 states → (B, out_dim): the masked-mean token is the only
    query over [pool; tokens], 8 heads, the padding masked by an additive
    bias (the math path of ``dot_product_attention``)."""

    def __init__(self, dim: int, heads: int = 8, out_dim: int = 3072,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads = heads
        self.to_kv = nn.Linear(dim, 2 * dim, dtype=dtype)
        self.to_q = nn.Linear(dim, dim, dtype=dtype)
        self.to_out = nn.Linear(dim, out_dim, dtype=dtype)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, l, d = x.shape
        if mask is None:
            mask = torch.ones((b, l), dtype=torch.bool, device=x.device)
        mf = mask.float()[..., None]
        pool = (x.float() * mf).sum(dim=1, keepdim=True) \
            / mf.sum(dim=1, keepdim=True).clamp_min(1.0)
        xs = torch.cat([pool, x.float()], dim=1).to(x.dtype)
        k, v = self.to_kv(xs).chunk(2, dim=-1)
        q = self.to_q(xs[:, :1]).unflatten(-1, (self.heads, -1))
        k = k.unflatten(-1, (self.heads, -1))
        v = v.unflatten(-1, (self.heads, -1))
        full = torch.cat([mask.new_ones((b, 1)), mask.bool()], dim=1)
        bias = torch.where(full, 0.0, float("-inf"))[:, None, None, :]
        o = dot_product_attention(q, k, v, bias=bias)
        return self.to_out(o.reshape(b, d))


class MochiBlock(nn.Module):
    """The asymmetric joint block: one attention over [visual; text] at
    the visual width, scale-only RMS modulation, tanh-gated residuals.
    With ``update_y`` False (the last block) the text stream is left as
    it is and its modulation gives the attention's scale alone."""

    def __init__(self, dim_x: int, dim_y: int, heads: int,
                 mlp_ratio_x: float = 4.0, mlp_ratio_y: float = 4.0,
                 update_y: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.update_y = heads, update_y
        hd = dim_x // heads
        self.mod_x = nn.Linear(dim_x, 4 * dim_x, dtype=dtype)
        self.mod_y = nn.Linear(dim_x, (4 if update_y else 1) * dim_y,
                               dtype=dtype)
        for n, din in (("q_x", dim_x), ("k_x", dim_x), ("v_x", dim_x),
                       ("q_y", dim_y), ("k_y", dim_y), ("v_y", dim_y)):
            self.add_module(n, dense_general(din, heads, hd, False, dtype))
        for n in ("norm_q_x", "norm_k_x", "norm_q_y", "norm_k_y"):
            self.add_module(n, RMSNorm(hd, dtype=dtype))
        self.proj_x = nn.Linear(dim_x, dim_x, dtype=dtype)
        hx = int(dim_x * mlp_ratio_x)
        self.ff_x_in = nn.Linear(dim_x, 2 * hx, bias=False, dtype=dtype)
        self.ff_x_out = nn.Linear(hx, dim_x, bias=False, dtype=dtype)
        if update_y:
            self.proj_y = nn.Linear(dim_x, dim_y, dtype=dtype)
            hy = int(dim_y * mlp_ratio_y)
            self.ff_y_in = nn.Linear(dim_y, 2 * hy, bias=False, dtype=dtype)
            self.ff_y_out = nn.Linear(hy, dim_y, bias=False, dtype=dtype)

    def _heads(self, z: torch.Tensor) -> torch.Tensor:
        return z.unflatten(-1, (self.heads, -1))

    @staticmethod
    def _swiglu(z: torch.Tensor, fc_in: nn.Linear,
                fc_out: nn.Linear) -> torch.Tensor:
        val, gate = fc_in(z).chunk(2, dim=-1)
        return fc_out(val * F.silu(gate))

    def forward(self, x: torch.Tensor, y: torch.Tensor, c: torch.Tensor,
                cos: torch.Tensor, sin: torch.Tensor,
                txt_mask: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cs = F.silu(c)
        sc_msa_x, g_msa_x, sc_mlp_x, g_mlp_x = self.mod_x(cs).chunk(4, -1)
        if self.update_y:
            sc_msa_y, g_msa_y, sc_mlp_y, g_mlp_y = self.mod_y(cs).chunk(4,
                                                                      -1)
        else:
            sc_msa_y = self.mod_y(cs)

        xm = modulated_rmsnorm(x, sc_msa_x)
        ym = modulated_rmsnorm(y, sc_msa_y)
        qx = apply_rope_perhead(self.norm_q_x(self._heads(self.q_x(xm))),
                                cos, sin)
        kx = apply_rope_perhead(self.norm_k_x(self._heads(self.k_x(xm))),
                                cos, sin)
        q = torch.cat([qx, self.norm_q_y(self._heads(self.q_y(ym)))], dim=1)
        k = torch.cat([kx, self.norm_k_y(self._heads(self.k_y(ym)))], dim=1)
        v = torch.cat([self._heads(self.v_x(xm)),
                       self._heads(self.v_y(ym))], dim=1)
        del qx, kx, xm, ym
        sx = x.shape[1]
        kv_valid = None
        if txt_mask is not None:
            kv_valid = torch.cat([txt_mask.new_ones((x.shape[0], sx)),
                                  txt_mask.bool()], dim=1)
        att = dot_product_attention(q, k, v, kv_valid=kv_valid,
                                    bounded_logits=True).flatten(-2)
        del q, k, v
        x = residual_tanh_gated_rmsnorm(x, self.proj_x(att[:, :sx]), g_msa_x)
        if self.update_y:
            y = residual_tanh_gated_rmsnorm(y, self.proj_y(att[:, sx:]),
                                            g_msa_y)
        del att
        x = residual_tanh_gated_rmsnorm(
            x, self._swiglu(modulated_rmsnorm(x, sc_mlp_x), self.ff_x_in,
                            self.ff_x_out), g_mlp_x)
        if self.update_y:
            y = residual_tanh_gated_rmsnorm(
                y, self._swiglu(modulated_rmsnorm(y, sc_mlp_y),
                                self.ff_y_in, self.ff_y_out), g_mlp_y)
        return x, y


@register("videotuna_tpu_torch.models.MochiDiT",
          aliases=["diffusers.MochiTransformer3DModel"])
class MochiDiT(nn.Module):
    def __init__(self, in_channels: int = 12,
                 out_channels: Optional[int] = None, dim: int = 3072,
                 dim_y: int = 1536, depth: int = 48, heads: int = 24,
                 patch_size: int = 2, caption_channels: int = 4096,
                 mlp_ratio_x: float = 4.0, mlp_ratio_y: float = 4.0,
                 rope_target_area: float = 36864.0,
                 dtype: Union[str, torch.dtype] = torch.float32,
                 scan_blocks: bool = True, remat: bool = False):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.in_channels = in_channels
        self.out_channels = out_channels or in_channels
        self.dim, self.heads, self.depth = dim, heads, depth
        self.patch_size = patch_size
        self.caption_channels = caption_channels
        self.rope_target_area = rope_target_area
        self.dtype = dtype
        # the JAX layout stacks the first depth − 1 blocks when they are
        # more than one
        self.scan_blocks = scan_blocks and depth - 1 > 1
        self.remat = remat
        self.patch_embed = nn.Linear(patch_size ** 2 * in_channels, dim,
                                     dtype=dtype)
        self.t_embedder = TimestepEmbedder(dim, dtype=dtype)
        self.t5_pool = MochiAttentionPool(caption_channels, out_dim=dim,
                                          dtype=dtype)
        self.caption_proj = nn.Linear(caption_channels, dim_y, dtype=dtype)
        self.pos_frequencies = nn.Parameter(
            torch.zeros(3, heads, dim // heads // 2))
        kw = dict(dim_x=dim, dim_y=dim_y, heads=heads,
                  mlp_ratio_x=mlp_ratio_x, mlp_ratio_y=mlp_ratio_y,
                  dtype=dtype)
        self.blocks = nn.ModuleList(MochiBlock(**kw)
                                    for _ in range(depth - 1))
        self.add_module(f"block_{depth - 1}",
                        MochiBlock(**kw, update_y=False))
        self.final_mod = nn.Linear(dim, 2 * dim, dtype=dtype)
        self.final_norm = LayerNorm(dim, eps=1e-6, affine=False)
        self.final_proj = nn.Linear(dim, patch_size ** 2 * self.out_channels,
                                    dtype=dtype)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                text_states: torch.Tensor,
                text_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, T, H, W, C) latents, t (B,), text_states (B, L,
        caption_channels), text_mask (B, L) bool → (B, T, H, W,
        out_channels), f32."""
        b, tt, hh, ww, cin = x.shape
        p = self.patch_size
        gt, gh, gw = tt, hh // p, ww // p
        xt = x.to(self.dtype).reshape(b, gt, gh, p, gw, p, cin)
        xt = xt.permute(0, 1, 2, 4, 3, 5, 6).reshape(b, gt * gh * gw,
                                                     p * p * cin)
        xt = self.patch_embed(xt)

        states = text_states.to(self.dtype)
        c = self.t_embedder(t) + self.t5_pool(states, text_mask)
        y = self.caption_proj(states)

        cos, sin = mochi_rope(self.pos_frequencies, mochi_positions(
            gt, gh, gw, self.rope_target_area, device=x.device))
        remat = self.remat and torch.is_grad_enabled()
        for block in self.blocks:
            if remat:
                xt, y = checkpoint(block, xt, y, c, cos, sin, text_mask,
                                   use_reentrant=False,
                                   context_fn=remat_contexts)
            else:
                xt, y = block(xt, y, c, cos, sin, text_mask)
        xt, _ = getattr(self, f"block_{self.depth - 1}")(xt, y, c, cos, sin,
                                                         text_mask)

        # scale first, then shift
        scale, shift = self.final_mod(F.silu(c))[:, None].chunk(2, dim=-1)
        xn = self.final_norm(xt) * (1.0 + scale) + shift
        out = unpatchify_3d(self.final_proj(xn), (gt, gh, gw), (1, p, p),
                            self.out_channels)
        return out.float()
