"""StepVideo DiT (torch), the counterpart of
``videotuna_tpu/models/stepvideo/dit.py``: the 30B flow-matching video
transformer of Step-Video-T2V (dim 6144, 48 heads of d = 128, 48 layers,
FFN 24,576).

A block: affine LayerNorm (eps 1e-5) → adaLN modulate → self-attention
(q, k, v over heads, per-head q/k RMSNorm, StepVideo's grouped rotate-half
RoPE on the (64, 32, 32) channel split) → gated residual; cross-attention
read off the residual stream itself, no pre-norm, with its own q/k
RMSNorms → ungated residual; affine LayerNorm → modulate → tanh-GELU FFN
without biases → gated residual.  Around the blocks: PixArt's adaLN-single
(the timestep's 256-d sinusoid through a 2-layer MLP, then a 6·dim
projection), the caption path (a LayerNorm without affine, eps 1e-6, then
a 2-layer tanh-GELU projection), the CLIP states projected and put before
the caption tokens, the final scale/shift table over a LayerNorm without
affine.

Attention: both declare bounded logits (q and k are RMSNormed), but the
StepVideo flow sets no fixed max, so they run the online softmax: the
self-attention on route K2, the cross-attention over the caption with its
key mask on route K4 (the CLIP tokens always valid).  Latents are
channel-last (B, T, H, W, C) in and f32 out.

``scan_blocks`` names the JAX parameter layout (every leaf stacked under
``blocks``) that ``tools/from_jax.py`` reads; the port holds one module per
block either way.  ``remat`` recomputes each block in the backward with
``torch.utils.checkpoint`` whenever autograd records.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from videotuna_tpu_torch.core.config import resolve_dtype
from videotuna_tpu_torch.core.registry import register
from videotuna_tpu_torch.kernels.attention import (dot_product_attention,
                                                   remat_contexts)
from videotuna_tpu_torch.models.layers import (STEPVIDEO_ROPE_DIMS,
                                               LayerNorm, RMSNorm,
                                               TimestepEmbedder,
                                               apply_rope_3d_grouped,
                                               dense_general, gelu_tanh,
                                               rope_3d_axis_tables,
                                               split_rope_dims,
                                               unpatchify_3d)


class StepVideoBlock(nn.Module):
    def __init__(self, dim: int, heads: int, ffn_dim: int,
                 rope_dims: Sequence[int] = STEPVIDEO_ROPE_DIMS,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.rope_dims = heads, tuple(rope_dims)
        hd = dim // heads
        # f32 as in the JAX package: the table is added to t6 in f32
        self.scale_shift_table = nn.Parameter(torch.zeros(6, dim))
        self.norm1 = LayerNorm(dim, eps=1e-5, dtype=dtype)
        self.norm2 = LayerNorm(dim, eps=1e-5, dtype=dtype)
        for n in ("self_q", "self_k", "self_v", "cross_q", "cross_k",
                  "cross_v"):
            self.add_module(n, dense_general(dim, heads, hd, False, dtype))
        for n in ("q_norm", "k_norm", "cross_q_norm", "cross_k_norm"):
            self.add_module(n, RMSNorm(hd, dtype=dtype))
        self.self_out = nn.Linear(dim, dim, bias=False, dtype=dtype)
        self.cross_out = nn.Linear(dim, dim, bias=False, dtype=dtype)
        self.ffn1 = nn.Linear(dim, ffn_dim, bias=False, dtype=dtype)
        self.ffn2 = nn.Linear(ffn_dim, dim, bias=False, dtype=dtype)

    def _heads(self, z: torch.Tensor) -> torch.Tensor:
        return z.unflatten(-1, (self.heads, -1))

    def forward(self, x: torch.Tensor, t6: torch.Tensor, ctx: torch.Tensor,
                tables: Tuple[Tuple[torch.Tensor, torch.Tensor], ...],
                ctx_valid: Optional[torch.Tensor]) -> torch.Tensor:
        mods = (self.scale_shift_table[None] + t6.float()).to(x.dtype)
        s1, sc1, g1, s2, sc2, g2 = mods.chunk(6, dim=1)

        h = self.norm1(x) * (1 + sc1) + s1
        q = self.q_norm(self._heads(self.self_q(h)))
        k = self.k_norm(self._heads(self.self_k(h)))
        v = self._heads(self.self_v(h))
        del h
        q = apply_rope_3d_grouped(q, tables, self.rope_dims)
        k = apply_rope_3d_grouped(k, tables, self.rope_dims)
        att = dot_product_attention(q, k, v, bounded_logits=True)
        del q, k, v
        x = x + g1 * self.self_out(att.flatten(-2))
        del att

        # cross-attention off the residual stream (no pre-norm), ungated
        q = self.cross_q_norm(self._heads(self.cross_q(x)))
        k = self.cross_k_norm(self._heads(self.cross_k(ctx)))
        v = self._heads(self.cross_v(ctx))
        out = dot_product_attention(q, k, v, kv_valid=ctx_valid,
                                    bounded_logits=True)
        del q, k, v
        x = x + self.cross_out(out.flatten(-2))
        del out

        h = self.ffn1(self.norm2(x) * (1 + sc2) + s2)
        return x + g2 * self.ffn2(gelu_tanh(h))


@register("videotuna_tpu_torch.models.stepvideo.StepVideoModel",
          aliases=["videotuna.models.stepvideo.stepvideo.modules.model."
                   "StepVideoModel"])
class StepVideoModel(nn.Module):
    def __init__(self, in_channels: int = 64, out_channels: int = 64,
                 dim: int = 6144, ffn_dim: int = 24576, num_layers: int = 48,
                 heads: int = 48, text_dim: int = 6144,
                 clip_dim: Optional[int] = 1024,
                 patch_size: Sequence[int] = (1, 1, 1),
                 rope_theta: float = 10000.0,
                 dtype: Union[str, torch.dtype] = torch.float32,
                 scan_blocks: bool = False, remat: bool = False):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.in_channels, self.out_channels = in_channels, out_channels
        self.dim, self.heads = dim, heads
        self.clip_dim = clip_dim
        self.patch_size = tuple(patch_size)
        self.rope_theta = rope_theta
        self.dtype = dtype
        self.scan_blocks = scan_blocks
        self.remat = remat
        hd = dim // heads
        self.rope_dims = (STEPVIDEO_ROPE_DIMS
                          if hd == sum(STEPVIDEO_ROPE_DIMS)
                          else split_rope_dims(hd))
        self.t_embedder = TimestepEmbedder(dim, dtype=dtype)
        self.t_block = nn.Linear(dim, 6 * dim, dtype=dtype)
        self.patch_embed = nn.Conv3d(in_channels, dim, self.patch_size,
                                     stride=self.patch_size, dtype=dtype)
        self.caption_norm = LayerNorm(text_dim, eps=1e-6, affine=False)
        self.caption_fc1 = nn.Linear(text_dim, dim, dtype=dtype)
        self.caption_fc2 = nn.Linear(dim, dim, dtype=dtype)
        if clip_dim is not None:
            self.clip_proj = nn.Linear(clip_dim, dim, dtype=dtype)
        self.blocks = nn.ModuleList(
            StepVideoBlock(dim, heads, ffn_dim, self.rope_dims, dtype)
            for _ in range(num_layers))
        self.final_scale_shift_table = nn.Parameter(torch.zeros(2, dim))
        self.final_norm = LayerNorm(dim, eps=1e-6, affine=False)
        self.final_proj = nn.Linear(
            dim, math.prod(self.patch_size) * out_channels, dtype=dtype)

    def forward(self, x: torch.Tensor, timestep: torch.Tensor,
                context: torch.Tensor,
                context_2: Optional[torch.Tensor] = None,
                context_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, T, H, W, C) latents; timestep (B,) already ×1000; context
        (B, L, text_dim) StepLLM states; context_2 (B, L2, clip_dim) CLIP
        states, projected and put before the caption tokens; context_mask
        (B, L) bool over the caption tokens (the CLIP tokens always
        attended) → velocity (B, T, H, W, out_channels), f32."""
        b, t_in, h_in, w_in, _ = x.shape
        pt, ph, pw = self.patch_size
        tt, hh, ww = t_in // pt, h_in // ph, w_in // pw
        d = self.dim

        temb = self.t_embedder(timestep)
        t6 = self.t_block(F.silu(temb)).reshape(b, 6, d)

        tok = self.patch_embed(x.to(self.dtype).permute(0, 4, 1, 2, 3))
        tok = tok.flatten(2).transpose(1, 2)

        cap = self.caption_norm(context.to(self.dtype))
        ctx = self.caption_fc2(gelu_tanh(self.caption_fc1(cap)))
        if context_2 is not None:
            clip = self.clip_proj(context_2.to(self.dtype))
            ctx = torch.cat([clip, ctx], dim=1)
        ctx_valid = None
        if context_mask is not None:
            ctx_valid = context_mask.bool()
            if context_2 is not None:
                ctx_valid = torch.cat([ctx_valid.new_ones(
                    (b, context_2.shape[1])), ctx_valid], dim=1)

        tables = tuple((c.to(self.dtype), s.to(self.dtype))
                       for c, s in rope_3d_axis_tables(
                           self.rope_dims, (tt, hh, ww),
                           theta=self.rope_theta, device=x.device))
        remat = self.remat and torch.is_grad_enabled()
        for block in self.blocks:
            if remat:
                tok = checkpoint(block, tok, t6, ctx, tables, ctx_valid,
                                 use_reentrant=False,
                                 context_fn=remat_contexts)
            else:
                tok = block(tok, t6, ctx, tables, ctx_valid)

        # the final modulation reads the embedded timestep, not t6;
        # shift first
        fm = (self.final_scale_shift_table[None]
              + temb.float()[:, None]).to(self.dtype)
        shift, scale = fm.chunk(2, dim=1)
        tok = self.final_norm(tok) * (1 + scale) + shift
        out = unpatchify_3d(self.final_proj(tok), (tt, hh, ww),
                            self.patch_size, self.out_channels)
        return out.float()
