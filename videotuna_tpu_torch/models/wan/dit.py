"""Wan 2.1 DiT (torch), the counterpart of ``videotuna_tpu/models/wan/dit.py``:
the flow-matching video transformer of the T2V 1.3B / 14B models and I2V.

- patchify (1, 2, 2) → blocks of [self-attention (3D RoPE, q and k
  RMSNormed over the full dim) → cross-attention to the umT5 text (plus the
  CLIP image tokens for I2V) → FFN], each modulated by the block's learned
  6-way table added to the shared time projection;
- time embedding: sinusoidal → MLP → e (dim,), and a 6·dim projection;
- head: a 2-way modulated norm + linear → unpatchify.

Every attention declares bounded logits (q and k are RMSNormed), so under
the flow's fixed max the self-attention, the text cross-attention (queries
over 512 text keys) and the image cross-attention take K3 at d = 128.
Latents are channel-last (B, T, H, W, C) in and f32 out.

``scan_blocks`` names the JAX parameter layout (every leaf stacked under
``blocks``) that ``tools/from_jax.py`` reads; the port holds one module per
block either way.  ``remat`` recomputes each block in the backward with
``torch.utils.checkpoint`` whenever autograd records.  The staged forward
(``stage`` other than "all", the JAX package's compile workaround for the
TPU) is not ported.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from videotuna_tpu_torch.core.config import resolve_dtype
from videotuna_tpu_torch.core.registry import register
from videotuna_tpu_torch.kernels.attention import (dot_product_attention,
                                                   remat_contexts)
from videotuna_tpu_torch.models.layers import (LayerNorm, RMSNorm,
                                               apply_rope, gelu_tanh, rope_3d,
                                               timestep_embedding,
                                               unpatchify_3d, wan_rope_dims)


def _ln(dim: int) -> LayerNorm:
    return LayerNorm(dim, eps=1e-6, affine=False)


class WanBlock(nn.Module):
    """Self-attention with RoPE, cross-attention to the text (and image)
    tokens, FFN; ``modulation`` (6, dim) plus the shared e6 gives the
    shift, scale and gate of the first and the last."""

    def __init__(self, dim: int, heads: int, ffn_dim: int,
                 img: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.heads = dim, heads
        # f32 as in the JAX package: the table is added to e6 in f32
        self.modulation = nn.Parameter(torch.zeros(6, dim))
        self.norm1 = _ln(dim)
        self.norm2 = _ln(dim)
        self.norm3 = LayerNorm(dim, eps=1e-6, dtype=dtype)
        for n in ("self_q", "self_k", "self_v", "self_out", "cross_q",
                  "cross_k", "cross_v", "cross_out"):
            self.add_module(n, nn.Linear(dim, dim, dtype=dtype))
        for n in ("self_q_norm", "self_k_norm", "cross_q_norm",
                  "cross_k_norm"):
            self.add_module(n, RMSNorm(dim, dtype=dtype))
        if img:
            self.cross_k_img = nn.Linear(dim, dim, dtype=dtype)
            self.cross_v_img = nn.Linear(dim, dim, dtype=dtype)
            self.cross_k_img_norm = RMSNorm(dim, dtype=dtype)
        self.ffn1 = nn.Linear(dim, ffn_dim, dtype=dtype)
        self.ffn2 = nn.Linear(ffn_dim, dim, dtype=dtype)

    def _heads(self, z: torch.Tensor) -> torch.Tensor:
        return z.unflatten(-1, (self.heads, -1))

    def forward(self, x: torch.Tensor, e6: torch.Tensor, ctx: torch.Tensor,
                ctx_img: Optional[torch.Tensor], cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
        mods = (self.modulation[None] + e6.float()).to(x.dtype)
        s1, sc1, g1, s2, sc2, g2 = mods.chunk(6, dim=1)

        # self-attention with RoPE; q and k RMSNormed over the full dim
        # before the head split
        h = self.norm1(x) * (1 + sc1) + s1
        q = apply_rope(self._heads(self.self_q_norm(self.self_q(h))),
                       cos, sin)
        k = apply_rope(self._heads(self.self_k_norm(self.self_k(h))),
                       cos, sin)
        v = self._heads(self.self_v(h))
        del h
        att = dot_product_attention(q, k, v, bounded_logits=True)
        del q, k, v
        x = x + g1 * self.self_out(att.flatten(-2))
        del att

        # cross-attention to the text (norm3 has a learned scale and bias)
        q = self._heads(self.cross_q_norm(self.cross_q(self.norm3(x))))
        k = self._heads(self.cross_k_norm(self.cross_k(ctx)))
        v = self._heads(self.cross_v(ctx))
        out = dot_product_attention(q, k, v, bounded_logits=True)
        if ctx_img is not None:
            k_i = self._heads(self.cross_k_img_norm(self.cross_k_img(
                ctx_img)))
            v_i = self._heads(self.cross_v_img(ctx_img))
            out = out + dot_product_attention(q, k_i, v_i,
                                              bounded_logits=True)
        del q, k, v
        x = x + self.cross_out(out.flatten(-2))
        del out

        h = self.ffn1(self.norm2(x) * (1 + sc2) + s2)
        return x + g2 * self.ffn2(gelu_tanh(h))


@register("videotuna_tpu_torch.models.wan.WanModel",
          aliases=["videotuna.models.wan.wan.modules.model.WanModel"])
class WanModel(nn.Module):
    """Defaults ≈ 1.3B (dim 1536, 30 layers, 12 heads); 14B: dim 5120, 40
    layers, 40 heads, ffn 13,824.  ``img_dim`` (the CLIP feature width)
    adds the I2V image branch."""

    def __init__(self, in_channels: int = 16, out_channels: int = 16,
                 dim: int = 1536, ffn_dim: int = 8960, num_layers: int = 30,
                 heads: int = 12, text_dim: int = 4096,
                 img_dim: Optional[int] = None,
                 patch_size: Sequence[int] = (1, 2, 2), freq_dim: int = 256,
                 rope_theta: float = 10000.0,
                 dtype: Union[str, torch.dtype] = torch.float32,
                 scan_blocks: bool = False, remat: bool = False):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.in_channels, self.out_channels = in_channels, out_channels
        self.dim, self.heads = dim, heads
        self.img_dim = img_dim
        self.patch_size = tuple(patch_size)
        self.freq_dim = freq_dim
        self.rope_theta = rope_theta
        self.dtype = dtype
        self.scan_blocks = scan_blocks
        self.remat = remat
        self.time_fc1 = nn.Linear(freq_dim, dim, dtype=dtype)
        self.time_fc2 = nn.Linear(dim, dim, dtype=dtype)
        self.time_projection = nn.Linear(dim, 6 * dim, dtype=dtype)
        self.patch_embedding = nn.Conv3d(in_channels, dim, self.patch_size,
                                         stride=self.patch_size, dtype=dtype)
        self.text_fc1 = nn.Linear(text_dim, dim, dtype=dtype)
        self.text_fc2 = nn.Linear(dim, dim, dtype=dtype)
        if img_dim is not None:
            self.img_fc1 = nn.Linear(img_dim, dim, dtype=dtype)
            self.img_fc2 = nn.Linear(dim, dim, dtype=dtype)
        self.blocks = nn.ModuleList(
            WanBlock(dim, heads, ffn_dim, img=img_dim is not None,
                     dtype=dtype)
            for _ in range(num_layers))
        self.head_modulation = nn.Parameter(torch.zeros(2, dim))
        self.head_norm = _ln(dim)
        self.head_out = nn.Linear(
            dim, math.prod(self.patch_size) * out_channels, dtype=dtype)

    def forward(self, x: torch.Tensor, timestep: torch.Tensor,
                context: torch.Tensor,
                context_img: Optional[torch.Tensor] = None,
                stage: str = "all") -> torch.Tensor:
        """x (B, T, H, W, C) latents, timestep (B,), context (B, Lt,
        text_dim) text states, context_img (B, Li, img_dim) CLIP tokens →
        velocity (B, T, H, W, out_channels), f32."""
        if stage != "all":
            raise NotImplementedError(
                f"WanModel stage={stage!r} is the JAX package's staged "
                "compile for the TPU; the port runs stage='all'")
        b, t_in, h_in, w_in, _ = x.shape
        pt, ph, pw = self.patch_size
        tt, hh, ww = t_in // pt, h_in // ph, w_in // pw
        d = self.dim

        te = timestep_embedding(timestep, self.freq_dim).to(self.dtype)
        e = self.time_fc2(F.silu(self.time_fc1(te)))
        e6 = self.time_projection(F.silu(e)).reshape(b, 6, d)

        tok = self.patch_embedding(x.to(self.dtype).permute(0, 4, 1, 2, 3))
        tok = tok.flatten(2).transpose(1, 2)

        ctx = self.text_fc2(gelu_tanh(self.text_fc1(
            context.to(self.dtype))))
        ctx_img = None
        if context_img is not None and self.img_dim is not None:
            ctx_img = self.img_fc2(gelu_tanh(self.img_fc1(
                context_img.to(self.dtype))))

        cos, sin = rope_3d(*wan_rope_dims(d // self.heads), tt, hh, ww,
                           theta=self.rope_theta, device=x.device)
        cos, sin = cos.to(self.dtype), sin.to(self.dtype)
        remat = self.remat and torch.is_grad_enabled()
        for block in self.blocks:
            if remat:
                tok = checkpoint(block, tok, e6, ctx, ctx_img, cos, sin,
                                 use_reentrant=False,
                                 context_fn=remat_contexts)
            else:
                tok = block(tok, e6, ctx, ctx_img, cos, sin)

        # the time embedding e is added to both head rows directly
        hm = (self.head_modulation[None] + e.float()[:, None]).to(self.dtype)
        shift, scale = hm.chunk(2, dim=1)
        tok = self.head_norm(tok) * (1 + scale) + shift
        out = unpatchify_3d(self.head_out(tok), (tt, hh, ww),
                            self.patch_size, self.out_channels)
        return out.float()
