"""CogVideoX MMDiT (torch): joint text+video transformer, the counterpart of
``videotuna_tpu/models/cogvideo/mmdit.py``.

Text tokens are projected and concatenated before the video tokens; every
block runs one joint self-attention over [text; video] with per-modality
adaLN (separate shift/scale/gate for the two segments) and per-head
qk-LayerNorm, so the attention logits are bounded and the fixed-max flash
kernel (K1 at head_dim 64) applies.  3D RoPE on the video segment (5B) or a
learned pos-embed (2B); adaLN final norm → unpatchify; v-prediction.
Activations are channel-last, (B, T, H, W, C) in and out.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from videotuna_tpu_torch.core.config import resolve_dtype
from videotuna_tpu_torch.core.registry import register
from videotuna_tpu_torch.kernels.attention import (dot_product_attention,
                                                   remat_contexts)
from videotuna_tpu_torch.models.layers import (LayerNorm, TimestepEmbedder,
                                               apply_rope, dense_general,
                                               rope_3d, split_rope_dims,
                                               unpatchify_3d)


class CogVideoXBlock(nn.Module):
    def __init__(self, dim: int, heads: int, time_embed_dim: int,
                 mlp_ratio: float = 4.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim = dim
        self.heads = heads
        # two CogVideoXLayerNormZero linears, each emitting 6 chunks in the
        # diffusers order (video shift/scale/gate, then text shift/scale/gate)
        self.norm1_mod = nn.Linear(time_embed_dim, 6 * dim, dtype=dtype)
        self.norm2_mod = nn.Linear(time_embed_dim, 6 * dim, dtype=dtype)
        self.norm1 = LayerNorm(dim, affine=False, dtype=dtype)
        self.norm2 = LayerNorm(dim, affine=False, dtype=dtype)
        self.q = dense_general(dim, heads, dim // heads, dtype=dtype)
        self.k = dense_general(dim, heads, dim // heads, dtype=dtype)
        self.v = dense_general(dim, heads, dim // heads, dtype=dtype)
        # diffusers CogVideoX: qk_norm="layer_norm" over head_dim
        self.q_norm = LayerNorm(dim // heads, dtype=dtype)
        self.k_norm = LayerNorm(dim // heads, dtype=dtype)
        self.attn_out = nn.Linear(dim, dim, dtype=dtype)
        self.ff1 = nn.Linear(dim, int(dim * mlp_ratio), dtype=dtype)
        self.ff2 = nn.Linear(int(dim * mlp_ratio), dim, dtype=dtype)

    def forward(self, x: torch.Tensor, temb: torch.Tensor, text_len: int,
                rope_cos: Optional[torch.Tensor],
                rope_sin: Optional[torch.Tensor]) -> torch.Tensor:
        """x: (B, L_text + L_vid, D); temb: (B, time_embed_dim); rope tables
        cover the video segment only."""
        b, n, d = x.shape
        lt = text_len
        act = F.silu(temb)
        vs1, vsc1, vg1, ts1, tsc1, tg1 = self.norm1_mod(act).chunk(6, dim=-1)
        vs2, vsc2, vg2, ts2, tsc2, tg2 = self.norm2_mod(act).chunk(6, dim=-1)

        # per-segment modulation as a (1, L, 1) select
        is_text = (torch.arange(n, device=x.device) < lt)[None, :, None]

        def seg_mod(h, tshift, tscale, vshift, vscale):
            scale = torch.where(is_text, tscale[:, None], vscale[:, None])
            shift = torch.where(is_text, tshift[:, None], vshift[:, None])
            return h * (1 + scale) + shift

        def seg_gate(h, tgate, vgate):
            return h * torch.where(is_text, tgate[:, None], vgate[:, None])

        h = seg_mod(self.norm1(x), ts1, tsc1, vs1, vsc1)
        hd = d // self.heads
        q = self.q_norm(self.q(h).view(b, n, self.heads, hd))
        k = self.k_norm(self.k(h).view(b, n, self.heads, hd))
        v = self.v(h).view(b, n, self.heads, hd)
        if rope_cos is not None:
            # identity rotation (cos=1, sin=0) on the text prefix
            full_cos = torch.cat([rope_cos.new_ones(lt, rope_cos.shape[1]),
                                  rope_cos])
            full_sin = torch.cat([rope_sin.new_zeros(lt, rope_sin.shape[1]),
                                  rope_sin])
            q = apply_rope(q, full_cos, full_sin)
            k = apply_rope(k, full_cos, full_sin)
        att = dot_product_attention(q, k, v, bounded_logits=True)
        att = self.attn_out(att.reshape(b, n, d))
        x = x + seg_gate(att, tg1, vg1)

        h = seg_mod(self.norm2(x), ts2, tsc2, vs2, vsc2)
        h = self.ff2(F.gelu(self.ff1(h), approximate="tanh"))
        return x + seg_gate(h, tg2, vg2)


@register("videotuna_tpu_torch.models.cogvideo.CogVideoXTransformer",
          aliases=[
              "diffusers.CogVideoXTransformer3DModel",
              "videotuna.models.cogvideo_hf.CogVideoXTransformer3DModel",
          ])
class CogVideoXTransformer(nn.Module):
    """Defaults ≈ CogVideoX-2b; 5b uses dim 3072 / 42 layers / 48 heads.

    ``video_tokens`` sizes the learned ``pos_embed`` (``use_rope=False``):
    the JAX module sizes it from the input it is initialised with, which is
    the flows' (1, 2, 8, 8) example latent, 32 tokens.  ``scan_blocks``
    names the JAX parameter layout (the blocks stacked under ``blocks``, or
    ``block_{i}``), which ``tools/from_jax.py`` and the LoRA tree follow.
    ``remat`` recomputes each block's forward in the backward
    (``torch.utils.checkpoint``, the JAX package's ``nn.remat``) whenever
    autograd records."""

    def __init__(self, in_channels: int = 16, out_channels: int = 16,
                 dim: int = 1920, num_layers: int = 30, heads: int = 30,
                 text_dim: int = 4096, max_text_len: int = 226,
                 patch_size: Sequence[int] = (1, 2, 2),
                 mlp_ratio: float = 4.0, time_embed_dim: int = 512,
                 use_rope: bool = True,
                 dtype: Union[str, torch.dtype] = torch.float32,
                 scan_blocks: bool = False, remat: bool = False,
                 video_tokens: int = 32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.out_channels = out_channels
        self.dim = dim
        self.heads = heads
        self.patch_size = tuple(patch_size)
        self.use_rope = use_rope
        self.dtype = dtype
        self.scan_blocks = scan_blocks
        self.remat = remat
        self.t_embedder = TimestepEmbedder(time_embed_dim, dtype=dtype)
        self.patch_embed = nn.Conv3d(in_channels, dim, self.patch_size,
                                     stride=self.patch_size, dtype=dtype)
        self.text_proj = nn.Linear(text_dim, dim, dtype=dtype)
        if not use_rope:
            self.pos_embed = nn.Parameter(
                torch.zeros(video_tokens, dim, dtype=torch.float32))
        self.blocks = nn.ModuleList(
            CogVideoXBlock(dim, heads, time_embed_dim, mlp_ratio, dtype)
            for _ in range(num_layers))
        self.norm_final = LayerNorm(dim, dtype=dtype)
        pt, ph, pw = self.patch_size
        self.adaln_out = nn.Linear(time_embed_dim, 2 * dim, dtype=dtype)
        self.proj_out = nn.Linear(dim, pt * ph * pw * out_channels,
                                  dtype=dtype)

    def forward(self, x: torch.Tensor, timestep: torch.Tensor,
                text_states: torch.Tensor) -> torch.Tensor:
        """x: (B, T, H, W, C) latents; timestep (B,); text_states
        (B, L, text_dim) → (B, T, H, W, C_out) f32."""
        b, t_in, h_in, w_in, _ = x.shape
        pt, ph, pw = self.patch_size
        tt, hh, ww = t_in // pt, h_in // ph, w_in // pw
        lt = text_states.shape[1]

        temb = self.t_embedder(timestep)
        xv = self.patch_embed(x.to(self.dtype).permute(0, 4, 1, 2, 3))
        xv = xv.flatten(2).transpose(1, 2)              # (B, tt·hh·ww, D)
        xt = self.text_proj(text_states.to(self.dtype))
        tok = torch.cat([xt, xv], dim=1)

        rope_cos = rope_sin = None
        if self.use_rope:
            dt, dh, dw = split_rope_dims(self.dim // self.heads)
            rope_cos, rope_sin = rope_3d(dt, dh, dw, tt, hh, ww,
                                         device=x.device)
            rope_cos = rope_cos.to(self.dtype)
            rope_sin = rope_sin.to(self.dtype)
        else:
            tok = torch.cat([tok[:, :lt],
                             tok[:, lt:] + self.pos_embed.to(self.dtype)],
                            dim=1)

        remat = self.remat and torch.is_grad_enabled()
        for block in self.blocks:
            if remat:
                tok = checkpoint(block, tok, temb, lt, rope_cos, rope_sin,
                                 use_reentrant=False,
                                 context_fn=remat_contexts)
            else:
                tok = block(tok, temb, lt, rope_cos, rope_sin)

        tok = self.norm_final(tok)
        shift, scale = self.adaln_out(F.silu(temb)).chunk(2, dim=-1)
        xv = tok[:, lt:] * (1 + scale[:, None]) + shift[:, None]
        xv = self.proj_out(xv)
        out = unpatchify_3d(xv, (tt, hh, ww), self.patch_size,
                            self.out_channels)
        return out.float()
