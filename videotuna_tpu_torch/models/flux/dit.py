"""Flux (torch), the counterpart of ``videotuna_tpu/models/flux/dit.py``: the
rectified-flow image DiT of Flux dev and schnell.

HunyuanVideo's architecture descends from Flux, so the blocks are the port's
``MMDoubleStreamBlock`` and ``MMSingleStreamBlock`` (``models/hunyuan/
dit.py``) with 2D (h, w) RoPE tables instead of 3D:

- conditioning vector = timestep·1000 (``time_in``) ⊕ the pooled CLIP vector
  (``vector_in``, a two-layer MLP, only when given) ⊕ the embedded guidance·
  1000 (``guidance_in``, only with ``guidance_embed`` and a guidance given);
- the packed latents (B, H', W', 64) and the T5 states through ``img_in`` and
  ``txt_in`` (linears), the tokens the flattened patch grid;
- RoPE over (1, H', W') with BFL's axes (16, 56, 56) at head_dim 128: the
  16-dim axis rotates over a position that is always 0, so it is the
  identity, as are the text rows of the single blocks' table;
- the un-affine ``final_norm`` with the ``final_mod`` shift and scale, then
  ``final_proj`` (zero-initialised, as in the JAX package), f32 out.

Flux's flow sets no fixed max, so every joint attention takes the online
softmax: K2 in sampling and K5 (with the LSE) under autograd, both at d=128
on K3's Hopper kernel.  ``scan_blocks`` names the JAX parameter layout
(leaves stacked under ``double_blocks`` / ``single_blocks``) that
``tools/from_jax.py`` reads; ``remat`` recomputes each block in the
backward with ``torch.utils.checkpoint`` whenever autograd records.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from videotuna_tpu_torch.core.config import resolve_dtype
from videotuna_tpu_torch.core.registry import register
from videotuna_tpu_torch.kernels.attention import remat_contexts
from videotuna_tpu_torch.models.hunyuan.dit import (MMDoubleStreamBlock,
                                                    MMSingleStreamBlock, _ln,
                                                    _mods)
from videotuna_tpu_torch.models.layers import (HUNYUAN_ROPE_DIMS,
                                               TimestepEmbedder, rope_3d)


class MLPEmbedder(nn.Module):
    """BFL's MLPEmbedder (in_layer → silu → out_layer) under the names
    ``fc1`` / ``fc2`` of ``TimestepEmbedder``."""

    def __init__(self, din: int, hidden: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = nn.Linear(din, hidden, dtype=dtype)
        self.fc2 = nn.Linear(hidden, hidden, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the bias's dtype: an int8-quantized fc1 keeps no weight
        return self.fc2(F.silu(self.fc1(x.to(self.fc1.bias.dtype))))


def flux_rope_dims(head_dim: int) -> Tuple[int, int, int]:
    """BFL's axes (16, 56, 56) at head_dim 128, else the JAX package's
    derived split: the first axis about head_dim/8, even, with the rest
    split evenly in multiples of 2."""
    if head_dim == 128:
        return HUNYUAN_ROPE_DIMS
    dt = head_dim // 8
    while dt > 0 and (dt % 2 or (head_dim - dt) % 4):
        dt -= 1
    dh = (head_dim - dt) // 2
    return dt, dh, dh


@register("videotuna_tpu_torch.models.flux.FluxModel",
          aliases=["videotuna.models.flux.model.Flux",
                   "diffusers.FluxTransformer2DModel"])
class FluxModel(nn.Module):
    """Flux's DiT; flux-dev is dim 3072, 24 heads, 19 double and 38 single
    blocks, in_channels 64 (2×2-packed 16-channel latents)."""

    def __init__(self, in_channels: int = 64, dim: int = 3072,
                 heads: int = 24, double_blocks: int = 19,
                 single_blocks: int = 38, mlp_ratio: float = 4.0,
                 text_dim: int = 4096, pooled_dim: int = 768,
                 guidance_embed: bool = True, rope_theta: float = 10000.0,
                 rope_dims: Optional[Sequence[int]] = None,
                 dtype: Union[str, torch.dtype] = torch.float32,
                 scan_blocks: bool = False, remat: bool = False):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.in_channels = in_channels
        self.dim, self.heads = dim, heads
        self.guidance_embed = guidance_embed
        self.rope_theta = rope_theta
        self.rope_dims = (tuple(rope_dims) if rope_dims is not None
                          else flux_rope_dims(dim // heads))
        if sum(self.rope_dims) != dim // heads:
            raise ValueError(f"rope dims {self.rope_dims} do not sum to "
                             f"head_dim {dim // heads}")
        self.dtype = dtype
        self.scan_blocks = scan_blocks
        self.remat = remat
        self.time_in = TimestepEmbedder(dim, dtype=dtype)
        self.vector_in = MLPEmbedder(pooled_dim, dim, dtype=dtype)
        if guidance_embed:
            self.guidance_in = TimestepEmbedder(dim, dtype=dtype)
        self.img_in = nn.Linear(in_channels, dim, dtype=dtype)
        self.txt_in = nn.Linear(text_dim, dim, dtype=dtype)
        self.double_blocks = nn.ModuleList(
            MMDoubleStreamBlock(dim, heads, mlp_ratio, dtype=dtype)
            for _ in range(double_blocks))
        self.single_blocks = nn.ModuleList(
            MMSingleStreamBlock(dim, heads, mlp_ratio, dtype=dtype)
            for _ in range(single_blocks))
        self.final_mod = nn.Linear(dim, 2 * dim, dtype=dtype)
        self.final_norm = _ln(dim)
        self.final_proj = nn.Linear(dim, in_channels, dtype=dtype)
        # zero-initialised by models.layers.init_weights_, as flax's zeros
        self.final_proj.zero_init = True

    def forward(self, x: torch.Tensor, timestep: torch.Tensor,
                text_states: torch.Tensor,
                pooled_text: Optional[torch.Tensor] = None,
                guidance: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, H', W', C) packed latents, timestep (B,) in [0, 1],
        text_states (B, L, text_dim), pooled_text (B, pooled_dim), guidance
        (B,) → velocity (B, H', W', C), f32."""
        b, hh, ww, c = x.shape
        vec = self.time_in(timestep * 1000.0)
        if pooled_text is not None:
            vec = vec + self.vector_in(pooled_text)
        if self.guidance_embed and guidance is not None:
            vec = vec + self.guidance_in(guidance * 1000.0)
        img = self.img_in(x.to(self.dtype)).reshape(b, hh * ww, self.dim)
        txt = self.txt_in(text_states.to(self.dtype))

        cos, sin = rope_3d(*self.rope_dims, 1, hh, ww, theta=self.rope_theta,
                           device=x.device)
        cos, sin = cos.to(self.dtype), sin.to(self.dtype)
        lt = txt.shape[1]
        cos_full = torch.cat([cos, cos.new_ones((lt, cos.shape[1]))])
        sin_full = torch.cat([sin, sin.new_zeros((lt, sin.shape[1]))])
        remat = self.remat and torch.is_grad_enabled()

        def run(block, *args):
            if remat:
                return checkpoint(block, *args, use_reentrant=False,
                                  context_fn=remat_contexts)
            return block(*args)

        for block in self.double_blocks:
            img, txt = run(block, img, txt, vec, cos, sin)
        xcat = torch.cat([img, txt], dim=1)
        del img, txt
        for block in self.single_blocks:
            xcat = run(block, xcat, vec, cos_full, sin_full)

        shift, scale = _mods(self.final_mod, vec, 2)
        img = self.final_norm(xcat[:, :hh * ww]) * (1 + scale) + shift
        return self.final_proj(img).reshape(b, hh, ww, c).float()
