"""DynamiCrafter's image conditioning (torch), the counterpart of
``videotuna_tpu/models/lvdm/image_cond.py``: the CLIP ViT image encoder's
patch tokens, a perceiver resampler with learned queries, the linear
``ImageProjModel``, and ``ImageConditioner`` (the encoder and the
resampler as one ``cond_stage_2``).  Wan 2.1 I2V uses ``CLIPImageEmbedder``
alone.

The ViT runs in f32: at ViT-H/14 (224 px, 256 patch tokens, 16 heads of
d = 80) its attention takes K2 on ``csrc/flash_fwd.cu``; the resampler's 16
queries stay on the plain math (fewer than 128 tokens).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from videotuna_tpu_torch.core.config import resolve_dtype
from videotuna_tpu_torch.core.registry import register
from videotuna_tpu_torch.kernels.attention import dot_product_attention
from videotuna_tpu_torch.models.layers import (LayerNorm, dense_general,
                                               gelu_tanh)


def _ln(dim: int, dtype: torch.dtype) -> LayerNorm:
    return LayerNorm(dim, eps=1e-6, dtype=dtype)   # flax's default epsilon


def _bilinear_weights(n_in: int, n_out: int,
                      device: torch.device) -> torch.Tensor:
    """(n_out, n_in) interpolation matrix of ``jax.image.resize``'s
    "bilinear" (a triangle kernel, widened by n_in / n_out when shrinking:
    antialiased), each row normalised, rows whose sample lies outside the
    input zeroed."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = ((torch.arange(n_out, dtype=torch.float32, device=device)
               + 0.5) * inv_scale - 0.5)
    x = (sample[:, None] - torch.arange(n_in, dtype=torch.float32,
                                        device=device)[None]).abs() \
        / kernel_scale
    w = (1.0 - x).clamp_min(0.0)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[:, None], w, 0.0)


def resize_bilinear(images: torch.Tensor,
                    size: Sequence[int]) -> torch.Tensor:
    """(B, H, W, C) → (B, h, w, C) as ``jax.image.resize(…, "bilinear")``
    (antialiased), in f32."""
    wh = _bilinear_weights(images.shape[1], size[0], images.device)
    ww = _bilinear_weights(images.shape[2], size[1], images.device)
    return torch.einsum("bhwc,yh,xw->byxc", images.float(), wh, ww)


@register("videotuna_tpu_torch.models.lvdm.CLIPImageEmbedder",
          aliases=["videotuna.models.lvdm.modules.encoders.condition."
                   "FrozenOpenCLIPImageEmbedderV2"])
class CLIPImageEmbedder(nn.Module):
    """ViT image encoder returning the patch tokens after ``ln_post`` (no
    CLS token, no pooling).  Its position table holds the
    (``image_size`` / ``patch``)² tokens of an ``image_size`` image; an
    image of another size is first resized to it (antialiased bilinear, as
    ``ImageConditioner`` resizes), where the JAX module, whose table is
    sized by its init input, fails (ROADMAP.md queue 3)."""

    def __init__(self, image_size: int = 224, patch: int = 14,
                 dim: int = 1280, heads: int = 16, num_layers: int = 32,
                 dtype: Union[str, torch.dtype] = torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.image_size, self.patch = image_size, patch
        self.dim, self.heads, self.num_layers = dim, heads, num_layers
        self.dtype = dtype
        self.patch_embed = nn.Conv2d(3, dim, patch, stride=patch, bias=False,
                                     dtype=dtype)
        self.pos_embed = nn.Parameter(
            torch.zeros((image_size // patch) ** 2, dim))
        self.ln_pre = _ln(dim, dtype)
        hd = dim // heads
        for i in range(num_layers):
            self.add_module(f"ln1_{i}", _ln(dim, dtype))
            for s in ("q", "k", "v"):
                self.add_module(f"{s}_{i}", dense_general(dim, heads, hd,
                                                          True, dtype))
            self.add_module(f"attn_out_{i}", nn.Linear(dim, dim, dtype=dtype))
            self.add_module(f"ln2_{i}", _ln(dim, dtype))
            self.add_module(f"fc1_{i}", nn.Linear(dim, dim * 4, dtype=dtype))
            self.add_module(f"fc2_{i}", nn.Linear(dim * 4, dim, dtype=dtype))
        self.ln_post = _ln(dim, dtype)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, H, W, 3) in [−1, 1] → (B, (image_size / patch)²,
        dim)."""
        size = (self.image_size, self.image_size)
        if tuple(images.shape[1:3]) != size:
            images = resize_bilinear(images, size)
        x = self.patch_embed(images.to(self.dtype).permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)
        x = self.ln_pre(x + self.pos_embed[None].to(self.dtype))
        split = (self.heads, self.dim // self.heads)
        for i in range(self.num_layers):
            h = getattr(self, f"ln1_{i}")(x)
            q, k, v = (getattr(self, f"{s}_{i}")(h).unflatten(-1, split)
                       for s in ("q", "k", "v"))
            o = dot_product_attention(q, k, v)
            x = x + getattr(self, f"attn_out_{i}")(o.flatten(-2))
            h = getattr(self, f"fc1_{i}")(getattr(self, f"ln2_{i}")(x))
            h = h * torch.sigmoid(1.702 * h)      # quick-GELU
            x = x + getattr(self, f"fc2_{i}")(h)
        return self.ln_post(x)


@register("videotuna_tpu_torch.models.lvdm.Resampler",
          aliases=["videotuna.models.lvdm.modules.encoders.ip_resampler."
                   "Resampler"])
class Resampler(nn.Module):
    """Perceiver resampler: ``num_queries`` learned latents (tiled
    ``video_length`` times when given) cross-attend to the image tokens and
    to themselves, ``depth`` times, then project to ``output_dim``.

    Its heads are ``dim`` / ``heads`` wide, as in the JAX package, where
    ``heads`` divides ``dim``; where it does not (DynamiCrafter's config: 12
    heads over 1024) the JAX module cannot build, and the port's heads are
    64 wide, the reference resampler's ``dim_head`` (12·64 = 768 inner
    features; ROADMAP.md queue 3)."""

    def __init__(self, dim: int = 1024, depth: int = 4, heads: int = 12,
                 num_queries: int = 16, embedding_dim: int = 1280,
                 output_dim: int = 1024, ff_mult: int = 4,
                 video_length: Optional[int] = None,
                 dtype: Union[str, torch.dtype] = torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.dim, self.depth, self.heads = dim, depth, heads
        self.head_dim = hd = dim // heads if dim % heads == 0 else 64
        self.video_length = video_length
        self.dtype = dtype
        self.latents = nn.Parameter(torch.zeros(num_queries, dim))
        self.proj_in = nn.Linear(embedding_dim, dim, dtype=dtype)
        for i in range(depth):
            self.add_module(f"lnq_{i}", _ln(dim, dtype))
            self.add_module(f"lnk_{i}", _ln(dim, dtype))
            for s in ("q", "k", "v"):
                self.add_module(f"{s}_{i}", dense_general(dim, heads, hd,
                                                          False, dtype))
            self.add_module(f"attn_out_{i}", nn.Linear(heads * hd, dim,
                                                       bias=False,
                                                       dtype=dtype))
            self.add_module(f"lnf_{i}", _ln(dim, dtype))
            self.add_module(f"ff1_{i}", nn.Linear(dim, dim * ff_mult,
                                                  bias=False, dtype=dtype))
            self.add_module(f"ff2_{i}", nn.Linear(dim * ff_mult, dim,
                                                  bias=False, dtype=dtype))
        self.proj_out = nn.Linear(dim, output_dim, dtype=dtype)
        self.norm_out = _ln(output_dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, N, embedding_dim) → (B, num_queries·video_length,
        output_dim)."""
        lat = self.latents[None].to(self.dtype).expand(x.shape[0], -1, -1)
        if self.video_length:
            lat = lat.repeat(1, self.video_length, 1)
        x = self.proj_in(x.to(self.dtype))
        split = (self.heads, self.head_dim)
        for i in range(self.depth):
            hq = getattr(self, f"lnq_{i}")(lat)
            hk = getattr(self, f"lnk_{i}")(torch.cat([x, lat], dim=1))
            o = dot_product_attention(
                getattr(self, f"q_{i}")(hq).unflatten(-1, split),
                getattr(self, f"k_{i}")(hk).unflatten(-1, split),
                getattr(self, f"v_{i}")(hk).unflatten(-1, split))
            lat = lat + getattr(self, f"attn_out_{i}")(o.flatten(-2))
            h = getattr(self, f"ff1_{i}")(getattr(self, f"lnf_{i}")(lat))
            lat = lat + getattr(self, f"ff2_{i}")(gelu_tanh(h))
        return self.norm_out(self.proj_out(lat))


@register("videotuna_tpu_torch.models.lvdm.ImageProjModel",
          aliases=["videotuna.models.lvdm.modules.encoders.ip_resampler."
                   "ImageProjModel"])
class ImageProjModel(nn.Module):
    """A linear map of an image embedding onto
    ``clip_extra_context_tokens`` context tokens, LayerNormed."""

    def __init__(self, cross_attention_dim: int = 1024,
                 clip_embeddings_dim: int = 1024,
                 clip_extra_context_tokens: int = 4,
                 dtype: Union[str, torch.dtype] = torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.tokens, self.dim = clip_extra_context_tokens, cross_attention_dim
        self.dtype = dtype
        self.proj = nn.Linear(clip_embeddings_dim,
                              self.tokens * cross_attention_dim, dtype=dtype)
        self.norm = _ln(cross_attention_dim, dtype)

    def forward(self, image_embeds: torch.Tensor) -> torch.Tensor:
        x = self.proj(image_embeds.to(self.dtype))
        return self.norm(x.reshape(x.shape[0], self.tokens, self.dim))


@register("videotuna_tpu_torch.models.lvdm.ImageConditioner")
class ImageConditioner(nn.Module):
    """DynamiCrafter's image tower as one ``cond_stage_2``: the CLIP patch
    tokens of the image resized to the CLIP grid, then the resampler's
    query tokens."""

    def __init__(self, image_size: int = 224, clip_dim: int = 1280,
                 clip_heads: int = 16, clip_layers: int = 32,
                 dim: int = 1024, depth: int = 4, heads: int = 12,
                 num_queries: int = 16, output_dim: int = 1024,
                 dtype: Union[str, torch.dtype] = torch.float32):
        super().__init__()
        self.clip = CLIPImageEmbedder(image_size=image_size, dim=clip_dim,
                                      heads=clip_heads,
                                      num_layers=clip_layers, dtype=dtype)
        self.resampler = Resampler(dim=dim, depth=depth, heads=heads,
                                   num_queries=num_queries,
                                   embedding_dim=clip_dim,
                                   output_dim=output_dim, dtype=dtype)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, H, W, 3) in [−1, 1] at any size → (B, num_queries,
        output_dim)."""
        return self.resampler(self.clip(images))
