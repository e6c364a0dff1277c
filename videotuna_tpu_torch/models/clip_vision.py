"""The CLIP vision tower (torch), the counterpart of
``videotuna_tpu/models/clip_vision.py``: a ViT in the layout of Hugging
Face's ``CLIPVisionModelWithProjection`` (``tools/convert_weights``'s
``clip_vision_map``).

A class token and the patch embedding, learned positions → ``pre_ln`` →
pre-norm blocks with quick-GELU → ``post_ln`` on the class token → the
projection.  ``feature_layer`` (−2 for LLaVA's patch features) returns the
states after that block in place of the last.

The tower runs in f32.  At ViT-L/14 and 336 px (577 tokens, 16 heads of
d = 64) its attention takes the f32 design,
``csrc/flash_fwd_f32_sm90.cu``.  The aesthetic predictor waits for queue
1, items 10.4 and 10.5 of ROADMAP.md.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from videotuna_tpu_torch.core.config import resolve_dtype
from videotuna_tpu_torch.core.registry import register
from videotuna_tpu_torch.kernels.attention import dot_product_attention
from videotuna_tpu_torch.models.layers import LayerNorm, dense_general
from videotuna_tpu_torch.models.lvdm.image_cond import resize_bilinear

# OpenAI CLIP's pixel statistics
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


class CLIPVisionBlock(nn.Module):
    """Pre-norm attention and a quick-GELU MLP of width 4·dim."""

    def __init__(self, dim: int, heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.ln1 = LayerNorm(dim, eps=1e-5, dtype=dtype)
        for s in ("q", "k", "v"):
            setattr(self, s, dense_general(dim, heads, dim // heads, True,
                                           dtype))
        self.attn_out = nn.Linear(dim, dim, dtype=dtype)
        self.ln2 = LayerNorm(dim, eps=1e-5, dtype=dtype)
        self.fc1 = nn.Linear(dim, dim * 4, dtype=dtype)
        self.fc2 = nn.Linear(dim * 4, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.ln1(x)
        split = (self.heads, self.dim // self.heads)
        q, k, v = (getattr(self, s)(h).unflatten(-1, split)
                   for s in ("q", "k", "v"))
        x = x + self.attn_out(dot_product_attention(q, k, v).flatten(-2))
        h = self.fc1(self.ln2(x))
        return x + self.fc2(h * torch.sigmoid(1.702 * h))   # quick-GELU


@register("videotuna_tpu_torch.models.CLIPVisionEncoder")
class CLIPVisionEncoder(nn.Module):
    """ViT-L/14 by default.  Images (B, H, W, 3) with H = W =
    ``image_size`` → the projected class embedding (B, proj_dim), and with
    ``return_states`` also the token states (B, N + 1, dim), those after
    block ``feature_layer`` where it is set."""

    def __init__(self, dim: int = 1024, heads: int = 16,
                 num_layers: int = 24, patch: int = 14,
                 image_size: int = 224, proj_dim: int = 768,
                 feature_layer: Optional[int] = None,
                 dtype: Union[str, torch.dtype] = torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.dim, self.patch, self.image_size = dim, patch, image_size
        self.num_layers = num_layers
        self.feature_layer = feature_layer
        self.dtype = dtype
        self.patch_embed = nn.Conv2d(3, dim, patch, stride=patch, bias=False,
                                     dtype=dtype)
        self.class_embedding = nn.Parameter(torch.zeros(dim))
        self.pos_embed = nn.Parameter(
            torch.zeros((image_size // patch) ** 2 + 1, dim))
        self.pre_ln = LayerNorm(dim, eps=1e-5, dtype=dtype)
        self.blocks = nn.ModuleList(CLIPVisionBlock(dim, heads, dtype)
                                    for _ in range(num_layers))
        self.post_ln = LayerNorm(dim, eps=1e-5, dtype=dtype)
        self.proj = nn.Linear(dim, proj_dim, bias=False, dtype=dtype)

    def forward(self, images: torch.Tensor, return_states: bool = False):
        b = images.shape[0]
        x = self.patch_embed(images.to(self.dtype).permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(self.dtype).expand(b, 1, self.dim)
        x = torch.cat([cls, x], dim=1) + self.pos_embed[None].to(self.dtype)
        x = self.pre_ln(x)
        fl = (None if self.feature_layer is None
              else self.feature_layer % self.num_layers)
        feat = None
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i == fl:
                feat = x
        proj = self.proj(self.post_ln(x[:, 0]))
        if return_states:
            return proj, (feat if feat is not None else x)
        return proj


def preprocess_frames(frames: torch.Tensor, size: int = 224) -> torch.Tensor:
    """(T, H, W, 3) in [−1, 1] → (T, size, size, 3), CLIP-normalised: an
    antialiased bilinear resize (no centre crop) and OpenAI CLIP's mean and
    std."""
    x = resize_bilinear((frames.float() + 1.0) / 2.0, (size, size))
    mean = torch.tensor(CLIP_MEAN, device=x.device)
    std = torch.tensor(CLIP_STD, device=x.device)
    return (x - mean) / std
