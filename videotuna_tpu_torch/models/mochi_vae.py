"""Mochi-1 VAE (torch), the counterpart of ``videotuna_tpu/models/
mochi_vae.py`` (diffusers' ``AutoencoderKLMochi``): 12 latent channels, 8×
spatial and 6× temporal compression, an asymmetric encoder (Fourier
features, widths 64 → 384, per-frame attention in the deeper blocks) and
decoder (widths 768 → 128, a linear expansion and a 3D depth-to-space in
each up block, no attention), causal convs with replicated padding and
per-frame 32-group GroupNorms.  Latents are normalised per channel by the
published mean and std.

Public methods take and return channel-last (B, T, H, W, C), as the JAX
package does; inside, activations are channel-first (B, C, T, H, W), the
layout torch's convolutions take, and the channel-mixing linears run as
1×1×1 convolutions with the ``nn.Linear`` weights.  ``FrameAttention``
(heads of d = 32) takes the flash route K2 where a frame has ≥ 128 tokens.
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from videotuna_tpu_torch.core.config import resolve_dtype
from videotuna_tpu_torch.core.registry import register
from videotuna_tpu_torch.kernels.attention import dot_product_attention

ENC_CHANNELS = (64, 128, 256, 384)
DEC_CHANNELS = (128, 256, 512, 768)
LAYERS_PER_BLOCK = (3, 3, 4, 6, 3)
TEMPORAL_EXPANSIONS = (1, 2, 3)
SPATIAL_EXPANSIONS = (2, 2, 2)
ADD_ATTENTION = (False, True, True, True, True)
LATENT_CHANNELS = 12

# diffusers AutoencoderKLMochi's per-channel latent statistics: the model's
# latents are (z − mean) / std
LATENTS_MEAN = (-0.06730895953510081, -0.038011381506090416,
                -0.07477820912866141, -0.05565264470995561,
                0.012767231469026969, -0.04703542746246419,
                0.043896967884726704, -0.09346305707025976,
                -0.09918314763016893, -0.008729793427399178,
                -0.011931556316503654, -0.0321993391887285)
LATENTS_STD = (0.9263795028493863, 0.9248894543193766, 0.9393059390890617,
               0.959253732819592, 0.8244560132752793, 0.917259975397747,
               0.9294154431013696, 1.3720942357788521, 0.881393668867029,
               0.9168315692124348, 0.9185249279345552, 0.9274757570805041)


def _channel_linear(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``lin`` over the channels of a channel-first (B, C, T, H, W) x."""
    w = lin.weight[:, :, None, None, None]
    return F.conv3d(x.to(w.dtype), w, lin.bias)


def fourier_features(x: torch.Tensor, start: int = 6,
                     stop: int = 8) -> torch.Tensor:
    """Channel-first x (B, C, …) → [x, sin, cos] (B, C·(1 + 2F), …): each
    input channel at the frequencies 2^start·2π … 2^(stop−1)·2π, channel c's
    bands adjacent, in the order proj_in's weights index."""
    w = (2.0 ** torch.arange(start, stop, dtype=torch.float32,
                             device=x.device)) * (2.0 * math.pi)
    nf = w.shape[0]
    shape = (1, -1) + (1,) * (x.ndim - 2)
    h = x.repeat_interleave(nf, dim=1) * w.repeat(x.shape[1]).view(shape)
    return torch.cat([x, torch.sin(h), torch.cos(h)], dim=1)


class FrameGroupNorm32(nn.Module):
    """32-group affine GroupNorm of each frame (time folded into batch),
    in f32."""

    def __init__(self, features: int, groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.norm_layer = nn.GroupNorm(groups, features, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, t, h, w = x.shape
        gn = self.norm_layer
        y = F.group_norm(x.transpose(1, 2).reshape(b * t, c, h, w).float(),
                         gn.num_groups, gn.weight.float(), gn.bias.float(),
                         gn.eps)
        return y.reshape(b, t, c, h, w).transpose(1, 2).to(x.dtype)


class MochiCausalConv3d(nn.Module):
    """(kt − 1) replicated front frames and a symmetric replicated spatial
    pad, then a VALID conv."""

    def __init__(self, in_ch: int, features: int,
                 kernel: Tuple[int, int, int] = (3, 3, 3),
                 stride: Tuple[int, int, int] = (1, 1, 1),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel = tuple(kernel)
        self.conv = nn.Conv3d(in_ch, features, self.kernel,
                              stride=tuple(stride), dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kt, kh, kw = self.kernel
        pt, ph, pw = kt - 1, (kh - 1) // 2, (kw - 1) // 2
        if pt or ph or pw:
            x = F.pad(x, (pw, pw, ph, ph, pt, 0), mode="replicate")
        return self.conv(x.to(self.conv.weight.dtype))


class MochiResnetBlock3D(nn.Module):
    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = FrameGroupNorm32(features)
        self.conv1 = MochiCausalConv3d(features, features, dtype=dtype)
        self.norm2 = FrameGroupNorm32(features)
        self.conv2 = MochiCausalConv3d(features, features, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        return x + self.conv2(F.silu(self.norm2(h)))


class FrameAttention(nn.Module):
    """Per-frame spatial self-attention without its residual: heads of
    d = 32, q, k, v without bias, the output projection with one."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads = max(features // 32, 1)
        for n in ("to_q", "to_k", "to_v"):
            self.add_module(n, nn.Linear(features, features, bias=False,
                                         dtype=dtype))
        self.to_out = nn.Linear(features, features, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, t, h, w = x.shape
        tokens = x.permute(0, 2, 3, 4, 1).reshape(b * t, h * w, c)
        q, k, v = (getattr(self, n)(tokens).unflatten(-1, (self.heads, -1))
                   for n in ("to_q", "to_k", "to_v"))
        out = self.to_out(dot_product_attention(q, k, v).flatten(-2))
        return out.reshape(b, t, h, w, c).permute(0, 4, 1, 2, 3)


class MochiMidBlock3D(nn.Module):
    """``num_layers`` resnets, each followed (``add_attention``) by a
    residual per-frame attention over a GroupNorm; names as the flax
    module's: ``resnets_{i}``, ``norms_{i}``, ``attentions_{i}``."""

    def __init__(self, features: int, num_layers: int = 3,
                 add_attention: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers, self.add_attention = num_layers, add_attention
        for i in range(num_layers):
            self.add_module(f"resnets_{i}",
                            MochiResnetBlock3D(features, dtype))
            if add_attention:
                self.add_module(f"norms_{i}", FrameGroupNorm32(features))
                self.add_module(f"attentions_{i}",
                                FrameAttention(features, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"resnets_{i}")(x)
            if self.add_attention:
                x = x + getattr(self, f"attentions_{i}")(
                    getattr(self, f"norms_{i}")(x))
        return x


class MochiDownBlock3D(MochiMidBlock3D):
    """A strided causal conv (the patch downsample), then a mid block."""

    def __init__(self, in_features: int, features: int, num_layers: int,
                 temporal_expansion: int, spatial_expansion: int,
                 add_attention: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(features, num_layers, add_attention, dtype)
        te, se = temporal_expansion, spatial_expansion
        self.conv_in = MochiCausalConv3d(in_features, features, (te, se, se),
                                         (te, se, se), dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(self.conv_in(x))


class MochiUpBlock3D(nn.Module):
    """Resnets at the wide width, then a linear expansion and a 3D
    depth-to-space (t, h, w), the (te − 1) made-up lead frames cut."""

    def __init__(self, in_features: int, out_features: int, num_layers: int,
                 temporal_expansion: int, spatial_expansion: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers = num_layers
        self.te, self.se, self.out_features = (temporal_expansion,
                                               spatial_expansion,
                                               out_features)
        for i in range(num_layers):
            self.add_module(f"resnets_{i}",
                            MochiResnetBlock3D(in_features, dtype))
        self.proj = nn.Linear(in_features, out_features * temporal_expansion
                              * spatial_expansion ** 2, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"resnets_{i}")(x)
        te, se, co = self.te, self.se, self.out_features
        x = _channel_linear(self.proj, x)
        b, _, t, h, w = x.shape
        # the expansion's features are (te, se, se, C) in flax's order
        x = x.view(b, te, se, se, co, t, h, w).permute(0, 4, 5, 1, 6, 2, 7, 3)
        x = x.reshape(b, co, t * te, h * se, w * se)
        return x[:, :, te - 1:] if te > 1 else x


class MochiEncoder3D(nn.Module):
    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj_in = nn.Linear(3 * 5, ENC_CHANNELS[0], dtype=dtype)
        self.block_in = MochiMidBlock3D(ENC_CHANNELS[0], LAYERS_PER_BLOCK[0],
                                        ADD_ATTENTION[0], dtype)
        for i in range(3):
            self.add_module(f"down_blocks_{i}", MochiDownBlock3D(
                ENC_CHANNELS[i], ENC_CHANNELS[i + 1], LAYERS_PER_BLOCK[i + 1],
                TEMPORAL_EXPANSIONS[i], SPATIAL_EXPANSIONS[i],
                ADD_ATTENTION[i + 1], dtype))
        self.block_out = MochiMidBlock3D(ENC_CHANNELS[-1],
                                         LAYERS_PER_BLOCK[-1],
                                         ADD_ATTENTION[-1], dtype)
        self.norm_out = FrameGroupNorm32(ENC_CHANNELS[-1])
        self.proj_out = nn.Linear(ENC_CHANNELS[-1], 2 * LATENT_CHANNELS,
                                  dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _channel_linear(self.proj_in, fourier_features(x))
        x = self.block_in(x)
        for i in range(3):
            x = getattr(self, f"down_blocks_{i}")(x)
        x = self.norm_out(self.block_out(x))
        return _channel_linear(self.proj_out, F.silu(x))


class MochiDecoder3D(nn.Module):
    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv_in = nn.Conv3d(LATENT_CHANNELS, DEC_CHANNELS[-1], 1,
                                 dtype=dtype)
        self.block_in = MochiMidBlock3D(DEC_CHANNELS[-1],
                                        LAYERS_PER_BLOCK[-1], False, dtype)
        ups = ((3, 2, 3), (2, 1, 2), (1, 0, 1))   # (in, out, layers) index
        for i, (ci, co, nl) in enumerate(ups):
            self.add_module(f"up_blocks_{i}", MochiUpBlock3D(
                DEC_CHANNELS[ci], DEC_CHANNELS[co], LAYERS_PER_BLOCK[nl],
                TEMPORAL_EXPANSIONS[2 - i], SPATIAL_EXPANSIONS[2 - i],
                dtype))
        self.block_out = MochiMidBlock3D(DEC_CHANNELS[0],
                                         LAYERS_PER_BLOCK[0], False, dtype)
        self.proj_out = nn.Linear(DEC_CHANNELS[0], 3, dtype=dtype)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.block_in(self.conv_in(z.to(self.conv_in.weight.dtype)))
        for i in range(3):
            x = getattr(self, f"up_blocks_{i}")(x)
        return _channel_linear(self.proj_out, F.silu(self.block_out(x)))


@register("videotuna_tpu_torch.models.MochiVAE")
class MochiVAE(nn.Module):
    """encode(video (B, T, H, W, 3) in [−1, 1]) → moments (B, T', H/8,
    W/8, 24), the mean normalised by the published statistics;
    decode(z (B, T', h, w, 12)) → (B, (T' − 1)·6 + 1, 8h, 8w, 3)."""

    temporal_ratio = 6
    spatial_ratio = 8

    def __init__(self, dtype: Union[str, torch.dtype] = torch.float32,
                 sample: bool = False):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.encoder = MochiEncoder3D(dtype)
        self.decoder = MochiDecoder3D(dtype)

    @staticmethod
    def _stats(like: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return (torch.tensor(LATENTS_MEAN, device=like.device),
                torch.tensor(LATENTS_STD, device=like.device))

    def encode(self, video: torch.Tensor) -> torch.Tensor:
        moments = self.encoder(video.permute(0, 4, 1, 2, 3).float())
        moments = moments.permute(0, 2, 3, 4, 1).float()
        mean, logvar = moments.chunk(2, dim=-1)
        m, s = self._stats(mean)
        # the log-variance stays on the raw scale, as in the JAX module
        mean = (mean - m) / s
        return torch.cat([mean, logvar], dim=-1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        m, s = self._stats(z)
        z = z.float() * s + m
        x = self.decoder(z.permute(0, 4, 1, 2, 3))
        return x.permute(0, 2, 3, 4, 1).float()


def mochi_vae_map():
    """diffusers AutoencoderKLMochi state-dict names → the MochiVAE tree
    (the flax layout, which ``tools/from_jax.py`` copies into the port's
    module)."""
    import numpy as np

    from videotuna_tpu_torch.tools.convert_weights import (ConversionMap,
                                                           t_linear)

    def t_conv3d(w: np.ndarray) -> np.ndarray:
        return np.transpose(w, (2, 3, 4, 1, 0))

    rules = []

    def linear(src, dst):
        rules.append((rf"{src}\.weight", f"{dst}/kernel", t_linear))
        rules.append((rf"{src}\.bias", f"{dst}/bias", None))

    def conv(src, dst):
        rules.append((rf"{src}\.conv\.weight", f"{dst}/conv/kernel",
                      t_conv3d))
        rules.append((rf"{src}\.conv\.bias", f"{dst}/conv/bias", None))

    def gnorm(src, dst):
        rules.append((rf"{src}\.norm_layer\.weight",
                      f"{dst}/norm_layer/scale", None))
        rules.append((rf"{src}\.norm_layer\.bias",
                      f"{dst}/norm_layer/bias", None))

    def resnet(src, dst):
        gnorm(f"{src}.norm1", f"{dst}/norm1")
        conv(f"{src}.conv1", f"{dst}/conv1")
        gnorm(f"{src}.norm2", f"{dst}/norm2")
        conv(f"{src}.conv2", f"{dst}/conv2")

    def attn(src, dst):
        for p in ("to_q", "to_k", "to_v"):
            rules.append((rf"{src}\.{p}\.weight", f"{dst}/{p}/kernel",
                          t_linear))
        rules.append((rf"{src}\.to_out\.0\.weight", f"{dst}/to_out/kernel",
                      t_linear))
        rules.append((rf"{src}\.to_out\.0\.bias", f"{dst}/to_out/bias",
                      None))

    def mid(src, dst, num_layers, add_attention):
        for i in range(num_layers):
            resnet(f"{src}.resnets.{i}", f"{dst}/resnets_{i}")
            if add_attention:
                gnorm(f"{src}.norms.{i}", f"{dst}/norms_{i}")
                attn(f"{src}.attentions.{i}", f"{dst}/attentions_{i}")

    # ----- encoder
    linear("encoder.proj_in", "encoder/proj_in")
    mid("encoder.block_in", "encoder/block_in", LAYERS_PER_BLOCK[0],
        ADD_ATTENTION[0])
    for i in range(3):
        src = f"encoder.down_blocks.{i}"
        dst = f"encoder/down_blocks_{i}"
        conv(f"{src}.conv_in", f"{dst}/conv_in")
        mid(src, dst, LAYERS_PER_BLOCK[i + 1], ADD_ATTENTION[i + 1])
    mid("encoder.block_out", "encoder/block_out", LAYERS_PER_BLOCK[-1],
        ADD_ATTENTION[-1])
    gnorm("encoder.norm_out", "encoder/norm_out")
    rules.append((r"encoder\.proj_out\.weight", "encoder/proj_out/kernel",
                  t_linear))
    rules.append((r"encoder\.proj_out\.bias", "encoder/proj_out/bias",
                  None))

    # ----- decoder
    rules.append((r"decoder\.conv_in\.weight", "decoder/conv_in/kernel",
                  t_conv3d))
    rules.append((r"decoder\.conv_in\.bias", "decoder/conv_in/bias", None))
    mid("decoder.block_in", "decoder/block_in", LAYERS_PER_BLOCK[-1],
        False)
    dec_layers = (LAYERS_PER_BLOCK[3], LAYERS_PER_BLOCK[2],
                  LAYERS_PER_BLOCK[1])
    for i in range(3):
        src = f"decoder.up_blocks.{i}"
        dst = f"decoder/up_blocks_{i}"
        for j in range(dec_layers[i]):
            resnet(f"{src}.resnets.{j}", f"{dst}/resnets_{j}")
        linear(f"{src}.proj", f"{dst}/proj")
    mid("decoder.block_out", "decoder/block_out", LAYERS_PER_BLOCK[0],
        False)
    linear("decoder.proj_out", "decoder/proj_out")
    return ConversionMap(rules)
