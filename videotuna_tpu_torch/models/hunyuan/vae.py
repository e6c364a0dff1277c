"""HunyuanVideo 3D causal VAE ("884": 8× spatial, 4× temporal compression,
16 latent channels) in torch, the counterpart of
``videotuna_tpu/models/hunyuan/vae.py``.

- ``HYCausalConv3d`` pads (k − 1) frames in front and k//2 pixels on each
  side, all in replicate mode, then runs a VALID conv;
- GroupNorm statistics span the whole clip (C/G, T, H, W);
- the mid block's attention has one head of d = channels, a frame-causal
  mask (a token of frame f sees frames ≤ f) and the softmax in f32.  It is
  a plain einsum in the JAX package too (d = 512 is above every kernel's
  limit); here it runs a block of query rows at a time, over the keys those
  rows may see, which is the same function in bounded memory;
- the first three down blocks halve H and W and the two before the last
  halve T; the up blocks mirror it, and ``HYUpsample`` doubles the first
  frame in space only.

Public methods take and return channel-last (B, T, H, W, C), as the JAX
package does; inside, activations are channel-first (B, C, T, H, W).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from videotuna_tpu_torch.core.config import resolve_dtype
from videotuna_tpu_torch.core.registry import register

# f32 logits held at once by the mid attention: 2^27 elements, 512 MB
_ATTN_CHUNK_ELEMS = 1 << 27


class HYCausalConv3d(nn.Module):
    """Replicate-pad (k − 1, 0) in time and (k//2, k//2) in space, then a
    VALID conv."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 stride: Sequence[int] = (1, 1, 1),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel = kernel
        self.conv = nn.Conv3d(in_ch, features, kernel, stride=tuple(stride),
                              dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel
        if k > 1:
            sp = k // 2
            x = F.pad(x, (sp, sp, sp, sp, k - 1, 0), mode="replicate")
        return self.conv(x)


class HYResnetBlock(nn.Module):
    """GroupNorm → SiLU → conv1 → GroupNorm → SiLU → conv2, plus a 1×1
    causal shortcut when the width changes."""

    def __init__(self, in_ch: int, out_ch: int, groups: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_ch, eps=1e-6, dtype=dtype)
        self.conv1 = HYCausalConv3d(in_ch, out_ch, dtype=dtype)
        self.norm2 = nn.GroupNorm(groups, out_ch, eps=1e-6, dtype=dtype)
        self.conv2 = HYCausalConv3d(out_ch, out_ch, dtype=dtype)
        self.conv_shortcut = (HYCausalConv3d(in_ch, out_ch, kernel=1,
                                             dtype=dtype)
                              if in_ch != out_ch else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # SiLU in place on the norms' fresh outputs keeps one clip-sized
        # buffer fewer alive at the full-resolution blocks
        h = self.conv1(F.silu(self.norm1(x), inplace=True))
        h = self.conv2(F.silu(self.norm2(h), inplace=True))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class HYMidAttention(nn.Module):
    """One head of d = channels over every token of the clip, GroupNorm in
    front, a frame-causal mask, the softmax in f32, a residual."""

    def __init__(self, channels: int, groups: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, channels, eps=1e-6,
                                       dtype=dtype)
        self.to_q = nn.Linear(channels, channels, dtype=dtype)
        self.to_k = nn.Linear(channels, channels, dtype=dtype)
        self.to_v = nn.Linear(channels, channels, dtype=dtype)
        self.to_out = nn.Linear(channels, channels, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, t, hh, ww = x.shape
        n, hw = t * hh * ww, hh * ww
        y = self.group_norm(x).flatten(2).transpose(1, 2)     # (B, N, C)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        del y
        frame = torch.arange(n, device=x.device) // hw
        rows = max(1, _ATTN_CHUNK_ELEMS // (b * n))
        out = torch.empty_like(v)
        for i in range(0, n, rows):
            j = min(i + rows, n)
            kend = (int(frame[j - 1]) + 1) * hw   # no later frame is seen
            logits = torch.einsum("bic,bjc->bij", q[:, i:j],
                                  k[:, :kend]).float() / math.sqrt(c)
            logits.masked_fill_(frame[None, i:j, None]
                                < frame[None, None, :kend], float("-inf"))
            out[:, i:j] = torch.einsum("bij,bjc->bic",
                                       logits.softmax(-1).to(v.dtype),
                                       v[:, :kend])
        out = self.to_out(out).transpose(1, 2).reshape(b, c, t, hh, ww)
        return x + out


class HYMidBlock(nn.Module):
    """resnet, then (attention, resnet)."""

    def __init__(self, channels: int, groups: int = 32,
                 add_attention: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.resnet_0 = HYResnetBlock(channels, channels, groups, dtype)
        self.attention_0 = (HYMidAttention(channels, groups, dtype)
                            if add_attention else None)
        self.resnet_1 = HYResnetBlock(channels, channels, groups, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.resnet_0(x)
        if self.attention_0 is not None:
            x = self.attention_0(x)
        return self.resnet_1(x)


def _updown_flags(n_blocks: int) -> List[Tuple[bool, bool]]:
    """(spatial, temporal) resampling of each block: the first three halve
    H and W (8×), the two before the last halve T (4×)."""
    return [(i < 3, n_blocks - 3 <= i < n_blocks - 1)
            for i in range(n_blocks)]


class HYUpsample(nn.Module):
    """Nearest ×2 in space, and in time on the frames after the first when
    ``temporal``; then a causal conv."""

    def __init__(self, channels: int, temporal: bool,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.temporal = temporal
        self.conv = HYCausalConv3d(channels, channels, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)
        if self.temporal and x.shape[2] > 1:
            x = torch.cat([x[:, :, :1],
                           x[:, :, 1:].repeat_interleave(2, dim=2)], dim=2)
        return self.conv(x)


class HYEncoder(nn.Module):
    def __init__(self, block_out_channels: Sequence[int],
                 layers_per_block: int, latent_channels: int, groups: int,
                 add_attention: bool, dtype: torch.dtype = torch.float32):
        super().__init__()
        ch = list(block_out_channels)
        self.layers_per_block = layers_per_block
        self.flags = _updown_flags(len(ch))
        self.conv_in = HYCausalConv3d(3, ch[0], dtype=dtype)
        c = ch[0]
        for i, (sp, tm) in enumerate(self.flags):
            for j in range(layers_per_block):
                self.add_module(f"down_{i}_res_{j}",
                                HYResnetBlock(c, ch[i], groups, dtype))
                c = ch[i]
            if sp or tm:
                st = (2 if tm else 1, 2 if sp else 1, 2 if sp else 1)
                self.add_module(f"down_{i}_downsampler",
                                HYCausalConv3d(c, c, stride=st, dtype=dtype))
        self.mid = HYMidBlock(c, groups, add_attention, dtype)
        self.norm_out = nn.GroupNorm(groups, c, eps=1e-6, dtype=dtype)
        self.conv_out = HYCausalConv3d(c, 2 * latent_channels, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for i, (sp, tm) in enumerate(self.flags):
            for j in range(self.layers_per_block):
                h = getattr(self, f"down_{i}_res_{j}")(h)
            if sp or tm:
                h = getattr(self, f"down_{i}_downsampler")(h)
        h = self.mid(h)
        return self.conv_out(F.silu(self.norm_out(h), inplace=True))


class HYDecoder(nn.Module):
    def __init__(self, block_out_channels: Sequence[int],
                 layers_per_block: int, latent_channels: int, groups: int,
                 add_attention: bool, dtype: torch.dtype = torch.float32):
        super().__init__()
        rev = list(reversed(block_out_channels))
        self.layers_per_block = layers_per_block
        self.flags = _updown_flags(len(rev))
        self.conv_in = HYCausalConv3d(latent_channels, rev[0], dtype=dtype)
        self.mid = HYMidBlock(rev[0], groups, add_attention, dtype)
        c = rev[0]
        for i, (sp, tm) in enumerate(self.flags):
            for j in range(layers_per_block + 1):
                self.add_module(f"up_{i}_res_{j}",
                                HYResnetBlock(c, rev[i], groups, dtype))
                c = rev[i]
            if sp or tm:
                self.add_module(f"up_{i}_upsampler",
                                HYUpsample(c, temporal=tm, dtype=dtype))
        self.norm_out = nn.GroupNorm(groups, c, eps=1e-6, dtype=dtype)
        self.conv_out = HYCausalConv3d(c, 3, dtype=dtype)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid(self.conv_in(z))
        for i, (sp, tm) in enumerate(self.flags):
            for j in range(self.layers_per_block + 1):
                h = getattr(self, f"up_{i}_res_{j}")(h)
            if sp or tm:
                h = getattr(self, f"up_{i}_upsampler")(h)
        return self.conv_out(F.silu(self.norm_out(h), inplace=True))


@register("videotuna_tpu_torch.models.HunyuanVAE",
          aliases=["videotuna.models.hunyuan.hyvideo_i2v.vae."
                   "autoencoder_kl_causal_3d.AutoencoderKLCausal3D"])
class HunyuanVAE(nn.Module):
    """AutoencoderKLCausal3D at HunyuanVideo's released configuration
    (block_out_channels 128/256/512/512, 2 layers per block, 16 latent
    channels); ``scaling_factor`` 0.476986."""

    spatial_ratio = 8
    temporal_ratio = 4

    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512,
                                                            512),
                 layers_per_block: int = 2, latent_channels: int = 16,
                 norm_num_groups: int = 32, scaling_factor: float = 0.476986,
                 mid_block_add_attention: bool = True,
                 dtype: Union[str, torch.dtype] = torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.latent_channels = latent_channels
        self.scaling_factor = scaling_factor
        args = (block_out_channels, layers_per_block, latent_channels,
                norm_num_groups, mid_block_add_attention, dtype)
        self.encoder = HYEncoder(*args)
        self.decoder = HYDecoder(*args)
        self.quant_conv = nn.Conv3d(2 * latent_channels, 2 * latent_channels,
                                    1, dtype=dtype)
        self.post_quant_conv = nn.Conv3d(latent_channels, latent_channels, 1,
                                         dtype=dtype)

    def encode(self, video: torch.Tensor) -> torch.Tensor:
        """(B, 1+4k, H, W, 3) → moments (B, 1+k, H/8, W/8, 2z)."""
        x = video.permute(0, 4, 1, 2, 3)
        return self.quant_conv(self.encoder(x)).permute(0, 2, 3, 4, 1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(B, 1+k, h, w, z) → (B, 1+4k, 8h, 8w, 3)."""
        x = self.post_quant_conv(z.permute(0, 4, 1, 2, 3))
        return self.decoder(x).permute(0, 2, 3, 4, 1)

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        moments = self.encode(video)
        return self.decode(moments[..., :self.latent_channels])
