"""CogVideoX 3D causal VAE (torch), the counterpart of
``videotuna_tpu/models/cogvideo/vae.py`` (SAT ``cp_enc_dec.py`` topology):

- causal conv: (k−1) copies of the FIRST frame in front in time, zero
  spatial padding, VALID conv;
- decoder norms are SpatialNorm3D: GroupNorm(f)·conv_y(zq↑) + conv_b(zq↑),
  with zq nearest-resized to f's grid and the first frame resized apart;
- downsample: time [x₀, avg-pool₂(x₁…)], space zero-pad (0,1) + stride-2
  conv; upsample: first frame ×2 in space only, the rest ×2 in t/h/w, then
  a 3×3 conv.  No attention anywhere.

Public methods take and return channel-last (B, T, H, W, C); inside,
activations are channel-first (B, C, T, H, W).  The per-frame 2D convs keep
``nn.Conv2d`` weights (the flax layout) and run as 3D convs with a unit
time kernel, which needs no frame-major copy.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from videotuna_tpu_torch.core.config import resolve_dtype
from videotuna_tpu_torch.core.registry import register


def resize_nearest(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Nearest resize of the (T, H, W) dims of (B, C, T, H, W), with
    ``jax.image.resize``'s index rule: floor((i + ½)·in/out) in f32."""
    for dim, n in zip((2, 3, 4), size):
        m = x.shape[dim]
        if m == n:
            continue
        idx = np.floor((np.arange(n, dtype=np.float32) + np.float32(0.5))
                       * np.float32(m) / np.float32(n)).astype(np.int64)
        x = x.index_select(dim, torch.as_tensor(idx, device=x.device))
    return x


def _conv2d_per_frame(conv: nn.Conv2d, x: torch.Tensor, stride: int = 1,
                      padding: int = 0) -> torch.Tensor:
    return F.conv3d(x, conv.weight.unsqueeze(2), conv.bias,
                    stride=(1, stride, stride), padding=(0, padding, padding))


class CogCausalConv3d(nn.Module):
    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel = kernel
        self.conv = nn.Conv3d(in_ch, features, kernel, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel
        if k > 1:
            x = torch.cat([x[:, :, :1].expand(-1, -1, k - 1, -1, -1), x],
                          dim=2)
            sp = k // 2
            x = F.pad(x, (sp, sp, sp, sp))
        return self.conv(x.to(self.conv.weight.dtype))


class CogSpatialNorm(nn.Module):
    """GroupNorm(f) · conv_y(zq↑) + conv_b(zq↑)."""

    def __init__(self, channels: int, zq_channels: int, groups: int = 32):
        super().__init__()
        self.norm_layer = nn.GroupNorm(groups, channels, eps=1e-6)
        self.conv_y = CogCausalConv3d(zq_channels, channels, kernel=1)
        self.conv_b = CogCausalConv3d(zq_channels, channels, kernel=1)

    def forward(self, f: torch.Tensor, zq: torch.Tensor) -> torch.Tensor:
        t, h, w = f.shape[2:]
        if t > 1 and zq.shape[2] > 1:
            zq = torch.cat([resize_nearest(zq[:, :, :1], (1, h, w)),
                            resize_nearest(zq[:, :, 1:], (t - 1, h, w))],
                           dim=2)
        else:
            zq = resize_nearest(zq, (t, h, w))
        norm_f = self.norm_layer(f)
        return norm_f * self.conv_y(zq) + self.conv_b(zq)


class CogResnetBlock(nn.Module):
    """ResNet block; with ``zq_channels`` its norms are zq-conditioned."""

    def __init__(self, in_ch: int, out_ch: int, groups: int = 32,
                 zq_channels: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()

        def norm(c):
            if zq_channels is not None:
                return CogSpatialNorm(c, zq_channels, groups)
            return nn.GroupNorm(groups, c, eps=1e-6)

        self.conditioned = zq_channels is not None
        self.norm1 = norm(in_ch)
        self.conv1 = CogCausalConv3d(in_ch, out_ch, dtype=dtype)
        self.norm2 = norm(out_ch)
        self.conv2 = CogCausalConv3d(out_ch, out_ch, dtype=dtype)
        self.nin_shortcut = (nn.Conv3d(in_ch, out_ch, 1, dtype=dtype)
                             if in_ch != out_ch else None)

    def forward(self, x: torch.Tensor,
                zq: Optional[torch.Tensor] = None) -> torch.Tensor:
        extra = (zq,) if self.conditioned else ()
        h = self.conv1(F.silu(self.norm1(x, *extra)))
        h = self.conv2(F.silu(self.norm2(h, *extra)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x.to(self.nin_shortcut.weight.dtype))
        return x + h


class CogDownsample(nn.Module):
    def __init__(self, channels: int, compress_time: bool,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compress_time = compress_time
        self.conv = nn.Conv2d(channels, channels, 3, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compress_time and x.shape[2] > 1:
            first, rest = x[:, :, :1], x[:, :, 1:]
            # avg_pool1d(k=2, s=2) over time (drops a trailing odd frame)
            tr = rest.shape[2] // 2
            rest = rest[:, :, :2 * tr].unflatten(2, (tr, 2)).mean(dim=3)
            x = torch.cat([first, rest], dim=2)
        x = F.pad(x, (0, 1, 0, 1))
        return _conv2d_per_frame(self.conv, x.to(self.conv.weight.dtype),
                                 stride=2)


class CogUpsample(nn.Module):
    def __init__(self, channels: int, compress_time: bool,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compress_time = compress_time
        self.conv = nn.Conv2d(channels, channels, 3, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compress_time and x.shape[2] > 1:
            x = torch.cat([
                F.interpolate(x[:, :, :1], scale_factor=(1, 2, 2),
                              mode="nearest"),
                F.interpolate(x[:, :, 1:], scale_factor=(2, 2, 2),
                              mode="nearest")], dim=2)
        else:
            x = F.interpolate(x, scale_factor=(1, 2, 2), mode="nearest")
        return _conv2d_per_frame(self.conv, x.to(self.conv.weight.dtype),
                                 padding=1)


class CogEncoder(nn.Module):
    def __init__(self, ch: int, ch_mult: Sequence[int], num_res_blocks: int,
                 z_channels: int, temporal_compress_level: int,
                 groups: int = 32, in_ch: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n = len(ch_mult)
        self.num_res_blocks = num_res_blocks
        self.conv_in = CogCausalConv3d(in_ch, ch, dtype=dtype)
        c = ch
        for i in range(self.n):
            for j in range(num_res_blocks):
                self.add_module(f"down_{i}_block_{j}", CogResnetBlock(
                    c, ch * ch_mult[i], groups, dtype=dtype))
                c = ch * ch_mult[i]
            if i != self.n - 1:
                self.add_module(f"down_{i}_downsample", CogDownsample(
                    c, i < temporal_compress_level, dtype=dtype))
        self.mid_block_1 = CogResnetBlock(c, c, groups, dtype=dtype)
        self.mid_block_2 = CogResnetBlock(c, c, groups, dtype=dtype)
        self.norm_out = nn.GroupNorm(groups, c, eps=1e-6)
        self.conv_out = CogCausalConv3d(c, 2 * z_channels, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for i in range(self.n):
            for j in range(self.num_res_blocks):
                h = getattr(self, f"down_{i}_block_{j}")(h)
            if i != self.n - 1:
                h = getattr(self, f"down_{i}_downsample")(h)
        h = self.mid_block_2(self.mid_block_1(h))
        return self.conv_out(F.silu(self.norm_out(h)))


class CogDecoder(nn.Module):
    """Every norm is conditioned on zq = the raw latent."""

    def __init__(self, ch: int, ch_mult: Sequence[int], num_res_blocks: int,
                 out_ch: int = 3, temporal_compress_level: int = 2,
                 groups: int = 32, z_channels: int = 16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n = len(ch_mult)
        self.num_res_blocks = num_res_blocks
        zc = z_channels
        c = ch * ch_mult[-1]
        self.conv_in = CogCausalConv3d(zc, c, dtype=dtype)
        self.mid_block_1 = CogResnetBlock(c, c, groups, zc, dtype=dtype)
        self.mid_block_2 = CogResnetBlock(c, c, groups, zc, dtype=dtype)
        for i in reversed(range(self.n)):
            for j in range(num_res_blocks + 1):
                self.add_module(f"up_{i}_block_{j}", CogResnetBlock(
                    c, ch * ch_mult[i], groups, zc, dtype=dtype))
                c = ch * ch_mult[i]
            if i != 0:
                self.add_module(f"up_{i}_upsample", CogUpsample(
                    c, i >= self.n - temporal_compress_level, dtype=dtype))
        self.norm_out = CogSpatialNorm(c, zc, groups)
        self.conv_out = CogCausalConv3d(c, out_ch, dtype=dtype)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        zq = z
        h = self.conv_in(z)
        h = self.mid_block_1(h, zq)
        h = self.mid_block_2(h, zq)
        for i in reversed(range(self.n)):
            for j in range(self.num_res_blocks + 1):
                h = getattr(self, f"up_{i}_block_{j}")(h, zq)
            if i != 0:
                h = getattr(self, f"up_{i}_upsample")(h)
        h = F.silu(self.norm_out(h, zq))
        return self.conv_out(h)


@register("videotuna_tpu_torch.models.CogVideoXVAE",
          aliases=["diffusers.AutoencoderKLCogVideoX"])
class CogVideoXVAE(nn.Module):
    """CogVideoX production config: ch=128, ch_mult (1,2,2,4), 3 res blocks,
    z=16, 4× temporal / 8× spatial; scaling_factor 1.15258426."""

    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 2, 4),
                 num_res_blocks: int = 3, z_channels: int = 16,
                 temporal_compress_times: int = 4, norm_num_groups: int = 32,
                 scaling_factor: float = 1.15258426,
                 dtype: Union[str, torch.dtype] = torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.ch_mult = tuple(ch_mult)
        self.temporal_compress_times = temporal_compress_times
        self.scaling_factor = scaling_factor
        lvl = int(math.log2(temporal_compress_times))
        self.encoder = CogEncoder(ch, ch_mult, num_res_blocks, z_channels,
                                  lvl, norm_num_groups, dtype=dtype)
        self.decoder = CogDecoder(ch, ch_mult, num_res_blocks, 3, lvl,
                                  norm_num_groups, z_channels, dtype=dtype)

    @property
    def spatial_ratio(self) -> int:
        return 2 ** (len(self.ch_mult) - 1)

    @property
    def temporal_ratio(self) -> int:
        return self.temporal_compress_times

    def encode(self, video: torch.Tensor) -> torch.Tensor:
        """(B, 1+4k, H, W, 3) → moments (B, 1+k, H/8, W/8, 2z)."""
        return self.encoder(video.permute(0, 4, 1, 2, 3)) \
            .permute(0, 2, 3, 4, 1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(B, 1+k, h, w, z) → (B, 1+4k, H, W, 3)."""
        return self.decoder(z.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        moments = self.encode(video)
        return self.decode(moments[..., :moments.shape[-1] // 2])
