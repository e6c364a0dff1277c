"""3D causal VAE (torch), the counterpart of ``videotuna_tpu/models/vae3d.py``:
causal temporal convs (front-replicate padding, so frame i sees only frames
≤ i), per-frame GroupNorm, 8× spatial / 4× temporal compression mapping
4k+1 frames ↔ k+1 latent frames.

Public methods take and return channel-last (B, T, H, W, C), as the JAX
package does; inside, activations are channel-first (B, C, T, H, W), the
layout torch's convolutions take.  The streaming, tiled and temporally
chunked decodes of the JAX module are not ported yet (see ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from videotuna_tpu_torch.core.config import resolve_dtype
from videotuna_tpu_torch.core.registry import register


def _groups(c: int) -> int:
    for g in (32, 16, 8, 4, 2):
        if c % g == 0:
            return g
    return 1


class FrameGroupNorm(nn.Module):
    """GroupNorm with per-frame statistics (over H, W, C/G), in f32."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-6):
        super().__init__()
        self.gn = nn.GroupNorm(num_groups, channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, t, h, w = x.shape
        y = x.transpose(1, 2).reshape(b * t, c, h, w).float()
        y = F.group_norm(y, self.gn.num_groups, self.gn.weight.float(),
                         self.gn.bias.float(), self.gn.eps)
        return y.reshape(b, t, c, h, w).transpose(1, 2).to(x.dtype)


class CausalConv3D(nn.Module):
    """3D conv, causal in time: front-pad (k_t−1) copies of the first frame,
    symmetric spatial SAME padding, then a VALID conv."""

    def __init__(self, in_ch: int, features: int,
                 kernel: Tuple[int, int, int] = (3, 3, 3),
                 strides: Tuple[int, int, int] = (1, 1, 1),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel = tuple(kernel)
        self.conv = nn.Conv3d(in_ch, features, self.kernel,
                              stride=tuple(strides), dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kt, kh, kw = self.kernel
        if kt > 1:
            x = torch.cat([x[:, :, :1].expand(-1, -1, kt - 1, -1, -1), x],
                          dim=2)
        x = F.pad(x, ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2))
        return self.conv(x.to(self.conv.weight.dtype))


class ResBlock3D(nn.Module):
    def __init__(self, in_ch: int, out_ch: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm1 = FrameGroupNorm(_groups(in_ch), in_ch)
        self.conv1 = CausalConv3D(in_ch, out_ch, dtype=dtype)
        self.norm2 = FrameGroupNorm(_groups(out_ch), out_ch)
        self.conv2 = CausalConv3D(out_ch, out_ch, dtype=dtype)
        self.shortcut = (nn.Conv3d(in_ch, out_ch, 1, dtype=dtype)
                         if in_ch != out_ch else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)).to(self.dtype))
        h = self.conv2(F.silu(self.norm2(h)).to(self.dtype))
        if self.shortcut is not None:
            x = self.shortcut(x.to(self.dtype))
        return x + h


class Encoder3D(nn.Module):
    """Down path: per level, res blocks then spatial (and on the marked
    levels temporal) downsampling by a strided causal conv."""

    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, z_channels: int = 16,
                 temporal_down_levels: Sequence[int] = (0, 1),
                 temporal_down_factors: Optional[Sequence[int]] = None,
                 in_ch: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.ch_mult = tuple(ch_mult)
        self.num_res_blocks = num_res_blocks
        factors = dict(zip(temporal_down_levels, temporal_down_factors
                           or (2,) * len(temporal_down_levels)))
        self.conv_in = CausalConv3D(in_ch, ch, dtype=dtype)
        c = ch
        for i, mult in enumerate(self.ch_mult):
            for j in range(num_res_blocks):
                self.add_module(f"down_{i}_block_{j}",
                                ResBlock3D(c, ch * mult, dtype=dtype))
                c = ch * mult
            if i != len(self.ch_mult) - 1:
                self.add_module(f"down_{i}_downsample", CausalConv3D(
                    c, c, strides=(factors.get(i, 1), 2, 2), dtype=dtype))
        self.mid_block_1 = ResBlock3D(c, c, dtype=dtype)
        self.mid_block_2 = ResBlock3D(c, c, dtype=dtype)
        self.norm_out = FrameGroupNorm(_groups(c), c)
        self.conv_out = CausalConv3D(c, 2 * z_channels, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for i in range(len(self.ch_mult)):
            for j in range(self.num_res_blocks):
                h = getattr(self, f"down_{i}_block_{j}")(h)
            if i != len(self.ch_mult) - 1:
                h = getattr(self, f"down_{i}_downsample")(h)
        h = self.mid_block_2(self.mid_block_1(h))
        return self.conv_out(F.silu(self.norm_out(h)).to(self.dtype))


class Decoder3D(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, out_ch: int = 3,
                 temporal_up_levels: Optional[Sequence[int]] = None,
                 temporal_up_factors: Optional[Sequence[int]] = None,
                 z_channels: int = 16, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.ch_mult = tuple(ch_mult)
        self.num_res_blocks = num_res_blocks
        n = len(self.ch_mult)
        t_up = (tuple(temporal_up_levels) if temporal_up_levels is not None
                else (n - 2, n - 1))
        self.t_up_factors = dict(zip(t_up, temporal_up_factors
                                     or (2,) * len(t_up)))
        c = ch * self.ch_mult[-1]
        self.conv_in = CausalConv3D(z_channels, c, dtype=dtype)
        self.mid_block_1 = ResBlock3D(c, c, dtype=dtype)
        self.mid_block_2 = ResBlock3D(c, c, dtype=dtype)
        for i in reversed(range(n)):
            for j in range(num_res_blocks + 1):
                self.add_module(f"up_{i}_block_{j}",
                                ResBlock3D(c, ch * self.ch_mult[i],
                                           dtype=dtype))
                c = ch * self.ch_mult[i]
            if i != 0:
                self.add_module(f"up_{i}_upsample",
                                CausalConv3D(c, c, dtype=dtype))
        self.norm_out = FrameGroupNorm(_groups(c), c)
        self.conv_out = CausalConv3D(c, out_ch, dtype=dtype)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(z)
        h = self.mid_block_2(self.mid_block_1(h))
        for i in reversed(range(len(self.ch_mult))):
            for j in range(self.num_res_blocks + 1):
                h = getattr(self, f"up_{i}_block_{j}")(h)
            if i != 0:
                # spatial nearest ×2; the temporal causal upsample repeats
                # every frame tu× except the first
                h = F.interpolate(h, scale_factor=(1, 2, 2), mode="nearest")
                tu = self.t_up_factors.get(i, 1)
                if tu > 1:
                    h = torch.cat([h[:, :, :1],
                                   h[:, :, 1:].repeat_interleave(tu, dim=2)],
                                  dim=2)
                h = getattr(self, f"up_{i}_upsample")(h)
        return self.conv_out(F.silu(self.norm_out(h)).to(self.dtype))


@register("videotuna_tpu_torch.models.CausalVAE3D")
class CausalVAE3D(nn.Module):
    """4k+1 frames ↔ k+1 latent frames; 8× spatial; z=16."""

    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, z_channels: int = 16,
                 embed_dim: int = 16, scale_factor: float = 1.0,
                 temporal_tile_latent: Optional[int] = None,
                 temporal_factors: Optional[Sequence[int]] = None,
                 dtype: Union[str, torch.dtype] = torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.ch_mult = tuple(ch_mult)
        self.temporal_factors = (tuple(temporal_factors)
                                 if temporal_factors else None)
        n = len(self.ch_mult)
        dn_lv = (tuple(range(len(self.temporal_factors)))
                 if self.temporal_factors else (0, 1))
        self.encoder = Encoder3D(ch, ch_mult, num_res_blocks, z_channels,
                                 temporal_down_levels=dn_lv,
                                 temporal_down_factors=self.temporal_factors,
                                 dtype=dtype)
        up_lv = (tuple(range(n - len(dn_lv), n))
                 if self.temporal_factors else None)
        up_f = (tuple(reversed(self.temporal_factors))
                if self.temporal_factors else None)
        self.decoder = Decoder3D(ch, ch_mult, num_res_blocks,
                                 temporal_up_levels=up_lv,
                                 temporal_up_factors=up_f,
                                 z_channels=z_channels, dtype=dtype)

    @property
    def temporal_ratio(self) -> int:
        if self.temporal_factors:
            r = 1
            for f in self.temporal_factors:
                r *= f
            return r
        n = len(self.ch_mult)
        return 2 ** len([i for i in (n - 2, n - 1) if i != 0])

    @property
    def spatial_ratio(self) -> int:
        return 2 ** (len(self.ch_mult) - 1)

    def encode(self, video: torch.Tensor) -> torch.Tensor:
        """(B, 4k+1, H, W, 3) → moments (B, k+1, H/8, W/8, 2·z)."""
        return self.encoder(video.permute(0, 4, 1, 2, 3)) \
            .permute(0, 2, 3, 4, 1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(B, k+1, h, w, z) → (B, 4k+1, H, W, 3)."""
        return self.decoder(z.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        mean = self.encode(video).chunk(2, dim=-1)[0]
        return self.decode(mean)
