"""2D KL autoencoder (Stable-Diffusion layout) applied frame-wise to video
(torch), the counterpart of ``videotuna_tpu/models/vae2d.py``: conv-in →
resnet down blocks → mid (resnet, attention, resnet) → 2·z_ch conv-out, and
the symmetric decoder.  Video is encoded and decoded frame by frame, in
chunks of ``micro_frame_batch`` frames to bound peak memory.

Public methods take and return channel-last tensors, as the JAX package
does; inside, activations are channel-first (N, C, H, W), the layout torch's
convolutions take.  GroupNorm runs in f32.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from videotuna_tpu_torch.core.config import resolve_dtype
from videotuna_tpu_torch.core.registry import register
from videotuna_tpu_torch.kernels.attention import dot_product_attention


def _groups(c: int) -> int:
    """Largest group count ≤ 32 dividing c (tiny test configs use c < 32)."""
    for g in (32, 16, 8, 4, 2):
        if c % g == 0:
            return g
    return 1


class GroupNorm32(nn.GroupNorm):
    """GroupNorm computed in f32, output in f32 (flax ``GroupNorm`` with
    ``dtype=float32``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight.float(),
                            self.bias.float(), self.eps)


def _norm(c: int) -> GroupNorm32:
    return GroupNorm32(_groups(c), c, eps=1e-6)


def _conv3(cin: int, cout: int, dtype: torch.dtype) -> nn.Conv2d:
    """flax ``Conv`` 3×3 with "SAME" padding at stride 1."""
    return nn.Conv2d(cin, cout, 3, padding=1, dtype=dtype)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm1 = _norm(in_ch)
        self.conv1 = _conv3(in_ch, out_ch, dtype)
        self.norm2 = _norm(out_ch)
        self.conv2 = _conv3(out_ch, out_ch, dtype)
        if in_ch != out_ch:
            self.nin_shortcut = nn.Conv2d(in_ch, out_ch, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)).to(self.dtype))
        h = self.conv2(F.silu(self.norm2(h)).to(self.dtype))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x.to(self.dtype))
        return x + h


class AttnBlock2D(nn.Module):
    """Single-head attention over the h·w tokens of a frame."""

    def __init__(self, c: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm = _norm(c)
        self.q = nn.Conv2d(c, c, 1, dtype=dtype)
        self.k = nn.Conv2d(c, c, 1, dtype=dtype)
        self.v = nn.Conv2d(c, c, 1, dtype=dtype)
        self.proj_out = nn.Conv2d(c, c, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        y = self.norm(x).to(self.dtype)

        def tokens(t):   # (N, C, H, W) → (N, H·W, 1, C), channels contiguous
            return t.flatten(2).transpose(1, 2).contiguous()[:, :, None]

        out = dot_product_attention(tokens(self.q(y)), tokens(self.k(y)),
                                    tokens(self.v(y)))
        out = out[:, :, 0].transpose(1, 2).reshape(n, c, h, w)
        return x + self.proj_out(out)


class Encoder2D(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, z_channels: int = 4,
                 double_z: bool = True, in_ch: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.ch_mult = tuple(ch_mult)
        self.num_res_blocks = num_res_blocks
        self.conv_in = _conv3(in_ch, ch, dtype)
        c = ch
        for i, mult in enumerate(self.ch_mult):
            for j in range(num_res_blocks):
                self.add_module(f"down_{i}_block_{j}",
                                ResnetBlock(c, ch * mult, dtype))
                c = ch * mult
            if i != len(self.ch_mult) - 1:
                # flax "SAME" at stride 2 on an even size pads (0, 1)
                self.add_module(f"down_{i}_downsample",
                                nn.Conv2d(c, c, 3, stride=2, dtype=dtype))
        self.mid_block_1 = ResnetBlock(c, c, dtype)
        self.mid_attn = AttnBlock2D(c, dtype)
        self.mid_block_2 = ResnetBlock(c, c, dtype)
        self.norm_out = _norm(c)
        self.conv_out = _conv3(c, 2 * z_channels if double_z else z_channels,
                               dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x.to(self.dtype))
        for i in range(len(self.ch_mult)):
            for j in range(self.num_res_blocks):
                h = getattr(self, f"down_{i}_block_{j}")(h)
            if i != len(self.ch_mult) - 1:
                h = getattr(self, f"down_{i}_downsample")(
                    F.pad(h, (0, 1, 0, 1)))
        h = self.mid_block_2(self.mid_attn(self.mid_block_1(h)))
        return self.conv_out(F.silu(self.norm_out(h)).to(self.dtype))


class Decoder2D(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, out_ch: int = 3,
                 z_channels: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.ch_mult = tuple(ch_mult)
        self.num_res_blocks = num_res_blocks
        c = ch * self.ch_mult[-1]
        self.conv_in = _conv3(z_channels, c, dtype)
        self.mid_block_1 = ResnetBlock(c, c, dtype)
        self.mid_attn = AttnBlock2D(c, dtype)
        self.mid_block_2 = ResnetBlock(c, c, dtype)
        for i in reversed(range(len(self.ch_mult))):
            for j in range(num_res_blocks + 1):
                self.add_module(f"up_{i}_block_{j}",
                                ResnetBlock(c, ch * self.ch_mult[i], dtype))
                c = ch * self.ch_mult[i]
            if i != 0:
                self.add_module(f"up_{i}_upsample", _conv3(c, c, dtype))
        self.norm_out = _norm(c)
        self.conv_out = _conv3(c, out_ch, dtype)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(z.to(self.dtype))
        h = self.mid_block_2(self.mid_attn(self.mid_block_1(h)))
        for i in reversed(range(len(self.ch_mult))):
            for j in range(self.num_res_blocks + 1):
                h = getattr(self, f"up_{i}_block_{j}")(h)
            if i != 0:
                h = F.interpolate(h, scale_factor=2, mode="nearest")
                h = getattr(self, f"up_{i}_upsample")(h)
        return self.conv_out(F.silu(self.norm_out(h)).to(self.dtype))


class DiagonalGaussian:
    """VAE posterior over channel-last moments [mean | logvar]."""

    def __init__(self, parameters: torch.Tensor):
        self.mean, logvar = parameters.chunk(2, dim=-1)
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        noise = torch.randn(self.mean.shape, generator=generator,
                            device=self.mean.device, dtype=self.mean.dtype)
        return self.mean + self.std * noise

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self) -> torch.Tensor:
        dims = tuple(range(1, self.mean.ndim))
        return 0.5 * (self.mean ** 2 + torch.exp(self.logvar) - 1.0
                      - self.logvar).sum(dim=dims)


@register("videotuna_tpu_torch.models.AutoencoderKL2D",
          aliases=[
              "videotuna.models.lvdm.modules.vae.autoencoder.AutoencoderKL",
              "videotuna.models.opensora.models.vae.vae.VideoAutoencoderKL",
          ])
class AutoencoderKL2D(nn.Module):
    """2D KL VAE applied frame-wise to (B, T, H, W, 3) video; images fold
    into T=1.  ``micro_frame_batch`` frames go through the encoder or the
    decoder at a time."""

    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, z_channels: int = 4,
                 embed_dim: int = 4, scale_factor: float = 0.18215,
                 micro_frame_batch: Optional[int] = None,
                 dtype: Union[str, torch.dtype] = torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.scale_factor = scale_factor
        self.micro_frame_batch = micro_frame_batch
        self.encoder = Encoder2D(ch, ch_mult, num_res_blocks, z_channels,
                                 dtype=dtype)
        self.decoder = Decoder2D(ch, ch_mult, num_res_blocks,
                                 z_channels=z_channels, dtype=dtype)
        self.quant_conv = nn.Conv2d(2 * z_channels, 2 * embed_dim, 1,
                                    dtype=dtype)
        self.post_quant_conv = nn.Conv2d(embed_dim, z_channels, 1,
                                         dtype=dtype)

    def encode_frames(self, frames: torch.Tensor) -> torch.Tensor:
        """(N, 3, H, W) → posterior moments (N, 2·embed_dim, h, w)."""
        return self.quant_conv(self.encoder(frames))

    def decode_frames(self, z: torch.Tensor) -> torch.Tensor:
        """(N, embed_dim, h, w) → (N, 3, H, W)."""
        return self.decoder(self.post_quant_conv(z.to(
            self.post_quant_conv.weight.dtype)))

    def _framewise(self, fn, x: torch.Tensor) -> torch.Tensor:
        """Apply ``fn`` to (B, T, H, W, C) frame by frame, in chunks of
        ``micro_frame_batch`` frames → (B, T, H', W', C')."""
        b, t = x.shape[:2]
        frames = x.reshape(b * t, *x.shape[2:]).permute(0, 3, 1, 2)
        step = self.micro_frame_batch or b * t
        out = torch.cat([fn(frames[i:i + step])
                         for i in range(0, b * t, step)])
        return out.permute(0, 2, 3, 1).reshape(b, t, *out.shape[2:],
                                               out.shape[1])

    def encode(self, video: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, 3) → latent moments (B, T, h, w, 2·embed_dim); the
        flow applies ``scale_factor``."""
        return self._framewise(self.encode_frames, video)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(B, T, h, w, embed_dim) → (B, T, H, W, 3)."""
        return self._framewise(self.decode_frames, z)

    def forward(self, video: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Encode → (sample with ``generator`` | mode) → decode."""
        post = DiagonalGaussian(self.encode(video))
        z = post.sample(generator) if generator is not None else post.mode()
        return self.decode(z / self.scale_factor)
