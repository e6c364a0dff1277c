"""Wan 2.1 3D causal VAE (torch), the counterpart of
``videotuna_tpu/models/wan/vae.py``: 8× spatial and 4× temporal
compression, 16 latent channels standardised by a per-channel mean and
std.

- ``WanCausalConv3d`` pads 2·pad_t zero frames in front and pad_h, pad_w
  zeros on each side, then runs a VALID conv;
- ``WanRMSNorm`` normalises over the channels, times √C and ``gamma``;
- the resample blocks' time convs let the first frame through unconvolved:
  ``downsample3d`` maps 1 + 2k frames to 1 + k (stride-2 windows after
  frame 0), ``upsample3d`` maps 1 + k to 1 + 2k (each later frame's causal
  window gives two frames, channels C | C interleaved), and frame 0 is zero
  where a later window sees it;
- the attention block is one head over each frame's pixels, on the math
  path as in the JAX package (its width, 384, is above every kernel's).

Two decodes compute the same function.  ``decode`` runs the whole sequence
at once; ``decode_chunk`` / ``wan_streaming_decode`` run latent frame 0
alone, then chunks of a few latent frames, each causal conv taking its
front frames from the previous chunk's.  That conv context is an explicit
state, a dict {conv's module path: its last 2·pad_t input frames}, which
the caller passes in and gets back, updated.  Every norm works per position and the
attention per frame, so the chunks join exactly; the streamed decode holds
one chunk's activations, which is what makes 81 frames at 720×1280 fit on
one card.

Public methods take and return channel-last (B, T, H, W, C), as the JAX
package does; inside, activations are channel-first (B, C, T, H, W).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from videotuna_tpu_torch.core.config import resolve_dtype
from videotuna_tpu_torch.core.registry import register

# latent normalisation constants (the reference's WanVAE wrapper)
WAN_LATENT_MEAN = np.array([
    -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921,
], np.float32)
WAN_LATENT_STD = np.array([
    2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
    3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160,
], np.float32)

# f32 logits held at once by an attention block: 2^28 elements, 1 GB
_ATTN_CHUNK_ELEMS = 1 << 28

State = Dict[str, torch.Tensor]


class WanRMSNorm(nn.Module):
    """x / max(‖x‖, 1e-12) over the channels, · √C · ``gamma``."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = torch.linalg.vector_norm(x.float(), dim=1, keepdim=True)
        y = x / n.clamp_min(1e-12).to(x.dtype)
        y.mul_(self.dim ** 0.5)
        return y.mul_(self.gamma.view(-1, *([1] * (x.ndim - 2))))


class WanCausalConv3d(nn.Module):
    """Front-pad 2·pad_t frames in time and pad_h, pad_w zeros in space,
    then a VALID conv.  Given a streaming ``state``, the front frames come
    from it (zeros on the first chunk) and it keeps this call's last
    2·pad_t input frames under ``cache_key``."""

    def __init__(self, in_ch: int, features: int,
                 kernel: Sequence[int] = (3, 3, 3),
                 stride: Sequence[int] = (1, 1, 1),
                 pad: Sequence[int] = (1, 1, 1),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.tpad = 2 * pad[0]
        self.cache_key = ""    # set by WanVAE to the module's path
        self.conv = nn.Conv3d(in_ch, features, tuple(kernel),
                              stride=tuple(stride),
                              padding=(0, pad[1], pad[2]), dtype=dtype)

    def forward(self, x: torch.Tensor, state: Optional[State] = None,
                first_chunk: bool = True) -> torch.Tensor:
        if self.tpad:
            if state is not None and not first_chunk:
                front = state[self.cache_key].to(x.dtype)
            else:
                front = x.new_zeros((*x.shape[:2], self.tpad, *x.shape[3:]))
            x = torch.cat([front, x], dim=2)
            del front
            if state is not None:
                state[self.cache_key] = x[:, :, -self.tpad:].clone()
        return self.conv(x)


class FrameConv2d(nn.Conv2d):
    """A 3×3 conv applied to each frame of (B, C, T, H, W): a conv3d with
    the 2D kernel as a (1, 3, 3) one, so that no frame is copied out."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv3d(x, self.weight[:, :, None], self.bias,
                        stride=(1, *self.stride),
                        padding=(0, *self.padding))


class WanResample(nn.Module):
    """``upsample2d`` / ``upsample3d``: (time conv →) nearest 2× in space →
    3×3 conv to dim/2; ``downsample2d`` / ``downsample3d``: zero pad (right,
    bottom) → stride-2 3×3 conv (→ stride-2 time conv)."""

    def __init__(self, dim: int, mode: str,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mode = mode
        if mode == "upsample3d":
            self.time_conv = WanCausalConv3d(dim, dim * 2, (3, 1, 1),
                                             pad=(1, 0, 0), dtype=dtype)
        if mode in ("upsample2d", "upsample3d"):
            self.resample_conv = FrameConv2d(dim, dim // 2, 3, padding=1,
                                             dtype=dtype)
        elif mode in ("downsample2d", "downsample3d"):
            self.resample_conv = FrameConv2d(dim, dim, 3, stride=2,
                                             dtype=dtype)
        else:
            raise ValueError(f"unknown resample mode {mode!r}")
        if mode == "downsample3d":
            self.time_conv = nn.Conv3d(dim, dim, (3, 1, 1), stride=(2, 1, 1),
                                       dtype=dtype)

    def forward(self, x: torch.Tensor, state: Optional[State] = None,
                first_chunk: bool = True) -> torch.Tensor:
        if self.mode == "upsample3d":
            # the global frame 0 never enters the time conv: later windows
            # see zeros in its place (on the first chunk only when
            # streaming), and it passes through unconvolved
            first = state is None or first_chunk
            xz = torch.cat([torch.zeros_like(x[:, :, :1]), x[:, :, 1:]],
                           dim=2) if first else x
            y = self.time_conv(xz, state, first_chunk)
            del xz
            if first:
                y = y[:, :, 1:]
            b, c2, n, h, w = y.shape
            # channels C | C → two frames per input frame
            inter = y.view(b, 2, c2 // 2, n, h, w).permute(0, 2, 3, 1, 4, 5)
            inter = inter.reshape(b, c2 // 2, 2 * n, h, w)
            del y
            x = torch.cat([x[:, :, :1], inter], dim=2) if first else inter
            del inter
        if self.mode in ("upsample2d", "upsample3d"):
            x = F.interpolate(x, scale_factor=(1, 2, 2), mode="nearest")
            return self.resample_conv(x)
        x = self.resample_conv(F.pad(x, (0, 1, 0, 1)))
        if self.mode == "downsample3d":
            # fewer than 3 frames (a single image's) have no stride-2 window:
            # frame 0 alone, as the JAX package's VALID conv gives
            y = self.time_conv(x) if x.shape[2] >= 3 else x[:, :, :0]
            x = torch.cat([x[:, :, :1], y], dim=2)
        return x


class WanResidualBlock(nn.Module):
    """norm1 → SiLU → conv1 → norm2 → SiLU → conv2, plus a 1×1×1 shortcut
    when the width changes."""

    def __init__(self, in_dim: int, out_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = WanRMSNorm(in_dim)
        self.conv1 = WanCausalConv3d(in_dim, out_dim, dtype=dtype)
        self.norm2 = WanRMSNorm(out_dim)
        self.conv2 = WanCausalConv3d(out_dim, out_dim, dtype=dtype)
        self.shortcut = (WanCausalConv3d(in_dim, out_dim, (1, 1, 1),
                                         pad=(0, 0, 0), dtype=dtype)
                         if in_dim != out_dim else None)

    def forward(self, x: torch.Tensor, state: Optional[State] = None,
                first_chunk: bool = True) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x), inplace=True), state,
                       first_chunk)
        h = self.conv2(F.silu(self.norm2(h), inplace=True), state,
                       first_chunk)
        if self.shortcut is not None:
            x = self.shortcut(x)
        return h.add_(x)


class WanAttentionBlock(nn.Module):
    """One head over each frame's pixels (d = channels), the softmax in
    f32, a residual; a block of frames at a time."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm = WanRMSNorm(dim)
        self.to_qkv = nn.Linear(dim, 3 * dim, dtype=dtype)
        self.proj = nn.Linear(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, t, h, w = x.shape
        y = self.norm(x).permute(0, 2, 3, 4, 1).reshape(b * t, h * w, c)
        q, k, v = self.to_qkv(y).chunk(3, dim=-1)
        del y
        frames = max(1, _ATTN_CHUNK_ELEMS // (h * w) ** 2)
        out = torch.empty_like(q)
        for i in range(0, b * t, frames):
            j = i + frames
            logits = torch.einsum("bic,bjc->bij", q[i:j], k[i:j]) \
                / math.sqrt(float(c))
            out[i:j] = torch.einsum("bij,bjc->bic",
                                    logits.float().softmax(-1).to(v.dtype),
                                    v[i:j])
            del logits
        out = self.proj(out).reshape(b, t, h, w, c).permute(0, 4, 1, 2, 3)
        return x + out


def _encoder_layout(dim_mult: Sequence[int], num_res_blocks: int,
                    attn_scales: Sequence[float],
                    temperal_downsample: Sequence[bool]):
    """The encoder's flat ``downsamples`` stack: (kind, in_mult, out_mult)."""
    layers = []
    dims = [1] + list(dim_mult)
    scale = 1.0
    for i in range(len(dim_mult)):
        in_m, out_m = dims[i], dims[i + 1]
        for _ in range(num_res_blocks):
            layers.append(("res", in_m, out_m))
            if scale in attn_scales:
                layers.append(("attn", out_m, out_m))
            in_m = out_m
        if i != len(dim_mult) - 1:
            mode = "downsample3d" if temperal_downsample[i] else "downsample2d"
            layers.append((mode, out_m, out_m))
            scale /= 2.0
    return layers


def _decoder_layout(dim_mult: Sequence[int], num_res_blocks: int,
                    attn_scales: Sequence[float],
                    temperal_upsample: Sequence[bool]):
    """The decoder's flat ``upsamples`` stack, with in_mult halved after
    each channel-halving upsample."""
    layers = []
    dims = [dim_mult[-1]] + list(dim_mult[::-1])
    scale = 1.0 / 2 ** (len(dim_mult) - 2)
    for i in range(len(dim_mult)):
        in_m, out_m = dims[i], dims[i + 1]
        if i in (1, 2, 3):
            in_m = in_m // 2
        for _ in range(num_res_blocks + 1):
            layers.append(("res", in_m, out_m))
            if scale in attn_scales:
                layers.append(("attn", out_m, out_m))
            in_m = out_m
        if i != len(dim_mult) - 1:
            mode = "upsample3d" if temperal_upsample[i] else "upsample2d"
            layers.append((mode, out_m, out_m))
            scale *= 2.0
    return layers


class WanCoder(nn.Module):
    """The encoder (conv1 → downsamples → middle → head) or the decoder
    (conv1 → middle → upsamples → head, ``middle_first``)."""

    def __init__(self, dim: int, z_in: int, in_ch: int, out_ch: int,
                 layout: Sequence[Tuple[str, int, int]], mid_dim: int,
                 stages_name: str, middle_first: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.middle_first = middle_first
        self.names = []
        md = dim * mid_dim
        self.conv1 = WanCausalConv3d(z_in, in_ch, dtype=dtype)
        self.middle_0 = WanResidualBlock(md, md, dtype)
        self.middle_1 = WanAttentionBlock(md, dtype)
        self.middle_2 = WanResidualBlock(md, md, dtype)
        for idx, (kind, in_m, out_m) in enumerate(layout):
            name = f"{stages_name}_{idx}"
            if kind == "res":
                layer = WanResidualBlock(dim * in_m, dim * out_m, dtype)
            elif kind == "attn":
                layer = WanAttentionBlock(dim * out_m, dtype)
            else:
                layer = WanResample(dim * out_m, kind, dtype)
            self.add_module(name, layer)
            self.names.append(name)
        head_dim = dim * layout[-1][2] if middle_first else md
        self.head_norm = WanRMSNorm(head_dim)
        self.head_conv = WanCausalConv3d(head_dim, out_ch, dtype=dtype)

    def _middle(self, h, state, first_chunk):
        h = self.middle_0(h, state, first_chunk)
        h = self.middle_1(h)
        return self.middle_2(h, state, first_chunk)

    def forward(self, x: torch.Tensor, state: Optional[State] = None,
                first_chunk: bool = True) -> torch.Tensor:
        h = self.conv1(x, state, first_chunk)
        if self.middle_first:
            h = self._middle(h, state, first_chunk)
        for name in self.names:
            layer = getattr(self, name)
            h = (layer(h) if isinstance(layer, WanAttentionBlock)
                 else layer(h, state, first_chunk))
        if not self.middle_first:
            h = self._middle(h, state, first_chunk)
        h = F.silu(self.head_norm(h), inplace=True)
        return self.head_conv(h, state, first_chunk)


@register("videotuna_tpu_torch.models.WanVAE",
          aliases=["videotuna.models.wan.wan.modules.vae.WanVAE",
                   "videotuna.models.wan.wan.modules.vae.WanVAE_"])
class WanVAE(nn.Module):
    """WanVAE_: encoder → conv1 (moments) → conv2 → decoder, with the
    latent standardisation; the released configuration is the default."""

    def __init__(self, dim: int = 96, z_dim: int = 16,
                 dim_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2,
                 attn_scales: Sequence[float] = (),
                 temperal_downsample: Sequence[bool] = (False, True, True),
                 dtype: Union[str, torch.dtype] = torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.z_dim = z_dim
        self.dim_mult = tuple(dim_mult)
        self.temperal_downsample = tuple(temperal_downsample)
        enc = _encoder_layout(dim_mult, num_res_blocks, attn_scales,
                              temperal_downsample)
        dec = _decoder_layout(dim_mult, num_res_blocks, attn_scales,
                              tuple(temperal_downsample)[::-1])
        self.encoder = WanCoder(dim, 3, dim, z_dim * 2, enc, dim_mult[-1],
                                "downsamples", dtype=dtype)
        self.decoder = WanCoder(dim, z_dim, dim * dim_mult[-1], 3, dec,
                                dim_mult[-1], "upsamples", middle_first=True,
                                dtype=dtype)
        self.conv1 = WanCausalConv3d(z_dim * 2, z_dim * 2, (1, 1, 1),
                                     pad=(0, 0, 0), dtype=dtype)
        self.conv2 = WanCausalConv3d(z_dim, z_dim, (1, 1, 1), pad=(0, 0, 0),
                                     dtype=dtype)
        for name, m in self.named_modules():
            if isinstance(m, WanCausalConv3d):
                m.cache_key = name
    @property
    def spatial_ratio(self) -> int:
        return 2 ** (len(self.dim_mult) - 1)

    @property
    def temporal_ratio(self) -> int:
        return 2 ** sum(bool(b) for b in self.temperal_downsample)

    def _scale(self, device: torch.device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The latent mean and std (B, …, z) broadcast, f32."""
        if self.z_dim == 16:
            mean, std = WAN_LATENT_MEAN, WAN_LATENT_STD
        else:
            mean = np.zeros(self.z_dim, np.float32)
            std = np.ones(self.z_dim, np.float32)
        return (torch.as_tensor(mean, device=device),
                torch.as_tensor(std, device=device))

    def encode(self, video: torch.Tensor,
               standardize: bool = True) -> torch.Tensor:
        """(B, 1+4k, H, W, 3) → the standardised mean (B, 1+k, H/8, W/8,
        z)."""
        moments = self.encode_moments(video)
        mu = moments[..., :self.z_dim]
        if standardize:
            mean, std = self._scale(mu.device)
            mu = (mu - mean) / std
        return mu

    def encode_moments(self, video: torch.Tensor) -> torch.Tensor:
        """Raw (mu, log_var) moments (B, 1+k, h, w, 2z)."""
        x = video.permute(0, 4, 1, 2, 3)
        return self.conv1(self.encoder(x)).permute(0, 2, 3, 4, 1)

    def _z_in(self, z: torch.Tensor, standardize: bool) -> torch.Tensor:
        if standardize:
            mean, std = self._scale(z.device)
            z = z * std + mean
        return self.conv2(z.permute(0, 4, 1, 2, 3))

    def decode(self, z: torch.Tensor, standardize: bool = True
               ) -> torch.Tensor:
        """(B, 1+k, h, w, z) → (B, 1+4k, 8h, 8w, 3), the whole sequence at
        once."""
        return self.decoder(self._z_in(z, standardize)).permute(0, 2, 3, 4,
                                                                1)

    def decode_chunk(self, z: torch.Tensor, state: Optional[State] = None,
                     standardize: bool = True, first_chunk: bool = True
                     ) -> Tuple[torch.Tensor, State]:
        """One chunk of the streamed decode: (pixels of ``z``'s frames, the
        conv state after them).  ``state``, the previous chunk's (None with
        ``first_chunk``), is updated in place, each conv's entry replaced as
        soon as it has been read, so that one state is alive at a time."""
        state = {} if state is None else state
        out = self.decoder(self._z_in(z, standardize), state, first_chunk)
        return out.permute(0, 2, 3, 4, 1), state

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(video, standardize=False),
                           standardize=False)


def wan_streaming_decode(vae: WanVAE, z: torch.Tensor, chunk: int = 2,
                         standardize: bool = True) -> torch.Tensor:
    """The streamed decode: latent frame 0 alone (one pixel frame, the
    first-frame bypass), then chunks of ``chunk`` latent frames (4·chunk
    pixel frames each), the conv state carried from chunk to chunk.  Equal
    to ``vae.decode(z)``.  A short last chunk needs no padding: every layer
    is causal in time."""
    out, state = vae.decode_chunk(z[:, :1], None, standardize, True)
    outs = [out]
    for i in range(1, z.shape[1], chunk):
        out, state = vae.decode_chunk(z[:, i:i + chunk], state, standardize,
                                      False)
        outs.append(out)
    return torch.cat(outs, dim=1)
