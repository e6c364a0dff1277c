"""UNet3D (torch): the latent video UNet of VideoCrafter 1/2 and
DynamiCrafter, the counterpart of ``videotuna_tpu/models/lvdm/unet3d.py``.

- time conditioning added to each ResBlock (or FiLM scale-shift), optional
  fps conditioning;
- per level: ResBlock (+ the 4-conv temporal block) → SpatialTransformer
  (self-attention over H·W, cross-attention to the text, plus DynamiCrafter's
  image tokens) → TemporalTransformer (attention over the frames at each
  location, optionally with relative-position key and value tables);
- down and up paths with skips, a middle block whose attention runs at every
  resolution, and the output conv.

Latents are channel-last (B, T, H, W, C) in and f32 out, as in the JAX
package.  Spatial ops fold T into the batch, temporal ops fold H·W into it.
The GroupNorms run in f32 inside bf16 blocks with the JAX package's group
counts and epsilons; the GEGLU's GELU is flax's tanh approximation.

Attention goes through ``dot_product_attention`` with the JAX package's
dispatch: at ≥ 128 tokens a flash route (K1 for an even head count at
d = 64, K2 otherwise: the 5 heads of the first level), below it (the 16
frames of the temporal attention, the middle block at 320×512) and with the
relative-position terms the plain math.  The zero initialisation of the
output convs and projections is not copied: the weights come from the seed
(``init_weights_``) or from a JAX tree (``tools/from_jax``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from videotuna_tpu_torch.core.config import resolve_dtype
from videotuna_tpu_torch.core.registry import register
from videotuna_tpu_torch.kernels.attention import dot_product_attention
from videotuna_tpu_torch.models.layers import (LayerNorm, dense_general,
                                               gelu_tanh, timestep_embedding)
from videotuna_tpu_torch.models.vae2d import _groups


def _group_norm(norm: nn.GroupNorm, x: torch.Tensor,
                lead: int) -> torch.Tensor:
    """``norm`` in f32 over channel-last ``x`` whose first ``lead`` axes
    are the batch of the statistics: f32 out, x's shape."""
    n = x.shape[:lead].numel()
    y = F.group_norm(x.float().reshape(n, -1, x.shape[-1]).transpose(1, 2),
                     norm.num_groups, norm.weight.float(), norm.bias.float(),
                     norm.eps)
    return y.transpose(1, 2).reshape(x.shape)


class FrameGN(nn.Module):
    """GroupNorm with per-frame statistics (the reference's 2D norms on
    (B·T, C, H, W)), f32 out."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.gn = nn.GroupNorm(_groups(c), c, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _group_norm(self.gn, x, 2)


class FrameConv(nn.Conv3d):
    """flax ``Conv`` with a (1, kh, kw) kernel on (B, T, H, W, C): a 2D
    convolution of each frame, "SAME" padding unless given.  The weight
    keeps the flax kernel's 3D shape."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, (1, k, k), stride=(1, stride, stride),
                         padding=(0, k // 2, k // 2), dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t = x.shape[:2]
        y = F.conv2d(x.reshape(b * t, *x.shape[2:]).permute(0, 3, 1, 2),
                     self.weight[:, :, 0], self.bias, self.stride[1:],
                     self.padding[1:])
        return y.permute(0, 2, 3, 1).reshape(b, t, *y.shape[2:],
                                              y.shape[1])


class TemporalConvBlock(nn.Module):
    """Four GroupNorm → SiLU → (3, 1, 1) conv stacks over the clip (the
    norms pool over time), then the residual."""

    def __init__(self, ch: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        for i in range(1, 5):
            self.add_module(f"norm{i}", nn.GroupNorm(_groups(ch), ch,
                                                     eps=1e-5))
            self.add_module(f"conv{i}", nn.Conv3d(ch, ch, (3, 1, 1),
                                                  padding=(1, 0, 0),
                                                  dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(1, 5):
            h = F.silu(_group_norm(getattr(self, f"norm{i}"), h, 1))
            h = getattr(self, f"conv{i}")(
                h.to(self.dtype).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
        return x + h


class ResBlock3D(nn.Module):
    """Residual block with the time embedding added after conv1 (or FiLM
    scale-shift with ``use_scale_shift_norm``), a 1×1 skip conv when the
    width changes, and the temporal conv block."""

    def __init__(self, in_ch: int, out_ch: int, emb_dim: int,
                 use_temporal_conv: bool = False,
                 use_scale_shift_norm: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.use_scale_shift_norm = use_scale_shift_norm
        self.norm1 = FrameGN(in_ch)
        self.conv1 = FrameConv(in_ch, out_ch, dtype=dtype)
        self.emb_proj = nn.Linear(
            emb_dim, 2 * out_ch if use_scale_shift_norm else out_ch,
            dtype=dtype)
        self.norm2 = FrameGN(out_ch)
        self.conv2 = FrameConv(out_ch, out_ch, dtype=dtype)
        if in_ch != out_ch:
            self.skip = nn.Conv3d(in_ch, out_ch, 1, dtype=dtype)
        self.tconv = (TemporalConvBlock(out_ch, dtype)
                      if use_temporal_conv else None)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)).to(self.dtype))
        es = self.emb_proj(F.silu(emb))[:, None, None, None]
        if self.use_scale_shift_norm:
            scale, shift = es.chunk(2, dim=-1)
            h = self.norm2(h).to(self.dtype) * (1.0 + scale) + shift
        else:
            h = self.norm2(h + es).to(self.dtype)
        h = self.conv2(F.silu(h))
        if hasattr(self, "skip"):
            x = self.skip(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
        h = x + h
        return self.tconv(h) if self.tconv is not None else h


def _heads(din: int, heads: int, head_dim: int,
           dtype: torch.dtype) -> nn.Linear:
    return dense_general(din, heads, head_dim, bias=False, dtype=dtype)


class SpatialTransformer(nn.Module):
    """Per-frame transformer: self-attention over H·W, cross-attention to
    the text context (with ``image_cross``, DynamiCrafter's image tokens
    too: the query is shared, ``attn2_k_ip``/``attn2_v_ip`` project the
    image tokens, and the two attention outputs are summed, the image's at
    ``img_cross_scale``, before the one output projection), GEGLU MLP."""

    def __init__(self, c: int, heads: int, head_dim: int,
                 context_dim: Optional[int] = None, image_cross: bool = False,
                 img_cross_scale: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.head_dim, self.dtype = heads, head_dim, dtype
        self.image_cross = image_cross
        self.img_cross_scale = img_cross_scale
        inner = heads * head_dim
        self.norm = FrameGN(c, eps=1e-6)
        self.proj_in = nn.Linear(c, inner, dtype=dtype)
        self.ln1 = LayerNorm(inner, eps=1e-6, dtype=dtype)
        for name in ("attn1_q", "attn1_k", "attn1_v"):
            self.add_module(name, _heads(inner, heads, head_dim, dtype))
        self.attn1_out = nn.Linear(inner, inner, dtype=dtype)
        if context_dim is not None:
            self.ln2 = LayerNorm(inner, eps=1e-6, dtype=dtype)
            self.attn2_q = _heads(inner, heads, head_dim, dtype)
            names = ("attn2_k", "attn2_v") + (
                ("attn2_k_ip", "attn2_v_ip") if image_cross else ())
            for name in names:
                self.add_module(name, _heads(context_dim, heads, head_dim,
                                             dtype))
            self.attn2_out = nn.Linear(inner, inner, dtype=dtype)
        self.ln3 = LayerNorm(inner, eps=1e-6, dtype=dtype)
        self.geglu = nn.Linear(inner, inner * 8, dtype=dtype)
        self.mlp_out = nn.Linear(inner * 4, inner, dtype=dtype)
        self.proj_out = nn.Linear(inner, c, dtype=dtype)

    def _kv(self, k_proj: nn.Linear, v_proj: nn.Linear, ctx: torch.Tensor,
            t: int):
        """k and v of ``ctx`` (B, L, D), each repeated for the T frames:
        the projection of the repeated context, computed once a clip."""
        split = (self.heads, self.head_dim)
        return [p(ctx).unflatten(-1, split).repeat_interleave(t, dim=0)
                for p in (k_proj, v_proj)]

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor],
                context_img: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, hh, ww, c = x.shape
        split = (self.heads, self.head_dim)
        h = self.proj_in(self.norm(x).to(self.dtype))
        tok = h.reshape(b * t, hh * ww, -1)
        m = self.ln1(tok)
        o = dot_product_attention(self.attn1_q(m).unflatten(-1, split),
                                  self.attn1_k(m).unflatten(-1, split),
                                  self.attn1_v(m).unflatten(-1, split))
        tok = tok + self.attn1_out(o.flatten(-2))
        if context is not None:
            q = self.attn2_q(self.ln2(tok)).unflatten(-1, split)
            ctx = context.to(self.dtype)
            out = dot_product_attention(
                q, *self._kv(self.attn2_k, self.attn2_v, ctx, t))
            if self.image_cross and context_img is not None:
                k_ip, v_ip = self._kv(self.attn2_k_ip, self.attn2_v_ip,
                                      context_img.to(self.dtype), t)
                out = out + self.img_cross_scale * dot_product_attention(
                    q, k_ip, v_ip)
            tok = tok + self.attn2_out(out.flatten(-2))
        a, g = self.geglu(self.ln3(tok)).chunk(2, dim=-1)
        tok = tok + self.mlp_out(a * gelu_tanh(g))
        return x + self.proj_out(tok.reshape(b, t, hh, ww, -1))


class TemporalTransformer(nn.Module):
    """Per-location transformer over the frames: two self-attentions (the
    reference block's only-self mode) and the GEGLU MLP.  With
    ``use_relative_position`` each attention adds q·K2ᵀ to its scores and
    P·V2 to its output, K2 and V2 gathered from (2·max_len + 1, head_dim)
    tables by the clipped frame offset, on the plain math (as in the JAX
    package)."""

    def __init__(self, c: int, heads: int, head_dim: int, max_len: int = 64,
                 use_relative_position: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.head_dim, self.dtype = heads, head_dim, dtype
        self.max_len = max_len
        self.use_relative_position = use_relative_position
        inner = heads * head_dim
        self.norm = nn.GroupNorm(_groups(c), c, eps=1e-6)
        self.proj_in = nn.Linear(c, inner, dtype=dtype)
        for p in ("attn1", "attn2"):
            self.add_module(f"ln_{p}", LayerNorm(inner, eps=1e-6,
                                                 dtype=dtype))
            for s in ("q", "k", "v"):
                self.add_module(f"{p}_{s}", _heads(inner, heads, head_dim,
                                                   dtype))
            if use_relative_position:
                for s in ("k", "v"):
                    self.register_parameter(f"{p}_rel_{s}", nn.Parameter(
                        torch.zeros(2 * max_len + 1, head_dim)))
            self.add_module(f"{p}_out", nn.Linear(inner, inner, dtype=dtype))
        self.ln3 = LayerNorm(inner, eps=1e-6, dtype=dtype)
        self.geglu = nn.Linear(inner, inner * 8, dtype=dtype)
        self.mlp_out = nn.Linear(inner * 4, inner, dtype=dtype)
        self.proj_out = nn.Linear(inner, c, dtype=dtype)

    def _attn(self, tok: torch.Tensor, p: str) -> torch.Tensor:
        split = (self.heads, self.head_dim)
        m = getattr(self, f"ln_{p}")(tok)
        q, k, v = (getattr(self, f"{p}_{s}")(m).unflatten(-1, split)
                   for s in ("q", "k", "v"))
        if self.use_relative_position:
            t = tok.shape[1]
            pos = torch.arange(t, device=tok.device)
            idx = (pos[None, :] - pos[:, None]).clamp(
                -self.max_len, self.max_len) + self.max_len
            # the scores in f32 from operands in q's dtype (the JAX
            # package's preferred_element_type=f32)
            k2 = getattr(self, f"{p}_rel_k")[idx].to(q.dtype).float()
            v2 = getattr(self, f"{p}_rel_v")[idx].to(v.dtype)
            qf = q.float()
            sim = (torch.einsum("bqhd,bkhd->bhqk", qf, k.float())
                   + torch.einsum("bqhd,qkd->bhqk", qf, k2)) \
                * self.head_dim ** -0.5
            pr = torch.softmax(sim, dim=-1).to(v.dtype)
            o = (torch.einsum("bhqk,bkhd->bqhd", pr, v)
                 + torch.einsum("bhqk,qkd->bqhd", pr, v2))
        else:
            o = dot_product_attention(q, k, v)
        return tok + getattr(self, f"{p}_out")(o.flatten(-2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, hh, ww, c = x.shape
        h = self.proj_in(_group_norm(self.norm, x, 1).to(self.dtype))
        tok = h.permute(0, 2, 3, 1, 4).reshape(b * hh * ww, t, -1)
        tok = self._attn(self._attn(tok, "attn1"), "attn2")
        a, g = self.geglu(self.ln3(tok)).chunk(2, dim=-1)
        tok = tok + self.mlp_out(a * gelu_tanh(g))
        h = tok.reshape(b, hh, ww, t, -1).permute(0, 3, 1, 2, 4)
        return x + self.proj_out(h)


@register("videotuna_tpu_torch.models.lvdm.UNet3D",
          aliases=[
              "videotuna.models.lvdm.modules.networks.openaimodel3d.UNetModel",
              "videotuna.models.lvdm.modules.networks.openaimodel3d_dc."
              "UNetModel",
          ])
class UNet3D(nn.Module):
    """Constructor arguments are the JAX module's (the configs'
    ``unet_config``)."""

    def __init__(self, in_channels: int = 4, model_channels: int = 320,
                 out_channels: int = 4, num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (4, 2, 1),
                 channel_mult: Sequence[int] = (1, 2, 4, 4),
                 num_head_channels: int = 64,
                 context_dim: Optional[int] = 1024,
                 temporal_conv: bool = True, temporal_attention: bool = True,
                 temporal_length: int = 16,
                 use_relative_position: bool = True,
                 use_image_attention: bool = False, fps_cond: bool = False,
                 addition_attention: bool = False,
                 use_scale_shift_norm: bool = False,
                 dtype: Union[str, torch.dtype] = torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.in_channels = in_channels
        self.model_channels = mc = model_channels
        self.num_res_blocks = num_res_blocks
        self.attention_resolutions = tuple(attention_resolutions)
        self.channel_mult = tuple(channel_mult)
        self.num_head_channels = num_head_channels
        self.fps_cond = fps_cond
        self.dtype = dtype
        ted = mc * 4
        self.time_fc1 = nn.Linear(mc, ted, dtype=dtype)
        self.time_fc2 = nn.Linear(ted, ted, dtype=dtype)
        if fps_cond:
            self.fps_fc1 = nn.Linear(mc, ted, dtype=dtype)
            self.fps_fc2 = nn.Linear(ted, ted, dtype=dtype)
        self.conv_in = FrameConv(in_channels, mc, dtype=dtype)
        hd = num_head_channels
        if addition_attention:
            self.init_attn = TemporalTransformer(
                mc, 8, hd, temporal_length, use_relative_position, dtype)

        def res(name, cin, cout):
            self.add_module(name, ResBlock3D(cin, cout, ted, temporal_conv,
                                             use_scale_shift_norm, dtype))

        def attn_pair(idx, ch, ds, force=False):
            if force or ds in self.attention_resolutions:
                self.add_module(f"spatial_{idx}", SpatialTransformer(
                    ch, ch // hd, hd, context_dim, use_image_attention,
                    dtype=dtype))
                if temporal_attention:
                    self.add_module(f"temporal_{idx}", TemporalTransformer(
                        ch, ch // hd, hd, temporal_length,
                        use_relative_position, dtype))

        skips = [mc]
        ch, ds, idx = mc, 1, 0
        for level, mult in enumerate(self.channel_mult):
            for _ in range(num_res_blocks):
                res(f"down_res_{idx}", ch, mult * mc)
                ch = mult * mc
                attn_pair(f"down_{idx}", ch, ds)
                skips.append(ch)
                idx += 1
            if level != len(self.channel_mult) - 1:
                self.add_module(f"downsample_{level}",
                                FrameConv(ch, ch, stride=2, dtype=dtype))
                skips.append(ch)
                ds *= 2
        res("mid_res_1", ch, ch)
        attn_pair("mid", ch, ds, force=True)
        res("mid_res_2", ch, ch)
        idx = 0
        for level, mult in reversed(list(enumerate(self.channel_mult))):
            for i in range(num_res_blocks + 1):
                res(f"up_res_{idx}", ch + skips.pop(), mult * mc)
                ch = mult * mc
                attn_pair(f"up_{idx}", ch, ds)
                if level != 0 and i == num_res_blocks:
                    self.add_module(f"upsample_{level}",
                                    FrameConv(ch, ch, dtype=dtype))
                    ds //= 2
                idx += 1
        self.norm_out = FrameGN(ch)
        self.conv_out = FrameConv(ch, out_channels, dtype=dtype)

    def _attn_pair(self, h, idx, context, context_img):
        spatial = getattr(self, f"spatial_{idx}", None)
        if spatial is not None:
            h = spatial(h, context, context_img)
            temporal = getattr(self, f"temporal_{idx}", None)
            if temporal is not None:
                h = temporal(h)
        return h

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                context: Optional[torch.Tensor] = None,
                context_img: Optional[torch.Tensor] = None,
                fps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, T, H, W, C), timesteps (B,), context (B, L, context_dim),
        context_img (B, L_img, context_dim) DynamiCrafter's image tokens,
        fps (B,) → (B, T, H, W, out_channels) f32."""
        mc = self.model_channels
        emb = timestep_embedding(timesteps, mc).to(self.dtype)
        emb = self.time_fc2(F.silu(self.time_fc1(emb)))
        if self.fps_cond and fps is not None:
            fe = timestep_embedding(fps, mc).to(self.dtype)
            emb = emb + self.fps_fc2(F.silu(self.fps_fc1(fe)))
        h = self.conv_in(x.to(self.dtype))
        if hasattr(self, "init_attn"):
            h = self.init_attn(h)
        skips = [h]
        idx = 0
        for level in range(len(self.channel_mult)):
            for _ in range(self.num_res_blocks):
                h = getattr(self, f"down_res_{idx}")(h, emb)
                h = self._attn_pair(h, f"down_{idx}", context, context_img)
                skips.append(h)
                idx += 1
            if level != len(self.channel_mult) - 1:
                h = getattr(self, f"downsample_{level}")(h)
                skips.append(h)
        h = self.mid_res_1(h, emb)
        h = self._attn_pair(h, "mid", context, context_img)
        h = self.mid_res_2(h, emb)
        idx = 0
        for level in reversed(range(len(self.channel_mult))):
            for i in range(self.num_res_blocks + 1):
                h = torch.cat([h, skips.pop()], dim=-1)
                h = getattr(self, f"up_res_{idx}")(h, emb)
                h = self._attn_pair(h, f"up_{idx}", context, context_img)
                if level != 0 and i == self.num_res_blocks:
                    # jax.image.resize "nearest" at exactly 2×: each pixel
                    # repeated
                    h = h.repeat_interleave(2, dim=2).repeat_interleave(
                        2, dim=3)
                    h = getattr(self, f"upsample_{level}")(h)
                idx += 1
        h = F.silu(self.norm_out(h)).to(self.dtype)
        return self.conv_out(h).float()
