"""STDiT (torch): the Open-Sora v1.0 spatial-temporal DiT, the counterpart
of ``videotuna_tpu/models/opensora/stdit.py``.

Patchify (1,2,2) → [spatial attention → temporal attention → cross-attention
to the T5 tokens → MLP] × depth with PixArt-style modulation (a shared 6-way
scale/shift table plus per-timestep offsets), a sincos spatial pos-embed, the
temporal pos-embed added before the first temporal attention, the T2I final
layer, optional sigma prediction (out_ch = 2·in_ch).  Latents are
channel-last (B, T, H, W, C) in and out; tokens are (B, T, S, C), so the
spatial / temporal factorisation is a reshape.

The variant flags of the JAX module are all here: ``qk_norm``,
``temporal_rope``, ``temporal_mod``, ``paired_blocks``, ``dynamic_pos_embed``
and the ``x_mask`` frame mask.  ``scan_blocks`` names the JAX parameter
layout, which ``tools/from_jax.py`` and the LoRA tree follow; ``remat``
recomputes each block (or pair) in the backward with
``torch.utils.checkpoint``, as ``nn.remat`` does, whenever autograd
records.  The temporal pos-embed goes to block 0 only (under scan it is the ``tpe_gate``, so both
layouts are one function), except in the scanned paired layout, where the
JAX module hands it to every pair and so does the port.  With
``dynamic_pos_embed`` (Open-Sora 1.2) the module holds ``fps_embedder``, a
timestep embedder whose embedding of ``fps``, when a call gives it, is added
to the timestep's and to the t0 embedding of the ``x_mask`` frames (the JAX
module makes that embedder only when its init is given fps; the upstream
STDiT3 always has it).  The staged forward (``stage`` other than "all") and
sharding constraints are not ported.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from videotuna_tpu_torch.core.config import resolve_dtype
from videotuna_tpu_torch.core.registry import register
from videotuna_tpu_torch.kernels.attention import remat_contexts
from videotuna_tpu_torch.models.layers import (Attention, LayerNorm, Mlp,
                                               PatchEmbed3D,
                                               TimestepEmbedder, gelu_tanh,
                                               modulate, rope_frequencies,
                                               unpatchify_3d)


def _sincos(pos: torch.Tensor, dim: int) -> torch.Tensor:
    """[sin | cos] of pos (n,) against dim/2 frequencies → (n, dim)."""
    omega = 1.0 / (10000.0 ** (torch.arange(dim // 2, dtype=torch.float32,
                                            device=pos.device) / (dim // 2)))
    out = pos[:, None] * omega[None]
    return torch.cat([torch.sin(out), torch.cos(out)], dim=1)


def sincos_pos_embed_2d(dim: int, h: int, w: int, scale: float = 1.0,
                        device: Optional[torch.device] = None
                        ) -> torch.Tensor:
    """2D sincos position table (h·w, dim): the W coordinate in the first
    half, as the reference's ``get_2d_sincos_pos_embed``."""
    def axis(n):
        return _sincos(torch.arange(n, dtype=torch.float32, device=device)
                       / scale, dim // 2)
    return torch.cat([axis(w).repeat(h, 1),
                      axis(h).repeat_interleave(w, dim=0)], dim=1)


def pos_embed_2d_dynamic(dim: int, h: int, w: int,
                         scale: Union[float, torch.Tensor], base_size: int,
                         device: Optional[torch.device] = None
                         ) -> torch.Tensor:
    """Open-Sora 1.2 PositionEmbedding2D: [sin, cos] halves per axis,
    positions divided by the resolution ``scale`` and renormalised by
    ``base_size`` → (h·w, dim)."""
    half = dim // 2
    inv = 1.0 / (10000 ** (torch.arange(0, half, 2, dtype=torch.float32,
                                        device=device) / half))
    gh = torch.arange(h, dtype=torch.float32, device=device) / scale \
        * (base_size / h)
    gw = torch.arange(w, dtype=torch.float32, device=device) / scale \
        * (base_size / w)
    grid_h = gw[None, :].expand(h, w).reshape(-1)
    grid_w = gh[:, None].expand(h, w).reshape(-1)

    def emb(t):
        out = t[:, None] * inv[None]
        return torch.cat([torch.sin(out), torch.cos(out)], dim=-1)

    return torch.cat([emb(grid_h), emb(grid_w)], dim=-1)


def sincos_pos_embed_1d(dim: int, n: int, scale: float = 1.0,
                        device: Optional[torch.device] = None
                        ) -> torch.Tensor:
    return _sincos(torch.arange(n, dtype=torch.float32, device=device)
                   / scale, dim)


class STDiTBlock(nn.Module):
    """One STDiT layer.  ``attn_mode``: "both" (spatial + temporal
    attention, STDiT1-7), or "spatial" / "temporal" (the single-axis blocks
    of the paired STDiT8 / Open-Sora 1.2 layout)."""

    def __init__(self, hidden: int, heads: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32, qk_norm: bool = False,
                 temporal_rope: bool = False, temporal_mod: bool = False,
                 attn_mode: str = "both"):
        super().__init__()
        if attn_mode not in ("both", "spatial", "temporal"):
            raise ValueError(f"unknown attn_mode {attn_mode!r}")
        self.hidden = hidden
        self.heads = heads
        self.dtype = dtype
        self.temporal_rope = temporal_rope
        self.attn_mode = attn_mode
        self.scale_shift_table = nn.Parameter(
            torch.zeros(6, hidden, dtype=torch.float32))
        self.norm1 = LayerNorm(hidden, eps=1e-6, affine=False)
        self.attn = Attention(hidden, heads, qk_norm=qk_norm, dtype=dtype)
        self.temporal_mod = temporal_mod and attn_mode == "both"
        if self.temporal_mod:
            self.scale_shift_table_temporal = nn.Parameter(
                torch.zeros(3, hidden, dtype=torch.float32))
            self.norm_temp = LayerNorm(hidden, eps=1e-6, affine=False)
        if attn_mode == "both":
            self.attn_temp = Attention(hidden, heads, qk_norm=qk_norm,
                                       dtype=dtype)
        self.cross_attn = Attention(hidden, heads, dtype=dtype)
        self.norm2 = LayerNorm(hidden, eps=1e-6, affine=False)
        self.mlp = Mlp(hidden, int(hidden * mlp_ratio), dtype=dtype)

    def _mods(self, table: torch.Tensor, tvec: torch.Tensor):
        """table (n, C) + tvec (B, n, C) in f32 → n tensors (B, 1, 1, C)."""
        mods = table[None] + tvec.float()
        return [m.to(self.dtype)[:, None, None] for m in mods.unbind(1)]

    def _temporal_attn(self, attn: Attention, x: torch.Tensor,
                       tpe: Optional[torch.Tensor]) -> torch.Tensor:
        """Attention over frames: (B, T, S, C) → S folded into the batch."""
        b, tt, ss, c = x.shape
        x_t = x.transpose(1, 2).reshape(b * ss, tt, c)
        rope = None
        if self.temporal_rope:
            rope = rope_frequencies(self.hidden // self.heads,
                                    torch.arange(tt, device=x.device))
        elif tpe is not None:
            x_t = x_t + tpe.to(self.dtype)
        x_t = attn(x_t, rope=rope)
        return x_t.reshape(b, ss, tt, c).transpose(1, 2)

    def forward(self, x: torch.Tensor, y: torch.Tensor, t6: torch.Tensor,
                y_mask: Optional[torch.Tensor] = None,
                tpe: Optional[torch.Tensor] = None,
                t3: Optional[torch.Tensor] = None,
                t6_zero: Optional[torch.Tensor] = None,
                t3_zero: Optional[torch.Tensor] = None,
                x_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, T, S, C); y (B, L, C); t6 (B, 6, C); t3 (B, 3, C).
        ``x_mask`` (B, T) bool: False frames are modulated at timestep 0
        (``t6_zero`` / ``t3_zero``)."""
        b, tt, ss, c = x.shape
        (shift_msa, scale_msa, gate_msa,
         shift_mlp, scale_mlp, gate_mlp) = self._mods(self.scale_shift_table,
                                                      t6)
        masked = x_mask is not None and t6_zero is not None
        zmods = (self._mods(self.scale_shift_table, t6_zero) if masked
                 else [None] * 6)
        fm = x_mask.to(self.dtype).reshape(b, tt, 1, 1) if masked else None

        def fsel(a, z):
            return a if fm is None else a * fm + z * (1.0 - fm)

        def mod(h, shift, scale, zshift, zscale):
            return fsel(modulate(h, shift, scale),
                        None if zshift is None
                        else modulate(h, zshift, zscale))

        def gate(h, g, zg):
            return fsel(g * h, None if zg is None else zg * h)

        x_m = mod(self.norm1(x), shift_msa, scale_msa, zmods[0], zmods[1])
        if self.attn_mode == "temporal":
            # the single attention runs over frames on the modulated input
            x = x + gate(self._temporal_attn(self.attn, x_m, tpe), gate_msa,
                         zmods[2])
        else:
            x_s = self.attn(x_m.reshape(b * tt, ss, c)).reshape(b, tt, ss, c)
            x = x + gate(x_s, gate_msa, zmods[2])

        if self.attn_mode == "both":
            # the temporal branch: the shared 6-way gate (STDiT1-4) or the
            # separate 3-way temporal table (STDiT5-7)
            if self.temporal_mod:
                shift_t, scale_t, gate_t = self._mods(
                    self.scale_shift_table_temporal, t3)
                zt = (self._mods(self.scale_shift_table_temporal, t3_zero)
                      if masked and t3_zero is not None else [None] * 3)
                x_tm = mod(self.norm_temp(x), shift_t, scale_t, zt[0], zt[1])
                zgate_t = zt[2]
            else:
                x_tm, gate_t, zgate_t = x, gate_msa, zmods[2]
            x = x + gate(self._temporal_attn(self.attn_temp, x_tm, tpe),
                         gate_t, zgate_t)

        # cross-attention to the text tokens
        x_flat = x.reshape(b, tt * ss, c)
        x_flat = x_flat + self.cross_attn(x_flat, context=y, mask=y_mask)
        x = x_flat.reshape(b, tt, ss, c)

        x_m = mod(self.norm2(x), shift_mlp, scale_mlp, zmods[3], zmods[4])
        return x + gate(self.mlp(x_m), gate_mlp, zmods[5])


class PairedSTDiTCell(nn.Module):
    """One (spatial-only, temporal-only) block pair: the STDiT8 / Open-Sora
    1.2 layout."""

    def __init__(self, hidden: int, heads: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32, qk_norm: bool = False,
                 temporal_rope: bool = False):
        super().__init__()
        self.spatial = STDiTBlock(hidden, heads, mlp_ratio, dtype,
                                  qk_norm=qk_norm, attn_mode="spatial")
        self.temporal = STDiTBlock(hidden, heads, mlp_ratio, dtype,
                                   qk_norm=qk_norm,
                                   temporal_rope=temporal_rope,
                                   attn_mode="temporal")

    def forward(self, x, y, t6, y_mask=None, tpe=None, t6_zero=None,
                x_mask=None):
        x = self.spatial(x, y, t6, y_mask=y_mask, t6_zero=t6_zero,
                         x_mask=x_mask)
        return self.temporal(x, y, t6, y_mask=y_mask, tpe=tpe,
                             t6_zero=t6_zero, x_mask=x_mask)


@register("videotuna_tpu_torch.models.opensora.STDiT",
          aliases=[
              "videotuna.models.opensora.models.stdit.stdit.STDiT",
              "videotuna.models.opensora.models.stdit.stdit.STDiT_XL_2",
          ])
class STDiT(nn.Module):
    """Args mirror the JAX module (and the reference constructor)."""

    def __init__(self, input_size: Sequence[int] = (16, 32, 32),
                 in_channels: int = 4, patch_size: Sequence[int] = (1, 2, 2),
                 hidden_size: int = 1152, depth: int = 28,
                 num_heads: int = 16, mlp_ratio: float = 4.0,
                 pred_sigma: bool = True, caption_channels: int = 4096,
                 model_max_length: int = 120, space_scale: float = 1.0,
                 time_scale: float = 1.0,
                 dtype: Union[str, torch.dtype] = torch.float32,
                 remat: bool = False, scan_blocks: bool = False,
                 qk_norm: bool = False, temporal_rope: bool = False,
                 temporal_mod: bool = False, paired_blocks: bool = False,
                 dynamic_pos_embed: bool = False,
                 input_sq_size: float = 512.0):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.input_size = tuple(input_size)
        self.in_channels = in_channels
        self.patch_size = tuple(patch_size)
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.pred_sigma = pred_sigma
        self.caption_channels = caption_channels
        self.space_scale = space_scale
        self.time_scale = time_scale
        self.dtype = dtype
        self.qk_norm = qk_norm
        self.temporal_rope = temporal_rope
        self.temporal_mod = temporal_mod
        self.paired_blocks = paired_blocks
        self.scan_blocks = scan_blocks
        self.remat = remat
        self.dynamic_pos_embed = dynamic_pos_embed
        self.input_sq_size = input_sq_size

        self.x_embedder = PatchEmbed3D(in_channels, hidden_size,
                                       self.patch_size, flatten=False,
                                       dtype=dtype)
        self.t_embedder = TimestepEmbedder(hidden_size, dtype=dtype)
        self.t_block = nn.Linear(hidden_size, 6 * hidden_size, dtype=dtype)
        if dynamic_pos_embed:
            self.fps_embedder = TimestepEmbedder(hidden_size, dtype=dtype)
        if temporal_mod:
            self.t_block_temp = nn.Linear(hidden_size, 3 * hidden_size,
                                          dtype=dtype)
        self.y_proj1 = nn.Linear(caption_channels, hidden_size, dtype=dtype)
        self.y_proj2 = nn.Linear(hidden_size, hidden_size, dtype=dtype)
        if paired_blocks:
            self.pairs = nn.ModuleList(
                PairedSTDiTCell(hidden_size, num_heads, mlp_ratio, dtype,
                                qk_norm=qk_norm, temporal_rope=temporal_rope)
                for _ in range(depth))
        else:
            self.blocks = nn.ModuleList(
                STDiTBlock(hidden_size, num_heads, mlp_ratio, dtype,
                           qk_norm=qk_norm, temporal_rope=temporal_rope,
                           temporal_mod=temporal_mod)
                for _ in range(depth))
        self.final_scale_shift_table = nn.Parameter(
            torch.zeros(2, hidden_size, dtype=torch.float32))
        self.final_norm = LayerNorm(hidden_size, eps=1e-6, affine=False)
        pt, ph, pw = self.patch_size
        self.final_linear = nn.Linear(hidden_size,
                                      pt * ph * pw * self.out_channels,
                                      dtype=dtype)

    @property
    def out_channels(self) -> int:
        return self.in_channels * 2 if self.pred_sigma else self.in_channels

    def forward(self, x: torch.Tensor, timestep: torch.Tensor,
                y: torch.Tensor, mask: Optional[torch.Tensor] = None,
                stage: str = "all", x_mask: Optional[torch.Tensor] = None,
                fps: Optional[torch.Tensor] = None,
                height: Optional[torch.Tensor] = None,
                width: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, T, H, W, C) latents; timestep (B,); y (B, L, C_cap) text
        states; mask (B, L) bool; x_mask (B, T) bool; fps (B,), read with
        ``dynamic_pos_embed`` only → (B, T, H, W, C_out) f32."""
        if stage != "all":
            raise NotImplementedError(
                f"STDiT stage={stage!r} is the JAX package's staged compile "
                "for the TPU; the port runs stage='all'")
        b, t_in, h_in, w_in, _ = x.shape
        pt, ph, pw = self.patch_size
        tt, hh, ww = t_in // pt, h_in // ph, w_in // pw
        ss = hh * ww
        c = self.hidden_size
        dev = x.device

        tpe = sincos_pos_embed_1d(c, tt, self.time_scale, device=dev)
        tok = self.x_embedder(x.to(self.dtype)).reshape(b, tt, ss, c)
        if self.dynamic_pos_embed:
            res_sq = (torch.sqrt((height[0] * width[0]).float())
                      if height is not None else float(h_in * 8))
            pos = pos_embed_2d_dynamic(c, hh, ww, res_sq / self.input_sq_size,
                                       int(round(ss ** 0.5)), device=dev)
        else:
            pos = sincos_pos_embed_2d(c, hh, ww, self.space_scale,
                                      device=dev)
        tok = tok + pos[None, None].to(self.dtype)

        t_emb = self.t_embedder(timestep)
        fps_emb = (self.fps_embedder(fps)
                   if self.dynamic_pos_embed and fps is not None else None)
        if fps_emb is not None:
            t_emb = t_emb + fps_emb
        t6 = self.t_block(F.silu(t_emb)).reshape(b, 6, c)
        t3 = t6_zero = t3_zero = t0_emb = None
        if self.temporal_mod:
            t3 = self.t_block_temp(F.silu(t_emb)).reshape(b, 3, c)
        if x_mask is not None:
            # masked frames are conditioned at timestep 0
            t0_emb = self.t_embedder(torch.zeros_like(timestep))
            if fps_emb is not None:
                t0_emb = t0_emb + fps_emb
            t6_zero = self.t_block(F.silu(t0_emb)).reshape(b, 6, c)
            if self.temporal_mod:
                t3_zero = self.t_block_temp(F.silu(t0_emb)).reshape(b, 3, c)

        y = self.y_proj2(gelu_tanh(self.y_proj1(y.to(self.dtype))))

        remat = self.remat and torch.is_grad_enabled()

        def run(cell, *args, **kwargs):
            if remat:
                return checkpoint(cell, *args, use_reentrant=False,
                                  context_fn=remat_contexts, **kwargs)
            return cell(*args, **kwargs)

        if self.paired_blocks:
            for i, pair in enumerate(self.pairs):
                tok = run(pair, tok, y, t6, y_mask=mask,
                          tpe=tpe if i == 0 or self.scan_blocks else None,
                          t6_zero=t6_zero, x_mask=x_mask)
        else:
            for i, block in enumerate(self.blocks):
                tok = run(block, tok, y, t6, y_mask=mask,
                          tpe=tpe if i == 0 else None, t3=t3,
                          t6_zero=t6_zero, t3_zero=t3_zero, x_mask=x_mask)

        # T2I final layer; with x_mask the masked frames get the timestep-0
        # modulation on top of the t-modulated tokens, as the reference does
        def fin_mods(te):
            fin = self.final_scale_shift_table[None] + te.float()[:, None]
            shift, scale = fin.unbind(1)
            return (shift.to(self.dtype)[:, None, None],
                    scale.to(self.dtype)[:, None, None])

        shift, scale = fin_mods(t_emb)
        tok = modulate(self.final_norm(tok), shift, scale)
        if x_mask is not None:
            tok0 = modulate(self.final_norm(tok), *fin_mods(t0_emb))
            fm = x_mask.to(self.dtype).reshape(b, tt, 1, 1)
            tok = tok * fm + tok0 * (1.0 - fm)
        tok = self.final_linear(tok).reshape(b, tt * ss, -1)
        out = unpatchify_3d(tok, (tt, hh, ww), self.patch_size,
                            self.out_channels)
        return out.float()


def stdit_xl_2(**kwargs) -> STDiT:
    kwargs.setdefault("hidden_size", 1152)
    kwargs.setdefault("depth", 28)
    kwargs.setdefault("num_heads", 16)
    return STDiT(**kwargs)
