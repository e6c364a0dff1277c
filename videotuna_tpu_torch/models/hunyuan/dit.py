"""HunyuanVideo DiT (torch), the counterpart of
``videotuna_tpu/models/hunyuan/dit.py``: a double- and single-stream MMDiT
with flow matching.

- conditioning vector = timestep ⊕ pooled CLIP (``vector_in``) ⊕ optional
  embedded guidance (``guidance_in``);
- ``double_blocks`` double-stream blocks: image and text streams with their
  own modulation, QKV (RMSNorm on q and k) and MLP, and one joint attention
  over [img; txt];
- ``single_blocks`` single-stream blocks over the concatenated sequence: a
  fused qkv+MLP ``linear1`` in, a fused attention+MLP ``linear2`` out;
- 3D RoPE (interleaved pairs) on the image tokens only;
- the token refiner over the LLaMA states, with its own timestep embedder
  and a key-and-query mask whose column 0 stays valid;
- final adaLN + linear → unpatchify;
- ``i2v_condition_type="token_replace"`` (HunyuanVideo I2V): the first
  latent frame's ``hh·ww`` image tokens are modulated with ``vec_tr``, the
  timestep-0 vector plus the pooled-text vector (no guidance), in every
  double- and single-stream block.  The JAX package broadcasts each
  modulation to the whole sequence; the port applies the two modulations
  to the two segments apart and materialises no broadcast.

Both joint attentions declare bounded logits (q and k are RMSNormed), so
under the flow's fixed max they take K3 (d ≤ 128).  The refiner carries an
additive mask and no qk-norm, so it stays on the math path, as in the JAX
package.  Latents are channel-last (B, T, H, W, C) in and f32 out.

``scan_blocks`` names the JAX parameter layout (leaves stacked under
``double_blocks`` / ``single_blocks``) that ``tools/from_jax.py`` reads; the
port holds one module per block either way.  ``remat`` recomputes each block
in the backward with ``torch.utils.checkpoint`` whenever autograd records.
The staged forward (``stage`` other than "all", the JAX package's compile
workaround for the TPU) is not ported.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from videotuna_tpu_torch.core.config import resolve_dtype
from videotuna_tpu_torch.core.registry import register
from videotuna_tpu_torch.kernels.attention import (dot_product_attention,
                                                   remat_contexts)
from videotuna_tpu_torch.models.layers import (HUNYUAN_ROPE_DIMS, LayerNorm,
                                               RMSNorm, TimestepEmbedder,
                                               apply_rope, dense_general,
                                               gelu_tanh, rope_3d,
                                               split_rope_dims, unpatchify_3d)


def _mods(linear: nn.Linear, vec: torch.Tensor, n: int):
    """adaLN parameters: linear(silu(vec)) split into n tensors (B, 1, D)."""
    return linear(F.silu(vec))[:, None, :].chunk(n, dim=-1)


def _ln(dim: int) -> LayerNorm:
    return LayerNorm(dim, eps=1e-6, affine=False)


def _segments(fn, x: torch.Tensor, mods, mods_tr, tr_len: int
              ) -> torch.Tensor:
    """fn(x, *mods) over the tokens of x (B, L, D); under token replace
    (``mods_tr`` given) the first ``tr_len`` tokens take ``mods_tr``."""
    if mods_tr is None:
        return fn(x, *mods)
    return torch.cat([fn(x[:, :tr_len], *mods_tr),
                      fn(x[:, tr_len:], *mods)], dim=1)


def _modulate(norm):
    return lambda x, scale, shift: norm(x) * (1 + scale) + shift


def _gated(linear):
    return lambda x, gate: gate * linear(x)


class MMDoubleStreamBlock(nn.Module):
    """Image and text streams, each with its own adaLN modulation, QKV with
    RMSNormed q and k, and MLP; one joint attention over [img; txt], RoPE on
    the image rows."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads = heads
        hd = dim // heads
        mlp = int(dim * mlp_ratio)
        for s in ("img", "txt"):
            self.add_module(f"{s}_mod", nn.Linear(dim, 6 * dim, dtype=dtype))
            for n in ("q", "k", "v"):
                self.add_module(f"{s}_{n}",
                                dense_general(dim, heads, hd, True, dtype))
            self.add_module(f"{s}_q_norm", RMSNorm(hd, dtype=dtype))
            self.add_module(f"{s}_k_norm", RMSNorm(hd, dtype=dtype))
            self.add_module(f"{s}_norm1", _ln(dim))
            self.add_module(f"{s}_norm2", _ln(dim))
            self.add_module(f"{s}_attn_out", nn.Linear(dim, dim, dtype=dtype))
            self.add_module(f"{s}_mlp1", nn.Linear(dim, mlp, dtype=dtype))
            self.add_module(f"{s}_mlp2", nn.Linear(mlp, dim, dtype=dtype))

    def _qkv(self, x: torch.Tensor, s: str):
        heads = (self.heads, -1)
        q = getattr(self, f"{s}_q")(x).unflatten(-1, heads)
        k = getattr(self, f"{s}_k")(x).unflatten(-1, heads)
        v = getattr(self, f"{s}_v")(x).unflatten(-1, heads)
        return (getattr(self, f"{s}_q_norm")(q),
                getattr(self, f"{s}_k_norm")(k), v)

    def _mlp(self, x: torch.Tensor, s: str) -> torch.Tensor:
        h = gelu_tanh(getattr(self, f"{s}_mlp1")(x))
        return getattr(self, f"{s}_mlp2")(h)

    def forward(self, img: torch.Tensor, txt: torch.Tensor,
                vec: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                vec_tr: Optional[torch.Tensor] = None, tr_len: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``vec_tr`` and ``tr_len``: token replace, the first ``tr_len``
        image tokens modulated with ``vec_tr``."""
        i_s1, i_sc1, i_g1, i_s2, i_sc2, i_g2 = _mods(self.img_mod, vec, 6)
        t_s1, t_sc1, t_g1, t_s2, t_sc2, t_g2 = _mods(self.txt_mod, vec, 6)
        tr = (_mods(self.img_mod, vec_tr, 6) if vec_tr is not None
              and tr_len else None)

        def img_seg(fn, x, *idx):
            return _segments(fn, x, [(i_s1, i_sc1, i_g1, i_s2, i_sc2,
                                      i_g2)[j] for j in idx],
                             tr and [tr[j] for j in idx], tr_len)

        iq, ik, iv = self._qkv(img_seg(_modulate(self.img_norm1), img, 1, 0),
                               "img")
        tq, tk, tv = self._qkv(self.txt_norm1(txt) * (1 + t_sc1) + t_s1,
                               "txt")
        iq = apply_rope(iq, cos, sin)
        ik = apply_rope(ik, cos, sin)
        att = dot_product_attention(torch.cat([iq, tq], dim=1),
                                    torch.cat([ik, tk], dim=1),
                                    torch.cat([iv, tv], dim=1),
                                    bounded_logits=True).flatten(-2)
        li = img.shape[1]
        img = img + img_seg(_gated(self.img_attn_out), att[:, :li], 2)
        txt = txt + t_g1 * self.txt_attn_out(att[:, li:])
        img = img + img_seg(
            _gated(lambda x: self._mlp(x, "img")),
            img_seg(_modulate(self.img_norm2), img, 4, 3), 5)
        txt = txt + t_g2 * self._mlp(self.txt_norm2(txt) * (1 + t_sc2)
                                     + t_s2, "txt")
        return img, txt


class MMSingleStreamBlock(nn.Module):
    """One stream over [img; txt]: ``linear1`` gives q, k, v and the MLP
    input at once; ``linear2`` maps [attention | gelu(MLP)] back.  The RoPE
    table's text rows are the identity."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.heads = dim, heads
        hd = dim // heads
        mlp = int(dim * mlp_ratio)
        self.mod = nn.Linear(dim, 3 * dim, dtype=dtype)
        self.norm = _ln(dim)
        self.linear1 = nn.Linear(dim, 3 * dim + mlp, dtype=dtype)
        self.q_norm = RMSNorm(hd, dtype=dtype)
        self.k_norm = RMSNorm(hd, dtype=dtype)
        self.linear2 = nn.Linear(dim + mlp, dim, dtype=dtype)

    def forward(self, x: torch.Tensor, vec: torch.Tensor,
                cos_full: torch.Tensor, sin_full: torch.Tensor,
                vec_tr: Optional[torch.Tensor] = None, tr_len: int = 0
                ) -> torch.Tensor:
        """``vec_tr`` and ``tr_len``: token replace, the first ``tr_len``
        tokens of [img; txt] modulated with ``vec_tr``."""
        d = self.dim
        shift, scale, gate = _mods(self.mod, vec, 3)
        tr = (_mods(self.mod, vec_tr, 3) if vec_tr is not None and tr_len
              else None)
        h = self.linear1(_segments(_modulate(self.norm), x, (scale, shift),
                                   tr and (tr[1], tr[0]), tr_len))
        # q, k and v are views of linear1's output: v goes to the kernel
        # through its strides, without a copy
        q, k, v = (h[..., i * d:(i + 1) * d].unflatten(-1, (self.heads, -1))
                   for i in range(3))
        q = apply_rope(self.q_norm(q), cos_full, sin_full)
        k = apply_rope(self.k_norm(k), cos_full, sin_full)
        att = dot_product_attention(q, k, v, bounded_logits=True)
        del q, k, v
        fused = torch.cat([att.flatten(-2), gelu_tanh(h[..., 3 * d:])],
                          dim=-1)
        del h, att
        return x + _segments(_gated(self.linear2), fused, (gate,),
                             tr and (tr[2],), tr_len)


class TokenRefiner(nn.Module):
    """The single token refiner over the LLaMA states: its own timestep
    embedder plus a projection of the masked mean of the raw states gate
    ``layers`` pre-LN self-attention blocks (no qk-norm) over the projected
    states.  The mask hides padded queries and keys, with key 0 kept valid
    so that every row has a key; it is an additive bias, so the attention
    runs on the math path."""

    def __init__(self, dim: int, in_dim: int, heads: int = 8,
                 layers: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.layers = heads, layers
        self.t_embedder = TimestepEmbedder(dim, dtype=dtype)
        self.c_embedder_1 = nn.Linear(in_dim, dim, dtype=dtype)
        self.c_embedder_2 = nn.Linear(dim, dim, dtype=dtype)
        self.input_embedder = nn.Linear(in_dim, dim, dtype=dtype)
        hd = dim // heads
        for i in range(layers):
            self.add_module(f"mod_{i}", nn.Linear(dim, 2 * dim, dtype=dtype))
            self.add_module(f"ln1_{i}", LayerNorm(dim, eps=1e-6, dtype=dtype))
            for n in ("q", "k", "v"):
                self.add_module(f"{n}_{i}",
                                dense_general(dim, heads, hd, True, dtype))
            self.add_module(f"attn_out_{i}", nn.Linear(dim, dim, dtype=dtype))
            self.add_module(f"ln2_{i}", LayerNorm(dim, eps=1e-6, dtype=dtype))
            self.add_module(f"fc1_{i}", nn.Linear(dim, 4 * dim, dtype=dtype))
            self.add_module(f"fc2_{i}", nn.Linear(4 * dim, dim, dtype=dtype))

    def forward(self, txt: torch.Tensor, t: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        temb = self.t_embedder(t)
        if mask is None:
            ctx = txt.mean(dim=1)
        else:
            mf = mask.to(txt.dtype)[..., None]
            ctx = (txt * mf).sum(dim=1) / mf.sum(dim=1).clamp_min(1e-6)
        c = temb + self.c_embedder_2(F.silu(self.c_embedder_1(ctx)))
        x = self.input_embedder(txt)
        bias = None
        if mask is not None:
            m = mask.bool()
            valid = m[:, None, :, None] & m[:, None, None, :]
            valid[..., 0] = True
            bias = torch.where(valid, 0.0, -1e30)
        heads = (self.heads, -1)
        for i in range(self.layers):
            layer = lambda name: getattr(self, f"{name}_{i}")  # noqa: E731
            g1, g2 = _mods(layer("mod"), c, 2)
            h = layer("ln1")(x)
            o = dot_product_attention(layer("q")(h).unflatten(-1, heads),
                                      layer("k")(h).unflatten(-1, heads),
                                      layer("v")(h).unflatten(-1, heads),
                                      bias=bias)
            x = x + g1 * layer("attn_out")(o.flatten(-2))
            h = layer("fc1")(layer("ln2")(x))
            x = x + g2 * layer("fc2")(F.silu(h))
        return x


@register("videotuna_tpu_torch.models.hunyuan.HYVideoDiT",
          aliases=[
              "videotuna.models.hunyuan.hyvideo_i2v.modules.models."
              "HYVideoDiffusionTransformer",
          ])
class HYVideoDiT(nn.Module):
    """HunyuanVideo's diffusion transformer; the 13B configuration is dim
    3072, 24 heads, 20 double and 40 single blocks, patch (1, 2, 2)."""

    def __init__(self, in_channels: int = 16, out_channels: int = 16,
                 dim: int = 3072, heads: int = 24, double_blocks: int = 20,
                 single_blocks: int = 40, mlp_ratio: float = 4.0,
                 patch_size: Sequence[int] = (1, 2, 2),
                 text_dim: int = 4096, pooled_dim: int = 768,
                 guidance_embed: bool = False, rope_theta: float = 256.0,
                 rope_dim_list: Optional[Sequence[int]] = None,
                 i2v_condition_type: Optional[str] = None,
                 dtype: Union[str, torch.dtype] = torch.float32,
                 scan_blocks: bool = False, remat: bool = False):
        super().__init__()
        dtype = resolve_dtype(dtype)
        # any other type, as in the JAX package, conditions nothing here
        self.token_replace = i2v_condition_type == "token_replace"
        self.out_channels = out_channels
        self.dim, self.heads = dim, heads
        self.patch_size = tuple(patch_size)
        self.rope_theta = rope_theta
        self.rope_dim_list = rope_dim_list
        self.guidance_embed = guidance_embed
        self.dtype = dtype
        self.scan_blocks = scan_blocks
        self.remat = remat
        self.t_embedder = TimestepEmbedder(dim, dtype=dtype)
        self.vector_in = nn.Linear(pooled_dim, dim, dtype=dtype)
        self.vector_in_out = nn.Linear(dim, dim, dtype=dtype)
        if guidance_embed:
            self.guidance_in = TimestepEmbedder(dim, dtype=dtype)
        self.img_in = nn.Conv3d(in_channels, dim, self.patch_size,
                                stride=self.patch_size, dtype=dtype)
        self.txt_in = TokenRefiner(dim, text_dim, heads=heads, dtype=dtype)
        self.double_blocks = nn.ModuleList(
            MMDoubleStreamBlock(dim, heads, mlp_ratio, dtype=dtype)
            for _ in range(double_blocks))
        self.single_blocks = nn.ModuleList(
            MMSingleStreamBlock(dim, heads, mlp_ratio, dtype=dtype)
            for _ in range(single_blocks))
        self.final_mod = nn.Linear(dim, 2 * dim, dtype=dtype)
        self.final_norm = _ln(dim)
        self.final_proj = nn.Linear(
            dim, math.prod(self.patch_size) * out_channels, dtype=dtype)

    def rope_dims(self) -> Tuple[int, int, int]:
        """(t, h, w) rotary widths: ``rope_dim_list``, else the released
        (16, 56, 56) at head_dim 128, else the even ~(1/4, 3/8, 3/8)
        split."""
        hd = self.dim // self.heads
        if self.rope_dim_list is not None:
            dims = tuple(self.rope_dim_list)
        elif hd == 128:
            dims = HUNYUAN_ROPE_DIMS
        else:
            dims = split_rope_dims(hd)
        if sum(dims) != hd:
            raise ValueError(f"rope dims {dims} do not sum to head_dim {hd}")
        return dims

    def forward(self, x: torch.Tensor, timestep: torch.Tensor,
                text_states: torch.Tensor,
                pooled_text: Optional[torch.Tensor] = None,
                text_mask: Optional[torch.Tensor] = None,
                guidance: Optional[torch.Tensor] = None,
                temporal_rope_scale: Optional[torch.Tensor] = None,
                stage: str = "all") -> torch.Tensor:
        """x (B, T, H, W, C) latents, timestep (B,), text_states (B, L,
        text_dim), pooled_text (B, pooled_dim), text_mask (B, L) bool,
        guidance (B,) → velocity (B, T, H, W, out_channels), f32."""
        if stage != "all":
            raise NotImplementedError(
                f"HYVideoDiT stage={stage!r} is the JAX package's staged "
                "compile for the TPU; the port runs stage='all'")
        pt, ph, pw = self.patch_size
        b, t_in, h_in, w_in, _ = x.shape
        tt, hh, ww = t_in // pt, h_in // ph, w_in // pw

        vec = self.t_embedder(timestep)
        vec_tr = (self.t_embedder(torch.zeros_like(timestep))
                  if self.token_replace else None)
        tr_len = hh * ww if self.token_replace else 0
        if pooled_text is not None:
            pv = self.vector_in(pooled_text.to(self.dtype))
            vec2 = self.vector_in_out(F.silu(pv))
            vec = vec + vec2
            if vec_tr is not None:
                vec_tr = vec_tr + vec2
        # guidance enters vec, not the token-replace vector
        if self.guidance_embed and guidance is not None:
            vec = vec + self.guidance_in(guidance)
        img = self.img_in(x.to(self.dtype).permute(0, 4, 1, 2, 3))
        img = img.flatten(2).transpose(1, 2)
        txt = self.txt_in(text_states.to(self.dtype), timestep, text_mask)

        cos, sin = rope_3d(*self.rope_dims(), tt, hh, ww,
                           theta=self.rope_theta,
                           temporal_scale=temporal_rope_scale,
                           device=x.device)
        cos, sin = cos.to(self.dtype), sin.to(self.dtype)
        remat = self.remat and torch.is_grad_enabled()

        def run(block, *args):
            if remat:
                return checkpoint(block, *args, use_reentrant=False,
                                  context_fn=remat_contexts)
            return block(*args)

        for block in self.double_blocks:
            img, txt = run(block, img, txt, vec, cos, sin, vec_tr, tr_len)
        img_len = img.shape[1]
        xcat = torch.cat([img, txt], dim=1)
        del img, txt
        lt = xcat.shape[1] - img_len
        cos_full = torch.cat([cos, cos.new_ones((lt, cos.shape[1]))])
        sin_full = torch.cat([sin, sin.new_zeros((lt, sin.shape[1]))])
        for block in self.single_blocks:
            xcat = run(block, xcat, vec, cos_full, sin_full, vec_tr, tr_len)

        shift, scale = _mods(self.final_mod, vec, 2)
        img = self.final_norm(xcat[:, :img_len]) * (1 + scale) + shift
        out = unpatchify_3d(self.final_proj(img), (tt, hh, ww),
                            self.patch_size, self.out_channels)
        return out.float()

