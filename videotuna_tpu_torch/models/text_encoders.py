"""Text encoders (torch): the T5 encoder (CogVideoX, Open-Sora, Mochi), the
CLIP text transformer, the LLaMA decoder used as an encoder (HunyuanVideo),
StepVideo's Step-1 LLM, host-side tokenisation and HunyuanVideo I2V's
LLaVA prompt encode, counterparts of
``videotuna_tpu/models/text_encoders.py``.

T5 attention carries a relative-position bias, so it runs on the math path
of ``dot_product_attention``, as in the JAX package.  CLIP and LLaMA are
causal: LLaMA and StepLLM at ≥ 128 tokens take the flash kernel (K2), CLIP
at its 77 tokens the math path.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from videotuna_tpu_torch.core.config import resolve_dtype
from videotuna_tpu_torch.core.registry import register
from videotuna_tpu_torch.kernels.attention import dot_product_attention
from videotuna_tpu_torch.models.layers import (LayerNorm, RMSNorm,
                                               apply_rope_half, dense_general,
                                               rope_frequencies)


def t5_relative_bucket(relative_position: torch.Tensor,
                       num_buckets: int = 32,
                       max_distance: int = 128) -> torch.Tensor:
    """Bidirectional T5 relative-position bucketing."""
    num_buckets //= 2
    ret = (relative_position > 0).to(torch.int32) * num_buckets
    n = relative_position.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-6)
        / np.log(max_distance / max_exact)
        * (num_buckets - max_exact)).to(torch.int32)
    val_if_large = val_if_large.clamp_max(num_buckets - 1)
    return ret + torch.where(is_small, n.to(torch.int32), val_if_large)


class T5SelfAttention(nn.Module):
    def __init__(self, dim: int, heads: int, head_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads = heads
        self.head_dim = head_dim
        inner = heads * head_dim
        self.q = dense_general(dim, heads, head_dim, False, dtype)
        self.k = dense_general(dim, heads, head_dim, False, dtype)
        self.v = dense_general(dim, heads, head_dim, False, dtype)
        self.o = nn.Linear(inner, dim, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor, bias: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        shape = (*x.shape[:-1], self.heads, self.head_dim)
        q = self.q(x).view(shape)
        k = self.k(x).view(shape)
        v = self.v(x).view(shape)
        full_bias = bias
        if mask is not None:
            full_bias = bias + torch.where(mask[:, None, None, :], 0.0, -1e30)
        # T5 does not scale by sqrt(d)
        out = dot_product_attention(q, k, v, bias=full_bias, scale=1.0)
        return self.o(out.reshape(*x.shape[:-1], -1))


class T5Block(nn.Module):
    def __init__(self, dim: int, heads: int, head_dim: int, ff_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = RMSNorm(dim, eps=1e-6, dtype=dtype)
        self.attn = T5SelfAttention(dim, heads, head_dim, dtype=dtype)
        self.norm2 = RMSNorm(dim, eps=1e-6, dtype=dtype)
        self.wi_0 = nn.Linear(dim, ff_dim, bias=False, dtype=dtype)
        self.wi_1 = nn.Linear(dim, ff_dim, bias=False, dtype=dtype)
        self.wo = nn.Linear(ff_dim, dim, bias=False, dtype=dtype)

    def forward(self, x, bias, mask):
        x = x + self.attn(self.norm1(x), bias, mask)
        h = self.norm2(x)
        ff = F.gelu(self.wi_0(h), approximate="tanh") * self.wi_1(h)
        return x + self.wo(ff)


@register("videotuna_tpu_torch.models.T5Encoder",
          aliases=[
              "videotuna.models.opensora.models.text_encoder.t5.T5Encoder",
          ])
class T5Encoder(nn.Module):
    """Encoder-only T5 (T5-v1.1/umT5 layout); defaults are T5-XXL."""

    def __init__(self, vocab_size: int = 32128, dim: int = 4096,
                 heads: int = 64, head_dim: int = 64, ff_dim: int = 10240,
                 num_layers: int = 24, rel_buckets: int = 32,
                 rel_max_distance: int = 128,
                 dtype: Union[str, torch.dtype] = torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.dim = dim
        self.rel_buckets = rel_buckets
        self.rel_max_distance = rel_max_distance
        self.token_embed = nn.Embedding(vocab_size, dim, dtype=dtype)
        self.rel_bias = nn.Parameter(
            torch.zeros(rel_buckets, heads, dtype=torch.float32))
        self.blocks = nn.ModuleList(
            T5Block(dim, heads, head_dim, ff_dim, dtype=dtype)
            for _ in range(num_layers))
        self.final_norm = RMSNorm(dim, eps=1e-6, dtype=dtype)

    def forward(self, input_ids: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """input_ids (B, N) int, mask (B, N) bool → (B, N, dim)."""
        x = self.token_embed(input_ids)
        n = input_ids.shape[-1]
        pos = torch.arange(n, device=input_ids.device)
        buckets = t5_relative_bucket(pos[None, :] - pos[:, None],
                                     self.rel_buckets, self.rel_max_distance)
        bias = self.rel_bias[buckets].permute(2, 0, 1)[None]   # (1,H,N,N)
        for block in self.blocks:
            x = block(x, bias, mask)
        x = self.final_norm(x)
        if mask is not None:
            x = x * mask[..., None].to(x.dtype)
        return x


# ---------------------------------------------------------------------------
# CLIP text encoder
# ---------------------------------------------------------------------------

class CLIPBlock(nn.Module):
    """Pre-LN causal self-attention and a quick-GELU MLP."""

    def __init__(self, dim: int, heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads = heads
        self.ln1 = LayerNorm(dim, eps=1e-5, dtype=dtype)
        self.q = dense_general(dim, heads, dim // heads, True, dtype)
        self.k = dense_general(dim, heads, dim // heads, True, dtype)
        self.v = dense_general(dim, heads, dim // heads, True, dtype)
        self.attn_out = nn.Linear(dim, dim, dtype=dtype)
        self.ln2 = LayerNorm(dim, eps=1e-5, dtype=dtype)
        self.fc1 = nn.Linear(dim, dim * 4, dtype=dtype)
        self.fc2 = nn.Linear(dim * 4, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.ln1(x)
        heads = (self.heads, -1)
        att = dot_product_attention(self.q(h).unflatten(-1, heads),
                                    self.k(h).unflatten(-1, heads),
                                    self.v(h).unflatten(-1, heads),
                                    causal=True)
        x = x + self.attn_out(att.flatten(-2))
        h = self.fc1(self.ln2(x))
        h = h * torch.sigmoid(1.702 * h)   # quick-GELU
        return x + self.fc2(h)


@register("videotuna_tpu_torch.models.CLIPTextEncoder",
          aliases=[
              "videotuna.models.lvdm.modules.encoders.condition."
              "FrozenOpenCLIPEmbedder",
          ])
class CLIPTextEncoder(nn.Module):
    """OpenCLIP-style causal text transformer with learned positions.
    ``penultimate=True`` (the default) runs and holds all but the last layer
    and returns their states after the final LayerNorm."""

    def __init__(self, vocab_size: int = 49408, dim: int = 1024,
                 heads: int = 16, num_layers: int = 24, max_len: int = 77,
                 penultimate: bool = True,
                 dtype: Union[str, torch.dtype] = torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.max_len = max_len
        self.dtype = dtype
        self.pos_embed = nn.Parameter(
            torch.zeros(max_len, dim, dtype=torch.float32))
        self.token_embed = nn.Embedding(vocab_size, dim, dtype=dtype)
        n_run = num_layers - 1 if penultimate else num_layers
        self.blocks = nn.ModuleList(CLIPBlock(dim, heads, dtype=dtype)
                                    for _ in range(n_run))
        self.ln_final = LayerNorm(dim, eps=1e-5, dtype=dtype)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """input_ids (B, N ≤ max_len) int → (B, N, dim)."""
        x = self.token_embed(input_ids)
        x = x + self.pos_embed[None, :x.shape[1]].to(self.dtype)
        for block in self.blocks:
            x = block(x)
        return self.ln_final(x)


# ---------------------------------------------------------------------------
# LLaMA decoder used as a text encoder (HunyuanVideo)
# ---------------------------------------------------------------------------

class LlamaBlock(nn.Module):
    """RMSNorm (eps 1e-5) → causal attention with rotate-half RoPE and
    grouped KV heads → RMSNorm → SwiGLU (ff_dim = int(dim·8/3) by
    default); no biases."""

    def __init__(self, dim: int, heads: int, kv_heads: Optional[int] = None,
                 ff_dim: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hd = dim // heads
        kvh = kv_heads or heads
        ff = ff_dim or int(dim * 8 / 3)
        self.heads, self.kv_heads, self.head_dim = heads, kvh, hd
        self.attn_norm = RMSNorm(dim, eps=1e-5, dtype=dtype)
        self.q = dense_general(dim, heads, hd, False, dtype)
        self.k = dense_general(dim, kvh, hd, False, dtype)
        self.v = dense_general(dim, kvh, hd, False, dtype)
        self.o = nn.Linear(dim, dim, bias=False, dtype=dtype)
        self.mlp_norm = RMSNorm(dim, eps=1e-5, dtype=dtype)
        self.gate = nn.Linear(dim, ff, bias=False, dtype=dtype)
        self.up = nn.Linear(dim, ff, bias=False, dtype=dtype)
        self.down = nn.Linear(ff, dim, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
        h = self.attn_norm(x)
        q = self.q(h).unflatten(-1, (self.heads, self.head_dim))
        k = self.k(h).unflatten(-1, (self.kv_heads, self.head_dim))
        v = self.v(h).unflatten(-1, (self.kv_heads, self.head_dim))
        o = dot_product_attention(apply_rope_half(q, cos, sin),
                                  apply_rope_half(k, cos, sin), v,
                                  causal=True)
        x = x + self.o(o.flatten(-2))
        h = self.mlp_norm(x)
        return x + self.down(F.silu(self.gate(h)) * self.up(h))


@register("videotuna_tpu_torch.models.LlamaTextEncoder",
          aliases=[
              "videotuna.models.hunyuan.hyvideo_i2v.text_encoder.TextEncoder",
          ])
class LlamaTextEncoder(nn.Module):
    """Causal LLaMA returning its final hidden states, zeroed where ``mask``
    is False.  ``input_embeds`` replaces the token embedding (multimodal
    prefixes); ``lm_head=True`` adds the vocabulary projection and returns
    logits."""

    def __init__(self, vocab_size: int = 32000, dim: int = 4096,
                 heads: int = 32, kv_heads: Optional[int] = None,
                 ff_dim: Optional[int] = None, num_layers: int = 32,
                 rope_theta: float = 10000.0, lm_head: bool = False,
                 dtype: Union[str, torch.dtype] = torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.dim = dim
        self.heads = heads
        self.rope_theta = rope_theta
        self.dtype = dtype
        self.token_embed = nn.Embedding(vocab_size, dim, dtype=dtype)
        self.blocks = nn.ModuleList(
            LlamaBlock(dim, heads, kv_heads, ff_dim, dtype=dtype)
            for _ in range(num_layers))
        self.final_norm = RMSNorm(dim, eps=1e-5, dtype=dtype)
        self.lm_head = (nn.Linear(dim, vocab_size, bias=False, dtype=dtype)
                        if lm_head else None)

    def forward(self, input_ids: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                input_embeds: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """input_ids (B, N) int or input_embeds (B, N, dim), mask (B, N)
        bool → (B, N, dim), or (B, N, vocab) logits with ``lm_head``."""
        if input_embeds is not None:
            x = input_embeds.to(self.dtype)
        else:
            x = self.token_embed(input_ids)
        cos, sin = rope_frequencies(
            self.dim // self.heads,
            torch.arange(x.shape[-2], device=x.device), self.rope_theta)
        for block in self.blocks:
            x = block(x, cos, sin)
        x = self.final_norm(x)
        if self.lm_head is not None:
            x = self.lm_head(x)
        if mask is not None:
            x = x * mask[..., None].to(x.dtype)
        return x

    def embed_tokens(self, input_ids: torch.Tensor) -> torch.Tensor:
        """The token embedding alone, for assembling ``input_embeds``."""
        return self.token_embed(input_ids)


# ---------------------------------------------------------------------------
# StepLLM: StepVideo's Step-1 text encoder (multi-query attention, SwiGLU,
# no positional encoding, no final norm)
# ---------------------------------------------------------------------------

class StepLLMBlock(nn.Module):
    """RMSNorm → causal attention over ``groups`` shared key/value heads
    (the fused ``wqkv``: q, then each group's [k | v]) → RMSNorm → SwiGLU
    (the fused ``w1``: silu(first half) · second half); no biases."""

    def __init__(self, dim: int, heads: int, groups: int, ff_hidden: int,
                 eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.heads, self.groups = dim, heads, groups
        self.head_dim = dim // heads
        self.attn_norm = RMSNorm(dim, eps=eps, dtype=dtype)
        self.wqkv = nn.Linear(dim, dim + 2 * groups * self.head_dim,
                              bias=False, dtype=dtype)
        self.wo = nn.Linear(dim, dim, bias=False, dtype=dtype)
        self.ffn_norm = RMSNorm(dim, eps=eps, dtype=dtype)
        self.w1 = nn.Linear(dim, 2 * ff_hidden, bias=False, dtype=dtype)
        self.w2 = nn.Linear(ff_hidden, dim, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, kv = self.wqkv(self.attn_norm(x)).split(
            [self.dim, 2 * self.groups * self.head_dim], dim=-1)
        q = q.unflatten(-1, (self.heads, self.head_dim))
        k, v = kv.unflatten(-1, (self.groups, 2 * self.head_dim)).chunk(
            2, dim=-1)
        # dot_product_attention repeats each group over heads // groups
        # adjacent query heads, as the JAX package's jnp.repeat
        o = dot_product_attention(q, k, v, causal=True)
        x = x + self.wo(o.flatten(-2))
        a, gate = self.w1(self.ffn_norm(x)).chunk(2, dim=-1)
        return x + self.w2(F.silu(a) * gate)


@register("videotuna_tpu_torch.models.StepLLMEncoder",
          aliases=["videotuna.models.stepvideo.stepvideo.text_encoder."
                   "stepllm.STEP1TextEncoder"])
class StepLLMEncoder(nn.Module):
    """Step-1 text encoder (30B config: dim 6144, 48 heads over 8 key/value
    groups, 48 layers; SwiGLU hidden ⌈dim·8/3⌉ rounded up to 256): word
    embeddings, the blocks, the states zeroed where ``mask`` is False.
    Every attention is causal at d = dim / heads; in f32 at d = 128 it takes
    the f32 Hopper design (route K2)."""

    def __init__(self, vocab_size: int = 65536, dim: int = 6144,
                 heads: int = 48, groups: int = 8,
                 ff_hidden: Optional[int] = None, num_layers: int = 48,
                 eps: float = 1e-5,
                 dtype: Union[str, torch.dtype] = torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        if ff_hidden is None:
            ff_hidden = 256 * ((int(dim * 8 / 3) + 255) // 256)
        self.dim = dim
        self.tok_embeddings = nn.Embedding(vocab_size, dim, dtype=dtype)
        self.blocks = nn.ModuleList(
            StepLLMBlock(dim, heads, groups, ff_hidden, eps, dtype)
            for _ in range(num_layers))

    def forward(self, input_ids: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """input_ids (B, N) int, mask (B, N) bool → (B, N, dim)."""
        x = self.tok_embeddings(input_ids)
        for block in self.blocks:
            x = block(x)
        if mask is not None:
            x = x * mask[..., None].to(x.dtype)
        return x


# ---------------------------------------------------------------------------
# Host-side tokenisation
# ---------------------------------------------------------------------------

_TOKENIZERS: dict = {}


def tokenize(texts, tokenizer_name: str = "t5", max_length: int = 120,
             pretrained: Optional[str] = None
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Host tokenisation → (ids, mask) int32/bool arrays.

    Falls back to the JAX package's hash tokenizer when no pretrained
    tokenizer is available.  That fallback uses Python's salted ``hash()``,
    so its ids are stable only within one process; it is copied as it is so
    the two packages agree inside one process (see ROADMAP.md)."""
    key = (tokenizer_name, pretrained)
    tok = _TOKENIZERS.get(key)
    if tok is None and pretrained is not None:
        try:
            from transformers import AutoTokenizer
            tok = AutoTokenizer.from_pretrained(pretrained)
            _TOKENIZERS[key] = tok
        except Exception:
            tok = None
    if tok is not None:
        enc = tok(list(texts), padding="max_length", truncation=True,
                  max_length=max_length, return_tensors="np")
        return (enc["input_ids"].astype(np.int32),
                enc["attention_mask"].astype(bool))
    # offline fallback: hash of whitespace tokens
    ids = np.zeros((len(texts), max_length), np.int32)
    mask = np.zeros((len(texts), max_length), bool)
    for i, t in enumerate(texts):
        words = str(t).split()[:max_length]
        for j, w in enumerate(words):
            ids[i, j] = (hash(w) % 30000) + 2
            mask[i, j] = True
        if not words:
            ids[i, 0] = 1
            mask[i, 0] = True
    return ids, mask


# ---------------------------------------------------------------------------
# HunyuanVideo I2V: the LLaVA prompt encode.  The prompt goes into a chat
# template whose system message holds an <image> slot; the slot becomes 576
# projected CLIP patch states in the LLaMA's input; the output states are
# cropped into [subsampled image states ; text states] for the DiT.
# ---------------------------------------------------------------------------

HUNYUAN_PROMPT_TEMPLATES = {
    "dit-llm-encode-i2v": {
        "template": ("<|start_header_id|>system<|end_header_id|>\n\n"
                     "<image>\nDescribe the image by detailing the color, "
                     "shape, size, texture, quantity, text, spatial "
                     "relationships of the objects and background:"
                     "<|eot_id|><|start_header_id|>user<|end_header_id|>"
                     "\n\n{}<|eot_id|>"
                     "<|start_header_id|>assistant<|end_header_id|>\n\n"),
        "crop_start": 36, "image_emb_start": 5, "image_emb_end": 581,
        "image_emb_len": 576, "double_return_token_id": 271,
    },
    "dit-llm-encode-video-i2v": {
        "template": ("<|start_header_id|>system<|end_header_id|>\n\n"
                     "<image>\nDescribe the video by detailing the "
                     "following aspects according to the reference image: "
                     "1. The main content and theme of the video."
                     "2. The color, shape, size, texture, quantity, text, "
                     "and spatial relationships of the objects."
                     "3. Actions, events, behaviors temporal relationships, "
                     "physical movement changes of the objects."
                     "4. background environment, light, style and "
                     "atmosphere."
                     "5. camera angles, movements, and transitions used in "
                     "the video:<|eot_id|>\n\n"
                     "<|start_header_id|>user<|end_header_id|>\n\n{}"
                     "<|eot_id|>"
                     "<|start_header_id|>assistant<|end_header_id|>\n\n"),
        "crop_start": 103, "image_emb_start": 5, "image_emb_end": 581,
        "image_emb_len": 576, "double_return_token_id": 271,
    },
}

# token replace keeps every 4th image state, latent concat every 2nd
HUNYUAN_I2V_INTERLEAVE = {"token_replace": 4, "latent_concat": 2}


def _span(start: int, stop: int, n: int) -> np.ndarray:
    """The indices of ``x[start:stop]`` for a length-``n`` axis (Python's
    slice rules: clipped, negative from the end)."""
    return np.arange(*slice(start, stop).indices(n))


def hunyuan_i2v_crop_index(input_ids: np.ndarray, lh: int, template: dict,
                           image_embed_interleave: int
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Where ``hunyuan_i2v_crop`` takes its rows from: (rows (B, N) into
    the LLaMA's ``lh`` states, cols (B, M) into the un-expanded (B, L)
    mask, −1 for an image row, whose mask is 1)."""
    crop_start = template["crop_start"]
    emb_len = template["image_emb_len"]
    img_s, img_e = template["image_emb_start"], template["image_emb_end"]
    b, L = input_ids.shape
    text_crop_start = crop_start - 1 + emb_len
    img = _span(img_s, img_e, lh)
    if 0 < image_embed_interleave < 6:
        img = img[::image_embed_interleave]
    rows, cols = [], []
    for i in range(b):
        dr = np.where(input_ids[i] == template["double_return_token_id"])[0]
        # the template holds four "\n\n" tokens; where a long prompt
        # truncates the last away, the end of the sequence stands for it
        last_dr = L if dr.size in (0, 3) else int(dr[-1])
        a_start, a_end = last_dr - 1 + emb_len - 4, last_dr - 1 + emb_len
        rows.append(np.concatenate([img, _span(text_crop_start, a_start, lh),
                                    _span(a_end, lh, lh)]))
        cols.append(np.concatenate([np.full(img.size, -1),
                                    _span(crop_start, last_dr - 4, L),
                                    _span(last_dr, L, L)]))
    if len({r.size for r in rows}) > 1:
        raise ValueError("hunyuan_i2v_crop: the prompts crop to different "
                         "lengths")
    return np.stack(rows), np.stack(cols)


def _crop_mask(attn_mask: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """The crop's mask: 1 for an image row (col −1), else the prompt's."""
    batch = np.arange(cols.shape[0])[:, None]
    return np.where(cols < 0, True, attn_mask[batch, np.maximum(cols, 0)]
                    ).astype(attn_mask.dtype)


def hunyuan_i2v_crop(hidden: np.ndarray, attn_mask: np.ndarray,
                     input_ids: np.ndarray, template: dict,
                     image_embed_interleave: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """The crop of the I2V prompt encode.  ``hidden``: (B, L + 575, D) the
    LLaMA's states, the one <image> token expanded to 576 patch states;
    ``attn_mask`` and ``input_ids``: (B, L), not expanded.  Returns (y,
    mask): the image states, every ``image_embed_interleave``-th, before the
    text states without the template's prefix and its last "\n\n"."""
    rows, cols = hunyuan_i2v_crop_index(input_ids, hidden.shape[1],
                                        template, image_embed_interleave)
    return (hidden[np.arange(rows.shape[0])[:, None], rows],
            _crop_mask(attn_mask, cols))


@torch.no_grad()
def encode_hunyuan_i2v(llama: LlamaTextEncoder, texts, image_states,
                       tokenizer: Optional[str] = None,
                       template_name: str = "dit-llm-encode-video-i2v",
                       text_len: int = 256,
                       i2v_condition_type: str = "token_replace",
                       image_token: str = "<image>"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The I2V prompt encode: template → tokens → the 576 projected CLIP
    patch states spliced at the <image> slot (``image_emb_start``) → the
    LLaMA over the expanded sequence → ``hunyuan_i2v_crop``, on the LLaMA's
    device.  ``image_states``: (B, 576, D_lm), e.g.
    ``tools.captioner.LlavaCaptioner.image_tokens``.  Returns (y, mask).

    Fewer than 576 states raise: the crop's offsets assume 576, and the JAX
    package, given fewer (its captioner's tower at 224 gives 256), returns
    image rows that hold text states, no text rows, and a mask longer than
    ``y`` (ROADMAP.md queue 3)."""
    template = HUNYUAN_PROMPT_TEMPLATES[template_name]
    emb_len = template["image_emb_len"]
    if image_states.shape[1] < emb_len:
        raise ValueError(
            f"encode_hunyuan_i2v needs {emb_len} image states a prompt, got "
            f"{image_states.shape[1]}: the crop assumes {emb_len} (a CLIP "
            "tower at 336 px, feature_layer -2); see ROADMAP.md queue 3")
    prompts = [template["template"].format(t) for t in texts]
    # the <image> slot held out as one placeholder token
    marked = [p.replace(image_token, " \x00 ") for p in prompts]
    ids, mask = tokenize(marked, tokenizer_name="llama",
                         max_length=text_len + template["crop_start"],
                         pretrained=tokenizer)
    # the slot sits at image_emb_start with the LLaMA tokenizer, and the
    # crop's offsets assume it there, so the splice is pinned there
    pos = template["image_emb_start"]
    dev = llama.token_embed.weight.device
    tok = llama.embed_tokens(torch.as_tensor(ids, device=dev))
    embeds = torch.cat([tok[:, :pos],
                        image_states[:, :emb_len].to(tok),
                        tok[:, pos + 1:]], dim=1)
    expanded = np.concatenate([mask[:, :pos],
                               np.ones((mask.shape[0], emb_len), mask.dtype),
                               mask[:, pos + 1:]], axis=1)
    hidden = llama(input_embeds=embeds,
                   mask=torch.as_tensor(expanded, device=dev))
    rows, cols = hunyuan_i2v_crop_index(
        ids, hidden.shape[1], template,
        HUNYUAN_I2V_INTERLEAVE.get(i2v_condition_type, 1))
    y = hidden[torch.arange(len(ids), device=dev)[:, None],
               torch.as_tensor(rows, device=dev)]
    return y, torch.as_tensor(_crop_mask(mask, cols), device=dev)
