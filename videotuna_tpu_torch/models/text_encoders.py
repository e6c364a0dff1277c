"""Text encoders (torch): the T5 encoder of the CogVideoX path and host-side
tokenisation, counterparts of ``videotuna_tpu/models/text_encoders.py``.

T5 attention carries a relative-position bias, so it runs on the math path
of ``dot_product_attention``, as in the JAX package.
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
from videotuna_tpu_torch.models.layers import RMSNorm, dense_general


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
