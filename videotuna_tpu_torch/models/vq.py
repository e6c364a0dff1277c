"""Vector-quantised video autoencoders (torch), the counterpart of
``videotuna_tpu/models/vq.py``: codebook VQ (MoVQ-style) and lookup-free
quantisation (MagViT-v2) around the causal 3D encoder and decoder of
``models/vae3d.py``.

- ``VectorQuantizer``: the nearest code by squared distance (one (N, C) ×
  (C, K) product), the codebook and commitment terms, the straight-through
  gradient, perplexity;
- ``LFQ``: each channel quantised to ±1 (implicit codebook {−1, 1}^C), the
  commitment term and the entropy terms over sigmoid(4z) bit
  probabilities;
- ``VQVAE3D``: encoder → the mean half of its moments → quantiser →
  decoder.

Latents are channel-last (B, T, H, W, C), as in the rest of the port.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple, Union

import torch
from torch import nn

from videotuna_tpu_torch.core.config import resolve_dtype
from videotuna_tpu_torch.core.registry import register
from videotuna_tpu_torch.models.vae3d import Decoder3D, Encoder3D


def _straight_through(z: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """q in the forward, the identity's gradient to z in the backward."""
    return z + (q - z).detach()


class VectorQuantizer(nn.Module):
    """Codebook VQ with a straight-through gradient; returns (quantised,
    {"indices", "vq_loss", "perplexity"})."""

    def __init__(self, codebook_size: int = 1024, dim: int = 8,
                 beta: float = 0.25):
        super().__init__()
        self.dim, self.beta = dim, beta
        self.codebook = nn.Parameter(torch.empty(codebook_size, dim))

    def forward(self, z: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, Any]]:
        cb = self.codebook
        flat = z.reshape(-1, self.dim)
        d = ((flat ** 2).sum(-1, keepdim=True) - 2.0 * flat @ cb.T
             + (cb ** 2).sum(-1)[None])
        idx = d.argmin(-1)
        zq = cb[idx].reshape(z.shape)
        codebook_loss = ((z.detach() - zq) ** 2).mean()
        commit_loss = ((z - zq.detach()) ** 2).mean()
        probs = torch.bincount(idx, minlength=cb.shape[0]).float() \
            / idx.numel()
        perplexity = torch.exp(-(probs * torch.log(probs + 1e-10)).sum())
        return _straight_through(z, zq), {
            "indices": idx.reshape(z.shape[:-1]),
            "vq_loss": codebook_loss + self.beta * commit_loss,
            "perplexity": perplexity}


class LFQ(nn.Module):
    """Lookup-free quantisation: each channel to ±1; the entropy terms push
    each sample's bits to be confident and the batch's to use the whole
    codebook."""

    def __init__(self, dim: int = 12, commit_weight: float = 0.25,
                 entropy_weight: float = 0.1):
        super().__init__()
        self.dim = dim
        self.commit_weight, self.entropy_weight = commit_weight, entropy_weight

    def forward(self, z: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, Any]]:
        q = torch.where(z > 0, 1.0, -1.0).to(z)
        commit = ((z - q.detach()) ** 2).mean()

        def entropy(p):
            return -(p * torch.log(p + 1e-8)
                     + (1 - p) * torch.log(1 - p + 1e-8)).mean()

        p = torch.sigmoid(4.0 * z.reshape(-1, self.dim))
        per_sample_ent = entropy(p)
        batch_ent = entropy(p.mean(0))
        weights = 2 ** torch.arange(self.dim, device=z.device)
        codes = ((q > 0).long() * weights).sum(-1)
        return _straight_through(z, q), {
            "indices": codes,
            "vq_loss": self.commit_weight * commit
            + self.entropy_weight * (per_sample_ent - batch_ent),
            "per_sample_entropy": per_sample_ent,
            "batch_entropy": batch_ent}


@register("videotuna_tpu_torch.models.VQVAE3D",
          aliases=["videotuna.models.cogvideo_sat.sgm.MagViT2",
                   "videotuna.models.cogvideo_sat.sgm.MoVQ"])
class VQVAE3D(nn.Module):
    """Causal 3D VQ autoencoder (the encoder and decoder of
    ``CausalVAE3D``); ``quantizer`` "vq" or "lfq"."""

    def __init__(self, ch: int = 64, ch_mult: Sequence[int] = (1, 2, 4),
                 num_res_blocks: int = 1, z_dim: int = 8,
                 quantizer: str = "vq", codebook_size: int = 1024,
                 dtype: Union[str, torch.dtype] = torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.encoder = Encoder3D(ch, ch_mult, num_res_blocks,
                                 z_channels=z_dim, dtype=dtype)
        self.decoder = Decoder3D(ch, ch_mult, num_res_blocks,
                                 z_channels=z_dim, dtype=dtype)
        self.quant = (LFQ(dim=z_dim) if quantizer == "lfq"
                      else VectorQuantizer(codebook_size, z_dim))

    def encode(self, video: torch.Tensor):
        """(B, T, H, W, 3) → (quantised latents (B, t, h, w, z_dim), aux)."""
        moments = self.encoder(video.permute(0, 4, 1, 2, 3))
        return self.quant(moments.permute(0, 2, 3, 4, 1).chunk(2, dim=-1)[0])

    def decode(self, zq: torch.Tensor) -> torch.Tensor:
        return self.decoder(zq.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)

    def forward(self, video: torch.Tensor):
        zq, aux = self.encode(video)
        return self.decode(zq), aux
