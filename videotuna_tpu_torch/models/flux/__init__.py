"""Flux (torch): the text-to-image DiT of Flux dev and schnell."""

from videotuna_tpu_torch.models.flux.dit import FluxModel, MLPEmbedder

__all__ = ["FluxModel", "MLPEmbedder"]
