"""Mochi-1 (torch): the AsymmDiT."""

from videotuna_tpu_torch.models.mochi.dit import (MochiAttentionPool,
                                                  MochiBlock, MochiDiT)

__all__ = ["MochiAttentionPool", "MochiBlock", "MochiDiT"]
