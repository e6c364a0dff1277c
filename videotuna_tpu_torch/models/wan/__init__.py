"""Wan 2.1 (torch): the DiT and the causal 3D VAE."""

from videotuna_tpu_torch.models.wan.dit import WanBlock, WanModel
from videotuna_tpu_torch.models.wan.vae import WanVAE, wan_streaming_decode

__all__ = ["WanBlock", "WanModel", "WanVAE", "wan_streaming_decode"]
