"""HunyuanVideo (torch): the DiT and the causal 3D VAE."""

from videotuna_tpu_torch.models.hunyuan.dit import HYVideoDiT
from videotuna_tpu_torch.models.hunyuan.vae import HunyuanVAE

__all__ = ["HYVideoDiT", "HunyuanVAE"]
