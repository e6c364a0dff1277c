"""VideoCrafter 1/2 and DynamiCrafter (torch): the latent video UNet and the
image conditioning tower."""

from videotuna_tpu_torch.models.lvdm.image_cond import (CLIPImageEmbedder,
                                                        ImageConditioner,
                                                        ImageProjModel,
                                                        Resampler)
from videotuna_tpu_torch.models.lvdm.unet3d import UNet3D

__all__ = ["CLIPImageEmbedder", "ImageConditioner", "ImageProjModel",
           "Resampler", "UNet3D"]
