"""Open-Sora denoisers of the port."""

from videotuna_tpu_torch.models.opensora.stdit import STDiT, stdit_xl_2

__all__ = ["STDiT", "stdit_xl_2"]
