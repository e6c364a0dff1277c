"""StepVideo (torch): the 30B text-to-video DiT."""

from videotuna_tpu_torch.models.stepvideo.dit import (StepVideoBlock,
                                                      StepVideoModel)

__all__ = ["StepVideoBlock", "StepVideoModel"]
