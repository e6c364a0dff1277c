"""The LLaVA pieces of the captioner (torch), the counterpart of
``videotuna_tpu/tools/captioner.py``: the CLIP tower's patch states of the
penultimate block (``feature_layer=-2``), projected by LLaVA-1.5's
``mlp2x_gelu`` into the language model's width.  HunyuanVideo I2V's prompt
encode splices them into the LLaMA (``flows/hunyuan.py``
``encode_text_i2v``).

The greedy caption decode, ``from_pretrained`` and ``caption_directory``
wait for queue 1, item 10.4 of ROADMAP.md.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from videotuna_tpu_torch.core.config import resolve_dtype
from videotuna_tpu_torch.models.clip_vision import (CLIPVisionEncoder,
                                                    preprocess_frames)

_WAITS = ("waits for the captioning slice (ROADMAP.md queue 1, item 10.4: "
          "tools/captioner.py)")


class LlavaProjector(nn.Module):
    """LLaVA-1.5's ``mlp2x_gelu``: vision width → ``out_dim``, exact GELU,
    → ``out_dim``."""

    def __init__(self, in_dim: int = 1024, out_dim: int = 4096,
                 dtype: Union[str, torch.dtype] = torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.dtype = dtype
        self.fc1 = nn.Linear(in_dim, out_dim, dtype=dtype)
        self.fc2 = nn.Linear(out_dim, out_dim, dtype=dtype)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(feats.to(self.dtype))))


class LlavaCaptioner:
    """The vision tower and the projector (the language model joins them
    with the decode)."""

    def __init__(self, vision: CLIPVisionEncoder, projector: LlavaProjector):
        self.vision = vision
        self.projector = projector

    @torch.no_grad()
    def image_tokens(self, frames: torch.Tensor) -> torch.Tensor:
        """(T, H, W, 3) in [−1, 1] → (T·N_patches, lm_dim): each frame's
        projected patch states, the class token dropped, the frames one
        after the other."""
        x = preprocess_frames(frames, self.vision.image_size)
        _, states = self.vision(x, return_states=True)
        proj = self.projector(states[:, 1:])
        return proj.reshape(-1, proj.shape[-1])

    def caption(self, frames: torch.Tensor, prompt_ids: Sequence[int],
                max_new_tokens: int = 32):
        raise NotImplementedError(f"LlavaCaptioner.caption {_WAITS}")

    def _decode(self, *args, **kwargs):
        raise NotImplementedError(f"LlavaCaptioner._decode {_WAITS}")

    @classmethod
    def from_pretrained(cls, *args, **kwargs) -> "LlavaCaptioner":
        raise NotImplementedError(f"LlavaCaptioner.from_pretrained {_WAITS}")


def caption_directory(*args, **kwargs) -> int:
    raise NotImplementedError(f"caption_directory {_WAITS}")
