"""Flows of the port — model compositions (VAE + text encoder + denoiser +
scheduler)."""

from videotuna_tpu_torch.flows.generation import (GenerationFlow,
                                                  load_prompts, savename)
from videotuna_tpu_torch.flows.cogvideo import CogVideoXFlow

__all__ = ["GenerationFlow", "CogVideoXFlow", "load_prompts", "savename"]
