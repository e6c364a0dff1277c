"""Flows of the port — model compositions (VAE + text encoder + denoiser +
scheduler)."""

from videotuna_tpu_torch.flows.generation import (GenerationFlow,
                                                  load_prompts, savename)
from videotuna_tpu_torch.flows.cogvideo import CogVideoXFlow
from videotuna_tpu_torch.flows.hunyuan import HunyuanVideoFlow
from videotuna_tpu_torch.flows.mochi import MochiFlow
from videotuna_tpu_torch.flows.opensora import OpenSoraFlow
from videotuna_tpu_torch.flows.stepvideo import StepVideoFlow
from videotuna_tpu_torch.flows.videocrafter import VideocrafterFlow
from videotuna_tpu_torch.flows.wan import WanVideoFlow

__all__ = ["GenerationFlow", "CogVideoXFlow", "HunyuanVideoFlow",
           "MochiFlow", "OpenSoraFlow", "StepVideoFlow", "VideocrafterFlow",
           "WanVideoFlow",
           "load_prompts", "savename"]
