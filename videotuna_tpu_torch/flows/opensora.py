"""OpenSoraFlow (torch): Open-Sora v1.0 STDiT text-to-video sampling, the
counterpart of ``videotuna_tpu/flows/opensora.py``: T5 → STDiT with CFG
under DDIM over the DDPM chain (or IDDPM spaced sampling with learned
variance) → the frame-wise 2D KL VAE.

The Open-Sora 1.2 rectified-flow sampler and the training loss wait for
later slices.
"""

from __future__ import annotations

import torch

from videotuna_tpu_torch.core.registry import register
from videotuna_tpu_torch.flows.generation import Cond, GenerationFlow
from videotuna_tpu_torch.schedulers import DDIMSchedule, DDPMSchedule
from videotuna_tpu_torch.schedulers.iddpm import SpacedSchedule


@register("videotuna_tpu_torch.flows.OpenSoraFlow",
          aliases=["videotuna.models.opensora.models.iddpm3d.IDDPM"])
class OpenSoraFlow(GenerationFlow):
    latent_channels = 4
    vae_spatial_ratio = 8
    vae_temporal_ratio = 1

    def __init__(self, *args, num_frames: int = 16, height: int = 256,
                 width: int = 256, ddim_steps: int = 50,
                 ddim_eta: float = 0.0, **kwargs):
        sched_cfg = kwargs.get("scheduler_config") or (args[1] if len(args) > 1
                                                       else {})
        if str(sched_cfg.get("target", "")).endswith("FlowMatchSchedule"):
            raise NotImplementedError(
                "Open-Sora 1.2 rectified-flow sampling waits for the "
                "HunyuanVideo slice, which ports schedulers/flow_match.py")
        super().__init__(*args, **kwargs)
        self.num_frames = num_frames
        self.height = height
        self.width = width
        # the config's scheduler is the DDPM base; the DDIM subset is
        # derived once
        if isinstance(self.scheduler, DDPMSchedule):
            self.base_schedule = self.scheduler
            self.scheduler = DDIMSchedule.create(self.base_schedule,
                                                 ddim_steps, ddim_eta)
        elif isinstance(self.scheduler, DDIMSchedule):
            self.base_schedule = self.scheduler.base
        elif isinstance(self.scheduler, SpacedSchedule):
            # Open-Sora 1.1: respacing is sampling-only; training uses the
            # full chain
            self.base_schedule = self.scheduler.full or self.scheduler.base
        else:
            raise TypeError(f"Unsupported scheduler {type(self.scheduler)}")

    def denoise_apply(self, x: torch.Tensor, t: torch.Tensor,
                      cond: Cond) -> torch.Tensor:
        """STDiT on (x, t, y, mask).  A ``pred_sigma`` model emits 2·C
        channels: IDDPM spaced sampling reads both halves, every other
        schedule the eps half."""
        out = self.denoiser(x, t, cond["y"], cond.get("mask"))
        c = x.shape[-1]
        if out.shape[-1] == 2 * c \
                and not isinstance(self.scheduler, SpacedSchedule):
            out = out[..., :c]
        return out

    def training_loss(self, *args, **kwargs):
        raise NotImplementedError(
            "the Open-Sora training loss waits for the training slice")
