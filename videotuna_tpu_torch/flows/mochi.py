"""MochiFlow (torch): Mochi-1 text-to-video sampling and training, the
counterpart of ``videotuna_tpu/flows/mochi.py``: T5-XXL states and mask →
``MochiDiT`` with true CFG (the batch doubled) on the shifted
flow-matching Euler schedule → the Mochi VAE.  Training draws uniform
sigmas, x_t = (1 − σ)·x0 + σ·ε, and regresses the velocity ε − x0.

The checkpoint predicts the x0-ward flow, so the flow negates the DiT's
output (``negate_model_output``) and the standard schedule (v = ε − x0)
serves sampling and training alike.

The DiT's joint attention runs under the fixed softmax max 0: its q and k
are RMSNormed at d = 128, so every scaled log2-score lies within
±√128·log2e ≈ 16.3, inside exp2's window (−126, 127); with the caption
mask it takes route K4.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from videotuna_tpu_torch.core.registry import register
from videotuna_tpu_torch.flows.generation import Cond, GenerationFlow
from videotuna_tpu_torch.schedulers import (FlowMatchSchedule,
                                            flow_interpolate, flow_target,
                                            sample_sigmas)
from videotuna_tpu_torch.schedulers.common import randn


@register("videotuna_tpu_torch.flows.MochiFlow",
          aliases=["diffusers.MochiPipeline"])
class MochiFlow(GenerationFlow):
    latent_channels = 12
    vae_spatial_ratio = 8
    vae_temporal_ratio = 6

    def __init__(self, *args, num_inference_steps: int = 64,
                 flow_shift: float = 6.0, negate_model_output: bool = True,
                 **kwargs):
        kwargs.setdefault("model_max_length", 256)
        kwargs.setdefault("attn_static_max", 0.0)
        super().__init__(*args, **kwargs)
        self.negate_model_output = negate_model_output
        if not isinstance(self.scheduler, FlowMatchSchedule):
            self.scheduler = FlowMatchSchedule.create(
                num_inference_steps, flow_shift).to(self.device)

    def denoise_apply(self, x: torch.Tensor, t: torch.Tensor,
                      cond: Cond) -> torch.Tensor:
        out = self.denoiser(x, t, cond["y"], cond.get("mask"))
        return -out if self.negate_model_output else out

    def training_loss(self, batch: Dict[str, Any],
                      generator: Optional[torch.Generator] = None, *,
                      sigma: Optional[torch.Tensor] = None,
                      noise: Optional[torch.Tensor] = None,
                      posterior_noise: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Flow-matching MSE of the velocity at t = 1000·σ, σ uniform, the
        per-sample mean with a NaN sample counted as 0, then the batch
        mean.  ``batch``: "video" (B, T, H, W, 3) in [−1, 1] or "latents",
        "text_states" and optionally "text_mask".  Given ``sigma``,
        ``noise`` or ``posterior_noise`` replace the draws."""
        z = batch.get("latents")
        if z is None:
            z = self.encode_video(batch["video"], generator,
                                  noise=posterior_noise)
        if sigma is None:
            sigma = sample_sigmas(generator, z.shape[0], "uniform",
                                  device=z.device)
        sigma = sigma.to(z)
        noise = (randn(z.shape, generator, z.device) if noise is None
                 else noise.to(z))
        x_t = flow_interpolate(z, noise, sigma)
        v = self.denoise_apply(x_t, sigma * 1000.0,
                               {"y": batch["text_states"],
                                "mask": batch.get("text_mask")})
        per = ((v - flow_target(z, noise)) ** 2).mean(
            dim=tuple(range(1, z.ndim)))
        loss = torch.where(torch.isnan(per), 0.0, per).mean()
        return loss, {"loss": loss, "sigma_mean": sigma.mean()}
