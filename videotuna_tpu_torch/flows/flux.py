"""FluxFlow (torch): Flux dev and schnell text-to-image sampling and its
rectified-flow loss, the counterpart of ``videotuna_tpu/flows/flux.py``: T5
states and CLIP's pooled vector → ``FluxModel`` on the flow-matching Euler
schedule shifted by the image's token count (embedded guidance for dev, 4
steps and no guidance for schnell) → the 2×2-packed latents unpacked for the
2D KL VAE.

The flow sets no fixed max: Flux's joint attention runs the online softmax
(K2 sampling, K5 under autograd, at d = 128 on K3's Hopper kernel).  CFG
never runs (the configs' guidance scale is 1 and the sampler takes no
uncond), so a prompt samples at B = 1.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from videotuna_tpu_torch.core.registry import register
from videotuna_tpu_torch.flows.generation import Cond, GenerationFlow
from videotuna_tpu_torch.flows.hunyuan import HunyuanVideoFlow
from videotuna_tpu_torch.schedulers import (FlowMatchSchedule,
                                            flow_interpolate, flow_target,
                                            sample_sigmas)
from videotuna_tpu_torch.schedulers.common import randn

# ROADMAP.md queue 3: no dataset or trainer of the JAX package fills the
# packed latents that FluxFlow.training_loss reads
FLUX_TRAIN_FAULT = (
    "ROADMAP.md queue 3's Flux-training fault: the JAX package's "
    "FluxFlow.training_loss reads batch['latents'] (packed latents), which "
    "no dataset or Trainer.prepare_batch fills (a dataset batch raises "
    "KeyError 'latents' there)")


def flux_shift_for_resolution(tokens: int, base_tokens: int = 256,
                              max_tokens: int = 4096,
                              base_shift: float = 0.5,
                              max_shift: float = 1.15) -> float:
    """Flux's resolution-dependent timestep shift exp(μ), μ linear in the
    image's token count: larger images get more high-noise steps."""
    m = (max_shift - base_shift) / (max_tokens - base_tokens)
    return math.exp(base_shift + m * (tokens - base_tokens))


@register("videotuna_tpu_torch.flows.FluxFlow",
          aliases=["videotuna.flow.flux.FluxFlow"])
class FluxFlow(GenerationFlow):
    latent_channels = 16
    vae_spatial_ratio = 8
    vae_temporal_ratio = 1

    def __init__(self, *args, num_inference_steps: int = 28,
                 guidance_scale: float = 3.5, schnell: bool = False,
                 **kwargs):
        kwargs.setdefault("model_max_length", 512)
        kwargs.setdefault("scale_factor", 0.3611)
        super().__init__(*args, **kwargs)
        self.schnell = schnell
        self.guidance_scale = guidance_scale
        self.num_inference_steps = 4 if schnell else num_inference_steps
        # the unshifted schedule of the steps sample() takes (it shifts by
        # the image's token count), so that metric.json counts them
        self.scheduler = FlowMatchSchedule.create(
            self.num_inference_steps, 1.0,
            num_train_timesteps=1).to(self.device)

    def latent_shape(self, batch, num_frames, height, width):
        """Packed latents (B, H/16, W/16, 64): the VAE's (H/8, W/8, 16)
        packed 2×2."""
        return (batch, height // 16, width // 16, 64)

    # T5 states and mask, and CLIP's state at each prompt's last valid token
    # as the pooled vector: the same as HunyuanVideo's (LLaMA there)
    encode_text = HunyuanVideoFlow.encode_text

    def denoise_apply(self, x: torch.Tensor, t: torch.Tensor,
                      cond: Cond) -> torch.Tensor:
        """Velocity at t = σ in [0, 1] (the DiT scales it by 1000), with the
        embedded guidance for dev and none for schnell."""
        guidance = (None if self.schnell else
                    torch.full((x.shape[0],), self.guidance_scale,
                               device=x.device))
        return self.denoiser(x, t, cond["y"], cond.get("pooled"), guidance)

    def training_loss(self, batch: Dict[str, Any],
                      generator: Optional[torch.Generator] = None, *,
                      sigma: Optional[torch.Tensor] = None,
                      noise: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Rectified-flow MSE of the velocity on packed latents: σ
        logit-normal, x_t = (1 − σ)·z + σ·ε, target ε − z, the per-sample
        mean with a NaN sample counted as 0, then the batch mean.
        ``batch``: "latents" (B, H', W', 64), "text_states", optionally
        "pooled_text".  ``sigma`` and ``noise`` replace the draws.  A batch
        without "latents" raises: the JAX package has no way to fill them
        either (queue 3), and the port invents none."""
        z = batch.get("latents")
        if z is None:
            raise ValueError(f"FluxFlow.training_loss needs batch['latents']: "
                             f"{FLUX_TRAIN_FAULT}")
        if sigma is None:
            sigma = sample_sigmas(generator, z.shape[0], "logit_normal",
                                  device=z.device)
        sigma = sigma.to(z)
        noise = (randn(z.shape, generator, z.device) if noise is None
                 else noise.to(z))
        x_t = flow_interpolate(z, noise, sigma)
        cond = {"y": batch["text_states"], "pooled": batch.get("pooled_text")}
        v = self.denoise_apply(x_t, sigma, cond)
        per = ((v - flow_target(z, noise)) ** 2).mean(
            dim=tuple(range(1, z.ndim)))
        loss = torch.where(torch.isnan(per), 0.0, per).mean()
        return loss, {"loss": loss}

    @torch.inference_mode()
    def sample(self, cond: Cond, uncond: Optional[Cond], shape,
               generator: Optional[torch.Generator], cfg_scale: float = 1.0,
               x_T: Optional[torch.Tensor] = None,
               noises: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Euler over ``num_inference_steps`` sigmas shifted by
        ``flux_shift_for_resolution`` of the packed token count; one model
        call a step (``uncond`` and ``cfg_scale`` are not used)."""
        shift = flux_shift_for_resolution(shape[1] * shape[2])
        sched = FlowMatchSchedule.create(self.num_inference_steps, shift,
                                         num_train_timesteps=1)
        return sched.to(self.device).sample(
            lambda x, t: self.denoise_apply(x, t, cond), shape, generator,
            x_T=x_T)

    @staticmethod
    def unpack_latents(z_packed: torch.Tensor) -> torch.Tensor:
        """(B, H', W', 64) → (B, 1, 2H', 2W', 16) for the 2D VAE decode."""
        b, hh, ww, _ = z_packed.shape
        z = z_packed.reshape(b, hh, ww, 2, 2, 16).permute(0, 1, 3, 2, 4, 5)
        return z.reshape(b, 1, 2 * hh, 2 * ww, 16)

    @staticmethod
    def pack_latents(z: torch.Tensor) -> torch.Tensor:
        """The inverse of ``unpack_latents``: (B, 1, H, W, 16) VAE latents
        → (B, H/2, W/2, 64), the layout the DiT and the loss take."""
        b, _, h, w, c = z.shape
        z = z.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
        return z.reshape(b, h // 2, w // 2, 4 * c)

    @torch.inference_mode()
    def decode_latents(self, z: torch.Tensor) -> torch.Tensor:
        if z.ndim == 4:
            z = self.unpack_latents(z)
        return super().decode_latents(z)
