"""OpenSoraFlow (torch): Open-Sora text-to-video sampling and training, the
counterpart of ``videotuna_tpu/flows/opensora.py``: T5 → STDiT with CFG
under DDIM over the DDPM chain (v1.0), IDDPM spaced sampling with learned
variance (v1.1) or the rectified flow's Euler steps (v1.2, a
``FlowMatchSchedule``) → the frame-wise 2D KL VAE.  Training is the
eps-MSE, plus IDDPM's vb term when the model's output keeps both halves;
under the rectified flow, the velocity MSE at uniform sigmas.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from videotuna_tpu_torch.core.registry import register
from videotuna_tpu_torch.flows.generation import Cond, GenerationFlow
from videotuna_tpu_torch.schedulers import (DDIMSchedule, DDPMSchedule,
                                            FlowMatchSchedule,
                                            flow_interpolate, flow_target,
                                            sample_sigmas)
from videotuna_tpu_torch.schedulers.common import randn
from videotuna_tpu_torch.schedulers.iddpm import SpacedSchedule, vb_loss_term


@register("videotuna_tpu_torch.flows.OpenSoraFlow",
          aliases=["videotuna.models.opensora.models.iddpm3d.IDDPM"])
class OpenSoraFlow(GenerationFlow):
    latent_channels = 4
    vae_spatial_ratio = 8
    vae_temporal_ratio = 1

    def __init__(self, *args, num_frames: int = 16, height: int = 256,
                 width: int = 256, ddim_steps: int = 50,
                 ddim_eta: float = 0.0, **kwargs):
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
        elif isinstance(self.scheduler, FlowMatchSchedule):
            # Open-Sora 1.2: the rectified flow, no diffusion chain
            self.base_schedule = None
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

    def training_loss(self, batch: Dict[str, Any],
                      generator: Optional[torch.Generator] = None, *,
                      t: Optional[torch.Tensor] = None,
                      noise: Optional[torch.Tensor] = None,
                      posterior_noise: Optional[torch.Tensor] = None,
                      sigma: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """eps-MSE over q_sample'd VAE latents; when ``denoise_apply`` keeps
        2·C channels (a ``pred_sigma`` model under IDDPM's
        ``SpacedSchedule``) IDDPM's hybrid loss adds the vb term × T/1000.
        A ``pred_sigma`` model under DDIM is handed the eps half only, as
        in the JAX package, so its loss is the eps-MSE.  NaN samples count
        as 0.  ``batch``: "video" or "latents", "text_states" and
        optionally "text_mask".  Under the rectified flow (Open-Sora 1.2)
        the loss is the velocity MSE at x_t = (1 − σ)·x0 + σ·ε, σ uniform in
        (0, 1) (``sigma`` replaces the draw), t = 1000·σ."""
        z = batch.get("latents")
        if z is None:
            z = self.encode_video(batch["video"], generator,
                                  noise=posterior_noise)
        sched = self.base_schedule
        if sched is None:
            return self._rectified_flow_loss(z, batch, generator, sigma,
                                             noise)
        t, noise = self._draw_t_noise(z, generator, t, noise)
        x_t = sched.q_sample(z, t, noise)
        model_out = self.denoise_apply(
            x_t, t, {"y": batch["text_states"],
                     "mask": batch.get("text_mask")})
        target = sched.training_target(z, noise, t)
        c = z.shape[-1]
        axes = tuple(range(1, z.ndim))
        aux: Dict[str, torch.Tensor] = {}
        if model_out.shape[-1] == 2 * c:
            vb = vb_loss_term(sched, model_out, z, x_t, t) \
                * (sched.num_timesteps / 1000.0)
            per = ((model_out[..., :c] - target) ** 2).mean(dim=axes)
            aux["loss_vb"] = vb.mean()
            per = per + vb
        else:
            per = ((model_out - target) ** 2).mean(dim=axes)
        per = torch.where(torch.isnan(per), 0.0, per)
        loss = per.mean()
        aux.update({"loss": loss, "t_mean": t.float().mean()})
        return loss, aux

    def _rectified_flow_loss(self, z, batch, generator, sigma, noise):
        if sigma is None:
            sigma = sample_sigmas(generator, z.shape[0], "uniform",
                                  device=z.device)
        sigma = sigma.to(z)
        noise = (randn(z.shape, generator, z.device) if noise is None
                 else noise.to(z))
        v_pred = self.denoise_apply(
            flow_interpolate(z, noise, sigma), sigma * 1000.0,
            {"y": batch["text_states"], "mask": batch.get("text_mask")})
        per = ((v_pred - flow_target(z, noise)) ** 2).mean(
            dim=tuple(range(1, z.ndim)))
        per = torch.where(torch.isnan(per), 0.0, per)
        loss = per.mean()
        return loss, {"loss": loss, "t_mean": sigma.mean() * 1000.0}
