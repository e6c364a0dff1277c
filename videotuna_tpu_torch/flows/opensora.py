"""OpenSoraFlow (torch): Open-Sora v1.0 STDiT text-to-video sampling and
training, the counterpart of ``videotuna_tpu/flows/opensora.py``: T5 →
STDiT with CFG under DDIM over the DDPM chain (or IDDPM spaced sampling with
learned variance) → the frame-wise 2D KL VAE.  Training is the eps-MSE, plus
IDDPM's vb term when the model's output keeps both halves.

The Open-Sora 1.2 rectified-flow sampler and loss wait for a later slice.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from videotuna_tpu_torch.core.registry import register
from videotuna_tpu_torch.flows.generation import Cond, GenerationFlow
from videotuna_tpu_torch.schedulers import DDIMSchedule, DDPMSchedule
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
        sched_cfg = kwargs.get("scheduler_config") or (args[1] if len(args) > 1
                                                       else {})
        if str(sched_cfg.get("target", "")).endswith("FlowMatchSchedule"):
            raise NotImplementedError(
                "Open-Sora 1.2 rectified-flow sampling and training (the "
                "flow-match branch and STDiT's fps conditioning) are not "
                "ported yet (ROADMAP.md queue 1, item 5)")
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

    def training_loss(self, batch: Dict[str, Any],
                      generator: Optional[torch.Generator] = None, *,
                      t: Optional[torch.Tensor] = None,
                      noise: Optional[torch.Tensor] = None,
                      posterior_noise: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """eps-MSE over q_sample'd VAE latents; when ``denoise_apply`` keeps
        2·C channels (a ``pred_sigma`` model under IDDPM's
        ``SpacedSchedule``) IDDPM's hybrid loss adds the vb term × T/1000.
        A ``pred_sigma`` model under DDIM is handed the eps half only, as
        in the JAX package, so its loss is the eps-MSE.  NaN samples count
        as 0.  ``batch``: "video" or "latents", "text_states" and
        optionally "text_mask"."""
        z = batch.get("latents")
        if z is None:
            z = self.encode_video(batch["video"], generator,
                                  noise=posterior_noise)
        sched = self.base_schedule
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
