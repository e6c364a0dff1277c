"""VideocrafterFlow (torch): VideoCrafter 1/2 text-to-video and
DynamiCrafter image-to-video, the counterpart of
``videotuna_tpu/flows/videocrafter.py``: OpenCLIP-H text over 77 tokens →
UNet3D with CFG under DDIM over the DDPM chain (ε or v, optionally zero
terminal SNR) → the frame-wise 2D KL VAE.  Training is the DDPM MSE against
the schedule's target, with the text dropped at ``uncond_prob``.

Image-to-video: ``cond_stage_2`` (DynamiCrafter's ``ImageConditioner``, or
VideoCrafter1's ``CLIPImageEmbedder``) turns the image into the UNet's image
tokens, and a UNet with more input channels than the latents takes the
image's latent repeated over the frames on its channels; both are the same
for the text-uncond half of CFG.  ``sample`` with ``image_cfg_scale`` guides
image and text apart (three model calls a step); inference, as in the JAX
package, never passes it (ROADMAP.md queue 3).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from videotuna_tpu_torch.core.registry import register
from videotuna_tpu_torch.flows.generation import Cond, GenerationFlow
from videotuna_tpu_torch.models.text_encoders import tokenize
from videotuna_tpu_torch.schedulers import (DDIMSchedule, DDPMSchedule,
                                            multicond_cfg_denoise)


@register("videotuna_tpu_torch.flows.VideocrafterFlow",
          aliases=["videotuna.flow.videocrafter.VideocrafterFlow"])
class VideocrafterFlow(GenerationFlow):
    latent_channels = 4
    vae_spatial_ratio = 8
    vae_temporal_ratio = 1

    def __init__(self, *args, ddim_steps: int = 50, ddim_eta: float = 0.0,
                 uncond_prob: float = 0.1, fps_cond: bool = True,
                 i2v_mode: bool = False, **kwargs):
        kwargs.setdefault("model_max_length", 77)
        super().__init__(*args, **kwargs)
        self.uncond_prob = uncond_prob
        self.fps_cond = fps_cond
        self.i2v_mode = i2v_mode
        if isinstance(self.scheduler, DDPMSchedule):
            self.base_schedule = self.scheduler
            self.scheduler = DDIMSchedule.create(self.base_schedule,
                                                 ddim_steps, ddim_eta)
        else:
            self.base_schedule = self.scheduler.base

    @torch.no_grad()
    def encode_text(self, texts) -> Cond:
        """CLIP text states over min(``model_max_length``, the encoder's
        ``max_len``) tokens; the encoder takes no mask."""
        max_len = min(self.model_max_length,
                      getattr(self.cond_stage, "max_len",
                              self.model_max_length))
        ids, mask = tokenize(texts, pretrained=self.tokenizer,
                             max_length=max_len)
        ids = torch.as_tensor(ids, device=self.device)
        return {"y": self.cond_stage(ids),
                "mask": torch.as_tensor(mask, device=self.device)}

    def denoise_apply(self, x: torch.Tensor, t: torch.Tensor,
                      cond: Cond) -> torch.Tensor:
        kwargs = {}
        if cond.get("fps") is not None and self.fps_cond:
            kwargs["fps"] = cond["fps"]
        if cond.get("context_img") is not None:
            kwargs["context_img"] = cond["context_img"]
        if cond.get("img_latents") is not None:
            # the image's latent on the channels (in_channels 8 = 4 + 4)
            x = torch.cat([x, cond["img_latents"].to(x)], dim=-1)
        return self.denoiser(x, t, cond["y"], **kwargs)

    @torch.no_grad()
    def prepare_image_cond(self, cond, uncond, images, frames, height, width,
                           generator=None, posterior_noise=None):
        """The image tokens of ``cond_stage_2`` and, for a UNet with more
        input channels than the latents, the image's latent (a posterior
        sample; ``posterior_noise`` replaces the draw from ``generator``)
        repeated over the latent frames; the text-uncond half gets both."""
        cond = dict(cond)
        images = images.to(self.device)
        if self.cond_stage_2 is not None:
            cond["context_img"] = self.cond_stage_2(images)
        if self.denoiser.in_channels > self.latent_channels:
            z0 = self.encode_video(images[:, None], generator,
                                   noise=posterior_noise)
            n = self.latent_shape(images.shape[0], frames, height, width)[1]
            cond["img_latents"] = z0.repeat_interleave(n, dim=1)
        if uncond is not None:
            uncond = dict(uncond, **{k: cond[k] for k in (
                "context_img", "img_latents") if k in cond})
        return cond, uncond

    # --------------------------------------------------------------- training
    def training_loss(self, batch: Dict[str, Any],
                      generator: Optional[torch.Generator] = None, *,
                      t: Optional[torch.Tensor] = None,
                      noise: Optional[torch.Tensor] = None,
                      posterior_noise: Optional[torch.Tensor] = None,
                      drop: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """q_sample → UNet → MSE against the schedule's target (ε, x0 or
        v), the text states zeroed for the samples ``drop`` (B,) bool marks
        (drawn at ``uncond_prob``), a NaN sample counted as 0.  ``batch``:
        "video" or "latents", "text_states", optionally "fps"; ``t``,
        ``noise``, ``posterior_noise`` and ``drop`` replace the draws."""
        z = batch.get("latents")
        if z is None:
            z = self.encode_video(batch["video"], generator,
                                  noise=posterior_noise)
        sched = self.base_schedule
        t, noise = self._draw_t_noise(z, generator, t, noise)
        x_t = sched.q_sample(z, t, noise)
        y = batch["text_states"]
        if self.uncond_prob > 0:
            if drop is None:
                drop = torch.rand((z.shape[0],), generator=generator,
                                  device=z.device) < self.uncond_prob
            y = torch.where(drop.to(y.device)[:, None, None],
                            torch.zeros_like(y), y)
        model_out = self.denoise_apply(x_t, t, {"y": y,
                                                "fps": batch.get("fps")})
        target = sched.training_target(z, noise, t)
        per = ((model_out - target) ** 2).mean(dim=tuple(range(1, z.ndim)))
        per = torch.where(torch.isnan(per), 0.0, per)
        loss = per.mean()
        return loss, {"loss": loss}

    # -------------------------------------------------------------- sampling
    @torch.inference_mode()
    def sample(self, cond: Cond, uncond: Optional[Cond], shape,
               generator: torch.Generator, cfg_scale: float = 12.0,
               x_T: Optional[torch.Tensor] = None,
               noises: Optional[torch.Tensor] = None,
               image_cfg_scale: Optional[float] = None) -> torch.Tensor:
        """DDIM with CFG; in ``i2v_mode`` with ``image_cfg_scale``, image
        and text guidance apart, the image-uncond call with zero image
        tokens."""
        if not (self.i2v_mode and image_cfg_scale is not None):
            return super().sample(cond, uncond, shape, generator, cfg_scale,
                                  x_T=x_T, noises=noises)
        img_uncond = dict(cond, context_img=(
            torch.zeros_like(cond["context_img"])
            if cond.get("context_img") is not None else None))
        denoise = multicond_cfg_denoise(self.denoise_apply, cond, uncond,
                                        img_uncond, cfg_scale,
                                        image_cfg_scale)
        return self._run_sampler(denoise, shape, generator, x_T, noises)
