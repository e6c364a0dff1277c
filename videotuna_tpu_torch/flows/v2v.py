"""V2VEnhanceFlow (torch): the dedicated video-to-video enhancement model,
the counterpart of ``videotuna_tpu/flows/v2v.py``: VideoCrafter's UNet3D
with doubled input channels for the concat conditioning.

- the source video is VAE-encoded frame-wise and, with ``upscale`` > 1,
  bilinearly upsampled in latent space;
- the conditioning latents are noise-augmented to a small timestep t_aug =
  max(⌊T · strength · ``t_aug_frac``⌋, 1);
- generation runs the full schedule from pure noise, every step seeing
  [x_t | z_cond] on the channel axis, the text through the UNet's
  cross-attention and CFG (the unconditional stream gets zero z_cond);
- training is self-supervised degradation: the clip downscaled 2× and back,
  re-encoded and augmented at strength 1 as the condition, the DDPM target
  of the full-resolution latents.

``_latent_bilinear`` resizes as ``jax.image.resize(..., "bilinear")`` does:
a triangle filter over half-pixel centres, widened by the scale when it
shrinks (antialiased) and renormalised at the borders, which is
``torch.nn.functional.interpolate``'s bilinear mode with ``antialias=True``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from videotuna_tpu_torch.core.registry import register
from videotuna_tpu_torch.flows.generation import Cond
from videotuna_tpu_torch.flows.videocrafter import VideocrafterFlow
from videotuna_tpu_torch.schedulers.common import randn


def _latent_bilinear(z: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """(B, T, h, w, C) → (B, T, H, W, C), bilinear over (h, w),
    antialiased when it shrinks."""
    b, t, h, w, c = z.shape
    x = z.reshape(b * t, h, w, c).permute(0, 3, 1, 2)
    x = F.interpolate(x.float(), size=tuple(hw), mode="bilinear",
                      align_corners=False, antialias=True).to(z.dtype)
    return x.permute(0, 2, 3, 1).reshape(b, t, hw[0], hw[1], c)


@register("videotuna_tpu_torch.flows.V2VEnhanceFlow",
          aliases=["videotuna.flow.v2v.V2VEnhanceFlow"])
class V2VEnhanceFlow(VideocrafterFlow):
    """Concat-conditioned enhancement flow (the UNet's in_channels are 2 ×
    latent_channels)."""

    def __init__(self, *args, t_aug_frac: float = 0.1, upscale: int = 1,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.t_aug_frac = t_aug_frac
        self.upscale = upscale

    def denoise_apply(self, x: torch.Tensor, t: torch.Tensor,
                      cond: Cond) -> torch.Tensor:
        """[x | z_cond] on the channels; zero z_cond where the cond has
        none (the unconditional stream of CFG)."""
        z_cond = cond.get("z_cond")
        if z_cond is None:
            z_cond = torch.zeros_like(x)
        rest = {k: v for k, v in cond.items() if k != "z_cond"}
        return super().denoise_apply(torch.cat([x, z_cond.to(x)], dim=-1), t,
                                     rest)

    @torch.no_grad()
    def _prepare_cond_latents(self, video: torch.Tensor,
                              generator: Optional[torch.Generator],
                              strength: float,
                              posterior_noise: Optional[torch.Tensor] = None,
                              noise: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
        """The conditioning latents: the video's encode (upsampled by
        ``upscale``), q_sampled to t_aug; ``posterior_noise`` and ``noise``
        replace the draws."""
        z = self.encode_video(video, generator, noise=posterior_noise)
        if self.upscale > 1:
            z = _latent_bilinear(z, (z.shape[2] * self.upscale,
                                     z.shape[3] * self.upscale))
        sched = self.base_schedule
        t_aug = max(int(sched.num_timesteps * strength * self.t_aug_frac), 1)
        noise = randn(z.shape, generator, z.device) if noise is None \
            else noise.to(z)
        return sched.q_sample(z, torch.full((z.shape[0],), t_aug,
                                            dtype=torch.int64,
                                            device=z.device), noise)

    @torch.inference_mode()
    def enhance(self, video: torch.Tensor, cond: Cond,
                generator: Optional[torch.Generator] = None,
                strength: float = 0.4, cfg_scale: float = 7.5,
                uncond: Optional[Cond] = None, *,
                posterior_noise: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None,
                x_T: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full Vid2Vid generation conditioned on ``video`` (B, T, H, W, 3):
        ``strength`` scales the conditioning's noise augmentation (it is
        not an SDEdit entry point: sampling runs the whole schedule).
        ``posterior_noise``, ``noise`` (the augmentation's) and ``x_T``
        replace the draws from ``generator``."""
        z_cond = self._prepare_cond_latents(video, generator, strength,
                                            posterior_noise, noise)
        cond = dict(cond, z_cond=z_cond)
        if uncond is not None:
            uncond = dict(uncond)
            uncond.setdefault("z_cond", torch.zeros_like(z_cond))
        x = self.sample(cond, uncond, tuple(z_cond.shape), generator,
                        cfg_scale, x_T=x_T)
        return self.decode_latents(x)

    def training_loss(self, batch: Dict[str, Any],
                      generator: Optional[torch.Generator] = None, *,
                      t: Optional[torch.Tensor] = None,
                      noise: Optional[torch.Tensor] = None,
                      posterior_noise: Optional[torch.Tensor] = None,
                      cond_posterior_noise: Optional[torch.Tensor] = None,
                      aug_noise: Optional[torch.Tensor] = None,
                      drop: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Self-supervised degradation: condition on the 2× downscaled and
        re-upscaled clip's encode, noise-augmented at strength 1, and
        regress the schedule's target of the full-resolution latents.
        ``batch``: "video", optionally "latents", "text_states", "fps".
        ``t``, ``noise``, ``posterior_noise`` (the clip's encode),
        ``cond_posterior_noise`` and ``aug_noise`` (the condition's encode
        and augmentation) and ``drop`` (B,) replace the draws."""
        video = batch["video"].to(self.device)
        z = batch.get("latents")
        if z is None:
            z = self.encode_video(video, generator, noise=posterior_noise)
        b, tt, hh, ww, _ = video.shape
        lr = _latent_bilinear(_latent_bilinear(video, (hh // 2, ww // 2)),
                              (hh, ww))
        z_cond = self._prepare_cond_latents(lr, generator, 1.0,
                                            cond_posterior_noise, aug_noise)
        sched = self.base_schedule
        t, noise = self._draw_t_noise(z, generator, t, noise)
        x_t = sched.q_sample(z, t, noise)
        y = batch["text_states"]
        if self.uncond_prob > 0:
            if drop is None:
                drop = torch.rand((b,), generator=generator,
                                  device=z.device) < self.uncond_prob
            y = torch.where(drop.to(y.device)[:, None, None],
                            torch.zeros_like(y), y)
        model_out = self.denoise_apply(
            x_t, t, {"y": y, "fps": batch.get("fps"), "z_cond": z_cond})
        target = sched.training_target(z, noise, t)
        per = ((model_out - target) ** 2).mean(dim=tuple(range(1, z.ndim)))
        loss = torch.where(torch.isnan(per), 0.0, per).mean()
        return loss, {"loss": loss}
