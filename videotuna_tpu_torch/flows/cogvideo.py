"""CogVideoXFlow (torch): CogVideoX text-to-video sampling and training, the
counterpart of ``videotuna_tpu/flows/cogvideo.py``: T5 → CogVideoX MMDiT
with CFG on the SNR-shifted zero-terminal-SNR v-prediction schedule
(SDE-DPM++(2M) or trailing DDIM, optional cosine dynamic guidance) → 3D
causal VAE; training is v-prediction with the 1/(1 − ᾱ_t) weight.

Image-to-video (``i2v_mode``): the first frame's latent, zero-padded over
latent time, is concatenated to the latents on channels, the same for the
cond and the uncond half of CFG.

CogVideoX 1.5's temporal patch (``patch_size[0] = p_t > 1``): where the
latent frame count T is not a multiple of p_t, the flow samples
``a = p_t − T mod p_t`` extra latent frames in front and drops them before
the decode (the diffusers CogVideoX 1.5 pipelines' ``additional_frames``);
in i2v the image latents' ``a`` front frames repeat the image frame.  The
JAX flow samples the odd T, which its MMDiT's patch conv cannot return
(ROADMAP.md queue 3).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from videotuna_tpu_torch.core.registry import register
from videotuna_tpu_torch.flows.generation import Cond, GenerationFlow
from videotuna_tpu_torch.schedulers import (DDPMSchedule, build_cogvideox_ddim,
                                            dynamic_cfg_denoise, extract_into)


@register("videotuna_tpu_torch.flows.CogVideoXFlow",
          aliases=["videotuna.models.cogvideo_hf.cogvideo_pl."
                   "CogVideoXWorkFlow"])
class CogVideoXFlow(GenerationFlow):
    latent_channels = 16
    vae_spatial_ratio = 8
    vae_temporal_ratio = 4

    def __init__(self, *args, ddim_steps: int = 50, i2v_mode: bool = False,
                 use_dynamic_cfg: bool = False, **kwargs):
        kwargs.setdefault("model_max_length", 226)
        kwargs.setdefault("scale_factor", 1.15258426)  # CogVideoX latent scale
        # q and k are LayerNormed per head (d=64): |log2 scores| ≤ √d·log2e
        # ≈ 11.5, well inside exp2's M=0 window (−126, 127)
        kwargs.setdefault("attn_static_max", 0.0)
        super().__init__(*args, **kwargs)
        self.i2v_mode = i2v_mode
        self.use_dynamic_cfg = use_dynamic_cfg
        if isinstance(self.scheduler, DDPMSchedule):
            # the CogVideoXDDIMScheduler recipe: trailing spacing +
            # set_alpha_to_one, η=0
            self.base_schedule = self.scheduler
            self.scheduler = build_cogvideox_ddim(self.base_schedule,
                                                  ddim_steps)
        else:
            self.base_schedule = self.scheduler.base

    def latent_frames(self, num_frames: int) -> int:
        """Latent frames of a ``num_frames`` video: the ones decoded."""
        return (num_frames - 1) // self.vae_temporal_ratio + 1

    def front_pad(self, latent_frames: int) -> int:
        """Latent frames sampled in front of ``latent_frames`` so that the
        count is a multiple of the MMDiT's temporal patch."""
        return -latent_frames % self.denoiser.patch_size[0]

    def latent_shape(self, batch, num_frames, height, width):
        n = self.latent_frames(num_frames)
        return (batch, n + self.front_pad(n),
                height // self.vae_spatial_ratio,
                width // self.vae_spatial_ratio,
                self.latent_channels)

    def kept_latents(self, z: torch.Tensor, num_frames: int) -> torch.Tensor:
        return z[:, z.shape[1] - self.latent_frames(num_frames):]

    def denoise_apply(self, x: torch.Tensor, t: torch.Tensor,
                      cond: Cond) -> torch.Tensor:
        if self.i2v_mode and cond.get("image_latents") is not None:
            x = torch.cat([x, cond["image_latents"].to(x)], dim=-1)
        return self.denoiser(x, t, cond["y"])

    # ------------------------------------------------------------ image cond
    def prepare_image_latents(self, image: torch.Tensor,
                              num_latent_frames: int,
                              generator: Optional[torch.Generator] = None,
                              posterior_noise: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
        """First-frame conditioning: the image (B, H, W, 3) or its one-frame
        video encoded, then zero-padded to ``num_latent_frames``.
        ``posterior_noise`` replaces the encode's draw from
        ``generator``."""
        video = image[:, None] if image.ndim == 4 else image
        z0 = self.encode_video(video, generator, noise=posterior_noise)
        pad = z0.new_zeros((z0.shape[0], num_latent_frames - z0.shape[1],
                            *z0.shape[2:]))
        return torch.cat([z0, pad], dim=1)

    def prepare_image_cond(self, cond, uncond, images, frames, height, width,
                           generator=None, posterior_noise=None):
        """i2v: the image latents at the sampled length, the same for the
        cond and the uncond half of CFG (text guidance only); the temporal
        patch's front frames repeat the image frame."""
        n = self.latent_frames(frames)
        il = self.prepare_image_latents(images, n, generator,
                                        posterior_noise)
        a = self.front_pad(n)
        il = torch.cat([il[:, :1].expand(-1, a, -1, -1, -1), il], dim=1)
        cond = dict(cond, image_latents=il)
        if uncond is not None:
            uncond = dict(uncond, image_latents=il)
        return cond, uncond

    def training_loss(self, batch: Dict[str, Any],
                      generator: Optional[torch.Generator] = None, *,
                      t: Optional[torch.Tensor] = None,
                      noise: Optional[torch.Tensor] = None,
                      posterior_noise: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """v-prediction MSE weighted per sample by 1/(1 − ᾱ_t), with a
        sample whose loss is NaN counted as 0.  ``batch``: "video"
        (B, T, H, W, 3) in [−1, 1] or "latents", and "text_states"; in
        ``i2v_mode`` also "image_latents" (B, T, h, w, C), which no
        dataset of the JAX package fills."""
        cond = {"y": batch["text_states"]}
        if self.i2v_mode:
            if batch.get("image_latents") is None:
                raise ValueError(
                    "CogVideoX i2v training needs batch['image_latents'], "
                    "which no dataset or trainer fills (ROADMAP.md queue "
                    "3)")
            cond["image_latents"] = batch["image_latents"]
        z = batch.get("latents")
        if z is None:
            z = self.encode_video(batch["video"], generator,
                                  noise=posterior_noise)
        sched = self.base_schedule
        t, noise = self._draw_t_noise(z, generator, t, noise)
        x_t = sched.q_sample(z, t, noise)
        model_out = self.denoise_apply(x_t, t, cond)
        target = sched.get_v(z, noise, t)
        w = 1.0 / (1.0 - extract_into(sched.alphas_cumprod, t, z.ndim))
        per = (w * (model_out - target) ** 2).mean(
            dim=tuple(range(1, z.ndim)))
        per = torch.where(torch.isnan(per), 0.0, per)
        loss = per.mean()
        return loss, {"loss": loss}

    @torch.inference_mode()
    def sample(self, cond: Cond, uncond: Optional[Cond], shape,
               generator: torch.Generator, cfg_scale: float = 6.0,
               x_T: Optional[torch.Tensor] = None,
               noises: Optional[torch.Tensor] = None) -> torch.Tensor:
        """CogVideoX sampling with optional cosine dynamic guidance.  The
        fixed-max attention scope applies in both cases (the JAX flow leaves
        it off on the dynamic path, where its kernel then runs the online
        softmax; the two are the same function)."""
        if not self.use_dynamic_cfg:
            return super().sample(cond, uncond, shape, generator, cfg_scale,
                                  x_T=x_T, noises=noises)
        denoise = dynamic_cfg_denoise(self.denoise_apply, cond, uncond,
                                      cfg_scale, self.scheduler.num_steps,
                                      timesteps=self.scheduler.timesteps)
        return self._run_sampler(denoise, shape, generator, x_T, noises)
