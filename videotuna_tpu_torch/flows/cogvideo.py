"""CogVideoXFlow (torch): CogVideoX text-to-video sampling, the counterpart
of ``videotuna_tpu/flows/cogvideo.py``: T5 → CogVideoX MMDiT with CFG on the
SNR-shifted zero-terminal-SNR v-prediction schedule (SDE-DPM++(2M) or
trailing DDIM, optional cosine dynamic guidance) → 3D causal VAE.

The image-to-video path and the training loss wait for later slices.
"""

from __future__ import annotations

from typing import Optional

import torch

from videotuna_tpu_torch.core.registry import register
from videotuna_tpu_torch.flows.generation import Cond, GenerationFlow
from videotuna_tpu_torch.schedulers import (DDPMSchedule, build_cogvideox_ddim,
                                            dynamic_cfg_denoise)


@register("videotuna_tpu_torch.flows.CogVideoXFlow",
          aliases=["videotuna.models.cogvideo_hf.cogvideo_pl."
                   "CogVideoXWorkFlow"])
class CogVideoXFlow(GenerationFlow):
    latent_channels = 16
    vae_spatial_ratio = 8
    vae_temporal_ratio = 4

    def __init__(self, *args, ddim_steps: int = 50, i2v_mode: bool = False,
                 use_dynamic_cfg: bool = False, **kwargs):
        if i2v_mode:
            raise NotImplementedError(
                "CogVideoX image-to-video is not ported yet")
        kwargs.setdefault("model_max_length", 226)
        kwargs.setdefault("scale_factor", 1.15258426)  # CogVideoX latent scale
        # q and k are LayerNormed per head (d=64): |log2 scores| ≤ √d·log2e
        # ≈ 11.5, well inside exp2's M=0 window (−126, 127)
        kwargs.setdefault("attn_static_max", 0.0)
        super().__init__(*args, **kwargs)
        self.use_dynamic_cfg = use_dynamic_cfg
        if isinstance(self.scheduler, DDPMSchedule):
            # the CogVideoXDDIMScheduler recipe: trailing spacing +
            # set_alpha_to_one, η=0
            self.base_schedule = self.scheduler
            self.scheduler = build_cogvideox_ddim(self.base_schedule,
                                                  ddim_steps)
        else:
            self.base_schedule = self.scheduler.base

    def latent_shape(self, batch, num_frames, height, width):
        return (batch,
                (num_frames - 1) // self.vae_temporal_ratio + 1,
                height // self.vae_spatial_ratio,
                width // self.vae_spatial_ratio,
                self.latent_channels)

    def denoise_apply(self, x: torch.Tensor, t: torch.Tensor,
                      cond: Cond) -> torch.Tensor:
        return self.denoiser(x, t, cond["y"])

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
