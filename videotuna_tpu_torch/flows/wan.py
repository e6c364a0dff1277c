"""WanVideoFlow (torch): Wan 2.1 text-to-video sampling (1.3B and 14B), the
counterpart of ``videotuna_tpu/flows/wan.py``: umT5 → ``WanModel`` with CFG
under the flow-matching UniPC (or DPM-Solver++) solver → the Wan VAE, whose
decode streams one latent frame at a time; training is the flow-matching
velocity MSE.

The DiT's attention runs under the fixed softmax max 0: its q and k are
RMSNormed at d = 128, so every scaled log2-score lies within
±√128·log2e ≈ 16.3, inside exp2's window (−126, 127).

Image-to-video (``i2v_mode``): ``cond_stage_2`` (the CLIP image embedder of
``models/lvdm/image_cond.py``) gives the image's patch tokens to the DiT's
image cross-attention, and a DiT with more input channels than the latents
takes [mask ; the image's latent zero-padded over latent time] on its
channels (in_dim 36 = 16 + 4 + 16); both are the same for the uncond half
of CFG.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from videotuna_tpu_torch.core.registry import register
from videotuna_tpu_torch.flows.generation import Cond, GenerationFlow
from videotuna_tpu_torch.models.wan.vae import wan_streaming_decode
from videotuna_tpu_torch.schedulers import (FlowDPMSolverSchedule,
                                            FlowMatchSchedule,
                                            FlowUniPCSchedule,
                                            flow_interpolate, flow_target,
                                            sample_sigmas)
from videotuna_tpu_torch.schedulers.common import randn

DEFAULT_NEGATIVE = ("low quality, blurry, distorted, text, watermark, "
                    "static, worst quality")
# latent frames a chunk of the streamed decode takes after frame 0: one, as
# the reference decodes (4 pixel frames a chunk); at 81×720×1280 a chunk of
# two does not fit in 80 GB beside the DiT's and T5's weights
DECODE_CHUNK = 1


@register("videotuna_tpu_torch.flows.WanVideoFlow",
          aliases=["videotuna.flow.wanvideo.WanVideoModelFlow"])
class WanVideoFlow(GenerationFlow):
    latent_channels = 16
    vae_spatial_ratio = 8
    vae_temporal_ratio = 4

    def __init__(self, *args, num_inference_steps: int = 50,
                 flow_shift: float = 5.0, sample_solver: str = "unipc",
                 negative_prompt: str = DEFAULT_NEGATIVE,
                 i2v_mode: bool = False, height: Optional[int] = None,
                 **kwargs):
        """``height`` is where the configs' ``inference.mapping`` puts the
        sampling height; the flow keeps it and samples at
        ``inference.height``, as before."""
        kwargs.setdefault("model_max_length", 512)
        kwargs.setdefault("attn_static_max", 0.0)
        super().__init__(*args, **kwargs)
        self.i2v_mode = i2v_mode
        self.negative_prompt = negative_prompt
        self.height = height
        if not isinstance(self.scheduler, (FlowUniPCSchedule,
                                           FlowDPMSolverSchedule,
                                           FlowMatchSchedule)):
            build = (FlowDPMSolverSchedule if sample_solver == "dpm++"
                     else FlowUniPCSchedule)
            self.scheduler = build.create(num_inference_steps,
                                          flow_shift).to(self.device)

    def denoise_apply(self, x: torch.Tensor, t: torch.Tensor,
                      cond: Cond) -> torch.Tensor:
        if cond.get("first_frame_latents") is not None:
            x = torch.cat([x, cond["first_frame_latents"].to(x)], dim=-1)
        return self.denoiser(x, t, cond["y"], cond.get("image_features"))

    @torch.no_grad()
    def prepare_image_cond(self, cond, uncond, images, frames, height, width,
                           generator=None, posterior_noise=None):
        """The image's CLIP tokens (with ``cond_stage_2``) and, for a DiT
        with more input channels than the latents, the first-frame latents
        behind a mask channel block that marks latent frame 0 as known;
        the uncond half gets both.  The Wan VAE encodes to its mean, so
        ``generator`` and ``posterior_noise`` are not used."""
        cond = dict(cond)
        images = images.to(self.device)
        if self.cond_stage_2 is not None:
            cond["image_features"] = self.prepare_image_features(images)
        extra = self.denoiser.in_channels - self.latent_channels
        if extra > 0:
            n = self.latent_shape(images.shape[0], frames, height, width)[1]
            ffl = self.prepare_first_frame_latents(images, n)
            n_mask = extra - ffl.shape[-1]
            if n_mask > 0:
                mask = ffl.new_zeros((*ffl.shape[:-1], n_mask))
                mask[:, 0] = 1.0
                ffl = torch.cat([mask, ffl], dim=-1)
            cond["first_frame_latents"] = ffl
        if uncond is not None:
            uncond = dict(uncond, **{k: cond[k] for k in (
                "image_features", "first_frame_latents") if k in cond})
        return cond, uncond

    @torch.no_grad()
    def prepare_image_features(self, image: torch.Tensor) -> torch.Tensor:
        """The CLIP patch tokens of the image (B, H, W, 3) for the blocks'
        image cross-attention; needs ``cond_stage_2``."""
        if self.cond_stage_2 is None:
            raise ValueError("i2v needs cond_stage_2 (CLIP image encoder)")
        return self.cond_stage_2(image.to(self.device))

    def prepare_first_frame_latents(self, image: torch.Tensor,
                                    num_latent_frames: int) -> torch.Tensor:
        """The image (B, H, W, 3) or its one-frame video encoded, then
        zero-padded to ``num_latent_frames``."""
        z0 = self.encode_video(image[:, None] if image.ndim == 4 else image)
        pad = z0.new_zeros((z0.shape[0], num_latent_frames - z0.shape[1],
                            *z0.shape[2:]))
        return torch.cat([z0, pad], dim=1)

    # ------------------------------------------------------------------ vae
    @torch.no_grad()
    def encode_video(self, video: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The Wan VAE's standardised posterior mean: no sample, no scale
        factor (``generator`` and ``noise`` are not used)."""
        return self.first_stage.encode(video.to(self.device))

    @torch.inference_mode()
    def decode_latents(self, z: torch.Tensor) -> torch.Tensor:
        """The Wan VAE's decode, streamed ``DECODE_CHUNK`` latent frames at
        a time (the same function as the whole-sequence decode), clipped to
        [−1, 1]."""
        return wan_streaming_decode(self.first_stage, z,
                                    DECODE_CHUNK).clamp_(-1.0, 1.0)

    # --------------------------------------------------------------- training
    def training_loss(self, batch: Dict[str, Any],
                      generator: Optional[torch.Generator] = None, *,
                      sigma: Optional[torch.Tensor] = None,
                      noise: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Flow-matching MSE of the velocity: logit-normal σ, x_t = (1 − σ)
        ·x0 + σ·ε at t = 1000·σ, the per-sample mean with a NaN sample
        counted as 0, then the batch mean.  ``batch``: "video" (B, T, H, W,
        3) in [−1, 1] or "latents", and "text_states".  Given ``sigma`` or
        ``noise`` replace the draws (the Wan VAE encodes to its mean, so
        there is no posterior noise)."""
        z = batch.get("latents")
        if z is None:
            z = self.encode_video(batch["video"])
        if sigma is None:
            sigma = sample_sigmas(generator, z.shape[0], "logit_normal",
                                  device=z.device)
        sigma = sigma.to(z)
        noise = (randn(z.shape, generator, z.device) if noise is None
                 else noise.to(z))
        x_t = flow_interpolate(z, noise, sigma)
        v_pred = self.denoise_apply(x_t, sigma * 1000.0,
                                    {"y": batch["text_states"]})
        per = ((v_pred - flow_target(z, noise)) ** 2).mean(
            dim=tuple(range(1, z.ndim)))
        per = torch.where(torch.isnan(per), 0.0, per)
        loss = per.mean()
        return loss, {"loss": loss}

    # -------------------------------------------------------------- sampling
    def inference(self, config: Dict[str, Any]) -> Dict[str, Any]:
        """Wan's default negative prompt takes the place of an empty
        unconditional prompt."""
        inf = config.get("inference", config)
        inf.setdefault("negative_prompt", self.negative_prompt)
        return super().inference(config)
