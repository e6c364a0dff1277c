"""HunyuanVideoFlow (torch): HunyuanVideo text- and image-to-video sampling
and training, the counterpart of ``videotuna_tpu/flows/hunyuan.py``: LLaMA
states and the CLIP state at the last valid token → ``HYVideoDiT`` with
embedded guidance on the shifted flow-matching Euler schedule → the causal
VAE; training draws logit-normal sigmas, x_t = (1 − σ)·x0 + σ·ε, and
regresses the velocity ε − x0.

Image-to-video (``i2v_mode``): the first frame's latents, zero-padded over
latent time, are concatenated to the latents on channels, so the DiT's
``img_in`` takes twice the latent channels (the JAX package's convolution
infers that width from the concat, whatever the config's ``in_channels``
says: ``hunyuanvideo_i2v.yaml`` says 33, ROADMAP.md queue 3).
``encode_text_i2v`` is the LLaVA prompt encode, with the projected CLIP
patch states of the image.

The DiT's joint attention runs under the fixed softmax max 0 (its q and k are
RMSNormed at d=128, so every scaled log2-score lies within ±√128·log2e ≈ 16.3,
inside exp2's window (−126, 127)).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from videotuna_tpu_torch.core.registry import register
from videotuna_tpu_torch.flows.generation import Cond, GenerationFlow
from videotuna_tpu_torch.models.text_encoders import (encode_hunyuan_i2v,
                                                      tokenize)
from videotuna_tpu_torch.schedulers import (FlowMatchSchedule, cfg_denoise,
                                            flow_interpolate, flow_target,
                                            sample_sigmas)
from videotuna_tpu_torch.schedulers.common import randn


def riflex_temporal_scale(dim_t: int, num_latent_frames: int, k: int = 4,
                          L_test: Optional[int] = None, theta: float = 256.0,
                          device: Optional[torch.device] = None
                          ) -> Optional[torch.Tensor]:
    """RIFLEx: per-frequency multipliers (dim_t/2,) of the temporal RoPE
    axis that cap the k-th frequency so that one period covers ``L_test``
    latent frames, or None up to 48 latent frames (192 pixel frames, the
    training horizon)."""
    if L_test is None or L_test <= 48:
        return None
    inv = 1.0 / (theta ** (torch.arange(0, dim_t, 2, dtype=torch.float32,
                                        device=device) / dim_t))
    scale = torch.ones_like(inv)
    scale[k - 1] = torch.clamp((2.0 * math.pi / L_test) / inv[k - 1],
                               max=1.0)
    return scale


def _with_pooled(flow: GenerationFlow, cond: Cond,
                 texts: Sequence[str]) -> Cond:
    """``cond`` with "pooled", the CLIP stage's state at each prompt's last
    valid token, where ``flow`` has that stage (FluxFlow shares
    ``encode_text``)."""
    if flow.cond_stage_2 is not None:
        ids2, mask2 = tokenize(texts, pretrained=flow.tokenizer,
                               max_length=flow.cond_stage_2.max_len)
        seq2 = flow.cond_stage_2(torch.as_tensor(ids2, device=flow.device))
        last = torch.as_tensor(mask2.sum(axis=1) - 1, device=flow.device)
        cond["pooled"] = seq2[torch.arange(seq2.shape[0],
                                           device=flow.device), last]
    return cond


@register("videotuna_tpu_torch.flows.HunyuanVideoFlow",
          aliases=["videotuna.flow.hunyuanvideo.HunyuanVideoFlow",
                   "videotuna.models.hunyuan.hyvideo_t2v.hunyuanvideo."
                   "HunyuanVideoWorkFlow"])
class HunyuanVideoFlow(GenerationFlow):
    latent_channels = 16
    vae_spatial_ratio = 8
    vae_temporal_ratio = 4

    def __init__(self, *args, num_inference_steps: int = 50,
                 flow_shift: float = 7.0,
                 embedded_cfg_scale: Optional[float] = 6.0,
                 i2v_mode: bool = False, riflex_k: int = 4, **kwargs):
        kwargs.setdefault("model_max_length", 256)
        kwargs.setdefault("attn_static_max", 0.0)
        kwargs.setdefault("scale_factor", 0.476986)
        if i2v_mode:   # img_in takes the concat's width
            args = list(args)
            den = args[0] if args else kwargs["denoiser_config"]
            den = dict(den, params=dict(den.get("params") or {},
                                        in_channels=2 * self.latent_channels))
            if args:
                args[0] = den
            else:
                kwargs["denoiser_config"] = den
        super().__init__(*args, **kwargs)
        self.i2v_mode = i2v_mode
        self.embedded_cfg_scale = embedded_cfg_scale
        self.riflex_k = riflex_k
        if not isinstance(self.scheduler, FlowMatchSchedule):
            self.scheduler = FlowMatchSchedule.create(
                num_inference_steps, flow_shift).to(self.device)

    # --------------------------------------------------------------- encoders
    @torch.no_grad()
    def encode_text(self, texts: Sequence[str]) -> Cond:
        """{"y": LLaMA states, "mask"} and, with the CLIP stage, "pooled":
        CLIP's state at each prompt's last valid token."""
        ids, mask = tokenize(texts, pretrained=self.tokenizer,
                             max_length=self.model_max_length)
        mask = torch.as_tensor(mask, device=self.device)
        cond = {"y": self.cond_stage(torch.as_tensor(ids, device=self.device),
                                     mask),
                "mask": mask}
        return _with_pooled(self, cond, texts)

    @torch.no_grad()
    def encode_text_i2v(self, texts: Sequence[str],
                        image_states: torch.Tensor,
                        i2v_condition_type: str = "token_replace") -> Cond:
        """The LLaVA prompt encode (``encode_hunyuan_i2v``): {"y": the
        subsampled image states before the text states, "mask"} and
        "pooled" as ``encode_text`` gives it.  ``image_states``: (B, 576,
        D_lm), ``tools.captioner.LlavaCaptioner.image_tokens`` of each
        image."""
        y, mask = encode_hunyuan_i2v(
            self.cond_stage, texts, image_states.to(self.device),
            tokenizer=self.tokenizer, text_len=self.model_max_length,
            i2v_condition_type=i2v_condition_type)
        return _with_pooled(self, {"y": y, "mask": mask}, texts)

    def prepare_image_cond(self, cond: Cond, uncond: Optional[Cond],
                           images: torch.Tensor, frames: int, height: int,
                           width: int,
                           generator: Optional[torch.Generator] = None,
                           posterior_noise: Optional[torch.Tensor] = None
                           ) -> Tuple[Cond, Optional[Cond]]:
        """Latent concat: the first frame's latents (``images`` (B, H, W,
        3) in [−1, 1]), zero-padded over the latent frames, as
        "image_latents" of ``cond`` and ``uncond``."""
        if not self.i2v_mode:
            raise NotImplementedError(
                "HunyuanVideoFlow i2v inference needs i2v_mode=true")
        lat = self.latent_shape(images.shape[0], frames, height, width)[1]
        z0 = self.encode_video(images[:, None], generator,
                               noise=posterior_noise)
        il = torch.cat([z0, z0.new_zeros((z0.shape[0], lat - z0.shape[1],
                                          *z0.shape[2:]))], dim=1)
        cond = dict(cond, image_latents=il)
        if uncond is not None:
            uncond = dict(uncond, image_latents=il)
        return cond, uncond

    def denoise_apply(self, x: torch.Tensor, t: torch.Tensor, cond: Cond,
                      temporal_rope_scale: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        if self.i2v_mode and cond.get("image_latents") is not None:
            x = torch.cat([x, cond["image_latents"].to(x)], dim=-1)
        guidance = None
        if self.embedded_cfg_scale is not None:
            guidance = torch.full((x.shape[0],),
                                  self.embedded_cfg_scale * 1000.0,
                                  device=x.device)
        return self.denoiser(x, t, cond["y"], cond.get("pooled"),
                             cond.get("mask"), guidance, temporal_rope_scale)

    # --------------------------------------------------------------- training
    def training_loss(self, batch: Dict[str, Any],
                      generator: Optional[torch.Generator] = None, *,
                      sigma: Optional[torch.Tensor] = None,
                      noise: Optional[torch.Tensor] = None,
                      posterior_noise: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Flow-matching MSE of the velocity, the per-sample mean with a
        NaN sample counted as 0, then the batch mean.  ``batch``: "video"
        (B, T, H, W, 3) in [−1, 1] or "latents", "text_states" and
        optionally "text_mask" and "pooled_text" (CLIP's vector).  Given
        ``sigma``, ``noise`` or ``posterior_noise`` replace the draws."""
        z = batch.get("latents")
        if z is None:
            z = self.encode_video(batch["video"], generator,
                                  noise=posterior_noise)
        if sigma is None:
            sigma = sample_sigmas(generator, z.shape[0], "logit_normal",
                                  device=z.device)
        sigma = sigma.to(z)
        noise = (randn(z.shape, generator, z.device) if noise is None
                 else noise.to(z))
        x_t = flow_interpolate(z, noise, sigma)
        cond = {"y": batch["text_states"], "mask": batch.get("text_mask"),
                "pooled": batch.get("pooled_text")}
        v_pred = self.denoise_apply(x_t, sigma * 1000.0, cond)
        per = ((v_pred - flow_target(z, noise)) ** 2).mean(
            dim=tuple(range(1, z.ndim)))
        per = torch.where(torch.isnan(per), 0.0, per)
        loss = per.mean()
        return loss, {"loss": loss, "sigma_mean": sigma.mean()}

    # -------------------------------------------------------------- sampling
    def temporal_rope_scale(self, num_latent_frames: int
                            ) -> Optional[torch.Tensor]:
        """RIFLEx's scale for a video of ``num_latent_frames``, sized by the
        DiT's own temporal rope width (the JAX flow derives another width at
        head_dim 128; see ROADMAP.md queue 3)."""
        return riflex_temporal_scale(
            self.denoiser.rope_dims()[0], num_latent_frames, self.riflex_k,
            L_test=num_latent_frames if num_latent_frames > 48 else None,
            theta=self.denoiser.rope_theta, device=self.device)

    @torch.inference_mode()
    def sample(self, cond: Cond, uncond: Optional[Cond], shape,
               generator: Optional[torch.Generator], cfg_scale: float = 1.0,
               x_T: Optional[torch.Tensor] = None,
               noises: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Euler flow matching, one forward per step (HunyuanVideo is
        guidance-distilled); true CFG only with ``uncond`` and
        ``cfg_scale`` ≠ 1.  Above 48 latent frames the temporal RoPE gets
        RIFLEx's scale."""
        scale = self.temporal_rope_scale(shape[1])

        def model_fn(x, t, c):
            return self.denoise_apply(x, t, c, temporal_rope_scale=scale)

        denoise = cfg_denoise(model_fn, cond, uncond, cfg_scale)
        return self._run_sampler(denoise, shape, generator, x_T, noises)
