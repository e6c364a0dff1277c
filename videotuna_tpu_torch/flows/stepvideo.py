"""StepVideoFlow (torch): Step-Video-T2V sampling and training, the
counterpart of ``videotuna_tpu/flows/stepvideo.py``: the dual-tower text
conditioning (the Step-1 LLM's states, and the CLIP states that the DiT puts
before the caption tokens) → ``StepVideoModel`` with CFG on the shifted
flow-matching Euler schedule → the causal 3D VAE.  Training draws uniform
sigmas, x_t = (1 − σ)·x0 + σ·ε, and regresses the velocity ε − x0.

The flow sets no fixed max, so the DiT's attention runs the online softmax
(its self-attention on route K2, its masked cross-attention on route K4,
both at d = 128).  ``shard_for_tp`` shards the DiT's linear layers over
the mesh's ``tp`` axis (``parallel/tensor_parallel.py``), as the JAX flow
places its parameters.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from videotuna_tpu_torch.core.registry import register
from videotuna_tpu_torch.flows.generation import Cond, GenerationFlow
from videotuna_tpu_torch.models.text_encoders import tokenize
from videotuna_tpu_torch.schedulers import (FlowMatchSchedule,
                                            flow_interpolate, flow_target,
                                            sample_sigmas)
from videotuna_tpu_torch.schedulers.common import randn


@register("videotuna_tpu_torch.flows.StepVideoFlow",
          aliases=["videotuna.flow.stepvideo.StepVideoModelFlow"])
class StepVideoFlow(GenerationFlow):
    latent_channels = 64
    vae_spatial_ratio = 16
    vae_temporal_ratio = 8

    def __init__(self, *args, num_inference_steps: int = 50,
                 flow_shift: float = 13.0, **kwargs):
        kwargs.setdefault("model_max_length", 320)
        super().__init__(*args, **kwargs)
        if not isinstance(self.scheduler, FlowMatchSchedule):
            self.scheduler = FlowMatchSchedule.create(
                num_inference_steps, flow_shift).to(self.device)

    def latent_shape(self, batch: int, num_frames: int, height: int,
                     width: int) -> Tuple[int, ...]:
        return (batch, max(num_frames // self.vae_temporal_ratio, 1),
                height // self.vae_spatial_ratio,
                width // self.vae_spatial_ratio, self.latent_channels)

    @torch.no_grad()
    def encode_text(self, texts: Sequence[str]) -> Cond:
        """{"y": the StepLLM states, "mask", "y_mask": the caption mask}
        and, with the CLIP stage, "y2": its sequence states."""
        cond = super().encode_text(texts)
        cond["y_mask"] = cond["mask"]
        if self.cond_stage_2 is not None:
            ids2, _ = tokenize(texts, pretrained=self.tokenizer,
                               max_length=getattr(self.cond_stage_2,
                                                  "max_len", 77))
            cond["y2"] = self.cond_stage_2(
                torch.as_tensor(ids2, device=self.device))
        return cond

    def denoise_apply(self, x: torch.Tensor, t: torch.Tensor,
                      cond: Cond) -> torch.Tensor:
        return self.denoiser(x, t, cond["y"], cond.get("y2"),
                             cond.get("y_mask"))

    def shard_for_tp(self, mesh) -> None:
        """Shard the denoiser with the TP rules over ``mesh``'s tp axis."""
        from videotuna_tpu_torch.parallel.tensor_parallel import apply_tp
        apply_tp(self.denoiser, mesh)

    def training_loss(self, batch: Dict[str, Any],
                      generator: Optional[torch.Generator] = None, *,
                      sigma: Optional[torch.Tensor] = None,
                      noise: Optional[torch.Tensor] = None,
                      posterior_noise: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Flow-matching MSE of the velocity at t = 1000·σ, σ uniform, the
        per-sample mean with a NaN sample counted as 0, then the batch
        mean.  ``batch``: "video" (B, T, H, W, 3) in [−1, 1] or "latents",
        and "text_states" (no mask, no CLIP states, as in the JAX flow).
        Given ``sigma``, ``noise`` or ``posterior_noise`` replace the
        draws."""
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
                               {"y": batch["text_states"]})
        per = ((v - flow_target(z, noise)) ** 2).mean(
            dim=tuple(range(1, z.ndim)))
        loss = torch.where(torch.isnan(per), 0.0, per).mean()
        return loss, {"loss": loss}
