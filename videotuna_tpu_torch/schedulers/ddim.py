"""DDIM sampler (torch), the counterpart of ``videotuna_tpu/schedulers/ddim.py``:
precomputed per-step (t, ᾱ, ᾱ_prev, σ) and a Python loop over the steps;
CFG as a wrapper around the model function that doubles the batch, so each
step makes one model call."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from videotuna_tpu_torch.core.registry import register
from videotuna_tpu_torch.schedulers.common import (
    make_ddim_sampling_parameters, make_ddim_timesteps, randn,
    rescale_noise_cfg)
from videotuna_tpu_torch.schedulers.ddpm import DDPMSchedule, _move

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    """Per-step buffers for a DDIM run (indices ascend in model-t order)."""
    timesteps: torch.Tensor     # (S,) int64, ascending
    alphas: torch.Tensor        # (S,) ᾱ at each step
    alphas_prev: torch.Tensor   # (S,)
    sigmas: torch.Tensor        # (S,)
    base: DDPMSchedule

    @classmethod
    def create(cls, base: DDPMSchedule, num_steps: int, eta: float = 0.0,
               method: str = "uniform") -> "DDIMSchedule":
        ddim_ts = make_ddim_timesteps(num_steps, base.num_timesteps, method)
        ddim_ts = np.minimum(ddim_ts, base.num_timesteps - 1)
        alphas, alphas_prev, sigmas = make_ddim_sampling_parameters(
            base.alphas_cumprod.cpu(), ddim_ts, eta)
        dev = base.alphas_cumprod.device
        return cls(timesteps=torch.as_tensor(ddim_ts, device=dev),
                   alphas=alphas.to(dev), alphas_prev=alphas_prev.to(dev),
                   sigmas=sigmas.to(dev), base=base)

    def to(self, device: Union[str, torch.device]) -> "DDIMSchedule":
        return _move(self, device)

    @property
    def num_steps(self) -> int:
        return self.timesteps.shape[0]

    def step(self, denoise_fn: DenoiseFn, x: torch.Tensor, i: int,
             noise: Optional[torch.Tensor], clip_denoised: bool = False
             ) -> torch.Tensor:
        """One DDIM update at schedule index ``i`` with explicit noise
        (``None`` where σ is 0)."""
        t = torch.full((x.shape[0],), int(self.timesteps[i]),
                       dtype=torch.int64, device=x.device)
        x0, eps = self.base.to_x0_and_eps(x, t, denoise_fn(x, t))
        if clip_denoised:
            x0 = x0.clamp(-1.0, 1.0)
        a_prev = self.alphas_prev[i]
        sigma = self.sigmas[i]
        dir_xt = torch.sqrt((1.0 - a_prev - sigma ** 2).clamp_min(0.0)) * eps
        x_next = torch.sqrt(a_prev) * x0 + dir_xt
        return x_next if noise is None else x_next + sigma * noise

    def sample(self, denoise_fn: DenoiseFn, shape: Sequence[int],
               generator: torch.Generator,
               x_T: Optional[torch.Tensor] = None,
               clip_denoised: bool = False) -> torch.Tensor:
        """The full loop from index S−1 down to 0.  ``x_T`` overrides the
        initial draw from ``generator``; steps with σ = 0 (η = 0) draw
        nothing."""
        dev = self.timesteps.device
        x = randn(shape, generator, dev) if x_T is None else x_T
        for i in range(self.num_steps - 1, -1, -1):
            noise = (randn(x.shape, generator, dev).to(x.dtype)
                     if float(self.sigmas[i]) != 0.0 else None)
            x = self.step(denoise_fn, x, i, noise, clip_denoised)
        return x


# ---------------------------------------------------------------------------
# CFG wrappers
# ---------------------------------------------------------------------------

def _cat_cond(uncond: Dict, cond: Dict) -> Dict:
    return {k: torch.cat([uncond[k], cond[k]], dim=0) for k in cond}


def cfg_denoise(model_fn: Callable[..., torch.Tensor], cond: Dict,
                uncond: Optional[Dict], scale: float,
                guidance_rescale: float = 0.0) -> DenoiseFn:
    """Classifier-free guidance with batch-doubling (one model call)."""

    def fn(x, t):
        if scale == 1.0 or uncond is None:
            return model_fn(x, t, cond)
        out = model_fn(torch.cat([x, x]), torch.cat([t, t]),
                       _cat_cond(uncond, cond))
        e_u, e_c = out.chunk(2, dim=0)
        e = e_u + scale * (e_c - e_u)
        if guidance_rescale > 0.0:
            e = rescale_noise_cfg(e, e_c, guidance_rescale)
        return e

    return fn


def dynamic_cfg_denoise(model_fn: Callable[..., torch.Tensor], cond: Dict,
                        uncond: Optional[Dict], scale: float,
                        num_inference_steps: int,
                        timesteps: Optional[torch.Tensor] = None,
                        guidance_rescale: float = 0.0) -> DenoiseFn:
    """CogVideoX cosine dynamic guidance: per-step scale
    ``1 + s·(1 − cos(π·((N − t)/N)^5))/2`` from the raw timestep ``t``.
    With the schedule's ``timesteps`` the table is computed in float64 and
    looked up as f32, as the JAX package does."""
    if timesteps is not None:
        ts64 = timesteps.cpu().numpy().astype(np.float64)
        frac64 = (num_inference_steps - ts64) / num_inference_steps
        tab = (1.0 + scale * ((1.0 - np.cos(np.pi * frac64 ** 5)) / 2.0)
               ).astype(np.float32)
        ts32 = ts64.astype(np.float32)

        def gs_of(tf: float) -> float:
            return float(tab[np.argmin(np.abs(ts32 - np.float32(tf)))])
    else:
        def gs_of(tf: float) -> float:
            frac = np.float32((num_inference_steps - np.float32(tf))
                              / num_inference_steps)
            return float(np.float32(1.0 + scale * (
                (1.0 - np.cos(np.float32(np.pi) * frac ** 5)) / 2.0)))

    def fn(x, t):
        if uncond is None:
            return model_fn(x, t, cond)
        gs = gs_of(float(t.reshape(-1)[0]))
        out = model_fn(torch.cat([x, x]), torch.cat([t, t]),
                       _cat_cond(uncond, cond))
        e_u, e_c = out.chunk(2, dim=0)
        e = e_u + gs * (e_c - e_u)
        if guidance_rescale > 0.0:
            e = rescale_noise_cfg(e, e_c, guidance_rescale)
        return e

    return fn


@register("videotuna_tpu_torch.schedulers.DDIMSchedule",
          aliases=["videotuna.schedulers.ddim.DDIMSampler",
                   "videotuna.schedulers.ddim_multiplecond.DDIMSampler"])
def build_ddim(base: Optional[DDPMSchedule] = None, num_steps: int = 50,
               eta: float = 0.0, method: str = "uniform",
               **base_kwargs) -> DDIMSchedule:
    if base is None:
        base = DDPMSchedule.create(**base_kwargs)
    return DDIMSchedule.create(base, num_steps, eta, method)
