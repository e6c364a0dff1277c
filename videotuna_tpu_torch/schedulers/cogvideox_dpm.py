"""CogVideoX samplers (torch): SDE-DPM-Solver++(2M) and trailing-spaced DDIM,
the counterparts of ``videotuna_tpu/schedulers/cogvideox_dpm.py``
(``diffusers.CogVideoXDPMScheduler`` / ``CogVideoXDDIMScheduler``).

With λ = log(√(ᾱ/(1−ᾱ))), h = λ_next − λ, σ = √(1−ᾱ):

    x⁺ = (σ⁺/σ)·e^{−h}·x + α⁺·(1−e^{−2h})·D + σ⁺·√(1−e^{−2h})·ξ
    D  = x₀                                  (first order)
    D  = (1 + 1/(2r))·x₀ − (1/(2r))·x₀_prev  (2M, r = h_last/h)

First-order steps on the first step and the final step (ᾱ_prev = 1 past
the grid end, λ = +∞: IEEE arithmetic lands the update on x₀).  The 2M
history (previous x₀) is carried in f32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from videotuna_tpu_torch.core.registry import register
from videotuna_tpu_torch.schedulers.common import (make_trailing_timesteps,
                                                   randn)
from videotuna_tpu_torch.schedulers.ddim import DDIMSchedule, DenoiseFn
from videotuna_tpu_torch.schedulers.ddpm import DDPMSchedule, _move


def _lam(acp: torch.Tensor) -> torch.Tensor:
    # unclipped: ᾱ=0 → −inf, ᾱ=1 → +inf
    return torch.log(torch.sqrt(acp / (1.0 - acp)))


def _trailing_grid(base: DDPMSchedule, num_steps: int):
    """Descending trailing timesteps, ᾱ at each, and ᾱ one step on (1.0
    past the grid end: ``set_alpha_to_one``), from f64 ᾱ."""
    n_train = int(base.alphas_cumprod.shape[0])
    ts = make_trailing_timesteps(num_steps, n_train)
    prev_ts = ts - n_train // num_steps
    acp = base.alphas_cumprod.cpu().numpy().astype(np.float64)
    alphas_prev = np.where(prev_ts >= 0, acp[np.maximum(prev_ts, 0)], 1.0)
    return ts, prev_ts, acp[ts], alphas_prev


@dataclasses.dataclass(frozen=True)
class CogVideoXDPMSchedule:
    """Per-step buffers of a CogVideoX SDE-DPM++(2M) run; ``timesteps``
    descend, index i is sampling order."""
    timesteps: torch.Tensor    # (S,) int64, DESCENDING
    alphas: torch.Tensor       # (S,) ᾱ[t_i]
    alphas_prev: torch.Tensor  # (S,) ᾱ[t_i − N/S] (1.0 past the end)
    is_final: torch.Tensor     # (S,) bool, prev_timestep < 0
    base: DDPMSchedule
    second_order: bool = True

    @classmethod
    def create(cls, base: DDPMSchedule, num_steps: int,
               second_order: bool = True) -> "CogVideoXDPMSchedule":
        ts, prev_ts, alphas, alphas_prev = _trailing_grid(base, num_steps)
        dev = base.alphas_cumprod.device
        return cls(timesteps=torch.as_tensor(ts, device=dev),
                   alphas=torch.as_tensor(alphas, dtype=torch.float32,
                                          device=dev),
                   alphas_prev=torch.as_tensor(alphas_prev,
                                               dtype=torch.float32,
                                               device=dev),
                   is_final=torch.as_tensor(prev_ts < 0, device=dev),
                   base=base, second_order=second_order)

    def to(self, device: Union[str, torch.device]) -> "CogVideoXDPMSchedule":
        return _move(self, device)

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])

    def step(self, denoise_fn: DenoiseFn, x: torch.Tensor,
             old_x0: torch.Tensor, i: int, noise: torch.Tensor,
             force_first: bool = False):
        """One SDE-DPM++(2M) update at sampling index ``i`` with explicit ξ;
        returns (x_next, x0), the caller threads x0 as ``old_x0``.
        ``force_first`` demotes the update to first order (a walk that
        enters the grid with no 2M history)."""
        t = torch.full((x.shape[0],), int(self.timesteps[i]),
                       dtype=torch.int64, device=x.device)
        x0, _ = self.base.to_x0_and_eps(x, t, denoise_fn(x, t))
        x0 = x0.float()

        a_t = self.alphas[i]
        a_prev = self.alphas_prev[i]
        lam = _lam(a_t)
        h = _lam(a_prev) - lam
        mult1 = torch.sqrt((1.0 - a_prev) / (1.0 - a_t)) * torch.exp(-h)
        mult2 = torch.expm1(-2.0 * h) * torch.sqrt(a_prev)
        mult_noise = (torch.sqrt(1.0 - a_prev)
                      * torch.sqrt(-torch.expm1(-2.0 * h)))

        first = (i == 0 or bool(self.is_final[i]) or force_first
                 or not self.second_order)
        if first:
            d = x0
        else:
            # r = h_last/h with the back step (the previous, larger t); the
            # first-order steps, where r is 0 or NaN, never reach 1/(2r)
            r = (lam - _lam(self.alphas[i - 1])) / h
            c2 = 1.0 / (2.0 * r)
            d = (1.0 + c2) * x0 - c2 * old_x0
        x_next = (mult1 * x - mult2 * d
                  + mult_noise * noise.float()).to(x.dtype)
        return x_next, x0

    def sample(self, denoise_fn: DenoiseFn, shape: Sequence[int],
               generator: torch.Generator,
               x_T: Optional[torch.Tensor] = None,
               noises: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The full loop.  ``x_T`` and ``noises`` (S, *shape) override the
        draws from ``generator`` (tests replay the JAX package's draws)."""
        dev = self.timesteps.device
        x = randn(shape, generator, dev) if x_T is None else x_T
        old_x0 = torch.zeros(x.shape, dtype=torch.float32, device=dev)
        for i in range(self.num_steps):
            xi = randn(x.shape, generator, dev) if noises is None \
                else noises[i]
            x, old_x0 = self.step(denoise_fn, x, old_x0, i, xi)
        return x


def build_cogvideox_ddim(base: Optional[DDPMSchedule] = None,
                         num_steps: int = 50, **base_kwargs) -> DDIMSchedule:
    """Trailing-spaced, η=0 DDIM — ``diffusers.CogVideoXDDIMScheduler``
    (its a_t/b_t step is algebraically the η=0 DDIM update)."""
    if base is None:
        base = DDPMSchedule.create(**base_kwargs)
    ts_desc, _, _, _ = _trailing_grid(base, num_steps)
    ts = ts_desc[::-1].copy()          # DDIMSchedule stores ascending
    n_train = int(base.alphas_cumprod.shape[0])
    prev_ts = ts - n_train // num_steps
    acp = base.alphas_cumprod.cpu().numpy().astype(np.float64)
    alphas_prev = np.where(prev_ts >= 0, acp[np.maximum(prev_ts, 0)], 1.0)
    dev = base.alphas_cumprod.device
    return DDIMSchedule(
        timesteps=torch.as_tensor(ts, device=dev),
        alphas=torch.as_tensor(acp[ts], dtype=torch.float32, device=dev),
        alphas_prev=torch.as_tensor(alphas_prev, dtype=torch.float32,
                                    device=dev),
        sigmas=torch.zeros(num_steps, dtype=torch.float32, device=dev),
        base=base)


@register("videotuna_tpu_torch.schedulers.CogVideoXDPMSchedule",
          aliases=["diffusers.CogVideoXDPMScheduler"])
def build_cogvideox_dpm(base: Optional[DDPMSchedule] = None,
                        num_steps: int = 50, second_order: bool = True,
                        **base_kwargs) -> CogVideoXDPMSchedule:
    if base is None:
        base_kwargs.setdefault("timesteps", 1000)
        base_kwargs.setdefault("beta_schedule", "scaled_linear")
        base_kwargs.setdefault("linear_start", 0.00085)
        base_kwargs.setdefault("linear_end", 0.012)
        base_kwargs.setdefault("parameterization", "v")
        base_kwargs.setdefault("rescale_betas_zero_snr", True)
        base_kwargs.setdefault("snr_shift_scale", 3.0)
        base = DDPMSchedule.create(**base_kwargs)
    return CogVideoXDPMSchedule.create(base, num_steps, second_order)


register("videotuna_tpu_torch.schedulers.build_cogvideox_ddim",
         aliases=["diffusers.CogVideoXDDIMScheduler"])(build_cogvideox_ddim)
