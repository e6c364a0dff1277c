"""Diffusion math shared by the schedulers (torch), the counterpart of
``videotuna_tpu/schedulers/common.py``: beta schedules, zero-terminal-SNR and
SNR-shift rescales, DDIM and trailing timestep grids, CFG rescale.  Schedules
are built in f32, as the JAX package builds them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def make_beta_schedule(schedule: str, n_timestep: int,
                       linear_start: float = 1e-4,
                       linear_end: float = 2e-2,
                       cosine_s: float = 8e-3) -> torch.Tensor:
    """Beta schedules; ``linear`` is the LDM convention (linear in
    sqrt(beta)).  Computed in float64, returned as f32."""
    if schedule in ("linear", "scaled_linear"):
        betas = np.linspace(linear_start ** 0.5, linear_end ** 0.5,
                            n_timestep, dtype=np.float64) ** 2
    elif schedule in ("simple_linear", "sqrt_linear"):
        betas = np.linspace(linear_start, linear_end, n_timestep,
                            dtype=np.float64)
    elif schedule == "cosine":
        timesteps = (np.arange(n_timestep + 1, dtype=np.float64) / n_timestep
                     + cosine_s)
        alphas = np.cos(timesteps / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        betas = np.clip(1 - alphas[1:] / alphas[:-1], 0, 0.999)
    elif schedule == "sqrt":
        betas = np.linspace(linear_start, linear_end, n_timestep,
                            dtype=np.float64) ** 0.5
    else:
        raise ValueError(f"Unknown beta schedule {schedule!r}")
    return torch.as_tensor(betas, dtype=torch.float32)


def rescale_zero_terminal_snr(betas: torch.Tensor) -> torch.Tensor:
    """Zero-terminal-SNR rescale in betas space (arXiv:2305.08891)."""
    alphas_bar_sqrt = torch.sqrt(torch.cumprod(1.0 - betas, dim=0))
    a0 = alphas_bar_sqrt[0].clone()
    aT = alphas_bar_sqrt[-1].clone()
    alphas_bar_sqrt = (alphas_bar_sqrt - aT) * a0 / (a0 - aT)
    alphas_bar = alphas_bar_sqrt ** 2
    alphas = torch.cat([alphas_bar[:1], alphas_bar[1:] / alphas_bar[:-1]])
    return 1.0 - alphas


def snr_shift_alphas_cumprod(alphas_cumprod: torch.Tensor,
                             snr_shift_scale: float) -> torch.Tensor:
    """SD3-style SNR shift of the CogVideoX schedulers:
    ᾱ ← ᾱ / (s + (1 − s)·ᾱ), which divides every SNR by s."""
    return alphas_cumprod / (snr_shift_scale
                             + (1.0 - snr_shift_scale) * alphas_cumprod)


def rescale_zero_terminal_snr_alphas(alphas_cumprod: torch.Tensor
                                     ) -> torch.Tensor:
    """Zero-terminal-SNR rescale applied directly to ᾱ (the diffusers
    CogVideoX order: after the SNR shift)."""
    alphas_bar_sqrt = torch.sqrt(alphas_cumprod)
    a0 = alphas_bar_sqrt[0].clone()
    aT = alphas_bar_sqrt[-1].clone()
    return ((alphas_bar_sqrt - aT) * a0 / (a0 - aT)) ** 2


def make_trailing_timesteps(num_steps: int,
                            num_train_timesteps: int) -> np.ndarray:
    """``timestep_spacing="trailing"``: descending grid ending at the
    schedule tail — round(arange(N, 0, −N/S)) − 1."""
    step_ratio = num_train_timesteps / num_steps
    ts = np.round(np.arange(num_train_timesteps, 0, -step_ratio))
    return ts.astype(np.int64) - 1


def make_ddim_timesteps(num_ddim_timesteps: int, num_ddpm_timesteps: int,
                        method: str = "uniform") -> np.ndarray:
    """Ascending DDIM timestep subset (+1, as in the reference)."""
    if method == "uniform":
        c = num_ddpm_timesteps // num_ddim_timesteps
        steps = np.asarray(list(range(0, num_ddpm_timesteps, c)))
    elif method == "quad":
        steps = (np.linspace(0, np.sqrt(num_ddpm_timesteps * 0.8),
                             num_ddim_timesteps) ** 2).astype(int)
    else:
        raise ValueError(f"Unknown ddim discretization {method!r}")
    return steps + 1


def make_ddim_sampling_parameters(alphacums: torch.Tensor,
                                  ddim_timesteps: np.ndarray, eta: float
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """alphas, alphas_prev, sigmas for the DDIM subset."""
    idx = torch.as_tensor(ddim_timesteps)
    alphas = alphacums[idx]
    alphas_prev = torch.cat([alphacums[:1], alphacums[idx[:-1]]])
    sigmas = eta * torch.sqrt((1 - alphas_prev) / (1 - alphas)
                              * (1 - alphas / alphas_prev))
    return alphas, alphas_prev, sigmas


def rescale_noise_cfg(noise_cfg: torch.Tensor, noise_pred_text: torch.Tensor,
                      guidance_rescale: float = 0.0) -> torch.Tensor:
    """CFG rescale (arXiv:2305.08891 §3.4), Bessel-corrected std."""
    dims = tuple(range(1, noise_pred_text.ndim))
    std_text = noise_pred_text.std(dim=dims, keepdim=True, correction=1)
    std_cfg = noise_cfg.std(dim=dims, keepdim=True, correction=1)
    rescaled = noise_cfg * (std_text / (std_cfg + 1e-8))
    return guidance_rescale * rescaled + (1 - guidance_rescale) * noise_cfg


def randn(shape, generator: Optional[torch.Generator],
          device: torch.device) -> torch.Tensor:
    """f32 standard normal draws from an explicit generator (never torch's
    global RNG)."""
    if generator is None:
        raise ValueError("drawing noise needs a torch.Generator")
    return torch.randn(tuple(shape), generator=generator, device=device)


def extract_into(a: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """a[t] (f32) broadcast to an ``ndim``-dim tensor; ``t`` is (batch,)."""
    out = a[t.long()].float()
    return out.reshape(out.shape[0], *([1] * (ndim - 1)))
