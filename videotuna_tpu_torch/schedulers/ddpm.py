"""DDPM/LDM schedule as precomputed f32 buffers + methods (torch), the
counterpart of ``videotuna_tpu/schedulers/ddpm.py``: q_sample, posterior,
the eps / x0 / v parameterisations, zero-SNR and SNR-shift rescaling."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from videotuna_tpu_torch.core.registry import register
from videotuna_tpu_torch.schedulers.common import (
    extract_into, make_beta_schedule, rescale_zero_terminal_snr,
    rescale_zero_terminal_snr_alphas, snr_shift_alphas_cumprod)


def _move(obj, device):
    """Copy of a schedule dataclass with every tensor (and nested schedule)
    moved to ``device``."""
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            changes[f.name] = v.to(device)
        elif dataclasses.is_dataclass(v):
            changes[f.name] = _move(v, device)
    return dataclasses.replace(obj, **changes)


@dataclasses.dataclass(frozen=True)
class DDPMSchedule:
    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    parameterization: str = "eps"
    v_posterior: float = 0.0

    @classmethod
    def create(cls, timesteps: int = 1000, beta_schedule: str = "linear",
               linear_start: float = 1e-4, linear_end: float = 2e-2,
               cosine_s: float = 8e-3,
               given_betas: Optional[torch.Tensor] = None,
               parameterization: str = "eps", v_posterior: float = 0.0,
               rescale_betas_zero_snr: bool = False,
               snr_shift_scale: float = 1.0) -> "DDPMSchedule":
        betas = (torch.as_tensor(given_betas, dtype=torch.float32)
                 if given_betas is not None else
                 make_beta_schedule(beta_schedule, timesteps, linear_start,
                                    linear_end, cosine_s))
        if snr_shift_scale != 1.0:
            # diffusers CogVideoX order: betas → cumprod → SNR shift →
            # zero-SNR rescale on ᾱ; betas re-derived from ᾱ
            acp = torch.cumprod(1.0 - betas, dim=0)
            acp = snr_shift_alphas_cumprod(acp, snr_shift_scale)
            if rescale_betas_zero_snr:
                acp = rescale_zero_terminal_snr_alphas(acp)
            alphas = torch.cat([acp[:1], acp[1:] / acp[:-1]])
            betas = 1.0 - alphas
            alphas_cumprod = acp
        else:
            if rescale_betas_zero_snr:
                betas = rescale_zero_terminal_snr(betas)
            alphas = 1.0 - betas
            alphas_cumprod = torch.cumprod(alphas, dim=0)
        alphas_cumprod_prev = torch.cat(
            [torch.ones(1, dtype=betas.dtype), alphas_cumprod[:-1]])
        posterior_variance = ((1 - v_posterior) * betas
                              * (1.0 - alphas_cumprod_prev)
                              / (1.0 - alphas_cumprod)
                              + v_posterior * betas)
        return cls(
            betas=betas,
            alphas_cumprod=alphas_cumprod,
            alphas_cumprod_prev=alphas_cumprod_prev,
            sqrt_alphas_cumprod=torch.sqrt(alphas_cumprod),
            sqrt_one_minus_alphas_cumprod=torch.sqrt(1.0 - alphas_cumprod),
            sqrt_recip_alphas_cumprod=torch.sqrt(1.0 / alphas_cumprod),
            sqrt_recipm1_alphas_cumprod=torch.sqrt(1.0 / alphas_cumprod - 1),
            posterior_variance=posterior_variance,
            posterior_log_variance_clipped=torch.log(
                posterior_variance.clamp_min(1e-20)),
            posterior_mean_coef1=(betas * torch.sqrt(alphas_cumprod_prev)
                                  / (1.0 - alphas_cumprod)),
            posterior_mean_coef2=((1.0 - alphas_cumprod_prev)
                                  * torch.sqrt(alphas)
                                  / (1.0 - alphas_cumprod)),
            parameterization=parameterization,
            v_posterior=v_posterior,
        )

    def to(self, device: Union[str, torch.device]) -> "DDPMSchedule":
        return _move(self, device)

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]

    # -------------------------------------------------------------- forward q
    def q_sample(self, x_start, t, noise):
        nd = x_start.ndim
        return (extract_into(self.sqrt_alphas_cumprod, t, nd) * x_start
                + extract_into(self.sqrt_one_minus_alphas_cumprod, t, nd)
                * noise)

    def q_posterior(self, x_start, x_t, t):
        nd = x_t.ndim
        mean = (extract_into(self.posterior_mean_coef1, t, nd) * x_start
                + extract_into(self.posterior_mean_coef2, t, nd) * x_t)
        var = extract_into(self.posterior_variance, t, nd)
        log_var = extract_into(self.posterior_log_variance_clipped, t, nd)
        return mean, var, log_var

    # ------------------------------------------------------ parameterizations
    def predict_start_from_noise(self, x_t, t, noise):
        nd = x_t.ndim
        return (extract_into(self.sqrt_recip_alphas_cumprod, t, nd) * x_t
                - extract_into(self.sqrt_recipm1_alphas_cumprod, t, nd)
                * noise)

    def predict_eps_from_start(self, x_t, t, x0):
        nd = x_t.ndim
        return ((extract_into(self.sqrt_recip_alphas_cumprod, t, nd) * x_t
                 - x0)
                / extract_into(self.sqrt_recipm1_alphas_cumprod, t, nd))

    def get_v(self, x, noise, t):
        nd = x.ndim
        return (extract_into(self.sqrt_alphas_cumprod, t, nd) * noise
                - extract_into(self.sqrt_one_minus_alphas_cumprod, t, nd) * x)

    def predict_start_from_z_and_v(self, x_t, t, v):
        nd = x_t.ndim
        return (extract_into(self.sqrt_alphas_cumprod, t, nd) * x_t
                - extract_into(self.sqrt_one_minus_alphas_cumprod, t, nd) * v)

    def predict_eps_from_z_and_v(self, x_t, t, v):
        nd = x_t.ndim
        return (extract_into(self.sqrt_alphas_cumprod, t, nd) * v
                + extract_into(self.sqrt_one_minus_alphas_cumprod, t, nd)
                * x_t)

    def to_x0_and_eps(self, x_t, t, model_out
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Model output under this parameterisation → (x0, eps)."""
        if self.parameterization == "eps":
            return self.predict_start_from_noise(x_t, t, model_out), model_out
        if self.parameterization == "x0":
            return model_out, self.predict_eps_from_start(x_t, t, model_out)
        if self.parameterization == "v":
            return (self.predict_start_from_z_and_v(x_t, t, model_out),
                    self.predict_eps_from_z_and_v(x_t, t, model_out))
        raise ValueError(self.parameterization)

    def training_target(self, x_start, noise, t) -> torch.Tensor:
        if self.parameterization == "eps":
            return noise
        if self.parameterization == "x0":
            return x_start
        if self.parameterization == "v":
            return self.get_v(x_start, noise, t)
        raise ValueError(self.parameterization)


@register("videotuna_tpu_torch.schedulers.DDPMSchedule",
          aliases=[
              "videotuna.schedulers.diffusion_schedulers.DDPMScheduler",
              "videotuna.schedulers.diffusion_schedulers.LDMScheduler",
          ])
def build_ddpm_schedule(**kwargs) -> DDPMSchedule:
    """Config-surface constructor accepting the reference's YAML params."""
    kwargs.pop("loss_type", None)  # handled by the flow's loss, not here
    kwargs.pop("logvar_init", None)
    names = DDPMSchedule.create.__func__.__code__.co_varnames
    return DDPMSchedule.create(**{k: v for k, v in kwargs.items()
                                  if k in names})
