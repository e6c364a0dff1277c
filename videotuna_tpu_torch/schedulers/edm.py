"""EDM / k-diffusion samplers (torch), the counterpart of
``videotuna_tpu/schedulers/edm.py``: the sgm sampler family of the
CogVideoX-SAT engine (Euler, Heun, Euler-ancestral, DPM++2S-ancestral,
DPM++2M and linear multistep) over a descending sigma schedule with a
terminal 0, Karras-ρ or legacy-DDPM.

Every sampler works on the EDM denoiser convention D(x; σ) ≈ x0 (the sgm
denoiser wrapper's output), one Python step a sigma.  The stochastic
samplers draw from an explicit ``torch.Generator``, or take the per-step
noises (N, *x.shape) given as ``noises`` (tests replay the JAX package's
draws).  LMS's coefficients are integrated on the host in numpy, as in the
JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import numpy as np
import torch

from videotuna_tpu_torch.core.registry import register
from videotuna_tpu_torch.schedulers.common import randn
from videotuna_tpu_torch.schedulers.ddpm import _move

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # (x, σ)→x0


def karras_sigmas(n: int, sigma_min: float = 0.002, sigma_max: float = 80.0,
                  rho: float = 7.0) -> torch.Tensor:
    """Karras et al.'s ρ-schedule, descending, with a terminal 0."""
    ramp = np.linspace(0, 1, n)
    mn, mx = sigma_min ** (1 / rho), sigma_max ** (1 / rho)
    sig = (mx + ramp * (mn - mx)) ** rho
    return torch.as_tensor(np.append(sig, 0.0), dtype=torch.float32)


def ddpm_sigmas(n: int, timesteps: int = 1000, linear_start: float = 0.00085,
                linear_end: float = 0.012) -> torch.Tensor:
    """sgm's LegacyDDPMDiscretization: σ = sqrt((1 − ᾱ)/ᾱ) on n evenly
    spaced steps of the scaled-linear chain, descending, terminal 0."""
    betas = np.linspace(linear_start ** 0.5, linear_end ** 0.5,
                        timesteps) ** 2
    abar = np.cumprod(1.0 - betas)
    idx = np.linspace(0, timesteps - 1, n).round().astype(int)
    sig = np.sqrt((1 - abar[idx]) / abar[idx])[::-1]
    return torch.as_tensor(np.append(sig, 0.0), dtype=torch.float32)


def cfg_denoiser(model_fn: Callable, cond, uncond, scale: float) -> DenoiseFn:
    """sgm's VanillaCFG guider: the two calls combined at the denoised
    level."""
    def fn(x, sigma):
        d_c = model_fn(x, sigma, cond)
        if uncond is None or scale == 1.0:
            return d_c
        d_u = model_fn(x, sigma, uncond)
        return d_u + scale * (d_c - d_u)
    return fn


def _ancestral_steps(sig, sig_n, eta: float):
    up = torch.minimum(sig_n, eta * torch.sqrt(torch.clamp_min(
        sig_n ** 2 * (sig ** 2 - sig_n ** 2) / torch.clamp_min(sig ** 2,
                                                               1e-12), 0.0)))
    down = torch.sqrt(torch.clamp_min(sig_n ** 2 - up ** 2, 0.0))
    return up, down


@dataclasses.dataclass(frozen=True)
class EDMSamplerFamily:
    """The shared sigma schedule (N+1,) f32, descending, last 0, and the six
    sgm samplers."""
    sigmas: torch.Tensor

    @classmethod
    def create(cls, num_steps: int = 30, discretization: str = "karras",
               sigma_min: float = 0.002, sigma_max: float = 80.0,
               rho: float = 7.0) -> "EDMSamplerFamily":
        if discretization == "karras":
            return cls(karras_sigmas(num_steps, sigma_min, sigma_max, rho))
        if discretization in ("ddpm", "legacy"):
            return cls(ddpm_sigmas(num_steps))
        raise ValueError(discretization)

    def to(self, device: Union[str, torch.device]) -> "EDMSamplerFamily":
        return _move(self, device)

    @property
    def num_steps(self) -> int:
        return self.sigmas.shape[0] - 1

    def _noise(self, i, x, generator, noises):
        return (noises[i].to(x) if noises is not None
                else randn(x.shape, generator, x.device).to(x.dtype))

    # ------------------------------------------------------------ samplers
    def sample_euler(self, denoise: DenoiseFn, x: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     s_churn: float = 0.0, s_noise: float = 1.0,
                     noises: Optional[torch.Tensor] = None) -> torch.Tensor:
        """EulerEDMSampler: a first-order ODE step a sigma; with ``s_churn``
        each step first raises σ by γ = min(s_churn/N, √2 − 1) and adds the
        matching noise."""
        gamma_max = min(s_churn / max(self.num_steps, 1), 2 ** 0.5 - 1)
        churn = s_churn > 0.0 and (generator is not None
                                   or noises is not None)
        for i in range(self.num_steps):
            sig, sig_n = self.sigmas[i], self.sigmas[i + 1]
            if churn:
                sig_hat = sig * (1.0 + gamma_max)
                eps = self._noise(i, x, generator, noises) * s_noise
                x = x + eps * torch.sqrt(torch.clamp_min(
                    sig_hat ** 2 - sig ** 2, 0.0))
                sig = sig_hat
            d = (x - denoise(x, sig)) / sig
            x = x + d * (sig_n - sig)
        return x

    def sample_heun(self, denoise: DenoiseFn, x: torch.Tensor
                    ) -> torch.Tensor:
        """HeunEDMSampler: Euler plus the second-order correction, except
        on the step to σ = 0."""
        for i in range(self.num_steps):
            sig, sig_n = self.sigmas[i], self.sigmas[i + 1]
            d = (x - denoise(x, sig)) / sig
            x_e = x + d * (sig_n - sig)
            if float(sig_n) > 0:
                d2 = (x_e - denoise(x_e, sig_n)) / torch.clamp_min(sig_n,
                                                                   1e-12)
                x_e = x + 0.5 * (d + d2) * (sig_n - sig)
            x = x_e
        return x

    def sample_euler_ancestral(self, denoise: DenoiseFn, x: torch.Tensor,
                               generator: Optional[torch.Generator] = None,
                               eta: float = 1.0,
                               noises: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
        """EulerAncestralSampler: an Euler step to σ_down, then noise of
        σ_up."""
        for i in range(self.num_steps):
            sig, sig_n = self.sigmas[i], self.sigmas[i + 1]
            up, down = _ancestral_steps(sig, sig_n, eta)
            d = (x - denoise(x, sig)) / sig
            x = x + d * (down - sig)
            x = x + self._noise(i, x, generator, noises) * up
        return x

    def sample_dpmpp2s_ancestral(self, denoise: DenoiseFn, x: torch.Tensor,
                                 generator: Optional[torch.Generator] = None,
                                 eta: float = 1.0,
                                 noises: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
        """DPMPP2SAncestralSampler: the 2S midpoint step in log-σ to
        σ_down (Euler where σ_down is 0), then noise of σ_up."""
        for i in range(self.num_steps):
            sig, sig_n = self.sigmas[i], self.sigmas[i + 1]
            up, down = _ancestral_steps(sig, sig_n, eta)
            d0 = denoise(x, sig)
            if float(down) > 1e-10:
                t = -torch.log(sig)
                t_n = -torch.log(torch.clamp_min(down, 1e-12))
                s_mid = t + 0.5 * (t_n - t)
                x_mid = (torch.exp(-s_mid) / torch.exp(-t)) * x \
                    - torch.expm1(-(s_mid - t)) * d0
                d_mid = denoise(x_mid, torch.exp(-s_mid))
                x = (torch.exp(-t_n) / torch.exp(-t)) * x \
                    - torch.expm1(-(t_n - t)) * d_mid
            else:
                x = x + (x - d0) / sig * (down - sig)
            x = x + self._noise(i, x, generator, noises) * up
        return x

    def sample_dpmpp2m(self, denoise: DenoiseFn, x: torch.Tensor
                       ) -> torch.Tensor:
        """DPMPP2MSampler: deterministic second-order multistep on the
        previous denoised estimate (first order on the first step); the
        step to σ = 0 returns the denoised estimate."""
        d_prev = None
        for i in range(self.num_steps):
            sig, sig_n = self.sigmas[i], self.sigmas[i + 1]
            d0 = denoise(x, sig)
            sig_n_c = torch.clamp_min(sig_n, 1e-12)
            t, t_n = -torch.log(sig), -torch.log(sig_n_c)
            h = t_n - t
            if d_prev is None:
                d_d = d0
            else:
                r = (t + torch.log(self.sigmas[i - 1])) / h
                d_d = (1 + 1 / (2 * r)) * d0 - (1 / (2 * r)) * d_prev
            x = (sig_n_c / sig) * x - torch.expm1(-h) * d_d
            if float(sig_n) <= 0:
                x = d0
            d_prev = d0
        return x

    def lms_coefficients(self, order: int = 4) -> np.ndarray:
        """(N, order) Adams-Bashforth weights of d = (x − D)/σ, newest
        first, integrated over each step by 8-point Gauss-Legendre on the
        host (the sigmas are fixed)."""
        from numpy.polynomial.legendre import leggauss
        sig = self.sigmas.cpu().numpy()
        xs, ws = leggauss(8)
        table = np.zeros((self.num_steps, order), np.float64)
        for i in range(self.num_steps):
            cur = min(i + 1, order)
            a, b = sig[i], sig[i + 1]
            taus = 0.5 * (b - a) * xs + 0.5 * (b + a)
            for j in range(cur):
                def poly(tau, j=j):
                    prod = 1.0
                    for kk in range(cur):
                        if kk != j:
                            prod *= (tau - sig[i - kk]) / (sig[i - j]
                                                           - sig[i - kk])
                    return prod
                table[i, j] = 0.5 * (b - a) * np.sum(
                    ws * [poly(t) for t in taus])
        return table

    def sample_lms(self, denoise: DenoiseFn, x: torch.Tensor,
                   order: int = 4) -> torch.Tensor:
        """LinearMultistepSampler: x += Σ_j c_ij·d_{i−j} over the last
        ``order`` derivatives."""
        coeffs = torch.as_tensor(self.lms_coefficients(order),
                                 dtype=torch.float32, device=x.device)
        ds = [torch.zeros_like(x)] * order          # newest first
        for i in range(self.num_steps):
            sig = self.sigmas[i]
            ds = [(x - denoise(x, sig)) / sig] + ds[:-1]
            x = x + sum(coeffs[i, j] * ds[j] for j in range(order))
        return x

    def sample(self, denoise: DenoiseFn, x: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               method: str = "euler", **kw) -> torch.Tensor:
        if method in ("euler", "euler_ancestral", "dpmpp2s_ancestral"):
            fn = {"euler": self.sample_euler,
                  "euler_ancestral": self.sample_euler_ancestral,
                  "dpmpp2s_ancestral": self.sample_dpmpp2s_ancestral}[method]
            return fn(denoise, x, generator, **kw)
        fn = {"heun": self.sample_heun, "dpmpp2m": self.sample_dpmpp2m,
              "lms": self.sample_lms}[method]
        return fn(denoise, x, **kw)


_SGM = ("videotuna.models.cogvideo_sat.sgm.modules.diffusionmodules."
        "sampling.")


@register("videotuna_tpu_torch.schedulers.EDMSamplerFamily",
          aliases=[_SGM + "EulerEDMSampler", _SGM + "HeunEDMSampler",
                   _SGM + "EulerAncestralSampler",
                   _SGM + "DPMPP2SAncestralSampler",
                   _SGM + "DPMPP2MSampler",
                   _SGM + "LinearMultistepSampler"])
def build_edm(**kwargs) -> EDMSamplerFamily:
    allowed = {"num_steps", "discretization", "sigma_min", "sigma_max", "rho"}
    return EDMSamplerFamily.create(**{k: v for k, v in kwargs.items()
                                      if k in allowed})
