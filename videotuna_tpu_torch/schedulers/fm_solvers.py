"""Flow-matching multistep solvers (torch): DPM-Solver++(2M) and UniPC, the
counterpart of ``videotuna_tpu/schedulers/fm_solvers.py`` (Wan's samplers
at their default configs: solver order 2, data prediction, UniPC's bh2
corrector, DPM++'s midpoint, a lower order on the final steps, a final
sigma of 0).

On the path x_σ = (1 − σ)·x₀ + σ·ε the model predicts v = ε − x₀, so the
data prediction is x₀ = x_σ − σ·v.  With α_σ = 1 − σ, λ = log(α/σ) and
h = λ_next − λ_cur:

    DPM++(2M) midpoint:  x⁺ = (σ⁺/σ)·x − α⁺·(e^{−h} − 1)·(m + ½·D1),
    UniPC-2 (bh2):       the predictor adds −α⁺·B(h)·½·D1, B(h) = e^{−h} − 1,
                         and a corrector re-derives the current sample from
                         the previous one with the fresh model output —
                         one model call per step.

Both follow the reference's order schedule: order 1 on the first step,
order 2 after, order 1 on the final step onto σ = 0 (which lands on the
data prediction).  λ is unclipped: σ = 1 gives −∞ and σ = 0 gives +∞, and
IEEE arithmetic carries them (e^{−∞} = 0).

Where the JAX package runs one ``lax.scan`` with ``jnp.where`` selects over
every branch, the port runs a Python loop that takes only the branch of
each step; the per-step scalars are computed in f32 with numpy, as the JAX
package computes them in f32.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from videotuna_tpu_torch.core.registry import register
from videotuna_tpu_torch.schedulers.common import randn
from videotuna_tpu_torch.schedulers.ddpm import _move

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
f32 = np.float32


def get_sampling_sigmas(num_steps: int, shift: float) -> torch.Tensor:
    """The DPM++ grid: linspace(1, 0, N + 1) shifted (the shift fixes 0 and
    1), descending to 0, f32."""
    sigmas = torch.linspace(1.0, 0.0, num_steps + 1)
    if shift != 1.0:
        sigmas = shift * sigmas / (1.0 + (shift - 1.0) * sigmas)
    return sigmas


def unipc_sigmas(num_steps: int, shift: float,
                 num_train_timesteps: int = 1000) -> torch.Tensor:
    """The UniPC grid: from σ_max = 1 − 1/num_train_timesteps,
    linspace(σ_max, 0, N + 1)[:N] shifted (in float64), then 0; f32."""
    sig_max = 1.0 - 1.0 / num_train_timesteps
    sigmas = np.linspace(sig_max, 0.0, num_steps + 1)[:-1]
    sigmas = shift * sigmas / (1 + (shift - 1) * sigmas)
    return torch.as_tensor(np.concatenate([sigmas, [0.0]]),
                           dtype=torch.float32)


def _lam(sigma: np.ndarray) -> np.ndarray:
    """λ = log(1 − σ) − log(σ), unclipped, f32."""
    sigma = np.asarray(sigma, f32)
    with np.errstate(divide="ignore"):
        return (np.log1p(-sigma) - np.log(sigma)).astype(f32)


def _order_schedule(num_steps: int) -> np.ndarray:
    """Per-step predictor order at solver order 2 with the warm-up and the
    lower final order: min(2, N − i, i + 1)."""
    return np.array([min(2, num_steps - i, i + 1)
                     for i in range(num_steps)], np.int32)


def _ratio(num: f32, den: f32) -> f32:
    return f32(num / (f32(1.0) if den == 0 else den))


@dataclasses.dataclass(frozen=True)
class _FlowSolver:
    sigmas: torch.Tensor          # (S+1,) f32, descending, last = 0
    timesteps: torch.Tensor       # (S,) = σ[:-1]·num_train_timesteps
    num_train_timesteps: int = 1000

    def to(self, device: Union[str, torch.device]):
        return _move(self, device)

    @property
    def num_steps(self) -> int:
        return self.timesteps.shape[0]

    def _start(self, shape: Sequence[int],
               generator: Optional[torch.Generator],
               x_T: Optional[torch.Tensor]) -> torch.Tensor:
        return (randn(shape, generator, self.sigmas.device) if x_T is None
                else x_T)

    def _t(self, i: int, batch: int) -> torch.Tensor:
        return self.timesteps[i].expand(batch)


@dataclasses.dataclass(frozen=True)
class FlowDPMSolverSchedule(_FlowSolver):
    """DPM-Solver++(2M), midpoint, flow prediction: one model call a step,
    first order on the first and the last step."""

    @classmethod
    def create(cls, num_steps: int, shift: float = 5.0,
               num_train_timesteps: int = 1000) -> "FlowDPMSolverSchedule":
        sigmas = get_sampling_sigmas(num_steps, shift)
        return cls(sigmas=sigmas,
                   timesteps=sigmas[:-1] * num_train_timesteps,
                   num_train_timesteps=num_train_timesteps)

    def sample(self, denoise_fn: DenoiseFn, shape: Sequence[int],
               generator: Optional[torch.Generator],
               x_T: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self._start(shape, generator, x_T)
        sig = self.sigmas.cpu().numpy().astype(f32)
        lam = _lam(sig)
        n = self.num_steps
        m_prev = None
        for i in range(n):
            s_i, s_n = sig[i], sig[i + 1]
            v = denoise_fn(x, self._t(i, shape[0]))
            m = x - float(s_i) * v                  # x0 prediction
            h = f32(lam[i + 1] - lam[i])
            alpha_n = f32(1.0 - s_n)
            phi1 = f32(np.expm1(-h))                # e^{−h} − 1
            x_next = float(_ratio(s_n, s_i)) * x \
                - float(f32(alpha_n * phi1)) * m    # first order
            if 0 < i < n - 1:                       # midpoint, second order
                r0 = f32(f32(lam[i] - lam[i - 1]) / h)
                d1 = (m - m_prev) / float(r0)
                x_next = x_next - float(f32(f32(0.5 * alpha_n) * phi1)) * d1
            x, m_prev = x_next, m
        return x


@dataclasses.dataclass(frozen=True)
class FlowUniPCSchedule(_FlowSolver):
    """UniPC (solver order 2, bh2, data prediction) predictor-corrector:
    one model call a step; the corrector at step i re-derives the current
    sample from the previous one with the fresh output, at the order of
    step i − 1's predictor."""

    @classmethod
    def create(cls, num_steps: int, shift: float = 5.0,
               num_train_timesteps: int = 1000) -> "FlowUniPCSchedule":
        sigmas = unipc_sigmas(num_steps, shift, num_train_timesteps)
        return cls(sigmas=sigmas,
                   timesteps=sigmas[:-1] * num_train_timesteps,
                   num_train_timesteps=num_train_timesteps)

    @staticmethod
    def _bh2(hh: f32):
        """φ₁ = e^{hh} − 1, B(h) = φ₁ and the bh2 coefficients at degree 2:
        b1 = (φ₁/hh − 1)/B, b2 = 2·((φ₁/hh − 1)/hh − ½)/B."""
        phi1 = f32(np.expm1(hh))
        k1 = f32(f32(phi1 / hh) - f32(1.0))
        b1 = f32(k1 / phi1)
        b2 = f32(f32(2.0) * f32(f32(k1 / hh) - f32(0.5)) / phi1)
        return phi1, phi1, b1, b2

    def sample(self, denoise_fn: DenoiseFn, shape: Sequence[int],
               generator: Optional[torch.Generator],
               x_T: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self._start(shape, generator, x_T)
        sig = self.sigmas.cpu().numpy().astype(f32)
        lam = _lam(sig)
        n = self.num_steps
        order = _order_schedule(n)
        # the corrector at step i uses step i − 1's predictor order
        c_order = np.concatenate([[1], order[:-1]])
        x_last = m_prev = m_prev2 = None
        for i in range(n):
            s_i, s_n = sig[i], sig[i + 1]
            v = denoise_fn(x, self._t(i, shape[0]))
            m = x - float(s_i) * v                  # data prediction

            # corrector (UniC) on the current sample, from x_last
            if i == 0:
                x_corr = x
            else:
                hc = f32(lam[i] - lam[i - 1])
                phi1c, bhc, b1c, b2c = self._bh2(f32(-hc))
                alpha_i = f32(1.0 - s_i)
                xc_base = float(_ratio(s_i, sig[i - 1])) * x_last \
                    - float(f32(alpha_i * phi1c)) * m_prev
                d1_t = m - m_prev
                if c_order[i] == 1:                 # rhos_c = [0.5]
                    x_corr = xc_base \
                        - float(f32(f32(alpha_i * bhc) * f32(0.5))) * d1_t
                else:                               # rks = [r0, 1]
                    r0c = f32(f32(lam[i - 2] - lam[i - 1]) / hc)
                    d1s = (m_prev2 - m_prev) / float(r0c)
                    rho0 = f32(f32(b1c - b2c) / f32(f32(1.0) - r0c))
                    rho1 = f32(b1c - rho0)
                    x_corr = xc_base - float(f32(alpha_i * bhc)) * (
                        float(rho0) * d1s + float(rho1) * d1_t)

            # predictor (UniP) from the corrected sample
            h = f32(lam[i + 1] - lam[i])
            phi1, bh, _, _ = self._bh2(f32(-h))
            alpha_n = f32(1.0 - s_n)
            x_next = float(_ratio(s_n, s_i)) * x_corr \
                - float(f32(alpha_n * phi1)) * m
            if order[i] == 2:                       # rhos_p = [0.5]
                r0p = f32(f32(lam[i - 1] - lam[i]) / h)
                d1p = (m_prev - m) / float(r0p)
                x_next = x_next - float(f32(f32(alpha_n * bh) * f32(0.5))) \
                    * d1p
            x, x_last, m_prev, m_prev2 = x_next, x_corr, m, m_prev
        return x


@register("videotuna_tpu_torch.schedulers.FlowUniPCSchedule",
          aliases=["videotuna.models.wan.wan.utils.fm_solvers_unipc."
                   "FlowUniPCMultistepScheduler"])
def build_unipc(num_steps: int = 50, shift: float = 5.0,
                **_ignored) -> FlowUniPCSchedule:
    return FlowUniPCSchedule.create(num_steps, shift)


@register("videotuna_tpu_torch.schedulers.FlowDPMSolverSchedule",
          aliases=["videotuna.models.wan.wan.utils.fm_solvers."
                   "FlowDPMSolverMultistepScheduler"])
def build_dpm(num_steps: int = 50, shift: float = 5.0,
              **_ignored) -> FlowDPMSolverSchedule:
    return FlowDPMSolverSchedule.create(num_steps, shift)
