"""Flow-matching schedules (torch), the counterpart of
``videotuna_tpu/schedulers/flow_match.py``: the discrete Euler sampler over a
shifted sigma schedule (HunyuanVideo, StepVideo) and the training-side sigma
draw, interpolation and velocity target.

Sigmas descend from 1 to 0 over ``num_steps + 1`` entries, shifted by
σ' = shift·σ / (1 + (shift − 1)·σ); the model predicts v = ε − x0 at
t = σ·1000 and each Euler step adds (σ_{i+1} − σ_i)·v.  Every draw comes from
an explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence, Union

import torch

from videotuna_tpu_torch.core.registry import register
from videotuna_tpu_torch.schedulers.common import randn
from videotuna_tpu_torch.schedulers.ddpm import _move

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def shift_sigmas(sigmas: torch.Tensor, shift: float) -> torch.Tensor:
    return shift * sigmas / (1.0 + (shift - 1.0) * sigmas)


@dataclasses.dataclass(frozen=True)
class FlowMatchSchedule:
    """Discrete flow-matching schedule: ``sigmas`` (S+1,) f32 and
    ``timesteps`` = σ[:-1]·``num_train_timesteps`` (S,)."""
    sigmas: torch.Tensor
    timesteps: torch.Tensor
    num_train_timesteps: int = 1000
    reverse: bool = True

    @classmethod
    def create(cls, num_steps: int, shift: float = 7.0,
               num_train_timesteps: int = 1000,
               reverse: bool = True) -> "FlowMatchSchedule":
        sigmas = torch.linspace(1.0, 0.0, num_steps + 1)
        if shift != 1.0:
            sigmas = shift_sigmas(sigmas, shift)
        if not reverse:
            sigmas = sigmas.flip(0)
        return cls(sigmas=sigmas, timesteps=sigmas[:-1] * num_train_timesteps,
                   num_train_timesteps=num_train_timesteps, reverse=reverse)

    def to(self, device: Union[str, torch.device]) -> "FlowMatchSchedule":
        return _move(self, device)

    @property
    def num_steps(self) -> int:
        return self.timesteps.shape[0]

    def step(self, x: torch.Tensor, v: torch.Tensor, i: int) -> torch.Tensor:
        """Euler update x + (σ_{i+1} − σ_i)·v; on the descending schedule
        with v = ε − x0 it integrates to x0."""
        return x + v * (self.sigmas[i + 1] - self.sigmas[i])

    def sample(self, denoise_fn: DenoiseFn, shape: Sequence[int],
               generator: Optional[torch.Generator],
               x_T: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Every step in order from x_T (drawn from ``generator`` unless
        given); one model call per step, at t = timesteps[i] (f32)."""
        dev = self.sigmas.device
        x = randn(shape, generator, dev) if x_T is None else x_T
        for i in range(self.num_steps):
            t = self.timesteps[i].expand(shape[0])
            x = self.step(x, denoise_fn(x, t), i)
        return x


# ---------------------------------------------------------------------------
# Training-side helpers
# ---------------------------------------------------------------------------

def sample_sigmas(generator: torch.Generator, batch: int,
                  weighting_scheme: str = "logit_normal",
                  logit_mean: float = 0.0, logit_std: float = 1.0,
                  device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """Training sigmas (batch,) in (0, 1): logit-normal, uniform or the SD3
    "mode" density, drawn from ``generator``."""
    if weighting_scheme == "logit_normal":
        u = randn((batch,), generator, device) * logit_std + logit_mean
        return torch.sigmoid(u)
    if weighting_scheme in ("uniform", "mode"):
        if generator is None:
            raise ValueError("drawing sigmas needs a torch.Generator")
        u = torch.rand((batch,), generator=generator, device=device)
        if weighting_scheme == "uniform":
            return u
        return 1.0 - u - 1.29 * (torch.cos(math.pi * u / 2) ** 2 - 1 + u)
    raise ValueError(weighting_scheme)


def flow_interpolate(x0: torch.Tensor, noise: torch.Tensor,
                     sigma: torch.Tensor) -> torch.Tensor:
    """x_t = (1 − σ)·x0 + σ·ε, σ (B,) broadcast over the rest."""
    s = sigma.reshape(-1, *([1] * (x0.ndim - 1)))
    return (1.0 - s) * x0 + s * noise


def flow_target(x0: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """The velocity target v = ε − x0."""
    return noise - x0


@register("videotuna_tpu_torch.schedulers.FlowMatchSchedule",
          aliases=[
              "videotuna.models.hunyuan.hyvideo_i2v.diffusion.schedulers."
              "scheduling_flow_match_discrete.FlowMatchDiscreteScheduler",
              "diffusers.FlowMatchEulerDiscreteScheduler",
          ])
def build_flow_match(num_steps: int = 50, shift: float = 7.0,
                     num_train_timesteps: int = 1000, reverse: bool = True,
                     **_ignored) -> FlowMatchSchedule:
    return FlowMatchSchedule.create(num_steps, shift, num_train_timesteps,
                                    reverse)
