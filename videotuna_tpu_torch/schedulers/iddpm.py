"""IDDPM spaced diffusion with learned variance (torch), Open-Sora's sampler:
the counterpart of ``videotuna_tpu/schedulers/iddpm.py``.

A trained T-step chain is respaced to S steps (``space_timesteps``); the
model emits 2·C channels, eps and a variance fraction v, and the posterior
log-variance is interpolated between log β̃_t and log β_t.  Sampling is the
ancestral loop over the spaced chain, with the noise drawn from an explicit
generator or given as ``noises``.  ``vb_loss_term`` is the hybrid loss's
vb term, which trains the variance half.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from videotuna_tpu_torch.core.registry import register
from videotuna_tpu_torch.schedulers.common import extract_into, randn
from videotuna_tpu_torch.schedulers.ddpm import DDPMSchedule, _move

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def space_timesteps(num_timesteps: int,
                    section_counts: Union[str, Sequence[int]]) -> List[int]:
    """Timesteps of the T-step chain kept by the respacing: "100" → 100
    evenly spaced steps; "ddim50" → a DDIM-style stride; [10, 10, 10] →
    per-section counts."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired:
                    return list(range(0, num_timesteps, i))
            raise ValueError(f"cannot create exactly {desired} ddim steps")
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps: List[int] = []
    for i, count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < count:
            raise ValueError(f"cannot divide section of {size} into {count}")
        stride = 1 if count <= 1 else (size - 1) / (count - 1)
        cur = 0.0
        for _ in range(count):
            all_steps.append(start_idx + round(cur))
            cur += stride
        start_idx += size
    return sorted(set(all_steps))


def p_mean_variance(sched: DDPMSchedule, model_out: torch.Tensor,
                    x: torch.Tensor, t: torch.Tensor):
    """Split a 2·C model output into eps and the variance fraction v; the
    log-variance is v' log β + (1 − v') log β̃ with v' = (v + 1)/2, and the
    mean is the posterior mean at the clipped x0 predicted from eps."""
    c = x.shape[-1]
    eps, var_v = model_out[..., :c], model_out[..., c:]
    nd = x.ndim
    min_log = extract_into(sched.posterior_log_variance_clipped, t, nd)
    max_log = torch.log(extract_into(sched.betas, t, nd))
    frac = (var_v + 1.0) / 2.0
    log_var = frac * max_log + (1.0 - frac) * min_log
    x0 = sched.predict_start_from_noise(x, t, eps).clamp(-1.0, 1.0)
    mean, _, _ = sched.q_posterior(x0, x, t)
    return mean, log_var


def vb_loss_term(sched: DDPMSchedule, model_out: torch.Tensor,
                 x_start: torch.Tensor, x_t: torch.Tensor,
                 t: torch.Tensor) -> torch.Tensor:
    """KL(q(x_{t−1} | x_t, x_0) ‖ p(x_{t−1} | x_t)) in bits, per sample: the
    vb term of IDDPM's hybrid loss.  The eps half is detached, so only the
    learned variance trains through it."""
    c = x_start.shape[-1]
    frozen = torch.cat([model_out[..., :c].detach(), model_out[..., c:]],
                       dim=-1)
    mean, log_var = p_mean_variance(sched, frozen, x_t, t)
    true_mean, _, true_log_var = sched.q_posterior(x_start, x_t, t)
    kl = 0.5 * (-1.0 + log_var - true_log_var
                + torch.exp(true_log_var - log_var)
                + (true_mean - mean) ** 2 * torch.exp(-log_var))
    return kl.mean(dim=tuple(range(1, x_start.ndim))) / math.log(2.0)


@dataclasses.dataclass(frozen=True)
class SpacedSchedule:
    """Respaced DDPM with learned-variance sampling."""
    base: DDPMSchedule                     # rebuilt over the spaced betas
    timestep_map: torch.Tensor             # (S,) spaced index → original t
    full: Optional[DDPMSchedule] = None    # the unrespaced training chain

    @classmethod
    def create(cls, timesteps: int = 1000,
               section_counts: Union[str, Sequence[int]] = "100",
               beta_schedule: str = "linear",
               linear_start: float = 1e-4, linear_end: float = 2e-2,
               parameterization: str = "eps") -> "SpacedSchedule":
        full = DDPMSchedule.create(timesteps, beta_schedule, linear_start,
                                   linear_end,
                                   parameterization=parameterization)
        use = set(space_timesteps(timesteps, section_counts))
        last_alpha = 1.0
        new_betas = []
        for i, ac in enumerate(full.alphas_cumprod.numpy()):
            if i in use:
                new_betas.append(1.0 - ac / last_alpha)
                last_alpha = ac
        spaced = DDPMSchedule.create(
            given_betas=torch.as_tensor(np.asarray(new_betas, np.float32)),
            timesteps=len(new_betas), parameterization=parameterization)
        return cls(base=spaced,
                   timestep_map=torch.as_tensor(sorted(use),
                                                dtype=torch.int64),
                   full=full)

    def to(self, device: Union[str, torch.device]) -> "SpacedSchedule":
        return _move(self, device)

    @property
    def num_steps(self) -> int:
        return self.timestep_map.shape[0]

    def p_mean_variance(self, model_out: torch.Tensor, x: torch.Tensor,
                        t: torch.Tensor):
        return p_mean_variance(self.base, model_out, x, t)

    def sample(self, denoise_fn: DenoiseFn, shape: Sequence[int],
               generator: Optional[torch.Generator],
               x_T: Optional[torch.Tensor] = None,
               noises: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Ancestral loop over the spaced chain, index S−1 down to 0.
        ``denoise_fn`` gets the original timesteps (through
        ``timestep_map``) and returns 2·C channels.  ``x_T`` and ``noises``
        (S, *shape), in loop order, replace the draws from ``generator``;
        the last step (t = 0) adds no noise."""
        dev = self.timestep_map.device
        x = randn(shape, generator, dev) if x_T is None else x_T
        n = self.num_steps
        for j, i in enumerate(range(n - 1, -1, -1)):
            t = torch.full((x.shape[0],), i, dtype=torch.int64, device=dev)
            t_orig = torch.full((x.shape[0],), int(self.timestep_map[i]),
                                dtype=torch.int64, device=dev)
            mean, log_var = self.p_mean_variance(denoise_fn(x, t_orig), x, t)
            if i == 0:
                x = mean
                continue
            noise = randn(x.shape, generator, dev) if noises is None \
                else noises[j]
            x = mean + torch.exp(0.5 * log_var) * noise.to(mean.dtype)
        return x

    def vb_loss_term(self, model_out, x_start, x_t, t):
        """Hybrid-loss vb term against the respaced chain."""
        return vb_loss_term(self.base, model_out, x_start, x_t, t)


@register("videotuna_tpu_torch.schedulers.SpacedSchedule",
          aliases=["videotuna.models.opensora.models.iddpm3d.IDDPMScheduler",
                   "videotuna.models.opensora.models.iddpm3d.SpacedDiffusion"])
def build_spaced(**kwargs) -> SpacedSchedule:
    allowed = {"timesteps", "section_counts", "beta_schedule",
               "linear_start", "linear_end", "parameterization"}
    return SpacedSchedule.create(**{k: v for k, v in kwargs.items()
                                    if k in allowed})
