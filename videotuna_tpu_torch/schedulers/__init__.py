"""Schedulers of the port: the DDPM/LDM buffers, DDIM with CFG wrappers, the
CogVideoX SDE-DPM++(2M) and trailing DDIM samplers, IDDPM spaced sampling
with learned variance, the flow-matching Euler sampler, Wan's flow-matching
UniPC and DPM-Solver++ multistep solvers and the EDM (sgm) sampler
family."""

from videotuna_tpu_torch.schedulers.common import (extract_into,
                                                   make_beta_schedule,
                                                   make_ddim_timesteps,
                                                   rescale_noise_cfg,
                                                   rescale_zero_terminal_snr)
from videotuna_tpu_torch.schedulers.ddpm import DDPMSchedule
from videotuna_tpu_torch.schedulers.cogvideox_dpm import (
    CogVideoXDPMSchedule, build_cogvideox_ddim)
from videotuna_tpu_torch.schedulers.ddim import (DDIMSchedule, cfg_denoise,
                                                 dynamic_cfg_denoise,
                                                 multicond_cfg_denoise)
from videotuna_tpu_torch.schedulers.edm import EDMSamplerFamily
from videotuna_tpu_torch.schedulers.flow_match import (FlowMatchSchedule,
                                                       flow_interpolate,
                                                       flow_target,
                                                       sample_sigmas,
                                                       shift_sigmas)
from videotuna_tpu_torch.schedulers.fm_solvers import (FlowDPMSolverSchedule,
                                                       FlowUniPCSchedule)
from videotuna_tpu_torch.schedulers.iddpm import (SpacedSchedule,
                                                  space_timesteps)

__all__ = [
    "DDPMSchedule", "DDIMSchedule", "CogVideoXDPMSchedule", "SpacedSchedule",
    "FlowMatchSchedule", "FlowUniPCSchedule", "FlowDPMSolverSchedule",
    "EDMSamplerFamily",
    "space_timesteps", "flow_interpolate", "flow_target",
    "sample_sigmas", "shift_sigmas",
    "build_cogvideox_ddim", "cfg_denoise", "dynamic_cfg_denoise",
    "multicond_cfg_denoise",
    "extract_into", "make_beta_schedule", "make_ddim_timesteps",
    "rescale_noise_cfg", "rescale_zero_terminal_snr",
]
