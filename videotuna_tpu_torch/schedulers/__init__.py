"""Schedulers of the port: the DDPM/LDM buffers, DDIM with CFG wrappers, and
the CogVideoX SDE-DPM++(2M) and trailing DDIM samplers."""

from videotuna_tpu_torch.schedulers.common import (extract_into,
                                                   make_beta_schedule,
                                                   make_ddim_timesteps,
                                                   rescale_noise_cfg,
                                                   rescale_zero_terminal_snr)
from videotuna_tpu_torch.schedulers.ddpm import DDPMSchedule
from videotuna_tpu_torch.schedulers.cogvideox_dpm import (
    CogVideoXDPMSchedule, build_cogvideox_ddim)
from videotuna_tpu_torch.schedulers.ddim import (DDIMSchedule, cfg_denoise,
                                                 dynamic_cfg_denoise)

__all__ = [
    "DDPMSchedule", "DDIMSchedule", "CogVideoXDPMSchedule",
    "build_cogvideox_ddim", "cfg_denoise", "dynamic_cfg_denoise",
    "extract_into", "make_beta_schedule", "make_ddim_timesteps",
    "rescale_noise_cfg", "rescale_zero_terminal_snr",
]
