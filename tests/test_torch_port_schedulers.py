"""Port schedulers against the JAX package: the DDPM buffers and
parameterisations, and whole DDIM / CogVideoX-DDIM / CogVideoX-DPM
trajectories with replayed x_T and per-step noise through the same toy
denoiser in both frameworks.  f32 on both sides; elementwise maths atol
1e-5·max|ref|; schedule buffers and trajectories 1e-4·max|ref| (the two
frameworks take the f32 cumprod in another order, 1−ᾱ cancels near t=0,
and errors compound over steps)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videotuna_tpu.schedulers as JS
import videotuna_tpu.schedulers.cogvideox_dpm as JD
import videotuna_tpu_torch.schedulers as PS
import videotuna_tpu_torch.schedulers.cogvideox_dpm as PD
from videotuna_tpu_torch.schedulers.ddim import build_ddim

from tests.test_torch_port_models import torch_one_thread  # noqa: F401

BUFFER_TOL = 1e-5
SCHEDULE_TOL = 1e-4
TRAJ_TOL = 1e-4

_SCHEDULES = {
    "linear": dict(timesteps=100, beta_schedule="linear"),
    "cosine": dict(timesteps=50, beta_schedule="cosine"),
    "zero_snr_v": dict(timesteps=100, beta_schedule="scaled_linear",
                       parameterization="v", rescale_betas_zero_snr=True),
    "cogvideox": dict(timesteps=1000, beta_schedule="scaled_linear",
                      linear_start=0.00085, linear_end=0.012,
                      parameterization="v", rescale_betas_zero_snr=True,
                      snr_shift_scale=3.0),
}


def _close(out, ref, tol):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    finite = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(out), finite)
    np.testing.assert_allclose(out[finite], ref[finite], rtol=0,
                               atol=tol * float(np.abs(ref[finite]).max()))


@pytest.mark.parametrize("name", list(_SCHEDULES))
def test_ddpm_buffers_match(name):
    kw = _SCHEDULES[name]
    ref = JS.DDPMSchedule.create(**kw)
    out = PS.DDPMSchedule.create(**kw)
    for field in ("betas", "alphas_cumprod", "alphas_cumprod_prev",
                  "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
                  "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
                  "posterior_variance", "posterior_log_variance_clipped",
                  "posterior_mean_coef1", "posterior_mean_coef2"):
        _close(getattr(out, field), getattr(ref, field), SCHEDULE_TOL)


@pytest.mark.parametrize("param", ["eps", "x0", "v"])
def test_q_sample_get_v_and_parameterisations(param):
    kw = dict(_SCHEDULES["zero_snr_v"], parameterization=param)
    ref, out = JS.DDPMSchedule.create(**kw), PS.DDPMSchedule.create(**kw)
    rng = np.random.default_rng(0)
    x, n, m = (rng.standard_normal((3, 2, 4, 4, 2), dtype=np.float32)
               for _ in range(3))
    t = np.array([0, 50, 98], np.int32)
    tt = torch.from_numpy(t)
    j = [jnp.asarray(a) for a in (x, n, m)]
    p = [torch.from_numpy(a) for a in (x, n, m)]
    _close(out.q_sample(p[0], tt, p[1]), ref.q_sample(j[0], t, j[1]),
           BUFFER_TOL)
    _close(out.get_v(p[0], p[1], tt), ref.get_v(j[0], j[1], t), BUFFER_TOL)
    for got, want in zip(out.to_x0_and_eps(p[0], tt, p[2]),
                         ref.to_x0_and_eps(j[0], t, j[2])):
        _close(got, want, BUFFER_TOL)


def _toy_denoisers():
    """The same smooth t-dependent model in jnp and torch."""
    def jfn(x, t):
        s = (t.astype(jnp.float32) / 1000.0).reshape(-1, 1, 1, 1, 1)
        return 0.5 * jnp.tanh(x) + s * x

    def pfn(x, t):
        s = (t.float() / 1000.0).reshape(-1, 1, 1, 1, 1)
        return 0.5 * torch.tanh(x) + s * x
    return jfn, pfn


def _latents(steps=0, seed=1):
    rng = np.random.default_rng(seed)
    x_T = rng.standard_normal((2, 3, 4, 4, 4), dtype=np.float32)
    noises = rng.standard_normal((steps, *x_T.shape), dtype=np.float32)
    return x_T, noises


def test_ddim_trajectory_matches():
    import jax
    kw = dict(_SCHEDULES["zero_snr_v"], num_steps=7)
    jfn, pfn = _toy_denoisers()
    x_T, _ = _latents()
    ref = JS.ddim.build_ddim(**kw).sample(jfn, x_T.shape, jax.random.key(0),
                                          x_T=jnp.asarray(x_T))
    out = build_ddim(**kw).sample(pfn, x_T.shape, None,
                                  x_T=torch.from_numpy(x_T))
    _close(out, ref, TRAJ_TOL)


def test_cogvideox_ddim_trajectory_matches():
    import jax
    base_kw = _SCHEDULES["cogvideox"]
    jfn, pfn = _toy_denoisers()
    x_T, _ = _latents()
    ref = JS.build_cogvideox_ddim(JS.DDPMSchedule.create(**base_kw), 5) \
        .sample(jfn, x_T.shape, jax.random.key(0), x_T=jnp.asarray(x_T))
    out = PS.build_cogvideox_ddim(PS.DDPMSchedule.create(**base_kw), 5) \
        .sample(pfn, x_T.shape, None, x_T=torch.from_numpy(x_T))
    _close(out, ref, TRAJ_TOL)


@pytest.mark.parametrize("steps", [3, 8])
def test_cogvideox_dpm_trajectory_matches(steps):
    """3 steps: first-order, one 2M and the final step; 8: a long 2M run."""
    import jax
    jfn, pfn = _toy_denoisers()
    x_T, noises = _latents(steps)
    ref = JD.build_cogvideox_dpm(num_steps=steps).sample(
        jfn, x_T.shape, jax.random.key(0), x_T=jnp.asarray(x_T),
        noises=jnp.asarray(noises))
    out = PD.build_cogvideox_dpm(num_steps=steps).sample(
        pfn, x_T.shape, None, x_T=torch.from_numpy(x_T),
        noises=torch.from_numpy(noises))
    _close(out, ref, TRAJ_TOL)


@pytest.mark.parametrize("dynamic", [False, True])
def test_cfg_wrappers_match(dynamic):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 2, 4, 4, 2), dtype=np.float32)
    cond = rng.standard_normal((1, 3, 2), dtype=np.float32)
    uncond = rng.standard_normal((1, 3, 2), dtype=np.float32)

    def jmodel(x, t, c):
        return x * c["y"].mean(axis=(1, 2)).reshape(-1, 1, 1, 1, 1) \
            + t.reshape(-1, 1, 1, 1, 1) / 1000.0

    def pmodel(x, t, c):
        return x * c["y"].mean(dim=(1, 2)).reshape(-1, 1, 1, 1, 1) \
            + t.reshape(-1, 1, 1, 1, 1) / 1000.0

    sched = PD.build_cogvideox_dpm(num_steps=5)
    for i in range(5):
        t = np.array([int(sched.timesteps[i])], np.int32)
        jc, ju = {"y": jnp.asarray(cond)}, {"y": jnp.asarray(uncond)}
        pc, pu = {"y": torch.from_numpy(cond)}, {"y": torch.from_numpy(uncond)}
        if dynamic:
            jf = JS.dynamic_cfg_denoise(jmodel, jc, ju, 6.0, 5,
                                        timesteps=jnp.asarray(
                                            sched.timesteps.numpy()))
            pf = PS.dynamic_cfg_denoise(pmodel, pc, pu, 6.0, 5,
                                        timesteps=sched.timesteps)
        else:
            jf = JS.cfg_denoise(jmodel, jc, ju, 6.0, guidance_rescale=0.7)
            pf = PS.cfg_denoise(pmodel, pc, pu, 6.0, guidance_rescale=0.7)
        _close(pf(torch.from_numpy(x), torch.from_numpy(t)),
               jf(jnp.asarray(x), jnp.asarray(t)), BUFFER_TOL)
