"""The port's Open-Sora 1.2 slice against the JAX package: STDiT3 and the
paired STDiT8 layout with the fps conditioning, and ``OpenSoraFlow``'s
rectified-flow branch (``FlowMatchSchedule``): CFG sampling from a given
x_T, and the velocity loss with its gradients at given sigmas and noise.

The JAX module's parameter tree is filled from a seeded numpy generator
(``jax_params``, read off the port's module: with ``dynamic_pos_embed`` it
holds ``fps_embedder``, which the JAX module makes only when its init is
given fps) and carried across with ``tools/from_jax``.  f32 throughout, on
the math path (the JAX package's reference attention on the CPU).
Tolerances, of max|ref|: 1e-5 for a module, 1e-4 for a sampled trajectory,
the loss and each gradient."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videotuna_tpu.core import config as jconfig
from videotuna_tpu.core import registry as jregistry
from videotuna_tpu.models.opensora.stdit import STDiT as JSTDiT
from videotuna_tpu.schedulers import cfg_denoise
from videotuna_tpu.schedulers import flow_match as jfm
from videotuna_tpu_torch.core import config as pconfig
from videotuna_tpu_torch.core import registry as pregistry
from videotuna_tpu_torch.models.opensora.stdit import STDiT as PSTDiT
from videotuna_tpu_torch.tools.from_jax import (load_flow_params,
                                                load_jax_params)

from tests.test_torch_port_models import (  # noqa: F401
    jax_params, torch_one_thread)
from tests.test_torch_port_opensora import _close, _stdit_inputs, _t

MODULE_TOL = 1e-5
TOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OS12 = os.path.join(ROOT, "configs", "003_opensora",
                    "opensorav12_stdit3_720p.yaml")
OS12_PAIRED = os.path.join(ROOT, "configs", "003_opensora",
                           "opensorav12_stdit8_paired.yaml")

_D = "flow.params.denoiser_config.params"
_C = "flow.params.cond_stage_config.params"
# the 720p config narrowed: STDiT3 at hidden 64 (2 heads), depth 2, a
# one-layer T5 of dim 32 over 16 tokens, the 2D VAE at ch 32, 3 steps
NARROW = [f"{_D}.hidden_size=64", f"{_D}.num_heads=2", f"{_D}.depth=2",
          f"{_D}.caption_channels=32", f"{_D}.dtype=float32",
          f"{_C}.dim=32", f"{_C}.heads=2", f"{_C}.head_dim=16",
          f"{_C}.ff_dim=64", f"{_C}.num_layers=1",
          "flow.params.model_max_length=16",
          "flow.params.first_stage_config.params.ch=32",
          "flow.params.first_stage_config.params.num_res_blocks=1",
          "flow.params.scheduler_config.params.num_steps=3"]


@pytest.mark.parametrize("name,flags,with_x_mask", [
    ("stdit3", dict(qk_norm=True, temporal_rope=True, scan_blocks=True,
                    pred_sigma=False), False),
    ("stdit8_paired", dict(paired_blocks=True, qk_norm=True,
                           temporal_rope=True, pred_sigma=False), True)])
def test_stdit_fps_conditioning_matches_jax(name, flags, with_x_mask):
    """Open-Sora 1.2's STDiT3 (scanned) and STDiT8 (paired, with the frame
    mask) under ``dynamic_pos_embed`` with fps: the fps embedding joins the
    timestep's and the masked frames' t0 embedding (without fps the
    output differs; ``test_torch_port_opensora``'s dynamic_pos_embed
    variant holds that call to JAX)."""
    cfg = dict(input_size=(4, 8, 8), hidden_size=32, depth=2, num_heads=2,
               caption_channels=16, dynamic_pos_embed=True, **flags)
    x, ts, y, mask = _stdit_inputs(1, 2, 4, 8, 16, 8, 5)
    fps = np.array([24.0, 8.0], np.float32)
    x_mask = np.array([[True, False, True, True], [False] * 2 + [True] * 2])
    kw = {"x_mask": x_mask} if with_x_mask else {}
    jm, pm = JSTDiT(**cfg), PSTDiT(**cfg)
    params = jax_params(jm, like=pm)
    assert "fps_embedder" in params
    load_jax_params(pm, params)
    ref = jax.jit(lambda p, *a, **k: jm.apply({"params": p}, *a, **k))(
        params, *map(jnp.asarray, (x, ts, y, mask)), fps=jnp.asarray(fps),
        **{k: jnp.asarray(v) for k, v in kw.items()})
    pkw = {k: _t(v) for k, v in kw.items()}
    with torch.no_grad():
        out = pm(_t(x), _t(ts), _t(y), _t(mask), fps=_t(fps), **pkw)
        plain = pm(_t(x), _t(ts), _t(y), _t(mask), **pkw)
    _close(out, ref)
    assert not torch.allclose(out, plain, atol=1e-3)


@functools.cache
def _flows(config):
    """(JAX flow, port flow, seeded parameters) of the narrowed config,
    once a module."""
    jcfg = jconfig.load_configs([config], NARROW)
    jregistry.populate()
    jflow = jregistry.instantiate(jcfg["flow"])
    pflow = pregistry.instantiate(
        pconfig.load_configs([config], NARROW)["flow"], device="cpu")
    ex = jflow.example_inputs()
    params = {c: jax_params(getattr(jflow, c), *ex[c], seed=i,
                            like=getattr(pflow, c))
              for i, c in enumerate(("denoiser", "first_stage",
                                     "cond_stage"))}
    load_flow_params(pflow, params)
    return jflow, pflow, params


def test_opensora_12_flow_match_branch_builds_and_samples():
    """The FlowMatch branch of ``OpenSoraFlow`` builds (no diffusion
    chain) and samples from the generator's own x_T: 3 Euler steps with
    CFG on the paired flow, finite latents of the asked shape."""
    _, pflow, _ = _flows(OS12_PAIRED)
    assert pflow.base_schedule is None and pflow.scheduler.num_steps == 3
    z = pflow.sample(pflow.encode_text(["a lake"]), pflow.encode_text([""]),
                     pflow.latent_shape(1, 2, 64, 64),
                     torch.Generator().manual_seed(0), 7.0)
    assert z.shape == (1, 2, 8, 8, 4) and torch.isfinite(z).all()


@pytest.mark.parametrize("config", [OS12, OS12_PAIRED],
                         ids=["stdit3", "stdit8_paired"])
def test_rectified_flow_samples_like_jax(config):
    """The prompt and the empty prompt through T5, the same x_T through the
    3 Euler steps of the rectified flow with CFG 7 (one doubled call a
    step, t = 1000·σ), then the 2D VAE; the flow builds no diffusion
    chain."""
    jflow, pflow, params = _flows(config)
    assert pflow.base_schedule is None is jflow.base_schedule
    assert type(pflow.scheduler).__name__ == "FlowMatchSchedule"
    shape = jflow.latent_shape(1, 2, 64, 64)
    x_T = np.random.default_rng(1).standard_normal(shape, dtype=np.float32)
    prompt = ["a koi pond at dusk"]
    jcond, juncond = jax.jit(lambda p: (jflow.encode_text(p, prompt),
                                        jflow.encode_text(p, [""])))(params)
    denoise = cfg_denoise(lambda x, t, c: jflow.denoise_apply(params, x, t, c),
                          jcond, juncond, 7.0)
    jz = jax.jit(lambda x: jflow.scheduler.sample(
        denoise, shape, jax.random.key(0), x_T=x))(jnp.asarray(x_T))
    pz = pflow.sample(pflow.encode_text(prompt), pflow.encode_text([""]),
                      shape, None, 7.0, x_T=_t(x_T))
    _close(pz, jz, TOL)
    video = pflow.decode_latents(pz)
    assert video.shape == (1, 2, 64, 64, 3) and torch.isfinite(video).all()


def test_rectified_flow_loss_and_grads_match_jax():
    """The rectified-flow loss on given latents and text states, σ (uniform)
    and ε the JAX key's draws handed to the port: the velocity MSE, its
    aux, and every gradient of the STDiT3."""
    jflow, pflow, params = _flows(OS12)
    rng = np.random.default_rng(7)
    z = rng.standard_normal((2, 2, 8, 8, 4), dtype=np.float32)
    text = rng.standard_normal((2, 16, 32), dtype=np.float32)
    tmask = np.ones((2, 16), bool)
    tmask[1, 6:] = False
    key = jax.random.key(11)
    _, k_t, k_noise = jax.random.split(key, 3)
    sigma = jfm.sample_sigmas(k_t, 2, "uniform")
    noise = jax.random.normal(k_noise, z.shape)
    jbatch = {"latents": jnp.asarray(z), "text_states": jnp.asarray(text),
              "text_mask": jnp.asarray(tmask)}

    def jloss(den):
        return jflow.training_loss(dict(params, denoiser=den), jbatch, key)

    (jl, jaux), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params["denoiser"])
    pflow.denoiser.requires_grad_(True)
    pflow.denoiser.train()
    try:
        pl, aux = pflow.training_loss(
            {"latents": _t(z), "text_states": _t(text),
             "text_mask": _t(tmask)},
            sigma=_t(np.asarray(sigma)), noise=_t(np.asarray(noise)))
        pl.backward()
    finally:
        pflow.denoiser.requires_grad_(False)
        pflow.denoiser.eval()
    assert aux["loss"] is pl
    np.testing.assert_allclose(float(pl.detach()), float(jl), rtol=TOL)
    np.testing.assert_allclose(float(aux["t_mean"]), float(jaux["t_mean"]),
                               rtol=1e-6)
    ref = pregistry.instantiate(
        pconfig.load_configs([OS12], NARROW)["flow"]["params"]
        ["denoiser_config"])
    load_jax_params(ref, jax.device_get(jg))
    gmax = max(float(r.detach().abs().max()) for r in ref.parameters())
    for name, p in pflow.denoiser.named_parameters():
        r = ref.get_parameter(name).detach()
        torch.testing.assert_close(
            p.grad, r, rtol=0, atol=TOL * float(r.abs().max()) + 1e-7 * gmax,
            msg=name)
        p.grad = None
