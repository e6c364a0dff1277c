"""The port's Flux slice against the JAX package on the CPU: ``FluxModel``
in both parameter layouts (dev with guidance and pooled text, schnell
without guidance, and a narrower head width with the derived RoPE split),
``flux_shift_for_resolution``, the latent packing, ``FluxFlow``'s text
encode, sampling and decode, its rectified-flow loss and gradients on given
latents, ``flux_map`` behind the fused-qkv split, the three Flux inference
commands on the CPU, and queue 3's Flux-training fault in both packages.

The harness of ROADMAP.md ("Parity harness"): JAX trees filled from a
seeded numpy generator (``jax_params(..., like=port_module)``), carried
across with ``tools/from_jax``; inputs and noise from numpy or from the JAX
package's own keys.  f32 throughout; the JAX side runs its reference
attention on the CPU (as its own Flux tests do), the port its kernels'
plain versions.  Tolerances, of max|ref|: 1e-4 for the DiT, the trajectory
and the gradients, 1e-3 for decoded pixels; 1e-6 for the schedule."""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videotuna_tpu.flows import flux as jflux
from videotuna_tpu.models.flux.dit import FluxModel as JFlux
from videotuna_tpu.schedulers import flow_match as jfm
from videotuna_tpu_torch.cli import commands as pcommands
from videotuna_tpu_torch.core import config as pconfig
from videotuna_tpu_torch.core import registry as pregistry
from videotuna_tpu_torch.flows import flux as pflux
from videotuna_tpu_torch.models.flux.dit import FluxModel as PFlux
from videotuna_tpu_torch.tools import ckpt_tools
from videotuna_tpu_torch.tools import convert_weights as pcw
from videotuna_tpu_torch.tools.from_jax import (load_flow_params,
                                                load_jax_params)

from tests.test_torch_port_models import (  # noqa: F401
    jax_params, torch_one_thread)
from tests.test_torch_port_opensora import _close, _t

TOL = 1e-4
PIXEL_TOL = 1e-3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLUX_CONFIGS = [os.path.join(ROOT, "configs", "006_flux", f)
                for f in ("flux_dev.yaml", "flux_schnell.yaml",
                          "flux_lora.yaml")]

# a narrow Flux: 2 heads of d = 128 (BFL's rope axes (16, 56, 56)), one
# double and one single block, a one-layer T5 and CLIP, the 2D VAE at ch 8
TINY_DIT = dict(in_channels=64, dim=256, heads=2, double_blocks=1,
                single_blocks=1, text_dim=24, pooled_dim=12,
                guidance_embed=True)
FLUX_TINY = dict(
    denoiser_config={"target": "videotuna_tpu.models.flux.FluxModel",
                     "params": TINY_DIT},
    scheduler_config={"target": "videotuna_tpu.schedulers.FlowMatchSchedule",
                      "params": dict(num_steps=2, shift=1.0,
                                     num_train_timesteps=1)},
    first_stage_config={"target": "videotuna_tpu.models.AutoencoderKL2D",
                        "params": dict(ch=8, ch_mult=(1, 2, 2, 2),
                                       num_res_blocks=1, z_channels=16,
                                       embed_dim=16)},
    cond_stage_config={"target": "videotuna_tpu.models.T5Encoder",
                       "params": dict(vocab_size=30002, dim=24, heads=2,
                                      head_dim=8, ff_dim=48, num_layers=1)},
    cond_stage_2_config={"target": "videotuna_tpu.models.CLIPTextEncoder",
                         "params": dict(vocab_size=30002, dim=12, heads=2,
                                        num_layers=1, max_len=8)},
    model_max_length=6, num_inference_steps=2)
PROMPT = "a castle on a hill at dawn"


# ---------------------------------------------------------------- the DiT
def _dit_inputs(seed=0, hw=(4, 8), text=6):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, *hw, 64), dtype=np.float32),
            np.array([0.3, 0.9], np.float32),
            rng.standard_normal((2, text, 24), dtype=np.float32),
            rng.standard_normal((2, 12), dtype=np.float32),
            np.array([3.5, 2.0], np.float32))


@pytest.mark.parametrize("dim,scan,dev", [(256, False, True),
                                          (256, True, False),
                                          (128, False, True)],
                         ids=["d128_blocks_dev", "d128_scan_schnell",
                              "d64_derived_rope"])
def test_flux_model_matches_jax(dim, scan, dev):
    """Dev takes the pooled vector and the embedded guidance; schnell
    (``guidance_embed`` off) gets the guidance too and ignores it, as in the
    JAX package.  At d = 64 the RoPE split is derived, (8, 28, 28)."""
    cfg = dict(TINY_DIT, dim=dim, guidance_embed=dev, scan_blocks=scan,
               single_blocks=2)
    jm, pm = JFlux(**cfg), PFlux(**cfg)
    params = jax_params(jm, like=pm)
    assert ("double_blocks" in params) == scan
    assert ("guidance_in" in params) == dev
    assert pm.rope_dims == ((16, 56, 56) if dim == 256 else (8, 28, 28))
    args = _dit_inputs()
    ref = jax.jit(lambda p, *a: jm.apply({"params": p}, *a))(
        params, *map(jnp.asarray, args))
    load_jax_params(pm, params)
    with torch.no_grad():
        out = pm(*map(_t, args))
    assert out.dtype == torch.float32
    _close(out, ref, TOL)


def test_flux_final_proj_is_zero_initialised():
    from videotuna_tpu_torch.models.layers import init_weights_
    pm = PFlux(**TINY_DIT)
    init_weights_(pm, torch.Generator().manual_seed(0))
    assert pm.final_proj.weight.abs().max() == 0
    assert pm.img_in.weight.abs().max() > 0
    with torch.no_grad():
        assert pm(*map(_t, _dit_inputs())).abs().max() == 0


# ---------------------------------------------------------------- schedule
def test_shift_and_latent_packing_match_jax():
    for tokens in (16, 256, 1024, 4080, 4096, 5000):
        assert pflux.flux_shift_for_resolution(tokens) == pytest.approx(
            jflux.flux_shift_for_resolution(tokens), rel=1e-12)
    jflow = jflux.FluxFlow.__new__(jflux.FluxFlow)
    zp = np.random.default_rng(1).standard_normal((2, 3, 5, 64),
                                                  dtype=np.float32)
    z = pflux.FluxFlow.unpack_latents(_t(zp))
    assert z.shape == (2, 1, 6, 10, 16)
    np.testing.assert_array_equal(
        z.numpy(), np.asarray(jflow.unpack_latents(jnp.asarray(zp))))
    np.testing.assert_array_equal(pflux.FluxFlow.pack_latents(z).numpy(), zp)


# ---------------------------------------------------------------- flow
@functools.cache
def _jax_flow():
    jflow = jflux.FluxFlow(**FLUX_TINY, schnell=False)
    pflow = pflux.FluxFlow(**FLUX_TINY, schnell=False, device="cpu")
    ex = jflow.example_inputs()
    params = {c: jax_params(getattr(jflow, c), *ex[c], seed=i,
                            like=getattr(pflow, c))
              for i, c in enumerate(("denoiser", "first_stage", "cond_stage",
                                     "cond_stage_2"))}
    return jflow, params


def _flows(**kw):
    jflow, params = _jax_flow()
    pflow = pflux.FluxFlow(**dict(FLUX_TINY, **kw), device="cpu")
    load_flow_params(pflow, params)
    return jflow, pflow, params


def test_flux_flow_samples_and_decodes_like_jax():
    """The prompt through T5 and CLIP (pooled at the last valid token), the
    JAX key's x_T through 2 shifted Euler steps with the embedded guidance,
    then the unpack and the 2D VAE's decode."""
    jflow, pflow, params = _flows()
    assert pflow.scheduler.num_steps == 2
    shape = pflow.latent_shape(1, 1, 64, 64)
    assert shape == jflow.latent_shape(1, 1, 64, 64) == (1, 4, 4, 64)
    key = jax.random.key(3)
    jcond = jax.jit(lambda p: jflow.encode_text(p, [PROMPT]))(params)
    jz = jax.jit(lambda p, c: jflow.sample(p, c, None, shape, key))(params,
                                                                    jcond)
    jvideo = jax.jit(jflow.decode_latents)(params, jz)

    pcond = pflow.encode_text([PROMPT])
    _close(pcond["y"], jcond["y"], TOL)
    _close(pcond["pooled"], jcond["pooled"], TOL)
    x_T = _t(np.asarray(jax.random.normal(key, shape)))
    pz = pflow.sample(pcond, None, shape, None, 1.0, x_T=x_T)
    _close(pz, jz, TOL)
    video = pflow.decode_latents(pz)
    assert video.shape == (1, 1, 64, 64, 3)
    _close(video, jvideo, PIXEL_TOL)


def test_flux_training_loss_and_grads_match_jax():
    """The loss on given packed latents, text states and the pooled vector,
    σ and ε the JAX key's draws handed to the port; the loss and every
    gradient of the DiT."""
    jflow, pflow, params = _flows()
    rng = np.random.default_rng(7)
    z = rng.standard_normal((2, 4, 4, 64), dtype=np.float32)
    text = rng.standard_normal((2, 6, 24), dtype=np.float32)
    pooled = rng.standard_normal((2, 12), dtype=np.float32)
    key = jax.random.key(11)
    k_sig, k_noise = jax.random.split(key)
    sigma = jfm.sample_sigmas(k_sig, 2, "logit_normal")
    noise = jax.random.normal(k_noise, z.shape)
    jbatch = {"latents": jnp.asarray(z), "text_states": jnp.asarray(text),
              "pooled_text": jnp.asarray(pooled)}

    def jloss(den):
        return jflow.training_loss(dict(params, denoiser=den), jbatch, key)

    (jl, _), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params["denoiser"])
    pflow.denoiser.requires_grad_(True)
    pl, aux = pflow.training_loss(
        {"latents": _t(z), "text_states": _t(text), "pooled_text": _t(pooled)},
        sigma=_t(np.asarray(sigma)), noise=_t(np.asarray(noise)))
    pl.backward()
    assert aux["loss"] is pl
    np.testing.assert_allclose(float(pl.detach()), float(jl), rtol=1e-5)
    ref = PFlux(**TINY_DIT)
    load_jax_params(ref, jax.device_get(jg))
    gmax = max(float(r.detach().abs().max()) for r in ref.parameters())
    for name, p in pflow.denoiser.named_parameters():
        r = ref.get_parameter(name).detach()
        torch.testing.assert_close(
            p.grad, r, rtol=0, atol=TOL * float(r.abs().max()) + 1e-7 * gmax,
            msg=name)


def test_flux_training_fault_of_queue_3(capsys):
    """A dataset batch (video and caption states, no packed latents): the
    JAX loss fails on the missing key, which no JAX dataset or trainer
    fills; the port raises naming queue 3, and train-flux-lora waits on
    it."""
    jflow, pflow, params = _flows()
    video = np.zeros((1, 1, 64, 64, 3), np.float32)
    text = np.zeros((1, 6, 24), np.float32)
    with pytest.raises(KeyError, match="latents"):
        jflow.training_loss(params, {"video": jnp.asarray(video),
                                     "text_states": jnp.asarray(text)},
                            jax.random.key(0))
    with pytest.raises(ValueError, match="queue 3"):
        pflow.training_loss({"video": _t(video), "text_states": _t(text)},
                            torch.Generator().manual_seed(0))
    assert pcommands.main(["train-flux-lora", "--device", "cpu"]) == 2
    assert "queue 3" in capsys.readouterr().err


# ---------------------------------------------------------------- weights
def test_flux_map_behind_the_fused_qkv_split():
    """A synthetic BFL state dict with each double block's q, k and v fused
    into ``(img|txt)_attn.qkv`` (and its biases): ckpt_tools' flux family
    splits them and maps the dict onto the tree that the JAX package's map
    gives from the split dict."""
    import argparse

    from tests.test_torch_port_convert import _case, _trees_equal
    _, params, _, sd, jtree = _case("flux")
    fused = dict(sd)
    for name in [k for k in sd if ".img_attn.q." in k or ".txt_attn.q." in k]:
        qkv = [fused.pop(name.replace(".q.", f".{p}.")) for p in "qkv"]
        fused[name.replace(".q.", ".qkv.")] = np.concatenate(qkv, axis=0)
    assert not any(".img_attn.k." in k for k in fused)
    make, preprocess = ckpt_tools.FAMILIES["flux"]
    tree = make(argparse.Namespace(heads=None, kv_heads=None),
                params).convert(preprocess(fused), strict=True)
    _trees_equal(tree, jtree)
    _trees_equal(pcw.flux_map(heads=2).convert(sd, strict=True), jtree)


# ---------------------------------------------------------------- commands
_D = "flow.params.denoiser_config.params"
_T = "flow.params.cond_stage_config.params"
_C = "flow.params.cond_stage_2_config.params"
NARROW = [f"{_D}.dim=256", f"{_D}.heads=2", f"{_D}.double_blocks=1",
          f"{_D}.single_blocks=1", f"{_D}.text_dim=32", f"{_D}.pooled_dim=32",
          f"{_T}.dim=32", f"{_T}.heads=2", f"{_T}.head_dim=16",
          f"{_T}.ff_dim=64", f"{_T}.num_layers=1", f"{_C}.dim=32",
          f"{_C}.heads=2", f"{_C}.num_layers=1",
          "flow.params.first_stage_config.params.ch=32",
          "flow.params.first_stage_config.params.num_res_blocks=1",
          "flow.params.model_max_length=32",
          "flow.params.num_inference_steps=2", "inference.height=64",
          "inference.width=64"]


@pytest.mark.parametrize("name,steps", [("inference-flux-dev", 2),
                                        ("inference-flux-schnell", 4),
                                        ("inference-flux-lora", 2)])
def test_flux_commands_run_the_port(name, steps, tmp_path):
    """Each command through the registry on the CPU, narrowed by
    overrides: one 64×64 image (4×4 packed latents), every step, finite."""
    assert name not in pcommands.WAITING
    out = tmp_path / name
    assert pcommands.main([name, "--device", "cpu", "--quiet", "--savedir",
                           str(out), *NARROW]) == 0
    m = json.loads((out / "metric.json").read_text())
    assert m["num_videos"] == 1 and m["denoise_steps"] == steps
    assert m["latent_shape"] == [1, 4, 4, 64]
    assert m["nonfinite_latents"] == 0 == m["nonfinite_pixels"]


@pytest.mark.parametrize("path", FLUX_CONFIGS, ids=os.path.basename)
def test_flux_configs_load_and_resolve_to_the_port(path):
    from videotuna_tpu.core import config as jconfig
    from videotuna_tpu.core import registry as jregistry
    assert pconfig.load_configs([path]) == jconfig.load_configs([path])
    flow = pconfig.load_configs([path])["flow"]
    for target in [flow["target"]] + [
            flow["params"][k]["target"] for k in (
                "denoiser_config", "scheduler_config", "first_stage_config",
                "cond_stage_config", "cond_stage_2_config")]:
        obj = pregistry.resolve(target)
        assert obj.__module__.startswith("videotuna_tpu_torch."), target
        assert jregistry.resolve(target).__name__ == obj.__name__, target
