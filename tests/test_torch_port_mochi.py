"""The port's Mochi slice against the JAX package on the CPU: the AsymmDiT
(its learned per-head RoPE, the attention pool, the asymmetric joint blocks
and the last block that leaves the text stream) in both parameter layouts
with a ragged caption mask, the Mochi VAE's decoder (narrowed) on a tiny
latent, ``MochiFlow``'s sampling with CFG (the model's output negated), the
two conversion maps, and the registry's ``inference-mochi`` on the CPU.

The JAX module's parameter tree is filled from a seeded numpy generator and
carried across with ``tools/from_jax``; inputs come from numpy too.  f32
throughout; the DiT narrow with heads of d = 128 kept, over 128 video
tokens and 16 caption tokens, so the port's joint attention takes route K4
(the caption mask) through its plain version under the flow's fixed max,
where the JAX package runs its reference attention on the CPU.  Tolerances,
of max|ref|: 1e-4 for modules through a kernel route and for trajectories
(the plain versions and the JAX reference sum in their own orders), 1e-3
for decoded pixels (the VAE's deep conv stacks).
"""

import argparse
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videotuna_tpu.core import config as jconfig
from videotuna_tpu.core import registry as jregistry
from videotuna_tpu.models import mochi_vae as jmochi_vae
from videotuna_tpu.models.mochi.dit import MochiDiT as JMochi
from videotuna_tpu.schedulers import cfg_denoise as jcfg_denoise
from videotuna_tpu.schedulers import flow_match as jflow_match
from videotuna_tpu.tools import convert_weights as jcw
from videotuna_tpu_torch.cli import commands as pcommands
from videotuna_tpu_torch.core import config as pconfig
from videotuna_tpu_torch.core import registry as pregistry
from videotuna_tpu_torch.kernels import attention as PA
from videotuna_tpu_torch.models import mochi_vae as pmochi_vae
from videotuna_tpu_torch.models.mochi.dit import MochiDiT as PMochi
from videotuna_tpu_torch.tools import ckpt_tools
from videotuna_tpu_torch.tools import convert_weights as pcw
from videotuna_tpu_torch.tools.from_jax import load_jax_params

from tests.test_torch_port_convert import (_flat, _trees_equal,
                                           synthetic_state_dict)
from tests.test_torch_port_models import (  # noqa: F401
    flax_shapes, jax_params, torch_one_thread)
from tests.test_torch_port_opensora import _close, _t

KERNEL_MODEL_TOL = 1e-4
TRAJ_TOL = 1e-4
PIXEL_TOL = 1e-3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "010_mochi", "mochi_t2v.yaml")
PROMPT = "a paper boat drifting down a rain gutter"

_D = "flow.params.denoiser_config.params"
_T = "flow.params.cond_stage_config.params"
# the 10B config narrow: the DiT at dim 256 / 64 (2 heads of d = 128), 3
# blocks (two scanned, the last apart), a 1-layer T5 of dim 32 over the
# config's 256 tokens; 7×128×128 gives 2×16×16 latents, 128 video tokens
NARROW = [f"{_D}.dim=256", f"{_D}.dim_y=64", f"{_D}.depth=3",
          f"{_D}.heads=2", f"{_D}.caption_channels=32",
          f"{_D}.dtype=float32", f"{_T}.dim=32", f"{_T}.heads=2",
          f"{_T}.head_dim=16", f"{_T}.ff_dim=64", f"{_T}.num_layers=1",
          "flow.params.scheduler_config.params.num_steps=2",
          "inference.height=128", "inference.width=128",
          "inference.frames=7"]


def _with_fixed_max(fn):
    """``fn`` under both packages' fixed max 0, as the flow runs the DiT."""
    import videotuna_tpu.kernels.attention as JA

    @functools.wraps(fn)
    def run(*a, **kw):
        with JA.attention_options(static_max=0.0), \
                PA.attention_options(static_max=0.0):
            return fn(*a, **kw)
    return run


# ---------------------------------------------------------------- the DiT
@_with_fixed_max
def test_mochi_dit_matches_jax():
    """``MochiDiT`` at dim 256 / 64, 3 blocks, on 2×16×16 latents (128
    tokens after the 2×2 patch) and 16 caption tokens, row 1 keeping 5,
    scanned (the first two blocks stacked; the block-by-block layout loads
    in ``test_mochi_maps_match_jax_and_load_strictly``)."""
    kw = dict(in_channels=12, dim=256, dim_y=64, depth=3, heads=2,
              caption_channels=32, scan_blocks=True)
    rng = np.random.default_rng(1)
    mask = np.ones((2, 16), bool)
    mask[1, 5:] = False
    inputs = [rng.standard_normal((2, 2, 16, 16, 12), dtype=np.float32),
              np.array([20.0, 870.0], np.float32),
              rng.standard_normal((2, 16, 32), dtype=np.float32), mask]
    jmod, pmod = JMochi(**kw), PMochi(**kw)
    params = jax_params(jmod, like=pmod)
    assert "blocks" in params and "block_2" in params
    ref = jax.jit(lambda p, *a: jmod.apply({"params": p}, *a))(
        params, *map(jnp.asarray, inputs))
    load_jax_params(pmod, params)
    with torch.no_grad():
        out = pmod(*map(_t, inputs))
    assert out.shape == (2, 2, 16, 16, 12) and out.dtype == torch.float32
    _close(out, ref, KERNEL_MODEL_TOL)


# ---------------------------------------------------------------- the VAE
@pytest.fixture
def narrow_vae(monkeypatch):
    """The Mochi VAE's widths, module constants in both packages, cut to
    32-96 channels (multiples of its 32 groups) for the test's run; the
    blocks' layout (layers, expansions, attention) stays."""
    for mod in (jmochi_vae, pmochi_vae):
        monkeypatch.setattr(mod, "ENC_CHANNELS", (32, 32, 64, 64))
        monkeypatch.setattr(mod, "DEC_CHANNELS", (32, 64, 64, 96))


def test_mochi_vae_decoder_matches_jax(narrow_vae):
    """The decoder, narrow, on a 2×2×2 latent: (1, 7, 16, 16, 3), through
    the per-channel latent statistics (each up block's linear expansion
    and 3D depth-to-space, the causal trims)."""
    z = np.random.default_rng(2).standard_normal((1, 2, 2, 2, 12),
                                                 dtype=np.float32)
    jmod = jmochi_vae.MochiDecoder3D()
    pmod = pmochi_vae.MochiDecoder3D()
    params = jax_params(jmod, like=pmod)
    ref = jax.jit(lambda p, z: jmochi_vae.MochiVAE().apply(
        {"params": {"decoder": p}}, z,
        method=jmochi_vae.MochiVAE.decode))(params, jnp.asarray(z))
    vae = pmochi_vae.MochiVAE()
    vae.decoder = pmod
    load_jax_params(pmod, params)
    with torch.no_grad():
        out = vae.decode(_t(z))
    assert out.shape == (1, 7, 16, 16, 3)
    _close(out, ref, PIXEL_TOL)


# ---------------------------------------------------------------- flow
@functools.cache
def _flows():
    """Both flows with the DiT's and the T5's seeded weights (the VAE is
    off the sampling path and stays unset), and the JAX flow's
    ``denoise_apply`` under one jit, compiled once for the CFG batch of 2
    over the config's 256 caption tokens (both tests below call it so)."""
    jcfg = jconfig.load_configs([CONFIG], NARROW)
    pcfg = pconfig.load_configs([CONFIG], NARROW)
    jregistry.populate()
    jflow = jregistry.instantiate(jcfg["flow"])
    pflow = pregistry.instantiate(pcfg["flow"], device="cpu")
    params = {}
    for i, c in enumerate(("denoiser", "cond_stage")):
        params[c] = jax_params(getattr(jflow, c), seed=i,
                               like=getattr(pflow, c))
        load_jax_params(getattr(pflow, c), params[c], c)
    jden = jax.jit(lambda x, t, c: jflow.denoise_apply(params, x, t, c))
    return jflow, pflow, params, jcfg["inference"], jden


@_with_fixed_max
def test_mochi_flow_samples_with_cfg_like_jax():
    """The prompt and the empty prompt through T5 (256 tokens, the mask
    into the DiT's pool and joint attention), the same x_T through 2 Euler
    steps with CFG 4.5 and the output negated, under the flow's fixed max
    0; the JAX side steps ``scheduler.step`` on its jitted model call."""
    jflow, pflow, params, inf, jden = _flows()
    assert pflow.attn_static_max == 0.0 and pflow.negate_model_output
    shape = jflow.latent_shape(1, inf["frames"], inf["height"],
                               inf["width"])
    assert shape == (1, 2, 16, 16, 12)
    x_T = np.random.default_rng(3).standard_normal(shape, dtype=np.float32)
    jcond, juncond = (jax.jit(lambda p, s=s: jflow.encode_text(p, [s]))(
        params) for s in (PROMPT, ""))
    denoise = jcfg_denoise(jden, jcond, juncond, 4.5)
    jz = jnp.asarray(x_T)
    for i in range(jflow.scheduler.num_steps):
        t = jnp.full((1,), jflow.scheduler.timesteps[i])
        jz = jflow.scheduler.step(jz, denoise(jz, t), i)
    pcond, puncond = (pflow.encode_text([s]) for s in (PROMPT, ""))
    _close(pcond["y"], jcond["y"], KERNEL_MODEL_TOL)
    pz = pflow.sample(pcond, puncond, shape, None, 4.5, x_T=_t(x_T))
    _close(pz, jz, TRAJ_TOL)


@_with_fixed_max
def test_mochi_training_loss_matches_jax():
    """The flow-matching loss on latents, T5 states over 256 tokens and
    their mask: the JAX flow's loss (its ``training_loss``: x_t = (1 − σ)
    x0 + σ ε, the negated model output against ε − x0, the per-sample
    mean, NaN samples as 0, the batch mean) on its jitted model call, with
    the same σ and noise handed to the port."""
    jflow, pflow, params, _, jden = _flows()
    rng = np.random.default_rng(4)
    z = rng.standard_normal((2, 2, 16, 16, 12), dtype=np.float32)
    text = rng.standard_normal((2, 256, 32), dtype=np.float32)
    mask = np.zeros((2, 256), bool)
    mask[0, :9], mask[1, :30] = True, True
    sigma = rng.uniform(size=2).astype(np.float32)
    noise = rng.standard_normal(z.shape, dtype=np.float32)
    x_t = jflow_match.flow_interpolate(jnp.asarray(z), jnp.asarray(noise),
                                       jnp.asarray(sigma))
    v = jden(x_t, jnp.asarray(sigma) * 1000.0,
             {"y": jnp.asarray(text), "mask": jnp.asarray(mask)})
    per = np.mean(np.asarray(v - jflow_match.flow_target(z, noise)) ** 2,
                  axis=(1, 2, 3, 4))
    jloss = np.mean(np.where(np.isnan(per), 0.0, per))
    with torch.no_grad():
        loss, aux = pflow.training_loss(
            {"latents": _t(z), "text_states": _t(text),
             "text_mask": _t(mask)}, sigma=_t(sigma), noise=_t(noise))
    assert set(aux) == {"loss", "sigma_mean"}
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(float(aux["sigma_mean"]), sigma.mean(),
                               rtol=1e-6)


# ---------------------------------------------------------------- maps
@pytest.mark.parametrize("family", ["mochi", "mochi_vae"])
def test_mochi_maps_match_jax_and_load_strictly(family, narrow_vae):
    """Each map's synthetic upstream state dict (the map's own rules over
    the module's leaves: the narrow DiT block by block, the narrow VAE)
    gives the JAX converter's tree exactly, through the
    port's converter and ``ckpt_tools``' family map, and loads strictly;
    the DiT's tree also into the scanned layout."""
    comp, extra = {"mochi": ("denoiser", [f"{_D}.scan_blocks=false"]),
                   "mochi_vae": ("first_stage", [])}[family]
    pcfg = pconfig.load_configs([CONFIG], NARROW + extra)
    module = ckpt_tools.build_component(pcfg, comp)
    params = dict(pcfg["flow"]["params"][f"{comp}_config"]["params"] or {})
    build = {"mochi": (lambda: jcw.mochi_map(heads=2),
                       lambda: pcw.mochi_map(heads=2)),
             "mochi_vae": (jmochi_vae.mochi_vae_map,
                           pmochi_vae.mochi_vae_map)}[family]
    shapes = flax_shapes(module)
    sd = synthetic_state_dict(build[0](), shapes)
    jtree = build[0]().convert(sd, strict=True)
    ptree = build[1]().convert(sd, strict=True)
    _trees_equal(ptree, jtree)
    assert {p: tuple(np.shape(v)) for p, v in _flat(ptree)} == shapes
    args = argparse.Namespace(heads=None, kv_heads=None)
    _trees_equal(ckpt_tools.FAMILIES[family][0](args, params).convert(sd),
                 ptree)
    load_jax_params(module, ptree, comp)
    if family == "mochi":
        scanned = ckpt_tools.build_component(
            pconfig.load_configs([CONFIG], NARROW), comp)
        assert scanned.scan_blocks
        load_jax_params(scanned, ptree, comp)


# ---------------------------------------------------------------- command
def test_mochi_command_runs_the_port_on_cpu(tmp_path, narrow_vae):
    """``inference-mochi`` through the registry, narrowed (the VAE too), on
    the CPU: the 2 latent frames sampled, the first decoded, an mp4 and
    metric.json."""
    assert "inference-mochi" not in pcommands.WAITING
    out = tmp_path / "out"
    assert pcommands.main(["inference-mochi", "--device", "cpu", "--quiet",
                           "--savedir", str(out), "--prompt", PROMPT,
                           *NARROW, "inference.height=32",
                           "inference.width=32",
                           "inference.decode_latent_frames=1"]) == 0
    metrics = json.loads((out / "metric.json").read_text())
    assert metrics["latent_shape"] == [1, 2, 4, 4, 12]
    assert metrics["decoded_latent_shape"] == [1, 1, 4, 4, 12]
    assert metrics["nonfinite_pixels"] == 0
