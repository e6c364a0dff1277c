"""The port's w8a8 int8 serving (``tools/int8.py``, ``GenerationFlow.
quantize_int8``, ``inference.quantize: int8``) against the JAX package.

The product on the same numpy inputs within 1e-5 relative; the quantized
leaves of the tiny STDiT equal to ``quantize_params_int8``'s (carried into a
quantized port module by ``tools/from_jax``), bar quotients within an ulp
of a .5 tie; ``tiny_t2v.yaml`` quantized, then 2 DDIM steps with CFG from
the same x_T and numpy conditions, within 1e-4·max of the JAX flow sampled
under its int8 interceptor; the residency below 0.45× of f32.

The reference fault of ROADMAP.md queue 3: the JAX continuous engine steps
an int8 flow outside ``flow._attn_scope()``, where the interceptor is not
armed, and fails; the port's engine enters the scope, and matches the JAX
engine stepped inside it (the test enters the scope; the JAX package is not
changed)."""

import copy
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
from videotuna_tpu.serving import ContinuousBatchEngine as JEngine
from videotuna_tpu.tools import int8 as J8
from videotuna_tpu_torch.core import config as pconfig
from videotuna_tpu_torch.core import registry as pregistry
from videotuna_tpu_torch.models.opensora.stdit import STDiT as PSTDiT
from videotuna_tpu_torch.serving import ContinuousBatchEngine as PEngine
from videotuna_tpu_torch.tools import int8 as P8
from videotuna_tpu_torch.tools.from_jax import (load_flow_params,
                                                load_jax_params)

from tests.test_torch_port_models import (  # noqa: F401
    jax_params, torch_one_thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_T2V = os.path.join(ROOT, "configs", "000_tiny", "tiny_t2v.yaml")
MATMUL_TOL = 1e-5
TRAJ_TOL = 1e-4
STEPS = ["flow.params.ddim_steps=2"]
CFG = 2.0


def _close(out, ref, tol):
    out = np.asarray(out.detach().float() if isinstance(out, torch.Tensor)
                     else out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=tol * float(np.abs(ref).max()))


@pytest.mark.parametrize("lead,din,n", [((64,), 256, 128),
                                        ((2, 5), 32, 48)])
def test_int8_matmul_matches_jax(lead, din, n):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(lead + (din,)).astype(np.float32)
    w = (rng.standard_normal((din, n)) * 0.05).astype(np.float32)
    wq, ws = jax.jit(J8._quantize_leaf, static_argnums=1)(jnp.asarray(w),
                                                         False)
    ref = np.asarray(jax.jit(J8.int8_matmul)(jnp.asarray(x), wq, ws))
    out = P8.int8_matmul(torch.from_numpy(x),
                         torch.from_numpy(np.array(wq)),
                         torch.from_numpy(np.array(ws))).numpy()
    assert out.shape == ref.shape
    rel = np.linalg.norm(out - ref) / np.linalg.norm(ref)
    assert rel <= MATMUL_TOL, rel
    # and the w8a8 product is close to the f32 one
    assert np.linalg.norm(out - x @ w) / np.linalg.norm(x @ w) < 2e-2


def _ties(w: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """Where the quotient w/scale (f32, per output channel) lies within an
    ulp of a .5 tie, where two correct roundings may differ."""
    q = w.astype(np.float32) / scale.astype(np.float32)
    frac = np.abs(np.abs(q) - np.floor(np.abs(q)) - 0.5)
    return frac <= np.spacing(np.abs(q).astype(np.float32))


@pytest.mark.parametrize("scan", [False, True], ids=["blocks", "scan"])
def test_quantized_leaves_equal_jax_and_load(scan):
    """The port's ``quantize_int8`` of the tiny STDiT against
    ``quantize_params_int8`` of the same f32 tree: the JAX tree is loaded
    into a copy of the quantized port module (strict: every kernel_q and
    kernel_scale must map, the scanned stack per depth), and every buffer
    must equal the port's own but for ties."""
    cfg = dict(input_size=(4, 8, 8), hidden_size=32, depth=2, num_heads=2,
               caption_channels=16, scan_blocks=scan)
    pm = PSTDiT(**cfg)
    params = jax_params(JSTDiT(**cfg), like=pm)
    load_jax_params(pm, params)
    weights = {n: m.weight.detach().numpy().T for n, m in pm.named_modules()
               if isinstance(m, torch.nn.Linear)}
    P8.quantize_int8(pm)
    qtree = jax.jit(J8.quantize_params_int8)(params)
    loaded = copy.deepcopy(pm)
    load_jax_params(loaded, jax.device_get(qtree))
    n_q, ties = 0, 0
    for name, m in pm.named_modules():
        if not isinstance(m, P8.Int8Linear):
            continue
        other = loaded.get_submodule(name)
        np.testing.assert_array_equal(m.kernel_scale.numpy(),
                                      other.kernel_scale.numpy())
        diff = m.kernel_q.numpy() != other.kernel_q.numpy()
        tie = _ties(weights[name], m.kernel_scale.numpy())
        assert not (diff & ~tie).any(), name
        ties += int(diff.sum())
        n_q += 1
    # every projection of the module is matched, none tied
    assert n_q == len(weights) and ties == 0


@functools.cache
def _tiny_flows():
    """``tiny_t2v.yaml`` at 2 DDIM steps in both packages with the same
    seeded weights, each quantized by its own ``quantize_int8``, and the
    f32 denoiser's bytes of the port."""
    jcfg = jconfig.load_configs([TINY_T2V], STEPS)
    jregistry.populate()
    jflow = jregistry.instantiate(jcfg["flow"])
    pflow = pregistry.instantiate(
        pconfig.load_configs([TINY_T2V], STEPS)["flow"], device="cpu")
    ex = jflow.example_inputs()
    params = {c: jax_params(getattr(jflow, c), *ex[c], seed=i,
                            like=getattr(pflow, c))
              for i, c in enumerate(("denoiser", "first_stage",
                                     "cond_stage"))}
    load_flow_params(pflow, params)
    f32_bytes = P8.tree_bytes(pflow.denoiser)
    # the JAX flow's quantize_int8 (its pure tree map, under one jit: op by
    # op it compiles every leaf's ops for their shapes)
    jflow.params = dict(params, denoiser=jax.jit(J8.quantize_params_int8)(
        params["denoiser"]))
    jflow._int8 = True
    pflow.quantize_int8()
    return jflow, pflow, f32_bytes


def _requests(n, shape):
    """(x_T, cond, uncond) of ``n`` requests from a seeded numpy generator:
    8 caption tokens of width 16, the first few valid."""
    rng = np.random.default_rng(7)
    out = []
    for i in range(n):
        x = rng.standard_normal(shape, dtype=np.float32)
        conds = []
        for valid in (3 + i, 8):
            mask = np.zeros((1, 8), bool)
            mask[0, :valid] = True
            conds.append({"y": rng.standard_normal((1, 8, 16),
                                                   dtype=np.float32),
                          "mask": mask})
        out.append((x, *conds))
    return out


def _as(pkg, req):
    x, c, u = req
    if pkg == "jax":
        return (jnp.asarray(x), jax.tree.map(jnp.asarray, c),
                jax.tree.map(jnp.asarray, u))
    return (torch.from_numpy(x),
            *({k: torch.from_numpy(v) for k, v in d.items()} for d in (c, u)))


def test_tiny_flow_int8_samples_match_jax():
    from videotuna_tpu.schedulers import cfg_denoise
    jflow, pflow, f32_bytes = _tiny_flows()
    shape = jflow.latent_shape(1, 4, 64, 64)
    req = _requests(1, shape)[0]
    x, c, u = _as("jax", req)
    # the CFG call under one jit, traced once inside the flow's scope (the
    # interceptor acts at trace time) and run by the eager DDIM loop
    denoise = jax.jit(cfg_denoise(
        lambda xx, t, cc: jflow.denoise_apply(jflow.params, xx, t, cc),
        c, u, CFG))
    with jflow._attn_scope():
        ref = jflow.scheduler.sample(denoise, shape, jax.random.key(0),
                                     x_T=x)
    x, c, u = _as("torch", req)
    out = pflow.sample(c, u, shape, None, CFG, x_T=x)
    _close(out, ref, TRAJ_TOL)
    assert P8.tree_bytes(pflow.denoiser) < 0.45 * f32_bytes


def test_w8a8_denoiser_close_to_f32():
    """A quantized port STDiT within 0.05 relative of its f32 self (the
    JAX package's gate, tests/test_int8.py)."""
    cfg = dict(input_size=(2, 8, 8), hidden_size=64, depth=2, num_heads=2,
               caption_channels=16)
    pm = PSTDiT(**cfg)
    load_jax_params(pm, jax_params(JSTDiT(**cfg), like=pm))
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 2, 8, 8, 4),
                                             dtype=np.float32))
    y = torch.from_numpy(rng.standard_normal((2, 8, 16), dtype=np.float32))
    t = torch.tensor([10, 700])
    with torch.inference_mode():
        ref = pm(x, t, y)
        out = P8.quantize_int8(pm)(x, t, y)
    rel = (torch.linalg.norm(out - ref) / torch.linalg.norm(ref)).item()
    assert rel < 0.05, rel


def test_jax_engine_int8_fault_and_the_port_engine():
    """The JAX engine's step outside ``_attn_scope`` raises on the int8
    flow (queue 3); stepped inside the scope it runs, and the port's
    engine (which enters the scope itself) matches it, for two requests,
    the second boarding after one step."""
    from flax.errors import ScopeParamNotFoundError
    jflow, pflow, _ = _tiny_flows()
    kw = dict(slots=2, frames=4, height=64, width=64, cfg_scale=CFG)
    jeng, peng = JEngine(jflow, **kw), PEngine(pflow, **kw)
    reqs = _requests(2, jflow.latent_shape(1, 4, 64, 64))
    assert jeng.submit(*_as("jax", reqs[0])) == 0
    with pytest.raises(ScopeParamNotFoundError, match="t_embedder/fc1"):
        jeng.step()
    assert peng.submit(*_as("torch", reqs[0])) == 0
    got = {"jax": {}, "torch": {}}
    for step in range(6):
        if step == 1:
            assert jeng.submit(*_as("jax", reqs[1])) == 1
            assert peng.submit(*_as("torch", reqs[1])) == 1
        with jflow._attn_scope():
            jeng.step()
        peng.step()
        for pkg, eng in (("jax", jeng), ("torch", peng)):
            got[pkg].update(eng.poll_completed())
    assert sorted(got["jax"]) == sorted(got["torch"]) == [0, 1]
    for s in (0, 1):
        _close(got["torch"][s], got["jax"][s], TRAJ_TOL)


def test_run_inference_int8_samples(tmp_path):
    """``inference.quantize=int8`` samples through the CLI (it raised
    before the quantization slice)."""
    from videotuna_tpu_torch.cli.inference import run_inference
    out = run_inference(["--config", TINY_T2V, "--device", "cpu", "--quiet",
                         "--savedir", str(tmp_path), *STEPS,
                         "inference.quantize=int8"])
    assert len(out["videos"]) == 1 and os.path.isfile(out["videos"][0])
    assert out["metrics"]["nonfinite_latents"] == 0
