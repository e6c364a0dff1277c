"""The port's CogVideoX slice end to end against the JAX package, plus its
config, registry, CLI and import boundary.

``tiny_cogvideox.yaml`` with both schedulers: the JAX flow's parameter tree
(seeded numpy values) is carried into the port with ``tools/from_jax``; the
prompt is encoded by both, and the same x_T and per-step noise go through
JAX ``encode_text`` → CFG → ``scheduler.sample(x_T=, noises=)`` →
``decode_latents`` and the port's ``sample`` → ``decode_latents``.  f32;
latents atol 1e-4·max|ref| (a whole trajectory), pixels 1e-3·max|ref|."""

import glob
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videotuna_tpu.core import config as jconfig
from videotuna_tpu.core import registry as jregistry
from videotuna_tpu_torch.core import config as pconfig
from videotuna_tpu_torch.core import registry as pregistry
from videotuna_tpu_torch.tools.from_jax import load_flow_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs", "000_tiny", "tiny_cogvideox.yaml")
TRAJ_TOL = 1e-4
PIXEL_TOL = 1e-3

_DPM = [
    "flow.params.scheduler_config.target="
    "videotuna_tpu.schedulers.CogVideoXDPMSchedule",
    "flow.params.scheduler_config.params.num_steps=4",
    "flow.params.use_dynamic_cfg=true",
]


def _close(out, ref, tol):
    out = np.asarray(out.detach().float() if isinstance(out, torch.Tensor)
                     else out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=tol * float(np.abs(ref).max()))


def _jax_params(jflow, seed=0):
    """The JAX flow's parameter tree with seeded numpy values (shapes from
    ``init`` under ``eval_shape``, no compile)."""
    rng = np.random.default_rng(seed)
    ex = jflow.example_inputs()
    params = {}
    for comp in ("denoiser", "first_stage", "cond_stage"):
        module = getattr(jflow, comp)
        shapes = jax.eval_shape(module.init, jax.random.key(0), *ex[comp])

        def fill(path, leaf):
            name = str(path[-1].key)
            x = rng.standard_normal(leaf.shape).astype(np.float32)
            if name == "kernel":
                fan_in = leaf.shape[0] if len(leaf.shape) == 3 \
                    else int(np.prod(leaf.shape[:-1]))
                return x / np.sqrt(fan_in)
            return 1.0 + 0.1 * x if name == "scale" else 0.1 * x

        params[comp] = jax.tree_util.tree_map_with_path(fill,
                                                        shapes["params"])
    return params


@pytest.mark.parametrize("overrides", [[], _DPM], ids=["ddim", "dpm"])
def test_tiny_cogvideox_end_to_end_matches_jax(overrides):
    jcfg = jconfig.load_configs([TINY], overrides)
    pcfg = pconfig.load_configs([TINY], overrides)
    jregistry.populate()
    jflow = jregistry.instantiate(jcfg["flow"])
    pflow = pregistry.instantiate(pcfg["flow"], device="cpu")
    params = _jax_params(jflow)
    load_flow_params(pflow, params)

    inf = jcfg["inference"]
    shape = jflow.latent_shape(1, inf["frames"], inf["height"], inf["width"])
    scale = inf["unconditional_guidance_scale"]
    steps = jflow.scheduler.num_steps
    rng = np.random.default_rng(1)
    x_T = rng.standard_normal(shape, dtype=np.float32)
    noises = rng.standard_normal((steps, *shape), dtype=np.float32)

    # JAX: encode_text → CFG → scheduler.sample(x_T=, noises=) → decode
    jcond = jflow.encode_text(params, [inf["prompt"]])
    juncond = jflow.encode_text(params, [""])
    model_fn = lambda x, t, c: jflow.denoise_apply(params, x, t, c)  # noqa
    from videotuna_tpu.schedulers import cfg_denoise, dynamic_cfg_denoise
    if jflow.use_dynamic_cfg:
        denoise = dynamic_cfg_denoise(model_fn, jcond, juncond, scale, steps,
                                      timesteps=jflow.scheduler.timesteps)
        jz = jflow.scheduler.sample(denoise, shape, jax.random.key(0),
                                    x_T=jnp.asarray(x_T),
                                    noises=jnp.asarray(noises))
    else:
        denoise = cfg_denoise(model_fn, jcond, juncond, scale)
        jz = jflow.scheduler.sample(denoise, shape, jax.random.key(0),
                                    x_T=jnp.asarray(x_T))
    jvideo = jax.jit(jflow.decode_latents)(params, jz)

    pcond = pflow.encode_text([inf["prompt"]])
    puncond = pflow.encode_text([""])
    _close(pcond["y"], jcond["y"], 1e-5)
    pz = pflow.sample(pcond, puncond, shape, None, scale,
                      x_T=torch.from_numpy(x_T),
                      noises=(torch.from_numpy(noises)
                              if pflow.use_dynamic_cfg else None))
    _close(pz, jz, TRAJ_TOL)
    _close(pflow.decode_latents(pz), jvideo, PIXEL_TOL)


def test_run_inference_writes_video_and_metrics(tmp_path):
    from videotuna_tpu_torch.cli.inference import run_inference
    out = run_inference(["--config", TINY, "--device", "cpu", "--quiet",
                         "--savedir", str(tmp_path)])
    assert len(out["videos"]) == 1 and os.path.isfile(out["videos"][0])
    metrics = json.loads((tmp_path / "metric.json").read_text())
    assert metrics["num_videos"] == 1 and metrics["denoise_steps"] == 4
    assert metrics["nonfinite_latents"] == 0 == metrics["nonfinite_pixels"]


def test_run_inference_needs_cuda_unless_cpu_is_asked_for(tmp_path):
    from videotuna_tpu_torch.cli.inference import run_inference
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_inference(["--config", TINY, "--quiet", "--savedir",
                       str(tmp_path)])


@pytest.mark.parametrize("argv,what", [
    (["--lora", "x"], "LoRA"),
    (["inference.quantize=int8"], "int8"),
    (["inference.mesh.dp=2"], "parallelism"),
    (["--ckpt", "x"], "checkpoint"),
])
def test_unported_inference_options_raise(argv, what, tmp_path):
    from videotuna_tpu_torch.cli.inference import run_inference
    with pytest.raises(NotImplementedError, match=what):
        run_inference(["--config", TINY, "--device", "cpu", "--quiet",
                       "--savedir", str(tmp_path), *argv])


def test_port_runs_with_jax_blocked(tmp_path):
    """The port imports neither jax, flax nor the JAX package."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'videotuna_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from videotuna_tpu_torch.cli.inference import run_inference\n"
        f"run_inference(['--config', {TINY!r}, '--device', 'cpu', "
        f"'--quiet', '--savedir', {str(tmp_path)!r}])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'videotuna_tpu') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert os.path.isfile(tmp_path / "metric.json")


_CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "004_cogvideox",
                                         "*.yaml"))
                  + glob.glob(os.path.join(ROOT, "configs", "000_tiny",
                                           "*.yaml")))


@pytest.mark.parametrize("path", _CONFIGS, ids=os.path.basename)
def test_configs_load_like_jax(path):
    assert pconfig.load_configs([path]) == jconfig.load_configs([path])


@pytest.mark.parametrize("path", [
    p for p in _CONFIGS
    if "i2v" not in p and ("cogvideo" in os.path.basename(p))],
    ids=os.path.basename)
def test_cogvideox_targets_resolve_to_the_port(path):
    cfg = pconfig.load_configs([path])
    flow = cfg["flow"]["params"]
    targets = [cfg["flow"]["target"]] + [
        flow[k]["target"] for k in ("denoiser_config", "scheduler_config",
                                    "first_stage_config", "cond_stage_config")
        if k in flow]
    for target in targets:
        obj = pregistry.resolve(target)
        assert obj.__module__.startswith("videotuna_tpu_torch."), target
