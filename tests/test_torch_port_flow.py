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

from tests.test_torch_port_models import (  # noqa: F401
    flax_shapes, flax_tree, torch_one_thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs", "000_tiny", "tiny_cogvideox.yaml")
TINY_T2V = os.path.join(ROOT, "configs", "000_tiny", "tiny_t2v.yaml")
TINY_HUNYUAN = os.path.join(ROOT, "configs", "000_tiny", "tiny_hunyuan.yaml")
OPENSORA_V10 = os.path.join(ROOT, "configs", "003_opensora",
                            "opensorav10_256x256.yaml")
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


def _jax_params(jflow, seed=0, pflow=None):
    """The JAX flow's parameter tree with seeded numpy values (shapes from
    ``init`` under ``eval_shape``, no compile; or read off the port flow
    ``pflow``'s components, ``flax_shapes``, the same tree untraced)."""
    rng = np.random.default_rng(seed)
    ex = jflow.example_inputs()
    params = {}
    for comp in ("denoiser", "first_stage", "cond_stage"):
        module = getattr(jflow, comp)
        shapes = ({"params": flax_tree(flax_shapes(getattr(pflow, comp)))}
                  if pflow is not None else
                  jax.eval_shape(module.init, jax.random.key(0), *ex[comp]))

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
    params = _jax_params(jflow, pflow=pflow)
    load_flow_params(pflow, params)

    inf = jcfg["inference"]
    shape = jflow.latent_shape(1, inf["frames"], inf["height"], inf["width"])
    scale = inf["unconditional_guidance_scale"]
    steps = jflow.scheduler.num_steps
    rng = np.random.default_rng(1)
    x_T = rng.standard_normal(shape, dtype=np.float32)
    noises = rng.standard_normal((steps, *shape), dtype=np.float32)

    # JAX: encode_text → CFG → scheduler.sample(x_T=, noises=) → decode,
    # each under one jit (op by op, every primitive compiles for its shape)
    jcond, juncond = jax.jit(lambda p: (jflow.encode_text(p, [inf["prompt"]]),
                                        jflow.encode_text(p, [""])))(params)
    from videotuna_tpu.schedulers import cfg_denoise, dynamic_cfg_denoise

    def jsample(p, c, u, x, n):
        model_fn = lambda x, t, cc: jflow.denoise_apply(p, x, t, cc)  # noqa
        if jflow.use_dynamic_cfg:
            denoise = dynamic_cfg_denoise(model_fn, c, u, scale, steps,
                                          timesteps=jflow.scheduler.timesteps)
            return jflow.scheduler.sample(denoise, shape, jax.random.key(0),
                                          x_T=x, noises=n)
        return jflow.scheduler.sample(cfg_denoise(model_fn, c, u, scale),
                                      shape, jax.random.key(0), x_T=x)

    jz = jax.jit(jsample)(params, jcond, juncond, jnp.asarray(x_T),
                          jnp.asarray(noises))
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
    (["--lora", "{tmp}/step_4"], "LoRA"),     # a JAX (orbax) LoRA dir
    (["inference.quantize=int8"], "int8"),
    (["inference.mesh.dp=2"], "parallelism"),
    # a JAX (orbax) checkpoint dir: the port reads its own and ckpt_tools'
    (["--ckpt", "{tmp}/step_4"], "checkpoint"),
])
def test_unported_inference_options_raise(argv, what, tmp_path):
    from videotuna_tpu_torch.cli.inference import run_inference
    (tmp_path / "step_4" / "lora").mkdir(parents=True)
    (tmp_path / "step_4" / "denoiser").mkdir()
    argv = [a.format(tmp=tmp_path) for a in argv]
    with pytest.raises(NotImplementedError, match=what):
        run_inference(["--config", TINY, "--device", "cpu", "--quiet",
                       "--savedir", str(tmp_path), *argv])


def test_port_runs_with_jax_blocked(tmp_path):
    """The port imports neither jax, flax nor the JAX package: the tiny
    CogVideoX and Open-Sora flows sample and train (two steps, one of them
    with LoRA), the tiny HunyuanVideo flow samples, the narrow Wan 1.3B
    flow samples through the registry (``flows/wan.py``, ``models/wan``,
    ``schedulers/fm_solvers.py``), and so do the narrow DynamiCrafter and
    Wan I2V flows from an image (``flows/videocrafter.py``,
    ``models/lvdm``), with them blocked, and every module of the port
    imports."""
    import cv2
    from tests.test_torch_port_videocrafter import NARROW_DC
    from tests.test_torch_port_wan import NARROW as WAN_NARROW
    from tests.test_torch_port_wan_i2v import NARROW_I2V
    runs = [(TINY, tmp_path / "cogvideox"), (TINY_T2V, tmp_path / "t2v")]
    hunyuan = tmp_path / "hunyuan"
    wan = tmp_path / "wan"
    inputs = tmp_path / "inputs"
    inputs.mkdir()
    cv2.imwrite(str(inputs / "image.png"), np.random.default_rng(0).integers(
        0, 256, (72, 96, 3), dtype=np.uint8))
    (inputs / "prompts.txt").write_text("a lake\n")
    i2v = [("inference-dc-i2v-576x1024", NARROW_DC, tmp_path / "dc"),
           ("inference-wanvideo-i2v-720p", NARROW_I2V, tmp_path / "wan_i2v")]
    code = (
        "import importlib, pkgutil, sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'videotuna_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import videotuna_tpu_torch\n"
        "for info in pkgutil.walk_packages(videotuna_tpu_torch.__path__, "
        "'videotuna_tpu_torch.'):\n"
        "    importlib.import_module(info.name)\n"
        "from videotuna_tpu_torch.cli.inference import run_inference\n"
        "from videotuna_tpu_torch.cli.train import run_train\n"
        + "".join(f"run_inference(['--config', {cfg!r}, '--device', 'cpu', "
                  f"'--quiet', '--savedir', {str(out)!r}])\n"
                  f"run_train(['--config', {cfg!r}, '--device', 'cpu', "
                  f"'--quiet', '--workdir', {str(out) + '_train'!r}, "
                  f"'--max_steps', '2'{extra}])\n"
                  for (cfg, out), extra in zip(runs, [", 'train.lora.rank=2'",
                                                      ""]))
        + f"run_inference(['--config', {TINY_HUNYUAN!r}, '--device', 'cpu', "
          f"'--quiet', '--savedir', {str(hunyuan)!r}])\n"
        + "from videotuna_tpu_torch.cli.commands import main\n"
        + f"assert main(['inference-wanvideo-t2v-1-3B', '--device', 'cpu', "
          f"'--quiet', '--savedir', {str(wan)!r}, '--prompt', 'a lake', "
          f"*{WAN_NARROW!r}]) == 0\n"
        + "".join(f"assert main([{name!r}, '--device', 'cpu', '--quiet', "
                  f"'--savedir', {str(out)!r}, *{narrow!r}, "
                  f"'inference.input_dir={inputs}']) == 0\n"
                  for name, narrow, out in i2v)
        + "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'videotuna_tpu') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n")
    # one torch thread, as the in-process tests (``torch_one_thread``)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    for _, out in runs:
        assert os.path.isfile(out / "metric.json")
        assert os.path.isfile(f"{out}_train/step_2/state.pt")
    assert os.path.isfile(hunyuan / "metric.json")
    assert os.path.isfile(wan / "metric.json")
    for _, _, out in i2v:
        assert os.path.isfile(out / "metric.json")


_CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "004_cogvideox",
                                         "*.yaml"))
                  + glob.glob(os.path.join(ROOT, "configs",
                                           "005_cogvideox1.5", "*.yaml"))
                  + glob.glob(os.path.join(ROOT, "configs", "000_tiny",
                                           "*.yaml"))
                  + [OPENSORA_V10])


@pytest.mark.parametrize("path", _CONFIGS, ids=os.path.basename)
def test_configs_load_like_jax(path):
    assert pconfig.load_configs([path]) == jconfig.load_configs([path])


@pytest.mark.parametrize("path", [
    p for p in _CONFIGS if "cogvideo" in os.path.basename(p)],
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


def _flow_targets(path):
    flow = pconfig.load_configs([path])["flow"]
    return [flow["target"]] + [
        flow["params"][k]["target"]
        for k in ("denoiser_config", "scheduler_config",
                  "first_stage_config", "cond_stage_config")]


@pytest.mark.parametrize("path", [TINY_T2V, OPENSORA_V10],
                         ids=os.path.basename)
def test_opensora_targets_resolve_to_the_port(path):
    for target in _flow_targets(path):
        obj = pregistry.resolve(target)
        assert obj.__module__.startswith("videotuna_tpu_torch."), target
