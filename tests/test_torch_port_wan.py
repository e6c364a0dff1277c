"""The port's Wan 2.1 T2V slice against the JAX package: Wan's RoPE split,
``WanModel`` in both parameter layouts (and its I2V image branch), the Wan
VAE (encode, the whole-sequence decode and the streamed decode), the
flow-matching UniPC and DPM-Solver++ solvers, and a narrow flow end to end
(CFG with the default negative prompt, the training loss, the registry's
``inference-wanvideo-t2v-1-3B`` on the CPU).

The JAX module's parameter tree is filled from a seeded numpy generator and
carried across with ``tools/from_jax``; inputs come from numpy too.  f32
throughout.  Where the JAX side reaches a Pallas kernel it runs in interpret
mode under ``attention_options(static_max=0.0)``: at heads of d = 128 with
≥ 128 tokens both the self- and the cross-attention take ``_flash_t128``
(K3), the cross-attention over the config's 512 text keys.  Tolerances, of
max|ref|: 1e-5 for modules on the math path and for a solver's trajectory,
1e-4 for modules through a kernel route and for whole trajectories (the
Pallas kernels and the port's plain versions sum in their own orders),
1e-3 for decoded pixels (deep conv stacks)."""

import contextlib
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videotuna_tpu.kernels.attention as JA
from videotuna_tpu.core import config as jconfig
from videotuna_tpu.core import registry as jregistry
from videotuna_tpu.models import layers as JL
from videotuna_tpu.models.wan import vae as jwanvae
from videotuna_tpu.models.wan.dit import WanModel as JWan
from videotuna_tpu.schedulers import cfg_denoise as jcfg_denoise
from videotuna_tpu.schedulers import fm_solvers as jfm
from videotuna_tpu.schedulers import flow_match as jflow_match
from videotuna_tpu_torch.cli import commands as pcommands
from videotuna_tpu_torch.core import config as pconfig
from videotuna_tpu_torch.core import registry as pregistry
from videotuna_tpu_torch.flows import wan as pwan
from videotuna_tpu_torch.kernels import attention as PA
from videotuna_tpu_torch.models import layers as PL
from videotuna_tpu_torch.models.wan import vae as pwanvae
from videotuna_tpu_torch.models.wan.dit import WanModel as PWan
from videotuna_tpu_torch.schedulers import fm_solvers as pfm
from videotuna_tpu_torch.tools.from_jax import (load_flow_params,
                                                load_jax_params)

from tests.test_torch_port_models import (  # noqa: F401
    jax_params, torch_one_thread)
from tests.test_torch_port_opensora import _apply, _close, _t

MODULE_TOL = 1e-5
KERNEL_MODEL_TOL = 1e-4
TRAJ_TOL = 1e-4
PIXEL_TOL = 1e-3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAN_CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "008_wanvideo",
                                            "*.yaml")))
CONFIG_1_3B = os.path.join(ROOT, "configs", "008_wanvideo",
                           "wan2_1_t2v_1_3B.yaml")
PROMPT = "a red panda climbing a snow-covered pine tree"

_DEN = "flow.params.denoiser_config.params"
_T5 = "flow.params.cond_stage_config.params"
_VAE = "flow.params.first_stage_config.params"
# the 1.3B config at narrow width, heads of d = 128 kept: the DiT at dim 256
# (2 heads, 2 layers), a 2-layer T5 of dim 64 over the config's 512 tokens,
# the VAE at dim 16; 5×128×128 gives 2×16×16 latents, 128 tokens a frame
# stack after the (1, 2, 2) patch
NARROW = [f"{_DEN}.dim=256", f"{_DEN}.heads=2", f"{_DEN}.num_layers=2",
          f"{_DEN}.ffn_dim=512", f"{_DEN}.text_dim=64",
          f"{_DEN}.dtype=float32", f"{_T5}.dim=64", f"{_T5}.heads=2",
          f"{_T5}.head_dim=32", f"{_T5}.ff_dim=128", f"{_T5}.num_layers=2",
          f"{_VAE}.dim=16", "flow.params.scheduler_config.params.num_steps=3",
          "inference.height=128", "inference.width=128", "inference.frames=5"]


@contextlib.contextmanager
def _fixed_max():
    """Both packages under the flow's fixed max, the JAX kernels in
    interpret mode."""
    old = JA._FA_INTERPRET
    JA._FA_INTERPRET = True
    try:
        with JA.attention_options(static_max=0.0), \
                PA.attention_options(static_max=0.0):
            yield
    finally:
        JA._FA_INTERPRET = old


def _count_t128(monkeypatch):
    """The (Sq, Sk) of the JAX side's ``_flash_t128`` calls, as traced:
    JAX's caches are cleared, so that every shape is traced again."""
    jax.clear_caches()
    seen = []
    t128 = JA._flash_t128
    monkeypatch.setattr(JA, "_flash_t128", lambda *a, **kw: seen.append(
        (kw["sq"], kw["sk"])) or t128(*a, **kw))
    return seen


# ---------------------------------------------------------------- RoPE
@pytest.mark.parametrize("grid", [(3, 5, 7), (21, 45, 80)],
                         ids=["small", "wan14b_720p"])
def test_wan_rope_dims_and_tables_match(grid):
    """128 → 44/42/42 (and the split at other widths); the interleaved-pair
    tables at that split over a small grid and the 14B 720p grid (21×45×80,
    75,600 tokens)."""
    for hd in (128, 64, 96):
        assert PL.wan_rope_dims(hd) == JL.wan_rope_dims(hd)
    assert PL.wan_rope_dims(128) == (44, 42, 42)
    dims = PL.wan_rope_dims(128)
    jcos, jsin = jax.jit(lambda: JL.rope_3d(*dims, *grid))()
    cos, sin = PL.rope_3d(*dims, *grid)
    assert cos.shape == (np.prod(grid), 64)
    _close(cos, jcos, MODULE_TOL)
    _close(sin, jsin, MODULE_TOL)
    if np.prod(grid) < 1000:
        x = np.random.default_rng(0).standard_normal(
            (1, int(np.prod(grid)), 2, 128), dtype=np.float32)
        _close(PL.apply_rope(_t(x), cos, sin),
               JL.apply_rope(jnp.asarray(x), jcos, jsin), MODULE_TOL)


# ---------------------------------------------------------------- DiT
def _dit_inputs(seed, text=512, img=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 3, 16, 16, 16), dtype=np.float32)
    t = np.array([30.0, 950.0], np.float32)
    y = rng.standard_normal((2, text, 64), dtype=np.float32)
    out = [x, t, y]
    if img:
        out.append(rng.standard_normal((2, 160, img), dtype=np.float32))
    return out


@pytest.mark.parametrize("scan,img", [(False, None), (True, None),
                                      (True, 32)],
                         ids=["blocks", "scan", "scan_i2v_branch"])
def test_wan_model_matches(monkeypatch, scan, img):
    """dim 256, 2 heads of d = 128, 2 layers, 3×16×16 latents (192
    tokens), 512 text tokens (and 160 image tokens): on the JAX side every
    self-, text cross- and image cross-attention reaches K3 in interpret
    mode, in both parameter layouts."""
    cfg = dict(in_channels=16, out_channels=16, dim=256, ffn_dim=512,
               num_layers=2, heads=2, text_dim=64, img_dim=img,
               scan_blocks=scan)
    args = _dit_inputs(7 + int(scan), img=img)
    jm = JWan(**cfg)
    pm = PWan(**cfg)
    params = jax_params(jm, like=pm)
    assert ("blocks" in params) == scan
    seen = _count_t128(monkeypatch)
    with _fixed_max():
        ref = _apply(jm, params, *args)
        assert set(seen) == {(192, 192), (192, 512)} | (
            {(192, 160)} if img else set())
        load_jax_params(pm, params)
        with torch.no_grad():
            out = pm(*map(_t, args))
    _close(out, ref, KERNEL_MODEL_TOL)


def test_wan_model_staged_forward_raises():
    pm = PWan(in_channels=4, out_channels=4, dim=32, ffn_dim=64,
              num_layers=1, heads=2, text_dim=8)
    with pytest.raises(NotImplementedError, match="stage"):
        pm(torch.zeros(1, 1, 2, 2, 4), torch.zeros(1), torch.zeros(1, 3, 8),
           stage="blocks")


# ---------------------------------------------------------------- VAE
@pytest.fixture(scope="module")
def wan_vae():
    """The Wan VAE at dim 16 (channels 16/32/64/64), both packages, the
    same weights; a 9×32×32 clip."""
    cfg = dict(dim=16)
    video = np.random.default_rng(3).uniform(
        -1, 1, (1, 9, 32, 32, 3)).astype(np.float32)
    jm = jwanvae.WanVAE(**cfg)
    pm = pwanvae.WanVAE(**cfg)
    params = jax_params(jm, like=pm)
    load_jax_params(pm, params)
    return jm, params, pm, video


def test_wan_vae_encode_and_decode_match(wan_vae):
    jm, params, pm, video = wan_vae
    jmu = _apply(jm, params, video, method="encode")
    assert jmu.shape == (1, 3, 4, 4, 16)
    z = np.asarray(jmu)
    with torch.no_grad():
        _close(pm.encode(_t(video)), jmu, KERNEL_MODEL_TOL)
        _close(pm.decode(_t(z)), _apply(jm, params, z, method="decode"),
               PIXEL_TOL)


def test_wan_streamed_decode_matches_jax_full_and_streamed(wan_vae):
    """The port's streamed decode (frame 0, then chunks of 1 latent frame,
    the flow's, or of 2: a whole chunk, then a short last one, the conv
    state carried) of 4 latent frames against the JAX package's
    whole-sequence decode and its own ``wan_streaming_decode`` (chunks of
    2, padding the short one); the port's whole-sequence decode agrees with
    its streamed one."""
    jm, params, pm, _ = wan_vae
    frames = 4
    z = np.random.default_rng(frames).standard_normal(
        (1, frames, 4, 4, 16)).astype(np.float32)
    full = _apply(jm, params, z, method="decode")
    streamed = jwanvae.wan_streaming_decode(jm, params, jnp.asarray(z))
    assert full.shape == (1, 1 + 4 * (frames - 1), 32, 32, 3)
    with torch.no_grad():
        for chunk in (pwan.DECODE_CHUNK, 2):
            out = pwanvae.wan_streaming_decode(pm, _t(z), chunk=chunk)
            _close(out, full, PIXEL_TOL)
            _close(out, streamed, PIXEL_TOL)
            _close(pm.decode(_t(z)), out, MODULE_TOL)
        # the state is explicit: each causal conv's last input frames under
        # its module path, handed back by every chunk
        _, state = pm.decode_chunk(_t(z[:, :1]), None, first_chunk=True)
        keys = sorted(state)
        _, state2 = pm.decode_chunk(_t(z[:, 1:3]), state, first_chunk=False)
        assert state2 is state and sorted(state2) == keys
        assert state["decoder.conv1"].shape == (1, 16, 2, 4, 4)
        assert all(v.shape[2] == 2 for v in state.values())


# ---------------------------------------------------------------- solvers
@pytest.mark.parametrize("solver", ["unipc", "dpm"])
@pytest.mark.parametrize("steps,shift", [(6, 5.0), (4, 3.0), (1, 5.0)])
def test_flow_solvers_match(solver, steps, shift):
    """The sigma grid and the whole trajectory from the same x_T on a toy
    denoiser whose output depends on x nonlinearly (so the multistep
    history matters)."""
    jcls, pcls = {"unipc": (jfm.FlowUniPCSchedule, pfm.FlowUniPCSchedule),
                  "dpm": (jfm.FlowDPMSolverSchedule,
                          pfm.FlowDPMSolverSchedule)}[solver]
    js, ps = jcls.create(steps, shift), pcls.create(steps, shift)
    _close(ps.sigmas, js.sigmas, 1e-6)
    _close(ps.timesteps, js.timesteps, 1e-6)
    x = np.random.default_rng(steps).standard_normal(
        (2, 3, 4, 4, 16)).astype(np.float32)

    def model(lib):
        return lambda x, t: 0.5 * lib.tanh(x) + 0.3 * x \
            - 1e-3 * t.reshape(-1, 1, 1, 1, 1)

    ref = js.sample(model(jnp), x.shape, jax.random.key(0),
                    x_T=jnp.asarray(x))
    _close(ps.sample(model(torch), x.shape, None, x_T=_t(x)), ref,
           MODULE_TOL)


def test_flow_solver_registry_names_resolve():
    for target, cls in (("videotuna_tpu.schedulers.FlowUniPCSchedule",
                         pfm.FlowUniPCSchedule),
                        ("videotuna_tpu.schedulers.FlowDPMSolverSchedule",
                         pfm.FlowDPMSolverSchedule)):
        sched = pregistry.instantiate({"target": target,
                                       "params": {"num_steps": 5,
                                                  "shift": 3.0}})
        assert isinstance(sched, cls) and sched.num_steps == 5
    from videotuna_tpu_torch import schedulers
    assert schedulers.FlowUniPCSchedule is pfm.FlowUniPCSchedule
    assert schedulers.FlowDPMSolverSchedule is pfm.FlowDPMSolverSchedule


# ---------------------------------------------------------------- flow
@pytest.fixture(scope="module")
def narrow_flows():
    """The narrow 1.3B flow in both packages with the same weights."""
    jcfg = jconfig.load_configs([CONFIG_1_3B], NARROW)
    pcfg = pconfig.load_configs([CONFIG_1_3B], NARROW)
    assert jcfg == pcfg
    jregistry.populate()
    jflow = jregistry.instantiate(jcfg["flow"])
    pflow = pregistry.instantiate(pcfg["flow"], device="cpu")
    ex = jflow.example_inputs()
    params = {c: jax_params(getattr(jflow, c), *ex[c], seed=i,
                            like=getattr(pflow, c))
              for i, c in enumerate(("denoiser", "first_stage",
                                     "cond_stage"))}
    load_flow_params(pflow, params)
    return jflow, pflow, params, jcfg["inference"]


def test_wan_flow_samples_with_cfg_like_jax(narrow_flows, monkeypatch):
    """The prompt and the default negative prompt through T5, the same x_T
    through 3 UniPC steps with CFG 5 (each step one DiT call at B = 2, its
    self- and its cross-attention over 512 text keys through K3 on the JAX
    side), then the decode: the port's streamed one against the JAX
    whole-sequence one."""
    jflow, pflow, params, inf = narrow_flows
    shape = jflow.latent_shape(1, inf["frames"], inf["height"],
                               inf["width"])
    assert shape == (1, 2, 16, 16, 16)
    x_T = np.random.default_rng(1).standard_normal(shape, dtype=np.float32)
    neg = pwan.DEFAULT_NEGATIVE
    seen = _count_t128(monkeypatch)
    with _fixed_max():
        jcond, juncond = (jax.jit(lambda p, s=s: jflow.encode_text(p, [s]))(
            params) for s in (PROMPT, neg))
        denoise = jcfg_denoise(
            lambda x, t, c: jflow.denoise_apply(params, x, t, c), jcond,
            juncond, 5.0)
        jz = jax.jit(lambda x: jflow.scheduler.sample(
            denoise, shape, jax.random.key(0), x_T=x))(jnp.asarray(x_T))
    assert set(seen) == {(128, 128), (128, 512)}
    jvideo = jax.jit(jflow.decode_latents)(params, jz)

    pcond, puncond = (pflow.encode_text([s]) for s in (PROMPT, neg))
    _close(pcond["y"], jcond["y"], MODULE_TOL)
    pz = pflow.sample(pcond, puncond, shape, None, 5.0, x_T=_t(x_T))
    _close(pz, jz, TRAJ_TOL)
    video = pflow.decode_latents(pz)
    assert video.shape == (1, 5, 128, 128, 3)
    _close(video, jvideo, PIXEL_TOL)


def test_wan_training_loss_matches_jax(narrow_flows):
    """The flow-matching loss on latents and the text states, with the JAX
    side's σ and noise handed to the port."""
    jflow, pflow, params, _ = narrow_flows
    rng = np.random.default_rng(4)
    z = rng.standard_normal((2, 3, 16, 16, 16)).astype(np.float32)
    text = rng.standard_normal((2, 512, 64)).astype(np.float32)
    key = jax.random.key(5)
    batch = {"latents": jnp.asarray(z), "text_states": jnp.asarray(text)}
    with _fixed_max():
        jloss, _ = jax.jit(lambda p, b: jflow.training_loss(p, b, key))(
            params, batch)
    _, k_sig, k_noise = jax.random.split(key, 3)
    sigma = jflow_match.sample_sigmas(k_sig, 2, "logit_normal")
    noise = jax.random.normal(k_noise, z.shape, jnp.float32)
    with PA.attention_options(static_max=0.0):
        loss, aux = pflow.training_loss(
            {"latents": _t(z), "text_states": _t(text)},
            sigma=_t(sigma), noise=_t(noise))
    assert torch.isfinite(loss) and aux["loss"] is loss
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-4)


def test_run_inference_wan_1_3b_command_on_cpu(tmp_path):
    """The registry's ``inference-wanvideo-t2v-1-3B`` with ``--device cpu``
    and the narrowing overrides writes an mp4 of 5 frames and
    metric.json."""
    out = tmp_path / "wan"
    assert pcommands.main(["inference-wanvideo-t2v-1-3B", "--device", "cpu",
                           "--quiet", "--savedir", str(out), "--prompt",
                           PROMPT, *NARROW]) == 0
    metrics = json.loads((out / "metric.json").read_text())
    assert metrics["num_videos"] == 1 and metrics["denoise_steps"] == 3
    assert metrics["nonfinite_latents"] == 0 == metrics["nonfinite_pixels"]
    videos = [p for p in os.listdir(out) if p.endswith((".mp4", ".npy"))]
    assert len(videos) == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pcommands.main(["inference-wanvideo-t2v-1-3B", "--quiet",
                            "--savedir", str(tmp_path / "cuda"), *NARROW])


@pytest.mark.parametrize("path", WAN_CONFIGS, ids=os.path.basename)
def test_wan_configs_load_and_resolve_to_the_port(path):
    assert pconfig.load_configs([path]) == jconfig.load_configs([path])
    flow = pconfig.load_configs([path])["flow"]
    targets = [flow["target"]] + [
        flow["params"][k]["target"]
        for k in ("denoiser_config", "scheduler_config",
                  "first_stage_config", "cond_stage_config")]
    for target in targets:
        obj = pregistry.resolve(target)
        assert obj.__module__.startswith("videotuna_tpu_torch."), target
        assert jregistry.resolve(target).__name__ == obj.__name__, target


def test_mapped_height_diverges_from_jax():
    """The Wan configs' ``inference.mapping`` puts the height into the
    flow's params: the JAX flow's constructor refuses it (so its
    ``run_inference`` cannot start these configs); the port's flow takes
    it (a recorded divergence, ROADMAP.md queue 3)."""
    jcfg = jconfig.apply_inference_mapping(jconfig.load_configs(
        [CONFIG_1_3B], NARROW))
    pcfg = pconfig.apply_inference_mapping(pconfig.load_configs(
        [CONFIG_1_3B], NARROW))
    assert jcfg == pcfg and pcfg["flow"]["params"]["height"] == 128
    jregistry.populate()
    with pytest.raises(TypeError, match="height"):
        jregistry.instantiate(jcfg["flow"])
    flow = pregistry.instantiate(pcfg["flow"], device="cpu")
    assert flow.height == 128


def test_wan_i2v_raises_naming_item_8():
    """The name is the test's history: the i2v flow once raised naming
    queue 1, item 8.  Wan image-to-video is now ported
    (``tests/test_torch_port_wan_i2v.py``), so this checks that an
    ``i2v_mode`` flow builds, and that its image features raise, as the
    JAX package's do, only where no ``cond_stage_2`` (the CLIP image
    embedder) is configured."""
    cfg = pconfig.load_configs([CONFIG_1_3B], NARROW)["flow"]
    i2v = dict(cfg, params=dict(cfg["params"], i2v_mode=True))
    flow = pregistry.instantiate(i2v, device="cpu")
    assert flow.i2v_mode
    with pytest.raises(ValueError, match="cond_stage_2"):
        flow.prepare_image_features(torch.zeros((1, 16, 16, 3)))
