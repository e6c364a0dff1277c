"""The port's HunyuanVideo slice against the JAX package: the K3 route, the
flow-matching schedule, the LLaMA and CLIP text encoders, the token refiner,
``HYVideoDiT`` in both parameter layouts, ``HunyuanVAE``, RIFLEx, and the
flow end to end (``tiny_hunyuan.yaml`` and a narrow d=128 flow whose
trajectory runs K3 and K2).

The JAX module's parameter tree is filled from a seeded numpy generator and
carried across with ``tools/from_jax``; inputs come from numpy too.  f32
throughout.  Where the JAX side reaches a Pallas kernel it runs in interpret
mode under ``attention_options(static_max=0.0)``.  Tolerances, of max|ref|:
1e-5 for modules on the math path, 1e-4 for modules through a kernel route
and for whole trajectories (the Pallas kernels and the port's plain
versions sum in their own orders), 1e-3 for decoded pixels (deep conv
stacks)."""

import contextlib
import functools
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
from videotuna_tpu.flows import hunyuan as jhunyuan
from videotuna_tpu.models import layers as JL
from videotuna_tpu.models.hunyuan.dit import HYVideoDiT as JDiT
from videotuna_tpu.models.hunyuan.dit import TokenRefiner as JRefiner
from videotuna_tpu.models.hunyuan.vae import HunyuanVAE as JVAE
from videotuna_tpu.models.text_encoders import CLIPTextEncoder as JCLIP
from videotuna_tpu.models.text_encoders import LlamaTextEncoder as JLlama
from videotuna_tpu.schedulers import flow_match as jfm
from videotuna_tpu_torch.core import config as pconfig
from videotuna_tpu_torch.core import registry as pregistry
from videotuna_tpu_torch.flows import hunyuan as phunyuan
from videotuna_tpu_torch.kernels import attention as PA
from videotuna_tpu_torch.models import layers as PL
from videotuna_tpu_torch.models.hunyuan.dit import HYVideoDiT as PDiT
from videotuna_tpu_torch.models.hunyuan.dit import TokenRefiner as PRefiner
from videotuna_tpu_torch.models.hunyuan.vae import HunyuanVAE as PVAE
from videotuna_tpu_torch.models.text_encoders import CLIPTextEncoder as PCLIP
from videotuna_tpu_torch.models.text_encoders import \
    LlamaTextEncoder as PLlama
from videotuna_tpu_torch.schedulers import flow_match as pfm
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
TINY = os.path.join(ROOT, "configs", "000_tiny", "tiny_hunyuan.yaml")
HUNYUAN_CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs",
                                                "007_hunyuanvideo", "*.yaml")))


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


# ---------------------------------------------------------------- K3
def _normed(rng, shape):
    x = rng.standard_normal(shape, dtype=np.float32)
    return x / np.sqrt((x * x).mean(-1, keepdims=True) + 1e-6)


@pytest.mark.parametrize("d", [128, 72])
@pytest.mark.parametrize("sq,sk", [(200, 200), (136, 300)])
def test_k3_route_matches_pallas_t128(monkeypatch, d, sq, sk):
    """The JAX side runs ``_flash_t128`` (its tail keys removed in closed
    form at Sk = 200 and 300); the port routes the call to ``flash_fwd``
    with the fixed max, counted as K3, whose plain version runs here."""
    rng = np.random.default_rng(d + sq + sk)
    q = _normed(rng, (2, sq, 2, d))
    k = _normed(rng, (2, sk, 2, d))
    v = rng.standard_normal((2, sk, 2, d), dtype=np.float32)
    reached = []
    t128 = JA._flash_t128
    monkeypatch.setattr(JA, "_flash_t128",
                        lambda *a, **kw: reached.append(1) or t128(*a, **kw))
    ref = JA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             interpret=True, static_max=0.0)
    assert reached, "the JAX side did not reach _flash_t128"
    routes = []
    fwd = PA.flash_fwd
    monkeypatch.setattr(PA, "flash_fwd",
                        lambda *a, **kw: routes.append(kw.get("route"))
                        or fwd(*a, **kw))
    before = dict(fwd.launches)
    out = PA.flash_attention(_t(q), _t(k), _t(v), static_max=0.0)
    assert routes == ["K3"]
    assert fwd.launches == before      # the CPU runs the plain version
    _close(out, ref, MODULE_TOL)


# ---------------------------------------------------------------- schedule
@pytest.mark.parametrize("shift", [1.0, 7.0])
def test_flow_match_schedule_matches(shift):
    js = jfm.FlowMatchSchedule.create(6, shift)
    ps = pfm.FlowMatchSchedule.create(6, shift)
    _close(ps.sigmas, js.sigmas, 1e-6)
    _close(ps.timesteps, js.timesteps, 1e-6)
    rng = np.random.default_rng(0)
    x, v = (rng.standard_normal((2, 3, 4, 4, 16), dtype=np.float32)
            for _ in range(2))
    for i in (0, 3, 5):
        _close(ps.step(_t(x), _t(v), i), js.step(jnp.asarray(x),
                                                 jnp.asarray(v), i), 1e-6)

    def model(lib):
        return lambda x, t: 0.3 * x - 1e-3 * t.reshape(-1, 1, 1, 1, 1) \
            * lib.ones_like(x)

    js4, ps4 = (m.FlowMatchSchedule.create(4, shift) for m in (jfm, pfm))
    ref = js4.sample(model(jnp), x.shape, jax.random.key(0),
                     x_T=jnp.asarray(x))
    _close(ps4.sample(model(torch), x.shape, None, x_T=_t(x)), ref,
           MODULE_TOL)


def test_flow_training_helpers_and_riflex_match():
    rng = np.random.default_rng(1)
    sig = rng.uniform(size=(5,)).astype(np.float32)
    _close(pfm.shift_sigmas(_t(sig), 5.0), jfm.shift_sigmas(sig, 5.0), 1e-6)
    x0, noise = (rng.standard_normal((5, 2, 3), dtype=np.float32)
                 for _ in range(2))
    _close(pfm.flow_interpolate(_t(x0), _t(noise), _t(sig)),
           jfm.flow_interpolate(x0, noise, sig), 1e-6)
    _close(pfm.flow_target(_t(x0), _t(noise)), jfm.flow_target(x0, noise),
           1e-6)
    gen = torch.Generator().manual_seed(0)
    for scheme in ("logit_normal", "uniform", "mode"):
        s = pfm.sample_sigmas(gen, 64, scheme)
        assert s.shape == (64,) and bool(((s >= 0) & (s <= 1)).all())
    for dim_t, frames, k in ((16, 49, 4), (32, 65, 2), (16, 40, 4)):
        got = phunyuan.riflex_temporal_scale(dim_t, frames, k,
                                             L_test=frames)
        want = jhunyuan.riflex_temporal_scale(dim_t, frames, k,
                                              L_test=frames)
        if want is None:
            assert got is None
        else:
            _close(got, want, 1e-6)


# ---------------------------------------------------------------- encoders
def test_llama_gqa_through_k2_matches():
    """dim 256, 2 heads of d=128 over 1 KV head, 160 tokens: the JAX side
    runs K2 causal in interpret mode."""
    cfg = dict(vocab_size=300, dim=256, heads=2, kv_heads=1, num_layers=2)
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 300, (2, 160)).astype(np.int32)
    mask = np.ones((2, 160), bool)
    mask[1, 97:] = False
    jm = JLlama(**cfg)
    pm = PLlama(**cfg)
    params = jax_params(jm, like=pm)
    with _fixed_max():
        ref = _apply(jm, params, ids, mask)
    load_jax_params(pm, params)
    with torch.no_grad():
        _close(pm(_t(ids).long(), _t(mask)), ref, KERNEL_MODEL_TOL)


def test_clip_penultimate_matches():
    cfg = dict(vocab_size=300, dim=64, heads=2, num_layers=3, max_len=16)
    ids = np.random.default_rng(3).integers(0, 300, (2, 16)).astype(np.int32)
    jm = JCLIP(**cfg)
    params = jax_params(jm, jnp.asarray(ids))
    assert sorted(k for k in params if k.startswith("block_")) == \
        ["block_0", "block_1"]
    pm = PCLIP(**cfg)
    load_jax_params(pm, params)
    with torch.no_grad():
        _close(pm(_t(ids).long()), _apply(jm, params, ids))


# ---------------------------------------------------------------- DiT
def test_token_refiner_ragged_mask_matches():
    rng = np.random.default_rng(4)
    txt = rng.standard_normal((2, 12, 24), dtype=np.float32)
    t = np.array([10.0, 700.0], np.float32)
    mask = np.ones((2, 12), bool)
    mask[0, 5:] = False
    jm = JRefiner(64, heads=2)
    pm = PRefiner(64, 24, heads=2)
    params = jax_params(jm, like=pm)
    load_jax_params(pm, params)
    with torch.no_grad():
        _close(pm(_t(txt), _t(t), _t(mask)),
               _apply(jm, params, txt, t, mask))


def _dit_inputs(seed, lat=(3, 16, 16), text=32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, *lat, 16), dtype=np.float32)
    t = np.array([30.0, 950.0], np.float32)
    y = rng.standard_normal((2, text, 64), dtype=np.float32)
    pooled = rng.standard_normal((2, 32), dtype=np.float32)
    mask = np.ones((2, text), bool)
    mask[1, 9:] = False
    g = np.full((2,), 6000.0, np.float32)
    return x, t, y, pooled, mask, g


@pytest.mark.parametrize("dim,heads,scan,riflex", [
    (256, 2, False, False), (256, 2, True, False), (128, 2, False, True)],
    ids=["d128_blocks", "d128_scan", "d64_riflex"])
def test_hyvideo_dit_matches(dim, heads, scan, riflex):
    """1 double and 2 single blocks, 3×16×16 latents (192 video tokens)
    and 32 text tokens, guidance and pooled text.  At d=128 every joint
    attention reaches K3 on the JAX side, in both parameter layouts; at
    d=64 (K1 there) the temporal RoPE takes RIFLEx's scale, whose width the
    two packages agree on at that head_dim."""
    cfg = dict(in_channels=16, out_channels=16, dim=dim, heads=heads,
               double_blocks=1, single_blocks=2, text_dim=64, pooled_dim=32,
               guidance_embed=True, scan_blocks=scan)
    x, t, y, pooled, mask, g = _dit_inputs(5)
    scale = None
    if riflex:
        hd = dim // heads
        dt_jax = hd - 2 * ((hd - hd // 4) // 2)
        scale = jhunyuan.riflex_temporal_scale(dt_jax, 49, 4, L_test=49)
        assert PL.split_rope_dims(hd)[0] == dt_jax
    jm = JDiT(**cfg)
    args = (x, t, y, pooled, mask, g)
    pm = PDiT(**cfg)
    params = jax_params(jm, like=pm)
    assert ("double_blocks" in params) == scan
    with _fixed_max():
        ref = jax.jit(lambda p, *a: jm.apply({"params": p}, *a,
                                             temporal_rope_scale=scale))(
            params, *map(jnp.asarray, args))
        load_jax_params(pm, params)
        with torch.no_grad():
            out = pm(*map(_t, args), temporal_rope_scale=None if scale is None
                     else _t(scale))
    _close(out, ref, KERNEL_MODEL_TOL)


def test_riflex_width_follows_the_dit_at_head_dim_128():
    """The JAX flow sizes RIFLEx's scale at hd − 2·((hd − hd//4)//2) = 32
    rope dims at head_dim 128, where the DiT's temporal axis has 16: above
    48 latent frames its rope table raises.  The port takes the width from
    the DiT's own split (a recorded divergence, ROADMAP.md queue 3)."""
    jscale = jhunyuan.riflex_temporal_scale(32, 49, 4, L_test=49)
    with pytest.raises(TypeError):
        JL.rope_3d(*JL.HUNYUAN_ROPE_DIMS, 49, 1, 1, theta=256.0,
                   temporal_scale=jscale)
    cfg = pconfig.load_configs([TINY], [
        "flow.params.denoiser_config.params.dim=256"])["flow"]
    flow = pregistry.instantiate(cfg, device="cpu")
    assert flow.denoiser.rope_dims() == PL.HUNYUAN_ROPE_DIMS
    scale = flow.temporal_rope_scale(49)
    _close(scale, jhunyuan.riflex_temporal_scale(16, 49, 4, L_test=49),
           1e-6)
    cos, _ = PL.rope_3d(*PL.HUNYUAN_ROPE_DIMS, 49, 1, 1, theta=256.0,
                        temporal_scale=scale)
    assert cos.shape == (49, 64)
    assert flow.temporal_rope_scale(48) is None


def test_dit_options_that_wait_raise():
    """The staged forward waits; token replace builds (any other condition
    type, as in the JAX package, conditions nothing)."""
    for kind, replace in (("token_replace", True), ("latent_concat", False),
                          (None, False)):
        assert PDiT(dim=32, heads=2, double_blocks=1, single_blocks=1,
                    i2v_condition_type=kind).token_replace is replace
    pm = PDiT(in_channels=4, out_channels=4, dim=32, heads=2,
              double_blocks=1, single_blocks=1, text_dim=8, pooled_dim=8)
    with pytest.raises(NotImplementedError, match="stage"):
        pm(torch.zeros(1, 1, 2, 2, 4), torch.zeros(1),
           torch.zeros(1, 3, 8), stage="double")


# ---------------------------------------------------------------- VAE
def test_hunyuan_vae_matches():
    cfg = dict(block_out_channels=(32, 32, 64, 64), norm_num_groups=8)
    video = np.random.default_rng(6).uniform(
        -1, 1, (1, 5, 32, 32, 3)).astype(np.float32)
    jm = JVAE(**cfg)
    pm = PVAE(**cfg)
    params = jax_params(jm, like=pm)
    load_jax_params(pm, params)
    jmoments = _apply(jm, params, video, method="encode")
    z = np.asarray(jmoments)[..., :16]
    with torch.no_grad():
        moments = pm.encode(_t(video))
        _close(moments, jmoments, KERNEL_MODEL_TOL)
        assert moments.shape == (1, 2, 4, 4, 32)
        _close(pm.decode(_t(z)), _apply(jm, params, z, method="decode"),
               PIXEL_TOL)


# ---------------------------------------------------------------- flow
NARROW_D128 = [
    "flow.params.model_max_length=160",
    "flow.params.denoiser_config.params.dim=256",
    "flow.params.denoiser_config.params.text_dim=256",
    "flow.params.cond_stage_config.params.dim=256",
    "flow.params.cond_stage_config.params.kv_heads=1",
    "flow.params.scheduler_config.params.num_steps=2",
    "inference.height=128",
    "inference.width=128",
]


def _flow_params(jflow, seed=0, pflow=None):
    """Seeded weights for each component (``jax_params``), their shapes
    read off the port flow ``pflow`` when given."""
    ex = jflow.example_inputs()
    return {c: jax_params(getattr(jflow, c), *ex[c], seed=seed + i,
                          like=getattr(pflow, c) if pflow else None)
            for i, c in enumerate(("denoiser", "first_stage", "cond_stage",
                                   "cond_stage_2"))}


@functools.cache
def _jax_flow(overrides):
    """(config, JAX flow, seeded parameters) of ``tiny_hunyuan.yaml`` under
    ``overrides``, once a module."""
    jcfg = jconfig.load_configs([TINY], list(overrides))
    jregistry.populate()
    jflow = jregistry.instantiate(jcfg["flow"])
    pflow = pregistry.instantiate(
        pconfig.load_configs([TINY], list(overrides))["flow"], device="cpu")
    return jcfg, jflow, _flow_params(jflow, pflow=pflow)


def _flows(overrides):
    jcfg, jflow, params = _jax_flow(tuple(overrides))
    pflow = pregistry.instantiate(
        pconfig.load_configs([TINY], list(overrides))["flow"], device="cpu")
    load_flow_params(pflow, params)
    return jcfg, jflow, pflow, params


@pytest.mark.parametrize("overrides", [[], NARROW_D128],
                         ids=["tiny", "narrow_d128"])
def test_hunyuan_flow_end_to_end_matches_jax(overrides):
    """The prompt through LLaMA and CLIP, the same x_T through the Euler
    trajectory, then the VAE.  The narrow d=128 flow has 3×16×16 latents
    (192 video tokens) and 160 LLaMA tokens: its trajectory runs K3 and K2
    on the JAX side."""
    jcfg, jflow, pflow, params = _flows(overrides)
    inf = jcfg["inference"]
    shape = jflow.latent_shape(1, inf["frames"], inf["height"], inf["width"])
    x_T = np.random.default_rng(1).standard_normal(shape, dtype=np.float32)

    with _fixed_max():
        jcond = jax.jit(lambda p: jflow.encode_text(p, [inf["prompt"]]))(
            params)
        denoise = lambda x, t: jflow.denoise_apply(params, x, t, jcond)  # noqa
        jz = jax.jit(lambda x: jflow.scheduler.sample(
            denoise, shape, jax.random.key(0), x_T=x))(jnp.asarray(x_T))
    jvideo = jax.jit(jflow.decode_latents)(params, jz)

    pcond = pflow.encode_text([inf["prompt"]])
    _close(pcond["y"], jcond["y"], KERNEL_MODEL_TOL)
    _close(pcond["pooled"], jcond["pooled"])
    pz = pflow.sample(pcond, None, shape, None, 1.0, x_T=_t(x_T))
    _close(pz, jz, TRAJ_TOL)
    _close(pflow.decode_latents(pz), jvideo, PIXEL_TOL)


def test_hunyuan_enhance_flow_match_matches_jax():
    """``GenerationFlow.enhance``'s flow-matching branch (SDEdit): a 9-frame
    clip encoded, entered at (1 − σ0)·z + σ0·ε with σ0 = sigmas[S − n] (4
    steps, strength 0.5: the last 2), then the Euler steps and the decode;
    the JAX key's draws handed to the port.  Both sides take their
    reference attention (no interpret mode here)."""
    jcfg, jflow, pflow, params = _flows([])
    inf = jcfg["inference"]
    video = np.random.default_rng(3).uniform(
        -1, 1, (1, inf["frames"], inf["height"], inf["width"], 3)
    ).astype(np.float32)
    key = jax.random.key(6)
    jcond = jax.jit(lambda p: jflow.encode_text(p, [inf["prompt"]]))(params)
    jout = jax.jit(lambda p, v, c: jflow.enhance(
        p, v, c, key, strength=0.5, cfg_scale=1.0))(params,
                                                     jnp.asarray(video), jcond)
    with torch.no_grad():   # the encode's latent shape (its own ratios)
        moments = pflow.first_stage.encode(torch.from_numpy(video))
    shape = (*moments.shape[:-1], moments.shape[-1] // 2)
    k_enc, k_noise, _ = jax.random.split(key, 3)
    post, noise = (_t(np.asarray(jax.random.normal(k, shape)))
                   for k in (k_enc, k_noise))
    out = pflow.enhance(_t(video), pflow.encode_text([inf["prompt"]]), None,
                        0.5, 1.0, posterior_noise=post, noise=noise)
    _close(out, jout, PIXEL_TOL)


def test_run_inference_tiny_hunyuan(tmp_path):
    from videotuna_tpu_torch.cli.inference import run_inference
    out = run_inference(["--config", TINY, "--device", "cpu", "--quiet",
                         "--savedir", str(tmp_path)])
    assert len(out["videos"]) == 1 and os.path.isfile(out["videos"][0])
    metrics = json.loads((tmp_path / "metric.json").read_text())
    assert metrics["num_videos"] == 1 and metrics["denoise_steps"] == 4
    assert metrics["nonfinite_latents"] == 0 == metrics["nonfinite_pixels"]


@pytest.mark.parametrize("path", HUNYUAN_CONFIGS + [TINY],
                         ids=os.path.basename)
def test_hunyuan_configs_load_and_resolve_to_the_port(path):
    assert pconfig.load_configs([path]) == jconfig.load_configs([path])
    flow = pconfig.load_configs([path])["flow"]
    targets = [flow["target"]] + [
        flow["params"][k]["target"]
        for k in ("denoiser_config", "scheduler_config",
                  "first_stage_config", "cond_stage_config",
                  "cond_stage_2_config")]
    for target in targets:
        obj = pregistry.resolve(target)
        assert obj.__module__.startswith("videotuna_tpu_torch."), target
        assert jregistry.resolve(target).__name__ == obj.__name__, target


def test_hunyuan_flow_parts_that_wait_raise():
    """Image conditioning needs ``i2v_mode`` (the JAX flow's raise); in
    i2v mode the flow builds with ``img_in`` at twice the latent
    channels."""
    cfg = pconfig.load_configs([TINY])["flow"]
    flow = pregistry.instantiate(cfg, device="cpu")
    assert not flow.i2v_mode
    with pytest.raises(NotImplementedError, match="i2v_mode"):
        flow.prepare_image_cond({}, None, torch.zeros((1, 32, 32, 3)), 9,
                                32, 32)
    i2v = dict(cfg, params=dict(cfg["params"], i2v_mode=True))
    flow = pregistry.instantiate(i2v, device="cpu")
    assert flow.i2v_mode and flow.denoiser.img_in.in_channels == 32
