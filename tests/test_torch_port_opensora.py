"""The port's Open-Sora v1.0 slice against the JAX package: STDiT (every
variant flag and both parameter layouts), the 2D KL VAE, IDDPM spaced
sampling and ``tiny_t2v.yaml`` end to end.

The JAX module's parameter tree is filled from a seeded numpy generator and
carried across with ``tools/from_jax``; inputs come from numpy too.  f32
throughout.  Tolerances, of max|ref|: 1e-5 for a module or one sampler
trajectory, 1e-4 for STDiT at the kernel-routed width (two blocks through
the Pallas K2 and K4 in interpret mode against their plain versions, each
summing in its own order), 1e-4 for a whole sampled trajectory and 1e-3
for decoded pixels (deeper conv stacks, other summation order)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videotuna_tpu.kernels.attention as JA
from videotuna_tpu.core import config as jconfig
from videotuna_tpu.core import registry as jregistry
from videotuna_tpu.models.opensora.stdit import STDiT as JSTDiT
from videotuna_tpu.models.vae2d import AutoencoderKL2D as JVAE2D
from videotuna_tpu.schedulers import iddpm as jiddpm
from videotuna_tpu_torch.core import config as pconfig
from videotuna_tpu_torch.core import registry as pregistry
from videotuna_tpu_torch.kernels import attention as PA
from videotuna_tpu_torch.models.opensora.stdit import STDiT as PSTDiT
from videotuna_tpu_torch.models.opensora.stdit import (pos_embed_2d_dynamic,
                                                       sincos_pos_embed_1d,
                                                       sincos_pos_embed_2d)
from videotuna_tpu_torch.models.vae2d import AutoencoderKL2D as PVAE2D
from videotuna_tpu_torch.schedulers import iddpm as piddpm
from videotuna_tpu_torch.tools.from_jax import load_flow_params, load_jax_params

from tests.test_torch_port_models import (  # noqa: F401
    jax_params, torch_one_thread)

MODULE_TOL = 1e-5
KERNEL_MODEL_TOL = 1e-4
TRAJ_TOL = 1e-4
PIXEL_TOL = 1e-3
TINY_T2V = "configs/000_tiny/tiny_t2v.yaml"


def _close(out, ref, tol=MODULE_TOL):
    if isinstance(out, torch.Tensor):
        out = out.detach().float().numpy()
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=tol * float(np.abs(ref).max()))


def _t(x):
    return torch.from_numpy(np.array(x))


def _apply(jmodule, params, *inputs, method=None, **kw):
    fn = functools.partial(jmodule.apply, method=method, **kw)
    return jax.jit(fn)({"params": params}, *map(jnp.asarray, inputs))


# ---------------------------------------------------------------- pos-embeds
def test_pos_embeds_match():
    from videotuna_tpu.models.opensora import stdit as J
    ref = jax.jit(lambda: (J.sincos_pos_embed_2d(48, 5, 7, 0.5),
                           J.sincos_pos_embed_1d(48, 9, 2.0),
                           J.pos_embed_2d_dynamic(48, 6, 4, 1.5, 5)))()
    _close(sincos_pos_embed_2d(48, 5, 7, 0.5), ref[0])
    _close(sincos_pos_embed_1d(48, 9, 2.0), ref[1])
    _close(pos_embed_2d_dynamic(48, 6, 4, 1.5, 5), ref[2])


# ---------------------------------------------------------------- STDiT
def _stdit_inputs(seed, b, t, hw, cap, length, valid0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, hw, hw, 4), dtype=np.float32)
    ts = np.array([17, 900][:b], np.int32)
    y = rng.standard_normal((b, length, cap), dtype=np.float32)
    mask = np.ones((b, length), bool)
    mask[0, valid0:] = False
    return x, ts, y, mask


@pytest.mark.parametrize("scan", [False, True], ids=["blocks", "scan"])
def test_stdit_through_k2_k4_matches(scan):
    """Hidden 144, 2 heads of d=72, 2×32×32 latents: 256 spatial tokens a
    frame (K2) and 512 cross queries over a ragged 32-token caption (K4).
    The unrolled layout runs the JAX side through the Pallas kernels in
    interpret mode; the scanned layout, which checks the parameter layout,
    runs it through the math path (one interpret-mode case holds the
    kernels, and test_torch_port_attention holds each at more shapes)."""
    cfg = dict(input_size=(2, 32, 32), hidden_size=144, depth=2,
               num_heads=2, caption_channels=16, model_max_length=32,
               scan_blocks=scan)
    x, ts, y, mask = _stdit_inputs(0, 2, 2, 32, 16, 32, 11)
    jm = JSTDiT(**cfg)
    pm = PSTDiT(**cfg)
    params = jax_params(jm, like=pm)
    old = JA._FA_INTERPRET
    JA._FA_INTERPRET = not scan
    try:
        ref = _apply(jm, params, x, ts, y, mask)
    finally:
        JA._FA_INTERPRET = old
    load_jax_params(pm, params)
    with torch.no_grad():
        out = pm(_t(x), _t(ts), _t(y), _t(mask))
    _close(out, ref, KERNEL_MODEL_TOL)


_VARIANTS = {
    "qk_norm_temporal_rope": (dict(qk_norm=True, temporal_rope=True,
                                   pred_sigma=False), False),
    "temporal_mod_x_mask": (dict(temporal_mod=True, pred_sigma=False), True),
    "paired_scan": (dict(paired_blocks=True, scan_blocks=True,
                         qk_norm=True), False),
    "paired_blocks_x_mask": (dict(paired_blocks=True), True),
    "dynamic_pos_embed": (dict(dynamic_pos_embed=True, scan_blocks=True),
                          False),
}


@pytest.mark.parametrize("name", list(_VARIANTS))
def test_stdit_variants_match(name):
    """The variant flags at the tiny size of tests/test_opensora_variants.py
    (math-path attention)."""
    flags, with_x_mask = _VARIANTS[name]
    cfg = dict(input_size=(4, 8, 8), hidden_size=32, depth=2, num_heads=2,
               caption_channels=16, **flags)
    x, ts, y, mask = _stdit_inputs(1, 2, 4, 8, 16, 8, 5)
    x_mask = np.array([[True, False, True, True], [False] * 2 + [True] * 2])
    jm = JSTDiT(**cfg)
    kw = {"x_mask": jnp.asarray(x_mask)} if with_x_mask else {}
    pm = PSTDiT(**cfg)
    params = jax_params(jm, like=pm)
    ref = _apply(jm, params, x, ts, y, mask, **kw)
    load_jax_params(pm, params)
    with torch.no_grad():
        out = pm(_t(x), _t(ts), _t(y), _t(mask),
                 x_mask=_t(x_mask) if with_x_mask else None)
    _close(out, ref)


def test_stdit_staged_forward_raises():
    pm = PSTDiT(input_size=(1, 4, 4), hidden_size=16, depth=1, num_heads=2,
                caption_channels=8)
    with pytest.raises(NotImplementedError, match="stage"):
        pm(torch.zeros(1, 1, 4, 4, 4), torch.zeros(1), torch.zeros(1, 2, 8),
           stage="embed")


# ---------------------------------------------------------------- VAE
def test_autoencoder_kl2d_matches():
    """Frame-wise encode and decode of 4 frames in chunks of 2."""
    cfg = dict(ch=8, ch_mult=(1, 2, 2), num_res_blocks=1, z_channels=4,
               embed_dim=4, micro_frame_batch=2)
    rng = np.random.default_rng(2)
    video = rng.uniform(-1, 1, (1, 4, 32, 32, 3)).astype(np.float32)
    jm = JVAE2D(**cfg)
    pm = PVAE2D(**cfg)
    params = jax_params(jm, like=pm)
    load_jax_params(pm, params)
    moments = _apply(jm, params, video, method=jm.encode)
    z = np.asarray(moments)[..., :4]
    with torch.no_grad():
        _close(pm.encode(_t(video)), moments)
        _close(pm.decode(_t(z)), _apply(jm, params, z, method=jm.decode),
               PIXEL_TOL)


def test_vae2d_attention_tokens_fit_the_flash_kernels(monkeypatch):
    """The 2D VAE's attention at d=64 over 16×16 tokens, the flash route:
    its tokens are channel-last with a contiguous head_dim, the layout the
    CUDA wrapper reads in place."""
    from videotuna_tpu_torch.models import vae2d
    seen = []

    def spy(q, k, v, **kw):
        PA._check_layout("flash_fwd", q, k, v)
        seen.append(tuple(q.shape))
        return PA.dot_product_attention(q, k, v, **kw)

    monkeypatch.setattr(vae2d, "dot_product_attention", spy)
    block = vae2d.AttnBlock2D(64, dtype=torch.bfloat16)
    with torch.no_grad():
        out = block(torch.randn((1, 64, 16, 16)))
    assert seen == [(1, 256, 1, 64)]
    assert out.shape == (1, 64, 16, 16) and torch.isfinite(out).all()


# ---------------------------------------------------------------- IDDPM
@pytest.mark.parametrize("counts", ["10", "ddim5", [3, 4]])
def test_space_timesteps_matches(counts):
    assert piddpm.space_timesteps(100, counts) \
        == jiddpm.space_timesteps(100, counts)


def test_spaced_schedule_sampling_matches():
    """The learned-variance ancestral loop with the same x_T and the JAX
    loop's own per-step noise, under a fixed 2·C-channel model."""
    kw = dict(timesteps=100, section_counts="10")
    jsched = jiddpm.build_spaced(**kw)
    psched = pregistry.resolve(
        "videotuna_tpu.schedulers.SpacedSchedule")(**kw)
    _close(psched.base.betas, jsched.base.betas)
    np.testing.assert_array_equal(psched.timestep_map.numpy(),
                                  np.asarray(jsched.timestep_map))
    shape = (1, 2, 4, 4, 4)
    x_T = np.random.default_rng(3).standard_normal(shape, dtype=np.float32)
    key = jax.random.key(4)
    noises = jax.jit(jax.vmap(lambda kk: jax.random.normal(kk, shape)))(
        jax.random.split(key, jsched.num_steps))

    def model(x, t, lib):
        tf = (t.astype(lib.float32) if lib is jnp else t.float()) / 100.0
        tf = tf.reshape(-1, 1, 1, 1, 1)
        eps = 0.3 * x + 0.1 * tf
        var = lib.tanh(x - tf)
        return lib.concatenate([eps, var], -1) if lib is jnp \
            else torch.cat([eps, var], -1)

    ref = jax.jit(lambda x: jsched.sample(lambda x, t: model(x, t, jnp),
                                          shape, key, x_T=x))(
        jnp.asarray(x_T))
    out = psched.sample(lambda x, t: model(x, t, torch), shape, None,
                        x_T=_t(x_T), noises=_t(noises))
    _close(out, ref)


def test_iddpm_vb_loss_waits_for_training():
    """The hybrid loss's vb term, ported with the training slice: against
    the JAX package's on the respaced chain, eps half frozen."""
    jsched = jiddpm.build_spaced(timesteps=100, section_counts="10")
    psched = piddpm.build_spaced(timesteps=100, section_counts="10")
    rng = np.random.default_rng(11)
    x0, xt = (rng.standard_normal((2, 3, 4, 4, 4)).astype(np.float32)
              for _ in range(2))
    out = rng.standard_normal((2, 3, 4, 4, 8)).astype(np.float32)
    t = np.array([0, 7], np.int32)
    ref = jsched.vb_loss_term(jnp.asarray(out), jnp.asarray(x0),
                              jnp.asarray(xt), jnp.asarray(t))
    model_out = torch.from_numpy(out).requires_grad_()
    got = psched.vb_loss_term(model_out, torch.from_numpy(x0),
                              torch.from_numpy(xt), torch.from_numpy(t))
    _close(got, ref)
    got.sum().backward()
    assert model_out.grad[..., :4].abs().max() == 0    # eps half frozen
    assert model_out.grad[..., 4:].abs().max() > 0


# ---------------------------------------------------------------- flow
def test_tiny_t2v_end_to_end_matches_jax():
    jcfg = jconfig.load_configs([TINY_T2V])
    pcfg = pconfig.load_configs([TINY_T2V])
    jregistry.populate()
    jflow = jregistry.instantiate(jcfg["flow"])
    pflow = pregistry.instantiate(pcfg["flow"], device="cpu")
    ex = jflow.example_inputs()
    params = {c: jax_params(getattr(jflow, c), *ex[c], seed=i,
                            like=getattr(pflow, c))
              for i, c in enumerate(("denoiser", "first_stage",
                                     "cond_stage"))}
    load_flow_params(pflow, params)

    inf = jcfg["inference"]
    shape = jflow.latent_shape(1, inf["frames"], inf["height"], inf["width"])
    scale = inf["unconditional_guidance_scale"]
    x_T = np.random.default_rng(1).standard_normal(shape, dtype=np.float32)

    from videotuna_tpu.schedulers import cfg_denoise
    jcond, juncond = jax.jit(lambda p: (jflow.encode_text(p, [inf["prompt"]]),
                                        jflow.encode_text(p, [""])))(params)
    denoise = cfg_denoise(
        lambda x, t, c: jflow.denoise_apply(params, x, t, c),
        jcond, juncond, scale)
    jz = jax.jit(lambda x: jflow.scheduler.sample(
        denoise, shape, jax.random.key(0), x_T=x))(jnp.asarray(x_T))
    jvideo = jax.jit(jflow.decode_latents)(params, jz)

    pcond = pflow.encode_text([inf["prompt"]])
    puncond = pflow.encode_text([""])
    _close(pcond["y"], jcond["y"])
    pz = pflow.sample(pcond, puncond, shape, None, scale, x_T=_t(x_T))
    _close(pz, jz, TRAJ_TOL)
    _close(pflow.decode_latents(pz), jvideo, PIXEL_TOL)


def test_opensora_flow_branches():
    cfg = pconfig.load_configs([TINY_T2V])["flow"]
    flow = pregistry.instantiate(cfg, device="cpu")
    assert type(flow.scheduler).__name__ == "DDIMSchedule"
    assert flow.scheduler.num_steps == 4
    z = torch.randn((1, 4, 8, 8, 4), generator=torch.Generator()
                    .manual_seed(0))
    loss, aux = flow.training_loss(
        {"latents": z, "text_states": torch.zeros((1, 8, 16))},
        torch.Generator().manual_seed(1))
    assert torch.isfinite(loss) and set(aux) == {"loss", "t_mean"}
    fm = dict(cfg, params=dict(cfg["params"], scheduler_config={
        "target": "videotuna_tpu.schedulers.FlowMatchSchedule",
        "params": {"num_steps": 4}}))
    with pytest.raises(NotImplementedError, match="Open-Sora 1.2"):
        pregistry.instantiate(fm, device="cpu")
    spaced = dict(cfg, params=dict(cfg["params"], scheduler_config={
        "target": "videotuna_tpu.schedulers.SpacedSchedule",
        "params": {"timesteps": 100, "section_counts": "5"}}))
    flow = pregistry.instantiate(spaced, device="cpu")
    assert flow.base_schedule.num_timesteps == 100
