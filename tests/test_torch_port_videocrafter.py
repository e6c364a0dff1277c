"""The port's VideoCrafter 1/2 and DynamiCrafter slice against the JAX
package on the CPU: UNet3D's blocks and the whole UNet (with fps, and with
DynamiCrafter's image cross-attention and concatenated image latent), the
image conditioner, ``VideocrafterFlow``'s DDIM sampling with CFG for T2V
(VideoCrafter2: v-prediction, zero terminal SNR; DynamiCrafter's I2V is in
``tests/test_torch_port_dynamicrafter.py``), its ``training_loss`` and
gradients, the registry's five VideoCrafter commands on the CPU, and the
reference faults that the port follows or leaves (ROADMAP.md queue 3).

The harness of ROADMAP.md ("Parity harness"): the JAX module's parameter
tree is filled from a seeded numpy generator and carried across with
``tools/from_jax``; inputs and noise come from numpy.  f32 throughout, at a
narrow size: the UNet at model_channels 48 (3 heads of d = 16 at the first
level, an odd count as VideoCrafter2's 5, and 6 in the middle block), two
levels of one res block, attention at the first level and in the middle
(the second level's blocks run without it, as the configs' deepest
level), 2 frames of 16×16 latents (256 spatial tokens, so the port takes
the flash routes' plain versions; the JAX package runs its reference
attention on the CPU); a 2-layer CLIP text encoder of dim 32, the
2D VAE at ch 32.  Tolerances, of max|ref|: 1e-5 for modules, 1e-4 for
trajectories and gradients, 1e-3 for decoded pixels.
"""

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
from videotuna_tpu.models.lvdm import image_cond as JI
from videotuna_tpu.models.lvdm import unet3d as JU
from videotuna_tpu.schedulers import cfg_denoise as jcfg_denoise
from videotuna_tpu_torch.cli import commands as pcommands
from videotuna_tpu_torch.core import config as pconfig
from videotuna_tpu_torch.core import registry as pregistry
from videotuna_tpu_torch.models.lvdm import image_cond as PI
from videotuna_tpu_torch.models.lvdm import unet3d as PU
from videotuna_tpu_torch.tools.from_jax import (load_flow_params,
                                                load_jax_params)

from tests.test_torch_port_models import (  # noqa: F401
    jax_params, torch_one_thread)
from tests.test_torch_port_opensora import _close, _t

MODULE_TOL = 1e-5
TRAJ_TOL = 1e-4
PIXEL_TOL = 1e-3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "configs")
VC2 = os.path.join(CONFIGS, "001_videocrafter2", "vc2_t2v_320x512.yaml")
DC = os.path.join(CONFIGS, "002_dynamicrafter", "dc_i2v_576x1024.yaml")
VC1_T2V = os.path.join(CONFIGS, "000_videocrafter", "vc1_t2v_576x1024.yaml")
VC1_I2V = os.path.join(CONFIGS, "000_videocrafter", "vc1_i2v_320x512.yaml")
PROMPT = "a corgi running on a beach at sunset"

_U = "flow.params.denoiser_config.params"
_C = "flow.params.cond_stage_config.params"
_V = "flow.params.first_stage_config.params"
_I = "flow.params.cond_stage_2_config.params"
NARROW = [f"{_U}.model_channels=48", f"{_U}.channel_mult=[1, 2]",
          f"{_U}.attention_resolutions=[1]", f"{_U}.num_res_blocks=1",
          f"{_U}.num_head_channels=16", f"{_U}.context_dim=32",
          f"{_U}.dtype=float32", f"{_C}.dim=32", f"{_C}.heads=2",
          f"{_C}.num_layers=2", f"{_V}.ch=32", f"{_V}.num_res_blocks=1",
          "flow.params.ddim_steps=2", "inference.height=128",
          "inference.width=128", "inference.frames=2"]
# DynamiCrafter's image tower narrowed: a 2-layer CLIP ViT of dim 32 at 28
# px (4 patch tokens), a 1-layer resampler of 4 queries
NARROW_DC = NARROW + [
    f"{_I}.image_size=28", f"{_I}.clip_dim=32", f"{_I}.clip_heads=2",
    f"{_I}.clip_layers=2", f"{_I}.dim=32", f"{_I}.depth=1", f"{_I}.heads=2",
    f"{_I}.num_queries=4", f"{_I}.output_dim=32"]
# VideoCrafter1 I2V's CLIP image embedder narrowed the same way
NARROW_VC1_I2V = NARROW + [f"{_I}.image_size=28", f"{_I}.dim=32",
                           f"{_I}.heads=2", f"{_I}.num_layers=2"]
FRAMES, HEIGHT, WIDTH = 2, 128, 128


# ---------------------------------------------------------------- blocks
def _block_inputs():
    rng = np.random.default_rng(0)
    return {"x32": rng.standard_normal((2, 2, 16, 8, 32), dtype=np.float32),
            "x48": rng.standard_normal((2, 2, 16, 8, 48), dtype=np.float32),
            "x_t6": rng.standard_normal((2, 6, 4, 4, 32), dtype=np.float32),
            "emb": rng.standard_normal((2, 64), dtype=np.float32),
            "ctx": rng.standard_normal((2, 5, 24), dtype=np.float32),
            "img": rng.standard_normal((2, 4, 24), dtype=np.float32)}


# name: (JAX module, port module, the inputs' names); the spatial blocks
# see 128 tokens a frame (the port's flash route), the temporal ones 6
# frames, which the relative-position table (max_len 2) clips
_BLOCKS = {
    "resblock_skip_tconv": (
        lambda: JU.ResBlock3D(48, use_temporal_conv=True),
        lambda: PU.ResBlock3D(32, 48, 64, use_temporal_conv=True),
        ("x32", "emb")),
    "resblock_scale_shift": (
        lambda: JU.ResBlock3D(48, use_scale_shift_norm=True),
        lambda: PU.ResBlock3D(48, 48, 64, use_scale_shift_norm=True),
        ("x48", "emb")),
    "spatial": (
        lambda: JU.SpatialTransformer(2, 16, 24),
        lambda: PU.SpatialTransformer(32, 2, 16, 24), ("x32", "ctx")),
    "spatial_image_cross": (
        lambda: JU.SpatialTransformer(2, 16, 24, image_cross=True,
                                      img_cross_scale=0.7),
        lambda: PU.SpatialTransformer(32, 2, 16, 24, image_cross=True,
                                      img_cross_scale=0.7),
        ("x32", "ctx", "img")),
    "temporal": (
        lambda: JU.TemporalTransformer(2, 16, max_len=2,
                                       use_relative_position=False),
        lambda: PU.TemporalTransformer(32, 2, 16, 2, False), ("x_t6",)),
    "temporal_rel_pos": (
        lambda: JU.TemporalTransformer(2, 16, max_len=2),
        lambda: PU.TemporalTransformer(32, 2, 16, 2, True), ("x_t6",)),
}


@pytest.mark.parametrize("name", list(_BLOCKS))
def test_unet_blocks_match_jax(name):
    jmod, pmod, names = _BLOCKS[name]
    jmod, pmod = jmod(), pmod()
    inputs = [_block_inputs()[n] for n in names]
    params = jax_params(jmod, *inputs, like=pmod)
    ref = jax.jit(lambda p, *a: jmod.apply({"params": p}, *a))(params,
                                                               *inputs)
    load_jax_params(pmod, params)
    with torch.no_grad():
        _close(pmod(*map(_t, inputs)), ref, MODULE_TOL)


# ---------------------------------------------------------------- the UNet
def _unet_config(path, overrides):
    cfg = pconfig.load_configs([path], overrides)
    return cfg["flow"]["params"]["denoiser_config"]["params"]


def test_unet3d_matches_jax():
    """The whole UNet with fps conditioning: VideoCrafter1's (relative
    positions, no temporal conv; DynamiCrafter's, with its image tokens and
    concatenated image latent, is held to JAX through the flow's
    ``denoise_apply`` in ``test_dc_unet_image_cond_and_sampling_match_jax``)."""
    kw = _unet_config(VC1_T2V, NARROW)
    assert kw["use_relative_position"] and not kw["temporal_conv"]
    rng = np.random.default_rng(1)
    inputs = [rng.standard_normal((2, 2, 16, 16, 4), dtype=np.float32),
              np.array([20, 970], np.int32),
              rng.standard_normal((2, 7, 32), dtype=np.float32), None,
              np.array([8.0, 24.0], np.float32)]
    jmod = JU.UNet3D(**kw)
    pmod = PU.UNet3D(**kw)
    params = jax_params(jmod, *inputs, like=pmod)
    ref = jax.jit(lambda p, *a: jmod.apply({"params": p}, *a))(params,
                                                               *inputs)
    load_jax_params(pmod, params)
    with torch.no_grad():
        out = pmod(*[None if a is None else _t(a) for a in inputs])
    assert out.shape == (2, 2, 16, 16, 4) and out.dtype == torch.float32
    _close(out, ref, MODULE_TOL)


# ---------------------------------------------------------------- images
def test_image_conditioner_and_resampler_match_jax():
    """DynamiCrafter's tower on images at video size (resized to the CLIP
    grid inside, antialiased bilinear as ``jax.image.resize``), the
    resampler with ``video_length`` tiling and ``ImageProjModel``."""
    rng = np.random.default_rng(2)
    images = rng.uniform(-1, 1, (2, 40, 52, 3)).astype(np.float32)
    kw = dict(image_size=28, clip_dim=32, clip_heads=2, clip_layers=2,
              dim=24, depth=2, heads=2, num_queries=4, output_dim=24)
    cases = [(JI.ImageConditioner(**kw), PI.ImageConditioner(**kw), images),
             (JI.Resampler(dim=24, depth=1, heads=2, num_queries=3,
                           embedding_dim=32, output_dim=24, video_length=2),
              PI.Resampler(dim=24, depth=1, heads=2, num_queries=3,
                           embedding_dim=32, output_dim=24, video_length=2),
              rng.standard_normal((2, 5, 32), dtype=np.float32)),
             (JI.ImageProjModel(24, 32, 4), PI.ImageProjModel(24, 32, 4),
              rng.standard_normal((2, 32), dtype=np.float32))]
    for jmod, pmod, x in cases:
        params = jax_params(jmod, x, like=pmod)
        ref = jax.jit(lambda p, a, m=jmod: m.apply({"params": p}, a))(
            params, x)
        load_jax_params(pmod, params)
        with torch.no_grad():
            _close(pmod(_t(x)), ref, MODULE_TOL)
    assert ref.shape == (2, 4, 24)
    np.testing.assert_allclose(
        PI.resize_bilinear(_t(images), (28, 28)).numpy(),
        jax.image.resize(jnp.asarray(images), (2, 28, 28, 3), "bilinear"),
        rtol=0, atol=1e-6)


def test_clip_image_embedder_resizes_where_jax_fails():
    """The JAX ``CLIPImageEmbedder`` sizes its position table by its init
    input and fails on an image of another size (VideoCrafter1 I2V and Wan
    I2V hand it video-size frames; ROADMAP.md queue 3); the port resizes
    to ``image_size`` first and gives what JAX gives on the resized
    image."""
    kw = dict(image_size=28, dim=32, heads=2, num_layers=2)
    images = np.random.default_rng(3).uniform(
        -1, 1, (1, 64, 96, 3)).astype(np.float32)
    small = np.asarray(jax.image.resize(jnp.asarray(images), (1, 28, 28, 3),
                                        "bilinear"))
    jmod = JI.CLIPImageEmbedder(**kw)
    params = jax_params(jmod, small)
    with pytest.raises(Exception, match="pos_embed"):
        jax.eval_shape(lambda p, a: jmod.apply({"params": p}, a), params,
                       images)
    ref = jax.jit(lambda p, a: jmod.apply({"params": p}, a))(params, small)
    pmod = PI.CLIPImageEmbedder(**kw)
    load_jax_params(pmod, params)
    with torch.no_grad():
        _close(pmod(_t(images)), ref, MODULE_TOL)
        _close(pmod(_t(small)), ref, MODULE_TOL)


def test_resampler_heads_that_do_not_divide_its_width():
    """DynamiCrafter's config gives its resampler 12 heads over dim 1024:
    the JAX module's heads are dim / heads wide, and its init fails on the
    reshape (ROADMAP.md queue 3); the port's heads are then 64 wide, the
    reference resampler's ``dim_head`` (12·64 = 768 inner features), and
    the config's tower builds and runs."""
    x = np.zeros((1, 5, 32), np.float32)
    with pytest.raises(Exception):
        jax.eval_shape(JI.Resampler(dim=1024, heads=12, depth=1,
                                    embedding_dim=32).init,
                       jax.random.key(0), x)
    pmod = PI.Resampler(dim=1024, heads=12, depth=1, embedding_dim=32,
                        num_queries=4, output_dim=24)
    assert pmod.head_dim == 64 and pmod.q_0.weight.shape == (768, 1024)
    assert pmod.attn_out_0.weight.shape == (1024, 768)
    with torch.no_grad():
        out = pmod(torch.randn((2, 5, 32)))
    assert out.shape == (2, 4, 24) and torch.isfinite(out).all()
    # where the heads divide the width, dim / heads as in the JAX package
    assert PI.Resampler(dim=1024, heads=16).head_dim == 64
    assert PI.Resampler(dim=24, heads=2).head_dim == 12


def _resampler_plain(p, x, depth, heads, head_dim, video_length):
    """The perceiver resampler written out in f64 over a state dict:
    LayerNorms, per-head einsum attention of the latents over the image
    tokens and themselves, the tanh-GELU feed-forward, the output
    projection and its LayerNorm."""
    p = {k: v.double() for k, v in p.items()}

    def ln(t, name):
        mu = t.mean(-1, keepdim=True)
        var = ((t - mu) ** 2).mean(-1, keepdim=True)
        return ((t - mu) / torch.sqrt(var + 1e-6) * p[f"{name}.weight"]
                + p[f"{name}.bias"])

    def gelu(t):
        return 0.5 * t * (1 + torch.tanh(
            np.sqrt(2 / np.pi) * (t + 0.044715 * t ** 3)))

    x = x.double() @ p["proj_in.weight"].T + p["proj_in.bias"]
    lat = p["latents"][None].expand(x.shape[0], -1, -1)
    lat = torch.cat([lat] * video_length, dim=1)
    for i in range(depth):
        hq = ln(lat, f"lnq_{i}")
        hk = ln(torch.cat([x, lat], dim=1), f"lnk_{i}")
        wq, wk, wv = (p[f"{s}_{i}.weight"].reshape(heads, head_dim, -1)
                      for s in "qkv")
        q = torch.einsum("bnc,hec->bhne", hq, wq)
        k = torch.einsum("bmc,hec->bhme", hk, wk)
        v = torch.einsum("bmc,hec->bhme", hk, wv)
        a = torch.softmax(torch.einsum("bhne,bhme->bhnm", q, k)
                          / np.sqrt(head_dim), dim=-1)
        o = torch.einsum("bhnm,bhme->bnhe", a, v).flatten(2)
        lat = lat + o @ p[f"attn_out_{i}.weight"].T
        h = ln(lat, f"lnf_{i}") @ p[f"ff1_{i}.weight"].T
        lat = lat + gelu(h) @ p[f"ff2_{i}.weight"].T
    out = lat @ p["proj_out.weight"].T + p["proj_out.bias"]
    return ln(out, "norm_out")


def test_resampler_12_heads_over_1024_matches_a_plain_reference():
    """DynamiCrafter's resampler layout, which the JAX module cannot build
    (12 heads over dim 1024: 64-wide heads, 768 inner features), against
    ``_resampler_plain`` over the same seeded weights, with the queries
    tiled over 2 frames and 2 layers; f32 against f64 within 1e-5 of
    max|ref|."""
    pmod = PI.Resampler(dim=1024, depth=2, heads=12, num_queries=4,
                        embedding_dim=32, output_dim=24, ff_mult=2,
                        video_length=2)
    rng = np.random.default_rng(14)
    state = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(
        np.float32) * (0.5 if v.ndim == 1 else v.shape[-1] ** -0.5))
        for k, v in pmod.state_dict().items()}
    pmod.load_state_dict(state)
    x = torch.from_numpy(rng.standard_normal((2, 5, 32)).astype(np.float32))
    with torch.no_grad():
        out = pmod(x)
    ref = _resampler_plain(state, x, 2, 12, 64, 2)
    assert out.shape == ref.shape == (2, 8, 24)
    _close(out, ref.numpy(), MODULE_TOL)


# ---------------------------------------------------------------- flows
@functools.cache
def _jax_flow(path, overrides):
    jcfg = jconfig.load_configs([path], list(overrides))
    jregistry.populate()
    jflow = jregistry.instantiate(jcfg["flow"])
    # the port's flow, whose components give the trees' shapes untraced
    pflow = pregistry.instantiate(
        pconfig.load_configs([path], list(overrides))["flow"], device="cpu")
    ex = jflow.example_inputs()
    params = {c: jax_params(getattr(jflow, c), *ex[c], seed=i,
                            like=getattr(pflow, c))
              for i, c in enumerate(("denoiser", "first_stage", "cond_stage",
                                     "cond_stage_2"))
              if getattr(jflow, c) is not None}
    return jflow, params


def _flows(path, overrides):
    jflow, params = _jax_flow(path, tuple(overrides))
    pflow = pregistry.instantiate(
        pconfig.load_configs([path], list(overrides))["flow"], device="cpu")
    load_flow_params(pflow, params)
    return jflow, pflow, params


@functools.cache
def _jax_text(path, overrides):
    jflow, params = _jax_flow(path, overrides)
    return jax.jit(lambda p: [jflow.encode_text(p, [s])
                              for s in (PROMPT, "")])(params)


@functools.cache
def _jax_denoise(path, overrides):
    """The JAX flow's ``denoise_apply`` under one jit, compiled once for
    each batch and conditioning layout."""
    jflow, _ = _jax_flow(path, overrides)
    return jax.jit(lambda p, x, t, c: jflow.denoise_apply(p, x, t, c))


def _jax_ddim(jflow, denoise, x_T):
    """The JAX flow's DDIM loop (η = 0) step by step, with ``denoise``
    compiled apart: what its ``scheduler.sample`` computes in one scan."""
    x = jnp.asarray(x_T)
    for i in range(jflow.scheduler.num_steps - 1, -1, -1):
        x = jflow.scheduler.step(denoise, x, i, jax.random.key(0))
    return x


def _image(seed=4):
    return np.random.default_rng(seed).uniform(
        -1.0, 1.0, (1, HEIGHT, WIDTH, 3)).astype(np.float32)


def test_vc2_t2v_sampling_and_decode_match_jax():
    """VideoCrafter2 (v-prediction, zero terminal SNR): the prompt and the
    empty prompt through CLIP, the same x_T through 2 DDIM steps with CFG
    12, then the frame-wise decode."""
    jflow, pflow, params = _flows(VC2, NARROW)
    assert jflow.base_schedule.parameterization == "v"
    jcond, juncond = _jax_text(VC2, tuple(NARROW))
    shape = jflow.latent_shape(1, FRAMES, HEIGHT, WIDTH)
    assert shape == (1, 2, 16, 16, 4) and jflow.scheduler.num_steps == 2
    x_T = np.random.default_rng(5).standard_normal(shape, dtype=np.float32)
    model = _jax_denoise(VC2, tuple(NARROW))
    jz = _jax_ddim(jflow, jcfg_denoise(
        lambda x, t, c: model(params, x, t, c), jcond, juncond, 12.0), x_T)
    jvideo = jax.jit(jflow.decode_latents)(params, jz)

    pcond, puncond = (pflow.encode_text([s]) for s in (PROMPT, ""))
    _close(pcond["y"], jcond["y"], MODULE_TOL)
    assert pcond["y"].shape == (1, 77, 32)
    pz = pflow.sample(pcond, puncond, shape, None, 12.0, x_T=_t(x_T))
    _close(pz, jz, TRAJ_TOL)
    video = pflow.decode_latents(pz)
    assert video.shape == (1, FRAMES, HEIGHT, WIDTH, 3)
    _close(video, jvideo, PIXEL_TOL)


def test_vc2_enhance_ddim_matches_jax():
    """``GenerationFlow.enhance``'s DDIM branch (SDEdit, ``inference-v2v-
    ms``'s path): a 2-frame clip encoded, entered at timesteps[1] by
    q_sample (strength 1: both steps), then the DDIM walk with CFG 7.5 and
    the decode; the JAX key's draws (the encode's and the renoise) handed
    to the port (η = 0 draws nothing more)."""
    jflow, pflow, params = _flows(VC2, NARROW)
    jcond, juncond = _jax_text(VC2, tuple(NARROW))
    video = _image(9)[:, None].repeat(FRAMES, axis=1)
    video[:, 1] *= 0.5
    key = jax.random.key(8)
    jout = jax.jit(lambda p, v, c, u: jflow.enhance(
        p, v, c, key, strength=1.0, cfg_scale=7.5, uncond=u))(
        params, jnp.asarray(video), jcond, juncond)
    shape = jflow.latent_shape(1, FRAMES, HEIGHT, WIDTH)
    k_enc, k_noise, _ = jax.random.split(key, 3)
    post, noise = (_t(np.asarray(jax.random.normal(k, shape)))
                   for k in (k_enc, k_noise))
    out = pflow.enhance(_t(video), pflow.encode_text([PROMPT]), None, 1.0,
                        7.5, pflow.encode_text([""]), posterior_noise=post,
                        noise=noise)
    _close(out, jout, PIXEL_TOL)


def test_videocrafter_training_loss_and_grads_match_jax():
    """VideoCrafter2's v-prediction MSE on latents, text states and fps,
    the text dropped for the samples JAX's key drops (uncond_prob 0.5, a
    key whose draw drops one of the two): the draws JAX makes from its key
    (t, noise, drop) handed to the port; the loss and every gradient."""
    overrides = NARROW + ["flow.params.uncond_prob=0.5"]
    # the parameter trees do not depend on uncond_prob: NARROW's, cached
    _, params = _jax_flow(VC2, tuple(NARROW))
    jflow = jregistry.instantiate(jconfig.load_configs([VC2],
                                                       overrides)["flow"])
    pflow = pregistry.instantiate(
        pconfig.load_configs([VC2], overrides)["flow"], device="cpu")
    load_flow_params(pflow, params)
    rng = np.random.default_rng(7)
    z = rng.standard_normal((2, 2, 16, 16, 4), dtype=np.float32)
    text = rng.standard_normal((2, 77, 32), dtype=np.float32)
    fps = np.array([8.0, 28.0], np.float32)
    for seed in range(16):
        key = jax.random.key(seed)
        _, k_t, k_noise, k_drop = jax.random.split(key, 4)
        drop = np.asarray(jax.random.bernoulli(k_drop, 0.5, (2,)))
        if drop.any() and not drop.all():
            break
    jbatch = {"latents": jnp.asarray(z), "text_states": jnp.asarray(text),
              "fps": jnp.asarray(fps)}

    def jloss(den):
        return jflow.training_loss(dict(params, denoiser=den), jbatch, key)

    (jl, _), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params["denoiser"])
    t = jax.random.randint(k_t, (2,), 0, jflow.base_schedule.num_timesteps)
    noise = jax.random.normal(k_noise, z.shape)
    pflow.denoiser.requires_grad_(True)
    pl, aux = pflow.training_loss(
        {"latents": _t(z), "text_states": _t(text), "fps": _t(fps)},
        t=_t(np.asarray(t)).long(), noise=_t(np.asarray(noise)),
        drop=_t(drop))
    pl.backward()
    assert aux["loss"] is pl
    np.testing.assert_allclose(float(pl.detach()), float(jl), rtol=1e-5)
    ref = PU.UNet3D(**_unet_config(VC2, overrides))
    load_jax_params(ref, jax.device_get(jg))
    gmax = max(float(r.detach().abs().max()) for r in ref.parameters())
    for name, p in pflow.denoiser.named_parameters():
        r = ref.get_parameter(name).detach()
        torch.testing.assert_close(
            p.grad, r, rtol=0,
            atol=TRAJ_TOL * float(r.abs().max()) + 1e-7 * gmax, msg=name)


# ---------------------------------------------------------------- commands
def _inputs_dir(tmp_path):
    import cv2
    inputs = tmp_path / "inputs"
    inputs.mkdir()
    cv2.imwrite(str(inputs / "image.png"), np.random.default_rng(0).integers(
        0, 256, (90, 120, 3), dtype=np.uint8))
    (inputs / "prompts.txt").write_text(PROMPT + "\n")
    return inputs


@pytest.mark.parametrize("name,narrow,i2v", [
    ("inference-vc2-t2v-320x512", NARROW, False),
    ("inference-vc2-t2v-320x512-lora", NARROW, False),
    ("inference-dc-i2v-576x1024", NARROW_DC, True),
    ("inference-vc1-t2v-576x1024", NARROW, False),
    ("inference-vc1-i2v-320x512", NARROW_VC1_I2V, True)])
def test_videocrafter_commands_run_the_port(name, narrow, i2v, tmp_path):
    """Each command runs the port's CLI on the CPU, narrowed, 2 steps at
    2×128×128: an i2v one from a directory of one seeded PNG and a .txt;
    the LoRA one merges a LoRA checkpoint of the port's trainer layout
    over its config's targets (attn1, attn2, fc1, fc2)."""
    from videotuna_tpu_torch.training import lora as plora
    assert name not in pcommands.WAITING
    out = tmp_path / "out"
    argv = [name, "--device", "cpu", "--quiet", "--savedir", str(out),
            *narrow]
    argv.append(f"inference.input_dir={_inputs_dir(tmp_path)}" if i2v
                else f"inference.prompt={PROMPT}")
    if name.endswith("-lora"):
        den = pregistry.instantiate(pconfig.load_configs(
            [pcommands.COMMANDS[name].configs[0]], narrow)["flow"]["params"]
            ["denoiser_config"])
        targets = ("attn1", "attn2", "fc1", "fc2")
        tree = plora.init_lora(den, rank=2, match=plora.lora_target(*targets),
                               generator=torch.Generator().manual_seed(0))
        assert tree
        torch.save({"denoiser": tree}, tmp_path / "lora.pt")
        argv += ["--lora", str(tmp_path / "lora.pt")]
    assert pcommands.main(argv) == 0
    m = json.loads((out / "metric.json").read_text())
    assert m["num_videos"] == 1 and m["denoise_steps"] == 2
    assert m["latent_shape"] == [1, FRAMES, 16, 16, 4]
    assert (m["image_encode_sec"] > 0) == i2v
    assert m["nonfinite_latents"] == 0 == m["nonfinite_pixels"]


def test_training_commands_wait_for_unet_training(capsys):
    """UNet3D training runs in the port (``tests/test_torch_port_vc_train.py``
    drives both commands): only ``train-dynamicrafter`` waits, for queue 3's
    fault of the JAX package's DynamiCrafter loss."""
    for name in ("train-videocrafter-v2", "train-videocrafter-lora"):
        assert name not in pcommands.WAITING
        assert pcommands.COMMANDS[name].mode == "train"
    assert pcommands.main(["train-dynamicrafter", "--device", "cpu"]) == 2
    assert "queue 3's DynamiCrafter training fault" in \
        capsys.readouterr().err


# ---------------------------------------------------------------- queue 3
def test_vc1_i2v_unet_ignores_its_image_tokens():
    """VideoCrafter1 I2V's config gives its UNet neither image
    cross-attention nor extra input channels, so in both packages the
    CLIP tokens that ``prepare_image_cond`` attaches change nothing
    (ROADMAP.md queue 3): the JAX flow's UNet has no image path, and the
    port's gives the same output with and without the tokens."""
    jcfg = jconfig.load_configs([VC1_I2V], NARROW_VC1_I2V)
    jregistry.populate()
    jden = jregistry.instantiate(jcfg["flow"]).denoiser
    assert not jden.use_image_attention and jden.in_channels == 4
    pflow = pregistry.instantiate(jcfg["flow"], device="cpu")
    pflow.init_params(seed=0)
    assert not any("_ip" in n for n, _ in
                   pflow.denoiser.named_parameters())
    rng = np.random.default_rng(8)
    x = _t(rng.standard_normal((1, 2, 16, 16, 4), dtype=np.float32))
    t, y = torch.tensor([500]), _t(rng.standard_normal((1, 77, 32),
                                                       dtype=np.float32))
    with torch.no_grad():
        tokens = pflow.cond_stage_2(_t(_image()))
        assert tokens.shape == (1, 4, 32)
        torch.testing.assert_close(
            pflow.denoise_apply(x, t, {"y": y, "context_img": tokens}),
            pflow.denoise_apply(x, t, {"y": y}), rtol=0, atol=0)
