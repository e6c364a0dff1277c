"""CogVideoX image-to-video and CogVideoX 1.5's temporal patch in the port,
against the JAX package on the CPU.

The flows are ``tiny_cogvideox.yaml`` with overrides (no config file is
added): the i2v flow takes ``i2v_mode`` and 32 input channels, and its VAE a
fourth level so that an image encodes to the 8× smaller latent grid; the
1.5 flows take ``patch_size`` (2, 2, 2).  Each JAX flow is built once a
module, its parameter tree (seeded numpy values) carried into the port with
``tools/from_jax``.  Latents are held to ``TRAJ_TOL`` and pixels to
``PIXEL_TOL`` of max|ref| (``test_torch_port_flow.py``).

- ``load_inputs_i2v`` on a directory of two seeded PNGs and a .txt;
- ``prepare_image_latents`` given the JAX posterior's draw;
- i2v sampling, trailing DDIM and SDE-DPM++ with dynamic CFG, from the same
  x_T and per-step noise, then the decode;
- the i2v training loss and its gradients, given ``image_latents``;
- CogVideoX 1.5: JAX's ``sample`` fails at the odd latent frame count its
  ``latent_shape`` gives (a reference fault); the port samples one frame
  more in front, its trajectory equals JAX's ``sample`` at that padded
  shape, and its decode of the kept frames equals JAX's decode of them;
  in i2v the padded front frame repeats the image frame;
- the port's two ``ValueError``s: i2v inference without images, i2v
  training without ``image_latents`` (where JAX fails in the denoiser).
"""

import copy
import functools
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videotuna_tpu.core import config as jconfig
from videotuna_tpu.core import registry as jregistry
from videotuna_tpu.flows import generation as jgeneration
from videotuna_tpu_torch.core import config as pconfig
from videotuna_tpu_torch.core import registry as pregistry
from videotuna_tpu_torch.flows import generation as pgeneration
from videotuna_tpu_torch.tools.from_jax import (load_flow_params,
                                                load_jax_params)

from tests.test_torch_port_flow import (PIXEL_TOL, TINY, TRAJ_TOL, _close,
                                        _jax_params)
from tests.test_torch_port_models import (  # noqa: F401
    jax_params, torch_one_thread)

FRAMES, HEIGHT, WIDTH = 9, 32, 32        # 3 latent frames of 4×4
_VAE = ("flow.params.first_stage_config.params.ch_mult=[1, 2, 2, 2]",)
_I2V = ("flow.params.i2v_mode=true",
        "flow.params.denoiser_config.params.in_channels=32") + _VAE
_PATCH_T2 = ("flow.params.denoiser_config.params.patch_size=[2, 2, 2]",
             ) + _VAE
_DPM = ("flow.params.scheduler_config.target="
        "videotuna_tpu.schedulers.CogVideoXDPMSchedule",
        "flow.params.scheduler_config.params.num_steps=4",
        "flow.params.use_dynamic_cfg=true")
PROMPT = "a panda eating bamboo"


def _model(overrides):
    """The overrides that shape the weights (the scheduler's do not)."""
    return tuple(o for o in overrides if o not in _DPM)


@functools.cache
def _jax_flow(overrides):
    """The JAX flow and its seeded weights.  Every flow here has the same
    VAE and T5 and takes their weights from the i2v flow; flows that differ
    in the scheduler alone share the denoiser's too."""
    jregistry.populate()
    jflow = jregistry.instantiate(
        jconfig.load_configs([TINY], list(overrides))["flow"])
    model = _model(overrides)
    if model != overrides:
        return jflow, _jax_flow(model)[1]
    # the port's flow, whose components give the trees' shapes untraced
    pflow = pregistry.instantiate(
        pconfig.load_configs([TINY], list(overrides))["flow"], device="cpu")
    if overrides == _I2V:
        return jflow, _jax_params(jflow, pflow=pflow)
    return jflow, dict(_jax_flow(_I2V)[1], denoiser=jax_params(
        jflow.denoiser, like=pflow.denoiser))


@functools.cache
def _jax_text():
    """JAX's encode of the prompt and of the empty negative prompt."""
    jflow, params = _jax_flow(_I2V)
    return jax.jit(lambda p: (jflow.encode_text(p, [PROMPT]),
                              jflow.encode_text(p, [""])))(params)


@functools.cache
def _jax_decode():
    return jax.jit(_jax_flow(_I2V)[0].decode_latents)


def _flows(overrides):
    jflow, params = _jax_flow(overrides)
    pflow = pregistry.instantiate(
        pconfig.load_configs([TINY], list(overrides))["flow"], device="cpu")
    load_flow_params(pflow, params)
    return jflow, pflow, params


def _image(seed=4):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, 1.0, (1, HEIGHT, WIDTH, 3)).astype(np.float32)


@functools.cache
def _jax_image_latents(model):
    """JAX's ``prepare_image_cond`` of ``_image()`` and the draw it makes
    inside from its key (the posterior noise)."""
    jflow, params = _jax_flow(model)
    key = jax.random.key(11)

    def prepare(p, cond, uncond, image):
        cond, uncond = jflow.prepare_image_cond(p, cond, uncond, image,
                                                FRAMES, HEIGHT, WIDTH, key)
        return cond, uncond["image_latents"]

    jcond, il_uncond = jax.jit(prepare)(params, *_jax_text(),
                                        jnp.asarray(_image()))
    np.testing.assert_array_equal(il_uncond, jcond["image_latents"])
    juncond = dict(_jax_text()[1], image_latents=il_uncond)
    noise = jax.random.normal(key, (1, 1, HEIGHT // 8, WIDTH // 8, 16))
    return jcond, juncond, np.array(noise)


def test_load_inputs_i2v_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    for name, (h, w) in (("b_wide.png", (40, 90)), ("a_tall.png", (70, 30)),
                         ("c_unpaired.jpg", (20, 20))):
        cv2.imwrite(str(tmp_path / name),
                    rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    (tmp_path / "prompts.txt").write_text("a tall tree\n\na wide lake\n")
    jnames, jimages, jprompts = jgeneration.load_inputs_i2v(str(tmp_path),
                                                            (24, 32))
    pnames, pimages, pprompts = pgeneration.load_inputs_i2v(str(tmp_path),
                                                            (24, 32))
    assert pnames == jnames == ["a_tall", "b_wide"]
    assert pprompts == jprompts == ["a tall tree", "a wide lake"]
    assert pimages.dtype == torch.float32
    np.testing.assert_array_equal(pimages.numpy(), np.asarray(jimages))
    assert pimages.shape == (2, 24, 32, 3)
    assert -1.0 <= float(pimages.min()) and float(pimages.max()) <= 1.0


def test_prepare_image_latents_matches_jax():
    jflow, pflow, params = _flows(_I2V)
    jcond, _, noise = _jax_image_latents(_I2V)
    n = pflow.latent_shape(1, FRAMES, HEIGHT, WIDTH)[1]
    il = pflow.prepare_image_latents(torch.from_numpy(_image()), n,
                                     posterior_noise=torch.from_numpy(noise))
    _close(il, jcond["image_latents"], TRAJ_TOL)
    assert il.shape == (1, 3, 4, 4, 16) and not il[:, 1:].any()


@pytest.mark.parametrize("overrides", [_I2V, _I2V + _DPM],
                         ids=["ddim", "dpm_dynamic_cfg"])
def test_i2v_sampling_and_decode_match_jax(overrides):
    jflow, pflow, params = _flows(overrides)
    jcond, juncond, noise = _jax_image_latents(_model(overrides))
    shape = jflow.latent_shape(1, FRAMES, HEIGHT, WIDTH)
    assert pflow.latent_shape(1, FRAMES, HEIGHT, WIDTH) == shape
    steps = jflow.scheduler.num_steps
    rng = np.random.default_rng(1)
    x_T = rng.standard_normal(shape, dtype=np.float32)
    noises = rng.standard_normal((steps, *shape), dtype=np.float32)
    scale = 6.0

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
    jvideo = _jax_decode()(params, jz)

    pcond, puncond = pflow.prepare_image_cond(
        pflow.encode_text([PROMPT]), pflow.encode_text([""]),
        torch.from_numpy(_image()), FRAMES, HEIGHT, WIDTH,
        posterior_noise=torch.from_numpy(noise))
    assert puncond["image_latents"] is pcond["image_latents"]
    pz = pflow.sample(pcond, puncond, shape, None, scale,
                      x_T=torch.from_numpy(x_T),
                      noises=(torch.from_numpy(noises)
                              if pflow.use_dynamic_cfg else None))
    _close(pz, jz, TRAJ_TOL)
    _close(pflow.decode_latents(pflow.kept_latents(pz, FRAMES)), jvideo,
           PIXEL_TOL)


def test_i2v_training_loss_and_grads_match_jax():
    jflow, pflow, params = _flows(_I2V)
    jcond, _ = _jax_text()
    rng = np.random.default_rng(3)
    b = 2
    shape = jflow.latent_shape(b, FRAMES, HEIGHT, WIDTH)
    image_latents = np.zeros(shape, np.float32)
    image_latents[:, 0] = rng.standard_normal(shape[2:], dtype=np.float32)
    inputs = {"latents": rng.standard_normal(shape, dtype=np.float32),
              "image_latents": image_latents,
              "text_states": np.repeat(np.asarray(jcond["y"]), b, axis=0)}
    jbatch = {k: jnp.asarray(v) for k, v in inputs.items()}
    pbatch = {k: torch.from_numpy(v) for k, v in inputs.items()}
    key = jax.random.key(5)
    _, k_t, k_noise = jax.random.split(key, 3)   # JAX's draws from `key`
    t = jax.random.randint(k_t, (b,), 0, jflow.base_schedule.num_timesteps)
    noise = jax.random.normal(k_noise, shape)

    def jloss(den):
        return jflow.training_loss(dict(params, denoiser=den), jbatch, key)

    (jl, _), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params["denoiser"])
    pflow.denoiser.requires_grad_(True)
    pl, _ = pflow.training_loss(pbatch, t=torch.tensor(np.asarray(t)),
                                noise=torch.tensor(np.asarray(noise)))
    pl.backward()
    _close(pl, jl, 1e-5)
    ref = copy.deepcopy(pflow.denoiser)
    load_jax_params(ref, jax.device_get(jg))
    gmax = max(float(r.detach().abs().max()) for r in ref.parameters())
    assert pflow.denoiser.patch_embed.weight.grad.shape[1] == 32
    for name, p in pflow.denoiser.named_parameters():
        r = ref.get_parameter(name).detach()
        torch.testing.assert_close(p.grad, r, rtol=0,
                                   atol=1e-5 * float(r.abs().max())
                                   + 1e-7 * gmax, msg=name)


def test_cogvideox15_pads_the_temporal_patch_where_jax_fails():
    """At 9 frames JAX's ``latent_shape`` gives 3 latent frames, which the
    (2, 2, 2) patch conv returns as 2: JAX's ``sample`` fails (ROADMAP.md
    queue 3).  The port samples 4, the first one padding: its trajectory is
    JAX's ``sample`` at the padded shape, and it decodes the last 3."""
    jflow, pflow, params = _flows(_PATCH_T2)
    jcond, juncond = _jax_text()
    odd = jflow.latent_shape(1, FRAMES, HEIGHT, WIDTH)
    assert odd[1] == 3
    key = jax.random.key(2)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jflow.sample(params, jcond, juncond, odd, key, 6.0)

    shape = pflow.latent_shape(1, FRAMES, HEIGHT, WIDTH)
    assert shape == (1, 4, *odd[2:]) and pflow.front_pad(3) == 1
    jz = jax.jit(lambda p, c, u: jflow.sample(p, c, u, shape, key, 6.0))(
        params, jcond, juncond)
    x_T = jax.random.normal(jax.random.split(key)[1], shape)  # JAX's draw
    pz = pflow.sample(pflow.encode_text([PROMPT]), pflow.encode_text([""]),
                      shape, None, 6.0, x_T=torch.tensor(np.asarray(x_T)))
    _close(pz, jz, TRAJ_TOL)
    kept = pflow.kept_latents(pz, FRAMES)
    assert kept.shape[1] == 3
    _close(pflow.decode_latents(kept),
           _jax_decode()(params, jz[:, 1:]), PIXEL_TOL)


def test_cogvideox15_i2v_front_pad_repeats_the_image_frame():
    pflow = pregistry.instantiate(pconfig.load_configs(
        [TINY], list(_I2V + _PATCH_T2))["flow"], device="cpu")
    pflow.init_params(seed=0)
    image = torch.from_numpy(_image())
    noise = torch.randn((1, 1, 4, 4, 16),
                        generator=torch.Generator().manual_seed(0))
    cond, uncond = pflow.prepare_image_cond(
        {"y": torch.zeros(1, 6, 16)}, {"y": torch.zeros(1, 6, 16)}, image,
        FRAMES, HEIGHT, WIDTH, posterior_noise=noise)
    il = cond["image_latents"]
    assert uncond["image_latents"] is il
    assert il.shape == pflow.latent_shape(1, FRAMES, HEIGHT, WIDTH)
    assert il.shape[1] == 4 and il[:, 0].abs().max() > 0
    torch.testing.assert_close(il[:, 0], il[:, 1], rtol=0, atol=0)
    assert not il[:, 2:].any()
    torch.testing.assert_close(
        pflow.kept_latents(il, FRAMES),
        pflow.prepare_image_latents(image, 3, posterior_noise=noise),
        rtol=0, atol=0)
    with torch.inference_mode():
        out = pflow.denoise_apply(torch.zeros(il.shape), torch.tensor([500]),
                                  cond)
    assert out.shape == il.shape


def test_i2v_without_images_or_image_latents_raises(tmp_path):
    jflow, pflow, params = _flows(_I2V)
    config = {"inference": {"savedir": str(tmp_path), "frames": FRAMES,
                            "height": HEIGHT, "width": WIDTH,
                            "prompt_dir": "inputs/i2v/576x1024"}}
    with pytest.raises(ValueError,
                       match=r"inference\.input_dir.*queue 3"):
        pflow.inference(config)
    # the reference reads the configs' prompt_dir as a file
    with pytest.raises(FileNotFoundError, match="prompt_dir|576x1024"):
        jgeneration.load_prompts(config["inference"])

    shape = pflow.latent_shape(1, FRAMES, HEIGHT, WIDTH)
    batch = {"latents": np.zeros(shape, np.float32),
             "text_states": np.zeros((1, 6, 16), np.float32)}
    with pytest.raises(ValueError, match="image_latents.*queue 3"):
        pflow.training_loss({k: torch.from_numpy(v)
                             for k, v in batch.items()},
                            t=torch.tensor([1]), noise=torch.zeros(shape))
    # JAX's i2v training without image latents feeds 16 channels to the
    # 32-channel patch embedding
    with pytest.raises(Exception, match="patch_embed"):
        jflow.training_loss(params, {k: jnp.asarray(v)
                                     for k, v in batch.items()},
                            jax.random.key(0))
    assert not os.listdir(tmp_path)
