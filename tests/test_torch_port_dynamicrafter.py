"""The port's DynamiCrafter I2V against the JAX package on the CPU (split
from ``tests/test_torch_port_videocrafter.py``, whose harness, narrow
configs and tolerances it shares): the image conditioning (the image
tokens of CLIP and the resampler, the image's latent repeated over the
frames), one UNet call on them, DDIM sampling with CFG and with image and
text guidance apart, and the reference faults of DynamiCrafter's
inference (ROADMAP.md queue 3)."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videotuna_tpu.flows import generation as jgeneration
from videotuna_tpu.schedulers import cfg_denoise as jcfg_denoise
from videotuna_tpu.schedulers import multicond_cfg_denoise as jmulticond
from videotuna_tpu_torch.core import config as pconfig
from videotuna_tpu_torch.core import registry as pregistry

from tests.test_torch_port_models import torch_one_thread  # noqa: F401
from tests.test_torch_port_opensora import _close, _t
from tests.test_torch_port_videocrafter import (
    DC, FRAMES, HEIGHT, MODULE_TOL, NARROW_DC, PROMPT, ROOT, TRAJ_TOL, WIDTH,
    _flows, _image, _inputs_dir, _jax_ddim, _jax_denoise, _jax_flow,
    _jax_text)


@functools.cache
def _jax_image_cond():
    """JAX's ``prepare_image_cond`` of ``_image()`` on the narrow
    DynamiCrafter flow and the posterior noise it draws from its key."""
    jflow, params = _jax_flow(DC, tuple(NARROW_DC))
    jcond, juncond = _jax_text(DC, tuple(NARROW_DC))
    key = jax.random.key(11)
    jcond, juncond = jax.jit(lambda p, c, u, im: jflow.prepare_image_cond(
        p, c, u, im, FRAMES, HEIGHT, WIDTH, key))(params, jcond, juncond,
                                                  jnp.asarray(_image()))
    noise = jax.random.normal(key, (1, 1, HEIGHT // 8, WIDTH // 8, 4))
    return jcond, juncond, np.array(noise)


@pytest.mark.parametrize("image_scale", [None, 1.5],
                         ids=["cfg", "image_and_text_guidance"])
def test_dc_unet_image_cond_and_sampling_match_jax(image_scale):
    """DynamiCrafter: the image tokens (CLIP and the resampler) and the
    image's latent (a posterior sample, the JAX key's noise handed to the
    port) repeated over the frames; one UNet call on them (8 input
    channels, the image cross-attention); then 2 DDIM steps with CFG 7.5,
    or with image and text guidance apart (``sample``'s
    ``image_cfg_scale``: three model calls a step, the image-uncond one
    with zero image tokens)."""
    jflow, pflow, params = _flows(DC, NARROW_DC)
    jcond, juncond, noise = _jax_image_cond()
    pcond, puncond = pflow.prepare_image_cond(
        pflow.encode_text([PROMPT]), pflow.encode_text([""]),
        _t(_image()), FRAMES, HEIGHT, WIDTH, posterior_noise=_t(noise))
    assert pcond["context_img"].shape == (1, 4, 32)
    assert pcond["img_latents"].shape == (1, FRAMES, 16, 16, 4)
    for k in ("context_img", "img_latents"):
        _close(pcond[k], jcond[k], MODULE_TOL)
        assert puncond[k] is pcond[k]
    shape = jflow.latent_shape(1, FRAMES, HEIGHT, WIDTH)
    x_T = np.random.default_rng(6).standard_normal(shape, dtype=np.float32)
    model = functools.partial(_jax_denoise(DC, tuple(NARROW_DC)), params)
    if image_scale is None:
        denoise = jcfg_denoise(model, jcond, juncond, 7.5)
        x2, t2 = np.concatenate([x_T, x_T]), np.array([300, 300])
        c2 = {k: np.concatenate([juncond[k], jcond[k]]) for k in jcond}
        with torch.inference_mode():
            call = pflow.denoise_apply(_t(x2), _t(t2), {
                k: _t(v) for k, v in c2.items()})
        _close(call, model(x2, t2, c2), MODULE_TOL)
    else:
        img_uncond = dict(jcond, context_img=jnp.zeros_like(
            jcond["context_img"]))
        denoise = jmulticond(model, jcond, juncond, img_uncond, 7.5,
                             image_scale)
    jz = _jax_ddim(jflow, denoise, x_T)
    pz = pflow.sample(pcond, puncond, shape, None, 7.5, x_T=_t(x_T),
                      image_cfg_scale=image_scale)
    _close(pz, jz, TRAJ_TOL)


def test_inference_never_passes_the_image_scale(monkeypatch, tmp_path):
    """Both packages' ``GenerationFlow.inference`` call ``sample`` with the
    text scale alone, so DynamiCrafter's ``cfg_img`` (1.0 in its config)
    and ``sample``'s image-and-text guidance are never reached from
    inference: the port follows the JAX package (ROADMAP.md queue 3)."""
    seen = {}

    class Stop(Exception):
        pass

    def record(pkg):
        def sample(self, *args, **kwargs):
            seen[pkg] = (len(args), sorted(kwargs))
            raise Stop
        return sample

    inputs = _inputs_dir(tmp_path)
    jflow, pflow, params = _flows(DC, NARROW_DC)
    jflow.params = params
    cfg = pconfig.load_configs([DC], NARROW_DC + [
        f"inference.input_dir={inputs}",
        f"inference.savedir={tmp_path / 'out'}"])
    assert cfg["inference"]["cfg_img"] == 1.0
    monkeypatch.setattr(type(jflow), "sample", record("jax"))
    monkeypatch.setattr(type(pflow), "sample", record("port"))
    # the JAX flow's encodes are not what this test reads: cached and
    # passed through, so that its inference reaches sample at once
    jtext = _jax_text(DC, tuple(NARROW_DC))
    monkeypatch.setattr(jflow, "encode_text",
                        lambda p, texts: jtext[not texts[0]])
    monkeypatch.setattr(jflow, "prepare_image_cond",
                        lambda p, c, u, *args: (c, u))
    for flow in (jflow, pflow):
        with pytest.raises(Stop):
            flow.inference(cfg)
    # (params,) cond, uncond, shape, key, cfg_scale: no image scale
    assert seen == {"jax": (6, []), "port": (5, [])}


def test_dc_prompt_dir_names_no_directory():
    """``dc_i2v_576x1024.yaml``'s ``prompt_dir: inputs/i2v/576x1024`` does
    not exist: the JAX package's inference reads it as a prompt file and
    fails; the port's i2v flow asks for ``inference.input_dir`` (the path
    the registry's command runs with)."""
    cfg = pconfig.load_configs([DC], NARROW_DC)
    assert not os.path.exists(os.path.join(ROOT, cfg["inference"]
                                           ["prompt_dir"]))
    with pytest.raises(FileNotFoundError):
        jgeneration.load_prompts(cfg["inference"])
    pflow = pregistry.instantiate(cfg["flow"], device="cpu")
    with pytest.raises(ValueError, match="inference.input_dir"):
        pflow.inference(cfg)
