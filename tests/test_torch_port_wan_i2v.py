"""The port's Wan 2.1 image-to-video against the JAX package on the CPU:
``WanVideoFlow``'s image conditioning (the CLIP image embedder's tokens for
the DiT's image cross-attention, and [mask ; the image's latent zero-padded
over latent time] on the DiT's 36 input channels) and one sampled step with
CFG; the registry's ``inference-wanvideo-i2v-720p`` with the shipped config
and with the overrides that give it the I2V-14B layout (ROADMAP.md queue 3).

The harness of ROADMAP.md ("Parity harness"): seeded numpy trees carried
across with ``tools/from_jax``, the same numpy inputs, f32.  The I2V-14B
config at narrow width (the DiT at dim 256, 2 heads of d = 128, 2 layers;
a 2-layer T5 of dim 64; the VAE at dim 16; the CLIP embedder at dim 32, 2
layers, 28 px); 9×128×128 gives 3×16×16 latents, 192 tokens, over which
the port takes K3's plain version and the JAX package its reference
attention.  Tolerances, of max|ref|: 1e-5 for the conditioning, 1e-4 for
the step."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from videotuna_tpu.core import config as jconfig
from videotuna_tpu.core import registry as jregistry
from videotuna_tpu.flows import generation as jgeneration
from videotuna_tpu.flows.wan import WanVideoFlow as JWanFlow
from videotuna_tpu.schedulers import cfg_denoise as jcfg_denoise
from videotuna_tpu_torch.cli import commands as pcommands
from videotuna_tpu_torch.core import config as pconfig
from videotuna_tpu_torch.core import registry as pregistry
from videotuna_tpu_torch.flows import generation as pgeneration
from videotuna_tpu_torch.tools.from_jax import load_flow_params

from tests.test_torch_port_models import (  # noqa: F401
    jax_params, torch_one_thread)
from tests.test_torch_port_opensora import _close, _t
from tests.test_torch_port_wan import NARROW, PROMPT, ROOT

MODULE_TOL = 1e-5
TRAJ_TOL = 1e-4
CONFIG_I2V = os.path.join(ROOT, "configs", "008_wanvideo",
                          "wan2_1_i2v_14B.yaml")
_DEN = "flow.params.denoiser_config.params"
_CLIP = "flow.params.cond_stage_2_config"
# the layout the shipped config lacks (ROADMAP.md queue 3): i2v_mode, the
# DiT's 36 input channels and the CLIP image embedder as cond_stage_2
I2V = ["flow.params.i2v_mode=true", f"{_DEN}.in_channels=36",
       f"{_CLIP}.target=videotuna_tpu.models.lvdm.CLIPImageEmbedder"]
NARROW_I2V = NARROW + I2V + [
    f"{_DEN}.img_dim=32", f"{_CLIP}.params.image_size=28",
    f"{_CLIP}.params.dim=32", f"{_CLIP}.params.heads=2",
    f"{_CLIP}.params.num_layers=2",
    "flow.params.scheduler_config.params.num_steps=1"]
FRAMES, HEIGHT, WIDTH = 9, 128, 128


@pytest.fixture(scope="module")
def i2v_flows():
    """The narrow I2V flow in both packages with the same weights."""
    jcfg = jconfig.load_configs([CONFIG_I2V], NARROW_I2V)
    assert jcfg == pconfig.load_configs([CONFIG_I2V], NARROW_I2V)
    jregistry.populate()
    jflow = jregistry.instantiate(jcfg["flow"])
    pflow = pregistry.instantiate(jcfg["flow"], device="cpu")
    ex = jflow.example_inputs()
    params = {c: jax_params(getattr(jflow, c), *ex[c], seed=i,
                            like=getattr(pflow, c))
              for i, c in enumerate(("denoiser", "first_stage", "cond_stage",
                                     "cond_stage_2"))}
    load_flow_params(pflow, params)
    return jflow, pflow, params


def _image():
    return np.random.default_rng(3).uniform(
        -1.0, 1.0, (1, HEIGHT, WIDTH, 3)).astype(np.float32)


def _jax_image_cond(jflow, params, monkeypatch):
    """JAX's ``prepare_image_cond`` of ``_image()``, its CLIP embedder
    handed the image resized to its 28 px grid: at the video size the JAX
    embedder fails on its position table (ROADMAP.md queue 3), which the
    port's embedder resizes first."""
    image = jnp.asarray(_image())
    with pytest.raises(Exception, match="pos_embed"):
        jax.eval_shape(jflow.prepare_image_features, params, image)
    resized = jax.image.resize(image, (1, 28, 28, 3), "bilinear")
    monkeypatch.setattr(jflow, "prepare_image_features",
                        lambda p, im: JWanFlow.prepare_image_features(
                            jflow, p, resized))
    # under one jit each: cheaper on the CPU than op-by-op dispatch
    text = jax.jit(lambda p: [jflow.encode_text(p, [s])
                              for s in (PROMPT, "blurry")])(params)
    return jax.jit(lambda p, c, u, im: jflow.prepare_image_cond(
        p, c, u, im, FRAMES, HEIGHT, WIDTH, jax.random.key(0)))(
            params, *text, image)


def test_wan_i2v_image_cond_and_one_step_match_jax(i2v_flows, monkeypatch):
    """The image's CLIP tokens and the first-frame latents behind the mask
    block (latent frame 0 known), the same for the uncond half; then one
    UniPC step with CFG 5, its DiT call at B = 2 over 36 input channels with
    the image cross-attention."""
    jflow, pflow, params = i2v_flows
    jcond, juncond = _jax_image_cond(jflow, params, monkeypatch)
    pcond, puncond = pflow.prepare_image_cond(
        pflow.encode_text([PROMPT]), pflow.encode_text(["blurry"]),
        _t(_image()), FRAMES, HEIGHT, WIDTH)
    assert pcond["image_features"].shape == (1, 4, 32)
    ffl = pcond["first_frame_latents"]
    assert ffl.shape == (1, 3, 16, 16, 20)
    assert (ffl[:, 0, ..., :4] == 1).all() and not ffl[:, 1:].any()
    for k in ("image_features", "first_frame_latents"):
        _close(pcond[k], jcond[k], MODULE_TOL)
        assert puncond[k] is pcond[k]
        _close(puncond[k], juncond[k], MODULE_TOL)

    shape = jflow.latent_shape(1, FRAMES, HEIGHT, WIDTH)
    x_T = np.random.default_rng(4).standard_normal(shape, dtype=np.float32)
    denoise = jcfg_denoise(
        lambda x, t, c: jflow.denoise_apply(params, x, t, c), jcond, juncond,
        5.0)
    jz = jax.jit(lambda x: jflow.scheduler.sample(
        denoise, shape, jax.random.key(0), x_T=x))(jnp.asarray(x_T))
    pz = pflow.sample(pcond, puncond, shape, None, 5.0, x_T=_t(x_T))
    assert pflow.scheduler.num_steps == 1
    _close(pz, jz, TRAJ_TOL)


def _inputs(tmp_path):
    import cv2
    inputs = tmp_path / "inputs"
    inputs.mkdir()
    cv2.imwrite(str(inputs / "image.png"), np.random.default_rng(0).integers(
        0, 256, (90, 160, 3), dtype=np.uint8))
    (inputs / "prompts.txt").write_text(PROMPT + "\n")
    return inputs


def test_wan_i2v_command_shipped_config_and_i2v_layout(tmp_path):
    """``configs/008_wanvideo/wan2_1_i2v_14B.yaml`` has ``in_channels: 16``,
    no ``cond_stage_2_config`` and no ``i2v_mode``, and its ``prompt_dir:
    inputs/i2v/720p`` does not exist (ROADMAP.md queue 3).  Without
    ``inference.input_dir`` both packages read that path as a prompt file
    and fail; with it, the JAX flow's ``prepare_image_cond`` and the port's
    attach nothing, so the command samples from the prompt alone.  With the
    overrides of the I2V-14B layout the command runs image-to-video."""
    cfg = pconfig.load_configs([CONFIG_I2V], NARROW)
    inf = cfg["inference"]
    assert not os.path.exists(os.path.join(ROOT, inf["prompt_dir"]))
    assert "cond_stage_2_config" not in cfg["flow"]["params"]
    for load in (pgeneration.load_prompts, jgeneration.load_prompts):
        with pytest.raises(FileNotFoundError):
            load(inf)
    jregistry.populate()
    jflow = jregistry.instantiate(jconfig.load_configs(
        [CONFIG_I2V], NARROW)["flow"])
    pflow = pregistry.instantiate(cfg["flow"], device="cpu")
    assert not pflow.i2v_mode and pflow.cond_stage_2 is None
    cond = {"y": np.zeros((1, 4, 64), np.float32)}
    jc, _ = jflow.prepare_image_cond({}, cond, None, jnp.asarray(_image()),
                                     FRAMES, HEIGHT, WIDTH,
                                     jax.random.key(0))
    pc, _ = pflow.prepare_image_cond({"y": _t(cond["y"])}, None,
                                     _t(_image()), FRAMES, HEIGHT, WIDTH)
    assert set(jc) == set(pc) == {"y"}

    inputs = _inputs(tmp_path)
    for tag, extra in (("shipped", []), ("i2v", NARROW_I2V[len(NARROW):])):
        out = tmp_path / tag
        assert pcommands.main([
            "inference-wanvideo-i2v-720p", "--device", "cpu", "--quiet",
            "--savedir", str(out), *NARROW, *extra,
            f"inference.input_dir={inputs}"]) == 0
        m = json.loads((out / "metric.json").read_text())
        assert m["num_videos"] == 1 and m["latent_shape"] == [1, 2, 16, 16,
                                                              16]
        assert m["nonfinite_latents"] == 0 == m["nonfinite_pixels"]
    i2v = pregistry.instantiate(pconfig.load_configs(
        [CONFIG_I2V], NARROW_I2V)["flow"], device="cpu")
    with pytest.raises(ValueError, match="inference.input_dir"):
        i2v.inference(pconfig.load_configs([CONFIG_I2V], NARROW_I2V))
