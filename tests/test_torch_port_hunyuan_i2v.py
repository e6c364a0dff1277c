"""The port's HunyuanVideo image-to-video slice against the JAX package: the
LLaVA prompt encode (``hunyuan_i2v_crop``, ``encode_hunyuan_i2v``), its
CLIP tower (``CLIPVisionEncoder``, ``preprocess_frames``) and projector
(``LlavaProjector``, ``LlavaCaptioner.image_tokens``), the DiT's token
replace, the latent-concat flow (``prepare_image_cond`` and two Euler
steps), the shipped config's ``img_in`` width and the command.

The JAX module's parameter tree is filled from a seeded numpy generator
(``jax_params``, read off the port's module) and carried across with
``tools/from_jax``; inputs come from numpy too.  f32 throughout, attention
on both sides on the math path (fewer than 128 tokens, or the JAX
package's reference path on the CPU).  Tolerances, of max|ref|: 1e-5 for a
module, 1e-4 for the LLaMA over 934 tokens and for a trajectory."""

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
from videotuna_tpu.models import clip_vision as jclip
from videotuna_tpu.models import text_encoders as jtext
from videotuna_tpu.models.hunyuan.dit import HYVideoDiT as JDiT
from videotuna_tpu.tools import captioner as jcap
from videotuna_tpu_torch.cli import commands as pcommands
from videotuna_tpu_torch.core import config as pconfig
from videotuna_tpu_torch.core import registry as pregistry
from videotuna_tpu_torch.models import clip_vision as pclip
from videotuna_tpu_torch.models import text_encoders as ptext
from videotuna_tpu_torch.models.hunyuan.dit import HYVideoDiT as PDiT
from videotuna_tpu_torch.tools import captioner as pcap
from videotuna_tpu_torch.tools.from_jax import (load_flow_params,
                                                load_jax_params)

from tests.test_torch_port_hunyuan import _flow_params
from tests.test_torch_port_models import (  # noqa: F401
    jax_params, torch_one_thread)
from tests.test_torch_port_opensora import _apply, _close, _t

MODULE_TOL = 1e-5
TRAJ_TOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs", "000_tiny", "tiny_hunyuan.yaml")
I2V = os.path.join(ROOT, "configs", "007_hunyuanvideo",
                   "hunyuanvideo_i2v.yaml")
TEMPLATE = "dit-llm-encode-video-i2v"

_D = "flow.params.denoiser_config.params"
# the shipped I2V config, narrowed: the DiT at dim 64 (2 heads, 1 double
# and 1 single block), a 1-layer LLaMA of dim 64, a 1-layer CLIP of dim 32,
# the HunyuanVAE at (32, 32, 64, 64); the config's in_channels (33) stays
I2V_NARROW = [
    f"{_D}.dim=64", f"{_D}.heads=2", f"{_D}.double_blocks=1",
    f"{_D}.single_blocks=1", f"{_D}.text_dim=64", f"{_D}.pooled_dim=32",
    f"{_D}.scan_blocks=false", f"{_D}.dtype=float32",
    "flow.params.cond_stage_config.params={vocab_size: 30002, dim: 64, "
    "heads: 2, num_layers: 1}",
    "flow.params.cond_stage_2_config.params={vocab_size: 30002, dim: 32, "
    "heads: 2, num_layers: 1, max_len: 8}",
    "flow.params.first_stage_config.params.block_out_channels="
    "[32, 32, 64, 64]",
    "flow.params.first_stage_config.params.norm_num_groups=8",
    "flow.params.model_max_length=8",
    "flow.params.scheduler_config.params.num_steps=2",
    "inference.height=64", "inference.width=64", "inference.frames=5"]


# ---------------------------------------------------------------- crop
def _crop_inputs(case, seed=0, L=120):
    """Two prompts' ids (L = 120) with the template's four "\\n\\n" tokens
    (271), the fourth truncated away ("truncated"), or none ("none"), and
    the LLaMA's states over the 576-state expansion (D = 4)."""
    rng = np.random.default_rng(seed)
    b = 2
    ids = rng.integers(300, 30000, (b, L)).astype(np.int32)
    drs = {"four": [(40, 60, 104, 117), (20, 50, 104, 111)],
           "truncated": [(40, 60, 104), (20, 50, 104)], "none": [(), ()]}
    for i, pos in enumerate(drs[case]):
        ids[i, list(pos)] = 271
    mask = np.ones((b, L), bool)
    mask[1, 113:] = False
    hidden = rng.standard_normal((b, L + 575, 4)).astype(np.float32)
    return hidden, mask, ids


@pytest.mark.parametrize("case", ["four", "truncated", "none"])
@pytest.mark.parametrize("kind", ["token_replace", "latent_concat"])
def test_hunyuan_i2v_crop_matches_jax(kind, case):
    """The crop and splice of both condition types (image states ×4 or ×2),
    with the template's last "\\n\\n" found, truncated away (the end of the
    sequence stands for it) or absent: the same rows and mask, exactly."""
    hidden, mask, ids = _crop_inputs(case)
    template = ptext.HUNYUAN_PROMPT_TEMPLATES[TEMPLATE]
    assert template == jtext.HUNYUAN_PROMPT_TEMPLATES[TEMPLATE]
    inter = ptext.HUNYUAN_I2V_INTERLEAVE[kind]
    assert inter == jtext.HUNYUAN_I2V_INTERLEAVE[kind]
    y, m = ptext.hunyuan_i2v_crop(hidden, mask, ids, template, inter)
    jy, jm = jtext.hunyuan_i2v_crop(hidden, mask, ids, template, inter)
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_array_equal(m, jm)
    assert y.shape[1] == m.shape[1] == 576 // inter + 120 - 103 - 4


class _Jitted:
    """A flax module whose ``apply`` runs under one jit (the JAX encode
    calls it op by op, which compiles every op for its shape)."""

    def __init__(self, module):
        self.module = module
        self.apply = jax.jit(module.apply)

    def __getattr__(self, name):
        return getattr(self.module, name)


@functools.cache
def _llama():
    """A 2-layer LLaMA of dim 64 (2 heads) over the hash tokenizer's ids,
    both packages, one seeded tree."""
    cfg = dict(vocab_size=30002, dim=64, heads=2, num_layers=2)
    pm = ptext.LlamaTextEncoder(**cfg)
    jm = jtext.LlamaTextEncoder(**cfg)
    params = jax_params(jm, like=pm)
    load_jax_params(pm, params)
    return _Jitted(jm), pm, params


def test_encode_hunyuan_i2v_matches_jax():
    """The whole prompt encode on a 2-layer LLaMA: 359 template and prompt
    ids with the <image> slot spliced with 576 image states (934 tokens),
    then token replace's crop: y (B, 144 + 252, 64) and its mask, one
    prompt truncated at 256 text tokens; ``embed_tokens`` alike."""
    jm, pm, params = _llama()
    texts = ["a red panda climbing a tree", " ".join(["word"] * 300)]
    states = np.random.default_rng(1).standard_normal(
        (2, 576, 64)).astype(np.float32)
    jy, jmask = jtext.encode_hunyuan_i2v(jm, params, texts, states,
                                         template_name=TEMPLATE)
    y, mask = ptext.encode_hunyuan_i2v(pm, texts, _t(states),
                                       template_name=TEMPLATE)
    assert y.shape == (2, 144 + 252, 64)
    _close(y, jy, TRAJ_TOL)
    np.testing.assert_array_equal(mask.numpy(), jmask)
    ids = np.array([[1, 5, 29999]], np.int32)
    _close(pm.embed_tokens(_t(ids).long()),
           jm.embed_tokens(params, jnp.asarray(ids)), 0)


def test_256_image_states_fault_of_queue_3():
    """The JAX captioner's tower at 224 px gives 256 patch states, and the
    crop's offsets assume 576: JAX's crop then takes text states as image
    rows, no text rows, and a mask longer than its states (the mismatch
    shown on the crop of the shorter expansion).  The port raises."""
    # 359 ids (256 text tokens and the template's 103), 256 image states
    hidden, mask, ids = _crop_inputs("none", L=359)
    hidden = hidden[:, :359 + 255]
    template = jtext.HUNYUAN_PROMPT_TEMPLATES[TEMPLATE]
    jy, jmask = jtext.hunyuan_i2v_crop(hidden, mask, ids, template, 4)
    assert jy.shape[1] == 144 and jmask.shape[1] == 144 + 359 - 103 - 4
    np.testing.assert_array_equal(jy, hidden[:, 5:581:4])
    y, m = ptext.hunyuan_i2v_crop(hidden, mask, ids, template, 4)
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_array_equal(m, jmask)
    _, pm, _ = _llama()
    with pytest.raises(ValueError, match="576 image states.*queue 3"):
        ptext.encode_hunyuan_i2v(pm, ["a cat"], torch.zeros((1, 256, 64)),
                                 template_name=TEMPLATE)


# ---------------------------------------------------------------- tower
_TOWER = dict(dim=64, heads=2, num_layers=3, patch=14, image_size=56,
              proj_dim=32)


@pytest.mark.parametrize("feature_layer", [None, -2])
def test_clip_vision_encoder_matches_jax(feature_layer):
    """ViT at dim 64 (2 heads), 3 blocks, 56 px (16 patches + the class
    token): the projected class embedding and the states, the last
    block's or the penultimate's (LLaVA's ``feature_layer``)."""
    cfg = dict(_TOWER, feature_layer=feature_layer)
    pm = pclip.CLIPVisionEncoder(**cfg)
    jm = jclip.CLIPVisionEncoder(**cfg)
    params = jax_params(jm, like=pm)
    load_jax_params(pm, params)
    images = np.random.default_rng(2).standard_normal(
        (2, 56, 56, 3)).astype(np.float32)
    jproj, jstates = jax.jit(lambda p, x: jm.apply(
        {"params": p}, x, return_states=True))(params, jnp.asarray(images))
    with torch.no_grad():
        proj, states = pm(_t(images), return_states=True)
        _close(pm(_t(images)), jproj)
    _close(proj, jproj)
    _close(states, jstates)


def test_llava_projector_and_image_tokens_match_jax():
    """``preprocess_frames`` (antialiased resize and CLIP's statistics),
    ``LlavaProjector`` (exact GELU) and ``image_tokens``: two 60×80 frames
    through the tower's penultimate block, the class token dropped, the
    frames' 16 patches each one after the other."""
    frames = np.random.default_rng(3).uniform(
        -1, 1, (2, 60, 80, 3)).astype(np.float32)
    _close(pclip.preprocess_frames(_t(frames), 56),
           jax.jit(lambda f: jclip.preprocess_frames(f, 56))(frames))
    vcfg = dict(_TOWER, feature_layer=-2)
    pv, jv = pclip.CLIPVisionEncoder(**vcfg), jclip.CLIPVisionEncoder(**vcfg)
    pp, jp = pcap.LlavaProjector(64, 48), jcap.LlavaProjector(out_dim=48)
    vparams, pparams = jax_params(jv, like=pv), jax_params(jp, like=pp)
    load_jax_params(pv, vparams)
    load_jax_params(pp, pparams)
    feats = np.random.default_rng(4).standard_normal(
        (2, 5, 64)).astype(np.float32)
    with torch.no_grad():
        _close(pp(_t(feats)), _apply(jp, pparams, feats))
    jc = jcap.LlavaCaptioner.__new__(jcap.LlavaCaptioner)
    jc.vision, jc.vision_params = jv, vparams
    jc.projector, jc.projector_params = jp, pparams
    tokens = pcap.LlavaCaptioner(pv, pp).image_tokens(_t(frames))
    assert tokens.shape == (2 * 16, 48)
    _close(tokens, jax.jit(jc.image_tokens)(jnp.asarray(frames)))
    for call in (lambda c: c.caption(_t(frames), [1]),
                 lambda c: pcap.caption_directory(c, "videos", "out.csv",
                                                  [1])):
        with pytest.raises(NotImplementedError, match="item 10.4"):
            call(pcap.LlavaCaptioner(pv, pp))


# ---------------------------------------------------------------- DiT
@pytest.mark.parametrize("i2v", [None, "token_replace"])
def test_token_replace_dit_matches_jax(i2v):
    """2 double and 2 single blocks at dim 64 over 2×8×8 latents (2×4×4
    patches: 16 image tokens of the first frame) and 8 text tokens, pooled
    text and guidance: under token replace the first frame's tokens take
    the timestep-0 vector (no guidance) in every block."""
    cfg = dict(in_channels=32, out_channels=16, dim=64, heads=2,
               double_blocks=2, single_blocks=2, text_dim=24, pooled_dim=12,
               guidance_embed=True, i2v_condition_type=i2v)
    rng = np.random.default_rng(5)
    args = (rng.standard_normal((2, 2, 8, 8, 32)).astype(np.float32),
            np.array([30.0, 950.0], np.float32),
            rng.standard_normal((2, 8, 24)).astype(np.float32),
            rng.standard_normal((2, 12)).astype(np.float32),
            np.array([[True] * 8, [True] * 5 + [False] * 3]),
            np.full((2,), 6000.0, np.float32))
    pm, jm = PDiT(**cfg), JDiT(**cfg)
    params = jax_params(jm, like=pm)
    load_jax_params(pm, params)
    ref = _apply(jm, params, *args)
    with torch.no_grad():
        out = pm(*map(_t, args))
    _close(out, ref, TRAJ_TOL)
    if i2v is not None:   # the first frame's tokens differ from None's
        with torch.no_grad():
            pm.token_replace = False
            plain = pm(*map(_t, args))
        assert not torch.allclose(out[:, 0], plain[:, 0], atol=1e-3)
        torch.testing.assert_close(out[:, 1:], plain[:, 1:], rtol=0,
                                   atol=0.5 * float(out.abs().max()))


# ---------------------------------------------------------------- flow
@functools.cache
def _i2v_flows():
    # the tiny VAE's ch_mult [1, 2, 2] compresses 4×, the flow's latents
    # assume 8×: one more level
    overrides = ["flow.params.i2v_mode=true",
                 "flow.params.scheduler_config.params.num_steps=2",
                 "flow.params.first_stage_config.params.ch_mult=[1, 2, 2, 2]"]
    jcfg = jconfig.load_configs([TINY], overrides)
    jregistry.populate()
    jflow = jregistry.instantiate(jcfg["flow"])
    pflow = pregistry.instantiate(
        pconfig.load_configs([TINY], overrides)["flow"], device="cpu")
    params = _flow_params(jflow, pflow=pflow)
    load_flow_params(pflow, params)
    return jcfg, jflow, pflow, params


def test_i2v_flow_samples_like_jax():
    """``tiny_hunyuan.yaml`` in i2v mode: the image's latents (the JAX key's
    posterior draw handed to the port) zero-padded over the 3 latent frames
    in ``cond``, two Euler steps from the same x_T with the channel concat
    in each call."""
    jcfg, jflow, pflow, params = _i2v_flows()
    assert pflow.i2v_mode and pflow.denoiser.img_in.in_channels == 32
    inf = jcfg["inference"]
    frames, h, w = inf["frames"], inf["height"], inf["width"]
    image = np.random.default_rng(6).uniform(-1, 1, (1, h, w, 3)).astype(
        np.float32)
    shape = jflow.latent_shape(1, frames, h, w)
    x_T = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    key = jax.random.key(8)

    def jsample(p, img, x):
        cond, _ = jflow.prepare_image_cond(
            p, jflow.encode_text(p, [inf["prompt"]]), None, img, frames, h,
            w, key)
        return cond, jflow.scheduler.sample(
            lambda xx, t: jflow.denoise_apply(p, xx, t, cond), shape,
            jax.random.key(0), x_T=x)

    jcond, jz = jax.jit(jsample)(params, jnp.asarray(image),
                                 jnp.asarray(x_T))
    post = np.asarray(jax.random.normal(key, (1, 1, h // 8, w // 8, 16)))
    pcond, none = pflow.prepare_image_cond(
        pflow.encode_text([inf["prompt"]]), None, _t(image), frames, h, w,
        posterior_noise=_t(post))
    assert none is None
    _close(pcond["image_latents"], jcond["image_latents"])
    assert pcond["image_latents"][:, 1:].abs().max() == 0
    _close(pflow.sample(pcond, None, shape, None, 1.0, x_T=_t(x_T)), jz,
           TRAJ_TOL)
    pflow.i2v_mode = False
    with pytest.raises(NotImplementedError, match="i2v_mode"):
        pflow.prepare_image_cond(pcond, None, _t(image), frames, h, w)
    pflow.i2v_mode = True


def test_encode_text_i2v_is_the_prompt_encode_and_the_pooled_state():
    """``encode_text_i2v`` on the tiny flow (model_max_length 6: 109 ids,
    684 tokens with the 576 image states), as the JAX flow composes it:
    ``encode_hunyuan_i2v`` of its LLaMA (held to JAX above) for y and
    mask, and ``encode_text``'s pooled CLIP state (held to JAX by the T2V
    flow's test); both condition types."""
    jcfg, _, pflow, _ = _i2v_flows()
    states = _t(np.random.default_rng(9).standard_normal(
        (1, 576, 24)).astype(np.float32))
    prompt = [jcfg["inference"]["prompt"]]
    pooled = pflow.encode_text(prompt)["pooled"]
    for kind, rows in (("token_replace", 144), ("latent_concat", 288)):
        pc = pflow.encode_text_i2v(prompt, states, kind)
        y, mask = ptext.encode_hunyuan_i2v(
            pflow.cond_stage, prompt, states, text_len=6,
            i2v_condition_type=kind)
        assert pc["y"].shape == (1, rows + 6 - 4, 24)
        torch.testing.assert_close(pc["y"], y, rtol=0, atol=0)
        assert torch.equal(pc["mask"], mask)
        torch.testing.assert_close(pc["pooled"], pooled, rtol=0, atol=0)


def test_shipped_i2v_config_img_in_takes_32_channels():
    """``hunyuanvideo_i2v.yaml`` says in_channels 33; JAX's Conv infers its
    input width from the flow's concat, 16 latent + 16 image channels, so
    the traced init's img_in kernel takes 32, and so does the port's
    (ROADMAP.md queue 3: reference config, followed)."""
    jcfg = jconfig.load_configs([I2V], I2V_NARROW)
    assert jcfg["flow"]["params"]["denoiser_config"]["params"][
        "in_channels"] == 33
    jregistry.populate()
    jflow = jregistry.instantiate(jcfg["flow"])
    shapes = jax.eval_shape(jflow.denoiser.init, jax.random.key(0),
                            *jflow.example_inputs()["denoiser"])
    kernel = shapes["params"]["img_in"]["kernel"].shape
    assert kernel == (1, 2, 2, 32, 64)
    pflow = pregistry.instantiate(
        pconfig.load_configs([I2V], I2V_NARROW)["flow"], device="cpu")
    assert tuple(pflow.denoiser.img_in.weight.shape) == (64, 32, 1, 2, 2)


def test_hunyuan_i2v_command_runs_the_port(tmp_path):
    """``inference-hunyuan-i2v-720p`` runs the port on the CPU (the shipped
    config narrowed) from a directory of one seeded PNG and a .txt:
    2 latent frames of 8×8 sampled and decoded; without
    ``inference.input_dir`` it asks for one (the config's prompt_dir
    ``inputs/i2v/720p`` does not exist: ROADMAP.md queue 3)."""
    import cv2
    assert "inference-hunyuan-i2v-720p" not in pcommands.WAITING
    assert not os.path.exists(os.path.join(ROOT, "inputs", "i2v", "720p"))
    out = tmp_path / "out"
    argv = ["inference-hunyuan-i2v-720p", "--device", "cpu", "--quiet",
            "--savedir", str(out), *I2V_NARROW]
    with pytest.raises(ValueError, match="input_dir"):
        pcommands.main(argv)
    inputs = tmp_path / "inputs"
    inputs.mkdir()
    cv2.imwrite(str(inputs / "image.png"), np.random.default_rng(0).integers(
        0, 256, (60, 80, 3), dtype=np.uint8))
    (inputs / "prompts.txt").write_text("a red panda on a branch\n")
    assert pcommands.main(argv + [f"inference.input_dir={inputs}"]) == 0
    m = json.loads((out / "metric.json").read_text())
    assert m["num_videos"] == 1 and m["denoise_steps"] == 2
    assert m["latent_shape"] == [1, 2, 8, 8, 16]
    assert m["image_encode_sec"] > 0
    assert m["nonfinite_latents"] == 0 == m["nonfinite_pixels"]
