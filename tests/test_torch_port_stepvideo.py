"""The port's StepVideo slice against the JAX package on the CPU: the
grouped rotate-half RoPE, the Step-1 LLM (causal, heads over shared
key/value groups, f32), ``StepVideoModel`` in both parameter layouts with
the CLIP states and a ragged caption mask, ``StepVideoFlow``'s sampling
with CFG and its decode, the two conversion maps, and the registry's
``inference-stepvideo-t2v-544x992`` on the CPU.

The JAX module's parameter tree is filled from a seeded numpy generator and
carried across with ``tools/from_jax``; inputs come from numpy too.  f32
throughout, narrow: heads of d = 128 kept (the (64, 32, 32) RoPE split), 128
video tokens, so the port's self-attention takes route K2 (online, as the
flow sets no fixed max) and its cross-attention route K4 through their plain
versions, the StepLLM's causal attention K2 at 160 tokens; the JAX package
runs its reference attention on the CPU.  Tolerances, of max|ref|: 1e-5 for
the RoPE, 1e-4 for modules through a kernel route and for trajectories (the
plain versions and the JAX reference sum in their own orders), 1e-3 for
decoded pixels.
"""

import argparse
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
from videotuna_tpu.models import layers as JL
from videotuna_tpu.models import text_encoders as JT
from videotuna_tpu.models.stepvideo.dit import StepVideoModel as JStep
from videotuna_tpu.schedulers import cfg_denoise as jcfg_denoise
from videotuna_tpu.tools import convert_weights as jcw
from videotuna_tpu_torch.cli import commands as pcommands
from videotuna_tpu_torch.core import config as pconfig
from videotuna_tpu_torch.core import registry as pregistry
from videotuna_tpu_torch.kernels import attention as PA
from videotuna_tpu_torch.models import layers as PL
from videotuna_tpu_torch.models import text_encoders as PT
from videotuna_tpu_torch.models.stepvideo.dit import StepVideoModel as PStep
from videotuna_tpu_torch.tools import ckpt_tools
from videotuna_tpu_torch.tools import convert_weights as pcw
from videotuna_tpu_torch.tools.from_jax import (load_flow_params,
                                                load_jax_params)

from tests.test_torch_port_convert import (_flat, _trees_equal,
                                           synthetic_state_dict)
from tests.test_torch_port_models import (  # noqa: F401
    flax_shapes, jax_params, torch_one_thread)
from tests.test_torch_port_opensora import _close, _t

MODULE_TOL = 1e-5
KERNEL_MODEL_TOL = 1e-4
TRAJ_TOL = 1e-4
PIXEL_TOL = 1e-3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "009_stepvideo",
                      "stepvideo_t2v.yaml")
PROMPT = "a koi pond at dusk, ripples spreading"

_D = "flow.params.denoiser_config.params"
_T = "flow.params.cond_stage_config.params"
_C = "flow.params.cond_stage_2_config.params"
_V = "flow.params.first_stage_config.params"
# the 30B config narrow: the DiT at dim 256 (2 heads of d = 128, 2 layers),
# a 1-layer StepLLM of dim 256 (2 heads, 1 key/value group), a 1-layer CLIP
# of dim 32 over 77 tokens, the VAE at ch 32 with one res block a level;
# 17×128×128 gives 2×8×8 latents, 128 video tokens
NARROW = [f"{_D}.dim=256", f"{_D}.heads=2", f"{_D}.num_layers=2",
          f"{_D}.ffn_dim=512", f"{_D}.text_dim=256", f"{_D}.clip_dim=32",
          f"{_D}.dtype=float32", f"{_T}.dim=256", f"{_T}.heads=2",
          f"{_T}.groups=1", f"{_T}.num_layers=1", f"{_T}.vocab_size=32768",
          f"{_C}.dim=32", f"{_C}.heads=2", f"{_C}.num_layers=1",
          f"{_V}.ch=32", f"{_V}.num_res_blocks=1",
          "flow.params.scheduler_config.params.num_steps=2",
          "inference.height=128", "inference.width=128",
          "inference.frames=17", "inference.mesh.tp=1"]


# ---------------------------------------------------------------- RoPE
def test_grouped_rope_tables_and_rotation_match():
    """StepVideo's per-axis tables and the per-group rotate-half rotation
    on a (2, 3, 4) grid at the (64, 32, 32) split."""
    dims, grid = JL.STEPVIDEO_ROPE_DIMS, (2, 3, 4)
    assert PL.STEPVIDEO_ROPE_DIMS == dims
    jt = jax.jit(lambda: JL.rope_3d_axis_tables(dims, grid))()
    pt = PL.rope_3d_axis_tables(dims, grid)
    for (jc, js), (pc, ps) in zip(jt, pt):
        _close(pc, jc, MODULE_TOL)
        _close(ps, js, MODULE_TOL)
    x = np.random.default_rng(0).standard_normal((1, 24, 2, 128),
                                                 dtype=np.float32)
    _close(PL.apply_rope_3d_grouped(_t(x), pt, dims),
           jax.jit(lambda x: JL.apply_rope_3d_grouped(x, jt, dims))(x),
           MODULE_TOL)


# ---------------------------------------------------------------- StepLLM
def test_stepllm_encoder_matches_jax():
    """A 2-layer StepLLM of dim 512 (4 heads of d = 128 over 2 key/value
    groups), 160 tokens with a padded row: the states and their mask."""
    kw = dict(vocab_size=512, dim=512, heads=4, groups=2, num_layers=2)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 512, (2, 160)).astype(np.int32)
    mask = np.ones((2, 160), bool)
    mask[1, 100:] = False
    jmod, pmod = JT.StepLLMEncoder(**kw), PT.StepLLMEncoder(**kw)
    params = jax_params(jmod, like=pmod)
    ref = jax.jit(lambda p: jmod.apply({"params": p}, jnp.asarray(ids),
                                       jnp.asarray(mask)))(params)
    load_jax_params(pmod, params)
    launches = PA.flash_fwd.launches["K2"]
    with torch.no_grad():
        out = pmod(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert out.shape == (2, 160, 512)
    _close(out, ref, KERNEL_MODEL_TOL)
    assert PA.flash_fwd.launches["K2"] == launches   # plain on the CPU


# ---------------------------------------------------------------- the DiT
def _dit_inputs(seed=2):
    rng = np.random.default_rng(seed)
    mask = np.zeros((2, 20), bool)
    mask[0, :20], mask[1, :7] = True, True
    return [rng.standard_normal((2, 2, 8, 8, 16), dtype=np.float32),
            np.array([40.0, 900.0], np.float32),
            rng.standard_normal((2, 20, 48), dtype=np.float32),
            rng.standard_normal((2, 5, 32), dtype=np.float32), mask]


def test_stepvideo_dit_matches_jax():
    """``StepVideoModel`` at dim 256 (2 heads of d = 128), 2 layers, on
    2×8×8 latents (128 tokens): the CLIP states before a ragged caption
    (row 1 keeps 7 of 20 tokens), scanned (the block-by-block layout loads
    in ``test_stepvideo_maps_match_jax_and_load_strictly``)."""
    kw = dict(in_channels=16, out_channels=16, dim=256, ffn_dim=512,
              num_layers=2, heads=2, text_dim=48, clip_dim=32,
              scan_blocks=True)
    inputs = _dit_inputs()
    jmod, pmod = JStep(**kw), PStep(**kw)
    params = jax_params(jmod, like=pmod)
    assert "blocks" in params
    ref = jax.jit(lambda p, *a: jmod.apply({"params": p}, *a))(
        params, *map(jnp.asarray, inputs))
    load_jax_params(pmod, params)
    with torch.no_grad():
        out = pmod(*map(_t, inputs))
    assert out.shape == (2, 2, 8, 8, 16) and out.dtype == torch.float32
    _close(out, ref, KERNEL_MODEL_TOL)


# ---------------------------------------------------------------- flow
@functools.cache
def _flows():
    jcfg = jconfig.load_configs([CONFIG], NARROW)
    pcfg = pconfig.load_configs([CONFIG], NARROW)
    jregistry.populate()
    jflow = jregistry.instantiate(jcfg["flow"])
    pflow = pregistry.instantiate(pcfg["flow"], device="cpu")
    params = {c: jax_params(getattr(jflow, c), seed=i,
                            like=getattr(pflow, c))
              for i, c in enumerate(("denoiser", "first_stage",
                                     "cond_stage", "cond_stage_2"))}
    load_flow_params(pflow, params)
    return jflow, pflow, params, jcfg["inference"]


def test_stepvideo_flow_samples_with_cfg_like_jax():
    """The prompt and the empty prompt through both towers (StepLLM states
    over 320 tokens, the CLIP's 77), the same x_T through 2 Euler steps
    with CFG 9 (each step one DiT call at B = 2 with the caption mask),
    then the decode."""
    jflow, pflow, params, inf = _flows()
    shape = jflow.latent_shape(1, inf["frames"], inf["height"],
                               inf["width"])
    assert shape == (1, 2, 8, 8, 64)
    x_T = np.random.default_rng(3).standard_normal(shape, dtype=np.float32)
    jcond, juncond = (jax.jit(lambda p, s=s: jflow.encode_text(p, [s]))(
        params) for s in (PROMPT, ""))
    denoise = jcfg_denoise(
        lambda x, t, c: jflow.denoise_apply(params, x, t, c), jcond,
        juncond, 9.0)
    jz = jax.jit(lambda x: jflow.scheduler.sample(
        denoise, shape, jax.random.key(0), x_T=x))(jnp.asarray(x_T))
    jvideo = jax.jit(jflow.decode_latents)(params, jz)

    pcond, puncond = (pflow.encode_text([s]) for s in (PROMPT, ""))
    assert pcond["y"].shape == (1, 320, 256)
    assert pcond["y2"].shape == (1, 77, 32)
    for k in ("y", "y2", "y_mask"):
        _close(pcond[k], jcond[k], MODULE_TOL)
    pz = pflow.sample(pcond, puncond, shape, None, 9.0, x_T=_t(x_T))
    _close(pz, jz, TRAJ_TOL)
    video = pflow.decode_latents(pz)
    assert video.shape == jvideo.shape
    _close(video, jvideo, PIXEL_TOL)


def test_stepvideo_training_loss_matches_jax():
    """The flow-matching loss on latents and StepLLM states, with the JAX
    side's uniform σ and noise handed to the port."""
    jflow, pflow, params, _ = _flows()
    rng = np.random.default_rng(4)
    z = rng.standard_normal((2, 2, 8, 8, 64), dtype=np.float32)
    text = rng.standard_normal((2, 24, 256), dtype=np.float32)
    key = jax.random.key(5)
    jloss, _ = jax.jit(lambda p, b: jflow.training_loss(p, b, key))(
        params, {"latents": jnp.asarray(z), "text_states": jnp.asarray(text)})
    _, k_sig, k_noise = jax.random.split(key, 3)
    sigma = jax.random.uniform(k_sig, (2,))
    noise = jax.random.normal(k_noise, z.shape)
    with torch.no_grad():
        loss, aux = pflow.training_loss(
            {"latents": _t(z), "text_states": _t(text)},
            sigma=_t(sigma), noise=_t(noise))
    assert set(aux) == {"loss"}
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)


# ---------------------------------------------------------------- maps
def _heads_interleaved(parts):
    """Fuse per-head [q|k|v] chunks as the upstream model stores them."""
    heads = 2
    stacked = np.stack([p.reshape(heads, -1, p.shape[-1]) for p in parts],
                       axis=1)
    return stacked.reshape(-1, parts[0].shape[-1])


@pytest.mark.parametrize("family", ["stepllm", "stepvideo"])
def test_stepvideo_maps_match_jax_and_load_strictly(family):
    """Each map's synthetic upstream state dict (the map's own rules over
    the narrow module's leaves) gives the JAX converter's tree exactly,
    through the port's converter and ``ckpt_tools``' family map, and loads
    strictly; the DiT's checkpoint stores q, k, v fused per head (and k,
    v of the cross-attention), which the headwise split undoes as the JAX
    package's does."""
    comp = {"stepllm": "cond_stage", "stepvideo": "denoiser"}[family]
    # the maps name blocks one by one (ckpt_tools loads that tree into
    # either layout)
    pcfg = pconfig.load_configs([CONFIG],
                                NARROW + [f"{_D}.scan_blocks=false"])
    module = ckpt_tools.build_component(pcfg, comp)
    params = dict(pcfg["flow"]["params"][f"{comp}_config"]["params"])
    build = {"stepllm": lambda cw: cw.stepllm_map(),
             "stepvideo": lambda cw: cw.stepvideo_map(heads=2)}[family]
    shapes = flax_shapes(module)
    sd = synthetic_state_dict(build(jcw), shapes)
    jtree = build(jcw).convert(sd, strict=True)
    ptree = build(pcw).convert(sd, strict=True)
    _trees_equal(ptree, jtree)
    assert {p: tuple(np.shape(v)) for p, v in _flat(ptree)} == shapes
    make_map, preprocess = ckpt_tools.FAMILIES[family]
    if family == "stepvideo":
        fused = {k: v for k, v in sd.items()
                 if ".attn1.w" not in k[-12:] or k.endswith("wo.weight")}
        for i in range(2):
            a1, a2 = f"transformer_blocks.{i}.attn1", \
                f"transformer_blocks.{i}.attn2"
            for k in ("wq", "wk", "wv"):
                fused.pop(f"{a1}.{k}.weight")
            fused[f"{a1}.wqkv.weight"] = _heads_interleaved(
                [sd[f"{a1}.{k}.weight"] for k in ("wq", "wk", "wv")])
            fused.pop(f"{a2}.wk.weight")
            fused.pop(f"{a2}.wv.weight")
            fused[f"{a2}.wkv.weight"] = _heads_interleaved(
                [sd[f"{a2}.{k}.weight"] for k in ("wk", "wv")])
        split = preprocess(dict(fused))
        jsplit = jcw.preprocess_split_headwise(
            jcw.preprocess_split_headwise(dict(fused), r"attn1\.wqkv",
                                          "wqkv", ("wq", "wk", "wv"), 2),
            r"attn2\.wkv", "wkv", ("wk", "wv"), 2)
        assert sorted(split) == sorted(jsplit) == sorted(sd)
        for k in sd:
            np.testing.assert_array_equal(split[k], sd[k], err_msg=k)
    args = argparse.Namespace(heads=None, kv_heads=None)
    _trees_equal(make_map(args, params).convert(sd), ptree)
    load_jax_params(module, ptree, comp)
    scanned = ckpt_tools.build_component(
        pconfig.load_configs([CONFIG], NARROW), comp)
    load_jax_params(scanned, ptree, comp)


# ---------------------------------------------------------------- command
def test_stepvideo_command_runs_the_port_on_cpu(tmp_path):
    """``inference-stepvideo-t2v-544x992`` through the registry, narrowed,
    on the CPU with the one-device mesh: an mp4 and metric.json; the
    config's own mesh (tp 4) needs four ranks, and in one process raises
    as the JAX package's make_mesh does."""
    assert "inference-stepvideo-t2v-544x992" not in pcommands.WAITING
    out = tmp_path / "out"
    assert pcommands.main(["inference-stepvideo-t2v-544x992", "--device",
                           "cpu", "--quiet", "--savedir", str(out),
                           "--prompt", PROMPT, *NARROW]) == 0
    metrics = json.loads((out / "metric.json").read_text())
    assert metrics["latent_shape"] == [1, 2, 8, 8, 64]
    assert metrics["nonfinite_pixels"] == 0
    assert any(p.suffix in (".mp4", ".npy") for p in out.iterdir())
    with pytest.raises(ValueError, match="= 4 != device count 1"):
        pcommands.main(["inference-stepvideo-t2v-544x992", "--device",
                        "cpu", "--quiet", "--savedir", str(out),
                        *NARROW[:-1]])
