"""The port's training slice against the JAX package on the CPU.

- ``training_loss`` of the tiny flows (CogVideoX, STDiT, HunyuanVideo)
  and of the narrow d=128 HunyuanVideo, and its gradients: the JAX flow's
  parameter tree (seeded numpy values) is carried into the port; each
  package encodes the captions and the video (the narrow case takes seeded
  latents and text states), and the draws that JAX's ``training_loss``
  makes inside from its key (posterior noise, t or σ, noise: the key split
  the same way here) are handed to the port explicitly.  f32, 1e-5 of
  max|ref| (other summation order).
- ``Trainer.prepare_batch`` carries HunyuanVideo's pooled CLIP vector as
  the JAX trainer's does.
- LoRA: the delta tree's layout (plain and scan-stacked), the side-branch
  forward and ``merge_lora``, with the same a and b in both packages.

The optimizer, ``run_train`` and remat are in
``tests/test_torch_port_training_run.py``.
"""

import copy
import functools
import math
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videotuna_tpu.core import config as jconfig
from videotuna_tpu.core import registry as jregistry
from videotuna_tpu.models import layers as jlayers
from videotuna_tpu.training import lora as jlora
from videotuna_tpu.training import trainer as jtrainer
from videotuna_tpu_torch.core import config as pconfig
from videotuna_tpu_torch.core import registry as pregistry
from videotuna_tpu_torch.tools.from_jax import (load_flow_params,
                                                load_jax_lora,
                                                load_jax_params)
from videotuna_tpu_torch.training import lora as plora
from videotuna_tpu_torch.training import trainer as ptrainer

from tests.test_torch_port_flow import (TINY, TINY_HUNYUAN, TINY_T2V,
                                        _jax_params)
from tests.test_torch_port_hunyuan import NARROW_D128, _flow_params
from tests.test_torch_port_models import (  # noqa: F401
    jax_params, torch_one_thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY_CSV = os.path.join(ROOT, "configs", "000_tiny", "toy_anno.csv")
TOL = 1e-5

_PRED_SIGMA = [   # the hybrid loss: a pred_sigma STDiT under IDDPM spacing
    "flow.params.denoiser_config.params.pred_sigma=true",
    "flow.params.scheduler_config.target="
    "videotuna_tpu.schedulers.SpacedSchedule",
    "flow.params.scheduler_config.params.section_counts=ddim10",
]


def _close(out, ref, tol=TOL):
    if isinstance(out, torch.Tensor):
        out = out.detach().float().numpy()
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=tol * float(np.abs(ref).max()) + 1e-30)


PROMPTS = ("a cat on a mat", "a dog")


@functools.cache
def _jax_flow(path, overrides, denoiser_only):
    """The JAX flow and its seeded weights, built once a module for each
    configuration (the tests read them and never change them)."""
    jcfg = jconfig.load_configs([path], list(overrides))
    jregistry.populate()
    jflow = jregistry.instantiate(jcfg["flow"])
    # the port's flow, whose components give the trees' shapes untraced
    pflow = pregistry.instantiate(
        pconfig.load_configs([path], list(overrides))["flow"], device="cpu")
    if denoiser_only:
        params = {"denoiser": jax_params(jflow.denoiser,
                                         like=pflow.denoiser)}
    else:
        params = (_flow_params(jflow, pflow=pflow)
                  if jflow.cond_stage_2 is not None
                  else _jax_params(jflow, pflow=pflow))
    return jcfg, jflow, params


@functools.cache
def _jax_text(path, overrides=()):
    """The JAX flow's encode of ``PROMPTS`` (one compile a configuration)."""
    _, jflow, params = _jax_flow(path, overrides, False)
    return jax.jit(lambda p: jflow.encode_text(p, list(PROMPTS)))(params)


def _flows(path, overrides=(), denoiser_only=False):
    """The JAX flow and the port's with the same seeded weights: every
    component's, or with ``denoiser_only`` the denoiser's alone (the cases
    whose compared path has no encoder)."""
    jcfg, jflow, params = _jax_flow(path, tuple(overrides), denoiser_only)
    pcfg = pconfig.load_configs([path], list(overrides))
    pflow = pregistry.instantiate(pcfg["flow"], device="cpu")
    if denoiser_only:
        load_jax_params(pflow.denoiser, params["denoiser"], "denoiser")
    else:
        load_flow_params(pflow, params)
    return copy.deepcopy(jcfg), jflow, pflow, params


# the narrow d=128 HunyuanVideo flow on 3×16×16 latents (9×128×128): 3×8×8
# = 192 video tokens and the config's 160 text tokens, so the port's joint
# attentions take the flash routes (K5 forward, K8 backward) through their
# plain versions on the CPU.  It starts from latents and from text states,
# mask and pooled vector made from the seed, so no encoder is on its path
# (the tiny case encodes video and captions)
_HUNYUAN_D128 = NARROW_D128 + ["data.dataset.params.resolution=[128, 128]"]


def _jax_embedding_on_port_freqs(t, dim, max_period=10000.0):
    """The JAX package's ``timestep_embedding`` with the port's f32
    frequency table.  HunyuanVideo embeds its guidance 6000 this way, where
    sin(6000·f) moves by up to 7e-4 for one ulp of f, and XLA's exp and
    torch's differ by one ulp in some of the 128 frequencies: the JAX side
    then differs from the float64 truth by 2.4e-4, the port by 3e-8.  With
    one table both sides compute the same function to f32 rounding."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32) / half)
    args = t.astype(jnp.float32)[:, None] * jnp.asarray(freqs.numpy())[None]
    return jnp.concatenate([jnp.cos(args), jnp.sin(args)], axis=-1)


# ---------------------------------------------------------------- the loss
@pytest.mark.parametrize("path,overrides", [
    (TINY, []), (TINY_T2V, []), (TINY_T2V, _PRED_SIGMA),
    (TINY_HUNYUAN, []), (TINY_HUNYUAN, _HUNYUAN_D128)],
    ids=["cogvideox", "t2v", "t2v_pred_sigma_vb", "hunyuan", "hunyuan_d128"])
def test_training_loss_and_grads_match_jax(path, overrides, monkeypatch):
    seeded = overrides is _HUNYUAN_D128
    jcfg, jflow, pflow, params = _flows(path, overrides, denoiser_only=seeded)
    hunyuan = jflow.cond_stage_2 is not None
    if hunyuan:   # HunyuanVideo's guidance embedding
        monkeypatch.setattr(jlayers, "timestep_embedding",
                            _jax_embedding_on_port_freqs)
    data = jcfg["data"]["dataset"]["params"]
    b, frames, (h, w) = 2, data["num_frames"], data["resolution"]
    rng = np.random.default_rng(3)
    if seeded:
        _, _, ex_text, ex_pooled, _, _ = jflow.example_inputs()["denoiser"]
        n_text = jcfg["flow"]["params"]["model_max_length"]
        mask = np.zeros((b, n_text), bool)
        mask[0, :120], mask[1, :40] = True, True
        inputs = {"latents": rng.standard_normal(
                      jflow.latent_shape(b, frames, h, w), dtype=np.float32),
                  "text_states": rng.standard_normal(
                      (b, n_text, ex_text.shape[-1]), dtype=np.float32),
                  "text_mask": mask,
                  "pooled_text": rng.standard_normal(
                      (b, ex_pooled.shape[-1]), dtype=np.float32)}
        jbatch = {k: jnp.asarray(v) for k, v in inputs.items()}
        pbatch = {k: torch.from_numpy(v) for k, v in inputs.items()}
    else:   # each package encodes the captions and the video
        video = rng.uniform(-1.0, 1.0, (b, frames, h, w, 3)).astype(
            np.float32)
        jcond = _jax_text(path, tuple(overrides))
        pcond = pflow.encode_text(list(PROMPTS))
        jbatch = {"video": jnp.asarray(video), "text_states": jcond["y"],
                  "text_mask": jcond["mask"]}
        pbatch = {"video": torch.from_numpy(video),
                  "text_states": pcond["y"], "text_mask": pcond["mask"]}
        if hunyuan:
            jbatch["pooled_text"] = jcond["pooled"]
            pbatch["pooled_text"] = pcond["pooled"]
    key = jax.random.key(5)

    # the draws JAX's training_loss makes from `key`: the posterior noise,
    # t (or HunyuanVideo's logit-normal sigma) and the noise
    k_enc, k_t, k_noise = jax.random.split(key, 3)
    draw = {}
    if "video" in jbatch:
        # the posterior's shape, traced without compiling the encoder
        moments = jax.eval_shape(lambda p, v: jflow.first_stage.apply(
            {"params": p}, v, method=jflow.first_stage.encode),
            params["first_stage"], jbatch["video"])
        zshape = moments.shape[:-1] + (moments.shape[-1] // 2,)
        draw["posterior_noise"] = jax.random.normal(k_enc, zshape)
    else:
        zshape = jbatch["latents"].shape
    noise = jax.random.normal(k_noise, zshape)
    if hunyuan:
        draw["sigma"] = jax.nn.sigmoid(jax.random.normal(k_t, (b,)))
    else:
        draw["t"] = jax.random.randint(k_t, (b,), 0,
                                       jflow.base_schedule.num_timesteps)

    def jloss(den):
        return jflow.training_loss(dict(params, denoiser=den), jbatch, key)

    (jl, jaux), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params["denoiser"])

    pflow.denoiser.requires_grad_(True)
    pl, aux = pflow.training_loss(
        pbatch, **{k: torch.tensor(np.asarray(v)) for k, v in draw.items()},
        noise=torch.tensor(np.asarray(noise)))
    pl.backward()
    _close(pl, jl)
    assert set(aux) == set(jaux)
    assert ("loss_vb" in aux) == (overrides == _PRED_SIGMA)
    if hunyuan:
        _close(aux["sigma_mean"], jaux["sigma_mean"])

    # JAX's gradients in the port's layout, through the weight loader; a
    # key projection's bias has gradient 0 in exact arithmetic (softmax
    # ignores a constant per query), so each leaf is held to 1e-5 of its
    # own max plus 1e-7 of the largest gradient
    ref = copy.deepcopy(pflow.denoiser)
    load_jax_params(ref, jax.device_get(jg))
    gmax = max(float(r.detach().abs().max()) for r in ref.parameters())
    for name, p in pflow.denoiser.named_parameters():
        r = ref.get_parameter(name).detach()
        torch.testing.assert_close(
            p.grad, r, rtol=0,
            atol=TOL * float(r.abs().max()) + 1e-7 * gmax, msg=name)


def test_prepare_batch_carries_pooled_text_like_jax():
    """The caption encode of a HunyuanVideo batch, through each package's
    ``Trainer.prepare_batch``: LLaMA states, mask and CLIP's pooled vector,
    which the DiT's ``vector_in`` reads (f32, 1e-5 of max|ref|)."""
    _, jflow, pflow, params = _flows(TINY_HUNYUAN)
    jcond = _jax_text(TINY_HUNYUAN)

    def jencode(p, captions):
        assert tuple(captions) == PROMPTS
        return jcond

    video = np.zeros((2, 1, 4, 4, 3), np.float32)
    me = types.SimpleNamespace(flow=types.SimpleNamespace(
        params=params, encode_text=jencode))
    ref = jtrainer.Trainer.prepare_batch(
        me, {"caption": list(PROMPTS), "video": video, "path": ["x"]})
    got = ptrainer.Trainer(pflow, ptrainer.TrainConfig()).prepare_batch(
        {"caption": list(PROMPTS), "video": video, "path": ["x"]})
    assert set(got) == set(ref) == {"video", "text_states", "text_mask",
                                    "pooled_text"}
    _close(got["text_states"], ref["text_states"])
    _close(got["pooled_text"], ref["pooled_text"])
    assert np.array_equal(got["text_mask"].numpy(),
                          np.asarray(ref["text_mask"]))


# ---------------------------------------------------------------- LoRA
def _lora_case(path, scan):
    key = "flow.params.denoiser_config.params.scan_blocks"
    jcfg, jflow, pflow, params = _flows(path, [f"{key}={str(scan).lower()}"],
                                        denoiser_only=True)
    rng = np.random.default_rng(7)
    if path == TINY:
        args = (rng.standard_normal((1, 2, 8, 8, 16)).astype(np.float32),
                np.array([37]),
                rng.standard_normal((1, 6, 16)).astype(np.float32))
    elif path == TINY_HUNYUAN:   # x, t, text states, pooled, mask, guidance
        mask = np.ones((1, 6), bool)
        mask[0, 4:] = False
        args = (rng.standard_normal((1, 2, 8, 8, 16)).astype(np.float32),
                np.array([37.0], np.float32),
                rng.standard_normal((1, 6, 24)).astype(np.float32),
                rng.standard_normal((1, 12)).astype(np.float32), mask,
                np.array([37.0], np.float32))
    else:
        mask = np.ones((1, 8), bool)
        mask[0, 5:] = False
        args = (rng.standard_normal((1, 4, 8, 8, 4)).astype(np.float32),
                np.array([37]),
                rng.standard_normal((1, 8, 16)).astype(np.float32), mask)
    return jflow, pflow, params, args


def _shapes(tree):
    return {p: (tuple(ab["a"].shape), tuple(ab["b"].shape))
            for p, ab in plora._iter_pairs(tree)}


@pytest.mark.parametrize("path,scan", [(TINY, False), (TINY, True),
                                       (TINY_T2V, False), (TINY_T2V, True),
                                       (TINY_HUNYUAN, False),
                                       (TINY_HUNYUAN, True)],
                         ids=["mmdit", "mmdit_scan", "stdit", "stdit_scan",
                              "hyvideo", "hyvideo_scan"])
def test_lora_tree_side_branch_and_merge_match_jax(path, scan):
    jflow, pflow, params, args = _lora_case(path, scan)
    den = params["denoiser"]
    jtree = jlora.init_lora(den, rank=4, key=jax.random.key(0))
    ptree = plora.init_lora(pflow.denoiser, rank=4,
                            generator=torch.Generator().manual_seed(0))
    assert _shapes(ptree) == _shapes(jtree)
    assert plora.count_lora_params(ptree) == jlora.count_lora_params(jtree)
    a = torch.cat([ab["a"].detach().flatten()
                   for _, ab in plora._iter_pairs(ptree)])
    assert abs(float(a.std()) - 0.5) < 0.05          # N(0, 1/r), r = 4
    assert all(float(ab["b"].detach().abs().max()) == 0
               for _, ab in plora._iter_pairs(ptree))

    # the same a and b (b nonzero) in both packages
    rng = np.random.default_rng(8)
    jtree = jax.tree.map(
        lambda x: (0.1 * rng.standard_normal(x.shape)).astype(np.float32),
        jax.device_get(jtree))
    ptree = load_jax_lora(pflow.denoiser, jtree)
    alpha = 0.5

    def jforward(p, *a):
        with jlora.lora_scope():
            return jflow.denoiser.apply({"params": p}, *a)

    ref = jax.jit(jforward)(jlora.inject_lora(den, jtree, alpha),
                            *map(jnp.asarray, args))
    targs = [torch.from_numpy(a) for a in args]
    with plora.lora_scope(pflow.denoiser, ptree, alpha):
        out = pflow.denoiser(*targs)
    _close(out, ref)
    plain = pflow.denoiser(*targs)            # the scope is gone
    assert (plain - out).abs().max() > 1e-3

    merged_ref = copy.deepcopy(pflow.denoiser)
    load_jax_params(merged_ref, jax.device_get(
        jlora.merge_lora(den, jtree, alpha)))
    plora.merge_lora(pflow.denoiser, ptree, alpha)
    for name, p in pflow.denoiser.named_parameters():
        _close(p, merged_ref.get_parameter(name).detach(), 1e-6)


# ---------------------------------------------------------------- optimizer
