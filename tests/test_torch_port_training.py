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
- The optimizer and train step against optax on identical gradients.
- ``run_train`` end to end with checkpoints and resume; the dummy dataset's
  batches against the JAX module's.
"""

import copy
import functools
import math
import os
import random
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from videotuna_tpu.core import config as jconfig
from videotuna_tpu.core import registry as jregistry
from videotuna_tpu.data import datasets as jdata
from videotuna_tpu.models import layers as jlayers
from videotuna_tpu.training import lora as jlora
from videotuna_tpu.training import trainer as jtrainer
from videotuna_tpu_torch.core import config as pconfig
from videotuna_tpu_torch.core import registry as pregistry
from videotuna_tpu_torch.data import datasets as pdata
from videotuna_tpu_torch.tools.from_jax import (load_flow_params,
                                                load_jax_lora,
                                                load_jax_params)
from videotuna_tpu_torch.training import lora as plora
from videotuna_tpu_torch.training import trainer as ptrainer

from tests.test_torch_port_flow import (TINY, TINY_HUNYUAN, TINY_T2V,
                                        _jax_params)
from tests.test_torch_port_hunyuan import NARROW_D128, _flow_params
from tests.test_torch_port_models import jax_params

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
    if denoiser_only:
        params = {"denoiser": jax_params(
            jflow.denoiser, *jflow.example_inputs()["denoiser"])}
    else:
        params = (_flow_params(jflow) if jflow.cond_stage_2 is not None
                  else _jax_params(jflow))
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
        moments = jax.jit(lambda p, v: jflow.first_stage.apply(
            {"params": p}, v, method=jflow.first_stage.encode))(
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
def test_warmup_cosine_schedule_matches_optax():
    ref = optax.warmup_cosine_decay_schedule(0.0, 2e-5, 1000, 100000)
    got = ptrainer.warmup_cosine_decay_schedule(0.0, 2e-5, 1000, 100000)
    for count in (0, 1, 500, 999, 1000, 1001, 50000, 99999, 100000, 100500):
        assert got(count) == pytest.approx(float(ref(count)), rel=1e-6,
                                           abs=1e-12)


@pytest.mark.parametrize("accumulate", [1, 2])
def test_train_step_matches_optax(accumulate):
    """Clip, AdamW, warmup-cosine, MultiSteps and EMA: the JAX train step
    and the port's on the same gradients (a linear loss Σ p·g has gradient
    g), some above the clip norm and some below."""
    kw = dict(learning_rate=1e-2, weight_decay=1e-2, grad_clip=1.0,
              warmup_steps=3, max_steps=7, ema_decay=0.9,
              accumulate_grad_batches=accumulate)
    rng = np.random.default_rng(9)
    init = {"w": rng.standard_normal((4, 5)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * (3.0 if i % 3 else 0.05))
              .astype(np.float32) for k, v in init.items()}
             for i in range(8 * accumulate)]

    jcfg = jtrainer.TrainConfig(**kw)
    tx = jtrainer.make_optimizer(jcfg)

    def jloss(p, batch, key):
        return sum(jnp.sum(p[k] * batch[k]) for k in p), {}

    jstep = jtrainer.make_train_step(jloss, tx, jcfg.ema_decay)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = jtrainer.TrainState(step=jnp.zeros((), jnp.int32), params=jp,
                                 opt_state=tx.init(jp), ema_params=jp)

    opt = ptrainer.make_optimizer(ptrainer.TrainConfig(**kw))
    pp = {k: torch.tensor(v, requires_grad=True) for k, v in init.items()}
    pstate = ptrainer.TrainState(step=0, params=pp, opt_state=opt.init(pp),
                                 ema_params={k: v.detach().clone()
                                             for k, v in pp.items()})

    def ploss(batch, gen):
        return sum((pstate.params[k] * batch[k]).sum() for k in batch), {}

    pstep = ptrainer.make_train_step(ploss, opt, kw["ema_decay"])
    for g in grads:
        jstate, jm = jstep(jstate, {}, {k: jnp.asarray(v)
                                        for k, v in g.items()},
                           jax.random.key(0))
        pstate, pm = pstep(pstate, {k: torch.from_numpy(v)
                                    for k, v in g.items()}, None)
        assert float(pm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        for k in init:
            _close(pstate.params[k], jstate.params[k], 1e-6)
            _close(pstate.ema_params[k], jstate.ema_params[k], 1e-6)
    assert pstate.step == len(grads)


def test_adafactor_and_mesh_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="adafactor"):
        ptrainer.make_optimizer(ptrainer.TrainConfig(optimizer="adafactor"))
    from videotuna_tpu_torch.cli.train import run_train
    with pytest.raises(NotImplementedError, match="parallelism"):
        run_train(["--config", TINY_T2V, "--device", "cpu", "--quiet",
                   "--workdir", str(tmp_path), "train.mesh.fsdp=2"])


# ---------------------------------------------------------------- the loop
def _state(path):
    return torch.load(path, weights_only=True)


def _assert_same(a, b, where="state"):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}/{k}")
    else:
        assert a == b, where


@pytest.mark.parametrize("path", [TINY_T2V, TINY],
                         ids=["tiny_t2v", "tiny_cogvideox"])
def test_run_train_checkpoints_and_resumes(path, tmp_path):
    """8 steps with checkpoints at 4 and 8; a run stopped at 4 and resumed
    reaches the same step-8 state.  The host augmentation's draws (the
    ``random`` module) are set equal for both, as they are not part of a
    checkpoint."""
    from videotuna_tpu_torch.cli.train import run_train
    common = ["--config", path, "--device", "cpu", "--quiet",
              "train.max_steps=8", "train.ckpt_every=4", "train.log_every=2"]
    whole, parts = tmp_path / "whole", tmp_path / "parts"
    random.seed(0)
    state = run_train(common + ["--workdir", str(whole)])
    assert state.step == 8
    assert sorted(os.listdir(whole)) == ["step_4", "step_8"]
    random.seed(0)
    run_train(common + ["--workdir", str(parts), "--max_steps", "4"])
    assert sorted(os.listdir(parts)) == ["step_4"]
    resumed = run_train(common + ["--workdir", str(parts), "--resume"])
    assert resumed.step == 8
    _assert_same(_state(parts / "step_8" / "state.pt"),
                 _state(whole / "step_8" / "state.pt"))


def test_fit_restores_the_signal_handler(tmp_path):
    """``fit`` checkpoints on SIGUSR1 while it runs, then puts the previous
    handler back, so nothing global keeps the trainer and its flow's
    weights alive after it returns."""
    import gc
    import signal
    import weakref
    from videotuna_tpu_torch.cli.train import build_trainer

    def mine(signum, frame):
        pass

    prev = signal.signal(signal.SIGUSR1, mine)
    try:
        trainer, loader, _ = build_trainer(
            ["--config", TINY, "--device", "cpu", "--quiet", "--workdir",
             str(tmp_path / "run"), "train.max_steps=1",
             "train.log_every=1"])
        seen = []
        trainer.callbacks.append(
            lambda step, m, state: seen.append(
                signal.getsignal(signal.SIGUSR1) is mine))
        trainer.fit(loader)
        assert seen == [False]
        assert signal.getsignal(signal.SIGUSR1) is mine
        ref = weakref.ref(trainer)
        del trainer, loader
        gc.collect()
        assert ref() is None
    finally:
        signal.signal(signal.SIGUSR1, prev)


def test_run_inference_merges_a_trained_lora(tmp_path):
    """A LoRA run writes lora.pt beside its state; ``--lora`` merges it
    into the inference weights."""
    from videotuna_tpu_torch.cli.inference import run_inference
    from videotuna_tpu_torch.cli.train import run_train
    from videotuna_tpu_torch.core import config as pc
    run_train(["--config", TINY, "--device", "cpu", "--quiet",
               "--workdir", str(tmp_path / "run"), "train.max_steps=2",
               "train.lora.rank=4", "train.lora.alpha=1.0"])
    tree = torch.load(tmp_path / "run" / "step_2" / "lora.pt",
                      weights_only=True)
    pairs = list(plora._iter_pairs(tree["denoiser"]))
    assert pairs and all(ab["b"].abs().max() > 0 for _, ab in pairs)
    out = run_inference(["--config", TINY, "--device", "cpu", "--quiet",
                         "--savedir", str(tmp_path / "v"),
                         "--lora", str(tmp_path / "run" / "step_2")])
    assert out["metrics"]["nonfinite_pixels"] == 0
    # the merge itself: the flow's weights move by α·(a @ b)
    flow = pregistry.instantiate(pc.load_configs([TINY])["flow"],
                                 device="cpu")
    flow.init_params(seed=0)
    before = flow.denoiser.blocks[0].q.weight.detach().clone()
    from videotuna_tpu_torch.cli.inference import merge_lora_checkpoint
    merge_lora_checkpoint(flow, str(tmp_path / "run" / "step_2"), None, {})
    ab = tree["denoiser"]["block_0"]["q"]["kernel"]
    _close(flow.denoiser.blocks[0].q.weight - before,
           (ab["a"] @ ab["b"].reshape(4, -1)).T, 1e-5)


# ---------------------------------------------------------------- data
def test_dummy_batches_match_jax():
    kw = dict(csv_path=TOY_CSV, num_frames=4, resolution=(64, 64),
              dummy=True)
    jl = jdata.EpochLoader(jdata.DatasetFromCSV(**kw), batch_size=2, seed=3)
    pl = pdata.EpochLoader(pdata.DatasetFromCSV(**kw), batch_size=2, seed=3)
    assert len(pl) == len(jl) == 4
    for epoch in range(2):
        random.seed(epoch)
        jb = list(jl)
        random.seed(epoch)
        pb = list(pl)
        assert len(pb) == len(jb)
        for x, r in zip(pb, jb):
            assert x["caption"] == r["caption"] and x["path"] == r["path"]
            np.testing.assert_allclose(x["video"], r["video"], rtol=0,
                                       atol=1e-6)
    pl.resume_at(5)            # epoch 1, after its first batch
    random.seed(1)
    assert [b["caption"] for b in pl] == [b["caption"] for b in pb[1:]]


def test_validate_and_callbacks(tmp_path):
    """``Trainer.validate`` (mean loss, no state change) and the four
    callbacks, called as ``fit`` calls them."""
    from videotuna_tpu_torch.cli.train import build_trainer
    from videotuna_tpu_torch.training import callbacks as cb
    trainer, loader, _ = build_trainer([
        "--config", TINY_T2V, "--device", "cpu", "--quiet",
        "--workdir", str(tmp_path / "run"), "train.max_steps=2",
        "train.log_every=1", "train.warmup_steps=3"])
    lr = cb.LearningRateMonitor(trainer.optimizer.schedule)
    samples = cb.SampleVideoLogger(
        str(tmp_path), lambda state, step: np.zeros((1, 2, 8, 8, 3)),
        every_n_steps=2)
    trainer.callbacks = [lr, cb.CSVMetricsLogger(str(tmp_path)),
                         cb.ThroughputMonitor(str(tmp_path), 1), samples]
    state = trainer.fit(loader)
    before = {k: v.clone() for k, v in state.params.items()}
    vm = trainer.validate(state, loader, max_batches=2)
    assert vm["val_batches"] == 2.0 and np.isfinite(vm["val_loss"])
    _assert_same(state.params, before)
    assert [s for s, _ in lr.history] == [1, 2]
    assert lr.history[1][1] == pytest.approx(1e-3 * 2 / 3)
    rows = (tmp_path / "metrics.csv").read_text().splitlines()
    assert rows[0].startswith("step,") and len(rows) == 3
    assert len((tmp_path / "throughput.jsonl").read_text().splitlines()) == 2
    assert os.listdir(tmp_path / "samples") == ["step0000002_0.mp4"]


def test_video_dataset_and_toy_csv(tmp_path):
    """The file-list format (videos.txt + labels.txt, frames cut to 4k+1)
    reading .npy videos, and ``make_toy_csv``."""
    rng = np.random.default_rng(0)
    names = []
    for i in range(2):
        np.save(tmp_path / f"v{i}.npy",
                rng.integers(0, 256, (12, 40, 48, 3), dtype=np.uint8))
        names.append(f"v{i}.npy")
    (tmp_path / "videos.txt").write_text("\n".join(names))
    (tmp_path / "labels.txt").write_text("a cat\na dog")
    ds = pdata.VideoDataset(str(tmp_path), num_frames=11,
                            resolution=(32, 32))
    item = ds[1]
    assert item["video"].shape == (9, 32, 32, 3) and item["caption"] == "a dog"
    assert -1.0 <= item["video"].min() and item["video"].max() <= 1.0
    csv_path = pdata.make_toy_csv(str(tmp_path / "anno" / "toy.csv"), n=3)
    rows = open(csv_path).read().splitlines()
    assert rows == ["path,caption", "toy_videos/clip_000.mp4,toy clip 0",
                    "toy_videos/clip_001.mp4,toy clip 1",
                    "toy_videos/clip_002.mp4,toy clip 2"]


def test_run_train_needs_cuda_unless_cpu_is_asked_for(tmp_path):
    from videotuna_tpu_torch.cli.train import run_train
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_train(["--config", TINY_T2V, "--quiet",
                   "--workdir", str(tmp_path)])


@pytest.mark.parametrize("model", ["hunyuan_d128", "cogvideox_d64",
                                   "wan_d128"])
def test_remat_recompute_keeps_the_attention_options(model, monkeypatch):
    """A checkpointed block recomputes its attention under the options its
    forward ran under, though the backward runs outside their scope (as it
    does on autograd's thread for a CUDA tensor): every flash forward, the
    recompute's included, takes the fixed max, and the gradients are those
    of the model without remat."""
    from videotuna_tpu_torch.kernels import attention as PA
    from videotuna_tpu_torch.models.cogvideo.mmdit import CogVideoXTransformer
    from videotuna_tpu_torch.models.hunyuan.dit import HYVideoDiT
    torch.manual_seed(0)
    gen = torch.Generator().manual_seed(1)
    if model == "hunyuan_d128":   # 192 video + 32 text tokens, heads of 128
        m = HYVideoDiT(in_channels=16, out_channels=16, dim=256, heads=2,
                       double_blocks=1, single_blocks=1, text_dim=64,
                       pooled_dim=32)
        args = (torch.randn((1, 3, 16, 16, 16), generator=gen),
                torch.tensor([400.0]), torch.randn((1, 32, 64), generator=gen),
                torch.randn((1, 32), generator=gen))
    elif model == "wan_d128":     # 192 video + 160 text tokens
        from videotuna_tpu_torch.models.wan.dit import WanModel
        m = WanModel(in_channels=16, out_channels=16, dim=256, ffn_dim=512,
                     num_layers=2, heads=2, text_dim=64)
        args = (torch.randn((1, 3, 16, 16, 16), generator=gen),
                torch.tensor([400.0]), torch.randn((1, 160, 64),
                                                   generator=gen))
    else:                         # 128 video + 6 text tokens, heads of 64
        m = CogVideoXTransformer(in_channels=16, out_channels=16, dim=128,
                                 num_layers=2, heads=2, text_dim=16,
                                 time_embed_dim=24)
        args = (torch.randn((1, 2, 16, 16, 16), generator=gen),
                torch.tensor([400]), torch.randn((1, 6, 16), generator=gen))
    seen = []
    fwd = PA.flash_fwd

    def spy(*a, **kw):
        seen[-1].append(kw.get("static_max"))
        return fwd(*a, **kw)

    monkeypatch.setattr(PA, "flash_fwd", spy)
    grads = []
    for remat in (False, True):
        m.remat = remat
        m.zero_grad()
        seen.append([])
        with PA.attention_options(static_max=0.0):
            out = m(*args)
        out.square().mean().backward()   # outside the options' scope
        grads.append([p.grad.clone() for p in m.parameters()
                      if p.grad is not None])
    plain, remat = seen
    assert plain and len(remat) == 2 * len(plain)
    assert set(plain) == set(remat) == {0.0}
    assert len(grads[0]) == len(grads[1])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-6 * float(b.abs().max()) + 1e-12)
