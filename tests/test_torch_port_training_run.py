"""The port's training loop against the JAX package on the CPU (split
from ``tests/test_torch_port_training.py``, which holds the losses and
LoRA):

- the optimizer and train step against optax on identical gradients;
- ``run_train`` end to end with checkpoints and resume, the signal
  handler, a trained LoRA merged by ``run_inference``, validation and
  callbacks, the dummy dataset's batches against the JAX module's;
- remat's recompute under the forward's attention options.
"""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from videotuna_tpu.data import datasets as jdata
from videotuna_tpu.training import trainer as jtrainer
from videotuna_tpu_torch.core import registry as pregistry
from videotuna_tpu_torch.data import datasets as pdata
from videotuna_tpu_torch.training import lora as plora
from videotuna_tpu_torch.training import trainer as ptrainer

from tests.test_torch_port_flow import TINY, TINY_T2V
from tests.test_torch_port_models import torch_one_thread  # noqa: F401
from tests.test_torch_port_training import TOY_CSV, _close


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

    # under one jit, as the JAX trainer runs it (op by op, MultiSteps'
    # lax.cond would compile again on every call)
    jstep = jax.jit(jtrainer.make_train_step(jloss, tx, jcfg.ema_decay))
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
    # a mesh that does not multiply to the world size (one process here)
    # raises as the JAX package's make_mesh does
    from videotuna_tpu_torch.cli.train import run_train
    with pytest.raises(ValueError, match="!= device count 1"):
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
