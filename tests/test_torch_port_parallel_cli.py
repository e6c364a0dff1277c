"""The port's commands on a mesh, each rank a separate process over gloo on
the CPU as ``torchrun`` starts them (``tests/torch_ranks.run_processes``),
against the same command on one rank, on the tiny Open-Sora config.

- ``run_train`` at ``{fsdp: 2, sp: 2}`` (four processes) with a batch of
  one sample, which does not divide over fsdp: every rank holds it whole
  and draws the one rank's noise, FSDP2 shards the denoiser's large
  weights, Ulysses takes the spatial self-attention, rank 0 alone writes
  the whole checkpoint.  Each step's loss and gradient norm equal the one
  rank's within 1e-5.
- ``run_inference`` at ``{fsdp: 2}`` (the denoiser under FSDP2, sampled
  under ``inference_mode``) and at ``{sp: 2}`` (Ulysses): every rank's
  sampled latents equal the one rank's within 1e-5 of their max, and rank
  0 alone writes the mp4 and ``metric.json``.

The tiny STDiT's spatial attention has 16 tokens, so the ranks route it
through SP with ``sequence_parallel``'s min_seq lowered to 16; its
temporal (4 frames) and text cross-attention stay local.  The one rank
runs in a process of its own too, and every process starts with
PYTHONHASHSEED=0: the dummy loader seeds each clip from the string hash of
its path and the offline tokenizer hashes words, as the JAX package's do,
and Python salts that hash per process.
"""

import contextlib
import functools
import os
import random

import pytest
import torch

from tests.test_torch_port_flow import TINY_T2V
from tests.test_torch_port_models import torch_one_thread  # noqa: F401
from tests.torch_ranks import run_processes

MIN_SEQ = 16
TOL = 1e-5


def _lower_min_seq():
    """Route the tiny model's 16-token attention through SP in this rank's
    process, and count the routed calls."""
    from videotuna_tpu_torch.kernels import attention as A
    from videotuna_tpu_torch.parallel import sequence as PS
    routed = []
    A.sequence_parallel = functools.partial(A.sequence_parallel,
                                            min_seq=MIN_SEQ)
    sp_attention = PS.sp_attention
    PS.sp_attention = lambda *a, **kw: (routed.append(tuple(a[1].shape))
                                        or sp_attention(*a, **kw))
    return routed


def _train(rank, argv):
    """One rank of ``run_train``: (each step's loss and gradient norm, the
    routed calls' q shapes, the number of sharded weights)."""
    from videotuna_tpu_torch.cli.train import run_train
    from videotuna_tpu_torch.parallel import sharding
    from videotuna_tpu_torch.training.trainer import Trainer
    routed = _lower_min_seq()
    # the crops' draws as build_trainer seeds them on a mesh (the tiny
    # config's train.seed)
    random.seed(42)
    seen = {}
    fit = Trainer.fit

    def spy(self, *a, **kw):
        state = fit(self, *a, **kw)
        seen["history"] = [(m["loss"], m["grad_norm"])
                           for m in self.metrics_history]
        seen["sharded"] = sum(sharding.is_sharded(p)
                              for p in self.flow.denoiser.parameters())
        return state

    Trainer.fit = spy
    run_train(argv)
    return seen["history"], routed, seen["sharded"]


def _infer(rank, argv):
    """One rank of ``run_inference``: (the sampled latents, the routed
    calls' q shapes, the number of sharded weights)."""
    from videotuna_tpu_torch.cli import inference
    from videotuna_tpu_torch.parallel import sharding
    routed = _lower_min_seq()
    seen = {"z": [], "sharded": 0}
    shard_flow = inference.shard_flow

    @contextlib.contextmanager
    def spy(flow, mesh):
        sample = flow.sample

        def sampled(*a, **kw):
            z = sample(*a, **kw)
            seen["z"].append(z.detach().float().cpu())
            return z

        flow.sample = sampled
        with shard_flow(flow, mesh):
            seen["sharded"] = sum(sharding.is_sharded(p)
                                  for p in flow.denoiser.parameters())
            yield

    inference.shard_flow = spy
    inference.run_inference(argv)
    return seen["z"], routed, seen["sharded"]


def test_run_train_on_fsdp2_sp2_matches_one_rank(tmp_path, monkeypatch):
    monkeypatch.setenv("PYTHONHASHSEED", "0")
    common = ["--config", TINY_T2V, "--device", "cpu", "--quiet",
              "--max_steps", "2"]
    overrides = ["train.log_every=1", "data.batch_size=1"]
    (one, _, _), = run_processes(1, _train, common + [
        "--workdir", str(tmp_path / "one")] + overrides)
    work = tmp_path / "four"
    ranks = run_processes(4, _train, common + ["--workdir", str(work)]
                          + overrides + ["train.mesh.fsdp=2",
                                         "train.mesh.sp=2"])
    assert len(one) == 2
    for history, routed, sharded in ranks:
        assert sharded > 0
        # depth 1: spatial attention forward and backward, 2 steps
        assert len(routed) >= 2 and all(s[1] == 16 for s in routed)
        for (loss, gnorm), (ref_loss, ref_gnorm) in zip(history, one,
                                                        strict=True):
            assert loss == pytest.approx(ref_loss, rel=TOL)
            assert gnorm == pytest.approx(ref_gnorm, rel=TOL)
    # rank 0 wrote the whole state once
    assert sorted(os.listdir(work)) == ["step_2"]
    saved = torch.load(work / "step_2" / "state.pt", weights_only=True)
    ref = torch.load(tmp_path / "one" / "step_2" / "state.pt",
                     weights_only=True)
    assert {k: v.shape for k, v in saved["params"].items()} == \
        {k: v.shape for k, v in ref["params"].items()}


INFER = ["--config", TINY_T2V, "--device", "cpu", "--quiet"]


@pytest.fixture(scope="module")
def one_rank_inference(tmp_path_factory):
    """The one rank's run_inference: (its latents, its savedir)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PYTHONHASHSEED", "0")
        out = tmp_path_factory.mktemp("one")
        (one, _, _), = run_processes(1, _infer, INFER + ["--savedir",
                                                         str(out)])
    return one, out


@pytest.mark.parametrize("axes", ["fsdp", "sp"])
def test_run_inference_on_a_mesh_matches_one_rank(axes, tmp_path,
                                                  monkeypatch,
                                                  one_rank_inference):
    one, one_dir = one_rank_inference
    monkeypatch.setenv("PYTHONHASHSEED", "0")
    out = tmp_path / "two"
    ranks = run_processes(2, _infer, INFER + [
        "--savedir", str(out), f"inference.mesh.{axes}=2"])
    assert len(one) == 1
    for zs, routed, sharded in ranks:
        assert (sharded > 0) == (axes == "fsdp")
        assert bool(routed) == (axes == "sp")
        assert len(zs) == 1
        torch.testing.assert_close(zs[0], one[0], rtol=0,
                                   atol=TOL * float(one[0].abs().max()))
    assert sorted(os.listdir(out)) == sorted(os.listdir(one_dir))
    assert len(os.listdir(out)) == 2       # one mp4 and metric.json
