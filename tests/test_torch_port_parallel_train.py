"""One training step of the port on a mesh against the JAX package's at the
same mesh, on the CPU: the narrow Wan 2.1 1.3B denoiser (dim 256, 2 heads
of d = 128, 2 layers, f32) on seeded latents of 3×16×16 (192 video
tokens).

- ``{fsdp: 2}``: the port's ``Trainer`` shards the denoiser with FSDP2 over
  two threaded ranks, each rank takes half of the batch and half of the
  draws; the JAX side places the parameters with ``shard_params`` and the
  batch with ``shard_batch``.
- ``{sp: 2}``: both sides under ``sequence_parallel`` (min_seq 128), so
  the denoiser's self-attention runs as Ulysses over the two ranks, which
  both hold the whole batch.
- ``{fsdp: 2, sp: 2}`` on four ranks with a batch of 4: each fsdp rank's
  block of 2 samples, which its two sp ranks share, through Ulysses
  inside the trainer's ``mesh_scope``; a block that would be split over
  fsdp a second time, or gathered across fsdp ranks, mixes samples.

JAX's draws (σ, noise) are handed to the port, and the JAX side embeds
the timestep on the port's f32 frequency table, as in
``tests/test_torch_port_training.py``.  The step's loss (averaged over the
ranks), its gradient norm and every weight's gradient (gathered whole from
the ranks' blocks) are held to JAX's value and gradient at that mesh within
that test's tolerances: 1e-5 of the loss, and of each leaf's max|grad| plus
1e-7 of the largest gradient.
"""

import contextlib
import copy
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from videotuna_tpu.core.mesh import MeshConfig as JMeshConfig
from videotuna_tpu.core.mesh import make_mesh as jmake_mesh
from videotuna_tpu.kernels import attention as JA
from videotuna_tpu.models.wan import dit as jwan_dit
from videotuna_tpu.parallel.sharding import shard_batch as jshard_batch
from videotuna_tpu.parallel.sharding import shard_params as jshard_params
from videotuna_tpu_torch.core.mesh import MeshConfig, make_mesh
from videotuna_tpu_torch.parallel import sequence as PS
from videotuna_tpu_torch.parallel import sharding as PSH
from videotuna_tpu_torch.tools.from_jax import load_jax_params
from videotuna_tpu_torch.training import trainer as ptrainer

from tests.test_torch_port_models import torch_one_thread  # noqa: F401
from tests.test_torch_port_training import (TOL, _close, _flows,
                                            _jax_embedding_on_port_freqs)
from tests.test_torch_port_wan import CONFIG_1_3B, NARROW
from tests.torch_ranks import run_threaded, train_step_rank

MESHES = {"fsdp2": {"fsdp": 2}, "sp2": {"sp": 2},
          "fsdp2_sp2": {"fsdp": 2, "sp": 2}}
# the global batch of each mesh: 2 samples, or a block of 2 a fsdp rank
BATCH = {"fsdp2_sp2": 4}
MIN_SEQ = 128


def _inputs(b=2):
    rng = np.random.default_rng(4)
    batch = {"latents": rng.standard_normal((b, 3, 16, 16, 16),
                                            dtype=np.float32),
             "text_states": rng.standard_normal((b, 32, 64),
                                                dtype=np.float32)}
    key = jax.random.key(5)
    _, k_sig, k_noise = jax.random.split(key, 3)
    draws = {"sigma": np.asarray(jax.nn.sigmoid(
                 jax.random.normal(k_sig, (b,)))),
             "noise": np.asarray(jax.random.normal(
                 k_noise, batch["latents"].shape))}
    return batch, key, draws


def _sp(sequence_parallel, mesh, on):
    return (sequence_parallel(mesh, min_seq=MIN_SEQ) if on
            else contextlib.nullcontext())


@functools.cache
def _jax_step(name):
    """JAX's loss and denoiser gradients at the mesh (one jit a mesh)."""
    axes = MESHES[name]
    _, jflow, _, params = _flows(CONFIG_1_3B, NARROW, denoiser_only=True)
    batch, key, _ = _inputs(BATCH.get(name, 2))
    world = int(np.prod(list(axes.values())))
    mesh = jmake_mesh(JMeshConfig(**axes), devices=jax.devices()[:world])

    def jloss(den, b):
        return jflow.training_loss(dict(params, denoiser=den), b, key)

    with mesh, _sp(JA.sequence_parallel, mesh, "sp" in axes):
        den = jax.device_put(params["denoiser"],
                             jshard_params(params["denoiser"], mesh))
        jb = jshard_batch({k: jnp.asarray(v) for k, v in batch.items()},
                          mesh)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            jloss, has_aux=True))(den, jb)
    return float(loss), jax.device_get(grads)


@pytest.mark.parametrize("name", list(MESHES))
def test_train_step_on_a_mesh_matches_jax(name, tmp_path, monkeypatch):
    axes = MESHES[name]
    world = int(np.prod(list(axes.values())))
    _, _, pflow, _ = _flows(CONFIG_1_3B, NARROW, denoiser_only=True)
    flows = [copy.deepcopy(pflow) for _ in range(world)]
    batch, _, draws = _inputs(BATCH.get(name, 2))
    routed = []
    sp_attention = PS.sp_attention
    monkeypatch.setattr(PS, "sp_attention", lambda *a, **kw: routed.append(
        a[1].shape) or sp_attention(*a, **kw))
    results = run_threaded(world, train_step_rank, axes, flows, batch,
                           draws, str(tmp_path), "cpu",
                           MIN_SEQ if "sp" in axes else None)

    monkeypatch.setattr(jwan_dit, "timestep_embedding",
                        _jax_embedding_on_port_freqs)
    jloss, jgrads = _jax_step(name)
    ref = copy.deepcopy(pflow.denoiser)
    load_jax_params(ref, jgrads)
    gmax = max(float(r.detach().abs().max()) for r in ref.parameters())
    jnorm = float(optax.global_norm(jgrads))
    for loss, gnorm, grads, n_sharded in results:
        _close(torch.tensor(loss), np.float32(jloss))
        assert gnorm == pytest.approx(jnorm, rel=1e-5)
        assert len(grads) == len(dict(ref.named_parameters()))
        for pname, r in ref.named_parameters():
            torch.testing.assert_close(
                grads[f"denoiser/{pname}"], r.detach(), rtol=0,
                atol=TOL * float(r.abs().max()) + 1e-7 * gmax, msg=pname)
        assert (n_sharded > 0) == ("fsdp" in axes)  # the large weights
        if "sp" not in axes:
            assert not routed
        else:       # 2 layers × the ranks, forward and remat, each rank's
            assert len(routed) >= 2 * world     # block of 2 samples whole
            assert all(s[:2] == (2, 192) for s in routed)


def test_trainer_checkpoint_on_a_mesh_is_whole(tmp_path):
    """At ``{fsdp: 2}`` rank 0 writes the whole state (each sharded weight
    gathered from both ranks' blocks), and a resumed trainer on each rank
    reads it back into its own blocks."""
    _, _, pflow, _ = _flows(CONFIG_1_3B, NARROW, denoiser_only=True)
    flows = [copy.deepcopy(pflow) for _ in range(2)]
    full = {f"denoiser/{n}": p.detach().clone()
            for n, p in pflow.denoiser.named_parameters()}

    def body(rank):
        mesh = make_mesh(MeshConfig(fsdp=2), "cpu")
        trainer = ptrainer.Trainer(flows[rank], ptrainer.TrainConfig(),
                                   workdir=str(tmp_path), mesh=mesh)
        state = trainer.init_state()
        step_dir = trainer.save(state, 3)
        state.params = {k: torch.zeros_like(v)
                        for k, v in state.params.items()}
        state.opt_state = trainer.optimizer.init(state.params)
        resumed = trainer.maybe_resume(state)
        return step_dir, {k: PSH.full_tensor(v, trainer._sharded[k])
                          if k in trainer._sharded else v
                          for k, v in resumed.params.items()}

    results = run_threaded(2, body)
    saved = torch.load(os.path.join(results[0][0], "state.pt"),
                       weights_only=True)
    assert results[0][0].endswith("step_3") and saved["step"] == 0
    assert set(saved["params"]) == set(full)
    for k, v in full.items():
        torch.testing.assert_close(saved["params"][k], v.float())
        for _, params in results:
            torch.testing.assert_close(params[k], v.float())


def _lora_rank(rank, flows, axes, batch, draws, workdir):
    """One LoRA step's (loss, grad norm, LoRA gradients averaged over the
    batch's ranks) on a mesh of ``axes``."""
    mesh = make_mesh(MeshConfig(**axes), "cpu")
    flow = flows[rank]
    trainer = ptrainer.Trainer(
        flow, ptrainer.TrainConfig(lora={"rank": 4, "alpha": 1.0}),
        workdir=workdir, mesh=mesh)
    state = trainer.init_state()
    flow.training_loss = functools.partial(
        type(flow).training_loss, flow,
        **{k: torch.from_numpy(v.copy())
           for k, v in PSH.shard_batch(draws, mesh).items()})
    seen = {}
    update = trainer.optimizer.update

    def spy(grads, opt_state, params):   # the gradients the optimizer gets
        seen.update({k: g.clone() for k, g in grads.items()})
        return update(grads, opt_state, params)

    trainer.optimizer.update = spy
    step = trainer.compiled_step()
    _, metrics = step(state, {k: torch.from_numpy(v.copy()) for k, v in
                              PSH.shard_batch(batch, mesh).items()}, None)
    base = [p for p in flow.denoiser.parameters() if PSH.is_sharded(p)]
    return float(metrics["loss"]), float(metrics["grad_norm"]), seen, \
        len(base)


def test_lora_step_on_fsdp2_matches_one_rank(tmp_path):
    """A LoRA step at ``{fsdp: 2}``: the frozen base sharded by FSDP2, each
    rank its half of the batch, the LoRA leaves' gradients averaged over
    the ranks: the loss, the gradient norm and every leaf's gradient equal
    one rank's on the whole batch within 1e-5 of the leaf's max."""
    _, _, pflow, _ = _flows(CONFIG_1_3B, NARROW, denoiser_only=True)
    batch, _, draws = _inputs()
    one = _lora_rank(0, [copy.deepcopy(pflow)], {}, batch, draws,
                     str(tmp_path / "one"))
    two = run_threaded(2, _lora_rank, [copy.deepcopy(pflow)
                                       for _ in range(2)], {"fsdp": 2},
                       batch, draws, str(tmp_path / "two"))
    assert one[3] == 0
    for loss, gnorm, grads, n_sharded in two:
        assert n_sharded > 0
        assert loss == pytest.approx(one[0], rel=1e-5)
        assert gnorm == pytest.approx(one[1], rel=1e-5)
        assert set(grads) == set(one[2])
        for k, g in one[2].items():
            torch.testing.assert_close(grads[k], g, rtol=0,
                                       atol=1e-5 * float(g.abs().max())
                                       + 1e-12, msg=k)
