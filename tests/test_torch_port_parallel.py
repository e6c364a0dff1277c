"""The port's parallelism against the JAX package on the CPU:
``core/mesh.py``, ``parallel/sequence.py`` (Ulysses, ring and the hybrid
through ``sp_attention``), ``sequence_parallel``'s routing rule
(``kernels/attention.py``), and ``parallel/tensor_parallel.py`` on the
narrow StepVideo DiT.

The JAX side runs on the 8-virtual-device CPU mesh of ``tests/conftest.py``
(4 or 2 of its devices); the port's ranks are threads of this process over
torch's threaded process group (``tests/torch_ranks.py``), and in one test
four spawned processes over gloo, as ``torchrun`` starts them.  Inputs are
seeded numpy arrays in f32; every rank's result is held to JAX's within
1e-4 of max|ref| (the JAX package's own SP tests hold it to 2e-5 against
its reference): forward outputs, and the gradients of q, k and v of
Σ out².  The training step at a mesh is in
``tests/test_torch_port_parallel_train.py``.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videotuna_tpu.core import config as jconfig
from videotuna_tpu.core import registry as jregistry
from videotuna_tpu.core.mesh import MeshConfig as JMeshConfig
from videotuna_tpu.core.mesh import make_mesh as jmake_mesh
from videotuna_tpu.kernels import attention as JA
from videotuna_tpu.models.stepvideo.dit import StepVideoModel as JStep
from videotuna_tpu.parallel import sequence as JS
from videotuna_tpu.parallel.tensor_parallel import tp_specs as jtp_specs
from videotuna_tpu_torch.core import config as pconfig
from videotuna_tpu_torch.core import registry as pregistry
from videotuna_tpu_torch.core.mesh import Mesh, MeshConfig, make_mesh
from videotuna_tpu_torch.kernels import attention as PA
from videotuna_tpu_torch.models.stepvideo.dit import StepVideoModel as PStep
from videotuna_tpu_torch.parallel import sequence as PS
from videotuna_tpu_torch.parallel import sharding as PSH
from videotuna_tpu_torch.parallel import tensor_parallel as PTP
from videotuna_tpu_torch.tools.from_jax import load_jax_params

from tests.test_torch_port_models import (  # noqa: F401
    jax_params, torch_one_thread)
from tests.test_torch_port_stepvideo import CONFIG as STEP_CONFIG
from tests.test_torch_port_stepvideo import NARROW as STEP_NARROW
from tests.torch_ranks import run_processes, run_threaded, sp_attention_rank

TOL = 1e-4


def _close(out, ref, tol=TOL):
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) \
        else np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=tol * float(np.abs(ref).max()))


# ---------------------------------------------------------------- the mesh
def test_make_mesh_is_jax_make_mesh_on_one_rank():
    """Axis names and order, sizes, and the world-size check."""
    from videotuna_tpu.core import mesh as jmesh
    from videotuna_tpu_torch.core import mesh as pmesh
    assert pmesh.AXES == jmesh.AXES
    assert pmesh.DEFAULT_RULES == jmesh.DEFAULT_RULES
    mesh = make_mesh(device_type="cpu")
    assert mesh.shape == {"dp": 1, "fsdp": 1, "sp": 1, "tp": 1}
    assert mesh.device_mesh is None and mesh.group("sp") is None
    with pytest.raises(ValueError, match="= 4 != device count 1"):
        make_mesh(MeshConfig(fsdp=2, sp=2), "cpu")
    with pmesh.use_mesh(mesh):
        assert pmesh.get_mesh() is mesh
    assert pmesh.initialize_distributed("cpu") == "cpu"   # one process


def test_mesh_coordinates_and_batch_blocks():
    """Four threaded ranks on dp2×fsdp2: each rank's coordinates, its block
    of the batch (the whole batch where it does not divide) and the axis
    groups' sizes."""
    batch = {"x": torch.arange(8.0)[:, None], "odd": torch.arange(3.0),
             "captions": ["a", "b"]}

    def body(rank):
        mesh = make_mesh(MeshConfig(dp=2, fsdp=2), "cpu")
        part = PSH.shard_batch(batch, mesh)
        return (mesh.coords, part["x"][:, 0].tolist(), part["odd"].tolist(),
                torch.distributed.get_world_size(mesh.group("fsdp")))

    for rank, (coords, x, odd, n) in enumerate(run_threaded(4, body)):
        assert coords == {"dp": rank // 2, "fsdp": rank % 2, "sp": 0,
                          "tp": 0}
        assert x == [2.0 * rank, 2.0 * rank + 1] and odd == [0.0, 1.0, 2.0]
        assert n == 2


# ---------------------------------------------------------------- SP
# mode: (mesh axes, ulysses axis, ring axis, batch axes), the JAX tests'
MODES = {"ulysses": ({"sp": 4}, "sp", None, ("dp", "fsdp")),
         "ring": ({"sp": 4}, None, "sp", ("dp", "fsdp")),
         "hybrid": ({"sp": 2, "tp": 2}, "sp", "tp", ("dp",))}


def _qkv():
    rng = np.random.default_rng(0)
    return tuple(rng.standard_normal((2, 64, 8, 16), dtype=np.float32)
                 for _ in range(3))


@functools.cache
def _jax_sp(mode):
    """JAX's sp_attention on 4 devices: the output and the gradients of
    q, k, v of Σ out² (one jit a mode)."""
    axes, u, r, batch = MODES[mode]
    mesh = jmake_mesh(JMeshConfig(**axes), devices=jax.devices()[:4])

    def loss(q, k, v):
        out = JS.sp_attention(mesh, q, k, v, ulysses_axis=u, ring_axis=r,
                              batch_axes=batch)
        return jnp.sum(out ** 2), out

    with mesh:
        (_, out), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(*map(jnp.asarray,
                                                         _qkv()))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _check_ranks(results, mode):
    jout, jgrads = _jax_sp(mode)
    for out, *grads in results:   # every rank holds the global tensors
        _close(out, jout)
        for g, jg in zip(grads, jgrads):
            _close(g, jg)


@pytest.mark.parametrize("mode", list(MODES))
def test_sp_attention_matches_jax(mode):
    """Ulysses sp=4, ring sp=4 and Ulysses(sp=2)×ring(tp=2) on four
    threaded ranks: forward and gradients, on every rank."""
    axes, u, r, batch = MODES[mode]
    q, k, v = map(torch.from_numpy, _qkv())
    _check_ranks(run_threaded(4, sp_attention_rank, axes, u, r, q, k, v,
                              batch), mode)


def test_sp_attention_in_gloo_processes():
    """The hybrid (Ulysses over sp, ring over tp) in four processes over
    gloo, each joining through ``initialize_distributed`` from torchrun's
    variables."""
    axes, u, r, batch = MODES["hybrid"]
    q, k, v = map(torch.from_numpy, _qkv())
    _check_ranks(run_processes(4, sp_attention_rank, axes, u, r, q, k, v,
                               batch), "hybrid")


def test_ring_hops_use_the_hop_functions():
    """The ring's forward runs one K5-route hop per block and its backward
    one flash backward per block (plain versions on the CPU, so the launch
    counts do not move), the blocks' LSE merged to the whole LSE."""
    q, k, v = (torch.from_numpy(x[:1]) for x in _qkv())
    seen = {"fwd": [], "bwd": []}
    hop, hop_bwd = PS._hop_attention, PS._hop_backward

    def spy_fwd(*a):
        seen["fwd"].append(a[1].shape)
        return hop(*a)

    def spy_bwd(*a):
        seen["bwd"].append(a[4].shape)
        return hop_bwd(*a)

    launches = (dict(PA.flash_fwd.launches), dict(PA.flash_bwd.launches))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PS, "_hop_attention", spy_fwd)
        mp.setattr(PS, "_hop_backward", spy_bwd)
        res = run_threaded(4, sp_attention_rank, {"sp": 4}, None, "sp",
                           q, k, v)
    assert len(seen["fwd"]) == len(seen["bwd"]) == 16    # 4 ranks × 4 hops
    assert all(s == (1, 16, 8, 16) for s in seen["fwd"])
    assert all(s == (1, 8, 16) for s in seen["bwd"])      # the global LSE
    assert (PA.flash_fwd.launches, PA.flash_bwd.launches) == launches
    full, lse = PA.flash_fwd_plain(q, k, v, sm_scale=0.25, emit_lse=True)
    _close(res[0][0], full.numpy())


# ---------------------------------------------------------------- routing
_S = (1, 1024, 4, 16)
# case: (q shape, k shape, dot_product_attention options, routed)
ROUTES = {
    "routed": (_S, _S, {}, True),
    "short": ((1, 512, 4, 16), (1, 512, 4, 16), {}, False),
    "indivisible": ((1, 1030, 4, 16), (1, 1030, 4, 16), {}, False),
    "heads": ((1, 1024, 6, 16), (1, 1024, 6, 16), {}, False),
    "cross": (_S, (1, 77, 4, 16), {}, False),
    "bias": (_S, _S, {"bias": np.zeros((1, 1, 1, 1024), np.float32)},
             False),
    "causal": (_S, _S, {"causal": True}, False),
    "kv_valid": (_S, _S, {"kv_valid": np.ones((1, 1024), bool)}, False),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_sequence_parallel_routes_as_jax(case, monkeypatch):
    """Inside ``sequence_parallel`` over an sp=4 mesh (min_seq 1024), a call
    goes to ``sp_attention`` in the port exactly when it does in the JAX
    package: long, divisible, equal-length self-attention without bias,
    causal mask or kv_valid, heads divisible by the Ulysses extent."""
    qs, ks, opts, routed = ROUTES[case]
    rng = np.random.default_rng(1)
    q = rng.standard_normal(qs, dtype=np.float32)
    k = rng.standard_normal(ks, dtype=np.float32)
    calls = {"jax": 0, "port": 0}

    def spy(side):
        def sp_attention(mesh, q, *a, **kw):
            calls[side] += 1
            return q
        return sp_attention

    monkeypatch.setattr(JS, "sp_attention", spy("jax"))
    monkeypatch.setattr(PS, "sp_attention", spy("port"))
    jmesh = jmake_mesh(JMeshConfig(sp=4), devices=jax.devices()[:4])
    with JA.sequence_parallel(jmesh):
        JA.dot_product_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(k), **{
                                     n: jnp.asarray(o) if hasattr(o, "shape")
                                     else o for n, o in opts.items()})
    # a mesh of the axes alone: the spy stands in for the collectives
    with PA.sequence_parallel(Mesh(MeshConfig(sp=4), "cpu")):
        PA.dot_product_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(k), **{
                                     n: torch.from_numpy(o)
                                     if hasattr(o, "shape") else o
                                     for n, o in opts.items()})
    assert calls == {"jax": int(routed), "port": int(routed)}


# ---------------------------------------------------------------- TP
_STEP = dict(in_channels=16, out_channels=16, dim=256, ffn_dim=512,
             num_layers=2, heads=2, text_dim=48, clip_dim=32,
             scan_blocks=False)


def _flax_path(path):
    """The port's flax-layout path in the JAX tree's naming (its blocks
    are ``block_<i>``)."""
    return re.sub(r"^blocks/(\d+)/", r"block_\1/", path)


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_specs_match_jax_on_stepvideo(tp):
    """The rule table gives the narrow StepVideo DiT's kernels the same
    column/row specs as JAX ``tp_specs`` (at tp=4 the 2-head q/k/v do not
    divide and fall back), and every other leaf none."""
    jmod, pmod = JStep(**_STEP), PStep(**_STEP)
    params = jax_params(jmod, like=pmod)
    jspecs = {"/".join(p.key for p in path): tuple(s) for path, s in
              jax.tree_util.tree_flatten_with_path(
                  jtp_specs(params, tp),
                  is_leaf=lambda s: isinstance(
                      s, jax.sharding.PartitionSpec))[0]}
    pspecs = PTP.tp_specs(pmod, tp)
    paths = {name: _flax_path(path)
             for name, path, _, _ in PTP._flax_leaves(pmod)}
    kernels = {paths[n]: tuple(s) for n, s in pspecs.items()
               if paths[n].endswith("/kernel") and paths[n] in jspecs}
    assert kernels == {p: s for p, s in jspecs.items() if p in kernels}
    # the patch embedding is a convolution in the port (no Linear kernel)
    assert {p for p in jspecs if p.endswith("/kernel")} - set(kernels) \
        == {"patch_embed/kernel"}
    assert all(s == () for n, s in pspecs.items()
               if not paths[n].endswith("/kernel"))
    assert sum("tp" in s for s in kernels.values()) == (25 if tp == 2
                                                        else 13)


@functools.cache
def _step_flows():
    overrides = STEP_NARROW + [
        "flow.params.denoiser_config.params.scan_blocks=false"]
    jcfg = jconfig.load_configs([STEP_CONFIG], overrides)
    jregistry.populate()
    jflow = jregistry.instantiate(jcfg["flow"])
    pcfg = pconfig.load_configs([STEP_CONFIG], overrides)
    return jflow, pcfg


def test_stepvideo_denoiser_at_tp2_matches_jax():
    """The narrow StepVideo flow's denoiser call (CFG's batch of 2, the
    CLIP states before a ragged caption) after ``shard_for_tp`` over a
    tp=2 mesh, on two threaded ranks, against JAX's ``shard_for_tp`` run;
    each rank holds half of every q/k/v, out and FFN weight and one of the
    two heads."""
    jflow, pcfg = _step_flows()
    pflows = [pregistry.instantiate(pcfg["flow"], device="cpu")
              for _ in range(2)]
    params = jax_params(jflow.denoiser, like=pflows[0].denoiser)
    rng = np.random.default_rng(2)
    mask = np.zeros((2, 24), bool)
    mask[0], mask[1, :9] = True, True
    x = rng.standard_normal((2, 2, 8, 8, 64), dtype=np.float32)
    t = np.array([500.0, 500.0], np.float32)
    cond = {"y": rng.standard_normal((2, 24, 256), dtype=np.float32),
            "y2": rng.standard_normal((2, 77, 32), dtype=np.float32),
            "y_mask": mask}
    mesh = jmake_mesh(JMeshConfig(tp=2), devices=jax.devices()[:2])
    jflow.params = {"denoiser": params}
    jflow.shard_for_tp(mesh)
    with mesh:
        ref = jax.jit(lambda p, x, t, c: jflow.denoise_apply(
            {"denoiser": p}, x, t, c))(jflow.params["denoiser"],
                                        jnp.asarray(x), jnp.asarray(t),
                                        {k: jnp.asarray(v)
                                         for k, v in cond.items()})
    for f in pflows:
        load_jax_params(f.denoiser, params)

    def body(rank):
        flow = pflows[rank]
        flow.shard_for_tp(make_mesh(MeshConfig(tp=2), "cpu"))
        blk = flow.denoiser.blocks[0]
        with torch.no_grad():
            out = flow.denoise_apply(torch.from_numpy(x), torch.from_numpy(t),
                                     {k: torch.from_numpy(v)
                                      for k, v in cond.items()})
        return out, blk.heads, blk.self_q.weight.to_local().shape

    for out, heads, q_shape in run_threaded(2, body):
        assert heads == 1 and q_shape == (128, 256)
        _close(out, ref)


@pytest.mark.parametrize("fsdp", [2, 4])
def test_sharding_specs_match_jax(fsdp):
    """``fsdp_spec``'s choice (the largest divisible axis, small
    parameters whole), the TP column/row specs, ``logical_to_mesh``'s
    placements and ``constrain`` on a rank's tensor."""
    from torch.distributed.tensor import Replicate, Shard
    from videotuna_tpu.parallel import sharding as JSH
    for shape in [(4096,), (4095,), (64, 128), (3, 4096, 7), (5, 7),
                  (6, 1000), (2, 2048)]:
        ref = JSH.fsdp_spec(jnp.zeros(shape), fsdp)
        assert tuple(PSH.fsdp_spec(shape, fsdp)) == tuple(ref), shape
    assert tuple(PSH.tp_col_spec()) == tuple(JSH.tp_col_spec())
    assert tuple(PSH.tp_row_spec()) == tuple(JSH.tp_row_spec())
    mesh = Mesh(MeshConfig(fsdp=fsdp), "cpu")
    tree = {"a": PSH.tp_col_spec(), "b": {"c": PSH.P(("dp", "fsdp"))}}
    placed = PSH.logical_to_mesh(tree, mesh)
    assert placed["a"] == (Replicate(),) * 3 + (Shard(1),)
    assert placed["b"]["c"] == (Shard(0), Shard(0), Replicate(),
                                Replicate())
    x = torch.ones(4, 3)
    assert PSH.constrain(x, "sp") is x and PSH.constrain_batch(x) is x
