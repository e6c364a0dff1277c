"""Port modules against the JAX package at small widths: the JAX module's
parameter tree (names and shapes from its ``init``) is filled from a seeded
numpy generator → ``tools/from_jax``; inputs come from numpy too, and
outputs are compared in f32 with atol = 1e-5·max|ref| for modules and
1e-3·max|ref| for decoded pixels (deeper conv stacks, other summation
order).  Random norm scales and biases, unlike flax's ones and zeros, make a
swapped leaf in the converter show."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videotuna_tpu.kernels.attention as JA
import videotuna_tpu_torch.kernels.attention as PA
from videotuna_tpu.models import layers as JL
from videotuna_tpu.models.cogvideo.mmdit import CogVideoXBlock as JBlock
from videotuna_tpu.models.cogvideo.mmdit import \
    CogVideoXTransformer as JTransformer
from videotuna_tpu.models.cogvideo.vae import CogVideoXVAE as JCogVAE
from videotuna_tpu.models.text_encoders import T5Encoder as JT5
from videotuna_tpu.models.vae3d import CausalVAE3D as JVAE3D
from videotuna_tpu_torch.models import layers as PL
from videotuna_tpu_torch.models.cogvideo.mmdit import CogVideoXBlock as PBlock
from videotuna_tpu_torch.models.cogvideo.mmdit import \
    CogVideoXTransformer as PTransformer
from videotuna_tpu_torch.models.cogvideo.vae import CogVideoXVAE as PCogVAE
from videotuna_tpu_torch.models.text_encoders import T5Encoder as PT5
from videotuna_tpu_torch.models.text_encoders import t5_relative_bucket
from videotuna_tpu_torch.models.vae3d import CausalVAE3D as PVAE3D
from videotuna_tpu_torch.tools.from_jax import load_jax_params

MODULE_TOL = 1e-5
PIXEL_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def torch_one_thread():
    """torch on one CPU thread for each port test module, restored after
    it: the suite's workers share the machine's cores, and with torch's
    default pool (a thread a core) in every worker the port's tests ran
    twice as long.  Every port test module imports this fixture."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(out, ref, tol=MODULE_TOL):
    if isinstance(out, torch.Tensor):
        out = out.detach().numpy()
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=tol * float(np.abs(ref).max()))


def jax_params(jmodule, *inputs, seed=0, **kwargs):
    """The flax tree of ``jmodule`` with seeded numpy values: kernels
    N(0, 1/fan_in), norm scales 1 + N(0, 0.1²), everything else N(0, 0.1²).
    ``eval_shape`` traces ``init`` (given ``inputs`` and ``kwargs``) without
    compiling it."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(functools.partial(jmodule.init, **kwargs),
                            jax.random.key(0), *inputs)

    def fill(path, leaf):
        name = str(path[-1].key)
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "kernel":
            fan_in = leaf.shape[0] if len(leaf.shape) == 3 \
                else int(np.prod(leaf.shape[:-1]))
            return x / np.sqrt(fan_in)
        return 1.0 + 0.1 * x if name == "scale" else 0.1 * x

    return jax.tree_util.tree_map_with_path(fill, shapes["params"])


_params = jax_params


def _apply(jmodule, params, *inputs, method=None):
    """The JAX module applied under one jit (cheaper on the CPU than
    op-by-op dispatch, which compiles every op for its shape)."""
    fn = functools.partial(jmodule.apply, method=method)
    return jax.jit(fn)({"params": params}, *map(jnp.asarray, inputs))


def _port(pmodule, params):
    load_jax_params(pmodule, params)
    return pmodule.eval()


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------- layers
def test_timestep_embedding_and_rope_tables():
    t = np.array([0, 17, 999], np.int32)
    _close(PL.timestep_embedding(_t(t), 33),
           JL.timestep_embedding(jnp.asarray(t), 33))
    assert PL.split_rope_dims(64) == JL.split_rope_dims(64) == (16, 24, 24)
    for got, want in zip(PL.rope_3d(16, 24, 24, 3, 4, 5),
                         JL.rope_3d(16, 24, 24, 3, 4, 5)):
        _close(got, want)


def test_apply_rope_and_unpatchify():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 60, 2, 64), dtype=np.float32)
    cos, sin = JL.rope_3d(16, 24, 24, 3, 4, 5)
    _close(PL.apply_rope(_t(x), _t(cos), _t(sin)),
           JL.apply_rope(jnp.asarray(x), cos, sin))
    y = rng.standard_normal((2, 3 * 4 * 5, 1 * 2 * 2 * 16), dtype=np.float32)
    _close(PL.unpatchify_3d(_t(y), (3, 4, 5), (1, 2, 2), 16),
           JL.unpatchify_3d(jnp.asarray(y), (3, 4, 5), (1, 2, 2), 16))


def test_timestep_embedder_and_rmsnorm():
    rng = np.random.default_rng(1)
    t = np.array([3, 500], np.int32)
    jm = JL.TimestepEmbedder(48)
    params = _params(jm, jnp.asarray(t))
    _close(_port(PL.TimestepEmbedder(48), params)(_t(t)),
           _apply(jm, params, t))
    x = rng.standard_normal((2, 7, 24), dtype=np.float32)
    jn = JL.RMSNorm()
    params = _params(jn, jnp.asarray(x))
    _close(_port(PL.RMSNorm(24), params)(_t(x)), _apply(jn, params, x))


# ---------------------------------------------------------------- T5
def test_t5_relative_bucket_matches():
    from videotuna_tpu.models.text_encoders import t5_relative_bucket as jb
    pos = np.arange(300)
    rel = pos[None, :] - pos[:, None]
    np.testing.assert_array_equal(
        t5_relative_bucket(torch.from_numpy(rel)).numpy(),
        np.asarray(jb(jnp.asarray(rel))))


def test_t5_encoder_matches():
    cfg = dict(vocab_size=300, dim=32, heads=2, head_dim=16, ff_dim=64,
               num_layers=2)
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 300, (2, 11)).astype(np.int32)
    mask = np.ones((2, 11), bool)
    mask[1, 7:] = False
    jm = JT5(**cfg)
    params = _params(jm, jnp.asarray(ids), jnp.asarray(mask))
    ref = _apply(jm, params, ids, mask)
    out = _port(PT5(**cfg), params)(_t(ids), _t(mask))
    _close(out, ref)


# ---------------------------------------------------------------- MMDiT
@pytest.mark.parametrize("use_rope,scan", [(True, False), (True, True),
                                           (False, False), (False, True)])
def test_cogvideox_transformer_matches(use_rope, scan):
    cfg = dict(in_channels=16, out_channels=16, dim=32, num_layers=2,
               heads=2, text_dim=16, time_embed_dim=24, use_rope=use_rope,
               scan_blocks=scan)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 2, 8, 8, 16), dtype=np.float32)
    t = np.array([10, 900], np.int32)
    y = rng.standard_normal((2, 6, 16), dtype=np.float32)
    jm = JTransformer(**cfg)
    params = _params(jm, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y))
    ref = _apply(jm, params, x, t, y)
    out = _port(PTransformer(**cfg), params)(_t(x), _t(t), _t(y))
    _close(out, ref)


def test_cogvideox_block_through_k1_matches():
    """dim 128, 2 heads of d=64 and 140 tokens: both packages take the K1
    flash route (Pallas interpret mode against K1's plain version) under
    the flow's fixed max."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 140, 128), dtype=np.float32)
    temb = rng.standard_normal((2, 24), dtype=np.float32)
    cos, sin = JL.rope_3d(16, 24, 24, 2, 5, 13)         # 130 video tokens
    jm = JBlock(128, 2, 10)
    params = _params(jm, jnp.asarray(x), jnp.asarray(temb), cos, sin)
    old = JA._FA_INTERPRET
    JA._FA_INTERPRET = True
    try:
        with JA.attention_options(static_max=0.0):
            ref = _apply(jm, params, x, temb, cos, sin)
    finally:
        JA._FA_INTERPRET = old
    block = _port(PBlock(128, 2, 24), params)
    with PA.attention_options(static_max=0.0):
        out = block(_t(x), _t(temb), 10, _t(cos), _t(sin))
    _close(out, ref)


# ---------------------------------------------------------------- VAEs
def test_causal_vae3d_matches():
    cfg = dict(ch=8, ch_mult=(1, 2, 2), num_res_blocks=1, z_channels=16,
               embed_dim=16)
    rng = np.random.default_rng(5)
    video = rng.uniform(-1, 1, (1, 9, 32, 32, 3)).astype(np.float32)
    z = rng.standard_normal((1, 3, 8, 8, 16), dtype=np.float32)
    jm = JVAE3D(**cfg)
    params = _params(jm, jnp.asarray(video))
    pm = _port(PVAE3D(**cfg), params)
    with torch.no_grad():
        _close(pm.encode(_t(video)),
               _apply(jm, params, video, method=jm.encode))
        _close(pm.decode(_t(z)), _apply(jm, params, z, method=jm.decode),
               PIXEL_TOL)


def test_cogvideox_vae_matches():
    """9 frames ↔ 3 latent frames: both temporal halvings and doublings,
    the first-frame paths and the zq resize of the spatial norms."""
    cfg = dict(ch=8, ch_mult=(1, 2, 2, 4), num_res_blocks=1,
               norm_num_groups=4)
    rng = np.random.default_rng(6)
    video = rng.uniform(-1, 1, (1, 9, 32, 32, 3)).astype(np.float32)
    jm = JCogVAE(**cfg)
    params = _params(jm, jnp.asarray(video))
    pm = _port(PCogVAE(**cfg), params)
    moments = _apply(jm, params, video, method=jm.encode)
    with torch.no_grad():
        _close(pm.encode(_t(video)), moments)
        z = np.asarray(moments)[..., :16]
        _close(pm.decode(_t(z)), _apply(jm, params, z, method=jm.decode),
               PIXEL_TOL)


def test_from_jax_is_strict():
    jm = JT5(vocab_size=50, dim=16, heads=2, head_dim=8, ff_dim=32,
             num_layers=1)
    params = _params(jm, jnp.zeros((1, 4), jnp.int32))
    pm = PT5(vocab_size=50, dim=16, heads=2, head_dim=8, ff_dim=32,
             num_layers=1)
    bad = dict(params, extra={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="extra"):
        load_jax_params(pm, bad)
    partial = {k: v for k, v in params.items() if k != "final_norm"}
    with pytest.raises(KeyError, match="not set"):
        load_jax_params(pm, partial)
