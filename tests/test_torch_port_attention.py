"""Port attention against the JAX package: the plain versions of K1, K2, K4
and K5 against the Pallas kernels (interpret mode), their LSEs, the key
mask's packing for the Hopper kernel, and
``dot_product_attention``'s dispatch on every route.  Inputs come from a
seeded numpy generator and go to both packages; comparisons are in f32 with
atol = 1e-5·max|ref| (the two sides sum in different orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videotuna_tpu.kernels.attention as A
import videotuna_tpu_torch.kernels.attention as P

from tests.test_torch_port_models import torch_one_thread  # noqa: F401

RTOL_MAX = 1e-5


def _qkv(seed, b, sq, h, d, sk=None, kh=None):
    rng = np.random.default_rng(seed)
    sk = sk or sq
    kh = kh or h
    q = rng.standard_normal((b, sq, h, d), dtype=np.float32)
    k = rng.standard_normal((b, sk, kh, d), dtype=np.float32)
    v = rng.standard_normal((b, sk, kh, d), dtype=np.float32)
    return q, k, v


def _close(out, ref, tol=RTOL_MAX):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=tol * float(np.abs(ref).max()))


@pytest.mark.parametrize("static_max", [None, 0.0])
@pytest.mark.parametrize("sq,sk", [(200, 200), (130, 300)])
def test_k1_plain_matches_pallas_packed_t(static_max, sq, sk):
    q, k, v = _qkv(0, 1, sq, 2, 64, sk=sk)
    ref = A.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            interpret=True, pack2="t", static_max=static_max)
    out = P.flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                      torch.from_numpy(v), sm_scale=64 ** -0.5,
                      static_max=static_max, route="K1")
    _close(out, ref)


@pytest.mark.parametrize("static_max", [None, 0.0])
def test_k1_plain_lse_matches_pallas(static_max):
    b, sq, h, sk = 1, 200, 4, 136
    q, k, v = _qkv(1, b, sq, h, 64, sk=sk)
    ref_out, ref_lse = A._flash_packed2t(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), sm_scale=0.125,
        block_q=None, block_k=None, interpret=True, static_max=static_max,
        emit_lse=True)
    # pair-major (B·H/2, 2, Sq_pad) → (B, H, Sq)
    ref_lse = np.asarray(ref_lse).reshape(b, h // 2, 2, -1) \
        .reshape(b, h, -1)[..., :sq]
    out, lse = P.flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), sm_scale=0.125,
                           static_max=static_max, emit_lse=True, route="K1")
    _close(out, ref_out)
    _close(lse, ref_lse)


def _layernorm(x):
    x = x - x.mean(-1, keepdims=True)
    return x / np.sqrt((x * x).mean(-1, keepdims=True) + 1e-5)


# (name, b, sq, h, d, kh, with_bias, causal, bounded, kv_valid)
_CASES = [
    ("bias", 1, 130, 2, 64, None, True, False, False, False),
    ("gqa_k1", 1, 160, 4, 64, 2, False, False, False, False),
    ("below_128", 2, 64, 2, 64, None, False, False, False, False),
    ("bounded_k1", 1, 136, 2, 64, None, False, False, True, False),
    ("bounded_d32_k3", 1, 136, 2, 32, None, False, False, True, False),
    ("causal_k2", 1, 136, 2, 32, None, False, True, False, False),
    ("kv_valid_k4", 2, 136, 2, 64, None, False, False, False, True),
    # STDiT at d=72: the spatial self-attention (K2) and the masked
    # cross-attention to the caption (K4, 136 queries over 40 keys)
    ("stdit_spatial_k2", 2, 256, 2, 72, None, False, False, False, False),
    ("stdit_cross_k4", 2, 136, 2, 72, None, False, False, False, True),
]


@pytest.mark.parametrize("case", _CASES, ids=[c[0] for c in _CASES])
def test_dispatch_matches_jax(case):
    name, b, sq, h, d, kh, with_bias, causal, bounded, masked = case
    sk = 40 if name == "stdit_cross_k4" else sq
    q, k, v = _qkv(2, b, sq, h, d, sk=sk, kh=kh)
    rng = np.random.default_rng(3)
    if bounded:
        q, k = _layernorm(q), _layernorm(k)
    bias = (rng.standard_normal((b, h, sq, sq), dtype=np.float32)
            if with_bias else None)
    kv_valid = None
    if masked:
        kv_valid = np.ones((b, sk), bool)
        kv_valid[0, min(100, sk - 27):] = False
    kw = dict(causal=causal, bounded_logits=bounded)

    old = A._FA_INTERPRET
    A._FA_INTERPRET = True
    try:
        with A.attention_options(static_max=0.0 if bounded else None):
            ref = A.dot_product_attention(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                bias=None if bias is None else jnp.asarray(bias),
                kv_valid=None if kv_valid is None else jnp.asarray(kv_valid),
                **kw)
    finally:
        A._FA_INTERPRET = old
    with P.attention_options(static_max=0.0 if bounded else None):
        out = P.dot_product_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            bias=None if bias is None else torch.from_numpy(bias),
            kv_valid=None if kv_valid is None else torch.from_numpy(kv_valid),
            **kw)
    _close(out, ref)


@pytest.mark.parametrize("kernel,d,causal,bounded,masked", [
    ("K2", 32, True, False, False),
    ("K3", 32, False, True, False),
    ("K4", 64, False, False, True),
])
def test_unported_kernels_raise_off_cpu(kernel, d, causal, bounded, masked):
    """Off the CPU (meta here) no route runs the math path quietly: K2, K3
    and K4 reach ``flash_fwd``, which launches its kernel on a CUDA tensor
    only and raises on any other device."""
    q = torch.empty((1, 256, 2, d), device="meta")
    kv_valid = torch.ones((1, 256), dtype=torch.bool, device="meta") \
        if masked else None
    with P.attention_options(static_max=0.0):
        with pytest.raises(ValueError,
                           match="flash_fwd: unsupported device meta"):
            P.dot_product_attention(q, q, q, causal=causal,
                                    bounded_logits=bounded,
                                    kv_valid=kv_valid)


def test_k1_launch_counter_untouched_on_cpu():
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 1, 128, 2, 64))
    before = (dict(P.flash_fwd.launches), dict(P.flash_fwd.launches_sm90))
    P.flash_fwd(q, k, v, sm_scale=0.125, static_max=0.0, route="K1")
    P.flash_attention(q, k, v, pack2=True)
    assert (P.flash_fwd.launches, P.flash_fwd.launches_sm90) == before


def test_k2_k4_launch_counters_untouched_on_cpu():
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 1, 128, 2, 72))
    before = dict(P.flash_fwd.launches)
    P.flash_fwd(q, k, v, sm_scale=0.125, causal=True)
    P.flash_fwd(q, k, v, sm_scale=0.125,
                kv_valid=torch.ones((1, 128), dtype=torch.bool))
    assert P.flash_fwd.launches == before


# ---------------------------------------------------------------- K2
# (name, d, sq, sk, causal, static_max); static_max runs on LayerNormed q, k
_K2_CASES = [
    ("d72_stdit", 72, 256, 256, False, None),
    ("d72_ragged", 72, 200, 200, False, None),
    ("d72_130x300", 72, 130, 300, False, None),
    ("d32_causal", 32, 130, 300, True, None),
    ("d128_causal", 128, 200, 200, True, None),
    ("d256_static", 256, 200, 200, False, 0.0),
]


@pytest.mark.parametrize("case", _K2_CASES, ids=[c[0] for c in _K2_CASES])
def test_k2_plain_matches_pallas(case):
    _, d, sq, sk, causal, static_max = case
    q, k, v = _qkv(5, 1, sq, 2, d, sk=sk)
    if static_max is not None:
        q, k = _layernorm(q), _layernorm(k)
    ref = A.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal, interpret=True,
                            static_max=static_max)
    out = P.flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                      torch.from_numpy(v), sm_scale=d ** -0.5, causal=causal,
                      static_max=static_max)
    _close(out, ref)


# ---------------------------------------------------------------- K4
def _mask(b, sk, prefix):
    """Row 0 keeps 13 keys (the first 13, or every 9th), row 1 all."""
    m = np.ones((b, sk), bool)
    m[0] = False
    m[0, :13] = True if prefix else False
    if not prefix:
        m[0, ::9] = True
    return m


@pytest.mark.parametrize("static_max", [None, 0.0])
@pytest.mark.parametrize("prefix", [True, False], ids=["prefix", "strided"])
def test_k4_plain_matches_pallas(prefix, static_max):
    b, sq, h, d, sk = 2, 512, 2, 72, 120
    q, k, v = _qkv(6, b, sq, h, d, sk=sk)
    if static_max is not None:
        q, k = _layernorm(q), _layernorm(k)
    kv_valid = _mask(b, sk, prefix)
    ref = A.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            interpret=True, kv_valid=jnp.asarray(kv_valid),
                            static_max=static_max)
    out = P.flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                      torch.from_numpy(v), sm_scale=d ** -0.5,
                      kv_valid=torch.from_numpy(kv_valid),
                      static_max=static_max)
    _close(out, ref)


def test_k4_plain_lse_matches_pallas():
    """K4 with its LSE, as the masked training forward calls it: the caller
    zeroes the masked keys and values and passes their count."""
    b, sq, h, d, sk = 2, 256, 2, 72, 120
    q, k, v = _qkv(7, b, sq, h, d, sk=sk)
    kv_valid = _mask(b, sk, prefix=False)
    vm = kv_valid[:, :, None, None].astype(np.float32)
    counts = (1.0 - kv_valid.astype(np.float32)).sum(axis=1)
    old = A._FA_INTERPRET
    A._FA_INTERPRET = True
    try:
        ref_out, res = A._fa_masked_fwd(
            jnp.asarray(q), jnp.asarray(k * vm), jnp.asarray(v * vm),
            jnp.asarray(counts), None)
    finally:
        A._FA_INTERPRET = old
    ref_lse = np.asarray(res[-1]).reshape(b, h, -1)[..., :sq]
    out, lse = P.flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), sm_scale=d ** -0.5,
                           kv_valid=torch.from_numpy(kv_valid),
                           emit_lse=True)
    _close(out, ref_out)
    _close(lse, ref_lse)


@pytest.mark.parametrize("static_max", [None, 0.0], ids=["online", "fixed"])
def test_k4_plain_lse_matches_pallas_dynpad(static_max):
    """K4 with its LSE against the Pallas ``_flash_dynpad`` (interpret mode)
    as the JAX package calls it: masked k and v rows zeroed, d padded to
    128, heads packed, and their share of l removed in closed form from the
    per-(batch, head) count of zeroed keys; a strided mask, the fixed max
    on LayerNormed q, k."""
    b, sq, h, d, sk = 2, 256, 2, 72, 120
    q, k, v = _qkv(21, b, sq, h, d, sk=sk)
    if static_max is not None:
        q, k = _layernorm(q), _layernorm(k)
    kv_valid = _mask(b, sk, prefix=False)
    vm = kv_valid[:, :, None, None].astype(np.float32)
    d_pad = A._round_to(d, 128)
    block_q = min(A.DEFAULT_BLOCK_Q, A._round_to(sq, 128))
    block_k = min(A.DEFAULT_BLOCK_K, A._round_to(sk, 128))
    sq_pad, sk_pad = A._round_to(sq, block_q), A._round_to(sk, block_k)
    pad = ((0, 0), (0, 0), (0, 0), (0, d_pad - d))
    qt, kt, vt = (A._pack_heads(jnp.pad(jnp.asarray(x), pad), b, s, h, d_pad)
                  for x, s in ((q, sq), (k * vm, sk), (v * vm, sk)))
    qt = jnp.pad(qt, ((0, 0), (0, sq_pad - sq), (0, 0)))
    kt, vt = (jnp.pad(x, ((0, 0), (0, sk_pad - sk), (0, 0)))
              for x in (kt, vt))
    counts = sk_pad - kv_valid.sum(axis=1).astype(np.float32)
    cnt = jnp.broadcast_to(jnp.repeat(jnp.asarray(counts), h)[:, None, None],
                           (b * h, 8, 128)).astype(jnp.float32)
    out_t, ref_lse = A._flash_dynpad(
        qt, kt, vt, cnt, sm_scale=d ** -0.5, block_q=block_q,
        block_k=block_k, emit_lse=True, interpret=True,
        static_max=static_max)
    ref = A._unpack_heads(out_t[:, :sq], b, sq, h, d_pad)[..., :d]
    ref_lse = np.asarray(ref_lse).reshape(b, h, -1)[..., :sq]
    out, lse = P.flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), sm_scale=d ** -0.5,
                           kv_valid=torch.from_numpy(kv_valid),
                           static_max=static_max, emit_lse=True)
    _close(out, ref)
    # every row keeps at least one valid key: the LSE is held on all of them
    _close(lse, ref_lse)


@pytest.mark.parametrize("sk", [1, 13, 120, 128, 300])
def test_k4_mask_words_match_the_bool_mask(sk):
    """The key mask as the persistent Hopper kernel reads it: four int32
    words a 128-key tile, bit c of word w for key 32·w + c, zeros past
    Sk; unpacked again, it is the bool mask."""
    rng = np.random.default_rng(sk)
    kv_valid = rng.random((3, sk)) < 0.6
    kv_valid[1] = True        # every bit of a word set: bit 31 included
    kv_valid[2, 0] = False
    words = P._mask_words(torch.from_numpy(kv_valid))
    n_words = 4 * -(-sk // 128)
    assert words.dtype == torch.int32 and words.shape == (3, n_words)
    bits = (words.numpy().view(np.uint32)[..., None]
            >> np.arange(32, dtype=np.uint32)) & 1
    bits = bits.reshape(3, 32 * n_words).astype(bool)
    np.testing.assert_array_equal(bits[:, :sk], kv_valid)
    assert not bits[:, sk:].any()


# ---------------------------------------------------------------- K5
def _rmsnorm(x):
    return x / np.sqrt((x * x).mean(-1, keepdims=True) + 1e-6)


@pytest.mark.parametrize("static_max", [None, 0.0], ids=["online", "fixed"])
@pytest.mark.parametrize("sq,sk,d", [pytest.param(256, 256, 72, id="256-256"),
                                     pytest.param(200, 300, 72, id="200-300"),
                                     pytest.param(256, 256, 128, id="d128")])
def test_k5_plain_lse_matches_pallas(sq, sk, d, static_max):
    """K5, the training forward with its LSE, at STDiT's d=72 and at
    HunyuanVideo's d=128: the port's plain version against the Pallas
    ``_flash_forward_lse`` (interpret mode) on q, k, v padded to a multiple
    of 128 columns and packed to (B·H, S_pad, d_pad) as ``_fa_fwd`` does;
    at d=72 the fixed max on LayerNormed q, k, at d=128 RMSNormed q, k (the
    DiT's qk-norm) in both modes."""
    b, h = 1, 2
    q, k, v = _qkv(20, b, sq, h, d, sk=sk)
    if d == 128:
        q, k = _rmsnorm(q), _rmsnorm(k)
    elif static_max is not None:
        q, k = _layernorm(q), _layernorm(k)
    d_pad = A._round_to(d, 128)
    block_q = min(A.DEFAULT_BLOCK_Q, A._round_to(sq, 128))
    block_k = min(A.DEFAULT_BLOCK_K, A._round_to(sk, 128))
    sq_pad, sk_pad = A._round_to(sq, block_q), A._round_to(sk, block_k)
    pad = ((0, 0), (0, 0), (0, 0), (0, d_pad - d))
    qt, kt, vt = (A._pack_heads(jnp.pad(jnp.asarray(x), pad), b, s, h, d_pad)
                  for x, s in ((q, sq), (k, sk), (v, sk)))
    qt = jnp.pad(qt, ((0, 0), (0, sq_pad - sq), (0, 0)))
    kt, vt = (jnp.pad(x, ((0, 0), (0, sk_pad - sk), (0, 0)))
              for x in (kt, vt))
    out_t, ref_lse = A._flash_forward_lse(
        qt, kt, vt, sm_scale=d ** -0.5, causal=False, sq=sq, sk=sk,
        block_q=block_q, block_k=block_k, interpret=True,
        static_max=static_max)
    ref = A._unpack_heads(out_t[:, :sq], b, sq, h, d_pad)[..., :d]
    ref_lse = np.asarray(ref_lse).reshape(b, h, -1)[..., :sq]
    out, lse = P.flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), sm_scale=d ** -0.5,
                           static_max=static_max, emit_lse=True, route="K5")
    _close(out, ref)
    _close(lse, ref_lse)


def test_k6_maps_onto_k1_online():
    """``pack2=True`` (K6, the natural-layout packed baseline) computes K1's
    online-softmax function: the Pallas K6 against the port's route."""
    q, k, v = _qkv(8, 1, 200, 2, 64, sk=136)
    ref = A.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            interpret=True, pack2=True)
    out = P.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), pack2=True)
    _close(out, ref)


# ---------------------------------------------------------------- backward
def _jax_bwd(q, k, v, g, causal):
    """JAX's fused backward in interpret mode on its own forward's output
    and LSE → (out, lse (B, H, Sq), dq, dk, dv)."""
    b, sq, h, _ = q.shape
    old = A._FA_INTERPRET
    A._FA_INTERPRET = True
    try:
        out, res = A._fa_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal, None)
        grads = A._fa_bwd(causal, None, None, True, True, res,
                          jnp.asarray(g))
    finally:
        A._FA_INTERPRET = old
    lse = np.asarray(res[4]).reshape(b, h, -1)[..., :sq]
    return (np.asarray(out), lse) + tuple(np.asarray(x) for x in grads)


@pytest.mark.parametrize("d,causal", [(64, False), (72, False), (64, True),
                                     (256, False), (160, False),
                                     (80, False), (128, False)],
                         ids=["k7_d64", "k8_d72", "k8_d64_causal", "k8_d256",
                              "k8_d160", "k8_d80", "k8_d128"])
def test_bwd_plain_matches_pallas(d, causal):
    """``flash_bwd_plain`` against the Pallas fused backward (K7 for d=64
    non-causal, K8 otherwise, which pads d to a multiple of 128 and runs
    every d ≤ 256) on the same q, k, v, o, dO and LSE."""
    q, k, v = _qkv(9, 1, 256, 2, d)
    g = np.random.default_rng(10).standard_normal(q.shape, dtype=np.float32)
    out, lse, *ref = _jax_bwd(q, k, v, g, causal)
    got = P.flash_bwd_plain(*(torch.tensor(x) for x in (q, k, v, out, g,
                                                           lse)),
                            sm_scale=d ** -0.5, causal=causal)
    for x, r in zip(got, ref):
        _close(x, r)


def test_masked_vjp_matches_jax():
    """Gradients through the masked route against the JAX package's
    ``_flash_diff_masked`` (with its outer k·mask multiply), a batch row
    with no valid key included: its dq is 0 and so are masked keys'
    dk, dv."""
    b, sq, sk, h, d = 2, 256, 120, 2, 72
    q, k, v = _qkv(11, b, sq, h, d, sk=sk)
    g = np.random.default_rng(12).standard_normal(q.shape, dtype=np.float32)
    kv_valid = np.ones((b, sk), bool)
    kv_valid[0, 13:] = False
    kv_valid[1] = False

    def loss(q, k, v):
        return jnp.sum(A.dot_product_attention(
            q, k, v, kv_valid=jnp.asarray(kv_valid)) * g)

    old = A._FA_INTERPRET
    A._FA_INTERPRET = True
    try:
        ref = jax.grad(loss, argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    finally:
        A._FA_INTERPRET = old
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = P.dot_product_attention(qt, kt, vt,
                                  kv_valid=torch.from_numpy(kv_valid))
    (out * torch.from_numpy(g)).sum().backward()
    for x, r in zip((qt, kt, vt), ref):
        _close(x.grad, r)
    assert qt.grad[1].abs().max() == 0
    assert kt.grad[0, 13:].abs().max() == 0 == vt.grad[0, 13:].abs().max()


@pytest.mark.parametrize("d", [72, 80])
@pytest.mark.parametrize("pattern", ["strided", "prefix"])
def test_masked_bwd_plain_matches_jax(d, pattern):
    """``flash_bwd_plain`` with the key mask, on the output and LSE of the
    port's masked forward, against the gradients of the JAX package's
    masked route (``_flash_diff_masked`` in interpret mode, with its outer
    k·mask multiply) at STDiT's cross-attention keys: 120 caption tokens,
    batch row 0 keeping every 9th key or the first 13, row 1 none."""
    b, sq, sk, h = 2, 128, 120, 2
    q, k, v = _qkv(20 + d, b, sq, h, d, sk=sk)
    g = np.random.default_rng(21).standard_normal(q.shape, dtype=np.float32)
    kv_valid = np.zeros((b, sk), bool)
    if pattern == "strided":
        kv_valid[0, ::9] = True
    else:
        kv_valid[0, :13] = True

    def loss(q, k, v):
        return jnp.sum(A.dot_product_attention(
            q, k, v, kv_valid=jnp.asarray(kv_valid)) * g)

    old = A._FA_INTERPRET
    A._FA_INTERPRET = True
    try:
        ref = jax.grad(loss, argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    finally:
        A._FA_INTERPRET = old
    qt, kt, vt, gt = (torch.from_numpy(x) for x in (q, k, v, g))
    mask = torch.from_numpy(kv_valid)
    out, lse = P.flash_fwd_plain(qt, kt, vt, sm_scale=d ** -0.5,
                                 kv_valid=mask, emit_lse=True)
    got = P.flash_bwd_plain(qt, kt, vt, out, gt, lse, sm_scale=d ** -0.5,
                            kv_valid=mask)
    for x, r in zip(got, ref):
        _close(x, r)
    assert got[0][1].abs().max() == 0
    assert got[1][0, ~mask[0]].abs().max() == 0 \
        == got[2][0, ~mask[0]].abs().max()


@pytest.mark.parametrize("case", ["k1", "k5", "k5_causal", "masked"])
def test_functions_match_autograd_of_reference(case):
    """The custom VJPs (forward with LSE, plain backward on the CPU) against
    torch.autograd through ``reference_attention``."""
    d = 64 if case in ("k1", "k5_causal") else 72
    sk = 120 if case == "masked" else 256
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _qkv(13, 2, 256, 2, d, sk=sk))
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(14))
    causal = case == "k5_causal"
    kv_valid = bias = None
    if case == "masked":
        kv_valid = torch.ones((2, sk), dtype=torch.bool)
        kv_valid[0, 40:] = False
        bias = torch.where(kv_valid, 0.0, -1e30)[:, None, None, :]
    out = P.dot_product_attention(q, k, v, causal=causal, kv_valid=kv_valid)
    out.backward(g)
    got = [x.grad.clone() for x in (q, k, v)]
    for x in (q, k, v):
        x.grad = None
    P.reference_attention(q, k, v, bias=bias, causal=causal).backward(g)
    for x, r in zip(got, (q.grad, k.grad, v.grad)):
        _close(x, r)


def test_bwd_routes_and_launch_counts_on_cpu():
    """The route a backward stands for, and no launch counted on the CPU."""
    assert P._bwd_route(30, 64, False, None, True) == "K7"
    assert P._bwd_route(30, 64, False, None, False) == "K10"
    assert P._bwd_route(16, 72, False, None, True) == "K8"
    assert P._bwd_route(16, 72, False, None, False) == "K9"
    assert P._bwd_route(2, 64, True, None, True) == "K8"
    assert P._bwd_route(2, 64, False, torch.ones(1, 4), True) == "K8"
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _qkv(15, 1, 128, 2, 64))
    before = (dict(P.flash_bwd.launches), dict(P.flash_fwd.launches),
              dict(P.flash_fwd.launches_sm90))
    P.flash_attention_diff(q, k, v, single_pass=False).sum().backward()
    assert (P.flash_bwd.launches, P.flash_fwd.launches,
            P.flash_fwd.launches_sm90) == before


# ---------------------------------------------------------------- designs
_BF, _F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("route,dtype,d,causal,masked,lse,fixed,design", [
    ("K3", _BF, 128, False, False, False, True, "sm90"),
    ("K3", _BF, 64, False, False, False, True, "sm90"),
    ("K3", _BF, 72, False, False, False, True, "sm90"),
    ("K3", _BF, 32, False, False, False, True, "mma"),
    ("K3", _F32, 128, False, False, False, True, "f32"),
    ("K3", _BF, 128, True, False, False, True, "mma"),
    ("K3", _BF, 128, False, True, False, True, "mma"),
    ("K3", _BF, 128, False, False, True, True, "sm90"),
    # K2 and the masked K4 at d = 128 in bf16 without the LSE (StepVideo's
    # self- and cross-attention, Mochi's joint attention): K3's kernel with
    # the online max and the key mask
    ("K2", _BF, 128, False, False, False, False, "sm90"),
    ("K4", _BF, 128, False, True, False, False, "sm90"),
    ("K4", _BF, 128, False, True, False, True, "sm90"),
    ("K2", _BF, 128, False, False, False, True, "sm90"),
    ("K2", _BF, 128, True, False, False, False, "mma"),
    ("K2", _BF, 128, False, False, True, False, "mma"),
    ("K4", _BF, 128, True, True, False, True, "mma"),
    # K5 at d = 128 online in bf16 (Flux's training forward): K3's kernel
    # with the online max and the LSE
    ("K5", _BF, 128, False, False, True, False, "sm90"),
    ("K5", _BF, 128, False, False, False, False, "sm90"),
    # K2 and K5 at d = 72 and 80 in bf16: the persistent Hopper kernel in
    # either softmax mode, with or without the LSE
    ("K2", _BF, 72, False, False, False, False, "sm90"),
    ("K2", _BF, 72, False, False, False, True, "sm90"),
    ("K2", _BF, 72, False, False, True, False, "sm90"),
    ("K2", _BF, 80, False, False, False, False, "sm90"),
    ("K2", _BF, 80, False, False, True, True, "sm90"),
    ("K5", _BF, 72, False, False, True, False, "sm90"),
    ("K5", _BF, 72, False, False, True, True, "sm90"),
    ("K5", _BF, 72, False, False, False, False, "sm90"),
    ("K5", _BF, 80, False, False, True, False, "sm90"),
    ("K5", _BF, 80, False, False, True, True, "sm90"),
    # K1 and K6 at d=64 in bf16: the persistent kernel in either softmax
    # mode, with or without the LSE; f32 takes the f32 design
    ("K1", _BF, 64, False, False, False, True, "sm90"),
    ("K1", _BF, 64, False, False, True, True, "sm90"),
    ("K1", _BF, 64, False, False, False, False, "sm90"),
    ("K1", _BF, 64, False, False, True, False, "sm90"),
    ("K6", _BF, 64, False, False, False, False, "sm90"),
    ("K6", _BF, 64, False, False, True, False, "sm90"),
    ("K6", _BF, 64, False, False, False, True, "sm90"),
    ("K6", _BF, 64, False, False, True, True, "sm90"),
    ("K1", _F32, 64, False, False, False, True, "f32"),
    ("K1", _F32, 64, False, False, True, False, "f32"),
    ("K6", _F32, 64, False, False, False, False, "f32"),
    # K4 at d = 72 and 80 in bf16: the persistent kernel with the key mask
    ("K4", _BF, 72, False, True, False, False, "sm90"),
    ("K4", _BF, 72, False, True, True, False, "sm90"),
    ("K4", _BF, 80, False, True, True, True, "sm90"),
    ("K4", _BF, 80, False, True, False, True, "sm90"),
    # everything else keeps flash_fwd.cu
    ("K2", _F32, 72, False, False, False, False, "mma"),
    ("K2", _BF, 72, True, False, False, False, "mma"),
    ("K4", _BF, 128, False, True, True, False, "mma"),
    ("K4", _BF, 64, False, True, False, False, "mma"),
    ("K4", _F32, 72, False, True, False, False, "mma"),
    ("K5", _BF, 72, True, False, True, False, "mma"),
    ("K2", _BF, 96, False, False, False, False, "mma"),
    ("K2", _BF, 256, False, False, False, False, "mma"),
    # K5 at d = 128 under the fixed max (HunyuanVideo's training forward):
    # K3's kernel with its LSE; causal, masked or f32 leave it
    ("K5", _BF, 128, False, False, True, True, "sm90"),
    ("K5", _BF, 128, False, False, False, True, "sm90"),
    ("K5", _BF, 128, True, False, True, True, "mma"),
    ("K5", _F32, 128, False, False, True, True, "f32"),
    ("K5", _BF, 128, False, True, True, True, "mma"),
    # f32 at d = 64, 80 and 128 without a key mask (LLaMA's causal K2, the
    # 2D VAE's mid attention, the CLIP towers): flash_fwd_f32_sm90.cu,
    # causal or not, online or fixed max, with or without the LSE; the
    # masked f32 call and other f32 widths keep flash_fwd.cu
    ("K2", _F32, 128, True, False, False, False, "f32"),
    ("K2", _F32, 128, True, False, True, False, "f32"),
    ("K2", _F32, 128, False, False, False, False, "f32"),
    ("K2", _F32, 128, False, False, True, True, "f32"),
    ("K5", _F32, 128, True, False, True, False, "f32"),
    ("K4", _F32, 128, False, True, False, False, "mma"),
    ("K4", _F32, 128, False, True, True, True, "mma"),
    ("K2", _F32, 64, True, False, False, False, "f32"),
    ("K2", _F32, 80, False, False, False, False, "f32"),
    ("K2", _F32, 80, True, False, True, True, "f32"),
    ("K4", _F32, 80, False, True, False, False, "mma"),
    ("K2", _F32, 256, True, False, True, False, "mma"),
    # K2 at d=64 in bf16 (an odd head count: the UNet's 5-head level): the
    # same persistent kernel, non-causal; causal keeps flash_fwd.cu, f32
    # takes the f32 design
    ("K2", _BF, 64, False, False, False, False, "sm90"),
    ("K2", _BF, 64, False, False, False, True, "sm90"),
    ("K2", _BF, 64, False, False, True, False, "sm90"),
    ("K2", _BF, 64, True, False, False, False, "mma"),
    ("K2", _F32, 64, False, False, False, False, "f32"),
    # K5 at d=64 (the UNet's training forward at its 5-head level and over
    # 77 text keys): the same persistent kernel with the LSE
    ("K5", _BF, 64, False, False, True, False, "sm90"),
    ("K5", _BF, 64, False, False, True, True, "sm90"),
    ("K5", _BF, 64, True, False, True, False, "mma"),
    ("K5", _F32, 64, False, False, True, False, "f32"),
])
def test_fwd_design_is_a_function_of_route_and_options(route, dtype, d,
                                                       causal, masked, lse,
                                                       fixed, design):
    """The Hopper forward (flash_fwd_sm90.cu) serves the fixed-max route K3
    in bf16 at d = 64 without the LSE, the fixed-max route K3 and K5 under
    either max in bf16 at d = 128 with or without the LSE, K2 and the
    masked K4 in bf16 at d = 128 without the LSE under either max, K1, K2
    and K6 in bf16 at
    d = 64,
    and K2, K3, K5 and the masked K4 in bf16 at d = 72 or 80, in either
    softmax mode, with or without the LSE, all non-causal and unmasked but
    for K4; the f32 design (flash_fwd_f32_sm90.cu) every unmasked f32 call
    at d = 64, 80 and 128; every other call keeps flash_fwd.cu."""
    kv_valid = torch.ones((1, 8), dtype=torch.bool) if masked else None
    assert P._fwd_design(route, dtype, d, causal, kv_valid, lse,
                         0.0 if fixed else None) == design


@pytest.mark.parametrize("route,dtype,d,causal,masked,design", [
    # K7 and its two-kernel baseline K10: the d=64 Hopper backward in bf16
    ("K7", _BF, 64, False, False, "sm90"),
    ("K10", _BF, 64, False, False, "sm90"),
    ("K7", _F32, 64, False, False, "mma"),
    ("K10", _F32, 64, False, False, "mma"),
    # K8 and K9 at STDiT's widths in bf16, non-causal, with or without the
    # key mask: the short-row Hopper backward
    ("K8", _BF, 72, False, False, "sm90"),
    ("K8", _BF, 72, False, True, "sm90"),
    ("K8", _BF, 80, False, False, "sm90"),
    ("K8", _BF, 80, False, True, "sm90"),
    ("K9", _BF, 72, False, False, "sm90"),
    ("K9", _BF, 72, False, True, "sm90"),
    ("K9", _BF, 80, False, False, "sm90"),
    ("K9", _BF, 80, False, True, "sm90"),
    # everything else keeps flash_bwd.cu
    ("K8", _BF, 72, True, False, "mma"),
    ("K8", _BF, 80, True, False, "mma"),
    ("K9", _BF, 72, True, False, "mma"),
    ("K8", _F32, 72, False, False, "mma"),
    ("K8", _F32, 80, False, True, "mma"),
    # K8 and K9 at d = 64 (the UNet's 5-head level), unmasked and
    # non-causal: the Hopper backward since the UNet trains on the card
    ("K8", _BF, 64, False, False, "sm90"),
    ("K9", _BF, 64, False, False, "sm90"),
    ("K8", _BF, 64, True, False, "mma"),
    ("K8", _BF, 64, False, True, "mma"),
    ("K8", _BF, 128, False, False, "sm90"),
    ("K8", _BF, 128, False, True, "mma"),
    ("K9", _BF, 128, False, False, "sm90"),
    ("K8", _BF, 256, False, False, "mma"),
    ("K8", _BF, 256, False, True, "mma"),
    ("K8", _BF, 160, True, False, "mma"),
    ("K8", _BF, 32, True, False, "mma"),
    # K8 and K9 at d = 128 (HunyuanVideo's training backward): the single
    # pass of flash_bwd_sm90.cu unmasked and non-causal, else flash_bwd.cu
    ("K8", _BF, 128, True, False, "mma"),
    ("K9", _BF, 128, False, True, "mma"),
    ("K8", _F32, 128, False, False, "mma"),
])
def test_bwd_design_is_a_function_of_route(route, dtype, d, causal, masked,
                                           design):
    """The Hopper backwards serve bf16 non-causal calls only: K7 and K10
    at d=64 and K8 and K9 at d = 64 and 128 unmasked, K8 and K9 at d = 72
    and 80, masked or not; causal, f32, masked d = 64 and 128 and every
    other width keep flash_bwd.cu."""
    assert P._bwd_design(route, dtype, d, causal, masked) == design


@pytest.mark.parametrize("d,sk,kernel", [
    # the short-row kernel at STDiT's widths, whatever the key length
    (72, 256, "rows"), (80, 4096, "rows"), (72, 120, "rows"),
    # at d = 64 over keys that fit one 128-key tile (the UNet's 77 text
    # keys), where it beat flash_bwd_sm90 over a training step's calls
    (64, 77, "rows"), (64, 128, "rows"), (64, 1, "rows"),
    # flash_bwd_sm90 at d = 64 over longer keys and at d = 128
    (64, 129, "sm90"), (64, 2560, "sm90"), (128, 77, "sm90"),
    (128, 7456, "sm90"),
])
def test_bwd_kernel_is_a_function_of_width_and_keys(d, sk, kernel):
    assert P._bwd_kernel(d, sk) == kernel


@pytest.mark.parametrize("bh,sq,sk,plan", [
    # STDiT-XL/2 training: spatial (B=16 × 16 heads, 256 × 256) keeps a
    # head's 4 query tiles and dQ in shared memory; cross (16 heads, 4096
    # queries over 120 keys) splits a head into 8 units of 8 query tiles
    (256, 256, 256, (False, 4)),
    (16, 4096, 120, (False, 8)),
    # the cross shape at B=2: 4 units of 16 tiles fill the SMs as well as 8
    # of 8, and the fewer units win the tie
    (32, 4096, 120, (False, 16)),
    # one key tile, few query tiles: one unit a query tile at most
    (4, 512, 120, (False, 1)),
    (6, 1, 13, (False, 1)),
    (6, 300, 128, (False, 2)),
    (6, 700, 13, (False, 2)),
    # several key tiles: a unit a head while its queries fit 4 tiles ...
    (6, 1, 300, (False, 1)),
    (6, 256, 129, (False, 4)),
    (2, 200, 4322, (False, 4)),
    # ... else the atomic mode
    (6, 257, 129, (True, 5)),
    (2, 300, 4322, (True, 5)),
    (4, 4096, 4096, (True, 64)),
])
def test_bwd_rows_plan(bh, sq, sk, plan):
    """The short-row backward's plan on an H100's 132 SMs: (atomic,
    query tiles a unit)."""
    assert P._bwd_rows_plan(bh, sq, sk, 132) == plan


@pytest.mark.parametrize("sk", [13, 120, 300])
def test_pack_mask_words_on_cpu_is_the_plain_packing(sk):
    """``_pack_mask_words`` on a CPU tensor is ``_mask_words``, and it
    checks the mask's shape."""
    rng = np.random.default_rng(sk)
    kv_valid = torch.from_numpy(rng.random((2, sk)) < 0.3)
    assert torch.equal(P._pack_mask_words(kv_valid, 2, sk),
                       P._mask_words(kv_valid))
    with pytest.raises(ValueError, match="kv_valid"):
        P._pack_mask_words(kv_valid, 2, sk + 1)


def test_sm90_counters_untouched_on_cpu():
    """On CPU tensors the K2, K3, K5 and K7 routes run their plain versions:
    no launch counted, per route or per design, and no alignment copy."""
    q, k, v = (torch.from_numpy(x).bfloat16()
               for x in _qkv(16, 1, 128, 3, 128))
    g = torch.from_numpy(np.random.default_rng(17).standard_normal(
        (1, 128, 2, 64), dtype=np.float32)).bfloat16()
    before = (dict(P.flash_fwd.launches), dict(P.flash_fwd.launches_sm90),
              P.flash_fwd.tma_copies, dict(P.flash_bwd.launches),
              dict(P.flash_bwd.launches_sm90),
              dict(P.flash_fwd.launches_d128),
              dict(P.flash_bwd.launches_d128))
    out = P.flash_attention(q, k, v.transpose(1, 2).contiguous()
                            .transpose(1, 2), static_max=0.0)
    ref = P.flash_fwd_plain(q, k, v, sm_scale=128 ** -0.5, static_max=0.0)
    assert torch.equal(out, ref)
    # K5 and K8 at HunyuanVideo's d=128 under the fixed max
    out, lse = P.flash_fwd(q, k, v, sm_scale=128 ** -0.5, static_max=0.0,
                           emit_lse=True, route="K5")
    ref, ref_lse = P.flash_fwd_plain(q, k, v, sm_scale=128 ** -0.5,
                                     static_max=0.0, emit_lse=True)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    g3 = torch.ones_like(out)
    got = P.flash_bwd(q, k, v, out, g3, lse, sm_scale=128 ** -0.5)
    ref = P.flash_bwd_plain(q, k, v, out, g3, lse, sm_scale=128 ** -0.5)
    assert all(torch.equal(x, r) for x, r in zip(got, ref))
    # K2 and K5 at STDiT's d=72, strided v included
    q7, k7, v7 = (torch.from_numpy(x).bfloat16()
                  for x in _qkv(19, 1, 256, 2, 72))
    v7 = v7.transpose(1, 2).contiguous().transpose(1, 2)
    out = P.flash_fwd(q7, k7, v7, sm_scale=72 ** -0.5, route="K2")
    assert torch.equal(out, P.flash_fwd_plain(q7, k7, v7,
                                              sm_scale=72 ** -0.5))
    out, lse = P.flash_fwd(q7, k7, v7, sm_scale=72 ** -0.5, emit_lse=True,
                           route="K5")
    ref, ref_lse = P.flash_fwd_plain(q7, k7, v7, sm_scale=72 ** -0.5,
                                     emit_lse=True)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    q2, k2, v2 = (x.requires_grad_() for x in
                  (torch.from_numpy(a) for a in _qkv(18, 1, 128, 2, 64)))
    P.flash_attention_diff(q2, k2, v2).backward(g.float())
    assert (P.flash_fwd.launches, P.flash_fwd.launches_sm90,
            P.flash_fwd.tma_copies, P.flash_bwd.launches,
            P.flash_bwd.launches_sm90, P.flash_fwd.launches_d128,
            P.flash_bwd.launches_d128) == before



def test_attribution_variants_apply_to_the_sources():
    """Every variant of ``kernels/attribution.py`` edits text that its
    kernel's source still holds (on the card a stale one raises), K5 and
    K8 at d=128 among them."""
    from videotuna_tpu_torch import kernels
    from videotuna_tpu_torch.kernels import attribution
    names = {kernel for kernel, _, _ in attribution.VARIANTS}
    assert {"K5_d128", "K8_d128"} <= names
    for (kernel, source, name), edits in attribution.VARIANTS.items():
        text = (kernels.CSRC / source).read_text()
        for old, _ in edits:
            assert old in text, f"{kernel} {name}: {old[:60]!r}"
