"""Port attention against the JAX package: K1's plain version against the
Pallas kernel K1 (interpret mode), its LSE, and ``dot_product_attention``'s
dispatch on every route.  Inputs come from a seeded numpy generator and go to
both packages; comparisons are in f32 with atol = 1e-5·max|ref| (the two
sides sum in different orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videotuna_tpu.kernels.attention as A
import videotuna_tpu_torch.kernels.attention as P

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
    out = P.flash_fwd_d64(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), sm_scale=64 ** -0.5,
                          static_max=static_max)
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
    out, lse = P.flash_fwd_d64(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), sm_scale=0.125,
                               static_max=static_max, emit_lse=True)
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
]


@pytest.mark.parametrize("case", _CASES, ids=[c[0] for c in _CASES])
def test_dispatch_matches_jax(case):
    _, b, sq, h, d, kh, with_bias, causal, bounded, masked = case
    q, k, v = _qkv(2, b, sq, h, d, kh=kh)
    rng = np.random.default_rng(3)
    if bounded:
        q, k = _layernorm(q), _layernorm(k)
    bias = (rng.standard_normal((b, h, sq, sq), dtype=np.float32)
            if with_bias else None)
    kv_valid = None
    if masked:
        kv_valid = np.ones((b, sq), bool)
        kv_valid[0, 100:] = False
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
    """A route whose TPU kernel is not ported raises on a non-CPU tensor
    (meta here) instead of running the math path quietly."""
    q = torch.empty((1, 256, 2, d), device="meta")
    kv_valid = torch.ones((1, 256), dtype=torch.bool, device="meta") \
        if masked else None
    with P.attention_options(static_max=0.0):
        with pytest.raises(NotImplementedError, match=kernel):
            P.dot_product_attention(q, q, q, causal=causal,
                                    bounded_logits=bounded,
                                    kv_valid=kv_valid)


def test_k1_launch_counter_untouched_on_cpu():
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 1, 128, 2, 64))
    before = P.flash_fwd_d64.launches
    P.flash_fwd_d64(q, k, v, sm_scale=0.125, static_max=0.0)
    assert P.flash_fwd_d64.launches == before
