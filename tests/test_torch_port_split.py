"""The split-key forward on the CPU: ``_fwd_split_plan``'s units, the plain
split-and-combine (``flash_fwd_split_plain``) against ``flash_fwd_plain``
and the JAX package's Pallas kernels in interpret mode, the f32 design's
tables, and a message that names ``ROADMAP.md`` queue 1's item 9.

Inputs come from a seeded numpy generator and go to both packages; the
comparisons are in f32 with atol = 1e-5·max|ref| (the partials and the
combine sum in another order than one pass over the keys)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videotuna_tpu.kernels.attention as A
import videotuna_tpu_torch.kernels.attention as P
from tests.test_torch_port_attention import _K2_CASES, _qkv
from tests.test_torch_port_models import torch_one_thread  # noqa: F401

RTOL_MAX = 1e-5
SMS = 132   # an H100's SMs


def _close(out, ref, tol=RTOL_MAX):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=tol * float(np.abs(ref).max()))


# ---------------------------------------------------------------- the plan
# (design, b, h, sq, sk, d, causal)
_PLANS = [
    ("sm90", 2, 4, 300, 4322, 64, False),     # K6's A/B shape: split
    ("sm90", 2, 4, 17, 4322, 64, False),      # Sq < 64: split
    ("sm90", 1, 2, 40, 1100, 64, False),      # the CPU test's K6 shape
    ("sm90", 2, 4, 2000, 2000, 64, False),    # 128 units: none fits
    ("sm90", 1, 3, 300, 4322, 72, False),     # d = 72: split
    ("f32", 1, 32, 256, 256, 128, True),      # LLaMA: split
    ("f32", 1, 2, 200, 200, 128, True),       # ragged causal
    ("f32", 2, 3, 300, 130, 128, True),       # more queries than keys
    ("f32", 4, 1, 1024, 1024, 128, False),    # the 2D VAE's mid attention
    ("f32", 1, 2, 1, 77, 128, False),         # one query
]


@pytest.mark.parametrize("design,b,h,sq,sk,d,causal", _PLANS)
def test_fwd_split_plan_covers_every_pair_once(design, b, h, sq, sk, d,
                                               causal):
    """The units of every query tile cover each (row, key) pair of the
    full or causal score matrix exactly once, their ranges adjacent and in
    order, and the units fit the card's resident blocks once split."""
    plan = P._fwd_split_plan(design, b, h, sq, sk, d, causal, False, SMS)
    count = np.zeros((sq, sk), np.int32)
    for qt, ranges in enumerate(plan.ranges):
        r0, r1 = qt * plan.block_m, min((qt + 1) * plan.block_m, sq)
        assert ranges[0][0] == 0
        for (t0, t1), nxt in zip(ranges, ranges[1:] + ((None, None),)):
            assert t0 < t1 and (nxt[0] is None or nxt[0] == t1)
            count[r0:r1, t0 * plan.block_n:t1 * plan.block_n] += 1
    want = np.ones((sq, sk), np.int32)
    if causal:
        want = np.tril(want)
    assert np.array_equal(count * want, want)
    assert plan.splits == max(len(r) for r in plan.ranges)
    if plan.splits > 1:
        per_sm = P._SPLIT_TILING[design][2]
        assert b * h * sum(len(r) for r in plan.ranges) <= per_sm * SMS


# (label, design, b, h, sq, sk, d, causal, masked, splits)
_MAIN_PATHS = [
    ("K1 CogVideoX-5B", "sm90", 2, 48, 17776, 17776, 64, False, False, 1),
    ("K1 CogVideoX-2B train", "sm90", 1, 30, 17776, 17776, 64, False, False,
     1),
    ("K2 STDiT spatial", "sm90", 32, 16, 256, 256, 72, False, False, 1),
    ("K5 STDiT spatial", "sm90", 16, 16, 256, 256, 72, False, False, 1),
    ("K4 STDiT cross", "sm90", 2, 16, 4096, 120, 72, False, True, 1),
    ("K4 STDiT cross train", "sm90", 1, 16, 4096, 120, 72, False, True, 1),
    ("K3 HunyuanVideo", "sm90", 1, 24, 119056, 119056, 128, False, False, 1),
    ("K5 d128 HunyuanVideo train", "sm90", 1, 24, 7456, 7456, 128, False,
     False, 1),
    # the key mask stays unsplit where the unmasked call splits
    ("K4 long keys", "sm90", 1, 3, 300, 4322, 72, False, True, 1),
    ("K6 A/B", "sm90", 2, 4, 300, 4322, 64, False, False, 5),
    ("K2 f32 LLaMA", "f32", 1, 32, 256, 256, 128, True, False, 3),
]


@pytest.mark.parametrize("label,design,b,h,sq,sk,d,causal,masked,splits",
                         _MAIN_PATHS, ids=[c[0] for c in _MAIN_PATHS])
def test_fwd_split_plan_splits_only_short_query_sides(label, design, b, h,
                                                      sq, sk, d, causal,
                                                      masked, splits):
    """The main paths' shapes stay unsplit; K6's A/B shape splits into 5
    ranges of 6-7 key tiles (120 units for 132 SMs), LLaMA's f32 causal K2
    into ranges of two or three 32-key tiles: 1, 2, 2 and 3 for its four
    query tiles, 8 units a head, 256 for two blocks on each of 132 SMs."""
    plan = P._fwd_split_plan(design, b, h, sq, sk, d, causal, masked, SMS)
    assert plan.splits == splits
    if label == "K6 A/B":
        assert plan.ranges[0] == ((0, 6), (6, 13), (13, 20), (20, 27),
                                  (27, 34))
    if label == "K2 f32 LLaMA":
        assert plan.ranges == (((0, 2),), ((0, 2), (2, 4)), ((0, 3), (3, 6)),
                               ((0, 2), (2, 5), (5, 8)))


def test_fwd_split_plan_mirrors_the_persistent_kernels_unit_walk():
    """The persistent kernel cuts a query tile's keys as the plan does:
    range j of ``splits`` is [j·n // splits, (j+1)·n // splits)."""
    from videotuna_tpu_torch import kernels
    text = (kernels.CSRC / "flash_fwd_sm90.cu").read_text()
    assert "x.t0 = j * n_tiles / splits;" in text
    assert "x.t1 = (j + 1) * n_tiles / splits;" in text
    plan = P._fwd_split_plan("sm90", 2, 4, 17, 4322, 64, False, False, SMS)
    n, r = 34, plan.splits
    assert plan.ranges[0] == tuple((j * n // r, (j + 1) * n // r)
                                   for j in range(r))


def test_f32_tables_hold_the_plan():
    """LLaMA's units as the f32 kernel reads them: 8 a head, the unsplit
    query tile 0 writing o itself (slot −1), the 7 ranges of tiles 1-3 in
    partial slots 0-6, and a combine row for each split tile."""
    units, combine, slots = P._f32_tables(1, 32, 256, 256, True, SMS,
                                          torch.device("cpu"))
    assert slots == 7
    assert units.tolist() == [
        [0, 0, 2, -1], [1, 0, 2, 0], [1, 2, 4, 1], [2, 0, 3, 2],
        [2, 3, 6, 3], [3, 0, 2, 4], [3, 2, 5, 5], [3, 5, 8, 6]]
    assert combine.tolist() == [[1, 0, 2, 0], [2, 2, 2, 0], [3, 4, 3, 0]]
    units, combine, slots = P._f32_tables(2, 48, 1024, 1024, False, SMS,
                                          torch.device("cpu"))
    assert (combine, slots) == (None, 0)
    assert units[:, 3].eq(-1).all() and units.shape == (16, 4)


# ---------------------------------------------------------------- the plain
@pytest.mark.parametrize("static_max", [None, 0.0], ids=["online", "fixed"])
def test_split_plain_matches_pallas_k6(static_max):
    """``_flash_packed2``'s function (K6, ``pack2=True``, online) at a
    small K6-like shape, 40 queries over 1,100 keys (3 ranges of 3 key
    tiles), with the LSE: the plain split-and-combine against
    ``flash_fwd_plain`` and, online, the Pallas K6 in interpret mode; the
    fixed max (K1's mode) against ``flash_fwd_plain``."""
    q, k, v = _qkv(21, 1, 40, 2, 64, sk=1100)
    if static_max is not None:
        q = q / np.linalg.norm(q, axis=-1, keepdims=True) * 8
        k = k / np.linalg.norm(k, axis=-1, keepdims=True) * 8
    plan = P._fwd_split_plan("sm90", 1, 2, 40, 1100, 64, False, False, SMS)
    assert plan.splits == 3
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = P.flash_fwd_split_plain(qt, kt, vt, sm_scale=0.125, plan=plan,
                                       static_max=static_max, emit_lse=True)
    ref, ref_lse = P.flash_fwd_plain(qt, kt, vt, sm_scale=0.125,
                                     static_max=static_max, emit_lse=True)
    _close(out, ref)
    np.testing.assert_allclose(lse, ref_lse, rtol=0, atol=1e-5)
    if static_max is None:
        pallas = A.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), interpret=True, pack2=True)
        _close(out, pallas)


@pytest.fixture(scope="module")
def k2_d128_causal():
    """``test_k2_plain_matches_pallas``'s d128_causal case: q, k, v and the
    Pallas K2's output in interpret mode."""
    _, d, sq, sk, causal, _ = next(c for c in _K2_CASES
                                   if c[0] == "d128_causal")
    q, k, v = _qkv(5, 1, sq, 2, d, sk=sk)
    ref = A.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal, interpret=True)
    return q, k, v, np.asarray(ref)


@pytest.mark.parametrize("sms", [SMS, 1], ids=["split", "unsplit"])
def test_split_plain_matches_pallas_f32_causal_d128(k2_d128_causal, sms):
    """``flash_attention`` in f32, causal, d = 128 (the f32 design's
    function, LLaMA's): the plain split-and-combine on the f32 plan (on 132
    SMs every query tile split into ranges of one 32-key tile; on one SM
    nothing split) against the Pallas K2 in interpret mode, and its LSE
    against ``flash_fwd_plain``'s."""
    q, k, v, ref = k2_d128_causal
    sq, sk = q.shape[1], k.shape[1]
    plan = P._fwd_split_plan("f32", 1, 2, sq, sk, 128, True, False, sms)
    assert (plan.splits > 1) == (sms == SMS)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = P.flash_fwd_split_plain(qt, kt, vt, sm_scale=128 ** -0.5,
                                       plan=plan, causal=True, emit_lse=True)
    _close(out, ref)
    _, ref_lse = P.flash_fwd_plain(qt, kt, vt, sm_scale=128 ** -0.5,
                                   causal=True, emit_lse=True)
    np.testing.assert_allclose(lse, ref_lse, rtol=0, atol=1e-5)


def test_split_plain_gives_empty_ranges_no_weight():
    """Under the online softmax a range that holds no valid key of a row
    (m = −inf, l = 0) adds nothing, and the row's result is that of its
    other ranges: a causal tile whose second range lies wholly above the
    diagonal for its first rows."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(22, 1, 64, 1, 128))
    plan = P._FwdPlan(64, 32, (((0, 1), (1, 2)),), 2)
    out, lse = P.flash_fwd_split_plain(q, k, v, sm_scale=128 ** -0.5,
                                       plan=plan, causal=True, emit_lse=True)
    ref, ref_lse = P.flash_fwd_plain(q, k, v, sm_scale=128 ** -0.5,
                                     causal=True, emit_lse=True)
    _close(out, ref)
    np.testing.assert_allclose(lse, ref_lse, rtol=0, atol=1e-5)


def test_split_counters_untouched_on_cpu():
    """On CPU tensors the f32 route runs ``flash_fwd_plain``: no launch
    counted on the f32 design or as a split."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(23, 1, 256, 2, 128))
    before = (dict(P.flash_fwd.launches_f32),
              dict(P.flash_fwd.launches_split))
    out = P.flash_attention(q, k, v, causal=True)
    assert torch.equal(out, P.flash_fwd_plain(q, k, v, sm_scale=128 ** -0.5,
                                              causal=True))
    assert P._fwd_design("K2", torch.float32, 128, True, None, False,
                         None) == "f32"
    assert (P.flash_fwd.launches_f32, P.flash_fwd.launches_split) == before


# ---------------------------------------------------------------- messages
def test_adafactor_raise_names_queue_1_item_9():
    """adafactor waits in queue 1, item 9 (slice C's leftovers)."""
    from videotuna_tpu_torch.training import trainer
    with pytest.raises(NotImplementedError,
                       match=r"ROADMAP\.md queue 1, item 9\)"):
        trainer.make_optimizer(trainer.TrainConfig(optimizer="adafactor"))
