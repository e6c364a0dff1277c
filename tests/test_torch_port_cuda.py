"""The port's CUDA kernels against their plain PyTorch versions on the card.

Imports neither jax nor the JAX package, so it also runs where only the
port is installed (``--noconftest`` skips the suite's JAX set-up):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_cuda.py

Without a CUDA device every test skips: a CUDA kernel has no CPU mode."""

import pytest
import torch

import videotuna_tpu_torch.kernels.attention as P


def _qkv(b, sq, sk, h, seed):
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((b, s, h, 64), generator=gen)
               for s in (sq, sk, sk))
    # LayerNormed q and k, as in the MMDiT: bounded logits
    q = torch.nn.functional.layer_norm(q, (64,))
    k = torch.nn.functional.layer_norm(k, (64,))
    return (x.cuda().bfloat16() for x in (q, k, v))


def _check_k1(q, k, v, static_max, emit_lse, route="K1", copies=0):
    """flash_fwd on route K1 (or K6) against ``flash_fwd_plain``: launched
    on flash_fwd_sm90 and counted per route and per design, with
    ``copies`` alignment copies."""
    before = (dict(P.flash_fwd.launches), dict(P.flash_fwd.launches_sm90),
              P.flash_fwd.tma_copies)
    res = P.flash_fwd(q, k, v, sm_scale=0.125, static_max=static_max,
                      emit_lse=emit_lse, route=route)
    ref, ref_lse = P.flash_fwd_plain(q, k, v, sm_scale=0.125,
                                     static_max=static_max, emit_lse=True)
    torch.cuda.synchronize()
    out = res[0] if emit_lse else res
    assert P.flash_fwd.launches == dict(before[0],
                                        **{route: before[0][route] + 1})
    assert P.flash_fwd.launches_sm90 == dict(before[1],
                                             **{route: before[1][route] + 1})
    assert P.flash_fwd.tma_copies == before[2] + copies
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    # bf16 output rounding; p is bf16 on both sides: 2e-2 of max|o|
    assert (out.float() - ref.float()).abs().max() \
        <= 2e-2 * ref.float().abs().max()
    if emit_lse:
        assert res[1].shape == ref_lse.shape
        assert (res[1] - ref_lse).abs().max() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("emit_lse", [False, True], ids=["no_lse", "lse"])
@pytest.mark.parametrize("static_max", [None, 0.0])
@pytest.mark.parametrize("sq,sk", [(200, 200), (300, 4322), (1, 64),
                                   (4096, 4096), (130, 300), (17, 4322),
                                   (2000, 2000)])
def test_k1_kernel_matches_plain(static_max, sq, sk, emit_lse):
    """K1 on the persistent Hopper kernel (flash_fwd_sm90.cu) at d=64, in
    both softmax modes, with and without the LSE, at ragged lengths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, k, v = _qkv(2, sq, sk, 4, seed=sq + sk)
    _check_k1(q, k, v, static_max, emit_lse)


@pytest.mark.cuda
@pytest.mark.parametrize("static_max", [0.0, None], ids=["fixed", "online"])
@pytest.mark.parametrize("s,h", [(2122, 4), (9674, 2)])
def test_k1_at_cogvideox15_ragged_length(s, h, static_max):
    """K1 at CogVideoX 1.5's joint length, 224 text + 9,450 video tokens =
    9,674 = 75·128 + 74 (a last query tile of 74 rows and a 74-key tail),
    at 2 of its 48 heads, and at a shorter stand-in of the same tail
    (224 + 1,898 = 16·128 + 74)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, k, v = _qkv(2, s, s, h, seed=s)
    _check_k1(q, k, v, static_max, emit_lse=True)


@pytest.mark.cuda
def test_narrow_cogvideox15_i2v_flow_card_matches_cpu():
    """``chip_smoke.py``'s narrow CogVideoX 1.5 I2V flow (the (2, 2, 2)
    patch, 32 input channels, 320 tokens so that K1 runs on the card)
    against the same flow on the CPU: image latents, one denoiser call,
    the latents after 3 steps and the decode, TF32 off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    import chip_smoke
    chip_smoke.check_small_reference_cog15()


@pytest.mark.cuda
def test_k1_kernel_reads_strided_inputs():
    """q, k, v sliced out of one fused qkv tensor: TMA reads them in place,
    without a copy; K6 (the online route of pack2=True) likewise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    qkv = torch.randn((2, 256, 3, 4, 64), device="cuda").bfloat16()
    q, k, v = qkv.unbind(dim=2)
    assert all(P._aligned(x) and not x.is_contiguous() for x in (q, k, v))
    _check_k1(q, k, v, 0.0, True)
    _check_k1(q, k, v, None, False, route="K6")


@pytest.mark.cuda
def test_k1_kernel_copies_what_tma_cannot_read():
    """A v whose head stride (68 elements, 136 bytes) is not a multiple of
    16 bytes is copied, and the copy is counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, k, _ = _qkv(1, 200, 300, 2, seed=3)
    v = torch.randn((1, 300, 2, 68), device="cuda").bfloat16()[..., :64]
    assert not P._aligned(v)
    _check_k1(q, k, v, None, True, copies=1)


@pytest.mark.cuda
def test_k1_kernel_rejects_what_it_does_not_take():
    """Route K1 takes bf16 (its Hopper kernel) or f32 (the f32 design);
    anything else, and mismatched shapes, raise before a launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q = torch.randn((1, 128, 2, 64), device="cuda")
    before = dict(P.flash_fwd.launches)
    with pytest.raises(TypeError, match="bf16"):
        P.flash_fwd(q.half(), q.half(), q.half(), sm_scale=0.125,
                    route="K1")
    qb = q.bfloat16()
    with pytest.raises(ValueError, match="shapes"):
        P.flash_fwd(qb, qb[:, :, :1], qb[:, :, :1], sm_scale=0.125,
                    route="K1")
    assert P.flash_fwd.launches == before


# ---------------------------------------------------------------- K2 / K4
def _qkv_d(b, sq, sk, h, d, seed, normed=False):
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((b, s, h, d), generator=gen)
               for s in (sq, sk, sk))
    if normed:
        q = torch.nn.functional.layer_norm(q, (d,))
        k = torch.nn.functional.layer_norm(k, (d,))
    return [x.cuda().bfloat16() for x in (q, k, v)]


def _check_fwd(q, k, v, route, emit_lse=True, **kw):
    """flash_fwd against ``flash_fwd_plain``, counted on its route, and on
    the Hopper design exactly when ``_fwd_design`` names it."""
    design = P._fwd_design(route, q.dtype, q.shape[-1],
                           kw.get("causal", False), kw.get("kv_valid"),
                           emit_lse, kw.get("static_max"))
    before = (P.flash_fwd.launches[route], P.flash_fwd.launches_sm90[route])
    res = P.flash_fwd(q, k, v, emit_lse=emit_lse, **kw)
    out, lse = res if emit_lse else (res, None)
    ref, ref_lse = P.flash_fwd_plain(q, k, v, emit_lse=True, **kw)
    torch.cuda.synchronize()
    assert (P.flash_fwd.launches[route], P.flash_fwd.launches_sm90[route]) \
        == (before[0] + 1, before[1] + (design == "sm90"))
    # bf16 output rounding; p is bf16 on both sides: 2e-2 of max|o|
    assert (out.float() - ref.float()).abs().max() \
        <= 2e-2 * ref.float().abs().max()
    if emit_lse:
        finite = torch.isfinite(ref_lse)
        assert torch.equal(torch.isfinite(lse), finite)
        if finite.any():   # every row of a B=1 empty-row case is -inf
            assert (lse - ref_lse)[finite].abs().max() <= 1e-3
    return out, lse


# (b, sq, sk, h, d, causal, static_max)
_K2_CUDA = [
    (32, 256, 256, 16, 72, False, None),     # STDiT-XL/2 spatial
    (2, 333, 333, 2, 64, True, None),
    (2, 1, 64, 2, 72, False, None),
    (1, 300, 4322, 2, 128, False, None),
    (1, 200, 200, 2, 256, False, 0.0),
    (1, 130, 300, 2, 32, True, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h,d,causal,static_max", _K2_CUDA)
def test_k2_kernel_matches_plain(b, sq, sk, h, d, causal, static_max):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, k, v = _qkv_d(b, sq, sk, h, d, seed=sq + d,
                     normed=static_max is not None)
    _check_fwd(q, k, v, "K2", sm_scale=d ** -0.5, causal=causal,
               static_max=static_max)


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["prefix", "strided", "empty_row"])
def test_k4_kernel_matches_plain(pattern):
    """STDiT-XL/2 cross-attention: 4096 queries over 120 caption keys."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, k, v = _qkv_d(2, 4096, 120, 16, 72, seed=7)
    kv_valid = torch.ones((2, 120), dtype=torch.bool, device="cuda")
    kv_valid[0] = False
    if pattern == "prefix":
        kv_valid[0, :13] = True
    elif pattern == "strided":
        kv_valid[0, ::9] = True
    _check_fwd(q, k, v, "K4", sm_scale=72 ** -0.5, kv_valid=kv_valid)


def _kv_mask(b, sk, pattern):
    """Batch row 0 keeps a prefix of 13 keys, every 9th key, every 7th key
    from key 128 on (its first key tile all masked), all keys or none; the
    other rows keep all.  Rows sk + 5 keys apart: the kernel's call reads
    the mask in place through its batch stride."""
    kv_valid = torch.ones((b, sk + 5), dtype=torch.bool,
                          device="cuda")[:, :sk]
    if pattern != "all_valid":
        kv_valid[0] = False
    if pattern == "prefix":
        kv_valid[0, :13] = True
    elif pattern == "strided":
        kv_valid[0, ::9] = True
    elif pattern == "late":
        kv_valid[0, 128::7] = True
    return kv_valid


def _check_k4_sm90(b, sq, sk, h, d, pattern, static_max, emit_lse, seed):
    """K4 on the persistent kernel with the key mask against
    ``flash_fwd_plain``; a row with no valid key gives o = 0 and
    lse = -inf in either softmax mode."""
    q, k, v = _qkv_d(b, sq, sk, h, d, seed=seed,
                     normed=static_max is not None)
    kv_valid = _kv_mask(b, sk, pattern)
    assert P._fwd_design("K4", q.dtype, d, False, kv_valid, emit_lse,
                         static_max) == "sm90"
    out, lse = _check_fwd(q, k, v, "K4", emit_lse=emit_lse,
                          sm_scale=d ** -0.5, kv_valid=kv_valid,
                          static_max=static_max)
    if pattern == "empty_row":
        assert out[0].abs().max() == 0
        if emit_lse:
            assert torch.isneginf(lse[0]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("emit_lse", [False, True], ids=["no_lse", "lse"])
@pytest.mark.parametrize("static_max", [None, 0.0], ids=["online", "fixed"])
@pytest.mark.parametrize("sk", [13, 120, 128])
@pytest.mark.parametrize("pattern", ["prefix", "strided", "all_valid",
                                     "empty_row"])
@pytest.mark.parametrize("d", [72, 80])
def test_k4_sm90_matches_plain(d, pattern, sk, static_max, emit_lse):
    """K4 on the persistent Hopper kernel with the key mask (bf16, d = 72
    and 80), one key tile; at B=2, H=3 and 700 queries each unit holds one
    query tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    _check_k4_sm90(2, 700, sk, 3, d, pattern, static_max, emit_lse,
                   seed=sk + d)


@pytest.mark.cuda
@pytest.mark.parametrize("emit_lse", [False, True], ids=["no_lse", "lse"])
@pytest.mark.parametrize("static_max", [None, 0.0], ids=["online", "fixed"])
@pytest.mark.parametrize("sk", [129, 300, 4322])
@pytest.mark.parametrize("pattern", ["late", "strided", "empty_row"])
@pytest.mark.parametrize("d", [72, 80])
def test_k4_sm90_streams_masked_key_tiles(d, pattern, sk, static_max,
                                          emit_lse):
    """K4 on the persistent kernel over more than one key tile: the mask
    words reloaded for each tile, the zero bits past Sk in place of the
    last tile's test, and (``late``) a row whose first key tile is all
    masked, so that the online softmax starts from m = -inf and takes
    its first valid keys in a later tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    _check_k4_sm90(2, 300, sk, 3, d, pattern, static_max, emit_lse,
                   seed=sk + d)


@pytest.mark.cuda
@pytest.mark.parametrize("emit_lse", [False, True], ids=["no_lse", "lse"])
@pytest.mark.parametrize("static_max", [None, 0.0], ids=["online", "fixed"])
@pytest.mark.parametrize("pattern", ["prefix", "empty_row"])
@pytest.mark.parametrize("b", [1, 2])
def test_k4_sm90_units_of_several_query_tiles(b, pattern, static_max,
                                              emit_lse):
    """STDiT-XL/2's cross-attention (4096 queries over 120 keys, H=16,
    d=72) at its training batch (B=1: units of 4 query tiles on 132 SMs)
    and its sampling batch (B=2: units of 8): the query tiles of a unit
    after the first reuse its K and V."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    _check_k4_sm90(b, 4096, 120, 16, 72, pattern, static_max, emit_lse,
                   seed=b)


# StepVideo's cross-attention and Mochi's joint attention at d = 128, cut
# to a test size: (queries, keys always valid, caption keys) — StepVideo's
# 77 CLIP keys before its 320 caption keys (397: a last key tile of 13),
# Mochi's video keys (2,260 of its 22,260) before its 256 caption keys
# (2,516: a last tile of 84)
_D128_MASKED = {"stepvideo_cross": (1000, 77, 320),
                "mochi_joint": (2516, 2260, 256)}
# the caption keys each batch row keeps: all, a prefix in both rows, rows
# padded apart; "strided" keeps every 9th key of row 0 (no prefix), and
# "empty_row" none of it
_D128_PATTERNS = {"all_valid": (None, None), "caption_prefix": (30, 30),
                  "ragged_rows": (120, 9), "strided": None,
                  "empty_row": None}


def _lead_mask(b, lead, caption, pattern):
    """(B, lead + caption) bool, rows 5 keys longer apart (read in place
    through the batch stride)."""
    m = torch.zeros((b, lead + caption + 5), dtype=torch.bool,
                    device="cuda")[:, :lead + caption]
    m[:, :lead] = True
    rows = _D128_PATTERNS[pattern]
    for i in range(b):
        m[i, lead:lead + (caption if rows is None or rows[i] is None
                          else rows[i])] = True
    if pattern == "strided":
        m[0] = False
        m[0, ::9] = True
    elif pattern == "empty_row":
        m[0] = False
    return m


@pytest.mark.cuda
@pytest.mark.parametrize("static_max", [None, 0.0], ids=["online", "fixed"])
@pytest.mark.parametrize("pattern", sorted(_D128_PATTERNS))
@pytest.mark.parametrize("case", sorted(_D128_MASKED))
def test_k4_d128_matches_plain(case, pattern, static_max):
    """K4 at d = 128 (bf16, without the LSE) on K3's Hopper kernel with the
    key mask, under the online max (StepVideo's cross-attention) and the
    fixed max 0 (Mochi's joint attention), against ``flash_fwd_plain``;
    key lengths that are not a multiple of the key tile; a row with no
    valid key gives o = 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    sq, lead, caption = _D128_MASKED[case]
    q, k, v = _rms_qkv(2, sq, lead + caption, 3, seed=sq + len(pattern))
    kv_valid = _lead_mask(2, lead, caption, pattern)
    assert P._fwd_design("K4", q.dtype, 128, False, kv_valid, False,
                         static_max) == "sm90"
    before = P.flash_fwd.launches_d128["K4"]
    out, _ = _check_fwd(q, k, v, "K4", emit_lse=False,
                        sm_scale=128 ** -0.5, kv_valid=kv_valid,
                        static_max=static_max)
    assert P.flash_fwd.launches_d128["K4"] == before + 1
    if pattern == "empty_row":
        assert out[0].abs().max() == 0 and out[1].abs().max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h", [(2, 1265, 1265, 3), (1, 300, 4322, 2),
                                       (2, 128, 397, 4), (2, 1, 130, 2),
                                       (1, 4112, 300, 2)])
def test_k2_d128_online_matches_plain(b, sq, sk, h):
    """K2 at d = 128 (bf16, without the LSE) on K3's Hopper kernel with the
    online max, StepVideo's self-attention cut to a test size (1,265
    tokens, a tenth of its 12,648), against ``flash_fwd_plain``; scores of
    unnormed q and k, so the running max moves from key tile to key
    tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, k, v = _qkv_d(b, sq, sk, h, 128, seed=sq + sk)
    q = q * 3   # scores up to ~±30: the running max moves between tiles
    assert P._fwd_design("K2", q.dtype, 128, False, None, False,
                         None) == "sm90"
    before = P.flash_fwd.launches_d128["K2"]
    _check_fwd(q, k, v, "K2", emit_lse=False, sm_scale=128 ** -0.5)
    assert P.flash_fwd.launches_d128["K2"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("d", [72, 128])
def test_k3_route_matches_plain(d):
    """The fixed-max route at d ≤ 128 (HunyuanVideo's joint attention):
    ``flash_attention`` launches ``flash_fwd`` counted as K3; 200 queries
    over 300 keys leave a ragged key tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, k, v = _qkv_d(2, 200, 300, 2, d, seed=d, normed=True)
    before = dict(P.flash_fwd.launches)
    out = P.flash_attention(q, k, v, static_max=0.0)
    ref = P.flash_fwd_plain(q, k, v, sm_scale=d ** -0.5, static_max=0.0)
    torch.cuda.synchronize()
    assert P.flash_fwd.launches == dict(before, K3=before["K3"] + 1)
    assert (out.float() - ref.float()).abs().max() \
        <= 2e-2 * ref.float().abs().max()


@pytest.mark.cuda
def test_k3_reads_the_single_stream_v_in_place():
    """The single-stream block hands v to the kernel as a strided view of
    its fused linear1 output (row stride 3·dim + 4·dim, start at 2·dim):
    the sm90 forward's TMA reads it in place, without a copy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dim, heads = 256, 2
    h = torch.randn((1, 300, 7 * dim), device="cuda").bfloat16()
    q, k, v = (torch.nn.functional.layer_norm(
        h[..., i * dim:(i + 1) * dim].unflatten(-1, (heads, -1)).float(),
        (dim // heads,)).bfloat16() if i < 2 else
        h[..., i * dim:(i + 1) * dim].unflatten(-1, (heads, -1))
        for i in range(3))
    assert P._aligned(v) and not v.is_contiguous()
    copies = P.flash_fwd.tma_copies
    before = P.flash_fwd.launches_sm90["K3"]
    out = P.flash_attention(q, k, v, static_max=0.0)
    ref = P.flash_fwd_plain(q, k, v.contiguous(), sm_scale=128 ** -0.5,
                            static_max=0.0)
    torch.cuda.synchronize()
    assert P.flash_fwd.tma_copies == copies
    assert P.flash_fwd.launches_sm90["K3"] == before + 1
    assert (out.float() - ref.float()).abs().max() \
        <= 2e-2 * ref.float().abs().max()


def _wan_qkv(b, sq, sk, h, seed):
    """Wan's q and k: RMSNormed over the full width h·128 before the head
    split (bounded logits), v plain; bf16 on the card."""
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((b, s, h * 128), generator=gen)
               for s in (sq, sk, sk))
    q, k = (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-6)
            for x in (q, k))
    return [x.unflatten(-1, (h, 128)).cuda().bfloat16() for x in (q, k, v)]


# Wan 2.1's K3 shapes at a reduced length that keeps each one's key tail
# (75,600 and 32,760 tokens end 80 and 120 keys into a tile) and the cross
# attention's 512 text keys: self-attention 14B (H=40) and 1.3B (H=12),
# cross-attention 14B
_WAN_K3 = {"self_14b": (2, 4176, 4176, 40), "self_1_3b": (2, 4216, 4216, 12),
           "cross_14b": (2, 4176, 512, 40)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_WAN_K3))
def test_k3_at_wan_shapes_matches_plain(case):
    """``flash_attention`` under the fixed max at Wan's shapes (B=2 with
    CFG): K3 on K3's Hopper kernel in place, against the plain version a
    few heads at a time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    b, sq, sk, h = _WAN_K3[case]
    q, k, v = _wan_qkv(b, sq, sk, h, seed=sq + sk + h)
    before = (P.flash_fwd.launches["K3"], P.flash_fwd.launches_sm90["K3"],
              P.flash_fwd.launches_d128["K3"], P.flash_fwd.tma_copies)
    out = P.flash_attention(q, k, v, static_max=0.0)
    ref = _plain_by_heads(P.flash_fwd_plain, q, k, v, sm_scale=128 ** -0.5,
                          static_max=0.0)
    torch.cuda.synchronize()
    assert (P.flash_fwd.launches["K3"], P.flash_fwd.launches_sm90["K3"],
            P.flash_fwd.launches_d128["K3"], P.flash_fwd.tma_copies) \
        == (before[0] + 1, before[1] + 1, before[2] + 1, before[3])
    assert out.shape == (b, sq, h, 128) and torch.isfinite(out.float()).all()
    # bf16 output rounding; p is bf16 on both sides: 2e-2 of max|o|
    assert (out.float() - ref.float()).abs().max() \
        <= 2e-2 * ref.float().abs().max()


# (sq, sk): a full key tile, one key past it, ragged, a long tail; queries
# other than keys
_SM90_FWD_LENGTHS = [(128, 128), (129, 129), (300, 300), (4112, 4112),
                     (4096, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b,h", [(1, 24), (2, 3)])
@pytest.mark.parametrize("sq,sk", _SM90_FWD_LENGTHS)
def test_sm90_forward_matches_plain(d, b, h, sq, sk):
    """The Hopper forward (flash_fwd_sm90.cu) under the fixed max against
    ``flash_fwd_plain``, counted per route and per design: the persistent
    kernel at d=64, K3's kernel at d=128.  Called on the K3 route directly:
    ``flash_attention`` sends d=64 with even heads to K1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, k, v = _qkv_d(b, sq, sk, h, d, seed=sq + sk + d, normed=True)
    before = (dict(P.flash_fwd.launches), dict(P.flash_fwd.launches_sm90))
    out = P.flash_fwd(q, k, v, sm_scale=d ** -0.5, static_max=0.0,
                      route="K3")
    ref = P.flash_fwd_plain(q, k, v, sm_scale=d ** -0.5, static_max=0.0)
    torch.cuda.synchronize()
    assert P.flash_fwd.launches == dict(before[0], K3=before[0]["K3"] + 1)
    assert P.flash_fwd.launches_sm90 == dict(before[1],
                                             K3=before[1]["K3"] + 1)
    # bf16 output rounding; p is bf16 on both sides: 2e-2 of max|o|
    assert (out.float() - ref.float()).abs().max() \
        <= 2e-2 * ref.float().abs().max()


@pytest.mark.cuda
def test_sm90_forward_copies_what_tma_cannot_read():
    """A v whose row stride is not a multiple of 16 bytes is copied, and the
    copy is counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, k, _ = _qkv_d(1, 200, 200, 2, 128, seed=5, normed=True)
    v = torch.randn((1, 200, 2, 132), device="cuda").bfloat16()[..., :128]
    assert not P._aligned(v)
    copies = P.flash_fwd.tma_copies
    out = P.flash_attention(q, k, v, static_max=0.0)
    ref = P.flash_fwd_plain(q, k, v, sm_scale=128 ** -0.5, static_max=0.0)
    torch.cuda.synchronize()
    assert P.flash_fwd.tma_copies == copies + 1
    assert (out.float() - ref.float()).abs().max() \
        <= 2e-2 * ref.float().abs().max()


# (sq, sk): STDiT's 256 tokens (K and V stay for both query tiles), a
# ragged tile, one query, a third key tile, a long key row streamed
_SM90_ROW_LENGTHS = [(256, 256), (200, 200), (1, 64), (130, 300),
                     (300, 4322)]


def _check_sm90_rows(q, k, v, static_max, emit_lse, copies=0):
    """flash_fwd on the K5 route (with the LSE) or the K2 route against
    ``flash_fwd_plain``, launched on flash_fwd_sm90 and counted per route
    and per design, with ``copies`` alignment copies."""
    route = "K5" if emit_lse else "K2"
    d = q.shape[-1]
    before = (dict(P.flash_fwd.launches), dict(P.flash_fwd.launches_sm90),
              P.flash_fwd.tma_copies)
    res = P.flash_fwd(q, k, v, sm_scale=d ** -0.5, static_max=static_max,
                      emit_lse=emit_lse, route=route)
    ref, ref_lse = P.flash_fwd_plain(q, k, v, sm_scale=d ** -0.5,
                                     static_max=static_max, emit_lse=True)
    torch.cuda.synchronize()
    out = res[0] if emit_lse else res
    assert P.flash_fwd.launches == dict(before[0],
                                        **{route: before[0][route] + 1})
    assert P.flash_fwd.launches_sm90 == dict(before[1],
                                             **{route: before[1][route] + 1})
    assert P.flash_fwd.tma_copies == before[2] + copies
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    # bf16 output rounding; p is bf16 on both sides: 2e-2 of max|o|
    assert (out.float() - ref.float()).abs().max() \
        <= 2e-2 * ref.float().abs().max()
    if emit_lse:
        assert res[1].shape == ref_lse.shape
        assert (res[1] - ref_lse).abs().max() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("emit_lse", [False, True], ids=["k2", "k5_lse"])
@pytest.mark.parametrize("static_max", [None, 0.0], ids=["online", "fixed"])
@pytest.mark.parametrize("d", [72, 80])
@pytest.mark.parametrize("sq,sk", _SM90_ROW_LENGTHS)
def test_sm90_rows_forward_matches_plain(sq, sk, d, static_max, emit_lse):
    """The persistent Hopper forward at d = 72 and 80 (flash_fwd_sm90.cu),
    online or under the fixed max (LayerNormed q, k), with and without the
    LSE, against ``flash_fwd_plain``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, k, v = _qkv_d(2, sq, sk, 3, d, seed=sq + sk + d,
                     normed=static_max is not None)
    _check_sm90_rows(q, k, v, static_max, emit_lse)


@pytest.mark.cuda
@pytest.mark.parametrize("emit_lse", [False, True], ids=["k2", "k5_lse"])
@pytest.mark.parametrize("b,h,sq", [(32, 16, 256), (16, 16, 256),
                                    (4, 128, 300)])
def test_sm90_rows_forward_at_many_heads(b, h, sq, emit_lse):
    """B·H up to 512 heads: STDiT-XL/2's sampling (K2, B=32) and training
    (K5, B=16) shapes, and 512 heads of 3 query tiles over 2 key tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, k, v = _qkv_d(b, sq, 256, h, 72, seed=b + h)
    _check_sm90_rows(q, k, v, None, emit_lse)


@pytest.mark.cuda
def test_sm90_rows_forward_reads_a_fused_qkv_in_place():
    """q, k, v sliced out of one fused (B, S, 3, H, 72) tensor: TMA reads
    the strided views in place, without a copy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    qkv = torch.randn((2, 256, 3, 4, 72), device="cuda").bfloat16()
    q, k, v = qkv.unbind(dim=2)
    assert all(P._aligned(x) and not x.is_contiguous() for x in (q, k, v))
    _check_sm90_rows(q, k, v, None, True)


@pytest.mark.cuda
def test_sm90_rows_forward_copies_what_tma_cannot_read():
    """A v whose head stride (76 elements, 152 bytes) is not a multiple of
    16 bytes is copied, and the copy is counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, k, _ = _qkv_d(1, 200, 200, 2, 72, seed=9)
    v = torch.randn((1, 200, 2, 76), device="cuda").bfloat16()[..., :72]
    assert not P._aligned(v)
    _check_sm90_rows(q, k, v, None, False, copies=1)


@pytest.mark.cuda
def test_vae2d_attention_takes_k2_in_bf16():
    """The 2D VAE's attention at d=64 over 16×16 tokens in bf16: K2 on the
    card against the same block on the CPU (K2's plain version)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from videotuna_tpu_torch.models.vae2d import AttnBlock2D
    torch.manual_seed(0)
    cpu = AttnBlock2D(64, dtype=torch.bfloat16)
    gpu = AttnBlock2D(64, dtype=torch.bfloat16).cuda()
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randn((2, 64, 16, 16))
    before = P.flash_fwd.launches["K2"]
    with torch.no_grad():
        out = gpu(x.cuda()).float().cpu()
        ref = cpu(x).float()
    assert P.flash_fwd.launches["K2"] == before + 1
    # bf16 attention output and projection: 2e-2 of max|ref|
    assert (out - ref).abs().max() <= 2e-2 * ref.abs().max()


# ---------------------------------------------------------------- f32 K2
@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h,d,causal", [
    (1, 1024, 1024, 1, 128, False),   # the 2D VAE's mid attention at ch 32
    (2, 200, 333, 2, 72, False),
    (1, 130, 130, 2, 256, True),
])
def test_k2_kernel_takes_f32(b, sq, sk, h, d, causal):
    """f32 q, k, v: split into bf16 hi + lo, three products each: the f32
    plain version to 1e-4 of max|o| (about 16 mantissa bits per product)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    gen = torch.Generator().manual_seed(sq + d)
    q, k, v = (torch.randn((b, s, h, d), generator=gen).cuda()
               for s in (sq, sk, sk))
    before = P.flash_fwd.launches["K2"]
    out, lse = P.flash_fwd(q, k, v, sm_scale=d ** -0.5, causal=causal,
                           emit_lse=True)
    ref, ref_lse = P.flash_fwd_plain(q, k, v, sm_scale=d ** -0.5,
                                     causal=causal, emit_lse=True)
    torch.cuda.synchronize()
    assert P.flash_fwd.launches["K2"] == before + 1
    assert out.dtype == torch.float32
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()
    assert (lse - ref_lse).abs().max() <= 1e-4


# ---------------------------------------------------------------- backward
def _bwd_inputs(b, sq, sk, h, d, seed, causal=False, kv_valid=None):
    """bf16 q, k, v, dO and the forward's output and LSE from the card."""
    gen = torch.Generator().manual_seed(seed)
    q, k, v, g = (torch.randn(shape, generator=gen).cuda().bfloat16()
                  for shape in ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d),
                                (b, sq, h, d)))
    out, lse = P.flash_fwd(q, k, v, sm_scale=d ** -0.5, causal=causal,
                           kv_valid=kv_valid, emit_lse=True)
    return q, k, v, out, g, lse


# (b, sq, sk, h, d, causal, masked, single_pass, route)
_BWD_CUDA = [
    (1, 256, 256, 2, 64, False, False, True, "K7"),
    (1, 300, 4322, 2, 64, False, False, True, "K7"),
    (2, 256, 256, 2, 72, False, False, True, "K8"),
    (2, 333, 333, 2, 64, True, False, True, "K8"),
    (1, 300, 4322, 2, 128, False, False, True, "K8"),
    (1, 130, 300, 2, 32, True, False, True, "K8"),
    (2, 512, 120, 2, 72, False, True, True, "K8"),
    (1, 256, 256, 2, 64, False, False, False, "K10"),
    (2, 256, 256, 2, 72, False, False, False, "K9"),
    (2, 300, 300, 3, 256, True, False, True, "K8"),
    (2, 300, 300, 3, 256, False, True, True, "K8"),
    (2, 300, 300, 3, 160, True, False, True, "K8"),
    (2, 300, 300, 3, 160, False, True, True, "K8"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h,d,causal,masked,single_pass,route",
                         _BWD_CUDA)
def test_flash_bwd_kernel_matches_plain(b, sq, sk, h, d, causal, masked,
                                        single_pass, route):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    kv_valid = None
    if masked:   # row 0 keeps 13 keys, row 1 none: dq = 0 there
        kv_valid = torch.zeros((b, sk), dtype=torch.bool, device="cuda")
        kv_valid[0, :13] = True
    q, k, v, out, g, lse = _bwd_inputs(b, sq, sk, h, d, seed=sq + d,
                                       causal=causal, kv_valid=kv_valid)
    before = dict(P.flash_bwd.launches)
    got = P.flash_bwd(q, k, v, out, g, lse, sm_scale=d ** -0.5,
                      causal=causal, kv_valid=kv_valid,
                      single_pass=single_pass)
    ref = P.flash_bwd_plain(q, k, v, out, g, lse, sm_scale=d ** -0.5,
                            causal=causal, kv_valid=kv_valid)
    torch.cuda.synchronize()
    assert P.flash_bwd.launches == dict(before, **{route: before[route] + 1})
    for x, r in zip(got, ref):
        assert x.shape == r.shape and x.dtype == torch.bfloat16
        assert torch.isfinite(x.float()).all()
        # p and ds are bf16 operands of the products, gradients bf16:
        # 2e-2 of max|grad|
        assert (x.float() - r.float()).abs().max() \
            <= 2e-2 * r.float().abs().max()
    if masked:
        dq, dk, dv = got
        assert dq[1].abs().max() == 0          # no valid key
        assert dk[0, 13:].abs().max() == 0 and dv[0, 13:].abs().max() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("d,masked", [(64, False), (72, False), (72, True)])
def test_grads_reach_q_k_v_on_cuda(d, masked):
    """A loss through ``dot_product_attention`` on CUDA tensors gives q, k
    and v their gradients, computed by flash_bwd from the LSE of a forward
    on flash_fwd_sm90: the autograd of the plain math on the same bf16
    values, in f32, to 2e-2 of max|grad|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    gen = torch.Generator().manual_seed(d)
    b, s, sk, h = 2, 256, (120 if masked else 256), 2
    base = [torch.randn(shape, generator=gen).bfloat16()
            for shape in ((b, s, h, d), (b, sk, h, d), (b, sk, h, d))]
    g = torch.randn((b, s, h, d), generator=gen)
    kv_valid = None
    if masked:
        kv_valid = torch.ones((b, sk), dtype=torch.bool)
        kv_valid[0, 30:] = False
    q, k, v = (x.cuda().requires_grad_() for x in base)
    before = sum(P.flash_bwd.launches.values())
    sm90 = dict(P.flash_fwd.launches_sm90)
    out = P.dot_product_attention(
        q, k, v, kv_valid=None if kv_valid is None else kv_valid.cuda())
    out.backward(g.cuda().bfloat16())
    torch.cuda.synchronize()
    assert sum(P.flash_bwd.launches.values()) == before + 1
    # every forward with its LSE on flash_fwd_sm90: K1 at d=64 (its LSE
    # read by K7), K5 at d=72 and the masked K4 (read by K8)
    route = "K4" if masked else "K1" if d == 64 else "K5"
    assert P.flash_fwd.launches_sm90 == dict(sm90, **{route: sm90[route] + 1})
    qr, kr, vr = (x.float().cuda().requires_grad_() for x in base)
    bias = None if kv_valid is None else \
        torch.where(kv_valid.cuda(), 0.0, -1e30)[:, None, None, :]
    P.reference_attention(qr, kr, vr, bias=bias).backward(
        g.cuda().bfloat16().float())
    for x, r in ((q, qr), (k, kr), (v, vr)):
        assert x.grad is not None
        assert (x.grad.float() - r.grad).abs().max() \
            <= 2e-2 * r.grad.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("static_max", [0.0, None], ids=["fixed", "online"])
@pytest.mark.parametrize("s,h", [(128, 2), (200, 2), (4112, 30), (200, 30)])
def test_sm90_backward_matches_plain(static_max, s, h):
    """The single-pass Hopper backward (flash_bwd_sm90.cu, route K7; at
    128 keys, one key tile, the short-row kernel ``_bwd_kernel`` names) on
    the LSE of K1 under both softmax modes, against ``flash_bwd_plain``,
    counted per route and per design."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, k, v = _qkv(1, s, s, h, seed=s + h)
    g = torch.randn((1, s, h, 64), generator=torch.Generator().manual_seed(s)
                    ).cuda().bfloat16()
    out, lse = P.flash_fwd(q, k, v, sm_scale=0.125, static_max=static_max,
                           emit_lse=True, route="K1")
    before = (dict(P.flash_bwd.launches), dict(P.flash_bwd.launches_sm90))
    got = P.flash_bwd(q, k, v, out, g, lse, sm_scale=0.125)
    ref = P.flash_bwd_plain(q, k, v, out, g, lse, sm_scale=0.125)
    torch.cuda.synchronize()
    assert P.flash_bwd.launches == dict(before[0], K7=before[0]["K7"] + 1)
    assert P.flash_bwd.launches_sm90 == dict(before[1],
                                             K7=before[1]["K7"] + 1)
    for x, r in zip(got, ref):
        assert x.shape == r.shape and x.dtype == torch.bfloat16
        assert torch.isfinite(x.float()).all()
        # p and ds are bf16 operands, gradients bf16: 2e-2 of max|grad|
        assert (x.float() - r.float()).abs().max() \
            <= 2e-2 * r.float().abs().max()


# ------------------------------------------------- short-row backward (K8)
def _rows_mask(b, sk, pattern):
    """None, or a (B, Sk) key mask whose batch row 0 keeps a prefix of 13
    keys, every 9th key, every 7th key from key 128 on (its first key tile
    all masked) or no key; the other rows keep all."""
    if pattern == "none":
        return None
    kv_valid = torch.ones((b, sk), dtype=torch.bool, device="cuda")
    kv_valid[0] = False
    if pattern == "prefix":
        kv_valid[0, :13] = True
    elif pattern == "strided":
        kv_valid[0, ::9] = True
    elif pattern == "late":
        kv_valid[0, 128::7] = True
    return kv_valid


def _check_rows(q, k, v, g, kv_valid, route="K8", copies=0):
    """flash_bwd on the short-row Hopper kernel (flash_bwd_rows_sm90.cu)
    against ``flash_bwd_plain`` on the forward's own output and LSE,
    counted per route and per design, with ``copies`` alignment copies;
    returns the gradients."""
    d = q.shape[-1]
    assert P._bwd_design(route, q.dtype, d, False,
                         kv_valid is not None) == "sm90"
    out, lse = P.flash_fwd(q, k, v, sm_scale=d ** -0.5, kv_valid=kv_valid,
                           emit_lse=True)
    before = (dict(P.flash_bwd.launches), dict(P.flash_bwd.launches_sm90),
              P.flash_bwd.tma_copies)
    got = P.flash_bwd(q, k, v, out, g, lse, sm_scale=d ** -0.5,
                      kv_valid=kv_valid, single_pass=route == "K8")
    ref = P.flash_bwd_plain(q, k, v, out, g, lse, sm_scale=d ** -0.5,
                            kv_valid=kv_valid)
    torch.cuda.synchronize()
    assert P.flash_bwd.launches == dict(before[0],
                                        **{route: before[0][route] + 1})
    assert P.flash_bwd.launches_sm90 == dict(before[1],
                                             **{route: before[1][route] + 1})
    assert P.flash_bwd.tma_copies == before[2] + copies
    for x, r in zip(got, ref):
        assert x.shape == r.shape and x.dtype == torch.bfloat16
        assert torch.isfinite(x.float()).all()
        # p and ds are bf16 operands, gradients bf16: 2e-2 of max|grad|
        assert (x.float() - r.float()).abs().max() \
            <= 2e-2 * r.float().abs().max()
    if kv_valid is not None:
        dq, dk, dv = got
        masked = ~kv_valid
        if masked.any():
            assert dk[masked].abs().max() == 0 == dv[masked].abs().max()
        if not kv_valid[0].any():   # no valid key: dq = 0
            assert dq[0].abs().max() == 0
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("sq", [1, 64, 255, 256, 4096])
@pytest.mark.parametrize("sk", [13, 120, 128, 129, 256, 300])
@pytest.mark.parametrize("pattern", ["none", "prefix", "strided",
                                     "empty_row"])
@pytest.mark.parametrize("d", [72, 80])
def test_rows_backward_matches_plain(d, pattern, sk, sq):
    """K8 on the short-row Hopper backward, bf16, d = 72 and 80, B=2, H=3:
    one key tile (a head's queries split into units, whose dK and dV go
    through f32 partials and ``dkv_reduce_kernel``), up to 4 query tiles
    over several key tiles (dQ summed in shared memory) and the atomic mode
    past that; masked keys get dk = dv = 0, a row with no valid key
    dq = 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, k, v = _qkv_d(2, sq, sk, 3, d, seed=sq + sk + d)
    g = _qkv_d(2, sq, 1, 3, d, seed=sq)[0]
    _check_rows(q, k, v, g, _rows_mask(2, sk, pattern))


@pytest.mark.cuda
@pytest.mark.parametrize("sk", [129, 256, 300])
@pytest.mark.parametrize("sq", [1, 256, 4096])
@pytest.mark.parametrize("d", [72, 80])
def test_rows_backward_first_key_tile_all_masked(d, sq, sk):
    """Batch row 0 keeps only every 7th key from key 128 on: its first key
    tile is all masked."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, k, v = _qkv_d(2, sq, sk, 3, d, seed=sq + sk)
    g = _qkv_d(2, sq, 1, 3, d, seed=sq)[0]
    _check_rows(q, k, v, g, _rows_mask(2, sk, "late"))


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True], ids=["spatial", "cross"])
@pytest.mark.parametrize("route", ["K8", "K9"])
def test_rows_backward_at_stdit_shapes(masked, route):
    """STDiT-XL/2's training backward at B=1 × 16 frames: the spatial shape
    (B=16, S=256, H=16, d=72) and the cross shape (B=1, 4096 queries over
    the 120 caption keys, 13 valid), on K8 and on its baseline K9."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    b, sq, sk = (1, 4096, 120) if masked else (16, 256, 256)
    q, k, v = _qkv_d(b, sq, sk, 16, 72, seed=b)
    g = _qkv_d(b, sq, 1, 16, 72, seed=b + 1)[0]
    kv_valid = None
    if masked:
        kv_valid = torch.zeros((1, sk), dtype=torch.bool, device="cuda")
        kv_valid[0, :13] = True
    _check_rows(q, k, v, g, kv_valid, route=route)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,masked", [(256, 256, False),
                                          (4096, 120, True),
                                          (4096, 120, False),
                                          (300, 4322, False)],
                         ids=["spatial", "cross", "one_tile", "atomic"])
def test_rows_backward_is_reproducible(sq, sk, masked):
    """dk and dv bit-equal across two calls, and dq too except in the
    atomic mode (its f32 adds run in another order each call); at the
    cross shapes the split units' dK and dV partials are summed in unit
    order by ``dkv_reduce_kernel``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, k, v = _qkv_d(1, sq, sk, 16, 72, seed=sq)
    g = _qkv_d(1, sq, 1, 16, 72, seed=sq + 1)[0]
    kv_valid = None
    if masked:
        kv_valid = torch.zeros((1, sk), dtype=torch.bool, device="cuda")
        kv_valid[0, ::9] = True
    out, lse = P.flash_fwd(q, k, v, sm_scale=72 ** -0.5, kv_valid=kv_valid,
                           emit_lse=True)

    def run():
        return P.flash_bwd(q, k, v, out, g, lse, sm_scale=72 ** -0.5,
                           kv_valid=kv_valid)

    first, second = run(), run()
    torch.cuda.synchronize()
    atomic = P._bwd_rows_plan(16, sq, sk, 132)[0]
    for i in (range(1, 3) if atomic else range(3)):
        assert torch.equal(first[i], second[i])


@pytest.mark.cuda
def test_rows_backward_reads_a_fused_qkv_in_place():
    """q, k, v sliced out of one fused (B, S, 3, H, 72) tensor and a dO
    sliced out of a wider one: TMA reads the strided views in place."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    qkv = torch.randn((2, 256, 3, 4, 72), device="cuda").bfloat16()
    q, k, v = qkv.unbind(dim=2)
    g = torch.randn((2, 256, 2, 4, 72), device="cuda").bfloat16()[:, :, 0]
    assert all(P._aligned(x) and not x.is_contiguous() for x in (q, k, v, g))
    _check_rows(q, k, v, g, None)


@pytest.mark.cuda
def test_rows_backward_copies_what_tma_cannot_read():
    """A v whose head stride (76 elements, 152 bytes) is not a multiple of
    16 bytes is copied, and the copy is counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, k, _ = _qkv_d(1, 200, 200, 2, 72, seed=9)
    v = torch.randn((1, 200, 2, 76), device="cuda").bfloat16()[..., :72]
    g = torch.randn((1, 200, 2, 72), device="cuda").bfloat16()
    assert not P._aligned(v)
    _check_rows(q, k, v, g, None, copies=1)


@pytest.mark.cuda
def test_rows_backward_reads_the_forwards_mask_words():
    """The words a masked training forward packs give the backward the same
    gradients as the mask it packs itself."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, k, v = _qkv_d(2, 512, 120, 4, 72, seed=3)
    g = torch.randn((2, 512, 4, 72), device="cuda").bfloat16()
    kv_valid = _rows_mask(2, 120, "strided")
    words = P._pack_mask_words(kv_valid, 2, 120)
    assert torch.equal(words, P._mask_words(kv_valid))
    out, lse = P.flash_fwd(q, k, v, sm_scale=72 ** -0.5, kv_valid=kv_valid,
                           emit_lse=True, mask_words=words)
    got = P.flash_bwd(q, k, v, out, g, lse, sm_scale=72 ** -0.5,
                      kv_valid=kv_valid, mask_words=words)
    ref = P.flash_bwd(q, k, v, out, g, lse, sm_scale=72 ** -0.5,
                      kv_valid=kv_valid)
    torch.cuda.synchronize()
    for x, r in zip(got, ref):
        assert torch.equal(x, r)


@pytest.mark.cuda
def test_k10_runs_k7s_kernel():
    """K10 (single_pass=False at d=64) launches flash_bwd_sm90, K7's Hopper
    kernel, and agrees with the plain backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, k, v = _qkv(1, 300, 300, 2, seed=5)
    g = torch.randn((1, 300, 2, 64)).cuda().bfloat16()
    out, lse = P.flash_fwd(q, k, v, sm_scale=0.125, emit_lse=True,
                           route="K1")
    before = (dict(P.flash_bwd.launches), dict(P.flash_bwd.launches_sm90))
    got = P.flash_bwd(q, k, v, out, g, lse, sm_scale=0.125,
                      single_pass=False)
    ref = P.flash_bwd_plain(q, k, v, out, g, lse, sm_scale=0.125)
    torch.cuda.synchronize()
    assert P.flash_bwd.launches == dict(before[0], K10=before[0]["K10"] + 1)
    assert P.flash_bwd.launches_sm90 == dict(before[1],
                                             K10=before[1]["K10"] + 1)
    for x, r in zip(got, ref):
        assert (x.float() - r.float()).abs().max() \
            <= 2e-2 * r.float().abs().max()


# ------------------------------------- d = 128: HunyuanVideo training (K5, K8)
# (sq, sk): a full tile, one row or key past it, ragged, the narrow card-vs-CPU
# step's 352 tokens, a long tail, the LoRA run's 7,456; then queries other
# than keys
_D128_LENGTHS = [(128, 128), (129, 129), (300, 300), (352, 352),
                 (4112, 4112), (7456, 7456), (129, 7456), (4112, 300)]


def _rms_qkv(b, sq, sk, h, seed, fused=False):
    """RMSNormed q, k (HunyuanVideo's qk-norm: bounded logits) and v, d=128,
    bf16; with ``fused`` q, k and v are views of one (B, S, 3, H, 128)
    projection, as HunyuanVideo's blocks hand them."""
    gen = torch.Generator().manual_seed(seed)
    if fused:
        qkv = torch.randn((b, sq, 3, h, 128), generator=gen)
        q, k, v = qkv.unbind(dim=2)
    else:
        q, k, v = (torch.randn((b, s, h, 128), generator=gen)
                   for s in (sq, sk, sk))
    q, k = (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-6)
            for x in (q, k))
    if fused:
        qkv = torch.stack([q, k, v], dim=2).cuda().bfloat16()
        return qkv.unbind(dim=2)
    return [x.cuda().bfloat16() for x in (q, k, v)]


def _plain_by_heads(fn, *args, heads=4, **kw):
    """A plain version over a few heads at a time (the f32 scores of 24
    heads at 7,456 tokens are 5.3 GB each), concatenated per output."""
    h = args[0].shape[2]
    parts = []
    for i in range(0, h, heads):
        sl = [x[:, :, i:i + heads] if x.ndim == 4 else x[:, i:i + heads]
              for x in args]
        parts.append(fn(*sl, **kw))
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts, dim=2)
    return tuple(torch.cat([p[j] for p in parts],
                           dim=2 if parts[0][j].ndim == 4 else 1)
                 for j in range(len(parts[0])))


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["K5", "K3"])
@pytest.mark.parametrize("h", [2, 24])
@pytest.mark.parametrize("sq,sk", _D128_LENGTHS)
def test_d128_forward_with_lse_matches_plain(sq, sk, h, route):
    """K5 (and K3 asked for the LSE) at d=128 under the fixed max 0 on K3's
    Hopper kernel with its LSE, against ``flash_fwd_plain``: counted per
    route, per design and at d=128; empty rows cannot occur without a mask,
    so every LSE is finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, k, v = _rms_qkv(1, sq, sk, h, seed=sq + sk + h)
    before = (P.flash_fwd.launches[route], P.flash_fwd.launches_sm90[route],
              P.flash_fwd.launches_d128[route], P.flash_fwd.tma_copies)
    out, lse = P.flash_fwd(q, k, v, sm_scale=128 ** -0.5, static_max=0.0,
                           emit_lse=True, route=route)
    ref, ref_lse = _plain_by_heads(P.flash_fwd_plain, q, k, v,
                                   sm_scale=128 ** -0.5, static_max=0.0,
                                   emit_lse=True)
    torch.cuda.synchronize()
    assert (P.flash_fwd.launches[route], P.flash_fwd.launches_sm90[route],
            P.flash_fwd.launches_d128[route], P.flash_fwd.tma_copies) \
        == (before[0] + 1, before[1] + 1, before[2] + 1, before[3])
    assert out.shape == ref.shape and lse.shape == ref_lse.shape == (1, h, sq)
    # bf16 output rounding; p is bf16 on both sides: 2e-2 of max|o|
    assert (out.float() - ref.float()).abs().max() \
        <= 2e-2 * ref.float().abs().max()
    assert torch.isfinite(lse).all()
    assert (lse - ref_lse).abs().max() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h", [(1, 2816, 2816, 2), (1, 129, 129, 24),
                                       (2, 300, 4322, 2), (1, 4112, 300, 3),
                                       (1, 1, 130, 2)])
def test_k5_d128_online_matches_plain(b, sq, sk, h):
    """K5 at d = 128 (bf16, with the LSE) on K3's Hopper kernel with the
    online max: Flux's training forward (2,816 tokens; its 24 heads cut to
    a test size) and ragged lengths, against ``flash_fwd_plain``; scores of
    unnormed q and k, so the running max moves from key tile to key tile
    and the LSE takes the row's final max."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, k, v = _qkv_d(b, sq, sk, h, 128, seed=sq + sk + h)
    q = q * 3
    assert P._fwd_design("K5", q.dtype, 128, False, None, True,
                         None) == "sm90"
    before = (P.flash_fwd.launches_sm90["K5"],
              P.flash_fwd.launches_d128["K5"])
    out, lse = P.flash_fwd(q, k, v, sm_scale=128 ** -0.5, emit_lse=True,
                           route="K5")
    ref, ref_lse = P.flash_fwd_plain(q, k, v, sm_scale=128 ** -0.5,
                                     emit_lse=True)
    torch.cuda.synchronize()
    assert (P.flash_fwd.launches_sm90["K5"],
            P.flash_fwd.launches_d128["K5"]) == (before[0] + 1,
                                                 before[1] + 1)
    assert lse.shape == ref_lse.shape == (b, h, sq)
    assert (out.float() - ref.float()).abs().max() \
        <= 2e-2 * ref.float().abs().max()
    assert torch.isfinite(lse).all()
    assert (lse - ref_lse).abs().max() <= 1e-3


def _check_bwd128(q, k, v, g, route="K8", copies=0):
    """flash_bwd at d=128 against ``flash_bwd_plain`` on the LSE of K5's
    Hopper forward: counted per route, per design and at d=128, with
    ``copies`` alignment copies.  Returns the gradients."""
    out, lse = P.flash_fwd(q, k, v, sm_scale=128 ** -0.5, static_max=0.0,
                           emit_lse=True, route="K5")
    before = (P.flash_bwd.launches[route], P.flash_bwd.launches_sm90[route],
              P.flash_bwd.launches_d128[route], P.flash_bwd.tma_copies)
    got = P.flash_bwd(q, k, v, out, g, lse, sm_scale=128 ** -0.5,
                      single_pass=route == "K8")
    ref = _plain_by_heads(P.flash_bwd_plain, q, k, v, out, g, lse,
                          sm_scale=128 ** -0.5)
    torch.cuda.synchronize()
    assert (P.flash_bwd.launches[route], P.flash_bwd.launches_sm90[route],
            P.flash_bwd.launches_d128[route], P.flash_bwd.tma_copies) \
        == (before[0] + 1, before[1] + 1, before[2] + 1, before[3] + copies)
    for x, r in zip(got, ref):
        assert x.shape == r.shape and x.dtype == torch.bfloat16
        assert torch.isfinite(x.float()).all()
        # p and ds are bf16 operands, gradients bf16: 2e-2 of max|grad|
        assert (x.float() - r.float()).abs().max() \
            <= 2e-2 * r.float().abs().max()
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("h", [2, 24])
@pytest.mark.parametrize("sq,sk", _D128_LENGTHS)
def test_d128_backward_matches_plain(sq, sk, h):
    """K8 at d=128, unmasked, non-causal, on the single pass of
    flash_bwd_sm90.cu at its width 128: ragged query and key tails (pad
    rows, keys past Sk) and Sq ≠ Sk."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, k, v = _rms_qkv(1, sq, sk, h, seed=sq + 3 * sk + h)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(sq)
                    ).cuda().bfloat16()
    _check_bwd128(q, k, v, g)


@pytest.mark.cuda
def test_k9_d128_runs_the_same_kernel():
    """K9 (single_pass=False) at d=128 launches the same single pass."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, k, v = _rms_qkv(1, 300, 300, 2, seed=11)
    g = torch.randn(q.shape, device="cuda").bfloat16()
    _check_bwd128(q, k, v, g, route="K9")


@pytest.mark.cuda
def test_d128_reads_a_fused_qkv_in_place():
    """q, k and v as views of one fused projection, and a dO sliced out of
    a wider tensor: the forward's and the backward's TMA read them in
    place, without a copy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, k, v = _rms_qkv(1, 352, 352, 2, seed=12, fused=True)
    g = torch.randn((1, 352, 2, 2, 128), device="cuda").bfloat16()[:, :, 0]
    assert all(P._aligned(x) and not x.is_contiguous() for x in (q, k, v, g))
    copies = P.flash_fwd.tma_copies
    _check_bwd128(q, k, v, g)
    assert P.flash_fwd.tma_copies == copies


@pytest.mark.cuda
def test_d128_copies_what_tma_cannot_read():
    """A v whose row stride (132 elements, 264 bytes) is not a multiple of
    16 bytes is copied, by the forward and by the backward, and each copy is
    counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, k, _ = _rms_qkv(1, 300, 300, 2, seed=13)
    v = torch.randn((1, 300, 2, 132), device="cuda").bfloat16()[..., :128]
    g = torch.randn(q.shape, device="cuda").bfloat16()
    assert not P._aligned(v)
    copies = P.flash_fwd.tma_copies
    _check_bwd128(q, k, v, g, copies=1)
    assert P.flash_fwd.tma_copies == copies + 1


@pytest.mark.cuda
@pytest.mark.parametrize("s", [352, 7456])
def test_d128_backward_dk_dv_are_reproducible(s):
    """dk and dv bit-equal across two calls; dq is summed by f32 atomics in
    another order each call, within the tolerance of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, k, v = _rms_qkv(1, s, s, 24, seed=s)
    g = torch.randn(q.shape, device="cuda").bfloat16()
    out, lse = P.flash_fwd(q, k, v, sm_scale=128 ** -0.5, static_max=0.0,
                           emit_lse=True, route="K5")

    def run():
        return P.flash_bwd(q, k, v, out, g, lse, sm_scale=128 ** -0.5)

    first, second = run(), run()
    torch.cuda.synchronize()
    assert torch.equal(first[1], second[1])
    assert torch.equal(first[2], second[2])


# ---------------------------------------------------------------- split keys
def _check_split(q, k, v, route, static_max, emit_lse, splits=None):
    """flash_fwd on ``route`` (or, with ``splits``, the private launcher
    with that many key ranges) against ``flash_fwd_plain``: counted as a
    split launch of the Hopper design exactly when the plan splits, and the
    same bits from a second call."""
    d = q.shape[-1]
    sm = d ** -0.5
    before = (dict(P.flash_fwd.launches_sm90), dict(P.flash_fwd.launches_split))
    if splits is None:
        run = lambda: P.flash_fwd(q, k, v, sm_scale=sm, static_max=static_max,
                                  emit_lse=emit_lse, route=route)
        plan = P._fwd_plan("sm90", q, k, False, False)
    else:
        run = lambda: P._flash_fwd_sm90(q, k, v, sm, static_max, emit_lse,
                                        splits=splits)
    first, second = run(), run()
    ref, ref_lse = P.flash_fwd_plain(q, k, v, sm_scale=sm,
                                     static_max=static_max, emit_lse=True)
    torch.cuda.synchronize()
    if splits is None:
        n = 2 * (plan.splits > 1)
        assert P.flash_fwd.launches_sm90 == dict(
            before[0], **{route: before[0][route] + 2})
        assert P.flash_fwd.launches_split == dict(
            before[1], **{route: before[1][route] + n})
    out, lse = first if emit_lse else (first, None)
    # bf16 output rounding; p is bf16 on both sides: 2e-2 of max|o|
    assert (out.float() - ref.float()).abs().max() \
        <= 2e-2 * ref.float().abs().max()
    if emit_lse:
        assert (lse - ref_lse).abs().max() <= 1e-3
        assert torch.equal(lse, second[1])
    assert torch.equal(out, second[0] if emit_lse else second)
    return plan.splits if splits is None else splits


@pytest.mark.cuda
@pytest.mark.parametrize("emit_lse", [False, True], ids=["no_lse", "lse"])
@pytest.mark.parametrize("route,static_max", [("K6", None), ("K1", None),
                                              ("K1", 0.0)])
@pytest.mark.parametrize("sq,sk,splits", [(300, 4322, 5), (17, 4322, 9),
                                          (1, 1100, 3), (130, 2000, 4)])
def test_split_k1_k6_matches_plain(sq, sk, splits, route, static_max,
                                   emit_lse):
    """K6 and K1 (d=64, B=2, H=4) at short query sides over long key rows
    (Sk not a multiple of 128, Sq below 64, a single query): the plan cuts
    every query tile's keys into ``splits`` ranges, and the split walk and
    its combine match the plain version in either softmax mode, with and
    without the LSE, the same bits on every call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, k, v = _qkv(2, sq, sk, 4, seed=sq + 7 * sk)
    assert _check_split(q, k, v, route, static_max, emit_lse) == splits


@pytest.mark.cuda
@pytest.mark.parametrize("emit_lse", [False, True], ids=["no_lse", "lse"])
@pytest.mark.parametrize("static_max", [None, 0.0], ids=["online", "fixed"])
@pytest.mark.parametrize("splits", [1, 2, 3, 8])
def test_split_ranges_of_any_count_match_plain(splits, static_max, emit_lse):
    """The private launcher with 1 to 8 key ranges at 64 queries over 1000
    keys (8 key tiles: 8 ranges is one tile each, more ranges than the
    plan would cut)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, k, v = _qkv(1, 64, 1000, 2, seed=splits)
    _check_split(q, k, v, "K1", static_max, emit_lse, splits=splits)


@pytest.mark.cuda
@pytest.mark.parametrize("route,emit_lse", [("K2", False), ("K5", True)])
@pytest.mark.parametrize("d", [72, 80])
def test_split_d72_matches_plain(d, route, emit_lse):
    """K2 and K5 at d = 72 and 80 (the persistent kernel's two boxes) over
    long keys split too (B=1, H=3, 300 × 4322: 9 ranges)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, k, v = _qkv_d(1, 300, 4322, 3, d, seed=d)
    assert _check_split(q, k, v, route, None, emit_lse) == 9


@pytest.mark.cuda
def test_split_rejects_what_it_does_not_take():
    """More ranges than key tiles, a split key mask and a split at
    d = 128 are refused by the C entry."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, k, v = _qkv(1, 64, 1000, 2, seed=3)
    with pytest.raises(RuntimeError, match="launch failed"):
        P._flash_fwd_sm90(q, k, v, 0.125, None, False, splits=9)
    q7, k7, v7 = _qkv_d(1, 64, 1000, 2, 72, seed=4)
    m = torch.ones((1, 1000), dtype=torch.bool, device="cuda")
    with pytest.raises(RuntimeError, match="launch failed"):
        P._flash_fwd_sm90(q7, k7, v7, 72 ** -0.5, None, False, kv_valid=m,
                          splits=2)
    q8, k8, v8 = _qkv_d(1, 64, 1000, 2, 128, seed=5)
    with pytest.raises(RuntimeError, match="launch failed"):
        P._flash_fwd_sm90(q8, k8, v8, 128 ** -0.5, 0.0, False, splits=2)


# ---------------------------------------------------------------- f32 design
def _f32_qkv(b, sq, sk, h, seed, normed=False):
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((b, s, h, 128), generator=gen)
               for s in (sq, sk, sk))
    if normed:
        q = torch.nn.functional.layer_norm(q, (128,))
        k = torch.nn.functional.layer_norm(k, (128,))
    return [x.cuda() for x in (q, k, v)]


@pytest.mark.cuda
@pytest.mark.parametrize("emit_lse", [False, True], ids=["no_lse", "lse"])
@pytest.mark.parametrize("static_max", [None, 0.0], ids=["online", "fixed"])
@pytest.mark.parametrize("b,sq,sk,h,causal", [
    (1, 256, 256, 32, True),      # LLaMA in HunyuanVideo's text encode
    (2, 333, 333, 2, True),       # ragged, causal
    (2, 300, 130, 3, True),       # more queries than keys
    (1, 1, 77, 2, False),         # one query
    (1, 1024, 1024, 1, False),    # the 2D VAE's mid attention
    (3, 200, 4322, 2, False),     # long keys
])
def test_f32_design_matches_plain(b, sq, sk, h, causal, static_max,
                                  emit_lse):
    """flash_fwd_f32_sm90.cu at d = 128 against the f32 plain version (1e-4
    of max|o|, LSE 1e-4), counted on the f32 design (and as a split where
    the plan splits), the same bits from a second call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, k, v = _f32_qkv(b, sq, sk, h, seed=sq + sk + h,
                       normed=static_max is not None)
    route = "K5" if emit_lse else "K2"
    plan = P._fwd_plan("f32", q, k, causal, False)
    before = (dict(P.flash_fwd.launches_f32), dict(P.flash_fwd.launches_split),
              dict(P.flash_fwd.launches_sm90))
    kw = dict(sm_scale=128 ** -0.5, causal=causal, static_max=static_max)
    first = P.flash_fwd(q, k, v, emit_lse=emit_lse, route=route, **kw)
    second = P.flash_fwd(q, k, v, emit_lse=emit_lse, route=route, **kw)
    ref, ref_lse = P.flash_fwd_plain(q, k, v, emit_lse=True, **kw)
    torch.cuda.synchronize()
    assert P.flash_fwd.launches_f32 == dict(
        before[0], **{route: before[0][route] + 2})
    assert P.flash_fwd.launches_split == dict(
        before[1], **{route: before[1][route] + 2 * (plan.splits > 1)})
    assert P.flash_fwd.launches_sm90 == before[2]
    out, lse = first if emit_lse else (first, None)
    assert out.dtype == torch.float32
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()
    if emit_lse:
        assert (lse - ref_lse).abs().max() <= 1e-4
        assert torch.equal(lse, second[1])
    assert torch.equal(out, second[0] if emit_lse else second)


@pytest.mark.cuda
@pytest.mark.parametrize("emit_lse", [False, True], ids=["no_lse", "lse"])
@pytest.mark.parametrize("b,sq,sk,h,d,causal,static_max", [
    (1, 577, 577, 16, 64, False, None),   # the LLaVA tower, ViT-L/14-336
    (1, 256, 256, 16, 80, False, None),   # the CLIP ViT-H/14 embedder
    (2, 333, 333, 2, 64, True, None),     # ragged, causal
    (2, 300, 130, 3, 80, True, None),     # more queries than keys
    (1, 1, 77, 2, 64, False, 0.0),        # one query, fixed max
    (3, 200, 4322, 2, 80, False, 0.0),    # long keys, fixed max
])
def test_f32_design_widths_match_plain(b, sq, sk, h, d, causal, static_max,
                                       emit_lse):
    """flash_fwd_f32_sm90.cu at d = 64 and 80 (routes K1 at d = 64 with an
    even head count, else K2) against the f32 plain version (1e-4 of
    max|o|, LSE 1e-4), counted on the f32 design, the same bits twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    gen = torch.Generator().manual_seed(sq + sk + d)
    q, k, v = (torch.randn((b, s, h, d), generator=gen) for s in (sq, sk, sk))
    if static_max is not None:
        q, k = (torch.nn.functional.layer_norm(x, (d,)) for x in (q, k))
    q, k, v = (x.cuda() for x in (q, k, v))
    route = "K1" if d == 64 and h % 2 == 0 and not causal else "K2"
    before = (dict(P.flash_fwd.launches_f32), dict(P.flash_fwd.launches_sm90))
    kw = dict(sm_scale=d ** -0.5, causal=causal, static_max=static_max,
              route=route)
    first = P.flash_fwd(q, k, v, emit_lse=emit_lse, **kw)
    second = P.flash_fwd(q, k, v, emit_lse=emit_lse, **kw)
    kw.pop("route")
    ref, ref_lse = P.flash_fwd_plain(q, k, v, emit_lse=True, **kw)
    torch.cuda.synchronize()
    assert P.flash_fwd.launches_f32 == dict(
        before[0], **{route: before[0][route] + 2})
    assert P.flash_fwd.launches_sm90 == before[1]
    out, lse = first if emit_lse else (first, None)
    assert out.dtype == torch.float32
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()
    if emit_lse:
        assert (lse - ref_lse).abs().max() <= 1e-4
        assert torch.equal(lse, second[1])
    assert torch.equal(out, second[0] if emit_lse else second)


@pytest.mark.cuda
@pytest.mark.parametrize("static_max", [None, 0.0], ids=["online", "fixed"])
def test_k2_d72_over_3600_keys(static_max):
    """Open-Sora 1.2's spatial attention at 720p: 3,600 tokens a frame (29
    key tiles under the online max), at 2 frames and 4 of its 16 heads of
    d = 72, on the persistent kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, k, v = _qkv_d(2, 3600, 3600, 4, 72, seed=36,
                     normed=static_max is not None)
    before = P.flash_fwd.launches_sm90["K2"]
    _check_fwd(q, k, v, "K2", sm_scale=72 ** -0.5, static_max=static_max)
    assert P.flash_fwd.launches_sm90["K2"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["prefix", "strided", "all_valid"])
def test_k4_d72_over_300_caption_keys(pattern):
    """Open-Sora 1.2's cross-attention: a frame's 3,600 queries over T5's
    300 caption keys (3 key tiles), the caption masked, on the persistent
    kernel with the key mask."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, k, v = _qkv_d(2, 3600, 300, 4, 72, seed=30)
    before = P.flash_fwd.launches_sm90["K4"]
    _check_fwd(q, k, v, "K4", sm_scale=72 ** -0.5,
               kv_valid=_kv_mask(2, 300, pattern))
    assert P.flash_fwd.launches_sm90["K4"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h,d,causal", [
    (1, 1024, 1024, 1, 128, False),
    (2, 200, 333, 2, 72, False),
    (1, 130, 130, 2, 256, True),
])
def test_k2_f32_shapes_launch_per_design(b, sq, sk, h, d, causal):
    """``test_k2_kernel_takes_f32``'s shapes, counted per design: d = 128
    on the f32 design, d = 72 and 256 on flash_fwd.cu (no Hopper or f32
    launch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    gen = torch.Generator().manual_seed(sq + d)
    q, k, v = (torch.randn((b, s, h, d), generator=gen).cuda()
               for s in (sq, sk, sk))
    before = (P.flash_fwd.launches["K2"], P.flash_fwd.launches_f32["K2"],
              P.flash_fwd.launches_sm90["K2"])
    out = P.flash_fwd(q, k, v, sm_scale=d ** -0.5, causal=causal)
    ref = P.flash_fwd_plain(q, k, v, sm_scale=d ** -0.5, causal=causal)
    torch.cuda.synchronize()
    assert (P.flash_fwd.launches["K2"], P.flash_fwd.launches_f32["K2"],
            P.flash_fwd.launches_sm90["K2"]) \
        == (before[0] + 1, before[1] + (d == 128), before[2])
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()


def _check_k2_d64(q, k, v):
    """flash_fwd on route K2 (online) against ``flash_fwd_plain``: launched
    on flash_fwd_sm90 (the persistent kernel) and counted as K2 there."""
    before = (P.flash_fwd.launches["K2"], P.flash_fwd.launches_sm90["K2"])
    out = P.flash_attention(q, k, v)
    ref = P.flash_fwd_plain(q, k, v, sm_scale=0.125)
    torch.cuda.synchronize()
    assert (P.flash_fwd.launches["K2"],
            P.flash_fwd.launches_sm90["K2"]) == (before[0] + 1,
                                                 before[1] + 1)
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    assert (out.float() - ref.float()).abs().max() \
        <= 2e-2 * ref.float().abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk", [(2600, 2600), (2600, 77), (300, 16),
                                   (9216, 77)])
def test_k2_d64_odd_heads_on_the_persistent_kernel(sq, sk):
    """K2 at d = 64 with 5 heads (VideoCrafter2's and DynamiCrafter's
    first UNet level: no head pairs, so the generic route) on the
    persistent Hopper kernel, online softmax, self-attention at a length
    that is not a multiple of the 128-row tile and over 77 text keys and 16
    image tokens; unnormalised q, k as the UNet's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    assert P._fwd_design("K2", torch.bfloat16, 64, False, None, False,
                         None) == "sm90"
    gen = torch.Generator().manual_seed(sq + sk)
    q, k, v = (torch.randn((2, s, 5, 64), generator=gen).cuda().bfloat16()
               for s in (sq, sk, sk))
    _check_k2_d64(q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,h", [(640, 10), (2304, 10), (576, 20)])
def test_k1_online_over_77_keys(sq, h):
    """K1 (even heads at d = 64) online over 77 text keys, the UNet's
    cross-attention at its second and third levels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, k, v = _qkv(2, sq, 77, h, seed=sq)
    _check_k1(q, k, v, None, emit_lse=False)


# -------------------------- d = 64: UNet3D training (K5, K8, K1, K7)
# (b, sq, sk, h): a VideoCrafter2 training step's attention at batch 1
# (B = 16 frames): level 1's self-attention and its 77-key cross-attention
# (5 heads: K5, K8), levels 2 and 4 (10 and 20 heads: K1 with the LSE and
# K7 self, K5 and K7 over 77 keys)
_UNET_TRAIN = [(16, 2560, 2560, 5), (16, 2560, 77, 5), (16, 640, 640, 10),
               (16, 640, 77, 10), (16, 160, 160, 20), (16, 160, 77, 20)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h", _UNET_TRAIN)
def test_unet_training_attention_on_hopper_designs(b, sq, sk, h):
    """The custom VJP's kernels at a VideoCrafter2 training step's shapes,
    routed as ``flash_attention_diff`` routes them: the forward with its
    LSE on flash_fwd_sm90 (K1 where the heads pair and both sides are ≥ 128
    tokens, else K5) against ``flash_fwd_plain``, the backward (K7 for an
    even head count, else K8) on the kernel ``_bwd_kernel`` names
    (flash_bwd_rows_sm90 over the 77 keys, flash_bwd_sm90 otherwise)
    against ``flash_bwd_plain``, each counted per route, design and
    kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    gen = torch.Generator().manual_seed(sq + sk + h)
    q, k, v, g = (torch.randn(shape, generator=gen).cuda().bfloat16()
                  for shape in ((b, sq, h, 64), (b, sk, h, 64),
                                (b, sk, h, 64), (b, sq, h, 64)))
    fwd = "K1" if h % 2 == 0 and min(sq, sk) >= 128 else "K5"
    bwd = "K7" if h % 2 == 0 else "K8"
    assert P._fwd_design(fwd, q.dtype, 64, False, None, True, None) == "sm90"
    assert P._bwd_design(bwd, q.dtype, 64, False, False) == "sm90"
    rows = P._bwd_kernel(64, sk) == "rows"
    assert rows == (sk <= 128)
    before = (P.flash_fwd.launches[fwd], P.flash_fwd.launches_sm90[fwd],
              P.flash_fwd.tma_copies)
    out, lse = P.flash_fwd(q, k, v, sm_scale=0.125, emit_lse=True,
                           route=fwd)
    torch.cuda.synchronize()
    assert (P.flash_fwd.launches[fwd], P.flash_fwd.launches_sm90[fwd],
            P.flash_fwd.tma_copies) == (before[0] + 1, before[1] + 1,
                                        before[2])
    ref, ref_lse = _plain_by_heads(P.flash_fwd_plain, q, k, v,
                                   sm_scale=0.125, emit_lse=True, heads=1)
    assert (out.float() - ref.float()).abs().max() \
        <= 2e-2 * ref.float().abs().max()
    assert (lse - ref_lse).abs().max() <= 1e-3
    before = (P.flash_bwd.launches[bwd], P.flash_bwd.launches_sm90[bwd],
              P.flash_bwd.launches_rows[bwd], P.flash_bwd.launches_d128[bwd])
    got = P.flash_bwd(q, k, v, out, g, lse, sm_scale=0.125)
    torch.cuda.synchronize()
    assert (P.flash_bwd.launches[bwd], P.flash_bwd.launches_sm90[bwd],
            P.flash_bwd.launches_rows[bwd],
            P.flash_bwd.launches_d128[bwd]) == (
        before[0] + 1, before[1] + 1, before[2] + rows, before[3])
    ref = _plain_by_heads(P.flash_bwd_plain, q, k, v, out, g, lse,
                          sm_scale=0.125, heads=1)
    for x, r in zip(got, ref):
        assert x.shape == r.shape and x.dtype == torch.bfloat16
        assert torch.isfinite(x.float()).all()
        # p and ds are bf16 operands, gradients bf16: 2e-2 of max|grad|
        assert (x.float() - r.float()).abs().max() \
            <= 2e-2 * r.float().abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("sk", [13, 77, 128])
def test_both_hopper_backwards_agree_over_one_key_tile(sk):
    """Over keys that fit one tile at d = 64 both Hopper backwards take the
    call: the short-row kernel the rule picks (its 16-column box past d)
    and flash_bwd_sm90, each against ``flash_bwd_plain``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    gen = torch.Generator().manual_seed(sk)
    q, k, v, g = (torch.randn(shape, generator=gen).cuda().bfloat16()
                  for shape in ((2, 700, 3, 64), (2, sk, 3, 64),
                                (2, sk, 3, 64), (2, 700, 3, 64)))
    out, lse = P.flash_fwd(q, k, v, sm_scale=0.125, emit_lse=True,
                           route="K5")
    ref = P.flash_bwd_plain(q, k, v, out, g, lse, sm_scale=0.125)
    for fn in (P._flash_bwd_rows, P._flash_bwd_sm90):
        got = fn(q, k, v, out, g, lse, 0.125)
        torch.cuda.synchronize()
        for x, r in zip(got, ref):
            assert torch.isfinite(x.float()).all()
            assert (x.float() - r.float()).abs().max() \
                <= 2e-2 * r.float().abs().max()
