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


@pytest.mark.cuda
@pytest.mark.parametrize("static_max", [None, 0.0])
@pytest.mark.parametrize("sq,sk", [(200, 200), (300, 4322), (1, 64),
                                   (4096, 4096)])
def test_k1_kernel_matches_plain(static_max, sq, sk):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, k, v = _qkv(2, sq, sk, 4, seed=sq + sk)
    before = P.flash_fwd_d64.launches["K1"]
    out, lse = P.flash_fwd_d64(q, k, v, sm_scale=0.125,
                               static_max=static_max, emit_lse=True)
    ref, ref_lse = P.flash_fwd_d64_plain(q, k, v, sm_scale=0.125,
                                         static_max=static_max,
                                         emit_lse=True)
    torch.cuda.synchronize()
    assert P.flash_fwd_d64.launches["K1"] == before + 1
    # bf16 output rounding; p is bf16 on both sides: 2e-2 of max|o|
    assert (out.float() - ref.float()).abs().max() \
        <= 2e-2 * ref.float().abs().max()
    assert (lse - ref_lse).abs().max() <= 1e-3


@pytest.mark.cuda
def test_k1_kernel_reads_strided_inputs():
    """q, k, v sliced out of one fused qkv tensor: read in place."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    qkv = torch.randn((2, 256, 3, 4, 64), device="cuda").bfloat16()
    q, k, v = qkv.unbind(dim=2)
    out = P.flash_fwd_d64(q, k, v, sm_scale=0.125)
    ref = P.flash_fwd_d64_plain(q, k, v, sm_scale=0.125)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max() \
        <= 2e-2 * ref.float().abs().max()


@pytest.mark.cuda
def test_k1_kernel_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q = torch.randn((1, 128, 2, 64), device="cuda")
    with pytest.raises(TypeError, match="bf16"):
        P.flash_fwd_d64(q, q, q, sm_scale=0.125)
    qb = q.bfloat16()
    with pytest.raises(ValueError, match="contiguous head_dim"):
        P.flash_fwd_d64(qb.transpose(1, 3).contiguous().transpose(1, 3),
                        qb, qb, sm_scale=0.125)


# ---------------------------------------------------------------- K2 / K4
def _qkv_d(b, sq, sk, h, d, seed, normed=False):
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((b, s, h, d), generator=gen)
               for s in (sq, sk, sk))
    if normed:
        q = torch.nn.functional.layer_norm(q, (d,))
        k = torch.nn.functional.layer_norm(k, (d,))
    return [x.cuda().bfloat16() for x in (q, k, v)]


def _check_fwd(q, k, v, route, **kw):
    before = P.flash_fwd.launches[route]
    out, lse = P.flash_fwd(q, k, v, emit_lse=True, **kw)
    ref, ref_lse = P.flash_fwd_plain(q, k, v, emit_lse=True, **kw)
    torch.cuda.synchronize()
    assert P.flash_fwd.launches[route] == before + 1
    # bf16 output rounding; p is bf16 on both sides: 2e-2 of max|o|
    assert (out.float() - ref.float()).abs().max() \
        <= 2e-2 * ref.float().abs().max()
    finite = torch.isfinite(ref_lse)
    assert torch.equal(torch.isfinite(lse), finite)
    assert (lse - ref_lse)[finite].abs().max() <= 1e-3


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
