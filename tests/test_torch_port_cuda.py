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
    before = P.flash_fwd_d64.launches
    out, lse = P.flash_fwd_d64(q, k, v, sm_scale=0.125,
                               static_max=static_max, emit_lse=True)
    ref, ref_lse = P.flash_fwd_d64_plain(q, k, v, sm_scale=0.125,
                                         static_max=static_max,
                                         emit_lse=True)
    torch.cuda.synchronize()
    assert P.flash_fwd_d64.launches == before + 1
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
