"""Attention for the port: ``dot_product_attention`` with the JAX package's
dispatch (``videotuna_tpu/kernels/attention.py:2166-2254``), the plain
``reference_attention``, and the wrapper of the Hopper flash kernel K1.

Layout: (batch, seq, heads, head_dim), as in the JAX package.

The JAX package sends an attention call to a Pallas kernel when it has no
additive bias, head_dim ≤ 256 and at least 128 query tokens; otherwise to the
math path.  Among the kernels, the port has K1 (d=64, even heads,
non-causal: ``flash_fwd_d64``).  A call that the JAX package would send to
another kernel (K2 generic, K3 d=128 fixed max, K4 ``kv_valid``) raises
``NotImplementedError`` on a CUDA tensor naming that kernel, and runs the plain
math on a CPU tensor, which is that kernel's plain version.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import threading
from typing import Optional, Tuple, Union

import torch

_NEG_INF = -1e30
_LOG2E = 1.4426950408889634

# TPU kernels of videotuna_tpu/kernels/attention.py that the forward dispatch
# can reach, with what each computes.
_KERNELS = {
    "K1": "d=64 non-causal flash forward (_flash_packed2t)",
    "K2": "generic online-softmax flash forward (flash_attention)",
    "K3": "d=128 non-causal fixed-max flash forward (_flash_t128)",
    "K4": "kv_valid-masked flash forward (_flash_dynpad)",
}


# ---------------------------------------------------------------------------
# Plain math path (CPU fallback of every route, and the tests' oracle)
# ---------------------------------------------------------------------------

def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        causal: bool = False,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Softmax attention: logits in f32, probabilities cast to ``v.dtype``
    before PV."""
    sq, _, d = q.shape[-3:]
    sk = k.shape[-3]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    logits = torch.einsum("...qhd,...khd->...hqk", q.float(),
                          k.float()) * scale
    if bias is not None:
        logits = logits + bias
    if causal:
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril()
        logits = torch.where(mask, logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("...hqk,...khd->...qhd", probs, v)


# ---------------------------------------------------------------------------
# K1: d=64 non-causal flash forward
# ---------------------------------------------------------------------------

def flash_fwd_d64_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, sm_scale: float,
                        static_max: Optional[float] = None,
                        emit_lse: bool = False
                        ) -> Union[torch.Tensor,
                                   Tuple[torch.Tensor, torch.Tensor]]:
    """Plain PyTorch version of K1, the function ``flash_fwd_d64`` computes.

    s = (q·k)·sm_scale·log2e in f32; p = exp2(s − M) with M = ``static_max``
    (fixed max) or the row max (online softmax); l = Σp; p is rounded to
    ``v.dtype`` and o = (p @ v) / l accumulated in f32.  With ``emit_lse`` it
    also returns lse = (M + log2 l) / log2e as f32 (B, H, Sq)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * (sm_scale * _LOG2E)
    if static_max is None:
        m = s.amax(dim=-1, keepdim=True)
    else:
        m = torch.full_like(s[..., :1], float(static_max))
    p = torch.exp2(s - m)
    l = p.sum(dim=-1).clamp_min(1e-30)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    out = (acc / l[..., None]).to(q.dtype).permute(0, 2, 1, 3).contiguous()
    if emit_lse:
        return out, (m[..., 0] + torch.log2(l)) / _LOG2E
    return out


_FLASH_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                      ctypes.c_void_p])


def _check_flash_inputs(q, k, v):
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"flash_fwd_d64 takes bf16 q/k/v on CUDA, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k, v must be (B, S, H, 64)")
    b, sq, h, d = q.shape
    if d != 64 or k.shape != v.shape or k.shape[0] != b \
            or k.shape[2] != h or k.shape[3] != 64:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not (B,Sq,H,64) and "
                         "(B,Sk,H,64)")
    if sq < 1 or k.shape[1] < 1:
        raise ValueError("empty sequence")
    if b * h > 65535:
        raise ValueError("B·H above 65535 exceeds the launch grid")
    for name, t in (("q", q), ("k", k), ("v", v)):
        # 16-byte cp.async copies: rows contiguous, row starts 16-byte aligned
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(
                f"{name} must have a contiguous head_dim, strides that are "
                "multiples of 8 elements and a 16-byte aligned start")


def flash_fwd_d64(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  sm_scale: float, static_max: Optional[float] = None,
                  emit_lse: bool = False
                  ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """K1: non-causal flash attention forward for head_dim 64.

    q (B, Sq, H, 64), k and v (B, Sk, H, 64) → o (B, Sq, H, 64) in q's
    dtype, and with ``emit_lse`` the natural-log LSE, f32 (B, H, Sq).

    On a CUDA tensor it launches the hand-written kernel
    ``csrc/flash_fwd_d64.cu`` (bf16 only; anything else raises) and adds one
    to ``flash_fwd_d64.launches``.  On a CPU tensor it runs
    ``flash_fwd_d64_plain``.  Replaces the TPU kernel
    ``_flash_kernel_packed2t`` / ``_flash_packed2t``
    (videotuna_tpu/kernels/attention.py:268, :449)."""
    if q.device.type == "cpu":
        return flash_fwd_d64_plain(q, k, v, sm_scale=sm_scale,
                                   static_max=static_max, emit_lse=emit_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd_d64: unsupported device {q.device}")
    _check_flash_inputs(q, k, v)
    from videotuna_tpu_torch.kernels import load
    lib = load("flash_fwd_d64.cu")
    fn = lib.flash_fwd_d64_bf16
    fn.argtypes = _FLASH_ARGTYPES
    fn.restype = ctypes.c_int
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    out = torch.empty((b, sq, h, 64), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if emit_lse else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr() if lse is not None else None,
                b, h, sq, sk,
                q.stride(0), q.stride(1), q.stride(2),
                k.stride(0), k.stride(1), k.stride(2),
                v.stride(0), v.stride(1), v.stride(2),
                out.stride(0), out.stride(1), out.stride(2),
                float(sm_scale * _LOG2E), int(static_max is not None),
                float(static_max or 0.0), stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd_d64 launch failed with CUDA error {rc}")
    flash_fwd_d64.launches += 1
    return (out, lse) if emit_lse else out


flash_fwd_d64.launches = 0


def _not_ported(x: torch.Tensor, kernel: str) -> None:
    """Raise on a CUDA tensor for a TPU kernel the port does not have yet."""
    if x.device.type != "cpu":
        raise NotImplementedError(
            f"TPU kernel {kernel} ({_KERNELS[kernel]}) is not ported to CUDA "
            "yet (see ROADMAP.md)")


# ---------------------------------------------------------------------------
# Scoped options and the public entry
# ---------------------------------------------------------------------------

_ATTN_OPTS = threading.local()


@contextlib.contextmanager
def attention_options(static_max: Optional[float] = None):
    """Scoped kernel options for every ``dot_product_attention`` inside.

    ``static_max``: fixed softmax max (log2 domain) for qk-normed denoisers,
    applied only at call sites that declare ``bounded_logits=True`` and are
    not causal.  Exact while scaled log2-scores lie within
    (static_max − 126, static_max + 127)."""
    prev = getattr(_ATTN_OPTS, "cfg", None)
    _ATTN_OPTS.cfg = {"static_max": static_max}
    try:
        yield
    finally:
        _ATTN_OPTS.cfg = prev


def _flash(q, k, v, causal, scale, static_max):
    """The JAX package's ``flash_attention`` route choice for (B,S,H,D)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    sm_scale = (1.0 / math.sqrt(d)) if scale is None else scale
    if d == 64 and h % 2 == 0 and not causal:
        return flash_fwd_d64(q, k, v, sm_scale=sm_scale,
                             static_max=static_max)
    # head_dim is zero-padded to 128 lanes there, so every d ≤ 128 with a
    # fixed max takes the d=128 kernel
    fixed_128 = (static_max is not None and not causal and d <= 128
                 and sq >= 128 and sk >= 128)
    _not_ported(q, "K3" if fixed_128 else "K2")
    return reference_attention(q, k, v, causal=causal, scale=scale)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          causal: bool = False,
                          scale: Optional[float] = None,
                          force_reference: bool = False,
                          kv_valid: Optional[torch.Tensor] = None,
                          bounded_logits: bool = False) -> torch.Tensor:
    """Attention entry point used by every model of the port.

    q, k, v: (..., seq, heads, head_dim); leading dims are flattened to
    batch.  ``kv_valid``: optional (B, Sk) bool key-validity mask.
    ``bounded_logits``: the call site's declaration that q and k are
    normalised, which lets the scoped ``attention_options(static_max=…)``
    apply."""
    orig_shape = q.shape
    if q.ndim > 4:
        if kv_valid is not None:
            raise ValueError("kv_valid needs 4D (B, S, H, D) inputs")
        lead = math.prod(orig_shape[:-3])
        q = q.reshape(lead, *orig_shape[-3:])
        k = k.reshape(lead, *k.shape[-3:])
        v = v.reshape(lead, *v.shape[-3:])
    elif q.ndim == 3:
        q, k, v = q[None], k[None], v[None]
        if kv_valid is not None and kv_valid.ndim == 1:
            kv_valid = kv_valid[None]

    # GQA/MQA: broadcast KV heads once so every path sees equal head counts
    h, kh = q.shape[-2], k.shape[-2]
    if kh != h:
        if h % kh:
            raise ValueError(f"q heads {h} not a multiple of kv heads {kh}")
        k = k.repeat_interleave(h // kh, dim=-2)
        v = v.repeat_interleave(h // kh, dim=-2)

    use_flash = (not force_reference and bias is None
                 and q.shape[-1] <= 256 and q.shape[1] >= 128)
    opts = getattr(_ATTN_OPTS, "cfg", None) or {}
    static_max = (opts.get("static_max")
                  if (bounded_logits and not causal) else None)
    if kv_valid is not None:
        kv_valid = kv_valid.bool()
        if use_flash and not causal:
            _not_ported(q, "K4")
        kb = torch.where(kv_valid, 0.0, _NEG_INF)[:, None, None, :]
        bias = kb if bias is None else bias + kb
        out = reference_attention(q, k, v, bias=bias, causal=causal,
                                  scale=scale)
        return out.reshape(orig_shape)
    if use_flash:
        out = _flash(q, k, v, causal, scale, static_max)
    else:
        out = reference_attention(q, k, v, bias=bias, causal=causal,
                                  scale=scale)
    return out.reshape(orig_shape)
