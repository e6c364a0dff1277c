"""Attention for the port: ``dot_product_attention`` with the JAX package's
dispatch (``videotuna_tpu/kernels/attention.py:2166-2254``), its
``flash_attention`` route choice (:689), the plain ``reference_attention``,
and the wrappers of the Hopper flash kernels.

Layout: (batch, seq, heads, head_dim), as in the JAX package.

The JAX package sends an attention call to a Pallas kernel when it has no
additive bias, head_dim ≤ 256 and at least 128 query tokens; otherwise to the
math path.  The forward kernels it can reach, and where each is in the port:

- K1 (d=64, even heads, non-causal): ``flash_fwd_d64``, CUDA;
- K6 (``pack2=True``, K1's online softmax in another layout): mapped onto
  K1's kernel;
- K2 (generic: any d ≤ 256, causal, fixed max) and K4 (``kv_valid``-masked):
  ``flash_fwd``, one CUDA kernel;
- K3 (d ≤ 128 non-causal fixed max): not ported yet.  On a CUDA tensor it
  raises ``NotImplementedError`` naming K3; on a CPU tensor it runs K2's
  plain version, which computes the same function.

Every wrapper runs its kernel's plain version for a CPU tensor and launches
the kernel, or raises, for a CUDA tensor.
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
# can reach, with what each computes and where the port has it.
_KERNELS = {
    "K1": "d=64 non-causal flash forward (_flash_packed2t): "
          "csrc/flash_fwd_d64.cu",
    "K2": "generic online-softmax flash forward (flash_attention): "
          "csrc/flash_fwd.cu",
    "K3": "d=128 non-causal fixed-max flash forward (_flash_t128): "
          "not ported",
    "K4": "kv_valid-masked flash forward (_flash_dynpad): csrc/flash_fwd.cu",
    "K6": "d=64 natural-layout packed forward (_flash_packed2): "
          "mapped onto csrc/flash_fwd_d64.cu",
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
# Shared checks of the CUDA wrappers
# ---------------------------------------------------------------------------

def _check_layout(name: str, q, k, v) -> None:
    """What every flash kernel takes: bf16 (B,Sq,H,d) q and (B,Sk,H,d) k, v
    on one device, read in place with 16-byte cp.async copies."""
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"{name} takes bf16 q/k/v on CUDA, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k, v must be (B, S, H, D)")
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != h \
            or k.shape[3] != d:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not (B,Sq,H,D) and "
                         "(B,Sk,H,D)")
    if sq < 1 or k.shape[1] < 1:
        raise ValueError("empty sequence")
    for arg, t in (("q", q), ("k", k), ("v", v)):
        # 16-byte cp.async copies: rows contiguous, row starts 16-byte aligned
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(
                f"{arg} must have a contiguous head_dim, strides that are "
                "multiples of 8 elements and a 16-byte aligned start")


def _launch(source: str, symbol: str, argtypes, *args) -> None:
    """Call the C entry ``symbol`` of ``source`` on the current stream; it
    returns the launch's CUDA error, which raises here."""
    from videotuna_tpu_torch.kernels import load
    fn = getattr(load(source), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed with CUDA error {rc}")


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


_D64_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                 + [ctypes.c_longlong] * 12
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                    ctypes.c_void_p])


def flash_fwd_d64(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  sm_scale: float, static_max: Optional[float] = None,
                  emit_lse: bool = False, route: str = "K1"
                  ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """K1: non-causal flash attention forward for head_dim 64.

    q (B, Sq, H, 64), k and v (B, Sk, H, 64) → o (B, Sq, H, 64) in q's
    dtype, and with ``emit_lse`` the natural-log LSE, f32 (B, H, Sq).

    On a CUDA tensor it launches the hand-written kernel
    ``csrc/flash_fwd_d64.cu`` (bf16 only; anything else raises) and adds one
    to ``flash_fwd_d64.launches[route]``: "K1", or "K6" for the
    ``pack2=True`` route of ``flash_attention``.  On a CPU tensor it runs
    ``flash_fwd_d64_plain``.  Replaces the TPU kernel
    ``_flash_kernel_packed2t`` / ``_flash_packed2t``
    (videotuna_tpu/kernels/attention.py:268, :449), and closes K6
    (``_flash_kernel_packed2``, :163), the same online-softmax function in
    another layout."""
    if q.device.type == "cpu":
        return flash_fwd_d64_plain(q, k, v, sm_scale=sm_scale,
                                   static_max=static_max, emit_lse=emit_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd_d64: unsupported device {q.device}")
    if route not in flash_fwd_d64.launches:
        raise ValueError(f"flash_fwd_d64: route must be K1 or K6, got {route}")
    _check_layout("flash_fwd_d64", q, k, v)
    b, sq, h, d = q.shape
    if d != 64:
        raise ValueError(f"flash_fwd_d64 takes head_dim 64, got {d}")
    if b * h > 65535:
        raise ValueError("B·H above 65535 exceeds the launch grid")
    sk = k.shape[1]
    out = torch.empty((b, sq, h, 64), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if emit_lse else None)
    with torch.cuda.device(q.device):
        _launch("flash_fwd_d64.cu", "flash_fwd_d64_bf16", _D64_ARGTYPES,
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr() if lse is not None else None,
                b, h, sq, sk,
                q.stride(0), q.stride(1), q.stride(2),
                k.stride(0), k.stride(1), k.stride(2),
                v.stride(0), v.stride(1), v.stride(2),
                out.stride(0), out.stride(1), out.stride(2),
                float(sm_scale * _LOG2E), int(static_max is not None),
                float(static_max or 0.0))
    flash_fwd_d64.launches[route] += 1
    return (out, lse) if emit_lse else out


flash_fwd_d64.launches = {"K1": 0, "K6": 0}


# ---------------------------------------------------------------------------
# K2 / K4: generic and kv_valid-masked flash forward
# ---------------------------------------------------------------------------

def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    sm_scale: float, causal: bool = False,
                    kv_valid: Optional[torch.Tensor] = None,
                    static_max: Optional[float] = None,
                    emit_lse: bool = False
                    ) -> Union[torch.Tensor,
                               Tuple[torch.Tensor, torch.Tensor]]:
    """Plain PyTorch version of K2 and K4, the function ``flash_fwd``
    computes.

    s = (q·k)·sm_scale·log2e in f32, −inf where the key is masked: above
    the top-left causal diagonal (``causal``) or where ``kv_valid`` (B, Sk)
    is False.  p = exp2(s − M) with M = ``static_max`` (fixed max) or the
    row max over valid keys (online softmax); l = Σp; p is rounded to
    ``v.dtype`` and o = (p @ v) / l accumulated in f32.  A row with no valid
    key gives o = 0 and lse = −inf.  With ``emit_lse`` it also returns
    lse = (M + log2 l) / log2e as f32 (B, H, Sq)."""
    sq, sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * (sm_scale * _LOG2E)
    valid = None
    if causal:
        valid = torch.ones((sq, sk), dtype=torch.bool,
                           device=q.device).tril()
    if kv_valid is not None:
        kv = kv_valid.bool()[:, None, None, :]
        valid = kv if valid is None else valid & kv
    if valid is not None:
        s = s.masked_fill(~valid, float("-inf"))
    if static_max is None:
        m = s.amax(dim=-1, keepdim=True)
        m = m.masked_fill(m == float("-inf"), 0.0)   # rows with no valid key
    else:
        m = torch.full_like(s[..., :1], float(static_max))
    p = torch.exp2(s - m)
    l = p.sum(dim=-1)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    some = l > 0
    out = torch.where(some[..., None], acc / l.clamp_min(1e-30)[..., None],
                      0.0)
    out = out.to(q.dtype).permute(0, 2, 1, 3).contiguous()
    if emit_lse:
        lse = torch.where(some, (m[..., 0] + torch.log2(l.clamp_min(1e-30)))
                          / _LOG2E, float("-inf"))
        return out, lse
    return out


_FWD_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                 + [ctypes.c_longlong] * 12
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                    ctypes.c_float, ctypes.c_void_p])


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              sm_scale: float, causal: bool = False,
              kv_valid: Optional[torch.Tensor] = None,
              static_max: Optional[float] = None,
              emit_lse: bool = False
              ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """K2 and K4: flash attention forward for any head_dim ≤ 256.

    q (B, Sq, H, d), k and v (B, Sk, H, d) → o (B, Sq, H, d) in q's dtype,
    and with ``emit_lse`` the natural-log LSE, f32 (B, H, Sq).  Options:
    ``causal`` (top-left aligned), ``kv_valid`` (B, Sk) bool key mask of any
    pattern, ``static_max`` (fixed softmax max, log2 domain).

    On a CUDA tensor it launches the hand-written kernel
    ``csrc/flash_fwd.cu`` (bf16, d a multiple of 8; anything else raises)
    and adds one to ``flash_fwd.launches["K4"]`` when a mask is given, else
    to ``flash_fwd.launches["K2"]``.  On a CPU tensor it runs
    ``flash_fwd_plain``.  Replaces the TPU kernels ``_flash_kernel`` /
    ``flash_attention`` (K2, videotuna_tpu/kernels/attention.py:78, :812)
    and ``_flash_kernel_dynpad`` / ``_flash_dynpad`` (K4, :970, :1059)."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, sm_scale=sm_scale, causal=causal,
                               kv_valid=kv_valid, static_max=static_max,
                               emit_lse=emit_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd: unsupported device {q.device}")
    _check_layout("flash_fwd", q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if d > 256 or d % 8:
        raise ValueError(f"flash_fwd takes head_dim ≤ 256 and a multiple of "
                         f"8, got {d}")
    if -(-sq // 64) > 65535:
        raise ValueError("Sq above 64·65535 exceeds the launch grid")
    mask = None
    if kv_valid is not None:
        if kv_valid.shape != (b, sk) or kv_valid.device != q.device \
                or kv_valid.dtype not in (torch.bool, torch.uint8):
            raise ValueError(f"kv_valid must be a (B, Sk) = {(b, sk)} bool "
                             f"mask on {q.device}, got {tuple(kv_valid.shape)} "
                             f"{kv_valid.dtype} on {kv_valid.device}")
        mask = kv_valid.contiguous()
        if mask.dtype == torch.bool:
            mask = mask.view(torch.uint8)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if emit_lse else None)
    with torch.cuda.device(q.device):
        _launch("flash_fwd.cu", "flash_fwd_bf16", _FWD_ARGTYPES,
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr() if lse is not None else None,
                mask.data_ptr() if mask is not None else None,
                b, h, sq, sk, d,
                q.stride(0), q.stride(1), q.stride(2),
                k.stride(0), k.stride(1), k.stride(2),
                v.stride(0), v.stride(1), v.stride(2),
                out.stride(0), out.stride(1), out.stride(2),
                float(sm_scale * _LOG2E), int(causal),
                int(static_max is not None), float(static_max or 0.0))
    flash_fwd.launches["K4" if mask is not None else "K2"] += 1
    return (out, lse) if emit_lse else out


flash_fwd.launches = {"K2": 0, "K4": 0}


def _not_ported(x: torch.Tensor, kernel: str) -> None:
    """Raise on a CUDA tensor for a TPU kernel the port does not have yet."""
    if x.device.type != "cpu":
        raise NotImplementedError(
            f"TPU kernel {kernel} ({_KERNELS[kernel]}) is not ported to CUDA "
            "yet (see ROADMAP.md)")


# ---------------------------------------------------------------------------
# Route choice, scoped options and the public entry
# ---------------------------------------------------------------------------

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None,
                    kv_valid: Optional[torch.Tensor] = None,
                    static_max: Optional[float] = None,
                    pack2: Union[None, bool, str] = None) -> torch.Tensor:
    """Flash attention, q, k, v (B, S, H, D) → (B, Sq, H, D): the port's
    counterpart of the JAX package's ``flash_attention`` (:689) and its
    route choice, without the TPU block sizes and interpret mode.

    ``kv_valid`` → K4; ``pack2`` ("t", or auto for d=64, even heads,
    non-causal) → K1, and ``pack2=True`` → K6, mapped onto K1's kernel in
    online mode; a fixed max at d ≤ 128 with ≥ 128 queries and keys → K3
    (not ported); everything else → K2."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    if kh != h:   # GQA/MQA: broadcast KV heads
        k = k.repeat_interleave(h // kh, dim=2)
        v = v.repeat_interleave(h // kh, dim=2)
    sm_scale = (1.0 / math.sqrt(d)) if scale is None else scale
    if kv_valid is not None:
        if causal:
            raise ValueError("kv_valid is for non-causal attention")
        return flash_fwd(q, k, v, sm_scale=sm_scale, kv_valid=kv_valid,
                         static_max=static_max)
    if pack2 is None:
        pack2 = "t" if (d == 64 and h % 2 == 0 and not causal) else False
    if pack2:
        if not (d == 64 and h % 2 == 0 and not causal):
            raise ValueError("pack2 needs d=64, even heads, non-causal")
        if pack2 != "t" and static_max is not None:
            raise ValueError("static_max needs the packed-t path")
        return flash_fwd_d64(q, k, v, sm_scale=sm_scale,
                             static_max=static_max,
                             route="K1" if pack2 == "t" else "K6")
    if static_max is not None:
        if causal:
            raise ValueError("static_max: non-causal only")
        # head_dim is zero-padded to 128 lanes there, so every d ≤ 128 with
        # a fixed max takes the d=128 kernel
        if d <= 128 and sq >= 128 and sk >= 128:
            _not_ported(q, "K3")
    return flash_fwd(q, k, v, sm_scale=sm_scale, causal=causal,
                     static_max=static_max)


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
            out = flash_attention(q, k, v, scale=scale, kv_valid=kv_valid,
                                  static_max=static_max)
            return out.reshape(orig_shape)
        kb = torch.where(kv_valid, 0.0, _NEG_INF)[:, None, None, :]
        bias = kb if bias is None else bias + kb
        out = reference_attention(q, k, v, bias=bias, causal=causal,
                                  scale=scale)
        return out.reshape(orig_shape)
    if use_flash:
        out = flash_attention(q, k, v, causal=causal, scale=scale,
                              static_max=static_max)
    else:
        out = reference_attention(q, k, v, bias=bias, causal=causal,
                                  scale=scale)
    return out.reshape(orig_shape)
