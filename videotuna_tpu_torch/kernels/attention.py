"""Attention for the port: ``dot_product_attention`` with the JAX package's
dispatch (``videotuna_tpu/kernels/attention.py:2166-2254``), its
``flash_attention`` route choice (:689), the custom VJPs of training
(``flash_attention_diff`` and ``_flash_diff_masked``, :1918-2074), the plain
``reference_attention``, and the wrappers of the Hopper flash kernels.

Layout: (batch, seq, heads, head_dim), as in the JAX package.

The JAX package sends an attention call to a Pallas kernel when it has no
additive bias, head_dim ≤ 256 and at least 128 query tokens; otherwise to the
math path.  The kernels it can reach, and where each is in the port:

- K1 (d=64, even heads, non-causal) and K6 (``pack2=True``, K1's online
  softmax in another layout): ``flash_fwd`` on routes "K1" and "K6",
  launching in bf16 the persistent Hopper kernel of
  ``csrc/flash_fwd_sm90.cu`` (TMA, wgmma, online softmax or fixed max,
  optional LSE; few query tiles over many keys, as at K6's A/B shape,
  split their keys into ranges whose partials a second launch combines:
  ``_fwd_split_plan``), in f32 ``csrc/flash_fwd.cu``;
- K2 (generic: any d ≤ 256, causal, fixed max) and K4 (``kv_valid``-masked):
  ``flash_fwd``, one CUDA kernel (``csrc/flash_fwd.cu``), which also takes
  f32 q, k, v; in bf16, non-causal, K2 at d = 64, 72 and 80 (at 64 an
  odd head count: the UNet's 5-head level) and K4 at d = 72 and 80 launch
  the persistent Hopper kernel of ``csrc/flash_fwd_sm90.cu`` (K4 with its
  key mask packed into bit words as ``_mask_words`` does), and K2 and K4
  at d = 128 without the LSE launch K3's kernel there, with its online max
  and the key mask (StepVideo, Mochi); in f32 at d = 128
  without a key mask (LLaMA's causal K2) ``csrc/flash_fwd_f32_sm90.cu``
  (split key ranges, a cp.async ring, three bf16 products a product);
- K5 (the training forward with the LSE): ``flash_fwd`` with ``emit_lse``,
  on the same two kernels as K2 (in bf16 at d = 64 the persistent kernel:
  the UNet's 5-head level and its short cross-attention), and in bf16 at
  d = 128 under the fixed max on K3's Hopper kernel, which writes the LSE
  too;
- K7 (d=64 single-pass backward) and its two-kernel baseline K10:
  ``flash_bwd``, launching in bf16 the Hopper kernel
  ``csrc/flash_bwd_sm90.cu`` (single pass, TMA, wgmma), over keys that fit
  one tile the short-row kernel below;
- K8 (generic and masked single-pass backward, d ≤ 256) and its two-kernel
  baseline K9: ``flash_bwd``, launching in bf16 at d = 72 and 80,
  non-causal, the short-row Hopper kernel ``csrc/flash_bwd_rows_sm90.cu``
  (single pass, persistent, the key mask as bit words), in bf16 at d = 64
  and 128, non-causal and unmasked, K7's kernel ``csrc/flash_bwd_sm90.cu``
  at that width (at d = 64 over keys that fit one tile the short-row
  kernel: ``_bwd_kernel``), else ``csrc/flash_bwd.cu``;
- K3 (d ≤ 128 non-causal fixed max, the qk-normed denoisers' sampling
  forward): ``flash_fwd`` with ``static_max``, counted as K3; at d = 64,
  72, 80 and 128 in bf16 it launches ``csrc/flash_fwd_sm90.cu`` (TMA,
  wgmma, warp-specialised: the persistent kernel at 64, 72 and 80, K3's
  own kernel at 128), at other widths ``flash_fwd.cu``.

Which kernel a route launches is a function of the route, the dtype, the
head width and the options (``_fwd_design``, ``_bwd_design``), decided
before the launch; ``flash_fwd.launches_sm90`` and
``flash_bwd.launches_sm90`` count the Hopper kernels' launches,
``launches_d128`` those of each at d = 128, ``flash_fwd.launches_f32``
the f32 design's and ``flash_fwd.launches_split`` the forward launches
whose plan (a function of the shape and the SM count) split the keys.

Under autograd (``torch.is_grad_enabled()`` and q, k or v requiring grad)
``dot_product_attention`` takes the custom VJPs: the forward kernel with
its LSE, and ``flash_bwd`` for the gradients.  Every wrapper runs its
kernel's plain version for a CPU tensor and launches the kernel, or raises,
for a CUDA tensor.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
import threading
from typing import NamedTuple, Optional, Tuple, Union

import torch

_NEG_INF = -1e30
_LOG2E = 1.4426950408889634
_DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float32: "f32"}

# TPU kernels of videotuna_tpu/kernels/attention.py that the forward dispatch
# can reach, with what each computes and where the port has it.
_KERNELS = {
    "K1": "d=64 non-causal flash forward (_flash_packed2t): "
          "flash_fwd route K1, csrc/flash_fwd_sm90.cu (persistent) in bf16, "
          "else csrc/flash_fwd.cu",
    "K2": "generic online-softmax flash forward (flash_attention): "
          "csrc/flash_fwd_sm90.cu at d=64, 72, 80 and 128 in bf16 "
          "(non-causal), "
          "csrc/flash_fwd_f32_sm90.cu in f32 at d=128 (LLaMA, causal), "
          "else csrc/flash_fwd.cu",
    "K3": "d<=128 non-causal fixed-max flash forward (_flash_t128): "
          "csrc/flash_fwd_sm90.cu at d=64, 72, 80 and 128 in bf16, else "
          "csrc/flash_fwd.cu (flash_fwd with static_max)",
    "K4": "kv_valid-masked flash forward (_flash_dynpad): "
          "csrc/flash_fwd_sm90.cu (persistent, key mask) at d=72 and 80 in "
          "bf16, K3's kernel with the key mask at d=128 in bf16 without the "
          "LSE, else csrc/flash_fwd.cu",
    "K5": "generic flash forward with the LSE (_flash_forward_lse): "
          "flash_fwd with emit_lse, csrc/flash_fwd_sm90.cu at d=64, 72 and "
          "80 in bf16 (non-causal) and at d=128 under the fixed max (K3's "
          "kernel), else csrc/flash_fwd.cu",
    "K6": "d=64 natural-layout packed forward (_flash_packed2): "
          "flash_fwd route K6, K1's kernel in online mode, its keys split "
          "into ranges at short query sides",
    "K7": "single-pass d=64 flash backward (_flash_bwd_packed2): "
          "csrc/flash_bwd_sm90.cu, csrc/flash_bwd_rows_sm90.cu over keys "
          "that fit one tile",
    "K8": "single-pass generic and kv_valid-masked flash backward "
          "(flash_attention_bwd): csrc/flash_bwd_rows_sm90.cu at d=72 and "
          "80 in bf16 (non-causal) and at d=64 over keys that fit one "
          "tile, csrc/flash_bwd_sm90.cu at d=64 and 128 in bf16 "
          "(non-causal, unmasked), else csrc/flash_bwd.cu",
    "K9": "two-kernel generic flash backward (flash_attention_bwd, "
          "single_pass=False): mapped onto K8's kernels",
    "K10": "two-kernel d=64 flash backward (_flash_bwd_packed2, "
           "single_pass=False): mapped onto K7's kernel "
           "(csrc/flash_bwd_sm90.cu) in bf16",
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

def _check_layout(name: str, q, k, v,
                  dtypes: Tuple[torch.dtype, ...] = (torch.bfloat16,),
                  check_aligned: bool = True) -> None:
    """What every flash kernel takes: (B,Sq,H,d) q and (B,Sk,H,d) k, v of
    one of ``dtypes`` on one device, read in place with 16-byte copies
    (``check_aligned=False`` where the caller copies what is not)."""
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if not (q.dtype == k.dtype == v.dtype and q.dtype in dtypes):
        names = "/".join(_DTYPE_NAMES[t] for t in dtypes)
        raise TypeError(f"{name} takes {names} q/k/v on CUDA, got "
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
        if check_aligned and not _aligned(t):
            raise ValueError(
                f"{arg} must have a contiguous head_dim, strides that are "
                "multiples of 16 bytes and a 16-byte aligned start")


def _aligned(t: torch.Tensor) -> bool:
    """16-byte copies of a (B, S, H, d) tensor: rows contiguous, row starts
    16-byte aligned."""
    per16 = 16 // t.element_size()
    sb, ss, sh, sd = t.stride()
    return (sd == 1 and sb % per16 == 0 and ss % per16 == 0
            and sh % per16 == 0 and t.data_ptr() % 16 == 0)


def _launch(source: str, symbol: str, argtypes, device: torch.device,
            *args) -> None:
    """Call the C entry ``symbol`` of ``source`` on ``device``'s current
    stream, with ``device`` made the current device for the call where it
    is not; the entry returns the launch's CUDA error, which raises here."""
    from videotuna_tpu_torch.kernels import load
    fn = getattr(load(source), symbol)   # ctypes keeps one object a symbol
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    current = torch.cuda.current_device()
    if device.index is None or device.index == current:
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(current))
    else:
        with torch.cuda.device(device):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed with CUDA error {rc}")


# ---------------------------------------------------------------------------
# K1-K6: the flash forward (generic, d=64, fixed max, kv_valid-masked)
# ---------------------------------------------------------------------------

def _valid_mask(sq: int, sk: int, causal: bool,
                kv_valid: Optional[torch.Tensor],
                device: torch.device) -> Optional[torch.Tensor]:
    """Bool mask of the (query, key) pairs that count, broadcastable to
    (B, H, Sq, Sk), or None when every pair does."""
    valid = None
    if causal:
        valid = torch.ones((sq, sk), dtype=torch.bool, device=device).tril()
    if kv_valid is not None:
        kv = kv_valid.bool()[:, None, None, :]
        valid = kv if valid is None else valid & kv
    return valid


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    sm_scale: float, causal: bool = False,
                    kv_valid: Optional[torch.Tensor] = None,
                    static_max: Optional[float] = None,
                    emit_lse: bool = False
                    ) -> Union[torch.Tensor,
                               Tuple[torch.Tensor, torch.Tensor]]:
    """Plain PyTorch version of K1-K6, the function ``flash_fwd``
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
    valid = _valid_mask(sq, sk, causal, kv_valid, q.device)
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
              emit_lse: bool = False, route: Optional[str] = None,
              mask_words: Optional[torch.Tensor] = None
              ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """K1-K6: flash attention forward for any head_dim ≤ 256.

    q (B, Sq, H, d), k and v (B, Sk, H, d) → o (B, Sq, H, d) in q's dtype,
    and with ``emit_lse`` the natural-log LSE, f32 (B, H, Sq).  Options:
    ``causal`` (top-left aligned), ``kv_valid`` (B, Sk) bool key mask of any
    pattern, ``static_max`` (fixed softmax max, log2 domain).

    On a CUDA tensor it launches a hand-written kernel and adds one to
    ``flash_fwd.launches[route]``: by default "K4" when a mask is given,
    else "K2"; ``flash_attention`` passes "K1" (d=64, even heads) and "K6"
    (``pack2=True``) and "K3" for its fixed-max route at d ≤ 128, the
    training forward "K1" or "K5".  The calls ``_fwd_design`` names "sm90"
    (bf16, non-causal: K1, K2, K5 and K6 at d = 64; K2, K3, K5 and the
    masked K4 at d = 72 or 80; K3 at d = 64 without the LSE; K3 and K5 at
    d = 128 under the fixed max, with or without the LSE; K2 and the
    masked K4 at d = 128 without the LSE) launch
    ``csrc/flash_fwd_sm90.cu`` and add one to
    ``flash_fwd.launches_sm90[route]``, at d = 128 (K3's kernel) also to
    ``flash_fwd.launches_d128[route]``; q, k or v that TMA cannot read in
    place is copied first and counted in ``flash_fwd.tma_copies``; the
    masked K4 there reads ``mask_words`` (``_mask_words_for`` of q and
    ``kv_valid``, packed by the caller) when given, else packs the mask in
    the same call.  The calls it names "f32" (f32 at d = 128, unmasked)
    launch ``csrc/flash_fwd_f32_sm90.cu`` and add one to
    ``flash_fwd.launches_f32[route]``.  On both, a call whose
    ``_fwd_split_plan`` cuts the keys into ranges also adds one to
    ``flash_fwd.launches_split[route]``.  Everything else launches
    ``csrc/flash_fwd.cu`` (bf16 or f32, d a multiple of 8; anything else
    raises).  On a CPU tensor it runs
    ``flash_fwd_plain``.  Replaces the TPU kernels
    ``_flash_kernel_packed2t`` / ``_flash_packed2t`` (K1,
    videotuna_tpu/kernels/attention.py:268, :449), ``_flash_kernel`` /
    ``flash_attention`` (K2, :78, :812), ``_flash_kernel_t128`` /
    ``_flash_t128`` (K3, :581, :648), ``_flash_kernel_dynpad`` /
    ``_flash_dynpad`` (K4, :970, :1059), ``_flash_fwd_lse_kernel`` /
    ``_flash_forward_lse`` (K5, :867, :933) and ``_flash_kernel_packed2`` /
    ``_flash_packed2`` (K6, :163, :525)."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, sm_scale=sm_scale, causal=causal,
                               kv_valid=kv_valid, static_max=static_max,
                               emit_lse=emit_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd: unsupported device {q.device}")
    route = route or ("K4" if kv_valid is not None else "K2")
    if route not in flash_fwd.launches:
        raise ValueError(f"flash_fwd: route must be one of "
                         f"{sorted(flash_fwd.launches)}, got {route}")
    if route == "K3" and static_max is None:
        raise ValueError("route K3 is the fixed-max route: give static_max")
    design = _fwd_design(route, q.dtype, q.shape[-1], causal, kv_valid,
                         emit_lse, static_max)
    if design == "mma":
        res = _flash_fwd_mma(q, k, v, sm_scale, causal, kv_valid, static_max,
                             emit_lse)
    else:
        plan = _fwd_plan(design, q, k, causal, kv_valid is not None)
        if design == "sm90":
            res = _flash_fwd_sm90(q, k, v, sm_scale, static_max, emit_lse,
                                  kv_valid, mask_words, splits=plan.splits)
            flash_fwd.launches_sm90[route] += 1
            if q.shape[-1] == 128:
                flash_fwd.launches_d128[route] += 1
        else:
            res = _flash_fwd_f32(q, k, v, sm_scale, causal, static_max,
                                 emit_lse)
            flash_fwd.launches_f32[route] += 1
        if plan.splits > 1:
            flash_fwd.launches_split[route] += 1
    flash_fwd.launches[route] += 1
    return res


def _check_mask(kv_valid: torch.Tensor, b: int, sk: int,
                device: torch.device) -> None:
    """Raise unless ``kv_valid`` is a (B, Sk) bool or uint8 mask on
    ``device``."""
    if kv_valid.shape != (b, sk) or kv_valid.device != device \
            or kv_valid.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"kv_valid must be a (B, Sk) = {(b, sk)} bool "
                         f"mask on {device}, got {tuple(kv_valid.shape)} "
                         f"{kv_valid.dtype} on {kv_valid.device}")


def _flash_fwd_mma(q, k, v, sm_scale: float, causal: bool,
                   kv_valid: Optional[torch.Tensor],
                   static_max: Optional[float], emit_lse: bool
                   ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Launch ``csrc/flash_fwd.cu`` (mma.sync, any d ≤ 256 a multiple of 8,
    bf16 or f32, causal and key mask); counts nothing."""
    _check_layout("flash_fwd", q, k, v, (torch.bfloat16, torch.float32))
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if d > 256 or d % 8:
        raise ValueError(f"flash_fwd takes head_dim ≤ 256 and a multiple of "
                         f"8, got {d}")
    if -(-sq // 64) > 65535:
        raise ValueError("Sq above 64·65535 exceeds the launch grid")
    mask = None
    if kv_valid is not None:
        _check_mask(kv_valid, b, sk, q.device)
        mask = kv_valid.contiguous()
        if mask.dtype == torch.bool:
            mask = mask.view(torch.uint8)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if emit_lse else None)
    symbol = "flash_fwd_f32" if q.dtype == torch.float32 else "flash_fwd_bf16"
    _launch("flash_fwd.cu", symbol, _FWD_ARGTYPES, q.device,
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
    return (out, lse) if emit_lse else out


flash_fwd.launches = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0, "K6": 0}
# the launches of the Hopper design (flash_fwd_sm90.cu), per route; they are
# counted in ``launches`` too
flash_fwd.launches_sm90 = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0,
                           "K6": 0}
# of those, the launches at d = 128 (K3's kernel), per route
flash_fwd.launches_d128 = dict(flash_fwd.launches_sm90)
# the launches of the f32 design (flash_fwd_f32_sm90.cu), per route
flash_fwd.launches_f32 = dict(flash_fwd.launches_sm90)
# the launches of the Hopper designs whose plan split a query tile's keys
# into ranges (``_fwd_split_plan``), per route
flash_fwd.launches_split = dict(flash_fwd.launches_sm90)
# q, k or v copied because TMA could not read it in place
flash_fwd.tma_copies = 0


def _fwd_design(route: str, dtype: torch.dtype, d: int, causal: bool,
                kv_valid: Optional[torch.Tensor], emit_lse: bool,
                static_max: Optional[float]) -> str:
    """Which forward kernel a CUDA call launches, from its route, dtype,
    width and options alone: "sm90" (``csrc/flash_fwd_sm90.cu``: TMA,
    wgmma, warp-specialised) for bf16 non-causal calls of K1, K2, K5 and
    K6 at d = 64, of K2, K3, K5 and the masked K4 at d = 72 or 80 (the
    persistent kernel: online or fixed max, with or without the LSE), of
    the fixed-max route K3 without the LSE at d = 64 (the persistent
    kernel), and at d = 128 (K3's kernel) of the fixed-max routes K3 and K5
    with or without the LSE, of K2 without the LSE (the online max:
    StepVideo's self-attention) and of the masked K4 without the LSE under
    either max (StepVideo's cross-attention, Mochi's joint attention);
    "f32" (``csrc/flash_fwd_f32_sm90.cu``: split key ranges, a cp.async
    ring, three bf16 products a product) for f32 calls
    at d = 128 without a key mask, causal or not, online or fixed max,
    with or without the LSE (LLaMA's K2); "mma" (``csrc/flash_fwd.cu``)
    for everything else."""
    if dtype == torch.float32:
        return "f32" if d == 128 and kv_valid is None else "mma"
    if dtype != torch.bfloat16 or causal:
        return "mma"
    if kv_valid is not None:
        return ("sm90" if route == "K4" and (d in (72, 80)
                                             or d == 128 and not emit_lse)
                else "mma")
    if d == 64 and route in ("K1", "K2", "K5", "K6"):
        return "sm90"
    if d in (72, 80) and route in ("K2", "K3", "K5"):
        return "sm90"
    if d == 128 and route == "K2" and not emit_lse:
        return "sm90"
    if static_max is None:
        return "mma"
    if d == 128 and route in ("K3", "K5"):
        return "sm90"
    if d == 64 and route == "K3" and not emit_lse:
        return "sm90"
    return "mma"


def _tma_ready(t: torch.Tensor, wrapper=None) -> torch.Tensor:
    """``t`` itself when TMA can read it in place (16-byte aligned start,
    contiguous head_dim, strides multiples of 16 bytes), else a contiguous
    copy, counted in ``wrapper.tma_copies`` (``flash_fwd``'s by default)."""
    if _aligned(t):
        return t
    (wrapper or flash_fwd).tma_copies += 1
    return t.contiguous()


def _mask_words(kv_valid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the key mask's packing, which the persistent
    kernel's call does on the card (``pack_mask_kernel`` in
    ``csrc/flash_fwd_sm90.cu``): (B, Sk) bool or uint8 → (B, 4·⌈Sk/128⌉)
    int32, four words a 128-key tile; bit c of word w is key 32·w + c
    (1 = valid), and the bits past Sk are 0."""
    b, sk = kv_valid.shape
    n = -(-sk // 128) * 128
    bits = torch.nn.functional.pad((kv_valid != 0).to(torch.int32),
                                   (0, n - sk))
    # 2**c for c < 31 and -2**31 for bit 31: their int32 sum is the word
    weights = torch.tensor([1 << c for c in range(31)] + [-(1 << 31)],
                           dtype=torch.int32, device=kv_valid.device)
    return (bits.view(b, n // 32, 32) * weights).sum(-1, dtype=torch.int32)


_PACK_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                  ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _pack_mask_words(kv_valid: torch.Tensor, b: int,
                     sk: int) -> torch.Tensor:
    """The key mask's bit words in ``_mask_words``' layout, which the
    persistent forward (K4) and the short-row backward (K8) read: on the
    card packed by ``pack_mask_kernel`` (``csrc/flash_fwd_sm90.cu``, one
    launch), on the CPU by ``_mask_words``.  A training forward packs them
    once and hands them to its backward."""
    _check_mask(kv_valid, b, sk, kv_valid.device)
    if kv_valid.device.type == "cpu":
        return _mask_words(kv_valid)
    mask = kv_valid if kv_valid.stride(1) == 1 else kv_valid.contiguous()
    if mask.dtype == torch.bool:
        mask = mask.view(torch.uint8)
    words = torch.empty((b, 4 * -(-sk // 128)), dtype=torch.int32,
                        device=mask.device)
    _launch("flash_fwd_sm90.cu", "pack_mask_words", _PACK_ARGTYPES,
            mask.device, mask.data_ptr(), mask.stride(0), words.data_ptr(),
            b, sk)
    return words


def _mask_words_for(q: torch.Tensor, kv_valid: Optional[torch.Tensor]
                    ) -> Optional[torch.Tensor]:
    """The bit words of ``kv_valid`` where a masked call on ``q`` runs the
    Hopper designs, which read them (K4's forward and K8's backward agree
    on which calls those are: CUDA, bf16, d = 72 or 80), packed once by
    ``_pack_mask_words`` for the caller to hand to both; else None."""
    if kv_valid is None or q.device.type != "cuda" or _bwd_design(
            "K8", q.dtype, q.shape[-1], False, True) != "sm90":
        return None
    return _pack_mask_words(kv_valid, q.shape[0], kv_valid.shape[1])


def _check_words(words: torch.Tensor, b: int, sk: int,
                 device: torch.device) -> None:
    """Raise unless ``words`` is the (B, 4·⌈Sk/128⌉) int32 word tensor of a
    (B, Sk) key mask, contiguous on ``device``."""
    shape = (b, 4 * -(-sk // 128))
    if words.shape != shape or words.dtype != torch.int32 \
            or words.device != device or not words.is_contiguous():
        raise ValueError(f"mask_words must be contiguous int32 {shape} on "
                         f"{device}, got {words.dtype} "
                         f"{tuple(words.shape)} on {words.device}")


_FWD_SM90_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong,
                                                ctypes.c_void_p]
                      + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 12
                      + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                         ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])


def _flash_fwd_sm90(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: float, static_max: Optional[float],
                    emit_lse: bool, kv_valid: Optional[torch.Tensor] = None,
                    words: Optional[torch.Tensor] = None,
                    splits: Optional[int] = None
                    ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Launch ``csrc/flash_fwd_sm90.cu``, bf16, non-causal: the persistent
    kernel (online or fixed max, with or without the LSE) at d = 64, 72 or
    80 (at 72 and 80 with the key mask ``kv_valid`` too: its ``words`` when
    given, else packed by the same call); K3's kernel at d = 128: the fixed
    max with or without the LSE, the online max, the key mask under either
    max.  ``splits``, the key ranges of each query
    tile, defaults to ``_fwd_split_plan``'s; above 1 the persistent kernel
    writes f32 partials (B·H·⌈Sq/128⌉·splits·128·(D + 2) floats, D = 64 or
    80) that the same call combines (1 is the unsplit walk)."""
    _check_layout("flash_fwd", q, k, v, check_aligned=False)
    q, k, v = (_tma_ready(x) for x in (q, k, v))
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if splits is None:
        splits = _fwd_plan("sm90", q, k, False, kv_valid is not None).splits
    part = None
    if splits > 1:
        part = torch.empty(b * h * -(-sq // 128) * splits * 128
                           * ((64 if d == 64 else 80) + 2),
                           dtype=torch.float32, device=q.device)
    if d == 128:
        if b * h > 65535:
            raise ValueError("B·H above 65535 exceeds the launch grid")
    if (static_max is None or kv_valid is not None) and not sm_scale > 0:
        raise ValueError(f"the online softmax and the key mask take "
                         f"sm_scale > 0, got {sm_scale}")
    mask = None
    if kv_valid is not None:
        _check_mask(kv_valid, b, sk, q.device)
        if words is not None:
            _check_words(words, b, sk, q.device)
        else:   # packed into ``words`` by the same call
            mask = (kv_valid if kv_valid.stride(1) == 1
                    else kv_valid.contiguous())
            if mask.dtype == torch.bool:
                mask = mask.view(torch.uint8)
            words = torch.empty((b, 4 * -(-sk // 128)), dtype=torch.int32,
                                device=q.device)
    else:
        words = None
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if emit_lse else None)
    _launch("flash_fwd_sm90.cu", "flash_fwd_sm90_bf16",
            _FWD_SM90_ARGTYPES, q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            mask.data_ptr() if mask is not None else None,
            mask.stride(0) if mask is not None else 0,
            words.data_ptr() if words is not None else None,
            b, h, sq, sk, d, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *out.stride()[:3],
            float(sm_scale * _LOG2E), int(static_max is None),
            float(static_max or 0.0), splits,
            part.data_ptr() if part is not None else None)
    return (out, lse) if emit_lse else out


_FWD_F32_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p]
                     + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 12
                     + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                        ctypes.c_float, ctypes.c_void_p])


def _flash_fwd_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   sm_scale: float, causal: bool,
                   static_max: Optional[float], emit_lse: bool
                   ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Launch ``csrc/flash_fwd_f32_sm90.cu``: f32 q, k, v at d = 128,
    causal or not, online or fixed max, with or without the LSE, on the
    units of ``_fwd_split_plan("f32", …)`` (their tables on the device,
    made once a shape); f32 scratch for the partials of split query tiles
    (B·H·slots·64·130 floats: 7.5 MB at LLaMA's shape), which the same
    call combines.  Counts nothing."""
    _check_layout("flash_fwd", q, k, v, (torch.float32,))
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if d != 128:
        raise ValueError(f"the f32 design takes head_dim 128, got {d}")
    if b * h > 65535:
        raise ValueError("B·H above 65535 exceeds the launch grid")
    units, combine, slots = _f32_tables(b, h, sq, sk, causal,
                                        _sm_count(q.device), q.device)
    part = (torch.empty(b * h * slots * 64 * 130, dtype=torch.float32,
                        device=q.device) if slots else None)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if emit_lse else None)
    _launch("flash_fwd_f32_sm90.cu", "flash_fwd_f32_sm90", _FWD_F32_ARGTYPES,
            q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr() if lse is not None else None,
            part.data_ptr() if part is not None else None,
            units.data_ptr(), units.shape[0],
            combine.data_ptr() if combine is not None else None,
            combine.shape[0] if combine is not None else 0, slots,
            b, h, sq, sk, d, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *out.stride()[:3],
            float(sm_scale * _LOG2E), int(causal), int(static_max is None),
            float(static_max or 0.0))
    return (out, lse) if emit_lse else out


# ---------------------------------------------------------------------------
# K7 / K8 (and K9 / K10 by mapping): flash backward
# ---------------------------------------------------------------------------

def flash_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
                    *, sm_scale: float, causal: bool = False,
                    kv_valid: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the flash backward, the function
    ``flash_bwd`` computes.

    In f32: s = (q·k)·sm_scale·log2e, −inf where the key is masked (above
    the top-left causal diagonal or where ``kv_valid`` is False);
    p = exp2(s − lse·log2e) with lse (B, H, Sq) clamped at −1e5, so a row
    with no valid key gets p = 0; δ = rowsum(dO·o); dv = pᵀ dO;
    ds = p (dO vᵀ − δ); dq = sm_scale·ds k; dk = sm_scale·dsᵀ q.  Outputs
    in q's, k's and v's dtypes, (B, S, H, D)."""
    sq, sk = q.shape[1], k.shape[1]
    qf, kf, vf = q.float(), k.float(), v.float()
    dof = dout.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * (sm_scale * _LOG2E)
    valid = _valid_mask(sq, sk, causal, kv_valid, q.device)
    if valid is not None:
        s = s.masked_fill(~valid, float("-inf"))
    p = torch.exp2(s - (lse.float().clamp_min(-1e5) * _LOG2E)[..., None])
    delta = (dof * out.float()).sum(dim=-1).transpose(1, 2)   # (B, H, Sq)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * sm_scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * sm_scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_route(h: int, d: int, causal: bool,
               kv_valid: Optional[torch.Tensor], single_pass: bool) -> str:
    """The TPU backward kernel a call stands for: the packed d=64 kernels
    (K7, or K10 under ``single_pass=False``) for d=64, even heads,
    non-causal and unmasked; the generic ones (K8, K9) otherwise."""
    packed = d == 64 and h % 2 == 0 and not causal and kv_valid is None
    if single_pass:
        return "K7" if packed else "K8"
    return "K10" if packed else "K9"


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor, *,
              sm_scale: float, causal: bool = False,
              kv_valid: Optional[torch.Tensor] = None,
              mask_words: Optional[torch.Tensor] = None,
              single_pass: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K7-K10: flash attention backward, dq, dk, dv from q, k, v, the
    forward's output ``out``, its gradient ``dout`` and the natural-log
    ``lse`` (B, H, Sq, f32) that the forward wrote.

    On a CUDA tensor it launches hand-written kernels (bf16, d ≤ 256 and a
    multiple of 8; anything else raises) and adds one to
    ``flash_bwd.launches[route]``: "K7" for d=64, even heads, non-causal
    and unmasked, "K8" otherwise, and under ``single_pass=False`` "K10" and
    "K9" for the same two cases, whose two-kernel TPU baselines compute the
    same function.  The calls ``_bwd_design`` names "sm90" add one to
    ``flash_bwd.launches_sm90[route]``, and run the Hopper kernel that
    ``_bwd_kernel`` names from the width and key length: K7 and K10 run
    the single-pass ``csrc/flash_bwd_sm90.cu``, and so do K8 and K9 in bf16
    at d = 64 and 128, non-causal and unmasked (at 128 counted in
    ``flash_bwd.launches_d128`` too), but at d = 64 over keys that fit one
    128-key tile; those, and K8 and K9 in bf16 at d = 72 or 80, non-causal,
    with or without ``kv_valid``, run the short-row
    ``csrc/flash_bwd_rows_sm90.cu`` (counted in
    ``flash_bwd.launches_rows`` too), which
    reads the key mask as ``mask_words`` (``_pack_mask_words`` of
    ``kv_valid``, as the masked training forward packed them) or packs it
    first.  On both Hopper designs tensors TMA cannot read in place are
    copied first, counted in ``flash_bwd.tma_copies``.  Everything else
    runs ``csrc/flash_bwd.cu``.  On a CPU tensor it runs
    ``flash_bwd_plain``.  Replaces ``_flash_bwd_packed2`` (K7,
    videotuna_tpu/kernels/attention.py :1424, :1517; K10 :1260, :1343) and
    ``flash_attention_bwd`` (K8 :1148, :1725; K9 :1107, :1197)."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, out, dout, lse, sm_scale=sm_scale,
                               causal=causal, kv_valid=kv_valid)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd: unsupported device {q.device}")
    _check_layout("flash_bwd", q, k, v, check_aligned=False)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if out.shape != q.shape or dout.shape != q.shape \
            or out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError("out and dout must have q's shape and dtype")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be f32 {(b, h, sq)}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if kv_valid is not None:
        _check_mask(kv_valid, b, sk, q.device)
    elif mask_words is not None:
        raise ValueError("mask_words without kv_valid")
    route = _bwd_route(h, d, causal, kv_valid, single_pass)
    lse = lse.contiguous()
    if _bwd_design(route, q.dtype, d, causal, kv_valid is not None) \
            == "mma":
        res = _flash_bwd_mma(q, k, v, out, dout, lse, sm_scale, causal,
                             kv_valid)
    elif _bwd_kernel(d, sk) == "sm90":
        res = _flash_bwd_sm90(q, k, v, out, dout, lse, sm_scale)
        flash_bwd.launches_sm90[route] += 1
        if d == 128:
            flash_bwd.launches_d128[route] += 1
    else:
        if kv_valid is not None and mask_words is None:
            mask_words = _pack_mask_words(kv_valid, b, sk)
        res = _flash_bwd_rows(q, k, v, out, dout, lse, sm_scale, mask_words)
        flash_bwd.launches_sm90[route] += 1
        flash_bwd.launches_rows[route] += 1
    flash_bwd.launches[route] += 1
    return res


flash_bwd.launches = {"K7": 0, "K8": 0, "K9": 0, "K10": 0}
# the launches of the Hopper designs (flash_bwd_sm90.cu for K7 and K10,
# flash_bwd_rows_sm90.cu for K8 and K9), per route; counted in ``launches``
# too
flash_bwd.launches_sm90 = {"K7": 0, "K8": 0, "K9": 0, "K10": 0}
# of those, the launches at d = 128 (flash_bwd_sm90.cu's width 128), per
# route
flash_bwd.launches_d128 = dict(flash_bwd.launches_sm90)
# of those, the launches of the short-row kernel (flash_bwd_rows_sm90.cu),
# per route
flash_bwd.launches_rows = dict(flash_bwd.launches_sm90)
# q, k, v, out or dout copied because TMA could not read it in place
flash_bwd.tma_copies = 0


def _bwd_design(route: str, dtype: torch.dtype, d: int, causal: bool,
                masked: bool) -> str:
    """Which backward kernel a CUDA call launches, from its route, dtype,
    width and options alone: "sm90" for bf16 non-causal calls of K7 and
    K10 (d=64, unmasked: ``csrc/flash_bwd_sm90.cu``), of K8 and K9 at
    d = 72 or 80, masked or not (``csrc/flash_bwd_rows_sm90.cu``), and of
    K8 and K9 at d = 64 or 128, unmasked (``csrc/flash_bwd_sm90.cu``: at
    64 the UNet's 5-head level), a d = 64 call over one key tile on the
    short-row kernel (``_bwd_kernel``); "mma" (``csrc/flash_bwd.cu``) for
    everything else."""
    if dtype != torch.bfloat16 or causal:
        return "mma"
    if route in ("K7", "K10"):
        return "sm90" if d == 64 and not masked else "mma"
    if d in (64, 128):
        return "mma" if masked else "sm90"
    return "sm90" if d in (72, 80) else "mma"


def _bwd_kernel(d: int, sk: int) -> str:
    """Which Hopper backward a call that ``_bwd_design`` names "sm90"
    launches, from its width and key length alone: the short-row
    ``csrc/flash_bwd_rows_sm90.cu`` ("rows") at d = 72 and 80, and at
    d = 64 when the keys fit one 128-key tile (the UNet's cross-attention
    over 77 text keys, where it beat ``flash_bwd_sm90`` at two of the
    three shapes and over a training step's calls together, PERF.md);
    ``csrc/flash_bwd_sm90.cu`` ("sm90") otherwise."""
    if d in (72, 80) or (d == 64 and sk <= 128):
        return "rows"
    return "sm90"


_BWD_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                 + [ctypes.c_longlong] * 24
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _flash_bwd_mma(q, k, v, out, dout, lse, sm_scale: float,
                   causal: bool = False,
                   kv_valid: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch ``csrc/flash_bwd.cu`` (mma.sync, two passes: any d ≤ 256 a
    multiple of 8, causal and key mask) → dq, dk, dv; counts nothing.  The
    design of every call ``_bwd_design`` names "mma", and the A/B baseline
    of the Hopper designs."""
    _check_layout("flash_bwd", q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if d > 256 or d % 8:
        raise ValueError(f"flash_bwd takes head_dim ≤ 256 and a multiple of "
                         f"8, got {d}")
    if -(-max(sq, sk) // 64) > 65535:
        raise ValueError("S above 64·65535 exceeds the launch grid")
    out = out if _aligned(out) else out.contiguous()
    dout = dout if _aligned(dout) else dout.contiguous()
    mask = None
    if kv_valid is not None:
        mask = kv_valid.bool().contiguous().view(torch.uint8)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    strides = [x.stride(i) for x in (q, k, v, out, dout, dq, dk, dv)
               for i in range(3)]
    _launch("flash_bwd.cu", "flash_bwd_bf16", _BWD_ARGTYPES, q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            mask.data_ptr() if mask is not None else None,
            b, h, sq, sk, d, *strides, float(sm_scale), int(causal))
    return dq, dk, dv


_BWD_SM90_ARGTYPES = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
                      + [ctypes.c_longlong] * 24
                      + [ctypes.c_float, ctypes.c_void_p])


def _flash_bwd_sm90(q, k, v, out, dout, lse, sm_scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch ``csrc/flash_bwd_sm90.cu`` (bf16, non-causal, unmasked: K7
    and K10 at d = 64, K8 and K9 at d = 64 and 128) → dq, dk, dv, with
    its f32 scratch: lse2 and delta rows padded to 64 queries, and the
    zeroed dq accumulator (B·H, Sq_pad, d): 92 MB at HunyuanVideo's
    training shape,
    freed when the call returns.  q, k, v, out or dout that TMA (or the
    prep kernel's 16-byte loads) cannot read in place is copied first."""
    q, k, v, out, dout = (_tma_ready(x, flash_bwd)
                          for x in (q, k, v, out, dout))
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if b * h > 65535:
        raise ValueError("B·H above 65535 exceeds the launch grid")
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, h, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    sq_pad = -(-sq // 64) * 64
    lse2 = torch.empty((b * h, sq_pad), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse2)
    dq_acc = torch.zeros((b * h, sq_pad, d), dtype=torch.float32,
                         device=q.device)
    strides = [x.stride(i) for x in (q, k, v, out, dout, dq, dk, dv)
               for i in range(3)]
    _launch("flash_bwd_sm90.cu", "flash_bwd_sm90_bf16",
            _BWD_SM90_ARGTYPES, q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), lse2.data_ptr(),
            delta.data_ptr(), dq_acc.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, h, sq, sk, d, *strides,
            float(sm_scale))
    return dq, dk, dv


# the short-row backward (csrc/flash_bwd_rows_sm90.cu): query tiles of 64,
# key tiles of 128; a unit keeps dQ in shared memory over at most
# _ROWS_HEAD_M_MAX query tiles, and a head's queries split into at most
# _ROWS_CHUNKS_MAX units when its keys fit one tile
_ROWS_HEAD_M_MAX = 4
_ROWS_CHUNKS_MAX = 8
_SMS = {}   # SM count per device index


def _sm_count(device: torch.device) -> int:
    """The SM count of a CUDA ``device``, asked once a device."""
    dev = device.index if device.index is not None \
        else torch.cuda.current_device()
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SMS[dev]


@functools.lru_cache(maxsize=None)
def _bwd_rows_plan(bh: int, sq: int, sk: int, sms: int) -> Tuple[bool, int]:
    """(atomic, unit_m) of a short-row backward of ``bh`` heads on ``sms``
    SMs.  Keys in one 128-key tile: rows mode, a head's ⌈Sq/64⌉ query
    tiles split into units of ``unit_m`` (1, 2, 4 or 8 units a head: the
    split whose busiest SM walks the fewest query tiles, the fewest units
    on a tie); several key tiles and at most ``_ROWS_HEAD_M_MAX`` query
    tiles: rows mode, one unit a head; otherwise the atomic mode (a unit a
    key tile, dq summed by atomics)."""
    m_tiles = -(-sq // 64)
    if -(-sk // 128) > 1:
        return m_tiles > _ROWS_HEAD_M_MAX, m_tiles
    best = None
    chunks = 1
    while chunks <= min(_ROWS_CHUNKS_MAX, m_tiles):
        unit_m = -(-m_tiles // chunks)
        span = -(-bh * -(-m_tiles // unit_m) // sms) * unit_m
        if best is None or span < best[0]:
            best = (span, unit_m)
        chunks *= 2
    return False, best[1]


# The split-key forward, per design: (query rows a tile, keys a tile, blocks
# resident on an SM, fewest key tiles a range).  "sm90": the persistent
# kernel, one block an SM; "f32": flash_fwd_f32_sm90.cu, two blocks an SM
# (its register budget).
_SPLIT_TILING = {"sm90": (128, 128, 1, 4), "f32": (64, 32, 2, 1)}


class _FwdPlan(NamedTuple):
    """Work units of a forward: query tile i of every head runs one unit per
    key-tile range [t0, t1) of ``ranges[i]``, in the order the combine sums
    them; ``splits`` is the most ranges of one tile (1: nothing split)."""
    block_m: int
    block_n: int
    ranges: Tuple[Tuple[Tuple[int, int], ...], ...]
    splits: int


@functools.lru_cache(maxsize=None)
def _fwd_split_plan(design: str, b: int, h: int, sq: int, sk: int, d: int,
                    causal: bool, masked: bool, sms: int) -> _FwdPlan:
    """The units of a Hopper forward (``design`` "sm90" or "f32") of
    ``b``·``h`` heads, ``sq`` queries over ``sk`` keys, on ``sms`` SMs.

    Query tile i meets n_i key tiles: all of them, or under ``causal`` those
    up to its last row.  A tile stays one unit (a range of all n_i tiles)
    unless the unsplit units, ``b``·``h``·⌈sq/block_m⌉, cannot fill the
    card's resident blocks and some tile meets at least twice the fewest
    key tiles a range may hold.  Then every tile's keys are cut into
    ⌈n_i / L⌉ ranges of near-equal length (range j of r is
    [j·n_i // r, (j+1)·n_i // r), as ``csrc/flash_fwd_sm90.cu``'s
    ``unit_of`` cuts them), L the shortest range length from that fewest
    up whose units fit the resident blocks at once; when none fits, nothing
    is split.  K3's kernel (``sm90`` at d = 128) and the key mask (K4)
    are never split."""
    block_m, block_n, per_sm, fewest = _SPLIT_TILING[design]
    m_tiles, n_tiles = -(-sq // block_m), -(-sk // block_n)
    counts = [min(n_tiles, -(-min((i + 1) * block_m, sq) // block_n))
              if causal else n_tiles for i in range(m_tiles)]
    whole = _FwdPlan(block_m, block_n, tuple(((0, n),) for n in counts), 1)
    slots = per_sm * sms
    if (design == "sm90" and (d == 128 or masked)) \
            or b * h * m_tiles >= slots or max(counts) < 2 * fewest:
        return whole
    for span in range(fewest, max(counts)):
        if b * h * sum(-(-n // span) for n in counts) <= slots:
            break
    else:
        return whole
    ranges = tuple(tuple((j * n // r, (j + 1) * n // r) for j in range(r))
                   for n, r in ((n, -(-n // span)) for n in counts))
    return _FwdPlan(block_m, block_n, ranges, max(len(x) for x in ranges))


def _fwd_plan(design: str, q: torch.Tensor, k: torch.Tensor, causal: bool,
              masked: bool) -> _FwdPlan:
    """``_fwd_split_plan`` of a CUDA call on q (B, Sq, H, d), k (B, Sk, …)."""
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError("q, k, v must be (B, S, H, D)")
    b, sq, h, d = q.shape
    return _fwd_split_plan(design, b, h, sq, k.shape[1], d, causal, masked,
                           _sm_count(q.device))


@functools.lru_cache(maxsize=None)
def _f32_tables(b: int, h: int, sq: int, sk: int, causal: bool, sms: int,
                device: torch.device):
    """The f32 design's plan as the kernel reads it, on ``device``: (units,
    combine, slots).  units: int32 (n, 4) rows (query tile, first key tile,
    end key tile, partial slot or −1 for a tile of one range), run for every
    head; combine: int32 rows (query tile, first slot, ranges, 0) of the
    split tiles, or None; slots: partial slots a head."""
    plan = _fwd_split_plan("f32", b, h, sq, sk, 128, causal, False, sms)
    units, combine = [], []
    slots = 0
    for qt, ranges in enumerate(plan.ranges):
        split = len(ranges) > 1
        if split:
            combine.append((qt, slots, len(ranges), 0))
        for t0, t1 in ranges:
            units.append((qt, t0, t1, slots if split else -1))
            slots += split
    as_dev = lambda rows: torch.tensor(rows, dtype=torch.int32,
                                       device=device) if rows else None
    return as_dev(units), as_dev(combine), slots


def flash_fwd_split_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, sm_scale: float, plan: _FwdPlan,
                          causal: bool = False,
                          static_max: Optional[float] = None,
                          emit_lse: bool = False
                          ) -> Union[torch.Tensor,
                                     Tuple[torch.Tensor, torch.Tensor]]:
    """Plain PyTorch version of the split-key forward, the function of
    ``flash_fwd_plain`` computed as the Hopper designs compute it on
    ``plan``: each unit's partials over its key range (o unnormalised, m
    the fixed max or the range's row max, −inf where the range holds no
    valid key of the row, l = Σp, p rounded to ``v.dtype`` for PV), then
    the combine of ``csrc/split_combine.cuh``: m = max m_j, w_j =
    exp2(m_j − m) (1 under the fixed max), l = Σ w_j l_j, o = Σ w_j o_j / l,
    summed over j in order; o = 0 and lse = −inf where l = 0.  For the
    tests: no wrapper takes it."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = sm_scale * _LOG2E
    out = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, sq), float("-inf"), device=q.device)
    for qt, ranges in enumerate(plan.ranges):
        r0, r1 = qt * plan.block_m, min((qt + 1) * plan.block_m, sq)
        rows = torch.arange(r0, r1, device=q.device)
        parts = []
        for t0, t1 in ranges:
            k0, k1 = t0 * plan.block_n, min(t1 * plan.block_n, sk)
            s = torch.einsum("bqhd,bkhd->bhqk", q[:, r0:r1].float(),
                             k[:, k0:k1].float()) * scale
            if causal:
                keys = torch.arange(k0, k1, device=q.device)
                s = s.masked_fill(keys[None, :] > rows[:, None],
                                  float("-inf"))
            m = (s.amax(dim=-1) if static_max is None
                 else torch.full_like(s[..., 0], float(static_max)))
            p = torch.exp2(s - m.masked_fill(m == float("-inf"),
                                             0.0)[..., None])
            o = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(),
                             v[:, k0:k1].float())
            parts.append((m, p.sum(dim=-1), o))
        m = torch.stack([x[0] for x in parts]).amax(dim=0)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(parts[0][2])
        for mj, lj, oj in parts:
            w = (torch.ones_like(mj) if static_max is not None else
                 torch.where(mj == float("-inf"), 0.0, torch.exp2(mj - m)))
            l = l + w * lj
            acc = acc + w[..., None] * oj
        some = l > 0
        out[:, :, r0:r1] = torch.where(
            some[..., None], acc / l.clamp_min(1e-30)[..., None], 0.0)
        lse[:, :, r0:r1] = torch.where(
            some, (m + torch.log2(l.clamp_min(1e-30))) / _LOG2E,
            float("-inf"))
    out = out.to(q.dtype).permute(0, 2, 1, 3).contiguous()
    return (out, lse) if emit_lse else out


_BWD_ROWS_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                      + [ctypes.c_longlong] * 24
                      + [ctypes.c_float] + [ctypes.c_int] * 2
                      + [ctypes.c_void_p])


def _flash_bwd_rows(q, k, v, out, dout, lse, sm_scale: float,
                    words: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch ``csrc/flash_bwd_rows_sm90.cu`` (K8 and K9: bf16, d = 72 or
    80, non-causal, the key mask as its ``words`` or none; K7 and K8 at
    d = 64, unmasked, over one key tile) → dq, dk, dv,
    on the plan of ``_bwd_rows_plan``.  Scratch only for the atomic mode
    (a zeroed f32 dq accumulator) and for a head split into several units
    (their f32 dK, dV partials, which a second launch sums: 10 MB at STDiT's
    cross shape); none at the spatial shape."""
    q, k, v, out, dout = (_tma_ready(x, flash_bwd)
                          for x in (q, k, v, out, dout))
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if words is not None:
        _check_words(words, b, sk, q.device)
    atomic, unit_m = _bwd_rows_plan(b * h, sq, sk, _sm_count(q.device))
    m_tiles = -(-sq // 64)
    chunks = -(-m_tiles // unit_m)
    scratch = None
    if atomic:
        scratch = torch.zeros((b * h, m_tiles * 64, 80),
                              dtype=torch.float32, device=q.device)
    elif chunks > 1:
        scratch = torch.empty((b * h * chunks, 2 * 2 * 40 * 128),
                              dtype=torch.float32, device=q.device)
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, h, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    _launch("flash_bwd_rows_sm90.cu", "flash_bwd_rows_sm90_bf16",
            _BWD_ROWS_ARGTYPES, q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(),
            words.data_ptr() if words is not None else None,
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            b, h, sq, sk, d, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *out.stride()[:3], *dout.stride()[:3],
            *dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3],
            float(sm_scale), int(atomic), unit_m)
    return dq, dk, dv


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
    non-causal) → K1, and ``pack2=True`` → K6, K1's function in online
    mode; a fixed max at d ≤ 128 with ≥ 128 queries and keys → K3;
    everything else → K2.  Every route is a route of ``flash_fwd``."""
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
        return flash_fwd(q, k, v, sm_scale=sm_scale, static_max=static_max,
                         route="K1" if pack2 == "t" else "K6")
    route = None
    if static_max is not None:
        if causal:
            raise ValueError("static_max: non-causal only")
        # the TPU pads head_dim to 128 lanes there, so every d ≤ 128 with a
        # fixed max takes the d=128 kernel
        if d <= 128 and sq >= 128 and sk >= 128:
            route = "K3"
    return flash_fwd(q, k, v, sm_scale=sm_scale, causal=causal,
                     static_max=static_max, route=route)


# ---------------------------------------------------------------------------
# Custom VJPs: the forward kernel with its LSE, the backward kernel
# ---------------------------------------------------------------------------

class _FlashAttentionDiff(torch.autograd.Function):
    """``flash_attention_diff``'s forward and backward (JAX ``_fa_fwd`` /
    ``_fa_bwd``, :1934-2008)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, static_max, fold_stats,
                single_pass):
        b, sq, h, d = q.shape
        sk = k.shape[1]
        sm_scale = (1.0 / math.sqrt(d)) if scale is None else scale
        k1 = (d == 64 and h % 2 == 0 and not causal and sq >= 128
              and sk >= 128)
        out, lse = flash_fwd(q, k, v, sm_scale=sm_scale, causal=causal,
                             static_max=static_max, emit_lse=True,
                             route="K1" if k1 else "K5")
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.sm_scale, ctx.causal = sm_scale, causal
        ctx.single_pass = single_pass
        return out

    @staticmethod
    def backward(ctx, dout):
        # static_max changes only how the forward accumulated; the LSE it
        # wrote is the true log-sum-exp, so the backward is the same
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, dout, lse,
                               sm_scale=ctx.sm_scale, causal=ctx.causal,
                               single_pass=ctx.single_pass)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_diff(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = False, scale: Optional[float] = None,
                         static_max: Optional[float] = None,
                         fold_stats: bool = True,
                         single_pass: bool = True) -> torch.Tensor:
    """Differentiable flash attention, q, k, v (B, S, H, D): the JAX
    package's ``flash_attention_diff`` (:1918).  Forward: ``flash_fwd``
    with its LSE, on route K1 for d=64, even heads, non-causal and ≥ 128
    queries and keys, else on route K5.  Each saves q, k, v, the
    output and the natural-log LSE (B, H, Sq, f32); the backward is
    ``flash_bwd`` (K7 / K8, or K10 / K9 with ``single_pass=False``).
    ``fold_stats`` selects a TPU packing variant of the d=64 backward; it is
    accepted and has no effect here."""
    return _FlashAttentionDiff.apply(q, k, v, causal, scale, static_max,
                                     fold_stats, single_pass)


class _FlashDiffMasked(torch.autograd.Function):
    """``_flash_diff_masked``'s forward and backward (JAX
    ``_fa_masked_fwd`` / ``_fa_masked_bwd``, :2011-2074)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_valid, scale, static_max):
        sm_scale = (1.0 / math.sqrt(q.shape[-1])) if scale is None else scale
        # the mask's bit words, packed once: read by the forward (K4) and
        # kept for the backward (K8)
        words = _mask_words_for(q, kv_valid)
        out, lse = flash_fwd(q, k, v, sm_scale=sm_scale, kv_valid=kv_valid,
                             static_max=static_max, emit_lse=True,
                             mask_words=words)
        ctx.save_for_backward(q, k, v, out, lse, kv_valid, words)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, kv_valid, words = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, dout, lse,
                               sm_scale=ctx.sm_scale, kv_valid=kv_valid,
                               mask_words=words)
        return dq, dk, dv, None, None, None


def _flash_diff_masked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       kv_valid: torch.Tensor, scale: Optional[float] = None,
                       static_max: Optional[float] = None) -> torch.Tensor:
    """Differentiable ``kv_valid``-masked flash attention (non-causal).
    The JAX package zeroes the masked k and v rows before its kernel and
    lets the caller's mask multiply zero their gradients; the port's
    forward (K4, with its LSE) masks with −inf, so the backward (K8 with the
    key mask) gives exactly 0 for masked keys' dk and dv by itself."""
    return _FlashDiffMasked.apply(q, k, v, kv_valid, scale, static_max)


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


def remat_contexts():
    """``context_fn`` of ``torch.utils.checkpoint`` for the models' remat:
    (the forward's context, the recompute's).  A checkpointed block is
    recomputed in the backward, for a CUDA tensor on autograd's own thread,
    where the forward's thread-local ``attention_options`` are not set, so
    the recompute would take the online softmax where the forward took the
    fixed max.  The recompute re-enters the options the forward ran under,
    and so computes what the forward did, as the JAX package's ``nn.remat``
    replays its traced forward."""
    cfg = getattr(_ATTN_OPTS, "cfg", None)
    return (contextlib.nullcontext(),
            attention_options(**cfg) if cfg else contextlib.nullcontext())


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
    apply.  When autograd records (grad enabled and q, k or v requiring
    grad) the flash routes run ``flash_attention_diff`` /
    ``_flash_diff_masked``, whose backward is a kernel too; otherwise they
    run the forward kernels alone."""
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
    # under autograd the flash routes take the custom VJPs
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    if kv_valid is not None:
        kv_valid = kv_valid.bool()
        if use_flash and not causal:
            if grad:
                out = _flash_diff_masked(q, k, v, kv_valid, scale,
                                         static_max)
            else:
                out = flash_attention(q, k, v, scale=scale,
                                      kv_valid=kv_valid,
                                      static_max=static_max)
            return out.reshape(orig_shape)
        kb = torch.where(kv_valid, 0.0, _NEG_INF)[:, None, None, :]
        bias = kb if bias is None else bias + kb
        out = reference_attention(q, k, v, bias=bias, causal=causal,
                                  scale=scale)
        return out.reshape(orig_shape)
    if use_flash and grad:
        out = flash_attention_diff(q, k, v, causal, scale, static_max)
    elif use_flash:
        out = flash_attention(q, k, v, causal=causal, scale=scale,
                              static_max=static_max)
    else:
        out = reference_attention(q, k, v, bias=bias, causal=causal,
                                  scale=scale)
    return out.reshape(orig_shape)
