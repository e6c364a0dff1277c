"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero
without a result line:

1. device     — the card's name and power limit (nvidia-smi).
2. build      — compiles every CUDA kernel of the port from kernels/csrc,
                one nvcc per source, all started together.
3. K1, K6     — the d=64 flash kernel against its plain PyTorch version on
                the card, at the CogVideoX-5B shape (B=2 with CFG, S=17776,
                H=48, bf16) in both softmax modes with the LSE, and at ragged
                shapes; K6 (``pack2=True``) through K1's kernel in online
                mode at one ragged shape, counted as K6.  Times the kernel,
                its plain version and torch's scaled_dot_product_attention
                (SDPA, a yardstick only: the port never calls it), and the
                generic kernel (flash_fwd) at K1's shape beside K1.
4. K2         — the generic flash kernel (flash_fwd.cu) against its plain
                version: the STDiT-XL/2 spatial shape (B=32, S=256, H=16,
                d=72, online), d=64 causal 333×333, d=72 1×64, d=128
                300×4322 and d=256 200×200 with a fixed max on LayerNormed
                q, k; every case with the LSE.  Timed at the STDiT shape.
5. K4         — the same kernel with a key mask at the STDiT-XL/2
                cross-attention shape (B=2, 4096 queries, 120 keys, H=16,
                d=72): row 0 keeps 13 keys (a prefix, then every 9th key),
                row 1 all 120, with the LSE; a row with no valid key must
                give zeros.  Timed on the prefix mask; SDPA with the boolean
                mask as the yardstick.
6. e2e        — ``run_inference`` on configs/004_cogvideox/cogvideo5b.yaml at
                full width (dim 3072, 42 layers, T5-XXL, CogVideoX VAE) with
                random weights from the seed, one prompt at 49×480×720.
                Cut: 3 denoising steps (first-order, 2M and final step: every
                branch of the DPM step), and the VAE decodes the first 4
                latent frames (13 video frames) because the full-length f32
                decode does not fit beside the weights.  Asserts 42×3 = 126
                K1 launches, finite latents and pixels, the video's shape and
                metric.json.
7. reference  — the same flow at narrow width (2 layers, 2 heads of d=64)
                on the card and on the CPU with the same weights and noise:
                one denoiser call, the latents, and the VAE's decode of
                the same latents must agree.
8. e2e-opensora — ``run_inference`` on
                configs/003_opensora/opensorav10_256x256.yaml at full width
                and depth (STDiT-XL/2: hidden 1152, 28 layers, 16 heads of
                d=72, bf16; T5-XXL; the 2D VAE at ch 128), random weights
                from the seed, one prompt, 16×256×256, CFG 7, all 50 DDIM
                steps, the whole 16-frame decode.  Asserts 28×50 K2 and K4
                launches and no K1 launch, finite latents and pixels, a
                (16, 256, 256, 3) video and metric.json.
9. reference-opensora — that flow at narrow width (hidden 144, 2 heads of
                d=72, depth 2, a narrow T5, the VAE at ch 72) on the card and
                on the CPU, same weights, x_T and prompt, TF32 off, 4×32×32
                latents, so that K2 (256 spatial tokens) and K4 (1024 cross
                queries) are on the path: one denoiser call, the latents
                after 5 steps and the decode must agree.  The VAE's mid
                attention has ch·4 channels over 32×32 tokens; at ch 72 that
                is d=288, the math path, as at full width (d=512).  At
                ch ≤ 64 it would take the flash route in f32, which the
                bf16 kernel refuses.
10. profile-opensora — one full-size STDiT-XL/2 denoiser call (CFG batch
                2) timed with CUDA events and traced with torch.profiler:
                device time by kernel group and the busy share.
11. kernels   — status of every TPU kernel of the JAX package.

Every launch count (K1, K6, K2, K4) is set to 0 just before each e2e run
and read just after; the kernels' JSON record, on the line before the
last, gives each kernel's launches summed over the two e2e runs.  The last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG_5B = os.path.join(ROOT, "configs", "004_cogvideox", "cogvideo5b.yaml")
CONFIG_OS = os.path.join(ROOT, "configs", "003_opensora",
                         "opensorav10_256x256.yaml")
OUT_DIR = os.path.join(ROOT, "results", "chip_smoke")

# H100 SXM published dense peaks (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

SHAPE_5B = dict(b=2, s=17776, h=48)   # 226 text + 13·30·45 video tokens
E2E_STEPS = 3
DECODE_LATENT_FRAMES = 4
K1_TOL = 2e-2   # of max|o|: bf16 output and bf16 p on both sides
LSE_TOL = 1e-3  # absolute, f32 LSE
# of max|ref|, card vs CPU: bf16 rounding in another summation order for
# one denoiser call and for the whole trajectory, where CFG scale 6
# multiplies the cond − uncond difference at each of 3 steps; f32 (TF32
# off) for the VAE decoding the same latents
REF_TOL_CALL = 3e-2
REF_TOL_TRAJ = 1e-1
REF_TOL_DECODE = 1e-3
OS_STEPS = 50        # Open-Sora e2e: every DDIM step of the config
OS_DEPTH = 28
OS_REF_STEPS = 5     # narrow Open-Sora card-vs-CPU trajectory
FWD_TOL = 2e-2       # K2/K4, of max|o|: bf16 output and bf16 p on both sides


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def cuda_time_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sdpa_ms(args, kw, reps: int):
    """Time of torch's scaled_dot_product_attention on the same tensors, a
    yardstick only: the fastest of its backends (flash, cuDNN, efficient)
    that takes the inputs, and that backend's name.  Its default choice is
    timed too and logged beside: at d=72 it can pick a far slower one."""
    import warnings
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = {"default": cuda_time_ms(lambda: sdpa(*args, **kw), reps)}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        try:
            with sdpa_kernel(backend), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                sdpa(*args, **kw)
                torch.cuda.synchronize()
                times[backend.name] = cuda_time_ms(
                    lambda: sdpa(*args, **kw), reps)
        except RuntimeError:   # this backend does not take the inputs
            continue
    log("sdpa", **{k: f"{v:.4f}" for k, v in times.items()})
    best = min((k for k in times if k != "default"), key=times.get)
    return times[best], best


# ---------------------------------------------------------------- phase 3
def _qkv(b, sq, sk, h, gen):
    """q, k LayerNormed per head, like the MMDiT's (bounded logits)."""
    q, k, v = (torch.randn((b, s, h, 64), generator=gen, device="cuda")
               for s in (sq, sk, sk))
    q = torch.nn.functional.layer_norm(q, (64,))
    k = torch.nn.functional.layer_norm(k, (64,))
    return q.bfloat16(), k.bfloat16(), v.bfloat16()


def _plain_chunked(A, q, k, v, static_max, rows=256):
    """The plain version over all query rows, a block of rows at a time
    (the full score matrix would not fit)."""
    outs, lses = [], []
    for i in range(0, q.shape[1], rows):
        o, lse = A.flash_fwd_d64_plain(q[:, i:i + rows], k, v,
                                       sm_scale=0.125, static_max=static_max,
                                       emit_lse=True)
        outs.append(o)
        lses.append(lse)
    return torch.cat(outs, dim=1), torch.cat(lses, dim=2)


def check_k1(A) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, s, h = SHAPE_5B["b"], SHAPE_5B["s"], SHAPE_5B["h"]
    q, k, v = _qkv(b, s, s, h, gen)
    flops = 4.0 * b * h * s * s * 64
    io_bytes = 4 * q.numel() * q.element_size()
    bound_ms = max(flops / PEAK_BF16_FLOPS, io_bytes / PEAK_BYTES) * 1e3
    bound_by = ("operations" if flops / PEAK_BF16_FLOPS
                >= io_bytes / PEAK_BYTES else "bytes")
    record = {}
    for static_max in (0.0, None):
        out, lse = A.flash_fwd_d64(q, k, v, sm_scale=0.125,
                                   static_max=static_max, emit_lse=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref, ref_lse = _plain_chunked(A, q, k, v, static_max)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        scale = ref.float().abs().max().item()
        ok = err <= K1_TOL * scale and lse_err <= LSE_TOL
        ms = cuda_time_ms(lambda: A.flash_fwd_d64(
            q, k, v, sm_scale=0.125, static_max=static_max), reps=5)
        log("K1", mode="static_max=0" if static_max == 0.0 else "online",
            shape=f"B{b}xS{s}xH{h}xd64", max_abs_err=f"{err:.3e}",
            tol=f"{K1_TOL * scale:.3e}", lse_err=f"{lse_err:.3e}",
            lse_tol=LSE_TOL, ms=f"{ms:.3f}", bound_ms=f"{bound_ms:.3f}",
            bound_by=bound_by, plain_ms=f"{plain_ms:.1f}",
            tflops=f"{flops / ms / 1e9:.1f}", ok=ok)
        if not ok:
            raise AssertionError(f"K1 disagrees with its plain version "
                                 f"(static_max={static_max})")
        if static_max == 0.0:   # the main path's mode
            record = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
            # the generic kernel (K2's) on the same inputs: whether one d=64
            # kernel could serve both routes
            fwd = A.flash_fwd(q, k, v, sm_scale=0.125, static_max=0.0)
            fwd_err = (fwd.float() - ref.float()).abs().max().item()
            fwd_ms = cuda_time_ms(lambda: A.flash_fwd(
                q, k, v, sm_scale=0.125, static_max=0.0), reps=5)
            log("K1", compare="flash_fwd (K2's kernel) at K1's shape",
                mode="static_max=0", max_abs_err=f"{fwd_err:.3e}",
                tol=f"{K1_TOL * scale:.3e}", ms=f"{fwd_ms:.3f}",
                k1_ms=f"{ms:.3f}", ok=fwd_err <= K1_TOL * scale)
            if fwd_err > K1_TOL * scale:
                raise AssertionError("flash_fwd disagrees with K1's plain "
                                     "version at K1's shape")
            del fwd
        del out, lse, ref, ref_lse
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    record["library_ms"], backend = sdpa_ms((qt, kt, vt), {}, reps=5)
    log("K1", library=f"scaled_dot_product_attention[{backend}]",
        library_ms=f"{record['library_ms']:.3f}")
    del q, k, v, qt, kt, vt

    for sq, sk in ((200, 200), (300, 4322), (1, 64)):
        q, k, v = _qkv(2, sq, sk, 4, gen)
        for static_max in (0.0, None):
            out, lse = A.flash_fwd_d64(q, k, v, sm_scale=0.125,
                                       static_max=static_max, emit_lse=True)
            ref, ref_lse = A.flash_fwd_d64_plain(
                q, k, v, sm_scale=0.125, static_max=static_max, emit_lse=True)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            scale = ref.float().abs().max().item()
            ok = err <= K1_TOL * scale and lse_err <= LSE_TOL
            log("K1", mode="static_max=0" if static_max == 0.0 else "online",
                shape=f"B2xSq{sq}xSk{sk}xH4xd64", max_abs_err=f"{err:.3e}",
                tol=f"{K1_TOL * scale:.3e}", lse_err=f"{lse_err:.3e}", ok=ok)
            if not ok:
                raise AssertionError(f"K1 disagrees at Sq={sq}, Sk={sk}")

    # K6: pack2=True runs K1's kernel in online mode
    q, k, v = _qkv(2, 300, 4322, 4, gen)
    before = dict(A.flash_fwd_d64.launches)
    out = A.flash_attention(q, k, v, pack2=True)
    ref = A.flash_fwd_d64_plain(q, k, v, sm_scale=0.125)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    ok = (err <= K1_TOL * scale
          and A.flash_fwd_d64.launches == dict(before, K6=before["K6"] + 1))
    log("K6", route="flash_attention(pack2=True) -> flash_fwd_d64 online, "
        "counted as K6",
        shape="B2xSq300xSk4322xH4xd64", max_abs_err=f"{err:.3e}",
        tol=f"{K1_TOL * scale:.3e}", ok=ok)
    if not ok:
        raise AssertionError("K6 (pack2=True) disagrees with K1's plain "
                             "online version")
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    bound_ms, bound_by = _bound(4.0 * 2 * 4 * 300 * 4322 * 64,
                                (2 * q.numel() + 2 * k.numel())
                                * q.element_size())
    library_ms, backend = sdpa_ms((qt, kt, vt), {}, reps=20)
    record["k6"] = dict(
        max_abs_err=err,
        ms=cuda_time_ms(lambda: A.flash_attention(q, k, v, pack2=True),
                        reps=20),
        plain_ms=cuda_time_ms(lambda: A.flash_fwd_d64_plain(
            q, k, v, sm_scale=0.125), reps=5),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    log("K6", ms=f"{record['k6']['ms']:.4f}", bound_ms=f"{bound_ms:.4f}",
        bound_by=bound_by, plain_ms=f"{record['k6']['plain_ms']:.3f}",
        library=f"scaled_dot_product_attention[{backend}]",
        library_ms=f"{record['k6']['library_ms']:.4f}")
    return record


# ---------------------------------------------------------------- phases 4-5
def _rand(shape, gen, normed=False):
    x = torch.randn(shape, generator=gen, device="cuda")
    if normed:
        x = torch.nn.functional.layer_norm(x, (shape[-1],))
    return x.bfloat16()


def _check_fwd(A, label, q, k, v, **kw) -> float:
    """flash_fwd against flash_fwd_plain with the LSE; returns max|err|."""
    route = "K4" if kw.get("kv_valid") is not None else "K2"
    before = A.flash_fwd.launches[route]
    out, lse = A.flash_fwd(q, k, v, emit_lse=True, **kw)
    ref, ref_lse = A.flash_fwd_plain(q, k, v, emit_lse=True, **kw)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    finite = torch.isfinite(ref_lse)
    inf_ok = torch.equal(torch.isfinite(lse), finite)
    lse_err = ((lse - ref_lse)[finite].abs().max().item()
               if finite.any() else 0.0)
    ok = (err <= FWD_TOL * scale and lse_err <= LSE_TOL and inf_ok
          and A.flash_fwd.launches[route] == before + 1)
    b, sq, h, d = q.shape
    log(route, case=label, shape=f"B{b}xSq{sq}xSk{k.shape[1]}xH{h}xd{d}",
        causal=kw.get("causal", False), static_max=kw.get("static_max"),
        max_abs_err=f"{err:.3e}", tol=f"{FWD_TOL * scale:.3e}",
        lse_err=f"{lse_err:.3e}", lse_tol=LSE_TOL, ok=ok)
    if not ok:
        raise AssertionError(f"{route} disagrees with its plain version "
                             f"({label})")
    return err


def _bound(flops: float, io_bytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, io_bytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _time_record(A, q, k, v, sdpa_args, sdpa_kw, flops, io_bytes, **kw):
    """ms of the kernel, of its plain version and of SDPA on the same
    tensors (CUDA events), with the bound of the work."""
    ms = cuda_time_ms(lambda: A.flash_fwd(q, k, v, **kw), reps=50)
    plain_ms = cuda_time_ms(lambda: A.flash_fwd_plain(q, k, v, **kw), reps=5)
    library_ms, backend = sdpa_ms(sdpa_args, sdpa_kw, reps=50)
    bound_ms, bound_by = _bound(flops, io_bytes)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by), backend


def check_k2(A) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(3)
    b, s, h, d = 32, 256, 16, 72          # STDiT-XL/2 spatial, CFG batch
    q, k, v = (_rand((b, s, h, d), gen) for _ in range(3))
    err = _check_fwd(A, "stdit-xl2 spatial", q, k, v, sm_scale=d ** -0.5)
    for label, (bb, sq, sk, hh, dd, causal, smax) in {
            "d64 causal": (2, 333, 333, 2, 64, True, None),
            "d72 single query": (2, 1, 64, 2, 72, False, None),
            "d128 ragged long": (1, 300, 4322, 2, 128, False, None),
            "d256 fixed max": (1, 200, 200, 2, 256, False, 0.0)}.items():
        normed = smax is not None
        qq = _rand((bb, sq, hh, dd), gen, normed)
        kk = _rand((bb, sk, hh, dd), gen, normed)
        vv = _rand((bb, sk, hh, dd), gen)
        _check_fwd(A, label, qq, kk, vv, sm_scale=dd ** -0.5, causal=causal,
                   static_max=smax)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    rec, backend = _time_record(A, q, k, v, (qt, kt, vt), {},
                                flops=4.0 * b * h * s * s * d,
                                io_bytes=4 * q.numel() * q.element_size(),
                                sm_scale=d ** -0.5)
    log("K2", case="stdit-xl2 spatial timing", ms=f"{rec['ms']:.4f}",
        bound_ms=f"{rec['bound_ms']:.4f}", bound_by=rec["bound_by"],
        plain_ms=f"{rec['plain_ms']:.3f}",
        library=f"scaled_dot_product_attention[{backend}]",
        library_ms=f"{rec['library_ms']:.4f}")
    return dict(max_abs_err=err, **rec)


def check_k4(A) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(4)
    b, sq, sk, h, d = 2, 4096, 120, 16, 72   # STDiT-XL/2 cross-attention
    q = _rand((b, sq, h, d), gen)
    k, v = (_rand((b, sk, h, d), gen) for _ in range(2))
    masks = {}
    for label in ("prefix", "strided", "empty row"):
        m = torch.ones((b, sk), dtype=torch.bool, device="cuda")
        m[0] = False
        if label == "prefix":
            m[0, :13] = True
        elif label == "strided":
            m[0, ::9] = True
        masks[label] = m
    errs = {label: _check_fwd(A, f"stdit-xl2 cross {label}", q, k, v,
                              sm_scale=d ** -0.5, kv_valid=m)
            for label, m in masks.items()}
    out = A.flash_fwd(q, k, v, sm_scale=d ** -0.5,
                      kv_valid=masks["empty row"])
    if out[0].abs().max().item() != 0.0:
        raise AssertionError("K4: a row with no valid key must give zeros")
    m = masks["prefix"]
    n_valid = int(m.sum())
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    io_bytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() + m.numel()
    rec, backend = _time_record(A, q, k, v, (qt, kt, vt),
                                {"attn_mask": m[:, None, None, :]},
                                flops=4.0 * h * sq * n_valid * d,
                                io_bytes=io_bytes, sm_scale=d ** -0.5,
                                kv_valid=m)
    log("K4", case="stdit-xl2 cross timing (prefix mask)",
        ms=f"{rec['ms']:.4f}", bound_ms=f"{rec['bound_ms']:.4f}",
        bound_by=rec["bound_by"], plain_ms=f"{rec['plain_ms']:.3f}",
        library=f"scaled_dot_product_attention[{backend}](attn_mask)",
        library_ms=f"{rec['library_ms']:.4f}", empty_row_zero=True)
    return dict(max_abs_err=errs["prefix"], **rec)


# ---------------------------------------------------------------- phase 6
def zero_counts(A) -> None:
    """Set every kernel's launch count to 0 just before a main-path run."""
    A.flash_fwd_d64.launches = {"K1": 0, "K6": 0}
    A.flash_fwd.launches = {"K2": 0, "K4": 0}


def read_counts(A) -> dict:
    """Every kernel's launch count, read just after a main-path run."""
    return dict(A.flash_fwd_d64.launches, **A.flash_fwd.launches)


def _read_video(path: str):
    import numpy as np
    if path.endswith(".npy"):
        return np.load(path)
    import cv2
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return np.stack(frames)


def run_e2e(A) -> dict:
    from videotuna_tpu_torch.cli.inference import run_inference
    savedir = os.path.join(OUT_DIR, "e2e")
    torch.cuda.reset_peak_memory_stats()
    zero_counts(A)
    result = run_inference([
        "--config", CONFIG_5B, "--device", "cuda", "--quiet",
        "--savedir", savedir,
        "--prompt", "a panda playing guitar by a lake at sunset",
        f"flow.params.ddim_steps={E2E_STEPS}",
        f"flow.params.scheduler_config.params.num_steps={E2E_STEPS}",
        f"inference.decode_latent_frames={DECODE_LATENT_FRAMES}",
    ])
    launches = read_counts(A)
    m = result["metrics"]
    peak = torch.cuda.max_memory_allocated()
    expected = 42 * E2E_STEPS
    frames = 1 + 4 * (DECODE_LATENT_FRAMES - 1)
    video = _read_video(result["videos"][0])
    log("e2e", config="cogvideo5b", frames_sampled=49, height=480, width=720,
        steps=m["denoise_steps"], sec_per_step=f"{m['sample_sec'] / m['denoise_steps']:.3f}",
        decode_sec=f"{m['decode_sec']:.3f}", decoded_frames=frames,
        peak_mem_gb=f"{peak / 1e9:.2f}", launches=launches,
        nonfinite_latents=m["nonfinite_latents"],
        nonfinite_pixels=m["nonfinite_pixels"],
        video_shape="x".join(map(str, video.shape)))
    if launches["K1"] != expected:
        raise AssertionError(f"K1 launched {launches['K1']} times, expected "
                             f"{expected} (42 layers × {E2E_STEPS} steps)")
    if m["nonfinite_latents"] or m["nonfinite_pixels"]:
        raise AssertionError("non-finite latents or pixels")
    if tuple(video.shape) != (frames, 480, 720, 3):
        raise AssertionError(f"video shape {video.shape}")
    if not os.path.isfile(os.path.join(savedir, "metric.json")):
        raise AssertionError("metric.json missing")
    return launches


# ---------------------------------------------------------------- phase 7
def check_small_reference() -> None:
    """The narrow 5B-shaped flow on the card (K1) against the CPU (K1's
    plain version), same weights, same x_T and noise, TF32 off."""
    from videotuna_tpu_torch.core.config import load_configs
    from videotuna_tpu_torch.core.registry import instantiate
    cfg = load_configs([CONFIG_5B], [
        "flow.params.denoiser_config.params.dim=128",
        "flow.params.denoiser_config.params.heads=2",
        "flow.params.denoiser_config.params.num_layers=2",
        "flow.params.denoiser_config.params.text_dim=64",
        "flow.params.cond_stage_config.params.dim=64",
        "flow.params.cond_stage_config.params.heads=2",
        "flow.params.cond_stage_config.params.head_dim=32",
        "flow.params.cond_stage_config.params.ff_dim=128",
        "flow.params.cond_stage_config.params.num_layers=2",
        "flow.params.first_stage_config.params.ch=32",
        "flow.params.first_stage_config.params.num_res_blocks=1",
        f"flow.params.ddim_steps={E2E_STEPS}",
        f"flow.params.scheduler_config.params.num_steps={E2E_STEPS}",
    ])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = instantiate(cfg["flow"], device="cpu")
    gpu = instantiate(cfg["flow"], device="cuda")
    cpu.init_params(seed=1)
    for name, module in cpu.components().items():
        gpu.components()[name].load_state_dict(module.state_dict())
    shape = cpu.latent_shape(1, 9, 96, 128)       # 3×12×16 → 144 + 226 tokens
    gen = torch.Generator().manual_seed(2)
    x_T = torch.randn(shape, generator=gen)
    noises = torch.randn((E2E_STEPS, *shape), generator=gen)
    t = torch.tensor([cpu.scheduler.timesteps[1].item()])
    outs = []
    z_cpu = None
    for flow, dev in ((cpu, "cpu"), (gpu, "cuda")):
        cond = flow.encode_text(["a panda playing guitar"])
        uncond = flow.encode_text([""])
        with torch.inference_mode():
            call = flow.denoise_apply(x_T.to(dev), t.to(dev), cond)
        z = flow.sample(cond, uncond, shape, None, 6.0, x_T=x_T.to(dev),
                        noises=noises.to(dev))
        z_cpu = z if z_cpu is None else z_cpu
        # decode the CPU's latents on both: the VAE alone, in f32
        video = flow.decode_latents(z_cpu.to(dev))
        outs.append([x.float().cpu() for x in (call, z, video)])

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    errs = [rel(a, b) for a, b in zip(outs[1], outs[0])]
    tols = (REF_TOL_CALL, REF_TOL_TRAJ, REF_TOL_DECODE)
    ok = all(math.isfinite(e) and e <= tol for e, tol in zip(errs, tols))
    log("reference", what="narrow cogvideo5b flow, cuda vs cpu",
        denoiser_call_rel_err=f"{errs[0]:.3e}", call_tol=REF_TOL_CALL,
        latent_rel_err=f"{errs[1]:.3e}", latent_tol=REF_TOL_TRAJ,
        decode_rel_err=f"{errs[2]:.3e}", decode_tol=REF_TOL_DECODE, ok=ok)
    if not ok:
        raise AssertionError("GPU flow disagrees with the CPU flow")


# ---------------------------------------------------------------- phase 8
def run_e2e_opensora(A) -> dict:
    from videotuna_tpu_torch.cli.inference import run_inference
    savedir = os.path.join(OUT_DIR, "e2e_opensora")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(A)
    result = run_inference([
        "--config", CONFIG_OS, "--device", "cuda", "--quiet",
        "--savedir", savedir,
        "--prompt", "a panda playing guitar by a lake at sunset",
        f"flow.params.ddim_steps={OS_STEPS}",
    ])
    launches = read_counts(A)
    m = result["metrics"]
    peak = torch.cuda.max_memory_allocated()
    video = _read_video(result["videos"][0])
    log("e2e-opensora", config="opensorav10_256x256", frames=16, height=256,
        width=256, steps=m["denoise_steps"],
        sec_per_step=f"{m['sample_sec'] / m['denoise_steps']:.4f}",
        sample_sec=f"{m['sample_sec']:.3f}",
        decode_sec=f"{m['decode_sec']:.3f}",
        peak_mem_gb=f"{peak / 1e9:.2f}", launches=launches,
        nonfinite_latents=m["nonfinite_latents"],
        nonfinite_pixels=m["nonfinite_pixels"],
        video_shape="x".join(map(str, video.shape)))
    expected = OS_DEPTH * OS_STEPS
    if m["denoise_steps"] != OS_STEPS or launches["K2"] != expected \
            or launches["K4"] != expected or launches["K1"] != 0:
        raise AssertionError(f"launches {launches}, expected K2 = K4 = "
                             f"{expected} ({OS_DEPTH} layers × {OS_STEPS} "
                             "steps) and no K1")
    if m["nonfinite_latents"] or m["nonfinite_pixels"]:
        raise AssertionError("non-finite latents or pixels")
    if tuple(video.shape) != (16, 256, 256, 3):
        raise AssertionError(f"video shape {video.shape}")
    if not os.path.isfile(os.path.join(savedir, "metric.json")):
        raise AssertionError("metric.json missing")
    return launches


# ---------------------------------------------------------------- phase 9
def check_small_reference_opensora() -> None:
    """The narrow Open-Sora flow on the card (K2, K4) against the CPU (their
    plain versions), same weights, x_T, prompt and latents, TF32 off."""
    from videotuna_tpu_torch.core.config import load_configs
    from videotuna_tpu_torch.core.registry import instantiate
    den = "flow.params.denoiser_config.params"
    t5 = "flow.params.cond_stage_config.params"
    cfg = load_configs([CONFIG_OS], [
        f"{den}.hidden_size=144", f"{den}.num_heads=2", f"{den}.depth=2",
        f"{den}.caption_channels=64",
        f"{t5}.dim=64", f"{t5}.heads=2", f"{t5}.head_dim=32",
        f"{t5}.ff_dim=128", f"{t5}.num_layers=2",
        "flow.params.first_stage_config.params.ch=72",
        "flow.params.first_stage_config.params.num_res_blocks=1",
        f"flow.params.ddim_steps={OS_REF_STEPS}",
    ])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = instantiate(cfg["flow"], device="cpu")
    gpu = instantiate(cfg["flow"], device="cuda")
    cpu.init_params(seed=1)
    for name, module in cpu.components().items():
        gpu.components()[name].load_state_dict(module.state_dict())
    shape = cpu.latent_shape(1, 4, 256, 256)      # 4×32×32 latents
    gen = torch.Generator().manual_seed(2)
    x_T = torch.randn(shape, generator=gen)
    t = torch.tensor([int(cpu.scheduler.timesteps[-2])])
    import videotuna_tpu_torch.kernels.attention as A
    outs, z_cpu = [], None
    for flow, dev in ((cpu, "cpu"), (gpu, "cuda")):
        A.flash_fwd.launches = {"K2": 0, "K4": 0}
        cond = flow.encode_text(["a panda playing guitar by a lake"])
        uncond = flow.encode_text([""])
        with torch.inference_mode():
            call = flow.denoise_apply(x_T.to(dev), t.to(dev), cond)
        z = flow.sample(cond, uncond, shape, None, 7.0, x_T=x_T.to(dev))
        z_cpu = z if z_cpu is None else z_cpu
        video = flow.decode_latents(z_cpu.to(dev))
        outs.append([x.float().cpu() for x in (call, z, video)])
        launches = dict(A.flash_fwd.launches)
    expected = 2 * (1 + OS_REF_STEPS)     # depth 2 × (one call + the steps)
    if launches != {"K2": expected, "K4": expected}:
        raise AssertionError(f"narrow Open-Sora flow on the card launched "
                             f"{launches}, expected {expected} of each")

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    errs = [rel(a, b) for a, b in zip(outs[1], outs[0])]
    tols = (REF_TOL_CALL, REF_TOL_TRAJ, REF_TOL_DECODE)
    ok = all(math.isfinite(e) and e <= tol for e, tol in zip(errs, tols))
    log("reference-opensora", what="narrow opensorav10 flow, cuda vs cpu",
        steps=OS_REF_STEPS, card_launches=launches,
        denoiser_call_rel_err=f"{errs[0]:.3e}", call_tol=REF_TOL_CALL,
        latent_rel_err=f"{errs[1]:.3e}", latent_tol=REF_TOL_TRAJ,
        decode_rel_err=f"{errs[2]:.3e}", decode_tol=REF_TOL_DECODE, ok=ok)
    if not ok:
        raise AssertionError("GPU Open-Sora flow disagrees with the CPU flow")


# ---------------------------------------------------------------- phase 10
def profile_opensora_call() -> dict:
    """One STDiT-XL/2 denoiser call with CFG (B=2, 16×32×32 latents, a
    120-token caption with a ragged mask), the work of one sampling step,
    timed with CUDA events and traced with torch.profiler: device time by
    kernel group, and the device's busy share of the call."""
    from torch.profiler import ProfilerActivity, profile
    from videotuna_tpu_torch.core.config import load_configs
    from videotuna_tpu_torch.core.registry import instantiate
    from videotuna_tpu_torch.models.layers import init_weights_
    cfg = load_configs([CONFIG_OS])["flow"]["params"]["denoiser_config"]
    with torch.device("meta"):
        model = instantiate(cfg)
    model = model.to_empty(device="cuda").eval()
    init_weights_(model, torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((2, 16, 32, 32, 4), generator=gen, device="cuda")
    t = torch.tensor([500, 500], device="cuda")
    y = torch.randn((2, 120, 4096), generator=gen, device="cuda")
    mask = torch.ones((2, 120), dtype=torch.bool, device="cuda")
    mask[0, 13:] = False
    with torch.inference_mode():
        call_ms = cuda_time_ms(lambda: model(x, t, y, mask), reps=10)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model(x, t, y, mask)
            torch.cuda.synchronize()
    groups = {"flash_fwd (K2+K4)": 0.0, "gemm": 0.0, "other": 0.0}
    kernels = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us <= 0 or str(getattr(e, "device_type", "")).endswith("CPU"):
            continue
        kernels[e.key] = us / 1e3
        name = e.key.lower()
        group = ("flash_fwd (K2+K4)" if "flash_fwd_kernel" in name else
                 "gemm" if any(g in name for g in ("gemm", "nvjet", "xmma",
                                                   "cutlass", "cublas"))
                 else "other")
        groups[group] += us / 1e3
    device_ms = sum(groups.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    log("profile-opensora", what="one STDiT-XL/2 call, CFG batch 2",
        call_ms=f"{call_ms:.3f}",
        device_ms=f"{device_ms:.3f}" if device_ms else "not measured",
        busy_share=(f"{device_ms / call_ms:.3f}" if device_ms
                    else "not measured"),
        **{k.replace(" ", "_"): f"{v:.3f}" for k, v in groups.items()})
    for name, ms in top:
        log("profile-opensora", kernel=name[:90].replace(" ", ""),
            ms=f"{ms:.3f}", share=f"{ms / call_ms:.3f}")
    del model
    return groups


# ---------------------------------------------------------------- main
def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    sys.path.insert(0, ROOT)
    import videotuna_tpu_torch
    if not os.path.abspath(videotuna_tpu_torch.__file__).startswith(ROOT):
        raise SystemExit("chip_smoke: videotuna_tpu_torch is not this "
                         "checkout's")
    from videotuna_tpu_torch import kernels
    import videotuna_tpu_torch.kernels.attention as A

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log("device", torch=torch.__version__, cuda=torch.version.cuda,
        name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    t0 = time.perf_counter()
    report = kernels.build_all()
    for src, info in report.items():
        regs = [l.strip() for l in info["ptxas"].splitlines()
                if "registers" in l or "spill" in l]
        log("build", source=src, ptxas=" | ".join(regs))
    log("build", seconds=f"{time.perf_counter() - t0:.1f}",
        built=len(report))

    k1 = check_k1(A)
    k6 = k1.pop("k6")
    k2 = check_k2(A)
    k4 = check_k4(A)
    cog_launches = run_e2e(A)
    check_small_reference()
    os_launches = run_e2e_opensora(A)
    # each kernel's launches over both main-path runs
    launches = {k: cog_launches[k] + os_launches[k] for k in cog_launches}
    check_small_reference_opensora()
    profile_opensora_call()

    statuses = {f"K{i}": "to port" for i in range(1, 11)}
    statuses.update({"K1": "ported, checked", "K2": "ported, checked",
                     "K4": "ported, checked",
                     "K6": "ported (mapped onto K1's kernel), checked"})
    log("kernels", **statuses)
    d64 = "videotuna_tpu_torch/kernels/csrc/flash_fwd_d64.cu"
    fwd = "videotuna_tpu_torch/kernels/csrc/flash_fwd.cu"
    tpu = "videotuna_tpu/kernels/attention.py"
    print(json.dumps({"kernels": [
        {"name": "flash_fwd_d64 (K1)", "route": "cuda", "source": d64,
         "replaces": f"{tpu}:268", "launches": launches["K1"], **k1},
        {"name": "flash_fwd (K2)", "route": "cuda", "source": fwd,
         "replaces": f"{tpu}:78", "launches": launches["K2"], **k2},
        {"name": "flash_fwd kv_valid (K4)", "route": "cuda", "source": fwd,
         "replaces": f"{tpu}:970", "launches": launches["K4"], **k4},
        {"name": "flash_fwd_d64 online, pack2=True (K6)", "route": "cuda",
         "source": d64, "replaces": f"{tpu}:163", "launches": launches["K6"],
         **k6},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
