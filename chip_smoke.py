"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line; any failure raises and exits non-zero
without a result line:

1. device     — the card's name and power limit (nvidia-smi).
2. build      — compiles every CUDA kernel of the port from kernels/csrc.
3. K1         — the d=64 flash kernel against its plain PyTorch version on
                the card, at the CogVideoX-5B shape (B=2 with CFG, S=17776,
                H=48, bf16) in both softmax modes with the LSE, and at ragged
                shapes; times the kernel, its plain version and
                torch's scaled_dot_product_attention (a yardstick only).
4. e2e        — ``run_inference`` on configs/004_cogvideox/cogvideo5b.yaml at
                full width (dim 3072, 42 layers, T5-XXL, CogVideoX VAE) with
                random weights from the seed, one prompt at 49×480×720.
                Cut: 3 denoising steps (first-order, 2M and final step: every
                branch of the DPM step), and the VAE decodes the first 4
                latent frames (13 video frames) because the full-length f32
                decode does not fit beside the weights.  Asserts 42×3 = 126
                K1 launches, finite latents and pixels, the video's shape and
                metric.json.
5. reference  — the same flow at narrow width (2 layers, 2 heads of d=64)
                on the card and on the CPU with the same weights and noise:
                one denoiser call, the latents, and the VAE's decode of
                the same latents must agree.
6. kernels    — status of every TPU kernel of the JAX package.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
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
        del out, lse, ref, ref_lse
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa(qt, kt, vt)
    record["library_ms"] = cuda_time_ms(lambda: sdpa(qt, kt, vt), reps=5)
    log("K1", library="scaled_dot_product_attention",
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
    return record


# ---------------------------------------------------------------- phase 4
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


def run_e2e(A) -> int:
    from videotuna_tpu_torch.cli.inference import run_inference
    savedir = os.path.join(OUT_DIR, "e2e")
    torch.cuda.reset_peak_memory_stats()
    A.flash_fwd_d64.launches = 0
    result = run_inference([
        "--config", CONFIG_5B, "--device", "cuda", "--quiet",
        "--savedir", savedir,
        "--prompt", "a panda playing guitar by a lake at sunset",
        f"flow.params.ddim_steps={E2E_STEPS}",
        f"flow.params.scheduler_config.params.num_steps={E2E_STEPS}",
        f"inference.decode_latent_frames={DECODE_LATENT_FRAMES}",
    ])
    launches = A.flash_fwd_d64.launches
    m = result["metrics"]
    peak = torch.cuda.max_memory_allocated()
    expected = 42 * E2E_STEPS
    frames = 1 + 4 * (DECODE_LATENT_FRAMES - 1)
    video = _read_video(result["videos"][0])
    log("e2e", config="cogvideo5b", frames_sampled=49, height=480, width=720,
        steps=m["denoise_steps"], sec_per_step=f"{m['sample_sec'] / m['denoise_steps']:.3f}",
        decode_sec=f"{m['decode_sec']:.3f}", decoded_frames=frames,
        peak_mem_gb=f"{peak / 1e9:.2f}", k1_launches=launches,
        nonfinite_latents=m["nonfinite_latents"],
        nonfinite_pixels=m["nonfinite_pixels"],
        video_shape="x".join(map(str, video.shape)))
    if launches != expected:
        raise AssertionError(f"K1 launched {launches} times, expected "
                             f"{expected} (42 layers × {E2E_STEPS} steps)")
    if m["nonfinite_latents"] or m["nonfinite_pixels"]:
        raise AssertionError("non-finite latents or pixels")
    if tuple(video.shape) != (frames, 480, 720, 3):
        raise AssertionError(f"video shape {video.shape}")
    if not os.path.isfile(os.path.join(savedir, "metric.json")):
        raise AssertionError("metric.json missing")
    return launches


# ---------------------------------------------------------------- phase 5
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
    launches = run_e2e(A)
    check_small_reference()

    statuses = {"K1": "ported, checked"}
    statuses.update({f"K{i}": "to port" for i in range(2, 11)})
    log("kernels", **statuses)
    print(json.dumps({"kernels": [{
        "name": "flash_fwd_d64", "route": "cuda",
        "source": "videotuna_tpu_torch/kernels/csrc/flash_fwd_d64.cu",
        "replaces": "videotuna_tpu/kernels/attention.py:268",
        "launches": launches, **k1}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
