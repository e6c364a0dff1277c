"""Where a Hopper kernel's time goes: the kernel timed beside copies of its
source with one part of its work taken out, on the same tensors.

    python -m videotuna_tpu_torch.kernels.attribution     # on the card

Variants (their outputs are wrong by design; only their times count):

- K3, ``csrc/flash_fwd_sm90.cu`` at HunyuanVideo's joint attention (B=1,
  S=119,056, H=24, d=128, fixed max): ``no_exp2`` keeps the scaled score
  where the softmax takes its exp2.  If the kernel's exp2 overlap the
  products, the time barely moves; if they run one after the other, it
  falls by the special-function units' share (≈ 80 ms).
- K7, ``csrc/flash_bwd_sm90.cu`` at CogVideoX-2B's training shape (B=1,
  S=17,776, H=30, d=64): ``no_exp2`` likewise, and ``no_dq_adds`` drops the
  atomic adds of dq into its f32 scratch.

Each variant is built from an edited copy under ``kernels/_build/
attribution/`` and loaded in place of the kernel's library for its timing.
Prints the card's name and power limit, then one line per variant.
"""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path

import torch

from videotuna_tpu_torch import kernels
import videotuna_tpu_torch.kernels.attention as A

_ADD = '''          atomicAdd(reinterpret_cast<float2*>(acc + row * D + col),
                    make_float2(dqa[nb * 4 + 2 * r], dqa[nb * 4 + 2 * r + 1]));'''
_NO_ADD = ('          if (dqa[nb * 4 + 2 * r] == 12345.f) '
           'acc[row * D + col] = 0.f;')

# (kernel, source, variant) -> [(text, replacement), ...]
VARIANTS = {
    ("K3", "flash_fwd_sm90.cu", "base"): [],
    ("K3", "flash_fwd_sm90.cu", "no_exp2"): [("fast_exp2(", "(")],
    ("K7", "flash_bwd_sm90.cu", "base"): [],
    ("K7", "flash_bwd_sm90.cu", "no_exp2"): [("fast_exp2(", "(")],
    ("K7", "flash_bwd_sm90.cu", "no_dq_adds"): [(_ADD, _NO_ADD)],
}


def _time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _inputs(b: int, s: int, h: int, d: int, gen: torch.Generator):
    """RMS-normed q, k (bounded logits, as the denoisers' qk-norm) and v."""
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda")
               for _ in range(3))
    q, k = (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-6)
            for x in (q, k))
    return q.bfloat16(), k.bfloat16(), v.bfloat16()


def _with_variant(source: str, name: str, edits, fn):
    """Run ``fn`` with ``source``'s library built from an edited copy."""
    text = (kernels.CSRC / source).read_text()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{source}: variant {name} no longer applies")
        text = text.replace(old, new)
    where = kernels.BUILD_DIR / "attribution" / name
    where.mkdir(parents=True, exist_ok=True)
    (where / source).write_text(text)
    for header in kernels.CSRC.glob("*.cuh"):
        shutil.copy(header, where / header.name)
    saved = kernels.CSRC, kernels.BUILD_DIR, kernels._LIBS.pop(source, None)
    kernels.CSRC, kernels.BUILD_DIR = where, where / "_build"
    try:
        return fn()
    finally:
        kernels.CSRC, kernels.BUILD_DIR = saved[0], saved[1]
        kernels._LIBS.pop(source, None)
        if saved[2] is not None:
            kernels._LIBS[source] = saved[2]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("attribution: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q3, k3, v3 = _inputs(1, 33 * 45 * 80 + 256, 24, 128, gen)
    q7, k7, v7 = _inputs(1, 17776, 30, 64, gen)
    g7 = torch.randn(q7.shape, generator=gen, device="cuda").bfloat16()
    o7, lse7 = A.flash_fwd(q7, k7, v7, sm_scale=0.125, static_max=0.0,
                           emit_lse=True)
    calls = {
        "K3": (lambda: A.flash_fwd(q3, k3, v3, sm_scale=128 ** -0.5,
                                   static_max=0.0, route="K3"), 3),
        "K7": (lambda: A.flash_bwd(q7, k7, v7, o7, g7, lse7,
                                   sm_scale=0.125), 5),
    }
    base = {}
    for (kernel, source, name), edits in VARIANTS.items():
        fn, reps = calls[kernel]
        ms = _with_variant(source, f"{kernel}_{name}", edits,
                           lambda: _time_ms(fn, reps))
        base.setdefault(kernel, ms)
        print(f"[attribution] kernel={kernel} source={source} "
              f"variant={name} ms={ms:.3f} "
              f"saved_ms={base[kernel] - ms:.3f}", flush=True)


if __name__ == "__main__":
    main()
