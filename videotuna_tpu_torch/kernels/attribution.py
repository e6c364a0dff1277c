"""Where a Hopper kernel's time goes: the kernel timed beside copies of its
source with one part of its work taken out, on the same tensors.

    python -m videotuna_tpu_torch.kernels.attribution [K1] [K3] [K4] [K5] [K7] [K8] [K5_d128] [K8_d128] [K6] [K2_f32] [host]

Variants (their outputs are wrong by design; only their times count):

- K3, ``csrc/flash_fwd_sm90.cu`` at HunyuanVideo's joint attention (B=1,
  S=119,056, H=24, d=128, fixed max): ``no_exp2`` keeps the scaled score
  where the softmax takes its exp2.  If the kernel's exp2 overlap the
  products, the time barely moves; if they run one after the other, it
  falls by the special-function units' share (≈ 80 ms).
- K1, the persistent kernel of ``csrc/flash_fwd_sm90.cu`` at D=64, at
  CogVideoX-5B's sampling shape (B=2, S=17,776, H=48, fixed max; and
  online, labelled K1_online): ``no_exp2``, as for K3.  At d=64 a score
  costs 256 FLOP of products and one exp2, so the special-function units'
  floor (≈ 7.3 ms) is as long as the products' (7.85 ms): what ``no_exp2``
  saves is the share of the exp2 that the other consumer's products do
  not hide.  ``k3_kernel`` sends the fixed max at d=64 to K3's kernel
  (``flash_fwd_sm90_kernel<64>``, one block per query tile, no running
  max), the other candidate for that route, which the persistent kernel
  took; the online call keeps the persistent kernel there.
  ``base_again`` times the kernel once more after it, so that a card
  that slows as it warms shows.
- K4, the persistent kernel with the key mask at STDiT-XL/2's
  cross-attention (4096 queries over 120 keys, H=16, d=72, the prefix
  mask): sampling (B=2, without the LSE) and, as K4_lse, training (B=1,
  with the LSE), by device time.  ``no_mask`` keeps every key (the mask
  test and its loads go); ``unit_max_1``, ``unit_max_2`` and
  ``unit_max_4`` cap the query tiles of a unit that holds one key tile
  (the kernel takes up to 8: 8 at B=2 and 4 at B=1 on 132 SMs).
- K7, ``csrc/flash_bwd_sm90.cu`` at CogVideoX-2B's training shape (B=1,
  S=17,776, H=30, d=64): ``no_exp2`` likewise, and ``no_dq_adds`` drops the
  atomic adds of dq into its f32 scratch.
- K5_d128 and K8_d128, HunyuanVideo's LoRA training attention (B=1,
  S=7,456, H=24, d=128, RMSNormed q and k): K5 under the fixed max 0 with
  the LSE on K3's kernel (``csrc/flash_fwd_sm90.cu``), ``no_exp2``; K8 on
  ``csrc/flash_bwd_sm90.cu`` at its width 128, ``no_exp2``,
  ``no_dq_adds`` (as K7) and ``no_dq``, which drops the dQ product as
  well as leaving its adds; what none of them saves is the chain of the
  other four products and the loads.
- K5 and K2, the persistent kernel of ``csrc/flash_fwd_sm90.cu`` at
  STDiT-XL/2's training forward (K5: B=16, S=256, H=16, d=72, online
  softmax with the LSE) and sampling (K2: B=32, without the LSE), each
  variant timed on both by device time (``device_ms``, a CUDA-graph
  replay): at 0.02-0.04 ms a call the host's launch sets a loop's
  CUDA-event time.  ``no_exp2``; ``no_rescale`` drops
  the O accumulator's rescale by the running max; ``no_lse_store`` the LSE
  store; ``no_reuse`` makes a unit of each query tile (K and V loaded for
  both query tiles of a head); ``no_prefetch`` shrinks the rings to one Q
  stage and one unit of K/V, so that nothing of the next unit loads while
  the current one computes; ``no_tail`` drops the products of columns
  64-79 (the 32-byte-swizzled box: one depth step of QK^T, the N = 16 PV
  products), its loads kept; ``no_math`` leaves out every product and
  the softmax, so that what is left is the loads, the barriers, the
  consumers' turns and the stores.

- K8, ``csrc/flash_bwd_rows_sm90.cu`` at STDiT-XL/2's training backward,
  spatial (K8: B=16, S=256, H=16, d=72) and cross (K8_cross: B=1, 4096
  queries over 120 keys, 13 valid, the mask words packed once as the
  training forward does), by device time: ``no_exp2``; ``no_mask`` keeps
  every key (the two mask bits a thread and their -inf bias go);
  ``no_delta`` takes delta from a zero row (the in-kernel rowsum of dO·O
  and the O tile's load go); ``no_tail`` drops the products
  of columns 64-79 (the 16-column boxes: the fifth depth step of S^T and
  dP^T, the N = 16 parts of dV and dK, the N = 8 part of dQ), their loads
  kept; ``no_dq`` drops the dQ product; ``no_math`` every product and the
  exp2, so that what is left is the loads, delta, the barriers and the
  stores.

- K6, the persistent kernel of ``csrc/flash_fwd_sm90.cu`` at its A/B
  shape (B=2, 300 queries over 4,322 keys, H=4, d=64, online), by device
  time: the call as planned (5 key ranges and the combine) beside the
  private launcher with 1 (the unsplit walk), 3 and 6 ranges; ``no_combine``
  leaves out the combine's launch.
- K2_f32, ``csrc/flash_fwd_f32_sm90.cu`` at LLaMA's f32 causal shape
  (B=1, 256 tokens, H=32, d=128), by device time: ``no_combine`` leaves out
  the combine's launch; ``no_split`` the in-place hi/lo split of the K and
  V tiles (they are read as if split); ``one_product`` keeps hi·hi of the
  three products of QK^T and PV; ``three_blocks`` compiles for three
  blocks an SM (168 registers, spills) on the same plan.

Each variant is built from an edited copy under ``kernels/_build/
attribution/`` and loaded in place of the kernel's library for its timing.
Prints the card's name and power limit, then one line per variant; the
arguments pick kernels (all ten by default).  ``host`` instead takes the
K8 wrapper's host time apart at both STDiT shapes, beside the old design's
(``host_breakdown``).
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import time
from pathlib import Path

import torch

from videotuna_tpu_torch import kernels
import videotuna_tpu_torch.kernels.attention as A

# flash_bwd_sm90.cu without the atomic adds of dq (either width)
_NO_DQ_ADDS = [('''          atomicAdd(reinterpret_cast<float2*>(acc + row * D + col),
                    make_float2(dqa[nb * 4 + 2 * r], dqa[nb * 4 + 2 * r + 1]));''',
                '          if (dqa[nb * 4 + 2 * r] == 12345.f) acc[row * D + col] = 0.f;')]

_K3_LAUNCH = '''  return launch<128, false>(q, k, v, p, B, q_sb, q_ss, q_sh, k_sb, k_ss,
                            k_sh, v_sb, v_ss, v_sh, s);'''

# the products of flash_bwd_rows_sm90.cu: columns 64-79 (the 16-column
# boxes), dQ, and the rest
_K8_TAIL = [(head, "if (false) " + head) for head in (
    "wgmma_ss_n64<0, 0>(st, desc_sw32(", "wgmma_ss_n64<0, 0>(dpt, desc_sw32(",
    "wgmma_rs_n16<1>(dv + 32,", "wgmma_rs_n16<1>(dk + 32,",
    "wgmma_ss_n8<1, 1>(")]
_K8_DQ = [("wgmma_ss_n32<1, 1>(dqa,", "if (false) wgmma_ss_n32<1, 1>(dqa,"),
          ("wgmma_ss_n8<1, 1>(", "if (false) wgmma_ss_n8<1, 1>(")]
_K8_REST = [(head, "if (false) " + head) for head in (
    "wgmma_ss_n64<0, 0>(st, desc(", "wgmma_ss_n64<0, 0>(dpt, desc(",
    "wgmma_rs_n64<1>(dv, pa[kk],", "wgmma_rs_n64<1>(dk, dsa[kk],")]

# (kernel, source, variant) -> [(text, replacement), ...]
VARIANTS = {
    ("K1", "flash_fwd_sm90.cu", "base"): [],
    ("K1", "flash_fwd_sm90.cu", "no_exp2"): [("fast_exp2(", "(")],
    ("K1", "flash_fwd_sm90.cu", "k3_kernel"): [
        ("  if (wide || d == 64) {",
         "  if (wide || (d == 64 && (online || lse))) {"),
        ("  if (d != 128 || online", "  if ((d != 128 && d != 64) || online"),
        (_K3_LAUNCH, "  if (d == 64)\n" + _K3_LAUNCH.replace("128", "64")
         + "\n" + _K3_LAUNCH)],
    ("K1", "flash_fwd_sm90.cu", "base_again"): [],
    ("K4", "flash_fwd_sm90.cu", "base"): [],
    ("K4", "flash_fwd_sm90.cu", "no_mask"): [
        ("return ((mk[nb >> 2] >> ((nb & 3) * 8 + (i & 1))) & 1u) != 0u;",
         "return true;")],
    ("K4", "flash_fwd_sm90.cu", "unit_max_1"): [
        ("P_UNIT_M_MAX = 8;", "P_UNIT_M_MAX = 1;")],
    ("K4", "flash_fwd_sm90.cu", "unit_max_2"): [
        ("P_UNIT_M_MAX = 8;", "P_UNIT_M_MAX = 2;")],
    ("K4", "flash_fwd_sm90.cu", "unit_max_4"): [
        ("P_UNIT_M_MAX = 8;", "P_UNIT_M_MAX = 4;")],
    ("K3", "flash_fwd_sm90.cu", "base"): [],
    ("K3", "flash_fwd_sm90.cu", "no_exp2"): [("fast_exp2(", "(")],
    ("K7", "flash_bwd_sm90.cu", "base"): [],
    ("K7", "flash_bwd_sm90.cu", "no_exp2"): [("fast_exp2(", "(")],
    ("K7", "flash_bwd_sm90.cu", "no_dq_adds"): _NO_DQ_ADDS,
    ("K5_d128", "flash_fwd_sm90.cu", "base"): [],
    ("K5_d128", "flash_fwd_sm90.cu", "no_exp2"): [("fast_exp2(", "(")],
    ("K8_d128", "flash_bwd_sm90.cu", "base"): [],
    ("K8_d128", "flash_bwd_sm90.cu", "no_exp2"): [("fast_exp2(", "(")],
    ("K8_d128", "flash_bwd_sm90.cu", "no_dq_adds"): _NO_DQ_ADDS,
    ("K8_d128", "flash_bwd_sm90.cu", "no_dq"): _NO_DQ_ADDS + [
        ("wgmma_ss_mn<D / 2>(dqa,", "if (false) wgmma_ss_mn<D / 2>(dqa,")],
    ("K8_d128", "flash_bwd_sm90.cu", "base_again"): [],
    ("K5", "flash_fwd_sm90.cu", "base"): [],
    ("K5", "flash_fwd_sm90.cu", "no_exp2"): [("fast_exp2(", "(")],
    ("K5", "flash_fwd_sm90.cu", "no_rescale"): [
        ("o[i] *= alpha[(i >> 1) & 1];", "{}")],
    ("K5", "flash_fwd_sm90.cu", "no_lse_store"): [
        ("if (tig == 0)\n              p.lse[",
         "if (tig == 0 && row < 0)\n              p.lse[")],
    ("K5", "flash_fwd_sm90.cu", "no_reuse"): [
        ("p.unit_m = n_tiles <= P_KV_STAGES / 2 ? 2 : 1;", "p.unit_m = 1;")],
    ("K5", "flash_fwd_sm90.cu", "no_prefetch"): [
        ("P_Q_STAGES = 3;", "P_Q_STAGES = 1;"),
        ("P_KV_STAGES = 4;", "P_KV_STAGES = 2;"),
        ("n_tiles <= P_KV_STAGES / 2 ? 2 : 1;", "n_tiles <= 2 ? 2 : 1;")],
    ("K5", "flash_fwd_sm90.cu", "no_math"): [
        (head, head + "\n      return;") for head in (
            "auto pv = [&](int s) {", "auto qk = [&](int qs, int s) {",
            "auto softmax = [&](int t) {")],
    ("K8", "flash_bwd_rows_sm90.cu", "base"): [],
    ("K8", "flash_bwd_rows_sm90.cu", "no_exp2"): [("fast_exp2(", "(")],
    ("K8", "flash_bwd_rows_sm90.cu", "no_mask"): [
        ("kb[r] = ok ? 0.f : -INFINITY;", "kb[r] = 0.f;")],
    ("K8", "flash_bwd_rows_sm90.cu", "no_delta"): [
        ("for (int ch = 0; ch < 10; ++ch) {", "for (int ch = 0; ch < 0; ++ch) {"),
        ("const bool need_o = t == x.t0;", "const bool need_o = false;"),
        ("mbar_wait(o_full, oi & 1);", "")],
    ("K8", "flash_bwd_rows_sm90.cu", "no_tail"): _K8_TAIL,
    ("K8", "flash_bwd_rows_sm90.cu", "no_dq"): _K8_DQ,
    ("K8", "flash_bwd_rows_sm90.cu", "no_math"): (
        _K8_TAIL[:4] + _K8_DQ + _K8_REST + [("fast_exp2(", "(")]),
    ("K8", "flash_bwd_rows_sm90.cu", "base_again"): [],
    ("K6", "flash_fwd_sm90.cu", "base"): [],
    ("K6", "flash_fwd_sm90.cu", "no_combine"): [
        ("  if (err != 0 || !SPLIT) return err;", "  return err;")],
    ("K2_f32", "flash_fwd_f32_sm90.cu", "base"): [],
    ("K2_f32", "flash_fwd_f32_sm90.cu", "no_combine"): [
        ("  if (err != 0 || n_combine == 0) return err;", "  return err;")],
    ("K2_f32", "flash_fwd_f32_sm90.cu", "no_split"): [
        ("    split_tile(i & 1);\n", "")],
    ("K2_f32", "flash_fwd_f32_sm90.cu", "one_product"): [
        (line, "") for line in (
            "        mma_bf16(s[nb], qh[ks], b0.y, b1.y);\n",
            "        mma_bf16(s[nb], ql[ks], b0.x, b1.x);\n",
            "        mma_bf16(acc[db], ph[kk], bl0, bl1);\n",
            "        mma_bf16(acc[db], pl[kk], bh0, bh1);\n")],
    ("K2_f32", "flash_fwd_f32_sm90.cu", "three_blocks"): [
        ("__launch_bounds__(THREADS, 2)", "__launch_bounds__(THREADS, 3)")],
    ("K2_f32", "flash_fwd_f32_sm90.cu", "base_again"): [],
    ("K5", "flash_fwd_sm90.cu", "no_tail"): [
        ("if constexpr (C::TAIL)\n          wgmma_rs_n16",
         "if constexpr (false)\n          wgmma_rs_n16"),
        ("if constexpr (C::TAIL)\n        wgmma_ss_n128",
         "if constexpr (false)\n        wgmma_ss_n128")],
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


def device_ms(fn, reps: int) -> float:
    """Device time per call of ``fn``: ``reps`` calls captured in one CUDA
    graph, whose replay is timed with CUDA events, so the host's time to
    launch each call is left out (warmed up first on a side stream)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    ms = _time_ms(graph.replay, 5) / reps
    del graph
    return ms


def _inputs(b: int, s: int, h: int, d: int, gen: torch.Generator):
    """RMS-normed q, k (bounded logits, as the denoisers' qk-norm) and v."""
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda")
               for _ in range(3))
    q, k = (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-6)
            for x in (q, k))
    return q.bfloat16(), k.bfloat16(), v.bfloat16()


def _with_variant(source: str, name: str, edits, fn):
    """Run ``fn`` with ``source``'s library built from a copy edited by
    ``edits``, (text, replacement) pairs."""
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


def _host_ms(fn, reps: int) -> float:
    """Host time per call of ``fn``, the device's work left to finish after
    the clock stops."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return ms


def _k8_inputs(gen: torch.Generator):
    """{label: (q, k, v, o, dO, lse, kv_valid, words)} at STDiT-XL/2's
    training backward, spatial (K8: B=16, S=256) and cross (K8_cross: B=1,
    4096 queries over 120 keys, 13 valid, the words packed once as the
    training forward does); H=16, d=72."""
    out = {}
    for label, (b, sq, sk) in (("K8", (16, 256, 256)),
                               ("K8_cross", (1, 4096, 120))):
        q, k, v, g = (torch.randn((b, s, 16, 72), generator=gen,
                                  device="cuda").bfloat16()
                      for s in (sq, sk, sk, sq))
        m = words = None
        if label == "K8_cross":
            m = torch.zeros((b, sk), dtype=torch.bool, device="cuda")
            m[:, :13] = True
            words = A._pack_mask_words(m, b, sk)
        o, lse = A.flash_fwd(q, k, v, sm_scale=72 ** -0.5, kv_valid=m,
                             emit_lse=True)
        out[label] = (q, k, v, o, g, lse, m, words)
    return out


def _median_host_ms(fn, loops: int = 25, calls: int = 20) -> float:
    """Median over ``loops`` loops of the host time per call of ``fn``, each
    loop ``calls`` calls (too few to fill the launch queue), the device's
    work finished between loops."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(loops):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e3)
        torch.cuda.synchronize()
    return sorted(times)[loops // 2]


def host_breakdown(gen: torch.Generator) -> None:
    """Where the K8 wrapper's host time goes, at both STDiT shapes, for the
    Hopper design (``flash_bwd``) and the old one (``_flash_bwd_mma``),
    each a median of short loops (``_median_host_ms``): ``host_ms`` a
    call; ``python_ms`` with the C call left out (checks, allocations);
    ``ctypes_ms`` the C entry called with the same arguments but B=0,
    which it refuses at once (the arguments' conversion and the call);
    ``c_ms`` = host − python − ctypes (the current stream, tensor maps,
    launches).  Beside them ``loop_ms``, the host time a call over 2000
    calls, which waits on a full launch queue where the device is the
    slower, and ``event_ms``, CUDA events around 2000 calls.  Then the
    parts every wrapper pays: ``torch.cuda.current_stream()``, entering
    ``torch.cuda.device`` and one 9.4 MB ``torch.empty``."""
    sm = 72 ** -0.5
    for label, t in _k8_inputs(gen).items():
        for design, fn in (
                ("sm90", lambda t=t: A.flash_bwd(
                    *t[:6], sm_scale=sm, kv_valid=t[6], mask_words=t[7])),
                ("mma", lambda t=t: A._flash_bwd_mma(
                    *t[:6], sm, False, t[6]))):
            host = _median_host_ms(fn)
            loop = _host_ms(fn, 2000)
            event = _time_ms(fn, 2000)
            calls = []
            launch = A._launch
            A._launch = lambda *a: calls.append(a)
            try:
                python = _median_host_ms(fn)
            finally:
                A._launch = launch
            source, symbol, argtypes, *args = calls[-1]
            args = [a for a in args if not isinstance(a, torch.device)]
            c_fn = getattr(kernels.load(source), symbol)
            c_fn.argtypes, c_fn.restype = argtypes, ctypes.c_int
            args[11] = 0   # B
            handle = torch.cuda.current_stream().cuda_stream
            conv = _median_host_ms(lambda: c_fn(*args, handle))
            print(f"[host] kernel={label} design={design} "
                  f"host_ms={host:.4f} python_ms={python:.4f} "
                  f"ctypes_ms={conv:.4f} c_ms={host - python - conv:.4f} "
                  f"loop_ms={loop:.4f} event_ms={event:.4f}", flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())

    def device_context():
        with torch.cuda.device(dev):
            pass
    for name, fn in (
            ("current_stream",
             lambda: torch.cuda.current_stream().cuda_stream),
            ("device_context", device_context),
            ("empty", lambda: torch.empty((16, 256, 16, 72),
                                          dtype=torch.bfloat16, device=dev))):
        print(f"[host] part={name} ms={_median_host_ms(fn):.4f}",
              flush=True)


def main(argv=None) -> None:
    import sys
    picked = set((sys.argv[1:] if argv is None else argv)
                 or ("K1", "K3", "K4", "K5", "K7", "K8", "K5_d128",
                     "K8_d128", "K6", "K2_f32"))
    if not torch.cuda.is_available():
        raise SystemExit("attribution: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if "host" in picked:
        host_breakdown(gen)
    # kernel -> the calls each of its variants is timed on:
    # (label, call, timer, repetitions)
    calls = {}
    if "K1" in picked:
        q1, k1, v1 = _inputs(2, 17776, 48, 64, gen)
        calls["K1"] = [
            ("K1", lambda: A.flash_fwd(q1, k1, v1, sm_scale=0.125,
                                       static_max=0.0, route="K1"),
             _time_ms, 5),
            ("K1_online", lambda: A.flash_fwd(q1, k1, v1, sm_scale=0.125,
                                              route="K1"), _time_ms, 5)]
    if "K4" in picked:
        q4 = torch.randn((2, 4096, 16, 72), generator=gen,
                         device="cuda").bfloat16()
        k4, v4 = (torch.randn((2, 120, 16, 72), generator=gen,
                              device="cuda").bfloat16() for _ in range(2))
        m4 = torch.ones((2, 120), dtype=torch.bool, device="cuda")
        m4[0, 13:] = False
        calls["K4"] = [
            ("K4", lambda: A.flash_fwd(q4, k4, v4, sm_scale=72 ** -0.5,
                                       kv_valid=m4), device_ms, 50),
            ("K4_lse", lambda: A.flash_fwd(
                q4[:1], k4[:1], v4[:1], sm_scale=72 ** -0.5,
                kv_valid=m4[:1], emit_lse=True), device_ms, 50)]
    if "K3" in picked:
        q3, k3, v3 = _inputs(1, 33 * 45 * 80 + 256, 24, 128, gen)
        calls["K3"] = [("K3", lambda: A.flash_fwd(
            q3, k3, v3, sm_scale=128 ** -0.5, static_max=0.0, route="K3"),
            _time_ms, 3)]
    if "K5" in picked:
        q5, k5, v5 = (torch.randn((32, 256, 16, 72), generator=gen,
                                  device="cuda").bfloat16()
                      for _ in range(3))
        calls["K5"] = [
            ("K5", lambda: A.flash_fwd(q5[:16], k5[:16], v5[:16],
                                       sm_scale=72 ** -0.5, emit_lse=True,
                                       route="K5"), device_ms, 50),
            ("K2", lambda: A.flash_fwd(q5, k5, v5, sm_scale=72 ** -0.5,
                                       route="K2"), device_ms, 50)]
    if "K7" in picked:
        q7, k7, v7 = _inputs(1, 17776, 30, 64, gen)
        g7 = torch.randn(q7.shape, generator=gen, device="cuda").bfloat16()
        o7, lse7 = A.flash_fwd(q7, k7, v7, sm_scale=0.125, static_max=0.0,
                               emit_lse=True)
        calls["K7"] = [("K7", lambda: A.flash_bwd(
            q7, k7, v7, o7, g7, lse7, sm_scale=0.125), _time_ms, 5)]
    if "K5_d128" in picked or "K8_d128" in picked:
        qh, kh, vh = _inputs(1, 7456, 24, 128, gen)
        gh = torch.randn(qh.shape, generator=gen, device="cuda").bfloat16()
        oh, lseh = A.flash_fwd(qh, kh, vh, sm_scale=128 ** -0.5,
                               static_max=0.0, emit_lse=True, route="K5")
        calls["K5_d128"] = [("K5_d128", lambda: A.flash_fwd(
            qh, kh, vh, sm_scale=128 ** -0.5, static_max=0.0, emit_lse=True,
            route="K5"), _time_ms, 10)]
        calls["K8_d128"] = [("K8_d128", lambda: A.flash_bwd(
            qh, kh, vh, oh, gh, lseh, sm_scale=128 ** -0.5), _time_ms, 5)]
        for name in ("K5_d128", "K8_d128"):
            if name not in picked:
                del calls[name]
    if "K6" in picked:
        q6, k6, v6 = (torch.randn((2, s, 4, 64), generator=gen,
                                  device="cuda").bfloat16()
                      for s in (300, 4322, 4322))
        calls["K6"] = [
            ("K6", lambda: A.flash_fwd(q6, k6, v6, sm_scale=0.125,
                                       route="K6"), device_ms, 20)] + [
            (f"K6_splits_{n}", (lambda n=n: A._flash_fwd_sm90(
                q6, k6, v6, 0.125, None, False, splits=n)), device_ms, 20)
            for n in (1, 3, 6)]
    if "K2_f32" in picked:
        qf, kf, vf = (torch.randn((1, 256, 32, 128), generator=gen,
                                  device="cuda") for _ in range(3))
        calls["K2_f32"] = [("K2_f32", lambda: A.flash_fwd(
            qf, kf, vf, sm_scale=128 ** -0.5, causal=True), device_ms, 50)]
    if "K8" in picked:
        calls["K8"] = [
            (label, (lambda t=t: A.flash_bwd(
                *t[:6], sm_scale=72 ** -0.5, kv_valid=t[6], mask_words=t[7])),
             device_ms, 50) for label, t in _k8_inputs(gen).items()]
    base = {}
    for (kernel, source, name), edits in VARIANTS.items():
        for label, fn, timer, reps in calls.get(kernel, ()):
            ms = _with_variant(source, f"{kernel}_{name}", edits,
                               lambda: timer(fn, reps))
            base.setdefault(label, ms)
            print(f"[attribution] kernel={label} source={source} "
                  f"variant={name} ms={ms:.4f} "
                  f"saved_ms={base[label] - ms:.4f}", flush=True)


if __name__ == "__main__":
    main()
