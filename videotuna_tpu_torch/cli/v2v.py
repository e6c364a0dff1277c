"""Video-to-video enhancement CLI of the port, the counterpart of
``videotuna_tpu/cli/v2v.py``: every video under the input directory through
the flow's ``enhance`` (SDEdit over the configured scheduler, or
``V2VEnhanceFlow``'s concat-conditioned generation), written to the output
directory under its own name.

Usage:
    python -m videotuna_tpu_torch.cli.v2v \
        --config configs/011_v2v/v2v_ms.yaml --input-dir DIR \
        [--output-dir DIR] [--prompt TEXT] [--strength 0.4] \
        [--ckpt PATH] [--device cpu] [key.sub=value ...]

A video's prompt is ``--prompt``, else its ``<name>.txt`` beside it, else
``inference.prompt``.  Beside the videos the output directory gets
``metric.json`` (port only): the seconds of each video's enhance (encode,
sampling, decode) and of the run.  Runs on ``cuda`` unless ``--device``
says otherwise.

The configs name ``inference.input_dir: inputs/v2v/001``, which the
repository lacks (ROADMAP.md queue 3): pass ``--input-dir``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from videotuna_tpu_torch.core.config import load_configs
from videotuna_tpu_torch.core.monitor import save_metrics
from videotuna_tpu_torch.core.prng import KeyChain
from videotuna_tpu_torch.core.registry import instantiate, populate

VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("videotuna-tpu-torch v2v")
    p.add_argument("--config", "-b", action="append", required=True)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu must be asked for)")
    p.add_argument("--input-dir", default=None)
    p.add_argument("--output-dir", "--savedir", dest="output_dir",
                   default=None)
    p.add_argument("--prompt", default=None,
                   help="guidance prompt (default: the video's .txt sidecar "
                        "or inference.prompt)")
    p.add_argument("--strength", type=float, default=None)
    p.add_argument("--ckpt", default=None,
                   help="checkpoint of the port (overrides flow.pretrained)")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("overrides", nargs="*")
    return p


def run_v2v(argv: Optional[List[str]] = None) -> dict:
    from videotuna_tpu_torch.data.video_io import load_video, save_video

    args = build_parser().parse_args(argv)
    config = load_configs(args.config, args.overrides)
    inf = config.setdefault("inference", {})
    input_dir = args.input_dir or inf.get("input_dir", "inputs/v2v/001")
    output_dir = args.output_dir or inf.get("savedir", "results/v2v")
    strength = (args.strength if args.strength is not None
                else float(inf.get("strength", 0.4)))
    cfg_scale = float(inf.get("unconditional_guidance_scale", 7.5))
    fps = int(inf.get("fps", 8))
    seed = int(inf.get("seed", 42))

    videos = sorted(
        f for f in os.listdir(input_dir)
        if f.lower().endswith(VIDEO_EXTS)) if os.path.isdir(input_dir) else []
    if not videos:
        raise FileNotFoundError(f"no videos found under {input_dir!r}")

    populate()
    flow = instantiate(config["flow"], device=args.device)
    flow.init_params(seed=seed)
    ckpt = args.ckpt or config["flow"].get("pretrained")
    if ckpt:
        flow.from_pretrained(ckpt)
    else:
        print("[videotuna-tpu-torch] no checkpoint given — using random "
              "init", file=sys.stderr)
    os.makedirs(output_dir, exist_ok=True)

    keys = KeyChain(seed, flow.device)
    results, per_video, t0 = [], {}, time.perf_counter()
    uncond = flow.encode_text([""]) if cfg_scale != 1.0 else None
    for name in videos:
        t_v = time.perf_counter()
        path = os.path.join(input_dir, name)
        video = load_video(path)           # (T, H, W, 3) uint8
        if video.dtype == np.uint8:
            video = video.astype(np.float32) / 127.5 - 1.0
        sidecar = os.path.splitext(path)[0] + ".txt"
        if args.prompt is not None:
            prompt = args.prompt
        elif os.path.isfile(sidecar):
            with open(sidecar) as f:
                prompt = f.read().strip()
        else:
            prompt = str(inf.get("prompt", ""))
        cond = flow.encode_text([prompt])
        out = flow.enhance(torch.from_numpy(video)[None].to(flow.device),
                           cond, keys("enhance"), strength=strength,
                           cfg_scale=cfg_scale, uncond=uncond)
        out = out[0].float().cpu().numpy()
        per_video[name] = time.perf_counter() - t_v
        results.append(save_video(out, os.path.join(output_dir, name),
                                  fps=fps))
    seconds = time.perf_counter() - t0
    save_metrics({"time_sec": seconds, "num_videos": len(results),
                  "per_video_sec": per_video, "strength": strength,
                  "device": str(flow.device)}, output_dir, config)
    if not args.quiet:
        print(f"[videotuna-tpu-torch] enhanced {len(results)} video(s) in "
              f"{seconds:.1f}s → {output_dir}")
    return {"videos": results, "time_sec": seconds}


if __name__ == "__main__":
    run_v2v()
