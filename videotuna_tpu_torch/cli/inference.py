"""Inference CLI of the port: YAML + CLI merge → flow on the chosen device →
seeded random weights → monitored ``flow.inference(config)``.

Usage:
    python -m videotuna_tpu_torch.cli.inference --config configs/.../x.yaml \
        [--device cpu] [key.sub=value ...]

Runs on ``cuda`` unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from videotuna_tpu_torch.core.config import (apply_inference_mapping,
                                             check_required, format_config,
                                             load_configs)
from videotuna_tpu_torch.core.monitor import monitor_resources
from videotuna_tpu_torch.core.registry import instantiate, populate


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("videotuna-tpu-torch inference")
    p.add_argument("--config", "-b", action="append", required=True,
                   help="YAML config file(s), merged left to right")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu must be asked for)")
    p.add_argument("--ckpt", default=None,
                   help="checkpoint dir (not ported yet)")
    p.add_argument("--lora", default=None, metavar="PATH",
                   help="LoRA-only checkpoint (not ported yet)")
    p.add_argument("--lora-alpha", type=float, default=None)
    p.add_argument("--savedir", default=None)
    p.add_argument("--prompt", default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--shard", default=None, metavar="I/N",
                   help="process only the i-th of N prompt shards")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("overrides", nargs="*",
                   help="dotlist overrides key.sub=value")
    return p


def run_inference(argv: Optional[List[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    config = load_configs(args.config, args.overrides)
    config = apply_inference_mapping(config)
    inf = config.setdefault("inference", {})
    for k in ("savedir", "prompt", "seed"):
        v = getattr(args, k)
        if v is not None:
            inf[k] = v
    if args.ckpt or config["flow"].get("pretrained"):
        raise NotImplementedError(
            "checkpoint loading is not ported yet: weights are random from "
            "the seed, or carried across with tools/from_jax.py")
    if args.lora:
        raise NotImplementedError("LoRA merging waits for the training slice")
    if str(inf.get("quantize", "")) == "int8":
        raise NotImplementedError(
            "int8 serving waits for the quantization slice")
    if inf.get("mesh"):
        raise NotImplementedError(
            "multi-device inference waits for the parallelism slice")
    if args.shard:
        i, _, n = args.shard.partition("/")
        from videotuna_tpu_torch.flows.generation import load_prompts
        inf["prompts_list"] = load_prompts(inf)[int(i)::int(n)]
    check_required(config, ["flow.target"])
    if not args.quiet:
        print(format_config(config, "inference config"))

    populate()
    flow = instantiate(config["flow"], device=args.device)
    print("[videotuna-tpu-torch] no checkpoint given — using random init",
          file=sys.stderr)
    flow.init_params(seed=int(inf.get("seed", 0)))
    result, metrics = monitor_resources()(flow.inference)(config)
    result["metrics"]["resources"] = metrics
    if not args.quiet:
        print(f"[videotuna-tpu-torch] wrote {len(result['videos'])} video(s) "
              f"in {metrics['time_sec']}s → {inf.get('savedir')}")
    return result


if __name__ == "__main__":
    run_inference()
