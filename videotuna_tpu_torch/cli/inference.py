"""Inference CLI of the port: YAML + CLI merge → flow on the chosen device →
seeded random weights, then the checkpoint's (``--ckpt`` or
``flow.pretrained``) → monitored ``flow.inference(config)``.

Usage:
    python -m videotuna_tpu_torch.cli.inference --config configs/.../x.yaml \
        [--device cpu] [key.sub=value ...]

Runs on ``cuda`` unless ``--device`` says otherwise.  ``inference.mesh``
({dp, fsdp, sp, tp}) builds the mesh over the ranks ``torchrun`` started:
the denoiser's weights go through FSDP2 over ``fsdp``, or the flow's
``shard_for_tp`` over ``tp``; ``sp`` above 1 routes long self-attention
through Ulysses SP.  Every rank draws the same noise and samples the same
videos; rank 0 alone writes them and ``metric.json``.  E.g. StepVideo's
``tp: 4`` on four cards:

    python -m torch.distributed.run --nproc-per-node 4 -m videotuna_tpu_torch \
        inference-stepvideo-t2v-544x992 --prompt "a koi pond"
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
from typing import List, Optional

from videotuna_tpu_torch.core.config import (apply_inference_mapping,
                                             check_required, format_config,
                                             load_configs)
from videotuna_tpu_torch.core.mesh import build_mesh, use_mesh
from videotuna_tpu_torch.core.monitor import monitor_resources
from videotuna_tpu_torch.core.registry import instantiate, populate


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("videotuna-tpu-torch inference")
    p.add_argument("--config", "-b", action="append", required=True,
                   help="YAML config file(s), merged left to right")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu must be asked for)")
    p.add_argument("--ckpt", default=None,
                   help="checkpoint of the port (a step dir, or a root whose "
                        "newest step dir is taken; overrides "
                        "flow.pretrained)")
    p.add_argument("--lora", default=None, metavar="PATH",
                   help="LoRA-only checkpoint of the port's trainer (a "
                        "step_<n> dir or its lora.pt) to merge into the "
                        "weights")
    p.add_argument("--lora-alpha", type=float, default=None,
                   help="merge scale (default: train.lora.alpha or 1.0)")
    p.add_argument("--savedir", default=None)
    p.add_argument("--prompt", default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--shard", default=None, metavar="I/N",
                   help="process only the i-th of N prompt shards")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("overrides", nargs="*",
                   help="dotlist overrides key.sub=value")
    return p


def merge_lora_checkpoint(flow, path: str, alpha: Optional[float],
                          config: dict) -> None:
    """Merge a LoRA-only checkpoint ({component: delta tree}, the trainer's
    ``lora.pt``) into the flow's weights.  A JAX (orbax) LoRA directory
    cannot be read: orbax needs JAX."""
    import torch
    from videotuna_tpu_torch.training.lora import merge_lora
    if os.path.isdir(path):
        if os.path.isdir(os.path.join(path, "lora")) \
                and not os.path.isfile(os.path.join(path, "lora.pt")):
            raise NotImplementedError(
                f"{path} holds an orbax LoRA checkpoint of the JAX package; "
                "the port reads its own lora.pt (carry a JAX tree across "
                "with tools/from_jax.load_jax_lora)")
        path = os.path.join(path, "lora.pt")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"LoRA checkpoint not found: {path}")
    tree = torch.load(path, map_location=flow.device, weights_only=True)
    if alpha is None:
        alpha = float(config.get("train", {}).get("lora", {})
                      .get("alpha", 1.0))
    comps = flow.components()
    merged = [c for c in tree if c in comps]
    if not merged:
        raise ValueError(f"LoRA checkpoint {path!r} has no components "
                         f"matching the flow's ({sorted(comps)})")
    for c in merged:
        merge_lora(comps[c], tree[c], alpha)


@contextlib.contextmanager
def shard_flow(flow, mesh):
    """The flow's denoiser sharded over ``mesh`` (FSDP2 over ``fsdp``, the
    flow's ``shard_for_tp`` over ``tp``) and the scopes its sampling runs
    in: the mesh, and ``sequence_parallel`` when ``sp`` is above 1 (JAX
    ``cli/inference.py:106-127``)."""
    if mesh is None or mesh.size == 1:
        yield
        return
    from videotuna_tpu_torch.kernels.attention import sequence_parallel
    from videotuna_tpu_torch.parallel.sharding import shard_params
    if mesh.shape["tp"] > 1 and hasattr(flow, "shard_for_tp"):
        flow.shard_for_tp(mesh)
    else:
        shard_params(flow.denoiser, mesh)
    with contextlib.ExitStack() as stack:
        stack.enter_context(use_mesh(mesh))
        if mesh.shape["sp"] > 1:
            stack.enter_context(sequence_parallel(mesh))
        yield


def run_inference(argv: Optional[List[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    config = load_configs(args.config, args.overrides)
    config = apply_inference_mapping(config)
    inf = config.setdefault("inference", {})
    for k in ("savedir", "prompt", "seed"):
        v = getattr(args, k)
        if v is not None:
            inf[k] = v
    device, mesh = args.device, None
    if inf.get("mesh"):
        device, mesh = build_mesh(inf["mesh"], args.device)
    if args.shard:
        i, _, n = args.shard.partition("/")
        from videotuna_tpu_torch.flows.generation import load_prompts
        inf["prompts_list"] = load_prompts(inf)[int(i)::int(n)]
    check_required(config, ["flow.target"])
    if not args.quiet:
        print(format_config(config, "inference config"))

    populate()
    flow = instantiate(config["flow"], device=device)
    # seeded weights first: a component the checkpoint lacks keeps them
    flow.init_params(seed=int(inf.get("seed", 0)))
    ckpt = args.ckpt or config["flow"].get("pretrained")
    if ckpt:
        flow.from_pretrained(ckpt)
    else:
        print("[videotuna-tpu-torch] no checkpoint given — using random "
              "init", file=sys.stderr)
    if args.lora:
        merge_lora_checkpoint(flow, args.lora, args.lora_alpha, config)
    if str(inf.get("quantize", "")) == "int8":
        # w8a8 serving (tools/int8.py): an int8-resident denoiser, applied
        # after any LoRA merge
        flow.quantize_int8()
    with shard_flow(flow, mesh):
        result, metrics = monitor_resources()(flow.inference)(config)
    result["metrics"]["resources"] = metrics
    if not args.quiet:
        print(f"[videotuna-tpu-torch] wrote {len(result['videos'])} video(s) "
              f"in {metrics['time_sec']}s → {inf.get('savedir')}")
    return result


if __name__ == "__main__":
    run_inference()
