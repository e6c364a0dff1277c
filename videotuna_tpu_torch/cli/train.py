"""Training CLI of the port: YAML + CLI merge → flow on the chosen device
with seeded random weights → dataset and loader → ``Trainer.fit`` with
auto-resume, the counterpart of ``videotuna_tpu/cli/train.py``.

Usage:
    python -m videotuna_tpu_torch.cli.train --config configs/.../x.yaml \
        [--device cpu] [--workdir DIR] [--resume] [key.sub=value ...]

Runs on ``cuda`` unless ``--device`` says otherwise.  Checkpoints are the
port's own (``core/checkpoint.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional

from videotuna_tpu_torch.core.config import (check_required, format_config,
                                             load_configs)
from videotuna_tpu_torch.core.registry import instantiate, populate
from videotuna_tpu_torch.data.datasets import EpochLoader
from videotuna_tpu_torch.training.trainer import TrainConfig, Trainer


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("videotuna-tpu-torch train")
    p.add_argument("--config", "-b", action="append", required=True,
                   help="YAML config file(s), merged left to right")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu must be asked for)")
    p.add_argument("--workdir", default=None)
    p.add_argument("--resume", "--auto_resume", action="store_true",
                   help="resume from the newest checkpoint in workdir")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("overrides", nargs="*",
                   help="dotlist overrides key.sub=value")
    return p


def build_trainer(argv: Optional[List[str]] = None):
    """Parse ``argv`` and build (trainer, loader, args) without training."""
    args = build_parser().parse_args(argv)
    config = load_configs(args.config, args.overrides)
    check_required(config, ["flow.target", "train"])
    if not args.quiet:
        print(format_config(config, "train config"))
    if config["flow"].get("pretrained"):
        raise NotImplementedError(
            "flow.pretrained: the port reads no JAX (orbax) checkpoint; "
            "weights are random from the seed, or carried across with "
            "tools/from_jax.py")

    tcfg_raw = dict(config.get("train", {}))
    mesh_cfg = tcfg_raw.pop("mesh", None) or {}
    if any(int(v) > 1 for v in mesh_cfg.values()):
        raise NotImplementedError(
            f"train.mesh {mesh_cfg}: multi-device training waits for the "
            "parallelism slice (ROADMAP.md slice F)")
    seed = int(tcfg_raw.pop("seed", 42))
    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    tcfg = TrainConfig(**{k: v for k, v in tcfg_raw.items() if k in fields})
    if args.max_steps:
        tcfg.max_steps = args.max_steps

    populate()
    flow = instantiate(config["flow"], device=args.device)
    flow.init_params(seed=seed)

    data_cfg = config.get("data", {})
    if "dataset" not in data_cfg:
        raise ValueError("train config needs data.dataset: {target:, params:}")
    dataset = instantiate(data_cfg["dataset"])
    loader = EpochLoader(dataset, batch_size=int(data_cfg.get("batch_size",
                                                              1)),
                         seed=seed)
    workdir = args.workdir or config.get("workdir", "logs/run")
    return Trainer(flow, tcfg, workdir=workdir, seed=seed), loader, args


def run_train(argv: Optional[List[str]] = None):
    trainer, loader, args = build_trainer(argv)
    state = trainer.init_state()
    if args.resume:
        state = trainer.maybe_resume(state)
    state = trainer.fit(loader, state)
    if not args.quiet and trainer.metrics_history:
        last = trainer.metrics_history[-1]
        print(f"[videotuna-tpu-torch] done at step {last['step']}: "
              f"loss={last['loss']:.4f} "
              f"({last['steps_per_sec']:.2f} steps/s)")
    return state


if __name__ == "__main__":
    run_train()
