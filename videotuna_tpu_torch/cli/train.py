"""Training CLI of the port: YAML + CLI merge → flow on the chosen device
with seeded random weights, then ``flow.pretrained``'s → dataset and
loader → ``Trainer.fit`` with auto-resume, the counterpart of
``videotuna_tpu/cli/train.py``.

Usage:
    python -m videotuna_tpu_torch.cli.train --config configs/.../x.yaml \
        [--device cpu] [--workdir DIR] [--resume] [key.sub=value ...]

Runs on ``cuda`` unless ``--device`` says otherwise.  Checkpoints are the
port's own (``core/checkpoint.py``).  ``train.mesh`` ({dp, fsdp, sp, tp})
builds the mesh over the ranks ``torchrun`` started (all of them on ``dp``
without it), e.g. on four cards:

    python -m torch.distributed.run --nproc-per-node 4 -m videotuna_tpu_torch \
        train-cogvideox-t2v-lora ... train.mesh.fsdp=4
"""

from __future__ import annotations

import argparse
import dataclasses
import random
from typing import List, Optional

from videotuna_tpu_torch.core.config import (check_required, format_config,
                                             load_configs)
from videotuna_tpu_torch.core.mesh import build_mesh
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

    tcfg_raw = dict(config.get("train", {}))
    device, mesh = build_mesh(tcfg_raw.pop("mesh", None), args.device)
    seed = int(tcfg_raw.pop("seed", 42))
    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    tcfg = TrainConfig(**{k: v for k, v in tcfg_raw.items() if k in fields})
    if args.max_steps:
        tcfg.max_steps = args.max_steps

    populate()
    flow = instantiate(config["flow"], device=device)
    flow.init_params(seed=seed)
    if config["flow"].get("pretrained"):
        # a checkpoint of the port: save_pretrained's or ckpt_tools'
        flow.from_pretrained(config["flow"]["pretrained"])

    data_cfg = config.get("data", {})
    if "dataset" not in data_cfg:
        raise ValueError("train config needs data.dataset: {target:, params:}")
    dataset = instantiate(data_cfg["dataset"])
    if mesh.size > 1:
        # the transforms' crops draw from the ``random`` module: seeded with
        # the run's seed, every rank's host pipeline gives the same global
        # batch, of which each takes its block
        random.seed(seed)
    loader = EpochLoader(dataset, batch_size=int(data_cfg.get("batch_size",
                                                              1)),
                         seed=seed)
    workdir = args.workdir or config.get("workdir", "logs/run")
    return (Trainer(flow, tcfg, workdir=workdir, seed=seed, mesh=mesh),
            loader, args)


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
