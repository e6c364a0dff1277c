"""The port's command registry, the counterpart of
``videotuna_tpu/cli/commands.py``: the same command names, each bound to a
config and a mode, and the same aliases and dev commands.

    python -m videotuna_tpu_torch list
    python -m videotuna_tpu_torch train-tiny-t2v --device cpu --workdir DIR
    python -m videotuna_tpu_torch train-hunyuan-t2v-lora train.mesh.fsdp=1

A train, inference or v2v command whose flow the port builds runs the port's
``run_train`` / ``run_inference`` / ``run_v2v`` with the command's config,
its overrides and the rest of the command line (``--device``,
``--input-dir``, dotlist overrides); ``serve`` runs ``cli/serve.main`` with
the rest of the line (``--config``, ``--device``, ``--port``, …); the
device is ``cuda`` unless the line asks for another.  Every other command,
and ``eval``, prints the queue of ``ROADMAP.md`` it waits for and returns
2: the port never hands a command to the JAX package.
"""

from __future__ import annotations

import subprocess
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

CONFIG_ROOT = "configs"


@dataclass
class Command:
    name: str
    mode: str                    # inference | train | v2v | eval
    configs: List[str]
    overrides: List[str] = field(default_factory=list)
    description: str = ""


def _c(name, mode, cfg, desc="", overrides=None):
    return Command(name, mode, [f"{CONFIG_ROOT}/{cfg}"],
                   overrides or [], desc)


COMMANDS: Dict[str, Command] = {c.name: c for c in [
    # tiny smoke commands (runnable anywhere)
    _c("inference-tiny-t2v", "inference", "000_tiny/tiny_t2v.yaml",
       "tiny STDiT T2V smoke run"),
    _c("train-tiny-t2v", "train", "000_tiny/tiny_t2v.yaml",
       "tiny STDiT training smoke run"),
    _c("inference-tiny-cogvideox", "inference",
       "000_tiny/tiny_cogvideox.yaml", "tiny CogVideoX smoke run"),
    _c("inference-tiny-hunyuan", "inference", "000_tiny/tiny_hunyuan.yaml",
       "tiny HunyuanVideo smoke run"),
    # VideoCrafter family
    _c("inference-vc2-t2v-320x512", "inference",
       "001_videocrafter2/vc2_t2v_320x512.yaml",
       "VideoCrafter2 T2V 320x512"),
    _c("inference-vc2-t2v-320x512-lora", "inference",
       "001_videocrafter2/vc2_t2v_lora.yaml",
       "VideoCrafter2 T2V with LoRA (pass --lora PATH)"),
    _c("train-videocrafter-v2", "train",
       "001_videocrafter2/vc2_t2v_320x512.yaml",
       "VideoCrafter2 full fine-tune"),
    _c("train-videocrafter-lora", "train",
       "001_videocrafter2/vc2_t2v_lora.yaml",
       "VideoCrafter2 LoRA fine-tune"),
    _c("inference-dc-i2v-576x1024", "inference",
       "002_dynamicrafter/dc_i2v_576x1024.yaml", "DynamiCrafter I2V"),
    _c("train-dynamicrafter", "train",
       "002_dynamicrafter/dc_i2v_training.yaml",
       "DynamiCrafter I2V fine-tune"),
    # Open-Sora
    _c("inference-opensora-v10-16x256x256", "inference",
       "003_opensora/opensorav10_256x256.yaml", "Open-Sora v1.0 T2V"),
    _c("train-opensorav10", "train",
       "003_opensora/opensorav10_256x256.yaml", "Open-Sora v1.0 training"),
    # CogVideoX
    _c("inference-cogvideo-t2v-diffusers", "inference",
       "004_cogvideox/cogvideo2b.yaml", "CogVideoX-2b T2V"),
    _c("inference-cogvideo-i2v-diffusers", "inference",
       "004_cogvideox/cogvideo5b_i2v.yaml", "CogVideoX-5b I2V"),
    _c("inference-cogvideo-lora", "inference",
       "004_cogvideox/cogvideo5b.yaml",
       "CogVideoX-5b T2V with LoRA (pass --lora PATH)"),
    _c("inference-cogvideo-i2v-lora", "inference",
       "004_cogvideox/cogvideo5b_i2v.yaml",
       "CogVideoX-5b I2V with LoRA (pass --lora PATH)"),
    _c("inference-cogvideox-15-5b-t2v", "inference",
       "005_cogvideox1.5/cogvideox1.5_5b_t2v.yaml", "CogVideoX-1.5 5B T2V"),
    _c("inference-cogvideox-15-5b-i2v", "inference",
       "005_cogvideox1.5/cogvideox1.5_5b_i2v.yaml", "CogVideoX-1.5 5B I2V"),
    _c("train-cogvideox-t2v-lora", "train",
       "004_cogvideox/cogvideo2b_lora.yaml", "CogVideoX LoRA"),
    _c("train-cogvideox-t2v-fullft", "train",
       "004_cogvideox/cogvideo2b.yaml", "CogVideoX full fine-tune"),
    _c("train-cogvideox-i2v-lora", "train",
       "004_cogvideox/cogvideo5b_i2v_lora.yaml", "CogVideoX-5b I2V LoRA"),
    _c("train-cogvideox-i2v-fullft", "train",
       "004_cogvideox/cogvideo5b_i2v_fullft.yaml",
       "CogVideoX-5b I2V full fine-tune"),
    # HunyuanVideo
    _c("inference-hunyuan-t2v", "inference",
       "007_hunyuanvideo/hunyuanvideo_t2v.yaml", "HunyuanVideo T2V 720p"),
    _c("inference-hunyuan-i2v-720p", "inference",
       "007_hunyuanvideo/hunyuanvideo_i2v.yaml", "HunyuanVideo I2V 720p"),
    _c("train-hunyuan-t2v-lora", "train",
       "007_hunyuanvideo/hunyuanvideo_t2v_lora.yaml",
       "HunyuanVideo T2V LoRA"),
    # Wan
    _c("inference-wanvideo-t2v-720p", "inference",
       "008_wanvideo/wan2_1_t2v_14B.yaml", "Wan2.1 T2V 14B 720p"),
    _c("inference-wanvideo-t2v-1-3B", "inference",
       "008_wanvideo/wan2_1_t2v_1_3B.yaml", "Wan2.1 T2V 1.3B"),
    _c("inference-wanvideo-i2v-720p", "inference",
       "008_wanvideo/wan2_1_i2v_14B.yaml", "Wan2.1 I2V 14B 720p"),
    # StepVideo
    _c("inference-stepvideo-t2v-544x992", "inference",
       "009_stepvideo/stepvideo_t2v.yaml", "StepVideo T2V 544x992"),
    # Mochi
    _c("inference-mochi", "inference", "010_mochi/mochi_t2v.yaml",
       "Mochi-1 T2V 480x848"),
    # v2v enhancement
    _c("inference-v2v-ms", "v2v", "011_v2v/v2v_ms.yaml",
       "video-to-video enhancement (SDEdit over VC2)"),
    # VideoCrafter1
    _c("inference-vc1-t2v-576x1024", "inference",
       "000_videocrafter/vc1_t2v_576x1024.yaml",
       "VideoCrafter1 T2V 576x1024"),
    _c("inference-vc1-i2v-320x512", "inference",
       "000_videocrafter/vc1_i2v_320x512.yaml",
       "VideoCrafter1 I2V 320x512"),
    # Flux
    _c("inference-flux-dev", "inference", "006_flux/flux_dev.yaml",
       "Flux-dev T2I"),
    _c("inference-flux-schnell", "inference", "006_flux/flux_schnell.yaml",
       "Flux-schnell T2I"),
    _c("inference-flux-lora", "inference", "006_flux/flux_lora.yaml",
       "Flux-dev T2I with LoRA (pass --lora PATH)"),
    _c("train-flux-lora", "train", "006_flux/flux_lora.yaml", "Flux LoRA"),
]}

# earlier spellings kept as aliases of the reference-exact names
ALIASES: Dict[str, str] = {
    "inference-vc2-t2v-320-512": "inference-vc2-t2v-320x512",
    "inference-vc1-t2v-576-1024": "inference-vc1-t2v-576x1024",
    "inference-vc1-i2v-320-512": "inference-vc1-i2v-320x512",
    "inference-dc-i2v-576-1024": "inference-dc-i2v-576x1024",
    "inference-cogvideox1.5-5b-t2v": "inference-cogvideox-15-5b-t2v",
    "inference-cogvideox1.5-5b-i2v": "inference-cogvideox-15-5b-i2v",
    "inference-hunyuan-t2v-720p": "inference-hunyuan-t2v",
}

# The commands the port does not run yet, with the queue of ROADMAP.md each
# waits for; every other command of COMMANDS runs the port's own CLI.
_COGVIDEOX_I2V_TRAIN = ("ROADMAP.md queue 1, item 3 (CogVideoX i2v "
                        "training), and queue 3's i2v-training fault: no "
                        "dataset or trainer fills batch['image_latents']")
_DC_TRAIN = ("ROADMAP.md queue 3's DynamiCrafter training fault: the JAX "
             "package's training_loss builds no image latents, so its "
             "8-channel UNet gets the 4 latent channels (and no image "
             "tokens), and no dataset fills them")
WAITING: Dict[str, str] = {
    "train-dynamicrafter": _DC_TRAIN,
    "train-cogvideox-i2v-lora": _COGVIDEOX_I2V_TRAIN,
    "train-cogvideox-i2v-fullft": _COGVIDEOX_I2V_TRAIN,
    "train-flux-lora": "ROADMAP.md queue 3's Flux-training fault: the JAX "
                       "package's FluxFlow.training_loss reads "
                       "batch['latents'], which no dataset or trainer fills "
                       "(a dataset batch raises KeyError 'latents')",
    "eval": "ROADMAP.md queue 1, item 10.5 (slice F: the evalkit)",
}

# dev-tooling commands: name → (argv, description); the two install steps
# have nothing to install for the port
DEV_COMMANDS: Dict[str, tuple] = {
    "test": ([sys.executable, "-m", "pytest", "tests/", "-q", "-k",
              "torch_port"], "run the port's tests"),
    "coverage-report": ([sys.executable, "-m", "pytest", "tests/", "-q",
                         "-k", "torch_port", "--cov=videotuna_tpu_torch",
                         "--cov-report=term"],
                        "the port's tests with coverage"),
    "format": ([sys.executable, "-m", "ruff", "format",
                "videotuna_tpu_torch", "tests"], "auto-format (ruff)"),
    "format-check": ([sys.executable, "-m", "ruff", "format", "--check",
                      "videotuna_tpu_torch", "tests"], "format check"),
    "lint": ([sys.executable, "-m", "ruff", "check", "videotuna_tpu_torch",
              "tests"], "lint (ruff)"),
    "type-check": ([sys.executable, "-m", "mypy", "videotuna_tpu_torch"],
                   "type check (mypy)"),
    "install-deepspeed": (None, "no-op: the port shards with PyTorch's "
                          "FSDP2 (train.mesh.fsdp under torchrun), no "
                          "DeepSpeed"),
    "install-flash-attn": (None, "no-op: the port's flash attention is its "
                           "own CUDA kernels (videotuna_tpu_torch/kernels/"
                           "csrc), built with nvcc at first use"),
}


def run_dev_command(name: str, extra: Sequence[str] = ()) -> int:
    argv, desc = DEV_COMMANDS[name]
    if argv is None:
        print(f"[videotuna-tpu-torch] {name}: {desc}")
        return 0
    try:
        return subprocess.run([*argv, *extra], check=False).returncode
    except FileNotFoundError:
        print(f"[videotuna-tpu-torch] {name}: tool not installed "
              f"({argv[2] if len(argv) > 2 else argv[0]})", file=sys.stderr)
        return 1


def list_commands() -> str:
    width = max(len(n) for n in COMMANDS) + 2
    lines = ["available commands (* waits for a later slice of the port):"]
    for name, cmd in sorted(COMMANDS.items()):
        mark = "*" if name in WAITING else " "
        lines.append(f" {mark}{name.ljust(width)}{cmd.description}")
    for name, (_, desc) in sorted(DEV_COMMANDS.items()):
        lines.append(f"  {name.ljust(width)}{desc}")
    lines.append(" *" + "eval <videos_dir>".ljust(width)
                 + "VBench-style evaluation")
    lines.append("  " + "serve --config <yaml>".ljust(width)
                 + "HTTP inference server")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    if not argv or argv[0] in ("-h", "--help", "list"):
        print(list_commands())
        return 0
    name, rest = argv[0], argv[1:]
    name = ALIASES.get(name, name)
    if name in DEV_COMMANDS:
        return run_dev_command(name, rest)
    if name == "serve":
        from videotuna_tpu_torch.cli.serve import main as serve_main
        serve_main(rest)
        return 0
    if name not in COMMANDS and name not in WAITING:
        print(f"unknown command {name!r}\n\n{list_commands()}",
              file=sys.stderr)
        return 2
    if name in WAITING:
        print(f"[videotuna-tpu-torch] {name} is not ported yet: it waits "
              f"for {WAITING[name]}", file=sys.stderr)
        return 2
    cmd = COMMANDS[name]
    args = []
    for cfg in cmd.configs:
        args += ["--config", cfg]
    args += cmd.overrides + rest
    if cmd.mode == "inference":
        from videotuna_tpu_torch.cli.inference import run_inference
        run_inference(args)
    elif cmd.mode == "v2v":
        from videotuna_tpu_torch.cli.v2v import run_v2v
        run_v2v(args)
    else:
        from videotuna_tpu_torch.cli.train import run_train
        run_train(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
