"""The port's command registry, the trainer's prefetcher and HunyuanVideo
LoRA training on the CPU, against the JAX package where it has the same
function.

- ``cli/commands.py``: the same command names, aliases, dev commands,
  configs and overrides as ``videotuna_tpu/cli/commands.py``; a command
  the port runs dispatches to the port's CLI, any other returns 2 and names
  the queue of ROADMAP.md it waits for.
- ``DevicePrefetcher``: the plain loop's batches in its order, a loader's
  error raised in the consumer, the worker stopped when the consumer
  leaves, and ``fit``'s losses equal with and without it.
- ``tiny_hunyuan.yaml`` trains LoRA for 2 steps; a run stopped after 1 and
  resumed reaches the same step-2 state.
"""

import json
import os
import random
import threading

import numpy as np
import pytest
import torch

from videotuna_tpu.cli import commands as jcommands
from videotuna_tpu.core import config as jconfig
from videotuna_tpu.core import registry as jregistry
from videotuna_tpu_torch.cli import commands as pcommands
from videotuna_tpu_torch.cli import entrypoints as pentry
from videotuna_tpu_torch.core import config as pconfig
from videotuna_tpu_torch.core import registry as pregistry
from videotuna_tpu_torch.data.prefetch import DevicePrefetcher, to_device
from videotuna_tpu_torch.training import lora as plora

from tests.test_torch_port_flow import TINY_HUNYUAN, TINY_T2V
from tests.test_torch_port_models import torch_one_thread  # noqa: F401
from tests.test_torch_port_training_run import _assert_same, _state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------- registry
def test_registry_names_configs_and_overrides_match_jax():
    assert set(pcommands.COMMANDS) == set(jcommands.COMMANDS)
    assert pcommands.ALIASES == jcommands.ALIASES
    assert set(pcommands.DEV_COMMANDS) == set(jcommands.DEV_COMMANDS)
    for name, cmd in pcommands.COMMANDS.items():
        ref = jcommands.COMMANDS[name]
        assert (cmd.mode, cmd.configs, cmd.overrides, cmd.description) == \
            (ref.mode, ref.configs, ref.overrides, ref.description), name
    # every command the port runs: its configs load as the JAX package
    # loads them and its flow resolves to the port
    pregistry.populate()
    for name, cmd in pcommands.COMMANDS.items():
        if name in pcommands.WAITING:
            continue
        paths = [os.path.join(ROOT, c) for c in cmd.configs]
        cfg = pconfig.load_configs(paths, cmd.overrides)
        assert cfg == jconfig.load_configs(paths, cmd.overrides), name
        flow = pregistry.resolve(cfg["flow"]["target"])
        assert flow.__module__.startswith("videotuna_tpu_torch."), name
    assert {e for e in pentry.ALL_ENTRIES} == {
        *jcommands.COMMANDS, *jcommands.DEV_COMMANDS, "serve", "eval",
        "list"}
    assert callable(getattr(pentry, "train_hunyuan_t2v_lora"))


def test_hunyuan_lora_command_resolves_like_jax():
    cmd = pcommands.COMMANDS["train-hunyuan-t2v-lora"]
    assert cmd.configs == ["configs/007_hunyuanvideo/"
                           "hunyuanvideo_t2v_lora.yaml"]
    assert cmd.mode == "train" and "train-hunyuan-t2v-lora" not in \
        pcommands.WAITING
    path = os.path.join(ROOT, cmd.configs[0])
    cfg = pconfig.load_configs([path])
    assert cfg == jconfig.load_configs([path])
    assert cfg["train"]["lora"] == {"rank": 64, "alpha": 1.0}
    for comp in ("denoiser_config", "scheduler_config", "first_stage_config",
                 "cond_stage_config", "cond_stage_2_config"):
        target = cfg["flow"]["params"][comp]["target"]
        assert pregistry.resolve(target).__module__.startswith(
            "videotuna_tpu_torch."), target
        assert jregistry.resolve(target).__name__ == \
            pregistry.resolve(target).__name__


@pytest.mark.parametrize("name,queue", [
    ("inference-flux-dev", "queue 1, item 8"),
    ("train-dynamicrafter", "queue 3"),
    ("inference-hunyuan-i2v-720p", "queue 1, item 4"),
    ("train-cogvideox-i2v-lora", "queue 1, item 3"),
    ("serve", "item 10.2"), ("eval", "item 10.5")])
def test_unported_command_returns_2_naming_its_queue(name, queue, capsys):
    assert pcommands.main([name, "--device", "cpu"]) == 2
    assert queue in capsys.readouterr().err


# CogVideoX-5B I2V and CogVideoX 1.5 narrowed: the MMDiT at dim 64 (one
# head of d=64, 2 layers), a one-layer T5 of dim 32, the VAE at ch 32 with
# one res block, 2 steps at 9×64×64 (3 latent frames: 1.5 samples 4)
_NARROW_COG = [f"flow.params.{k}" for k in (
    "denoiser_config.params.dim=64", "denoiser_config.params.heads=1",
    "denoiser_config.params.num_layers=2",
    "denoiser_config.params.text_dim=32", "cond_stage_config.params.dim=32",
    "cond_stage_config.params.heads=2", "cond_stage_config.params.head_dim=16",
    "cond_stage_config.params.ff_dim=64",
    "cond_stage_config.params.num_layers=1", "first_stage_config.params.ch=32",
    "first_stage_config.params.num_res_blocks=1",
    "scheduler_config.params.num_steps=2", "ddim_steps=2")] + [
    "inference.height=64", "inference.width=64", "inference.frames=9"]


@pytest.mark.parametrize("name,i2v,sampled", [
    ("inference-cogvideo-i2v-diffusers", True, 3),
    ("inference-cogvideo-i2v-lora", True, 3),
    ("inference-cogvideox-15-5b-t2v", False, 4),
    ("inference-cogvideox-15-5b-i2v", True, 4)])
def test_cogvideox_i2v_and_15_commands_run_the_port(name, i2v, sampled,
                                                     tmp_path):
    """Each command runs the port's CLI on the CPU: an i2v one from a
    directory of one seeded PNG and a .txt; the 1.5 ones sample a padded
    latent frame in front and decode the 3 kept ones."""
    import cv2
    assert name not in pcommands.WAITING
    inputs = tmp_path / "inputs"
    inputs.mkdir()
    cv2.imwrite(str(inputs / "image.png"), np.random.default_rng(0).integers(
        0, 256, (60, 80, 3), dtype=np.uint8))
    (inputs / "prompts.txt").write_text("a red panda on a branch\n")
    out = tmp_path / "out"
    argv = [name, "--device", "cpu", "--quiet", "--savedir", str(out),
            *_NARROW_COG]
    argv.append(f"inference.input_dir={inputs}" if i2v
                else "inference.prompt=a red panda on a branch")
    assert pcommands.main(argv) == 0
    m = json.loads((out / "metric.json").read_text())
    assert m["num_videos"] == 1 and m["denoise_steps"] == 2
    assert m["latent_shape"] == [1, sampled, 8, 8, 16]
    assert m["decoded_latent_shape"] == [1, 3, 8, 8, 16]
    assert (m["image_encode_sec"] > 0) == i2v
    assert m["nonfinite_latents"] == 0 == m["nonfinite_pixels"]


def test_main_lists_trains_and_needs_cuda_unless_asked(tmp_path, capsys):
    assert pcommands.main(["list"]) == 0
    listed = capsys.readouterr().out
    assert all(name in listed for name in jcommands.COMMANDS)
    # the Wan T2V and I2V commands and VideoCrafter2's training run the
    # port (no waiting mark); DynamiCrafter's training waits
    for name in ("inference-wanvideo-t2v-720p", "inference-wanvideo-t2v-1-3B",
                 "inference-wanvideo-i2v-720p", "train-videocrafter-v2",
                 "train-videocrafter-lora"):
        assert f"  {name}" in listed and f"*{name}" not in listed
    assert "*train-dynamicrafter" in listed
    assert pcommands.main(["no-such-command"]) == 2
    assert pcommands.main(["install-flash-attn"]) == 0
    assert "CUDA kernels" in capsys.readouterr().out
    work = tmp_path / "run"
    assert pcommands.main(["train-tiny-t2v", "--device", "cpu", "--quiet",
                           "--workdir", str(work), "train.max_steps=2"]) == 0
    assert os.path.isfile(work / "step_2" / "state.pt")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pcommands.main(["train-tiny-t2v", "--quiet", "--workdir",
                            str(tmp_path / "cuda")])


# ---------------------------------------------------------------- prefetcher
def _batches(n):
    rng = np.random.default_rng(0)
    return [{"video": rng.standard_normal((1, 2, 4, 4, 3)).astype(np.float32),
             "caption": [f"clip {i}"]} for i in range(n)]


def _prepare(batch):
    return dict(batch, text_states=torch.full((1, 2), float(len(
        batch["caption"][0]))))


def test_prefetcher_yields_the_plain_loops_batches_in_order():
    batches = _batches(5)
    plain = [_prepare(b) for b in batches]
    got = list(DevicePrefetcher(batches, "cpu", depth=2, prepare=_prepare))
    assert len(got) == len(plain)
    for g, p in zip(got, plain):
        assert g["caption"] == p["caption"]
        assert torch.equal(g["video"], torch.from_numpy(p["video"]))
        assert torch.equal(g["text_states"], p["text_states"])


def test_prefetcher_raises_the_loaders_error_and_stops_its_worker():
    def loader():
        yield from _batches(2)
        raise ValueError("bad clip")

    seen = []
    with pytest.raises(ValueError, match="bad clip"):
        for batch in DevicePrefetcher(loader(), "cpu"):
            seen.append(batch)
    assert len(seen) == 2
    it = iter(DevicePrefetcher(_batches(50), "cpu", depth=1))
    next(it)
    it.close()       # the consumer leaves: the worker ends
    assert not any(t.name == "DevicePrefetcher" and t.is_alive()
                   for t in threading.enumerate())


class _Inline:
    """The plain loop in the prefetcher's place: each batch prepared when
    the step asks for it."""

    def __init__(self, loader, device, prepare):
        self.loader, self.device, self.prepare = loader, device, prepare

    def __iter__(self):
        return (to_device(self.prepare(b), self.device) for b in self.loader)


def test_fit_losses_are_the_same_with_and_without_the_prefetcher(
        tmp_path, monkeypatch):
    from videotuna_tpu_torch.cli.train import build_trainer
    from videotuna_tpu_torch.training import trainer as ptrainer
    losses = []
    for inline in (True, False):
        if inline:
            monkeypatch.setattr(ptrainer, "DevicePrefetcher", _Inline)
        else:
            monkeypatch.undo()
        trainer, loader, _ = build_trainer([
            "--config", TINY_T2V, "--device", "cpu", "--quiet",
            "--workdir", str(tmp_path / str(inline)), "train.max_steps=3",
            "train.log_every=1"])
        random.seed(0)
        trainer.fit(loader)
        losses.append([(m["step"], m["loss"], m["grad_norm"])
                       for m in trainer.metrics_history])
    assert len(losses[0]) == 3 and losses[0] == losses[1]


# ---------------------------------------------------------------- HunyuanVideo
def test_tiny_hunyuan_lora_trains_and_resumes(tmp_path):
    """LoRA (rank 4) on the tiny HunyuanVideo flow: 2 steps unbroken, and 1
    step then ``--resume``, reach the same step-2 state; the LoRA tree is
    written beside it and its b moved."""
    from videotuna_tpu_torch.cli.train import run_train
    common = ["--config", TINY_HUNYUAN, "--device", "cpu", "--quiet",
              "train.max_steps=2", "train.ckpt_every=1", "train.log_every=1",
              "train.lora.rank=4"]
    whole, parts = tmp_path / "whole", tmp_path / "parts"
    random.seed(0)
    assert run_train(common + ["--workdir", str(whole)]).step == 2
    random.seed(0)
    run_train(common + ["--workdir", str(parts), "--max_steps", "1"])
    assert sorted(os.listdir(parts)) == ["step_1"]
    assert run_train(common + ["--workdir", str(parts),
                               "--resume"]).step == 2
    _assert_same(_state(parts / "step_2" / "state.pt"),
                 _state(whole / "step_2" / "state.pt"))
    tree = torch.load(whole / "step_2" / "lora.pt", weights_only=True)
    pairs = dict(plora._iter_pairs(tree["denoiser"]))
    assert ("double_blocks", "kernel") not in pairs
    assert any(p[0] == "double_0" for p in pairs) and \
        any(p[0] == "single_1" for p in pairs)
    assert all(float(ab["b"].abs().max()) > 0 for ab in pairs.values())
