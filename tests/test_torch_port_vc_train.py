"""VideoCrafter2 fine-tuning in the port on the CPU, narrowed, with the
checkpoint paths that feed it: ``ckpt_tools convert`` of a synthetic
upstream (Lightning-layout) UNet checkpoint → ``--ckpt`` inference and
``flow.pretrained`` → ``run_train`` through the registry's
``train-videocrafter-v2``; ``train-videocrafter-lora``'s LoRA tree against
the JAX package's for the same targets; ``save_pretrained`` /
``from_pretrained``; and DynamiCrafter training, which fails in the JAX
package (pinned through ``jax.eval_shape``) and raises in the port
(ROADMAP.md queue 3).

The UNet is ``tests/test_torch_port_videocrafter.py``'s narrow one (48
channels, two levels, f32), 2 frames of 128×128 on dummy video.
"""

import json
import os

import flax
import jax
import jax.numpy as jnp
import pytest
import torch

from videotuna_tpu.core import config as jconfig
from videotuna_tpu.core import registry as jregistry
from videotuna_tpu.training import lora as jlora
from videotuna_tpu_torch.cli import commands as pcommands
from videotuna_tpu_torch.core import config as pconfig
from videotuna_tpu_torch.core import registry as pregistry
from videotuna_tpu_torch.flows.generation import GenerationFlow
from videotuna_tpu_torch.models.lvdm import unet3d as PU
from videotuna_tpu_torch.tools import ckpt_tools
from videotuna_tpu_torch.tools.from_jax import load_jax_params

from tests.test_torch_port_convert import _case
from tests.test_torch_port_models import flax_shapes, flax_tree
from tests.test_torch_port_models import torch_one_thread  # noqa: F401
from tests.test_torch_port_videocrafter import (DC, NARROW, NARROW_DC,
                                                PROMPT, ROOT, VC2)

# the narrow UNet with attention at both levels: the UNet of the synthetic
# upstream checkpoint (``_case("lvdm")``), which these tests convert, load
# and train
_LEVELS = ["flow.params.denoiser_config.params.attention_resolutions=[1, 2]"]
NARROW = NARROW + _LEVELS
NARROW_DC = NARROW_DC + _LEVELS

TOY_CSV = os.path.join(ROOT, "configs", "000_tiny", "toy_anno.csv")
DUMMY = ("data.dataset={target: videotuna_tpu.data.DatasetFromCSV, params: "
         f"{{csv_path: {TOY_CSV}, dummy: true, num_frames: 2, "
         "resolution: [128, 128]}}")
TARGETS = ("attn1", "attn2", "fc1", "fc2")   # vc2_t2v_lora.yaml's


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """A monolithic Lightning checkpoint (the UNet under
    ``model.diffusion_model.``, a VAE tensor beside it) of the synthetic
    upstream UNet, converted by ``ckpt_tools convert``; returns the output
    root and the UNet module the JAX map's tree gives through
    ``from_jax``."""
    _, _, _, sd, jtree = _case("lvdm")
    root = tmp_path_factory.mktemp("vc2_ckpt")
    src = root / "model.ckpt"
    torch.save({"state_dict": {
        **{f"model.diffusion_model.{k}": torch.from_numpy(v)
           for k, v in sd.items()},
        "first_stage_model.encoder.conv_in.weight": torch.zeros(3)}}, src)
    ckpt_tools.main(["convert", "--src", str(src), "--family", "lvdm",
                     "--split-source", "denoiser", "--strict", "--config",
                     VC2, "--out", str(root / "out"), *NARROW])
    cfg = pconfig.load_configs([VC2], NARROW)
    expected = PU.UNet3D(**cfg["flow"]["params"]["denoiser_config"]
                         ["params"])
    load_jax_params(expected, jtree)
    return root / "out", expected


def _spy_from_pretrained(monkeypatch):
    """Record each ``from_pretrained`` call: its path and the denoiser's
    state just after it."""
    calls = []
    original = GenerationFlow.from_pretrained

    def spy(self, path):
        out = original(self, path)
        calls.append((path, {k: v.clone() for k, v in
                             self.denoiser.state_dict().items()}))
        return out

    monkeypatch.setattr(GenerationFlow, "from_pretrained", spy)
    return calls


def _same_state(state, module):
    ref = module.state_dict()
    assert state.keys() == ref.keys()
    for k in ref:
        torch.testing.assert_close(state[k], ref[k], rtol=0, atol=0, msg=k)


def test_ckpt_tools_convert_then_inference_with_ckpt(converted, tmp_path,
                                                     monkeypatch, capsys):
    """``ckpt_tools convert`` writes ``step_0/denoiser.pt``, which the
    registry's inference command loads with ``--ckpt`` (a root: its newest
    step dir) over the seeded weights: the UNet is then exactly the one
    the JAX map's tree gives; ``inspect`` lists it."""
    out, expected = converted
    assert sorted(os.listdir(out / "step_0")) == ["denoiser.pt"]
    calls = _spy_from_pretrained(monkeypatch)
    savedir = tmp_path / "v"
    assert pcommands.main(["inference-vc2-t2v-320x512", "--device", "cpu",
                           "--quiet", "--savedir", str(savedir), "--ckpt",
                           str(out), f"inference.prompt={PROMPT}",
                           *NARROW]) == 0
    assert [c[0] for c in calls] == [str(out)]
    _same_state(calls[0][1], expected)
    m = json.loads((savedir / "metric.json").read_text())
    assert m["num_videos"] == 1 and m["nonfinite_pixels"] == 0
    ckpt_tools.main(["inspect", "--path", str(out)])
    n = sum(p.numel() for p in expected.parameters())
    assert f"denoiser: {n / 1e6:.2f}M values" in capsys.readouterr().out


def test_flow_pretrained_then_train_videocrafter_v2(converted, tmp_path,
                                                    monkeypatch):
    """``flow.pretrained`` = the converted root: the registry's
    ``train-videocrafter-v2`` (full fine-tune) starts from its UNet and
    takes two steps on the CPU, checkpointing the train state."""
    out, expected = converted
    calls = _spy_from_pretrained(monkeypatch)
    workdir = tmp_path / "w"
    assert pcommands.main(["train-videocrafter-v2", "--device", "cpu",
                           "--quiet", "--workdir", str(workdir),
                           "--max_steps", "2", DUMMY, "train.log_every=1",
                           f"flow.pretrained={out}", *NARROW]) == 0
    assert [c[0] for c in calls] == [str(out)]
    _same_state(calls[0][1], expected)
    assert sorted(os.listdir(workdir / "step_2")) == ["state.pt"]
    state = torch.load(workdir / "step_2" / "state.pt", weights_only=True)
    assert state["step"] == 2


def test_train_videocrafter_lora_tree_matches_jax_targets(tmp_path):
    """``train-videocrafter-lora`` takes two steps on the CPU; its LoRA
    tree has the JAX package's paths and shapes for the config's targets
    (rank 16).  ``attn1`` and ``attn2`` match every self- and
    cross-attention projection, spatial and temporal; ``fc1`` and ``fc2``
    name no projection of the UNet's feed-forward (``geglu``,
    ``mlp_out``) and match, by substring, the time and fps embeddings'
    ``time_fc1``, ``time_fc2``, ``fps_fc1``, ``fps_fc2``, in both
    packages."""
    workdir = tmp_path / "w"
    assert pcommands.main(["train-videocrafter-lora", "--device", "cpu",
                           "--quiet", "--workdir", str(workdir),
                           "--max_steps", "2", DUMMY, "train.log_every=1",
                           *NARROW]) == 0
    assert sorted(os.listdir(workdir / "step_2")) == ["lora.pt", "state.pt"]
    tree = torch.load(workdir / "step_2" / "lora.pt",
                      weights_only=True)["denoiser"]
    # the UNet's flax tree (the narrow UNet of ``_case("lvdm")`` is this
    # one), as the JAX package's init_lora walks it
    jtree = jlora.init_lora(flax_tree(_case("lvdm")[2]), rank=16,
                            match=jlora.lora_target(*TARGETS))
    got = {p: tuple(v.shape) for p, v in _flat(tree)}
    assert got == {p: tuple(v.shape) for p, v in _flat(jtree)}
    kernels = {p[:-1] for p in got}
    fc = sorted("/".join(p) for p in kernels if "fc" in "/".join(p))
    assert fc == ["fps_fc1/kernel", "fps_fc2/kernel", "time_fc1/kernel",
                  "time_fc2/kernel"]
    assert not any("geglu" in "/".join(p) or "mlp_out" in "/".join(p)
                   for p in kernels)
    assert any(float(v.abs().max()) > 0 for p, v in _flat(tree)
               if p[-1] == "b")


def test_save_pretrained_and_from_pretrained_layouts(tmp_path):
    """``save_pretrained`` writes one ``<component>.pt`` a component
    (``only_trained``: the denoiser alone) under ``step_<n>``;
    ``from_pretrained`` takes a step dir or a root's newest step dir,
    loads strictly, and refuses a JAX (orbax) checkpoint and a path with
    none."""
    cfg = pconfig.load_configs([VC2], NARROW)["flow"]
    a = pregistry.instantiate(cfg, device="cpu")
    a.init_params(seed=1)
    step = a.save_pretrained(str(tmp_path / "r"), step=3)
    assert sorted(os.listdir(step)) == ["cond_stage.pt", "denoiser.pt",
                                        "first_stage.pt"]
    a.save_pretrained(str(tmp_path / "r"), step=1, only_trained=True)
    assert os.listdir(tmp_path / "r" / "step_1") == ["denoiser.pt"]
    b = pregistry.instantiate(cfg, device="cpu")
    b.init_params(seed=2)
    b.from_pretrained(str(tmp_path / "r"))   # the newest: step_3
    for name, module in a.components().items():
        _same_state(b.components()[name].state_dict(), module)
    c = pregistry.instantiate(cfg, device="cpu")
    c.init_params(seed=2)
    c.from_pretrained(step)
    _same_state(c.denoiser.state_dict(), a.denoiser)
    (tmp_path / "orbax" / "step_5" / "denoiser").mkdir(parents=True)
    with pytest.raises(NotImplementedError, match="orbax"):
        c.from_pretrained(str(tmp_path / "orbax"))
    with pytest.raises(FileNotFoundError):
        c.from_pretrained(str(tmp_path / "none"))


def test_dynamicrafter_training_fails_in_jax_and_raises_in_the_port(
        capsys):
    """DynamiCrafter's loss in the JAX package builds no image latents, so
    its 8-channel UNet gets 4 channels and tracing the loss fails on the
    shape (``jax.eval_shape``, nothing compiled); the port's loss raises a
    ``ValueError`` naming ROADMAP.md queue 3 instead, and
    ``train-dynamicrafter`` returns 2 naming it."""
    jregistry.populate()
    jflow = jregistry.instantiate(jconfig.load_configs([DC],
                                                       NARROW_DC)["flow"])
    assert jflow.denoiser.in_channels == 8
    pflow = pregistry.instantiate(
        pconfig.load_configs([DC], NARROW_DC)["flow"], device="cpu")
    pflow.init_params(seed=0)
    # the UNet's parameter tree, as the JAX package's init gives it
    params = {"denoiser": flax_tree(flax_shapes(pflow.denoiser))}
    assert params["denoiser"]["conv_in"]["kernel"].shape[-2] == 8
    batch = {"latents": jnp.zeros((1, 2, 16, 16, 4)),
             "text_states": jnp.zeros((1, 77, 32))}
    with pytest.raises(flax.errors.ScopeParamShapeError, match="conv_in"):
        jax.eval_shape(lambda p: jflow.training_loss(
            p, batch, jax.random.key(0)), params)
    with pytest.raises(ValueError, match="queue 3"):
        pflow.training_loss({"latents": torch.zeros((1, 2, 16, 16, 4)),
                             "text_states": torch.zeros((1, 77, 32))})
    assert pcommands.main(["train-dynamicrafter", "--device", "cpu"]) == 2
    assert "queue 3's DynamiCrafter training fault" in \
        capsys.readouterr().err
