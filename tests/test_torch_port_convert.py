"""The port's weight conversion (``tools/convert_weights.py``) against the
JAX package's on the CPU, with its safetensors reader and the checkpoint
round trip (``tools/ckpt_tools.py`` → ``--ckpt`` and ``flow.pretrained``).

Each ported map gets a synthetic upstream state dict built from the map's
own rules: every rule's torch name, its ``(\\d+)`` groups and alternatives
expanded, is kept where the flax path it maps to is a leaf of the
component's parameter tree at a narrow config, with a seeded numpy tensor
of the upstream shape whose transform gives that leaf's shape.  The tree's
paths and shapes are read off the port's module in the layout
``tools/from_jax`` copies (``flax_shapes``), which is the JAX module's
(the parity tests load JAX trees into these modules strictly; at these
configs the two were equal leaf for leaf, ``jax.eval_shape`` of each
``init`` against ``flax_shapes``).  The JAX converter and the port's must
give the same tree exactly; that tree must load strictly into the port's
module and equal the tree that ``ckpt_tools``' family map, sized from
the config, gives; a leaf of the wrong shape must be reported by
``verify_tree_shapes`` and refused by the load.
"""

import argparse
import functools
import itertools
import os
import re

import jax
import numpy as np
import pytest
import torch

from videotuna_tpu.tools import convert_weights as jcw
from videotuna_tpu_torch.core import config as pconfig
from videotuna_tpu_torch.tools import ckpt_tools
from videotuna_tpu_torch.tools import convert_weights as pcw
from videotuna_tpu_torch.tools.from_jax import load_jax_params

from tests.test_torch_port_models import (  # noqa: F401
    flax_shapes, torch_one_thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(*parts):
    return os.path.join(ROOT, "configs", *parts)


_D = "flow.params.denoiser_config.params"
_F = "flow.params.first_stage_config.params"
_C = "flow.params.cond_stage_config.params"
_TINY_HY = _cfg("000_tiny", "tiny_hunyuan.yaml")
_TINY_COG = _cfg("000_tiny", "tiny_cogvideox.yaml")
_WAN = _cfg("008_wanvideo", "wan2_1_t2v_1_3B.yaml")
_WAN_NARROW = [f"{_D}.dim=256", f"{_D}.heads=2", f"{_D}.num_layers=2",
               f"{_D}.ffn_dim=512", f"{_D}.text_dim=64", f"{_F}.dim=16",
               f"{_D}.scan_blocks=false", f"{_C}.dim=64", f"{_C}.heads=2",
               f"{_C}.head_dim=32", f"{_C}.ff_dim=128", f"{_C}.num_layers=1"]
_UNET_NARROW = [f"{_D}.model_channels=48", f"{_D}.channel_mult=[1, 2]",
                f"{_D}.attention_resolutions=[1, 2]",
                f"{_D}.num_res_blocks=1", f"{_D}.num_head_channels=16",
                f"{_D}.context_dim=32", f"{_D}.dtype=float32",
                f"{_C}.dim=32", f"{_C}.heads=2", f"{_C}.num_layers=1"]

# family: (config, overrides, component, the map of a convert_weights
# module for the component's config params)
CASES = {
    "stdit": (_cfg("000_tiny", "tiny_t2v.yaml"), [f"{_D}.depth=2"],
              "denoiser", lambda cw, p: cw.stdit_map(heads=p["num_heads"])),
    "stdit8": (_cfg("003_opensora", "opensorav12_stdit8_paired.yaml"),
               [f"{_D}.hidden_size=64", f"{_D}.num_heads=2", f"{_D}.depth=2",
                f"{_D}.caption_channels=32", f"{_D}.scan_blocks=false",
                f"{_C}.dim=32", f"{_C}.heads=2", f"{_C}.head_dim=16",
                f"{_C}.ff_dim=64", f"{_C}.num_layers=1"],
               "denoiser", lambda cw, p: cw.stdit8_map(heads=p["num_heads"])),
    "wan": (_WAN, _WAN_NARROW, "denoiser",
            lambda cw, p: cw.wan_map(heads=p["heads"])),
    "hunyuan": (_TINY_HY, [], "denoiser",
                lambda cw, p: cw.hunyuan_map(
                    heads=p["heads"],
                    patch=tuple(p.get("patch_size", (1, 2, 2))),
                    out_ch=p.get("out_channels", 16))),
    "cogvideox": (_TINY_COG, [], "denoiser",
                  lambda cw, p: cw.cogvideox_map(heads=p["heads"])),
    "wan_vae": (_WAN, _WAN_NARROW, "first_stage",
                lambda cw, p: cw.wan_vae_map()),
    "hunyuan_vae": (_cfg("007_hunyuanvideo", "hunyuanvideo_t2v.yaml"),
                    [f"{_F}.block_out_channels=[32, 32, 64, 64]",
                     f"{_F}.norm_num_groups=8"], "first_stage",
                    lambda cw, p: cw.hunyuan_vae_map()),
    "cogvideox_vae": (_cfg("004_cogvideox", "cogvideo5b.yaml"),
                      [f"{_F}.ch=8", f"{_F}.ch_mult=[1, 2, 2, 4]",
                       f"{_F}.num_res_blocks=1", f"{_F}.norm_num_groups=4"],
                      "first_stage", lambda cw, p: cw.cogvideox_vae_map()),
    "t5": (_TINY_COG, [f"{_C}.num_layers=2"], "cond_stage",
           lambda cw, p: cw.t5_map(heads=p["heads"])),
    "clip_text": (_TINY_HY, ["flow.params.cond_stage_2_config.params."
                             "num_layers=2"], "cond_stage_2",
                  lambda cw, p: cw.clip_text_map(heads=p["heads"])),
    "llama": (_TINY_HY, [f"{_C}.num_layers=2", f"{_C}.kv_heads=1"],
              "cond_stage",
              lambda cw, p: cw.llama_map(heads=p["heads"],
                                         kv_heads=p.get("kv_heads"))),
    "flux": (_cfg("006_flux", "flux_dev.yaml"),
             [f"{_D}.dim=256", f"{_D}.heads=2", f"{_D}.double_blocks=2",
              f"{_D}.single_blocks=2", f"{_D}.text_dim=32",
              f"{_D}.pooled_dim=32", f"{_D}.scan_blocks=false"],
             "denoiser", lambda cw, p: cw.flux_map(heads=p["heads"])),
    "lvdm": (_cfg("001_videocrafter2", "vc2_t2v_320x512.yaml"),
             _UNET_NARROW, "denoiser",
             lambda cw, p: cw.lvdm_map(
                 model_channels=48, channel_mult=(1, 2), num_res_blocks=1,
                 attention_resolutions=(1, 2), num_head_channels=16,
                 addition_attention=True)),
    # no config names these two: built from their modules' classes
    "clip_vision": (None, dict(dim=64, heads=2, num_layers=2, patch=14,
                               image_size=56, proj_dim=32),
                    "models.clip_vision.CLIPVisionEncoder",
                    lambda cw, p: cw.clip_vision_map(heads=p["heads"])),
    "llava_projector": (None, dict(in_dim=64, out_dim=48),
                        "tools.captioner.LlavaProjector",
                        lambda cw, p: cw.llava_projector_map()),
    "lvdm_vc1": (_cfg("000_videocrafter", "vc1_t2v_576x1024.yaml"),
                 _UNET_NARROW, "denoiser",
                 lambda cw, p: cw.lvdm_map(
                     model_channels=48, channel_mult=(1, 2),
                     num_res_blocks=1, attention_resolutions=(1, 2),
                     num_head_channels=16, addition_attention=True,
                     use_relative_position=True)),
}


# ------------------------------------------------------- synthetic state
def _flat(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from _flat(v, path)
        else:
            yield path, v


def _names(pattern: str, nmax: int):
    """Every name ``pattern`` matches whose ``(\\d+)`` groups are below
    ``nmax``, whose ``(a|b)`` groups (named or not) take each alternative,
    whose optional ``(?:x)?`` groups are left out and whose optional
    characters ``x?`` are kept (one name a leaf)."""
    parts = re.split(r"(\((?:\?P<\w+>|\?:)?(?:\\d\+|[\w|\\.]+)\)\??)",
                     pattern.strip("^$"))
    options = []
    for i, part in enumerate(parts):
        if i % 2:
            optional = part.endswith("?")
            inner = re.sub(r"^\?(P<\w+>|:)", "", part.rstrip("?")[1:-1])
            alts = ([str(n) for n in range(nmax)] if inner == r"\d+" else
                    [re.sub(r"\\(.)", r"\1", a) for a in inner.split("|")])
            options.append([""] if optional else alts)
        else:
            options.append([re.sub(r"\\(.)", r"\1",
                                   re.sub(r"(\w)\?", r"\1", part))])
    for combo in itertools.product(*options):
        yield "".join(combo)


def _candidates(shape):
    """Upstream shapes a transform may have mapped to ``shape``: it, its
    size-1 axes dropped or more added, two adjacent axes merged, in any
    order (``shape`` and its reverse first)."""
    ones = [i for i, n in enumerate(shape) if n == 1]
    bases = [tuple(n for i, n in enumerate(shape) if i not in drop)
             for r in range(len(ones) + 1)
             for drop in itertools.combinations(ones, r)]
    bases += [b + (1,) * e for b in list(bases) for e in (1, 2, 3)]
    bases += [b[:i] + (b[i] * b[i + 1],) + b[i + 2:]
              for b in list(bases) for i in range(len(b) - 1)]
    seen = set()
    for u in [tuple(shape), tuple(shape)[::-1]] + [
            p for b in bases for p in itertools.permutations(b)]:
        if u not in seen:
            seen.add(u)
            yield u


def _upstream_shape(fn, name, shape):
    if fn is None:   # ConversionMap's default: a 2D .weight is transposed
        return shape[::-1] if name.endswith(".weight") \
            and len(shape) == 2 else shape
    return _inverse_shape(fn.__code__, tuple(
        c.cell_contents for c in fn.__closure__ or ()), fn, shape, name)


@functools.lru_cache(maxsize=None)
def _inverse_shape(code, closure, fn, shape, name):
    """The first of ``_candidates`` that ``fn`` maps onto ``shape``; cached
    by the transform's code and closure (``fn`` and ``name`` ride along)."""
    for u in _candidates(shape):
        try:
            if fn(np.zeros(u, np.float32)).shape == tuple(shape):
                return u
        except (ValueError, IndexError, TypeError):
            continue
    raise AssertionError(f"no upstream shape for {name} → {shape}")


def synthetic_state_dict(cmap, shapes, seed=0):
    """A seeded upstream state dict that ``cmap`` maps onto every leaf of
    ``shapes`` ({flax path: shape}) that one of its rules names."""
    rng = np.random.default_rng(seed)
    ints = [int(x) for p in shapes for x in re.findall(r"\d+", p)]
    nmax = max(ints + [3]) + 2
    sd = {}
    for pat, template, fn in cmap.rules:
        for name in _names(pat.pattern, nmax):
            m = pat.match(name)
            if m is None or m.end() != len(name):
                continue
            path = m.expand(template)
            if path in shapes:
                shape = _upstream_shape(fn, name, tuple(shapes[path]))
                sd[name] = rng.standard_normal(shape).astype(np.float32)
    return sd


@functools.lru_cache(maxsize=None)
def _case(family):
    """(the component's port module, its config params, leaf shapes,
    upstream state dict, the JAX map's tree) of a family's case."""
    config, overrides, comp, _ = CASES[family]
    if config is None:   # overrides: the module's params; comp: its class
        import importlib
        mod, cls = comp.rsplit(".", 1)
        module = getattr(importlib.import_module(
            f"videotuna_tpu_torch.{mod}"), cls)(**overrides)
        params = dict(overrides)
    else:
        pcfg = pconfig.load_configs([config], overrides)
        module = ckpt_tools.build_component(pcfg, comp)
        params = dict(pcfg["flow"]["params"][f"{comp}_config"].get("params")
                      or {})
    shapes = flax_shapes(module)
    build = CASES[family][3]
    sd = synthetic_state_dict(build(jcw, params), shapes)
    return module, params, shapes, sd, build(jcw, params).convert(
        sd, strict=True)


def _trees_equal(a, b):
    fa, fb = dict(_flat(a)), dict(_flat(b))
    assert fa.keys() == fb.keys()
    for k in fa:
        assert np.asarray(fa[k]).shape == np.asarray(fb[k]).shape, k
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]),
                                      err_msg=k)


# ------------------------------------------------------------------ maps
@pytest.mark.parametrize("family", sorted(CASES))
def test_map_matches_jax_and_loads_strictly(family):
    module, params, shapes, sd, jtree = _case(family)
    comp = CASES[family][2]
    ptree = CASES[family][3](pcw, params).convert(sd, strict=True)
    _trees_equal(ptree, jtree)
    assert {p: tuple(np.shape(v)) for p, v in _flat(ptree)} == shapes
    # ckpt_tools' family map, sized from the config alone, gives the same
    # tree
    args = argparse.Namespace(heads=None, kv_heads=None)
    _trees_equal(ckpt_tools.FAMILIES[family][0](args, params).convert(sd),
                 ptree)
    load_jax_params(module, ptree, comp)   # strict: every parameter set
    if "block_1" in ptree:   # ckpt_tools --scan-layout's stacked tree
        load_jax_params(module, pcw.stack_blocks_for_scan(ptree), comp)


@pytest.mark.parametrize("family", ["lvdm", "wan_vae", "llama"])
def test_map_reports_a_mismatched_leaf(family):
    module, params, shapes, sd, _ = _case(family)
    comp = CASES[family][2]
    name = next(k for k in sorted(sd) if sd[k].ndim == 2)
    bad = dict(sd, **{name: sd[name][:-1]})
    tree = CASES[family][3](pcw, params).convert(bad)
    target = {}
    for p, s in shapes.items():
        node = target
        *head, leaf = p.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[leaf] = np.zeros(s)
    problems = pcw.verify_tree_shapes(tree, target)
    assert len(problems) == 1 and problems[0].startswith("shape "), problems
    with pytest.raises(ValueError, match="does not map onto"):
        load_jax_params(module, tree, comp)


def test_unported_maps_raise_naming_their_queue():
    for name, item in (("aesthetic_map", "10.4"),):
        assert hasattr(jcw, name)
        with pytest.raises(NotImplementedError, match=item):
            getattr(pcw, name)(heads=24)
    assert set(ckpt_tools.WAITING) | set(ckpt_tools.FAMILIES) >= {
        "stdit", "wan", "hunyuan", "cogvideox", "mochi", "flux", "lvdm",
        "lvdm_vc1", "t5", "clip_text", "clip_vision", "llama", "stepvideo",
        "stepllm", "aesthetic", "llava_projector", "wan_vae", "hunyuan_vae",
        "cogvideox_vae", "mochi_vae", "raft", "amt"}


def test_shared_pieces_match_jax():
    """strip_prefixes, split_lightning_components, the fused-projection
    preprocessors, stack_blocks_for_scan (numpy here, jax.numpy there) and
    convert_lora_safetensors give what the JAX package's give."""
    rng = np.random.default_rng(3)
    sd = {f"module.model.diffusion_model.blocks.{i}.attn.qkv.weight":
          rng.standard_normal((12, 4)).astype(np.float32) for i in range(2)}
    for cw in (jcw, pcw):
        assert list(cw.strip_prefixes(sd)) == [f"blocks.{i}.attn.qkv.weight"
                                               for i in range(2)]
    mono = {"model.diffusion_model.a": np.zeros(2),
            "first_stage_model.b": np.zeros(3), "betas": np.zeros(1)}
    _trees_equal(pcw.split_lightning_components(mono),
                 jcw.split_lightning_components(mono))
    flat = pcw.strip_prefixes(sd)
    _trees_equal(pcw.preprocess_split_fused_qkv(flat, r"attn\.qkv"),
                 jcw.preprocess_split_fused_qkv(flat, r"attn\.qkv"))
    tree = {f"block_{i}": {"w": {"kernel": rng.standard_normal(
        (3, 2)).astype(np.float32)}} for i in range(3)}
    tree["head"] = {"bias": np.zeros(2)}
    _trees_equal(pcw.stack_blocks_for_scan(tree, exclude=(2,)),
                 jax.device_get(jcw.stack_blocks_for_scan(tree,
                                                          exclude=(2,))))
    lora = {"x.q.lora_A.weight": rng.standard_normal((4, 8)),
            "x.q.lora_B.weight": rng.standard_normal((8, 4))}
    _trees_equal(pcw.convert_lora_safetensors(lora),
                 jcw.convert_lora_safetensors(lora))


# ------------------------------------------------------------ safetensors
def test_safetensors_reader_reads_what_safetensors_writes(tmp_path):
    """The port's reader (header length, JSON header, little-endian
    buffers) against files the ``safetensors`` package writes: every dtype
    it takes, bf16 as float32, ``__metadata__`` skipped, and
    ``load_torch_state_dict`` stripping the shared prefix."""
    from safetensors.numpy import save_file
    from safetensors.torch import save_file as save_torch
    rng = np.random.default_rng(4)
    arrays = {
        "model.a": rng.standard_normal((3, 5)).astype(np.float32),
        "model.b": rng.standard_normal((2, 2, 2)).astype(np.float16),
        "model.c": rng.integers(-9, 9, (7,)).astype(np.int64),
        "model.d": rng.integers(0, 2, (4,)).astype(bool),
        "model.e": np.array(2.5, dtype=np.float64),
        "model.f": rng.integers(0, 255, (2, 3)).astype(np.uint8),
    }
    path = tmp_path / "w.safetensors"
    save_file(arrays, str(path), metadata={"format": "np"})
    got = pcw.read_safetensors(str(path))
    assert got.keys() == arrays.keys()
    for k, v in arrays.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape
        np.testing.assert_array_equal(got[k], v)
    assert sorted(pcw.load_torch_state_dict(str(path))) == list("abcdef")
    bf = torch.randn(4, 3).bfloat16()
    save_torch({"w": bf}, str(tmp_path / "bf.safetensors"))
    got = pcw.read_safetensors(str(tmp_path / "bf.safetensors"))["w"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, bf.float().numpy())
