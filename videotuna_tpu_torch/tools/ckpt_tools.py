"""Checkpoint tools of the port: upstream checkpoint → the port's format, and
inspection; the counterpart of ``videotuna_tpu/tools/ckpt_tools.py``.

``convert`` reads an upstream checkpoint (``.pt``/``.pth``/``.ckpt``/
``.safetensors``), maps it with ``tools/convert_weights.py`` to the flax
layout, copies that tree strictly into the component's module, built from
the flow config (``flow.params.<component>_config``), and writes the
module's ``state_dict`` as ``<out>/step_0/<component>.pt``, which
``GenerationFlow.from_pretrained``, ``cli/inference.py --ckpt`` and
``flow.pretrained`` read.  The map's sizes (heads, the UNet's levels) come
from the same config unless ``--heads``/``--kv_heads`` say otherwise.  The
JAX tool's ``--scan-layout`` has no counterpart: the module's
``state_dict`` is the format, whatever layout the module scans in.

Usage:
    python -m videotuna_tpu_torch.tools.ckpt_tools convert \
        --src model.ckpt --family lvdm --split-source denoiser \
        --config configs/001_videocrafter2/vc2_t2v_320x512.yaml \
        --out ckpts/vc2 [--component denoiser] [key.sub=value ...]
    python -m videotuna_tpu_torch.tools.ckpt_tools inspect --path ckpts/vc2
"""

from __future__ import annotations

import argparse
import inspect
from pathlib import Path
from typing import Any, Dict

import torch

from videotuna_tpu_torch.core import checkpoint as ckpt_lib
from videotuna_tpu_torch.tools import convert_weights as cw


def _heads(args, params: Dict[str, Any]) -> int:
    heads = args.heads or params.get("heads") or params.get("num_heads")
    if not heads:
        raise SystemExit("give --heads: the component's config names none")
    return int(heads)


def _lvdm(args, params: Dict[str, Any], **fixed) -> cw.ConversionMap:
    """``lvdm_map`` sized by the UNet's config, with the port UNet3D's
    defaults for what the config leaves out."""
    from videotuna_tpu_torch.models.lvdm.unet3d import UNet3D
    defaults = {k: p.default for k, p in
                inspect.signature(UNet3D.__init__).parameters.items()}
    names = inspect.signature(cw.lvdm_map).parameters
    kwargs = {k: params.get(k, defaults.get(k, names[k].default))
              for k in names}
    kwargs.update(fixed)
    return cw.lvdm_map(**kwargs)


def _stdit_preprocess(sd):
    sd = cw.preprocess_split_fused_qkv(sd, r"attn\.qkv|attn_temp\.qkv")
    return cw.preprocess_split_fused(sd, r"cross_attn\.kv_linear",
                                     "kv_linear", ("k_linear", "v_linear"))


def _stepvideo_preprocess(sd):
    """The DiT's per-head-interleaved fused projections split, the heads
    read off the checkpoint (a q_norm weight's length is the head width),
    as the JAX tool derives them: a wrong head count would reshape cleanly
    and scramble the interleave."""
    qn = next((v for k, v in sd.items()
               if k.endswith("attn1.q_norm.weight")), None)
    wq = next((v for k, v in sd.items() if k.endswith("attn1.wqkv.weight")),
              None)
    if qn is None or wq is None:
        return sd   # nothing fused to split
    heads = wq.shape[0] // (3 * int(qn.shape[0]))
    sd = cw.preprocess_split_headwise(sd, r"attn1\.wqkv", "wqkv",
                                      ("wq", "wk", "wv"), heads=heads)
    return cw.preprocess_split_headwise(sd, r"attn2\.wkv", "wkv",
                                        ("wk", "wv"), heads=heads)


def _mochi_vae_map():
    from videotuna_tpu_torch.models.mochi_vae import mochi_vae_map
    return mochi_vae_map()


# family → (the map made from args and the component's config params,
# state-dict preprocessor or None): the JAX package's families whose
# target module the port has.  Preprocessors split the upstream
# checkpoints' fused projections before the rules run.
FAMILIES = {
    "stdit": (lambda a, p: cw.stdit_map(heads=_heads(a, p)),
              _stdit_preprocess),
    "stdit8": (lambda a, p: cw.stdit8_map(heads=_heads(a, p)),
               _stdit_preprocess),
    "wan": (lambda a, p: cw.wan_map(heads=_heads(a, p)), None),
    "hunyuan": (lambda a, p: cw.hunyuan_map(
        heads=_heads(a, p), patch=tuple(p.get("patch_size", (1, 2, 2))),
        out_ch=int(p.get("out_channels", 16))),
        lambda sd: cw.preprocess_split_fused_qkv(sd, r"attn_qkv")),
    "cogvideox": (lambda a, p: cw.cogvideox_map(heads=_heads(a, p)), None),
    "wan_vae": (lambda a, p: cw.wan_vae_map(), None),
    "hunyuan_vae": (lambda a, p: cw.hunyuan_vae_map(), None),
    "cogvideox_vae": (lambda a, p: cw.cogvideox_vae_map(), None),
    "t5": (lambda a, p: cw.t5_map(heads=_heads(a, p)), None),
    "clip_text": (lambda a, p: cw.clip_text_map(heads=_heads(a, p)), None),
    "llama": (lambda a, p: cw.llama_map(
        heads=_heads(a, p), kv_heads=a.kv_heads or p.get("kv_heads")),
        None),
    "lvdm": (lambda a, p: _lvdm(a, p, addition_attention=p.get(
        "addition_attention", True)), None),
    "lvdm_vc1": (lambda a, p: _lvdm(a, p, use_relative_position=True),
                 None),
    "stepllm": (lambda a, p: cw.stepllm_map(), None),
    "stepvideo": (lambda a, p: cw.stepvideo_map(heads=_heads(a, p)),
                  _stepvideo_preprocess),
    "mochi": (lambda a, p: cw.mochi_map(heads=_heads(a, p)), None),
    "mochi_vae": (lambda a, p: _mochi_vae_map(), None),
}

# the JAX package's families whose target module the port does not have
# yet, with the ROADMAP.md item each waits for
WAITING = {
    "flux": "item 8.5 (Flux)",
    "clip_vision": "items 10.4 and 10.5 (models/clip_vision.py)",
    "aesthetic": "items 10.4 and 10.5 (the aesthetic scorer)",
    "llava_projector": "item 4 (HunyuanVideo i2v)",
    "raft": "item 10.5 (the evalkit)", "amt": "item 10.5 (the evalkit)",
}


def build_component(config: Dict[str, Any], component: str
                    ) -> torch.nn.Module:
    """The flow config's ``component`` module on the CPU, its storage
    uninitialised (a strict load fills every parameter)."""
    from videotuna_tpu_torch.core.registry import populate
    from videotuna_tpu_torch.flows.generation import _build_module
    populate()
    comp_cfg = config["flow"]["params"].get(f"{component}_config")
    if not comp_cfg:
        raise SystemExit(f"the config has no flow.params.{component}_config")
    return _build_module(comp_cfg, torch.device("cpu"))


def convert_tree(args, params: Dict[str, Any]) -> Dict[str, Any]:
    """The upstream checkpoint ``args.src`` as the flax-layout tree of
    ``args.family``'s map."""
    if args.family in WAITING:
        raise SystemExit(f"family {args.family!r}: its target module is not "
                         f"ported yet (ROADMAP.md queue 1, "
                         f"{WAITING[args.family]})")
    if args.family not in FAMILIES:
        raise SystemExit(f"unknown family {args.family!r}; available: "
                         f"{sorted(FAMILIES)}")
    sd = cw.load_torch_state_dict(args.src)
    print(f"loaded {len(sd)} tensors from {args.src}")
    if args.split_source:
        comps = cw.split_lightning_components(sd)
        if args.split_source not in comps:
            raise SystemExit(f"--split-source {args.split_source!r} not "
                             f"found; components present: {sorted(comps)}")
        sd = comps[args.split_source]
        print(f"split monolithic checkpoint: using component "
              f"{args.split_source!r} ({len(sd)} tensors)")
    make_map, preprocess = FAMILIES[args.family]
    if preprocess is not None:
        sd = preprocess(sd)
    return make_map(args, params).convert(sd, strict=args.strict)


def cmd_convert(args) -> str:
    from videotuna_tpu_torch.core.config import load_configs
    from videotuna_tpu_torch.tools.from_jax import load_jax_params
    config = load_configs([args.config], args.overrides)
    comp_cfg = config["flow"]["params"].get(f"{args.component}_config") \
        or {}
    tree = convert_tree(args, dict(comp_cfg.get("params") or {}))
    module = build_component(config, args.component)
    load_jax_params(module, tree, args.component)
    n = sum(p.numel() for p in module.parameters())
    print(f"converted {args.component}: {n / 1e6:.1f}M params")
    step_dir = ckpt_lib.save_components(
        args.out, step=0, components={args.component: module.state_dict()})
    print(f"wrote {step_dir}/{args.component}.pt")
    return step_dir


def cmd_inspect(args) -> None:
    root = Path(args.path)
    latest = ckpt_lib.latest_step_dir(str(root))
    target = Path(latest) if latest else root
    print(f"checkpoint: {target}")
    for path in sorted(target.glob("*.pt")):
        try:
            obj = torch.load(path, map_location="cpu", weights_only=True)
            leaves = list(_leaves(obj))
            n = sum(t.numel() for t in leaves)
            print(f"  {path.stem}: {n / 1e6:.2f}M values, {len(leaves)} "
                  "tensors")
        except Exception as e:   # a report, not a check
            print(f"  {path.stem}: unreadable ({e})")


def _leaves(obj: Any):
    if isinstance(obj, dict):
        for v in obj.values():
            yield from _leaves(v)
    elif isinstance(obj, torch.Tensor):
        yield obj


def main(argv=None) -> None:
    ap = argparse.ArgumentParser("videotuna-tpu-torch ckpt tools")
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("convert")
    c.add_argument("--src", required=True)
    c.add_argument("--family", required=True)
    c.add_argument("--config", required=True,
                   help="flow config whose component module is built")
    c.add_argument("--out", required=True)
    c.add_argument("--component", default="denoiser")
    c.add_argument("--heads", type=int, default=None,
                   help="default: the component config's heads/num_heads")
    c.add_argument("--kv_heads", type=int, default=None)
    c.add_argument("--strict", action="store_true",
                   help="raise on upstream tensors that no rule maps")
    c.add_argument("--split-source", default=None, dest="split_source",
                   help="for monolithic Lightning checkpoints: pick one "
                        "component (denoiser/first_stage/cond_stage/"
                        "cond_stage_2) before mapping")
    c.add_argument("overrides", nargs="*",
                   help="dotlist overrides of the config, key.sub=value")
    i = sub.add_parser("inspect")
    i.add_argument("--path", required=True)
    args = ap.parse_args(argv)
    {"convert": cmd_convert, "inspect": cmd_inspect}[args.cmd](args)


if __name__ == "__main__":
    main()
