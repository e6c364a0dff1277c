"""Config system: YAML files + dotlist overrides, the same surface as the JAX
package's ``videotuna_tpu/core/config.py`` (``-b a.yaml b.yaml`` merged left to
right, ``key.sub=value`` overrides, ``target:``/``params:`` component configs,
dtype strings).  ``resolve_dtype`` maps dtype strings to torch dtypes and
``resolve_device`` picks the device of an entry point.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Sequence, Union

import torch
import yaml

ConfigDict = Dict[str, Any]

DTYPE_MAP = {
    "fp32": torch.float32,
    "float32": torch.float32,
    "fp16": torch.float16,
    "float16": torch.float16,
    "bf16": torch.bfloat16,
    "bfloat16": torch.bfloat16,
    "fp8": torch.float8_e4m3fn,
    "fp8_e4m3": torch.float8_e4m3fn,
    "fp8_e5m2": torch.float8_e5m2,
}


def resolve_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    """``torch.float16``/``jnp.bfloat16``-style and short dtype strings →
    torch dtypes; a torch dtype passes through."""
    if not isinstance(name, str):
        return name
    key = name.replace("torch.", "").replace("jnp.", "").lower()
    if key in DTYPE_MAP:
        return DTYPE_MAP[key]
    dtype = getattr(torch, key, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"Unknown dtype {name!r}")
    return dtype


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """Device of an entry point: ``None`` means ``cuda``.  Raises when a
    CUDA device is asked for and none is present — the port never carries
    on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: "
            "--device cpu) to run on the CPU")
    return dev


def load_yaml(path: Union[str, Path]) -> ConfigDict:
    with open(path) as f:
        return yaml.safe_load(f) or {}


def deep_merge(base: ConfigDict, override: Mapping[str, Any]) -> ConfigDict:
    """Recursive dict merge; override wins. Lists are replaced, not merged."""
    out = copy.deepcopy(dict(base))
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, Mapping):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _parse_scalar(text: str) -> Any:
    # YAML 1.1 won't parse "1e-4" as float; try numeric forms first.
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        pass
    return yaml.safe_load(text)


def apply_dotlist(config: ConfigDict, dotlist: Sequence[str]) -> ConfigDict:
    """Apply ``a.b.c=value`` overrides."""
    out = copy.deepcopy(config)
    for item in dotlist:
        if "=" not in item:
            raise ValueError(f"Override {item!r} must look like key.sub=value")
        key, _, raw = item.partition("=")
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise ValueError(f"Cannot override through non-dict at {p!r}")
        node[parts[-1]] = _parse_scalar(raw)
    return out


def _load_with_defaults(path: Union[str, Path],
                        _depth: int = 0) -> ConfigDict:
    """Load a YAML; a top-level ``defaults: <path>`` key pulls in a base
    config first (relative to the working directory or the file's)."""
    if _depth > 8:
        raise RecursionError(f"defaults chain too deep at {path}")
    cfg = load_yaml(path)
    base_ref = cfg.pop("defaults", None)
    if base_ref:
        base_path = Path(base_ref)
        if not base_path.exists():
            base_path = Path(path).parent / base_ref
        base = _load_with_defaults(base_path, _depth + 1)
        cfg = deep_merge(base, cfg)
    return cfg


def load_configs(paths: Sequence[Union[str, Path]],
                 dotlist: Sequence[str] = ()) -> ConfigDict:
    """Merge YAML files left→right then apply CLI dotlist overrides."""
    cfg: ConfigDict = {}
    for p in paths:
        cfg = deep_merge(cfg, _load_with_defaults(p))
    if dotlist:
        cfg = apply_dotlist(cfg, dotlist)
    return cfg


def apply_inference_mapping(config: ConfigDict) -> ConfigDict:
    """Re-route ``inference:`` args into flow params via ``inference.mapping``:
    entries ``{arg_name: dotted.path}`` copy ``config["inference"][arg_name]``
    to ``config[<dotted.path>]``."""
    out = copy.deepcopy(config)
    inf = out.get("inference") or {}
    mapping = inf.get("mapping") or {}
    for arg_name, dotted in mapping.items():
        if arg_name not in inf:
            continue
        node = out
        parts = dotted.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = inf[arg_name]
    return out


def check_required(config: ConfigDict, required: Sequence[str]) -> None:
    """Raise when a mandatory dotted key is missing or null."""
    missing = []
    for dotted in required:
        node: Any = config
        for p in dotted.split("."):
            if not isinstance(node, Mapping) or p not in node:
                missing.append(dotted)
                break
            node = node[p]
        else:
            if node is None:
                missing.append(dotted)
    if missing:
        raise ValueError(f"Missing required config keys: {missing}")


def format_config(config: ConfigDict, title: str = "config") -> str:
    """Boxed pretty-printer."""
    body = yaml.safe_dump(config, sort_keys=False, default_flow_style=False)
    lines = body.rstrip("\n").split("\n")
    width = max([len(title) + 2] + [len(l) for l in lines]) + 2
    top = "┌" + "─" * width + "┐"
    mid = f"│ {title}".ljust(width + 1) + "│"
    sep = "├" + "─" * width + "┤"
    rows = [f"│ {l}".ljust(width + 1) + "│" for l in lines]
    bot = "└" + "─" * width + "┘"
    return "\n".join([top, mid, sep, *rows, bot])
