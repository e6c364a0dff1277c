"""Component registry: maps config ``target:`` strings to constructors.

The configs under ``configs/`` name the JAX package's classes
(``videotuna_tpu.models.cogvideo.CogVideoXTransformer``) and legacy upstream
aliases (``diffusers.CogVideoXTransformer3DModel``).  ``resolve`` maps both to
this package's classes: a ``videotuna_tpu.`` prefix is rewritten to
``videotuna_tpu_torch.``, and every class registers the same aliases as its
JAX counterpart, so the YAML files load unchanged.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict, Iterable

_REGISTRY: Dict[str, Any] = {}

PACKAGE = "videotuna_tpu_torch"
_JAX_PREFIX = "videotuna_tpu."

# Sentinels for "this stage has no module".
FIRST_STAGE_SENTINEL = "__is_first_stage__"
UNCONDITIONAL_SENTINEL = "__is_unconditional__"

# Modules imported for their @register side effects.
_MODULES = (
    "videotuna_tpu_torch.models.vae2d",
    "videotuna_tpu_torch.models.vae3d",
    "videotuna_tpu_torch.models.cogvideo.vae",
    "videotuna_tpu_torch.models.text_encoders",
    "videotuna_tpu_torch.models.cogvideo.mmdit",
    "videotuna_tpu_torch.models.opensora.stdit",
    "videotuna_tpu_torch.models.hunyuan.dit",
    "videotuna_tpu_torch.models.hunyuan.vae",
    "videotuna_tpu_torch.models.wan.dit",
    "videotuna_tpu_torch.models.wan.vae",
    "videotuna_tpu_torch.models.lvdm",
    "videotuna_tpu_torch.models.stepvideo.dit",
    "videotuna_tpu_torch.models.mochi.dit",
    "videotuna_tpu_torch.models.mochi_vae",
    "videotuna_tpu_torch.schedulers",
    "videotuna_tpu_torch.flows",
    "videotuna_tpu_torch.data.datasets",
)


def register(name: str, aliases: Iterable[str] = ()) -> Callable[[Any], Any]:
    """Class/function decorator registering it under ``name`` (+ aliases)."""

    def deco(obj: Any) -> Any:
        _REGISTRY[name] = obj
        for a in aliases:
            _REGISTRY[a] = obj
        return obj

    return deco


def _port_name(target: str) -> str:
    if target.startswith(_JAX_PREFIX):
        return f"{PACKAGE}.{target[len(_JAX_PREFIX):]}"
    return target


def resolve(target: str) -> Any:
    """Resolve a ``target:`` string to a constructor of this package.

    Lookup order: registry (after the JAX prefix rewrite) → import of a
    ``videotuna_tpu_torch.*`` dotted path.  No other module is imported."""
    name = _port_name(target)
    if name not in _REGISTRY:
        populate()
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name.startswith(PACKAGE + "."):
        module, _, attr = name.rpartition(".")
        try:
            obj = getattr(importlib.import_module(module), attr)
        except (ImportError, AttributeError) as e:
            raise KeyError(
                f"{target!r} has no counterpart in {PACKAGE} yet "
                "(see ROADMAP.md for the port's slices)") from e
        _REGISTRY[name] = obj
        return obj
    raise KeyError(
        f"Unknown target {target!r}. Register it with "
        f"{PACKAGE}.core.registry.register, or use a videotuna_tpu.* path.")


def known_targets() -> list[str]:
    return sorted(_REGISTRY)


def instantiate(config: Any, **extra_kwargs: Any) -> Any:
    """Instantiate from a ``{target: ..., params: {...}}`` mapping (or a bare
    target string), honouring the first-stage / unconditional sentinels."""
    if isinstance(config, str):
        target = config
        params: Dict[str, Any] = {}
    else:
        if "target" not in config:
            if config in (FIRST_STAGE_SENTINEL, UNCONDITIONAL_SENTINEL):
                return None
            raise KeyError(f"Expected `target` key in config: {config!r}")
        target = config["target"]
        params = dict(config.get("params") or {})
    if target in (FIRST_STAGE_SENTINEL, UNCONDITIONAL_SENTINEL):
        return None
    params.update(extra_kwargs)
    return resolve(target)(**params)


_POPULATED = False


def populate() -> None:
    """Import every module of the port that registers components."""
    global _POPULATED
    if _POPULATED:
        return
    _POPULATED = True
    for mod in _MODULES:
        importlib.import_module(mod)
