"""Console-script entry points of the port, the counterpart of
``videotuna_tpu/cli/entrypoints.py``: one zero-argument function per
command of the registry (``cli/commands.py``: COMMANDS, DEV_COMMANDS,
``serve``, ``eval`` and ``list``), named after the command with dashes and
dots as underscores, each calling ``main`` with its command and the
process's arguments.  They are generated from the registry, so the two
cannot drift.
"""

from __future__ import annotations

import sys

from videotuna_tpu_torch.cli.commands import COMMANDS, DEV_COMMANDS, main


def entry_name(command_name: str) -> str:
    """Command name → Python identifier (dashes and dots → underscores)."""
    return command_name.replace("-", "_").replace(".", "_")


def _make_entry(command_name: str):
    def entry() -> int:
        return main([command_name, *sys.argv[1:]])
    entry.__name__ = entry_name(command_name)
    entry.__qualname__ = entry.__name__
    entry.__doc__ = f"console entry for `videotuna-tpu-torch {command_name}`"
    return entry


ALL_ENTRIES = {}
for _name in (*COMMANDS, *DEV_COMMANDS, "serve", "eval", "list"):
    _fn = _make_entry(_name)
    globals()[_fn.__name__] = _fn
    ALL_ENTRIES[_name] = _fn.__name__
del _name, _fn
