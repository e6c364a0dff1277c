"""PRNG discipline: one seed in, named generator streams out.

The counterpart of the JAX package's ``KeyChain``: ``keys("sample")`` returns
a fresh ``torch.Generator`` whose seed is derived from (seed, stream name,
call index), so a run is deterministic per (seed, stream, step) and no code
touches torch's global RNG.  The streams give other numbers than
``jax.random`` from the same seed; tests that compare the two packages make
their inputs and noise with numpy and hand them to both.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Union

import torch


def derive_seed(seed: int, stream: str, index: int) -> int:
    """63-bit seed for (seed, stream, index)."""
    digest = hashlib.sha256(f"{seed}/{stream}/{index}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


class KeyChain:
    """Deterministic named generator streams on one device."""

    def __init__(self, seed: int,
                 device: Union[str, torch.device] = "cpu"):
        self.seed = int(seed)
        self.device = torch.device(device)
        self._counters: Dict[str, int] = {}

    def __call__(self, stream: str) -> torch.Generator:
        idx = self._counters.get(stream, 0)
        self._counters[stream] = idx + 1
        return self.fixed(stream, idx)

    def fixed(self, stream: str, step: int) -> torch.Generator:
        """Stateless variant: the generator for ``stream`` at ``step``."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(derive_seed(self.seed, stream, step))
        return gen
