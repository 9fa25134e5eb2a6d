"""Modexp-engine selection.

The port has one engine, :class:`rns2.Rns2Engine` (Cox-Rower RNS with
the hand-written sliding-window kernel on the GPU), and takes it at
every key size.  The JAX package's v1 bf16 engine (``bigint/rns.py``,
``engine._V1Engine``) and its limb-Montgomery path for small keys are
not ported.
"""

from __future__ import annotations

from .rns2 import Rns2Engine


def make_engine(n_modulus: int, n_limbs: int, *, device) -> Rns2Engine:
    """Build the RNS modexp engine for an odd modulus on ``device``."""
    return Rns2Engine(n_modulus, n_limbs, device=device)
