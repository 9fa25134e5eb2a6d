"""Runtime configuration of the port.

The JAX package's ``Config`` also carries TPU knobs (Pallas batch block,
lane-padding ablation, forced-RNS switch, engine kind); none of them has
a meaning on the GPU, so the port keeps only the sliding-ladder window.
Its ``window`` (the fixed-window digit width) is not kept either: kernel
B2's only callers, the per-element exponents of ``const_mult`` and the
nested operations, use the JAX default of 4 (``homomorphic.B2_WINDOW``).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Config:
    """Port-wide tunables.

    sliding_window: window for the shared-exponent sliding-window
                    odd-power ladder (the r^n / c^(p-1) hot paths).
    """

    sliding_window: int = 6


_config = Config()


def get_config() -> Config:
    return _config


def set_config(cfg: Config) -> None:
    """Replace the global config (tests / embedding applications)."""
    global _config
    _config = cfg
