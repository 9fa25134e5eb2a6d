"""Runtime configuration of the port.

The JAX package's ``Config`` also carries TPU knobs (Pallas batch block,
lane-padding ablation, forced-RNS switch, engine kind); none of them has
a meaning on the GPU, so the port keeps only the ladder windows.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Config:
    """Port-wide tunables.

    window:         fixed-window ladder digit width (bits) for
                    per-element exponents; kept on Encryptor/Decryptor
                    for the fixed-window kernel B2 (not ported yet).
    sliding_window: window for the shared-exponent sliding-window
                    odd-power ladder (the r^n / c^(p-1) hot paths).
    """

    window: int = 4
    sliding_window: int = 6


_config = Config()


def get_config() -> Config:
    return _config


def set_config(cfg: Config) -> None:
    """Replace the global config (tests / embedding applications)."""
    global _config
    _config = cfg
