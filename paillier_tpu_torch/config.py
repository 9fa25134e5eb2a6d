"""Runtime configuration of the port.

The JAX package's ``Config`` also carries TPU knobs (Pallas batch block,
lane-padding ablation, forced-RNS switch, engine kind); none of them has
a meaning on the GPU, so the port keeps the sliding-ladder window and the
mesh shape of :func:`paillier_tpu_torch.parallel.make_mesh`.
Its ``window`` (the fixed-window digit width) is not kept either: kernel
B2's only callers, the per-element exponents of ``const_mult`` and the
nested operations, use the JAX default of 4 (``homomorphic.B2_WINDOW``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class Config:
    """Port-wide tunables.

    sliding_window: window for the shared-exponent sliding-window
                    odd-power ladder (the r^n / c^(p-1) hot paths).
    mesh_devices:   devices (ranks) for parallel.make_mesh(); None = the
                    world size of the process group.
    mesh_servers:   threshold server-axis rows for 2-D meshes; None = 1-D.
    """

    sliding_window: int = 6
    mesh_devices: Optional[int] = None
    mesh_servers: Optional[int] = None


_config = Config()


def get_config() -> Config:
    return _config


def set_config(cfg: Config) -> None:
    """Replace the global config (tests / embedding applications)."""
    global _config
    _config = cfg
