"""Key material and ciphertext containers.

Host-side key objects hold Python-int values (control plane); the derived
:class:`DeviceKey` holds the RNS engines of one public key on one torch
device.

Reference parity: PublicKey/SecretKey/Ciphertext structure follows
paillier.go:46-69; level handling follows paillier.go:403-414.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..bigint import host

# Encryption levels (generalized Damgard-Jurik s; reference: paillier.go:15-23)
LEVEL_ONE = 1
LEVEL_TWO = 2
DEFAULT_LEVEL = LEVEL_ONE  # reference: paillier.go:42

# Encryption methods (reference: paillier.go:27-39)
REGULAR = "regular"
ALTERNATIVE = "alternative"


@dataclass
class Ciphertext:
    """A batch of ciphertexts: int64 limb tensor [..., L_{s+1}] of
    little-endian 16-bit digits.

    ``level`` is the Damgard-Jurik s (1 or 2): the value lives mod n^(s+1).
    """

    c: torch.Tensor
    level: int = DEFAULT_LEVEL
    method: str = REGULAR

    @property
    def batch_shape(self):
        return self.c.shape[:-1]


@dataclass
class PublicKey:
    """Paillier public key (reference: paillier.go:46-56).

    n: modulus, g: generator (always n+1), h: random QR generator used by
    alternative encryption, k: 2^(secparam/2) randomness bound.
    """

    n: int
    g: int
    h: int
    k: int
    bits: int

    def __post_init__(self):
        self._devices: dict = {}

    @property
    def n2(self) -> int:
        return self.n * self.n

    @property
    def n3(self) -> int:
        return self.n * self.n * self.n

    def modulus_for_level(self, level: int) -> int:
        """n^(s+1) for ciphertexts at level s (reference: paillier.go:403-414)."""
        return self.n2 if level == LEVEL_ONE else self.n3

    def plaintext_modulus(self, level: int) -> int:
        """n^s: the plaintext space at level s."""
        return self.n if level == LEVEL_ONE else self.n2

    def device(self, device) -> "DeviceKey":
        """The cached :class:`DeviceKey` of this key on ``device``."""
        dev = torch.device(device)
        if dev not in self._devices:
            self._devices[dev] = DeviceKey(self, dev)
        return self._devices[dev]


@dataclass
class SecretKey(PublicKey):
    """Secret key: lambda = phi(n); p, q retained for CRT decryption
    (the reference drops them; reference: paillier.go:292-303 has no
    CRT)."""

    lam: int = 0
    p: int = 0
    q: int = 0

    def public(self) -> PublicKey:
        return PublicKey(n=self.n, g=self.g, h=self.h, k=self.k,
                         bits=self.bits)


class DeviceKey:
    """Per-device engines for one public key (public-key derived only).

    The RNS engine of each level is built on first use (host-side prime
    search and CRT matrices, then one copy to ``device``)."""

    def __init__(self, pk: PublicKey, device):
        self.pk = pk
        self.device = torch.device(device)
        self.L = host.limbs_for_bits(pk.bits)
        self._rns: dict = {}

    def rns(self, level: int):
        """RNS engine for modulus n^(s+1), cached."""
        if level not in self._rns:
            from ..bigint.engine import make_engine
            self._rns[level] = make_engine(self.pk.modulus_for_level(level),
                                           self.limbs_for_level(level),
                                           device=self.device)
        return self._rns[level]

    def _widen(self, x: torch.Tensor, level: int) -> torch.Tensor:
        """Pad a mod-n^(s+1) result to the canonical ciphertext limb width."""
        want = self.limbs_for_level(level)
        pad = want - x.shape[-1]
        if pad <= 0:
            return x[..., :want]
        return torch.nn.functional.pad(x, (0, pad))

    def limbs_for_level(self, level: int) -> int:
        return 2 * self.L if level == LEVEL_ONE else 3 * self.L


# ---------------------------------------------------------------------------
# host <-> device value helpers
# ---------------------------------------------------------------------------

def encode_batch(values, n_limbs: int, *, device) -> torch.Tensor:
    """List of Python ints -> int64 [B, n_limbs] limb tensor on ``device``."""
    limbs = host.ints_to_limbs(list(values), n_limbs).astype(np.int64)
    return torch.as_tensor(limbs, device=device)


def decode_batch(arr: torch.Tensor) -> list[int]:
    """Limb tensor [B, L] -> list of Python ints."""
    return host.limbs_to_ints(arr.cpu().numpy())
