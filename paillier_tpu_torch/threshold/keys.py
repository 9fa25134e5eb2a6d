"""Threshold key material (reference: thresholdkey.go:26-58).

ThresholdPublicKey carries the verification base V (a QR generator of
Z_{n^2}) and per-server verification keys V_i for the share-decryption
ZKPs; ThresholdSecretKey adds the server ID and Shamir share.  Host-side
Python ints, as in the JAX package; :func:`from_reference` carries a key
across from any object with the JAX dataclasses' attributes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from ..bigint import host
from ..core.keys import PublicKey


@dataclass
class ThresholdPublicKey(PublicKey):
    """(reference: thresholdkey.go:26-32).  A PublicKey, so threshold
    keys encrypt with the same Encryptor (regular method; as in the
    reference, threshold keys have no h for alternative encryption)."""

    l: int = 0            # TotalNumberOfDecryptionServers
    t: int = 0            # Threshold
    v: int = 0            # VerificationKey
    vi: Tuple[int, ...] = ()   # VerificationKeys (server i at vi[i-1])

    @property
    def delta(self) -> int:
        """l! (thresholdkey.go:70-72)."""
        return host.factorial(self.l)

    @property
    def combine_shares_constant(self) -> int:
        """(4*delta^2)^{-1} mod n (thresholdkey.go:63-66)."""
        return pow(4 * self.delta * self.delta, -1, self.n)

    def public(self) -> "ThresholdPublicKey":
        """The public part, as a new key with its own device cache."""
        return ThresholdPublicKey(n=self.n, g=self.g, h=self.h, k=self.k,
                                  bits=self.bits, l=self.l, t=self.t,
                                  v=self.v, vi=tuple(self.vi))


@dataclass
class ThresholdSecretKey(ThresholdPublicKey):
    """Per-server secret share (reference: thresholdkey.go:38-42)."""

    id: int = 0           # servers are indexed from 1
    share: int = 0


@dataclass
class PartialDecryption:
    """(reference: thresholdkey.go:44-48)."""

    id: int
    decryption: int


@dataclass
class PartialDecryptionZKP(PartialDecryption):
    """Non-interactive Fiat-Shamir proof of correct share decryption
    (reference: thresholdkey.go:50-58)."""

    key: ThresholdPublicKey = None
    e: int = 0            # challenge
    z: int = 0            # response
    c: int = 0            # the ciphertext value proven about


_PUBLIC_FIELDS = ("n", "g", "h", "k", "bits", "l", "t", "v")


def from_reference(obj) -> ThresholdPublicKey:
    """The port's threshold key with the attributes of ``obj`` (n, g, h,
    k, bits, l, t, v, vi and, for a secret key, id and share), e.g. a key
    of the JAX package: a ThresholdSecretKey where ``obj`` has a share,
    else a ThresholdPublicKey."""
    fields = {f: int(getattr(obj, f)) for f in _PUBLIC_FIELDS}
    fields["vi"] = tuple(int(x) for x in obj.vi)
    if hasattr(obj, "share"):
        return ThresholdSecretKey(**fields, id=int(obj.id),
                                  share=int(obj.share))
    return ThresholdPublicKey(**fields)
