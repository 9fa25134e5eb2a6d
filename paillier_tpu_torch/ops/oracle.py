"""Fiat-Shamir random oracle (reference: random_oracle.go:10-32) and the
share-ZKP hash (reference: thresholdkey.go:319-326), on the host.

The port's copy of ``paillier_tpu.ops.oracle``.  Byte semantics follow
Go's ``gmp.Int.Bytes()``: minimal big-endian encoding, *empty* for zero,
so lengths vary per value, which matters for hash parity.  Two quirks of
the reference are kept on purpose, for bit parity:

* ``oracle_digest`` SKIPS ITS FIRST ARGUMENT (the ``if i == 0: continue``
  at random_oracle.go:24-26), so DDLEQ challenges do not bind ct1.C.
* The threshold ZKP hash takes the UNREDUCED integers c^4 and c_i^2
  (thresholdkey.go:241,248 call Exp with a nil modulus).

The batched hash of many proofs is :mod:`paillier_tpu_torch.ops.sha256`.
"""

from __future__ import annotations

import hashlib


def go_bytes(v: int) -> bytes:
    """Go gmp.Int.Bytes(): minimal big-endian, empty for 0."""
    if v == 0:
        return b""
    return v.to_bytes((v.bit_length() + 7) // 8, "big")


def oracle_digest(*values: int) -> bytes:
    """SHA-256 over concatenated go_bytes of values[1:]: the first input
    is skipped (random_oracle.go:24-26)."""
    h = hashlib.sha256()
    for v in values[1:]:
        h.update(go_bytes(v))
    return h.digest()


def oracle_bit(*values: int) -> bool:
    """Digest mod 2 == 1 (random_oracle.go:10-16)."""
    return int.from_bytes(oracle_digest(*values), "big") % 2 == 1


def zkp_hash(a: int, b: int, c4: int, ci2: int) -> int:
    """SHA-256(a || b || c^4 || c_i^2) as an integer
    (thresholdkey.go:319-326).  c4 and ci2 must be the unreduced powers."""
    h = hashlib.sha256()
    for v in (a, b, c4, ci2):
        h.update(go_bytes(v))
    return int.from_bytes(h.digest(), "big")
