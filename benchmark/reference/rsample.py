"""Plain encryption with randomness drawn by the program's own sampler.

Frozen copy of the draws the program makes for ``Encryptor.encrypt(ms)``
(``ops.random.random_units``: for each row, ``rng.randrange(n)`` until
the value is a nonzero unit, utils.go:36-49), replayed from the
generator the benchmark seeded for the request.
"""

from __future__ import annotations

import random

from .paillier import Key, encrypt
from .threshold import random_unit


def encrypt_rows(key: Key, seed: str, count: int, rows: list[int],
                 ms: list[int]) -> list[int]:
    """The ciphertexts of ``rows`` (plaintexts ``ms``) of a batch of
    ``count`` whose r were drawn in row order from
    ``random.Random(seed)``."""
    rng = random.Random(seed)
    rs = [random_unit(key.n, rng) for _ in range(count)]
    return [encrypt(key, m, rs[j]) for j, m in zip(rows, ms)]
