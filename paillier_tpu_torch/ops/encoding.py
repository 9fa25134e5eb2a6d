"""Fixed-point plaintext encoding (reference: plaintext.go:10-18).

EncodeFixedPoint(a, prec) = floor(a * 2^prec).  The reference provides no
decode; we add one (plus a signed variant via the usual mod-n embedding)
since a usable framework needs the roundtrip.  Host functions, the same
as ``paillier_tpu.ops.encoding``'s.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Sequence


def encode_fixed_point(a, prec: int) -> int:
    """floor(a * 2^prec) as an int.  ``a`` may be float, Fraction or str
    (str/Fraction avoid double rounding for high precisions)."""
    f = Fraction(a) if not isinstance(a, Fraction) else a
    scaled = f * (1 << prec)
    return int(scaled) if scaled >= 0 else -int(-scaled) - (scaled != int(scaled))


def decode_fixed_point(v: int, prec: int) -> float:
    return v / (1 << prec)


def encode_signed(v: int, n: int) -> int:
    """Embed a signed integer into Z_n (negative -> n - |v|)."""
    if abs(v) * 2 >= n:
        raise ValueError("value too large for signed embedding")
    return v % n


def decode_signed(v: int, n: int) -> int:
    return v - n if v * 2 >= n else v


def encode_fixed_point_batch(vals: Sequence, prec: int) -> list[int]:
    return [encode_fixed_point(v, prec) for v in vals]
