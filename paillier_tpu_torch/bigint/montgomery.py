"""Exponent digits for the fixed-window ladder (kernel B2).

Counterpart of the host and tensor helpers of
``paillier_tpu.bigint.montgomery``: :func:`exp_digits` and
:func:`n_digits_for_bits` turn a host integer into MSB-first
base-2^window digits, :func:`limbs_to_digits` does the same for a limb
tensor on the device (the exponent of ``nested_add`` is a ciphertext).

The JAX module's limb-Montgomery scans (``mont_mul``, ``modmul``,
``mod_wide``, ``mont_pow_digits``) are not ported: on the port's paths
every multiply either has a constant operand, which is one int8 Toeplitz
product (:mod:`limbmm`), or multiplies two ciphertexts, which is
``Rns2Engine.mul`` (two base extensions instead of an O(L)-step chain of
launches).  The integers they give are the same.
"""

from __future__ import annotations

import numpy as np
import torch

from .host import LIMB_BITS


def exp_digits(e: int, window: int, n_digits: int) -> np.ndarray:
    """MSB-first base-2^window digits of e, padded to n_digits (host side)."""
    digits = []
    for i in range(n_digits - 1, -1, -1):
        digits.append((e >> (i * window)) & ((1 << window) - 1))
    return np.asarray(digits, dtype=np.int32)


def n_digits_for_bits(bits: int, window: int) -> int:
    return max(1, -(-bits // window))


def limbs_to_digits(x: torch.Tensor, window: int,
                    n_digits: int | None = None) -> torch.Tensor:
    """MSB-first base-2^window digits of a limb tensor, on its device.

    ``window`` must divide LIMB_BITS.  x: limbs [..., L]; output int32
    [..., D] with D = L * LIMB_BITS / window (or left-padded with zeros /
    truncated to the low ``n_digits``).
    """
    if LIMB_BITS % window:
        raise ValueError("window must divide LIMB_BITS")
    per = LIMB_BITS // window
    shifts = torch.arange(per, device=x.device, dtype=torch.int64) * window
    d = (x.to(torch.int64)[..., :, None] >> shifts) & ((1 << window) - 1)
    d = d.reshape(x.shape[:-1] + (x.shape[-1] * per,))     # LE digit string
    d = d.flip(-1).to(torch.int32)                          # MSB-first
    if n_digits is not None:
        D = d.shape[-1]
        if n_digits < D:
            d = d[..., D - n_digits:]
        elif n_digits > D:
            d = torch.nn.functional.pad(d, (n_digits - D, 0))
    return d
