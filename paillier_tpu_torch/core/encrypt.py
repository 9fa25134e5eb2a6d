"""Batched encryption (reference: paillier.go:185-289).

Regular encryption at level 1:  c = G^m * r^n mod n^2   (G = n+1)

G^m = 1 + m*n is computed in residue space (one multiply-add and one
exact reduction per channel) and multiplied into r^n by the ladder's
mandatory exit multiply, so encryption is one sliding-window ladder:
kernel B1 on a CUDA tensor.  The port takes the RNS engine at every key
size; the JAX package's limb-Montgomery branch for small keys is not
ported.

Not ported yet: level-2 (Damgard-Jurik s=2) encryption (ROADMAP A.7),
alternative encryption h_s^r (ROADMAP A.8), nested encryption (A.7).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..ops import random as prand
from .keys import (ALTERNATIVE, DEFAULT_LEVEL, LEVEL_ONE, REGULAR,
                   Ciphertext, DeviceKey, PublicKey, encode_batch)


def encrypt_with_r_rns_fused_kernel(dk: DeviceKey, eng, nrow: torch.Tensor,
                                    m: torch.Tensor, r: torch.Tensor,
                                    ns_exp: int) -> torch.Tensor:
    """Level-1 regular encryption with G^m fused into the ladder.

    m: limbs [..., L] (< n); r: limbs [..., 2L]; nrow: int32 [C] true-form
    residues of n.  Returns ciphertext limbs [..., 2L], bit-identical to
    the reference formula (paillier.go:206-218)."""
    from ..bigint.rns2 import rns2_one_plus_mul
    m_wide = torch.nn.functional.pad(m, (0, dk.L))            # width 2L
    gm = rns2_one_plus_mul(eng.ctx, eng.from_limbs(m_wide), nrow)
    c_rns = eng.pow_shared(eng.from_limbs(r), ns_exp, fin=gm)
    return dk._widen(eng.to_limbs_mod(c_rns), LEVEL_ONE)


class Encryptor:
    """Batched encryption for one public key on one torch device.

    Only ``method=REGULAR`` at ``LEVEL_ONE`` is ported; the other
    methods and levels raise ``NotImplementedError``.
    """

    def __init__(self, pk: PublicKey, level: int = DEFAULT_LEVEL,
                 method: str = REGULAR, window: int | None = None, rng=None,
                 *, device):
        from ..config import get_config
        if method not in (REGULAR, ALTERNATIVE):
            raise ValueError(f"unknown encryption method {method!r}")
        if method == ALTERNATIVE:
            raise NotImplementedError(
                "alternative encryption is not ported yet (ROADMAP A.8)")
        if level != LEVEL_ONE:
            raise NotImplementedError(
                f"level-{level} encryption is not ported yet (ROADMAP A.7)")
        self.pk = pk
        self.dk = pk.device(device)
        self.level = level
        self.method = method
        self.window = window if window is not None else get_config().window
        self.rng = rng or prand.make_rng()
        self.m_limbs = self.dk.L
        self.c_limbs = 2 * self.dk.L
        eng = self.dk.rns(LEVEL_ONE)
        spec = eng.spec
        nrow = torch.tensor([pk.n % mi for mi in spec.b1 + spec.b2],
                            dtype=torch.int32, device=self.dk.device)
        self._fn = lambda m, r: encrypt_with_r_rns_fused_kernel(
            self.dk, eng, nrow, m, r, pk.n)

    # -- randomness -------------------------------------------------------
    def sample_r(self, count: int) -> list[int]:
        return prand.random_units(self.pk.n, count, self.rng)

    # -- encryption -------------------------------------------------------
    def encrypt(self, ms: Sequence[int] | torch.Tensor,
                rs: Optional[Sequence[int]] = None) -> Ciphertext:
        """Encrypt a batch of plaintexts (ints < n, or a limb tensor)."""
        dev = self.dk.device
        if isinstance(ms, (list, tuple)):
            m = encode_batch(ms, self.m_limbs, device=dev)
        else:
            m = ms.to(dev)
        count = m[..., 0].numel()
        if rs is None:
            rs = self.sample_r(count)
        r = encode_batch(rs, self.c_limbs, device=dev).reshape(
            m.shape[:-1] + (self.c_limbs,))
        return Ciphertext(c=self._fn(m, r), level=self.level, method=REGULAR)
