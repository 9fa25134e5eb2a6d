"""Key material and ciphertext containers.

Host-side key objects hold Python-int values (control plane); the derived
:class:`DeviceKey` holds the engine of each level of one public key on
one torch device, chosen by ``bigint.engine.make_engine`` from the width
of n^(s+1) alone (a 4096-bit key's level 2 and both levels of an
8192-bit key are past the RNS engine and take the limb engine).

Reference parity: PublicKey/SecretKey/Ciphertext structure follows
paillier.go:46-69; level handling follows paillier.go:403-414.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..bigint import host, vpu
from ..ops.profiling import span

# Encryption levels (generalized Damgard-Jurik s; reference: paillier.go:15-23)
LEVEL_ONE = 1
LEVEL_TWO = 2
DEFAULT_LEVEL = LEVEL_ONE  # reference: paillier.go:42

# Encryption methods (reference: paillier.go:27-39)
REGULAR = "regular"
ALTERNATIVE = "alternative"
MIXED = "mixed"

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

    def device(self, device="cuda") -> "DeviceKey":
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
    """Per-device engines, limb plans and tables for one public key.

    Everything here is derived from the public key alone; secret-derived
    constants (lambda^-1, the CRT plans) stay with the Decryptor.  The
    engine of each level (``bigint.engine.make_engine``), each plan and
    each fixed-base table are built on first use (host-side prime search
    and matrices, then one copy to ``device``) and kept.  :meth:`pow`,
    :meth:`pow_int` and :meth:`mul` take limbs and return limbs at the
    ciphertext width."""

    def __init__(self, pk: PublicKey, device):
        self.pk = pk
        self.device = torch.device(device)
        self.L = host.limbs_for_bits(pk.bits)
        self._engines: dict = {}
        self._plans: dict = {}

    def check_level(self, level: int) -> None:
        """Raise ValueError unless ``level`` is 1 or 2 (every width has an
        engine)."""
        if level not in (LEVEL_ONE, LEVEL_TWO):
            raise ValueError(f"level must be 1 or 2, got {level}")

    def engine(self, level: int):
        """The engine of n^(s+1) at the ciphertext width, cached: the RNS
        engine or, past its width, the limb engine (``make_engine``)."""
        eng = self._engines.get(level)
        if eng is None:
            from ..bigint.engine import make_engine
            eng = self._engines[level] = make_engine(
                self.pk.modulus_for_level(level), self.limbs_for_level(level),
                device=self.device)
        return eng

    def pow(self, level: int, base: torch.Tensor, digits, window: int = 4
            ) -> torch.Tensor:
        """base^e mod n^(s+1) on the engine's fixed-window ladder (kernel
        B2, or B4 / B4w on the limb engine, on a CUDA tensor).

        ``digits``: int [D] shared or [..., D] per element, MSB-first
        base-2^window; base: limbs [..., L_{s+1}].  Returns limbs."""
        eng = self.engine(level)
        return eng.to_limbs_mod(eng.pow(eng.from_limbs(base),
                                        torch.as_tensor(digits), window))

    def pow_int(self, level: int, base: torch.Tensor, e: int
                ) -> torch.Tensor:
        """pow with a host-int shared exponent (``pow_shared``: the
        sliding-window odd-power ladder, kernel B1 on a CUDA tensor, with
        Config.sliding_window; the limb engine's ladder on e's digits)."""
        if e == 0:
            return vpu.one_like(base)
        eng = self.engine(level)
        return eng.to_limbs_mod(eng.pow_shared(eng.from_limbs(base), e))

    def mul(self, level: int, a: torch.Tensor, b: torch.Tensor
            ) -> torch.Tensor:
        """a * b mod n^(s+1) for two limb tensors (the engine's ``mul``:
        two Montgomery multiplies)."""
        eng = self.engine(level)
        return eng.to_limbs_mod(eng.mul(eng.from_limbs(a), eng.from_limbs(b)))

    # -- limb plans (limbmm), cached per key and device ---------------------
    def _plan(self, key, build):
        plan = self._plans.get(key)
        if plan is None:
            plan = self._plans[key] = build()
        return plan

    def const_mul_plan(self, d: int, lin: int, lout: int):
        from ..bigint import limbmm as lm
        return self._plan(("cm", d, lin, lout), lambda: lm.ConstMulPlan.build(
            d, lin, lout, device=self.device))

    def mod_mul_plan(self, d: int, modulus: int, lin: int):
        from ..bigint import limbmm as lm
        return self._plan(("mm", d, modulus, lin),
                          lambda: lm.ModMulConstPlan.build(
                              d, modulus, lin, device=self.device))

    def fold_plan(self, modulus: int, lin: int):
        from ..bigint import limbmm as lm
        return self._plan(("fold", modulus, lin), lambda: lm.FoldPlan.build(
            modulus, lin, device=self.device))

    def barrett_plan(self, modulus: int):
        from ..bigint import limbmm as lm
        return self._plan(("br", modulus), lambda: lm.BarrettPlan.build(
            modulus, device=self.device))

    def div_n_plan(self, width: int):
        """Exact division by n at ``width`` limbs: x * n^-1 mod
        2^(16*width) (Hensel), for decryption's L(u) = (u - 1)/n."""
        return self.const_mul_plan(host.hensel_inverse(self.pk.n, width),
                                   width, width)

    def inv2_n_plan(self):
        """(x * 2^-1) mod n for a 2L-limb x: level-2 G^m's C(m, 2)."""
        return self.mod_mul_plan((self.pk.n + 1) // 2, self.pk.n, 2 * self.L)

    def hs_int_for_level(self, level: int) -> int:
        """Alternative encryption's generator h_s as a Python int (host
        pow; reference: paillier.go:416-434): h1 = (n-h)^n mod n^2,
        h2 = (n^2-h)^(n^2) mod n^3."""
        pk = self.pk
        if level == LEVEL_ONE:
            return self._plan(("hs", level),
                              lambda: pow(pk.n - pk.h, pk.n, pk.n2))
        return self._plan(("hs", level),
                          lambda: pow(pk.n2 - pk.h, pk.n2, pk.n3))

    def fixed_base(self, level: int, window: int):
        """Alternative encryption's fixed base h_s for exponents r < K in
        the engine's form (``fixed_base``: the comb table, int32
        [D*2^w, C], on the RNS engine; h_s's limbs on the limb engine),
        cached per (level, window)."""
        from ..bigint.montgomery import n_digits_for_bits
        nd = n_digits_for_bits(self.pk.k.bit_length() - 1, window)
        return self._plan(("fixed base", level, window),
                          lambda: self.engine(level).fixed_base(
                              self.hs_int_for_level(level), nd, window))

    def mont_ctx_n(self):
        """Limb Montgomery context of n at L limbs (kernel B4's modulus in
        ``extract_randomness``)."""
        from ..bigint.montgomery import make_mont_ctx
        return self._plan(("mont", self.pk.n), lambda: make_mont_ctx(
            self.pk.n, self.L, device=self.device))

    def inv2fac_n2_plan(self):
        """(x * n * 2^-1) mod n^2 for a 2L-limb x: level-2 recovery."""
        n2 = self.pk.n2
        return self.mod_mul_plan(self.pk.n * pow(2, -1, n2) % n2, n2,
                                 2 * self.L)

    def limbs_for_level(self, level: int) -> int:
        return 2 * self.L if level == LEVEL_ONE else 3 * self.L


# ---------------------------------------------------------------------------
# host <-> device value helpers
# ---------------------------------------------------------------------------

def encode_batch(values, n_limbs: int, *, device) -> torch.Tensor:
    """List of Python ints -> int64 [B, n_limbs] limb tensor on ``device``."""
    values = list(values)
    with span("encode", rows=len(values)):
        limbs = host.ints_to_limbs(values, n_limbs).astype(np.int64)
        return torch.as_tensor(limbs, device=device)


def decode_batch(arr: torch.Tensor) -> list[int]:
    """Limb tensor [B, L] -> list of Python ints."""
    with span("decode", rows=arr.shape[0]):
        return host.limbs_to_ints(arr.cpu().numpy())
