"""Key material and ciphertext containers.

Host-side key objects hold Python-int values (control plane); the derived
:class:`DeviceKey` holds the RNS engines and limb Montgomery contexts of
one public key on one torch device.

The engine of a level is chosen by the width of its modulus n^(s+1)
alone: the RNS engine where ``Rns2Spec`` takes it (at most
``rns2.MAX_MODULUS_BITS`` bits), else the limb route, the limb Montgomery
ladder at any width (on a CUDA tensor kernel B4 up to
``mont_kernel.REGISTER_MAX_LIMBS`` = 768 limbs, kernel B4w past it).  A
4096-bit key takes the RNS engine at level 1 (n^2: 8,192 bits) and the
limb route at level 2 (n^3: 12,288 bits, 768 limbs, B4); an 8192-bit key
takes the limb route at both (n^2: 1,024 limbs, n^3: 1,536, B4w).

Reference parity: PublicKey/SecretKey/Ciphertext structure follows
paillier.go:46-69; level handling follows paillier.go:403-414.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

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

# Digit width of the limb route's ladders (the JAX package's default)
LIMB_WINDOW = 4


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
    constants (lambda^-1, the CRT plans) stay with the Decryptor.  The RNS
    engine of each level, each limb Montgomery context, each plan and
    each comb table are built on first use (host-side prime search and
    matrices, then one copy to ``device``).  :meth:`pow`,
    :meth:`pow_int` and :meth:`mul` take the RNS engine or the limb route
    by :meth:`limb_route`."""

    def __init__(self, pk: PublicKey, device):
        self.pk = pk
        self.device = torch.device(device)
        self.L = host.limbs_for_bits(pk.bits)
        self._rns: dict = {}
        self._plans: dict = {}

    def limb_route(self, level: int) -> bool:
        """True where the RNS engine cannot take n^(s+1) (more than
        ``rns2.MAX_MODULUS_BITS`` bits): that level runs on the limb
        Montgomery ladder (kernel B4, or B4w past 768 limbs) and limb
        products, which take every width."""
        from ..bigint.rns2 import MAX_MODULUS_BITS
        return self.pk.modulus_for_level(level).bit_length() > \
            MAX_MODULUS_BITS

    def check_level(self, level: int) -> None:
        """Raise ValueError unless ``level`` is 1 or 2.  Every width has
        an engine: the RNS engine up to ``rns2.MAX_MODULUS_BITS`` bits,
        the limb route past it."""
        if level not in (LEVEL_ONE, LEVEL_TWO):
            raise ValueError(f"level must be 1 or 2, got {level}")

    def rns(self, level: int):
        """RNS engine for modulus n^(s+1), cached; raises ValueError where
        the modulus is past ``rns2.MAX_MODULUS_BITS`` (the limb route's
        levels have no RNS engine)."""
        if level not in self._rns:
            if self.limb_route(level):
                from ..bigint.rns2 import MAX_MODULUS_BITS
                bits = self.pk.modulus_for_level(level).bit_length()
                raise ValueError(
                    f"a {self.pk.bits}-bit key at level {level} has a "
                    f"{bits}-bit modulus n^{level + 1}; the RNS engine takes "
                    f"moduli of at most {MAX_MODULUS_BITS} bits")
            from ..bigint.engine import make_engine
            self._rns[level] = make_engine(self.pk.modulus_for_level(level),
                                           self.limbs_for_level(level),
                                           device=self.device)
        return self._rns[level]

    def pow(self, level: int, base: torch.Tensor, digits, window: int = 4
            ) -> torch.Tensor:
        """base^e mod n^(s+1) on the RNS engine's fixed-window ladder
        (kernel B2 on a CUDA tensor), or on the limb route the limb
        Montgomery ladder (``montgomery.mont_pow_digits``: kernel B4 on a
        CUDA tensor, the plain ladder on a CPU tensor).

        ``digits``: int [D] shared or [..., D] per element, MSB-first
        base-2^window; base: limbs [..., L_{s+1}].  Returns limbs."""
        if self.limb_route(level):
            from ..bigint import montgomery as mont
            return mont.mont_pow_digits(
                self.ctx_for_level(level), base.to(torch.int64),
                torch.as_tensor(digits, device=base.device), window)
        eng = self.rns(level)
        out = eng.pow(eng.from_limbs(base), torch.as_tensor(digits), window)
        return self._widen(eng.to_limbs_mod(out), level)

    def pow_int(self, level: int, base: torch.Tensor, e: int
                ) -> torch.Tensor:
        """pow with a host-int shared exponent, on the sliding-window
        odd-power ladder (``Rns2Engine.pow_shared``, kernel B1 on a CUDA
        tensor; fewer multiplies than the fixed-window ladder; its window
        is Config.sliding_window), or on the limb route :meth:`pow` with
        e's base-16 digits (the JAX package's window 4)."""
        if e == 0:
            return vpu.one_like(base)
        if self.limb_route(level):
            from ..bigint import montgomery as mont
            nd = mont.n_digits_for_bits(e.bit_length(), LIMB_WINDOW)
            return self.pow(level, base, mont.exp_digits(e, LIMB_WINDOW, nd),
                            LIMB_WINDOW)
        eng = self.rns(level)
        out = eng.pow_shared(eng.from_limbs(base), e)
        return self._widen(eng.to_limbs_mod(out), level)

    def mul(self, level: int, a: torch.Tensor, b: torch.Tensor
            ) -> torch.Tensor:
        """a * b mod n^(s+1) for two limb tensors (``Rns2Engine.mul``: two
        Montgomery multiplies in residue space; on the limb route
        ``montgomery.modmul``, two limb Montgomery products)."""
        if self.limb_route(level):
            from ..bigint import montgomery as mont
            return mont.modmul(self.ctx_for_level(level), a.to(torch.int64),
                               b.to(torch.int64))
        eng = self.rns(level)
        out = eng.mul(eng.from_limbs(a), eng.from_limbs(b))
        return self._widen(eng.to_limbs_mod(out), level)

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

    def comb_table(self, level: int, window: int) -> torch.Tensor:
        """The comb table of h_s for exponents r < K (rns2
        .build_fixed_base_table: int32 [D*2^w, C] on this device), cached
        per (level, window)."""
        from ..bigint.montgomery import n_digits_for_bits
        from ..bigint.rns2 import build_fixed_base_table
        nd = n_digits_for_bits(self.pk.k.bit_length() - 1, window)
        return self._plan(("comb", level, window),
                          lambda: build_fixed_base_table(
                              self.rns(level), self.hs_int_for_level(level),
                              nd, window))

    def ctx_for_level(self, level: int):
        """Limb Montgomery context of n^(s+1) at the ciphertext width
        (2L or 3L limbs) on this device, cached: the limb route's
        modulus."""
        from ..bigint.montgomery import make_mont_ctx
        return self._plan(("mont", level), lambda: make_mont_ctx(
            self.pk.modulus_for_level(level), self.limbs_for_level(level),
            device=self.device))

    def hs_for_level(self, level: int) -> torch.Tensor:
        """h_s as limbs [L_{s+1}] on this device, cached: the fixed base
        of alternative encryption on the limb route."""
        return self._plan(("hs limbs", level), lambda: encode_batch(
            [self.hs_int_for_level(level)], self.limbs_for_level(level),
            device=self.device)[0])

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
    values = list(values)
    with span("encode", rows=len(values)):
        limbs = host.ints_to_limbs(values, n_limbs).astype(np.int64)
        return torch.as_tensor(limbs, device=device)


def decode_batch(arr: torch.Tensor) -> list[int]:
    """Limb tensor [B, L] -> list of Python ints."""
    with span("decode", rows=arr.shape[0]):
        return host.limbs_to_ints(arr.cpu().numpy())
