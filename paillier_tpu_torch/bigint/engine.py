"""One engine per modulus, chosen by width in :func:`make_engine`.

Every caller holds an engine of its modulus and speaks to it through
one interface, whichever the engine:

* ``from_limbs`` / ``to_limbs_mod``: int64 limbs in and out, the result
  canonical mod N at the width the engine was built for;
* ``mont_mul``, ``mul``, ``pow(x, digits, window)``,
  ``pow_shared(x, e, fin=None)`` (x^e, times ``fin`` when given);
* ``one`` (the integer 1 in the engine's form), ``radix`` (the
  Montgomery radix, M or R, for a product tree's fix-up) and ``encode``;
* ``one_plus_mul(x, c)`` (the integer 1 + x*c < N: encryption's level-1
  G^m), ``fixed_base`` / ``pow_fixed_base`` (a fixed base's powers:
  alternative encryption's h_s^r).

:class:`rns2.Rns2Engine` (kernels B1-B3 on a CUDA tensor) takes moduli of
up to ``rns2.MAX_MODULUS_BITS`` bits; :class:`LimbEngine`, the limb
Montgomery ladder (kernel B4, or B4w past 768 limbs, on a CUDA tensor),
takes every width and is the engine past it.  The JAX package picks its
engine by backend; the port by width alone.  :func:`product_tree` and
:class:`CrtSplit` are written once over the interface.
"""

from __future__ import annotations

import functools

import torch

from . import host, vpu
from . import limbmm as lm
from . import montgomery as mont
from . import rns2

# Digit width of the limb ladders (the JAX package's default)
LIMB_WINDOW = 4


def make_engine(n_modulus: int, n_limbs: int, *, device):
    """The engine of an odd modulus on ``device`` at ``n_limbs`` limbs:
    the RNS engine up to ``rns2.MAX_MODULUS_BITS`` bits (read at call
    time), the limb engine past it."""
    if n_modulus.bit_length() > rns2.MAX_MODULUS_BITS:
        return LimbEngine(n_modulus, n_limbs, device=device)
    return rns2.Rns2Engine(n_modulus, n_limbs, device=device)


class LimbEngine:
    """The limb Montgomery engine of one odd modulus N on one device: the
    RNS engine's interface on int64 limbs [..., L], which are its own
    form (``from_limbs`` / ``to_limbs_mod`` only fit the width)."""

    def __init__(self, n_modulus: int, n_limbs: int | None = None, *,
                 device):
        self.ctx = mont.make_mont_ctx(n_modulus, n_limbs, device=device)
        self.L = self.ctx.n_limbs
        self.radix = 1 << (host.LIMB_BITS * self.L)
        self.one = vpu.one_like(self.ctx.n)
        # e's digits for the exponents seen last, as rns2.Rns2Engine
        # keeps their schedules
        self._digits = functools.lru_cache(rns2.EXPONENT_CACHE)(
            self._exp_digits)
        self._plans: dict = {}

    @property
    def device(self) -> torch.device:
        return self.ctx.device

    def encode(self, values) -> torch.Tensor:
        return torch.as_tensor(host.ints_to_limbs(list(values), self.L)
                               .astype("int64"), device=self.device)

    def from_limbs(self, x):
        return vpu.fit(x.to(torch.int64), self.L)

    def to_limbs_mod(self, x):
        return x

    def mont_mul(self, x, y):
        """x * y * R^-1 mod N (one limb Montgomery product)."""
        return mont.mont_mul(self.ctx, x, y)

    def mul(self, x, y):
        """x * y mod N (``montgomery.modmul``: two Montgomery products)."""
        return mont.modmul(self.ctx, x, y)

    def pow(self, x, digits, window: int = 4):
        """x^e by the fixed-window ladder (``montgomery.mont_pow_digits``);
        ``digits`` int [D] shared or [..., D] per element, MSB-first."""
        return mont.mont_pow_digits(
            self.ctx, x, torch.as_tensor(digits, device=x.device), window)

    def _exp_digits(self, e: int) -> torch.Tensor:
        nd = mont.n_digits_for_bits(e.bit_length(), LIMB_WINDOW)
        return torch.as_tensor(mont.exp_digits(e, LIMB_WINDOW, nd),
                               device=self.device)

    def pow_shared(self, x, e: int, fin=None):
        """x^e (times ``fin`` when given, one more product) for a host
        exponent: :meth:`pow` on e's base-2^LIMB_WINDOW digits, kept for
        the ``rns2.EXPONENT_CACHE`` exponents seen last."""
        if e == 0:
            out = self.one.expand(x.shape)
        else:
            out = self.pow(x, self._digits(e), LIMB_WINDOW)
        return out if fin is None else self.mul(fin, out)

    def one_plus_mul(self, x, c: int):
        """The integer 1 + x*c (< N) for limbs x and a host int c: one
        int8 constant product (:func:`limbmm.const_mul`, its plan made once
        per c and input width) and an add."""
        key = (c, x.shape[-1])
        plan = self._plans.get(key)
        if plan is None:
            plan = self._plans[key] = lm.ConstMulPlan.build(
                c, x.shape[-1], self.L, device=self.device)
        t = lm.const_mul(x, plan)
        return vpu.add(t, vpu.one_like(t))[0]

    def fixed_base(self, base_int: int, n_digits: int, window: int):
        """The base as limbs [L] (the ladder takes it as any base)."""
        return self.encode([base_int])[0]

    def pow_fixed_base(self, base, digits, window: int, fin=None):
        """base^e for per-element digits [..., D] (the base broadcast over
        the batch), times ``fin`` when given."""
        out = mont.mont_pow_fixed_base(self.ctx, base, digits, window)
        return out if fin is None else self.mul(fin, out)


def product_tree(mul, x: torch.Tensor, one: torch.Tensor) -> torch.Tensor:
    """The product over axis 0 of ``x`` by a log-depth tree of ``mul``,
    a level of odd length padded with ``one`` (a row, broadcast)."""
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = torch.cat([x, one.expand(x[:1].shape)], dim=0)
        x = mul(x[0::2], x[1::2])
    return x[0]


class CrtSplit:
    """A value mod (p q)^s as its halves mod p^s and mod q^s, each on an
    engine of its own (:func:`make_engine`), and Garner's step back.

    The operand is ``s * L`` limbs wide (L the limbs of p q).  Garner
    joins values mod p^j and q^j (j = ``join``, s by default) into
    m = m_p + p^j ((m_q - m_p) (p^j)^-1 mod q^j) at ``j * L`` limbs;
    m_p is reduced mod q^j by one conditional subtract where p^j < 2 q^j
    (at one width), else by a fold, chosen here from the moduli."""

    def __init__(self, p: int, q: int, s: int, L: int, *, device,
                 join: int | None = None):
        dev = dict(device=device)
        self.halves = []
        for f in (p, q):
            m = f ** s
            self.halves.append((lm.FoldPlan.build(m, s * L, **dev),
                                lm.BarrettPlan.build(m, **dev),
                                make_engine(m, host.limbs_for_bits(
                                    m.bit_length()), **dev)))
        self.eng_p, self.eng_q = (h[2] for h in self.halves)
        # group orders mod p^s / q^s: exponents of units reduce mod these
        self.orders = (p ** (s - 1) * (p - 1), q ** (s - 1) * (q - 1))
        a, b = p ** (join or s), q ** (join or s)
        la, lb = (host.limbs_for_bits(v.bit_length()) for v in (a, b))
        self.out = (join or s) * L
        self.b_limbs = torch.as_tensor(
            host.int_to_limbs(b, lb).astype("int64"), **dev)
        self.br_b = lm.BarrettPlan.build(b, **dev)
        self.fold_ab = (None if a < 2 * b and la == lb
                        else lm.FoldPlan.build(b, la, **dev))
        self.ainv = lm.ModMulConstPlan.build(pow(a, -1, b), b, lb, **dev)
        self.mul_a = lm.ConstMulPlan.build(a, lb, self.out, **dev)

    def map(self, x: torch.Tensor, fn) -> list:
        """[fn(i, engine, x mod the half's modulus in the engine's form)
        for the halves i = 0 (p) and 1 (q)]; x: limbs [..., s L]."""
        return [fn(i, eng, eng.from_limbs(lm.fold_mod(x, fold, br)))
                for i, (fold, br, eng) in enumerate(self.halves)]

    def pow(self, x: torch.Tensor, digits, window: int) -> torch.Tensor:
        """x^e mod (p q)^s for MSB-first base-2^window ``digits``: a
        fixed-window ladder a half.  Returns limbs [..., s L]."""
        return self.combine(*self.map(x, lambda i, eng, y: eng.to_limbs_mod(
            eng.pow(y, digits, window))))

    def pow_shared(self, x: torch.Tensor, e: int) -> torch.Tensor:
        """x^e mod (p q)^s for a unit x and a shared host exponent, reduced
        mod each half's group order: a shared-exponent ladder a half."""
        return self.combine(*self.map(x, lambda i, eng, y: eng.to_limbs_mod(
            eng.pow_shared(y, e % self.orders[i]))))

    def combine(self, mp: torch.Tensor, mq: torch.Tensor) -> torch.Tensor:
        """Garner: mp mod p^j, mq mod q^j -> limbs [..., j L]."""
        bl = self.b_limbs.expand(mq.shape)
        mp_b = (vpu.cond_sub(mp, bl) if self.fold_ab is None
                else lm.fold_mod(mp, self.fold_ab, self.br_b))
        diff, borrow = vpu.sub(mq, mp_b)
        fixed, _ = vpu.add(diff, bl)
        diff = torch.where((borrow != 0).unsqueeze(-1), fixed, diff)
        t = lm.modmul_const(diff, self.ainv, self.br_b)
        pt = lm.const_mul(t, self.mul_a)                      # t p^j, exact
        m, _ = vpu.add(pt, torch.nn.functional.pad(mp, (0, self.out -
                                                        mp.shape[-1])))
        return m
