"""RNS Montgomery engine v2 (Cox-Rower) on torch tensors.

Counterpart of ``paillier_tpu.bigint.rns2``; the arithmetic is the same,
line for line, so both packages give bit-identical residues.

* **Standard-form residues**: every per-channel constant multiply is
  folded into the base-extension matrices, so a Montgomery multiply
  needs one variable-by-variable integer multiply per channel; the rest
  is int8 matmuls plus float-reciprocal channel reductions.
* **Sigma-form B2 half**: B2 residues are stored pre-scaled by
  c_j = (M2/m'_j)^-1, i.e. the stored value IS the Kawamura digit of the
  true residue.  B1 stays in true form; decode/to_limbs read only B1.
* **int8 extension matrices**: 7-bit chunk pairs, ``i8 x i8 -> i32``
  products, every accumulation exact in int32.  Each base extension is
  ONE ``[.., 2k] x [2k, 2k]`` product (lo-chunk columns [0, k), hi-chunk
  columns [k, 2k)).  The JAX package pads the columns to a 128-lane
  boundary for the TPU; the padding columns are zero, so the unpadded
  layout gives identical results.
* **Cox floating alpha** for the second extension (Kawamura et al.,
  EUROCRYPT 2000): alpha2 = floor(sum(sigma_j / m'_j) + eps), exact
  because M2 >= 8*lambda*N keeps the true fraction below 1/8 while the
  f32 sum error stays < eps.

Value-range invariants (signed-lazy configuration): channel primes
< MCAP, k per base.  Ladder (lazy) residues are SIGNED near-canonical:
digit outputs (_red_fast) in (-(m + ~820), m + ~820), residue outputs
(_red_lazy) in (-m, 2m); the final lazy=False multiply returns canonical
[0, m).  Inputs/outputs of the Montgomery multiply stay below lambda*N
in magnitude with lambda = k*2^10; the spec enforces M >= lambda^2 * N
and M2 >= 8*lambda*N (see the JAX module for the full derivation).

The ladders are the hot paths, each a hand-written kernel on a CUDA
tensor and its plain version on a CPU tensor: :func:`rns2_pow_sliding`
(shared exponent, sliding window: ``sliding_kernel.rns2_pow_sliding_b1``
or :func:`rns2_pow_sliding_plain`), :func:`rns2_pow` (fixed window,
shared or per-element exponents: ``modexp_kernel.rns2_pow_b2`` or
:func:`rns2_pow_plain`) and :func:`rns2_pow_fixed_base` (comb over a
fixed-base table, per-element exponents:
``fixed_base_kernel.rns2_pow_fixed_base_b3`` or
:func:`rns2_pow_fixed_base_plain`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from . import host, vpu
from .limbmm import BarrettPlan, _dot_i8, barrett_small

CHUNK = 7                      # int8 chunk width (values < 2^7)
# Channel prime cap and _red_fast bias: digit outputs must still chunk
# into two 7-bit int8 digits (|digit| < 2^14); see the JAX module.
MCAP = 15200
RED_BIAS_INT = 420

# ic1 rows (base B1 constants, int32 [NI1, k])
I1_M = 0       # B1 moduli
I1_M2M = 1     # m_i - (M2 mod m_i): the cox correction is ADDED
I1_ENTRY = 2   # (M^2 mod N) mod m_i  (to-Montgomery factor)
I1_ONEM = 3    # (M mod N) mod m_i    (1 in Montgomery form)
I1_ONE = 4     # 1
NI1 = 5

# ic2 rows (base B2 constants, int32 [NI2, k]), sigma form
I2_M = 0       # B2 moduli
I2_U0S = 1     # (M^-1 * c_j^-1) mod m'_j  (sigma-form Montgomery factor)
I2_ENTRY = 2   # sigma-form (M^2 mod N) mod m'_j
I2_ONEM = 3    # sigma-form (M mod N) mod m'_j
I2_ONE = 4     # sigma-form 1
NI2 = 5

# Cox bias: must dominate max|t|*N/M2 (signed-digit drift) + the f32
# sum error; checked against each concrete spec in Rns2Spec.__init__.
COX_EPS = 0.05

# The widest modulus Rns2Spec takes: its channels are the sub-14-bit
# primes, and 2k = 1408 of them (k = 704, the kernels' K_MAX) cover at
# most an 8661-bit modulus under the M, M2 bounds below (checked by
# tests/test_torch_api.py).  Level 2 of a 4096-bit key (n^3, 12,288
# bits) is beyond it.
MAX_MODULUS_BITS = 8661

# Distinct exponents an engine keeps the ladder data of for
# ``pow_shared``, the least recently used dropped first.
EXPONENT_CACHE = 64


def _inverse_table(a: np.ndarray, m: np.ndarray) -> np.ndarray:
    """[i, j] = a_i^-1 mod m_j for primes m_j below 2^14 that divide no
    a_i (int64 [len(a), len(m)]), by Fermat: a_i^(m_j - 2) mod m_j."""
    mod = m[None, :]
    x = a[:, None] % mod
    e = np.broadcast_to(mod - 2, x.shape)
    out = np.ones_like(x)
    while e.any():
        out = np.where(e & 1, out * x % mod, out)
        x = x * x % mod
        e = e >> 1
    return out


def _primes_descending(count: int) -> list[int]:
    """``count`` largest primes below MCAP (descending)."""
    out = []
    n = MCAP - 1 if MCAP % 2 == 0 else MCAP
    while len(out) < count and n > (1 << 11):
        if host.is_probable_prime(n, 12):
            out.append(n)
        n -= 2
    if len(out) < count:
        raise ValueError(f"not enough sub-14-bit primes for {count} channels")
    return out


class Rns2Context(NamedTuple):
    """Per-modulus device constants (the system's "parameters")."""

    ic1: torch.Tensor     # int32 [NI1, k]
    ic2: torch.Tensor     # int32 [NI2, k]
    f1: torch.Tensor      # f32 [1, k]: 1/m_i
    f2: torch.Tensor      # f32 [1, k]: 1/m'_j
    e1g: torch.Tensor     # int8 [2k, 2k]: ext1 lo|hi columns (-> B2)
    e2g: torch.Tensor     # int8 [2k, 2k]: ext2 lo|hi columns (-> B1)

    @property
    def k(self) -> int:
        return self.ic1.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.ic1.device


def context_from_numpy(ic1, ic2, f1, f2, e1g, e2g, *, device) -> Rns2Context:
    """Port context from the JAX package's context arrays (as numpy).

    The JAX extension matrices are ``[2k, 2*pk]`` with the hi-chunk
    columns at the 128-aligned offset pk; the ``pk - k`` zero gap columns
    are stripped here, giving the port's unpadded ``[2k, 2k]`` layout.
    """
    ic1 = np.asarray(ic1)
    k = ic1.shape[-1]

    def unpad(G):
        G = np.asarray(G)
        pk = G.shape[-1] // 2
        if np.any(G[:, k:pk]) or np.any(G[:, pk + k:]):
            raise ValueError("extension matrix gap columns are not zero")
        return np.concatenate([G[:, :k], G[:, pk:pk + k]], axis=1)

    return Rns2Context(
        ic1=torch.as_tensor(ic1.astype(np.int32), device=device),
        ic2=torch.as_tensor(np.asarray(ic2).astype(np.int32), device=device),
        f1=torch.as_tensor(np.asarray(f1).astype(np.float32), device=device),
        f2=torch.as_tensor(np.asarray(f2).astype(np.float32), device=device),
        e1g=torch.as_tensor(unpad(e1g).astype(np.int8), device=device),
        e2g=torch.as_tensor(unpad(e2g).astype(np.int8), device=device))


class Rns2Spec:
    """Host-side spec: channel selection, CRT data, folded matrices."""

    def __init__(self, n_modulus: int):
        if n_modulus % 2 == 0:
            raise ValueError("modulus must be odd")
        self.N = n_modulus
        nbits = n_modulus.bit_length()
        # lambda = k * 2^10 covers the digit-inflation alpha1 bound; each
        # channel contributes >= 13 bits.  k rounded to a multiple of 64.
        k = -(-(nbits + 64) // 13)
        k = ((k + 63) // 64) * 64
        while True:
            primes = _primes_descending(2 * k)
            b1, b2 = primes[:k], primes[k:2 * k]
            M = 1
            for p in b1:
                M *= p
            M2 = 1
            for p in b2:
                M2 *= p
            lam = k << 10
            if M >= lam * lam * n_modulus and M2 >= 8 * lam * n_modulus:
                break
            k += 64
        # COX_EPS soundness under the signed-digit lazy mix: eps must
        # dominate the drift + f32 sum error while true_frac(1/8) +
        # drift + eps stays below 1.  Real exceptions, not asserts.
        drift = (k * 256 * n_modulus) / M2
        f32_err = 2e-3
        if COX_EPS <= drift + f32_err:
            raise ValueError(
                f"COX_EPS={COX_EPS} too small for k={k}: drift bound "
                f"{drift:.4f} + f32 error {f32_err}")
        if 0.125 + drift + COX_EPS >= 1.0:
            raise ValueError(
                f"cox fraction headroom violated for k={k}: "
                f"1/8 + {drift:.4f} + {COX_EPS} >= 1")
        self.k = k
        self.C = 2 * k
        self.b1, self.b2 = b1, b2
        self.M, self.M2 = M, M2
        self.lam = lam
        self.all_m = b1 + b2
        self.crt_w = [(M // p, pow(M // p, -1, p)) for p in b1]
        self.m2_mod_n = (M * M) % n_modulus
        self.onem_int = M % n_modulus
        # sigma-form scale factors c_j = (M2/m'_j)^-1 mod m'_j
        self.sigma_c = [pow(M2 // p, -1, p) for p in b2]

    # -- host <-> residues (full-width [B, C], B2 half in sigma form) ------
    def encode(self, values: Sequence[int]) -> np.ndarray:
        k = self.k
        out = np.zeros((len(values), self.C), dtype=np.int32)
        for b, v in enumerate(values):
            for i, m in enumerate(self.b1):
                out[b, i] = v % m
            for j, m in enumerate(self.b2):
                out[b, k + j] = (v % m) * self.sigma_c[j] % m
        return out

    def decode(self, residues: np.ndarray) -> list[int]:
        res = np.asarray(residues, dtype=np.int64)
        out = []
        for b in range(res.shape[0]):
            x = 0
            for i, m in enumerate(self.b1):
                Mi, wi = self.crt_w[i]
                x += ((int(res[b, i]) * wi) % m) * Mi
            out.append((x % self.M) % self.N)
        return out

    # -- device context ------------------------------------------------------
    def context_arrays(self) -> dict:
        """The context as host numpy arrays (unpadded extension matrices).

        Same values as the JAX package's ``Rns2Spec.build_context``; the
        loop-invariant modular inverses are hoisted out of the channel
        double loops, which changes no entry."""
        N, k = self.N, self.k
        b1, b2, M, M2 = self.b1, self.b2, self.M, self.M2

        m1 = np.asarray(b1, dtype=np.int64)
        m2 = np.asarray(b2, dtype=np.int64)
        ic1 = np.zeros((NI1, k), dtype=np.int64)
        ic2 = np.zeros((NI2, k), dtype=np.int64)
        ic1[I1_M] = m1
        ic2[I2_M] = m2
        cs = self.sigma_c
        minv2 = [pow(M, -1, mj) for mj in b2]
        for j, mj in enumerate(b2):
            # stored products carry c_j^2; one c_j^-1 = (M2/m'_j) here
            ic2[I2_U0S, j] = minv2[j] * ((M2 // mj) % mj) % mj
        for i, mi in enumerate(b1):
            ic1[I1_M2M, i] = mi - (M2 % mi)     # == -M2 (mod m_i), in (0, m_i)
            ic1[I1_ENTRY, i] = self.m2_mod_n % mi
            ic1[I1_ONEM, i] = self.onem_int % mi
            ic1[I1_ONE, i] = 1
        for j, mj in enumerate(b2):
            ic2[I2_ENTRY, j] = (self.m2_mod_n % mj) * cs[j] % mj
            ic2[I2_ONEM, j] = (self.onem_int % mj) * cs[j] % mj
            ic2[I2_ONE, j] = cs[j]

        def merged(T: np.ndarray) -> np.ndarray:
            return np.concatenate([T & ((1 << CHUNK) - 1), T >> CHUNK],
                                  axis=1).astype(np.int8)

        # ext1 rows (c, i in B1) -> cols j in B2:
        #   A[(c,i), j] = (w_ci * (M/m_i) * N * M^-1 * c_j) mod m'_j,
        #   w_ci = (2^(7c) * k1_i) mod m_i, k1_i = (-N^-1 (M/m_i)^-1) mod m_i
        # (the extra c_j factor lands the dot result in sigma form).
        # (M/m_i) mod m'_j = (M mod m'_j) m_i^-1 mod m'_j (the primes are
        # distinct), so the k x k entries are small-integer arithmetic
        ncj = np.asarray([(N % mj) * minv2[j] % mj * cs[j] % mj
                          for j, mj in enumerate(b2)], dtype=np.int64)
        k1 = np.asarray([pow(-N, -1, mi) * pow(M // mi, -1, mi) % mi
                         for mi in b1], dtype=np.int64)[:, None]
        mdi = np.asarray([M % mj for mj in b2], dtype=np.int64) \
            * _inverse_table(m1, m2) % m2                   # [i, j]
        base = mdi * ncj % m2
        T1 = np.concatenate([k1 * base % m2,
                             ((1 << CHUNK) * k1 % m1[:, None]) * base % m2])

        # ext2 rows (c, j in B2) -> cols i in B1: (2^(7c) * (M2/m'_j)) mod m_i
        m2dj = np.asarray([M2 % mi for mi in b1], dtype=np.int64) \
            * _inverse_table(m2, m1) % m1                   # [j, i]
        T2 = np.concatenate([m2dj, (1 << CHUNK) * m2dj % m1])

        return dict(
            ic1=ic1.astype(np.int32), ic2=ic2.astype(np.int32),
            f1=(1.0 / m1.astype(np.float64)).astype(np.float32)[None],
            f2=(1.0 / m2.astype(np.float64)).astype(np.float32)[None],
            e1g=merged(T1), e2g=merged(T2))

    def build_context(self, *, device) -> Rns2Context:
        return context_from_numpy(**self.context_arrays(), device=device)


# ---------------------------------------------------------------------------
# Math core (the CUDA kernels compute exactly this; see csrc/rns2_mont.cuh)
# ---------------------------------------------------------------------------

def _red(v, m, inv_m):
    """v mod m for int32 |v| < 2^31 (single float-reciprocal pass):
    q = floor(f32(v) * inv_m), then two conditional fixes."""
    q = torch.floor(v.to(torch.float32) * inv_m).to(torch.int32)
    r = v - q * m
    r = torch.where(r < 0, r + m, r)
    return torch.where(r >= m, r - m, r)


def _red_lazy(v, m, inv_m):
    """Congruence-preserving reduction into (-m, 2m): the quotient of
    :func:`_red` without the conditional fixes."""
    q = torch.floor(v.to(torch.float32) * inv_m).to(torch.int32)
    return v - q * m


def _red_fast(v, m, inv_m):
    """Biased truncating reduction (the ladder's digit path):
    q = trunc(f32(v - RED_BIAS_INT) * inv_m).  float->int32 conversion
    in torch truncates toward zero, as in JAX."""
    q = ((v - RED_BIAS_INT).to(torch.float32) * inv_m).to(torch.int32)
    return v - q * m


_red_digit_lazy = _red_fast      # s1 / sg (chunked into int8 digits)
_red_out_lazy = _red_lazy        # s2 / w1 (residue outputs)


def _chunks(v):
    """int32 in (-2^14, 2^14) -> (lo7, hi7) int32 chunks; ``>>`` on int32
    is arithmetic, so v == lo + 128*hi in two's complement."""
    return v & ((1 << CHUNK) - 1), v >> CHUNK


def _pack_digits(v):
    """int32 digits in (-2^14, 2^14) -> int8 lhs [.., 2k] (lo | hi)."""
    a0, a1 = _chunks(v)
    return torch.cat([a0, a1], dim=-1).to(torch.int8)


def _ext_split(P, k: int):
    """Split an extension product into its (lo, hi) channel halves."""
    return P[..., :k], P[..., k:]


def _mm_lhs1(ctx: Rns2Context, x, y, lazy: bool):
    """Stage 1: channel products, digit/lazy reds, ext1 lhs pack."""
    x1, x2 = x
    y1, y2 = y
    digit_red = _red_digit_lazy if lazy else _red
    s1 = digit_red(x1 * y1, ctx.ic1[I1_M], ctx.f1[0])
    s2 = _red_out_lazy(x2 * y2, ctx.ic2[I2_M], ctx.f2[0]) if lazy \
        else _red_lazy(x2 * y2, ctx.ic2[I2_M], ctx.f2[0])
    return _pack_digits(s1), s2


def _mm_ext1(ctx: Rns2Context, lhs1):
    """First base extension (B1 -> B2) as ONE int8 product."""
    return _ext_split(_dot_i8(lhs1, ctx.e1g), ctx.k)


def _mm_lhs2(ctx: Rns2Context, P, s2, lazy: bool):
    """Stage 2: combine ext1 into the sigma-form B2 result, pack the ext2
    lhs.  Returns (lhs2, sg); sg IS the B2 output (sigma form)."""
    Plo, Phi = P
    m2 = ctx.ic2[I2_M]
    inv2 = ctx.f2[0]
    digit_red = _red_digit_lazy if lazy else _red
    # Plo + (Phi << 7) overflows int32 for k >= 512: reduce the hi
    # product first on wide specs (4096-bit keys / level 2).
    if Plo.shape[-1] >= 512:
        Phi = digit_red(Phi, m2, inv2)
    v = Plo + (Phi << CHUNK)                # == Q*N*M^-1*c mod m', < 1.4e9
    sg = digit_red(v + s2 * ctx.ic2[I2_U0S], m2, inv2)
    return _pack_digits(sg), sg


def _mm_ext2(ctx: Rns2Context, lhs2):
    """Second base extension (B2 -> B1), one int8 product."""
    return _ext_split(_dot_i8(lhs2, ctx.e2g), ctx.k)


def _mm_finish(ctx: Rns2Context, V, sg, lazy: bool):
    """Stage 3: combine ext2 + cox floating alpha -> B1 result."""
    Vlo, Vhi = V
    m1 = ctx.ic1[I1_M]
    inv1 = ctx.f1[0]
    digit_red = _red_digit_lazy if lazy else _red
    out_red = _red_out_lazy if lazy else _red
    if Vlo.shape[-1] >= 512:
        Vhi = digit_red(Vhi, m1, inv1)
    v1 = Vlo + (Vhi << CHUNK)                    # == sum sg*(M2/m') mod m_i
    # alpha counts whole multiples of M2 in sum(sg * M2/m'_j); the
    # correction is ADDED (I1_M2M = -M2 mod m_i > 0).
    alpha = torch.floor(
        (sg.to(torch.float32) * ctx.f2[0]).sum(dim=-1, keepdim=True)
        + COX_EPS).to(torch.int32)
    return out_red(v1 + alpha * ctx.ic1[I1_M2M], m1, inv1)


def rns2_mont_mul_pair(ctx: Rns2Context, x, y, lazy: bool = False):
    """w = x*y*M^-1 mod N on residue pairs ((x1, x2), (y1, y2)).

    Halves are int32 [..., k] residues of values < lambda*N in
    magnitude, canonical or (with ``lazy``) signed near-canonical; with
    ``lazy=True`` the outputs are lazy too (finish a ladder with one
    lazy=False multiply so the final residues are canonical).
    """
    lhs1, s2 = _mm_lhs1(ctx, x, y, lazy)
    P = _mm_ext1(ctx, lhs1)
    lhs2, sg = _mm_lhs2(ctx, P, s2, lazy)
    V = _mm_ext2(ctx, lhs2)
    w1 = _mm_finish(ctx, V, sg, lazy)
    return w1, sg


def _split(ctx: Rns2Context, x):
    k = ctx.k
    return x[..., :k], x[..., k:]


def _const_row(ctx: Rns2Context, r1: int, r2: int) -> torch.Tensor:
    return torch.cat([ctx.ic1[r1], ctx.ic2[r2]])


def rns2_one_plus_mul(ctx: Rns2Context, x, crow):
    """(1 + x*c) mod N as canonical residues, per channel.

    ``x``: canonical [..., C] residues (B2 half sigma-form, as stored);
    ``crow``: int32 [C] TRUE-form residues of a host constant c.  This
    is encryption's G^m = 1 + m*n in residue space."""
    k = ctx.k
    x1, x2 = x[..., :k], x[..., k:]
    c1, c2 = crow[..., :k], crow[..., k:]
    g1 = _red(x1 * c1 + 1, ctx.ic1[I1_M], ctx.f1[0])
    g2 = _red(x2 * c2 + ctx.ic2[I2_ONE], ctx.ic2[I2_M], ctx.f2[0])
    return torch.cat([g1, g2], dim=-1)


def rns2_mont_mul_values(ctx: Rns2Context, x, y, lazy: bool = False):
    """Full-width [..., C] wrapper around the pair core."""
    w1, w2 = rns2_mont_mul_pair(ctx, _split(ctx, x), _split(ctx, y), lazy)
    return torch.cat([w1, w2], dim=-1)


# ---------------------------------------------------------------------------
# Fixed-window exponentiation (shared or per-element exponents)
# ---------------------------------------------------------------------------

def rns2_pow_plain(ctx: Rns2Context, x, digits, window: int = 4):
    """x^e mod N by the fixed 2^window-ary ladder, in plain torch.

    Mirrors ``paillier_tpu.bigint.rns2.rns2_pow_jnp`` multiply for
    multiply: the table [1_M, xm, xm^2, ..., xm^(2^w - 1)] (each entry
    the previous one times xm), acc = 1_M, then per digit ``window``
    squarings and one multiply by table[d] (d = 0 included), and an exit
    multiply by 1 with exact reductions.  x: [..., C] standard-form
    residues; digits: int [D] shared or [..., D] per element, MSB-first
    base-2^window.  Output: canonical residues of a value < lambda*N.
    """
    digits = torch.as_tensor(digits)
    per_element = digits.dim() > 1
    entry = _const_row(ctx, I1_ENTRY, I2_ENTRY)
    onem = _const_row(ctx, I1_ONEM, I2_ONEM)
    one = _const_row(ctx, I1_ONE, I2_ONE)

    xm = rns2_mont_mul_values(ctx, x, entry.expand(x.shape), lazy=True)
    one_m = onem.expand(x.shape)
    tbl = [one_m, xm]
    for _ in range(2, 1 << window):
        tbl.append(rns2_mont_mul_values(ctx, tbl[-1], xm, lazy=True))

    acc = one_m
    if per_element:
        lead = torch.broadcast_shapes(x.shape[:-1], digits.shape[:-1])
        C = x.shape[-1]
        stack = torch.stack([t.expand(lead + (C,)).reshape(-1, C)
                             for t in tbl])                  # [2^w, R, C]
        dig = digits.to(x.device).expand(lead + digits.shape[-1:]
                                         ).reshape(-1, digits.shape[-1])
        rows = torch.arange(dig.shape[0], device=x.device)
        acc = one_m.expand(lead + (C,))
        for i in range(dig.shape[-1]):
            for _ in range(window):
                acc = rns2_mont_mul_values(ctx, acc, acc, lazy=True)
            t = stack[dig[:, i].long(), rows].reshape(lead + (C,))
            acc = rns2_mont_mul_values(ctx, acc, t, lazy=True)
    else:
        for d in digits.cpu().tolist():
            for _ in range(window):
                acc = rns2_mont_mul_values(ctx, acc, acc, lazy=True)
            acc = rns2_mont_mul_values(ctx, acc, tbl[d], lazy=True)
    return rns2_mont_mul_values(ctx, acc, one.expand(acc.shape))


def rns2_pow(ctx: Rns2Context, x, digits, window: int = 4):
    """Dispatcher: kernel B2 for a CUDA tensor, the plain ladder for a CPU
    tensor (the wrapper decides by the tensor's device)."""
    from .modexp_kernel import rns2_pow_b2
    return rns2_pow_b2(ctx, x, digits, window)


# ---------------------------------------------------------------------------
# Shared-exponent sliding-window exponentiation (odd-power table)
# ---------------------------------------------------------------------------

def sliding_window_schedule(e: int, window: int) -> np.ndarray:
    """Recode e >= 1 for a left-to-right sliding-window ladder over the
    odd-power table [x, x^3, x^5, ..., x^(2^window - 1)].

    Returns int32 [1 + S]: out[0] is the odd-table index of the leading
    window; each following entry encodes one ladder step "square, then
    (entry >= 0 ? multiply by table[entry] : nothing)".
    """
    if e < 1:
        raise ValueError("sliding-window exponent must be >= 1")
    bits = bin(e)[2:]
    nb = len(bits)
    lead = min(window, nb)
    while bits[lead - 1] != "1":        # window must end in a set bit
        lead -= 1
    out = [int(bits[:lead], 2) >> 1]    # odd-table index of leading window
    i = lead
    while i < nb:
        if bits[i] == "0":
            out.append(-1)
            i += 1
            continue
        l = min(window, nb - i)
        while bits[i + l - 1] != "1":
            l -= 1
        out.extend([-1] * (l - 1))
        out.append(int(bits[i:i + l], 2) >> 1)
        i += l
    return np.asarray(out, dtype=np.int32)


def rns2_pow_sliding_plain(ctx: Rns2Context, x, sched, window: int = 6,
                           fin=None):
    """x^e * fin mod N by the sliding-window schedule, in plain torch.

    Mirrors ``paillier_tpu.bigint.rns2.rns2_pow_sliding_jnp``: x is
    [..., C] standard-form residues; sched int32 [1+S] from
    :func:`sliding_window_schedule` (sentinels: -2 skip, -1 square only,
    d >= 0 square then multiply by table[d]); ``fin`` (canonical
    [..., C] residues, or None for 1) rides the exit multiply.  Output:
    canonical residues of a value < lambda*N.
    """
    sched = np.asarray(torch.as_tensor(sched).cpu(), dtype=np.int64)
    entry = _const_row(ctx, I1_ENTRY, I2_ENTRY)
    one = _const_row(ctx, I1_ONE, I2_ONE)

    xm = rns2_mont_mul_values(ctx, x, entry.expand(x.shape), lazy=True)
    x2 = rns2_mont_mul_values(ctx, xm, xm, lazy=True)
    tbl = [xm]
    for _ in range(1, 1 << (window - 1)):
        tbl.append(rns2_mont_mul_values(ctx, tbl[-1], x2, lazy=True))

    acc = tbl[int(sched[0])]
    for d in sched[1:].tolist():
        if d >= -1:
            acc = rns2_mont_mul_values(ctx, acc, acc, lazy=True)
        if d >= 0:
            acc = rns2_mont_mul_values(ctx, acc, tbl[d], lazy=True)
    last = one.expand(acc.shape) if fin is None else fin
    return rns2_mont_mul_values(ctx, acc, last)


def rns2_pow_sliding(ctx: Rns2Context, x, sched, window: int = 6,
                     fin=None):
    """Dispatcher: kernel B1 for a CUDA tensor, the plain ladder for a
    CPU tensor (the wrapper decides by the tensor's device)."""
    from .sliding_kernel import rns2_pow_sliding_b1
    return rns2_pow_sliding_b1(ctx, x, sched, window, fin=fin)


# ---------------------------------------------------------------------------
# Fixed-base exponentiation (comb method: zero squarings)
# ---------------------------------------------------------------------------

def build_fixed_base_table(eng: "Rns2Engine", base_int: int, n_digits: int,
                           window: int = 4) -> torch.Tensor:
    """Residue table T[step*2^w + d] = (base^(d * 2^(w*(D-1-step))) * M)
    mod N in Montgomery form, step 0 = most-significant digit; int32
    [D*2^w, C] canonical residues on the engine's device.

    With this table a fixed-base power is D-1 Montgomery multiplies and
    zero squarings: the comb method for Damgard-Jurik "alternative"
    encryption h_s^r (reference: paillier.go:221-238), where the base is
    the public h_s and only the short exponent r varies per element.
    The same host integers as ``paillier_tpu.bigint.rns2``'s table.
    """
    spec = eng.spec
    N, M = spec.N, spec.M
    g = [base_int % N]
    for _ in range(1, n_digits):
        x = g[-1]
        for _ in range(window):
            x = (x * x) % N
        g.append(x)
    vals = []
    for step in range(n_digits):
        gi = g[n_digits - 1 - step]
        cur = M % N                      # d=0 -> 1 in Montgomery form
        for _ in range(1 << window):
            vals.append(cur)
            cur = (cur * gi) % N
    limbs = host.ints_to_limbs(vals, eng.converter.L).astype(np.int64)
    return eng.from_limbs(torch.as_tensor(limbs, device=eng.device))


def rns2_pow_fixed_base_plain(ctx: Rns2Context, table, digits,
                              window: int = 4, fin=None):
    """base^e_b (times ``fin`` when given) by the comb table, in plain
    torch.

    Mirrors ``paillier_tpu.bigint.rns2.rns2_pow_fixed_base_jnp``: acc =
    table[0][d_0], then one lazy Montgomery multiply by table[j][d_j] per
    later digit, and the exact exit multiply by 1, or by ``fin``
    (canonical [..., C] residues: encryption's G^m, fused as in the
    sliding ladder).  table: int [D*2^w, C] from
    :func:`build_fixed_base_table`; digits: int [..., D] per element,
    MSB-first.  Output: canonical residues of a value < lambda*N.
    """
    digits = torch.as_tensor(digits).to(table.device).long()
    D = digits.shape[-1]
    C = table.shape[-1]
    tbl = table.to(torch.int32).reshape(D, 1 << window, C)
    acc = tbl[0][digits[..., 0]]
    for j in range(1, D):
        acc = rns2_mont_mul_values(ctx, acc, tbl[j][digits[..., j]],
                                   lazy=True)
    last = _const_row(ctx, I1_ONE, I2_ONE).expand(acc.shape) if fin is None \
        else fin
    return rns2_mont_mul_values(ctx, acc, last)


def rns2_pow_fixed_base(ctx: Rns2Context, table, digits, window: int = 4,
                        fin=None):
    """Dispatcher: kernel B3 for a CUDA table, the plain comb for a CPU
    table (the wrapper decides by the table's device)."""
    from .fixed_base_kernel import rns2_pow_fixed_base_b3
    return rns2_pow_fixed_base_b3(ctx, table, digits, window, fin=fin)


# ---------------------------------------------------------------------------
# Limb <-> residue conversion (int8 matmuls, exact int32 accum)
# ---------------------------------------------------------------------------

def converter_arrays(spec: Rns2Spec, n_limbs: int) -> dict:
    """Host numpy constants of :class:`Rns2Converter` (same values as the
    JAX package's ``Rns2Converter``)."""
    k, C = spec.k, spec.C
    mask = (1 << CHUNK) - 1

    # forward matrix: rows = 3 chunk blocks x L limbs, cols = (lo|hi) x C;
    # B2 columns carry the sigma-form scale c_j
    P = np.zeros((n_limbs, C), dtype=np.int64)
    for i, mi in enumerate(spec.all_m):
        scale = spec.sigma_c[i - k] if i >= k else 1
        val, step = scale % mi, pow(2, 16, mi)
        for l in range(n_limbs):
            P[l, i] = val
            val = (val * step) % mi
    rows = []
    for shift in (0, CHUNK, 2 * CHUNK):
        A = (P << shift) % np.asarray(spec.all_m)[None, :]
        rows.append(np.concatenate([A & mask, A >> CHUNK], axis=1))
    fwd = np.concatenate(rows, axis=0).astype(np.int8)
    all_m = np.asarray(spec.all_m, dtype=np.int32)
    all_inv = (1.0 / np.asarray(spec.all_m, dtype=np.float64)
               ).astype(np.float32)

    # reverse: eta weights and (M/m_i) limb chunk matrix over B1
    ML = max(n_limbs, (spec.M.bit_length() + 15) // 16)
    w = np.zeros(k, np.int64)
    for i, mi in enumerate(spec.b1):
        w[i] = pow(spec.M // mi, -1, mi)
    rows = []
    for shift in (0, CHUNK):
        W = np.zeros((k, ML), dtype=np.int64)
        for i, mi in enumerate(spec.b1):
            W[i] = host.int_to_limbs((spec.M // mi) << shift, ML
                                     ).astype(np.int64)
        rows.append(np.concatenate(
            [W & mask, (W >> CHUNK) & mask, W >> (2 * CHUNK)], axis=1))
    return dict(
        fwd=fwd, all_m=all_m, all_inv=all_inv,
        w0=w.astype(np.int32),
        w1=(((1 << CHUNK) * w) % np.asarray(spec.b1)).astype(np.int32),
        rev=np.concatenate(rows, axis=0).astype(np.int8),
        inv_b1=(1.0 / np.asarray(spec.b1, dtype=np.float64)
                ).astype(np.float32),
        M_limbs=host.int_to_limbs(spec.M, ML))


class Rns2Converter:
    """Bidirectional limb-vector <-> RNS-residue conversion on a device.

    forward: 7-bit chunks of the 16-bit limbs against the power matrix
    chunk((2^(7c+16l)) mod m_i); int8 product, one channel reduction.

    reverse: exact B1 digits eta_i, then an int8 product against the
    7-bit column chunks of the limb decompositions of (M/m_i); the
    alpha*M overshoot is fixed with a cox float estimate plus +-M
    corrections (exact for any f32 summation order: an alpha off by
    one is repaired by the borrow fix-up or the final cond_sub).
    """

    def __init__(self, spec: Rns2Spec, ctx: Rns2Context, n_limbs: int):
        self._init(spec, ctx, n_limbs, converter_arrays(spec, n_limbs))

    def _init(self, spec, ctx, n_limbs, arrays: dict):
        self.spec = spec
        self.ctx = ctx
        self.L = n_limbs
        dev = ctx.device
        t = {name: torch.as_tensor(np.array(a), device=dev)
             for name, a in arrays.items()}
        self.fwd = t["fwd"].to(torch.int8)
        self.all_m_dev = t["all_m"].to(torch.int32)
        self.all_inv_dev = t["all_inv"].to(torch.float32)
        self.w0 = t["w0"].to(torch.int32)
        self.w1 = t["w1"].to(torch.int32)
        self.rev = t["rev"].to(torch.int8)
        self.inv_b1 = t["inv_b1"].to(torch.float32)
        self.M_limbs = t["M_limbs"].to(torch.int64)
        self.ML = self.M_limbs.shape[-1]

    def from_limbs(self, x: torch.Tensor) -> torch.Tensor:
        """limbs [..., L] -> standard residues int32 [..., C]."""
        mask = (1 << CHUNK) - 1
        xi = x.to(torch.int32)
        lhs = torch.cat([xi & mask, (xi >> CHUNK) & mask,
                         xi >> (2 * CHUNK)], dim=-1).to(torch.int8)
        P = _dot_i8(lhs, self.fwd)
        C = P.shape[-1] // 2
        vhi = _red(P[..., C:], self.all_m_dev, self.all_inv_dev)
        return _red(P[..., :C] + (vhi << CHUNK), self.all_m_dev,
                    self.all_inv_dev)

    def to_limbs(self, x: torch.Tensor) -> torch.Tensor:
        """residues [..., C] -> int64 limbs [..., ML] of the exact value
        (< M)."""
        ctx = self.ctx
        k = ctx.k
        m1 = ctx.ic1[I1_M]
        inv1 = ctx.f1[0]
        c0, c1 = _chunks(x[..., :k])
        eta = _red(c0 * self.w0 + c1 * self.w1, m1, inv1)
        P = _dot_i8(_pack_digits(eta), self.rev).to(torch.int64)
        ML = P.shape[-1] // 3
        # combine the three chunk column blocks under vpu.normalize's
        # < 2^31 bound: route the high bits of the shifted blocks into
        # the next limb (weight 2^16) instead of shifting in place.
        P0, P1, P2 = P[..., :ML], P[..., ML:2 * ML], P[..., 2 * ML:]
        lo = P0 + ((P1 & 0x1FF) << CHUNK) + ((P2 & 0x3) << (2 * CHUNK))
        hi = (P1 >> 9) + (P2 >> 2)            # units of 2^16: next limb up
        total = vpu.normalize(lo + vpu._shift_up(hi, 1))
        frac = (eta.to(torch.float32) * self.inv_b1).sum(dim=-1)
        alpha = torch.floor(frac + 0.5 ** 12).to(torch.int64)
        aM = vpu.mul(alpha.unsqueeze(-1), self.M_limbs, ML)
        cand, borrow = vpu.sub(total, aM)
        fixed_up, _ = vpu.add(cand, self.M_limbs.expand(cand.shape))
        cand = torch.where((borrow != 0).unsqueeze(-1), fixed_up, cand)
        return vpu.cond_sub(cand, self.M_limbs.expand(cand.shape))


def converter_from_numpy(spec: Rns2Spec, ctx: Rns2Context, n_limbs: int,
                         arrays: dict) -> Rns2Converter:
    """Port converter from the JAX converter's arrays (as numpy): keys
    fwd, all_m, all_inv, w0, w1, rev, inv_b1, M_limbs; tensors land on
    ``ctx``'s device."""
    conv = Rns2Converter.__new__(Rns2Converter)
    conv._init(spec, ctx, n_limbs, arrays)
    return conv


# ---------------------------------------------------------------------------
# Engine facade
# ---------------------------------------------------------------------------

class Rns2Engine:
    """User-facing v2 engine for one modulus N on one device: the
    interface of ``bigint.engine`` (which builds it up to
    MAX_MODULUS_BITS) on residues [..., C]."""

    def __init__(self, n_modulus: int, n_limbs: int | None = None, *,
                 device):
        self.spec = Rns2Spec(n_modulus)
        self.ctx = self.spec.build_context(device=device)
        L = n_limbs or host.limbs_for_bits(n_modulus.bit_length())
        self.converter = Rns2Converter(self.spec, self.ctx, L)
        self.m2_rns = _const_row(self.ctx, I1_ENTRY, I2_ENTRY)
        self.one = _const_row(self.ctx, I1_ONE, I2_ONE)
        self.radix = self.spec.M
        # ladder schedules of the exponents seen last (a key's own are a
        # handful; a caller's scalars are not bounded)
        self._schedule = functools.lru_cache(EXPONENT_CACHE)(
            sliding_window_schedule)
        self._rows: dict = {}
        self.barrett = BarrettPlan.build(n_modulus, device=device)

    @property
    def device(self) -> torch.device:
        return self.ctx.device

    def encode(self, values) -> torch.Tensor:
        return torch.as_tensor(self.spec.encode(list(values)),
                               device=self.device)

    def decode(self, residues) -> list:
        return self.spec.decode(residues.cpu().numpy())

    def from_limbs(self, x):
        """limbs [..., <= L] -> residues [..., C]."""
        return self.converter.from_limbs(vpu.fit(x, self.converter.L))

    def to_limbs(self, x):
        return self.converter.to_limbs(x)

    def to_limbs_mod(self, x):
        """Residues of a value < 2^28 * N -> exact limbs [..., L] of
        (value mod N): one int8 product (to_limbs) plus an O(L)
        small-quotient Barrett."""
        return vpu.fit(barrett_small(self.to_limbs(x), self.barrett),
                       self.converter.L)

    def mont_mul(self, x, y):
        """x * y * M^-1 mod N (one exact Montgomery multiply)."""
        return rns2_mont_mul_values(self.ctx, x, y)

    def mul(self, x, y):
        """Plain modular product (fix the M^-1 with the entry factor)."""
        t = rns2_mont_mul_values(self.ctx, x, y)
        return rns2_mont_mul_values(self.ctx, t, self.m2_rns.expand(t.shape))

    def pow(self, x, digits, window: int = 4):
        """x^e by the fixed-window ladder; ``digits`` int [D] shared or
        [B, D] per element, MSB-first base-2^window."""
        return rns2_pow(self.ctx, x, digits, window)

    def pow_shared(self, x, e: int, window: int | None = None, fin=None):
        """x^e (times ``fin`` when given, at no extra multiply) for a
        host-known shared exponent via the sliding-window odd-power
        ladder.  Window defaults to Config.sliding_window."""
        from ..config import get_config
        if window is None:
            window = get_config().sliding_window
        if e == 0:
            out = self.one.expand(x.shape)
            return out if fin is None else self.mul(out, fin)
        return rns2_pow_sliding(self.ctx, x, self._schedule(e, window),
                                window, fin=fin)

    def one_plus_mul(self, x, c: int):
        """The integer 1 + x*c (< N) for limbs x and a host int c, made in
        residue space (:func:`rns2_one_plus_mul`: encryption's level-1
        G^m = 1 + m n)."""
        row = self._rows.get(c)
        if row is None:
            row = self._rows[c] = torch.tensor(
                [c % mi for mi in self.spec.b1 + self.spec.b2],
                dtype=torch.int32, device=self.device)
        return rns2_one_plus_mul(self.ctx, self.from_limbs(x), row)

    def fixed_base(self, base_int: int, n_digits: int, window: int):
        """The comb table of a fixed base (:func:`build_fixed_base_table`)
        for exponents of ``n_digits`` base-2^window digits."""
        return build_fixed_base_table(self, base_int, n_digits, window)

    def pow_fixed_base(self, table, digits, window: int, fin=None):
        """base^e for per-element digits [..., D] by the comb over
        ``table`` (kernel B3 on a CUDA tensor), times ``fin`` when given
        at no extra multiply."""
        lead, C = digits.shape[:-1], table.shape[-1]
        out = rns2_pow_fixed_base(
            self.ctx, table, digits.reshape(-1, digits.shape[-1]), window,
            fin=None if fin is None else fin.reshape(-1, C))
        return out.reshape(lead + (C,))
