"""Limb-domain big-int ops as int8 matmuls (the Toeplitz toolkit).

Counterpart of ``paillier_tpu.bigint.limbmm``.  Every limb-domain
multiplication on the encryption and CRT-decryption paths has a
*constant* operand (the modulus, a Hensel inverse, CRT constants), so
each one is a linear map of the input's limbs: ONE ``i8 x i8 -> i32``
matmul against a host-precomputed Toeplitz-chunk matrix.

  x * d             -> ConstMulPlan   (optionally truncated: x*d mod 2^16L)
  (x * d) mod N     -> ModMulConstPlan (mod folded into the matrix entries;
                       output is a bounded representative, < 2^26 * N)
  x mod N (wide x)  -> FoldPlan       (entries (2^(16a+7c)) mod N)

plus :func:`barrett_small`, the exact O(L) reduction for values
< 2^28 * N.  The plans are host numpy, built exactly as the JAX package
builds them; each holds its matrix as an int8 tensor on one device.

Matrix layout (same convention as rns2.Rns2Converter): lhs rows are the
three 7/7/2-bit chunks of each input limb; matrix columns are the three
7/7/2-bit chunks of each output limb; the int32 column sums are
recombined with carry routing into the next limb and normalized once.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import host, vpu

CHUNK = 7
_MASK7 = (1 << CHUNK) - 1


def _dot_i8(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """int8 [..., K] x int8 [K, N] -> exact int32 [..., N].

    ``torch._int_mm`` accumulates in int32, so the result is exact while
    every column sum stays below 2^31 in magnitude: K * 128 * 127 < 2^31
    holds for K < 132,000, far beyond every caller (the widest is the
    3L = 768-row limb fold at 2048-bit keys, |sum| < 12.4M).  On a CUDA
    tensor ``_int_mm`` wants more than 16 rows and K, N multiples of 8,
    and on an H100 (torch 2.11, CUDA 12.8) cuBLASLt refused every
    K < 128 unless the row count was a multiple of 32 (swept over rows
    17..4096, K 8..768, N 8..640); so rows are padded to a multiple of
    32.  The zero rows and columns padded in leave every sum unchanged
    and are sliced off.
    """
    K, N = rhs.shape
    lead = lhs.shape[:-1]
    a = lhs.reshape(-1, K)
    b = rhs
    if a.is_cuda:
        M = a.shape[0]
        pm, pk, pn = -M % 32 if M else 32, -K % 8, -N % 8
        if pm or pk:
            a = torch.nn.functional.pad(a, (0, pk, 0, pm))
        if pk or pn:
            b = torch.nn.functional.pad(b, (0, pn, 0, pk))
        out = torch._int_mm(a.contiguous(), b.contiguous())[:M, :N]
    else:
        out = torch._int_mm(a.contiguous(), b.contiguous())
    return out.reshape(lead + (N,))


def _chunk_rows(x: torch.Tensor) -> torch.Tensor:
    """limbs [..., L] -> int8 [..., 3L] (7,7,2-bit chunk blocks)."""
    xi = x.to(torch.int32)
    return torch.cat([xi & _MASK7, (xi >> CHUNK) & _MASK7,
                      xi >> (2 * CHUNK)], dim=-1).to(torch.int8)


def _chunk_cols(W: np.ndarray) -> np.ndarray:
    """int64 limb matrix [R, L] -> int8 [R, 3L] column chunk blocks."""
    return np.concatenate([W & _MASK7, (W >> CHUNK) & _MASK7,
                           W >> (2 * CHUNK)], axis=1).astype(np.int8)


def _recombine3(P: torch.Tensor) -> torch.Tensor:
    """int32 [..., 3L] chunk column sums -> int64 limbs [..., L].

    Routes the high bits of the shifted chunk blocks into the next limb
    (weight 2^16) to stay under vpu.normalize's < 2^31 bound.
    """
    L = P.shape[-1] // 3
    P = P.to(torch.int64)
    P0, P1, P2 = P[..., :L], P[..., L:2 * L], P[..., 2 * L:]
    lo = P0 + ((P1 & 0x1FF) << CHUNK) + ((P2 & 0x3) << (2 * CHUNK))
    hi = (P1 >> 9) + (P2 >> 2)
    return vpu.normalize(lo + vpu._shift_up(hi, 1))


def _toeplitz_rows(d_int: int, lin: int, lout: int) -> np.ndarray:
    """[3*lin, lout] limb matrix: row (c, a) holds limbs of (d << 7c) << 16a,
    truncated to lout limbs (exact when lout covers the full product)."""
    rows = np.zeros((3 * lin, lout), dtype=np.int64)
    for c in range(3):
        dc = d_int << (CHUNK * c)
        ld = host.limbs_for_bits(dc.bit_length() or 1)
        dc_limbs = host.int_to_limbs(dc, ld).astype(np.int64)
        for a in range(lin):
            if a >= lout:
                break
            span = min(ld, lout - a)
            rows[c * lin + a, a:a + span] = dc_limbs[:span]
    return rows


def _i8(mat, device) -> torch.Tensor:
    return torch.as_tensor(np.array(mat, dtype=np.int8), device=device)


def _u16(limbs, device) -> torch.Tensor:
    return torch.as_tensor(np.array(limbs, dtype=np.int64), device=device)


class ConstMulPlan(NamedTuple):
    """x * d (exact, or low-truncated) as one int8 matmul."""

    mat: torch.Tensor  # int8 [3*lin, 3*lout]
    lin: int
    lout: int

    @classmethod
    def build(cls, d_int: int, lin: int, lout: int | None = None, *,
              device) -> "ConstMulPlan":
        lout = lout or lin + host.limbs_for_bits(d_int.bit_length())
        return cls.from_numpy(_chunk_cols(_toeplitz_rows(d_int, lin, lout)),
                              lin, lout, device=device)

    @classmethod
    def from_numpy(cls, mat, lin: int, lout: int, *, device
                   ) -> "ConstMulPlan":
        return cls(mat=_i8(mat, device), lin=lin, lout=lout)


class ModMulConstPlan(NamedTuple):
    """(x * d) mod N as one int8 matmul + barrett_small.

    Matrix entries are the limbs of ((d << (7c + 16a)) mod N); the matmul
    output represents a value === x*d (mod N) bounded by 3*lin*2^7*N,
    i.e. quotient < 2^(7 + log2(3*lin)) <= 2^26 for lin <= 2^16.
    """

    mat: torch.Tensor  # int8 [3*lin, 3*lf]
    lin: int
    lf: int

    @classmethod
    def build(cls, d_int: int, n_int: int, lin: int, *, device
              ) -> "ModMulConstPlan":
        lf = host.limbs_for_bits(n_int.bit_length() + 26)
        rows = np.zeros((3 * lin, lf), dtype=np.int64)
        for c in range(3):
            for a in range(lin):
                v = (d_int << (CHUNK * c + 16 * a)) % n_int
                rows[c * lin + a] = host.int_to_limbs(v, lf).astype(np.int64)
        return cls.from_numpy(_chunk_cols(rows), lin, lf, device=device)

    @classmethod
    def from_numpy(cls, mat, lin: int, lf: int, *, device
                   ) -> "ModMulConstPlan":
        return cls(mat=_i8(mat, device), lin=lin, lf=lf)


class FoldPlan(NamedTuple):
    """wide x -> bounded representative of x mod N (d = 1 special case)."""

    mat: torch.Tensor
    lin: int
    lf: int

    @classmethod
    def build(cls, n_int: int, lin: int, *, device) -> "FoldPlan":
        p = ModMulConstPlan.build(1, n_int, lin, device=device)
        return cls(mat=p.mat, lin=p.lin, lf=p.lf)

    @classmethod
    def from_numpy(cls, mat, lin: int, lf: int, *, device) -> "FoldPlan":
        return cls(mat=_i8(mat, device), lin=lin, lf=lf)


class BarrettPlan(NamedTuple):
    """Exact x mod N for x < 2^28 * N (small-quotient Barrett)."""

    n_limbs_arr: torch.Tensor  # int64 [ln + 1]
    mu_limbs: torch.Tensor     # int64 [4]: floor(2^(b+36) / N) (<= 2^37)
    b: int                     # N.bit_length()
    ln: int                    # limbs of N

    @classmethod
    def build(cls, n_int: int, *, device) -> "BarrettPlan":
        b = n_int.bit_length()
        ln = host.limbs_for_bits(b)
        mu = (1 << (b + 36)) // n_int
        return cls.from_numpy(host.int_to_limbs(n_int, ln + 1),
                              host.int_to_limbs(mu, 4), b, ln, device=device)

    @classmethod
    def from_numpy(cls, n_limbs_arr, mu_limbs, b: int, ln: int, *, device
                   ) -> "BarrettPlan":
        return cls(n_limbs_arr=_u16(n_limbs_arr, device),
                   mu_limbs=_u16(mu_limbs, device), b=b, ln=ln)


def _pad_last(x: torch.Tensor, pad: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, pad)) if pad > 0 else x


def _shift_right_bits(x: torch.Tensor, bits: int, keep: int) -> torch.Tensor:
    """floor(x / 2^bits) keeping ``keep`` limbs (static shift amounts)."""
    k, r = divmod(bits, 16)
    L = x.shape[-1]
    if k >= L:
        return torch.zeros(x.shape[:-1] + (keep,), dtype=x.dtype,
                           device=x.device)
    x = x[..., k:]
    x = _pad_last(x, keep + 1 - x.shape[-1])[..., :keep + 1]
    if r:
        lo = x[..., :keep] >> r
        hi = (x[..., 1:keep + 1] << (16 - r)) & 0xFFFF
        return lo + hi
    return x[..., :keep]


def const_mul(x: torch.Tensor, plan: ConstMulPlan) -> torch.Tensor:
    """limbs [..., lin] -> limbs [..., lout] of x*d (low-truncated to
    lout limbs — exact-division callers rely on this)."""
    return _recombine3(_dot_i8(_chunk_rows(x), plan.mat))


def modmul_const(x: torch.Tensor, plan: ModMulConstPlan,
                 br: BarrettPlan) -> torch.Tensor:
    """(x * d) mod N exactly: one matmul + small Barrett."""
    return barrett_small(_recombine3(_dot_i8(_chunk_rows(x), plan.mat)), br)


def fold_mod(x: torch.Tensor, plan: FoldPlan, br: BarrettPlan
             ) -> torch.Tensor:
    """x mod N exactly for wide x (one matmul + small Barrett)."""
    return modmul_const(x, ModMulConstPlan(plan.mat, plan.lin, plan.lf), br)


def barrett_small(x: torch.Tensor, br: BarrettPlan) -> torch.Tensor:
    """Exact x mod N for 0 <= x < 2^28 * N; returns [..., ln].

    With mu = floor(2^(b+36)/N), q_hat = floor(x1 * mu / 2^44) where
    x1 = floor(x / 2^(b-8)) < 2^36.  Standard Barrett error analysis gives
    q - q_hat in {0, 1, 2}; three conditional subtracts finish exactly.
    """
    b, ln = br.b, br.ln
    x1 = _shift_right_bits(x, b - 8, 3)                 # < 2^36, 3 limbs
    prod = vpu.mul(x1, br.mu_limbs, 7)                  # x1 * mu < 2^73
    qhat = _shift_right_bits(prod, 44, 2)               # quotient < 2^28
    qn = vpu.mul(qhat, br.n_limbs_arr, ln + 1)
    xw = _pad_last(x[..., :ln + 1], ln + 1 - min(x.shape[-1], ln + 1))
    r, _ = vpu.sub(xw, qn)
    nb = br.n_limbs_arr.expand(r.shape)
    r = vpu.cond_sub(r, nb)
    r = vpu.cond_sub(r, nb)
    r = vpu.cond_sub(r, nb)
    return r[..., :ln]
