"""Limb-domain Montgomery arithmetic and exponent digits.

Counterpart of ``paillier_tpu.bigint.montgomery``.  Residues are
little-endian radix-2^16 limb vectors (int64 tensors, as in :mod:`vpu`)
modulo an odd n, with R = 2^(16 L):

* :class:`MontCtx` / :func:`make_mont_ctx`: the modulus' constants, each
  [L], or [B, L] for a batch whose rows have their own moduli (the
  stacked contexts that the JAX package ``vmap``s over in keygen's Fermat
  batch).
* :func:`mont_mul`, :func:`to_mont`, :func:`from_mont`, :func:`modmul`:
  SOS Montgomery products in plain torch.  The column sums of a product
  are formed in one batched step (an outer product summed along its
  anti-diagonals, in int64, in row chunks at wide moduli) instead of the
  JAX package's Horner scan; the integers are the same.
* :func:`mont_pow_digits`: the fixed-window ladder, shared or per-row
  digits, shared or per-row moduli.  A CUDA tensor runs kernel B4
  (``mont_kernel.mont_pow_b4``), a CPU tensor :func:`mont_pow_digits_plain`;
  :func:`mont_pow` and :func:`mont_pow_fixed_base` route through it with
  the base broadcast, as the JAX package does on an accelerator.  The
  result is the canonical base^e mod n.
* :func:`exp_digits`, :func:`n_digits_for_bits`, :func:`limbs_to_digits`:
  MSB-first base-2^window digits of a host integer or a limb tensor.

The JAX module's ``mod_wide`` and ``exact_div`` are not ported: on the
port's paths a multiply with a constant operand is one int8 Toeplitz
product (:mod:`limbmm`).  :class:`..engine.LimbEngine` serves this
module's ladder and products through the engines' interface.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import vpu
from .host import LIMB_BITS, int_to_limbs, limbs_for_bits, mont_nprime


class MontCtx(NamedTuple):
    """Montgomery constants of an odd modulus n: int64 limb tensors [L]
    (shared by a batch) or [B, L] (one modulus per row)."""

    n: torch.Tensor        # the modulus
    nprime: torch.Tensor   # -n^{-1} mod R,  R = 2^(16 L)
    r2: torch.Tensor       # R^2 mod n   (to-Montgomery factor)
    one_m: torch.Tensor    # R mod n     (1 in Montgomery form)

    @property
    def n_limbs(self) -> int:
        return self.n.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.n.device


def mont_ctx_arrays(n_int: int, n_limbs: int | None = None) -> list:
    """The fields of :class:`MontCtx` as host uint32 limb arrays (the JAX
    package's values; its fifth field, ``b2l``, serves only the unported
    ``mod_wide_any``)."""
    if n_int % 2 == 0:
        raise ValueError("Montgomery reduction requires an odd modulus")
    L = n_limbs or limbs_for_bits(n_int.bit_length())
    R = 1 << (LIMB_BITS * L)
    return [int_to_limbs(n_int, L), int_to_limbs(mont_nprime(n_int, L), L),
            int_to_limbs((R * R) % n_int, L), int_to_limbs(R % n_int, L)]


def make_mont_ctx(n_int: int, n_limbs: int | None = None, *, device
                  ) -> MontCtx:
    """Host-side constructor from a Python-int odd modulus."""
    return MontCtx(*[torch.as_tensor(a.astype(np.int64), device=device)
                     for a in mont_ctx_arrays(n_int, n_limbs)])


def stack_mont_ctx(moduli, n_limbs: int, *, device) -> MontCtx:
    """One context per row: fields [B, L] for the odd ``moduli``."""
    per = [mont_ctx_arrays(n, n_limbs) for n in moduli]
    return MontCtx(*[torch.as_tensor(np.stack([p[f] for p in per])
                                     .astype(np.int64), device=device)
                     for f in range(len(MontCtx._fields))])


# ---------------------------------------------------------------------------
# Core Montgomery ops (plain torch)
# ---------------------------------------------------------------------------

# int64 elements of one outer-product step of _mul_cols (256 MB): a wider
# batch is taken in row chunks
_MUL_CHUNK_ELEMS = 1 << 25


def _mul_cols(a: torch.Tensor, b: torch.Tensor, out_len: int) -> torch.Tensor:
    """Column sums of a*b (limbs < 2^16) truncated to out_len columns, in
    one step: the outer product [.., La, Lb] with row i shifted right by
    i (pad to La + Lb - 1 columns and re-stride), summed over i.  Each
    column is < min(La, Lb) * 2^32: exact in int64.  Where the step of
    the whole batch would pass :data:`_MUL_CHUNK_ELEMS` elements (wide
    moduli on many rows), the rows go in chunks."""
    La, Lb = a.shape[-1], b.shape[-1]
    batch = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    rows = int(np.prod(batch)) if batch else 1
    step = max(1, _MUL_CHUNK_ELEMS // (La * (La + Lb)))
    if rows > step:
        a2 = a.expand(batch + (La,)).reshape(-1, La)
        b2 = b.expand(batch + (Lb,)).reshape(-1, Lb)
        return torch.cat([_mul_cols(a2[i:i + step], b2[i:i + step], out_len)
                          for i in range(0, rows, step)]).reshape(
                              batch + (out_len,))
    outer = a[..., :, None] * b[..., None, :]                  # [.., La, Lb]
    W = La + Lb - 1
    padded = torch.nn.functional.pad(outer.expand(batch + (La, Lb)),
                                     (0, W + 1 - Lb))          # [.., La, W+1]
    cols = padded.reshape(batch + (La * (W + 1),))[..., :La * W]
    cols = cols.reshape(batch + (La, W)).sum(dim=-2)           # [.., W]
    if out_len <= W:
        return cols[..., :out_len]
    return torch.nn.functional.pad(cols, (0, out_len - W))


def _normalize(cols: torch.Tensor) -> torch.Tensor:
    """Column sums < 2^47 -> limbs < 2^16 (a carry off the top is
    dropped): three fold passes bring each entry below 2^16 + 2^2, then
    one 0/1 carry resolution finishes exactly."""
    v = cols
    for _ in range(3):
        v = (v & vpu._MASK) + vpu._shift_up(v >> vpu._BITS, 1)
    return vpu.resolve_carries_01(v)[0]


def _mul(a, b, out_len: int) -> torch.Tensor:
    return _normalize(_mul_cols(a, b, out_len))


def mont_mul(ctx: MontCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a*b*R^{-1} mod n for residues a, b < n (SOS:
    full product, quotient digits from -n^{-1} mod R, one conditional
    subtract), as ``paillier_tpu.bigint.montgomery.mont_mul``."""
    L = ctx.n_limbs
    t = _mul(a, b, 2 * L)                          # [.., 2L], < n^2
    m = _mul(t[..., :L], ctx.nprime, L)            # quotient digits, < R
    mn = _mul(m, ctx.n, 2 * L)
    s, carry = vpu.add(t, mn)                      # t + m n == 0 mod R
    hi = torch.cat([s[..., L:], carry.unsqueeze(-1)], dim=-1)   # (t+mn)/R
    n_pad = torch.nn.functional.pad(ctx.n.expand(hi.shape[:-1] + (L,)),
                                    (0, 1))
    return vpu.cond_sub(hi, n_pad)[..., :L]


def modmul(ctx: MontCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain modular product a*b mod n of residues a, b < n (one extra
    Montgomery product by R^2 fixes the R^-1), as
    ``paillier_tpu.bigint.montgomery.modmul``."""
    return mont_mul(ctx, mont_mul(ctx, a, b), ctx.r2.expand(
        torch.broadcast_shapes(a.shape, ctx.r2.shape)))


def to_mont(ctx: MontCtx, x: torch.Tensor) -> torch.Tensor:
    """x -> x*R mod n (x < R, normalized limbs)."""
    return mont_mul(ctx, x, ctx.r2.expand(
        torch.broadcast_shapes(x.shape, ctx.r2.shape)))


def from_mont(ctx: MontCtx, x: torch.Tensor) -> torch.Tensor:
    """x*R^{-1} mod n (leave the Montgomery domain)."""
    return mont_mul(ctx, x, vpu.one_like(x))


# ---------------------------------------------------------------------------
# Fixed-window modular exponentiation
# ---------------------------------------------------------------------------

def exp_digits(e: int, window: int, n_digits: int) -> np.ndarray:
    """MSB-first base-2^window digits of e, padded to n_digits (host side)."""
    digits = []
    for i in range(n_digits - 1, -1, -1):
        digits.append((e >> (i * window)) & ((1 << window) - 1))
    return np.asarray(digits, dtype=np.int32)


def n_digits_for_bits(bits: int, window: int) -> int:
    return max(1, -(-bits // window))


def mont_pow_digits_plain(ctx: MontCtx, base: torch.Tensor, digits,
                          window: int = 4) -> torch.Tensor:
    """base^e mod n by the fixed 2^window-ary ladder, in plain torch.

    Mirrors ``paillier_tpu.bigint.montgomery._mont_pow_digits_jnp``
    multiply for multiply: bm = to_mont(base); table [1_M, bm, ..,
    bm^(2^w - 1)]; acc = 1_M; per digit ``window`` squarings and one
    multiply by table[d] (d = 0 included); from_mont.  base: limbs
    [..., L] < R; digits: int [D] shared or [..., D] per element,
    MSB-first; ctx fields [L] or [..., L] (per-row moduli).  Output: the
    canonical base^e mod n, int64 limbs [..., L].
    """
    digits = torch.as_tensor(digits).to(base.device).long()
    lead = torch.broadcast_shapes(base.shape[:-1], ctx.n.shape[:-1],
                                  digits.shape[:-1])
    L = ctx.n_limbs
    base = base.to(torch.int64).expand(lead + (L,))
    bm = to_mont(ctx, base)
    one_m = ctx.one_m.expand(lead + (L,))
    tbl = [one_m, bm]
    for _ in range(2, 1 << window):
        tbl.append(mont_mul(ctx, tbl[-1], bm))
    stack = torch.stack(tbl, dim=-2)                       # [.., 2^w, L]
    acc = one_m
    for i in range(digits.shape[-1]):
        for _ in range(window):
            acc = mont_mul(ctx, acc, acc)
        d = digits[..., i].expand(lead)
        t = torch.gather(stack, -2, d[..., None, None].expand(lead + (1, L)))
        acc = mont_mul(ctx, acc, t[..., 0, :])
    return from_mont(ctx, acc)


def mont_pow_digits(ctx: MontCtx, base: torch.Tensor, digits,
                    window: int = 4) -> torch.Tensor:
    """Dispatcher: kernel B4 for a CUDA tensor, the plain ladder for a CPU
    tensor (the wrapper decides by the base's device).  A base with more
    than one batch axis (and per-element digits broadcast to its batch
    shape) goes through the kernel flattened to rows, as the JAX package
    flattens it for its Pallas kernel; the result has the base's shape."""
    from .mont_kernel import mont_pow_b4
    lead, L = base.shape[:-1], base.shape[-1]
    if len(lead) <= 1:
        return mont_pow_b4(ctx, base, digits, window)
    digits = torch.as_tensor(digits, device=base.device)
    if digits.dim() > 1:
        digits = digits.expand(lead + digits.shape[-1:]).reshape(
            -1, digits.shape[-1])
    return mont_pow_b4(ctx, base.reshape(-1, L), digits,
                       window).reshape(lead + (L,))


def mont_pow(ctx: MontCtx, base: torch.Tensor, e: int, window: int = 4
             ) -> torch.Tensor:
    """base^e mod n for a host-known nonnegative exponent (shared)."""
    if e < 0:
        raise ValueError("negative exponents need a modular inverse")
    if e == 0:
        return vpu.one_like(base.to(torch.int64))
    nd = n_digits_for_bits(e.bit_length(), window)
    return mont_pow_digits(ctx, base,
                           torch.as_tensor(exp_digits(e, window, nd)), window)


def mont_pow_fixed_base(ctx: MontCtx, base_1d: torch.Tensor, digits,
                        window: int = 4) -> torch.Tensor:
    """Shared base [L], per-element exponents [..., D]: the base is
    broadcast over the batch and the ladder runs as for any base."""
    digits = torch.as_tensor(digits)
    base = base_1d.expand(digits.shape[:-1] + (ctx.n_limbs,))
    return mont_pow_digits(ctx, base, digits, window)


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
