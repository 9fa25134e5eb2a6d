"""Batched fixed-limb big-integer arithmetic on tensors (plain torch).

Counterpart of ``paillier_tpu.bigint.vpu``.  Integers are little-endian
radix-2^16 limb vectors, shape ``(batch, n_limbs)``.  The JAX package
keeps them in ``uint32``; the port keeps the same digits in ``int64``
(torch's ``uint32`` has no add or shift on the CPU), so every sum and
product below that is exact in uint32 is exact here too.

* Carry propagation is log-depth: a Kogge-Stone generate/propagate
  ladder of log2(L) vector steps.
* Multiplication is a length-L Horner loop of broadcast
  multiply-accumulates, carries resolved once at the end.  On the hot
  paths it runs only at widths of 1 to 3 limbs (Barrett quotients and
  the converter's alpha*M); wide constant multiplies are int8 matmuls
  (:mod:`limbmm`).
"""

from __future__ import annotations

import torch

from .host import LIMB_BITS, LIMB_MASK

_MASK = LIMB_MASK
_BITS = LIMB_BITS


def _shift_up(x: torch.Tensor, k: int) -> torch.Tensor:
    """out[..., i] = x[..., i - k] along the limb axis, zeros below."""
    L = x.shape[-1]
    if k >= L:
        return torch.zeros_like(x)
    pad = torch.zeros(x.shape[:-1] + (k,), dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[..., :L - k]], dim=-1)


# ---------------------------------------------------------------------------
# Carry resolution: log-depth generate/propagate prefix
# ---------------------------------------------------------------------------

def resolve_carries_01(s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Resolve carries for limb values in [0, 2^17): returns
    (limbs, carry_out) with limbs < 2^16 and carry_out the carry off the
    top limb (shape ``s.shape[:-1]``)."""
    g = s >> _BITS                       # 0/1 generate
    r = s & _MASK
    p = (r == _MASK).to(s.dtype)         # propagate
    L = s.shape[-1]
    d = 1
    while d < L:
        g = g | (p & _shift_up(g, d))
        p = p & _shift_up(p, d)
        d *= 2
    # g now holds the inclusive prefix: carry OUT of limb i
    carry_out = g[..., -1]
    out = (r + _shift_up(g, 1)) & _MASK
    return out, carry_out


def normalize(cols: torch.Tensor) -> torch.Tensor:
    """Normalize unreduced column sums (each < 2^31) to limbs < 2^16.

    Two fold passes shrink entries to < 2^16 + 1, then one 0/1-carry
    resolution finishes exactly.  A final carry off the top limb is
    dropped (callers size the output so it is zero).
    """
    v = cols
    for _ in range(2):
        v = (v & _MASK) + _shift_up(v >> _BITS, 1)
    out, _ = resolve_carries_01(v)
    return out


# ---------------------------------------------------------------------------
# Add / sub / compare
# ---------------------------------------------------------------------------

def add(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(a + b) of equal-width normalized numbers -> (limbs, carry_out)."""
    return resolve_carries_01(a + b)


def sub(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(a - b) mod 2^(16L) -> (limbs, borrow) with borrow=1 iff a < b."""
    # two's complement add: a + ~b + 1 over 16-bit limbs
    s = a + (b ^ _MASK)
    s[..., 0] += 1
    out, carry = resolve_carries_01(s)
    return out, 1 - carry


def cond_sub(a: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """a - n where a >= n else a (branchless). Shapes must match."""
    d, borrow = sub(a, n)
    return torch.where((borrow == 0).unsqueeze(-1), d, a)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(dim=-1)


# ---------------------------------------------------------------------------
# Multiplication
# ---------------------------------------------------------------------------

def _mul_cols(a: torch.Tensor, b: torch.Tensor, out_len: int) -> torch.Tensor:
    """Unnormalized column sums of a*b, truncated to out_len limbs.

    Horner form over the limbs of ``a`` (MSB first): each step shifts
    the accumulator one limb up and adds a_i * b split into 16-bit
    halves.  Column entries stay < 2^17 * min(La, Lb) <= 2^31 for limb
    counts <= 2^14, as in the JAX package's uint32 version.
    """
    La = a.shape[-1]
    batch = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    Lb = min(b.shape[-1], out_len)
    b = b[..., :Lb].expand(batch + (Lb,))
    a = a.expand(batch + (La,))
    acc = torch.zeros(batch + (out_len,), dtype=torch.int64, device=a.device)
    for i in range(La - 1, -1, -1):
        acc = _shift_up(acc, 1)                                    # * 2^16
        p = a[..., i:i + 1] * b                                    # exact
        acc[..., :Lb] += p & _MASK
        if Lb < out_len:
            acc[..., 1:Lb + 1] += p >> _BITS
        else:
            acc[..., 1:Lb] += (p >> _BITS)[..., :Lb - 1]
    return acc


def mul(a: torch.Tensor, b: torch.Tensor, out_len: int | None = None
        ) -> torch.Tensor:
    """Full product of normalized numbers; default width La+Lb limbs."""
    if out_len is None:
        out_len = a.shape[-1] + b.shape[-1]
    return normalize(_mul_cols(a, b, out_len))
