"""Batched homomorphic operations (reference: operations.go:11-140).

add       : elementwise ciphertext product mod n^(s+1)
sub       : product with the modular inverse of the subtrahend
const_mult: ciphertext^k (shared k: sliding-window ladder, kernel B1;
            per-element k: fixed-window ladder, kernel B2)
randomize : add a fresh encryption of zero
aggregate : modular product over an axis (the 1M-ciphertext aggregation
            path, BASELINE config #3): a log-depth tree of RNS
            Montgomery products with a single M-power fix-up
nested_*  : ops on (level-2, level-1) ciphertext pairs
extract_randomness: recover the randomness r of a regular ciphertext
            with the secret key (its mod-n ladder: kernel B4)

Every product and ladder runs on the engine of n^(s+1)
(``DeviceKey.engine``, chosen by width in ``bigint.engine.make_engine``);
the ciphertexts' device is the device of the work.  Modular inverses
(sub / nested_sub) are computed on the host in one batch.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch

from ..bigint import host
from ..bigint import limbmm as lm
from ..bigint import montgomery as mont
from ..bigint import vpu
from ..bigint.engine import product_tree
from ..ops import random as prand
from ..ops.profiling import span, spanned
from .encrypt import Encryptor, gm_binomial
from .keys import (LEVEL_ONE, LEVEL_TWO, MIXED, REGULAR, Ciphertext,
                   PublicKey, SecretKey, decode_batch, encode_batch)


# Digit width of kernel B2's per-element exponents and of kernel B4's
# ladder in extract_randomness (the JAX default).
B2_WINDOW = 4
B4_WINDOW = 4


def _dk(pk: PublicKey, ct: Ciphertext):
    return pk.device(ct.c.device)


def _inverse_limbs(ct: Ciphertext, modulus: int) -> torch.Tensor:
    """Limbs of ct.c^-1 mod ``modulus``, same shape and device as ct.c."""
    inv = host.modinv_batch(decode_batch(ct.c.reshape(-1, ct.c.shape[-1])),
                            modulus)
    return encode_batch(inv, ct.c.shape[-1],
                        device=ct.c.device).reshape(ct.c.shape)


@spanned("add")
def add(pk: PublicKey, *cts: Ciphertext) -> Ciphertext:
    """Homomorphic addition: elementwise product mod n^(s+1)
    (reference: operations.go:11-29)."""
    level = cts[0].level
    dk = _dk(pk, cts[0])
    acc = cts[0].c
    for ct in cts[1:]:
        if ct.level != level:
            raise ValueError("cannot add ciphertexts at different levels")
        acc = dk.mul(level, acc, ct.c)
    return Ciphertext(c=acc, level=level, method=MIXED)


def sub(pk: PublicKey, *cts: Ciphertext) -> Ciphertext:
    """Homomorphic subtraction from the first argument
    (reference: operations.go:32-55).  Inverses are computed host-side."""
    level = cts[0].level
    dk = _dk(pk, cts[0])
    mod = pk.modulus_for_level(level)
    acc = cts[0].c
    for ct in cts[1:]:
        acc = dk.mul(level, acc, _inverse_limbs(ct, mod))
    return Ciphertext(c=acc, level=level, method=MIXED)


@spanned("const_mult")
def const_mult(pk: PublicKey, ct: Ciphertext, k) -> Ciphertext:
    """ct^k mod n^(s+1) (reference: operations.go:58-64).

    ``k`` may be a single int (shared) or a sequence of per-element ints;
    the per-element digit count comes from the largest of them.
    """
    dk = _dk(pk, ct)
    level = ct.level
    if isinstance(k, (int, np.integer)):
        c = dk.pow_int(level, ct.c, int(k))
    else:
        with span("host_int", op="exp_digits"):
            bits = max(int(ki).bit_length() for ki in k) or 1
            nd = mont.n_digits_for_bits(bits, B2_WINDOW)
            digits = np.stack([mont.exp_digits(int(ki), B2_WINDOW, nd)
                               for ki in k])
        digits = torch.as_tensor(digits.reshape(ct.c.shape[:-1] + (nd,)),
                                 device=ct.c.device)
        c = dk.pow(level, ct.c, digits, B2_WINDOW)
    return Ciphertext(c=c, level=level, method=ct.method)


def randomize(pk: PublicKey, ct: Ciphertext, rng=None) -> Ciphertext:
    """Re-randomize by adding Enc(0) (reference: operations.go:67-69)."""
    enc = Encryptor(pk, ct.level, rng=rng, device=ct.c.device)
    zeros = enc.encrypt([0] * int(np.prod(ct.batch_shape or (1,))))
    z = Ciphertext(c=zeros.c.reshape(ct.c.shape), level=ct.level)
    return add(pk, ct, z)


# ---------------------------------------------------------------------------
# Aggregation: modular product over an axis (1M-ciphertext adds)
# ---------------------------------------------------------------------------

@spanned("aggregate")
def aggregate(pk: PublicKey, ct: Ciphertext, axis: int = 0) -> Ciphertext:
    """Homomorphic sum of a whole batch: prod_i c_i mod n^(s+1).

    A log-depth tree (:func:`..bigint.engine.product_tree`) of the
    engine's Montgomery multiply (on the RNS engine one exact multiply of
    the pairs: pointwise channel products and two int8 base extensions),
    padded with the integer 1 at odd counts; every tree multiply divides
    by the radix (M, or R on the limb engine), and one multiply by
    radix^(t+1) mod N restores the product (t from
    :func:`_tree_r_power`).  Plain torch, as the JAX package runs it
    outside any Pallas kernel.
    """
    dk = _dk(pk, ct)
    level = ct.level
    c = torch.movedim(ct.c, axis, 0)
    eng = dk.engine(level)
    fix = eng.encode([pow(eng.radix, _tree_r_power(c.shape[0]) + 1,
                          pk.modulus_for_level(level))])[0]
    x = product_tree(eng.mont_mul, eng.from_limbs(c), eng.one)
    out = eng.mont_mul(x, fix.expand(x.shape))
    return Ciphertext(c=eng.to_limbs_mod(out[None])[0], level=level,
                      method=MIXED)


def aggregate_streaming(pk: PublicKey,
                        chunks: Iterable[Ciphertext]) -> Ciphertext:
    """Homomorphic sum over an unbounded stream of ciphertext batches.

    Each chunk is reduced with :func:`aggregate` and the running partial
    is folded in with one modular multiply, so device memory stays
    bounded by one chunk whatever the stream's length.  Chunks may have
    different batch sizes.
    """
    partial = None
    level = None
    for ct in chunks:
        if level is None:
            level = ct.level
        elif ct.level != level:
            raise ValueError("cannot aggregate ciphertexts at "
                             "different levels")
        p = aggregate(pk, ct, axis=0)
        if partial is None:
            partial = p
        else:
            partial = Ciphertext(c=_dk(pk, ct).mul(level, partial.c, p.c),
                                 level=level, method=MIXED)
    if partial is None:
        raise ValueError("aggregate_streaming needs at least one chunk")
    return partial


def _tree_r_power(m: int) -> int:
    """Total M^-1 deficit of the product tree for m elements (exact)."""
    # Every tree multiply divides its pair's product by M.  All m real
    # elements start with deficit 0; padded 1s have deficit 0 too (they
    # are the integer 1).  Each level: new_deficit = d_a + d_b + 1.
    deficits = [0] * m
    while len(deficits) > 1:
        if len(deficits) % 2:
            deficits.append(0)
        deficits = [deficits[i] + deficits[i + 1] + 1
                    for i in range(0, len(deficits), 2)]
    return deficits[0]


# ---------------------------------------------------------------------------
# Nested ops (level-2 x level-1)
# ---------------------------------------------------------------------------

def nested_add(pk: PublicKey, ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
    """ct1^(ct2.c) mod n^3 (reference: operations.go:121-127): kernel B2
    with per-element exponents, the 16 L base-16 digits of ct2's limbs."""
    if ct1.level != LEVEL_TWO or ct2.level != LEVEL_ONE:
        raise ValueError("nested_add needs (level-2, level-1) ciphertexts")
    dk = _dk(pk, ct1)
    digits = mont.limbs_to_digits(ct2.c.to(dk.device), B2_WINDOW)
    c = dk.pow(LEVEL_TWO, ct1.c, digits, B2_WINDOW)
    return Ciphertext(c=c, level=LEVEL_TWO, method=ct1.method)


def nested_sub(pk: PublicKey, ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
    """ct1^(ct2.c^-1 mod n^2) (reference: operations.go:130-140)."""
    if ct1.level != LEVEL_TWO or ct2.level != LEVEL_ONE:
        raise ValueError("nested_sub needs (level-2, level-1) ciphertexts")
    inv = Ciphertext(c=_inverse_limbs(ct2, pk.n2), level=LEVEL_ONE)
    return nested_add(pk, ct1, inv)


def nested_randomize(pk: PublicKey, ct: Ciphertext, rng=None,
                     rs: Sequence[tuple[int, int]] | None = None):
    """ct' = ct^(a^n mod n^2) * b^(n^2) mod n^3, returning (ct', a, b)
    (reference: operations.go:96-118)."""
    if ct.level != LEVEL_TWO:
        raise ValueError("can only nested-randomize level-2 ciphertexts")
    rng = rng or prand.make_rng()
    count = int(np.prod(ct.batch_shape or (1,)))
    if rs is None:
        rs = [(prand.random_unit(pk.n, rng), prand.random_unit(pk.n, rng))
              for _ in range(count)]
    a_list = [x[0] for x in rs]
    b_list = [x[1] for x in rs]
    dk = _dk(pk, ct)
    L = dk.L
    a = encode_batch(a_list, 2 * L, device=dk.device).reshape(
        ct.c.shape[:-1] + (2 * L,))
    b = encode_batch(b_list, 3 * L, device=dk.device).reshape(
        ct.c.shape[:-1] + (3 * L,))
    an = dk.pow_int(LEVEL_ONE, a, pk.n)                    # a^n mod n^2
    bn2 = dk.pow_int(LEVEL_TWO, b, pk.n2)                  # b^(n^2) mod n^3
    ctan = dk.pow(LEVEL_TWO, ct.c, mont.limbs_to_digits(an, B2_WINDOW),
                  B2_WINDOW)
    out = Ciphertext(c=dk.mul(LEVEL_TWO, ctan, bn2), level=LEVEL_TWO,
                     method=REGULAR)
    return out, a_list, b_list


def extract_randomness(sk: SecretKey, ct: Ciphertext) -> list[int]:
    """Recover the encryption randomness r with the secret key
    (reference: operations.go:75-91 "ExtractRandonness" [sic]).

    z = c * G^{-m} mod n^(s+1) encrypts 0, so z = r^(n^s); then
    r = z^((n^s)^{-1} mod lambda) mod n: the plain decryption (kernel B1
    on a CUDA tensor), G^{-m} by the binomial shortcut, one RNS product,
    a fold to mod n and the limb Montgomery ladder (kernel B4).
    """
    from .decrypt import Decryptor
    dk = _dk(sk, ct)
    s = ct.level
    ns = sk.n ** s
    v = Decryptor(sk, s, device=dk.device).decrypt_array(ct)   # m [..., sL]
    # G^{-m} = G^{(n^s - m) mod n^s}; m == 0 gives G^0 = 1
    ns_l = encode_batch([ns], s * dk.L, device=dk.device)[0]
    negv, _ = vpu.sub(ns_l.expand(v.shape), v)
    negv = torch.where(vpu.is_zero(v).unsqueeze(-1), torch.zeros_like(negv),
                       negv)
    z = dk.mul(s, ct.c.to(dk.device), gm_binomial(dk, negv, s))
    # r lives mod n: one fold of z (< n^(s+1)) and a small Barrett
    z_mod_n = lm.fold_mod(z, dk.fold_plan(sk.n, z.shape[-1]),
                          dk.barrett_plan(sk.n))
    ns_inv = pow(ns, -1, sk.lam)                   # shared secret exponent
    nd = mont.n_digits_for_bits(ns_inv.bit_length() or 1, B4_WINDOW)
    digits = torch.as_tensor(mont.exp_digits(ns_inv, B4_WINDOW, nd),
                             device=dk.device)
    r = mont.mont_pow_digits(dk.mont_ctx_n(), z_mod_n, digits, B4_WINDOW)
    return decode_batch(r.reshape(-1, dk.L))
