"""The port's comb (fixed-base) ladder against the JAX package, both on
the CPU.

``build_fixed_base_table`` and ``rns2_pow_fixed_base_plain`` (what kernel
B3 computes, bit for bit) are held to the JAX package's
``build_fixed_base_table``, ``rns2_pow_fixed_base_jnp`` and the Pallas
kernel ``rns2_pow_fixed_base_pallas`` in interpret mode, as
tests/test_rns2.py runs them on its 256-bit engine.  The same seeded
inputs go to both sides; tolerance: exact (residues compared as int32).
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paillier_tpu.bigint import rns2 as jr
from paillier_tpu.bigint.pallas_rns2 import rns2_pow_fixed_base_pallas
from paillier_tpu_torch.bigint import fixed_base_kernel as fb
from paillier_tpu_torch.bigint import montgomery as tmont
from paillier_tpu_torch.bigint import rns2 as tr

torch.set_num_threads(2)


def _same(t: torch.Tensor, j) -> bool:
    return np.array_equal(t.numpy(), np.asarray(j))


@pytest.fixture(scope="module")
def pair256():
    rng = random.Random(0xB3)
    n = rng.getrandbits(256) | (1 << 255) | 1
    return n, jr.Rns2Engine(n), tr.Rns2Engine(n, device="cpu")


def _digits(es, window, nd):
    return np.stack([tmont.exp_digits(e, window, nd) for e in es])


@pytest.mark.parametrize("window", [2, 4])
def test_table_vs_jax(pair256, window):
    """The comb table: the same [D*2^w, C] residues as the JAX package."""
    n, jeng, teng = pair256
    base = random.Random(window).randrange(2, n)
    nd = tmont.n_digits_for_bits(60, window)
    got = tr.build_fixed_base_table(teng, base, nd, window)
    assert got.dtype == torch.int32 and got.shape == (nd << window, 2 * teng.spec.k)
    assert _same(got, jr.build_fixed_base_table(jeng, base, nd, window))


@pytest.mark.parametrize("window", [2, 4])
def test_comb_plain_vs_jax(pair256, window):
    """rns2_pow_fixed_base_plain == rns2_pow_fixed_base_jnp == the Pallas
    kernel in interpret mode, 8 rows of 60-bit exponents (a zero exponent
    included), and == Python's pow."""
    n, jeng, teng = pair256
    rng = random.Random(0xC0 + window)
    base = rng.randrange(2, n)
    es = [rng.getrandbits(60) for _ in range(7)] + [0]
    nd = tmont.n_digits_for_bits(60, window)
    dig = _digits(es, window, nd)
    table = tr.build_fixed_base_table(teng, base, nd, window)
    jtable = jr.build_fixed_base_table(jeng, base, nd, window)
    got = tr.rns2_pow_fixed_base_plain(teng.ctx, table, torch.as_tensor(dig),
                                       window)
    assert got.dtype == torch.int32 and got.shape == (8, 2 * teng.spec.k)
    assert _same(got, jr.rns2_pow_fixed_base_jnp(jeng.ctx, jtable,
                                                 jnp.asarray(dig), window))
    assert _same(got, rns2_pow_fixed_base_pallas(
        jeng.ctx, jtable, jnp.asarray(dig), window, block=8, interpret=True))
    assert teng.decode(got) == [pow(base, e, n) for e in es]


def test_comb_fin_dispatch_and_one_digit(pair256):
    """The exit multiply takes ``fin`` (base^e * fin mod n); a CPU table
    runs the plain comb through the dispatcher and the B3 wrapper without
    a launch; one digit (D = 1) is the exit multiply alone."""
    n, _, teng = pair256
    rng = random.Random(0xC9)
    base = rng.randrange(2, n)
    es = [rng.getrandbits(32) for _ in range(5)]
    fs = [rng.randrange(n) for _ in range(5)]
    nd = tmont.n_digits_for_bits(32, 4)
    dig = torch.as_tensor(_digits(es, 4, nd))
    table = tr.build_fixed_base_table(teng, base, nd, 4)
    fin = teng.encode(fs)
    before = fb.rns2_pow_fixed_base_b3.launches
    got = fb.rns2_pow_fixed_base_b3(teng.ctx, table, dig, 4, fin=fin)
    assert fb.rns2_pow_fixed_base_b3.launches == before
    assert torch.equal(got, tr.rns2_pow_fixed_base(teng.ctx, table, dig, 4,
                                                   fin=fin))
    assert teng.decode(got) == [pow(base, e, n) * f % n
                                for e, f in zip(es, fs)]
    table1 = tr.build_fixed_base_table(teng, base, 1, 4)
    one = tr.rns2_pow_fixed_base_plain(
        teng.ctx, table1, torch.as_tensor([[0], [1], [15]]), 4)
    assert teng.decode(one) == [1, base, pow(base, 15, n)]
