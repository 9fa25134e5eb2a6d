"""The port's fixed-window ladder and exponent digits against the JAX
package, both on the CPU.

``rns2_pow_plain`` (what kernel B2 computes, bit for bit) is held to the
JAX ladder ``rns2_pow_jnp`` and to the Pallas kernel ``rns2_pow_pallas``
in interpret mode, as tests/test_rns2.py runs them; the digit helpers of
``bigint/montgomery.py`` and ``DeviceKey.pow`` / ``pow_int`` to theirs
(the JAX key forced onto its RNS engine with PAILLIER_TPU_FORCE_RNS=1, as
tests/test_engine_paths.py does).  The same seeded inputs go to both
sides; tolerance: exact (residues compared as int32, limbs as uint32).
"""

import dataclasses
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paillier_tpu_torch as pt
from paillier_tpu.bigint import montgomery as jmont
from paillier_tpu.bigint import rns2 as jr
from paillier_tpu.bigint.pallas_rns2 import rns2_pow_pallas
from paillier_tpu.core.keygen import keygen as jkeygen
from paillier_tpu_torch.bigint import host
from paillier_tpu_torch.bigint import montgomery as tmont
from paillier_tpu_torch.bigint import rns2 as tr

torch.set_num_threads(2)


def _odd(rng, bits):
    return rng.getrandbits(bits) | (1 << (bits - 1)) | 1


def _same(t: torch.Tensor, j) -> bool:
    return np.array_equal(t.numpy(), np.asarray(j))


def _same_limbs(t: torch.Tensor, j) -> bool:
    return np.array_equal(t.numpy().astype(np.uint32), np.asarray(j))


@pytest.fixture(scope="module")
def pair256():
    n = _odd(random.Random(0xB2), 256)
    return n, jr.Rns2Engine(n), tr.Rns2Engine(n, device="cpu")


@pytest.mark.parametrize("window", [2, 4, 5])
@pytest.mark.parametrize("per_element", [False, True])
def test_plain_fixed_window_ladder_vs_jax(pair256, window, per_element):
    """rns2_pow_plain == rns2_pow_jnp at k = 64, 8 rows, shared and
    per-element 24-bit exponents (zero exponent and zero digits
    included), and == the Pallas kernel in interpret mode at windows 2
    and 4 (its 32-entry table at window 5 takes the interpreter ~8 s)."""
    n, jeng, teng = pair256
    rng = random.Random(window * 10 + per_element)
    xs = [rng.randrange(n) for _ in range(7)] + [n - 1]
    es = [rng.getrandbits(24) for _ in range(7)] + [0]
    nd = tmont.n_digits_for_bits(24, window)
    per = np.stack([tmont.exp_digits(e, window, nd) for e in es])
    digits = per if per_element else per[0]
    want_e = es if per_element else [es[0]] * 8
    jx = jeng.encode(xs)
    got = tr.rns2_pow_plain(teng.ctx, teng.encode(xs), torch.as_tensor(digits),
                            window)
    assert got.dtype == torch.int32
    assert _same(got, jr.rns2_pow_jnp(jeng.ctx, jx, jnp.asarray(digits),
                                      window))
    if window < 5:
        assert _same(got, rns2_pow_pallas(jeng.ctx, jx, jnp.asarray(digits),
                                          window, block=8, interpret=True))
    assert teng.decode(got) == [pow(x, e, n) for x, e in zip(xs, want_e)]
    # the dispatcher and the engine take a CPU tensor to the plain ladder
    assert torch.equal(teng.pow(teng.encode(xs), digits, window), got)


def test_wide_k512_row_vs_jax():
    """One row on the ~6,500-bit modulus of tests/test_rns2.py, whose spec
    lands at k = 512: the hi-product pre-reduction of the wide branch, in
    the fixed-window ladder, the sliding ladder and one exact multiply."""
    rng = random.Random(0x51DE)
    n = rng.getrandbits(6500) | (1 << 6499) | 1
    jeng, teng = jr.Rns2Engine(n), tr.Rns2Engine(n, device="cpu")
    assert teng.spec.k == jeng.ctx.k == 512
    xs = [rng.randrange(n)]
    jx, tx = jeng.encode(xs), teng.encode(xs)
    e = 0xB2C3
    digits = tmont.exp_digits(e, 4, tmont.n_digits_for_bits(16, 4))
    got = tr.rns2_pow_plain(teng.ctx, tx, digits, 4)
    assert _same(got, jr.rns2_pow_jnp(jeng.ctx, jx, jnp.asarray(digits), 4))
    assert teng.decode(got) == [pow(xs[0], e, n)]
    sched = tr.sliding_window_schedule(e, 6)
    got = tr.rns2_pow_sliding_plain(teng.ctx, tx, sched, 6)
    assert _same(got, jr.rns2_pow_sliding_jnp(jeng.ctx, jx, jnp.asarray(sched),
                                              6))
    assert _same(teng.mul(tx, tx), jeng.mul(jx, jx))


@pytest.mark.parametrize("window", [1, 3, 4, 6])
def test_exp_digits_parity(window):
    rng = random.Random(window)
    for e in (0, 1, 2, 255, rng.getrandbits(100), rng.getrandbits(2048)):
        nd = tmont.n_digits_for_bits(e.bit_length(), window)
        assert nd == jmont.n_digits_for_bits(e.bit_length(), window)
        for width in (nd, nd + 3):
            got = tmont.exp_digits(e, window, width)
            assert got.dtype == np.int32
            assert np.array_equal(got, jmont.exp_digits(e, window, width))
        assert sum(int(d) << (window * i) for i, d in
                   enumerate(tmont.exp_digits(e, window, nd)[::-1])) == e


@pytest.mark.parametrize("window", [1, 2, 4, 8])
@pytest.mark.parametrize("n_digits", [None, 5, 200])
def test_limbs_to_digits_parity(window, n_digits):
    rng = random.Random(window)
    vals = [rng.getrandbits(16 * 9) for _ in range(5)] + [0, 2 ** 144 - 1]
    limbs = host.ints_to_limbs(vals, 9)
    got = tmont.limbs_to_digits(torch.as_tensor(limbs.astype(np.int64)),
                                window, n_digits)
    want = jmont.limbs_to_digits(jnp.asarray(limbs), window, n_digits)
    assert got.dtype == torch.int32 and _same(got, want)
    three = tmont.limbs_to_digits(
        torch.as_tensor(limbs.astype(np.int64)).reshape(7, 1, 9), window)
    assert three.shape == (7, 1, 9 * 16 // window)
    with pytest.raises(ValueError):
        tmont.limbs_to_digits(torch.zeros((1, 2), dtype=torch.int64), 5)


@pytest.fixture(scope="module")
def keys128():
    """(port secret key, JAX secret key forced onto its RNS engine)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PAILLIER_TPU_FORCE_RNS", "1")
        tsk, _ = pt.keygen(128, random.Random(0x128))
        jsk, _ = jkeygen(128, random.Random(0x128))
        jsk = type(jsk)(**{f.name: getattr(jsk, f.name)
                           for f in dataclasses.fields(jsk)})   # fresh DeviceKey
        assert jsk.device().use_rns()
        yield tsk, jsk


@pytest.mark.parametrize("level", [1, 2])
def test_device_key_pow_parity(keys128, level):
    """DeviceKey.pow (fixed window, shared and per-element digits) and
    pow_int (sliding window, e = 0 included) against the JAX DeviceKey."""
    tsk, jsk = keys128
    tdk, jdk = tsk.device("cpu"), jsk.device()
    rng = random.Random(level)
    mod = tsk.modulus_for_level(level)
    width = tdk.limbs_for_level(level)
    bases = [rng.randrange(mod) for _ in range(5)] + [1]
    limbs = host.ints_to_limbs(bases, width)
    tb = torch.as_tensor(limbs.astype(np.int64))
    jb = jnp.asarray(limbs)
    es = [rng.getrandbits(40) for _ in range(5)] + [0]
    nd = tmont.n_digits_for_bits(40, 4)
    per = np.stack([tmont.exp_digits(e, 4, nd) for e in es])
    for digits, want_e in ((per, es), (per[1], [es[1]] * 6)):
        got = tdk.pow(level, tb, torch.as_tensor(digits), 4)
        assert got.shape == (6, width)
        assert _same_limbs(got, jdk.pow(level, jb, jnp.asarray(digits), 4))
        assert host.limbs_to_ints(got.numpy()) == [
            pow(b, e, mod) for b, e in zip(bases, want_e)]
    for e in (0, 3, tsk.n):
        got = tdk.pow_int(level, tb, e)
        assert _same_limbs(got, jdk.pow_int(level, jb, e))
        assert host.limbs_to_ints(got.numpy()) == [pow(b, e, mod)
                                                   for b in bases]
