"""Parity of the port's limb layer (paillier_tpu_torch.bigint.vpu and
.limbmm) with the JAX package's, both on the CPU.

Inputs are seeded numpy / random draws fed to both; the JAX side works
in uint32 limbs, the port in int64 limbs.  Tolerance: exact (outputs
compared after casting the port's limbs to uint32).
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paillier_tpu.bigint import limbmm as jlm
from paillier_tpu.bigint import vpu as jvpu
from paillier_tpu_torch.bigint import host
from paillier_tpu_torch.bigint import limbmm as tlm
from paillier_tpu_torch.bigint import vpu as tvpu

torch.set_num_threads(2)


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a).astype(np.int64))


def _same(t: torch.Tensor, j) -> bool:
    got = t.numpy()
    return (got.min(initial=0) >= 0 and got.max(initial=0) < 2 ** 32
            and np.array_equal(got.astype(np.uint32), np.asarray(j)))


def _limbs(rng, count, L, bits=None):
    bits = bits or 16 * L
    return host.ints_to_limbs([rng.getrandbits(bits) for _ in range(count)],
                              L)


@pytest.mark.parametrize("L", [1, 3, 16, 33])
def test_vpu_add_sub_cond_sub(L):
    rng = random.Random(L)
    a = _limbs(rng, 24, L)
    b = _limbs(rng, 24, L)
    a[0] = b[0]                                 # equal rows: borrow 0
    a[1] = 0xFFFF                               # long carry chains
    b[1, 0] = 1
    for tf, jf in ((tvpu.add, jvpu.add), (tvpu.sub, jvpu.sub)):
        tout, tc = tf(_t(a), _t(b))
        jout, jc = jf(jnp.asarray(a), jnp.asarray(b))
        assert _same(tout, jout) and _same(tc, jc)
    assert _same(tvpu.cond_sub(_t(a), _t(b)),
                 jvpu.cond_sub(jnp.asarray(a), jnp.asarray(b)))
    z = a.copy()
    z[::3] = 0
    assert np.array_equal(tvpu.is_zero(_t(z)).numpy(),
                          np.asarray(jvpu.is_zero(jnp.asarray(z))))


@pytest.mark.parametrize("L", [2, 17])
def test_vpu_normalize_and_resolve(L):
    rng = np.random.default_rng(L)
    cols = rng.integers(0, 2 ** 31 - 1, size=(12, L), dtype=np.int64)
    cols[:, -1] = 0                  # room for the carries
    assert _same(tvpu.normalize(_t(cols)),
                 jvpu.normalize(jnp.asarray(cols.astype(np.uint32))))
    s = rng.integers(0, 2 ** 17, size=(12, L), dtype=np.int64)
    tout, tc = tvpu.resolve_carries_01(_t(s))
    jout, jc = jvpu.resolve_carries_01(jnp.asarray(s.astype(np.uint32)))
    assert _same(tout, jout) and _same(tc, jc)


@pytest.mark.parametrize("La,Lb,out", [(1, 16, 16), (3, 4, 7), (2, 9, 10),
                                       (8, 8, None), (5, 3, 4)])
def test_vpu_mul(La, Lb, out):
    rng = random.Random(La * 100 + Lb)
    a = _limbs(rng, 10, La)
    b = _limbs(rng, 10, Lb)
    assert _same(tvpu.mul(_t(a), _t(b), out),
                 jvpu.mul(jnp.asarray(a), jnp.asarray(b), out))
    # shared (broadcast) right operand, as barrett_small and to_limbs use
    assert _same(tvpu.mul(_t(a), _t(b[0]), out),
                 jvpu.mul(jnp.asarray(a), jnp.asarray(b[0]), out))


def test_dot_i8_exact():
    rng = np.random.default_rng(8)
    for M, K, N in ((4, 12, 4), (17, 640, 640), (1, 768, 96)):
        a = rng.integers(-128, 128, size=(M, K), dtype=np.int64)
        b = rng.integers(-128, 128, size=(K, N), dtype=np.int64)
        got = tlm._dot_i8(torch.as_tensor(a, dtype=torch.int8),
                          torch.as_tensor(b, dtype=torch.int8))
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), a @ b)
    lead = torch.as_tensor(rng.integers(-128, 128, (2, 3, 16)),
                           dtype=torch.int8)
    rhs = torch.as_tensor(rng.integers(-128, 128, (16, 8)), dtype=torch.int8)
    assert tlm._dot_i8(lead, rhs).shape == (2, 3, 8)


def _plan_fields(plan):
    return {f: np.asarray(v) if not isinstance(v, int) else v
            for f, v in plan._asdict().items()}


def _check_plan(tplan, jplan, cls):
    conv = cls.from_numpy(**_plan_fields(jplan), device="cpu")
    for f, v in tplan._asdict().items():
        other = getattr(conv, f)
        if isinstance(v, int):
            assert v == other == getattr(jplan, f), f
        else:
            assert torch.equal(v, other), f
            assert np.array_equal(v.numpy(), np.asarray(getattr(jplan, f))), f


@pytest.mark.parametrize("bits", [128, 1024])
def test_limbmm_plans_and_ops(bits):
    """const_mul, modmul_const, fold_mod and barrett_small against JAX;
    the port's own plans equal the converted JAX plans.  1024-bit
    moduli with 128-limb inputs are the 2048-bit key's p^2 fold."""
    rng = random.Random(bits)
    p = rng.getrandbits(bits) | (1 << (bits - 1)) | 1
    N = p * p
    lin = host.limbs_for_bits(2 * N.bit_length())      # a c-wide input
    Lp = host.limbs_for_bits(bits)
    d = rng.randrange(p)

    fold_t = tlm.FoldPlan.build(N, lin, device="cpu")
    fold_j = jlm.FoldPlan.build(N, lin)
    br_t = tlm.BarrettPlan.build(N, device="cpu")
    br_j = jlm.BarrettPlan.build(N)
    cm_t = tlm.ConstMulPlan.build(d, Lp, 2 * Lp, device="cpu")
    cm_j = jlm.ConstMulPlan.build(d, Lp, 2 * Lp)
    mm_t = tlm.ModMulConstPlan.build(d, p, Lp, device="cpu")
    mm_j = jlm.ModMulConstPlan.build(d, p, Lp)
    brp_t = tlm.BarrettPlan.build(p, device="cpu")
    brp_j = jlm.BarrettPlan.build(p)
    for tp, jp, cls in ((fold_t, fold_j, tlm.FoldPlan),
                        (br_t, br_j, tlm.BarrettPlan),
                        (cm_t, cm_j, tlm.ConstMulPlan),
                        (mm_t, mm_j, tlm.ModMulConstPlan)):
        _check_plan(tp, jp, cls)

    xs = [rng.getrandbits(16 * lin) for _ in range(6)] + [0, 2 ** (16 * lin) - 1]
    x = host.ints_to_limbs(xs, lin)
    got = tlm.fold_mod(_t(x), fold_t, br_t)
    assert _same(got, jlm.fold_mod(jnp.asarray(x), fold_j, br_j))
    assert host.limbs_to_ints(got.numpy()) == [v % N for v in xs]

    ys = [rng.randrange(p) for _ in range(6)] + [0, p - 1]
    y = host.ints_to_limbs(ys, Lp)
    got = tlm.const_mul(_t(y), cm_t)
    assert _same(got, jlm.const_mul(jnp.asarray(y), cm_j))
    assert host.limbs_to_ints(got.numpy()) == [v * d for v in ys]
    got = tlm.modmul_const(_t(y), mm_t, brp_t)
    assert _same(got, jlm.modmul_const(jnp.asarray(y), mm_j, brp_j))
    assert host.limbs_to_ints(got.numpy()) == [v * d % p for v in ys]

    # barrett_small on values just below its 2^28 * N bound
    zs = [rng.randrange(N << 28) for _ in range(6)] + [(N << 28) - 1, N]
    z = host.ints_to_limbs(zs, host.limbs_for_bits(N.bit_length() + 28))
    got = tlm.barrett_small(_t(z), br_t)
    assert _same(got, jlm.barrett_small(jnp.asarray(z), br_j))
    assert host.limbs_to_ints(got.numpy()) == [v % N for v in zs]
