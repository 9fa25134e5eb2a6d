"""The port's batched SHA-256 (``paillier_tpu_torch.ops.sha256``) and
random oracle (``ops/oracle.py``) against hashlib and the JAX package's
``paillier_tpu.ops.sha256`` / ``ops.oracle``, on the CPU.

Messages are seeded random bytes of 0-300 bytes with the padding edges
(55, 56, 63, 64, 119 bytes) among them; limbs are seeded random integers
with zero rows and mixed lengths, given to both packages.  Tolerance:
none (bytes, lengths and digests are integers).
"""

import hashlib
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paillier_tpu.bigint import host as jhost
from paillier_tpu.ops import oracle as joracle
from paillier_tpu.ops import sha256 as jsha
from paillier_tpu_torch.ops import oracle
from paillier_tpu_torch.ops import sha256 as sha

torch.set_num_threads(2)

EDGES = [0, 1, 3, 55, 56, 63, 64, 119, 120, 128]


def _ref(m: bytes) -> int:
    return int.from_bytes(hashlib.sha256(m).digest(), "big")


def _batch(msgs, W):
    data = np.zeros((len(msgs), W), np.int64)
    for i, m in enumerate(msgs):
        data[i, :len(m)] = np.frombuffer(m, np.uint8)
    return data, np.asarray([len(m) for m in msgs], np.int64)


@pytest.mark.parametrize("W", [128, 300])
def test_sha256_bytes_vs_hashlib(W):
    """Rows of 0-W bytes in a W-byte buffer (3 and 5 blocks)."""
    rng = random.Random(W)
    msgs = [bytes(rng.getrandbits(8) for _ in range(n)) for n in EDGES]
    msgs += [bytes(rng.getrandbits(8) for _ in range(rng.randrange(W + 1)))
             for _ in range(14)]
    data, lens = _batch(msgs, W)
    got = sha.sha256_bytes(torch.as_tensor(data), torch.as_tensor(lens))
    assert got.dtype == torch.int64 and tuple(got.shape) == (len(msgs), 8)
    assert sha.digest_to_ints(got) == [_ref(m) for m in msgs]


def test_sha256_bytes_vs_jax():
    """The same bytes through both packages: the same digest words."""
    rng = random.Random(0x5B)
    msgs = [bytes(rng.getrandbits(8) for _ in range(n))
            for n in (0, 55, 56, 64, 119, 200)]
    data, lens = _batch(msgs, 200)
    got = sha.sha256_bytes(torch.as_tensor(data), torch.as_tensor(lens))
    want = jsha.sha256_bytes(jnp.asarray(data.astype(np.uint32)),
                             jnp.asarray(lens.astype(np.int32)))
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    assert sha.digest_to_ints(got) == jsha.digest_to_ints(want)


def _limb_rows(rng, L):
    xs = [rng.getrandbits(rng.randrange(1, 16 * L)) for _ in range(9)]
    return xs + [0, 1, 255, 256, (1 << (16 * L)) - 1, 0]


def test_limbs_to_be_bytes_vs_jax():
    rng = random.Random(0x5C)
    L = 8
    xs = _limb_rows(rng, L)
    limbs = jhost.ints_to_limbs(xs, L)
    be, ln = sha.limbs_to_be_bytes(torch.as_tensor(limbs.astype(np.int64)))
    jbe, jln = jsha.limbs_to_be_bytes(jnp.asarray(limbs))
    assert np.array_equal(be.numpy(), np.asarray(jbe).astype(np.int64))
    assert ln.tolist() == np.asarray(jln).tolist()
    for i, x in enumerate(xs):
        gb = oracle.go_bytes(x)
        assert int(ln[i]) == len(gb)
        assert bytes(be[i, 2 * L - len(gb):].tolist()) == gb


def test_concat_be_and_zkp_hash_vs_jax():
    """a || b || c^4 || c_i^2 of mixed widths and lengths (zero rows
    included): the port's buffer and lengths equal JAX's, and its digest
    equals the host zkp_hash of both packages."""
    rng = random.Random(0x5D)
    widths = (8, 8, 32, 16)
    cols = [_limb_rows(rng, w) for w in widths]
    tparts, jparts = [], []
    for xs, w in zip(cols, widths):
        limbs = jhost.ints_to_limbs(xs, w)
        tparts.append(sha.limbs_to_be_bytes(
            torch.as_tensor(limbs.astype(np.int64))))
        jparts.append(jsha.limbs_to_be_bytes(jnp.asarray(limbs)))
    out_len = 2 * sum(widths)
    buf, total = sha.concat_be(tparts, out_len)
    jbuf, jtotal = jsha.concat_be(jparts, out_len)
    assert np.array_equal(buf.numpy(), np.asarray(jbuf).astype(np.int64))
    assert total.tolist() == np.asarray(jtotal).tolist()
    got = sha.digest_to_ints(sha.sha256_bytes(buf, total))
    quads = list(zip(*cols))
    assert got == [oracle.zkp_hash(*q) for q in quads]
    assert got == [joracle.zkp_hash(*q) for q in quads]


def test_oracle_vs_jax():
    rng = random.Random(0x5E)
    for _ in range(8):
        vals = [rng.getrandbits(rng.randrange(0, 600)) for _ in range(4)]
        vals[rng.randrange(4)] = 0
        assert oracle.go_bytes(vals[0]) == joracle.go_bytes(vals[0])
        assert oracle.oracle_digest(*vals) == joracle.oracle_digest(*vals)
        assert oracle.oracle_bit(*vals) == joracle.oracle_bit(*vals)
        assert oracle.zkp_hash(*vals) == joracle.zkp_hash(*vals)
    assert oracle.go_bytes(0) == b"" and oracle.go_bytes(256) == b"\x01\x00"
    # the reference skips the oracle's first input (random_oracle.go:24-26)
    assert oracle.oracle_digest(5, 7) == oracle.oracle_digest(9, 7) \
        == hashlib.sha256(b"\x07").digest()


def test_cpu_ddleq_hashes_on_the_plain_version(monkeypatch):
    """A DDLEQ prove and verify on the CPU (128-bit key, 2 proofs x 4
    instances) take the plain version, once each, and launch no kernel:
    ``launch.SHA`` is among ``profiling.take()``'s counters and reads 0."""
    import paillier_tpu_torch as pt
    from paillier_tpu_torch.ops import profiling
    from paillier_tpu_torch.zk import ddleq as zd
    calls = []
    plain = sha.sha256_bytes_plain

    def counted(data, lengths):
        calls.append(tuple(data.shape))
        return plain(data, lengths)

    monkeypatch.setattr(sha, "sha256_bytes_plain", counted)
    sk, pk = pt.keygen(128, random.Random(0x5F), device="cpu")
    rng = random.Random(0x5F1)
    ct1 = pt.nested_encrypt(pk, [rng.randrange(pk.n) for _ in range(2)],
                            rng, device="cpu")
    ct2, a_l, b_l = pt.homomorphic.nested_randomize(pk, ct1, rng)
    proof = zd.prove(sk, ct1, ct2, a_l, b_l, 4, rng)
    assert zd.verify(pk, ct1, ct2, proof) == [True, True]
    L = pk.device("cpu").L
    assert calls == [(8, 16 * L)] * 2          # c2 || x || y || alpha
    counters = profiling.take()["counters"]
    assert counters["launch.SHA"] == 0 == sha.sha256_bytes.launches


def test_sha256_bytes_refuses_other_devices():
    """A tensor on neither the CPU nor a CUDA card raises; nothing falls
    back to the plain version."""
    data = torch.zeros((2, 64), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        sha.sha256_bytes(data, torch.zeros(2, dtype=torch.int64,
                                           device="meta"))
