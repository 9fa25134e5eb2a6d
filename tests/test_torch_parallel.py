"""The port's multi-device sharding (``paillier_tpu_torch.parallel`` and
DDLEQ's ``mesh=``) against the JAX package's ``paillier_tpu.parallel``,
both on the CPU.

torch needs one process a rank: each test's ranks are spawned processes
on one gloo process group (``tests/torch_ranks.py``, which imports no
JAX; every rank checks that JAX stays out of it).  The JAX side runs in
this process on the 8-device virtual CPU mesh of tests/conftest.py.
Inputs come from seeds at 128 bits (64-bit (4, 3) threshold keys):
shard_batch's blocks equal the JAX mesh's addressable shards;
sharded_aggregate on 2 and 4 ranks, levels 1 and 2, equals the JAX
function and the single-process ``aggregate``; distributed_combine on a
(2 servers x 2 batch) mesh equals the JAX function on its (4 x 2) mesh
and the plaintexts; DDLEQ proofs with ``mesh=`` on 2 ranks, with and
without the CRT split, are bit-identical to the single-process proofs
(which tests/test_torch_ddleq.py holds to the JAX package's).  Each
fixture spawns its ranks once.  Tolerance: none (every value is an
integer).
"""

import dataclasses
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paillier_tpu_torch as pt
from paillier_tpu.core.keygen import keygen as jkeygen
from paillier_tpu.core.keys import Ciphertext as JCiphertext
from paillier_tpu.core.keys import decode_batch as jdecode
from paillier_tpu.parallel import collective as jcol
from paillier_tpu.parallel import mesh as jmesh
from paillier_tpu.threshold import keys as jtkeys
from paillier_tpu_torch.core.keys import Ciphertext, decode_batch
from paillier_tpu_torch.parallel import mesh as pm
from paillier_tpu_torch.threshold import (ThresholdKeyGenerator,
                                          compute_lambda, lagrange_powers,
                                          partial_decrypt_all)
from paillier_tpu_torch.zk import ddleq as zd
from torch_ranks import (aggregate_body, bodies, combine_body, ddleq_body,
                         mesh_body, run_ranks)

torch.set_num_threads(2)

CPU = "cpu"
BATCH = 16                 # divides 2, 4 and the JAX package's 8 devices
SECPAR = 8
FIELDS = ("x", "y", "alpha", "e", "f")
CHUNKS = (1, 2, 1)         # pipeline: 3 chunks for 2 workers


def _jlimbs(t):
    return jnp.asarray(np.asarray(t).astype(np.uint32))


@pytest.fixture(scope="module")
def key128():
    sk, pk = pt.keygen(128, random.Random(0xA66), device=CPU)
    jsk, jpk = jkeygen(128, random.Random(0xA66))
    assert (sk.n, sk.p, sk.q) == (jsk.n, jsk.p, jsk.q)
    return sk, pk, jpk


@pytest.fixture(scope="module")
def four(key128, tmp_path_factory):
    """One spawn of 4 ranks: the meshes, sharded_aggregate at levels 1
    and 2, and distributed_combine on (2 servers x 2 batch)."""
    sk, pk, _ = key128
    rng = random.Random(0xA67)
    vals = [rng.randrange(10_000) for _ in range(BATCH)]
    cts = {1: pt.Encryptor(pk, 1, rng=rng, device=CPU).encrypt(vals).c,
           2: pt.Encryptor(pk, 2, rng=rng, device=CPU).encrypt(vals).c}
    keys = ThresholdKeyGenerator(64, 4, 3, random.Random(0xA68),
                                 device=CPU).generate()
    tpk = keys[0].public()
    ms = [rng.randrange(tpk.n) for _ in range(4)]
    tct = pt.Encryptor(tpk, 1, rng=rng, device=CPU).encrypt(ms).c
    x = np.arange(BATCH * 3, dtype=np.int64).reshape(BATCH, 3)
    fresh = [dataclasses.replace(k) for k in keys]
    out = run_ranks(bodies, 4, [
        (mesh_body, (x,)),
        (aggregate_body, (dataclasses.replace(pk), {lv: c.numpy()
                                                    for lv, c in cts.items()},
                          CPU)),
        (combine_body, (fresh, tct.numpy(), 2, CPU))],
        init_dir=tmp_path_factory.mktemp("four"), timeout=120)
    return dict(x=x, vals=vals, cts=cts, keys=keys, ms=ms, tct=tct,
                mesh=[r[0] for r in out], agg=[r[1] for r in out],
                combine=[r[2] for r in out])


@pytest.fixture(scope="module")
def two(key128, four, tmp_path_factory):
    """One spawn of 2 ranks: sharded_aggregate at levels 1 and 2 and the
    DDLEQ checks of ``ddleq_body`` on two nested ciphertexts."""
    sk, pk, _ = key128
    rng = random.Random(0xA69)
    ct1 = pt.nested_encrypt(pk, [rng.randrange(pk.n) for _ in range(2)], rng,
                            device=CPU)
    ct2, a_l, b_l = pt.homomorphic.nested_randomize(pk, ct1, rng)
    out = run_ranks(bodies, 2, [
        (aggregate_body, (dataclasses.replace(pk),
                          {lv: c.numpy() for lv, c in four["cts"].items()},
                          CPU)),
        (ddleq_body, (dataclasses.replace(sk), ct1.c.numpy(), ct2.c.numpy(),
                      a_l, b_l, SECPAR, 0xA6A, CHUNKS, CPU))],
        init_dir=tmp_path_factory.mktemp("two"), timeout=120)
    return dict(ct1=ct1, ct2=ct2, a=a_l, b=b_l, agg=[r[0] for r in out],
                ddleq=[r[1] for r in out])


# ---------------------------------------------------------------------------
# mesh
# ---------------------------------------------------------------------------

def test_make_mesh_errors_in_one_process():
    """Devices that do not divide into server groups raise JAX's
    ValueError; without a process group make_mesh names what it needs."""
    with pytest.raises(ValueError, match="6 devices not divisible into 4 "
                       "server groups"):
        pm.make_mesh(6, servers=4, device_type=CPU)
    with pytest.raises(RuntimeError, match="process group"):
        pm.make_mesh(device_type=CPU)
    cfg = pt.Config()
    assert (cfg.mesh_devices, cfg.mesh_servers) == (None, None)


def test_mesh_shapes_and_coordinates(four):
    """1-D ("batch",) over the 4 ranks; (2, 2) ("servers", "batch") with
    rank r at (r // 2, r % 2), as the JAX package lays out its devices;
    Config(mesh_servers=2) gives the 2-D mesh by default; no rank
    imported JAX."""
    for r, m in enumerate(four["mesh"]):
        assert (m["1d"]["shape"], m["1d"]["names"], m["1d"]["coord"]) == (
            (4,), ("batch",), (r,))
        assert (m["2d"]["shape"], m["2d"]["names"], m["2d"]["coord"]) == (
            (2, 2), ("servers", "batch"), (r // 2, r % 2))
        assert m["config_shape"] == (2, 2)
        assert m["jax"] is False
    j2 = jmesh.make_mesh(4, servers=2)
    assert dict(j2.shape) == {"servers": 2, "batch": 2}
    assert [d.id for d in j2.devices.flat] == [0, 1, 2, 3]


@pytest.mark.parametrize("kind", ["1d", "2d"])
def test_shard_batch_blocks_equal_jax_shards(four, kind):
    """Rank r's shard_batch block is the shard of JAX's
    shard_batch(...).addressable_shards on device r, on the 1-D mesh of
    4 devices and on the (2 x 2) mesh (replicated over servers)."""
    jm = (jmesh.make_mesh(4) if kind == "1d"
          else jmesh.make_mesh(4, servers=2))
    shards = {s.device.id: np.asarray(s.data)
              for s in jmesh.shard_batch(jnp.asarray(four["x"]),
                                         jm).addressable_shards}
    assert sorted(shards) == [0, 1, 2, 3]
    for r, m in enumerate(four["mesh"]):
        assert np.array_equal(m[kind]["block"], shards[r])


def test_shard_batch_and_mesh_errors(four):
    """A batch that does not divide the batch axis, and a mesh larger
    than the process group, raise ValueError on every rank."""
    for m in four["mesh"]:
        assert m["indivisible"] == ("batch 5 does not divide the mesh's 4 "
                                    "batch shards")
        assert m["too_many"] == ("5 devices asked for, the process group "
                                 "has 4 ranks")


# ---------------------------------------------------------------------------
# sharded_aggregate
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_aggregates(key128, four):
    """JAX's sharded_aggregate of each level's batch on its 8-device
    mesh, decoded."""
    _, _, jpk = key128
    mesh = jmesh.make_mesh()
    out = {}
    for level, c in four["cts"].items():
        jct = JCiphertext(c=jmesh.shard_batch(_jlimbs(c), mesh), level=level)
        agg = jcol.sharded_aggregate(jpk, jct, mesh)
        out[level] = jdecode(agg.c[None])[0]
    return out


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("level", [1, 2])
def test_sharded_aggregate_vs_jax(key128, four, two, jax_aggregates, ranks,
                                  level):
    """Every rank's sharded_aggregate is the product of the whole batch:
    equal to JAX's sharded_aggregate on 8 devices, to the port's
    single-process aggregate and to the product of the plaintexts."""
    sk, pk, _ = key128
    got = (four if ranks == 4 else two)["agg"]
    single = decode_batch(pt.homomorphic.aggregate(
        pk, Ciphertext(c=four["cts"][level], level=level)).c[None])[0]
    assert single == jax_aggregates[level]
    for r in got:
        assert r["sums"][level] == single
        assert r["on_device"]
        assert r["launches"] == {"B1": 0, "B2": 0, "B3": 0, "B4": 0,
                                  "SHA": 0}
    dec = pt.Decryptor(sk, level, device=CPU)
    assert dec.decrypt(Ciphertext(
        c=pt.encode_batch([single], four["cts"][level].shape[-1],
                           device=CPU),
        level=level)) == [sum(four["vals"])]


# ---------------------------------------------------------------------------
# distributed_combine
# ---------------------------------------------------------------------------

def test_distributed_combine_vs_jax(four):
    """(2 servers x 2 batch) on 4 ranks, each rank's servers decrypting
    its batch block: every rank returns the plaintexts, equal to JAX's
    distributed_combine on its (4 servers x 2 batch) mesh over the same
    Lagrange powers."""
    keys, ms = four["keys"], four["ms"]
    tpk = keys[0].public()
    ids = [k.id for k in keys]
    lam2 = [2 * compute_lambda(tpk, i, ids) for i in ids]
    pds = partial_decrypt_all(keys, Ciphertext(c=four["tct"]))
    powed = lagrange_powers(tpk, torch.stack([p.c for p in pds]),
                            [abs(v) for v in lam2])
    jtpk = jtkeys.ThresholdPublicKey(
        n=tpk.n, g=tpk.g, h=tpk.h, k=tpk.k, bits=tpk.bits, l=tpk.l, t=tpk.t,
        v=tpk.v, vi=tuple(tpk.vi))
    mesh = jmesh.make_mesh(8, servers=4)
    jgot = jcol.distributed_combine(jtpk, _jlimbs(powed), [
        1 if v >= 0 else -1 for v in lam2], mesh)
    assert jgot == ms
    for r in four["combine"]:
        assert r["plain"] == ms
        assert r["launches"] == {"B1": 0, "B2": 0, "B3": 0, "B4": 0,
                                  "SHA": 0}


# ---------------------------------------------------------------------------
# DDLEQ with mesh=
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def single_proofs(key128, two):
    """The port's single-process proofs of the same chunk and seed."""
    sk = key128[0]
    return {crt: zd.prove(sk, two["ct1"], two["ct2"], two["a"], two["b"],
                          SECPAR, random.Random(0xA6A), use_crt=crt)
            for crt in (True, False)}


@pytest.mark.parametrize("crt", [True, False])
def test_sharded_proofs_equal_single_process(two, single_proofs, crt):
    """On 2 ranks, with and without the p^3/q^3 split, every rank holds a
    proof bit-identical to the single-process proof from the same seed."""
    for r in two["ddleq"]:
        for f in FIELDS:
            assert np.array_equal(r["proofs"][crt][f],
                                  getattr(single_proofs[crt], f).numpy()), f


def test_sharded_verify_and_tamper(key128, two, single_proofs):
    """verify(mesh=) accepts both proofs; with instance (1, 3) of e
    tampered only proof 1 fails, as JAX's sharded verify does; the
    single-process verifier agrees."""
    pk = key128[1]
    for r in two["ddleq"]:
        assert r["ok"] == [True, True]
        assert r["bad"] == [True, False]
    assert zd.verify(pk, two["ct1"], two["ct2"],
                     single_proofs[True]) == [True, True]


def test_flat_batch_must_divide_the_mesh(two):
    """One proof of 3 instances on 2 ranks raises JAX's ValueError."""
    for r in two["ddleq"]:
        assert r["flat_err"] == ("flat batch 3 must divide the 2-device mesh "
                                 "(pad the proof batch)")


def test_sharded_pipeline(two):
    """pipeline_prove_verify(mesh=) over 3 chunks with 2 workers (chunk
    j on worker j mod 2, each worker on a group of its own): every
    chunk's proofs verify, in order, on every rank."""
    for r in two["ddleq"]:
        assert r["piped"] == [[True] * k for k in CHUNKS]

