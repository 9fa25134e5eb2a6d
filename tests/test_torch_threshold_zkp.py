"""The port's batched share-decryption proofs
(``partial_decrypt_with_zkp_batch``, ``verify_proofs_batch``,
``combine_with_zkp_batch``) against its list functions and against the
benchmark's plain reference (``benchmark/reference/threshold_zkp.py``:
Python integers and hashlib), on the CPU.

The key is a (3, 5)-threshold key on the benchmark's fixed 64-bit safe
primes (a 128-bit n), its dealer's draws from a seed; ciphertexts are
encrypted under it with seeded plaintexts and randomness.  A tampered
server has the low bit of one row's partial decryption flipped after
proving, as the benchmark's faulty server does.  Tolerance: none (every
value is an integer).
"""

import dataclasses
import json
import random
from pathlib import Path

import pytest
import torch

import paillier_tpu_torch as pt
from benchmark.reference import paillier as rp
from benchmark.reference import threshold as rth
from benchmark.reference import threshold_zkp as rz
from paillier_tpu_torch.ops import profiling
from paillier_tpu_torch.threshold import decrypt as tdec
from paillier_tpu_torch.threshold import keygen as tkg
from paillier_tpu_torch.threshold import zkp as tzkp

torch.set_num_threads(2)

CPU = "cpu"
ROWS = 6
PRIMES = json.loads((Path(__file__).resolve().parents[1] / "benchmark"
                     / "data" / "safe_primes_small.json").read_text())["64"]


@pytest.fixture(scope="module")
def flow():
    """The keys, the plain reference's key, shares and verification
    keys from the same dealer seed, and ROWS ciphertexts."""
    p, q = int(PRIMES["p"], 16), int(PRIMES["q"], 16)
    tk = tkg.ThresholdKeyGenerator(
        128, 5, 3, random.Random(0xD1), device=CPU).generate_from_primes(
            p, (p - 1) // 2, q, (q - 1) // 2)
    key = rp.Key(p, q)
    shares = rth.shares(p, q, 5, 3, random.Random(0xD1))
    v, vis = rz.verification_keys(key, 5, shares, random.Random(0xD1))
    tpk = tk[0].public()
    rng = random.Random(0xC7)
    ms = [rng.randrange(tpk.n) for _ in range(ROWS - 2)] + [0, 1]
    ct = pt.Encryptor(tpk, device=CPU, rng=rng).encrypt(ms)
    return dict(tk=tk, tpk=tpk, key=key, shares=shares, v=v, vis=vis,
                ms=ms, ct=ct)


def _rngs(ids, seed=0x2C0):
    return [random.Random(seed + i) for i in ids]


def _prove(flow, ids, seed=0x2C0):
    return tzkp.partial_decrypt_with_zkp_batch(
        [flow["tk"][i - 1] for i in ids], flow["ct"], _rngs(ids, seed))


def _ints(x):
    return pt.decode_batch(x)


def test_reference_keys_are_the_programs(flow):
    """The reference works out the same shares, v and v_i from the
    dealer's seed as the program's key generator."""
    tk = flow["tk"]
    assert [k.share for k in tk] == flow["shares"]
    assert tk[0].v == flow["v"] and list(tk[0].vi) == flow["vis"]


@pytest.mark.parametrize("ids", [(1, 2, 3, 4), (5, 2)])
def test_batch_proofs_equal_the_list_path(flow, ids):
    """Each server's batch holds, bit for bit, the (c_i, e, z, c) of
    partial_decrypt_with_zkp from the same generator, whether proven
    alone or stacked with other servers."""
    batches = _prove(flow, ids)
    assert [b.id for b in batches] == list(ids)
    for b, i in zip(batches, ids):
        want = tzkp.partial_decrypt_with_zkp(flow["tk"][i - 1], flow["ct"],
                                             random.Random(0x2C0 + i))
        assert b.c.shape == b.ci.shape == (ROWS, 16)
        assert b.e.shape == (ROWS, 16)
        assert (_ints(b.ci), _ints(b.e), _ints(b.z), _ints(b.c)) == (
            [p.decryption for p in want], [p.e for p in want],
            [p.z for p in want], [p.c for p in want])
        assert all(tzkp.verify_proof(p) for p in want)


def test_batch_proofs_equal_the_plain_reference(flow):
    """(c_i, e, z) of every row against the reference prover with the
    same draws of r."""
    key, ms = flow["key"], flow["ms"]
    cs = _ints(flow["ct"].c)
    for b in _prove(flow, (1, 3, 4)):
        want = rz.prove_rows(key, flow["v"], 5, flow["shares"][b.id - 1],
                             0x2C0 + b.id, list(range(ROWS)), cs)
        assert list(zip(_ints(b.ci), _ints(b.e), _ints(b.z))) == want
        assert rp.decrypt(key, cs[0]) == ms[0]


def _tampered(batch, row, field="ci"):
    x = getattr(batch, field).clone()
    x[row, 0] ^= 1
    return dataclasses.replace(batch, **{field: x})


@pytest.mark.parametrize("field", ["ci", "e", "z"])
def test_verify_proofs_batch_agrees_with_verify_proofs(flow, field):
    """Honest rows verify; a row with its share, challenge or response
    changed does not, in the batch verifier, the list verifier, the host
    verifier and the reference's."""
    b = _prove(flow, (2,))[0]
    assert tzkp.verify_proofs_batch(b).tolist() == [True] * ROWS
    bad = _tampered(b, 1, field)
    got = tzkp.verify_proofs_batch(bad).tolist()
    assert got == [True, False] + [True] * (ROWS - 2)
    proofs = tzkp._to_list(bad)
    assert tzkp.verify_proofs(proofs, device=CPU) == got
    assert [tzkp.verify_proof(p) for p in proofs] == got
    cs = _ints(b.c)
    assert [rz.verify(flow["key"], flow["v"], flow["vis"][1], c, p.decryption,
                      p.e, p.z) for c, p in zip(cs, proofs)] == got


def test_verify_proofs_takes_several_servers_in_one_list(flow):
    """verify_proofs on proofs of three servers interleaved, one of them
    tampered, gives each proof its own verdict."""
    lists = [tzkp._to_list(b) for b in _prove(flow, (1, 4, 5))]
    lists[1][2] = dataclasses.replace(lists[1][2], z=lists[1][2].z + 1)
    mixed = [p for row in zip(*lists) for p in row]
    want = [tzkp.verify_proof(p) for p in mixed]
    assert want.count(False) == 1
    assert tzkp.verify_proofs(mixed, device=CPU) == want


def test_combine_with_zkp_batch_drops_exactly_the_tampered_server(flow):
    batches = _prove(flow, (1, 2, 3, 4))
    batches[2] = _tampered(batches[2], 3)
    out = tzkp.combine_with_zkp_batch(flow["tpk"], batches)
    assert out.dropped == [3] and out.kept == [1, 2, 4]
    assert [v.tolist() for v in out.verdicts] == [
        [True] * ROWS, [True] * ROWS,
        [True] * 3 + [False] + [True] * (ROWS - 4), [True] * ROWS]
    assert out.plaintexts == flow["ms"]
    cis = {b.id: _ints(b.ci) for b in batches if b.id != 3}
    assert [rz.combine(flow["key"], 5, {i: cis[i][j] for i in cis})
            for j in range(ROWS)] == flow["ms"]
    # the list function gives the same plaintexts
    lists = [tzkp._to_list(b) for b in batches]
    assert tzkp.combine_with_zkp(flow["tpk"], lists, device=CPU) == \
        flow["ms"]


def test_combine_with_zkp_batch_raises_below_the_threshold(flow):
    batches = _prove(flow, (1, 2, 3, 4))
    batches[0] = _tampered(batches[0], 0)
    batches[1] = _tampered(batches[1], 5, "e")
    with pytest.raises(ValueError, match="Threshold not meet"):
        tzkp.combine_with_zkp_batch(flow["tpk"], batches)


def test_the_reference_combiner_drops_the_same_server(flow):
    """combine_with_proofs of the reference on one row: the tampered
    server's proof fails, the plaintext of the other three."""
    batches = _prove(flow, (1, 2, 4, 5))
    batches[3] = _tampered(batches[3], 0)
    cs = _ints(batches[0].c)
    proofs = {b.id: (_ints(b.ci)[0], _ints(b.e)[0], _ints(b.z)[0])
              for b in batches}
    vis = dict(enumerate(flow["vis"], start=1))
    verdicts, dropped, m = rz.combine_with_proofs(
        flow["key"], flow["v"], vis, 5, 3, cs[0], proofs)
    assert dropped == [5] and m == flow["ms"][0]
    out = tzkp.combine_with_zkp_batch(flow["tpk"], batches)
    assert out.dropped == dropped
    assert {b.id: bool(v[0]) for b, v in zip(batches, out.verdicts)} == \
        verdicts


def test_counters_count_rows_verified_and_servers_dropped(flow):
    batches = _prove(flow, (1, 2, 3, 4))
    batches[1] = _tampered(batches[1], 2, "z")
    before = profiling.take()["counters"]
    tzkp.verify_proofs_batch(batches[0])
    tzkp.combine_with_zkp_batch(flow["tpk"], batches)
    after = profiling.take()["counters"]
    assert after["zkp.rows_verified"] - before.get(
        "zkp.rows_verified", 0) == 5 * ROWS
    assert after["zkp.servers_dropped"] - before.get(
        "zkp.servers_dropped", 0) == 1
    assert "launch.B2" in after


def test_the_batch_path_records_its_spans(flow):
    """Under a profiler: the roots zkp_prove and zkp_combine, zkp_verify
    and combine inside zkp_combine, the r draws and the inverses as
    host_int, the hash as hash."""
    from torch.profiler import ProfilerActivity, profile
    profiling.take()
    with profile(activities=[ProfilerActivity.CPU]):
        batches = _prove(flow, (1, 2, 3))
        tzkp.combine_with_zkp_batch(flow["tpk"], batches)
    rec = profiling.take()
    spans = rec["spans"]
    roots = [s["name"] for s in spans if s["parent"] == -1]
    assert roots == ["zkp_prove", "zkp_combine"]
    by_root = {}
    for s in spans:
        root = next(r for r in spans if r["id"] == s["root"])
        by_root.setdefault(root["name"], set()).add(
            (s["name"], s["attrs"].get("op")))
    assert {("partial", None), ("host_int", "zkp_r"), ("hash", None),
            ("encode", None)} <= by_root["zkp_prove"]
    assert {("zkp_verify", None), ("combine", None), ("decode", None),
            ("host_int", "modinv"), ("hash", None)} <= \
        by_root["zkp_combine"]
    assert tdec.PartialDecryptionZKPBatch is type(batches[0])
