"""The cells ``t2048.threshold_zkp`` and ``p2048.encdec_rsample`` on the
CPU at small sizes, the harness's look for a card skipped: each is
correct as it stands, its control is not, and each fault planted in its
timed path makes ``correct`` false.  Their plain reference against the
program's list functions, and the op's vectorised multiply count against
``roofline.least_mults``."""

import random

import pytest

from benchmark import harness, inputs, refpool, roofline, runner
from benchmark.ops.threshold import primes
from benchmark.ops.threshold_zkp import least_mults_many
from benchmark.reference import paillier as rp
from benchmark.reference import threshold as rth
from benchmark.reference import threshold_zkp as rz

SEED = 2 ** 33 + 54321          # past 32 signed bits, as run seeds may be

SMALL = {
    "t2048.threshold_zkp": {"config": {"primes_file":
                                       "data/safe_primes_small.json",
                                       "primes_key": "128"},
                            "traffic": {"batch": 16, "pool_batches": 2}},
    "p2048.encdec_rsample": {"config": {"key_bits": 256},
                             "traffic": {"batch": 16,
                                         "distinct_requests": 2}},
}
FAULTS = {
    "t2048.threshold_zkp": ["answer_altered", "faulty_kept",
                            "honest_dropped", "half_batch"],
    "p2048.encdec_rsample": ["answer_altered", "rng_not_reseeded",
                             "half_batch"],
}


@pytest.fixture(autouse=True)
def serial_reference(monkeypatch):
    monkeypatch.setattr(refpool, "WORKERS", 1)


def _run(cell, fault=None, trace=False):
    return runner.run_cell(cell, SEED, 0.5, trace, device="cpu", fault=fault,
                           controls=fault is None and not trace,
                           overrides=SMALL[cell])


@pytest.mark.parametrize("cell", list(SMALL))
def test_a_sound_run_is_correct_and_its_control_is_not(cell):
    out = _run(cell)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert all(v["value"] == 0 for v in out["checks"].values())
    assert any(v["value"] > v["limit"]
               for v in out["control_checks"].values())
    assert set(out["metrics"]) == {m["name"] for m in
                                   harness.load_cell(cell).end_to_end}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in FAULTS
                                        for f in FAULTS[c]])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    assert _run(cell, fault)["correct"] is False


def test_a_traced_run_reads_the_proof_spans_and_lists_its_ladders():
    """On the CPU (no device trace): the two harness spans' readers, and
    a work list of a B1 and a B2 entry a server and the combine's B2."""
    out = _run("t2048.threshold_zkp", trace=True)
    assert out["correct"] is True, out["checks"]
    assert {"tzkp_ms.prove", "tzkp_ms.verify_combine"} <= set(
        out["metrics"])
    cell = harness.load_cell("t2048.threshold_zkp")
    for part in ("config", "traffic"):
        getattr(cell, part).update(SMALL["t2048.threshold_zkp"][part])
    spans = harness.Spans(True)
    op = harness.op_module("threshold_zkp").Op(cell, SEED, "cpu", spans)
    win = harness.measure(op, 0.01, spans)
    work = op.work(op.requests[0])
    assert [w["kernel"] for w in work] == ["B1", "B2"] * 4 + ["B2"]
    assert all(w["row_mults"] > 0 and w["mod_bits"] == op.n2_bits == 512
               for w in work)
    assert len(win.records) == 1


def test_least_mults_many_is_roofline_least_mults():
    rng = random.Random(7)
    exps = [0, 1, 2, 3, 7, 8, 255, 256, 2 ** 16, 2 ** 16 - 1] + [
        rng.getrandbits(rng.randrange(1, 700)) for _ in range(400)]
    assert least_mults_many(exps).tolist() == [roofline.least_mults(e)
                                                for e in exps]


@pytest.mark.parametrize("cell", list(SMALL))
def test_the_generators_are_deterministic_per_seed(cell):
    c = harness.load_cell(cell)
    for part in ("config", "traffic"):
        getattr(c, part).update(SMALL[cell][part])
    op = harness.op_module(c.traffic["op"]).Op

    def reqs(seed):
        return [vars(r).copy() for r in op(c, seed, "cpu",
                                           harness.Spans(False)).requests]

    assert reqs(SEED) == reqs(SEED) != reqs(SEED + 1)


def test_the_reference_prover_and_verifier_match_the_programs_lists():
    """On the small key: the program's list prover gives the reference's
    (c_i, e, z) from the same generator; the reference verifier's and the
    program's verdicts agree on honest and altered proofs."""
    from paillier_tpu_torch import Encryptor
    from paillier_tpu_torch.threshold import (ThresholdKeyGenerator,
                                              partial_decrypt_with_zkp,
                                              verify_proof, verify_proofs)
    cfg = SMALL["t2048.threshold_zkp"]["config"]
    p, q = primes(cfg)
    key = rp.Key(p, q)
    tk = ThresholdKeyGenerator(
        256, 5, 3, inputs.stream(SEED, "dealer"),
        device="cpu").generate_from_primes(p, (p - 1) // 2, q, (q - 1) // 2)
    shares = rth.shares(p, q, 5, 3, inputs.stream(SEED, "dealer"))
    v, vis = rz.verification_keys(key, 5, shares,
                                  inputs.stream(SEED, "dealer"))
    rng = random.Random(3)
    ms = [rng.randrange(key.n) for _ in range(4)]
    rs = [inputs.unit(key.n, rng) for _ in range(4)]
    ct = Encryptor(tk[0].public(), device="cpu").encrypt(ms, rs)
    cs = [rp.encrypt(key, m, r) for m, r in zip(ms, rs)]
    for s in (2, 5):
        proofs = partial_decrypt_with_zkp(tk[s - 1], ct,
                                          random.Random(f"r/{s}"))
        want = rz.prove_rows(key, v, 5, shares[s - 1], f"r/{s}",
                             [0, 1, 2, 3], cs)
        assert [(x.decryption, x.e, x.z) for x in proofs] == want
        proofs[1].z += 1
        proofs[3].decryption ^= 1
        got = verify_proofs(proofs, device="cpu")
        assert got == [True, False, True, False]
        assert got == [verify_proof(x) for x in proofs] == [
            rz.verify(key, v, vis[s - 1], c, x.decryption, x.e, x.z)
            for c, x in zip(cs, proofs)]
