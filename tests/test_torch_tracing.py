"""The port's span recorder (``ops/profiling.py``: ``span``, ``take``,
``merge``, and the span track that ``trace`` writes), on the CPU, or on
the card where one is present (decided inside the tests).

* Without a profiler nothing is recorded, and the launch counters count
  as they did.
* Under ``torch.profiler`` (CPU activity): ``Encryptor.encrypt`` then
  ``Decryptor.decrypt`` give one root each with their stages as
  children (parents, shared root ids, nesting in time), at most 128
  spans a call; ``threshold.combine`` records its host big-integer work;
  a DDLEQ proof stays within 128 spans; two threads keep separate
  stacks; ``take()`` clears; the spans add no event to the profiler's
  results; ``trace`` writes them on its own clock.
* ``run_ranks`` on two gloo ranks returns what it returned before, and
  brings each rank's record back tagged with its rank.

Tolerance: exact (names, counts, parents); times only in their order,
and the span track against a ``record_function`` window to 1 ms.
"""

import dataclasses
import json
import random
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import paillier_tpu_torch as pt
from paillier_tpu_torch.bigint import cuda_build, sliding_kernel
from paillier_tpu_torch.core import homomorphic as hom
from paillier_tpu_torch.ops import profiling
from paillier_tpu_torch.threshold import (ThresholdKeyGenerator, combine,
                                          partial_decrypt_all)
from paillier_tpu_torch.zk import ddleq as zd
from torch_ranks import run_ranks, traced_ddleq_body

torch.set_num_threads(2)

NAMES = {"encrypt", "decrypt", "const_mult", "aggregate", "add", "partial",
         "combine", "prove", "verify", "encode", "decode", "host_int",
         "ladder", "hash", "gather"}
MAX_SPANS = 128             # spans an API call: none inside a per-row loop
SECPAR = 8


@pytest.fixture(scope="module")
def dev():
    return "cuda" if torch.cuda.is_available() else "cpu"


@pytest.fixture(scope="module")
def key(dev):
    sk, pk = pt.keygen(128, random.Random(0x7A1), device=dev)
    enc = pt.Encryptor(pk, 1, rng=random.Random(0x7A2), device=dev)
    dec = pt.Decryptor(sk, 1, crt=True, device=dev)
    dec.decrypt(enc.encrypt([1, 2]))          # engines and plans built
    return sk, pk, enc, dec


@pytest.fixture(autouse=True)
def empty_record():
    profiling.take()
    yield
    profiling.take()


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, profiling.take(), prof


def _check_tree(spans):
    """Parents precede and enclose their children, on the same thread
    and under the same root; a root's root is itself."""
    for s in spans:
        assert s["start_ns"] <= s["end_ns"]
        if s["parent"] < 0:
            assert s["root"] == s["id"]
            continue
        p = spans[s["parent"]]
        assert spans.index(p) < spans.index(s)
        assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"]
        assert (p["root"], p["thread"]) == (s["root"], s["thread"])


def _children(spans, root):
    i = spans.index(root)
    return Counter((s["name"], s["attrs"].get("kernel", s["attrs"].get("op")))
                   for s in spans if s["parent"] == i)


def _per_call(spans):
    return Counter(s["root"] for s in spans)


def test_nothing_recorded_without_a_profiler(key, dev):
    sk, pk, enc, dec = key
    w = sliding_kernel.rns2_pow_sliding_b1
    before = profiling.take()["counters"]
    assert before["launch.B1"] == w.launches
    assert profiling.span("encrypt") is profiling.span("ladder", kernel="B1")
    ms = [3, 1, 4, 1]
    assert dec.decrypt(enc.encrypt(ms)) == ms
    rec = profiling.take()
    assert rec["spans"] == [] and rec["ranks"] == []
    assert rec["anchor_ns"] is None and rec["rank"] == 0
    b1 = 3 if dev == "cuda" else 0            # encrypt 1, CRT decrypt 2
    assert rec["counters"]["launch.B1"] == before["launch.B1"] + b1
    cuda_build.count_launch(w)
    try:
        assert profiling.take()["counters"]["launch.B1"] == w.launches == \
            before["launch.B1"] + b1 + 1
    finally:
        w.launches -= 1


def test_encrypt_then_decrypt_one_root_each(key):
    sk, pk, enc, dec = key
    ms = [5, 9, 2, 6, 5, 3]
    out, rec, _ = _traced(lambda: dec.decrypt(enc.encrypt(ms)))
    assert out == ms
    spans = rec["spans"]
    _check_tree(spans)
    roots = [s for s in spans if s["parent"] < 0]
    assert [s["name"] for s in roots] == ["encrypt", "decrypt"]
    assert roots[0]["end_ns"] <= roots[1]["start_ns"]
    assert _children(spans, roots[0]) == {("encode", None): 2,
                                          ("host_int", "units"): 1,
                                          ("ladder", "B1"): 1}
    assert _children(spans, roots[1]) == {("ladder", "B1"): 2,
                                          ("decode", None): 1}
    assert {s["root"] for s in spans} == {r["id"] for r in roots}
    assert max(_per_call(spans).values()) <= MAX_SPANS
    assert {s["thread"] for s in spans} == {threading.get_ident()}
    assert all(s["attrs"]["rows"] == len(ms) for s in spans
               if s["name"] in ("encode", "decode"))
    # the anchor puts perf_counter_ns on the Unix epoch of the profiler
    now = time.time_ns() - time.perf_counter_ns()
    assert abs(rec["anchor_ns"] - now) < 10 ** 8


def test_decrypt_array_and_nested_roots(key):
    """decrypt_array is one root too; a root opened inside another span
    is a child like any other."""
    sk, pk, enc, dec = key
    ct = enc.encrypt([7, 8])
    _, rec, _ = _traced(lambda: dec.decrypt_array(ct))
    assert [s["name"] for s in rec["spans"] if s["parent"] < 0] == \
        ["decrypt"]
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("outer"):
            enc.encrypt([1])
    spans = profiling.take()["spans"]
    _check_tree(spans)
    assert spans[0]["name"] == "outer" and spans[1]["name"] == "encrypt"
    assert spans[1]["parent"] == 0 and spans[1]["root"] == spans[0]["id"]


def test_homomorphic_roots(key):
    sk, pk, enc, dec = key
    ct = enc.encrypt([1, 2, 3, 4])
    w = [3, 70000, 5, 11]

    def ops():
        cm = hom.const_mult(pk, ct, w)
        agg = hom.aggregate(pk, cm)
        return hom.add(pk, agg, agg)

    out, rec, _ = _traced(ops)
    assert dec.decrypt(pt.Ciphertext(c=out.c[None]))[0] == \
        2 * sum(a * b for a, b in zip([1, 2, 3, 4], w)) % pk.n
    spans = rec["spans"]
    _check_tree(spans)
    roots = [s for s in spans if s["parent"] < 0]
    assert [s["name"] for s in roots] == ["const_mult", "aggregate", "add"]
    assert _children(spans, roots[0]) == {("host_int", "exp_digits"): 1,
                                          ("ladder", "B2"): 1}
    assert max(_per_call(spans).values()) <= MAX_SPANS


def test_threshold_combine_records_host_int(dev):
    keys = ThresholdKeyGenerator(64, 4, 3, random.Random(0x7A3),
                                 device=dev).generate()
    tpk = keys[0].public()
    rng = random.Random(0x7A4)
    ms = [rng.randrange(tpk.n) for _ in range(4)]
    ct = pt.Encryptor(tpk, 1, rng=rng, device=dev).encrypt(ms)
    combine(tpk, partial_decrypt_all(keys[:3], ct))
    out, rec, _ = _traced(lambda: combine(
        tpk, partial_decrypt_all(keys[:3], ct)))
    assert out == ms
    spans = rec["spans"]
    _check_tree(spans)
    roots = [s for s in spans if s["parent"] < 0]
    assert [s["name"] for s in roots] == ["partial", "combine"]
    assert _children(spans, roots[0]) == {("ladder", "B1"): 3}
    got = _children(spans, roots[1])
    assert got[("host_int", "lagrange")] == 1
    assert got[("host_int", "modinv")] == 1
    assert got[("ladder", "B2")] == 1 and got[("decode", None)] >= 1
    assert max(_per_call(spans).values()) <= MAX_SPANS


@pytest.fixture(scope="module")
def statement(key, dev):
    sk, pk, _, _ = key
    rng = random.Random(0x7A5)
    ct1 = pt.nested_encrypt(pk, [rng.randrange(pk.n) for _ in range(2)], rng,
                            device=dev)
    ct2, a_l, b_l = hom.nested_randomize(pk, ct1, rng)
    return ct1, ct2, a_l, b_l


def test_ddleq_prove_and_verify_within_128_spans(key, statement):
    sk, pk, _, _ = key
    ct1, ct2, a_l, b_l = statement

    def run():
        proof = zd.prove(sk, ct1, ct2, a_l, b_l, SECPAR, random.Random(1))
        return zd.verify(pk, ct1, ct2, proof)

    assert _traced(run)[0] == [True, True]
    ok, rec, _ = _traced(run)
    assert ok == [True, True]
    spans = rec["spans"]
    _check_tree(spans)
    roots = [s for s in spans if s["parent"] < 0]
    assert [s["name"] for s in roots] == ["prove", "verify"]
    calls = _per_call(spans)
    assert max(calls.values()) <= MAX_SPANS
    under = {r["name"]: {s["name"] for s in spans if s["root"] == r["id"]}
             for r in roots}
    assert {"hash", "host_int", "ladder", "encode", "decode",
            "decrypt"} <= under["prove"]
    assert {"hash", "ladder"} <= under["verify"]
    assert {s["name"] for s in spans} <= NAMES


def test_two_threads_keep_separate_stacks():
    barrier = threading.Barrier(2)

    def work():
        with profiling.span("encrypt"):
            barrier.wait()
            with profiling.span("encode"):
                barrier.wait()

    with profile(activities=[ProfilerActivity.CPU]):
        threads = [threading.Thread(target=work) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    spans = profiling.take()["spans"]
    assert sorted(s["name"] for s in spans) == ["encode", "encode",
                                                "encrypt", "encrypt"]
    roots = [s for s in spans if s["parent"] < 0]
    assert len(roots) == 2 and roots[0]["thread"] != roots[1]["thread"]
    for s in spans:
        if s["name"] == "encode":
            p = spans[s["parent"]]
            assert p["name"] == "encrypt" and p["thread"] == s["thread"]
            assert s["root"] == p["id"]


def test_take_clears():
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("encrypt"):
            with profiling.span("encode", rows=1):
                pass
    first = profiling.take()
    assert [s["name"] for s in first["spans"]] == ["encrypt", "encode"]
    assert first["spans"][1]["attrs"] == {"rows": 1}
    assert first["anchor_ns"] is not None
    again = profiling.take()
    assert again["spans"] == [] and again["anchor_ns"] is None


def test_spans_add_no_event_to_the_profiler(key):
    sk, pk, enc, dec = key
    _, rec, prof = _traced(lambda: dec.decrypt(enc.encrypt([4, 2])))
    assert len(rec["spans"]) >= 6
    events = list(prof.profiler.kineto_results.events())
    assert events
    assert not {e.name() for e in events} & NAMES
    assert not {a.key for a in prof.key_averages()} & NAMES


def test_trace_writes_the_spans_on_its_clock(key, tmp_path):
    sk, pk, enc, dec = key
    with profiling.trace(str(tmp_path)):
        with torch.profiler.record_function("window"):
            enc.encrypt([1, 2, 3])
    with open(tmp_path / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    window = next(e for e in events if e.get("name") == "window"
                  and e.get("cat") == "user_annotation")
    mine = [e for e in events if e.get("cat") == "paillier_span"]
    assert Counter(e["name"] for e in mine) == {"encrypt": 1, "encode": 2,
                                                "host_int": 1, "ladder": 1}
    tol = 1000.0                                  # us
    for e in mine:
        assert window["ts"] - tol <= e["ts"]
        assert e["ts"] + e["dur"] <= window["ts"] + window["dur"] + tol
        assert e["pid"] == "paillier_tpu_torch spans, rank 0"
    # the exporter leaves the record for take()
    assert len(profiling.take()["spans"]) == len(mine)


def test_run_ranks_brings_back_rank_tagged_records(key, statement, tmp_path):
    sk, pk, _, _ = key
    ct1, ct2, a_l, b_l = statement
    out = run_ranks(traced_ddleq_body, 2, dataclasses.replace(sk),
                    ct1.c.cpu().numpy(),
                    ct2.c.cpu().numpy(), a_l, b_l, SECPAR, 0x7A6, "cpu",
                    init_dir=tmp_path, timeout=180)
    assert len(out) == 2
    for r in out:
        assert r["plain"][1] == r["traced"][1] == [True, True]
        for f, v in r["plain"][0].items():
            assert np.array_equal(v, r["traced"][0][f])
            assert np.array_equal(v, out[0]["plain"][0][f])
    rec = profiling.take()
    assert rec["spans"] == []
    assert sorted(r["rank"] for r in rec["ranks"]) == [0, 1]
    for r in rec["ranks"]:
        spans = r["spans"]
        _check_tree(spans)
        assert r["anchor_ns"] is not None and "launch.B1" in r["counters"]
        assert [s["name"] for s in spans if s["parent"] < 0] == \
            ["prove", "verify"]
        assert max(_per_call(spans).values()) <= MAX_SPANS
        assert "gather" in {s["name"] for s in spans}
    assert profiling.take()["ranks"] == []
