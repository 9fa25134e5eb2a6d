"""Whole runs on the CPU at small sizes, the harness's look for a card
skipped: each cell is correct as it stands; its control (the
reference's own answers with the canonical form broken) and each fault
the cell can have, planted in the timed path, make ``correct`` false.
The traffic generators give the same inputs for the same seed."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness, inputs, refpool, runner

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 33 + 12345          # past 32 signed bits, as run seeds may be

SMALL = {
    "p2048.encdec": {"config": {"key_bits": 256},
                     "traffic": {"batch": 16, "distinct_requests": 2}},
    "p2048.tally": {"config": {"key_bits": 256},
                    "traffic": {"pool": 256, "base": 64, "encrypt_batch": 32,
                                "block": 48, "distinct_requests": 3}},
    "t2048.threshold": {"config": {"primes_file":
                                   "data/safe_primes_small.json",
                                   "primes_key": "128"},
                        "traffic": {"batch": 16, "pool_batches": 2}},
    "ddleq2048.x4": {"config": {"key_bits": 256, "secpar": 4},
                     "traffic": {"chunk": 8, "pool_chunks": 2}, "world": 2},
}
FAULTS = {
    "p2048.encdec": ["answer_altered", "half_batch"],
    "p2048.tally": ["state_unchanged", "half_batch", "answer_altered"],
    "t2048.threshold": ["answer_altered", "half_batch"],
    "ddleq2048.x4": ["exchange_left_out", "answer_altered", "half_batch"],
}
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(autouse=True)
def serial_reference(monkeypatch):
    monkeypatch.setattr(refpool, "WORKERS", 1)


def _run(cell, fault=None, seconds=0.5):
    return runner.run_cell(cell, SEED, seconds, False, device="cpu",
                           fault=fault, controls=fault is None,
                           overrides=SMALL[cell])


@pytest.mark.parametrize("cell", list(SMALL))
def test_a_sound_run_is_correct_and_its_control_is_not(cell):
    out = _run(cell)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[:5] == KEYS and list(out)[-1] == "checks"
    assert all(v["value"] <= v["limit"] for v in out["checks"].values())
    assert any(v["value"] > v["limit"]
               for v in out["control_checks"].values())
    e2e = {m["name"] for m in harness.load_cell(cell).end_to_end}
    assert set(out["metrics"]) == e2e
    assert out["metrics"]["ops_per_s"]["value"] > 0
    json.dumps(out)


@pytest.mark.parametrize("cell,fault", [(c, f) for c in FAULTS
                                        for f in FAULTS[c]])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    out = _run(cell, fault)
    assert out["correct"] is False


def test_the_result_line_keys():
    """The contract's keys in its order, ``breakdown`` only when traced,
    ``checks`` last."""
    cell = harness.load_cell("p2048.encdec")
    run = harness.Run(ops=10, ops_attempted=10, latencies=[0.1, 0.2],
                      window_s=1.0, setup_s=2.0, spans={}, work=[])
    win = harness.Window(failed=[False, False])
    out = harness.result_line(cell, run, win, {"x": (0, 0)},
                              {"platform": "gpu"}, traced=False)
    assert list(out) == KEYS + ["checks"]
    assert out["correct"] is True
    out = harness.result_line(cell, run, win, {"x": (1, 0)},
                              {"platform": "gpu"}, traced=False)
    assert out["correct"] is False


@pytest.mark.parametrize("cell", ["p2048.encdec", "p2048.tally",
                                  "t2048.threshold"])
def test_the_generators_are_deterministic_per_seed(cell):
    c = harness.load_cell(cell)
    for part in ("config", "traffic"):
        getattr(c, part).update(SMALL[cell][part])
    op = harness.op_module(c.traffic["op"]).Op

    def reqs(seed):
        o = op(c, seed, "cpu", harness.Spans(False))
        return [vars(r).copy() for r in o.requests]

    a, b, other = reqs(SEED), reqs(SEED), reqs(SEED + 1)
    for r in a + b + other:
        r.pop("mults", None)
    assert a == b and a != other


def test_ddleq_inputs_are_deterministic_per_seed():
    from benchmark.ops import ddleq
    n = 3 * 2 ** 255 + 7
    assert ddleq.pool_inputs(SEED, n, 4, 2) == ddleq.pool_inputs(SEED, n, 4,
                                                                 2)
    assert ddleq.pool_inputs(SEED, n, 4, 2) != ddleq.pool_inputs(SEED + 1,
                                                                 n, 4, 2)
    assert (ddleq.weights(SEED, 9) == ddleq.weights(SEED, 9)).all()


def test_streams_are_deterministic():
    assert inputs.stream(SEED, "a").random() == inputs.stream(SEED,
                                                              "a").random()
    assert inputs.stream(SEED, "a").random() != inputs.stream(SEED,
                                                              "b").random()


def _cli(cwd, *extra):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "p2048.encdec",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_the_command_needs_a_card(tmp_path):
    """No CUDA device: a non-zero exit and no result on standard output
    (the check runs before any set-up)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    proc = _cli(ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_reap_leaves_no_process_behind(monkeypatch):
    """After the reference's pool of spawned processes, ``reap`` leaves
    this process with no child: not a worker, not multiprocessing's
    resource tracker."""
    import importlib.util
    monkeypatch.setattr(sys, "path", list(sys.path))  # run.py sets path[0]
    spec = importlib.util.spec_from_file_location("bench_run",
                                                  ROOT / "benchmark/run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    monkeypatch.setattr(refpool, "WORKERS", 2)
    assert refpool.run(pow, [(3, k, 1000003) for k in range(16)]) == \
        [pow(3, k, 1000003) for k in range(16)]
    assert run.reap(grace_s=10) == []
    assert run._children() == []


def test_the_benchmark_alone_does_not_run(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files
    gives a non-zero exit and no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _cli(tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.mark.cuda
def test_a_traced_run_reads_the_card():
    """On a card: a short traced run reports busy_s, window_s and the
    per-layer metrics of the cell."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = runner.run_cell("p2048.encdec", SEED, 1.0, True,
                          overrides={"traffic": {"distinct_requests": 1}})
    assert out["correct"] is True
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    assert "device_idle_pct" in out["metrics"]
    assert "breakdown" in out


def test_the_per_layer_readers_read_a_trace():
    """Every per-layer reader on a synthetic traced window: two ladder
    kernels, a glue kernel, a copy and an NCCL kernel; the shares stay
    within 0..100 and a reader with nothing to read returns None."""
    import numpy as np
    from benchmark import roofline
    from benchmark.traces import Trace
    names = ["void rns2_sliding_kernel<32, false, 640>",
             "void rns2_modexp_kernel<32, false, 640>",
             "void at::native::elementwise", "Memcpy DtoH ",
             "ncclDevKernel_AllGather_RING_LL"]
    ms = 1_000_000
    tr = Trace(window_s=1.0, names=names, idx=np.array([0, 1, 2, 3, 4]),
               start=np.array([0, 200, 400, 500, 600]) * ms,
               end=np.array([150, 300, 450, 550, 650]) * ms)
    work = [{"kernel": "B1", "mod_bits": 4096,
             "row_mults": 4096 * roofline.least_mults(2 ** 2047 + 1)},
            {"kernel": "B2", "mod_bits": 4096, "row_mults": 16384 * 40}]
    run = harness.Run(ops=100, ops_attempted=100, latencies=[0.1],
                      window_s=1.0, setup_s=1.0,
                      spans={"encrypt": [0.05, 0.07]}, work=work, trace=tr)
    read = {m["name"]: harness.reader(m["name"])(run)
            for m in json.loads((ROOT / "BENCHMARK.json").read_text())
            ["per_layer"]}
    assert read["api_ms.encrypt"] == pytest.approx(60.0)
    assert read["api_ms.decrypt"] is None
    assert read["launches_per_op"] == pytest.approx(4 / 100)
    assert read["device_idle_pct"] == pytest.approx(60.0)
    assert read["nccl_pct"] == pytest.approx(5.0)
    assert read["B1_roofline"] == pytest.approx(
        100 * roofline.item_seconds(work[0]) / 0.150)
    for k in ("ladder_roofline", "B1_roofline", "B2_roofline", "step_mfu"):
        assert 0 < read[k] <= 100
    run.trace = None
    assert all(harness.reader(k)(run) is None
               for k in ("device_idle_pct", "B1_roofline", "step_mfu"))
