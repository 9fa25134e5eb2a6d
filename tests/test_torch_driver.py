"""The port's profiling module and driver entry points against the JAX
package's, on the CPU.

* ``ops/profiling.py``: the multiply counts and the channel count equal
  the JAX module's for the same arguments; the H100 roofline gives the
  bounds of the port's kernel table (B1 at k = 320 on 4096 rows with
  e = n: 8.05 ms; B4 at L = 128, 4096 rows, 512 digits: 10.42 ms);
  ``detect_chip`` never guesses; ``trace`` writes a Chrome trace.
* ``dryrun.entry()`` run on the CPU equals the JAX ``entry()``'s output
  (its jit on the JAX CPU backend), limb for limb.
* ``dryrun_multichip(4)`` passes on 4 spawned gloo ranks, and
  ``python -m paillier_tpu_torch.dryrun``'s main on 2.
* the scaling probe prints its JSON line at 1 and 2 ranks.

Tolerance: exact (limbs as uint32, counts as ints); the bounds to 0.01
ms, as the table writes them.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from paillier_tpu.ops import profiling as jprof
from paillier_tpu_torch import dryrun, scaling_probe
from paillier_tpu_torch.ops import profiling as prof

torch.set_num_threads(2)
H100 = prof.CHIPS["h100"]


@pytest.mark.parametrize("e_bits,window", [(2048, 6), (4100, 6), (4096, 5),
                                           (1, 2), (2048, 4), (8192, 4)])
def test_mult_counts_equal_jax(e_bits, window):
    assert prof.sliding_mults(e_bits, window) == \
        jprof.sliding_mults(e_bits, window)
    assert prof.fixed_window_mults(e_bits, window) == \
        jprof.fixed_window_mults(e_bits, window)
    for sliding in (True, False):
        m = prof.RooflineModel(4096, e_bits, 320, window, sliding, chip=H100)
        j = jprof.RooflineModel(4096, e_bits, 320, window, sliding,
                                chip=jprof.CHIPS["v5e"])
        assert m.mults == j.mults and m.macs_per_mult == j.macs_per_mult


@pytest.mark.parametrize("pk_bits", [1024, 2048, 4096])
def test_encryption_roofline_k_equals_jax(pk_bits):
    m = prof.encryption_roofline(pk_bits, chip=H100)
    j = jprof.encryption_roofline(pk_bits, chip=jprof.CHIPS["v5e"])
    assert (m.k, m.mults, m.macs_per_mult) == (j.k, j.mults, j.macs_per_mult)


def test_roofline_bounds_of_the_kernel_table():
    """B1, k = 320, 4096 rows, e = n: 2,374 multiplies x 819,200 MACs x 2
    / 1,979 TOP/s = 8.05 ms (~509,000 enc/s); B4 at L = 128 (a 2048-bit
    modulus), 4096 rows, 512 digits: 2,577 products x 8,256 multiply-adds
    over 132 x 64 x 1.98 GHz / 2 = 10.42 ms; both bound by operations."""
    b1 = prof.encryption_roofline(2048, chip=H100)
    assert (b1.k, b1.mults, b1.macs_per_mult, b1.rows) == (320, 2374,
                                                           819200, 4096)
    assert round(b1.bound_s() * 1e3, 2) == 8.05
    assert b1.bound_by == "operations" and 508_000 < b1.rate() < 510_000
    b4 = prof.RooflineModel(2048, 2048, 0, 4, sliding=False, rows=4096,
                            chip=H100)
    assert (b4.mults, b4.words, b4.imad_per_mult) == (2577, 64, 8256)
    assert round(b4.bound_s() * 1e3, 2) == 10.42
    assert "10.4197 ms by operations" in b4.report()
    assert "11.8% of the bound" in b1.report(measured=60_000)


def test_detect_chip_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        prof.detect_chip()
    with pytest.raises(RuntimeError):
        prof.RooflineModel(4096, 2048, 320)


def test_trace_writes_a_chrome_trace(tmp_path):
    with prof.trace(str(tmp_path / "t")) as p:
        with torch.profiler.record_function("window"):
            torch.ones(64).cumsum(0)
    with open(tmp_path / "t" / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name") == "window" for e in events)
    assert p.key_averages() is not None


def test_entry_equals_jax_entry():
    """The port's entry() on the CPU (the plain ladder at L = 64) and the
    JAX entry() under jit on its CPU backend: the same 64 ciphertexts,
    limb for limb, and the reference formula."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    try:
        import __graft_entry__ as graft
    finally:
        sys.path.pop(0)
    jfn, jargs = graft.entry()
    want = np.asarray(jax.jit(jfn)(*jargs))
    fn, args = dryrun.entry("cpu")
    assert all(a.device.type == "cpu" for a in args)
    got = fn(*args)
    assert got.shape == (64, 64)
    assert np.array_equal(got.numpy().astype(np.uint32), want)
    for a, j in zip(args, jargs):
        assert np.array_equal(a.numpy().astype(np.uint32), np.asarray(j))


def test_dryrun_multichip_on_four_gloo_ranks(tmp_path):
    from torch_ranks import run_ranks
    ranks = run_ranks(dryrun.dryrun_rank, 4, 4, "cpu", init_dir=tmp_path,
                      timeout=300)
    assert all(r == ranks[0] for r in ranks)
    zkp, last = ranks[0]
    assert zkp == ("dryrun zkp: 3/3 share proofs verified on the mesh "
                   "backend; ZKP combine ok")
    assert last.startswith("dryrun_multichip(4): OK")
    a, b = last.split("tally ")[1].split(";")[0].split(" == ")
    assert a == b
    assert "ddleq 2/2 proofs x 4 instances" in last


def test_dryrun_main_on_two_cpu_ranks(capsys):
    dryrun.main(["--ranks", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "entry(): ran on cpu, output shape (64, 64)" in out
    assert "2 gloo ranks on the CPU: OK" in out


@pytest.mark.parametrize("ranks", [1, 2])
def test_scaling_probe_json_line(capsys, ranks):
    scaling_probe.main([str(ranks), "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    rec = json.loads(line)
    assert set(rec) == {"n_devices", "t_aggregate_s", "t_combine_s"}
    assert rec["n_devices"] == ranks
    assert 0 < rec["t_aggregate_s"] < 30 and 0 < rec["t_combine_s"] < 30
