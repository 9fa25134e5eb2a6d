"""The probes P1-P5 (``paillier_tpu_torch/probes``) against the JAX
package's v5e probe kernels, on the CPU.

The scripts ``scripts/perf_{dotvar,dotchain,overlap,pad,vpuops}.py`` run
their benchmark when imported, so their kernel functions are read with
``ast`` (the top-level defs, and the nested ``kern`` / ``kern_roll`` /
``kern_base`` of ``perf_pad``, with their closure names given as
globals), executed with the step counts overridden, and run through
``pl.pallas_call(..., interpret=True)``.  Both sides get the same numpy
inputs (the probes' ``inputs``: the scripts' draws, P5's f on a 1/256
grid) at k = 320 (P5: 320 columns), 8-32 rows and 2-5 steps; each
variant of each probe's plain version, which the wrapper runs for a CPU
tensor, must equal the JAX kernel.  Tolerance: exact.
"""

import ast
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from paillier_tpu_torch.probes import D, K
from paillier_tpu_torch.probes import dotchain, dotvar, overlap, pad, vpuops

torch.set_num_threads(2)

_SCRIPTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "scripts")


def _load(script, names, nested_in=None, **consts):
    """The functions ``names`` of scripts/<script> (top-level, or nested in
    the function ``nested_in``), executed with JAX's modules and
    ``consts`` as globals."""
    path = os.path.join(_SCRIPTS, script)
    with open(path) as fh:
        tree = ast.parse(fh.read())
    scope = tree.body
    if nested_in is not None:
        outer = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
                     and n.name == nested_in)
        scope = list(ast.walk(outer))
    body = [n for n in scope if isinstance(n, ast.FunctionDef)
            and n.name in names]
    g = dict(jax=jax, jnp=jnp, lax=lax, pl=pl, pltpu=pltpu,
             functools=functools, **consts)
    exec(compile(ast.Module(body=body, type_ignores=[]), path, "exec"), g)
    return g


def _pallas(kern, out_shape, *args):
    out = pl.pallas_call(kern, out_shape=out_shape, interpret=True)(*args)
    return jax.tree_util.tree_map(np.asarray, out)


def _np(*ts):
    return [t.numpy() for t in ts]


@pytest.mark.parametrize("variant", dotvar.VARIANTS)
def test_p1_dotvar(variant):
    x, mlo, mhi = dotvar.inputs(rows=16)
    g = _load("perf_dotvar.py", {"dot", "mk_kernel"}, STEPS=3, k=K)
    gap = dotvar.gap_matrix(mlo, mhi)
    want = _pallas(g["mk_kernel"](variant),
                   jax.ShapeDtypeStruct((16, D), jnp.int8),
                   *_np(x, mlo, mhi, gap, torch.cat([mlo, mhi], 1)))
    got = dotvar.dotvar(x, mlo, mhi, 3, variant)
    assert got.dtype == torch.int8 and np.array_equal(got.numpy(), want)


def test_p1_layouts_compute_one_function():
    """split4, gap2 and fused2 give one result; wide1 (half the
    products) another."""
    x, mlo, mhi = dotvar.inputs(rows=8)
    outs = {v: dotvar.dotvar_plain(x, mlo, mhi, 4, v)
            for v in dotvar.VARIANTS}
    assert torch.equal(outs["split4"], outs["gap2"])
    assert torch.equal(outs["split4"], outs["fused2"])
    assert not torch.equal(outs["split4"], outs["wide1"])


def test_p2_dotchain():
    x, mlo, mhi = dotchain.inputs(rows=8)
    g = _load("perf_dotchain.py", {"kernel"})
    want = _pallas(functools.partial(g["kernel"], steps=2),
                   jax.ShapeDtypeStruct((8, D), jnp.int8), *_np(x, mlo, mhi))
    got = dotchain.dotchain(x, mlo, mhi, 2)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", overlap.MODES)
def test_p3_overlap(mode):
    x, mlo, mhi, y, m, inv = overlap.inputs(rows=8)
    g = _load("perf_overlap.py", {"dot", "dots_step", "vpu_step", "k_dots",
                                  "k_vpu", "k_both"}, VPU_PASSES=3)
    mb = np.broadcast_to(m.numpy()[None], (8, K))
    want = _pallas(functools.partial(g[f"k_{mode}"], steps=3),
                   (jax.ShapeDtypeStruct((8, D), jnp.int8),
                    jax.ShapeDtypeStruct((8, K), jnp.int32)),
                   *_np(x, mlo, mhi, y), mb,
                   1.0 / jnp.asarray(mb).astype(jnp.float32))
    o, p = overlap.overlap(x, mlo, mhi, y, m, inv, 3, mode)
    assert np.array_equal(o.numpy(), want[0])
    assert np.array_equal(p.numpy(), want[1])
    # the chains move (a step count of 3 is not a fixed point)
    assert not np.array_equal(want[0], x.numpy()) or mode == "vpu"
    assert not np.array_equal(want[1], y.numpy()) or mode == "dots"


@pytest.mark.parametrize("case", [768, 640, 384, "roll", "add-only"])
def test_p4_pad(case):
    rows = 8
    if isinstance(case, int):
        x, w = pad.inputs(case, rows=rows)
        g = _load("perf_pad.py", {"kern"}, nested_in="bench_dots", B=rows,
                  lanes=case)
        want = _pallas(functools.partial(g["kern"], steps=3),
                       jax.ShapeDtypeStruct((rows, D), jnp.int32),
                       *_np(x, w))
        got = pad.pad(x, w, 3)
    else:
        x = pad.roll_input(rows)
        name = "kern_roll" if case == "roll" else "kern_base"
        g = _load("perf_pad.py", {name}, nested_in="bench_roll")
        want = _pallas(functools.partial(g[name], steps=5),
                       jax.ShapeDtypeStruct((rows, D), jnp.int32), x.numpy())
        got = pad.roll(x, 5, permute=case == "roll")
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("op", list(vpuops.OPS))
def test_p5_vpuops(op):
    """On x to 64,000 (``vpuops.inputs``), so that the reductions (the
    identity below 16,383) move too."""
    x, f = vpuops.inputs(rows=8)
    assert int(x.max()) > 16383
    g = _load("perf_vpuops.py", {"mk"}, REPS=5)
    want = _pallas(g["mk"](op), jax.ShapeDtypeStruct((8, K), jnp.int32),
                   *_np(x, f))
    got = vpuops.vpuops(x, f, 5, op)
    assert np.array_equal(got.numpy(), want)
    assert not np.array_equal(want, x.numpy())
