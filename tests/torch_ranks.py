"""Spawned ``torch.distributed`` ranks for the port's parallel tests, and
the rank bodies they run.  Imports no JAX: each rank is a fresh process
(the ``spawn`` start method; CUDA cannot start again in a forked child)
that imports this module, never a test module.

    run_ranks(body, world, *args, init_dir=tmp_path, timeout=120)

is the package's ``paillier_tpu_torch.parallel.launch.run_ranks``: it
starts ``world`` processes, each joining one process group (gloo, or NCCL
with one card a rank) through a file in ``init_dir``, runs
``body(rank, world, *args)`` in each and returns their results in rank
order.  Results travel as plain Python data (ints, lists, numpy arrays).
"""

from __future__ import annotations

import random
import sys

import torch

from paillier_tpu_torch.parallel.launch import rank_device, run_ranks


# ---------------------------------------------------------------------------
# Rank bodies
# ---------------------------------------------------------------------------

def _no_jax() -> None:
    assert "jax" not in sys.modules, "a rank imported JAX"


def _launches() -> dict:
    from paillier_tpu_torch.bigint import (fixed_base_kernel, modexp_kernel,
                                           mont_kernel, sliding_kernel)
    from paillier_tpu_torch.ops import sha256
    return {"B1": sliding_kernel.rns2_pow_sliding_b1.launches,
            "B2": modexp_kernel.rns2_pow_b2.launches,
            "B3": fixed_base_kernel.rns2_pow_fixed_base_b3.launches,
            "B4": mont_kernel.mont_pow_b4.launches,
            "SHA": sha256.sha256_bytes.launches}


def _raises(exc, fn, *args, **kw) -> str:
    """The message of the ``exc`` that fn(*args) raises ("" if none)."""
    try:
        fn(*args, **kw)
    except exc as e:
        return str(e)
    return ""


def bodies(rank, world, calls):
    """Several bodies in one spawn: ``calls`` is a list of (body, args);
    returns their results in order."""
    return [body(rank, world, *args) for body, args in calls]


def mesh_body(rank, world, x):
    """Mesh shapes, axis names and coordinates of make_mesh's 1-D mesh and
    (on 4 ranks) its (2 servers x 2 batch) mesh; this rank's shard_batch
    block of the int64 array ``x`` on each; the errors of a batch that
    does not divide and of a mesh larger than the world."""
    from paillier_tpu_torch.parallel import mesh as pm
    _no_jax()
    xt = torch.as_tensor(x)
    out = {}
    meshes = {"1d": pm.make_mesh(device_type="cpu")}
    if world == 4:
        meshes["2d"] = pm.make_mesh(4, servers=2, device_type="cpu")
    for key, mesh in meshes.items():
        out[key] = dict(shape=tuple(mesh.shape), names=mesh.mesh_dim_names,
                        coord=tuple(mesh.get_coordinate()),
                        block=pm.shard_batch(xt, mesh).numpy())
    out["indivisible"] = _raises(ValueError, pm.shard_batch, xt[:world + 1],
                                 meshes["1d"])
    out["too_many"] = _raises(ValueError, pm.make_mesh, world + 1,
                              device_type="cpu")
    # defaults through Config: mesh_servers = 2 makes the 2-D mesh
    from paillier_tpu_torch.config import Config, get_config, set_config
    saved = get_config()
    set_config(Config(mesh_devices=world, mesh_servers=2))
    try:
        out["config_shape"] = tuple(pm.make_mesh(device_type="cpu").shape)
    finally:
        set_config(saved)
    out["jax"] = "jax" in sys.modules
    return out


def aggregate_body(rank, world, pk, cts, device):
    """sharded_aggregate of each level's whole batch ``cts`` ({level:
    int64 limbs [B, Ltot]}) on a 1-D mesh: each rank passes its
    shard_batch block; returns {level: the product as an int}, whether
    each result lies on the rank's device, and the kernel launches."""
    from paillier_tpu_torch.core.keys import Ciphertext, decode_batch
    from paillier_tpu_torch.parallel import (make_mesh, shard_batch,
                                             sharded_aggregate)
    _no_jax()
    dev = rank_device(device)
    mesh = make_mesh(device_type=dev.type)
    before = _launches()
    out, on_dev = {}, []
    for level, c in cts.items():
        local = Ciphertext(c=shard_batch(torch.as_tensor(c, device=dev),
                                         mesh), level=level)
        agg = sharded_aggregate(pk, local, mesh)
        on_dev.append(agg.c.device == dev and agg.level == level)
        out[level] = decode_batch(agg.c[None])[0]
    return dict(sums=out, on_device=all(on_dev),
                launches={k: v - before[k] for k, v in _launches().items()})


def combine_steps(keys, ct, mesh, step=None):
    """The threshold path into distributed_combine on a (servers x batch)
    ``mesh``: this rank's servers (its row's block of ``keys``) decrypt
    its batch block of ``ct`` (int64 limbs [B, 2L] on the rank's device)
    partially (B1 a server), raise the shares to their Lagrange weights
    (B2 once) and combine; returns the plaintexts of the whole batch.
    Each stage runs as ``step(name, fn)`` (default: ``fn()``)."""
    from paillier_tpu_torch.core.keys import Ciphertext
    from paillier_tpu_torch.parallel import distributed_combine, shard_batch
    from paillier_tpu_torch.parallel.mesh import SERVER_AXIS, axis
    from paillier_tpu_torch.threshold import (compute_lambda,
                                              lagrange_powers,
                                              partial_decrypt_all)
    step = step or (lambda name, fn: fn())
    tpk = keys[0].public()
    ids = [k.id for k in keys]
    lam2 = [2 * compute_lambda(tpk, i, ids) for i in ids]
    signs = [1 if v >= 0 else -1 for v in lam2]
    servers, row = axis(mesh, SERVER_AXIS)
    s_local = len(keys) // servers
    mine = slice(row * s_local, (row + 1) * s_local)
    pds = step("partial_decrypt_all", lambda: partial_decrypt_all(
        keys[mine], Ciphertext(c=shard_batch(ct, mesh))))
    powed = step("lagrange_powers", lambda: lagrange_powers(
        tpk, torch.stack([p.c for p in pds]), [abs(v) for v in lam2[mine]]))
    return step("distributed_combine", lambda: distributed_combine(
        tpk, powed, signs, mesh))


def combine_body(rank, world, keys, ct, servers, device):
    """:func:`combine_steps` on a (servers x world / servers) mesh;
    returns the plaintexts and the launches."""
    from paillier_tpu_torch.parallel import make_mesh
    _no_jax()
    dev = rank_device(device)
    mesh = make_mesh(world, servers=servers, device_type=dev.type)
    before = _launches()
    got = combine_steps(keys, torch.as_tensor(ct, device=dev), mesh)
    return dict(plain=got,
                launches={k: v - before[k] for k, v in _launches().items()})


def ddleq_body(rank, world, sk, c1, c2, a_l, b_l, secpar, seed, chunks,
               device):
    """DDLEQ with mesh= on a 1-D mesh: proofs with and without the CRT
    split from ``seed``, their verdicts, the verdicts of a proof with
    instance (1, 3) of e tampered, the flat-batch error of one proof of
    3 instances, and pipeline_prove_verify over ``chunks`` (proof counts,
    seeds seed + 1 + j) with 2 workers; proofs as numpy arrays."""
    import dataclasses

    from paillier_tpu_torch.core.keys import LEVEL_TWO, Ciphertext
    from paillier_tpu_torch.parallel import make_mesh
    from paillier_tpu_torch.zk import ddleq as zd
    _no_jax()
    dev = rank_device(device)
    mesh = make_mesh(device_type=dev.type)
    pk = sk.public()
    ct1 = Ciphertext(c=torch.as_tensor(c1, device=dev), level=LEVEL_TWO)
    ct2 = Ciphertext(c=torch.as_tensor(c2, device=dev), level=LEVEL_TWO)
    before = _launches()
    proofs = {crt: zd.prove(sk, ct1, ct2, a_l, b_l, secpar,
                            random.Random(seed), mesh=mesh, use_crt=crt)
              for crt in (True, False)}
    prove_launches = {k: v - before[k] for k, v in _launches().items()}
    before = _launches()
    ok = zd.verify(pk, ct1, ct2, proofs[True], mesh=mesh)
    verify_launches = {k: v - before[k] for k, v in _launches().items()}
    e = proofs[True].e.clone()
    e[1, 3, 0] ^= 1
    bad = zd.verify(pk, ct1, ct2, dataclasses.replace(proofs[True], e=e),
                    mesh=mesh)
    one = [Ciphertext(c=c.c[:1], level=LEVEL_TWO) for c in (ct1, ct2)]
    flat_err = _raises(ValueError, zd.prove, sk, *one, a_l[:1], b_l[:1], 3,
                       random.Random(seed), mesh=mesh)
    jobs = [(Ciphertext(c=ct1.c[:k], level=LEVEL_TWO),
             Ciphertext(c=ct2.c[:k], level=LEVEL_TWO), a_l[:k], b_l[:k],
             random.Random(seed + 1 + j)) for j, k in enumerate(chunks)]
    piped = list(zd.pipeline_prove_verify(sk, jobs, secpar, mesh=mesh,
                                          verify_pk=pk))
    fields = ("x", "y", "alpha", "e", "f")
    return dict(proofs={crt: {f: getattr(p, f).cpu().numpy() for f in fields}
                        for crt, p in proofs.items()},
                ok=ok, bad=bad, flat_err=flat_err, piped=piped,
                prove_launches=prove_launches,
                verify_launches=verify_launches)


def traced_ddleq_body(rank, world, sk, c1, c2, a_l, b_l, secpar, seed,
                      device):
    """A proof with mesh= from ``seed`` and its verdicts, first with no
    profiler, then again under ``torch.profiler`` (CPU activity), so
    this rank records its spans; returns both proofs (numpy) and
    verdicts."""
    from torch.profiler import ProfilerActivity, profile

    from paillier_tpu_torch.core.keys import LEVEL_TWO, Ciphertext
    from paillier_tpu_torch.parallel import make_mesh
    from paillier_tpu_torch.zk import ddleq as zd
    _no_jax()
    dev = rank_device(device)
    mesh = make_mesh(device_type=dev.type)
    ct1 = Ciphertext(c=torch.as_tensor(c1, device=dev), level=LEVEL_TWO)
    ct2 = Ciphertext(c=torch.as_tensor(c2, device=dev), level=LEVEL_TWO)

    def run():
        proof = zd.prove(sk, ct1, ct2, a_l, b_l, secpar,
                         random.Random(seed), mesh=mesh)
        ok = zd.verify(sk.public(), ct1, ct2, proof, mesh=mesh)
        return {f: getattr(proof, f).cpu().numpy()
                for f in ("x", "y", "alpha", "e", "f")}, ok

    plain = run()
    with profile(activities=[ProfilerActivity.CPU]):
        traced = run()
    return dict(plain=plain, traced=traced)
