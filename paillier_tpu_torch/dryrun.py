"""Driver entry points of the port (the counterparts of the repo's
``__graft_entry__.py``).

entry(device):        (fn, args) of the batched regular encryption on the
                      limb engine (G^m shortcut and the fixed-window
                      r^(n^s) ladder, kernel B4 on a CUDA device) at a
                      512-bit key and 64 rows: a one-card check that the
                      kernels build and run.
dryrun_multichip(n):  one full multi-device step on tiny shapes, called by
                      every rank of a ``torch.distributed`` group of at
                      least n ranks: data-parallel encryption,
                      ``sharded_aggregate`` checked by threshold
                      decryption, ``distributed_combine`` on a
                      (servers x batch) mesh when 4 divides n, the
                      share-decryption proofs with ``combine_with_zkp``,
                      and DDLEQ proofs with ``mesh=``.

    python -m paillier_tpu_torch.dryrun --ranks 4 [--device cpu]

runs ``entry()`` once, then spawns the ranks of ``dryrun_multichip``:
gloo ranks on the CPU with ``--device cpu``; on the card, NCCL with one
card a rank where the host has that many cards, else gloo ranks sharing
card 0.
"""

from __future__ import annotations

import argparse
import random
import tempfile

import torch


def entry(device="cuda"):
    """(fn, example_args) for a one-card check: ``fn(m, r)`` is the
    regular level-1 encryption ``core.encrypt.encrypt_with_r_kernel`` on
    the limb engine of n^2 (kernel B4 at window 4 on the card), and the
    args are 64 plaintexts and their randomness as limb tensors on
    ``device``, under a 512-bit key from ``random.Random(0xF1A6)`` (the
    JAX entry point's key, plaintexts and r)."""
    from .bigint.engine import LimbEngine
    from .core.encrypt import encrypt_with_r_kernel
    from .core.keygen import keygen
    from .core.keys import LEVEL_ONE, encode_batch
    from .ops import random as prand

    dev = torch.device(device)
    rng = random.Random(0xF1A6)
    sk, pk = keygen(512, rng, device=dev)
    dk = pk.device(dev)
    eng = LimbEngine(pk.n2, 2 * dk.L, device=dev)

    B = 64
    ms = [rng.randrange(pk.n) for _ in range(B)]
    rs = prand.random_units(pk.n, B, rng)
    m = encode_batch(ms, dk.L, device=dev)
    r = encode_batch(rs, 2 * dk.L, device=dev)

    def fn(m, r):
        return encrypt_with_r_kernel(dk, eng, m, r, LEVEL_ONE)

    return fn, (m, r)


def dryrun_multichip(n_devices: int, device="cuda") -> list:
    """One full multi-device step over an n-rank mesh, on every rank of
    the caller's process group (at least ``n_devices`` ranks), each on
    ``device`` ("cpu", or its current card).  Every rank draws the same
    values from ``random.Random(0xD12)`` and computes on its own block;
    every check raises AssertionError on failure.  Rank 0 prints the JAX
    dry run's two lines; every rank returns them."""
    import torch.distributed as dist

    from .core import homomorphic as hom
    from .core.encrypt import Encryptor, nested_encrypt
    from .core.keygen import keygen
    from .core.keys import LEVEL_ONE, Ciphertext
    from .parallel.collective import (_all_gather, distributed_combine,
                                      sharded_aggregate)
    from .parallel.launch import rank_device
    from .parallel.mesh import (BATCH_AXIS, SERVER_AXIS, axis, make_mesh,
                                shard_batch)
    from .threshold.decrypt import (combine, compute_lambda, lagrange_powers,
                                    partial_decrypt_all)
    from .threshold.keygen import generate_threshold_keys
    from .threshold.zkp import (combine_with_zkp, partial_decrypt_with_zkp,
                                verify_proofs)
    from .zk.ddleq import prove, verify

    assert dist.get_world_size() >= n_devices, (
        f"need {n_devices} ranks, have {dist.get_world_size()}")
    dev = rank_device(device)
    lines = []

    def say(line):
        lines.append(line)
        if dist.get_rank() == 0:
            print(line, flush=True)

    rng = random.Random(0xD12)

    # tiny threshold keyset: 4 servers, threshold 3, 64-bit modulus
    n_servers = 4
    keys = generate_threshold_keys(64, n_servers, 3, rng, device=dev)
    tpk = keys[0].public()

    # mesh: (servers, batch) when divisible, else 1D batch
    mesh2 = (make_mesh(n_devices, servers=n_servers, device_type=dev.type)
             if n_devices % n_servers == 0 else None)
    mesh1 = make_mesh(n_devices, device_type=dev.type)

    # --- data-parallel encryption: each rank encrypts its block of the
    #     batch with its block of the randomness ---
    B = 2 * n_devices
    enc = Encryptor(tpk, LEVEL_ONE, rng=rng, device=dev)
    ms = [rng.randrange(1000) for _ in range(B)]
    rs = enc.sample_r(B)
    _, i = axis(mesh1, BATCH_AXIS)
    blk = slice(i * 2, (i + 1) * 2)
    ct_local = enc.encrypt(ms[blk], rs[blk])

    # --- homomorphic aggregation with an all-gather collective ---
    agg = sharded_aggregate(tpk, ct_local, mesh1)

    # verify the aggregate via threshold decryption of the single result
    agg_ct = Ciphertext(c=agg.c[None], level=LEVEL_ONE)
    shares = partial_decrypt_all(keys[:3], agg_ct)
    expected = sum(ms) % tpk.n
    got = combine(tpk, shares)
    assert got == [expected], f"aggregate mismatch: {got} != {expected}"

    # --- threshold over the full batch: this rank's servers' Lagrange
    #     powers of its batch block, server-axis combine collective ---
    if mesh2 is not None:
        ids = [k.id for k in keys]
        lam2s = [2 * compute_lambda(tpk, k.id, ids) for k in keys]
        signs = [1 if l2 >= 0 else -1 for l2 in lam2s]
        rows, row = axis(mesh2, SERVER_AXIS)
        s_local = n_servers // rows
        mine = slice(row * s_local, (row + 1) * s_local)
        # the whole batch from the encryption's shards, then this rank's
        # block of the (servers x batch) mesh's batch axis
        full = _all_gather(ct_local.c, mesh1.get_group(BATCH_AXIS))
        pds = partial_decrypt_all(keys[mine], Ciphertext(
            c=shard_batch(full.flatten(0, 1), mesh2)))
        server_powed = lagrange_powers(
            tpk, torch.stack([p.c for p in pds]),
            [abs(l2) for l2 in lam2s[mine]])
        got_batch = distributed_combine(tpk, server_powed, signs, mesh2)
        assert got_batch == ms, "distributed combine mismatch"

    # --- threshold share-ZKP: prove + batched verify ---
    zkp_proofs = [partial_decrypt_with_zkp(k, agg_ct, rng)
                  for k in keys[:3]]              # per server: [proof]
    oks_zkp = verify_proofs([p for ps in zkp_proofs for p in ps], device=dev)
    assert all(oks_zkp), f"threshold share ZKPs failed: {oks_zkp}"
    got_zkp = combine_with_zkp(tpk, zkp_proofs, device=dev)
    assert got_zkp == [expected], f"ZKP combine mismatch: {got_zkp}"
    say(f"dryrun zkp: {sum(bool(o) for o in oks_zkp)}/3 share proofs "
        "verified on the mesh backend; ZKP combine ok")

    # --- DDLEQ proofs sharded over the batch axis ---
    sk2, pk2 = keygen(64, rng, device=dev)
    msd = [rng.randrange(pk2.n) for _ in range(2)]
    ct1 = nested_encrypt(pk2, msd, rng, device=dev)
    ct2, a_l, b_l = hom.nested_randomize(pk2, ct1, rng)
    secpar = max(4, n_devices)
    while (2 * secpar) % n_devices:     # flat batch 2*secpar must shard evenly
        secpar += 1
    proof = prove(sk2, ct1, ct2, a_l, b_l, secpar, rng, mesh=mesh1)
    oks = verify(pk2, ct1, ct2, proof, mesh=mesh1)
    assert oks == [True, True], f"sharded DDLEQ failed: {oks}"

    say(f"dryrun_multichip({n_devices}): OK — tally {got[0]} == "
        f"{expected}; ddleq {sum(oks)}/2 proofs x {secpar} instances "
        "verified sharded")
    return lines


def dryrun_rank(rank: int, world: int, n_devices: int, device: str
                ) -> list:
    """A spawned rank's body: :func:`dryrun_multichip`."""
    return dryrun_multichip(n_devices, device)


def main(argv=None) -> None:
    from .parallel.launch import plan, run_ranks
    ap = argparse.ArgumentParser(
        prog="python -m paillier_tpu_torch.dryrun",
        description="entry() once, then dryrun_multichip(n) on n spawned "
                    "ranks")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    backend = plan(args.ranks, args.device)
    fn, fargs = entry(args.device)
    out = fn(*fargs)
    print(f"entry(): ran on {out.device}, output shape {tuple(out.shape)}")
    with tempfile.TemporaryDirectory() as tmp:
        run_ranks(dryrun_rank, args.ranks, args.ranks, args.device,
                  init_dir=tmp, timeout=args.timeout, backend=backend)
    print(f"{args.ranks} {backend} ranks on "
          f"{'the CPU' if args.device == 'cpu' else 'the card(s)'}: OK")


if __name__ == "__main__":
    main()
