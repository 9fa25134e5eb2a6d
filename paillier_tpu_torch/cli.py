"""Working demo CLI (the reference ships a stale, non-compiling demo at
main/main.go; this one runs), on the card unless given ``--cpu``.

    python -m paillier_tpu_torch.cli demo --bits 256
    python -m paillier_tpu_torch.cli threshold --bits 64 --servers 5 --threshold 3
    python -m paillier_tpu_torch.cli ddleq --bits 128 --secpar 16
    python -m paillier_tpu_torch.cli --cpu --seed 1 demo

The flags and result lines are those of ``python -m paillier_tpu.cli``.
"""

from __future__ import annotations

import argparse
import random


def _demo(args, dev):
    from .core import homomorphic as hom
    from .core.decrypt import Decryptor
    from .core.encrypt import Encryptor
    from .core.keygen import keygen
    from .core.keys import LEVEL_ONE, Ciphertext

    rng = random.Random(args.seed)
    print(f"generating {args.bits}-bit keypair...")
    sk, pk = keygen(args.bits, rng, device=dev)
    print(f"  n = {hex(pk.n)}")
    enc = Encryptor(pk, LEVEL_ONE, rng=rng, device=dev)
    dec = Decryptor(sk, LEVEL_ONE, crt=True, device=dev)

    vals = [101, 202, 303, 404]
    print(f"encrypting {vals} (batched on device)...")
    ct = enc.encrypt(vals)
    print(f"  ciphertext tensor: {tuple(ct.c.shape)} "
          f"{str(ct.c.dtype).removeprefix('torch.')}")

    total = hom.aggregate(pk, ct, axis=0)
    out = dec.decrypt(Ciphertext(c=total.c[None], level=LEVEL_ONE))[0]
    print(f"homomorphic sum     -> {out}  (expected {sum(vals)})")

    tripled = hom.const_mult(pk, ct, 3)
    print(f"const_mult by 3     -> {dec.decrypt(tripled)}")

    diff = hom.sub(pk, ct, enc.encrypt([1, 2, 3, 4]))
    print(f"homomorphic sub     -> {dec.decrypt(diff)}")
    print("ok")


def _threshold(args, dev):
    from .core.encrypt import Encryptor
    from .core.keys import LEVEL_ONE
    from .threshold.decrypt import combine, partial_decrypt
    from .threshold.keygen import generate_threshold_keys

    rng = random.Random(args.seed)
    print(f"generating ({args.threshold},{args.servers})-threshold keys "
          f"({args.bits}-bit)...")
    keys = generate_threshold_keys(args.bits, args.servers, args.threshold,
                                   rng, device=dev)
    tpk = keys[0].public()
    enc = Encryptor(tpk, LEVEL_ONE, rng=rng, device=dev)
    votes = [1, 0, 1, 1, 0]
    ct = enc.encrypt(votes)
    subset = keys[:args.threshold]
    print(f"servers {[k.id for k in subset]} decrypting batch {votes}...")
    shares = [partial_decrypt(k, ct) for k in subset]
    print(f"combined -> {combine(tpk, shares)}")
    print("ok")


def _ddleq(args, dev):
    from .core import homomorphic as hom
    from .core.encrypt import nested_encrypt
    from .core.keygen import keygen
    from .zk.ddleq import prove, verify

    rng = random.Random(args.seed)
    sk, pk = keygen(args.bits, rng, device=dev)
    ms = [rng.randrange(pk.n) for _ in range(2)]
    print(f"nested-encrypting {len(ms)} values, re-randomizing...")
    ct1 = nested_encrypt(pk, ms, rng, device=dev)
    ct2, a_l, b_l = hom.nested_randomize(pk, ct1, rng)
    print(f"proving DDLEQ (secpar={args.secpar})...")
    proof = prove(sk, ct1, ct2, a_l, b_l, args.secpar, rng)
    print(f"verify -> {verify(pk, ct1, ct2, proof)}")
    print("ok")


def main(argv=None):
    p = argparse.ArgumentParser(prog="paillier_tpu_torch",
                                description="Paillier on the GPU: a demo")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    sub = p.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("demo", help="keygen/encrypt/add/mult roundtrip")
    d.add_argument("--bits", type=int, default=256)
    t = sub.add_parser("threshold", help="threshold decryption ceremony")
    t.add_argument("--bits", type=int, default=64)
    t.add_argument("--servers", type=int, default=5)
    t.add_argument("--threshold", type=int, default=3)
    z = sub.add_parser("ddleq", help="nested re-encryption ZK proof")
    z.add_argument("--bits", type=int, default=128)
    z.add_argument("--secpar", type=int, default=16)
    args = p.parse_args(argv)
    dev = "cpu" if args.cpu else "cuda"
    {"demo": _demo, "threshold": _threshold, "ddleq": _ddleq}[args.cmd](
        args, dev)


if __name__ == "__main__":
    main()
