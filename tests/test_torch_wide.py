"""Every key width the JAX package takes: kernel B4w
(``paillier_tpu_torch/csrc/limb_modexp_wide.cu``, the limb Montgomery
ladder past kernel B4's 768 limbs) and the limb branches that the wide
keys run, against the JAX package on the CPU.

* B4w's launch rules as pure functions (the variant by width, the padded
  words, the shared-memory bytes of a row, the rows of a block, the
  switch of the table and then the operands to global memory), and its
  Montgomery product and ladder emulated warp by warp on the
  interleaved shared-memory layout, against Python integers and the
  plain version.
* Threshold decryption's limb branches (``partial_decrypt_all``: one
  ``DeviceKey.pow_int`` a server; ``combine``'s limb product trees) at
  64- and 128-bit threshold keys, with ``rns2.MAX_MODULUS_BITS`` lowered
  so that n^2 takes the limb route: equal to the port's own RNS
  branches at both widths and to the JAX package's functions (which
  take their limb branches on the CPU backend) at 64 bits.
* The limb CRT decryption ``crt_decrypt_kernel`` through
  ``Decryptor(crt=True)`` with the limit lowered below p^2, against
  ``crt_decrypt_kernel_mm`` at 256- and 512-bit keys and against the JAX
  package's ``crt_decrypt_kernel`` at 256 bits.

The JAX package compiles each of its functions at each width (≈ 12 s a
threshold width, 12-15 s a CRT width on this suite's CPU), so it runs
at one width of each.
* DDLEQ's CRT plans past 5,774-bit keys: both packages raise in
  ``make_engine`` (p^3 past 8,661 bits).
* Full width: an 8192-bit key (fixed 4096-bit primes) builds its
  Encryptor and Decryptor at levels 1 and 2, crt=True and False, and
  its level-2 ladder (L = 1,536) equals pow on one row over 4 digits.

On the CPU every ladder is the kernels' plain version (the tensors lie on
the CPU); B4w itself runs in tests/test_torch_kernels.py on the card.
Tolerance: exact (limbs as uint32, values as ints).
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paillier_tpu_torch as pt
from paillier_tpu.core import decrypt as jdec
from paillier_tpu.core import keys as jkeys
from paillier_tpu.threshold import decrypt as jtdec
from paillier_tpu.threshold import keys as jtkeys
from paillier_tpu.zk import ddleq as jzd
from paillier_tpu_torch.bigint import host, rns2
from paillier_tpu_torch.bigint import mont_kernel as mk
from paillier_tpu_torch.bigint import montgomery as tmont
from paillier_tpu_torch.core import decrypt as tdec
from paillier_tpu_torch.core.keys import decode_batch, encode_batch
from paillier_tpu_torch.ops import random as prand
from paillier_tpu_torch.threshold import decrypt as ttdec
from paillier_tpu_torch.threshold import keygen as tkg
from paillier_tpu_torch.zk import ddleq as tzd

torch.set_num_threads(2)
CPU = "cpu"
M32 = (1 << 32) - 1
LANES = 32

# two 4096-bit primes = 3 mod 4 (host.random_prime, random.Random(81920)):
# an 8192-bit key without the ~20 s prime search
P4096 = int(
    "e20173fc5ad6e1aa7f33c2a2217b15522fd9d3ddb48416bb4dd71b95d105fc12"
    "60fa807e1c5d8868104287f771cc1e223306d8e950c206541488ed825475dada"
    "1716eafebe616988feed076963f6128c7b77dc7aebfdffe156ce76fafcb261a3"
    "a4926367e7b4edc0c66f420a0862f9557a4f94eb64b17a8d01c0a4419f6a1930"
    "01ebaec00b409c062e6bb80c32757442e021fffb3bd1ca5d11be38f32b2c61f2"
    "0018097433897730604c0e1fdac7b99ec62fd2dacb34c3fba077826508a13449"
    "cf286a0e055ec91aee9d50075552b8882eebb9ab127f16db53133f204f1f24a2"
    "a54146becac3c5ce8fb15c40759fbabd6582f6ee6da64104ed3bbc7b2f82b6bc"
    "5882f79f8f6b7a69d1efca349d44f997ee84c0d5f09772656981b341f646fa8d"
    "19faac227de84a5e41885ba76bca73bd5b237f4d6a54c9f65969a3ac905bacd4"
    "7d19cff5b508a20fe6eb956c181a26b16e0aea1309792c42ee8145bded2a60c4"
    "5c981df527e13245164a257033bf27b48548bc027833742e369b4c32e7bb6ade"
    "e71d6389bf80f9b1c1538fd71004c7cb134ff544973d6d3243736fc590b6e940"
    "f2b173441cd054a5511eda89c5f672fccb5b249a610be24559aef7a9a8a8a425"
    "4875fc97232de2386fc4aca0562e703b54791058354f09c3ce9d090c435abe4b"
    "d1fd6ed453de9ca65d907b095d1ba4da63f4c29b393fe8092ee93dee79129bbf", 16)
Q4096 = int(
    "d3a01996bb150bedb28f2bc3fafbde5aac7f0e0a1b6ce2b4fc644c72f425cfec"
    "1b2df839970f0c7b5defe73e1417f091f773266f4494fdb9ac3e363d597100a5"
    "ae0ba13053098ea791de5e97cf63a5cfbf0037439f18c18fa3ddec6e9509c9a5"
    "9446935f4aa2d02d9feb7805df7cefbdb50237f5981c8a11896d98f754545c57"
    "0745f580c3dc548594b215d107e994a08d1b9d9396cf7049f8f4b4eea0caf9d2"
    "358997391d544d77dee7eebeb0040a35ecc767357c1599c4bffbab9640668fe1"
    "c9c8425512985ca0f5f49f303cde577d1801bc6e37d234ab10400859a4fadac3"
    "eece93766a2b796325432d2a9440ec90f68c292b5c9581b73f6d9fbef07e25dd"
    "a2d3c03ce819f491acbf5e32c6a31c50e27945282b833c7783ec0ac7f544661b"
    "0e00f11a50bc31de0eac8f974565824ee1a2e790e525fd7f88c18204c4722434"
    "17d6533baf559ee4e4d4296b30cc64e1bd426ca0b144cddf0b92b07784a45329"
    "774e1b8953c9336a523f8699884d5a81a9b3d260ece6094238e6a2efc0a38d74"
    "3261e3190b221aace912880a339a834e530b085ed2e337ca958e4f9409a3a197"
    "e4e6b8e52e0151377a51b772f82423557d23bd6ac661b7c856a69ab33d33a04c"
    "e28d79b098f0f1a87d3141b9e7e5336da5034da4608cece9104b6560c462546e"
    "4baf7f8de4356252de4865b73078dfd5db4c25f599137a3d15934c6dbcccf0bb", 16)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


def _limbs(vals, width):
    return encode_batch(vals, width, device=CPU)


# ---------------------------------------------------------------------------
# B4w's launch rules
# ---------------------------------------------------------------------------

def test_b4w_variant_and_padded_words():
    """A CUDA call of mont_pow_b4 launches the register kernel B4 up to 768
    limbs (n^3 of a 4096-bit key) and B4w past them; B4w pads a row to a
    multiple of 32 words (a warp)."""
    assert mk.REGISTER_MAX_LIMBS == 768
    assert [mk.variant(L) for L in (16, 512, 768, 769, 1024, 1536, 10 ** 5)
            ] == ["B4"] * 3 + ["B4w"] * 4
    assert [mk.wide_words(L) for L in (769, 1024, 1100, 1536, 1537)] == [
        416, 512, 576, 768, 800]


def test_b4w_shared_memory_rows_and_global_table():
    """A row's shared bytes: 4 operands and the 2^w-entry table of nw
    words (mode 0), the operands alone with the table in global memory
    (mode 1), nothing (mode 2, all in global memory).  The table moves
    out past 2,905 words at window 4 (92,960-bit moduli) and the
    operands past 14,528 words; a block takes one row per SM first, then
    as many rows as shared memory holds, at most 8."""
    assert mk.wide_row_bytes(512, 4, 0) == 20 * 512 * 4 == 40960
    assert mk.wide_row_bytes(512, 4, 1) == 4 * 512 * 4
    assert mk.wide_row_bytes(512, 4, 2) == 0
    modes = {(nw, w): mk.wide_mode(nw, w) for nw, w in (
        (416, 4), (512, 4), (768, 4), (2880, 4), (2912, 4), (14528, 4),
        (14560, 4), (192, 8), (224, 8), (14528, 1), (14560, 1))}
    assert modes == {(416, 4): 0, (512, 4): 0, (768, 4): 0, (2880, 4): 0,
                     (2912, 4): 1, (14528, 4): 1, (14560, 4): 2, (192, 8): 0,
                     (224, 8): 1, (14528, 1): 1, (14560, 1): 2}
    for nw in (512, 768, 2880):
        assert mk.wide_row_bytes(nw, 4, 0) <= mk.SMEM_MAX
    assert mk.wide_row_bytes(2912, 4, 0) > mk.SMEM_MAX
    assert mk.wide_row_bytes(14528, 4, 1) <= mk.SMEM_MAX < \
        mk.wide_row_bytes(14560, 4, 1)
    rows = mk.wide_rows_per_block
    assert [rows(b, 40960, 132) for b in (1, 16, 64, 132, 264, 4096)] == [
        1, 1, 1, 1, 2, 5]
    assert [rows(b, 61440, 132) for b in (16, 4096)] == [1, 3]
    assert [rows(b, 0, 132) for b in (2, 4096, 10 ** 6)] == [1, 8, 8]
    assert rows(4096, mk.wide_row_bytes(2880, 4, 0), 132) == 1


# ---------------------------------------------------------------------------
# B4w's arithmetic, warp by warp, on its shared-memory layout
# ---------------------------------------------------------------------------

def _lookahead(gen, prop):
    G = sum(1 << i for i, g in enumerate(gen) if g)
    P = sum(1 << i for i, p in enumerate(prop) if p)
    c = ((G | P) + G) ^ (G | P) ^ G
    return [(c >> i) & 1 for i in range(LANES)], (c >> LANES) & 1


def _warp_mont_mul(mem, a, b, n, t, out, W, k0):
    """limb_modexp_wide.cu's mont_mul on a flat word list ``mem``: each
    argument is an operand's offset, lane l's word w at [off + w * 32 + l]
    (interleaved), the 32 lanes stepped in lockstep, shuffles reading the
    values of the step before its writes.  Checks the kernel's bounds."""
    def at(off, w, lane):
        return off + w * LANES + lane

    for lane in range(LANES):
        for w in range(W):
            mem[at(t, w, lane)] = 0
    a0 = [mem[at(a, 0, lane)] for lane in range(LANES)]
    n0w = [mem[at(n, 0, lane)] for lane in range(LANES)]
    cy, tx = [0] * LANES, 0
    for src in range(LANES):
        for wb in range(W):
            bi = mem[at(b, wb, src)]                       # __shfl_sync
            t0 = [mem[at(t, 0, lane)] for lane in range(LANES)]
            m = ((t0[0] + a0[0] * bi) * k0) & M32          # from lane 0
            u0, co = [0] * LANES, [0] * LANES
            for lane in range(LANES):                      # word_step
                p = a0[lane] * bi + t0[lane] + cy[lane]
                c1 = p >> 32
                q = m * n0w[lane] + (p & M32)
                c2 = q >> 32
                u0[lane] = q & M32
                for w in range(1, W):
                    p = mem[at(a, w, lane)] * bi + mem[at(t, w, lane)] + c1
                    c1 = p >> 32
                    q = m * mem[at(n, w, lane)] + (p & M32) + c2
                    c2 = q >> 32
                    assert p < 1 << 64 and q < 1 << 64
                    mem[at(t, w - 1, lane)] = q & M32
                co[lane] = c1 + c2
            assert u0[0] == 0
            new_cy = [0] * LANES
            for lane in range(LANES):
                top = lane == LANES - 1
                s = (tx if top else u0[lane + 1]) + co[lane]   # shfl_down
                mem[at(t, W - 1, lane)] = s & M32
                if top:
                    tx = s >> 32
                if lane:
                    new_cy[lane] = (u0[lane] + co[lane - 1]) >> 32  # shfl_up
            cy = new_cy
            assert max(cy) <= 2 and tx <= 1
    gen, prop = [], []
    for lane in range(LANES):
        c, ones = cy[lane], True
        for w in range(W):
            v = mem[at(t, w, lane)] + c
            mem[at(t, w, lane)], c = v & M32, v >> 32
            ones = ones and v & M32 == M32
        gen.append(c != 0)
        prop.append(ones)
    cin, cout = _lookahead(gen, prop)
    tx += cout
    gen, prop = [], []
    for lane in range(LANES):
        c, bw, zero = cin[lane], 0, True
        for w in range(W):
            v = mem[at(t, w, lane)] + c
            mem[at(t, w, lane)], c = v & M32, v >> 32
            d = (v & M32) - mem[at(n, w, lane)] - bw
            bw = 1 if d < 0 else 0
            zero = zero and d % (1 << 32) == 0
        gen.append(bw != 0)
        prop.append(zero)
    bin_, bout = _lookahead(gen, prop)
    sub = tx != 0 or bout == 0
    for lane in range(LANES):
        bw = bin_[lane]
        for w in range(W):
            tw = mem[at(t, w, lane)]
            if sub:
                d = tw - mem[at(n, w, lane)] - bw
                bw = 1 if d < 0 else 0
                mem[at(out, w, lane)] = d % (1 << 32)
            else:
                mem[at(out, w, lane)] = tw


def _store(mem, off, v, W):
    """Value v into an operand: logical word l W + w at [off + w 32 + l]."""
    for lane in range(LANES):
        for w in range(W):
            mem[off + w * LANES + lane] = (v >> (32 * (lane * W + w))) & M32


def _load(mem, off, W):
    return sum(mem[off + w * LANES + lane] << (32 * (lane * W + w))
               for lane in range(LANES) for w in range(W))


@pytest.mark.parametrize("W", [1, 2, 3])
def test_b4w_warp_arithmetic(W):
    """B4w's Montgomery product at W words a lane (nw = 32 W), emulated on
    its interleaved layout, including the in-place shift of t and the
    aliasing of out with a and b: a b R^-1 mod n for random operands,
    all-ones words, a < R, and moduli just below 2^(32 nw)."""
    nw = LANES * W
    R = 1 << (32 * nw)
    rng = random.Random(W)
    moduli = [rng.getrandbits(32 * nw) | 1 | 1 << (32 * nw - 1), R - 1,
              R - 3, R - (1 << (16 * nw)) + 1, (R >> 1) + 1]
    A, B, N, T = 0, nw, 2 * nw, 3 * nw
    for n in moduli:
        k0 = (-pow(n, -1, 1 << 32)) % (1 << 32)
        for a, b in [(rng.randrange(n), rng.randrange(n)), (n - 1, n - 1),
                     (R - 1, n - 1), (R - 1, rng.randrange(n)), (0, n - 1),
                     (rng.randrange(R), 1)]:
            want = a * b * pow(R, -1, n) % n
            mem = [0] * (4 * nw)
            _store(mem, A, a, W)
            _store(mem, B, b, W)
            _store(mem, N, n, W)
            _warp_mont_mul(mem, A, B, N, T, A, W, k0)     # out aliases a
            assert _load(mem, A, W) == want, (n, a, b)
            _store(mem, A, b, W)
            _warp_mont_mul(mem, A, A, N, T, A, W, k0)     # squaring
            assert _load(mem, A, W) == b * b * pow(R, -1, n) % n


def test_b4w_warp_ladder():
    """The kernel's whole ladder (the table at [4 nw], entry v at
    [4 nw + v nw], acc = table[0], window squarings and table[d] * acc a
    digit, the exit by 1) emulated at W = 1 with window 2, on a padded
    modulus (R^2 rebuilt for the padded R, as the wrapper does): equal
    to pow and to the plain ladder."""
    W, window = 1, 2
    nw = LANES * W
    rng = random.Random(0xB4)
    n = rng.getrandbits(32 * nw - 40) | 1 | 1 << (32 * nw - 41)
    R = 1 << (32 * nw)
    k0 = (-pow(n, -1, 1 << 32)) % (1 << 32)
    N, T, ACC, X, TAB = 0, nw, 2 * nw, 3 * nw, 4 * nw
    x, e = rng.randrange(n), rng.getrandbits(14) | 1 << 13
    digits = tmont.exp_digits(e, window, 7)
    mem = [0] * ((4 + (1 << window)) * nw)
    _store(mem, N, n, W)
    _store(mem, ACC, x, W)
    _store(mem, X, R * R % n, W)
    mm = lambda a, b, out: _warp_mont_mul(mem, a, b, N, T, out, W, k0)
    mm(ACC, X, TAB + nw)
    _store(mem, ACC, 1, W)
    mm(ACC, X, TAB)
    _store(mem, ACC, _load(mem, TAB, W), W)
    for v in range(2, 1 << window):
        mm(TAB + (v - 1) * nw, TAB + nw, TAB + v * nw)
    for d in digits:
        for _ in range(window):
            mm(ACC, ACC, ACC)
        mm(TAB + int(d) * nw, ACC, ACC)
    _store(mem, X, 1, W)
    mm(ACC, X, ACC)
    assert _load(mem, ACC, W) == pow(x, e, n)
    ctx = tmont.make_mont_ctx(n, device=CPU)
    got = tmont.mont_pow_digits_plain(
        ctx, _limbs([x], ctx.n_limbs), digits, window)
    assert decode_batch(got) == [pow(x, e, n)]


# ---------------------------------------------------------------------------
# Threshold decryption's limb branches
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[64, 128])
def thr(request):
    """A (5, 3) threshold key of the port, the same key in the JAX
    package, ciphertexts of the port's Encryptor, servers {1, 3, 5}
    (negative Lagrange weights), and the results of the port's RNS
    branches (n^2 within the RNS engine) and, at 64 bits, of the JAX
    package (``partial_decrypt_all`` and ``combine``, its limb branches
    on the CPU; None at 128 bits)."""
    bits = request.param
    keys = tkg.ThresholdKeyGenerator(bits, 5, 3, random.Random(bits),
                                     device=CPU).generate()
    tpk = keys[0].public()
    rng = random.Random(bits + 1)
    ms = [rng.randrange(tpk.n) for _ in range(4)] + [0]
    ct = pt.Encryptor(tpk, rng=rng, device=CPU).encrypt(ms)
    servers = [keys[0], keys[2], keys[4]]
    rns_parts = ttdec.partial_decrypt_all(servers, ct)
    assert not tpk.device(CPU).limb_route(1)
    fields = {f: getattr(keys[0], f) for f in (
        "n", "g", "h", "k", "bits", "l", "t", "v", "vi")}
    jservers = [jtkeys.ThresholdSecretKey(**fields, id=k.id, share=k.share)
                for k in servers]
    jparts = jms = None
    if bits == 64:
        jct = jkeys.Ciphertext(c=jnp.asarray(_u32(ct.c)))
        jparts = jtdec.partial_decrypt_all(jservers, jct)
        jms = jtdec.combine(jservers[0].public(), jparts)
    return dict(bits=bits, tpk=tpk, ms=ms, ct=ct, servers=servers,
                rns_parts=rns_parts, jparts=jparts, jms=jms,
                rns_ms=ttdec.combine(tpk, rns_parts))


def test_threshold_limb_branches(thr, monkeypatch):
    """With the RNS engine's limit below n^2, partial_decrypt_all runs one
    DeviceKey.pow_int a server and combine its limb trees (the RNS engine
    is never asked for): the partial decryptions equal the RNS branch's
    limbs (and the JAX package's at 64 bits), the plaintexts equal the
    RNS branch's, the messages (and the JAX package's); the limb trees'
    positive / negative products equal the residue trees'."""
    tpk, ct = thr["tpk"], thr["ct"]
    dk = tpk.device(CPU)
    L = dk.L
    stacked = torch.stack([p.c for p in thr["rns_parts"]])
    exps = [abs(2 * ttdec.compute_lambda(tpk, s.id, [1, 3, 5]))
            for s in thr["servers"]]
    sel = torch.tensor([ttdec.compute_lambda(tpk, s.id, [1, 3, 5]) > 0
                        for s in thr["servers"]])[:, None, None]
    powed = ttdec.lagrange_powers(tpk, stacked, exps)
    rns_prod = ttdec._combine_products(dk, powed, sel)
    monkeypatch.setattr(rns2, "MAX_MODULUS_BITS", thr["bits"])
    assert dk.limb_route(1)

    def no_rns(level):
        raise AssertionError("the limb route asked for the RNS engine")

    monkeypatch.setattr(dk, "rns", no_rns)
    parts = ttdec.partial_decrypt_all(thr["servers"], ct)
    for got, rp in zip(parts, thr["rns_parts"]):
        assert got.id == rp.id and got.c.shape[-1] == 2 * L
        assert torch.equal(got.c, rp.c)
    ms = ttdec.combine(tpk, parts)
    assert ms == thr["rns_ms"] == thr["ms"]
    if thr["jparts"] is not None:
        for got, jp in zip(parts, thr["jparts"]):
            assert got.id == jp.id
            assert np.array_equal(_u32(got.c), np.asarray(jp.c))
        assert ms == thr["jms"]
    limb_prod = ttdec._combine_products(dk, powed, sel)
    for got, want in zip(limb_prod, rns_prod):
        assert torch.equal(got, want)
    # an odd count of rows pads the tree with the limbs of 1
    three = ttdec._tree_modmul(dk.ctx_for_level(1), powed)
    n2 = tpk.n2
    want = [a * b * c % n2 for a, b, c in zip(
        *(decode_batch(powed[i]) for i in range(3)))]
    assert decode_batch(three) == want


# ---------------------------------------------------------------------------
# The limb CRT decryption
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [256, 512])
def test_limb_crt_decrypt_vs_jax(bits, monkeypatch):
    """With the RNS engine's limit below p^2, Decryptor(crt=True) takes
    crt_decrypt_kernel (the limb ladders mod p^2 and q^2) and gives the
    limbs of crt_decrypt_kernel_mm (the RNS halves, with the limit
    restored) and, at 256 bits, of the JAX package's crt_decrypt_kernel
    (its Decryptor with crt=True on the limb engine)."""
    sk, pk = pt.keygen(bits, random.Random(bits + 7), device=CPU)
    rng = random.Random(bits)
    ms = [rng.randrange(pk.n) for _ in range(4)] + [0, pk.n - 1]
    ct = pt.Encryptor(pk, rng=rng, device=CPU).encrypt(ms)
    mm = tdec.Decryptor(sk, crt=True, device=CPU).decrypt_array(ct)
    calls = []
    kernel = tdec.crt_decrypt_kernel

    def counted(*a, **kw):
        calls.append(1)
        return kernel(*a, **kw)

    monkeypatch.setattr(tdec, "crt_decrypt_kernel", counted)
    monkeypatch.setattr(rns2, "MAX_MODULUS_BITS", bits - 8)
    dec = tdec.Decryptor(sk, crt=True, device=CPU)
    got = dec.decrypt_array(ct)
    assert calls == [1]
    assert torch.equal(got, mm)
    assert dec.decrypt(ct) == ms
    if bits == 256:
        jsk = jkeys.SecretKey(n=sk.n, g=sk.g, h=sk.h, k=sk.k, bits=sk.bits,
                              lam=sk.lam, p=sk.p, q=sk.q)
        want = jdec.Decryptor(jsk, 1, crt=True, engine="limb")._fn(
            jnp.asarray(_u32(ct.c)))
        assert np.array_equal(_u32(got), np.asarray(want))


# ---------------------------------------------------------------------------
# DDLEQ's CRT halves past the RNS engine
# ---------------------------------------------------------------------------

def test_ddleq_crt_plans_past_5774_bits_raise_in_both():
    """A 5,776-bit key's p^3 (8,664 bits) is past the RNS engine's 8,661:
    the prover's CRT plans raise in make_engine in both packages, before
    any ladder runs (use_crt=False, the full-width path, is what takes
    such a key)."""
    rng = random.Random(5776)
    p, q = (rng.getrandbits(2888) | 3 << 2886 | 1 for _ in range(2))
    n = p * q
    assert n.bit_length() == 5776 and (p ** 3).bit_length() > \
        rns2.MAX_MODULUS_BITS
    sk = pt.SecretKey(n=n, g=n + 1, h=2, k=1, bits=5776,
                      lam=(p - 1) * (q - 1), p=p, q=q)
    msg = "not enough sub-14-bit primes"
    with pytest.raises(ValueError, match=msg):
        tzd.crt_plans(sk, CPU)
    jsk = jkeys.SecretKey(n=n, g=n + 1, h=2, k=1, bits=5776,
                          lam=(p - 1) * (q - 1), p=p, q=q)
    with pytest.raises(ValueError, match=msg):
        jzd._CrtN3Plans(jsk, host.limbs_for_bits(5776))


# ---------------------------------------------------------------------------
# An 8192-bit key at full width
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def key8192():
    n = P4096 * Q4096
    sk = pt.SecretKey(n=n, g=n + 1, h=prand.random_qr_generator(
        n, random.Random(8192)), k=1 << 4096, bits=8192,
        lam=(P4096 - 1) * (Q4096 - 1), p=P4096, q=Q4096)
    return sk


def test_8192_bit_key_builds_at_both_levels(key8192):
    """Both levels of an 8192-bit key are past the RNS engine (n^2: 1,024
    limbs, n^3: 1,536, both B4w on the card): the Encryptor and the
    Decryptor build at levels 1 and 2, and Decryptor(crt=True) at level
    1 with its p^2 / q^2 halves (8,192 bits) on the RNS engine at
    k = 704.  No RNS engine of n^2 or n^3 is built."""
    sk = key8192
    pk = sk.public()
    dk = pk.device(CPU)
    assert dk.limb_route(1) and dk.limb_route(2)
    assert [mk.variant(dk.limbs_for_level(lv)) for lv in (1, 2)] == [
        "B4w", "B4w"]
    for level in (1, 2):
        assert pt.Encryptor(pk, level, device=CPU).dk is dk
        assert pt.Decryptor(sk, level, device=CPU).level == level
    dec = pt.Decryptor(sk, 1, crt=True, device=CPU)
    assert dec.crt and not sk.device(CPU)._rns and not dk._rns
    for level, bits in ((1, "1638"), (2, "2457")):
        with pytest.raises(ValueError, match=rf"a 8192-bit key at level "
                           rf"{level} has a {bits}\d-bit modulus"):
            dk.rns(level)


def test_8192_bit_level2_ladder_at_full_width(key8192):
    """DeviceKey.pow at level 2 of the 8192-bit key: the limb ladder at
    L = 1,536 (B4w's width on the card; the plain ladder here) on one row
    over 4 digits equals pow."""
    pk = key8192.public()
    dk = pk.device(CPU)
    rng = random.Random(1536)
    x = rng.randrange(pk.n3)
    e = rng.getrandbits(16) | 1 << 15
    got = dk.pow(2, _limbs([x], 1536), tmont.exp_digits(e, 4, 4))
    assert dk.ctx_for_level(2).n_limbs == 1536
    assert decode_batch(got) == [pow(x, e, pk.n3)]
