"""The frozen roofline arithmetic: exact multiply counts and the bounds
PERF.md's kernel table quotes (B1 at k = 320 on 4,096 rows with e = n:
8.0 ms; at k = 192 with a 1,023-bit e: 1.46 ms)."""

import random

import numpy as np
import pytest

from benchmark import roofline


def _plain_count(e: int, w: int) -> int:
    """The ladder walked step by step, counting every multiply."""
    bits = bin(e)[2:]
    count = 1 + (1 << (w - 1) if w > 1 else 0)      # entry, x^2, table
    i, lead = 0, min(w, len(bits))
    while bits[lead - 1] != "1":
        lead -= 1
    i = lead
    while i < len(bits):
        if bits[i] == "0":
            count += 1                                # square
            i += 1
            continue
        l = min(w, len(bits) - i)
        while bits[i + l - 1] != "1":
            l -= 1
        count += l + 1                                # l squares, 1 product
        i += l
    return count + 1                                  # exit


@pytest.mark.parametrize("e", [1, 2, 3, 5, 255, 256, 2 ** 61 + 1,
                               (1 << 200) - 1])
def test_least_mults_is_the_fewest_over_windows(e):
    assert roofline.least_mults(e) == min(_plain_count(e, w)
                                          for w in range(1, 9))


def test_rows_agree_with_one_at_a_time():
    rng = random.Random(7)
    exps = [rng.getrandbits(rng.randint(0, 40)) for _ in range(500)]
    assert list(roofline.least_mults_rows(exps)) == [
        roofline.least_mults(e) for e in exps]


@pytest.mark.parametrize("bits,k", [(4096, 320), (2048, 192), (2047, 192),
                                    (3072, 256), (6144, 512)])
def test_channels(bits, k):
    assert roofline.channels(bits) == k


def test_b1_bounds_of_the_kernel_table():
    rng = random.Random(2048)
    n = rng.getrandbits(2048) | (3 << 2046) | 1
    p = rng.getrandbits(1024) | (3 << 1022) | 1
    t320 = roofline.least_seconds(320, 4096, roofline.least_mults(n))
    t192 = roofline.least_seconds(192, 4096, roofline.least_mults(p - 1))
    assert 7.9e-3 < t320 < 8.1e-3
    assert 1.43e-3 < t192 < 1.49e-3


def test_item_seconds():
    item = {"kernel": "B2", "mod_bits": 4096,
            "row_mults": int(roofline.least_mults_rows(
                np.array([3, 5, 7])).sum())}
    assert item["row_mults"] == sum(roofline.least_mults(e)
                                    for e in (3, 5, 7))
    assert roofline.item_seconds(item) == pytest.approx(
        2 * 8 * 320 ** 2 * item["row_mults"] / 1979e12)
