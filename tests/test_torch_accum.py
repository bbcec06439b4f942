"""The histogram kernels' split-word accumulator, modelled in torch integer
arithmetic on the CPU.

csrc/hist_common.cuh keeps each float cell's 64-bit fixed-point sum as two
32-bit shared words, because Hopper has native 32-bit shared atomics only:
the low word takes the value's low 32 bits as an unsigned add (the atomic
returns the old word), the signed high word takes value >> 32 plus one when
that add wrapped, and the flush recombines (hi << 32) + lo into a 64-bit
global sum.  These tests replay that arithmetic add by add and hold the
recombined sum to the exact int64 sum.  Values sit at the extremes the
tree's exponent allows, +-2^(62 - bitlen(N)) (ops/hist_cuda.py::_shift_of
scales max |v| into [2^(61 - bitlen(N)), 2^(62 - bitlen(N)))), with random
signs, more adds into one cell than a block has threads, and carries out of
the low word with both signs of the high word.  Bitwise: integer
arithmetic.
"""

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import hist_cuda

MASK32 = (1 << 32) - 1
THREADS = 1024  # rows a block walks at once (csrc/hist_common.cuh kThreads)


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """Two's-complement int32 wrap-around of int64 values."""
    return ((x + (1 << 31)) & MASK32) - (1 << 31)


def _split_add(lo, hi, v):
    """One add_split per cell: atomicAdd on the unsigned low word returns
    the old word, the carry is old + l < old (mod 2^32), and the high word
    takes (v >> 32) + carry as an int32 add."""
    low = v & MASK32
    old = lo
    lo = (old + low) & MASK32
    carry = (lo < old).long()
    return lo, _wrap_i32(hi + (v >> 32) + carry)


def _join(lo, hi):
    """The flush's join_split: (hi << 32) | lo as a signed 64-bit value."""
    return hi * (1 << 32) + lo


def _accumulate(vals: torch.Tensor):
    """Replay the adds of vals (K, C) in row order into C cells."""
    c = vals.shape[1]
    lo = torch.zeros(c, dtype=torch.int64)
    hi = torch.zeros(c, dtype=torch.int64)
    for row in vals:
        lo, hi = _split_add(lo, hi, row)
    return lo, hi


def _extreme_values(n_rows: int, k: int, cells: int, seed: int, sign: str):
    """(k, cells) fixed-point values of a call on n_rows rows: |v| at the
    top of the exponent's range and just under it, small ones and ones one
    step either side of a 32-bit boundary, with the given signs."""
    rng = np.random.RandomState(seed)
    top = 1 << (62 - int(n_rows).bit_length())
    mags = np.stack([
        np.full(cells, top - 1),
        np.full(cells, top >> 1),
        np.full(cells, (1 << 32) - 1),
        np.full(cells, (1 << 32) + 1),
        np.ones(cells, dtype=np.int64),
    ])
    mags = np.minimum(mags, top)
    pick = rng.randint(0, len(mags) + 1, (k, cells))
    rand = rng.randint(0, top, (k, cells), dtype=np.int64)
    v = np.where(pick < len(mags), mags[np.minimum(pick, len(mags) - 1),
                                        np.arange(cells)[None, :]], rand)
    if sign == "mixed":
        v = v * np.where(rng.rand(k, cells) < 0.5, -1, 1)
    elif sign == "negative":
        v = -v
    return torch.from_numpy(v.astype(np.int64))


@pytest.mark.parametrize("n_rows", [400_000, 1_000_000, 2**31 - 1])
@pytest.mark.parametrize("sign", ["positive", "negative", "mixed"])
def test_split_words_recombine_to_the_int64_sum(n_rows, sign):
    k = 3 * THREADS + 77  # more adds into a cell than a block holds rows
    vals = _extreme_values(n_rows, k, 16, n_rows % 1000 + len(sign), sign)
    lo, hi = _accumulate(vals)
    want = vals.sum(0)
    assert torch.equal(_join(lo, hi), want)
    # the low word wrapped, so the carry path ran, in the sign under test
    low_sum = (vals & MASK32).sum(0)
    assert bool((low_sum >= (1 << 32)).all())
    assert bool((hi.abs() < (1 << 31)).all())


def test_carry_with_a_negative_high_word():
    """-1 is low word 0xffffffff with high word -1: every add of it after
    the first wraps the low word, the carry cancels the high word's -1, and
    the cell still sums to -k; a positive value just under 2^32 carries
    into a zero high word."""
    k = 2 * THREADS + 1
    for v, hi_step in ((-1, -1), ((1 << 32) - 1, 0)):
        vals = torch.full((k, 1), v, dtype=torch.int64)
        lo, hi = _accumulate(vals)
        assert int(vals[0, 0] >> 32) == hi_step
        assert int(_join(lo, hi)) == v * k


def test_order_and_block_split_do_not_change_the_sum():
    """Rows in another order give the same two words; partials of blocks
    that each hold a range of the rows, flushed into a 64-bit sum, give the
    same total (the global atomicAdd on u64 wraps like int64)."""
    vals = _extreme_values(400_000, 2 * THREADS, 8, 5, "mixed")
    lo, hi = _accumulate(vals)
    perm = torch.from_numpy(np.random.RandomState(1).permutation(vals.shape[0]))
    lo_p, hi_p = _accumulate(vals[perm])
    assert torch.equal(lo, lo_p) and torch.equal(hi, hi_p)
    total = torch.zeros(vals.shape[1], dtype=torch.int64)
    for part in torch.tensor_split(vals, [300, 301, 1500]):
        total += _join(*_accumulate(part))
    assert torch.equal(total, vals.sum(0))


def test_model_matches_the_plain_histograms_fixed_point():
    """The values the model adds are the plain version's: round(v * 2^s)
    with the exponent of the call's rows; their split-word sum, scaled back
    and rounded to f32, is the plain histogram's single cell."""
    rng = np.random.RandomState(3)
    n = 2 * THREADS + 5
    grad = torch.from_numpy((rng.randn(n) * 7).astype(np.float32))
    hess = torch.from_numpy(rng.rand(n).astype(np.float32))
    sg, sh = hist_cuda.fixed_shift_pair(grad, hess)
    bins = torch.zeros((n, 1), dtype=torch.int16)
    mask = torch.ones(n, dtype=torch.bool)
    slot = torch.zeros(n, dtype=torch.int32)
    plain = hist_cuda.histogram_multi_plain(bins, grad, hess, mask, slot, 0, 1, 2)
    for ch, (v, s) in enumerate(((grad, sg), (hess, sh))):
        fixed = torch.round(v.double() * 2.0 ** s).long()[:, None]
        lo, hi = _accumulate(fixed)
        got = (_join(lo, hi).double() * 2.0 ** -s).float()
        assert torch.equal(got, plain[0, ch, 0, :1])
