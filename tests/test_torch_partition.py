"""Segment partition parity: lightgbm_tpu_torch's plain partition
(stable_partition_ranges, and partition_segments on a CPU tensor, the
kernel's dispatcher) against the JAX package's stable_partition_ranges and
its Pallas kernel in interpret mode (partition_rows(..., interpret=True)).

The output is a permutation and a count, so every comparison is bitwise.
Fixtures mirror tests/test_partition.py: disjoint segments, empty and
one-element segments, all-left and all-right segments."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
from lightgbm_tpu.ops import partition as jpart
from lightgbm_tpu_torch.ops import partition as tpart
from lightgbm_tpu_torch.ops import partition_cuda


def _seg_id(n, seg_start, seg_len):
    seg_id = np.full(n, -1, np.int32)
    for s, (lo, ln) in enumerate(zip(seg_start, seg_len)):
        seg_id[lo:lo + ln] = s
    return seg_id


CASES = ["disjoint", "unaligned", "degenerate", "one_side"]


def _case(name):
    rng = np.random.RandomState(CASES.index(name))
    if name == "disjoint":  # tests/test_partition.py:24
        n = 10_000
        order = rng.permutation(n).astype(np.int32)
        seg_start = np.asarray([0, 3000, 5000, 9000], np.int32)
        seg_len = np.asarray([1500, 800, 2500, 1000], np.int32)
        go = rng.rand(n) < 0.4
    elif name == "unaligned":  # tests/test_partition.py:58, starts off chunk edges
        n = 6000
        order = rng.permutation(n).astype(np.int32)
        seg_start = np.asarray([2048, 100, 5800, 1500], np.int32)  # not sorted
        seg_len = np.asarray([3000, 900, 200, 500], np.int32)
        go = rng.rand(n) < 0.55
    elif name == "degenerate":  # tests/test_partition.py:84
        n = 1100
        order = np.arange(n, dtype=np.int32)[::-1].copy()
        seg_start = np.asarray([0, 512, 513, 600], np.int32)
        seg_len = np.asarray([512, 1, 0, 500], np.int32)
        go = np.zeros(n, bool)
        go[:512] = True  # segment 0 all left, segment 3 all right
        go[512] = True
    else:  # "one_side": tests/test_partition.py:42
        n = 100
        order = np.arange(n, dtype=np.int32)
        seg_start = np.asarray([10, 50], np.int32)
        seg_len = np.asarray([20, 0], np.int32)
        go = np.zeros(n, bool)
    return order, _seg_id(n, seg_start, seg_len), seg_start, seg_len, go


@pytest.fixture
def pallas_compat(monkeypatch):
    """The installed JAX names the kernel's compiler parameters
    CompilerParams; the JAX package still asks for TPUCompilerParams."""
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                            raising=False)


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_jax_xla(name):
    order, seg_id, seg_start, seg_len, go = _case(name)
    want, want_l = jpart.stable_partition_ranges(*map(jnp.asarray, (
        order, seg_id, seg_start, seg_len, go)))
    got, got_l = tpart.stable_partition_ranges(*map(torch.from_numpy, (
        order, seg_id, seg_start, seg_len, go)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))


@pytest.mark.parametrize("name", ["disjoint", "degenerate"])
def test_plain_matches_jax_pallas_interpret(pallas_compat, name):
    order, seg_id, seg_start, seg_len, go = _case(name)
    want, want_l = jpart.partition_rows(*map(jnp.asarray, (
        order, seg_id, seg_start, seg_len, go)), interpret=True)
    got, got_l = partition_cuda.partition_segments(*map(torch.from_numpy, (
        order, seg_start, seg_len, go)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))


def test_all_left_keeps_order_and_counts_everything():
    order, _, seg_start, seg_len, go = _case("one_side")
    t = list(map(torch.from_numpy, (order, seg_start, seg_len, go)))
    got, lefts = partition_cuda.partition_segments(*t)
    assert torch.equal(got, t[0]) and lefts.tolist() == [0, 0]
    t[3][:] = True
    got, lefts = partition_cuda.partition_segments(*t)
    assert torch.equal(got, t[0]) and lefts.tolist() == [20, 0]
    # no segment at all: every position keeps its row
    got, lefts = partition_cuda.partition_segments(t[0], t[1][:0], t[2][:0], t[3])
    assert torch.equal(got, t[0]) and lefts.numel() == 0


def test_segment_ids_and_library_yardstick():
    """segment_ids rebuilds the per-position table from the segment table,
    and chip_smoke.py's stable-sort yardstick (timed on the card, never
    used by the port) computes the same permutation."""
    order, seg_id, seg_start, seg_len, go = _case("unaligned")
    t = {k: torch.from_numpy(v) for k, v in dict(
        order=order, seg_start=seg_start, seg_len=seg_len, go=go).items()}
    np.testing.assert_array_equal(
        tpart.segment_ids(t["seg_start"], t["seg_len"], len(order)).numpy(), seg_id)
    want, _ = partition_cuda.partition_segments_plain(
        t["order"], t["seg_start"], t["seg_len"], t["go"])
    got = chip_smoke.library_partition(t["order"], t["seg_start"],
                                       t["seg_len"], t["go"])()
    assert torch.equal(got, want)


def test_wrappers_check_inputs():
    order, _, seg_start, seg_len, go = _case("one_side")
    t = list(map(torch.from_numpy, (order, seg_start, seg_len, go)))
    with pytest.raises(TypeError):
        partition_cuda.check_segments(t[0].long(), *t[1:])
    with pytest.raises(TypeError):
        partition_cuda.check_segments(t[0], t[1], t[2][:1], t[3])
    with pytest.raises(TypeError):
        partition_cuda.check_segments(t[0], t[1], t[2], t[3].int())
