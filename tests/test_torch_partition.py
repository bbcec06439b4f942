"""Segment partition parity: lightgbm_tpu_torch's plain partition
(stable_partition_ranges, and partition_segments on a CPU tensor, the
kernel's dispatcher) against the JAX package's stable_partition_ranges and
its Pallas kernel in interpret mode (partition_rows(..., interpret=True)).

The output is a permutation and a count, so every comparison is bitwise.
Fixtures mirror tests/test_partition.py: disjoint segments, empty and
one-element segments, all-left and all-right segments, and segments in
admission order (unsorted starts, empty entries at 0).

The kernel itself runs only on the card (tests/test_torch_gpu.py); here
``chunk_model`` repeats its work decomposition (csrc/partition_common.cuh)
in torch integer ops and is held bitwise against the plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
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


CASES = ["disjoint", "unaligned", "degenerate", "one_side", "admission"]


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
    elif name == "one_side":  # tests/test_partition.py:42
        n = 100
        order = np.arange(n, dtype=np.int32)
        seg_start = np.asarray([10, 50], np.int32)
        seg_len = np.asarray([20, 0], np.int32)
        go = np.zeros(n, bool)
    else:  # "admission": the windowed grower's segment table, in admission
        # order, with its empty slots at start 0 beside a segment at 0
        n = 5000
        order = rng.permutation(n).astype(np.int32)
        seg_start = np.asarray([3100, 0, 0, 1200, 0, 4999], np.int32)
        seg_len = np.asarray([1500, 0, 900, 1024, 0, 1], np.int32)
        go = rng.rand(n) < 0.45
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


@pytest.mark.parametrize("name", ["disjoint", "degenerate", "admission"])
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


def test_wrapper_refuses_more_rows_than_the_status_words_count():
    """Counts live in 30 bits of a status word: N >= 2^30 raises before any
    launch (meta tensors: no memory)."""
    n = partition_cuda.MAX_ROWS
    order = torch.empty(n, dtype=torch.int32, device="meta")
    go = torch.empty(n, dtype=torch.bool, device="meta")
    seg = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        partition_cuda.check_segments(order, seg, seg, go)
    partition_cuda.check_segments(order[:-1], seg, seg, go[:-1])


# ---------------------------------------------------------------------------
# the kernel's work decomposition, modelled in torch integer ops
# ---------------------------------------------------------------------------
def _exclusive(x):
    return torch.cumsum(x, 0) - x


def chunk_model(order, seg_start, seg_len, go, chunk=partition_cuda.CHUNK):
    """csrc/partition_common.cuh's partition: the flat chunk table from the
    segment table (segment chunks, then the gap before each non-empty
    segment and after the last), each segment chunk's count and the
    exclusive left prefix of the earlier chunks of its segment (what the
    look-back sums), the segment's last chunk's n_left, the move's
    destinations and the gap chunks' copy.  Returns (out, n_left, chunks,
    writes per position)."""
    n, S = order.shape[0], seg_start.shape[0]
    st, ln = seg_start.long(), seg_len.long()
    full = ln > 0
    end = st + ln
    # build_table: the gap before a non-empty segment starts at the end of
    # the non-empty segment before it in position order
    before = full[None, :] & (st[None, :] < st[:, None])
    gap_lo = torch.where(before, end[None, :], 0).amax(1)
    gap_len = torch.where(full, (st - gap_lo).clamp_min(0), 0)
    max_end = int(torch.where(full, end, 0).max())
    seg_chunks = (ln + chunk - 1) // chunk
    gap_chunks = torch.cat([(gap_len + chunk - 1) // chunk,
                            torch.tensor([(n - max_end + chunk - 1) // chunk])])
    seg_first = _exclusive(seg_chunks)
    n_seg = int(seg_chunks.sum())
    gap_first = n_seg + _exclusive(gap_chunks)
    total = n_seg + int(gap_chunks.sum())
    assert n_seg <= (n + chunk - 1) // chunk + S
    assert total <= (n + chunk - 1) // chunk + 2 * S + 1
    tid = torch.arange(chunk)
    out = torch.full_like(order, -1)
    writes = torch.zeros(n, dtype=torch.int64)
    # segment chunks: tickets 0..n_seg-1 (entry_of: the last entry whose
    # first ticket is <= k)
    k = torch.arange(n_seg)
    s = torch.searchsorted(seg_first, k, right=True) - 1
    c = k - seg_first[s]
    rel = c[:, None] * chunk + tid[None, :]
    valid = rel < ln[s][:, None]
    pos = torch.where(valid, st[s][:, None] + rel, 0)
    left = valid & go[pos]
    cnt = left.sum(1)
    excl = _exclusive(cnt) - _exclusive(cnt)[seg_first[s]]
    # each non-empty segment's last chunk writes n_left; empty ones get 0
    last = torch.where(seg_chunks > 0, seg_first + seg_chunks - 1, n_seg)
    n_left = torch.cat([excl + cnt, torch.zeros(1, dtype=torch.int64)])[last]
    rank = torch.cumsum(left.long(), 1) - left.long()
    dest = torch.where(left, st[s][:, None] + excl[:, None] + rank,
                       st[s][:, None] + n_left[s][:, None] + (c[:, None] * chunk - excl[:, None])
                       + (tid[None, :] - rank))
    out[dest[valid]] = order[pos[valid]]
    writes.index_add_(0, dest[valid], torch.ones_like(dest[valid]))
    # gap chunks: tickets n_seg..total-1 copy the positions outside every segment
    k = torch.arange(n_seg, total)
    r = torch.searchsorted(gap_first, k, right=True) - 1
    lo_all = torch.cat([gap_lo, torch.tensor([max_end])])
    hi_all = torch.cat([st, torch.tensor([n])])
    p = lo_all[r][:, None] + (k - gap_first[r])[:, None] * chunk + tid[None, :]
    ok = p < hi_all[r][:, None]
    out[p[ok]] = order[p[ok]]
    writes.index_add_(0, p[ok], torch.ones_like(p[ok]))
    return out, n_left.to(torch.int32), total, writes


def _check_model(order, seg_start, seg_len, go, chunk):
    t = [torch.as_tensor(v) for v in (order, seg_start, seg_len, go)]
    out, n_left, _, writes = chunk_model(*t, chunk=chunk)
    want, want_l = partition_cuda.partition_segments_plain(*t)
    assert torch.equal(writes, torch.ones_like(writes)), "a position written other than once"
    assert torch.equal(out, want)
    assert torch.equal(n_left, want_l)


@pytest.mark.parametrize("chunk", [partition_cuda.CHUNK, 100, 7])
@pytest.mark.parametrize("name", list(chip_smoke.PARTITION_EDGES))
def test_chunk_model_matches_plain_on_the_edge_geometries(name, chunk):
    _check_model(*chip_smoke.partition_edge(name), chunk)


@st.composite
def _geometry(draw):
    """Disjoint segments cut from [0, N) at random, kept or dropped, in a
    shuffled (admission) order, with empty entries at random starts and at
    0; go flags at random."""
    n = draw(st.integers(1, 300))
    cuts = sorted(draw(st.lists(st.integers(0, n), max_size=12)))
    bounds = [0] + cuts + [n]
    pieces = [(a, b - a) for a, b in zip(bounds[:-1], bounds[1:])]
    keep = draw(st.lists(st.booleans(), min_size=len(pieces), max_size=len(pieces)))
    segs = [p for p, k in zip(pieces, keep) if k]
    segs += [(draw(st.sampled_from([0, n - 1, n // 2])), 0)
             for _ in range(draw(st.integers(0, 3)))]
    segs = draw(st.permutations(segs)) or [(0, 0)]
    seed = draw(st.integers(0, 2**31 - 1))
    rng = np.random.RandomState(seed)
    order = rng.permutation(n).astype(np.int32)
    go = rng.rand(n) < draw(st.sampled_from([0.0, 0.3, 1.0]))
    start, length = (np.asarray(v, np.int32) for v in zip(*segs))
    return order, start, length, go


@settings(max_examples=150, deadline=None, derandomize=True)
@given(geo=_geometry(), chunk=st.sampled_from([1, 2, 5, 16, partition_cuda.CHUNK]))
def test_chunk_model_matches_plain_on_random_geometries(geo, chunk):
    _check_model(*geo, chunk)
