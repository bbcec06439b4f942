"""Stable segment partition: the hand-written Hopper kernel and its plain
version.

The kernel (csrc/partition.cu) replaces lightgbm_tpu/ops/
partition_pallas.py::_partition_kernel; the source note there says what
bounds it and how its design answers.  Dispatch rule: a CUDA tensor
launches the kernel or raises; only a tensor on the CPU takes the plain
version (ops/partition.py::stable_partition_ranges).  The output is a
permutation, so kernel and plain version agree bit for bit.  The round
megakernel (ops/round_cuda.py) runs the same device code and shares the
scratch kept here.  ``partition_segments_lanes`` is the lane mode (the
booster fleet's): L orders partitioned in one launch, lane b's segments
offset by b * N in the flat space of its lane group (1024 // S lanes, whose
segments fill one chunk table); the launch takes the groups in turn.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import KernelLibrary, count_launch, stream_ptr
from .partition import segment_ids, stable_partition_ranges

launches = {"partition_segments": 0, "partition_segments_lanes": 0}
plain_calls = {"partition_segments": 0, "partition_segments_lanes": 0}
CHUNK = 4096  # positions per chunk (partition_common.cuh kChunk)
MAX_SEGMENTS = 1024  # segments a call (kMaxSegments); the kernels refuse more
MAX_ROWS = 1 << 30  # the status words count in 30 bits (kMaxRows)
SCRATCH_HEADER = 1  # int64 words before the status words (kScratchWords u32)
# the kernels' scratch, one buffer per (device, stream), grown when a call
# needs more; every launch leaves it ready for the next one on its stream
_scratch = {}


def reset_counts() -> None:
    for d in (launches, plain_calls):
        for k in d:
            d[k] = 0


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lgbt_partition.argtypes = [p, p, p, p, ll, i, p, p, p, p]
    lib.lgbt_partition.restype = i
    lib.lgbt_partition_lanes.argtypes = [p, p, p, p, i, ll, i, p, p, p, p]
    lib.lgbt_partition_lanes.restype = i


LIBRARY = KernelLibrary("partition.cu", _bind)


def scratch(device: torch.device, stream: int, n: int, s: int) -> torch.Tensor:
    """The partition kernels' scratch for ``n`` positions and ``s``
    segments on ``stream`` of ``device`` (partition_common.cuh: epoch and
    block count, then one status word a segment chunk).  It is
    zeroed once when it is allocated or grown, never per call: each launch
    leaves it ready for the next launch in stream order.  A captured CUDA
    graph bakes in the buffer's address: ops/graphs.py keeps the buffer
    alive, growing it replaces the entry for later launches only, and a
    capture that would grow it raises."""
    words = SCRATCH_HEADER + (n + CHUNK - 1) // CHUNK + s
    key = (device.index, stream)
    buf = _scratch.get(key)
    if buf is None or buf.numel() < words:
        if torch.cuda.is_current_stream_capturing():
            # a graph would bake in a buffer from its own pool: the capture
            # must find the scratch ready (ops/graphs.py warms up first)
            raise RuntimeError(
                f"partition scratch for {n} positions and {s} segments is "
                "not allocated on the capturing stream; run the round once "
                "on that stream before capturing it")
        buf = torch.zeros(words, dtype=torch.int64, device=device)
        _scratch[key] = buf
    return buf


def scratch_of(device: torch.device, stream: int):
    """The scratch allocated for ``stream`` of ``device``, or None."""
    return _scratch.get((device.index, stream))


def check_segments(order, seg_start, seg_len, go_left) -> None:
    if order.dim() != 1 or order.dtype != torch.int32:
        raise TypeError(f"order must be (N,) int32, got {tuple(order.shape)} "
                        f"{order.dtype}")
    n = order.shape[0]
    if n >= MAX_ROWS:
        raise ValueError(f"the partition kernels take fewer than {MAX_ROWS} "
                         f"positions, got {n}")
    if go_left.dtype != torch.bool or go_left.shape != (n,):
        raise TypeError(f"go_left must be ({n},) bool, got "
                        f"{tuple(go_left.shape)} {go_left.dtype}")
    s = seg_start.shape
    for name, t in (("seg_start", seg_start), ("seg_len", seg_len)):
        if t.dtype != torch.int32 or t.dim() != 1 or t.shape != s:
            raise TypeError(f"{name} must be (S,) int32 like seg_start, got "
                            f"{tuple(t.shape)} {t.dtype}")
    for name, t in (("go_left", go_left), ("seg_start", seg_start),
                    ("seg_len", seg_len)):
        if t.device != order.device:
            raise ValueError(f"{name} is on {t.device}, order on {order.device}")
    for name, t in (("order", order), ("go_left", go_left),
                    ("seg_start", seg_start), ("seg_len", seg_len)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def partition_segments(order, seg_start, seg_len, go_left):
    """Stably partition each segment [seg_start[s], seg_start[s] +
    seg_len[s]) of ``order`` (disjoint segments, in any order) into its
    go-left rows, then the others.  Returns (new_order (N,) i32, left
    counts (S,) i32); other positions keep order's value.  On the card it
    makes the kernel's one launch and nothing else; S > MAX_SEGMENTS is
    refused by the kernel and raises."""
    if not order.is_cuda:
        return partition_segments_plain(order, seg_start, seg_len, go_left)
    check_segments(order, seg_start, seg_len, go_left)
    n, s = order.shape[0], seg_start.shape[0]
    dev = order.device
    if n == 0 or s == 0:
        return order.clone(), torch.zeros(s, dtype=torch.int32, device=dev)
    out = torch.empty_like(order)
    n_left = torch.empty(s, dtype=torch.int32, device=dev)
    stream = stream_ptr(dev)
    with torch.cuda.device(dev):
        rc = LIBRARY.lib().lgbt_partition(
            order.data_ptr(), go_left.data_ptr(), seg_start.data_ptr(),
            seg_len.data_ptr(), n, s, scratch(dev, stream, n, s).data_ptr(),
            n_left.data_ptr(), out.data_ptr(), stream)
    LIBRARY.raise_on(rc, "partition_segments kernel")
    count_launch(launches, "partition_segments")
    return out, n_left


def partition_segments_plain(order, seg_start, seg_len, go_left):
    plain_calls["partition_segments"] += 1
    sid = segment_ids(seg_start, seg_len, order.shape[0])
    return stable_partition_ranges(order, sid, seg_start, seg_len, go_left)


def partition_segments_lanes(order, seg_start, seg_len, go_left):
    """B2's lane mode (the booster fleet's partition): L independent
    segment partitions in one launch.  order and go_left are (L, N),
    seg_start and seg_len (L, S) with starts relative to their lane's
    order; returns the new orders (L, N) i32 and left counts (L, S) i32,
    each lane's equal to ``partition_segments`` on that lane.  The kernel
    lays each group of G = MAX_SEGMENTS // S lanes end to end in one flat
    space of G * N positions (one chunk table) and takes the groups in
    turn in its one cooperative wave, so it takes S <= MAX_SEGMENTS and
    L * N < MAX_ROWS: beyond that this raises."""
    if not order.is_cuda:
        return partition_segments_lanes_plain(order, seg_start, seg_len, go_left)
    if order.dim() != 2 or seg_start.dim() != 2:
        raise TypeError(f"order must be (L, N) and seg_start (L, S), got "
                        f"{tuple(order.shape)}, {tuple(seg_start.shape)}")
    lanes, n = order.shape
    s = seg_start.shape[1]
    if s > MAX_SEGMENTS or lanes * n >= MAX_ROWS:
        raise ValueError(
            f"partition_segments_lanes takes S <= {MAX_SEGMENTS} segments a lane and "
            f"L * N < {MAX_ROWS} positions, got L={lanes}, S={s}, N={n}")
    check_segments(order.reshape(-1), seg_start.reshape(-1), seg_len.reshape(-1),
                   go_left.reshape(-1))
    if seg_start.shape != (lanes, s) or seg_len.shape != (lanes, s):
        raise TypeError(f"seg_start and seg_len must be ({lanes}, {s})")
    dev = order.device
    if n == 0 or s == 0:
        return order.clone(), torch.zeros((lanes, s), dtype=torch.int32, device=dev)
    out = torch.empty_like(order)
    n_left = torch.empty((lanes, s), dtype=torch.int32, device=dev)
    stream = stream_ptr(dev)
    # each lane group's status words are a run of their own
    group = min(MAX_SEGMENTS // s, lanes)
    groups = -(-lanes // group)
    words_n = groups * -(-group * n // CHUNK) * CHUNK
    with torch.cuda.device(dev):
        rc = LIBRARY.lib().lgbt_partition_lanes(
            order.data_ptr(), go_left.data_ptr(), seg_start.data_ptr(),
            seg_len.data_ptr(), lanes, n, s,
            scratch(dev, stream, words_n, groups * group * s).data_ptr(),
            n_left.data_ptr(), out.data_ptr(), stream)
    LIBRARY.raise_on(rc, "partition_segments_lanes kernel")
    count_launch(launches, "partition_segments_lanes")
    return out, n_left


def partition_segments_lanes_plain(order, seg_start, seg_len, go_left):
    """The solo plain version looped over the lanes."""
    plain_calls["partition_segments_lanes"] += 1
    outs = [stable_partition_ranges(order[l], segment_ids(seg_start[l], seg_len[l],
                                                          order.shape[1]),
                                    seg_start[l], seg_len[l], go_left[l])
            for l in range(order.shape[0])]
    return (torch.stack([o for o, _ in outs]), torch.stack([c for _, c in outs]))
