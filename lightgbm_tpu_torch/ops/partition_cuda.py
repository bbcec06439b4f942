"""Stable segment partition: the hand-written Hopper kernel and its plain
version.

The kernel (csrc/partition.cu) replaces lightgbm_tpu/ops/
partition_pallas.py::_partition_kernel; the source note there says what
bounds it and how its design answers.  Dispatch rule: a CUDA tensor
launches the kernel or raises; only a tensor on the CPU takes the plain
version (ops/partition.py::stable_partition_ranges).  The output is a
permutation, so kernel and plain version agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import KernelLibrary, stream_ptr
from .partition import segment_ids, stable_partition_ranges

launches = {"partition_segments": 0}
plain_calls = {"partition_segments": 0}
CHUNK = 1024  # positions per block (partition_common.cuh kChunk)


def reset_counts() -> None:
    launches["partition_segments"] = 0
    plain_calls["partition_segments"] = 0


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lgbt_partition.argtypes = [p, p, p, p, ll, i, p, p, p, p]
    lib.lgbt_partition.restype = i


LIBRARY = KernelLibrary("partition.cu", _bind)


def check_segments(order, seg_start, seg_len, go_left) -> None:
    if order.dim() != 1 or order.dtype != torch.int32:
        raise TypeError(f"order must be (N,) int32, got {tuple(order.shape)} "
                        f"{order.dtype}")
    n = order.shape[0]
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
    seg_len[s]) of ``order`` (disjoint segments) into its go-left rows, then
    the others.  Returns (new_order (N,) i32, left counts (S,) i32); other
    positions keep order's value."""
    if not order.is_cuda:
        return partition_segments_plain(order, seg_start, seg_len, go_left)
    check_segments(order, seg_start, seg_len, go_left)
    n, s = order.shape[0], seg_start.shape[0]
    dev = order.device
    n_left = torch.zeros(s, dtype=torch.int32, device=dev)
    if n == 0 or s == 0:
        return order.clone(), n_left
    out = torch.empty_like(order)
    counts = torch.empty((s, (n + CHUNK - 1) // CHUNK), dtype=torch.int32,
                         device=dev)
    with torch.cuda.device(dev):
        rc = LIBRARY.lib().lgbt_partition(
            order.data_ptr(), go_left.data_ptr(), seg_start.data_ptr(),
            seg_len.data_ptr(), n, s, counts.data_ptr(), n_left.data_ptr(),
            out.data_ptr(), stream_ptr(dev))
    LIBRARY.raise_on(rc, "partition_segments kernel")
    launches["partition_segments"] += 1
    return out, n_left


def partition_segments_plain(order, seg_start, seg_len, go_left):
    plain_calls["partition_segments"] += 1
    sid = segment_ids(seg_start, seg_len, order.shape[0])
    return stable_partition_ranges(order, sid, seg_start, seg_len, go_left)
