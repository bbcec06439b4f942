"""Multi-leaf histogram: the hand-written Hopper kernel and its plain version.

The kernel (csrc/hist.cu) replaces lightgbm_tpu/ops/hist_pallas.py::
_direct_kernel; the source note there says what bounds it and how its
design answers.  This module builds it (nvcc into a shared library with a
plain C interface, loaded with ctypes, at first use), checks and launches
it, and holds the plain PyTorch version of every entry point.

Dispatch rule: a CUDA tensor launches the kernel or raises; only a tensor
that lies on the CPU takes the plain version.  No failure is caught and
turned into the plain path.

Float sums are 64-bit fixed point with a per-call exponent (see the source
note): both the kernel and the plain version quantize each value the same
way and add integers, so they agree bit for bit and repeat bit for bit.
``precision="bf16"`` (the JAX package's hist_precision=bf16) rounds grad
and hess to bfloat16 before the pass, outside the kernel as the JAX package
builds its payload outside its kernel, and the kernel reads the 2-byte
values; the sums are the same fixed point.

Two further modes: the lane mode (``histogram_multi_lanes`` and its int8
twin: L lanes' window histograms over shared bins in one launch, each lane
through its own row ids and exponents, the booster fleet's) and the carried
mode (``histogram_multi_carry``: a sweep's chunks added into one
accumulator the caller keeps, converted to f32 once, the out-of-core spill
grower's).  Each plain version is the solo plain version's arithmetic:
looped over the lanes, or its integer sums added.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ..utils.guards import NonFiniteError
from ..utils.sanitizer import sync_pull
from .cuda_build import KernelLibrary, count_launch, stream_ptr

# launch counts of the kernel wrappers and call counts of the plain versions
_NAMES = ("histogram_multi", "histogram_multi_bf16", "histogram_multi_quantized",
          "histogram_multi_lanes", "histogram_multi_quantized_lanes",
          "histogram_multi_carry")
launches = dict.fromkeys(_NAMES, 0)
plain_calls = dict.fromkeys(_NAMES, 0)


def reset_counts() -> None:
    for d in (launches, plain_calls):
        for k in d:
            d[k] = 0


# ---------------------------------------------------------------------------
# leaf-tile policy: a copy of hist_pallas.recommended_leaf_tile, so both
# packages admit the same number of splits per round and grow the same trees
# ---------------------------------------------------------------------------
_VMEM_ACC_BUDGET = 8_000_000


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def recommended_leaf_tile(num_bins: int, n_features_effective: int,
                          num_leaves: int, *, quantized: bool = False,
                          hist_precision: str = "f32") -> int:
    """Leaves histogrammed per pass: at narrow F 8 for f32, 16 for bf16 and
    20 for int8 (the JAX package's policy for its 6-lane bf16x2, 3-lane
    bf16 and 3-lane int8 payloads; the Hopper-derived tile is ROADMAP queue
    A17)."""
    ncl = 3 if (quantized or hist_precision == "bf16") else 6
    fb = min(n_features_effective if n_features_effective > 0 else 1, 128)
    fb_pad = max(_round_up(fb, 8), 8)
    bpad = _round_up(max(num_bins, 8), 8)
    per_leaf = fb_pad * bpad * 4 * ncl
    if n_features_effective <= 128:
        cap = 8 if ncl == 6 else (20 if quantized else 16)
    else:
        cap = 20 if quantized else 10
    return max(1, min(cap, _VMEM_ACC_BUDGET // max(per_leaf, 1), num_leaves))


# ---------------------------------------------------------------------------
# build + bind
# ---------------------------------------------------------------------------
def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in (lib.lgbt_hist_multi_f32, lib.lgbt_hist_multi_bf16):
        fn.argtypes = [p, p, p, p, p, ll, i, i, i, i, i, p, p, p, p, p, p]
        fn.restype = i
    lib.lgbt_hist_multi_i8.argtypes = [p, p, p, p, p, ll, i, i, i, i, p, p]
    lib.lgbt_hist_multi_i8.restype = i
    lib.lgbt_hist_multi_f32_carry.argtypes = [p, p, p, p, p, ll, i, i, i, i, p, p, p,
                                              p, i, p]
    lib.lgbt_hist_multi_f32_carry.restype = i
    lib.lgbt_hist_multi_lanes_f32.argtypes = [p, p, p, p, p, p, ll, ll, i, i, i, i, p,
                                              p, p, p, i, p]
    lib.lgbt_hist_multi_lanes_f32.restype = i
    lib.lgbt_hist_multi_lanes_i8.argtypes = [p, p, p, p, p, p, ll, ll, i, i, i, i, p, p]
    lib.lgbt_hist_multi_lanes_i8.restype = i


LIBRARY = KernelLibrary("hist.cu", _bind)


def _check(bins, payload, mask, leaf_slot, payload_dtype, tile, num_bins):
    if bins.dim() != 2 or bins.dtype != torch.int16:
        raise TypeError(f"bins must be (N, F) int16, got {tuple(bins.shape)} "
                        f"{bins.dtype}")
    n = bins.shape[0]
    for name, t, dt in (("grad", payload[0], payload_dtype),
                        ("hess", payload[1], payload_dtype),
                        ("mask", mask, torch.bool),
                        ("leaf_slot", leaf_slot, torch.int32)):
        if t.dtype != dt or t.shape != (n,):
            raise TypeError(f"{name} must be ({n},) {dt}, got "
                            f"{tuple(t.shape)} {t.dtype}")
    for name, t in (("bins", bins), ("grad", payload[0]), ("hess", payload[1]),
                    ("mask", mask), ("leaf_slot", leaf_slot)):
        if t.device != bins.device:
            raise ValueError(f"{name} is on {t.device}, bins on {bins.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tile < 1 or num_bins < 1:
        raise ValueError(f"tile and num_bins must be >= 1, got {tile}, "
                         f"{num_bins}")


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------
def _payload(grad, hess, precision: str):
    """grad and hess as the pass reads them: f32, or rounded to bfloat16
    (round to nearest even; a no-op on values already bfloat16)."""
    if precision == "f32":
        return grad, hess
    if precision == "bf16":
        return grad.to(torch.bfloat16), hess.to(torch.bfloat16)
    raise ValueError(f"precision must be f32 or bf16, got {precision!r}")


def histogram_multi(bins, grad, hess, mask, leaf_slot, leaf_base: int,
                    tile: int, num_bins: int, shift=None,
                    precision: str = "f32") -> torch.Tensor:
    """(tile, 3, F, B) f32 sums of grad, hess and count of the rows with
    mask set and slot = leaf_slot - leaf_base in [0, tile).  With
    ``precision="bf16"`` grad and hess are summed rounded to bfloat16.

    ``shift`` fixes the fixed-point exponents of grad and hess: an int32[2]
    tensor on the rows' device (fixed_shift_tensor), which the kernel reads
    when it runs, so a captured CUDA graph takes each tree's; or a pair of
    ints (fixed_shift_pair), copied to the device first.  By default they
    come from this call's own rows, as fixed_shift_pair(grad, hess) would
    give them."""
    grad, hess = _payload(grad, hess, precision)
    if not bins.is_cuda:
        return histogram_multi_plain(bins, grad, hess, mask, leaf_slot,
                                     leaf_base, tile, num_bins, shift=shift,
                                     precision=precision)
    bf16 = precision == "bf16"
    _check(bins, (grad, hess), mask, leaf_slot,
           torch.bfloat16 if bf16 else torch.float32, tile, num_bins)
    n, f = bins.shape
    dev = bins.device
    out = torch.zeros((tile, 3, f, num_bins), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    absmax = torch.zeros(2, dtype=torch.int32, device=dev)
    acc64 = torch.zeros((tile, 2, f, num_bins), dtype=torch.int64, device=dev)
    acc32 = torch.zeros((tile, f, num_bins), dtype=torch.int32, device=dev)
    shift = shift_on(shift, dev)
    lib = LIBRARY.lib()
    with torch.cuda.device(dev):
        rc = (lib.lgbt_hist_multi_bf16 if bf16 else lib.lgbt_hist_multi_f32)(
            bins.data_ptr(), grad.data_ptr(), hess.data_ptr(), mask.data_ptr(),
            leaf_slot.data_ptr(), n, f, int(leaf_base), int(tile),
            int(num_bins), int(n).bit_length(),
            None if shift is None else shift.data_ptr(),
            absmax.data_ptr(), acc64.data_ptr(), acc32.data_ptr(),
            out.data_ptr(), stream_ptr(dev))
    name = "histogram_multi_bf16" if bf16 else "histogram_multi"
    LIBRARY.raise_on(rc, name + " kernel")
    count_launch(launches, name)
    return out


def histogram_multi_quantized(bins, grad_q, hess_q, mask, leaf_slot,
                              leaf_base: int, tile: int,
                              num_bins: int) -> torch.Tensor:
    """(tile, 3, F, B) int32 exact sums of int8 grad_q, hess_q and count."""
    if not bins.is_cuda:
        return histogram_multi_quantized_plain(
            bins, grad_q, hess_q, mask, leaf_slot, leaf_base, tile, num_bins)
    _check(bins, (grad_q, hess_q), mask, leaf_slot, torch.int8, tile,
           num_bins)
    n, f = bins.shape
    dev = bins.device
    out = torch.zeros((tile, 3, f, num_bins), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    with torch.cuda.device(dev):
        rc = LIBRARY.lib().lgbt_hist_multi_i8(
            bins.data_ptr(), grad_q.data_ptr(), hess_q.data_ptr(),
            mask.data_ptr(), leaf_slot.data_ptr(), n, f, int(leaf_base),
            int(tile), int(num_bins), out.data_ptr(), stream_ptr(dev))
    LIBRARY.raise_on(rc, "histogram_multi_quantized kernel")
    count_launch(launches, "histogram_multi_quantized")
    return out


def _check_acc(name, t, shape, dtype, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise TypeError(f"{name} must be {tuple(shape)} {dtype}, got "
                        f"{tuple(t.shape)} {t.dtype}")
    if t.device != torch.device(device) or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous on {device}")


class CarryAccumulator:
    """The carried float mode's accumulators (B1 over a sweep of row
    chunks, the out-of-core spill grower's): int64 fixed-point sums of grad
    and hess and int32 counts, (tile, 2, F, B) and (tile, F, B), kept by
    the caller across the sweep's calls.  Every chunk is summed with the
    sweep's exponent pair (``shift``: the tree's, from all N rows), so the
    sums, and the f32 histogram ``histogram_multi_carry`` writes after the
    last chunk, are the in-memory call's bit for bit."""

    def __init__(self, tile: int, f: int, num_bins: int, shift, device):
        self.shape = (tile, f, num_bins)
        self.shift = shift_on(shift, device)
        if self.shift is None:
            raise TypeError("the carried mode needs the sweep's exponent pair")
        self.acc64 = torch.zeros((tile, 2, f, num_bins), dtype=torch.int64,
                                 device=device)
        self.acc32 = torch.zeros((tile, f, num_bins), dtype=torch.int32,
                                 device=device)


def histogram_multi_carry(bins, grad, hess, mask, leaf_slot, leaf_base: int,
                          acc: CarryAccumulator, finalize: bool = False
                          ) -> Optional[torch.Tensor]:
    """B1's carried float mode: add the rows of one chunk of a sweep (bins
    (C, F), their grad, hess, mask and slot) into ``acc``; with
    ``finalize``, after this chunk, return the sweep's (tile, 3, F, B) f32
    histogram (one conversion a sweep), else None.  One launch a call on
    the card (the conversion rides in it)."""
    tile, f, num_bins = acc.shape
    if not bins.is_cuda:
        return histogram_multi_carry_plain(bins, grad, hess, mask, leaf_slot,
                                           leaf_base, acc, finalize)
    _check(bins, (grad, hess), mask, leaf_slot, torch.float32, tile, num_bins)
    if bins.shape[1] != f:
        raise TypeError(f"bins have {bins.shape[1]} columns, the accumulator {f}")
    dev = bins.device
    _check_acc("acc64", acc.acc64, (tile, 2, f, num_bins), torch.int64, dev)
    _check_acc("acc32", acc.acc32, (tile, f, num_bins), torch.int32, dev)
    out = (torch.empty((tile, 3, f, num_bins), dtype=torch.float32, device=dev)
           if finalize else None)
    with torch.cuda.device(dev):
        rc = LIBRARY.lib().lgbt_hist_multi_f32_carry(
            bins.data_ptr(), grad.data_ptr(), hess.data_ptr(), mask.data_ptr(),
            leaf_slot.data_ptr(), bins.shape[0], f, int(leaf_base), int(tile),
            int(num_bins), acc.shift.data_ptr(), acc.acc64.data_ptr(),
            acc.acc32.data_ptr(), None if out is None else out.data_ptr(),
            int(finalize), stream_ptr(dev))
    LIBRARY.raise_on(rc, "histogram_multi_carry kernel")
    count_launch(launches, "histogram_multi_carry")
    return out


def _check_lanes(bins, grad, hess, mask, rows, slot, payload_dtype, tile,
                 num_bins):
    if bins.dim() != 2 or bins.dtype != torch.int16:
        raise TypeError(f"bins must be (N, F) int16, got {tuple(bins.shape)} "
                        f"{bins.dtype}")
    n = bins.shape[0]
    if rows.dim() != 2:
        raise TypeError(f"rows must be (L, W) int32, got {tuple(rows.shape)}")
    lanes, w = rows.shape
    for name, t, shape, dt in (("grad", grad, (lanes, n), payload_dtype),
                               ("hess", hess, (lanes, n), payload_dtype),
                               ("mask", mask, (lanes, n), torch.bool),
                               ("rows", rows, (lanes, w), torch.int32),
                               ("slot", slot, (lanes, w), torch.int32)):
        if t.dtype != dt or tuple(t.shape) != shape:
            raise TypeError(f"{name} must be {shape} {dt}, got "
                            f"{tuple(t.shape)} {t.dtype}")
        if t.device != bins.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {bins.device}")
    if not bins.is_contiguous():
        raise ValueError("bins must be contiguous")
    if tile < 1 or num_bins < 1 or lanes < 1 or lanes > 65535:
        raise ValueError(f"need 1 <= lanes <= 65535, tile and num_bins >= 1, got "
                         f"{lanes}, {tile}, {num_bins}")


def histogram_multi_lanes(bins, grad, hess, mask, rows, slot, shift, tile: int,
                          num_bins: int, precision: str = "f32") -> torch.Tensor:
    """B1's lane mode (the booster fleet's window pass): (L, tile, 3, F, B)
    f32 histograms of L lanes over the shared bins (N, F) in one launch.
    Lane l's position p is row rows[l, p] in slot slot[l, p] (a slot
    outside [0, tile) is skipped), summed from grad / hess[l, row] where
    mask[l, row], with lane l's exponent pair shift[l] ((L, 2) int32 on the
    device).  Each lane's slice equals, bit for bit, ``histogram_multi`` of
    that lane's gathered rows with its own exponents."""
    grad, hess = _payload(grad, hess, precision)
    if not bins.is_cuda:
        return histogram_multi_lanes_plain(bins, grad, hess, mask, rows, slot,
                                           shift, tile, num_bins, precision)
    bf16 = precision == "bf16"
    _check_lanes(bins, grad, hess, mask, rows, slot,
                 torch.bfloat16 if bf16 else torch.float32, tile, num_bins)
    lanes, w = rows.shape
    n, f = bins.shape
    dev = bins.device
    _check_acc("shift", shift, (lanes, 2), torch.int32, dev)
    out = torch.empty((lanes, tile, 3, f, num_bins), dtype=torch.float32, device=dev)
    acc64 = torch.zeros((lanes, tile, 2, f, num_bins), dtype=torch.int64, device=dev)
    acc32 = torch.zeros((lanes, tile, f, num_bins), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = LIBRARY.lib().lgbt_hist_multi_lanes_f32(
            bins.data_ptr(), grad.data_ptr(), hess.data_ptr(), mask.data_ptr(),
            rows.data_ptr(), slot.data_ptr(), n, w, f, lanes, int(tile),
            int(num_bins), shift.data_ptr(), acc64.data_ptr(), acc32.data_ptr(),
            out.data_ptr(), int(bf16), stream_ptr(dev))
    LIBRARY.raise_on(rc, "histogram_multi_lanes kernel")
    count_launch(launches, "histogram_multi_lanes")
    return out


def histogram_multi_quantized_lanes(bins, grad_q, hess_q, mask, rows, slot,
                                    tile: int, num_bins: int) -> torch.Tensor:
    """B1's int8 lane mode: (L, tile, 3, F, B) int32 exact sums, lane by
    lane ``histogram_multi_lanes``'s geometry."""
    if not bins.is_cuda:
        return histogram_multi_quantized_lanes_plain(bins, grad_q, hess_q, mask,
                                                     rows, slot, tile, num_bins)
    _check_lanes(bins, grad_q, hess_q, mask, rows, slot, torch.int8, tile, num_bins)
    lanes, w = rows.shape
    n, f = bins.shape
    dev = bins.device
    out = torch.zeros((lanes, tile, 3, f, num_bins), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = LIBRARY.lib().lgbt_hist_multi_lanes_i8(
            bins.data_ptr(), grad_q.data_ptr(), hess_q.data_ptr(), mask.data_ptr(),
            rows.data_ptr(), slot.data_ptr(), n, w, f, lanes, int(tile),
            int(num_bins), out.data_ptr(), stream_ptr(dev))
    LIBRARY.raise_on(rc, "histogram_multi_quantized_lanes kernel")
    count_launch(launches, "histogram_multi_quantized_lanes")
    return out


def histogram(bins, grad, hess, mask, num_bins: int) -> torch.Tensor:
    """Single-leaf (3, F, B) f32 histogram: a tile-1 call."""
    slot = torch.zeros(bins.shape[0], dtype=torch.int32, device=bins.device)
    return histogram_multi(bins, grad, hess, mask, slot, 0, 1, num_bins)[0]


def histogram_quantized(bins, grad_q, hess_q, mask,
                        num_bins: int) -> torch.Tensor:
    """Single-leaf (3, F, B) int32 histogram: a tile-1 call."""
    slot = torch.zeros(bins.shape[0], dtype=torch.int32, device=bins.device)
    return histogram_multi_quantized(bins, grad_q, hess_q, mask, slot, 0, 1,
                                     num_bins)[0]


# ---------------------------------------------------------------------------
# plain versions: index_add_ over flat (slot, feature, bin) indices
# ---------------------------------------------------------------------------
def _rows_and_index(bins, mask, leaf_slot, leaf_base, tile, num_bins):
    """Contributing rows and their flat (slot * F + feature) * B + bin
    indices, (R, F) int64."""
    n, f = bins.shape
    s = leaf_slot.to(torch.int64) - leaf_base
    take = mask & (s >= 0) & (s < tile)
    rows = torch.nonzero(take).squeeze(1)
    feat = torch.arange(f, dtype=torch.int64, device=bins.device)
    idx = ((s[rows, None] * f + feat[None, :]) * num_bins
           + bins[rows].to(torch.int64))
    return rows, idx


def _shift_of(absmax: float, n: int) -> int:
    """Exponent s of the 64-bit fixed point: the kernel's fixed_shift."""
    return 62 - int(n).bit_length() - math.frexp(absmax)[1]


def _fixed_shift(v: torch.Tensor) -> int:
    return _shift_of(float(v.abs().max()) if v.numel() else 0.0, v.shape[0])


def fixed_shift_pair(grad: torch.Tensor, hess: torch.Tensor) -> Tuple[int, int]:
    """The exponents a call on these rows derives by default: with them no
    sum of up to len(grad) values overflows 63 bits, so they hold for any
    subset of the rows too.  One blocking host read of max |grad|, max
    |hess| (counted by utils/sanitizer.py); raises NonFiniteError when
    either is not finite (a fixed-point sum cannot carry a NaN or an
    infinity)."""
    n = int(grad.shape[0])
    if n == 0:
        return 62, 62
    gm, hm = (float(v) for v in
              sync_pull(torch.stack([grad.abs().max(), hess.abs().max()])))
    if not (math.isfinite(gm) and math.isfinite(hm)):
        raise NonFiniteError(f"non-finite gradients or hessians (max |g| = "
                             f"{gm}, max |h| = {hm})")
    return _shift_of(gm, n), _shift_of(hm, n)


def fixed_shift_tensor(grad: torch.Tensor, hess: torch.Tensor) -> torch.Tensor:
    """fixed_shift_pair's exponents as an int32[2] tensor, computed on
    grad's device from the same maxima: no host read, so a round that takes
    them stays free of syncs."""
    n = int(grad.shape[0])
    if n == 0:
        return torch.full((2,), 62, dtype=torch.int32, device=grad.device)
    am = torch.stack([grad.abs().max(), hess.abs().max()])
    return (62 - n.bit_length() - torch.frexp(am).exponent).to(torch.int32)


def shift_on(shift, device) -> Optional[torch.Tensor]:
    """The exponent pair as the kernels read it: None (derive per call), or
    an int32[2] on ``device``.  A tensor passes unchanged; a pair of ints
    costs a host-to-device copy, so it cannot be given inside a captured
    CUDA graph."""
    if shift is None:
        return None
    if not torch.is_tensor(shift):
        return torch.tensor([int(shift[0]), int(shift[1])], dtype=torch.int32,
                            device=device)
    if shift.dtype != torch.int32 or tuple(shift.shape) != (2,):
        raise TypeError(f"shift must be (2,) int32, got {tuple(shift.shape)} "
                        f"{shift.dtype}")
    if shift.device != torch.device(device):
        raise ValueError(f"shift is on {shift.device}, the rows on {device}")
    return shift


def histogram_multi_plain(bins, grad, hess, mask, leaf_slot, leaf_base: int,
                          tile: int, num_bins: int, shift=None,
                          precision: str = "f32") -> torch.Tensor:
    plain_calls["histogram_multi_bf16" if precision == "bf16"
                else "histogram_multi"] += 1
    return _multi_plain(bins, grad, hess, mask, leaf_slot, leaf_base, tile,
                        num_bins, shift, precision)


def _multi_plain(bins, grad, hess, mask, leaf_slot, leaf_base, tile, num_bins,
                 shift, precision):
    grad, hess = (v.float() for v in _payload(grad, hess, precision))
    n, f = bins.shape
    rows, idx = _rows_and_index(bins, mask, leaf_slot, leaf_base, tile,
                                num_bins)
    idx = idx.reshape(-1)
    size = tile * f * num_bins
    chans = []
    for i, v in enumerate((grad, hess)):
        sh = _fixed_shift(v) if shift is None else int(shift[i])
        fixed = torch.round(v[rows].double() * math.ldexp(1.0, sh)).long()
        acc = torch.zeros(size, dtype=torch.int64, device=bins.device)
        acc.index_add_(0, idx, fixed[:, None].expand(-1, f).reshape(-1))
        chans.append((acc.double() * math.ldexp(1.0, -sh)).float())
    cnt = torch.zeros(size, dtype=torch.int64, device=bins.device)
    cnt.index_add_(0, idx, torch.ones_like(idx))
    chans.append(cnt.float())
    return torch.stack([c.reshape(tile, f, num_bins) for c in chans], dim=1)


def histogram_multi_quantized_plain(bins, grad_q, hess_q, mask, leaf_slot,
                                    leaf_base: int, tile: int,
                                    num_bins: int) -> torch.Tensor:
    plain_calls["histogram_multi_quantized"] += 1
    return _quantized_plain(bins, grad_q, hess_q, mask, leaf_slot, leaf_base,
                            tile, num_bins)


def _quantized_plain(bins, grad_q, hess_q, mask, leaf_slot, leaf_base, tile,
                     num_bins):
    n, f = bins.shape
    rows, idx = _rows_and_index(bins, mask, leaf_slot, leaf_base, tile,
                                num_bins)
    idx = idx.reshape(-1)
    size = tile * f * num_bins
    chans = []
    for v in (grad_q, hess_q, torch.ones_like(grad_q)):
        acc = torch.zeros(size, dtype=torch.int32, device=bins.device)
        acc.index_add_(0, idx, v[rows].to(torch.int32)[:, None].expand(-1, f)
                       .reshape(-1))
        chans.append(acc.reshape(tile, f, num_bins))
    return torch.stack(chans, dim=1)


def _lane_rows(rows, slot, l: int):
    """Lane l's positions as the solo plain version takes them: row ids
    (int64, 0 where the slot is out of range) and slots."""
    r, s = rows[l].long(), slot[l]
    return torch.where(s >= 0, r, 0), s


def histogram_multi_lanes_plain(bins, grad, hess, mask, rows, slot, shift,
                                tile: int, num_bins: int,
                                precision: str = "f32") -> torch.Tensor:
    """The solo plain version looped over the lanes, each lane's rows
    gathered and summed with its own exponent pair."""
    plain_calls["histogram_multi_lanes"] += 1
    out = []
    for l in range(rows.shape[0]):
        r, s = _lane_rows(rows, slot, l)
        out.append(_multi_plain(bins[r], grad[l][r], hess[l][r], mask[l][r], s, 0,
                                tile, num_bins, (int(shift[l, 0]), int(shift[l, 1])),
                                precision))
    return torch.stack(out)


def histogram_multi_quantized_lanes_plain(bins, grad_q, hess_q, mask, rows, slot,
                                          tile: int, num_bins: int) -> torch.Tensor:
    plain_calls["histogram_multi_quantized_lanes"] += 1
    out = []
    for l in range(rows.shape[0]):
        r, s = _lane_rows(rows, slot, l)
        out.append(_quantized_plain(bins[r], grad_q[l][r], hess_q[l][r], mask[l][r],
                                    s, 0, tile, num_bins))
    return torch.stack(out)


def histogram_multi_carry_plain(bins, grad, hess, mask, leaf_slot, leaf_base: int,
                                acc: CarryAccumulator,
                                finalize: bool = False) -> Optional[torch.Tensor]:
    """The solo plain version's integer sums of one chunk, added into the
    accumulators; the conversion of histogram_multi_plain after the last."""
    plain_calls["histogram_multi_carry"] += 1
    tile, f, num_bins = acc.shape
    rows, idx = _rows_and_index(bins, mask, leaf_slot, leaf_base, tile, num_bins)
    idx = idx.reshape(-1)
    sh = (int(acc.shift[0]), int(acc.shift[1]))
    a64 = acc.acc64.view(tile, 2, -1)
    for i, v in enumerate((grad, hess)):
        fixed = torch.round(v.float()[rows].double() * math.ldexp(1.0, sh[i])).long()
        flat = torch.zeros(tile * f * num_bins, dtype=torch.int64, device=bins.device)
        flat.index_add_(0, idx, fixed[:, None].expand(-1, f).reshape(-1))
        a64[:, i] += flat.view(tile, -1)
    cnt = torch.zeros(tile * f * num_bins, dtype=torch.int64, device=bins.device)
    cnt.index_add_(0, idx, torch.ones_like(idx))
    acc.acc32 += cnt.view(tile, f, num_bins).to(torch.int32)
    if not finalize:
        return None
    chans = [(a64[:, i].double() * math.ldexp(1.0, -sh[i])).float()
             for i in range(2)] + [acc.acc32.view(tile, -1).float()]
    return torch.stack([c.reshape(tile, f, num_bins) for c in chans], dim=1)
