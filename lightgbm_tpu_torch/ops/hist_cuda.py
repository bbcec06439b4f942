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
launches = {"histogram_multi": 0, "histogram_multi_bf16": 0,
            "histogram_multi_quantized": 0}
plain_calls = {"histogram_multi": 0, "histogram_multi_bf16": 0,
               "histogram_multi_quantized": 0}


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
    grad, hess = (v.float() for v in _payload(grad, hess, precision))
    plain_calls["histogram_multi_bf16" if precision == "bf16"
                else "histogram_multi"] += 1
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
