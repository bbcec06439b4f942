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
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path

import torch

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "hist.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# launch counts of the kernel wrappers and call counts of the plain versions
launches = {"histogram_multi": 0, "histogram_multi_quantized": 0}
plain_calls = {"histogram_multi": 0, "histogram_multi_quantized": 0}
# compiler output of the last build (nvcc -Xptxas -v: registers, smem, spills)
build_log = ""


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
                          num_leaves: int, *, quantized: bool = False) -> int:
    """Leaves histogrammed per pass: 8 for f32 and 20 for int8 at narrow F
    (the JAX package's policy for its f32/bf16x2 and int8 payloads; the
    Hopper-derived tile is ROADMAP queue A9)."""
    ncl = 3 if quantized else 6
    fb = min(n_features_effective if n_features_effective > 0 else 1, 128)
    fb_pad = max(_round_up(fb, 8), 8)
    bpad = _round_up(max(num_bins, 8), 8)
    per_leaf = fb_pad * bpad * 4 * ncl
    if n_features_effective <= 128:
        cap = 20 if quantized else 8
    else:
        cap = 20 if quantized else 10
    return max(1, min(cap, _VMEM_ACC_BUDGET // max(per_leaf, 1), num_leaves))


# ---------------------------------------------------------------------------
# build + bind
# ---------------------------------------------------------------------------
def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc"]:
        if Path(cand).is_file():
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the histogram kernel is built from "
                           f"{_SRC} with the CUDA toolkit (set CUDA_HOME)")
    return found


def build(force: bool = False) -> Path:
    """Compile csrc/hist.cu into build/ (once per source content, or anew
    with ``force``, which also refreshes ``build_log``)."""
    global build_log
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    out = _BUILD_DIR / f"libhist_{tag}.so"
    if out.is_file() and not force:
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SRC)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    build_log = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{build_log}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lgbt_hist_multi_f32.argtypes = [p, p, p, p, p, ll, i, i, i, i, i,
                                        p, p, p, p, p]
    lib.lgbt_hist_multi_f32.restype = i
    lib.lgbt_hist_multi_i8.argtypes = [p, p, p, p, p, ll, i, i, i, i, p, p]
    lib.lgbt_hist_multi_i8.restype = i
    lib.lgbt_error_string.argtypes = [i]
    lib.lgbt_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().lgbt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


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


def _stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------
def histogram_multi(bins, grad, hess, mask, leaf_slot, leaf_base: int,
                    tile: int, num_bins: int) -> torch.Tensor:
    """(tile, 3, F, B) f32 sums of grad, hess and count of the rows with
    mask set and slot = leaf_slot - leaf_base in [0, tile)."""
    if not bins.is_cuda:
        return histogram_multi_plain(bins, grad, hess, mask, leaf_slot,
                                     leaf_base, tile, num_bins)
    _check(bins, (grad, hess), mask, leaf_slot, torch.float32, tile, num_bins)
    n, f = bins.shape
    dev = bins.device
    out = torch.zeros((tile, 3, f, num_bins), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    absmax = torch.zeros(2, dtype=torch.int32, device=dev)
    acc64 = torch.zeros((tile, 2, f, num_bins), dtype=torch.int64, device=dev)
    acc32 = torch.zeros((tile, f, num_bins), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().lgbt_hist_multi_f32(
            bins.data_ptr(), grad.data_ptr(), hess.data_ptr(), mask.data_ptr(),
            leaf_slot.data_ptr(), n, f, int(leaf_base), int(tile),
            int(num_bins), int(n).bit_length(), absmax.data_ptr(),
            acc64.data_ptr(), acc32.data_ptr(), out.data_ptr(),
            _stream_ptr(dev))
    _raise_on(rc, "histogram_multi kernel")
    launches["histogram_multi"] += 1
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
        rc = _lib().lgbt_hist_multi_i8(
            bins.data_ptr(), grad_q.data_ptr(), hess_q.data_ptr(),
            mask.data_ptr(), leaf_slot.data_ptr(), n, f, int(leaf_base),
            int(tile), int(num_bins), out.data_ptr(), _stream_ptr(dev))
    _raise_on(rc, "histogram_multi_quantized kernel")
    launches["histogram_multi_quantized"] += 1
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


def _fixed_shift(v: torch.Tensor) -> int:
    """Exponent s of the 64-bit fixed point: the kernel's fixed_shift."""
    m = float(v.abs().max()) if v.numel() else 0.0
    return 62 - int(v.shape[0]).bit_length() - math.frexp(m)[1]


def histogram_multi_plain(bins, grad, hess, mask, leaf_slot, leaf_base: int,
                          tile: int, num_bins: int) -> torch.Tensor:
    plain_calls["histogram_multi"] += 1
    n, f = bins.shape
    rows, idx = _rows_and_index(bins, mask, leaf_slot, leaf_base, tile,
                                num_bins)
    idx = idx.reshape(-1)
    size = tile * f * num_bins
    chans = []
    for v in (grad, hess):
        sh = _fixed_shift(v)
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
