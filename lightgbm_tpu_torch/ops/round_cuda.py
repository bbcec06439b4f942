"""The round megakernel: the hand-written Hopper kernel and its plain
version.

The kernel (csrc/round.cu) replaces lightgbm_tpu/ops/round_pallas.py::
_mk_kernel with its fused tail: one windowed round's partition, the small
children's window histograms read straight from the row-major bins through
the new order, the siblings by subtraction, and the per-feature split
search, with the categorical candidates on the features of a categorical
mask and the feature_contri scaling when given (the TPU kernel's has_cat
and has_contri tails), and the CEGB split penalty (cegb_penalty_split, which
the TPU kernel's gain_plane applies from its params).  ``select_from_feature_best`` (ops/split.py)
finishes the cross-feature choice in torch, and replays a categorical
winner's left-bin mask, as the JAX package does outside its kernel.

Dispatch rule: a CUDA tensor launches the kernel or raises; only a tensor
on the CPU takes the plain version, which is the three-pass round's own
arithmetic (partition, gathered window through the histogram kernel's plain
version, subtraction, ops/split.py::gain_plane + reduce_plane_per_feature).
Left/right histograms agree bit for bit (same fixed point, same exponents);
the per-feature bests too where the float64 prefix sums are exact (see
ops/split.py::gain_plane).
"""

from __future__ import annotations

import ctypes

import torch

from . import hist_cuda
from .cuda_build import KernelLibrary, count_launch, stream_ptr
from .partition import segment_ids, stable_partition_ranges
from .partition_cuda import MAX_ROWS, scratch
from .split import FeatureBests, SplitParams, gain_plane, reduce_plane_per_feature

launches = {"round_megakernel": 0}
plain_calls = {"round_megakernel": 0}


def reset_counts() -> None:
    launches["round_megakernel"] = 0
    plain_calls["round_megakernel"] = 0


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.lgbt_round.argtypes = (
        [p, ll, i, i, i] + [p] * 13 + [ll] + [p] * 12 + [f] * 7 + [i]
        + [f, f, i, i, f] + [p] * 8)
    lib.lgbt_round.restype = i


LIBRARY = KernelLibrary("round.cu", _bind, extra_flags=["--fmad=false"])


def window_rows(order: torch.Tensor, win_start: torch.Tensor,
                win_cnt: torch.Tensor, W: int):
    """The round's windows laid end to end in W slots: row id (int64), slot
    (int32) and validity of each.  Slot s's rows are order[win_start[s] +
    i], i < win_cnt[s]; slots past the windows' total are not valid."""
    dev = order.device
    T = win_cnt.shape[0]
    offs = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                      torch.cumsum(win_cnt.long(), 0)])
    aw = torch.arange(W, dtype=torch.int64, device=dev)
    slot_of = (aw[:, None] >= offs[1:][None, :]).sum(1).clamp(0, T - 1)
    valid = aw < offs[-1]
    wpos = torch.where(valid, win_start.long()[slot_of] + aw - offs[slot_of], 0)
    return order[wpos].long(), slot_of.to(torch.int32), valid


def window_histograms(hist_fn, order, bins, vals, row_mask, win_start, win_cnt,
                      W: int, T: int, num_bins: int, **kw):
    """The three-pass round's window pass: the windows' rows gathered into
    a (W, F) block and histogrammed by ``hist_fn`` (a multi-leaf histogram
    entry point of ops/hist_cuda.py, with ``vals`` its two payloads), one
    slot per window."""
    rows, slot_of, valid = window_rows(order, win_start, win_cnt, W)
    return hist_fn(bins.index_select(0, rows), vals[0][rows], vals[1][rows],
                   row_mask[rows] & valid, slot_of, 0, T, num_bins, **kw)


def split_window(parent, fresh, small_left):
    """(left, right) children from the parents' histograms and the small
    children's ``fresh`` ones: the large sibling by subtraction."""
    big = parent - fresh
    sml = (small_left != 0)[:, None, None, None]
    return torch.where(sml, fresh, big), torch.where(sml, big, fresh)


def _check(bins, order, go_left, grad, hess, row_mask, tvecs, parent, cand_tab,
           nbpf, mbpf, fmask, cmask=None, contri=None):
    if bins.dim() != 2 or bins.dtype != torch.int16:
        raise TypeError(f"bins must be (N, F) int16, got {tuple(bins.shape)} "
                        f"{bins.dtype}")
    n, f = bins.shape
    T = tvecs[0].shape[0]
    b = parent.shape[-1] if parent.dim() == 4 else -1
    want = [("order", order, (n,), torch.int32), ("go_left", go_left, (n,), torch.bool),
            ("grad", grad, (n,), torch.float32), ("hess", hess, (n,), torch.float32),
            ("row_mask", row_mask, (n,), torch.bool),
            ("parent", parent, (T, 3, f, b), torch.float32),
            ("cand_tab", cand_tab, (4, 2 * T), torch.float32),
            ("num_bins_per_feature", nbpf, (f,), torch.int32),
            ("missing_bin_per_feature", mbpf, (f,), torch.int32),
            ("feature_mask", fmask, (f,), torch.bool)]
    want += [(name, t, (f,), dt) for name, t, dt in
             (("categorical_mask", cmask, torch.bool),
              ("feature_contri", contri, torch.float32)) if t is not None]
    want += [(f"segment/window table {i}", t, (T,), torch.int32)
             for i, t in enumerate(tvecs)]
    for name, t, shape, dt in want:
        if t.dtype != dt or tuple(t.shape) != shape:
            raise TypeError(f"{name} must be {shape} {dt}, got {tuple(t.shape)} "
                            f"{t.dtype}")
        if t.device != bins.device:
            raise ValueError(f"{name} is on {t.device}, bins on {bins.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not bins.is_contiguous():
        raise ValueError("bins must be contiguous")
    if n >= MAX_ROWS:
        raise ValueError(f"the round kernel takes fewer than {MAX_ROWS} rows, got {n}")
    if T < 1 or b < 1:
        raise ValueError(f"need at least one slot and one bin, got T={T}, B={b}")
    if cmask is not None and b > 256:
        raise ValueError(f"the categorical search takes at most 256 bins, got {b}")


def round_megakernel(bins, order, go_left, grad, hess, row_mask, seg_start,
                     seg_len, n_left, win_start, win_cnt, small_left, parent,
                     cand_tab, num_bins_per_feature, missing_bin_per_feature,
                     feature_mask, *, params: SplitParams, W: int, shift,
                     categorical_mask=None, feature_contri=None):
    """One round: returns (new_order (N,) i32, left (T, 3, F, B), right
    (T, 3, F, B), FeatureBests (2T, F)).  ``categorical_mask`` (F,) bool
    and ``feature_contri`` (F,) f32 are gain_plane's (B <= 256 with a
    categorical mask).

    Segments (seg_start, seg_len, n_left: (T,) i32) are the split leaves'
    position ranges and their left counts; windows (win_start, win_cnt) the
    small children's ranges in the new order, at most W rows each;
    small_left (T,) i32 is 1 where the left child is the windowed one.
    parent (T, 3, F, B) holds the split leaves' histograms, cand_tab (4, 2T)
    the parent sum_g, sum_h, count and output of the 2T children (left
    children first), for the split search.  ``shift`` is the tree's
    fixed-point exponent pair: an int32[2] tensor (hist_cuda.
    fixed_shift_tensor) that the kernel reads when it runs, so a captured
    CUDA graph takes each tree's; a pair of ints (fixed_shift_pair) is
    copied to the device first, which a capture does not allow."""
    tvecs = (seg_start, seg_len, n_left, win_start, win_cnt, small_left)
    tables = dict(categorical_mask=categorical_mask, feature_contri=feature_contri)
    if not bins.is_cuda:
        return round_megakernel_plain(
            bins, order, go_left, grad, hess, row_mask, *tvecs, parent, cand_tab,
            num_bins_per_feature, missing_bin_per_feature, feature_mask,
            params=params, W=W, shift=shift, **tables)
    _check(bins, order, go_left, grad, hess, row_mask, tvecs, parent, cand_tab,
           num_bins_per_feature, missing_bin_per_feature, feature_mask,
           categorical_mask, feature_contri)
    n, f = bins.shape
    T, b = seg_start.shape[0], parent.shape[3]
    dev = bins.device

    def empty(shape, dt=torch.float32):
        return torch.empty(shape, dtype=dt, device=dev)

    new_order = empty((n,), torch.int32)
    left, right = empty((T, 3, f, b)), empty((T, 3, f, b))
    acc64 = empty((T, 2, f, b), torch.int64)
    acc32 = empty((T, f, b), torch.int32)
    c = 2 * T
    o_gain, o_lg, o_lh, o_lc = (empty((c, f)) for _ in range(4))
    o_thr, o_var = empty((c, f), torch.int32), empty((c, f), torch.int32)
    o_left = empty((c, f), torch.bool)
    shift = hist_cuda.shift_on(shift, dev)
    if shift is None:
        raise TypeError("round_megakernel needs the tree's exponent pair (shift)")
    p = params
    stream = stream_ptr(dev)
    with torch.cuda.device(dev):
        rc = LIBRARY.lib().lgbt_round(
            bins.data_ptr(), n, f, b, T, order.data_ptr(), go_left.data_ptr(),
            seg_start.data_ptr(), seg_len.data_ptr(), n_left.data_ptr(),
            scratch(dev, stream, n, T).data_ptr(), new_order.data_ptr(),
            grad.data_ptr(), hess.data_ptr(), row_mask.data_ptr(),
            win_start.data_ptr(), win_cnt.data_ptr(), small_left.data_ptr(),
            int(W), shift.data_ptr(), acc64.data_ptr(),
            acc32.data_ptr(), parent.data_ptr(), left.data_ptr(),
            right.data_ptr(), num_bins_per_feature.data_ptr(),
            missing_bin_per_feature.data_ptr(), feature_mask.data_ptr(),
            *(None if t is None else t.data_ptr() for t in tables.values()),
            cand_tab.data_ptr(), p.lambda_l1, p.lambda_l2,
            float(p.min_data_in_leaf), p.min_sum_hessian_in_leaf,
            p.min_gain_to_split, p.max_delta_step, p.path_smooth,
            int(p.path_smooth > 0), p.lambda_l2 + p.cat_l2, p.cat_smooth,
            int(p.max_cat_threshold), int(p.max_cat_to_onehot),
            (p.cegb_tradeoff * p.cegb_penalty_split
             if p.cegb_penalty_split > 0 else -1.0),
            o_gain.data_ptr(), o_thr.data_ptr(), o_left.data_ptr(),
            o_var.data_ptr(), o_lg.data_ptr(), o_lh.data_ptr(),
            o_lc.data_ptr(), stream)
    LIBRARY.raise_on(rc, "round_megakernel kernel")
    count_launch(launches, "round_megakernel")
    fb = FeatureBests(gain=o_gain, threshold_bin=o_thr, use_left=o_left,
                      variant=o_var, left_g=o_lg, left_h=o_lh, left_c=o_lc)
    return new_order, left, right, fb


def round_megakernel_plain(bins, order, go_left, grad, hess, row_mask,
                           seg_start, seg_len, n_left, win_start, win_cnt,
                           small_left, parent, cand_tab, num_bins_per_feature,
                           missing_bin_per_feature, feature_mask, *,
                           params: SplitParams, W: int, shift,
                           categorical_mask=None, feature_contri=None):
    plain_calls["round_megakernel"] += 1
    n = order.shape[0]
    T, b = seg_start.shape[0], parent.shape[3]
    sid = segment_ids(seg_start, seg_len, n)
    new_order, _ = stable_partition_ranges(order, sid, seg_start, seg_len, go_left)
    fresh = window_histograms(hist_cuda.histogram_multi_plain, new_order, bins,
                              (grad, hess), row_mask, win_start, win_cnt, W, T,
                              b, shift=shift)
    left, right = split_window(parent, fresh, small_left)
    gain, ctx = gain_plane(torch.cat([left, right]), cand_tab[0], cand_tab[1],
                           cand_tab[2], num_bins_per_feature,
                           missing_bin_per_feature, params,
                           feature_mask=feature_mask, parent_output=cand_tab[3],
                           categorical_mask=categorical_mask,
                           feature_contri=feature_contri)
    return new_order, left, right, reduce_plane_per_feature(gain, ctx)
