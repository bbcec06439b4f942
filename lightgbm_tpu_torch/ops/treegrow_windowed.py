"""Windowed round-batched growth: the wide-regime (Epsilon-class) grower.

Counterpart of lightgbm_tpu/ops/treegrow_windowed.py, single device.  The
rounds grower (ops/treegrow_fast.py) histograms all N rows every round;
this one keeps rows physically grouped by leaf (reference: DataPartition's
[start, count) ranges, src/treelearner/data_partition.hpp) so a round
reads only its small children's rows, the window.

One round (``_round_fused``) is a fixed sequence of device work with no
host read inside it:

* admission, split decisions and segment geometry, as the rounds grower
  admits (best gain first, at most ``leaf_tile`` a round);
* an on-device check that the window fits W, the host's predicted window
  size; a breach makes the round a no-op and reports, so a wrong
  prediction costs a retried round, never a wrong tree;
* either the round megakernel (ops/round_cuda.py: partition, window
  histograms from the row-major bins through the new order, subtraction
  and per-feature split search in one entry point), or the three-pass
  round: the segment partition (ops/partition_cuda.py), the window pass
  (the multi-leaf kernel's window mode, float or int8, reading the window
  rows through the new order: hist_cuda.histogram_window, which the
  megakernel's plain version shares), subtraction (round_cuda.split_window)
  and split search in torch;
* the bookkeeping, and a 6-scalar info vector [admitted splits, window
  rows, fits W, next-window bound, all finite, splits the next round
  admits].

The host (``_run_fused_rounds``, which the rounds grower shares) launches
round r+1 before it reads round r's info vector, which was copied to pinned
memory behind an event one round earlier, so the device queue never
drains; the next W comes from the bound (``whint``): every split's small
child holds at most half of its leaf, so the top-(tile) halves of the live
leaves' counts bound both next rounds' windows.  A tree ends when a round
reports that the next admits nothing: the round already launched then is a
no-op.  utils/sanitizer.py counts rounds, blocking reads (one a tree: the
maxima of the gradients, checked finite before the first round) and async
resolves, and with ops/graphs.py captures, replays and dispatches.

With ``graphs`` (ops/graphs.py; GBDT passes one when fused_training is on)
each round is one run of the same round function on static buffers: on the
card one CUDA-graph replay, captured once per window rung and training.
The tree's inputs (gradients, quantized lanes and scale, masks, exponent
pair) are copied into the buffers before its first round.

Float histograms use one fixed-point exponent pair per tree, taken from
all N rows (hist_cuda.fixed_shift_tensor: an int32[2] on the device, which
the kernels read when they run), so every window histogram equals bit for
bit what the rounds grower's full-N pass gives for the same rows, and the
megakernel's equals the three-pass round's.

State updates are functional but for the (L + 1, 3, F, B) histogram state,
which is written in place (row L is a spare that takes the writes of
inactive slots).  Trees do not depend on W: it only bounds the window.

Scope: numerical and categorical features (a categorical split routes the
bins of its mask left), missing values, max_depth, bagging masks and
sample weights, feature_contri, float and int8-quantized gradients,
hist_precision=bf16 in the root pass and the three-pass window pass (the
megakernel's window pass sums f32, as the JAX package's does), and EFB
bundles: outside the megakernel's envelope, as in the JAX package, so an
EFB tree takes the three-pass round, reports ``megakernel_excluded``
"efb" and counts a megakernel fallback (utils/sanitizer.py); its root pass
and window pass histogram the bundled (N, F_b) matrix and unbundle, while
the partition and the split's go-left test read the feature bins.
Per-node feature sampling (extra_trees, feature_fraction_bynode: the
tree's uniform table ``rng_key``, indexed by node id as in
ops/treegrow.py) is outside the megakernel's envelope too, as in the JAX
package: it takes the three-pass round and reports "node_rng".

Telemetry (obs/, under the JAX package's names): the round loop records
each resolved round's ``train_window_rows`` and ``train_window_fill``
histograms and ``windowed_round`` span, and each tree's
``train_windowed_rounds_total`` / ``train_windowed_retries_total``, the
``windowed_tree`` event and span; the gate counts
``train_megakernel_trees_total`` and ``megakernel_envelope_fallbacks_total``.
All of it runs on the host loop around the launches (never inside a
captured round, whose body a CUDA graph replays without the host) and
reads only what the loop has read already.

Data-parallel (``axis_name``: a parallel/mesh.py::RowShard; the JAX
package's sharded fused round, parallel/data_parallel.py::
grow_tree_windowed_data_parallel): each rank keeps its rows grouped by
leaf and windows its own rows of each round's small children; which child
is the window is chosen by the GLOBAL physical counts (one psum of the
segments' left counts), so every rank windows the same child, as the
serial round does.  The round runs B3 unfused (round_cuda.
round_partition_window: partition and window pass, the sums left in fixed
point) or the three-pass round, then merges the window sums exactly
(ops/histogram.py::merge_carry, or the int8 histograms as integers) with
``merge="psum"`` (every rank holds the (T, 3, F, B) block and searches
every feature) or ``merge="scatter"`` (reduce_scatter over the features,
F padded to a multiple of R: each rank keeps the histogram state of its
feature block, searches it, and the best split is elected across ranks,
ops/treegrow.py::elect_best), and then runs the sibling subtraction and
the split search in torch that the fused tail would have run.  The
window check (pmin of fits, pmax of the rows), the next-window bound (a
rank's bound is its leaves' whole counts: a globally small child can
hold all of one rank's rows of its parent; pmax) and the finite flag are
merged, so every rank's host loop reads the same info vector and runs the
same rounds.  Sharded rounds run eagerly (ROADMAP: NCCL collectives in the
round graphs).
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..obs import metrics as _obs
from ..obs import trace as _trace
from ..utils import sanitizer as _san
from ..utils.guards import NonFiniteError
from ..utils.log import log_warning
from .graphs import RoundGraphs, copy_into
from ..parallel import collectives as C
from .hist_cuda import (CarryAccumulator, fixed_shift_pair, fixed_shift_tensor,
                        histogram_multi_carry, histogram_window,
                        histogram_window_quantized)
from .hist_cuda import _payload as hist_cuda_payload
from .histogram import (dcn_merge, fixed_to_f32, global_shift, histogram_multi,
                        histogram_multi_merged, histogram_multi_quantized,
                        histogram_multi_quantized_merged, histogram_window_merged,
                        histogram_window_quantized_merged, merge_carry, merge_fixed,
                        merge_int, owned_features, pack_fixed, unbundle)
from .partition import segment_ids
from .partition_cuda import partition_segments
from .round_cuda import round_megakernel, round_partition_window, split_window
from .split import (KMIN_SCORE, BestSplit, SplitParams, find_best_split,
                    leaf_output, select_from_feature_best)
from .treegrow import (TreeArrays, _empty_best, _put, _set_best, admit,
                       admits_next, book_tree, dcn_topk_best, elect_best, empty_tree,
                       go_left_of, quantize_gradients, serial_totals)


class WState(NamedTuple):
    order: torch.Tensor  # (N,) i32: row ids physically grouped by leaf
    leaf_start: torch.Tensor  # (L,) i64: position of each leaf's range
    leaf_cnt: torch.Tensor  # (L,) i64
    leaf_id: torch.Tensor  # (N,) i32: leaf per ROW
    hist: torch.Tensor  # (L + 1, 3, F, B) f32, row L a spare; in place
    best: BestSplit
    leaf_sum_g: torch.Tensor
    leaf_sum_h: torch.Tensor
    leaf_count: torch.Tensor
    leaf_depth: torch.Tensor  # i64
    leaf_parent: torch.Tensor  # i64
    leaf_side: torch.Tensor  # i64
    num_leaves_cur: torch.Tensor  # 0-d i64
    leaf_out: torch.Tensor
    tree: TreeArrays


class WInputs(NamedTuple):
    """A tree's inputs to its rounds (the static buffers' second part)."""
    grad: torch.Tensor
    hess: torch.Tensor
    gq: Optional[torch.Tensor]
    hq: Optional[torch.Tensor]
    quant_scale: Optional[torch.Tensor]
    row_mask: torch.Tensor
    feature_mask: torch.Tensor
    shift: torch.Tensor  # (2,) i32 fixed-point exponents
    rng: Optional[torch.Tensor] = None  # (2L-1, 2, F) node uniforms


INFO = 6  # scalars in a round's info vector


class Sharding(NamedTuple):
    """A sharded windowed tree's collective context: the rank's RowShard
    (its mesh sums over rows: the row-domain axis), the merge, and where
    features are owned (``merge="scatter"``, or the 2-D mesh) this rank's
    feature block (first feature f0) with its split tables (num bins,
    missing bin, feature mask, categorical mask, contri), padded features
    never splittable.  ``hist_mesh``: the axis the histograms merge over
    (None: the row-domain one); ``own_mesh``: the axis the owned-feature
    winner is elected over; ``feature_mesh``: the 2-D mesh's feature axis
    (the go-left broadcast; the rank's bins are its feature block);
    ``dcn_mesh`` and ``top_k``: the hierarchical merge's dcn axis and
    vote size (the histogram state stays in fixed point, per slice; with
    ``dcn_exhaustive``, a vote that would elect every feature the rank
    searches, the window sums are summed over dcn too, converted once, and
    the state is the flat round's)."""
    shard: object
    merge: str = "psum"
    f0: int = 0
    tables: Optional[tuple] = None
    hist_mesh: object = None
    own_mesh: object = None
    feature_mesh: object = None
    dcn_mesh: object = None
    top_k: int = 0
    dcn_exhaustive: bool = False

    @property
    def mesh(self):
        return self.shard.mesh

    @property
    def hmesh(self):
        return self.shard.mesh if self.hist_mesh is None else self.hist_mesh

    @property
    def vote(self) -> bool:
        """The hierarchical top-k exchange searches the splits (below the
        exhaustive k)."""
        return self.dcn_mesh is not None and not self.dcn_exhaustive


def _own_tables(sh: "Sharding", nbpf, mbpf, fmask, cmask, contri):
    """The split search's tables: every feature's (psum), or this rank's
    block (scatter)."""
    if sh is None or sh.tables is None:
        return nbpf, mbpf, fmask, cmask, contri
    return sh.tables


def _root_best(hist0, g0, h0, c0, leaf_out0, nbpf, mbpf, fmask, cmask, contri,
               params, rng, sh: Optional["Sharding"], convert=None):
    nb, mb, fm, cm, fc = _own_tables(sh, nbpf, mbpf, fmask, cmask, contri)
    if sh is not None and sh.vote:
        best = dcn_topk_best(hist0[None], g0[None], h0[None], c0[None], nb, mb, fm,
                             cm, fc, params=params, top_k=sh.top_k,
                             dcn=sh.dcn_mesh, convert=convert,
                             parent_out=leaf_out0[None])
    else:
        best = find_best_split(
            hist0[None], g0[None], h0[None], c0[None], nb, mb, params,
            feature_mask=fm, parent_output=leaf_out0[None], categorical_mask=cm,
            feature_contri=fc, rng_key=None if rng is None else rng[:1])
    if sh is not None and sh.tables is not None:
        best = elect_best(best, sh.own_mesh, sh.f0)
    return best


def _ladder(n: int, floor: int = 8192):
    """The W ladder for (n, floor): factor-4 steps to 128k, then factor-2,
    clamped to (and ending at) round_up(n, floor)."""
    cap = -(-n // floor) * floor
    w = floor
    while True:
        yield min(w, cap)
        if w >= cap:
            return
        w *= 4 if w < 131072 else 2


def _window_size(x: int, n: int, floor: int = 8192) -> int:
    """Window size quantization: the first ladder rung covering ``x``."""
    for w in _ladder(n, floor):
        if w >= x:
            break
    return w


def _round_fused(state: WState, bins, grad, hess, gq, hq, quant_scale,
                 row_mask, num_bins_pf, missing_bin_pf, feature_mask, cmask=None,
                 contri=None, *, num_leaves: int, num_bins: int, max_depth: int,
                 params: SplitParams, leaf_tile: int, W: int,
                 quantize_bins: int, megakernel: bool, shift: torch.Tensor,
                 hist_precision: str = "f32", efb=None, rng=None,
                 sharding: Optional[Sharding] = None):
    """One whole boosting round; returns (state', info) with info = [k_acc,
    window_total, fits_W, whint, finite, k_next] (i32, on the device).
    ``efb``: the EFB tables (three-pass rounds only): the window pass
    histograms the bundled matrix and unbundles.  ``rng``: the tree's node
    uniforms (three-pass rounds only).  The round is its stages in order
    (round_geometry, the partition, round_rows, the window pass,
    round_finish); ops/treegrow_fleet.py runs the same stages for each of
    its lanes around one lane-mode launch of each kernel.  ``sharding``:
    the rows are one rank's (module docstring): B3 unfused or the
    three-pass window pass, the exact merge, then the subtraction and the
    torch split search."""
    T = leaf_tile
    mesh = None if sharding is None else sharding.mesh
    g = round_geometry(state, bins, missing_bin_pf, cmask, num_leaves=num_leaves,
                       leaf_tile=T, max_depth=max_depth, params=params, W=W,
                       mesh=mesh, feature_mesh=(None if sharding is None
                                                else sharding.feature_mesh),
                       f0=0 if sharding is None else sharding.f0)
    i32 = torch.int32
    if sharding is not None:
        return _round_sharded(state, g, bins, grad, hess, gq, hq, quant_scale,
                              row_mask, num_bins_pf, missing_bin_pf, feature_mask,
                              cmask, contri, num_leaves=num_leaves,
                              num_bins=num_bins, max_depth=max_depth, params=params,
                              leaf_tile=T, W=W, quantize_bins=quantize_bins,
                              megakernel=megakernel, shift=shift,
                              hist_precision=hist_precision, rng=rng,
                              sharding=sharding)
    if megakernel:
        cand_tab = torch.stack([g.leaf_sum_g[g.ci], g.leaf_sum_h[g.ci],
                                g.leaf_count[g.ci], g.leaf_out[g.ci]]).contiguous()
        new_order, left_h, right_h, fbests = round_megakernel(
            bins, state.order, g.go_left, grad, hess, row_mask,
            g.seg_start.to(i32), g.seg_len_eff.to(i32), g.n_left_seg.to(i32),
            g.win_start.to(i32), g.win_cnt.to(i32), g.slot_small_left.to(i32),
            g.parent_hists, cand_tab, num_bins_pf, missing_bin_pf, feature_mask,
            params=params, W=W, shift=shift, categorical_mask=cmask,
            feature_contri=contri)
    else:
        new_order, _ = partition_segments(state.order, g.seg_start.to(i32),
                                          g.seg_len_eff.to(i32), g.go_left)
    rows = round_rows(state, g, new_order, cmask)
    if megakernel:
        return round_finish(state, g, rows, left_h, right_h, num_bins_pf,
                            missing_bin_pf, feature_mask, cmask, contri,
                            num_leaves=num_leaves, num_bins=num_bins,
                            max_depth=max_depth, params=params, leaf_tile=T,
                            fbests=fbests)
    # ---- three-pass: window pass through the new order -> subtraction ----
    wbins = bins if efb is None else efb[0]
    geo = (row_mask, new_order, g.win_start.to(i32), g.win_cnt.to(i32), T, num_bins)
    if quantize_bins:
        fresh_h = unbundle(histogram_window_quantized(wbins, gq, hq, *geo, W=W), efb,
                           num_bins).float() * quant_scale[:, None, None]
    else:
        fresh_h = unbundle(histogram_window(wbins, grad, hess, *geo, W=W, shift=shift,
                                            precision=hist_precision), efb, num_bins)
    left_h, right_h = split_window(g.parent_hists, fresh_h, g.slot_small_left)
    return round_finish(state, g, rows, left_h, right_h, num_bins_pf,
                        missing_bin_pf, feature_mask, cmask, contri,
                        num_leaves=num_leaves, num_bins=num_bins,
                        max_depth=max_depth, params=params, leaf_tile=T, rng=rng)


def _round_sharded(state: WState, g, bins, grad, hess, gq, hq, quant_scale,
                   row_mask, num_bins_pf, missing_bin_pf, feature_mask, cmask,
                   contri, *, num_leaves: int, num_bins: int, max_depth: int,
                   params: SplitParams, leaf_tile: int, W: int, quantize_bins: int,
                   megakernel: bool, shift, hist_precision: str, rng,
                   sharding: Sharding):
    """A sharded round after its geometry: this rank's window sums (B3
    unfused, or the three-pass window pass), merged exactly, then the
    subtraction and the split search that B3's fused tail would run.
    Hierarchical below the exhaustive top-k: the sums stay in fixed point
    (slice domain), the subtraction is integer, and convert makes f32 of
    them for the vote; at it, the sums are merged over dcn too and
    converted (the flat round's state)."""
    i32 = torch.int32
    mesh, merge = sharding.hmesh, sharding.merge
    hier = sharding.dcn_mesh is not None
    T = leaf_tile
    convert = None
    if hier:
        convert = ((lambda h: h.float() * quant_scale[:, None, None]) if quantize_bins
                   else (lambda h: fixed_to_f32(h, shift)))
    if megakernel:
        new_order, acc64, acc32 = round_partition_window(
            bins, state.order, g.go_left, grad, hess, row_mask,
            g.seg_start.to(i32), g.seg_len_eff.to(i32), g.n_left_seg.to(i32),
            g.win_start.to(i32), g.win_cnt.to(i32), num_bins=num_bins, W=W,
            shift=shift)
        fresh_h = merge_carry(acc64, acc32, shift, mesh, merge)
    else:
        new_order, _ = partition_segments(state.order, g.seg_start.to(i32),
                                          g.seg_len_eff.to(i32), g.go_left)
        geo = (row_mask, new_order, g.win_start.to(i32), g.win_cnt.to(i32), T, num_bins)
        if quantize_bins:
            fresh_h = histogram_window_quantized_merged(bins, gq, hq, *geo, W=W,
                                                        mesh=mesh, merge=merge)
            fresh_h = (fresh_h.to(torch.int64) if hier
                       else fresh_h.float() * quant_scale[:, None, None])
        else:
            fresh_h = histogram_window_merged(
                bins, grad, hess, *geo, W=W, shift=shift, mesh=mesh, merge=merge,
                precision=hist_precision, convert=not hier)
    if hier and sharding.dcn_exhaustive:  # the global window sums, the flat state
        fresh_h = convert(dcn_merge(fresh_h, sharding.dcn_mesh))
        convert = None
    rows = round_rows(state, g, new_order, cmask)
    left_h, right_h = split_window(g.parent_hists, fresh_h, g.slot_small_left)
    return round_finish(state, g, rows, left_h, right_h, num_bins_pf,
                        missing_bin_pf, feature_mask, cmask, contri,
                        num_leaves=num_leaves, num_bins=num_bins,
                        max_depth=max_depth, params=params, leaf_tile=T, rng=rng,
                        sharding=sharding, convert=convert)


class RoundGeometry(NamedTuple):
    """A round's decisions before its partition (round_geometry)."""
    accept: torch.Tensor
    k_acc: torch.Tensor
    total: torch.Tensor
    ok: torch.Tensor
    live_rk: torch.Tensor
    leaf_of_rank: torch.Tensor
    seg_start: torch.Tensor
    seg_len_eff: torch.Tensor
    seg_id: torch.Tensor
    sid: torch.Tensor
    n_left_seg: torch.Tensor
    go_left: torch.Tensor
    node_of: torch.Tensor
    right_of: torch.Tensor
    leaf_sum_g: torch.Tensor
    leaf_sum_h: torch.Tensor
    leaf_count: torch.Tensor
    leaf_depth: torch.Tensor
    leaf_parent: torch.Tensor
    leaf_side: torch.Tensor
    leaf_out: torch.Tensor
    num_leaves_new: torch.Tensor
    fresh: torch.Tensor
    slot_small_left: torch.Tensor
    leaf_start: torch.Tensor
    leaf_cnt: torch.Tensor
    win_start: torch.Tensor
    win_cnt: torch.Tensor
    active: torch.Tensor
    sl: torch.Tensor
    sr: torch.Tensor
    parent_hists: torch.Tensor
    cand: torch.Tensor
    cand_ok: torch.Tensor
    ci: torch.Tensor


def round_geometry(state: WState, bins, missing_bin_pf, cmask=None, *,
                   num_leaves: int, leaf_tile: int, max_depth: int,
                   params: SplitParams, W: int, mesh=None, feature_mesh=None,
                   f0: int = 0) -> RoundGeometry:
    """Admission, split decisions, segment and window geometry, the window
    check against W and the order-independent bookkeeping of a round.
    ``mesh``: the rows are one rank's; the window child is the globally
    smaller one and the window check is merged (module docstring).
    ``feature_mesh``: ``bins`` hold this rank's feature block (first
    feature ``f0``) of a 2-D mesh; each position's decision comes from the
    block that owns its segment's split feature, one masked psum over the
    feature axis (the round's only feature-axis data)."""
    L, T = num_leaves, leaf_tile
    n, f = bins.shape
    dev = bins.device
    s = state.best
    idx = torch.arange(L, dtype=torch.int64, device=dev)
    nlc = state.num_leaves_cur
    drop = -1  # _put's index of the spare slot

    # ---- admission (the rounds grower's semantics) ----
    accept0, order_rank, srt = admit(s.gain, state.leaf_depth, nlc, num_leaves=L,
                                     leaf_tile=T, max_depth=max_depth)

    # ---- split decisions + segment geometry (pre-partition) ----
    leaf_of_rank = srt[:T]
    live_rk = accept0[leaf_of_rank]
    feats_rk = torch.where(live_rk, s.feature[leaf_of_rank].long(), 0)
    seg_start = torch.where(live_rk, state.leaf_start[leaf_of_rank], 0)
    seg_len = torch.where(live_rk, state.leaf_cnt[leaf_of_rank], 0)
    seg_id = segment_ids(seg_start, seg_len, n).long()  # admission rank
    sid = seg_id.clamp_min(0)
    # each position's bin of its segment's split feature: one gather of the
    # row-major matrix (a contiguous row, one column of it)
    feats_col = feats_rk
    if feature_mesh is not None:  # global feature -> this block's column
        own_rk = (feats_rk >= f0) & (feats_rk < f0 + f)
        feats_col = (feats_rk - f0).clamp(0, f - 1)
    col = bins.view(-1)[state.order.long() * f + feats_col[sid]].to(torch.int32)
    thr = s.threshold_bin[leaf_of_rank][sid]
    dl = s.default_left[leaf_of_rank][sid]
    mb = missing_bin_pf[feats_rk][sid]
    go_left = go_left_of(col, mb, dl, thr, *(
        (s.is_cat[leaf_of_rank][sid], s.cat_mask[leaf_of_rank][sid, col.long()])
        if cmask is not None else ()))
    if feature_mesh is not None:
        own_pos = own_rk[sid] & (seg_id >= 0)
        go_left = C.psum(torch.where(own_pos, go_left, False).to(torch.int32),
                         feature_mesh) > 0

    # ---- on-device window verification ----
    # segments are contiguous position ranges: differences of one prefix sum
    # (a scatter-add into T slots would serialise on T atomic words)
    cl = torch.cumsum((go_left & (seg_id >= 0)).long(), 0)
    cl = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), cl])
    left_counts = cl[seg_start + seg_len] - cl[seg_start]
    if mesh is None:
        left_small = 2 * left_counts <= seg_len
    else:  # every rank windows the same child: the globally smaller one
        both = C.psum(torch.stack([left_counts, seg_len]), mesh)
        left_small = 2 * both[0] <= both[1]
    win_cnt_rk = torch.where(live_rk, torch.where(left_small, left_counts,
                                                  seg_len - left_counts), 0)
    total = win_cnt_rk.sum()
    ok = total <= W
    if mesh is not None:
        # one rank's breach skips the round on every rank, and the host's
        # corrected W must cover the worst rank
        ok = C.pmin(ok, mesh)
        total = C.pmax(total, mesh)
    accept = accept0 & ok
    live_rk = live_rk & ok
    k_acc = accept.sum()
    acc_rank = torch.where(accept, order_rank, L)
    node_of = nlc - 1 + acc_rank
    right_of = nlc + acc_rank
    seg_id = torch.where(ok, seg_id, -1)
    seg_len_eff = torch.where(ok, seg_len, 0)
    n_left_seg = torch.where(live_rk, left_counts, 0)

    # ---- order-independent bookkeeping ----
    right_pos = torch.where(accept, right_of, drop)

    def upd(arr, left_val, right_val):
        return _put(torch.where(accept, left_val, arr), right_pos, right_val)

    leaf_sum_g = upd(state.leaf_sum_g, s.left_sum_g, s.right_sum_g)
    leaf_sum_h = upd(state.leaf_sum_h, s.left_sum_h, s.right_sum_h)
    leaf_count = upd(state.leaf_count, s.left_count, s.right_count)
    depth_child = state.leaf_depth + 1
    leaf_depth = upd(state.leaf_depth, depth_child, depth_child)
    leaf_parent = upd(state.leaf_parent, node_of, torch.where(accept, node_of, 0))
    leaf_side = _put(torch.where(accept, 0, state.leaf_side), right_pos, 1)
    leaf_out = upd(state.leaf_out, leaf_output(s.left_sum_g, s.left_sum_h, params),
                   leaf_output(s.right_sum_g, s.right_sum_h, params))
    num_leaves_new = nlc + k_acc

    fresh = _put(accept.clone(), right_pos, True)
    pos_r = torch.where(accept, acc_rank, -1)
    minus1 = torch.full((T,), -1, dtype=torch.int64, device=dev)
    slot_left = _put(minus1, pos_r, idx)
    slot_right = _put(minus1, pos_r, right_of)
    slot_small_left = live_rk & left_small  # slot r == admission rank r

    # leaf ranges: the left child keeps the leaf's start
    st_rk = state.leaf_start[leaf_of_rank]
    ct_rk = state.leaf_cnt[leaf_of_rank]
    rp = right_of[leaf_of_rank].clamp(0, L - 1)
    leaf_start = _put(state.leaf_start, torch.where(live_rk, rp, drop),
                      st_rk + n_left_seg)
    leaf_cnt = _put(state.leaf_cnt, torch.where(live_rk, leaf_of_rank, drop),
                    n_left_seg)
    leaf_cnt = _put(leaf_cnt, torch.where(live_rk, rp, drop), ct_rk - n_left_seg)

    # windows: per admission rank, the SMALL child's [start, cnt)
    sm = torch.where(left_small, leaf_of_rank, rp)
    win_start = torch.where(live_rk, leaf_start[sm], 0)
    win_cnt = torch.where(live_rk, leaf_cnt[sm], 0)

    active = slot_left >= 0
    sl = slot_left.clamp(0, L - 1)
    sr = slot_right.clamp(0, L - 1)
    parent_hists = state.hist.index_select(0, sl)  # (T, 3, F, B)
    cand = torch.cat([sl, sr])
    cand_ok = torch.cat([active, active])
    ci = torch.where(cand_ok, cand, 0)
    return RoundGeometry(
        accept=accept, k_acc=k_acc, total=total, ok=ok, live_rk=live_rk,
        leaf_of_rank=leaf_of_rank, seg_start=seg_start, seg_len_eff=seg_len_eff,
        seg_id=seg_id, sid=sid, n_left_seg=n_left_seg, go_left=go_left,
        node_of=node_of, right_of=right_of, leaf_sum_g=leaf_sum_g,
        leaf_sum_h=leaf_sum_h, leaf_count=leaf_count, leaf_depth=leaf_depth,
        leaf_parent=leaf_parent, leaf_side=leaf_side, leaf_out=leaf_out,
        num_leaves_new=num_leaves_new, fresh=fresh, slot_small_left=slot_small_left,
        leaf_start=leaf_start, leaf_cnt=leaf_cnt, win_start=win_start,
        win_cnt=win_cnt, active=active, sl=sl, sr=sr, parent_hists=parent_hists,
        cand=cand, cand_ok=cand_ok, ci=ci)


def round_rows(state: WState, g: RoundGeometry, new_order, cmask=None):
    """After the partition: each row's leaf id, the tree arrays and the
    best splits with the split leaves' cleared.  Returns (new_order,
    leaf_id, tree, best)."""
    n = new_order.shape[0]
    dev = new_order.device
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    sid = g.sid
    # ---- per-row leaf ids (needs the partitioned order) ----
    new_rows = new_order.long()
    lid_pos = state.leaf_id[new_rows]
    in_right = ((g.seg_id >= 0) & g.live_rk[sid]
                & (pos >= g.seg_start[sid] + g.n_left_seg[sid]))
    lid_pos = torch.where(in_right, g.right_of[g.leaf_of_rank][sid].to(torch.int32),
                          lid_pos)
    leaf_id = torch.empty_like(state.leaf_id)
    leaf_id[new_rows] = lid_pos

    # ---- tree arrays ----
    s = state.best
    tree = book_tree(state.tree, g.accept, g.node_of, g.right_of, state.leaf_parent,
                     state.leaf_side, s, state.leaf_out, state.leaf_sum_h,
                     state.leaf_count, categorical=cmask is not None)
    best = s._replace(gain=torch.where(g.fresh, KMIN_SCORE, s.gain))
    return new_order, leaf_id, tree, best


def round_finish(state: WState, g: RoundGeometry, rows, left_h, right_h,
                 num_bins_pf, missing_bin_pf, feature_mask, cmask=None,
                 contri=None, *, num_leaves: int, num_bins: int, max_depth: int,
                 params: SplitParams, leaf_tile: int, fbests=None, rng=None,
                 sharding: Optional[Sharding] = None, convert=None):
    """The children's histograms into the state, their split search (from
    the megakernel's per-feature bests ``fbests``, or in torch), the
    next-window bound and the info vector.  Returns (state', info).
    ``sharding``: a sharded round's search (this rank's feature block and
    the election where features are owned; the two-level top-k search of
    the hierarchical mesh, over fixed-point children that ``convert``
    makes f32) and merged bound and flag."""
    L, T = num_leaves, leaf_tile
    new_order, leaf_id, tree, best = rows
    dev = left_h.device
    idx = torch.arange(L, dtype=torch.int64, device=dev)
    drop = -1
    spare = L  # inactive slots write the spare row
    state.hist.index_copy_(0, torch.where(g.active, g.sl, spare), left_h)
    state.hist.index_copy_(0, torch.where(g.active, g.sr, spare), right_h)

    # ---- fresh-leaf split search ----
    ci, cand_ok = g.ci, g.cand_ok
    pg, ph, pc = g.leaf_sum_g[ci], g.leaf_sum_h[ci], g.leaf_count[ci]
    if fbests is not None:
        bb = select_from_feature_best(
            fbests, pg, ph, pc, num_bins, categorical_mask=cmask,
            cand_hist=None if cmask is None else torch.cat([left_h, right_h]),
            missing_bin_per_feature=missing_bin_pf, params=params)
    else:
        node_ids = g.leaf_parent.clamp_min(0) * 2 + g.leaf_side + 1
        nb, mb, fm, cm, fc = _own_tables(sharding, num_bins_pf, missing_bin_pf,
                                         feature_mask, cmask, contri)
        cand_h = torch.cat([left_h, right_h])
        if sharding is not None and sharding.vote:
            bb = dcn_topk_best(cand_h, pg, ph, pc, nb, mb, fm, cm, fc, params=params,
                               top_k=sharding.top_k, dcn=sharding.dcn_mesh,
                               convert=convert, parent_out=g.leaf_out[ci])
        else:
            bb = find_best_split(cand_h, pg, ph, pc, nb, mb, params, feature_mask=fm,
                                 parent_output=g.leaf_out[ci], categorical_mask=cm,
                                 feature_contri=fc,
                                 rng_key=None if rng is None else rng[node_ids[ci]])
        if sharding is not None and sharding.tables is not None:
            bb = elect_best(bb, sharding.own_mesh, sharding.f0)
    scatter_pos = torch.where(cand_ok, g.cand, drop)
    best = BestSplit(*[_put(o, scatter_pos, nw) for o, nw in zip(best, bb)])

    # ---- next-window bound for the host's ladder ----
    num_leaves_new = g.num_leaves_new
    # sharded: a rank's window can hold all its rows of a leaf (the small
    # child is small globally), so its bound drops the halving
    half_cnt = torch.where(idx < num_leaves_new,
                           g.leaf_cnt // 2 if sharding is None else g.leaf_cnt, 0)
    k_top = min(T, L)
    top = torch.topk(half_cnt, k_top).values
    budget_next = (L - num_leaves_new).clamp_min(0).clamp_max(T)
    whint = torch.where(torch.arange(k_top, device=dev) < budget_next, top, 0).sum()
    if sharding is not None:
        whint = C.pmax(whint, sharding.mesh)

    state = WState(
        order=new_order, leaf_start=g.leaf_start, leaf_cnt=g.leaf_cnt,
        leaf_id=leaf_id, hist=state.hist, best=best, leaf_sum_g=g.leaf_sum_g,
        leaf_sum_h=g.leaf_sum_h, leaf_count=g.leaf_count, leaf_depth=g.leaf_depth,
        leaf_parent=g.leaf_parent, leaf_side=g.leaf_side,
        num_leaves_cur=num_leaves_new, leaf_out=g.leaf_out, tree=tree)
    # ---- non-finite guard, in the same info vector ----
    finite = (torch.isfinite(g.leaf_sum_g).all() & torch.isfinite(g.leaf_sum_h).all()
              & torch.isfinite(g.leaf_out).all() & ~torch.isnan(best.gain).any())
    if sharding is not None:
        finite = C.pmin(finite, sharding.mesh)
    k_next = admits_next(best.gain, g.leaf_depth, num_leaves_new, num_leaves=L,
                         leaf_tile=T, max_depth=max_depth)
    info = torch.stack([g.k_acc, g.total, g.ok.long(), whint, finite.long(),
                        k_next]).to(torch.int32)
    return state, info


def _w_init(bins, grad, hess, row_mask, sample_weight, num_bins_pf,
            missing_bin_pf, feature_mask, *, num_leaves: int, num_bins: int,
            params: SplitParams, quantize_bins: int, stochastic_rounding: bool,
            generator: Optional[torch.Generator], hist_precision: str = "f32",
            categorical_mask=None, feature_contri=None, hist=None, efb=None,
            rng=None, check_finite: bool = True,
            sharding: Optional[Sharding] = None):
    """Root state: quantize gradients, the one full-N pass, seed best.
    ``hist``: the (L + 1, 3, F, B) buffer to hold the histogram state (the
    static one of a graph cache), else a new one; ``efb``: the EFB tables
    (the pass reads the bundled matrix).  ``check_finite``: make the
    tree's blocking read of the gradients' maxima here (a fleet makes one
    for all its lanes).  ``sharding``: the rows are one rank's; the
    exponents, scales and the finite check are global and the root
    histogram merged (under the scatter merge: this rank's feature block
    of it, the state's histograms too).  Returns (state, WInputs,
    grad_true, hess_true)."""
    n, f = bins.shape
    L = num_leaves
    dev = bins.device
    grad = grad.float() * sample_weight
    hess = hess.float() * sample_weight
    grad_true, hess_true = grad, hess
    gq = hq = quant_scale = None
    if quantize_bins:
        gq, hq, grad, hess, quant_scale = quantize_gradients(
            grad, hess, row_mask, quantize_bins, stochastic_rounding, generator,
            None if sharding is None else sharding.shard)
    slot0 = torch.zeros(n, dtype=torch.int32, device=dev)
    convert = None
    if sharding is not None:
        mesh, hmesh, merge = sharding.mesh, sharding.hmesh, sharding.merge
        shift = global_shift(grad, hess, sharding.shard)
        if check_finite:  # the tree's one blocking read: all ranks' maxima
            am = C.pmax(torch.stack([grad.float().abs().amax(),
                                     hess.float().abs().amax()])
                        if n else torch.zeros(2, device=dev), mesh)
            if not np.isfinite(_san.sync_pull(am)).all():
                raise NonFiniteError("non-finite gradients or hessians on some rank")
        if sharding.dcn_mesh is not None:
            hist0, tot0, convert = _hier_root(bins, grad, hess, gq, hq, quant_scale,
                                              row_mask, slot0, num_bins, shift,
                                              sharding, hist_precision,
                                              num_bins_pf.shape[0])
        else:
            if quantize_bins:
                hist0 = histogram_multi_quantized_merged(
                    bins, gq, hq, row_mask, slot0, 0, 1, num_bins, hmesh, merge
                )[0].float() * quant_scale[:, None, None]
            else:
                hist0 = histogram_multi_merged(bins, grad, hess, row_mask, slot0, 0, 1,
                                               num_bins, shift, hmesh, merge,
                                               precision=hist_precision)[0]
            tot0 = torch.sum(hist0[:, 0, :], dim=1)  # totals from feature 0
            if sharding.tables is not None:  # global feature 0 is block 0's
                tot0 = C.broadcast_from(
                    serial_totals(hist0[:, 0, :], num_bins_pf.shape[0]),
                    torch.zeros((), device=dev), sharding.own_mesh)
        g0, h0, c0 = tot0
    else:
        if check_finite:
            fixed_shift_pair(grad, hess)  # the tree's one blocking host read: finite?
        shift = fixed_shift_tensor(grad, hess)
        src = bins if efb is None else efb[0]
        if quantize_bins:
            hist0 = unbundle(histogram_multi_quantized(src, gq, hq, row_mask, slot0, 0,
                                                        1, num_bins), efb, num_bins
                              )[0].float() * quant_scale[:, None, None]
        else:
            hist0 = unbundle(histogram_multi(src, grad, hess, row_mask, slot0, 0, 1,
                                              num_bins, shift=shift,
                                              precision=hist_precision), efb,
                             num_bins)[0]
        g0, h0, c0 = torch.sum(hist0[:, 0, :], dim=1)  # totals from feature 0
    leaf_out0 = leaf_output(g0, h0, params)
    best = _empty_best(L, num_bins, dev)
    _set_best(best, torch.zeros(1, dtype=torch.int64, device=dev), _root_best(
        hist0, g0, h0, c0, leaf_out0, num_bins_pf, missing_bin_pf, feature_mask,
        categorical_mask, feature_contri, params, rng, sharding, convert))

    def zeros(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    if hist is None:
        hist = zeros((L + 1, 3, hist0.shape[1], num_bins), hist0.dtype)
    else:
        hist.zero_()
    hist[0] = hist0

    def first(v, dtype=torch.float32):
        out = zeros(L, dtype)
        out[0] = v
        return out

    state = WState(
        order=torch.arange(n, dtype=torch.int32, device=dev),
        leaf_start=zeros(L, torch.int64), leaf_cnt=first(n, torch.int64),
        leaf_id=zeros(n, torch.int32), hist=hist, best=best,
        leaf_sum_g=first(g0), leaf_sum_h=first(h0), leaf_count=first(c0),
        leaf_depth=zeros(L, torch.int64),
        leaf_parent=torch.full((L,), -1, dtype=torch.int64, device=dev),
        leaf_side=zeros(L, torch.int64),
        num_leaves_cur=torch.ones((), dtype=torch.int64, device=dev),
        leaf_out=first(leaf_out0), tree=empty_tree(L, num_bins, dev))
    inputs = WInputs(grad, hess, gq, hq, quant_scale, row_mask, feature_mask,
                     shift, rng)
    return state, inputs, grad_true, hess_true


def _hier_root(bins, grad, hess, gq, hq, quant_scale, row_mask, slot0,
               num_bins: int, shift, sharding: Sharding, hist_precision: str,
               num_feature: int):
    """The hierarchical root: this rank's pass over its rows, merged over
    the slice (ici) and kept in fixed point (the slice-domain root), and
    the tree's totals from global feature 0, its column summed over every
    rank as integers and converted as the serial pass converts it; with
    ``dcn_exhaustive`` the root summed over dcn too and converted (the flat
    round's root).  Returns (hist0 (3, F, B) int64, or f32 when
    exhaustive, totals (3,) f32, convert or None)."""
    hmesh, merge = sharding.hmesh, sharding.merge
    if gq is not None:
        loc = histogram_multi_quantized(bins, gq, hq, row_mask, slot0, 0, 1, num_bins)
        col = C.psum(loc[0, :, 0, :].to(torch.int64), sharding.mesh)
        col_f32 = col.float() * quant_scale[:, None]
        hist0 = merge_int(loc, hmesh, merge)[0].to(torch.int64)

        def convert(h):
            return h.float() * quant_scale[:, None, None]
    else:
        g, h = hist_cuda_payload(grad, hess, hist_precision)
        acc = CarryAccumulator(1, bins.shape[1], num_bins, shift, bins.device)
        histogram_multi_carry(bins, g.float().contiguous(), h.float().contiguous(),
                              row_mask, slot0, 0, acc)
        col = C.psum(pack_fixed(acc.acc64[:, :, :1], acc.acc32[:, :1])[0, :, 0, :],
                     sharding.mesh)
        col_f32 = fixed_to_f32(col[None, :, None, :], shift)[0, :, 0, :]
        hist0 = pack_fixed(*merge_fixed(acc.acc64, acc.acc32, hmesh, merge))[0]

        def convert(h):
            return fixed_to_f32(h, shift)
    if sharding.dcn_exhaustive:
        return (convert(dcn_merge(hist0[None], sharding.dcn_mesh))[0],
                serial_totals(col_f32, num_feature), None)
    return hist0, serial_totals(col_f32, num_feature), convert


def renew_leaf_hist(leaf_id, grad_true, hess_true, row_mask, L: int, shard=None):
    """Per-leaf sums of the true gradients as a one-feature histogram (bin
    = leaf id), deterministic like every other kernel sum: (1, 3, 1, L).
    ``shard``: over every rank's rows, with the global exponents, merged
    exactly."""
    cols = leaf_id.to(torch.int16)[:, None].contiguous()
    slot = torch.zeros_like(leaf_id)
    if shard is None:
        return histogram_multi(cols, grad_true, hess_true, row_mask, slot, 0, 1, L)
    return histogram_multi_merged(cols, grad_true, hess_true, row_mask, slot, 0, 1,
                                  L, global_shift(grad_true, hess_true, shard),
                                  shard.mesh)


def _w_finalize(state: WState, grad_true, hess_true, row_mask, *,
                params: SplitParams, quant_renew: bool, shard=None):
    L = state.leaf_out.shape[0]
    if quant_renew:
        # leaf outputs from the TRUE gradients, as the rounds grower does
        leaf_hist = renew_leaf_hist(state.leaf_id, grad_true, hess_true, row_mask,
                                    L, shard)
        leaf_value = leaf_output(leaf_hist[0, 0, 0], leaf_hist[0, 1, 0], params)
    else:
        leaf_value = leaf_output(state.leaf_sum_g, state.leaf_sum_h, params)
    active = torch.arange(L, device=leaf_value.device) < state.num_leaves_cur
    tree = state.tree._replace(
        num_leaves=state.num_leaves_cur.to(torch.int32),
        leaf_value=torch.where(active, leaf_value, 0.0),
        leaf_weight=torch.where(active, state.leaf_sum_h, 0.0),
        leaf_count=torch.where(active, state.leaf_count, 0.0),
        leaf_sum_g=torch.where(active, state.leaf_sum_g, 0.0),
        leaf_depth=state.leaf_depth.to(torch.int32))
    return tree, state.leaf_id


def round_body(round_fn, W: int):
    """The body ``graphs.run`` runs for one round at window ``W``:
    ``round_fn(state, inputs, W)`` on the static buffers (state, inputs,
    info), its new state and info copied back into them.  The trace audit
    runs the same body (analysis/contracts.py)."""
    def body(b):
        st, inp, out = b
        new, new_info = round_fn(st, inp, W)
        copy_into(st, new)
        out.copy_(new_info)

    return body


def windowed_round_fn(bins, num_bins_pf, missing_bin_pf, tables, efb,
                      sharding: Optional[Sharding], static: dict):
    """The windowed grower's ``round_fn(state, inputs, W) -> (state',
    info)``: ``_round_fused`` over the tree's fixed inputs (the bins, the
    per-feature tables, the categorical mask and contri ``tables``, the EFB
    plan) and its static arguments."""
    def round_fn(st, inp: WInputs, W):
        return _round_fused(
            st, bins, inp.grad, inp.hess, inp.gq, inp.hq, inp.quant_scale,
            inp.row_mask, num_bins_pf, missing_bin_pf, inp.feature_mask, *tables,
            W=W, shift=inp.shift, efb=efb, rng=inp.rng, sharding=sharding,
            **static)

    return round_fn


def round_runner(round_fn, state, inputs, fixed, key, graphs: Optional[RoundGraphs]):
    """The driver's ``round(state, W) -> (state', info)``.  Without
    ``graphs``: ``round_fn(state, inputs, W)``, functional.  With them, the
    tree's state and inputs are loaded into the cache's static buffers and
    each round is ``graphs.run`` of ``round_body`` (on the card one replay
    of the graph captured for ``key + (W,)``).  ``fixed`` are the tensors
    the rounds read where they lie."""
    if graphs is None:
        return lambda st, W: round_fn(st, inputs, W)
    info = torch.zeros(INFO, dtype=torch.int32, device=inputs.grad.device)
    buffers = graphs.load((state, inputs, info), fixed)

    def run(_, W):
        graphs.run(key + (W,), round_body(round_fn, W))
        return buffers[0], buffers[2]

    return run


def _run_fused_rounds(round_fn, state, *, n_ladder: Optional[int],
                      w_first: Optional[int], num_leaves: int,
                      stats: Optional[dict], guard_label: str, floor: int = 8192):
    """The round protocol: W predicted from the bound, each round's info
    read one round behind, a breach retried at a corrected W, a non-finite
    flag raised as NonFiniteError, and the tree ended when a round reports
    that the next admits nothing (the round in flight then is a no-op).
    ``round_fn(state, W) -> (state', info)`` launches one round without
    reading anything back.  ``n_ladder`` None: the rounds take no window
    (the rounds grower), W stays None."""
    n = n_ladder
    W = w_first
    pending: list = []  # launched rounds whose info is still in flight
    n_leaves = 1
    retries = 0
    windows: list = []  # W of every launched round
    # every productive round admits >= 1 split, reads lag 1 round, plus
    # headroom for retried (skipped) rounds
    max_rounds = 2 * num_leaves + 4
    converged = False
    resolved = 0
    # the windowed grower's telemetry (the rounds grower shares this loop)
    tele = n is not None and _obs.enabled()
    t_open = t_prev = time.perf_counter()
    try:
        while len(windows) < max_rounds:
            _san.record_dispatch()
            state, info_d = round_fn(state, W)
            pending.append(_san.async_pull_start(info_d))
            windows.append(W)
            if len(pending) < 2:
                continue  # pipeline fill: resolve reads one round behind
            k_acc, total, ok, whint, finite, k_next = (
                int(v) for v in _san.async_pull_result(pending.pop(0)))
            resolved += 1
            if tele:
                # the resolve just made is the loop's own read: the span
                # from the previous one is the round that retired between
                w_ran = windows[resolved - 1]
                _obs.histogram("train_window_rows").observe(total)
                _obs.histogram("train_window_fill").observe(total / max(w_ran, 1))
                t_now = time.perf_counter()
                _trace.record_span("windowed_round", t_now - t_prev, round=resolved,
                                   k_acc=k_acc, rows=total, W=w_ran, whint=whint,
                                   first=resolved == 1)
                t_prev = t_now
            if not finite:
                _obs.counter("train_nonfinite_errors_total").inc()
                _obs.event("nonfinite", phase="windowed", round=resolved)
                raise NonFiniteError(
                    f"non-finite gradients/hessians/split stats on the device "
                    f"at round {resolved}{guard_label}: refusing to keep "
                    "boosting on NaNs; check labels, weights and custom "
                    "objective outputs")
            if not ok:
                # the window bound was breached: the device skipped the round;
                # fold the corrected W into the next launch
                retries += 1
                W = _window_size(max(total, 1), n, floor)
                continue
            n_leaves += k_acc
            if k_acc == 0 or k_next == 0:
                converged = True
                break
            if n is not None:
                W = _window_size(max(whint, 1), n, floor)
        # drain the in-flight round so its finite flag is checked too
        while pending:
            info = _san.async_pull_result(pending.pop(0))
            resolved += 1
            if tele:
                t_now = time.perf_counter()
                _trace.record_span("windowed_round", t_now - t_prev, round=resolved,
                                   k_acc=int(info[0]), rows=int(info[1]),
                                   W=windows[resolved - 1], whint=int(info[3]),
                                   first=resolved == 1, drained=True)
                t_prev = t_now
            if not int(info[4]):
                _obs.counter("train_nonfinite_errors_total").inc()
                _obs.event("nonfinite", phase="windowed_drain", round=resolved)
                raise NonFiniteError(
                    f"non-finite gradients/hessians/split stats on the device "
                    f"at round {resolved}{guard_label} (drained "
                    "in-flight round): refusing to finalize a tree grown on NaNs")
    finally:
        pending.clear()
        if stats is not None:
            stats.update(retries=retries, windows=windows)
        if tele:
            rounds = len(windows)
            _obs.counter("train_windowed_rounds_total").inc(rounds)
            _obs.counter("train_windowed_retries_total").inc(retries)
            _obs.event("windowed_tree", rounds=rounds, retries=retries,
                       resolved=resolved)
            _trace.record_span("windowed_tree", time.perf_counter() - t_open,
                               rounds=rounds, retries=retries)
    if not converged:
        log_warning(
            f"round-batched growth exhausted its round budget ({max_rounds} "
            f"rounds, {retries} window retries) before reaching num_leaves="
            f"{num_leaves}; the tree is valid but under-grown")
    return state


def megakernel_mode(on_card: bool, *, quantize_bins: int = 0, efb: bool = False,
                    node_rng: bool = False,
                    mode: Optional[str] = None) -> Tuple[bool, Optional[str]]:
    """The round-megakernel gate: returns (megakernel, exclusion reason).

    ``mode`` (the Booster's ``megakernel`` extra parameter): ``auto`` (the
    default: on wherever the kernels run, i.e. on the card), ``1`` (on; on
    the CPU the megakernel's plain version runs), ``0`` (off).  On the card,
    int8-quantized training is outside the megakernel's envelope: the
    three-pass round sums the int8 values exactly while the megakernel
    would fold the dequantized floats, so it takes the three-pass round and
    the reason ``quantized`` is reported (in the grower's stats).  EFB
    bundles (``efb``) and per-node feature sampling (``node_rng``) are
    outside the envelope wherever the megakernel was asked for, as in the
    JAX package: reasons ``efb`` and ``node_rng``.  Every exclusion counts
    a megakernel fallback (utils/sanitizer.py)."""
    mode = "auto" if mode is None else str(mode).lower()
    if mode in ("0", "off", "false"):
        return False, None
    if mode not in ("auto", "1", "on", "true"):
        raise ValueError(f"megakernel must be auto, 1 or 0, got {mode!r}")
    if not (mode != "auto" or on_card):
        return False, None
    reason = ("efb" if efb else "node_rng" if node_rng
              else "quantized" if quantize_bins and on_card else None)
    if reason is not None:
        _san.record_megakernel_fallback()
        _obs.counter("megakernel_envelope_fallbacks_total").inc()
        _obs.event("megakernel_fallback", reason=reason)
        return False, reason
    return True, None


def _sharding(shard, merge: str, rng_key, graphs, efb, nbpf, mbpf, fmask, cmask,
              contri) -> Sharding:
    """A sharded windowed tree's Sharding, with the scatter merge's feature
    block tables (pads: one bin, no missing bin, masked, contri 1)."""
    if merge not in ("psum", "scatter"):
        raise ValueError(f"merge must be 'psum' or 'scatter', got {merge!r}")
    if graphs is not None or efb is not None:
        raise ValueError("the sharded windowed round runs eagerly over the "
                         "feature bins (no graphs, no EFB plan)")
    if merge == "psum":
        return Sharding(shard, merge)
    if rng_key is not None:
        raise ValueError(
            "merge='scatter' (owned-feature split search) is incompatible with "
            "per-node feature sampling (feature_fraction_bynode/extra_trees): "
            "each rank would sample only its owned block; use merge='psum'")
    f0, k, fp = owned_features(nbpf.shape[0], shard.mesh)
    return Sharding(shard, merge, f0, feature_block_tables(
        f0, k, fp, nbpf, mbpf, fmask, cmask, contri), own_mesh=shard.mesh)


def feature_block_tables(f0: int, k: int, fp: int, nbpf, mbpf, fmask, cmask,
                         contri) -> tuple:
    """The split tables of the feature block [f0, f0 + k) of the features
    padded to ``fp``: pads have one bin, no missing bin, are masked and
    have contri 1, so they never split."""
    f = nbpf.shape[0]

    def block(v, fill):
        if v is None:
            return None
        if fp > f:
            v = torch.cat([v, torch.full((fp - f,), fill, dtype=v.dtype,
                                         device=v.device)])
        return v[f0:f0 + k].contiguous()

    return (block(nbpf, 1), block(mbpf, -1), block(fmask, False),
            block(cmask, False), block(contri, 1.0))


def grow_tree_windowed(
    bins: torch.Tensor,  # (N, F) int16, row-major
    grad: torch.Tensor,
    hess: torch.Tensor,
    row_mask: torch.Tensor,
    sample_weight: torch.Tensor,
    feature_mask: torch.Tensor,  # (F,) bool
    num_bins_per_feature: torch.Tensor,
    missing_bin_per_feature: torch.Tensor,
    *,
    num_leaves: int,
    num_bins: int,
    max_depth: int = -1,
    params: SplitParams = SplitParams(),
    leaf_tile: int = 16,
    quantize_bins: int = 0,
    stochastic_rounding: bool = True,
    quant_renew: bool = False,
    generator: Optional[torch.Generator] = None,
    stats: Optional[dict] = None,
    guard_label: str = "",
    megakernel_opt: Optional[str] = None,
    graphs: Optional[RoundGraphs] = None,
    hist_precision: str = "f32",
    categorical_mask: Optional[torch.Tensor] = None,  # (F,) bool
    feature_contri: Optional[torch.Tensor] = None,  # (F,) f32
    efb: Optional[tuple] = None,  # Dataset.efb_device_tables()
    rng_key: Optional[torch.Tensor] = None,  # (2L-1, 2, F) node uniforms
    axis_name=None,  # parallel/mesh.py::RowShard: this rank's rows
    merge: str = "psum",  # sharded: psum | scatter
    sharding: Optional[Sharding] = None,  # 2-D / hierarchical (parallel/)
    **options,
) -> tuple[TreeArrays, torch.Tensor]:
    """Grow one tree with windowed rounds; returns (tree, leaf_id per row).
    ``graphs``: run every round through that cache's static buffers (one
    CUDA-graph replay a round on the card), else as eager torch launches.
    ``stats``, when given, receives {rounds, host_syncs, async_resolves,
    captures, replays, dispatches, megakernel_fallbacks, retries, windows,
    megakernel, megakernel_excluded}: the counts of utils/sanitizer.py over
    the whole tree.  ``efb``: an EFB plan's (bundled (N, F_b) int16,
    gather, default), which the root and window passes read (the
    three-pass round: the megakernel excludes it).  ``rng_key``: the
    tree's node uniforms for extra_trees and feature_fraction_bynode (the
    three-pass round too).  ``axis_name``: the rows are one rank's of a
    data-parallel training, merged by ``merge`` (module docstring; eager
    rounds, no EFB plan; the scatter merge refuses per-node sampling, whose
    draw must span every feature on every rank).  ``sharding``: a 2-D or
    hierarchical mesh's context, built by parallel/feature2d.py and
    parallel/hierarchy.py (eager rounds, three-pass)."""
    if options:
        raise TypeError(f"unexpected options: {sorted(options)}")
    if feature_mask is None:
        feature_mask = torch.ones(bins.shape[1], dtype=torch.bool,
                                  device=bins.device)
    if sharding is not None:
        if graphs is not None or efb is not None or rng_key is not None:
            raise ValueError("the 2-D and hierarchical rounds run eagerly over the "
                             "feature bins, without per-node sampling")
    elif axis_name is not None:
        sharding = _sharding(axis_name, merge, rng_key, graphs, efb,
                             num_bins_per_feature, missing_bin_per_feature,
                             feature_mask, categorical_mask, feature_contri)
    with _san.DispatchCounter() as counter:  # the gate's fallback count too
        mk, excluded = megakernel_mode(bins.is_cuda, quantize_bins=quantize_bins,
                                       efb=efb is not None,
                                       node_rng=rng_key is not None,
                                       mode=megakernel_opt)
        if mk and _obs.enabled():
            _obs.counter("train_megakernel_trees_total").inc()
        tile = max(1, min(leaf_tile, num_leaves))
        static = dict(num_leaves=num_leaves, num_bins=num_bins, max_depth=max_depth,
                      params=params, leaf_tile=tile, quantize_bins=quantize_bins,
                      megakernel=mk, hist_precision=hist_precision)
        tables = (categorical_mask, feature_contri)
        fixed = (bins, num_bins_per_feature, missing_bin_per_feature,
                 *(t for t in tables if t is not None), *(efb or ()))

        try:
            hist = None if graphs is None or graphs.buffers is None else (
                graphs.buffers[0].hist)
            state, inputs, g_true, h_true = _w_init(
                bins, grad, hess, row_mask, sample_weight, num_bins_per_feature,
                missing_bin_per_feature, feature_mask, num_leaves=num_leaves,
                num_bins=num_bins, params=params, quantize_bins=quantize_bins,
                stochastic_rounding=stochastic_rounding, generator=generator,
                hist_precision=hist_precision, categorical_mask=categorical_mask,
                feature_contri=feature_contri, hist=hist, efb=efb, rng=rng_key,
                sharding=sharding)
            n = bins.shape[0]
            # round 1 needs no feedback: a round's window (the small
            # children) can never exceed floor(N/2) rows, whatever it admits;
            # a rank's can hold all its rows (the child is small globally)
            w_first = _window_size(max(n // 2 if sharding is None else n, 1), n)
            state = _run_fused_rounds(
                round_runner(windowed_round_fn(bins, num_bins_per_feature,
                                               missing_bin_per_feature, tables,
                                               efb, sharding, static),
                             state, inputs, fixed,
                             ("windowed",) + tuple(static.items()), graphs),
                state, n_ladder=n, w_first=w_first,
                num_leaves=num_leaves, stats=stats, guard_label=guard_label)
            tree, leaf_id = _w_finalize(
                state, g_true, h_true, inputs.row_mask, params=params,
                quant_renew=bool(quant_renew and quantize_bins),
                shard=None if sharding is None else sharding.shard)
            if graphs is not None:  # the next tree overwrites the buffers
                tree = TreeArrays(*[None if a is None else a.clone() for a in tree])
                leaf_id = leaf_id.clone()
            return tree, leaf_id
        finally:
            if stats is not None:
                stats.update(counter.stats(), megakernel=mk,
                             megakernel_excluded=excluded)
