"""Round-batched leaf-wise tree growth.

Counterpart of lightgbm_tpu/ops/treegrow_fast.py: each round splits every
evaluated leaf whose gain clears the bar (best-gain-first, at most
``leaf_tile`` per round, within the num_leaves budget), histograms all new
smaller children in ONE multi-leaf kernel pass (ops/hist_cuda.py), recovers
the bigger siblings by subtraction, and evaluates all fresh leaves with one
batched split search.  Split math, admission order and leaf numbering are
the JAX package's, so on fixtures with separated gains both packages grow
the same trees.

There is no jit here: the rounds loop is a Python loop that reads one
scalar (the number of admitted splits) per round.  Per-leaf bookkeeping is
small tensor updates on the device; node arrays carry one spare slot at
index L-1 that takes the writes the JAX code drops with mode="drop".

Supported: numerical splits, missing values, max_depth, bagging masks and
sample weights, path smoothing, float and int8-quantized histograms
(quantize_bins, stochastic_rounding, quant_renew).  Monotone, interaction
and CEGB constraints, forced splits, EFB bundles, linear trees, categorical
splits and per-node sampling raise ValueError (ROADMAP queue A5/A8).
"""

from __future__ import annotations

from typing import Optional

import torch

from .histogram import fix_histogram_subtract, histogram_multi, histogram_multi_quantized
from .split import KMIN_SCORE, SplitParams, find_best_split, leaf_output, leaf_output_smoothed
from .treegrow import TreeArrays, _empty_best, _set_best

_UNPORTED = ("categorical_mask", "monotone_constraints", "interaction_sets",
             "rng_key", "cegb_feature_penalty", "efb_bins", "feature_contri",
             "forced_leaf", "cegb_lazy_penalty", "track_path")


def predict_leaf_arrays(arrays: TreeArrays, bins: torch.Tensor,
                        missing_bin_per_feature: torch.Tensor) -> torch.Tensor:
    """Leaf index per row for a device tree on binned rows (host analogue:
    Tree::GetLeafIndex).  Children encode leaves as ~leaf."""
    n = bins.shape[0]
    L = arrays.leaf_value.shape[0]
    cur = torch.zeros(n, dtype=torch.int64, device=bins.device)
    if int(arrays.num_leaves) <= 1:
        return cur.to(torch.int32)
    sf = arrays.split_feature.long()
    lc, rc = arrays.left_child.long(), arrays.right_child.long()
    for _ in range(max(L - 1, 1)):
        nd = cur.clamp(0, max(L - 2, 0))
        ft = sf[nd]
        col = bins.gather(1, ft[:, None])[:, 0].to(torch.int32)
        miss = col == missing_bin_per_feature[ft]
        gl = torch.where(miss, arrays.default_left[nd],
                         col <= arrays.threshold_bin[nd])
        cur = torch.where(cur >= 0, torch.where(gl, lc[nd], rc[nd]), cur)
    return (-cur - 1).to(torch.int32)


def grow_tree_fast(
    bins: torch.Tensor,  # (N, F) int16
    grad: torch.Tensor,  # (N,) f32
    hess: torch.Tensor,
    row_mask: torch.Tensor,  # (N,) bool
    sample_weight: torch.Tensor,  # (N,) f32
    feature_mask: Optional[torch.Tensor],  # (F,) bool
    num_bins_per_feature: torch.Tensor,  # (F,) i32
    missing_bin_per_feature: torch.Tensor,  # (F,) i32
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
    **options,
) -> tuple[TreeArrays, torch.Tensor]:
    """Grow one tree in rounds; returns (tree, final leaf_id per row).

    quantize_bins > 0 enables quantized training (reference:
    gradient_discretizer.cpp): gradients/hessians are discretized to int8
    (stochastic rounding draws from ``generator``), histograms accumulate
    exactly in int32, and split evaluation sees the rescaled sums;
    quant_renew recomputes leaf outputs from the true gradients."""
    for name in _UNPORTED:
        v = options.pop(name, None)
        if v is not None and v is not False:
            raise ValueError(f"grow_tree_fast: {name} is not ported to "
                             "lightgbm_tpu_torch yet (ROADMAP queue A5/A8)")
    if options:
        raise TypeError(f"unexpected options: {sorted(options)}")
    dev = bins.device
    n, f = bins.shape
    L = num_leaves
    grad = grad.float() * sample_weight
    hess = hess.float() * sample_weight
    grad_true, hess_true = grad, hess

    if quantize_bins:
        # discretize: grad in [-half, half], hess in [0, quantize_bins]
        # (reference: GradientDiscretizer::DiscretizeGradients)
        half = max(quantize_bins // 2, 1)
        inbag = row_mask.float()
        g_scale = torch.clamp_min(torch.max(torch.abs(grad) * inbag) / half,
                                  1e-30)
        h_scale = torch.clamp_min(torch.max(hess * inbag) / quantize_bins,
                                  1e-30)
        gs = grad / g_scale
        hs = hess / h_scale
        if stochastic_rounding:
            u = torch.rand((2, n), generator=generator, device=dev)
            gq = torch.floor(gs + u[0])
            hq = torch.floor(hs + u[1])
        else:
            gq = torch.round(gs)
            hq = torch.round(hs)
        gq = gq.clamp(-127, 127).to(torch.int8)
        hq = hq.clamp(0, 127).to(torch.int8)
        # downstream sees the dequantized values, consistent with the int
        # histograms
        grad = gq.float() * g_scale
        hess = hq.float() * h_scale
        quant_scale = torch.stack([g_scale, h_scale,
                                   torch.ones((), device=dev)])

    def multi_hist(leaf_slot: torch.Tensor, tile: int) -> torch.Tensor:
        """(N,)-slot -> (tile, 3, F, B) f32: per-slot histograms, one pass."""
        m = row_mask & (leaf_slot >= 0)
        if quantize_bins:
            hi = histogram_multi_quantized(bins, gq, hq, m, leaf_slot, 0, tile,
                                           num_bins)
            return hi.float() * quant_scale[:, None, None]
        return histogram_multi(bins, grad, hess, m, leaf_slot, 0, tile,
                               num_bins)

    def zeros(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    # ---- root ----
    minus1 = torch.full((n,), -1, dtype=torch.int32, device=dev)
    hist0 = multi_hist(torch.where(row_mask, 0, minus1), 1)[0]
    g0, h0, c0 = torch.sum(hist0[:, 0, :], dim=1)  # totals from feature 0

    # node arrays: L-1 real slots + one spare (index L-1) for dropped writes
    t_feature = zeros(L, torch.int32)
    t_thr = zeros(L, torch.int32)
    t_dl = zeros(L, torch.bool)
    t_gain = zeros(L)
    t_left = zeros(L, torch.int32)
    t_right = zeros(L, torch.int32)
    t_ival = zeros(L)
    t_iweight = zeros(L)
    t_icount = zeros(L)

    leaf_out0 = leaf_output(g0, h0, params)
    best = _empty_best(L, num_bins, dev)
    root = torch.zeros(1, dtype=torch.int64, device=dev)
    _set_best(best, root, find_best_split(
        hist0[None], g0[None], h0[None], c0[None], num_bins_per_feature,
        missing_bin_per_feature, params, feature_mask=feature_mask,
        parent_output=leaf_out0[None]))

    leaf_id = torch.zeros(n, dtype=torch.int32, device=dev)
    hist = zeros((L, 3, f, num_bins))
    hist[0] = hist0
    leaf_sum_g, leaf_sum_h, leaf_count = zeros(L), zeros(L), zeros(L)
    leaf_sum_g[0], leaf_sum_h[0], leaf_count[0] = g0, h0, c0
    leaf_depth = zeros(L, torch.int32)
    leaf_parent = torch.full((L,), -1, dtype=torch.int32, device=dev)
    leaf_side = zeros(L, torch.int32)
    leaf_out = zeros(L)
    leaf_out[0] = leaf_out0
    num_cur = 1
    eps = KMIN_SCORE / 2
    inf = torch.tensor(float("inf"), device=dev)

    while num_cur < L:
        # ---------- phase 1: admit this round's splits ----------
        gains = best.gain
        can = gains > eps
        if max_depth > 0:
            can = can & (leaf_depth < max_depth)
        # best-gain-first within the budget and the leaf tile; the admitted
        # set is a prefix of the stable sort order
        srt = torch.argsort(torch.where(can, -gains, inf), stable=True)
        k = min(int(can.sum()), L - num_cur, leaf_tile)  # one sync a round
        if k == 0:
            break
        lv = srt[:k]  # admitted leaves in rank order (left children keep ids)
        ar = torch.arange(k, dtype=torch.int32, device=dev)
        nodes = (num_cur - 1 + ar).long()
        rights = (num_cur + ar).long()
        s_feat = best.feature[lv]
        s_thr = best.threshold_bin[lv]
        s_dl = best.default_left[lv]
        s_lg, s_lh, s_lc = best.left_sum_g[lv], best.left_sum_h[lv], best.left_count[lv]
        s_rg, s_rh, s_rc = best.right_sum_g[lv], best.right_sum_h[lv], best.right_count[lv]

        # ---------- row partition: all admitted splits at once ----------
        right_of = torch.full((L,), -1, dtype=torch.int32, device=dev)
        right_of[lv] = rights.to(torch.int32)
        lid = leaf_id.long()
        r_row = right_of[lid]
        feat_row = best.feature.long()[lid]
        col = bins.gather(1, feat_row[:, None])[:, 0].to(torch.int32)
        miss = col == missing_bin_per_feature[feat_row]
        gl = torch.where(miss, best.default_left[lid],
                         col <= best.threshold_bin[lid])
        leaf_id = torch.where((r_row >= 0) & ~gl, r_row, leaf_id)

        # ---------- tree bookkeeping ----------
        par = leaf_parent[lv].long()
        side = leaf_side[lv]
        spare = L - 1
        t_left[torch.where((par >= 0) & (side == 0), par, spare)] = nodes.to(torch.int32)
        t_right[torch.where((par >= 0) & (side == 1), par, spare)] = nodes.to(torch.int32)
        t_left[nodes] = (-lv - 1).to(torch.int32)
        t_right[nodes] = (-rights - 1).to(torch.int32)
        t_feature[nodes] = s_feat
        t_thr[nodes] = s_thr
        t_dl[nodes] = s_dl
        t_gain[nodes] = best.gain[lv]
        parent_out = leaf_out[lv]
        t_ival[nodes] = parent_out
        t_iweight[nodes] = leaf_sum_h[lv]
        t_icount[nodes] = leaf_count[lv]

        # ---------- leaf aggregates (left keeps the id, right is new) ----------
        for arr, lval, rval in ((leaf_sum_g, s_lg, s_rg),
                                (leaf_sum_h, s_lh, s_rh),
                                (leaf_count, s_lc, s_rc)):
            arr[lv] = lval
            arr[rights] = rval
        depth_child = leaf_depth[lv] + 1
        leaf_depth[lv] = depth_child
        leaf_depth[rights] = depth_child
        leaf_parent[lv] = nodes.to(torch.int32)
        leaf_parent[rights] = nodes.to(torch.int32)
        leaf_side[lv] = 0
        leaf_side[rights] = 1
        leaf_out[lv] = leaf_output_smoothed(s_lg, s_lh, s_lc, parent_out, params)
        leaf_out[rights] = leaf_output_smoothed(s_rg, s_rh, s_rc, parent_out,
                                                params)
        num_cur += k

        # ---------- phase 2: one pass for all smaller children ----------
        left_smaller = s_lc <= s_rc
        small = torch.where(left_smaller, lv, rights)
        slot_of_leaf = torch.full((L,), -1, dtype=torch.int32, device=dev)
        slot_of_leaf[small] = ar
        fresh = multi_hist(slot_of_leaf[leaf_id.long()], k)  # (k, 3, F, B)
        big = fix_histogram_subtract(hist[lv], fresh)
        sml = left_smaller[:, None, None, None]
        left_h = torch.where(sml, fresh, big)
        right_h = torch.where(sml, big, fresh)
        hist[lv] = left_h
        hist[rights] = right_h

        # ---------- phase 3: evaluate the fresh leaves ----------
        cand = torch.cat([lv, rights])
        _set_best(best, cand, find_best_split(
            torch.cat([left_h, right_h]), leaf_sum_g[cand], leaf_sum_h[cand],
            leaf_count[cand], num_bins_per_feature, missing_bin_per_feature,
            params, feature_mask=feature_mask, parent_output=leaf_out[cand]))

    if quant_renew and quantize_bins:
        # leaf outputs from the TRUE gradients (reference: GBDT::Train ->
        # RenewIntGradTreeOutput): per-leaf sums as a one-feature histogram
        # (bin = leaf id), deterministic like every other kernel sum
        leaf_hist = histogram_multi(
            leaf_id.to(torch.int16)[:, None].contiguous(), grad_true,
            hess_true, row_mask, torch.zeros_like(leaf_id), 0, 1, L)
        leaf_value = leaf_output(leaf_hist[0, 0, 0], leaf_hist[0, 1, 0], params)
    elif params.path_smooth > 0:
        leaf_value = leaf_out  # smoothed at creation
    else:
        leaf_value = leaf_output(leaf_sum_g, leaf_sum_h, params)
    active = torch.arange(L, device=dev) < num_cur
    m = L - 1
    tree = TreeArrays(
        num_leaves=torch.tensor(num_cur, dtype=torch.int32, device=dev),
        split_feature=t_feature[:m],
        threshold_bin=t_thr[:m],
        default_left=t_dl[:m],
        split_gain=t_gain[:m],
        left_child=t_left[:m],
        right_child=t_right[:m],
        internal_value=t_ival[:m],
        internal_weight=t_iweight[:m],
        internal_count=t_icount[:m],
        leaf_value=torch.where(active, leaf_value, 0.0),
        leaf_weight=torch.where(active, leaf_sum_h, 0.0),
        leaf_count=torch.where(active, leaf_count, 0.0),
        leaf_sum_g=torch.where(active, leaf_sum_g, 0.0),
        leaf_depth=leaf_depth,
        is_cat=zeros(m, torch.bool),
        cat_mask=zeros((m, num_bins), torch.bool),
    )
    return tree, leaf_id
