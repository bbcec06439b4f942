"""Round-batched leaf-wise tree growth.

Counterpart of lightgbm_tpu/ops/treegrow_fast.py: each round splits every
evaluated leaf whose gain clears the bar (best-gain-first, at most
``leaf_tile`` per round, within the num_leaves budget), histograms all new
smaller children in ONE multi-leaf kernel pass (ops/hist_cuda.py), recovers
the bigger siblings by subtraction, and evaluates all fresh leaves with one
batched split search.  Split math, admission order and leaf numbering are
the JAX package's, so on fixtures with separated gains both packages grow
the same trees.

A round is the JAX package's masked fixed-tile round: the admitted splits
are a mask over the leaves, the number of leaves lives on the device, the
histogram pass always runs at ``leaf_tile`` slots, and writes of the slots
and leaves a round does not admit land in spare rows.  So a round reads
nothing back and a round that admits nothing is a bitwise no-op.  The host
drives the rounds with the windowed grower's one-behind protocol
(ops/treegrow_windowed.py::_run_fused_rounds): each round's info vector is
read while the next round runs.  With ``graphs`` (ops/graphs.py; GBDT
passes one on its fused path) each round is one run of the same round
function on static buffers, on the card one CUDA-graph replay.

Supported: numerical and categorical splits, missing values, max_depth,
bagging masks and sample weights, path smoothing, feature_contri, float,
bf16 (``hist_precision``: grad and hess rounded to bfloat16 once a tree,
summed exactly) and int8-quantized histograms (quantize_bins,
stochastic_rounding, quant_renew), and EFB bundles (``efb``: the root and
round passes histogram the bundled matrix and unbundle, int8 histograms
before they are scaled; the partition reads the feature bins), and the JAX package's constraint
envelope (ops/treegrow.py): monotone constraints, basic or intermediate
(same-round splits under a shared monotone node are deferred by a masked
admission, so bounds evolve one split at a time), interaction constraints,
CEGB split, coupled and lazy penalties, per-node sampling from the tree's
uniform table, forced splits (one single-split round per schedule entry
before free growth, its cursor in the state) and the path features of
linear trees.  Their per-leaf state lives in ``FState`` and so in a
graph's static buffers: a constrained round is still one replay.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils import sanitizer as _san
from .graphs import RoundGraphs
from .histogram import histogram_multi, histogram_multi_quantized, unbundle
from .round_cuda import split_window
from .split import (KMIN_SCORE, BestSplit, SplitParams, find_best_split,
                    forced_split_candidate, leaf_output, leaf_output_smoothed)
from .treegrow import (Envelope, TreeArrays, _empty_best, _put, _set_best, admit,
                       admits_next, at, basic_bounds, book_tree, empty_tree,
                       final_leaf_values, finish_tree, go_left_of,
                       intermediate_bounds, leaf_search, quantize_gradients,
                       reject_unported)
from .treegrow_windowed import _run_fused_rounds, round_runner


class FState(NamedTuple):
    leaf_id: torch.Tensor  # (N,) i32
    hist: torch.Tensor  # (L + 1, 3, F, B) f32, row L a spare; in place
    best: BestSplit
    leaf_sum_g: torch.Tensor
    leaf_sum_h: torch.Tensor
    leaf_count: torch.Tensor
    leaf_depth: torch.Tensor  # i64
    leaf_parent: torch.Tensor  # i64, -1 at the root
    leaf_side: torch.Tensor  # i64
    num_leaves_cur: torch.Tensor  # 0-d i64
    leaf_out: torch.Tensor
    tree: TreeArrays
    inputs_finite: torch.Tensor  # 0-d bool
    # the constraint envelope's state, None where the option is off
    leaf_lo: Optional[torch.Tensor] = None  # (L,) monotone output bounds
    leaf_hi: Optional[torch.Tensor] = None
    anc: Optional[torch.Tensor] = None  # (L, L-1) bool ancestors (intermediate)
    aside: Optional[torch.Tensor] = None  # (L, L-1) bool: on the node's right
    cegb_used: Optional[torch.Tensor] = None  # (F,) bool features split on
    used: Optional[torch.Tensor] = None  # (L, F) bool path features
    lazy_used: Optional[torch.Tensor] = None  # (N, F) bool charged rows
    lazy_counts: Optional[torch.Tensor] = None  # (L, F) f32 uncharged rows
    forced_i: Optional[torch.Tensor] = None  # 0-d i64 schedule cursor
    forced_ok: Optional[torch.Tensor] = None  # 0-d bool: no entry failed yet


class FInputs(NamedTuple):
    """A tree's inputs to its rounds (the static buffers' second part)."""
    grad: torch.Tensor  # f32, or bf16 under hist_precision=bf16
    hess: torch.Tensor
    gq: Optional[torch.Tensor]
    hq: Optional[torch.Tensor]
    quant_scale: Optional[torch.Tensor]
    row_mask: torch.Tensor
    feature_mask: Optional[torch.Tensor]
    rng: Optional[torch.Tensor] = None  # (2L-1, 2, F) node uniforms
    cegb_pen: Optional[torch.Tensor] = None  # (F,) coupled penalties


def predict_leaf_arrays(arrays: TreeArrays, bins: torch.Tensor,
                        missing_bin_per_feature: torch.Tensor,
                        categorical: bool = False) -> torch.Tensor:
    """Leaf index per row for a device tree on binned rows (host analogue:
    Tree::GetLeafIndex).  Children encode leaves as ~leaf.  ``categorical``:
    the tree may hold categorical nodes (their bin-space masks route)."""
    n = bins.shape[0]
    L = arrays.leaf_value.shape[0]
    # a one-leaf tree starts every row at leaf 0 (~(-1)): nothing is read back
    start = torch.where(arrays.num_leaves > 1, 0, -1).to(torch.int64)
    cur = torch.zeros(n, dtype=torch.int64, device=bins.device) + start
    sf = arrays.split_feature.long()
    lc, rc = arrays.left_child.long(), arrays.right_child.long()
    for _ in range(max(L - 1, 1)):
        nd = cur.clamp(0, max(L - 2, 0))
        ft = sf[nd]
        col = bins.gather(1, ft[:, None])[:, 0].to(torch.int32)
        gl = go_left_of(col, missing_bin_per_feature[ft], arrays.default_left[nd],
                        arrays.threshold_bin[nd],
                        *((arrays.is_cat[nd], arrays.cat_mask[nd, col.long()])
                          if categorical else ()))
        cur = torch.where(cur >= 0, torch.where(gl, lc[nd], rc[nd]), cur)
    return (-cur - 1).to(torch.int32)


def _multi_hist(bins, inp: FInputs, leaf_slot, tile: int, num_bins: int,
                quantize_bins: int, hist_precision: str, efb=None) -> torch.Tensor:
    """(N,)-slot -> (tile, 3, F, B) f32: per-slot histograms, one pass (over
    the bundled matrix, then unbundled, with an EFB plan)."""
    src = bins if efb is None else efb[0]
    m = inp.row_mask & (leaf_slot >= 0)
    if quantize_bins:
        hi = histogram_multi_quantized(src, inp.gq, inp.hq, m, leaf_slot, 0,
                                       tile, num_bins)
        return unbundle(hi, efb, num_bins).float() * inp.quant_scale[:, None, None]
    return unbundle(histogram_multi(src, inp.grad, inp.hess, m, leaf_slot, 0, tile,
                                    num_bins, precision=hist_precision), efb, num_bins)


def _f_init(bins, grad, hess, row_mask, sample_weight, feature_mask, nbpf, mbpf,
            *, num_leaves: int, num_bins: int, params: SplitParams,
            quantize_bins: int, stochastic_rounding: bool,
            generator: Optional[torch.Generator], hist_precision: str = "f32",
            categorical_mask=None, feature_contri=None, hist=None, efb=None,
            env: Envelope = Envelope(), rng=None, cegb_pen=None,
            lazy_used=None):
    """Root state: quantize gradients, the root pass, seed best.  ``hist``:
    the (L + 1, 3, F, B) buffer for the histogram state, else a new one;
    ``efb``: the EFB tables; ``env``, ``rng``, ``cegb_pen`` and
    ``lazy_used``: the constraint envelope and this tree's uniforms,
    coupled penalties and lazy charges.  Returns (state, FInputs,
    grad_true, hess_true)."""
    dev = bins.device
    n, f = bins.shape
    L = num_leaves
    grad = grad.float() * sample_weight
    hess = hess.float() * sample_weight
    grad_true, hess_true = grad, hess
    gq = hq = quant_scale = None
    if quantize_bins:
        gq, hq, grad, hess, quant_scale = quantize_gradients(
            grad, hess, row_mask, quantize_bins, stochastic_rounding, generator)
    elif hist_precision == "bf16":  # rounded once, as the payload is built
        grad, hess = grad.to(torch.bfloat16), hess.to(torch.bfloat16)
    inputs = FInputs(grad, hess, gq, hq, quant_scale, row_mask, feature_mask,
                     rng, cegb_pen)
    minus1 = torch.full((n,), -1, dtype=torch.int32, device=dev)
    hist0 = _multi_hist(bins, inputs, torch.where(row_mask, 0, minus1), 1,
                        num_bins, quantize_bins, hist_precision, efb)[0]
    g0, h0, c0 = torch.sum(hist0[:, 0, :], dim=1)  # totals from feature 0

    def zeros(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def first(v):
        out = zeros(L)
        out[0] = v
        return out

    mono = env.monotone is not None
    ext = dict(
        leaf_lo=torch.full((L,), float("-inf"), device=dev) if mono else None,
        leaf_hi=torch.full((L,), float("inf"), device=dev) if mono else None,
        anc=zeros((L, L - 1), torch.bool) if env.intermediate else None,
        aside=zeros((L, L - 1), torch.bool) if env.intermediate else None,
        cegb_used=zeros(f, torch.bool) if cegb_pen is not None else None,
        used=(zeros((L, f), torch.bool)
              if env.sets is not None or env.track_path else None),
        lazy_used=lazy_used,
        lazy_counts=None if lazy_used is None else zeros((L, f)),
        forced_i=None if env.forced is None else zeros((), torch.int64),
        forced_ok=None if env.forced is None else torch.ones((), dtype=torch.bool,
                                                             device=dev))
    if lazy_used is not None:
        ext["lazy_counts"][0] = row_mask.float() @ (~lazy_used).float()
    leaf_out0 = leaf_output(g0, h0, params)
    root = torch.zeros(1, dtype=torch.int64, device=dev)

    def row0(t):
        return None if t is None else t[:1]

    best = _empty_best(L, num_bins, dev)
    _set_best(best, root, find_best_split(
        hist0[None], g0[None], h0[None], c0[None], nbpf, mbpf, params,
        parent_output=leaf_out0[None], categorical_mask=categorical_mask,
        feature_contri=feature_contri,
        **leaf_search(env, feature_mask, rng, cegb_pen, ext["cegb_used"],
                      row0(ext["used"]), row0(ext["leaf_lo"]), row0(ext["leaf_hi"]),
                      root, zeros(1, torch.int64), row0(ext["lazy_counts"]))))

    if hist is None:
        hist = zeros((L + 1, 3, f, num_bins))
    else:
        hist.zero_()
    hist[0] = hist0
    state = FState(
        leaf_id=zeros(n, torch.int32), hist=hist, best=best,
        leaf_sum_g=first(g0), leaf_sum_h=first(h0), leaf_count=first(c0),
        leaf_depth=zeros(L, torch.int64),
        leaf_parent=torch.full((L,), -1, dtype=torch.int64, device=dev),
        leaf_side=zeros(L, torch.int64),
        num_leaves_cur=torch.ones((), dtype=torch.int64, device=dev),
        leaf_out=first(leaf_out0), tree=empty_tree(L, num_bins, dev),
        inputs_finite=torch.isfinite(grad_true).all() & torch.isfinite(hess_true).all(),
        **ext)
    return state, inputs, grad_true, hess_true


def _round(st: FState, bins, inp: FInputs, nbpf, mbpf, cmask=None, contri=None, *,
           num_leaves: int, num_bins: int, max_depth: int, params: SplitParams,
           leaf_tile: int, quantize_bins: int, hist_precision: str = "f32",
           efb=None, env: Envelope = Envelope(), forced: bool = False):
    """One masked fixed-tile round; returns (state', info) with info =
    [k_acc, 0, 1, 0, finite, k_next] (i32, on the device; the windowed
    round's layout, whose window fields this round has no use for).
    ``forced``: the round applies the schedule entry at the state's cursor
    (valid or not), and only it (reference: ForceSplits)."""
    L, T = num_leaves, leaf_tile
    dev = bins.device
    f = bins.shape[1]
    s = st.best
    idx = torch.arange(L, dtype=torch.int64, device=dev)
    nlc = st.num_leaves_cur
    drop = -1  # _put's index of the spare slot
    mono = env.monotone
    ext = {}

    # ---------- phase 1: admit this round's splits ----------
    if forced:
        fleaf, ffeat, fbin = env.forced
        fi = st.forced_i.clamp_max(fleaf.shape[0] - 1)
        fl_raw = at(fleaf, fi).long()
        fl = fl_raw.clamp(0, L - 1)
        s_f = forced_split_candidate(
            at(st.hist, fl), at(st.leaf_sum_g, fl), at(st.leaf_sum_h, fl),
            at(st.leaf_count, fl), nbpf, mbpf, params, at(ffeat, fi), at(fbin, fi),
            categorical_mask=cmask, monotone_constraints=mono,
            out_lo=None if mono is None else at(st.leaf_lo, fl),
            out_hi=None if mono is None else at(st.leaf_hi, fl),
            depth=at(st.leaf_depth, fl), parent_output=at(st.leaf_out, fl),
            feature_contri=contri)
        valid = ((fl_raw < nlc) & (nlc < L) & (s_f.gain > KMIN_SCORE / 2)
                 & st.forced_ok)
        if max_depth > 0:
            valid = valid & (at(st.leaf_depth, fl) < max_depth)
        # the first invalid entry disables the rest of the schedule
        ext.update(forced_i=st.forced_i + 1, forced_ok=valid)
        accept = (idx == fl) & valid
        order_rank = torch.where(accept, 0, L)
        s = BestSplit(*[_put(a, fl.reshape(1), v[None]) for a, v in zip(s, s_f)])
    else:
        conflict = None
        if env.intermediate:
            # leaves under a common monotone node conflict: their splits
            # would move each other's bounds
            d_nodes = torch.where(st.tree.is_cat, 0, mono[st.tree.split_feature.long()])
            mono_anc = (st.anc & (d_nodes != 0)[None, :]).float()
            conflict = (mono_anc @ mono_anc.T) > 0.5
        accept, order_rank, _ = admit(s.gain, st.leaf_depth, nlc, num_leaves=L,
                                      leaf_tile=T, max_depth=max_depth,
                                      conflict=conflict)
    k_acc = accept.sum()
    acc_rank = torch.where(accept, order_rank, L)
    node_of = nlc - 1 + acc_rank  # node slot of each admitted leaf
    right_of = nlc + acc_rank  # leaf id of its right child

    # ---------- row partition: all admitted splits at once ----------
    lid = st.leaf_id.long()
    r_row = torch.where(accept, right_of, -1)[lid]
    feat_row = s.feature.long()[lid]
    col = bins.gather(1, feat_row[:, None])[:, 0].to(torch.int32)
    gl = go_left_of(col, mbpf[feat_row], s.default_left[lid], s.threshold_bin[lid],
                    *((s.is_cat[lid], s.cat_mask[lid, col.long()])
                      if cmask is not None else ()))
    leaf_id = torch.where((r_row >= 0) & ~gl, r_row.to(torch.int32), st.leaf_id)

    # ---------- tree and leaf bookkeeping (left keeps the id) ----------
    tree = book_tree(st.tree, accept, node_of, right_of, st.leaf_parent,
                     st.leaf_side, s, st.leaf_out, st.leaf_sum_h, st.leaf_count,
                     categorical=cmask is not None)
    right_pos = torch.where(accept, right_of, drop)

    def upd(arr, left_val, right_val):
        return _put(torch.where(accept if arr.dim() == 1 else accept[:, None],
                                left_val, arr), right_pos, right_val)

    leaf_sum_g = upd(st.leaf_sum_g, s.left_sum_g, s.right_sum_g)
    leaf_sum_h = upd(st.leaf_sum_h, s.left_sum_h, s.right_sum_h)
    leaf_count = upd(st.leaf_count, s.left_count, s.right_count)
    depth_child = st.leaf_depth + 1
    leaf_depth = upd(st.leaf_depth, depth_child, depth_child)
    leaf_parent = upd(st.leaf_parent, node_of, torch.where(accept, node_of, 0))
    leaf_side = _put(torch.where(accept, 0, st.leaf_side), right_pos, 1)
    out_l = leaf_output_smoothed(s.left_sum_g, s.left_sum_h, s.left_count,
                                 st.leaf_out, params)
    out_r = leaf_output_smoothed(s.right_sum_g, s.right_sum_h, s.right_count,
                                 st.leaf_out, params)
    num_leaves_new = nlc + k_acc
    feat_oh = torch.arange(f, device=dev)[None, :] == s.feature.long()[:, None]
    if env.intermediate:
        # admitted splits share no monotone ancestor, so each child's
        # bounds are its parent's current ones; then every leaf's bounds
        # from the opposite subtrees' outputs
        node_oh = accept[:, None] & (node_of[:, None]
                                     == torch.arange(L - 1, device=dev)[None, :])
        anc_child = st.anc | node_oh
        ext.update(anc=upd(st.anc, anc_child, anc_child),
                   aside=_put(st.aside, right_pos, st.aside | node_oh))
        leaf_out = upd(st.leaf_out, torch.clamp(out_l, st.leaf_lo, st.leaf_hi),
                       torch.clamp(out_r, st.leaf_lo, st.leaf_hi))
        node_mono = torch.where(tree.is_cat, 0, mono[tree.split_feature.long()])
        lo, hi = intermediate_bounds(ext["anc"], ext["aside"], node_mono,
                                     leaf_out, num_leaves_new, L)
        ext.update(leaf_lo=lo, leaf_hi=hi)
    elif mono is not None:
        out_l, out_r, l_lo, l_hi, r_lo, r_hi = basic_bounds(
            mono[s.feature.long()], out_l, out_r, st.leaf_lo, st.leaf_hi)
        leaf_out = upd(st.leaf_out, out_l, out_r)
        ext.update(leaf_lo=upd(st.leaf_lo, l_lo, r_lo),
                   leaf_hi=upd(st.leaf_hi, l_hi, r_hi))
    else:
        leaf_out = upd(st.leaf_out, out_l, out_r)
    if st.cegb_used is not None:
        ext["cegb_used"] = _put(st.cegb_used, torch.where(accept, s.feature.long(),
                                                          drop), True)
    if st.lazy_used is not None:
        # charge each admitted leaf's in-bag rows for its split feature,
        # then count the children's uncharged rows: the left ones (they keep
        # the leaf's id) in one pass, the right ones as the remainder
        hit = accept[lid] & inp.row_mask
        lazy_used = st.lazy_used | (hit[:, None] & feat_oh[lid])
        sel = accept[leaf_id.long()] & inp.row_mask
        cl = torch.zeros((L + 1, f), device=dev).index_add_(
            0, torch.where(sel, leaf_id.long(), L), (~lazy_used).float())[:L]
        cl = torch.where(feat_oh, 0.0, cl)
        cr = torch.clamp_min(torch.where(feat_oh, 0.0, st.lazy_counts) - cl, 0.0)
        ext.update(lazy_used=lazy_used, lazy_counts=upd(st.lazy_counts, cl, cr))
    if st.used is not None:
        used_child = st.used | (accept[:, None] & feat_oh)
        ext["used"] = _put(used_child, right_pos, used_child)

    # ---------- phase 2: one pass at the tile for all smaller children ----------
    left_smaller = s.left_count <= s.right_count
    small = torch.where(left_smaller, idx, right_of)
    slot_of_leaf = _put(torch.full((L,), -1, dtype=torch.int64, device=dev),
                        torch.where(accept, small, drop), acc_rank)
    fresh = _multi_hist(bins, inp, slot_of_leaf[leaf_id.long()].to(torch.int32),
                        T, num_bins, quantize_bins, hist_precision, efb)  # (T, 3, F, B)
    # per admission rank: the split leaf (the left child keeps its id), the
    # right child, and which one the pass histogrammed
    pos_r = torch.where(accept, acc_rank, -1)
    minus1 = torch.full((T,), -1, dtype=torch.int64, device=dev)
    slot_left = _put(minus1, pos_r, idx)
    slot_right = _put(minus1, pos_r, right_of)
    active = slot_left >= 0
    sl = slot_left.clamp(0, L - 1)
    sr = slot_right.clamp(0, L - 1)
    small_left = _put(torch.zeros(T, dtype=torch.int32, device=dev), pos_r,
                      left_smaller)
    left_h, right_h = split_window(st.hist.index_select(0, sl), fresh, small_left)
    spare = L  # inactive slots write the spare row
    st.hist.index_copy_(0, torch.where(active, sl, spare), left_h)
    st.hist.index_copy_(0, torch.where(active, sr, spare), right_h)

    # ---------- phase 3: evaluate the fresh leaves ----------
    nst = st._replace(**ext)
    node_ids = leaf_parent.clamp_min(0) * 2 + leaf_side + 1
    if env.intermediate:
        # every leaf's bounds may have moved: search every live leaf again
        bb = find_best_split(
            st.hist[:L], leaf_sum_g, leaf_sum_h, leaf_count, nbpf, mbpf, params,
            parent_output=leaf_out, categorical_mask=cmask, feature_contri=contri,
            **leaf_search(env, inp.feature_mask, inp.rng, inp.cegb_pen,
                          nst.cegb_used, nst.used, nst.leaf_lo, nst.leaf_hi,
                          node_ids, leaf_depth, nst.lazy_counts))
        best = bb._replace(gain=torch.where(idx < num_leaves_new, bb.gain,
                                            KMIN_SCORE))
    else:
        cand = torch.cat([sl, sr])
        cand_ok = torch.cat([active, active])
        ci = torch.where(cand_ok, cand, 0)

        def rows(t):
            return None if t is None else t[ci]

        bb = find_best_split(
            torch.cat([left_h, right_h]), leaf_sum_g[ci], leaf_sum_h[ci],
            leaf_count[ci], nbpf, mbpf, params, parent_output=leaf_out[ci],
            categorical_mask=cmask, feature_contri=contri,
            **leaf_search(env, inp.feature_mask, inp.rng, inp.cegb_pen,
                          nst.cegb_used, rows(nst.used), rows(nst.leaf_lo),
                          rows(nst.leaf_hi), node_ids[ci], leaf_depth[ci],
                          rows(nst.lazy_counts)))
        scatter_pos = torch.where(cand_ok, cand, drop)
        best = BestSplit(*[_put(o, scatter_pos, nw) for o, nw in zip(st.best, bb)])

    state = nst._replace(
        leaf_id=leaf_id, best=best, leaf_sum_g=leaf_sum_g,
        leaf_sum_h=leaf_sum_h, leaf_count=leaf_count, leaf_depth=leaf_depth,
        leaf_parent=leaf_parent, leaf_side=leaf_side,
        num_leaves_cur=num_leaves_new, leaf_out=leaf_out, tree=tree)
    finite = (st.inputs_finite & torch.isfinite(leaf_sum_g).all()
              & torch.isfinite(leaf_sum_h).all() & torch.isfinite(leaf_out).all()
              & ~torch.isnan(best.gain).any())
    k_next = admits_next(best.gain, leaf_depth, num_leaves_new, num_leaves=L,
                         leaf_tile=T, max_depth=max_depth)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    info = torch.stack([k_acc, zero, zero + 1, zero, finite.long(), k_next])
    return state, info.to(torch.int32)


def _f_finalize(st: FState, inp: FInputs, grad_true, hess_true, *,
                params: SplitParams, quant_renew: bool, env: Envelope = Envelope()):
    L = st.leaf_out.shape[0]
    if quant_renew and not env.intermediate:
        # leaf outputs from the TRUE gradients (reference: GBDT::Train ->
        # RenewIntGradTreeOutput): per-leaf sums as a one-feature histogram
        # (bin = leaf id), deterministic like every other kernel sum; not
        # under intermediate bounds, which a renewed value could cross
        leaf_hist = histogram_multi(
            st.leaf_id.to(torch.int16)[:, None].contiguous(), grad_true,
            hess_true, inp.row_mask, torch.zeros_like(st.leaf_id), 0, 1, L)
        leaf_value = leaf_output(leaf_hist[0, 0, 0], leaf_hist[0, 1, 0], params)
        if env.monotone is not None:
            leaf_value = torch.clamp(leaf_value, st.leaf_lo, st.leaf_hi)
    else:
        leaf_value = final_leaf_values(st.leaf_out, st.leaf_sum_g, st.leaf_sum_h,
                                       st.leaf_lo, st.leaf_hi, params,
                                       env.monotone is not None, env.intermediate)
    tree = finish_tree(st.tree, st.num_leaves_cur, leaf_value, st.leaf_sum_g,
                       st.leaf_sum_h, st.leaf_count, st.leaf_depth)
    if env.track_path:
        tree = tree._replace(path_features=st.used)
    return tree, st.leaf_id


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
    stats: Optional[dict] = None,
    guard_label: str = "",
    graphs: Optional[RoundGraphs] = None,
    hist_precision: str = "f32",
    categorical_mask: Optional[torch.Tensor] = None,  # (F,) bool
    feature_contri: Optional[torch.Tensor] = None,  # (F,) f32
    efb: Optional[tuple] = None,  # Dataset.efb_device_tables()
    monotone_constraints: Optional[torch.Tensor] = None,  # (F,) i32
    interaction_sets: Optional[torch.Tensor] = None,  # (S, F) bool
    rng_key: Optional[torch.Tensor] = None,  # (2L-1, 2, F) node uniforms
    cegb_feature_penalty: Optional[torch.Tensor] = None,  # (F,) coupled
    cegb_lazy_penalty: Optional[torch.Tensor] = None,  # (F,) lazy
    cegb_lazy_used: Optional[torch.Tensor] = None,  # (N, F) bool
    forced_leaf: Optional[torch.Tensor] = None,  # (K,) i32 forced schedule
    forced_feature: Optional[torch.Tensor] = None,
    forced_bin: Optional[torch.Tensor] = None,
    n_forced: int = 0,
    track_path: bool = False,
    monotone_method: str = "basic",  # basic | intermediate
    **options,
):
    """Grow one tree in rounds; returns (tree, final leaf_id per row), and
    the updated (N, F) lazy CEGB charges third when ``cegb_lazy_penalty``
    is given.

    quantize_bins > 0 enables quantized training (reference:
    gradient_discretizer.cpp): gradients/hessians are discretized to int8
    (stochastic rounding draws from ``generator``), histograms accumulate
    exactly in int32, and split evaluation sees the rescaled sums;
    quant_renew recomputes leaf outputs from the true gradients.
    ``graphs``: run every round through that cache's static buffers (one
    CUDA-graph replay a round on the card).  ``stats`` receives the
    utils/sanitizer.py counts of the tree and the driver's retries.
    ``efb``: (bundled (N, F_b) int16, gather, default) of an EFB plan, which
    the histogram passes read; the static buffers of ``graphs`` read them
    where they lie, as they read ``bins``.  The constraint options are the
    strict grower's (ops/treegrow.py::grow_tree); ``n_forced`` schedule
    entries run as single-split rounds before free growth."""
    reject_unported("grow_tree_fast", options)
    if hist_precision not in ("f32", "bf16"):
        raise ValueError(f"hist_precision must be f32 or bf16, got {hist_precision!r}")
    tile = max(1, min(leaf_tile, num_leaves))
    use_lazy = cegb_lazy_penalty is not None and cegb_lazy_used is not None
    n_forced = min(n_forced, num_leaves - 1)
    env = Envelope(
        monotone=monotone_constraints,
        intermediate=(monotone_method == "intermediate"
                      and monotone_constraints is not None),
        sets=interaction_sets, lazy_pen=cegb_lazy_penalty if use_lazy else None,
        forced=((forced_leaf, forced_feature, forced_bin) if n_forced > 0 else None),
        track_path=track_path)
    static = dict(num_leaves=num_leaves, num_bins=num_bins, max_depth=max_depth,
                  params=params, leaf_tile=tile, quantize_bins=quantize_bins,
                  hist_precision=hist_precision)
    tables = (categorical_mask, feature_contri)
    fixed = (bins, num_bins_per_feature, missing_bin_per_feature,
             *(t for t in tables if t is not None), *(efb or ()), *env.tensors())
    key = (("rounds",) + tuple(static.items())
           + ((env.intermediate, env.track_path),))

    def round_fn(forced):
        def fn(st, inp: FInputs, _W):
            return _round(st, bins, inp, num_bins_per_feature,
                          missing_bin_per_feature, *tables, efb=efb, env=env,
                          forced=forced, **static)
        return fn

    with _san.DispatchCounter() as counter:
        try:
            hist = None if graphs is None or graphs.buffers is None else (
                graphs.buffers[0].hist)
            state, inputs, g_true, h_true = _f_init(
                bins, grad, hess, row_mask, sample_weight, feature_mask,
                num_bins_per_feature, missing_bin_per_feature,
                num_leaves=num_leaves, num_bins=num_bins, params=params,
                quantize_bins=quantize_bins,
                stochastic_rounding=stochastic_rounding, generator=generator,
                hist_precision=hist_precision, categorical_mask=categorical_mask,
                feature_contri=feature_contri, hist=hist, efb=efb, env=env,
                rng=rng_key, cegb_pen=cegb_feature_penalty,
                lazy_used=cegb_lazy_used if use_lazy else None)
            if n_forced:
                # the forced prefix (reference: ForceSplits): one single-split
                # round per entry, whatever it admits; nothing is read back
                run = round_runner(round_fn(True), state, inputs, fixed,
                                   key + ("forced",), graphs)
                for _ in range(n_forced):
                    _san.record_dispatch()
                    state, _info = run(state, None)
            state = _run_fused_rounds(
                round_runner(round_fn(False), state, inputs, fixed, key, graphs),
                state, n_ladder=None, w_first=None, num_leaves=num_leaves,
                stats=stats, guard_label=guard_label)
            if stats is not None and n_forced:  # the forced rounds' own key
                stats["windows"] = ["forced"] * n_forced + stats["windows"]
            tree, leaf_id = _f_finalize(
                state, inputs, g_true, h_true, params=params,
                quant_renew=bool(quant_renew and quantize_bins), env=env)
            lazy_used = state.lazy_used
            if graphs is not None:  # the next tree overwrites the buffers
                tree = TreeArrays(*[None if a is None else a.clone() for a in tree])
                leaf_id = leaf_id.clone()
                lazy_used = None if lazy_used is None else lazy_used.clone()
            return (tree, leaf_id, lazy_used) if use_lazy else (tree, leaf_id)
        finally:
            if stats is not None:
                stats.update(counter.stats())
