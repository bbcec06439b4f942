"""Split-gain search over histograms, as batched tensor reductions.

Counterpart of lightgbm_tpu/ops/split.py: numerical and categorical
features with missing-value handling, feature_contri, monotone constraints
(output clipping, ordering and the split-gain penalty), CEGB penalties,
per-node feature sampling and extra_trees, and forced splits.  The whole (F, B)
candidate plane of each leaf is evaluated at once with cumulative sums,
both missing-value directions in parallel, and the argmax taken as one
reduction.  Where the JAX package vmaps over leaves, these functions take a
leading batch axis: histograms (C, 3, F, B) and parent sums (C,); an
unbatched (3, F, B) call works too.

Math (as in the JAX package; SURVEY.md §8):
  ThresholdL1(g, l1) = sign(g) * max(0, |g| - l1)
  leaf_output = -ThresholdL1(G, l1) / (H + l2)        [clipped to max_delta_step]
  leaf_gain   = ThresholdL1(G, l1)^2 / (H + l2)
  split_gain  = gain(L) + gain(R) - gain(parent)

Per-node sampling: where the JAX package folds a threefry key into each
node id and draws two (F,) uniforms from it, these functions take the two
rows of uniforms themselves (``rng_key``: (C, 2, F) f32, row 0 for the
bynode keep mask, row 1 for extra_trees' random threshold), which the
growers gather from a per-tree table indexed by the JAX package's node ids
(GBDT._node_uniforms).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

KEPSILON = 1e-15  # reference: feature_histogram.hpp kEpsilon added to hessians
KMIN_SCORE = -1e30


class SplitParams(NamedTuple):
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
    max_delta_step: float = 0.0
    path_smooth: float = 0.0
    # categorical split params (reference: FindBestThresholdCategoricalInner)
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    max_cat_threshold: int = 32
    max_cat_to_onehot: int = 4
    # node-level sampling (reference: ColSampler bynode / extra_trees)
    feature_fraction_bynode: float = 1.0
    extra_trees: bool = False
    # monotone split gain penalty (reference: monotone_penalty ->
    # ComputeMonotoneSplitGainPenalty)
    monotone_penalty: float = 0.0
    # CEGB (reference: cost_effective_gradient_boosting.hpp): split gain is
    # charged cegb_tradeoff * cegb_penalty_split * num_data, plus the
    # per-feature penalties each leaf passes in
    cegb_tradeoff: float = 1.0
    cegb_penalty_split: float = 0.0


class BestSplit(NamedTuple):
    """Per-leaf best split (reference: struct SplitInfo); fields are
    batched (C,) tensors, cat_mask (C, B)."""

    gain: torch.Tensor  # f32
    feature: torch.Tensor  # i32
    threshold_bin: torch.Tensor  # i32 (bin <= threshold_bin -> left)
    default_left: torch.Tensor  # bool (missing goes left)
    is_cat: torch.Tensor  # bool — categorical (bitmask) split
    cat_mask: torch.Tensor  # (B,) bool — bins going left (categorical only)
    left_sum_g: torch.Tensor
    left_sum_h: torch.Tensor
    left_count: torch.Tensor
    right_sum_g: torch.Tensor
    right_sum_h: torch.Tensor
    right_count: torch.Tensor


def threshold_l1(g: torch.Tensor, l1: float) -> torch.Tensor:
    return torch.sign(g) * torch.clamp_min(torch.abs(g) - l1, 0.0)


def leaf_output(sum_g, sum_h, p: SplitParams):
    """reference: FeatureHistogram::CalculateSplittedLeafOutput."""
    out = -threshold_l1(sum_g, p.lambda_l1) / (sum_h + p.lambda_l2 + KEPSILON)
    if p.max_delta_step > 0:
        out = torch.clamp(out, -p.max_delta_step, p.max_delta_step)
    return out


def leaf_output_smoothed(sum_g, sum_h, count, parent_output, p: SplitParams):
    """Path-smoothed leaf output (reference: USE_SMOOTHING
    CalculateSplittedLeafOutput)."""
    raw = leaf_output(sum_g, sum_h, p)
    if p.path_smooth <= 0:
        return raw
    alpha = count / (count + p.path_smooth)
    return raw * alpha + parent_output * (1.0 - alpha)


def gain_given_output(sum_g, sum_h, l1, l2, out):
    """reference: GetLeafGainGivenOutput (x-0.5 factor dropped)."""
    tg = threshold_l1(sum_g, l1)
    return -(2.0 * tg * out + (sum_h + l2 + KEPSILON) * out * out)


def monotone_split_gain_penalty(depth, penalization: float):
    """reference: LeafConstraintsBase::ComputeMonotoneSplitGainPenalty: the
    multiplicative factor of a monotone split's gain at ``depth`` (f32)."""
    depth = depth.float()
    eps = 1e-10
    full = penalization >= depth + 1.0
    f_small = 1.0 - penalization / torch.exp2(depth) + eps
    f_big = 1.0 - torch.exp2(penalization - 1.0 - depth) + eps
    return torch.where(full, eps, f_small if penalization <= 1.0 else f_big)


def leaf_gain(sum_g, sum_h, p: SplitParams):
    """reference: GetLeafGain (0.5 factor dropped — it cancels in deltas)."""
    tg = threshold_l1(sum_g, p.lambda_l1)
    denom = sum_h + p.lambda_l2 + KEPSILON
    if p.max_delta_step > 0:
        out = torch.clamp(-tg / denom, -p.max_delta_step, p.max_delta_step)
        return -(2.0 * tg * out + denom * out * out)
    return tg * tg / denom


def _cat_gain(g, h, p: SplitParams):
    """leaf_gain with lambda_l2 + cat_l2 (the categorical candidates')."""
    return leaf_gain(g, h, p._replace(lambda_l2=p.lambda_l2 + p.cat_l2))


def _cat_keys(sum_g, sum_h, used, p: SplitParams):
    """The many-vs-many sort keys of each bin, ascending and descending:
    sum_g / (sum_h + cat_smooth) of a used bin, +inf for the others (they
    sort last).  ``+ 0.0`` and ``0.0 -`` turn a -0.0 into +0.0, so a
    comparison sort and a radix sort (torch.sort on the card) order every
    key alike; no other value changes."""
    ratio = sum_g / (sum_h + p.cat_smooth)
    inf = float("inf")
    return (torch.where(used, ratio + 0.0, inf),
            torch.where(used, 0.0 - ratio, inf))


def _ranks(keys):
    """(order, rank) of a stable ascending sort along the last axis: ties
    keep bin order, as jnp.argsort does."""
    order = torch.argsort(keys, dim=-1, stable=True)
    idx = torch.arange(keys.shape[-1], device=keys.device).expand_as(order)
    return order, torch.empty_like(order).scatter_(-1, order, idx)


def gain_plane(hist, parent_sum_g, parent_sum_h, parent_count,
               num_bins_per_feature, missing_bin_per_feature,
               params: SplitParams, feature_mask=None, parent_output=None,
               categorical_mask=None, feature_contri=None,
               monotone_constraints=None, out_lo=None, out_hi=None,
               rng_key=None, depth=None, cegb_feature_penalty=None):
    """Every (feature, threshold, missing-direction) candidate of a batch of
    leaves: returns (gain (C, F, B), ctx).  hist is (C, 3, F, B); rows with
    bin <= t go left, missing rows go the default direction; the missing
    bin (last, when present) is excluded from the scan.  Features of
    ``categorical_mask`` (F,) take the categorical candidates instead (the
    JAX package's two families): at most max_cat_to_onehot used bins, each
    used bin alone goes left (cell t = bin t); otherwise the used bins
    sorted by sum_g / (sum_h + cat_smooth), ascending and descending, and
    cell t = the sorted order's prefix of length t + 1 goes left.  The
    missing bin never goes left.

    Per candidate: ``feature_mask`` (F,) or (C, F); ``monotone_constraints``
    (F,) i32 with the output band ``out_lo`` / ``out_hi`` (C,): child
    outputs are clipped to the band and a split that breaks its feature's
    order (or a leaf whose band is empty) is rejected (reference:
    BasicLeafConstraints + GetSplitGainGivenOutput); ``depth`` (C,) feeds
    monotone_penalty; ``rng_key`` (C, 2, F) the node's uniforms (module
    docstring); ``cegb_feature_penalty`` (F,) or (C, F) the pre-scaled
    CEGB feature penalties.  The min_gain_to_split gate sees the raw (and
    monotone-penalized) gain; then ``feature_contri`` (F,) scales it by
    max(0, contri) and the CEGB penalties are subtracted, and an adjusted
    gain must stay positive (reference: config feature_contri, the
    SerialTreeLearner's CEGB delta)."""
    c, _, f, b = hist.shape
    dev = hist.device
    bins_idx = torch.arange(b, dtype=torch.int32, device=dev)
    mbpf = missing_bin_per_feature
    has_missing = mbpf >= 0
    is_missing_bin = bins_idx[None, :] == mbpf[:, None]  # (F, B)
    hist_nm = torch.where(is_missing_bin, 0.0, hist)  # (C, 3, F, B)
    miss = torch.where(is_missing_bin, hist, 0.0).sum(dim=3)  # (C, 3, F)
    # prefix sums in float64, rounded once to f32.  They are exact, so the
    # round megakernel's sequential scan (csrc/round.cu) gets the same bits
    # as this cumsum, when every partial sum fits 53 bits; a sum that needs
    # more (a tiny bin beside a large prefix) can round apart in the two
    # orders, and then only where the double lands on an f32 rounding tie.
    # The JAX package scans in f32; this departs from it by design.
    cum = torch.cumsum(hist_nm.double(), dim=3).float()

    last_nm_bin = num_bins_per_feature - torch.where(has_missing, 2, 1)
    fmask = feature_mask
    if fmask is not None and fmask.dim() == 1:
        fmask = fmask[None]  # (1 or C, F)
    # node-level feature sampling (reference: ColSampler::GetByNode) and
    # extra_trees' one random threshold per feature, as candidate masks
    if rng_key is not None and params.feature_fraction_bynode < 1.0:
        keep = rng_key[:, 0] < params.feature_fraction_bynode  # (C, F)
        fmask = keep if fmask is None else fmask & keep
    valid_thr = (bins_idx[None, :] < last_nm_bin[:, None])[None]  # (1, F, B)
    if rng_key is not None and params.extra_trees:
        rbin = torch.floor(rng_key[:, 1] * last_nm_bin.clamp_min(1)).to(torch.int32)
        valid_thr = valid_thr & (bins_idx == rbin[..., None])
    if fmask is not None:
        valid_thr = valid_thr & fmask[..., None]

    pg = parent_sum_g[:, None, None]
    ph = parent_sum_h[:, None, None]
    pc = parent_count[:, None, None]
    use_smooth = params.path_smooth > 0 and parent_output is not None
    po = parent_output[:, None, None] if use_smooth else None
    if use_smooth:
        gain_parent = gain_given_output(pg, ph, params.lambda_l1,
                                        params.lambda_l2, po)
    else:
        gain_parent = leaf_gain(pg, ph, params)
    mono = monotone_constraints
    if mono is not None:
        inf = torch.full((c,), float("inf"), device=dev)
        lo = (-inf if out_lo is None else out_lo)[:, None, None]
        hi = (inf if out_hi is None else out_hi)[:, None, None]
        mono_col = mono[:, None]

    def split_ok(lc, rc, lh, rh):
        return ((lc >= params.min_data_in_leaf) & (rc >= params.min_data_in_leaf)
                & (lh >= params.min_sum_hessian_in_leaf)
                & (rh >= params.min_sum_hessian_in_leaf))

    def eval_direction(missing_left: bool):
        add = miss if missing_left else torch.zeros_like(miss)  # (C, 3, F)
        left_g = cum[:, 0] + add[:, 0, :, None]
        left_h = cum[:, 1] + add[:, 1, :, None]
        left_c = cum[:, 2] + add[:, 2, :, None]
        right_g = pg - left_g
        right_h = ph - left_h
        right_c = pc - left_c
        ok = valid_thr & split_ok(left_c, right_c, left_h, right_h)
        if mono is None and not use_smooth:
            g = (leaf_gain(left_g, left_h, params)
                 + leaf_gain(right_g, right_h, params) - gain_parent)
        else:
            # output-based gains: smoothed outputs, clipped to the
            # monotone band where constraints apply
            if use_smooth:
                out_l = leaf_output_smoothed(left_g, left_h, left_c, po, params)
                out_r = leaf_output_smoothed(right_g, right_h, right_c, po, params)
            else:
                out_l = leaf_output(left_g, left_h, params)
                out_r = leaf_output(right_g, right_h, params)
            if mono is not None:
                out_l = torch.clamp(out_l, lo, hi)
                out_r = torch.clamp(out_r, lo, hi)
            g = (gain_given_output(left_g, left_h, params.lambda_l1,
                                   params.lambda_l2, out_l)
                 + gain_given_output(right_g, right_h, params.lambda_l1,
                                     params.lambda_l2, out_r)
                 - gain_parent)
            if mono is not None:
                viol = (((mono_col > 0) & (out_l > out_r))
                        | ((mono_col < 0) & (out_l < out_r)))
                # an empty band (conflicting ancestors) makes the leaf
                # unsplittable: clamp would quietly return hi
                ok = ok & ~viol & (lo <= hi)
        g = torch.where(ok, g, KMIN_SCORE)
        return g, (left_g, left_h, left_c)

    gain_r, stats_r = eval_direction(False)  # missing -> right
    gain_l, stats_l = eval_direction(True)  # missing -> left
    # ties (no missing values) prefer missing->right, the reference default
    use_left = gain_l > gain_r
    gain = torch.where(use_left, gain_l, gain_r)
    ctx = dict(use_left=use_left, stats_l=stats_l, stats_r=stats_r,
               parent_g=parent_sum_g, parent_h=parent_sum_h,
               parent_count=parent_count, categorical_mask=categorical_mask)

    if categorical_mask is not None:
        gain_parent_cat = _cat_gain(pg, ph, params)
        used = (hist_nm[:, 2] > 0) & ~is_missing_bin  # (C, F, B)
        num_used = used.sum(dim=2, keepdim=True)  # (C, F, 1)
        k_len = bins_idx + 1  # prefix length at cell t

        def eval_sorted(keys):
            order, rank = _ranks(keys)
            sh = hist_nm.gather(3, order[:, None].expand(-1, 3, -1, -1))
            # prefixes in float64, rounded once, as the numerical scan
            cs = torch.cumsum(sh.double(), dim=3).float()
            lg, lh, lc = cs[:, 0], cs[:, 1], cs[:, 2]
            # each direction stops at half the used bins, so the two scans
            # never try one partition twice (reference: (used_bin + 1) / 2)
            ok = ((k_len <= params.max_cat_threshold)
                  & (k_len <= torch.div(num_used + 1, 2, rounding_mode="floor"))
                  & (k_len < num_used) & split_ok(lc, pc - lc, lh, ph - lh))
            g = (_cat_gain(lg, lh, params) + _cat_gain(pg - lg, ph - lh, params)
                 - gain_parent_cat)
            return torch.where(ok, g, KMIN_SCORE), rank, (lg, lh, lc)

        key_asc, key_desc = _cat_keys(hist_nm[:, 0], hist_nm[:, 1], used, params)
        gain_asc, rank_asc, st_asc = eval_sorted(key_asc)
        gain_desc, rank_desc, st_desc = eval_sorted(key_desc)
        og, oh, oc = hist_nm[:, 0], hist_nm[:, 1], hist_nm[:, 2]  # bin t alone
        oh_ok = used & split_ok(oc, pc - oc, oh, ph - oh)
        gain_oh = (_cat_gain(og, oh, params) + _cat_gain(pg - og, ph - oh, params)
                   - gain_parent_cat)
        gain_oh = torch.where(oh_ok, gain_oh, KMIN_SCORE)
        onehot = num_used <= params.max_cat_to_onehot
        gain_cat = torch.where(onehot, gain_oh, torch.maximum(gain_asc, gain_desc))
        variant = torch.where(onehot, 0, torch.where(gain_desc > gain_asc, 2, 1))
        cat_col = categorical_mask[:, None]
        if fmask is not None:
            cat_col = cat_col & fmask[..., None]
        gain = torch.where(categorical_mask[:, None], KMIN_SCORE, gain)
        gain = torch.where(cat_col, gain_cat, gain)
        ctx.update(variant=variant.to(torch.int32), rank_asc=rank_asc,
                   rank_desc=rank_desc, st_asc=st_asc, st_desc=st_desc,
                   oh_l=(og, oh, oc))

    live = gain > KMIN_SCORE / 2
    if params.monotone_penalty > 0 and mono is not None and depth is not None:
        factor = monotone_split_gain_penalty(depth, params.monotone_penalty)
        gain = torch.where(live & (mono != 0)[:, None],
                           gain * factor[:, None, None], gain)
    # the min_gain gate sees raw gains (FindBestThresholdSequentially); the
    # gated gain is then scaled by feature_contri, charged the CEGB
    # penalties, and must stay positive
    gate = live & (gain > params.min_gain_to_split)
    gain = torch.where(gate, gain, KMIN_SCORE)
    has_adjust = False
    if feature_contri is not None:
        contri = torch.clamp_min(feature_contri.float(), 0.0)
        gain = torch.where(gate, gain * contri[:, None], gain)
        has_adjust = True
    if params.cegb_penalty_split > 0 or cegb_feature_penalty is not None:
        pen = torch.zeros((c, f), dtype=torch.float32, device=dev)
        if params.cegb_penalty_split > 0:
            pen = pen + (params.cegb_tradeoff * params.cegb_penalty_split
                         ) * parent_count[:, None]
        if cegb_feature_penalty is not None:
            pen = pen + cegb_feature_penalty
        gain = torch.where(gate, gain - pen[..., None], gain)
        has_adjust = True
    if has_adjust:
        gain = torch.where(gate & (gain > 0), gain, KMIN_SCORE)
    return gain, ctx


def select_from_plane(gain: torch.Tensor, ctx: dict) -> BestSplit:
    """Materialize each leaf's argmax candidate (first maximum in flat
    (feature, bin) order, as jnp.argmax) into a BestSplit (numerical
    planes; find_best_split selects categorical ones per feature first)."""
    c, f, b = gain.shape
    flat = gain.reshape(c, -1)
    best = torch.argmax(flat, dim=1, keepdim=True)  # (C, 1)

    def at(x):
        return x.reshape(c, -1).gather(1, best)[:, 0]

    cell = best[:, 0]
    best_left = at(ctx["use_left"])
    stats_l, stats_r = ctx["stats_l"], ctx["stats_r"]
    lg = torch.where(best_left, at(stats_l[0]), at(stats_r[0]))
    lh = torch.where(best_left, at(stats_l[1]), at(stats_r[1]))
    lc = torch.where(best_left, at(stats_l[2]), at(stats_r[2]))
    return BestSplit(
        gain=at(gain),
        feature=(cell // b).to(torch.int32),
        threshold_bin=(cell % b).to(torch.int32),
        default_left=best_left,
        is_cat=torch.zeros(c, dtype=torch.bool, device=gain.device),
        cat_mask=torch.zeros((c, b), dtype=torch.bool, device=gain.device),
        left_sum_g=lg,
        left_sum_h=lh,
        left_count=lc,
        right_sum_g=ctx["parent_g"] - lg,
        right_sum_h=ctx["parent_h"] - lh,
        right_count=ctx["parent_count"] - lc,
    )


class FeatureBests(NamedTuple):
    """Per-feature reduction of a batch of gain planes (the round
    megakernel's output, csrc/round.cu): per (candidate, feature) the first
    maximizing threshold's gain and what a BestSplit needs if that feature
    wins.  Fields are (C, F); ``variant`` is -1 on numerical features, 0
    (one-hot), 1 (ascending) or 2 (descending) on categorical ones."""

    gain: torch.Tensor  # f32
    threshold_bin: torch.Tensor  # i32
    use_left: torch.Tensor  # bool (False on categorical features)
    variant: torch.Tensor  # i32
    left_g: torch.Tensor
    left_h: torch.Tensor
    left_c: torch.Tensor


def reduce_plane_per_feature(gain: torch.Tensor, ctx: dict) -> FeatureBests:
    """Reduce (C, F, B) gain planes over the bins: per feature the first
    maximizing bin (torch.argmax) and the stats select_from_plane would
    gather there.  Feature-independent, so it may run on feature slices."""
    bb = torch.argmax(gain, dim=2, keepdim=True)  # (C, F, 1)

    def at(x):
        return x.gather(2, bb)[..., 0]

    use_left = at(ctx["use_left"])
    stats_l, stats_r = ctx["stats_l"], ctx["stats_r"]
    lg, lh, lc = (torch.where(use_left, at(a), at(b))
                  for a, b in zip(stats_l, stats_r))
    variant = torch.full_like(bb[..., 0], -1, dtype=torch.int32)
    cmask = ctx.get("categorical_mask")
    if cmask is not None:
        v = at(ctx["variant"])

        def pick_cat(i):  # the variant's stats at the feature's best cell
            stk = torch.stack([at(ctx["oh_l"][i]), at(ctx["st_asc"][i]),
                               at(ctx["st_desc"][i])])
            return stk.gather(0, v.long()[None])[0]

        lg = torch.where(cmask, pick_cat(0), lg)
        lh = torch.where(cmask, pick_cat(1), lh)
        lc = torch.where(cmask, pick_cat(2), lc)
        use_left = torch.where(cmask, False, use_left)
        variant = torch.where(cmask, v, variant)
    return FeatureBests(
        gain=at(gain), threshold_bin=bb[..., 0].to(torch.int32),
        use_left=use_left, variant=variant, left_g=lg, left_h=lh, left_c=lc)


def categorical_winner_mask(hist_col, missing_bin, params: SplitParams,
                            variant, threshold) -> torch.Tensor:
    """The left-bin mask (C, B) of each candidate's winning categorical
    feature, rebuilt from its (C, 3, B) histogram column: gain_plane's
    ranks replayed for one feature (same zeroing, keys and stable sort), so
    the per-feature search need not ship (F, B) rank planes out of the
    round kernel."""
    b = hist_col.shape[-1]
    bins_idx = torch.arange(b, dtype=torch.int32, device=hist_col.device)
    is_missing = bins_idx[None, :] == missing_bin[:, None]  # (C, B)
    hist_nm = torch.where(is_missing[:, None], 0.0, hist_col)
    used = (hist_nm[:, 2] > 0) & ~is_missing
    key_asc, key_desc = _cat_keys(hist_nm[:, 0], hist_nm[:, 1], used, params)
    t = threshold[:, None]
    v = variant[:, None]
    return torch.where(v == 0, bins_idx[None, :] == t,
                       torch.where(v == 1, _ranks(key_asc)[1] <= t,
                                   _ranks(key_desc)[1] <= t))


def select_from_feature_best(fb: FeatureBests, parent_g, parent_h,
                             parent_count, num_bins: int,
                             categorical_mask=None, cand_hist=None,
                             missing_bin_per_feature=None,
                             params: SplitParams = SplitParams()) -> BestSplit:
    """Cross-feature half of the selection: per candidate, the first
    feature with the largest per-feature gain.  Bitwise equal to
    select_from_plane's flat argmax on the same planes (both take the first
    (feature, bin) cell in order).  A categorical winner's mask is replayed
    from its column of ``cand_hist`` (C, 3, F, B)."""
    c = fb.gain.shape[0]
    best_f = torch.argmax(fb.gain, dim=1, keepdim=True)  # (C, 1)

    def at(x):
        return x.gather(1, best_f)[:, 0]

    lg, lh, lc = at(fb.left_g), at(fb.left_h), at(fb.left_c)
    thr = at(fb.threshold_bin)
    dev = fb.gain.device
    is_cat = torch.zeros(c, dtype=torch.bool, device=dev)
    cat_mask = torch.zeros((c, num_bins), dtype=torch.bool, device=dev)
    if categorical_mask is not None:
        is_cat = categorical_mask[best_f[:, 0]]
        col = cand_hist.gather(2, best_f[:, None, :, None].expand(
            -1, 3, 1, cand_hist.shape[3]))[:, :, 0]  # (C, 3, B)
        cat_mask = is_cat[:, None] & categorical_winner_mask(
            col, missing_bin_per_feature[best_f[:, 0]], params,
            at(fb.variant), thr)
    return BestSplit(
        gain=at(fb.gain),
        feature=best_f[:, 0].to(torch.int32),
        threshold_bin=thr,
        default_left=at(fb.use_left),
        is_cat=is_cat,
        cat_mask=cat_mask,
        left_sum_g=lg,
        left_sum_h=lh,
        left_count=lc,
        right_sum_g=parent_g - lg,
        right_sum_h=parent_h - lh,
        right_count=parent_count - lc,
    )


def find_best_split(hist, parent_sum_g, parent_sum_h, parent_count,
                    num_bins_per_feature, missing_bin_per_feature,
                    params: SplitParams, feature_mask=None,
                    categorical_mask=None, monotone_constraints=None,
                    out_lo=None, out_hi=None, rng_key=None, depth=None,
                    parent_output=None, cegb_feature_penalty=None,
                    feature_contri=None, cell=None) -> BestSplit:
    """gain_plane + the selection (reference: FindBestThreshold).
    hist (3, F, B) with scalar parents (and out_lo, out_hi, depth scalars,
    rng_key (2, F)), or batched (C, 3, F, B) with (C,) parents.  ``cell``
    (F, B) bool keeps only those candidates (forced_split_candidate)."""
    single = hist.dim() == 3
    if single:
        hist = hist[None]

        def one(v):
            return None if v is None else torch.as_tensor(
                v, dtype=torch.float32, device=hist.device).reshape(1)

        parent_sum_g, parent_sum_h, parent_count, parent_output, out_lo, \
            out_hi, depth = (one(v) for v in (
                parent_sum_g, parent_sum_h, parent_count, parent_output,
                out_lo, out_hi, depth))
        if rng_key is not None:
            rng_key = rng_key[None]
    gain, ctx = gain_plane(hist, parent_sum_g, parent_sum_h, parent_count,
                           num_bins_per_feature, missing_bin_per_feature,
                           params, feature_mask=feature_mask,
                           parent_output=parent_output,
                           categorical_mask=categorical_mask,
                           feature_contri=feature_contri,
                           monotone_constraints=monotone_constraints,
                           out_lo=out_lo, out_hi=out_hi, rng_key=rng_key,
                           depth=depth, cegb_feature_penalty=cegb_feature_penalty)
    if cell is not None:
        gain = torch.where(cell, gain, KMIN_SCORE)
    if categorical_mask is None:
        best = select_from_plane(gain, ctx)
    else:  # per feature first: the winner's mask is replayed from its column
        best = select_from_feature_best(
            reduce_plane_per_feature(gain, ctx), parent_sum_g, parent_sum_h,
            parent_count, hist.shape[3], categorical_mask=categorical_mask,
            cand_hist=hist, missing_bin_per_feature=missing_bin_per_feature,
            params=params)
    if single:
        best = BestSplit(*[x[0] for x in best])
    return best


def forced_split_candidate(hist, parent_sum_g, parent_sum_h, parent_count,
                           num_bins_per_feature, missing_bin_per_feature,
                           params: SplitParams, forced_feature, forced_bin,
                           categorical_mask=None, monotone_constraints=None,
                           out_lo=None, out_hi=None, depth=None,
                           parent_output=None, feature_contri=None) -> BestSplit:
    """A forced split (reference: SerialTreeLearner::ForceSplits): the
    scheduled (feature, bin) cell of one leaf's (3, F, B) histogram through
    the standard gain machinery, so min_data, min_hess and the monotone
    gates still apply; the split is valid where its gain > KMIN_SCORE / 2.
    ``forced_feature`` / ``forced_bin`` are 0-d tensors (no host read)."""
    _, f, b = hist.shape
    dev = hist.device
    cell = ((torch.arange(f, device=dev)[:, None] == forced_feature)
            & (torch.arange(b, device=dev)[None, :] == forced_bin))
    return find_best_split(
        hist, parent_sum_g, parent_sum_h, parent_count, num_bins_per_feature,
        missing_bin_per_feature, params, categorical_mask=categorical_mask,
        monotone_constraints=monotone_constraints, out_lo=out_lo, out_hi=out_hi,
        depth=depth, parent_output=parent_output, feature_contri=feature_contri,
        cell=cell)
