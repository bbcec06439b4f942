"""Split-gain search over histograms, as batched tensor reductions.

Counterpart of lightgbm_tpu/ops/split.py for numerical features with
missing-value handling.  The whole (F, B) candidate plane of each leaf is
evaluated at once with cumulative sums, both missing-value directions in
parallel, and the argmax taken as one reduction.  Where the JAX package
vmaps over leaves, these functions take a leading batch axis: histograms
(C, 3, F, B) and parent sums (C,); an unbatched (3, F, B) call works too.

Math (as in the JAX package; SURVEY.md §8):
  ThresholdL1(g, l1) = sign(g) * max(0, |g| - l1)
  leaf_output = -ThresholdL1(G, l1) / (H + l2)        [clipped to max_delta_step]
  leaf_gain   = ThresholdL1(G, l1)^2 / (H + l2)
  split_gain  = gain(L) + gain(R) - gain(parent)

Categorical, monotone, CEGB, feature_contri and per-node sampling
arguments are not ported yet (ROADMAP queue A5) and raise when given.
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


class BestSplit(NamedTuple):
    """Per-leaf best split (reference: struct SplitInfo); fields are
    batched (C,) tensors, cat_mask (C, B)."""

    gain: torch.Tensor  # f32
    feature: torch.Tensor  # i32
    threshold_bin: torch.Tensor  # i32 (bin <= threshold_bin -> left)
    default_left: torch.Tensor  # bool (missing goes left)
    is_cat: torch.Tensor  # bool — always False here
    cat_mask: torch.Tensor  # (B,) bool — always False here
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


def leaf_gain(sum_g, sum_h, p: SplitParams):
    """reference: GetLeafGain (0.5 factor dropped — it cancels in deltas)."""
    tg = threshold_l1(sum_g, p.lambda_l1)
    denom = sum_h + p.lambda_l2 + KEPSILON
    if p.max_delta_step > 0:
        out = torch.clamp(-tg / denom, -p.max_delta_step, p.max_delta_step)
        return -(2.0 * tg * out + denom * out * out)
    return tg * tg / denom


def _reject_unported(**args) -> None:
    for name, v in args.items():
        if v is not None:
            raise ValueError(f"{name} is not ported to lightgbm_tpu_torch yet "
                             "(ROADMAP queue A5)")


def gain_plane(hist, parent_sum_g, parent_sum_h, parent_count,
               num_bins_per_feature, missing_bin_per_feature,
               params: SplitParams, feature_mask=None, parent_output=None):
    """Every (feature, threshold, missing-direction) candidate of a batch of
    leaves: returns (gain (C, F, B), ctx).  hist is (C, 3, F, B); rows with
    bin <= t go left, missing rows go the default direction; the missing
    bin (last, when present) is excluded from the scan."""
    _, _, f, b = hist.shape
    dev = hist.device
    bins_idx = torch.arange(b, dtype=torch.int32, device=dev)
    mbpf = missing_bin_per_feature
    has_missing = mbpf >= 0
    is_missing_bin = bins_idx[None, :] == mbpf[:, None]  # (F, B)
    hist_nm = torch.where(is_missing_bin, 0.0, hist)  # (C, 3, F, B)
    miss = torch.where(is_missing_bin, hist, 0.0).sum(dim=3)  # (C, 3, F)
    cum = torch.cumsum(hist_nm, dim=3)

    last_nm_bin = num_bins_per_feature - torch.where(has_missing, 2, 1)
    valid_thr = bins_idx[None, :] < last_nm_bin[:, None]  # (F, B)
    if feature_mask is not None:
        valid_thr = valid_thr & feature_mask[:, None]

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

    def eval_direction(missing_left: bool):
        add = miss if missing_left else torch.zeros_like(miss)  # (C, 3, F)
        left_g = cum[:, 0] + add[:, 0, :, None]
        left_h = cum[:, 1] + add[:, 1, :, None]
        left_c = cum[:, 2] + add[:, 2, :, None]
        right_g = pg - left_g
        right_h = ph - left_h
        right_c = pc - left_c
        ok = (
            valid_thr
            & (left_c >= params.min_data_in_leaf)
            & (right_c >= params.min_data_in_leaf)
            & (left_h >= params.min_sum_hessian_in_leaf)
            & (right_h >= params.min_sum_hessian_in_leaf)
        )
        if not use_smooth:
            g = (leaf_gain(left_g, left_h, params)
                 + leaf_gain(right_g, right_h, params) - gain_parent)
        else:
            out_l = leaf_output_smoothed(left_g, left_h, left_c, po, params)
            out_r = leaf_output_smoothed(right_g, right_h, right_c, po, params)
            g = (gain_given_output(left_g, left_h, params.lambda_l1,
                                   params.lambda_l2, out_l)
                 + gain_given_output(right_g, right_h, params.lambda_l1,
                                     params.lambda_l2, out_r)
                 - gain_parent)
        g = torch.where(ok, g, KMIN_SCORE)
        return g, (left_g, left_h, left_c)

    gain_r, stats_r = eval_direction(False)  # missing -> right
    gain_l, stats_l = eval_direction(True)  # missing -> left
    # ties (no missing values) prefer missing->right, the reference default
    use_left = gain_l > gain_r
    gain = torch.where(use_left, gain_l, gain_r)
    # the min_gain gate sees raw gains (FindBestThresholdSequentially)
    gate = (gain > KMIN_SCORE / 2) & (gain > params.min_gain_to_split)
    gain = torch.where(gate, gain, KMIN_SCORE)
    ctx = dict(use_left=use_left, stats_l=stats_l, stats_r=stats_r,
               parent_g=parent_sum_g, parent_h=parent_sum_h,
               parent_count=parent_count)
    return gain, ctx


def select_from_plane(gain: torch.Tensor, ctx: dict) -> BestSplit:
    """Materialize each leaf's argmax candidate (first maximum in flat
    (feature, bin) order, as jnp.argmax) into a BestSplit."""
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


def find_best_split(hist, parent_sum_g, parent_sum_h, parent_count,
                    num_bins_per_feature, missing_bin_per_feature,
                    params: SplitParams, feature_mask=None,
                    categorical_mask=None, monotone_constraints=None,
                    out_lo=None, out_hi=None, rng_key=None, depth=None,
                    parent_output=None, cegb_feature_penalty=None,
                    feature_contri=None) -> BestSplit:
    """gain_plane + select_from_plane (reference: FindBestThreshold).
    hist (3, F, B) with scalar parents, or batched (C, 3, F, B) with (C,)
    parents.  ``depth`` only feeds the monotone penalty and is ignored."""
    _reject_unported(categorical_mask=categorical_mask,
                     monotone_constraints=monotone_constraints,
                     out_lo=out_lo, out_hi=out_hi, rng_key=rng_key,
                     cegb_feature_penalty=cegb_feature_penalty,
                     feature_contri=feature_contri)
    single = hist.dim() == 3
    if single:
        hist = hist[None]
        parent_sum_g, parent_sum_h, parent_count = (
            torch.as_tensor(v, dtype=torch.float32,
                            device=hist.device).reshape(1)
            for v in (parent_sum_g, parent_sum_h, parent_count))
        if parent_output is not None:
            parent_output = torch.as_tensor(
                parent_output, dtype=torch.float32,
                device=hist.device).reshape(1)
    gain, ctx = gain_plane(hist, parent_sum_g, parent_sum_h, parent_count,
                           num_bins_per_feature, missing_bin_per_feature,
                           params, feature_mask=feature_mask,
                           parent_output=parent_output)
    best = select_from_plane(gain, ctx)
    if single:
        best = BestSplit(*[x[0] for x in best])
    return best
