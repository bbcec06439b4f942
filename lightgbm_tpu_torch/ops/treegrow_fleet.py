"""Fleet growth: B independent boosters over one shared bin matrix, one
round of all lanes at a time.

Counterpart of lightgbm_tpu/ops/treegrow_fleet.py, which lifts the windowed
round (``_round_fused``) over a lane axis with ``jax.vmap``: the bins and
per-feature tables are shared, the gradients, masks, window state and split
elections are each lane's.  Here a fleet round runs the solo three-pass
round's stages (ops/treegrow_windowed.py: ``round_geometry``,
``round_rows``, ``round_finish``) for each lane, around one launch of each
kernel in its lane mode:

* B2 (``partition_segments_lanes``): every lane's segments in one
  cooperative wave, lane b's positions offset by b * N in its lane group's
  flat space (groups of 1024 // tile lanes, taken in turn; L * N < 2^30);
* B1 (``histogram_multi_lanes``, or its int8 twin): every lane's window in
  one launch, each lane reading the shared bins through its own row ids
  (no (W, F) copy a lane) with its own fixed-point exponents, on a grid
  with a lane axis.

With ``graphs`` (fused_training) a fleet round is one CUDA-graph replay:
the lanes' states and inputs are one tuple of static buffers.

Protocol.  The windowed grower's round loop (``_run_fused_rounds``) runs
unchanged: the lanes' (B, 6) info folds inside the round to the loop's
6 scalars, as the JAX package folds its (B, 5):

* ``k_acc``  the minimum over the lanes that admitted a split (0 when none
  did): a finished lane's round is a state passthrough with k = 0, so the
  loop ends only when every lane has;
* ``total``  the maximum (a retry ladders on the worst lane's need);
* ``ok``     the minimum (any lane's window breach retries the round; the
  lanes that fitted already applied theirs, which is benign: admission is
  the same best-first sequence however it is cut into rounds);
* ``whint``  the maximum (the ladder quantizes on the widest live window);
* ``finite`` the minimum (any lane's NaN aborts the fleet);
* ``k_next`` the maximum (the port's info vector carries what the next
  round admits: the fleet goes on while any lane would).

The W ladder floors at 8192 / B rows a lane, 128-quantized (the JAX
package's lane floor).  W only bounds the window: padding positions add
nothing and every leaf's histogram sums its own rows, so a lane is bitwise
the port's solo windowed run (three-pass) of the same labels and weights,
whatever W each ran at.

int8: every lane quantizes with a generator seeded as the solo run's for
(seed, iteration), so every lane draws the solo run's uniforms.

Scope (models/fleet.py gates it): numerical features, no EFB, no feature
sampling, no megakernel (the JAX fleet has none either), one device.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..utils import sanitizer as _san
from ..utils.guards import NonFiniteError
from .graphs import RoundGraphs, copy_into
from .hist_cuda import histogram_multi_lanes, histogram_multi_quantized_lanes
from .partition_cuda import MAX_ROWS, partition_segments_lanes
from .round_cuda import split_window, window_rows
from .split import SplitParams
from .treegrow import TreeArrays
from .treegrow_windowed import (INFO, _run_fused_rounds, _w_finalize, _w_init,
                                _window_size, round_finish, round_geometry,
                                round_rows)

_INT32_MAX = 2 ** 31 - 1


def lane_floor(lanes: int) -> int:
    """The fleet's W ladder floor a lane: 8192 / B, 128-quantized."""
    return max(128, (8192 // max(lanes, 1)) // 128 * 128)


def fold_info(infos: torch.Tensor) -> torch.Tensor:
    """(B, 6) lane info vectors -> the round loop's (6,) (module docstring)."""
    k_b = infos[:, 0]
    act = k_b > 0
    k = torch.where(act.any(), torch.where(act, k_b, _INT32_MAX).min(),
                    torch.zeros((), dtype=k_b.dtype, device=k_b.device))
    return torch.stack([k, infos[:, 1].max(), infos[:, 2].min(), infos[:, 3].max(),
                        infos[:, 4].min(), infos[:, 5].max()]).to(torch.int32)


def _fleet_round(states, inputs, bins, num_bins_pf, missing_bin_pf, *,
                 num_leaves: int, num_bins: int, max_depth: int,
                 params: SplitParams, leaf_tile: int, W: int, quantize_bins: int,
                 hist_precision: str):
    """One round of every lane: returns (states', folded info)."""
    T = leaf_tile
    i32 = torch.int32
    geo = [round_geometry(st, bins, missing_bin_pf, num_leaves=num_leaves,
                          leaf_tile=T, max_depth=max_depth, params=params, W=W)
           for st in states]
    # ---- B2, lane mode: every lane's segments in one launch ----
    new_orders, _ = partition_segments_lanes(
        torch.stack([st.order for st in states]),
        torch.stack([g.seg_start for g in geo]).to(i32),
        torch.stack([g.seg_len_eff for g in geo]).to(i32),
        torch.stack([g.go_left for g in geo]))
    rows = [round_rows(st, g, new_orders[b], None)
            for b, (st, g) in enumerate(zip(states, geo))]
    # ---- B1, lane mode: every lane's window through its own row ids ----
    win_rows, win_slot = [], []
    for b, g in enumerate(geo):
        r, slot_of, valid = window_rows(new_orders[b], g.win_start, g.win_cnt, W)
        win_rows.append(r.to(i32))
        win_slot.append(torch.where(valid, slot_of, -1))
    win_rows, win_slot = torch.stack(win_rows), torch.stack(win_slot)
    mask = torch.stack([inp.row_mask for inp in inputs])
    if quantize_bins:
        fresh = histogram_multi_quantized_lanes(
            bins, torch.stack([inp.gq for inp in inputs]),
            torch.stack([inp.hq for inp in inputs]), mask, win_rows, win_slot, T,
            num_bins)
    else:
        fresh = histogram_multi_lanes(
            bins, torch.stack([inp.grad for inp in inputs]),
            torch.stack([inp.hess for inp in inputs]), mask, win_rows, win_slot,
            torch.stack([inp.shift for inp in inputs]), T, num_bins,
            precision=hist_precision)
    out_states, infos = [], []
    for b, (st, g, inp) in enumerate(zip(states, geo, inputs)):
        fresh_b = (fresh[b].float() * inp.quant_scale[:, None, None]
                   if quantize_bins else fresh[b])
        left_h, right_h = split_window(g.parent_hists, fresh_b, g.slot_small_left)
        st2, info = round_finish(st, g, rows[b], left_h, right_h, num_bins_pf,
                                 missing_bin_pf, inp.feature_mask,
                                 num_leaves=num_leaves, num_bins=num_bins,
                                 max_depth=max_depth, params=params, leaf_tile=T)
        out_states.append(st2)
        infos.append(info)
    return tuple(out_states), fold_info(torch.stack(infos))


def grow_fleet_windowed(
    bins: torch.Tensor,  # (N, F) int16, row-major, shared
    grad: torch.Tensor,  # (B, N) f32
    hess: torch.Tensor,  # (B, N) f32
    row_mask: torch.Tensor,  # (B, N) bool
    sample_weight: torch.Tensor,  # (B, N) f32
    feature_mask: torch.Tensor,  # (F,) bool, shared
    num_bins_per_feature: torch.Tensor,
    missing_bin_per_feature: torch.Tensor,
    *,
    num_leaves: int,
    num_bins: int,
    max_depth: int = -1,
    params: SplitParams = SplitParams(),
    leaf_tile: int = 16,
    hist_precision: str = "f32",
    quantize_bins: int = 0,
    stochastic_rounding: bool = True,
    quant_renew: bool = False,
    quant_seed: Optional[int] = None,
    graphs: Optional[RoundGraphs] = None,
    stats: Optional[dict] = None,
    guard_label: str = "",
) -> tuple[List[TreeArrays], torch.Tensor]:
    """Grow one tree for each of B boosters, one round of all lanes at a
    time; returns (the B lanes' TreeArrays, (B, N) leaf ids).  A lane whose
    ``row_mask`` is all False rides as a no-op lane: its root leaf is -0.0,
    it admits nothing, and its score update is an identity.  ``quant_seed``
    seeds every lane's stochastic-rounding generator (the solo run's
    seed).  ``stats`` receives the utils/sanitizer.py counts of the tree
    and the round loop's retries and windows."""
    if grad.dim() != 2:
        raise ValueError(f"fleet: grad must be (B, N), got {tuple(grad.shape)}; "
                         "for one model use ops.treegrow_windowed.grow_tree_windowed")
    lanes, n = grad.shape
    if bins.dim() != 2 or bins.shape[0] != n:
        raise ValueError(f"fleet: bins must be ({n}, F), shared by the lanes, got "
                         f"{tuple(bins.shape)}")
    for name, arr in (("hess", hess), ("row_mask", row_mask),
                      ("sample_weight", sample_weight)):
        if tuple(arr.shape) != (lanes, n):
            raise ValueError(f"fleet: {name} must be ({lanes}, {n}), got "
                             f"{tuple(arr.shape)}")
    tile = max(1, min(leaf_tile, num_leaves))
    if bins.is_cuda and lanes * n >= MAX_ROWS:
        raise ValueError(f"fleet: {lanes} lanes x {n} rows exceed the lane-mode "
                         f"partition's {MAX_ROWS} positions a launch")
    static = dict(num_leaves=num_leaves, num_bins=num_bins, max_depth=max_depth,
                  params=params, leaf_tile=tile, quantize_bins=quantize_bins,
                  hist_precision=hist_precision)
    fixed = (bins, num_bins_per_feature, missing_bin_per_feature)
    with _san.DispatchCounter() as counter:
        try:
            states, inputs, g_true, h_true = [], [], [], []
            hist_bufs = (None if graphs is None or graphs.buffers is None
                         else [st.hist for st in graphs.buffers[0]])
            for b in range(lanes):
                gen = None
                if quantize_bins:
                    gen = torch.Generator(device=bins.device)
                    gen.manual_seed(int(quant_seed or 0))
                st, inp, gt, ht = _w_init(
                    bins, grad[b], hess[b], row_mask[b], sample_weight[b],
                    num_bins_per_feature, missing_bin_per_feature, feature_mask,
                    num_leaves=num_leaves, num_bins=num_bins, params=params,
                    quantize_bins=quantize_bins, stochastic_rounding=stochastic_rounding,
                    generator=gen, hist_precision=hist_precision,
                    hist=None if hist_bufs is None else hist_bufs[b],
                    check_finite=False)
                states.append(st)
                inputs.append(inp)
                g_true.append(gt)
                h_true.append(ht)
            # the tree's one blocking read, for every lane at once: the
            # gradients' maxima must be finite (a fixed-point sum cannot
            # carry a NaN or an infinity)
            am = torch.stack([torch.stack([inp.grad.abs().max(), inp.hess.abs().max()])
                              for inp in inputs])
            if not np.isfinite(_san.sync_pull(am)).all():
                raise NonFiniteError(f"non-finite gradients or hessians in the fleet"
                                     f"{guard_label}")

            def round_fn(sts, inps, W):
                return _fleet_round(sts, inps, bins, num_bins_per_feature,
                                    missing_bin_per_feature, W=W, **static)

            states, inputs = tuple(states), tuple(inputs)
            if graphs is None:
                def run(sts, W):
                    return round_fn(sts, inputs, W)
            else:
                info0 = torch.zeros(INFO, dtype=torch.int32, device=bins.device)
                buffers = graphs.load((states, inputs, info0), fixed)
                key = ("fleet", lanes) + tuple(static.items())

                def run(_, W):
                    def body(bufs):
                        sts, inps, out = bufs
                        new, info = round_fn(sts, inps, W)
                        copy_into(sts, new)
                        out.copy_(info)

                    graphs.run(key + (W,), body)
                    return buffers[0], buffers[2]

            floor = lane_floor(lanes)
            states = _run_fused_rounds(
                run, states, n_ladder=n,
                w_first=_window_size(max(n // 2, 1), n, floor),
                num_leaves=num_leaves, stats=stats, guard_label=guard_label,
                floor=floor)
            trees, leaf_ids = [], []
            for b in range(lanes):
                tree, leaf_id = _w_finalize(
                    states[b], g_true[b], h_true[b], inputs[b].row_mask, params=params,
                    quant_renew=bool(quant_renew and quantize_bins))
                if graphs is not None:  # the next tree overwrites the buffers
                    tree = TreeArrays(*[None if a is None else a.clone() for a in tree])
                    leaf_id = leaf_id.clone()
                trees.append(tree)
                leaf_ids.append(leaf_id)
            return trees, torch.stack(leaf_ids)
        finally:
            if stats is not None:
                stats.update(counter.stats())
