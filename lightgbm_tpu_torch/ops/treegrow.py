"""Leaf-wise tree growth: the strict grower, and what the round-batched
growers share (tree arrays, admission and the node bookkeeping of a round).

Counterpart of lightgbm_tpu/ops/treegrow.py (reference:
src/treelearner/serial_tree_learner.cpp, class Tree in
include/LightGBM/tree.h).  ``grow_tree`` is the exact-order best-first
grower, the JAX package's default off the accelerator: L - 1 steps, each
splitting the leaf with the best gain.  A step is a fixed sequence of
device work, as the JAX package's fori_loop body is: the best leaf, the
number of leaves and "no splittable leaf" stay on the device, and a step
after the last useful split is a masked no-op, so a tree makes no host
read.  Categorical splits route a row left when its bin is in the
winning subset (``cat_mask``), so missing and unseen categories go right.

The constraint envelope is the JAX package's: monotone constraints with
basic (midpoint fences) or intermediate bounds (every leaf bounded by the
opposite subtrees' outputs at each monotone ancestor, all leaves searched
again after each split), interaction constraints (a per-leaf mask from
the features on its path), CEGB split, coupled and lazy penalties,
per-node sampling from a per-tree uniform table (``rng_key``, indexed by
node id: 0 for the root, 2s + 1 and 2s + 2 for the children of split s),
forced splits (a (leaf, feature, bin) schedule applied first; the first
invalid entry disables the rest), and the path features linear trees
need (``track_path``).
The round-batched growers live in ops/treegrow_fast.py and
ops/treegrow_windowed.py.

A round is a fixed sequence of device work: its splits are masked by
``accept`` over the leaves, and writes of the leaves or ranks it does not
admit land in a spare slot (``_put``), so no host read sizes anything.

Distributed (``axis_name``: a parallel/mesh.py::RowShard, the torch form of
the JAX package's mesh axis; parallel/data_parallel.py and
feature_parallel.py call it), with ``parallel_mode``:

* ``data``: rows sharded.  Every histogram is summed by each rank into the
  fixed-point accumulators with the tree's global exponents and merged
  exactly (ops/histogram.py::histogram_multi_merged), so every rank holds
  the serial histograms and grows the serial tree bit for bit;
* ``voting`` (PV-Tree, reference: voting_parallel_tree_learner.cpp): rows
  sharded, histograms kept local; each leaf search votes each rank's
  top_k features by local gain, and only the 2 * top_k elected features'
  histograms are summed (in f32, as the JAX package's psum sums them);
* ``feature``: rows replicated, features sharded (each rank holds a block
  of F / R columns): each rank searches its features, the best split is
  elected (max gain, then the lowest rank) and broadcast, and the owner's
  go-left bits are broadcast; the histograms are the serial ones, so the
  tree is too.

Lazy CEGB charges are row-global state and stay serial-only, as in the JAX
package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..parallel import collectives as C
from ..utils import sanitizer as _san
from .hist_cuda import fixed_shift_tensor
from .histogram import dcn_merge, global_shift, histogram_multi, histogram_multi_merged
from .round_cuda import split_window
from .split import (KMIN_SCORE, BestSplit, SplitParams, find_best_split,
                    forced_split_candidate, gain_plane, leaf_output,
                    leaf_output_smoothed, reduce_plane_per_feature)

def reject_unported(who: str, options: dict) -> None:
    """Raise for any option a grower does not know (the 2-D and
    hierarchical meshes have no grower option: parallel/feature2d.py and
    parallel/hierarchy.py build their context)."""
    if options:
        raise TypeError(f"unexpected options: {sorted(options)}")


def at(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """t[i] for a 0-d index tensor, without reading it on the host."""
    return t.index_select(0, i.reshape(1))[0]


def allowed_features(used, interaction_sets, mesh=None):
    """(C, F) features allowed at each leaf: the union of the interaction
    sets that hold every feature on its path (``used`` (C, F); reference:
    col_sampler.hpp's interaction-constraint filter).  ``mesh``: features
    are sharded (feature mode), so a set qualifies only if it does on
    every rank's block."""
    ok_s = ~(used[:, None, :] & ~interaction_sets[None]).any(dim=2)  # (C, S)
    if mesh is not None:
        ok_s = C.pmin(ok_s, mesh)
    return (interaction_sets[None] & ok_s[..., None]).any(dim=1)


class Envelope(NamedTuple):
    """A training's constraint options as the growers take them (fixed
    tensors, read where they lie)."""
    monotone: Optional[torch.Tensor] = None  # (F,) i32 in {-1, 0, 1}
    intermediate: bool = False  # monotone bounds: intermediate, else basic
    sets: Optional[torch.Tensor] = None  # (S, F) bool interaction sets
    lazy_pen: Optional[torch.Tensor] = None  # (F,) lazy CEGB penalties
    forced: Optional[tuple] = None  # (leaf, feature, bin) (K,) i32 each
    track_path: bool = False  # keep the path features (linear trees)

    def tensors(self) -> tuple:
        return tuple(t for t in (self.monotone, self.sets, self.lazy_pen,
                                 *(self.forced or ())) if t is not None)


def leaf_search(env: Envelope, feature_mask, rng, coupled, cegb_used, used, lo,
                hi, node_ids, depth, lazy_counts, feature_mesh=None) -> dict:
    """find_best_split's constraint keywords for C leaves: the feature mask
    narrowed by the interaction sets of the features on each leaf's path
    (``used`` (C, F)), the monotone band (lo, hi (C,)), the leaves' rows of
    the node-uniform table ``rng`` (by ``node_ids``), and the CEGB penalties:
    the coupled ones (F,) of features not yet used in the tree plus the lazy
    ones times each leaf's uncharged rows (``lazy_counts`` (C, F))."""
    fm = feature_mask
    if env.sets is not None:
        allowed = allowed_features(used, env.sets, feature_mesh)
        fm = allowed if fm is None else fm & allowed
    pen = None if coupled is None else torch.where(cegb_used, 0.0, coupled)
    if lazy_counts is not None:
        lz = env.lazy_pen * lazy_counts
        pen = lz if pen is None else pen + lz
    mono = env.monotone is not None
    return dict(feature_mask=fm, monotone_constraints=env.monotone,
                out_lo=lo if mono else None, out_hi=hi if mono else None,
                rng_key=None if rng is None else rng.index_select(0, node_ids),
                depth=depth.float(), cegb_feature_penalty=pen)


def intermediate_bounds(anc, aside, node_mono, leaf_out, n_live, L: int):
    """Monotone 'intermediate' bounds (reference: IntermediateLeafConstraints;
    the JAX package's _intermediate_bounds): each leaf is bounded by the
    output extremes of the opposite subtree at every monotone ancestor.
    anc / aside (L, L-1) ancestor masks (aside: the leaf is on the node's
    right), node_mono (L-1,) each node's direction (0 at categorical
    nodes).  Returns (lo, hi) (L,)."""
    live = (torch.arange(L, device=leaf_out.device) < n_live)[:, None]
    left_m = anc & ~aside & live
    right_m = anc & aside & live
    o = leaf_out[:, None]
    ninf, pinf = float("-inf"), float("inf")
    l_max = torch.where(left_m, o, ninf).amax(dim=0)
    l_min = torch.where(left_m, o, pinf).amin(dim=0)
    r_max = torch.where(right_m, o, ninf).amax(dim=0)
    r_min = torch.where(right_m, o, pinf).amin(dim=0)
    d = node_mono[None, :]
    lo_c = torch.maximum(torch.where(right_m & (d > 0), l_max[None], ninf),
                         torch.where(left_m & (d < 0), r_max[None], ninf))
    hi_c = torch.minimum(torch.where(left_m & (d > 0), r_min[None], pinf),
                         torch.where(right_m & (d < 0), l_min[None], pinf))
    return lo_c.amax(dim=1), hi_c.amin(dim=1)


def basic_bounds(mono_c, out_l, out_r, p_lo, p_hi):
    """Basic monotone bounds (reference: BasicLeafConstraints::
    SetChildrenConstraints): the children's outputs clipped to the
    parent's band, then fenced at their midpoint on a monotone split.
    Returns (out_l, out_r, l_lo, l_hi, r_lo, r_hi)."""
    out_l = torch.clamp(out_l, p_lo, p_hi)
    out_r = torch.clamp(out_r, p_lo, p_hi)
    mid = 0.5 * (out_l + out_r)
    l_hi = torch.where(mono_c > 0, torch.minimum(p_hi, mid), p_hi)
    r_lo = torch.where(mono_c > 0, torch.maximum(p_lo, mid), p_lo)
    l_lo = torch.where(mono_c < 0, torch.maximum(p_lo, mid), p_lo)
    r_hi = torch.where(mono_c < 0, torch.minimum(p_hi, mid), p_hi)
    return out_l, out_r, l_lo, l_hi, r_lo, r_hi


def final_leaf_values(leaf_out, leaf_sum_g, leaf_sum_h, lo, hi, params,
                      monotone: bool, intermediate: bool):
    """Leaf values at the end of a tree: the creation-time outputs where
    they were smoothed or clipped to evolving (intermediate) bounds, else
    the outputs of the sums, clipped to the final basic bounds."""
    if params.path_smooth > 0 or intermediate:
        return leaf_out
    v = leaf_output(leaf_sum_g, leaf_sum_h, params)
    return torch.clamp(v, lo, hi) if monotone else v


def serial_totals(hist_f0: torch.Tensor, num_feature: int) -> torch.Tensor:
    """A leaf's (g, h, count) totals from the (3, B) histogram of global
    feature 0, summed as the serial growers sum them: torch.sum over the
    bins of feature 0 of a (3, F, B) histogram.  A CUDA reduction's order
    follows its input's layout, so the rank holding feature 0 of a feature
    block lays it out at the serial width first; the sum is then the
    serial one bit for bit."""
    buf = hist_f0.new_zeros((3, num_feature, hist_f0.shape[-1]))
    buf[:, 0] = hist_f0
    return torch.sum(buf[:, 0, :], dim=1)


def _pack_best(s: BestSplit) -> torch.Tensor:
    """A BestSplit (C,) as one (C, 11 + B) int32 tensor of bit patterns."""
    def col(x):
        if x.dtype == torch.float32:
            return x.contiguous().view(torch.int32)[:, None]
        return x.to(torch.int32)[:, None]
    return torch.cat([col(s.gain), col(s.feature), col(s.threshold_bin),
                      col(s.default_left), col(s.is_cat), col(s.left_sum_g),
                      col(s.left_sum_h), col(s.left_count), col(s.right_sum_g),
                      col(s.right_sum_h), col(s.right_count),
                      s.cat_mask.to(torch.int32)], dim=1)


def _unpack_best(t: torch.Tensor) -> BestSplit:
    def fl(i):
        return t[:, i].contiguous().view(torch.float32)
    return BestSplit(gain=fl(0), feature=t[:, 1], threshold_bin=t[:, 2],
                     default_left=t[:, 3] != 0, is_cat=t[:, 4] != 0,
                     cat_mask=t[:, 11:] != 0, left_sum_g=fl(5), left_sum_h=fl(6),
                     left_count=fl(7), right_sum_g=fl(8), right_sum_h=fl(9),
                     right_count=fl(10))


def elect_best(s: BestSplit, mesh, f0: int) -> BestSplit:
    """Owned-feature winner election (reference: SyncUpGlobalBestSplit, an
    Allreduce of SplitInfo; the JAX package's feature mode and _merge_best):
    each rank's best over its block, its feature index made global (+ f0),
    the max gain, the lowest rank holding it (the lowest feature block,
    so the serial argmax's first maximum), and the winner's fields
    broadcast bit for bit: three collectives for a batch of leaves."""
    single = s.gain.dim() == 0
    if single:
        s = BestSplit(*[x[None] for x in s])
    s = s._replace(feature=s.feature + f0)
    gmax = C.pmax(s.gain, mesh)
    cand = torch.where(s.gain >= gmax, mesh.rank, 1 << 30).to(torch.int32)
    wrank = C.pmin(cand, mesh)
    out = _unpack_best(C.broadcast_from(_pack_best(s), wrank, mesh))
    return BestSplit(*[x[0] for x in out]) if single else out


def vote_best(hist, sum_g, sum_h, count, nbpf, mbpf, params, mesh, top_k: int,
              kw: dict) -> BestSplit:
    """PV-Tree's search for a batch of leaves (the JAX package's voting
    mode): per leaf, each rank votes its top_k features by the gain of its
    LOCAL histogram (hist (C, 3, F, B), local totals), the tally elects
    min(2 * top_k, F) features (ties to the lower index), and only their
    histograms are summed across the ranks before the search."""
    c, _three, f, b = hist.shape
    loc = hist[:, :, 0, :].sum(dim=2)  # (C, 3) local leaf totals
    gain, ctx = gain_plane(hist, loc[:, 0], loc[:, 1], loc[:, 2], nbpf, mbpf,
                           params, **kw)
    per_f = reduce_plane_per_feature(gain, ctx).gain  # (C, F)
    kth = torch.topk(per_f, min(top_k, f), dim=1).values[:, -1:]
    vote = (per_f >= kth) & (per_f > KMIN_SCORE / 2)
    tally = C.psum(vote.to(torch.int32), mesh)
    score = tally * (f + 1) - torch.arange(f, dtype=torch.int32, device=hist.device)
    n_elect = min(2 * top_k, f)
    el = torch.topk(score, n_elect, dim=1).indices  # (C, E)
    sub = C.psum(hist.gather(2, el[:, None, :, None].expand(c, 3, n_elect, b)),
                 mesh)
    outs = []
    for i in range(c):  # the elected tables differ leaf by leaf
        e = el[i]

        def pick(v):
            if v is None:
                return None
            if v.dim() == 2 and v.shape[0] == c:  # per-leaf (C, F)
                return v[i][e]
            return v[e]
        kwi = {k: (pick(v) if k in ("feature_mask", "categorical_mask",
                                    "monotone_constraints",
                                    "cegb_feature_penalty", "feature_contri")
                   else v[i:i + 1] if torch.is_tensor(v) and v.dim() >= 1
                   and v.shape[0] == c else v)
               for k, v in kw.items()}
        if kwi.get("rng_key") is not None:
            kwi["rng_key"] = kwi["rng_key"][:, :, e]
        bi = find_best_split(sub[i:i + 1], sum_g[i:i + 1], sum_h[i:i + 1],
                             count[i:i + 1], nbpf[e], mbpf[e], params, **kwi)
        outs.append(bi._replace(feature=e[bi.feature.long()].to(torch.int32)))
    return BestSplit(*[torch.cat(xs) for xs in zip(*outs)])


def _topk(x: torch.Tensor, k: int):
    """(values, indices) of the k largest of each row, ties to the lower
    index (a stable sort: the same order on every rank)."""
    v, i = torch.sort(x, dim=1, descending=True, stable=True)
    return v[:, :k], i[:, :k]


def dcn_topk_best(cand: torch.Tensor, parent_g, parent_h, parent_c, nbpf, mbpf,
                  fmask, cmask, contri, *, params: SplitParams, top_k: int, dcn,
                  convert, parent_out) -> BestSplit:
    """The two-level split search of a batch of candidates (the JAX
    package's dcn_topk_best): ``cand`` (C, 3, Fd, B) slice-domain fixed-point
    histograms over this rank's feature tables (every feature under the
    slice's all_reduce, its owned block under reduce_scatter), the GLOBAL
    parent sums, ``convert`` the fixed point's f32 conversion.  Returns the
    best split of each candidate, its feature in this rank's domain (the
    caller's owned-feature election composes)."""
    c, _three, fd, b = cand.shape
    k = max(1, min(int(top_k), fd))
    local = convert(cand)
    tot = local[:, :, 0, :].sum(dim=2)  # slice-local child totals
    gain, ctx = gain_plane(local, tot[:, 0], tot[:, 1], tot[:, 2], nbpf, mbpf, params,
                           feature_mask=fmask, categorical_mask=cmask,
                           feature_contri=contri, parent_output=parent_out)
    vote_gain, vote_idx = _topk(reduce_plane_per_feature(gain, ctx).gain, k)
    all_gain = C.all_gather(vote_gain[None].contiguous(), dcn)  # (S, C, k)
    all_idx = C.all_gather(vote_idx[None].contiguous(), dcn)
    contrib = torch.where(all_gain > KMIN_SCORE / 2, all_gain, 0.0)
    score = torch.zeros((c, fd), dtype=torch.float32, device=cand.device)
    for s in range(all_gain.shape[0]):  # a slice's ids are distinct: no races
        score.scatter_add_(1, all_idx[s], contrib[s])
    elected = torch.sort(_topk(score, k)[1], dim=1).values  # (C, k)
    sub = cand.gather(2, elected[:, None, :, None].expand(c, 3, k, b))
    glob = convert(dcn_merge(sub, dcn))  # the only histogram over dcn
    outs = []
    for i in range(c):  # each candidate's elected tables differ
        e = elected[i]

        def pick(v):
            return None if v is None else v[e]

        outs.append(find_best_split(
            glob[i:i + 1], parent_g[i:i + 1], parent_h[i:i + 1], parent_c[i:i + 1],
            nbpf[e], mbpf[e], params, feature_mask=pick(fmask),
            parent_output=parent_out[i:i + 1], categorical_mask=pick(cmask),
            feature_contri=pick(contri)))
    bb = BestSplit(*[torch.cat(xs) for xs in zip(*outs)])
    feat = elected.gather(1, bb.feature.long()[:, None])[:, 0]
    return bb._replace(feature=feat.to(bb.feature.dtype))


class TreeArrays(NamedTuple):
    """Structure-of-arrays tree.  Internal node slots 0..num_leaves-2 (slot
    t = t-th split); children encode leaves as ~leaf_index (negative)."""

    num_leaves: torch.Tensor  # i32 scalar — actual leaf count
    split_feature: torch.Tensor  # (L-1,) i32
    threshold_bin: torch.Tensor  # (L-1,) i32
    default_left: torch.Tensor  # (L-1,) bool
    split_gain: torch.Tensor  # (L-1,) f32
    left_child: torch.Tensor  # (L-1,) i32
    right_child: torch.Tensor  # (L-1,) i32
    internal_value: torch.Tensor  # (L-1,) f32
    internal_weight: torch.Tensor  # (L-1,) f32 — sum hessian
    internal_count: torch.Tensor  # (L-1,) f32
    leaf_value: torch.Tensor  # (L,) f32
    leaf_weight: torch.Tensor  # (L,) f32 — sum hessian
    leaf_count: torch.Tensor  # (L,) f32
    leaf_sum_g: torch.Tensor  # (L,) f32
    leaf_depth: torch.Tensor  # (L,) i32
    is_cat: torch.Tensor  # (L-1,) bool
    cat_mask: torch.Tensor  # (L-1, B) bool
    path_features: Optional[torch.Tensor] = None  # (L, F) bool (linear trees)

    def to_numpy(self) -> "TreeArrays":
        return TreeArrays(*[None if a is None else a.cpu().numpy()
                            for a in self])


def _empty_best(num_leaves: int, num_bins: int, device) -> BestSplit:
    def z(dtype):
        return torch.zeros((num_leaves,), dtype=dtype, device=device)

    return BestSplit(
        gain=torch.full((num_leaves,), KMIN_SCORE, dtype=torch.float32,
                        device=device),
        feature=z(torch.int32),
        threshold_bin=z(torch.int32),
        default_left=z(torch.bool),
        is_cat=z(torch.bool),
        cat_mask=torch.zeros((num_leaves, num_bins), dtype=torch.bool,
                             device=device),
        left_sum_g=z(torch.float32),
        left_sum_h=z(torch.float32),
        left_count=z(torch.float32),
        right_sum_g=z(torch.float32),
        right_sum_h=z(torch.float32),
        right_count=z(torch.float32),
    )


def _set_best(best: BestSplit, idx: torch.Tensor, s: BestSplit) -> None:
    """best[idx] = s for every field, in place."""
    for arr, v in zip(best, s):
        arr[idx] = v


def _put(arr: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """``arr.at[idx].set(val, mode="drop")``: a new array with arr[idx] =
    val where 0 <= idx < len(arr); idx = -1 drops the write (it lands in a
    spare slot past the end); any other index raises.  Two device kernels:
    a round is hundreds of such small updates, so their count is most of
    its device time."""
    n = arr.shape[0]
    ext = torch.cat([arr, arr[:1]])
    if not torch.is_tensor(val):  # a host scalar would be a blocking copy
        val = torch.full((), val, device=arr.device)
    ext[idx.long()] = val.to(arr.dtype)
    return ext[:n]


def go_left_of(col, missing_bin, default_left, threshold_bin, is_cat=None,
               cat_mask=None):
    """Each row's direction at its split: a numerical split sends bin <=
    threshold left and the missing bin its default way; a categorical one
    (``is_cat``) sends the bins of its ``cat_mask`` left (reference:
    Tree::CategoricalDecision; missing and unseen categories go right).
    ``cat_mask`` is the row's mask row, or a gather of it; col (N,) i32."""
    gl = torch.where(col == missing_bin, default_left, col <= threshold_bin)
    if is_cat is None:
        return gl
    return torch.where(is_cat, cat_mask, gl)


def _splittable(gain, leaf_depth, max_depth: int) -> torch.Tensor:
    can = gain > KMIN_SCORE / 2
    if max_depth > 0:
        can = can & (leaf_depth < max_depth)
    return can


def _rank(srt: torch.Tensor) -> torch.Tensor:
    """The rank of each element from a sort order (an inverse permutation)."""
    rank = torch.empty_like(srt)
    rank[srt] = torch.arange(srt.shape[0], dtype=srt.dtype, device=srt.device)
    return rank


def admit(gain, leaf_depth, num_leaves_cur, *, num_leaves: int,
          leaf_tile: int, max_depth: int, conflict=None):
    """This round's splits, best gain first within the budget and at most
    ``leaf_tile``: (accept (L,) bool, rank of each leaf, leaf of each rank).
    The admitted leaves are a prefix of the stable sort order.
    ``conflict`` (L, L) bool (intermediate monotone bounds: the leaves share
    a monotone ancestor): a leaf in conflict with any better-ranked
    candidate is deferred to a later round, so bounds evolve one split at a
    time under each monotone node, as in the strict grower."""
    L = num_leaves
    can = _splittable(gain, leaf_depth, max_depth)
    if conflict is not None:
        pre_rank = _rank(torch.argsort(torch.where(can, -gain, float("inf")),
                                       stable=True))
        better = pre_rank[None, :] < pre_rank[:, None]
        can = can & ~(conflict & better & can[None, :]).any(dim=1)
    srt = torch.argsort(torch.where(can, -gain, float("inf")), stable=True)
    order_rank = _rank(srt)
    accept = can & (order_rank < (L - num_leaves_cur).clamp_max(leaf_tile))
    return accept, order_rank, srt


def admits_next(gain, leaf_depth, num_leaves_cur, *, num_leaves: int,
                leaf_tile: int, max_depth: int) -> torch.Tensor:
    """How many splits the next round admits from this state (0-d)."""
    budget = (num_leaves - num_leaves_cur).clamp(0, leaf_tile)
    return torch.minimum(_splittable(gain, leaf_depth, max_depth).sum(), budget)


def empty_tree(num_leaves: int, num_bins: int, device) -> TreeArrays:
    """A one-leaf tree: node arrays (L-1,), leaf arrays (L,), all zero."""
    L, m = num_leaves, num_leaves - 1

    def zeros(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return TreeArrays(
        num_leaves=torch.ones((), dtype=torch.int32, device=device),
        split_feature=zeros(m, torch.int32), threshold_bin=zeros(m, torch.int32),
        default_left=zeros(m, torch.bool), split_gain=zeros(m),
        left_child=zeros(m, torch.int32), right_child=zeros(m, torch.int32),
        internal_value=zeros(m), internal_weight=zeros(m), internal_count=zeros(m),
        leaf_value=zeros(L), leaf_weight=zeros(L), leaf_count=zeros(L),
        leaf_sum_g=zeros(L), leaf_depth=zeros(L, torch.int32),
        is_cat=zeros(m, torch.bool), cat_mask=zeros((m, num_bins), torch.bool))


def book_tree(t: TreeArrays, accept, node_of, right_of, leaf_parent, leaf_side,
              s: BestSplit, leaf_out, leaf_sum_h, leaf_count,
              categorical: bool = False) -> TreeArrays:
    """The node arrays after the admitted splits: each admitted leaf's node
    (slot node_of) takes its split and the leaf's output and sums, its
    children are ~leaf (the left keeps the id) and ~right_of, and the
    parent's child slot is re-pointed from ~leaf to the node.
    ``categorical``: book is_cat and cat_mask too (they stay False
    otherwise)."""
    L = accept.shape[0]
    drop = -1  # _put's index of the spare slot
    idx = torch.arange(L, dtype=torch.int64, device=accept.device)
    repoint_l = accept & (leaf_parent >= 0) & (leaf_side == 0)
    repoint_r = accept & (leaf_parent >= 0) & (leaf_side == 1)
    safe_node = node_of.clamp(0, L - 2)
    lc_t = _put(t.left_child, torch.where(repoint_l, leaf_parent, drop), safe_node)
    rc_t = _put(t.right_child, torch.where(repoint_r, leaf_parent, drop), safe_node)
    node_pos = torch.where(accept, node_of, drop)
    if categorical:
        t = t._replace(is_cat=_put(t.is_cat, node_pos, s.is_cat),
                       cat_mask=_put(t.cat_mask, node_pos, s.cat_mask))
    return t._replace(
        split_feature=_put(t.split_feature, node_pos, s.feature),
        threshold_bin=_put(t.threshold_bin, node_pos, s.threshold_bin),
        default_left=_put(t.default_left, node_pos, s.default_left),
        split_gain=_put(t.split_gain, node_pos, s.gain),
        left_child=_put(lc_t, node_pos, -idx - 1),
        right_child=_put(rc_t, node_pos, -right_of - 1),
        internal_value=_put(t.internal_value, node_pos, leaf_out),
        internal_weight=_put(t.internal_weight, node_pos, leaf_sum_h),
        internal_count=_put(t.internal_count, node_pos, leaf_count),
    )


def quantize_gradients(grad, hess, row_mask, quantize_bins: int,
                       stochastic_rounding: bool,
                       generator: Optional[torch.Generator], shard=None):
    """Discretize to int8: grad in [-half, half], hess in [0, quantize_bins]
    (reference: GradientDiscretizer::DiscretizeGradients); stochastic
    rounding draws from ``generator``.  Returns (gq, hq, the dequantized
    grad and hess that split evaluation sees, quant_scale (3,)).
    ``shard`` (parallel/mesh.py::RowShard): the rows are one rank's; the
    scales come from the maxima over all ranks (one pmax) and the draws are
    the serial draws of these rows (all N drawn, this rank's slice kept),
    so every rank quantizes as the serial run does."""
    dev = grad.device
    n = grad.shape[0]
    half = max(quantize_bins // 2, 1)
    inbag = row_mask.float()
    if n:
        mx = torch.stack([torch.max(torch.abs(grad) * inbag), torch.max(hess * inbag)])
    else:
        mx = torch.zeros(2, dtype=torch.float32, device=dev)
    if shard is not None:
        mx = C.pmax(mx, shard.mesh)
    g_scale = torch.clamp_min(mx[0] / half, 1e-30)
    h_scale = torch.clamp_min(mx[1] / quantize_bins, 1e-30)
    gs = grad / g_scale
    hs = hess / h_scale
    if stochastic_rounding:
        total = n if shard is None else shard.num_data
        u = torch.rand((2, total), generator=generator, device=dev)
        if shard is not None:
            u = u[:, shard.offset: shard.offset + n]
        gq = torch.floor(gs + u[0])
        hq = torch.floor(hs + u[1])
    else:
        gq = torch.round(gs)
        hq = torch.round(hs)
    gq = gq.clamp(-127, 127).to(torch.int8)
    hq = hq.clamp(0, 127).to(torch.int8)
    quant_scale = torch.stack([g_scale, h_scale, torch.ones((), device=dev)])
    return gq, hq, gq.float() * g_scale, hq.float() * h_scale, quant_scale


def finish_tree(t: TreeArrays, num_leaves_cur, leaf_value, leaf_sum_g,
                leaf_sum_h, leaf_count, leaf_depth) -> TreeArrays:
    """The tree with its leaf arrays; leaves past the last are zero."""
    L = leaf_value.shape[0]
    active = torch.arange(L, device=leaf_value.device) < num_leaves_cur
    return t._replace(
        num_leaves=num_leaves_cur.to(torch.int32),
        leaf_value=torch.where(active, leaf_value, 0.0),
        leaf_weight=torch.where(active, leaf_sum_h, 0.0),
        leaf_count=torch.where(active, leaf_count, 0.0),
        leaf_sum_g=torch.where(active, leaf_sum_g, 0.0),
        leaf_depth=leaf_depth.to(torch.int32))


def grow_tree(
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
    stats: Optional[dict] = None,
    categorical_mask: Optional[torch.Tensor] = None,  # (F,) bool
    feature_contri: Optional[torch.Tensor] = None,  # (F,) f32
    monotone_constraints: Optional[torch.Tensor] = None,  # (F,) i32 in {-1,0,1}
    interaction_sets: Optional[torch.Tensor] = None,  # (S, F) bool
    rng_key: Optional[torch.Tensor] = None,  # (2L-1, 2, F) f32 node uniforms
    cegb_feature_penalty: Optional[torch.Tensor] = None,  # (F,) coupled
    cegb_lazy_penalty: Optional[torch.Tensor] = None,  # (F,) lazy
    cegb_lazy_used: Optional[torch.Tensor] = None,  # (N, F) bool charged rows
    forced_leaf: Optional[torch.Tensor] = None,  # (K,) i32 forced schedule
    forced_feature: Optional[torch.Tensor] = None,
    forced_bin: Optional[torch.Tensor] = None,
    n_forced: int = 0,
    track_path: bool = False,
    monotone_method: str = "basic",  # basic | intermediate
    axis_name=None,  # parallel/mesh.py::RowShard: a rank's part of the tree
    parallel_mode: str = "data",  # with axis_name: data | voting | feature
    top_k: int = 20,  # voting: features each rank votes for (reference: top_k)
    **options,
):
    """Grow one tree best-first, one split a step; returns (tree, final
    leaf_id per row), and the updated (N, F) lazy CEGB charges third when
    ``cegb_lazy_penalty`` is given (serial runs only).  With ``axis_name``
    the rows (or, in feature mode, the feature columns) are this rank's,
    and the tree comes out the same on every rank (module docstring); in
    feature mode the tables of features (feature mask, categorical mask,
    monotone vector, interaction sets, contri, penalties, uniforms) are
    this rank's block and split_feature is global.

    Each step: the leaf with the best gain (the first on ties; a scheduled
    forced split first), an elementwise leaf_id update from its split's
    column, the histogram of the smaller child (one histogram_multi call at
    tile 1 over the rows of that child), the sibling as parent minus child,
    and both children's best splits (every live leaf's, under intermediate
    monotone bounds).  Every histogram of the tree shares one fixed-point
    exponent pair (hist_cuda.fixed_shift_tensor of the tree's gradients,
    computed on the device), so the subtraction is exact.  ``stats``
    receives the utils/sanitizer.py counts of the tree (a step counts as a
    round), in the round drivers' layout (no retries, no windows)."""
    reject_unported("grow_tree", options)
    if axis_name is not None and parallel_mode not in ("data", "voting", "feature"):
        raise ValueError(f"parallel_mode must be data, voting or feature, got "
                         f"{parallel_mode!r}")
    use_lazy = (cegb_lazy_penalty is not None and cegb_lazy_used is not None
                and axis_name is None)
    env = Envelope(
        monotone=monotone_constraints,
        intermediate=(monotone_method == "intermediate"
                      and monotone_constraints is not None),
        sets=interaction_sets, lazy_pen=cegb_lazy_penalty if use_lazy else None,
        forced=((forced_leaf, forced_feature, forced_bin) if n_forced > 0 else None),
        track_path=track_path)
    with _san.DispatchCounter() as counter:
        try:
            return _grow(bins, grad, hess, row_mask, sample_weight, feature_mask,
                         num_bins_per_feature, missing_bin_per_feature,
                         num_leaves, num_bins, max_depth, params,
                         categorical_mask, feature_contri, env, n_forced, rng_key,
                         cegb_feature_penalty, cegb_lazy_used if use_lazy else None,
                         axis_name, parallel_mode if axis_name is not None
                         else "serial", top_k)
        finally:
            if stats is not None:
                stats.update(counter.stats(), retries=0, windows=[])


def _grow(bins, grad, hess, row_mask, sample_weight, feature_mask, nbpf, mbpf,
          L, num_bins, max_depth, params, cmask, contri, env: Envelope, n_forced,
          rng, coupled, lazy_used, shard=None, mode: str = "serial", top_k: int = 20):
    dev = bins.device
    n, f = bins.shape
    grad = grad.float() * sample_weight
    hess = hess.float() * sample_weight
    mesh = None if shard is None else shard.mesh
    # feature mode: rows are replicated, this rank's columns are global
    # features f0 .. f0 + f - 1
    f0 = mesh.rank * f if mode == "feature" else 0
    # the tree's exponents from all N rows (rows replicated in feature mode)
    shift = (global_shift(grad, hess, shard) if mode in ("data", "voting")
             else fixed_shift_tensor(grad, hess))
    slot = torch.zeros(n, dtype=torch.int32, device=dev)
    idx = torch.arange(L, dtype=torch.int64, device=dev)
    drop = -1  # _put's index of the spare slot
    eps = KMIN_SCORE / 2
    mono, inter = env.monotone, env.intermediate
    use_lazy = lazy_used is not None
    use_used = env.sets is not None or env.track_path
    f_leaf, f_feat, f_bin = env.forced or (None, None, None)
    fcols = torch.arange(f, device=dev) + f0

    def leaf_hist(mask):
        if mode == "data":  # rows sharded: the exact merge
            return histogram_multi_merged(bins, grad, hess, mask, slot, 0, 1,
                                          num_bins, shift, mesh)
        return histogram_multi(bins, grad, hess, mask, slot, 0, 1, num_bins,
                               shift=shift)

    def of_feature(table, feat):
        """table[feat] for a global feature index (in feature mode from
        the rank that holds the feature, broadcast)."""
        if mode != "feature":
            return at(table, feat)
        lf = feat - f0
        owned = (lf >= 0) & (lf < f)
        return C.psum(torch.where(owned, at(table, lf.clamp(0, f - 1)),
                                  torch.zeros((), dtype=table.dtype, device=dev)),
                      mesh)

    def best_for(hist, g, h, c, depth, parent_out, lo, hi, used, node_ids,
                 cegb_used, lazy_counts) -> BestSplit:
        kw = dict(parent_output=parent_out, categorical_mask=cmask,
                  feature_contri=contri,
                  **leaf_search(env, feature_mask, rng, coupled, cegb_used, used,
                                lo, hi, node_ids, depth, lazy_counts,
                                mesh if mode == "feature" else None))
        if mode == "voting":
            s = vote_best(hist, g, h, c, nbpf, mbpf, params, mesh, top_k, kw)
        else:
            s = find_best_split(hist, g, h, c, nbpf, mbpf, params, **kw)
        if mode == "feature":
            s = elect_best(s, mesh, f0)
        if max_depth > 0:  # reference: the max_depth check of BeforeFindBestSplit
            s = s._replace(gain=torch.where(depth >= max_depth, KMIN_SCORE, s.gain))
        return s

    def first(v, dtype=torch.float32):
        out = torch.zeros(L, dtype=dtype, device=dev)
        out[0] = v
        return out

    # ---- the root: every in-bag row ----
    hist = torch.zeros((L + 1, 3, f, num_bins), dtype=torch.float32, device=dev)
    hist0 = leaf_hist(row_mask)  # (1, 3, F, B)
    hist[0] = hist0[0]
    tot0 = torch.sum(hist0[0, :, 0, :], dim=1)  # totals from feature 0
    if mode == "voting":  # local histograms; the leaf totals are global
        tot0 = C.psum(tot0, mesh)
    elif mode == "feature":  # global feature 0 is rank 0's
        tot0 = C.broadcast_from(serial_totals(hist0[0, :, 0, :], shard.num_feature
                                              or f * mesh.size),
                                torch.zeros((), device=dev), mesh)
    g0, h0, c0 = tot0
    leaf_out = first(leaf_output(g0, h0, params))
    leaf_lo = torch.full((L,), float("-inf"), device=dev)
    leaf_hi = torch.full((L,), float("inf"), device=dev)
    cegb_used = torch.zeros(f, dtype=torch.bool, device=dev)
    used = (torch.zeros((L, f), dtype=torch.bool, device=dev) if use_used
            else None)
    lazy_counts = None
    if use_lazy:
        lazy_counts = torch.zeros((L, f), device=dev)
        lazy_counts[0] = row_mask.float() @ (~lazy_used).float()
    if inter:
        anc = torch.zeros((L, L - 1), dtype=torch.bool, device=dev)
        aside = torch.zeros_like(anc)
        node_mono = torch.zeros(L - 1, dtype=torch.int64, device=dev)
    best = _empty_best(L, num_bins, dev)
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    _set_best(best, zero, best_for(
        hist0, g0[None], h0[None], c0[None], zero, leaf_out[:1], leaf_lo[:1],
        leaf_hi[:1], None if used is None else used[:1], zero, cegb_used,
        None if lazy_counts is None else lazy_counts[:1]))
    leaf_id = torch.zeros(n, dtype=torch.int32, device=dev)
    leaf_sum_g, leaf_sum_h, leaf_count = first(g0), first(h0), first(c0)
    leaf_depth = torch.zeros(L, dtype=torch.int64, device=dev)
    leaf_parent = torch.full((L,), -1, dtype=torch.int64, device=dev)
    leaf_side = torch.zeros(L, dtype=torch.int64, device=dev)
    nlc = torch.ones((), dtype=torch.int64, device=dev)
    tree = empty_tree(L, num_bins, dev)
    sides = torch.arange(2, dtype=torch.int64, device=dev)
    forced_active = torch.ones((), dtype=torch.bool, device=dev)

    for i in range(L - 1):
        _san.record_dispatch()
        can = best.gain.max() > eps
        best_leaf = torch.argmax(best.gain)
        s = BestSplit(*[at(a, best_leaf) for a in best])
        if i < n_forced:
            # the i-th forced split (reference: ForceSplits), through the
            # standard gain machinery so min_data and monotone gates apply
            fl = f_leaf[i].long().clamp(0, L - 1)
            s_f = forced_split_candidate(
                at(hist, fl), at(leaf_sum_g, fl), at(leaf_sum_h, fl),
                at(leaf_count, fl), nbpf, mbpf, params, f_feat[i], f_bin[i],
                categorical_mask=cmask, monotone_constraints=mono,
                out_lo=at(leaf_lo, fl), out_hi=at(leaf_hi, fl),
                depth=at(leaf_depth, fl), parent_output=at(leaf_out, fl),
                feature_contri=contri)
            valid = (f_leaf[i] < nlc) & (s_f.gain > eps)
            if max_depth > 0:
                valid = valid & (at(leaf_depth, fl) < max_depth)
            use_forced = valid & forced_active
            # the first invalid entry disables the rest of the schedule
            forced_active = forced_active & valid
            can = can | use_forced
            best_leaf = torch.where(use_forced, fl, best_leaf)
            s = BestSplit(*[torch.where(use_forced, a, b) for a, b in zip(s_f, s)])
        bl = best_leaf.reshape(1)  # (index_select: no host read of the index)
        node, new_leaf = nlc - 1, nlc
        pair = torch.stack([best_leaf, new_leaf])
        pos = torch.where(can, pair, drop)  # where the two children write

        # ---- partition: an elementwise leaf_id update ----
        feat = s.feature.long()
        lfeat = (feat - f0).clamp(0, f - 1) if mode == "feature" else feat
        fcol = bins.index_select(1, lfeat.reshape(1))[:, 0].to(torch.int32)
        go_left = go_left_of(
            fcol, mbpf.index_select(0, lfeat.reshape(1)), s.default_left,
            s.threshold_bin, *((s.is_cat, s.cat_mask[fcol.long()])
                               if cmask is not None else ()))
        if mode == "feature":
            # only the rank holding the winning feature can route the rows;
            # rows are replicated, so its go-left bits are broadcast
            owned = (feat >= f0) & (feat < f0 + f)
            go_left = C.psum((go_left & owned).to(torch.uint8), mesh) > 0  # jaxlint: disable=R13 (C17/A27: the strict grower's sharded steps run eagerly; the step's go-left broadcast is its round's collective until NCCL rides the round graphs)
        in_leaf = can & (leaf_id == best_leaf)
        leaf_id = torch.where(in_leaf & ~go_left, new_leaf.to(torch.int32), leaf_id)

        # ---- the smaller child's histogram, the sibling by subtraction ----
        left_smaller = s.left_count <= s.right_count
        small_leaf = torch.where(left_smaller, best_leaf, new_leaf)
        fresh = leaf_hist(can & row_mask & (leaf_id == small_leaf))
        left_h, right_h = split_window(hist.index_select(0, bl), fresh,
                                       left_smaller.reshape(1))
        children = torch.cat([left_h, right_h])
        hist.index_copy_(0, torch.where(can, pair, L), children)

        # ---- the node (reference: Tree::Split) and the leaf aggregates ----
        accept = can & (idx == best_leaf)
        tree = book_tree(tree, accept, node.expand(L), new_leaf.expand(L),
                         leaf_parent, leaf_side,
                         BestSplit(*[a.expand(L, *a.shape) for a in s]),
                         leaf_out, leaf_sum_h, leaf_count,
                         categorical=cmask is not None)
        parent_out = at(leaf_out, best_leaf)
        out_l = leaf_output_smoothed(s.left_sum_g, s.left_sum_h, s.left_count,
                                     parent_out, params)
        out_r = leaf_output_smoothed(s.right_sum_g, s.right_sum_h, s.right_count,
                                     parent_out, params)
        p_lo, p_hi = at(leaf_lo, best_leaf), at(leaf_hi, best_leaf)
        if mono is not None:
            mono_c = of_feature(mono, feat)
            out_l, out_r, l_lo, l_hi, r_lo, r_hi = basic_bounds(
                mono_c, out_l, out_r, p_lo, p_hi)
        else:
            l_lo, l_hi, r_lo, r_hi = p_lo, p_hi, p_lo, p_hi
        depth_child = at(leaf_depth, best_leaf) + 1
        g2 = torch.stack([s.left_sum_g, s.right_sum_g])
        h2 = torch.stack([s.left_sum_h, s.right_sum_h])
        c2 = torch.stack([s.left_count, s.right_count])
        out2 = torch.stack([out_l, out_r])
        lo2, hi2 = torch.stack([l_lo, r_lo]), torch.stack([l_hi, r_hi])
        d2 = depth_child.expand(2)
        leaf_sum_g = _put(leaf_sum_g, pos, g2)
        leaf_sum_h = _put(leaf_sum_h, pos, h2)
        leaf_count = _put(leaf_count, pos, c2)
        leaf_depth = _put(leaf_depth, pos, d2)
        leaf_parent = _put(leaf_parent, pos, node.expand(2))
        leaf_side = _put(leaf_side, pos, sides)
        leaf_out = _put(leaf_out, pos, out2)
        leaf_lo = _put(leaf_lo, pos, lo2)
        leaf_hi = _put(leaf_hi, pos, hi2)
        split_oh = fcols == feat  # (F,) the split feature
        if coupled is not None:
            cegb_used = cegb_used | (split_oh & can)
        if use_lazy:
            # charge the split leaf's in-bag rows for its feature, then
            # count each child's uncharged rows (a child split on the same
            # feature is free); the right child holds the remainder
            lazy_used = lazy_used | ((in_leaf & row_mask)[:, None] & split_oh)
            m_l = (can & (leaf_id == best_leaf) & row_mask).float()
            counts_l = m_l @ (~lazy_used).float()
            parent_counts = torch.where(split_oh, 0.0, at(lazy_counts, best_leaf))
            counts_r = torch.clamp_min(parent_counts - counts_l, 0.0)
            lazy_counts = _put(lazy_counts, pos, torch.stack([counts_l, counts_r]))
        if inter:
            # ancestor masks, this node's direction, and every leaf's bounds
            # from the opposite subtrees' outputs
            node_oh = torch.arange(L - 1, device=dev) == node
            anc_child = at(anc, best_leaf) | node_oh
            aside_l = at(aside, best_leaf)
            anc = _put(anc, pos, torch.stack([anc_child, anc_child]))
            aside = _put(aside, pos, torch.stack([aside_l, aside_l | node_oh]))
            node_mono = _put(node_mono, torch.where(can, node, drop).reshape(1),
                             torch.where(s.is_cat, 0, mono_c).reshape(1))
            lo_all, hi_all = intermediate_bounds(anc, aside, node_mono, leaf_out,
                                                 nlc + 1, L)
            leaf_lo = torch.where(can, lo_all, leaf_lo)
            leaf_hi = torch.where(can, hi_all, leaf_hi)
        if use_used:
            used_child = at(used, best_leaf) | split_oh
            used = _put(used, pos, torch.stack([used_child, used_child]))

        # ---- best splits: the two fresh leaves, or every live leaf ----
        if inter:
            # other leaves' bounds may have moved: search them all again
            # (reference: IntermediateLeafConstraints' leaves_to_update)
            node_ids = leaf_parent.clamp_min(0) * 2 + leaf_side + 1
            bb = best_for(hist[:L], leaf_sum_g, leaf_sum_h, leaf_count,
                          leaf_depth, leaf_out, leaf_lo, leaf_hi, used,
                          node_ids, cegb_used, lazy_counts)
            bb = bb._replace(gain=torch.where(idx < nlc + 1, bb.gain, KMIN_SCORE))
            best = BestSplit(*[torch.where(can.reshape((1,) * o.dim()), nw, o)
                               for o, nw in zip(best, bb)])
        else:
            bb = best_for(children, g2, h2, c2, d2, out2, lo2, hi2,
                          None if used is None else used.index_select(0, pair),
                          torch.stack([2 * node + 1, 2 * node + 2]), cegb_used,
                          None if lazy_counts is None
                          else lazy_counts.index_select(0, pair))
            best = BestSplit(*[_put(o, pos, nw) for o, nw in zip(best, bb)])
        nlc = nlc + can.long()

    leaf_value = final_leaf_values(leaf_out, leaf_sum_g, leaf_sum_h, leaf_lo,
                                   leaf_hi, params, mono is not None, inter)
    tree = finish_tree(tree, nlc, leaf_value, leaf_sum_g, leaf_sum_h,
                       leaf_count, leaf_depth)
    if env.track_path:
        tree = tree._replace(path_features=used)
    if use_lazy:  # the charges carry over to the next tree
        return tree, leaf_id, lazy_used
    return tree, leaf_id
