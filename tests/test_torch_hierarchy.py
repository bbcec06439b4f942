"""The hierarchical two-level merge of lightgbm_tpu_torch
(parallel/hierarchy.py) on a 2 x 2 (dcn, ici) mesh of gloo loopback ranks,
against the port's flat trees and the JAX package's
grow_tree_windowed_hierarchical on the 8-device CPU mesh tests/conftest.py
provides.

Bars.  With top_k_features >= the features a rank searches the vote is
exhaustive: the window sums cross dcn as integers after the slice's merge
and the tree is the flat sharded tree (the port's serial windowed tree)
bit for bit, with the all_reduce and with the reduce_scatter inside
slices, float and int8, categorical too.  Against the JAX
package's hierarchical tree the bar is its own (tests/test_hierarchy.py):
the same nodes and leaf values within 2e-3 at full top-k, a grown, valid
tree at top-k 3.  The dcn axis carries at most k features' fixed-point
columns a candidate, and the world axis scalars only.

One run_spmd launch of 4 ranks grows every configuration, and each rank
also trains lgb.train with num_slices 2 (data and voting) and 3 (which
does not divide 4 ranks).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.ops.split import SplitParams as JParams
from lightgbm_tpu.parallel.hierarchy import SlicedData as JSliced
from lightgbm_tpu.parallel.hierarchy import grow_tree_windowed_hierarchical as jgrow_h
from lightgbm_tpu.parallel.mesh import make_mesh_hierarchical as jmesh_h
from lightgbm_tpu_torch.binning import DatasetBinner
from lightgbm_tpu_torch.ops.split import SplitParams
from lightgbm_tpu_torch.ops.treegrow_windowed import grow_tree_windowed
from lightgbm_tpu_torch.parallel.hierarchy import grow_tree_windowed_hierarchical
from lightgbm_tpu_torch.parallel.launcher import run_spmd
from lightgbm_tpu_torch.parallel.mesh import make_mesh_hierarchical

from test_torch_distributed import B, F, L, MIN_DATA, N, _data
from test_torch_feature2d import TRAIN, _train_data, _trees_of

TILE = 8
# merge inside slices, top_k_features, quantize_bins, data set
CONFIGS = {"psum_kF": ("psum", F, 0, "num"), "scatter_kF": ("scatter", F, 0, "num"),
           "psum_kF_q31": ("psum", F, 31, "num"), "psum_k3": ("psum", 3, 0, "num"),
           "scatter_k3": ("scatter", 3, 0, "num"), "cat_psum_kF": ("psum", 5, 0, "cat"),
           # the vote forced at the exhaustive k (dcn_exhaustive off)
           "psum_kF_vote": ("psum", F, 0, "num"), "scatter_kF_vote": ("scatter", F, 0, "num")}
ROUNDS = 3

_SCRIPT = r'''
import json, os
import numpy as np, torch
import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch.ops.split import SplitParams
from lightgbm_tpu_torch.ops.treegrow_windowed import grow_tree_windowed
from lightgbm_tpu_torch.parallel.hierarchy import (SlicedData, grow_tree_windowed_hierarchical,
                                                   hierarchical_sharding)
from lightgbm_tpu_torch.parallel.mesh import make_mesh_2d, make_mesh_hierarchical

torch.set_num_threads(1)
d = np.load(os.path.join(WORKDIR, "inputs.npz"))
cfg = json.load(open(os.path.join(WORKDIR, "configs.json")))
T = torch.as_tensor
params = SplitParams(min_data_in_leaf=cfg["min_data"])
mesh = make_mesh_hierarchical(2)
out = {"coords": list(mesh.coords)}
sets = {}
for key in ("num", "cat"):
    bins = d[f"{key}_bins"]
    per = -(-len(bins) // WORLD)
    lo, hi = RANK * per, min((RANK + 1) * per, len(bins))
    sets[key] = (SlicedData(mesh, bins[lo:hi], d[f"{key}_nbpf"], d[f"{key}_mbpf"]),
                 lo, hi, d[f"{key}_cmask"] if key == "cat" else None)
for name, (merge, k, q, key) in cfg["configs"].items():
    sl, lo, hi, cmask = sets[key]
    g, h = d[f"{key}_g"][lo:hi], d[f"{key}_h"][lo:hi]
    m, f = hi - lo, len(d[f"{key}_nbpf"])
    gen = torch.Generator()
    gen.manual_seed(5)
    mesh.reset_stats()
    st = {}
    ins = (T(g), T(h), torch.ones(m, dtype=torch.bool), torch.ones(m),
           torch.ones(f, dtype=torch.bool))
    common = dict(generator=gen, num_leaves=cfg["L"], num_bins=cfg["B"], params=params,
                  leaf_tile=cfg["tile"], quantize_bins=q, stats=st)
    if name.endswith("_vote"):
        sh = hierarchical_sharding(sl, merge, k, ins[4])._replace(dcn_exhaustive=False)
        tree, leaf = grow_tree_windowed(sl.bins, *ins, sl.num_bins_pf, sl.missing_bin_pf,
                                        megakernel_opt="0", sharding=sh, **common)
    else:
        tree, leaf = grow_tree_windowed_hierarchical(
            sl, *ins, None if cmask is None else T(cmask), merge=merge,
            top_k_features=k, **common)
    arrs = {kk: v.numpy() for kk, v in tree._asdict().items() if v is not None}
    np.savez(os.path.join(WORKDIR, f"{name}_r{RANK}.npz"), leaf=leaf.numpy(), **arrs)
    out[name] = dict(stats=json.loads(json.dumps(mesh.stats)), rounds=st["rounds"],
                     megakernel=bool(st["megakernel"]))
errors = []
for make in (lambda: make_mesh_hierarchical(3), lambda: make_mesh_2d(3, 2)):
    try:
        make()
    except ValueError as e:
        errors.append(str(e))
out["errors"] = errors
X, y = d["X"], d["y"]
per = -(-len(X) // WORLD)
lo, hi = RANK * per, min((RANK + 1) * per, len(X))
for learner, slices in (("data", 2), ("voting", 2), ("data", 3)):
    p = dict(cfg["train"], tree_learner=learner, num_slices=slices, pre_partition=True,
             top_k_features=X.shape[1])
    bst = lgb.train(p, lgb.Dataset(X[lo:hi], label=y[lo:hi], params=p), cfg["rounds"])
    gb = bst._gbdt
    out[f"train_{learner}_{slices}"] = dict(
        text=bst.model_to_string(), growers=[s["grower"] for s in gb.round_stats],
        hier=gb._dp_hier is not None)
json.dump(out, open(os.path.join(WORKDIR, f"out_r{RANK}.json"), "w"))
'''


def _cat_data(n=1200, seed=7):
    """The JAX package's categorical case (tests/test_hierarchy.py): two
    categorical columns of 6 values among 5."""
    rng = np.random.RandomState(seed)
    Xc = rng.randint(0, 6, size=(n, 2)).astype(np.float64)
    Xn = rng.randn(n, 3)
    X = np.concatenate([Xn, Xc], axis=1)
    y = (Xn[:, 0] + (Xc[:, 0] > 2) + 0.3 * rng.randn(n) > 0.5)
    binner = DatasetBinner.fit(X, max_bin=31, categorical_features=[3, 4])
    bins = binner.transform(X).astype(np.int16)
    g = (0.6 * (y - 0.5)).astype(np.float32)
    return (bins, g, np.ones(n, np.float32),
            np.asarray(binner.num_bins_per_feature, np.int32),
            np.asarray(binner.missing_bin_per_feature, np.int32),
            np.asarray(binner.categorical_mask, bool))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("hier"))
    bins, g, h, nbpf, mbpf = _data()
    cb, cg, ch, cn, cm, cc = _cat_data()
    X, y = _train_data()
    np.savez(os.path.join(wd, "inputs.npz"), num_bins=bins, num_g=g, num_h=h,
             num_nbpf=nbpf, num_mbpf=mbpf, cat_bins=cb, cat_g=cg, cat_h=ch, cat_nbpf=cn,
             cat_mbpf=cm, cat_cmask=cc, X=X, y=y)
    with open(os.path.join(wd, "configs.json"), "w") as fh:
        json.dump({"configs": CONFIGS, "L": L, "B": B, "min_data": MIN_DATA,
                   "tile": TILE, "train": TRAIN, "rounds": ROUNDS}, fh)
    run_spmd(_SCRIPT, 4, wd, timeout_s=85)
    trees = {name: [dict(np.load(os.path.join(wd, f"{name}_r{r}.npz"))) for r in range(4)]
             for name in CONFIGS}
    outs = [json.load(open(os.path.join(wd, f"out_r{r}.json"))) for r in range(4)]
    return trees, outs


def _inputs(key):
    if key == "num":
        bins, g, h, nbpf, mbpf = _data()
        return bins, g, h, nbpf, mbpf, None
    return _cat_data()


def _flat(name):
    """The port's serial windowed tree (the flat sharded tree bit for bit,
    tests/test_torch_distributed.py) of a configuration's inputs."""
    _merge, _k, q, key = CONFIGS[name]
    bins, g, h, nbpf, mbpf, cmask = (None if a is None else torch.as_tensor(a)
                                     for a in _inputs(key))
    n, f = bins.shape
    gen = torch.Generator()
    gen.manual_seed(5)
    t, lf = grow_tree_windowed(bins, g, h, torch.ones(n, dtype=torch.bool), torch.ones(n),
                               torch.ones(f, dtype=torch.bool), nbpf, mbpf, num_leaves=L,
                               num_bins=B, params=SplitParams(min_data_in_leaf=MIN_DATA),
                               leaf_tile=TILE, generator=gen, quantize_bins=q,
                               categorical_mask=cmask)
    return {k: v.numpy() for k, v in t._asdict().items() if v is not None}, lf.numpy()


def _same_on_every_rank(ranks):
    t0 = {k: v for k, v in ranks[0].items() if k != "leaf"}
    for r in ranks[1:]:
        for k, v in t0.items():
            np.testing.assert_array_equal(r[k], v, err_msg=f"ranks disagree on {k}")
    return t0


@pytest.mark.parametrize("name", ["psum_kF", "scatter_kF", "psum_kF_q31", "cat_psum_kF"])
def test_full_topk_is_the_flat_tree_bitwise(runs, name):
    trees, outs = runs
    tree = _same_on_every_rank(trees[name])
    want, want_leaf = _flat(name)
    assert int(want["num_leaves"]) > 8
    for k, v in want.items():
        np.testing.assert_array_equal(tree[k], v, err_msg=k)
    np.testing.assert_array_equal(np.concatenate([r["leaf"] for r in trees[name]]),
                                  want_leaf)
    assert not outs[0][name]["megakernel"]


def _meets_jax_bar(trees, name, k):
    """The port's tree of configuration ``name`` against the JAX package's
    hierarchical tree at the same merge and top-k: the same nodes, leaf
    counts and leaf ids, leaf values within 2e-3."""
    merge = CONFIGS[name][0]
    jt, jleaf = _jax_tree(merge, k)
    port = _same_on_every_rank(trees[name])
    assert int(port["num_leaves"]) == int(jt.num_leaves) > 8
    m = int(jt.num_leaves) - 1
    for key in ("split_feature", "threshold_bin", "left_child", "right_child",
                "default_left"):
        np.testing.assert_array_equal(port[key][:m], np.asarray(getattr(jt, key))[:m],
                                      err_msg=key)
    np.testing.assert_array_equal(port["leaf_count"][:m + 1],
                                  np.asarray(jt.leaf_count)[:m + 1])
    np.testing.assert_allclose(port["leaf_value"][:m + 1],
                               np.asarray(jt.leaf_value)[:m + 1], rtol=2e-3, atol=2e-3)
    np.testing.assert_array_equal(np.concatenate([r["leaf"] for r in trees[name]]),
                                  np.asarray(jleaf)[:N])


@pytest.mark.parametrize("merge", ["psum", "scatter"])
def test_full_topk_meets_the_jax_hierarchical_bar(runs, merge):
    _meets_jax_bar(runs[0], f"{merge}_kF", F)


def _jax_tree(merge, k):
    bins, g, h, nbpf, mbpf = _data()
    sd = JSliced(jmesh_h(2, 2), bins, nbpf, mbpf)
    return jgrow_h(sd, sd.pad_rows(g), sd.pad_rows(h), sd.row_valid,
                   sd.pad_rows(np.ones(N, np.float32), fill=1.0), jnp.ones((F,), bool),
                   merge=merge, top_k_features=k, num_leaves=L, num_bins=B,
                   params=JParams(min_data_in_leaf=MIN_DATA), leaf_tile=TILE,
                   use_pallas=False)


@pytest.mark.parametrize("merge", ["psum", "scatter"])
def test_small_topk_meets_the_jax_hierarchical_bar(runs, merge):
    """top_k_features 3 < F is the PV-Tree approximation: the vote (slice-
    local gains, the k best a slice, the summed score, ties to the lower id,
    the elected ids ascending) and the elected columns' global search are
    the JAX package's, so its tree at the same k is the bar."""
    _meets_jax_bar(runs[0], f"{merge}_k3", 3)


@pytest.mark.parametrize("name", ["psum_kF", "scatter_kF", "scatter_k3", "psum_k3",
                                  "psum_kF_vote", "scatter_kF_vote"])
def test_dcn_carries_at_most_k_columns_a_candidate(runs, name):
    """Per candidate, the dcn axis's histogram bytes are exactly k
    features' (B,) columns of int64 grad and hess sums and int32 counts
    (20 bytes a cell).  Below the exhaustive k the candidates are both
    children of every split (at most one root and 2 x tile a round) and
    their votes (a gain and an id, 12 bytes, for each of k features)
    cross too; at the exhaustive k the window children alone cross (one
    root and at most a tile a round: the flat merge in two levels).  The
    world axis carries scalars only; the all-feature merges stay inside
    slices (ici).  The vote forced at the exhaustive k crosses as below it."""
    _, outs = runs
    merge, k, _q, _key = CONFIGS[name]
    fd = F if merge == "psum" else -(-F // 2)  # the features a rank searches
    kk = min(k, fd)
    vote = k < fd or name.endswith("_vote")
    col = kk * B * 20
    for r in range(4):
        o = outs[r][name]
        dcn, ici, world = (o["stats"][a] for a in ("dcn", "ici", "world"))
        cands = dcn["merge_bytes"] // col
        assert dcn["merge_bytes"] == cands * col
        assert dcn["merges"] == o["rounds"] + 1
        per_round = 2 * TILE if vote else TILE
        assert 1 <= cands <= 1 + per_round * o["rounds"]
        votes = dcn["bytes"] - dcn["merge_bytes"]  # the all-gathered gains and ids
        assert votes == (cands * kk * 12 if vote else 0), (votes, cands)
        assert ici["merges"] == o["rounds"] + 1 and world["merges"] == 0
        assert world["bytes"] / max(world["collectives"], 1) < 64 * TILE


@pytest.mark.parametrize("merge", ["psum", "scatter"])
def test_forced_vote_at_full_topk_is_the_flat_tree_within_c19(runs, merge):
    """The vote at the exhaustive k elects every feature in ascending
    order, so it grows the flat tree's splits, thresholds, leaf counts and
    leaf ids.  Its slice-domain state is exact integer sums and its
    siblings integer differences, where the flat round subtracts f32
    parents: the leaf values part in the last bits (ROADMAP C19), held
    within 1e-5 of their magnitude.  It sends at least twice the dcn
    histogram bytes of the exhaustive path, which is why that k skips it."""
    trees, outs = runs
    name = f"{merge}_kF_vote"
    tree = _same_on_every_rank(trees[name])
    want, want_leaf = _flat(name)
    m = int(want["num_leaves"]) - 1
    assert int(tree["num_leaves"]) == m + 1 > 8
    for key in ("split_feature", "threshold_bin", "left_child", "right_child",
                "default_left", "leaf_count"):
        np.testing.assert_array_equal(tree[key], want[key], err_msg=key)
    np.testing.assert_array_equal(np.concatenate([r["leaf"] for r in trees[name]]),
                                  want_leaf)
    scale = float(np.abs(want["leaf_value"][:m + 1]).max())
    np.testing.assert_allclose(tree["leaf_value"], want["leaf_value"], rtol=0,
                               atol=1e-5 * scale)
    for r in range(4):
        vote = outs[r][name]["stats"]["dcn"]["merge_bytes"]
        flat = outs[r][f"{merge}_kF"]["stats"]["dcn"]["merge_bytes"]
        assert vote >= 2 * flat - F * B * 20, (vote, flat)


@pytest.mark.parametrize("name", ["psum_k3", "scatter_k3", "psum_kF_vote",
                                  "scatter_kF_vote"])
def test_plain_pv_tree_replay_holds_the_vote_path(runs, name):
    """chip_smoke.py's plain reference of the vote (each node's slice and
    global histograms from scratch, the vote, the elected search; the one
    the card holds its top-k 32 tree to) agrees with the port's vote-path
    trees at every node, bit for bit."""
    from chip_smoke import pv_tree_replay

    trees, _ = runs
    merge, k = CONFIGS[name][:2]
    bins, g, h, nbpf, mbpf = (torch.as_tensor(a) for a in _data())
    out = pv_tree_replay(bins, g, h, _same_on_every_rank(trees[name]),
                         np.concatenate([r["leaf"] for r in trees[name]]), nbpf, mbpf,
                         SplitParams(min_data_in_leaf=MIN_DATA), slices=2,
                         blocks=2 if merge == "scatter" else 1, top_k=k, num_bins=B)
    assert out["nodes"] > 8
    assert (out["split_mismatch"], out["count_mismatch"], out["leaf_gap"]) == (0, 0, 0.0)


def test_mesh_refuses_counts_that_do_not_divide_the_world(runs):
    _, outs = runs
    assert outs[0]["coords"] == [0, 0] and outs[3]["coords"] == [1, 1]
    errs = outs[0]["errors"]
    assert len(errs) == 2 and "do not divide" in errs[0] and "needs 6 ranks" in errs[1]
    with pytest.raises(ValueError, match=">= 1"):
        make_mesh_hierarchical(0)


def test_num_slices_trains_the_hierarchical_rounds_and_falls_back(runs):
    """lgb.train with num_slices 2 over 4 ranks (data: the all_reduce inside
    slices, voting: the reduce_scatter) takes the hierarchical rounds and,
    at top_k_features = F, grows the serial model's trees bit for bit;
    num_slices 3 warns and trains on the single-level mesh, the serial
    trees too."""
    _, outs = runs
    X, y = _train_data()
    serial = tlgb.train(TRAIN, tlgb.Dataset(X, label=y, params=TRAIN), ROUNDS)
    for key, hier, grower in (("data_2", True, "windowed_hier"),
                              ("voting_2", True, "windowed_hier"),
                              ("data_3", False, "windowed")):
        texts = [outs[r][f"train_{key}"]["text"] for r in range(4)]
        assert len(set(texts)) == 1
        o = outs[0][f"train_{key}"]
        assert o["hier"] is hier and o["growers"] == [grower] * ROUNDS
        assert _trees_of(texts[0]) == _trees_of(serial.model_to_string())


def test_hierarchical_refuses_per_node_sampling():
    bins, g, h, nbpf, mbpf = (torch.as_tensor(a) for a in _data())
    with pytest.raises(ValueError, match="per-node feature sampling"):
        grow_tree_windowed_hierarchical(None, g, h, torch.ones(N, dtype=torch.bool),
                                        torch.ones(N), torch.ones(F, dtype=torch.bool),
                                        num_leaves=L, num_bins=B,
                                        params=SplitParams(feature_fraction_bynode=0.5))
