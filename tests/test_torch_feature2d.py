"""The 2-D (data, feature) mesh of lightgbm_tpu_torch (parallel/feature2d.py)
on gloo loopback ranks, against the port's serial windowed grower and the
JAX package's grow_tree_windowed_feature2d on the 8-device CPU mesh
tests/conftest.py provides.

Bars.  The rank at (i, j) of a d_r x d_f mesh holds row block i and feature
block j; its window histograms are its block of the serial ones bit for
bit (B1's fixed-point sums merged exactly over the data axis) and the
winner is elected over the feature axis, so the 2-D tree is the port's
serial windowed tree bit for bit, float and int8, at 2 x 2 and 1 x 4.  The
histogram phase never crosses the feature axis: the feature axis carries
no merge and less than one histogram block a round (the port's version of
the JAX package's ``windowed_round_2d_*`` jaxpr contracts, which cannot run
under the installed JAX).  Against the JAX package's 2-D tree the bar is
its own (tests/test_feature2d.py): splits exact, leaf values within 2e-3,
leaf ids equal.

One run_spmd launch of 4 ranks grows every configuration, and each rank
also trains lgb.train with tree_learner=feature2d on its row block
(num_feature_shards 2, and 3, which does not divide 4 ranks); one
train_distributed launch holds the launcher's row-block plan.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.ops.split import SplitParams as JParams
from lightgbm_tpu.parallel.feature2d import Sharded2DData as JSharded2D
from lightgbm_tpu.parallel.feature2d import grow_tree_windowed_feature2d as jgrow2d
from lightgbm_tpu.parallel.mesh import make_mesh_2d as jmesh2d
from lightgbm_tpu_torch.ops.split import SplitParams
from lightgbm_tpu_torch.ops.treegrow_windowed import grow_tree_windowed
from lightgbm_tpu_torch.parallel.feature2d import grow_tree_windowed_feature2d
from lightgbm_tpu_torch.parallel.launcher import run_spmd, train_distributed

from test_torch_distributed import B, F, L, MIN_DATA, N, _data

TILE = 8
# (d_r, d_f, quantize_bins, stochastic rounding)
CONFIGS = {"2x2_q0": (2, 2, 0, True), "2x2_q31": (2, 2, 31, True),
           "1x4_q0": (1, 4, 0, True), "1x4_q31": (1, 4, 31, True),
           "2x2_q16det": (2, 2, 16, False)}
TRAIN = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 10,
         "device_type": "cpu", "verbosity": -1, "tree_growth_mode": "windowed",
         "bin_construct_sample_cnt": 1000}
ROUNDS = 3

_SCRIPT = r'''
import json, os
import numpy as np, torch
import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch.ops.split import SplitParams
from lightgbm_tpu_torch.parallel.feature2d import Sharded2DData, grow_tree_windowed_feature2d
from lightgbm_tpu_torch.parallel.mesh import make_mesh_2d

torch.set_num_threads(1)
d = np.load(os.path.join(WORKDIR, "inputs.npz"))
cfg = json.load(open(os.path.join(WORKDIR, "configs.json")))
bins, g, h, nbpf, mbpf = (d[k] for k in ("bins", "g", "h", "nbpf", "mbpf"))
n, f = bins.shape
T = torch.as_tensor
params = SplitParams(min_data_in_leaf=cfg["min_data"])
out = {}
meshes = {}
for name, (dr, df, q, stoch) in cfg["configs"].items():
    if (dr, df) not in meshes:  # every rank makes every mesh, in one order
        meshes[dr, df] = make_mesh_2d(dr, df)
    mesh = meshes[dr, df]
    per = -(-n // dr)
    lo, hi = mesh.coords[0] * per, min((mesh.coords[0] + 1) * per, n)
    sd = Sharded2DData(mesh, bins[lo:hi], nbpf, mbpf)
    gen = torch.Generator()
    gen.manual_seed(5)
    mesh.reset_stats()
    m = hi - lo
    st = {}
    tree, leaf = grow_tree_windowed_feature2d(
        sd, T(g[lo:hi]), T(h[lo:hi]), torch.ones(m, dtype=torch.bool), torch.ones(m),
        torch.ones(f, dtype=torch.bool), generator=gen, num_leaves=cfg["L"],
        num_bins=cfg["B"], params=params, leaf_tile=cfg["tile"], quantize_bins=q,
        stochastic_rounding=stoch, quant_renew=not stoch, stats=st)
    arrs = {k: v.numpy() for k, v in tree._asdict().items() if v is not None}
    np.savez(os.path.join(WORKDIR, f"{name}_r{RANK}.npz"), leaf=leaf.numpy(), **arrs)
    out[name] = dict(stats=json.loads(json.dumps(mesh.stats)), rounds=st["rounds"],
                     f_pad=sd.f_pad, k=sd.k, n_loc=m, rows=[lo, hi],
                     megakernel=bool(st["megakernel"]), host_syncs=st["host_syncs"])
# lgb.train on this rank's row block: tree_learner=feature2d over the world
X, y = d["X"], d["y"]
for shards in (2, 3):
    blocks = WORLD // shards if WORLD % shards == 0 else WORLD
    block = RANK // shards if WORLD % shards == 0 else RANK
    per = -(-len(X) // blocks)
    lo, hi = block * per, min((block + 1) * per, len(X))
    p = dict(cfg["train"], tree_learner="feature2d", num_feature_shards=shards,
             pre_partition=True)
    bst = lgb.train(p, lgb.Dataset(X[lo:hi], label=y[lo:hi], params=p), cfg["rounds"])
    gb = bst._gbdt
    out[f"train_{shards}"] = dict(
        text=bst.model_to_string(), growers=[s["grower"] for s in gb.round_stats],
        grid=gb._dp2d is not None,
        stats=json.loads(json.dumps(gb._dp2d.mesh.stats)) if gb._dp2d is not None else None)
json.dump(out, open(os.path.join(WORKDIR, f"out_r{RANK}.json"), "w"))
'''


def _train_data(n=2400, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 9)
    X[rng.rand(n) < 0.05, 2] = np.nan
    y = ((X[:, 0] + X[:, 1] * X[:, 3] + 0.3 * rng.randn(n)) > 0).astype(float)
    return X, y


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One launch of 4 gloo ranks: every configuration, and lgb.train."""
    wd = str(tmp_path_factory.mktemp("f2d"))
    bins, g, h, nbpf, mbpf = _data()
    X, y = _train_data()
    np.savez(os.path.join(wd, "inputs.npz"), bins=bins, g=g, h=h, nbpf=nbpf, mbpf=mbpf,
             X=X, y=y)
    with open(os.path.join(wd, "configs.json"), "w") as fh:
        json.dump({"configs": CONFIGS, "L": L, "B": B, "min_data": MIN_DATA,
                   "tile": TILE, "train": TRAIN, "rounds": ROUNDS}, fh)
    run_spmd(_SCRIPT, 4, wd, timeout_s=85)
    trees = {name: [dict(np.load(os.path.join(wd, f"{name}_r{r}.npz"))) for r in range(4)]
             for name in CONFIGS}
    outs = [json.load(open(os.path.join(wd, f"out_r{r}.json"))) for r in range(4)]
    return trees, outs


def _serial(q, stoch=True):
    bins, g, h, nbpf, mbpf = (torch.as_tensor(a) for a in _data())
    gen = torch.Generator()
    gen.manual_seed(5)
    t, lf = grow_tree_windowed(bins, g, h, torch.ones(N, dtype=torch.bool), torch.ones(N),
                               torch.ones(F, dtype=torch.bool), nbpf, mbpf, num_leaves=L,
                               num_bins=B, params=SplitParams(min_data_in_leaf=MIN_DATA),
                               leaf_tile=TILE, generator=gen, quantize_bins=q,
                               stochastic_rounding=stoch, quant_renew=not stoch)
    return {k: v.numpy() for k, v in t._asdict().items() if v is not None}, lf.numpy()


def _same_on_every_rank(ranks):
    t0 = {k: v for k, v in ranks[0].items() if k != "leaf"}
    for r in ranks[1:]:
        for k, v in t0.items():
            np.testing.assert_array_equal(r[k], v, err_msg=f"ranks disagree on {k}")
    return t0


def _leaf_ids(ranks, outs, name):
    """The rows' leaf ids in global order: each row block's from its first
    rank (the ranks of a block agree)."""
    d_r, d_f = CONFIGS[name][:2]
    for r in range(4):
        np.testing.assert_array_equal(ranks[r]["leaf"], ranks[r - r % d_f]["leaf"])
    return np.concatenate([ranks[i * d_f]["leaf"] for i in range(d_r)])


@pytest.mark.parametrize("name", ["2x2_q0", "2x2_q31", "1x4_q0", "1x4_q31"])
def test_2d_tree_is_the_serial_windowed_tree_bitwise(runs, name):
    trees, outs = runs
    tree = _same_on_every_rank(trees[name])
    want, want_leaf = _serial(CONFIGS[name][2])
    assert int(want["num_leaves"]) > 10
    for k, v in want.items():
        np.testing.assert_array_equal(tree[k], v, err_msg=k)
    np.testing.assert_array_equal(_leaf_ids(trees[name], outs, name), want_leaf)
    o = outs[0][name]
    assert not o["megakernel"] and o["host_syncs"] == 1  # three-pass, one read a tree


@pytest.mark.parametrize("name", ["2x2_q0", "1x4_q31"])
def test_2d_histogram_phase_never_crosses_the_feature_axis(runs, name):
    """The feature axis carries no histogram merge and, a round, less than
    one f32 histogram block (T, 3, F / d_f, B): its traffic is the go-left
    broadcast (N / d_r int32) and the election's scalars."""
    _, outs = runs
    for r in range(4):
        o = outs[r][name]
        feat, data = o["stats"]["feature"], o["stats"]["data"]
        assert feat["merges"] == 0 and feat["merge_bytes"] == 0
        assert data["merges"] == o["rounds"] + 1  # the root and every round
        block = TILE * 3 * o["k"] * B * 4
        go_left = o["n_loc"] * 4
        assert feat["bytes"] <= (o["rounds"] + 1) * (go_left + block // 4), feat
        assert feat["bytes"] < (o["rounds"] + 1) * block + 1, feat


def test_padded_features_never_split(runs):
    """F = 13 pads to 14 at d_f 2 and to 16 at d_f 4: no pad wins."""
    trees, outs = runs
    assert outs[0]["2x2_q0"]["f_pad"] == 14 and outs[0]["1x4_q0"]["f_pad"] == 16
    for name in CONFIGS:
        t = trees[name][0]
        m = int(t["num_leaves"]) - 1
        assert m > 0 and t["split_feature"][:m].max() < F


@pytest.mark.parametrize("name", ["2x2_q0", "2x2_q16det"])
def test_2d_tree_meets_the_jax_feature2d_bar(runs, name):
    trees, outs = runs
    d_r, d_f, q, _ = CONFIGS[name]
    bins, g, h, nbpf, mbpf = _data()
    sd = JSharded2D(jmesh2d(d_r, d_f), bins, nbpf, mbpf)
    kw = dict(num_leaves=L, num_bins=B, params=JParams(min_data_in_leaf=MIN_DATA),
              leaf_tile=TILE, use_pallas=False)
    if q:  # deterministic rounding: the same int8 gradients in both packages
        kw.update(quantize_bins=q, stochastic_rounding=False, quant_renew=True)
    jt, jleaf = jgrow2d(
        sd, sd.pad_rows_device(g, jnp.float32), sd.pad_rows_device(h, jnp.float32),
        sd.row_valid, sd.pad_rows_device(np.ones(N, np.float32), jnp.float32, fill=1.0),
        jnp.ones((F,), bool), quant_key=jax.random.PRNGKey(3) if q else None, **kw)
    port = _same_on_every_rank(trees[name])
    assert int(port["num_leaves"]) == int(jt.num_leaves)
    m = int(jt.num_leaves) - 1
    for k in ("split_feature", "threshold_bin", "left_child", "right_child",
              "default_left"):
        np.testing.assert_array_equal(port[k][:m], np.asarray(getattr(jt, k))[:m],
                                      err_msg=k)
    np.testing.assert_allclose(port["leaf_value"][:m + 1],
                               np.asarray(jt.leaf_value)[:m + 1], rtol=2e-3, atol=2e-3)
    np.testing.assert_array_equal(_leaf_ids(trees[name], outs, name),
                                  np.asarray(jleaf)[:N])


def _trees_of(text: str) -> str:
    return text[text.index("Tree=0"):text.index("end of trees")]


def test_feature2d_trains_the_serial_model_and_falls_back_when_shards_do_not_divide(runs):
    """lgb.train with tree_learner=feature2d on each rank's row block: at
    num_feature_shards 2 over 4 ranks the 2-D rounds give the serial
    windowed model's trees; at 3, which does not divide 4, the JAX
    package's warning and the single-level row mesh (its windowed data-
    parallel rounds), the serial trees too."""
    _, outs = runs
    X, y = _train_data()
    serial = tlgb.train(TRAIN, tlgb.Dataset(X, label=y, params=TRAIN), ROUNDS)
    want = _trees_of(serial.model_to_string())
    for shards, grid, grower in ((2, True, "windowed_2d"), (3, False, "windowed")):
        texts = [outs[r][f"train_{shards}"]["text"] for r in range(4)]
        assert len(set(texts)) == 1
        assert _trees_of(texts[0]) == want
        o = outs[0][f"train_{shards}"]
        assert o["grid"] is grid and o["growers"] == [grower] * ROUNDS
    st = outs[0]["train_2"]["stats"]
    assert st["feature"]["merges"] == 0 and st["data"]["merges"] > 0


def test_train_distributed_plans_row_blocks_for_feature2d():
    """The launcher gives the d_f ranks of a row of the 2-D mesh the same
    row block; the fleet's model is the serial windowed model."""
    X, y = _train_data(n=1600, seed=4)
    p = {**TRAIN, "use_quantized_grad": True}
    serial = tlgb.train(p, tlgb.Dataset(X, label=y, params=p), 2)
    bst, paths = train_distributed({**p, "tree_learner": "feature2d",
                                    "num_feature_shards": 2}, X, y, 2, num_machines=4,
                                   timeout_s=85)
    texts = [open(pth).read() for pth in paths]
    assert len(set(texts)) == 1
    assert _trees_of(texts[0]) == _trees_of(serial.model_to_string())
    meta = bst._distributed_meta
    assert [s["grower"] for s in meta["round_stats"]] == ["windowed_2d"] * 2
    assert meta["mesh_2d_stats"]["feature"]["merges"] == 0


def test_feature2d_refuses_per_node_sampling():
    bins, g, h, nbpf, mbpf = (torch.as_tensor(a) for a in _data())
    with pytest.raises(ValueError, match="per-node feature sampling"):
        grow_tree_windowed_feature2d(None, g, h, torch.ones(N, dtype=torch.bool),
                                     torch.ones(N), torch.ones(F, dtype=torch.bool),
                                     num_leaves=L, num_bins=B,
                                     params=SplitParams(feature_fraction_bynode=0.5))
