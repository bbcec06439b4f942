"""The distributed tree learners of lightgbm_tpu_torch (parallel/) on gloo
loopback ranks, against the port's serial growers and the JAX package's
sharded growers on the 8-device CPU mesh tests/conftest.py provides.

Bars.  R ranks hold the serial histograms bit for bit (64-bit fixed-point
sums with the tree's global exponents, merged as integers), so the port's
data-parallel and feature-parallel trees are its serial trees bit for bit,
for the strict, rounds and windowed growers, psum and scatter merges,
megakernel on and off, float and int8.  Voting (PV-Tree) is not a serial
algorithm; it is held to the JAX package's voting tree.  Against the JAX
package's sharded trees the bar is the JAX package's own
(tests/test_distributed.py): splits exact, leaf values within 2e-3.  B3
unfused (round_cuda.round_partition_window_plain) against the JAX
megakernel with fuse_tail=False in Pallas interpret mode: the new order
bitwise, histograms within 1e-5 of their largest magnitude (f32 scatter
sums there, 64-bit fixed point here).

The ranks run as separate processes through parallel/launcher.py::run_spmd
(a FileStore rendezvous in a test temp directory, a wall limit under 90 s),
each running a script that imports only the port; one launch a world size
grows every configuration, and the tests read its results.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas
from jax.experimental.pallas import tpu as pltpu

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.ops.round_pallas import round_megakernel as jax_round
from lightgbm_tpu.ops.split import SplitParams as JParams
from lightgbm_tpu.parallel import data_parallel as jdp
from lightgbm_tpu.parallel import feature_parallel as jfp
from lightgbm_tpu.parallel.mesh import make_mesh as jmesh
from lightgbm_tpu_torch.ops import round_cuda
from lightgbm_tpu_torch.ops.hist_cuda import carry_convert
from lightgbm_tpu_torch.ops.partition import segment_ids
from lightgbm_tpu_torch.ops.split import SplitParams
from lightgbm_tpu_torch.ops.treegrow import grow_tree
from lightgbm_tpu_torch.ops.treegrow_fast import grow_tree_fast
from lightgbm_tpu_torch.ops.treegrow_windowed import grow_tree_windowed
from lightgbm_tpu_torch.parallel import distributed as tdist
from lightgbm_tpu_torch.parallel import mesh as tmesh
from lightgbm_tpu_torch.parallel.launcher import run_spmd
from lightgbm_tpu_torch.parallel.mesh import RowShard

N, F, B, L = 2400, 13, 32, 31  # F = 13: the scatter merge pads it at R = 2 and 4
MIN_DATA = 5
TOP_K = 3


def _data():
    rng = np.random.RandomState(11)
    bins = rng.randint(0, B, size=(N, F)).astype(np.int16)
    g = (rng.randn(N) + 1.5 * (bins[:, 0] > B // 2) + (bins[:, 3] < 6)
         - 0.8 * (bins[:, 7] > 20)).astype(np.float32)
    h = (0.5 + 0.5 * rng.rand(N)).astype(np.float32)
    nbpf = np.full(F, B, np.int32)
    mbpf = np.full(F, -1, np.int32)
    mbpf[2] = B - 1  # a missing bin
    return bins, g, h, nbpf, mbpf


# the configurations a launch grows: (grower, options)
CONFIGS = {
    "strict_data": ("strict", {}),
    "strict_voting": ("voting", {}),
    "feature": ("feature", {}),
    "rounds_f32": ("rounds", {"quantize_bins": 0}),
    "rounds_int8": ("rounds", {"quantize_bins": 31}),
}
for _mk in ("0", "1"):
    for _merge in ("psum", "scatter"):
        for _q in (0, 31):
            CONFIGS[f"win_{_merge}_mk{_mk}_q{_q}"] = (
                "windowed", {"merge": _merge, "megakernel_opt": _mk, "quantize_bins": _q})

_SCRIPT = r'''
import json, os
import numpy as np, torch
from lightgbm_tpu_torch.ops.split import SplitParams
from lightgbm_tpu_torch.parallel import data_parallel as DP, feature_parallel as FP
from lightgbm_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)  # R ranks share the host's cores
d = np.load(os.path.join(WORKDIR, "inputs.npz"))
cfg = json.load(open(os.path.join(WORKDIR, "configs.json")))
bins, g, h, nbpf, mbpf = (d[k] for k in ("bins", "g", "h", "nbpf", "mbpf"))
n, f = bins.shape
mesh = make_mesh()
per = -(-n // WORLD)
lo, hi = min(RANK * per, n), min((RANK + 1) * per, n)
T = torch.as_tensor
sd = DP.ShardedData(mesh, bins[lo:hi], nbpf, mbpf)
fsd = FP.FeatureShardedData(mesh, T(bins), nbpf, mbpf)
params = SplitParams(min_data_in_leaf=cfg["min_data"])
m = hi - lo
loc = (T(g[lo:hi]), T(h[lo:hi]), torch.ones(m, dtype=torch.bool), torch.ones(m),
       torch.ones(f, dtype=torch.bool))
out = {}
for name, (kind, opt) in cfg["configs"].items():
    common = dict(num_leaves=cfg["L"], num_bins=cfg["B"], params=params)
    gen = torch.Generator()
    gen.manual_seed(5)
    mesh.reset_stats()
    if kind == "strict":
        tree, leaf = DP.grow_tree_data_parallel(sd, *loc, **common)
    elif kind == "voting":
        tree, leaf = DP.grow_tree_data_parallel(sd, *loc, parallel_mode="voting",
                                                top_k=cfg["top_k"], **common)
    elif kind == "feature":
        tree, leaf = FP.grow_tree_feature_parallel(
            fsd, T(g), T(h), torch.ones(n, dtype=torch.bool), torch.ones(n),
            torch.ones(f, dtype=torch.bool), **common)
    elif kind == "rounds":
        tree, leaf = DP.grow_tree_fast_data_parallel(sd, *loc, generator=gen, leaf_tile=8,
                                                     **opt, **common)
    else:
        tree, leaf = DP.grow_tree_windowed_data_parallel(sd, *loc, generator=gen,
                                                         leaf_tile=8, **opt, **common)
    arrs = {k: v.numpy() for k, v in tree._asdict().items() if v is not None}
    np.savez(os.path.join(WORKDIR, f"{name}_r{RANK}.npz"), leaf=leaf.numpy(), **arrs)
    out[name] = dict(mesh.stats)
json.dump(out, open(os.path.join(WORKDIR, f"stats_r{RANK}.json"), "w"))
'''


def _serial(name):
    """The port's serial tree of a configuration (voting: None)."""
    kind, opt = CONFIGS[name]
    bins, g, h, nbpf, mbpf = (torch.as_tensor(a) for a in _data())
    args = (bins, g, h, torch.ones(N, dtype=torch.bool), torch.ones(N),
            torch.ones(F, dtype=torch.bool), nbpf, mbpf)
    common = dict(num_leaves=L, num_bins=B, params=SplitParams(min_data_in_leaf=MIN_DATA))
    gen = torch.Generator()
    gen.manual_seed(5)
    if kind in ("strict", "feature"):
        t, lf = grow_tree(*args, **common)[:2]
    elif kind == "rounds":
        t, lf = grow_tree_fast(*args, generator=gen, leaf_tile=8, **opt, **common)[:2]
    elif kind == "windowed":
        opt = {k: v for k, v in opt.items() if k != "merge"}
        t, lf = grow_tree_windowed(*args, generator=gen, leaf_tile=8, **opt, **common)
    else:
        return None
    return {k: v.numpy() for k, v in t._asdict().items() if v is not None}, lf.numpy()


def _launch(world, workdir):
    bins, g, h, nbpf, mbpf = _data()
    os.makedirs(workdir, exist_ok=True)
    np.savez(os.path.join(workdir, "inputs.npz"), bins=bins, g=g, h=h, nbpf=nbpf,
             mbpf=mbpf)
    with open(os.path.join(workdir, "configs.json"), "w") as fh:
        json.dump({"configs": CONFIGS, "L": L, "B": B, "min_data": MIN_DATA,
                   "top_k": TOP_K}, fh)
    run_spmd(_SCRIPT, world, workdir, timeout_s=85)
    res = {}
    for name in CONFIGS:
        ranks = [dict(np.load(os.path.join(workdir, f"{name}_r{r}.npz")))
                 for r in range(world)]
        res[name] = ranks
    stats = [json.load(open(os.path.join(workdir, f"stats_r{r}.json")))
             for r in range(world)]
    return res, stats


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One launch a world size (2 and 4 gloo ranks), every configuration."""
    return {w: _launch(w, str(tmp_path_factory.mktemp(f"spmd{w}"))) for w in (2, 4)}


def _rank_tree(ranks):
    """Rank 0's tree (every rank's must be the same) and the rows' leaf ids
    in global order."""
    t0 = {k: v for k, v in ranks[0].items() if k != "leaf"}
    for r in ranks[1:]:
        for k, v in t0.items():
            np.testing.assert_array_equal(r[k], v, err_msg=f"ranks disagree on {k}")
    return t0


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", [c for c in CONFIGS if c != "strict_voting"])
def test_sharded_tree_is_the_serial_tree_bitwise(runs, world, name):
    res, stats = runs[world]
    tree = _rank_tree(res[name])
    want, want_leaf = _serial(name)
    assert int(want["num_leaves"]) > 10
    for k, v in want.items():
        np.testing.assert_array_equal(tree[k], v, err_msg=k)
    if CONFIGS[name][0] == "feature":  # rows replicated: every rank has all
        np.testing.assert_array_equal(res[name][0]["leaf"], want_leaf)
    else:
        np.testing.assert_array_equal(np.concatenate([r["leaf"] for r in res[name]]),
                                      want_leaf)
    s = stats[0][name]
    if CONFIGS[name][0] in ("feature",):
        assert s["merges"] == 0 and s["collectives"] > 0
    else:  # one exact merge a histogram pass: the root and every step/round
        assert s["merges"] > 1 and s["merge_bytes"] > 0


@pytest.mark.parametrize("world", [2, 4])
def test_scatter_merge_pads_undivisible_features(runs, world):
    """F = 13 pads to a multiple of R: no pad feature ever wins a split,
    and the scatter tree is the psum tree (both the serial one)."""
    res, _ = runs[world]
    assert F % world
    for mk in ("0", "1"):
        ps = _rank_tree(res[f"win_psum_mk{mk}_q0"])
        sc = _rank_tree(res[f"win_scatter_mk{mk}_q0"])
        m = int(sc["num_leaves"]) - 1
        assert sc["split_feature"][:m].max() < F
        for k in ps:
            np.testing.assert_array_equal(sc[k], ps[k], err_msg=k)


def test_scatter_merge_refuses_per_node_sampling():
    bins, g, h, nbpf, mbpf = (torch.as_tensor(a) for a in _data())
    rng_key = torch.rand((2 * L - 1, 2, F))
    with pytest.raises(ValueError, match="scatter"):
        grow_tree_windowed(bins, g, h, torch.ones(N, dtype=torch.bool), torch.ones(N),
                           torch.ones(F, dtype=torch.bool), nbpf, mbpf, num_leaves=L,
                           num_bins=B, rng_key=rng_key, axis_name=RowShard(None, 0, N),
                           merge="scatter")


# ---------------------------------------------------------------------------
# against the JAX package's sharded trees (its bar)
# ---------------------------------------------------------------------------
def _jax_tree(world, name):
    kind, opt = CONFIGS[name]
    bins, g, h, nbpf, mbpf = _data()
    mesh = jmesh(world)
    p = JParams(min_data_in_leaf=MIN_DATA)
    common = dict(num_leaves=L, num_bins=B, params=p)
    fm = jnp.ones((F,), bool)
    if kind == "feature":
        fsd = jfp.FeatureShardedData(mesh, bins.astype(np.int32), nbpf, mbpf)
        t, _ = jfp.grow_tree_feature_parallel(
            fsd, jnp.asarray(g), jnp.asarray(h), jnp.ones(N, bool), jnp.ones(N),
            np.ones(F, bool), **common)
        return t
    sd = jdp.ShardedData(mesh, bins.astype(np.int32), nbpf, mbpf)
    args = (sd, sd.pad_rows(g), sd.pad_rows(h), sd.row_valid,
            sd.pad_rows(np.ones(N, np.float32), fill=1.0), fm)
    if kind in ("strict", "voting"):
        t, _ = jdp.grow_tree_data_parallel(
            *args, parallel_mode="data" if kind == "strict" else "voting", top_k=TOP_K,
            **common)
    elif kind == "rounds":
        t, _ = jdp.grow_tree_fast_data_parallel(*args, leaf_tile=8, use_pallas=False,
                                                **common)
    else:
        t, _ = jdp.grow_tree_windowed_data_parallel(*args, leaf_tile=8, use_pallas=False,
                                                    merge=opt["merge"], **common)
    return t


def _assert_jax_bar(port, jt):
    """The JAX package's bar (tests/test_distributed.py): the same nodes,
    leaf values within 2e-3."""
    assert int(port["num_leaves"]) == int(jt.num_leaves)
    m = int(jt.num_leaves) - 1
    for name in ("split_feature", "threshold_bin", "default_left", "left_child",
                 "right_child"):
        np.testing.assert_array_equal(port[name][:m], np.asarray(getattr(jt, name))[:m],
                                      err_msg=name)
    np.testing.assert_allclose(port["leaf_value"][:m + 1],
                               np.asarray(jt.leaf_value)[:m + 1], atol=2e-3, rtol=0)


@pytest.mark.parametrize("world,name", [
    (2, "strict_data"), (2, "strict_voting"), (2, "feature"), (2, "rounds_f32"),
    (2, "win_psum_mk0_q0"), (2, "win_scatter_mk0_q0"), (4, "strict_data"),
    (4, "win_psum_mk1_q0"),
])
def test_sharded_tree_meets_the_jax_sharded_bar(runs, world, name):
    res, _ = runs[world]
    _assert_jax_bar(_rank_tree(res[name]), _jax_tree(world, name))


# ---------------------------------------------------------------------------
# B3 unfused against the JAX megakernel with fuse_tail=False
# ---------------------------------------------------------------------------
def _round_geometry(seed, n=1200, f=6, T=4):
    rng = np.random.RandomState(seed)
    bins = torch.from_numpy(rng.randint(0, B, (n, f)).astype(np.int16))
    order = torch.from_numpy(rng.permutation(n).astype(np.int32))
    go = torch.from_numpy(rng.rand(n) < 0.4)
    go[500:600] = True  # an all-left segment
    seg_start = torch.tensor([0, 500, 700, 700], dtype=torch.int32)[:T]
    seg_len = torch.tensor([400, 100, 0, 450], dtype=torch.int32)[:T]  # one empty
    sid = segment_ids(seg_start, seg_len, n)
    n_left = torch.stack([(go & (sid == s)).sum() for s in range(T)]).to(torch.int32)
    small_left = (2 * n_left <= seg_len).to(torch.int32)
    win_start = torch.where(small_left > 0, seg_start, seg_start + n_left)
    win_cnt = torch.where(small_left > 0, n_left, seg_len - n_left)
    grad = torch.from_numpy(rng.randn(n).astype(np.float32))
    hess = torch.from_numpy((0.2 + rng.rand(n)).astype(np.float32))
    mask = torch.from_numpy(rng.rand(n) < 0.9)
    return (bins, order, go, grad, hess, mask, seg_start, seg_len, n_left, win_start,
            win_cnt), small_left, sid


@pytest.mark.parametrize("seed", [0, 1])
def test_unfused_plain_matches_jax_fuse_tail_false(monkeypatch, seed):
    call = pallas.pallas_call
    monkeypatch.setattr(pallas, "pallas_call",
                        lambda *a, **k: call(*a, **{**k, "interpret": True}))
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                            raising=False)
    args, small_left, sid = _round_geometry(seed)
    n, T = args[0].shape[0], args[6].shape[0]
    W = 1 << 11
    shift = torch.tensor([40, 40], dtype=torch.int32)
    round_cuda.reset_counts()
    order, acc64, acc32 = round_cuda.round_partition_window(*args, num_bins=B, W=W,
                                                            shift=shift)
    assert round_cuda.plain_calls["round_megakernel_unfused"] == 1
    hist = carry_convert(acc64, acc32, shift)
    ja = [jnp.asarray(a.numpy()) for a in args]
    raw, fresh = jax_round(jnp.asarray(args[0].numpy().T.copy()), *ja[1:],
                           jnp.asarray(small_left.numpy()), num_bins=B, leaf_tile=T,
                           fuse_tail=False, interpret=True)
    want_order = np.where(sid.numpy() >= 0, np.asarray(raw), args[1].numpy())
    np.testing.assert_array_equal(order.numpy(), want_order)
    fresh = np.asarray(fresh)
    assert fresh.shape == tuple(hist.shape)
    np.testing.assert_allclose(hist.numpy(), fresh, rtol=0,
                               atol=1e-5 * max(np.abs(fresh).max(), 1.0))


# ---------------------------------------------------------------------------
# set-up: the serial run's bins on every rank, on the card as on the host
# ---------------------------------------------------------------------------
def test_greedy_bounds_match_the_jax_package():
    """binning.py's greedy equal-count bounds, taken a bin at a time (A25:
    fitting 2000 columns in seconds), are the JAX package's bit for bit."""
    from lightgbm_tpu.binning import _greedy_equal_count_bounds as jax_bounds
    from lightgbm_tpu_torch.binning import _greedy_equal_count_bounds as port_bounds

    rng = np.random.RandomState(0)
    for t in range(400):
        n = rng.randint(300, 8000)
        v = (rng.randn(n), np.round(rng.randn(n) * rng.choice([1, 3, 30])),
             np.where(rng.rand(n) < rng.rand(), 0.0, rng.randn(n)),
             np.concatenate([np.full(rng.randint(1, n), 1.5), rng.randn(n)]),
             rng.randint(0, rng.randint(2, 900), n).astype(float))[t % 5]
        sv, c = np.unique(v, return_counts=True)
        mb, md = int(rng.choice([2, 15, 63, 255])), int(rng.choice([1, 3, 20]))
        np.testing.assert_array_equal(port_bounds(sv, c, mb, md, int(c.sum())),
                                      jax_bounds(sv, c, mb, md, int(c.sum())))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_torch_binning_is_the_numpy_binning(dtype):
    """DatasetBinner.transform_torch (the card's binning, run here on the
    CPU device) against the numpy transform: NaN, zeros as missing,
    infinities, a categorical column, float32 and float64 input, chunked."""
    from lightgbm_tpu_torch.binning import DatasetBinner

    rng = np.random.RandomState(1)
    X = rng.randn(4000, 9).astype(dtype)
    X[rng.rand(4000, 9) < 0.05] = np.nan
    X[:, 2] = np.where(rng.rand(4000) < 0.4, 0.0, X[:, 2])
    X[:, 5] = rng.randint(0, 7, 4000)
    X[0, 7], X[1, 7] = np.inf, -np.inf
    for kw in ({}, {"zero_as_missing": True}, {"use_missing": False}):
        b = DatasetBinner.fit(X, max_bin=31, categorical_features=[5], **kw)
        np.testing.assert_array_equal(b.transform_torch(X, "cpu", chunk_bytes=20_000),
                                      b.transform(X))


def test_sync_binning_sample_is_the_serial_sample(tmp_path):
    """Two gloo ranks holding consecutive halves of the rows gather exactly
    the rows DatasetBinner.fit would sample from all of them, so every rank
    fits the serial binner."""
    from lightgbm_tpu_torch.binning import DatasetBinner

    rng = np.random.RandomState(2)
    X = rng.randn(3000, 5)
    np.save(tmp_path / "X.npy", X)
    script = (
        "import os, numpy as np, torch\n"
        "from lightgbm_tpu_torch.basic import _sync_binning_sample\n"
        "X = np.load(os.path.join(WORKDIR, 'X.npy'))\n"
        "half = X[:1400] if RANK == 0 else X[1400:]\n"
        "s = _sync_binning_sample(half, 1000, 4, torch.device('cpu'))\n"
        "np.save(os.path.join(WORKDIR, f's{RANK}.npy'), s)\n")
    run_spmd(script, 2, str(tmp_path), timeout_s=80)
    idx = np.sort(np.random.RandomState(4).choice(3000, 1000, replace=False))
    for r in range(2):
        np.testing.assert_array_equal(np.load(tmp_path / f"s{r}.npy"), X[idx])
    serial = DatasetBinner.fit(X, sample_cnt=1000, seed=4)
    synced = DatasetBinner.fit(X[idx], sample_cnt=1000, seed=4)
    for a, b in zip(serial.mappers, synced.mappers):
        np.testing.assert_array_equal(a.upper_bounds, b.upper_bounds)


# ---------------------------------------------------------------------------
# bring-up, and what stays for A13b
# ---------------------------------------------------------------------------
def test_init_distributed_parses_machines_and_detects_rank(tmp_path, monkeypatch):
    from lightgbm_tpu_torch.config import Config

    cfg = Config.from_dict({"machines": "127.0.0.1:1201, 127.0.0.1:1202,127.0.0.1",
                            "local_listen_port": 1202, "num_machines": 3})
    machines = tdist._parse_machines(cfg)
    assert machines == [("127.0.0.1", 1201), ("127.0.0.1", 1202), ("127.0.0.1", 1202)]
    monkeypatch.delenv("LIGHTGBM_TPU_RANK", raising=False)
    assert tdist.detect_rank(cfg, machines[:2]) == 1
    monkeypatch.setenv("LIGHTGBM_TPU_RANK", "0")
    assert tdist.detect_rank(cfg, machines) == 0
    monkeypatch.delenv("LIGHTGBM_TPU_RANK")
    mlist = tmp_path / "mlist.txt"
    mlist.write_text("# two machines\n127.0.0.1 1301\n127.0.0.1 1302\n")
    cfg2 = Config.from_dict({"machine_list_filename": str(mlist),
                             "local_listen_port": 1301, "num_machines": 2})
    assert tdist._parse_machines(cfg2) == [("127.0.0.1", 1301), ("127.0.0.1", 1302)]
    assert tdist.detect_rank(cfg2, tdist._parse_machines(cfg2)) == 0
    with pytest.raises(ValueError, match="none matches"):
        tdist.detect_rank(Config.from_dict({"local_listen_port": 9}),
                          [("127.0.0.1", 1), ("localhost", 2)])
    # one machine: nothing to bring up; a wrong count raises
    assert tdist.init_distributed(Config.from_dict({"num_machines": 1})) is False
    with pytest.raises(ValueError, match="entries"):
        tdist.init_distributed(Config.from_dict({"num_machines": 2,
                                                 "machines": "127.0.0.1:1"}))
    assert tdist.backend_for(Config.from_dict({"device_type": "cpu"})) == "gloo"
    assert tdist.backend_for(Config.from_dict({})) == "nccl"
    assert tdist.backend_for(Config.from_dict({"dist_backend": "gloo"})) == "gloo"


@pytest.mark.parametrize("params", [{"tree_learner": "feature2d"}, {"num_slices": 2}])
def test_feature2d_and_num_slices_raise_citing_a13b(params):
    """tree_learner=feature2d and num_slices > 1 are ported (ROADMAP A13b,
    tests/test_torch_feature2d.py and test_torch_hierarchy.py); in one
    process they train the serial model, as the JAX package's learners do
    on one device."""
    rng = np.random.RandomState(0)
    X = rng.randn(200, 4)
    p = {"objective": "regression", "device_type": "cpu", "verbosity": -1}
    want = tlgb.train(p, tlgb.Dataset(X, label=X[:, 0], params=p), 2).model_to_string()
    got = tlgb.train({**p, **params}, tlgb.Dataset(X, label=X[:, 0], params=p), 2)
    assert got._gbdt._dp is None and got._gbdt._dp2d is None and got._gbdt._dp_hier is None
    cut = lambda t: t[t.index("Tree=0"):t.index("end of trees")]  # noqa: E731
    assert cut(got.model_to_string()) == cut(want)


def test_2d_and_hierarchical_meshes_and_predict_mesh_raise_citing_a13b():
    """The 2-D and hierarchical meshes are subgroups of an initialized
    world (without one they refuse, and a slice count below 1 is refused
    first); predict(mesh=) over a device mesh is predict bit for bit."""
    with pytest.raises(RuntimeError, match="initialized"):
        tmesh.make_mesh_2d(2, 2)
    with pytest.raises(ValueError, match=">= 1"):
        tmesh.make_mesh_hierarchical(0)
    rng = np.random.RandomState(0)
    X = rng.randn(200, 4)
    p = {"objective": "regression", "device_type": "cpu", "verbosity": -1}
    bst = tlgb.train(p, tlgb.Dataset(X, label=X[:, 0], params=p), 2)
    np.testing.assert_array_equal(bst.predict(X, mesh=tmesh.make_device_mesh(["cpu"] * 2)),
                                  bst.predict(X))
