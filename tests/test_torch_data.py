"""Data input parity: lightgbm_tpu_torch's sparse, arrow, Sequence_ and
text-file input, two-round loading, forced bins and the save_binary bin
cache against the JAX package's (mirroring tests/test_binning.py,
test_sparse.py, test_arrow.py, test_two_round.py and test_forcedbins.py).

Binning is the same numpy code in both packages, so every comparison of
bins, mappers and parsed values is exact; predictions on CSR rows equal
those on the same rows dense, bit for bit.
"""

import json

import numpy as np
import pytest
import scipy.sparse as sp

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.binning import DatasetBinner as JBinner
from lightgbm_tpu.io import parser as jparser
from lightgbm_tpu_torch import native
from lightgbm_tpu_torch.binning import DatasetBinner as TBinner
from lightgbm_tpu_torch.io import parser as tparser
from lightgbm_tpu_torch.io.stream import CorruptBinCacheError, read_bin_cache

CPU = {"device_type": "cpu", "verbosity": -1}


def _sparse(n=3000, f=24, seed=0):
    """CSR rows with ~4 stored values each: positive, negative, a few NaN."""
    rng = np.random.RandomState(seed)
    rows = np.repeat(np.arange(n), 4)
    cols = rng.randint(0, f, 4 * n)
    vals = rng.randn(4 * n) * 2.0
    vals[rng.rand(4 * n) < 0.02] = np.nan
    X = sp.csr_matrix((vals, (rows, cols)), shape=(n, f))
    X.sum_duplicates()
    y = np.nan_to_num(np.asarray(X[:, :4].sum(axis=1)).ravel()) + 0.1 * rng.randn(n)
    return X, y


def _same_mappers(a, b):
    assert len(a.mappers) == len(b.mappers)
    for ma, mb in zip(a.mappers, b.mappers):
        np.testing.assert_array_equal(ma.upper_bounds, mb.upper_bounds)
        assert (ma.missing_type, ma.is_categorical) == (mb.missing_type, mb.is_categorical)


@pytest.mark.parametrize("sample_cnt", [200_000, 1000])
def test_sparse_binner_matches_jax_and_dense(sample_cnt):
    """fit_sparse / transform_sparse against the JAX package's, and (when
    every row is in the sample) against the dense binner."""
    X, _ = _sparse()
    csc = X.tocsc()
    kw = dict(max_bin=63, sample_cnt=sample_cnt, seed=3)
    tb, jb = TBinner.fit_sparse(csc, **kw), JBinner.fit_sparse(csc, **kw)
    _same_mappers(tb, jb)
    bins = tb.transform_sparse(csc)
    np.testing.assert_array_equal(bins, jb.transform_sparse(csc))
    if sample_cnt >= X.shape[0]:
        dense = TBinner.fit(X.toarray(), **kw)
        _same_mappers(tb, dense)
        np.testing.assert_array_equal(bins, dense.transform(X.toarray()))


@pytest.mark.parametrize("enable_sparse", [True, False])
def test_sparse_dataset_bins_like_jax_without_densifying(enable_sparse):
    """Dataset(CSR): the JAX package's bins and the dense input's; with
    is_enable_sparse (the default) the raw matrix is never densified."""
    X, y = _sparse()
    want = jlgb.Dataset(X.toarray(), label=y).construct()
    if enable_sparse:
        def boom(*a, **k):
            raise AssertionError("sparse input was densified")
        X.toarray = X.todense = boom
    p = {**CPU, "is_enable_sparse": enable_sparse}
    ds = tlgb.Dataset(X, label=y, params=p).construct()
    np.testing.assert_array_equal(ds.bins, np.asarray(want.bins))
    _same_mappers(ds.binner, want.binner)
    assert ds.bins.dtype == np.uint8 and ds.feature_names == want.feature_names


@pytest.mark.parametrize("sparse_input", [False, True])
def test_forced_bins_match_jax(tmp_path, sparse_input):
    """forcedbins_filename: the JAX package's mappers, the forced bound in
    them, and a root split at the forced class edge."""
    rng = np.random.RandomState(2)
    X = rng.randn(1500, 3)
    X[rng.rand(1500, 3) < 0.5] = 0.0
    y = (X[:, 0] > 0.5).astype(float)
    path = tmp_path / "forced.json"
    path.write_text(json.dumps([{"feature": 0, "bin_upper_bound": [0.5]},
                                {"feature": 2, "bin_upper_bound": [-1.0, 1.0]}]))
    data = sp.csr_matrix(X) if sparse_input else X
    p = {"objective": "binary", "num_leaves": 4, "forcedbins_filename": str(path),
         "verbosity": -1}
    jd = jlgb.Dataset(data, label=y, params=p).construct()
    td = tlgb.Dataset(data, label=y, params={**p, **CPU}).construct()
    _same_mappers(td.binner, jd.binner)
    np.testing.assert_array_equal(td.bins, np.asarray(jd.bins))
    assert 0.5 in td.binner.mappers[0].upper_bounds
    assert np.isin([-1.0, 1.0], td.binner.mappers[2].upper_bounds).all()
    roots = [b.dump_model()["tree_info"][0]["tree_structure"] for b in (
        tlgb.train({**p, **CPU}, td, 3), jlgb.train(p, jd, 3))]
    assert roots[0]["split_feature"] == roots[1]["split_feature"] == 0
    assert roots[0]["threshold"] == roots[1]["threshold"]


def test_arrow_input_matches_jax():
    """pyarrow tables: numeric, null, boolean and dictionary columns across
    chunks bin as in the JAX package, names from the schema."""
    pa = pytest.importorskip("pyarrow")
    rng = np.random.RandomState(4)
    n = 800
    a = rng.randn(n)
    b = pa.array([None if i % 7 == 0 else float(v) for i, v in enumerate(rng.randn(n))])
    c = rng.rand(n) < 0.3
    d = pa.array(rng.choice(["x", "y", "z"], n)).dictionary_encode()
    t = pa.table({"a": a, "b": b, "c": c, "d": d})
    t = pa.concat_tables([t.slice(0, 300), t.slice(300)])
    y = (a > 0).astype(float)
    jd = jlgb.Dataset(t, label=y).construct()
    td = tlgb.Dataset(t, label=y, params=CPU).construct()
    assert td.feature_names == jd.feature_names == ["a", "b", "c", "d"]
    np.testing.assert_array_equal(td.bins, np.asarray(jd.bins))
    bst = tlgb.train({"objective": "binary", "num_leaves": 4, **CPU}, td, 2)
    np.testing.assert_array_equal(bst.predict(t), bst.predict(tlgb.basic._to_2d_float(t)))


class _Rows(tlgb.basic.Sequence_):
    batch_size = 97

    def __init__(self, X):
        self.X = X

    def __len__(self):
        return len(self.X)

    def __getitem__(self, idx):
        return self.X[idx]


def test_sequence_input_bins_like_dense():
    """One Sequence_ and a list of them: the rows of the dense array, read
    in batches."""
    rng = np.random.RandomState(5)
    X = rng.randn(1000, 5)
    y = rng.randn(1000)
    want = tlgb.Dataset(X, label=y, params=CPU).construct().bins
    for data in (_Rows(X), [_Rows(X[:400]), _Rows(X[400:])]):
        np.testing.assert_array_equal(
            tlgb.Dataset(data, label=y, params=CPU).construct().bins, want)


def _write_text(path, fmt, X, y, header=False):
    """X (with NaN) and y as CSV, TSV or LibSVM (0-based indices, zeros
    left out), values written exactly (%.17g)."""
    with open(path, "w") as fh:
        if header and fmt != "libsvm":
            d = "," if fmt == "csv" else "\t"
            fh.write(d.join(["target"] + [f"f{j}" for j in range(X.shape[1])]) + "\n")
        for row, t in zip(X, y):
            if fmt == "libsvm":
                fh.write(" ".join([f"{t:.17g}"] + [f"{j}:{v:.17g}" for j, v in
                                                   enumerate(row) if v != 0]) + "\n")
            else:
                d = "," if fmt == "csv" else "\t"
                fh.write(d.join(f"{v:.17g}" if np.isfinite(v) else ""
                                for v in [t, *row]) + "\n")


def _table(n=600, f=6, seed=6):
    rng = np.random.RandomState(seed)
    X = np.round(rng.randn(n, f), 3)
    X[rng.rand(n, f) < 0.3] = 0.0
    y = (X[:, 0] + X[:, 1] > 0).astype(float)
    return X, y


@pytest.mark.parametrize("fmt", ["csv", "tsv", "libsvm"])
def test_parse_text_and_native_parser_match(tmp_path, fmt):
    """The port's numpy parser is the JAX package's; the native loader
    parses the same file to the same values."""
    X, y = _table()
    if fmt != "libsvm":
        X[::9, 2] = np.nan
    path = tmp_path / f"d.{fmt}"
    _write_text(path, fmt, X, y)
    text = path.read_text()
    got, first, detected = tparser.parse_text(text)
    want, wfirst, wdetected = jparser.parse_text(text)
    assert detected == wdetected == fmt
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(first, wfirst)
    data, label = native.parse_file(str(path), fmt, False, 0 if fmt == "libsvm" else -1)
    np.testing.assert_array_equal(data, got)
    np.testing.assert_array_equal(label if fmt == "libsvm" else data[:, 0], y)


def test_load_data_file_columns_match_jax(tmp_path):
    """A CSV with a header: label, weight and group columns by name, an
    ignored column, side files absent; the port's load and Dataset(path)
    give the JAX package's."""
    rng = np.random.RandomState(7)
    n = 300
    cols = {"qid": np.repeat(np.arange(30), 10), "f0": rng.randn(n),
            "w": rng.rand(n) + 0.5, "y": rng.randint(0, 3, n), "junk": rng.randn(n),
            "f1": rng.randn(n)}
    path = tmp_path / "ranked.csv"
    with open(path, "w") as fh:
        fh.write(",".join(cols) + "\n")
        for i in range(n):
            fh.write(",".join(f"{cols[k][i]:.17g}" for k in cols) + "\n")
    kw = dict(header=True, label_column="name:y", weight_column="name:w",
              group_column="name:qid", ignore_column="name:junk")
    got, want = tparser.load_data_file(str(path), **kw), jparser.load_data_file(str(path), **kw)
    assert got["feature_names"] == want["feature_names"] == ["f0", "f1"]
    for k in ("data", "label", "weight", "group"):
        np.testing.assert_array_equal(got[k], want[k], k)
    p = {"header": True, "label_column": "name:y", "weight_column": "name:w",
         "group_column": "name:qid", "ignore_column": "name:junk"}
    td = tlgb.Dataset(str(path), params={**p, **CPU}).construct()
    jd = jlgb.Dataset(str(path), params=p).construct()
    np.testing.assert_array_equal(td.bins, np.asarray(jd.bins))
    for k in ("label", "weight", "group"):
        np.testing.assert_array_equal(getattr(td, k), getattr(jd, k), k)


@pytest.mark.parametrize("fmt", ["csv", "libsvm"])
def test_two_round_bins_equal_one_round_and_jax(tmp_path, fmt):
    """two_round streams the file (a sample and a count, then chunks):
    the one-round bins, the JAX package's two-round bins, the in-memory
    rows' bins; a reference= set bins with its reference's mappers; the
    trained trees are the one-round ones."""
    X, y = _table(n=900)
    path = tmp_path / f"d.{fmt}"
    _write_text(path, fmt, X, y)
    one = tlgb.Dataset(str(path), params=CPU).construct()
    two = tlgb.Dataset(str(path), params={**CPU, "two_round": True}).construct()
    jtwo = jlgb.Dataset(str(path), params={"two_round": True}).construct()
    mem = tlgb.Dataset(X, label=y, params=CPU).construct()
    for d in (two, jtwo, mem):
        np.testing.assert_array_equal(np.asarray(d.bins), one.bins)
    np.testing.assert_array_equal(two.label, y)
    ref = tlgb.Dataset(str(path), params={**CPU, "two_round": True}, reference=one).construct()
    assert ref.binner is one.binner
    np.testing.assert_array_equal(ref.bins, one.bins)
    p = {"objective": "binary", "num_leaves": 7, "tree_growth_mode": "rounds", **CPU}
    bsts = [tlgb.train(p, d, 3) for d in (
        tlgb.Dataset(str(path), params=p),
        tlgb.Dataset(str(path), params={**p, "two_round": True}))]
    if fmt == "libsvm":
        assert bsts[0].model_to_string() == bsts[1].model_to_string()
    else:  # a one-round CSV names the features by their file columns
        np.testing.assert_array_equal(bsts[0].predict(X), bsts[1].predict(X))


def test_save_binary_round_trip_and_caches_across_packages(tmp_path):
    """save_binary, then Dataset(cache): the bins, mappers and metadata, in
    either direction between the packages; a flipped byte in the matrix
    fails its CRC32 block."""
    X, y = _table(n=700)
    group = np.full(7, 100)
    w = np.linspace(0.5, 1.5, 700)
    td = tlgb.Dataset(X, label=y, weight=w, group=group, params=CPU).construct()
    jd = jlgb.Dataset(X, label=y, weight=w, group=group).construct()
    td.save_binary(str(tmp_path / "t.bin"))
    jd.save_binary(str(tmp_path / "j.bin"))
    for name in ("t.bin", "j.bin"):
        back = tlgb.Dataset(str(tmp_path / name), params=CPU).construct()
        jback = jlgb.Dataset(str(tmp_path / name)).construct()
        for d in (back, jback):
            np.testing.assert_array_equal(np.asarray(d.bins), td.bins)
            _same_mappers(d.binner, td.binner)
            np.testing.assert_array_equal(d.label, y)
            np.testing.assert_array_equal(d.weight, w)
            np.testing.assert_array_equal(d.group, group)
        assert back.feature_names == td.feature_names
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    raw = read_bin_cache(str(tmp_path / "t.bin"))["bins"]
    bad = raw.copy()
    bad[650, 2] ^= 1
    z = np.load(str(tmp_path / "t.bin"))
    members = {k: z[k] for k in z.files}
    members["bins"] = bad
    with open(tmp_path / "bad.bin", "wb") as fh:
        np.savez_compressed(fh, **members)
    with pytest.raises(CorruptBinCacheError, match="CRC chunk 0"):
        read_bin_cache(str(tmp_path / "bad.bin"))


def test_booster_predict_on_csr_equals_dense():
    """Booster.predict on CSR rows: the dense rows' predictions, bitwise,
    raw scores and leaf ids too."""
    X, y = _sparse(n=2000)
    p = {"objective": "regression", "num_leaves": 15, "tree_growth_mode": "rounds", **CPU}
    bst = tlgb.train(p, tlgb.Dataset(X, label=y, params=p), 5)
    Xt, _ = _sparse(n=500, seed=9)
    np.testing.assert_array_equal(bst.predict(Xt), bst.predict(Xt.toarray()))
    np.testing.assert_array_equal(bst.predict(Xt.tocsc(), pred_leaf=True),
                                  bst.predict(Xt.toarray(), pred_leaf=True))


def test_pre_filter_mask_is_kept_per_dataset_and_per_subset():
    """feature_pre_filter's mask is computed once for a Dataset and again
    for a subset's rows (a feature with 60 nonzero rows passes
    min_data_in_leaf 20, its 10 in the subset do not)."""
    from lightgbm_tpu_torch.models.gbdt import _pre_filter

    rng = np.random.RandomState(8)
    X = rng.randn(1000, 3)
    X[:, 2] = 0.0
    X[rng.choice(500, 50, replace=False), 2] = 1.0
    X[500 + rng.choice(500, 10, replace=False), 2] = 1.0
    d = tlgb.Dataset(X, label=rng.randn(1000), params=CPU).construct()
    full = d.pre_filter_mask(20)
    assert full.tolist() == [True, True, True] and d.pre_filter_mask(20) is full
    sub = d.subset(np.arange(500, 1000))
    assert sub.pre_filter_mask(20).tolist() == [True, True, False]
    np.testing.assert_array_equal(sub.pre_filter_mask(20),
                                  _pre_filter(sub.bins, sub.binner, 20))
