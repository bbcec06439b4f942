"""Out-of-core training and the bin cache's streamed sweeps, appends and
segments in the port (io/stream.py, basic.py's out_of_core,
ops/treegrow_ooc.py), on the CPU.

The port's pins: the resident regime (rows within max_rows_in_hbm) trains
bitwise the in-memory model at every chunk size; the spill regime's model
text is bitwise the in-memory strict grower's at chunks of 7, 64, 300 and
N rows (B1's carried mode sums every chunk into one fixed-point
accumulator), with bagging and feature_fraction too, and a spill training
resumed from a snapshot is bitwise the uninterrupted one.  A cache written
by either package reads in the other, base and segments.  Against the JAX
package's spill training: the same tree structure on values on a coarse
grid (gains well apart), leaf values and predictions within 1e-5.
"""

import json

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
from lightgbm_tpu.io import stream as jstream
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.io import stream as tstream
from lightgbm_tpu_torch.io.stream import CorruptBinCacheError
from lightgbm_tpu_torch.ops import hist_cuda

CPU = {"device_type": "cpu"}
PARAMS = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 5,
          "learning_rate": 0.2, "verbosity": -1, **CPU}
STRICT = {**PARAMS, "tree_growth_mode": "strict"}
TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _data(n=600, f=6, seed=0):
    rng = np.random.RandomState(seed)
    X = np.round(rng.randn(n, f) * 8) / 8
    X[rng.rand(n, f) < 0.05] = np.nan
    Z = np.nan_to_num(X)
    y = (Z[:, 0] + 0.5 * Z[:, 1] - (Z[:, 2] > 0.5) + 0.5 * rng.randn(n) > 0)
    return X, y.astype(np.float64)


def _train(params, ds, rounds=5, **kw):
    return tlgb.train(params, ds, rounds, **kw)


def _cache(tmp_path, X, y, name="c.bin", params=PARAMS):
    path = str(tmp_path / name)
    tlgb.Dataset(X, label=y, params=params).construct().save_binary(path)
    return path


def test_a_cache_written_by_either_package_streams_in_the_other(tmp_path):
    X, y = _data()
    port = _cache(tmp_path, X, y, "port.bin")
    jax_path = str(tmp_path / "jax.bin")
    jlgb.Dataset(X, label=y, params={"verbosity": -1}).construct().save_binary(jax_path)
    want = tlgb.Dataset(X, label=y, params=PARAMS).construct().bins
    for path in (port, jax_path):
        for Stream in (tstream.BinCacheStream, jstream.BinCacheStream):
            st = Stream(path)
            got = np.concatenate([v.copy() for _lo, v in st.chunks(77)])
            np.testing.assert_array_equal(got, want)
    # appended rows: a segment written by each package reads in the other
    extra = want[:50]
    tstream.append_rows(port, extra, label=y[:50], segment_threshold=8)
    jstream.append_rows(jax_path, extra, label=y[:50], segment_threshold=8)
    for path in (port, jax_path):
        t = tstream.read_bin_cache(path)
        np.testing.assert_array_equal(t["bins"], np.concatenate([want, extra]))
        np.testing.assert_array_equal(t["label"], np.concatenate([y, y[:50]]))
        j = jstream.load_segmented_cache(path)
        np.testing.assert_array_equal(j[0], t["bins"])


def test_prefetch_reuses_two_staging_buffers_and_copies_each_chunk():
    rng = np.random.RandomState(1)
    bins = rng.randint(0, 200, (1000, 5)).astype(np.int16)
    read_buf = np.empty((64, 5), np.int16)  # one reused read buffer, as the stream's

    def chunks():
        for lo in range(0, 1000, 64):
            m = min(64, 1000 - lo)
            read_buf[:m] = bins[lo:lo + m]
            yield lo, read_buf[:m]

    staging = tstream._Staging()
    for _ in range(3):  # three sweeps share the two buffers
        got = [(lo, m, c) for lo, m, c in tstream.prefetch_device(chunks(), "cpu",
                                                                  staging=staging)]
        np.testing.assert_array_equal(torch.cat([c for _, _, c in got]).numpy(), bins)
        assert [lo for lo, _, _ in got] == list(range(0, 1000, 64))
        assert len(staging.bufs) == 2


@pytest.mark.parametrize("grower", ["strict", "rounds"])
def test_resident_regime_is_bitwise_in_memory_training_at_every_chunk_size(tmp_path,
                                                                          grower):
    X, y = _data()
    p = {**PARAMS, "tree_growth_mode": grower, "enable_bundle": False}
    want = _train(p, tlgb.Dataset(X, label=y, params=p)).model_to_string()
    path = _cache(tmp_path, X, y, params=p)
    for chunk in (1, 37, 128, len(y)):
        q = {**p, "out_of_core": True, "out_of_core_chunk_rows": chunk}
        ds = tlgb.Dataset(path, params=q)
        assert _train(q, ds).model_to_string() == want, chunk
        assert ds.bins is None and ds.bins_device is not None and not ds.ooc_spill


@pytest.mark.parametrize("chunk", [7, 64, 300, 600])
def test_spill_is_bitwise_the_in_memory_strict_grower(tmp_path, chunk):
    X, y = _data()
    want = _train(STRICT, tlgb.Dataset(X, label=y, params=STRICT)).model_to_string()
    q = {**PARAMS, "out_of_core": True, "max_rows_in_hbm": 100,
         "out_of_core_chunk_rows": chunk}
    for ds in (tlgb.Dataset(X, label=y, params=q),
               tlgb.Dataset(_cache(tmp_path, X, y), params=q)):
        bst = _train(q, ds)
        assert ds.ooc_spill and ds.bins_device is None
        assert bst.model_to_string() == want
        st = bst._gbdt.round_stats[0]
        assert st["grower"] == "ooc"
        # one blocking read a split (and one more where a tree stops short)
        assert st["host_syncs"] == min(st["splits"] + 1, 6)
        assert st["chunks"] == st["passes"] * -(-len(y) // chunk)


def test_spill_with_bagging_and_feature_fraction_is_bitwise_strict(tmp_path):
    X, y = _data(seed=3)
    extra = {"bagging_freq": 1, "bagging_fraction": 0.7, "feature_fraction": 0.7}
    p = {**STRICT, **extra}
    want = _train(p, tlgb.Dataset(X, label=y, params=p), 6).model_to_string()
    q = {**PARAMS, **extra, "out_of_core": True, "max_rows_in_hbm": 64,
         "out_of_core_chunk_rows": 50}
    assert _train(q, tlgb.Dataset(_cache(tmp_path, X, y), params=q), 6
                  ).model_to_string() == want


def test_spill_envelope_raises(tmp_path):
    X, y = _data(n=200)
    forced = tmp_path / "f.json"
    forced.write_text(json.dumps({"feature": 0, "threshold": 0.0}))
    base = {**PARAMS, "out_of_core": True, "max_rows_in_hbm": 50}
    for extra, word in (({"monotone_constraints": [1, 0, 0, 0, 0, 0]}, "monotone"),
                        ({"interaction_constraints": "[0,1],[2,3]"}, "interaction"),
                        ({"forcedsplits_filename": str(forced)}, "forcedsplits"),
                        ({"cegb_penalty_feature_lazy": [1e-3] * 6}, "cegb"),
                        ({"linear_tree": True}, "linear_tree"),
                        ({"extra_trees": True}, "extra_trees"),
                        ({"boosting": "dart"}, "dart")):
        p = {**base, **extra}
        with pytest.raises(ValueError, match=word):
            _train(p, tlgb.Dataset(X, label=y, params={**p, "linear_tree": False}), 1)


def test_spill_resumed_from_a_snapshot_is_bitwise_the_uninterrupted_run(tmp_path):
    X, y = _data(seed=4)
    q = {**PARAMS, "out_of_core": True, "max_rows_in_hbm": 100,
         "out_of_core_chunk_rows": 90}
    path = _cache(tmp_path, X, y)
    full = _train(q, tlgb.Dataset(path, params=q), 6).model_to_string()
    out = str(tmp_path / "m.txt")
    run = {**q, "snapshot_freq": 2, "output_model": out}
    _train(run, tlgb.Dataset(path, params=run), 3)  # stopped after round 3
    resumed = _train(run, tlgb.Dataset(path, params=run), 6, resume="auto")
    assert resumed.model_to_string() == full


def test_append_segment_watermark_and_compaction(tmp_path):
    X, y = _data(n=300)
    path = _cache(tmp_path, X, y)
    base = tstream.read_bin_cache(path)["bins"]
    rng = np.random.RandomState(5)
    adds = [rng.randint(0, 8, (40, 6)).astype(base.dtype) for _ in range(3)]
    labels = [rng.rand(40).round() for _ in range(3)]
    # rewrite mode: one file, the CRC table covers every row
    assert tstream.append_rows(path, adds[0], label=labels[0]) == 340
    assert tstream.BinCacheStream(path).segments == []
    # segment mode: O(new rows) sidecars, then folded at the threshold
    tstream.append_rows(path, adds[1], label=labels[1], segment_threshold=3)
    st = tstream.BinCacheStream(path)
    assert len(st.segments) == 1 and st.n_rows == 380
    seg_path = st.segments[0][1]
    stale = open(seg_path, "rb").read()
    tstream.append_rows(path, adds[2], label=labels[2], segment_threshold=2)
    st = tstream.BinCacheStream(path)
    assert st.segments == [] and st.n_rows == 420 and st.seg_watermark >= 1
    want = np.concatenate([base] + adds)
    np.testing.assert_array_equal(tstream.read_bin_cache(path)["bins"], want)
    np.testing.assert_array_equal(tstream.read_bin_cache(path)["label"],
                                  np.concatenate([y] + labels))
    # a sidecar a crash stranded below the watermark is ignored, not counted twice
    open(seg_path, "wb").write(stale)
    np.testing.assert_array_equal(tstream.read_bin_cache(path)["bins"], want)
    assert tstream.compact_bin_cache(path) == 420
    # the cache trains as it reads, out of core and in memory alike
    q = {**PARAMS, "out_of_core": True, "max_rows_in_hbm": 100}
    ds = tlgb.Dataset(path, params=q).construct()
    assert ds.num_data() == 420 and ds.ooc_spill
    # appends refuse what would put rows and labels out of step
    with pytest.raises(ValueError, match="labels"):
        tstream.append_rows(path, adds[0])
    with pytest.raises(ValueError, match="shape"):
        tstream.append_rows(path, adds[0][:, :3], label=labels[0])


def test_a_corrupt_segment_raises_with_its_rows(tmp_path):
    X, y = _data(n=300)
    path = _cache(tmp_path, X, y)
    add = np.zeros((40, 6), np.int16)
    tstream.append_rows(path, add, label=np.zeros(40), segment_threshold=5)
    seg = tstream.BinCacheStream(path).segments[0][1]
    raw = bytearray(open(seg, "rb").read())
    i = raw.index(b"\x93NUMPY") + 200
    raw[i] ^= 0xFF
    open(seg, "wb").write(bytes(raw))
    with pytest.raises(CorruptBinCacheError, match="CRC chunk 0"):
        tstream.read_bin_cache(path)


def test_carried_plain_version_is_the_one_call_at_any_chunking():
    rng = np.random.RandomState(6)
    n, f, b = 1000, 5, 40
    bins = torch.as_tensor(rng.randint(0, b, (n, f)), dtype=torch.int16)
    grad = torch.as_tensor(rng.randn(n) * 2, dtype=torch.float32)
    hess = torch.as_tensor(rng.rand(n), dtype=torch.float32)
    mask = torch.as_tensor(rng.rand(n) < 0.8)
    slot = torch.as_tensor(rng.randint(-1, 3, n), dtype=torch.int32)
    shift = hist_cuda.fixed_shift_tensor(grad, hess)
    one = hist_cuda.histogram_multi(bins, grad, hess, mask, slot, 0, 3, b, shift=shift)
    for chunk in (1, 7, 333, n):
        acc = hist_cuda.CarryAccumulator(3, f, b, shift, "cpu")
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            out = hist_cuda.histogram_multi_carry(bins[lo:hi], grad[lo:hi], hess[lo:hi],
                                                  mask[lo:hi], slot[lo:hi], 0, acc,
                                                  finalize=hi == n)
        assert torch.equal(out, one), chunk


def test_port_spill_agrees_with_jax_spill(tmp_path):
    X, y = _data(seed=7)
    jp = {k: v for k, v in PARAMS.items() if k != "device_type"}
    jq = {**jp, "out_of_core": True, "max_rows_in_hbm": 100, "out_of_core_chunk_rows": 128}
    jpath = str(tmp_path / "j.bin")
    jlgb.Dataset(X, label=y, params={"verbosity": -1}).construct().save_binary(jpath)
    jb = jlgb.train(jq, jlgb.Dataset(jpath, params=jq), 5)
    tq = {**PARAMS, "out_of_core": True, "max_rows_in_hbm": 100,
          "out_of_core_chunk_rows": 128}
    tb = _train(tq, tlgb.Dataset(jpath, params=tq))
    jt, tt = jb._gbdt.models, tb._gbdt.models
    assert len(jt) == len(tt)
    for a, b in zip(jt, tt):
        assert a.num_leaves == b.num_leaves
        m = a.num_leaves - 1
        for fld in ("split_feature", "threshold", "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(b, fld)[:m], getattr(a, fld)[:m])
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tb.predict(X), jb.predict(X), rtol=TOL, atol=TOL)
