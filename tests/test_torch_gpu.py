"""Hand-written Hopper kernels against their plain versions, on the card.

Marked ``gpu``; each test decides inside itself whether a card is present
and skips otherwise.  Run on a machine with a card (no JAX needed there):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

The strict grower, multiclass and LambdaRank trainings are held against
the same trainings on the CPU (the plain versions) within 1e-4, the strict
grower's steps run under torch's sync debug mode set to raise, and
multiclass graph and eager training give the same model text with one
capture a training.

The CUDA-graph tests (the one-dispatch contracts, ops/graphs.py) hold graph
and eager training bitwise, count one replay a tree-round and captures only
in the first tree that meets a key, run the replays under torch's sync debug
mode, and hold B2 and B3 captured in a graph to their eager launches.

EFB: B1 over a bundled Expo-shaped matrix (values up to 255, F_b
columns, the tile from F_b) against its plain version, unbundling on the
card against the CPU, a bundled CSR training graph == eager with no
blocking read, and the windowed grower's three-pass round over bundles.

The runtime: predict cached (the packed ensemble on the card) == uncached
bitwise, 1,000 coalesced batches through the serving runtime's pinned
staging, each bitwise, training in graph mode while a runtime serves
(thread-local capture), the probe that global-mode capture fails
beside a reading thread, and a traced predict's walk, sum and finish
device ms against CUDA events around the whole call.

Tolerances: int8 histograms are exact; float histograms are held to
1e-5 * (max|hess| + 1), the f32 summation-order bound, though the 64-bit
fixed point makes kernel and plain version agree bit for bit.  The
partition kernel and the round kernel are pinned bitwise: a permutation,
fixed-point histograms with the caller's exponents, and a split search
whose prefix sums are exact in float64 before their one rounding to f32.
"""

import numpy as np
import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.gpu


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _inputs(dev, n, f, b, slots, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return dict(
        bins=torch.randint(0, b, (n, f), generator=g, device=dev, dtype=torch.int16),
        grad=torch.randn(n, generator=g, device=dev) * 3,
        hess=torch.rand(n, generator=g, device=dev),
        mask=torch.rand(n, generator=g, device=dev) < 0.8,
        slot=torch.randint(-1, slots, (n,), generator=g, device=dev, dtype=torch.int32),
        gq=torch.randint(-8, 9, (n,), generator=g, device=dev, dtype=torch.int8),
        hq=torch.randint(0, 17, (n,), generator=g, device=dev, dtype=torch.int8))


@pytest.mark.parametrize("n,f,b,tile,base", [
    (1, 1, 2, 1, 0), (1000, 3, 16, 1, 0), (5003, 130, 255, 8, 3),
    (100_000, 28, 255, 8, 0), (70_001, 28, 63, 20, 2)])
def test_kernels_match_plain(n, f, b, tile, base):
    from lightgbm_tpu_torch.ops import hist_cuda as hc

    dev = _card()
    x = _inputs(dev, n, f, b, base + tile + 2)
    args = (x["bins"], x["grad"], x["hess"], x["mask"], x["slot"], base, tile, b)
    hc.reset_counts()
    k1, k2 = hc.histogram_multi(*args), hc.histogram_multi(*args)
    p = hc.histogram_multi_plain(*args)
    assert hc.launches["histogram_multi"] == 2
    assert torch.equal(k1, k2)
    tol = 1e-5 * (float(x["hess"].abs().max()) + 1.0)
    assert float((k1 - p).abs().max()) <= tol
    qargs = (x["bins"], x["gq"], x["hq"], x["mask"], x["slot"], base, tile, b)
    assert torch.equal(hc.histogram_multi_quantized(*qargs),
                       hc.histogram_multi_quantized_plain(*qargs))


def test_wrong_inputs_raise_on_card():
    from lightgbm_tpu_torch.ops import hist_cuda as hc

    dev = _card()
    x = _inputs(dev, 100, 2, 8, 2)
    with pytest.raises(TypeError):
        hc.histogram_multi(x["bins"].int(), x["grad"], x["hess"], x["mask"],
                           x["slot"], 0, 1, 8)
    with pytest.raises(ValueError):
        hc.histogram_multi(x["bins"], x["grad"].cpu(), x["hess"], x["mask"],
                           x["slot"], 0, 1, 8)


def test_training_on_card_launches_the_kernel():
    import lightgbm_tpu_torch as tlgb
    from lightgbm_tpu_torch.ops import hist_cuda as hc

    _card()
    rng = np.random.RandomState(0)
    X = rng.randn(20000, 10)
    y = (X[:, 0] + X[:, 1] ** 2 + rng.randn(20000) > 1).astype(float)
    # the rounds grower on both sides (auto is the strict grower on the CPU)
    p = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
         "tree_growth_mode": "rounds"}
    hc.reset_counts()
    bst = tlgb.train(p, tlgb.Dataset(X, label=y, params=p), 5)
    assert hc.launches["histogram_multi"] >= 5
    # no mode's plain version ran, the lane and carried modes' neither
    assert hc.plain_calls == dict.fromkeys(hc.plain_calls, 0)
    pc = {**p, "device_type": "cpu"}
    ref = tlgb.train(pc, tlgb.Dataset(X, label=y, params=pc), 5)
    np.testing.assert_allclose(bst.predict(X), ref.predict(X), atol=1e-4)


def _segments(dev, n, seed):
    """A ragged round: unsorted disjoint segments, an empty one, an all-left
    one, one of hundreds of chunks (a long look-back), odd N."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    order = torch.randperm(n, generator=g).to(torch.int32)
    go = torch.rand(n, generator=g) < 0.37
    seg_start = torch.tensor([n // 2, 7, n // 2 - 1000, n - 5, 3], dtype=torch.int32)
    seg_len = torch.tensor([n // 2 - 10, 900, 999, 5, 0], dtype=torch.int32)
    go[7:907] = True
    return [t.to(dev) for t in (order, go, seg_start, seg_len)]


@pytest.mark.parametrize("n", [2_500_001, 4099])
def test_partition_kernel_matches_plain(n):
    from lightgbm_tpu_torch.ops import partition_cuda as pc

    dev = _card()
    if n < 10_000:
        order, go, _, _ = _segments(dev, n, 1)
        seg_start = torch.tensor([0, 2048, 1024], dtype=torch.int32, device=dev)
        seg_len = torch.tensor([1000, 2051, 1], dtype=torch.int32, device=dev)
    else:
        order, go, seg_start, seg_len = _segments(dev, n, 0)
    pc.reset_counts()
    k, kl = pc.partition_segments(order, seg_start, seg_len, go)
    p, pl = pc.partition_segments_plain(order, seg_start, seg_len, go)
    assert pc.launches["partition_segments"] == 1
    assert torch.equal(k, p) and torch.equal(kl, pl)
    assert torch.equal(chip_smoke.library_partition(order, seg_start, seg_len, go)(), p)


def _partition_edge(dev, name, seed=0):
    return [torch.from_numpy(v).to(dev) for v in chip_smoke.partition_edge(name, seed)]


def _round_on(dev, order, go, seg_start, seg_len, f=8, b=16, seed=5):
    """round_megakernel's arguments for a given segment geometry: the left
    counts from go, the small children as windows, seeded bins and sums."""
    from lightgbm_tpu_torch.ops import partition_cuda as pc

    g = torch.Generator(device="cpu").manual_seed(seed)
    n, T = order.shape[0], seg_start.shape[0]
    n_left = pc.partition_segments_plain(order, seg_start, seg_len, go)[1]
    small_left = (2 * n_left <= seg_len).to(torch.int32)
    win_start = torch.where(small_left > 0, seg_start, seg_start + n_left)
    win_cnt = torch.where(small_left > 0, n_left, seg_len - n_left)
    fmask = torch.ones(f, dtype=torch.bool)
    cpu = [torch.randint(0, b, (n, f), generator=g, dtype=torch.int16), order.cpu(), go.cpu(),
           torch.randn(n, generator=g), torch.rand(n, generator=g),
           torch.rand(n, generator=g) < 0.9]
    rest = [torch.rand((T, 3, f, b), generator=g) * 40, torch.rand((4, 2 * T), generator=g) * 300,
            torch.full((f,), b, dtype=torch.int32), torch.full((f,), -1, dtype=torch.int32), fmask]
    args = ([a.to(dev) for a in cpu] + [seg_start, seg_len, n_left, win_start, win_cnt,
                                         small_left] + [a.to(dev) for a in rest])
    return args, max(int(win_cnt.sum()), 1)


def _b2_matches_plain(order, seg_start, seg_len, go):
    from lightgbm_tpu_torch.ops import partition_cuda as pc

    k, kl = pc.partition_segments(order, seg_start, seg_len, go)
    p, pl = pc.partition_segments_plain(order, seg_start, seg_len, go)
    torch.cuda.synchronize()
    assert torch.equal(k, p) and torch.equal(kl, pl)


def _b3_matches_plain(dev, order, go, seg_start, seg_len):
    from lightgbm_tpu_torch.ops import round_cuda as rc
    from lightgbm_tpu_torch.ops.split import SplitParams

    args, W = _round_on(dev, order, go, seg_start, seg_len)
    kw = dict(params=SplitParams(min_data_in_leaf=5, lambda_l2=1.0), W=W, shift=(30, 30))
    ko, kl, kr, kf = rc.round_megakernel(*args, **kw)
    po, pl, pr, pf = rc.round_megakernel_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(ko, po) and torch.equal(kl, pl) and torch.equal(kr, pr)
    for name in kf._fields:
        assert torch.equal(getattr(kf, name), getattr(pf, name)), name


@pytest.mark.parametrize("name", list(chip_smoke.PARTITION_EDGES))
def test_partition_edges_match_plain(name):
    """B2, and B3's partition phase through round_megakernel, bit for bit
    against their plain versions on every edge geometry (admission order,
    empty entries at 0, all empty, one segment over all N, one position,
    chunk edges, N below one chunk, S = 1 and 20, positions outside every
    segment)."""
    from lightgbm_tpu_torch.ops import partition_cuda as pc
    from lightgbm_tpu_torch.ops import round_cuda as rc

    dev = _card()
    order, seg_start, seg_len, go = _partition_edge(dev, name)
    pc.reset_counts()
    rc.reset_counts()
    _b2_matches_plain(order, seg_start, seg_len, go)
    _b3_matches_plain(dev, order, go, seg_start, seg_len)
    assert pc.launches["partition_segments"] == 1 and rc.launches["round_megakernel"] == 1


def test_partition_repeated_calls_carry_no_state():
    """Calls that share the reused scratch, with other geometries and N
    rising past the last call's (the scratch grows), B2 and B3 interleaved:
    each equals its plain version, so no ticket, block count or status
    word of one launch leaks into the next."""
    from lightgbm_tpu_torch.ops import partition_cuda as pc

    dev = _card()
    geoms = [_partition_edge(dev, name, seed) for seed, name in enumerate(
        ("below_one_chunk", "admission_order", "one_covers_all", "chunk_edges"))]
    order, go, seg_start, seg_len = _segments(dev, 300_001, 5)
    geoms.append([order, seg_start, seg_len, go])
    for i, (order, seg_start, seg_len, go) in enumerate(geoms + geoms[::-1]):
        _b2_matches_plain(order, seg_start, seg_len, go)
        if i % 2:
            _b3_matches_plain(dev, order, go, seg_start, seg_len)
        _b2_matches_plain(order, seg_start, seg_len, go)
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    assert pc._scratch[key].numel() >= pc.SCRATCH_HEADER + -(-300_001 // pc.CHUNK) + 5


def test_partition_refuses_more_segments_than_the_kernel_takes():
    """S > 1024: the kernel's C entry returns an error and the wrapper
    raises; the next call still works."""
    from lightgbm_tpu_torch.ops import partition_cuda as pc

    dev = _card()
    order, seg_start, seg_len, go = _partition_edge(dev, "one_segment")
    s = pc.MAX_SEGMENTS + 1
    zeros = torch.zeros(s, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError):
        pc.partition_segments(order, zeros, zeros, go)
    _b2_matches_plain(order, seg_start, seg_len, go)


def _round_case(dev, n=60_013, f=300, b=255, T=6, seed=3):
    """Window geometry from a real split of a ragged round."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    bins = torch.randint(0, b, (n, f), generator=g, dtype=torch.int16)
    order = torch.randperm(n, generator=g).to(torch.int32)
    go = torch.rand(n, generator=g) < 0.4
    go[20_000:21_000] = False  # an all-right segment
    seg_start = torch.tensor([0, 20_000, 21_000, 50_000, 59_000, 59_000],
                             dtype=torch.int32)
    seg_len = torch.tensor([20_000, 1000, 29_000, 9000, 0, 0], dtype=torch.int32)
    n_left = torch.stack([go[int(s):int(s + l)].sum() for s, l in
                          zip(seg_start, seg_len)]).to(torch.int32)
    small_left = (2 * n_left <= seg_len).to(torch.int32)
    win_start = torch.where(small_left > 0, seg_start, seg_start + n_left)
    win_cnt = torch.where(small_left > 0, n_left, seg_len - n_left)
    grad = torch.randn(n, generator=g)
    hess = torch.rand(n, generator=g)
    mask = torch.rand(n, generator=g) < 0.9
    parent = torch.rand((T, 3, f, b), generator=g) * 40
    cand = torch.rand((4, 2 * T), generator=g) * 3000
    nbpf = torch.full((f,), b, dtype=torch.int32)
    mbpf = torch.full((f,), -1, dtype=torch.int32)
    mbpf[::4] = b - 1
    fmask = torch.ones(f, dtype=torch.bool)
    fmask[5] = False
    args = [bins, order, go, grad, hess, mask, seg_start, seg_len, n_left,
            win_start, win_cnt, small_left, parent, cand, nbpf, mbpf, fmask]
    return [a.to(dev) for a in args]


def test_round_kernel_matches_plain():
    from lightgbm_tpu_torch.ops import round_cuda as rc
    from lightgbm_tpu_torch.ops.split import SplitParams

    dev = _card()
    args = _round_case(dev)
    kw = dict(params=SplitParams(min_data_in_leaf=20, lambda_l2=1.0), W=32768,
              shift=(30, 30))
    rc.reset_counts()
    ko, kl, kr, kf = rc.round_megakernel(*args, **kw)
    po, pl, pr, pf = rc.round_megakernel_plain(*args, **kw)
    assert rc.launches["round_megakernel"] == 1
    assert torch.equal(ko, po)
    assert torch.equal(kl, pl) and torch.equal(kr, pr)
    for name in kf._fields:  # float64 prefix sums, the same formulas op for op
        assert torch.equal(getattr(kf, name), getattr(pf, name)), name


def _edge_round(dev, f, geometry, n=40_013, b=255, seed=11):
    """A round whose small-child windows have set sizes, each from a
    segment with that many rows going left (left small) or right (right
    small): "empty_and_one" has an empty window and two one-row ones;
    "exactly_W" and "over_W" have windows totalling W and W + 2345 rows.
    Windows are thousands of rows long, so they cross the window pass's
    block ranges.  Every seventh row has all its bins at B - 1, the missing
    bin of every fourth feature."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    seg_len = torch.tensor([8000, 3000, 12000, 5000, 9000, n - 37000], dtype=torch.int32)
    lefts = {"empty_and_one": [0, 1, 5000, 4999, 4500, 1000]}.get(
        geometry, [3000, 1200, 6000, 2500, 100, 1500])
    seg_start = torch.cumsum(seg_len, 0, dtype=torch.int32) - seg_len
    go = torch.zeros(n, dtype=torch.bool)
    for start, length, k in zip(seg_start.tolist(), seg_len.tolist(), lefts):
        go[start + torch.randperm(length, generator=g)[:k]] = True
    n_left = torch.tensor(lefts, dtype=torch.int32)
    small_left = (2 * n_left <= seg_len).to(torch.int32)
    win_start = torch.where(small_left > 0, seg_start, seg_start + n_left)
    win_cnt = torch.where(small_left > 0, n_left, seg_len - n_left)
    total = int(win_cnt.sum())
    W = {"empty_and_one": 16_384, "exactly_W": total}.get(geometry, total - 2345)
    bins = torch.randint(0, b, (n, f), generator=g, dtype=torch.int16)
    bins[::7] = b - 1
    T = 6
    mbpf = torch.full((f,), -1, dtype=torch.int32)
    mbpf[::4] = b - 1
    fmask = torch.ones(f, dtype=torch.bool)
    fmask[3] = False
    args = [bins, torch.randperm(n, generator=g).to(torch.int32), go,
            torch.randn(n, generator=g), torch.rand(n, generator=g),
            torch.rand(n, generator=g) < 0.9, seg_start, seg_len, n_left, win_start,
            win_cnt, small_left, torch.rand((T, 3, f, b), generator=g) * 40,
            torch.rand((4, 2 * T), generator=g) * 3000,
            torch.full((f,), b, dtype=torch.int32), mbpf, fmask]
    quant = (torch.randint(-8, 9, (n,), generator=g, dtype=torch.int8),
             torch.randint(0, 17, (n,), generator=g, dtype=torch.int8))
    return [a.to(dev) for a in args], [q.to(dev) for q in quant], W, total


@pytest.mark.parametrize("f", [257, 2000])
@pytest.mark.parametrize("geometry", ["empty_and_one", "exactly_W", "over_W"])
def test_window_edges_match_plain(f, geometry):
    """B3 and B1's window passes (float and int8) bit for bit against their
    plain versions on the window edge cases; past W the kernel drops the
    rows that window_rows drops."""
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    from lightgbm_tpu_torch.ops import round_cuda as rc
    from lightgbm_tpu_torch.ops.split import SplitParams

    dev = _card()
    args, quant, W, total = _edge_round(dev, f, geometry)
    assert (W < total) == (geometry == "over_W")
    kw = dict(params=SplitParams(min_data_in_leaf=20, lambda_l2=1.0), W=W, shift=(30, 30))
    rc.reset_counts()
    ko, kl, kr, kf = rc.round_megakernel(*args, **kw)
    po, pl, pr, pf = rc.round_megakernel_plain(*args, **kw)
    assert rc.launches["round_megakernel"] == 1
    assert torch.equal(ko, po) and torch.equal(kl, pl) and torch.equal(kr, pr)
    for name in kf._fields:
        assert torch.equal(getattr(kf, name), getattr(pf, name)), name
    rows, _, valid = hc.window_rows(po, args[9], args[10], W)
    counted = int((args[5][rows] & valid).sum())  # masked rows of the first W positions
    for kern, plain, vals, extra in (
            (hc.histogram_window, hc.histogram_window_plain, (args[3], args[4]),
             dict(shift=(30, 30))),
            (hc.histogram_window_quantized, hc.histogram_window_quantized_plain, quant,
             {})):
        wa = (args[0], *vals, args[5], po, args[9], args[10], 6, 255)
        k = kern(*wa, W=W, **extra)
        assert torch.equal(k, plain(*wa, W=W, **extra))
        assert int(k[:, 2, 0].sum()) == counted


@pytest.mark.parametrize("f,tile,base", [(257, 8, 2), (2000, 1, 0), (2000, 20, 0)])
def test_wide_kernels_match_plain_with_bins_at_the_top(f, tile, base):
    """B1 direct, float and int8, at F = 257 and 2000 with every fifth row's
    bins at B - 1."""
    from lightgbm_tpu_torch.ops import hist_cuda as hc

    dev = _card()
    x = _inputs(dev, 30_011, f, 255, base + tile + 2, seed=f + tile)
    x["bins"][::5] = 254
    args = (x["bins"], x["grad"], x["hess"], x["mask"], x["slot"], base, tile, 255)
    k, p = hc.histogram_multi(*args), hc.histogram_multi_plain(*args)
    assert torch.equal(k, p)
    assert float(k[:, 2, :, 254].sum()) > 0
    qargs = (x["bins"], x["gq"], x["hq"], x["mask"], x["slot"], base, tile, 255)
    assert torch.equal(hc.histogram_multi_quantized(*qargs),
                       hc.histogram_multi_quantized_plain(*qargs))


def test_new_kernels_reject_wrong_inputs():
    from lightgbm_tpu_torch.ops import partition_cuda as pc
    from lightgbm_tpu_torch.ops import round_cuda as rc
    from lightgbm_tpu_torch.ops.split import SplitParams

    dev = _card()
    order, go, seg_start, seg_len = _segments(dev, 5001, 2)
    with pytest.raises(TypeError):
        pc.partition_segments(order.long(), seg_start, seg_len, go)
    with pytest.raises(ValueError):
        pc.partition_segments(order, seg_start.cpu(), seg_len, go)
    args = _round_case(dev, n=2000, f=8, b=16)
    args[0] = args[0].int()
    with pytest.raises(TypeError):
        rc.round_megakernel(*args, params=SplitParams(), W=8192, shift=(40, 40))


def _wide(n=30_000, f=512, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    y = (X[:, :8].sum(1) + X[:, 8] * X[:, 9] + rng.randn(n) > 0).astype(float)
    return X, y


def test_windowed_training_launches_the_round_megakernel(monkeypatch):
    """lgb.train with windowed_growth at 512 features and 64 leaves takes
    the windowed grower; every round launches the megakernel and nothing
    else on the float path, no plain version runs, and no round body asks
    the host to wait (torch's sync debug mode raises inside every round)."""
    import lightgbm_tpu_torch as tlgb
    from lightgbm_tpu_torch.ops import hist_cuda, partition_cuda, round_cuda
    from lightgbm_tpu_torch.ops import treegrow_windowed as tw

    _card()
    real = tw._round_fused

    def strict(*a, **k):
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        out = real(*a, **k)
        torch.cuda.set_sync_debug_mode(prev)
        return out

    monkeypatch.setattr(tw, "_round_fused", strict)
    X, y = _wide()
    p = {"objective": "binary", "num_leaves": 64, "verbosity": -1,
         "windowed_growth": True}
    for d in (hist_cuda, partition_cuda, round_cuda):
        d.reset_counts()
    bst = tlgb.train(p, tlgb.Dataset(X, label=y, params=p), 3)
    stats = bst._gbdt.windowed_stats
    assert len(stats) == 3 and all(s["megakernel"] for s in stats)
    # one launch a round (a graph replay), plus the warm-up round before
    # each capture
    assert round_cuda.launches["round_megakernel"] == sum(
        s["rounds"] + s["captures"] for s in stats)
    assert partition_cuda.launches["partition_segments"] == 0
    # one blocking read a tree, the fixed-point exponents before round 1
    assert all(s["retries"] == 0 and s["host_syncs"] == 1 for s in stats)
    for d in (hist_cuda, partition_cuda, round_cuda):
        assert not any(d.plain_calls.values()), d.plain_calls
    # the three-pass round grows the same trees
    p0 = {**p, "megakernel": "0"}
    for d in (hist_cuda, partition_cuda, round_cuda):
        d.reset_counts()
    ref = tlgb.train(p0, tlgb.Dataset(X, label=y, params=p0), 3)
    assert round_cuda.launches["round_megakernel"] == 0
    assert partition_cuda.launches["partition_segments"] > 0
    np.testing.assert_allclose(bst.predict(X[:2000]), ref.predict(X[:2000]),
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the one-dispatch contracts: every round one CUDA-graph replay
# ---------------------------------------------------------------------------
def _train_modes(p, X, y, rounds):
    """lgb.train with fused_training on (graphs) and off (eager): the two
    boosters, each with the stats of its trees and the kernels' launches."""
    import lightgbm_tpu_torch as tlgb
    from lightgbm_tpu_torch.ops import hist_cuda, partition_cuda, round_cuda

    out = []
    for fused in (True, False):
        q = {**p, "fused_training": fused}
        for d in (hist_cuda, partition_cuda, round_cuda):
            d.reset_counts()
        bst = tlgb.train(q, tlgb.Dataset(X, label=y, params=q), rounds)
        launches = {**hist_cuda.launches, **partition_cuda.launches,
                    **round_cuda.launches}
        for d in (hist_cuda, partition_cuda, round_cuda):
            assert not any(d.plain_calls.values()), d.plain_calls
        out.append((bst, bst._gbdt.round_stats, launches))
    return out


@pytest.mark.parametrize("cell", ["windowed_float", "windowed_int8", "rounds_float"])
def test_graph_and_eager_trees_are_bitwise_equal(cell):
    """fused_training=true (a replay a round) and false (eager rounds) grow
    the same model text; every round of the graph run is one replay, graphs
    are captured only for keys the tree meets first, and each kernel's
    launches are its replays' nodes plus the warm-up rounds."""
    _card()
    if cell == "rounds_float":
        rng = np.random.RandomState(1)
        X = rng.randn(40_000, 12)
        y = (X[:, 0] + X[:, 1] * X[:, 2] + rng.randn(40_000) > 0).astype(float)
        p = {"objective": "binary", "num_leaves": 31, "verbosity": -1}
    else:
        X, y = _wide()
        p = {"objective": "binary", "num_leaves": 64, "verbosity": -1,
             "windowed_growth": True,
             "use_quantized_grad": cell == "windowed_int8"}
    (gb, g_stats, g_l), (eb, e_stats, e_l) = _train_modes(p, X, y, 4)
    assert gb.model_to_string() == eb.model_to_string()
    assert all(s["replays"] == s["rounds"] == s["dispatches"] for s in g_stats)
    assert all(s["replays"] == s["captures"] == 0 for s in e_stats)
    assert g_stats[0]["captures"] >= 1
    seen = set()
    for s in g_stats:
        keys = set(s["windows"])
        assert s["captures"] == len(keys - seen), (s, seen)
        seen |= keys
    rounds = sum(s["rounds"] for s in g_stats)
    captures = sum(s["captures"] for s in g_stats)
    trees = len(g_stats)
    if cell == "windowed_float":
        assert g_l["round_megakernel"] == rounds + captures
        assert g_l["histogram_multi"] == trees  # the root passes, eager
    elif cell == "windowed_int8":
        assert g_l["partition_segments"] == rounds + captures
        # the window passes in B1's window mode, the root passes direct
        assert g_l["histogram_window_quantized"] == rounds + captures
        assert g_l["histogram_multi_quantized"] == trees
    else:
        assert g_l["histogram_multi"] == rounds + captures + trees
        assert all(s["host_syncs"] == 0 for s in g_stats)
    assert e_l["histogram_multi"] + e_l["histogram_multi_quantized"] > 0


def _windowed_fixture(n=30_000, f=512, seed=0):
    from lightgbm_tpu_torch.ops.split import SplitParams

    dev = _card()
    g = torch.Generator(device="cpu").manual_seed(seed)
    bins = torch.randint(0, 64, (n, f), generator=g, dtype=torch.int16).to(dev)
    grad = (bins[:, 0].float() - 30 + 8 * (bins[:, 1] > 20).float()
            + torch.randn(n, generator=g).to(dev))
    ones = torch.ones(n, device=dev)
    args = (bins, grad, ones, torch.ones(n, dtype=torch.bool, device=dev), ones,
            torch.ones(f, dtype=torch.bool, device=dev),
            torch.full((f,), 64, dtype=torch.int32, device=dev),
            torch.full((f,), -1, dtype=torch.int32, device=dev))
    kw = dict(num_leaves=64, num_bins=64, leaf_tile=10,
              params=SplitParams(min_data_in_leaf=20, lambda_l2=1.0))
    return args, kw


@pytest.mark.parametrize("grower", ["windowed", "rounds"])
def test_second_tree_replays_clean_and_captures_nothing(monkeypatch, grower):
    """The same tree twice through one cache: the first captures one graph
    per key it meets, the second none; the second's whole round loop runs
    under torch's sync debug mode set to raise (so no round asks the host
    to wait), with one replay a round and the same tree."""
    from lightgbm_tpu_torch.ops import treegrow_fast as tf
    from lightgbm_tpu_torch.ops import treegrow_windowed as tw
    from lightgbm_tpu_torch.ops.graphs import RoundGraphs

    args, kw = _windowed_fixture()
    grow = tw.grow_tree_windowed if grower == "windowed" else tf.grow_tree_fast
    graphs = RoundGraphs(args[0].device)
    s1, s2 = {}, {}
    t1, l1 = grow(*args, graphs=graphs, stats=s1, **kw)
    real = tw._run_fused_rounds

    def strict(*a, **k):
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode(prev)

    monkeypatch.setattr(tw, "_run_fused_rounds", strict)
    monkeypatch.setattr(tf, "_run_fused_rounds", strict)
    t2, l2 = grow(*args, graphs=graphs, stats=s2, **kw)
    assert s1["captures"] == len(set(s1["windows"])) >= 1
    assert s2["captures"] == 0 and s2["replays"] == s2["rounds"] == s1["rounds"]
    assert s2["host_syncs"] == (1 if grower == "windowed" else 0)
    assert torch.equal(l1, l2)
    for a, b in zip(t1, t2):
        assert (a is None and b is None) or torch.equal(a, b)


def test_b2_and_b3_in_a_graph_equal_their_eager_launches():
    """B2 and B3 captured in one graph (their cooperative launches as graph
    nodes, the exponent pair read from device memory), replayed with new
    inputs, interleaved on the same scratch with eager B2 calls over rising
    N (the last past the scratch's size, which regrows it for later eager
    calls while the graph keeps its own): every output equals the plain
    version's."""
    from lightgbm_tpu_torch.ops import partition_cuda as pc
    from lightgbm_tpu_torch.ops import round_cuda as rc
    from lightgbm_tpu_torch.ops.graphs import RoundGraphs
    from lightgbm_tpu_torch.ops.split import SplitParams

    dev = _card()
    n = 60_013
    order, go, seg_start, seg_len = _segments(dev, n, 7)
    args, W = _round_on(dev, order, go, seg_start, seg_len)
    kw = dict(params=SplitParams(min_data_in_leaf=5, lambda_l2=1.0), W=n)
    shift = torch.tensor([30, 31], dtype=torch.int32, device=dev)
    graphs = RoundGraphs(dev)
    side = graphs._stream
    big = _segments(dev, 200_003, 8)
    with torch.cuda.stream(side):
        _b2_matches_plain(big[0], big[2], big[3], big[1])  # scratch at its largest
        buffers = graphs.load((order, go, seg_start, seg_len, shift, tuple(args),
                               torch.empty_like(order), torch.empty_like(seg_start),
                               torch.empty_like(order)))

        def body(b):
            o, g, ss, sl, sh, ra, out2, nl2, out3 = b
            k2, kl2 = pc.partition_segments(o, ss, sl, g)
            out2.copy_(k2)
            nl2.copy_(kl2)
            out3.copy_(rc.round_megakernel(*ra, shift=sh, **kw)[0])

        for i, m in enumerate((5_000, 60_013, 150_001, 400_001)):
            other = _segments(dev, m, 20 + i)
            _b2_matches_plain(other[0], other[2], other[3], other[1])
            if i == 2:  # new inputs for the same graph
                o2 = torch.roll(order, 1)
                g2 = torch.roll(go, 3)
                ra = tuple(_round_on(dev, o2, g2, seg_start, seg_len, seed=9)[0])
                graphs.load((o2, g2, seg_start, seg_len, shift + 1, ra,
                             *buffers[6:]))
            graphs.run("b2b3", body)
            b = graphs.buffers
            p2, pl2 = pc.partition_segments_plain(b[0], b[2], b[3], b[1])
            p3 = rc.round_megakernel_plain(*b[5], shift=b[4], **kw)[0]
            torch.cuda.synchronize()
            assert torch.equal(b[6], p2) and torch.equal(b[7], pl2), i
            assert torch.equal(b[8], p3), i
    assert pc.launches["partition_segments"] >= 4


def test_a_failed_capture_raises_and_trains_nothing_eagerly(monkeypatch):
    """A round that asks the host to wait cannot be captured: training
    raises, and does not go on with eager rounds.  (Last in this file: a
    failed capture is left behind on its stream.)"""
    import lightgbm_tpu_torch as tlgb
    from lightgbm_tpu_torch.ops import treegrow_fast as tf

    _card()
    real = tf._round

    def syncing(*a, **k):
        st, info = real(*a, **k)
        if int(info[0]) < 0:  # a blocking read inside the round
            raise AssertionError("unreachable")
        return st, info

    monkeypatch.setattr(tf, "_round", syncing)
    rng = np.random.RandomState(2)
    X = rng.randn(5000, 6)
    y = (X[:, 0] > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 8, "verbosity": -1}
    ds = tlgb.Dataset(X, label=y, params=p)
    with pytest.raises(RuntimeError):
        tlgb.train(p, ds, 2)
    torch.cuda.synchronize()


def _card_vs_cpu(p, X, y, rounds, group=None):
    import lightgbm_tpu_torch as tlgb

    out = []
    for dev in ("cuda", "cpu"):
        q = {**p, "device_type": dev}
        out.append(tlgb.train(q, tlgb.Dataset(X, label=y, group=group, params=q),
                              rounds))
    return out


def test_strict_grower_on_card_matches_cpu_and_reads_nothing(monkeypatch):
    """tree_growth_mode=strict on the card: B1 at tile 1 its only histogram
    (the root and one a step), no host read inside a tree (every step runs
    under the sync debug mode set to raise), and the CPU's trees."""
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    from lightgbm_tpu_torch.ops import treegrow as tg

    _card()
    rng = np.random.RandomState(2)
    X = rng.randn(30_000, 10)
    y = (X[:, 0] + X[:, 1] ** 2 + rng.randn(30_000) > 1).astype(float)
    real = tg._grow

    def no_sync(*a, **k):
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode(prev)

    monkeypatch.setattr(tg, "_grow", no_sync)
    hc.reset_counts()
    p = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
         "tree_growth_mode": "strict"}
    card, cpu = _card_vs_cpu(p, X, y, 4)
    stats = card._gbdt.round_stats
    assert all(s["grower"] == "strict" and s["host_syncs"] == 0 for s in stats)
    assert hc.launches["histogram_multi"] == 4 * 15
    assert hc.launches["histogram_multi_quantized"] == 0
    np.testing.assert_allclose(card.predict(X), cpu.predict(X), atol=1e-4)


@pytest.mark.parametrize("objective,extra", [
    ("multiclass", {"num_class": 4}), ("multiclassova", {"num_class": 4}),
    ("lambdarank", {}), ("quantile", {"alpha": 0.8})])
def test_new_objectives_on_card_match_cpu(objective, extra):
    _card()
    rng = np.random.RandomState(3)
    n = 24_000
    X = rng.randn(n, 12)
    s = X[:, 0] + X[:, 1] * X[:, 2] + 0.5 * rng.randn(n)
    group = None
    if objective.startswith("multiclass"):
        y = np.digitize(s, [-1.0, 0.0, 1.0]).astype(float)
    elif objective == "lambdarank":
        y = np.clip(np.round(s + 1), 0, 4)
        group = np.full(n // 120, 120)
    else:
        y = s
    p = {"objective": objective, "num_leaves": 15, "verbosity": -1,
         "tree_growth_mode": "rounds", **extra}
    card, cpu = _card_vs_cpu(p, X, y, 3, group)
    assert card.predict(X).shape == cpu.predict(X).shape
    np.testing.assert_allclose(card.predict(X, raw_score=True),
                               cpu.predict(X, raw_score=True), atol=1e-4)


def test_multiclass_graph_and_eager_give_the_same_model():
    """Five classes, fused_training on and off: the same model text; in
    graph mode every class tree's rounds are replays of one capture."""
    _card()
    rng = np.random.RandomState(4)
    X = rng.randn(30_000, 10)
    y = np.digitize(X[:, 0] + X[:, 1] * X[:, 2], [-1.5, -0.5, 0.5, 1.5]).astype(float)
    p = {"objective": "multiclass", "num_class": 5, "num_leaves": 15,
         "max_bin": 63, "verbosity": -1}
    (gb, g_stats, g_l), (eb, e_stats, e_l) = _train_modes(p, X, y, 3)
    assert gb.model_to_string() == eb.model_to_string()
    assert len(g_stats) == 15
    assert all(s["replays"] == s["rounds"] == s["dispatches"] for s in g_stats)
    assert sum(s["captures"] for s in g_stats) == 1 == g_stats[0]["captures"]
    assert all(s["replays"] == s["captures"] == 0 for s in e_stats)


def _sync_error(fn):
    """fn run under torch's sync debug mode set to raise."""
    def run(*a, **k):
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    return run


def test_goss_mask_reads_nothing_and_graph_equals_eager(monkeypatch):
    """GOSS on the card: the mask and weights (gradients' scores, the
    threshold, the draws) run under the sync debug mode set to raise, every
    tree makes no blocking read, and graph and eager training (the mask
    entering the static buffers) give the same model."""
    from lightgbm_tpu_torch.models.gbdt import GBDT

    _card()
    monkeypatch.setattr(GBDT, "_goss_mask", _sync_error(GBDT._goss_mask))
    rng = np.random.RandomState(5)
    X = rng.randn(40_000, 10)
    y = (X[:, 0] + X[:, 1] ** 2 + rng.randn(40_000) > 1).astype(float)
    p = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
         "data_sample_strategy": "goss", "learning_rate": 0.25}
    (gb, g_stats, _), (eb, e_stats, _) = _train_modes(p, X, y, 8)
    assert gb.model_to_string() == eb.model_to_string()
    assert all(s["host_syncs"] == 0 for s in g_stats + e_stats)
    assert all(s["replays"] == s["rounds"] for s in g_stats)
    mask, w = gb._gbdt._bagging_mask()
    assert 0 < int(mask.sum()) < len(y) and float(w.max()) > 1.0


def test_dart_graph_equals_eager_and_counts_its_reads():
    """DART on the card: graph and eager training give the same model, and
    an iteration's drops and rescales of pending trees make no blocking
    read."""
    from lightgbm_tpu_torch.utils import sanitizer as san

    _card()
    rng = np.random.RandomState(6)
    X = rng.randn(40_000, 10)
    y = X[:, 0] + X[:, 1] * X[:, 2] + rng.randn(40_000)
    p = {"objective": "regression", "num_leaves": 15, "verbosity": -1,
         "boosting": "dart", "drop_rate": 0.3, "skip_drop": 0.0}
    (gb, _, _), (eb, _, _) = _train_modes(p, X, y, 8)
    assert gb.model_to_string() == eb.model_to_string()
    import lightgbm_tpu_torch as tlgb

    bst = tlgb.Booster(params=p, train_set=tlgb.Dataset(X, label=y, params=p))
    with san.DispatchCounter() as c:
        for _ in range(8):
            bst.update()
    assert c.host_syncs == 0 and sum(bst._gbdt.drops) > 0


def test_pred_leaf_and_early_stop_on_card_match_cpu():
    """A card-trained model: pred_leaf bitwise the CPU's, and prediction
    early stopping bitwise the CPU's with one blocking read a chunk."""
    import lightgbm_tpu_torch as tlgb
    from lightgbm_tpu_torch.utils import sanitizer as san

    _card()
    rng = np.random.RandomState(7)
    X = rng.randn(50_000, 10)
    X[rng.rand(50_000, 10) < 0.05] = np.nan
    y = (np.nan_to_num(X[:, 0]) + np.nan_to_num(X[:, 1]) ** 2 > 1).astype(float)
    p = {"objective": "binary", "num_leaves": 31, "verbosity": -1}
    card = tlgb.train(p, tlgb.Dataset(X, label=y, params=p), 20)
    cpu = tlgb.Booster(model_str=card.model_to_string(), params={"device_type": "cpu"})
    np.testing.assert_array_equal(card.predict(X, pred_leaf=True),
                                  cpu.predict(X, pred_leaf=True))
    es = {"pred_early_stop": True, "pred_early_stop_freq": 4,
          "pred_early_stop_margin": 2.0}
    with san.DispatchCounter() as c:
        r_card = card.predict(X, raw_score=True, **es)
    stats = card._gbdt.early_stop_stats
    assert c.host_syncs == stats["reads"] == stats["chunks"] >= 2
    assert 0 < stats["stopped"] < len(X)
    np.testing.assert_array_equal(r_card, cpu.predict(X, raw_score=True, **es))
    full = card.predict(X, raw_score=True)
    running = np.abs(r_card) < 2.0
    np.testing.assert_array_equal(r_card[running], full[running])


# ---------------------------------------------------------------------------
# categorical features, feature_contri and hist_precision=bf16
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,f,b,tile,base", [
    (1, 1, 2, 1, 0), (5003, 39, 256, 16, 3), (200_000, 39, 256, 16, 0),
    (70_001, 130, 63, 16, 2)])
def test_bf16_histogram_matches_plain(n, f, b, tile, base):
    """B1's bf16 mode bit for bit against its plain version, with the
    exponents derived from the rounded values and given by the caller."""
    from lightgbm_tpu_torch.ops import hist_cuda as hc

    dev = _card()
    x = _inputs(dev, n, f, b, base + tile + 2)
    args = (x["bins"], x["grad"], x["hess"], x["mask"], x["slot"], base, tile, b)
    hc.reset_counts()
    k = hc.histogram_multi(*args, precision="bf16")
    assert hc.launches["histogram_multi_bf16"] == 1 and hc.launches["histogram_multi"] == 0
    assert torch.equal(k, hc.histogram_multi_plain(*args, precision="bf16"))
    shift = hc.fixed_shift_tensor(x["grad"], x["hess"])
    assert torch.equal(hc.histogram_multi(*args, shift=shift, precision="bf16"),
                       hc.histogram_multi_plain(*args, shift=shift, precision="bf16"))


@pytest.mark.parametrize("mode", ["categorical", "contri", "both"])
def test_round_kernel_categorical_and_contri_match_plain(mode):
    """B3's categorical and feature_contri modes bit for bit against the
    plain version: per-feature bests, variants included."""
    from lightgbm_tpu_torch.ops import round_cuda as rc
    from lightgbm_tpu_torch.ops.split import SplitParams

    dev = _card()
    args = _round_case(dev)
    f = args[0].shape[1]
    g = torch.Generator(device="cpu").manual_seed(3)
    cmask = (torch.rand(f, generator=g) < 0.4).to(dev)
    contri = (torch.rand(f, generator=g) * 1.6 - 0.1).to(dev)
    extra = {"categorical": dict(categorical_mask=cmask),
             "contri": dict(feature_contri=contri),
             "both": dict(categorical_mask=cmask, feature_contri=contri)}[mode]
    for prm in (SplitParams(min_data_in_leaf=20, lambda_l2=1.0),
                SplitParams(min_data_in_leaf=5, lambda_l1=0.2, max_delta_step=0.5,
                            cat_smooth=2.0, cat_l2=1.0, max_cat_threshold=6,
                            max_cat_to_onehot=8)):
        kw = dict(params=prm, W=32768, shift=(30, 30), **extra)
        ko = rc.round_megakernel(*args, **kw)
        po = rc.round_megakernel_plain(*args, **kw)
        for a, b in zip(ko[:3], po[:3]):
            assert torch.equal(a, b)
        for name in ko[3]._fields:
            assert torch.equal(getattr(ko[3], name), getattr(po[3], name)), name
        if "categorical_mask" in extra:
            assert bool((ko[3].variant[:, cmask] >= 0).all())


def _categorical_rows(n=40_000, seed=6):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 8)
    X[:, 0] = rng.randint(0, 40, n)
    X[:, 1] = rng.randint(0, 4, n)
    X[rng.rand(n) < 0.1, 0] = np.nan
    eff = rng.randn(40)
    y = (eff[np.nan_to_num(X[:, 0]).astype(int)] + (X[:, 1] == 2) + X[:, 2]
         + rng.randn(n) > 0.5).astype(float)
    return X, y


def test_categorical_training_graph_equals_eager_and_reads_nothing(monkeypatch):
    """Categorical features on the rounds grower: graph and eager training
    give the same model text, every round of the graph run is one replay,
    no tree makes a blocking read, and every round body (captured or
    eager) runs under torch's sync debug mode set to raise; the card's
    trees predict as the CPU's."""
    import lightgbm_tpu_torch as tlgb
    from lightgbm_tpu_torch.ops import treegrow_fast as tf

    _card()
    monkeypatch.setattr(tf, "_round", _sync_error(tf._round))
    X, y = _categorical_rows()
    p = {"objective": "binary", "num_leaves": 31, "verbosity": -1,
         "tree_growth_mode": "rounds", "feature_contri": [1.0, 1.0, 0.7]}
    out = []
    for fused in (True, False):
        q = {**p, "fused_training": fused}
        bst = tlgb.train(q, tlgb.Dataset(X, label=y, categorical_feature=[0, 1],
                                         params=q), 5)
        out.append((bst, bst._gbdt.round_stats))
    (gb, g_stats), (eb, e_stats) = out
    assert gb.model_to_string() == eb.model_to_string()
    assert sum(t.num_cat for t in gb._gbdt.models) > 0
    assert all(s["replays"] == s["rounds"] for s in g_stats)
    assert all(s["host_syncs"] == 0 for s in g_stats + e_stats)
    cpu = {**p, "device_type": "cpu"}
    ref = tlgb.train(cpu, tlgb.Dataset(X, label=y, categorical_feature=[0, 1],
                                       params=cpu), 5)
    np.testing.assert_allclose(gb.predict(X[:5000]), ref.predict(X[:5000]), atol=1e-4)


def test_bf16_training_launches_the_bf16_kernel():
    import lightgbm_tpu_torch as tlgb
    from lightgbm_tpu_torch.ops import hist_cuda as hc

    _card()
    X, y = _categorical_rows(seed=8)
    p = {"objective": "binary", "num_leaves": 31, "verbosity": -1,
         "hist_precision": "bf16", "tree_growth_mode": "rounds"}
    hc.reset_counts()
    bst = tlgb.train(p, tlgb.Dataset(X, label=y, categorical_feature=[0, 1], params=p), 3)
    assert hc.launches["histogram_multi"] == 0
    assert hc.launches["histogram_multi_bf16"] >= 3
    assert not any(hc.plain_calls.values())
    assert bst._gbdt._leaf_tile == 16


def test_windowed_categorical_megakernel_equals_three_pass():
    """The windowed grower with categorical features: the megakernel's
    categorical mode against the three-pass round, the same trees."""
    import lightgbm_tpu_torch as tlgb
    from lightgbm_tpu_torch.ops import round_cuda

    _card()
    X, y = _wide()
    X[:, :12] = np.floor((X[:, :12] - X[:, :12].min(0)) * 3).clip(0, 20)
    p = {"objective": "binary", "num_leaves": 64, "verbosity": -1,
         "windowed_growth": True}
    boosters = []
    for mk in ("auto", "0"):
        q = {**p, "megakernel": mk}
        round_cuda.reset_counts()
        boosters.append(tlgb.train(q, tlgb.Dataset(X, label=y, categorical_feature=list(
            range(12)), params=q), 2))
        assert (round_cuda.launches["round_megakernel"] > 0) == (mk == "auto")
    assert sum(t.num_cat for t in boosters[0]._gbdt.models) > 0
    chip_smoke.trees_agree(*boosters)


def _bundled(n=60_000, seed=9):
    """A constructed Expo-shaped CSR set on the card (700 one-hot and
    integer columns, bundled) and its labels."""
    import lightgbm_tpu_torch as tlgb

    X, y = chip_smoke.expo_like(n, seed)
    ds = tlgb.Dataset(X, label=y, params={"verbosity": -1, "max_bin": 255})
    ds.construct()
    assert ds.efb is not None and ds.efb.num_bundled < 40
    return X, y, ds


@pytest.mark.parametrize("quantized", [False, True])
def test_b1_over_the_bundled_matrix_matches_plain(quantized):
    """B1 over an (N, F_b) bundled matrix, values up to 255 in bundles of
    width 256, at the tile the training derives from F_b: bitwise its plain
    version; unbundling on the card equals the CPU's (int32 bitwise, f32
    within its float64 fill's rounding)."""
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    from lightgbm_tpu_torch.ops.histogram import unbundle_hists
    from lightgbm_tpu_torch.ops.treegrow import quantize_gradients

    dev = _card()
    _, y, ds = _bundled()
    bundled, gather, default = ds.efb_device_tables()
    assert bundled.dtype == torch.int16 and int(bundled.max()) >= 200
    b, f, n = ds.max_num_bins, ds.num_feature(), bundled.shape[0]
    tile = hc.recommended_leaf_tile(b, ds.efb.num_bundled, 255, quantized=quantized)
    g = torch.as_tensor(0.19 - y, dtype=torch.float32, device=dev)
    h = torch.full((n,), 0.25, device=dev)
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    slot = chip_smoke.round_slots(n, tile, 5, dev)
    if quantized:
        gq, hq = quantize_gradients(g, h, mask, 16, False, None)[:2]
        args = (bundled, gq, hq, mask, slot, 0, tile, b)
        k = hc.histogram_multi_quantized(*args)
        assert torch.equal(k, hc.histogram_multi_quantized_plain(*args))
    else:
        args = (bundled, g, h, mask, slot, 0, tile, b)
        k = hc.histogram_multi(*args)
        assert torch.equal(k, hc.histogram_multi_plain(*args))
    card = unbundle_hists(k, gather, default, f, b).cpu()
    host = unbundle_hists(k.cpu(), gather.cpu(), default.cpu(), f, b)
    if quantized:
        assert torch.equal(card, host)
    else:
        scale = float(host.abs().max())
        assert float((card - host).abs().max()) <= 1e-6 * scale


def test_csr_training_graph_equals_eager_over_bundles(monkeypatch):
    """A bundled CSR set on the rounds grower: graph and eager training give
    the same model text, every round of the graph run one replay and none
    a blocking read, under torch's sync debug mode; the tile comes from
    F_b; the card's trees predict as the CPU's on CSR rows."""
    import lightgbm_tpu_torch as tlgb
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    from lightgbm_tpu_torch.ops import treegrow_fast as tf

    _card()
    monkeypatch.setattr(tf, "_round", _sync_error(tf._round))
    X, y, _ = _bundled(n=40_000)
    p = {"objective": "binary", "num_leaves": 63, "verbosity": -1, "max_bin": 255,
         "tree_growth_mode": "rounds"}
    out = []
    for fused in (True, False):
        q = {**p, "fused_training": fused}
        hc.reset_counts()
        bst = tlgb.train(q, tlgb.Dataset(X, label=y, params=q), 4)
        assert hc.launches["histogram_multi"] > 0 and not any(hc.plain_calls.values())
        out.append((bst, bst._gbdt.round_stats))
    (gb, g_stats), (eb, e_stats) = out
    assert gb.model_to_string() == eb.model_to_string()
    assert all(s["replays"] == s["rounds"] for s in g_stats)
    assert all(s["host_syncs"] == 0 for s in g_stats + e_stats)
    ts = gb._gbdt.train_set
    assert gb._gbdt._leaf_tile == hc.recommended_leaf_tile(ts.max_num_bins,
                                                           ts.efb.num_bundled, 63)
    cpu = {**p, "device_type": "cpu"}
    ref = tlgb.train(cpu, tlgb.Dataset(X, label=y, params=cpu), 4)
    np.testing.assert_allclose(gb.predict(X[:5000]), ref.predict(X[:5000]), atol=1e-4)


def test_windowed_training_over_bundles_takes_the_three_pass_round():
    """windowed_growth with a bundle plan: every tree reports the
    megakernel excluded for "efb", launches B2 and B1 and no B3, and equals
    the rounds grower's tree."""
    import lightgbm_tpu_torch as tlgb
    from lightgbm_tpu_torch.ops import partition_cuda, round_cuda

    _card()
    X, y, _ = _bundled(n=40_000)
    p = {"objective": "binary", "num_leaves": 64, "verbosity": -1, "max_bin": 255}
    round_cuda.reset_counts()
    partition_cuda.reset_counts()
    q = {**p, "windowed_growth": True}
    bw = tlgb.train(q, tlgb.Dataset(X, label=y, params=q), 2)
    st = bw._gbdt.round_stats
    assert [s["megakernel_excluded"] for s in st] == ["efb", "efb"]
    assert all(s["megakernel_fallbacks"] == 1 for s in st)
    assert round_cuda.launches["round_megakernel"] == 0
    assert partition_cuda.launches["partition_segments"] > 0
    br = tlgb.train(p, tlgb.Dataset(X, label=y, params=p), 2)
    chip_smoke.trees_agree(bw, br)


def test_round_kernel_cegb_split_penalty_matches_plain():
    """B3's gain tail with cegb_penalty_split (the parent count times the
    penalty subtracted after feature_contri), bit for bit against the plain
    version, alone and with feature_contri and categorical features."""
    from lightgbm_tpu_torch.ops import round_cuda as rc
    from lightgbm_tpu_torch.ops.split import SplitParams

    dev = _card()
    args = _round_case(dev)
    f = args[0].shape[1]
    g = torch.Generator(device="cpu").manual_seed(5)
    cmask = (torch.rand(f, generator=g) < 0.3).to(dev)
    contri = (torch.rand(f, generator=g) * 1.6 - 0.1).to(dev)
    for extra in ({}, dict(feature_contri=contri),
                  dict(categorical_mask=cmask, feature_contri=contri)):
        for prm in (SplitParams(min_data_in_leaf=20, lambda_l2=1.0,
                                cegb_penalty_split=1e-3),
                    SplitParams(min_data_in_leaf=5, cegb_tradeoff=0.5,
                                cegb_penalty_split=0.05)):
            kw = dict(params=prm, W=32768, shift=(30, 30), **extra)
            ko = rc.round_megakernel(*args, **kw)
            po = rc.round_megakernel_plain(*args, **kw)
            for name in ko[3]._fields:
                assert torch.equal(getattr(ko[3], name), getattr(po[3], name)), name
            assert bool((ko[3].gain > -1e29).any())


def _envelope_rows(n=40_000, seed=11):
    rng = np.random.RandomState(seed)
    X = np.round(rng.randn(n, 8) * 8) / 8
    X[rng.rand(n, 8) < 0.05] = np.nan
    Z = np.nan_to_num(X)
    s = 2.0 * (Z[:, 0] > 0.3) + 1.5 * Z[:, 1] - (Z[:, 2] < -0.5) + 0.5 * Z[:, 3] * (Z[:, 4] > 0)
    return X, (s + 0.5 * rng.randn(n) > 0.6).astype(float)


@pytest.mark.parametrize("opt", ["monotone", "intermediate", "interaction", "forced"])
def test_constrained_training_graph_equals_eager_and_reads_nothing(opt, monkeypatch,
                                                                   tmp_path):
    """Monotone (basic, intermediate), interaction and forced-split rounds
    on the card: graph and eager training give the same model text, every
    round of the graph run is one replay, no tree reads the device, every
    round body runs under torch's sync debug mode set to raise, and the
    card's trees predict as the CPU's within 1e-4."""
    import json

    import lightgbm_tpu_torch as tlgb
    from lightgbm_tpu_torch.ops import treegrow_fast as tf

    _card()
    monkeypatch.setattr(tf, "_round", _sync_error(tf._round))
    path = tmp_path / "forced.json"
    path.write_text(json.dumps({"feature": 1, "threshold": 0.25,
                                "left": {"feature": 2, "threshold": -0.5}}))
    mono = [1, 1, 1, 1, 0, -1, 0, 0]
    extra = {"monotone": {"monotone_constraints": mono},
             "intermediate": {"monotone_constraints": mono,
                              "monotone_constraints_method": "intermediate"},
             "interaction": {"interaction_constraints": [[0, 1], [2, 3, 4], [1, 5, 6, 7]]},
             "forced": {"forcedsplits_filename": str(path)}}[opt]
    X, y = _envelope_rows()
    # min_gain_to_split drops the splits that gain nothing in exact
    # arithmetic (their f32 gains are a few rounding steps of the leaf's
    # score terms, which the card's and the CPU's summation orders decide
    # differently); test_intermediate_card_and_cpu_part_only_at_f32_ties
    # runs this fixture without it
    p = {"objective": "binary", "num_leaves": 31, "verbosity": -1,
         "tree_growth_mode": "rounds", "min_gain_to_split": 1.0, **extra}
    out = []
    for fused in (True, False):
        q = {**p, "fused_training": fused}
        bst = tlgb.train(q, tlgb.Dataset(X, label=y, params=q), 5)
        out.append((bst, bst._gbdt.round_stats))
    (gb, g_stats), (eb, e_stats) = out
    assert gb.model_to_string() == eb.model_to_string()
    assert all(s["replays"] == s["rounds"] > 0 for s in g_stats)
    assert all(s["host_syncs"] == 0 for s in g_stats + e_stats)
    cpu = {**p, "device_type": "cpu"}
    ref = tlgb.train(cpu, tlgb.Dataset(X, label=y, params=cpu), 5)
    np.testing.assert_allclose(gb.predict(X[:5000]), ref.predict(X[:5000]), atol=1e-4)


def _search_log(monkeypatch, p, X, y, rounds):
    """An eager training's split searches in call order, on the host: each
    gain plane (C, F, B) as ("plane", gains) and each admission as
    ("admit", leaf gains, accepted leaves)."""
    import lightgbm_tpu_torch as tlgb
    from lightgbm_tpu_torch.ops import split
    from lightgbm_tpu_torch.ops import treegrow_fast as tf

    log = []
    plane0, admit0 = split.gain_plane, tf.admit

    def plane(*a, **k):
        gain, ctx = plane0(*a, **k)
        log.append(("plane", gain.detach().cpu().clone()))
        return gain, ctx

    def admit(gain, *a, **k):
        out = admit0(gain, *a, **k)
        log.append(("admit", gain.detach().cpu().clone(), out[0].detach().cpu().clone()))
        return out

    monkeypatch.setattr(split, "gain_plane", plane)
    monkeypatch.setattr(tf, "admit", admit)
    q = {**p, "fused_training": False}
    tlgb.train(q, tlgb.Dataset(X, label=y, params=q), rounds)
    monkeypatch.setattr(split, "gain_plane", plane0)
    monkeypatch.setattr(tf, "admit", admit0)
    return log


def test_intermediate_card_and_cpu_part_only_at_f32_ties(monkeypatch):
    """The intermediate-bounds rounds grower searches every leaf again each
    round.  On the graph test's fixture without min_gain_to_split, the card
    and the CPU score every candidate alike and admit the same leaves up to
    the first search whose choice they part on, and there each side scores
    the other's choice within rounding of its own: a tie.

    A gain is a difference of score terms up to ~8,000 here (the roots'),
    whose f32 spacing is 4.9e-4, so the sides are held within 1e-2 (20
    such steps) plus 1e-4 relative.  A candidate that one side rejects
    (gain not above 0) counts there as 0, the gain of not splitting, and
    may be valid on the other side only with a gain within 1e-2 of 0."""
    _card()
    tol = 1e-2
    mono = [1, 1, 1, 1, 0, -1, 0, 0]
    p = {"objective": "binary", "num_leaves": 31, "verbosity": -1,
         "tree_growth_mode": "rounds", "monotone_constraints": mono,
         "monotone_constraints_method": "intermediate"}
    X, y = _envelope_rows()
    card = _search_log(monkeypatch, p, X, y, 5)
    cpu = _search_log(monkeypatch, {**p, "device_type": "cpu"}, X, y, 5)

    def score(g):  # rejected candidates score 0, the gain of no split
        return torch.where(g > -1e29, g, 0.0).double()

    parted = None
    for i, (a, b) in enumerate(zip(card, cpu)):
        assert a[0] == b[0], i
        ga, gb = score(a[1]), score(b[1])
        np.testing.assert_allclose(ga.numpy(), gb.numpy(), rtol=1e-4, atol=tol)
        if a[0] == "admit":
            if not torch.equal(a[2], b[2]):
                # leaves admitted on one side only: each within tol of a
                # leaf that side ranked past it, or of no split
                for l in torch.nonzero(a[2] != b[2]).flatten().tolist():
                    for g, acc in ((ga, a[2]), (gb, b[2])):
                        rival = torch.where(acc != acc[l], g, -np.inf)
                        assert min(float(g[l]), float((rival - g[l]).abs().min())) <= tol
                parted = (i, "admission", torch.nonzero(a[2] != b[2]).flatten().tolist())
                break
            continue
        live = (a[1] > -1e29).flatten(1).any(1) | (b[1] > -1e29).flatten(1).any(1)
        pa, pb = ga.flatten(1).argmax(1), gb.flatten(1).argmax(1)
        rows = torch.nonzero(live & (pa != pb)).flatten().tolist()
        if rows:
            r = rows[0]
            fa, fb = ga[r].flatten(), gb[r].flatten()
            ja, jb = int(pa[r]), int(pb[r])
            bins = ga.shape[2]
            parted = (i, f"leaf {r}", f"card picks {divmod(ja, bins)} at {float(fa[ja])} "
                      f"(CPU {float(fb[ja])})", f"CPU picks {divmod(jb, bins)} at "
                      f"{float(fb[jb])} (card {float(fa[jb])})")
            assert float(fa[ja] - fa[jb]) <= tol and float(fb[jb] - fb[ja]) <= tol, parted
            break
    print(f"searches {len(card)}, first parting {parted}")


@pytest.mark.parametrize("opt", ["cegb", "node_sampling", "linear"])
def test_eager_envelope_on_card_matches_cpu(opt, monkeypatch):
    """CEGB coupled and lazy penalties, per-node sampling (the card's
    draws on both sides) and linear trees run eagerly by the fused gate;
    on the card they train the CPU's trees (predictions within 1e-4), the
    linear fit runs under torch's sync debug mode set to raise, and the
    linear model predicts on the card as its text does on the CPU, with
    prediction early stopping too."""
    import chip_smoke as cs
    import lightgbm_tpu_torch as tlgb
    from lightgbm_tpu_torch.models import gbdt

    dev = _card()
    monkeypatch.setattr(gbdt, "fit_linear_leaves", _sync_error(gbdt.fit_linear_leaves))
    extra = {"cegb": {"cegb_penalty_split": 1e-4,
                      "cegb_penalty_feature_coupled": [0, 0, 20, 0, 10, 0, 0, 0],
                      "cegb_penalty_feature_lazy": [0.01, 0, 0, 0.02, 0, 0, 0, 0]},
             "node_sampling": {"extra_trees": True, "feature_fraction_bynode": 0.7},
             "linear": {"linear_tree": True, "linear_lambda": 0.01}}[opt]
    X, y = _envelope_rows()
    p = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
         "tree_growth_mode": "rounds", **extra}
    with cs.card_draws(dev):
        bst = tlgb.train(p, tlgb.Dataset(X, label=y, params=p), 5)
        cpu = {**p, "device_type": "cpu"}
        ref = tlgb.train(cpu, tlgb.Dataset(X, label=y, params=cpu), 5)
    assert not bst._gbdt._fused_eligible(bst._gbdt.train_set)
    assert all(s["host_syncs"] == 0 and s["replays"] == 0 for s in bst._gbdt.round_stats)
    np.testing.assert_allclose(bst.predict(X[:5000]), ref.predict(X[:5000]), atol=1e-4)
    if opt == "linear":
        assert all(t.is_linear for t in bst._gbdt.models)
        back = tlgb.Booster(model_str=bst.model_to_string(), params={"device_type": "cpu"})
        np.testing.assert_allclose(bst.predict(X[:5000], raw_score=True),
                                   back.predict(X[:5000], raw_score=True), atol=1e-5)
        es = dict(pred_early_stop=True, pred_early_stop_freq=2,
                  pred_early_stop_margin=0.5)
        np.testing.assert_allclose(bst.predict(X[:5000], raw_score=True, **es),
                                   back.predict(X[:5000], raw_score=True, **es),
                                   atol=1e-5)
        assert bst._gbdt.early_stop_stats["stopped"] > 0


def test_windowed_node_sampling_takes_the_three_pass_round():
    """extra_trees and feature_fraction_bynode on the windowed grower: every
    tree reports the megakernel excluded for "node_rng", launches B2 and B1
    and no B3, and equals the rounds grower's tree on the same draws."""
    import lightgbm_tpu_torch as tlgb
    from lightgbm_tpu_torch.ops import partition_cuda, round_cuda

    _card()
    rng = np.random.RandomState(12)
    X = rng.randn(30_000, 520).astype(np.float32)
    y = (X[:, 0] + X[:, 1] * X[:, 2] + 0.5 * rng.randn(30_000) > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 64, "verbosity": -1, "max_bin": 63,
         "extra_trees": True, "feature_fraction_bynode": 0.8}
    round_cuda.reset_counts()
    partition_cuda.reset_counts()
    q = {**p, "windowed_growth": True}
    bw = tlgb.train(q, tlgb.Dataset(X, label=y, params=q), 2)
    st = bw._gbdt.round_stats
    assert [s["megakernel_excluded"] for s in st] == ["node_rng", "node_rng"]
    assert round_cuda.launches["round_megakernel"] == 0
    assert partition_cuda.launches["partition_segments"] > 0
    br = tlgb.train(p, tlgb.Dataset(X, label=y, params=p), 2)
    chip_smoke.trees_agree(bw, br)


# ---------------------------------------------------------------------------
# the runtime: the cached ensemble, pinned staging, training while serving
# ---------------------------------------------------------------------------

def _card_booster(n=20_000, f=12, rounds=10, seed=0, **extra):
    import lightgbm_tpu_torch as lgt

    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.3 * rng.randn(n) > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 31, "verbosity": -1, **extra}
    return lgt.train(p, lgt.Dataset(X, label=y, params=p), rounds), X, y, p


def test_cached_and_uncached_predict_agree_bitwise():
    """A warm predict (the packed ensemble cached on the card, its rung's
    pinned buffers reused) and one that packs and uploads the ensemble
    again (the version bumped first) give the same bits, raw and converted,
    at every rung; a warm call is one traversal and one blocking read."""
    from lightgbm_tpu_torch.utils import sanitizer as san

    _card()
    bst, X, _, _ = _card_booster()
    g = bst._gbdt
    for n in (1, 7, 1024, 20_000):
        for raw in (False, True):
            warm = bst.predict(X[:n], raw_score=raw)
            with san.DispatchCounter() as c:
                again = bst.predict(X[:n], raw_score=raw)
            assert (c.predicts, c.host_syncs) == (1, 1)
            g._invalidate_pred_cache("test")
            cold = bst.predict(X[:n], raw_score=raw)
            assert np.array_equal(warm, again) and np.array_equal(warm, cold), (n, raw)


def test_traced_predict_splits_its_device_time_by_phase():
    """A predict under torch.profiler: its ``predict.predict`` span carries
    the walk, sum and finish device ms, which with the rows' upload add up
    to within 5% of the call's device interval in the profiler's trace
    (the card kept busy while the host readies the call, so that interval
    is device time: the upload, then the phases, to the read's end); the
    answers are the untraced call's, in one blocking read.  200 trees
    of 255 leaves over 200,000 rows: one launch of the traversal kernel,
    which sums as it walks, so the sum phase is empty."""
    from lightgbm_tpu_torch.obs import trace as trc
    from lightgbm_tpu_torch.utils import sanitizer as san

    _card()
    bst, X, _, _ = _card_booster(n=200_000, rounds=200, num_leaves=255)
    want = bst.predict(X)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        bst.predict(X)
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda._sleep(200_000_000)
        with san.DispatchCounter() as c:
            got = bst.predict(X)
        torch.cuda.synchronize()
    assert (c.predicts, c.host_syncs) == (1, 1) and np.array_equal(got, want)
    call = trc.spans("predict.predict")[-1]["attrs"]
    phases = [call[f"{p}_device_ms"] for p in ("walk", "sum", "finish")]
    # the call's device interval from the trace: its first device op (the
    # upload) to its last (the read), the sleep that keeps the card busy
    # while the host readies the call left out
    ops = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    ops = ops[next(i for i, e in enumerate(ops) if "HtoD" in e.name):]
    whole = (ops[-1].time_range.end - ops[0].time_range.start) / 1e3
    upload = ops[0].time_range.elapsed_us() / 1e3
    assert phases[0] > 0 and phases[2] > 0 and 0 <= phases[1] <= 0.01 * phases[0]
    assert abs(sum(phases) + upload - whole) <= 0.05 * whole, (phases, upload, whole)
    assert 0 < call["walk_useful_share"] <= 1


# ---------------------------------------------------------------------------
# the traversal kernel (csrc/predict.cu) against the plain walk and sum
# ---------------------------------------------------------------------------
# float32 thresholds, and row values at them, a float32 step above them, at
# and around the zero threshold 1e-35, signed zeros and NaN
_THR = np.float32([-1.0, -1e-36, 0.0, 1e-36, 1e-35, 0.5, 2.0])
_EDGE = np.concatenate([_THR, np.nextafter(_THR, np.float32(np.inf)),
                        np.float32([np.nan, -0.0, -1e-35, 3.0, -2.0]),
                        np.nextafter(np.float32([1e-35]), np.float32(0.0))])
# categorical values: NaN, negative, fractional (truncated), in and out of
# the bitsets' words, huge and infinite
_CATS = np.float32([np.nan, -1.0, -5.0, -0.5, 0.0, 1.0, 2.7, 31.0, 32.0, 63.0, 64.0,
                    100.0, 127.0, 1000.0, 3e9, -3e9, 1e10, np.inf, -np.inf])


def _random_trees(rng, n_trees, max_leaves, n_feat, cat_cols=()):
    """Host trees of random shape (every seventh a one-leaf tree) in
    LightGBM's numbering, each node's missing type and default side drawn,
    thresholds from _THR, and with ``cat_cols`` categorical nodes on those
    columns with bitsets of 1-4 random words."""
    from lightgbm_tpu_torch.models.tree import Tree

    trees = []
    for i in range(n_trees):
        L = 1 if i % 7 == 3 else int(rng.randint(2, max_leaves + 1))
        M = L - 1
        left, right = np.zeros(M, np.int32), np.zeros(M, np.int32)
        above = {0: (-1, 0)}  # leaf -> (its node, side)
        for node in range(M):
            leaf = int(rng.choice(sorted(above)))
            par, side = above.pop(leaf)
            if par >= 0:
                (left if side == 0 else right)[par] = node
            left[node], right[node] = ~leaf, ~(node + 1)
            above[leaf], above[node + 1] = (node, 0), (node, 1)
        feat = rng.randint(0, n_feat, M).astype(np.int32)
        dt = (rng.randint(0, 2, M) << 1) | (rng.randint(0, 3, M) << 2)
        thr = _THR[rng.randint(0, len(_THR), M)].astype(np.float64)
        bounds, words = [0], []
        for j in range(M):
            if len(cat_cols) and rng.rand() < 0.4:
                feat[j] = rng.choice(cat_cols)
                dt[j] |= 1
                thr[j] = len(bounds) - 1
                nw = int(rng.randint(1, 5))
                words.extend(rng.randint(0, 2 ** 32, nw, dtype=np.uint64))
                bounds.append(bounds[-1] + nw)
        trees.append(Tree(
            num_leaves=L, split_feature=feat, threshold=thr, threshold_bin=None,
            decision_type=dt.astype(np.uint8), split_gain=np.ones(M, np.float32),
            left_child=left, right_child=right, internal_value=np.zeros(M),
            internal_weight=np.zeros(M), internal_count=np.zeros(M, np.int64),
            leaf_value=rng.randn(L), leaf_weight=np.ones(L),
            leaf_count=np.ones(L, np.int64), num_cat=len(bounds) - 1,
            cat_boundaries=np.asarray(bounds, np.int32),
            cat_threshold=np.asarray(words, np.uint32)))
    return trees


def _edge_rows(rng, n, n_feat, cat_cols=()):
    x = _EDGE[rng.randint(0, len(_EDGE), (n, n_feat))]
    normal = rng.rand(n, n_feat) < 0.25
    x[normal] = rng.randn(int(normal.sum())).astype(np.float32)
    for c in cat_cols:
        x[:, c] = _CATS[rng.randint(0, len(_CATS), n)]
    return x


def _stacked_on(trees, dev):
    from lightgbm_tpu_torch.models.gbdt import GBDT

    return GBDT._stacked(None, trees, dev)  # a pack's tables, no booster needed


def _plain_on_card(x, walk, k, **window):
    """The plain walk and sum on the card, a chunk of rows at a time."""
    from lightgbm_tpu_torch.ops import predict_cuda as pc

    step = max(1, 2 ** 25 // walk["num_leaves"].shape[0])
    outs = []
    for lo in range(0, x.shape[0], step):
        part = {key: v[lo:lo + step] if key in ("base", "active") else v
                for key, v in window.items()}
        outs.append(pc.predict_trees_plain(x[lo:lo + step], walk, k, **part))
    return torch.cat(outs)


@pytest.mark.parametrize("k,n,f,cats,leaves", [
    (1, 1, 28, (), 40), (1, 1000, 28, (), 40), (3, 777, 28, (), 40),
    (1, 5003, 28, (3, 7), 40), (3, 257, 28, (0,), 40), (1, 4099, 130, (), 40),
    (3, 1, 130, (5, 129), 40), (1, 2001, 28, (1,), 3000)])
def test_traversal_kernel_matches_the_plain_walk_and_sum(k, n, f, cats, leaves):
    """Random trees, one-leaf trees among them, every missing type and
    default side, thresholds hit exactly and a float32 step above, zero
    and the zero threshold, categorical bitsets against negative, NaN,
    huge, infinite and out-of-range values: the kernel's margins are the
    plain walk's and sum's bit for bit, at row counts off the block size,
    for 1 and 3 classes, on staged (F 28) and directly read (F 130) rows,
    with the trees' records in shared memory and, for trees of up to 3,000
    leaves, read where they lie; one launch a call."""
    from lightgbm_tpu_torch.ops import predict_cuda as pc

    dev = _card()
    rng = np.random.RandomState(n + 17 * k + f)
    trees = _random_trees(rng, (30 if leaves < 100 else 6) * k, leaves, f, cats)
    walk = _stacked_on(trees, dev)
    assert (walk["cat"] is not None) == bool(cats)
    x = torch.as_tensor(_edge_rows(rng, n, f, cats), device=dev)
    pc.reset_counts()
    got = pc.predict_trees(x, walk, k)
    assert pc.launches["predict_trees"] == 1 and pc.plain_calls["predict_trees"] == 0
    want = _plain_on_card(x, walk, k)
    assert got.shape == want.shape and torch.equal(got, want)
    assert torch.equal(pc.predict_trees(x, walk, k), got)  # a second launch, same bits
    assert pc.launches["predict_trees"] == 2


def test_traversal_kernel_on_the_benchmark_forest():
    """262,144 rows through 500 random 255-leaf trees of depth <= 16, the
    prediction cell's forest (gbdt_bench/data/forest.py), loaded as model
    text: the kernel's margins are the plain walk's and sum's bit for bit,
    and a Booster's predict launches the kernel once a call."""
    import lightgbm_tpu_torch as lgt
    from gbdt_bench.data import forest, tabular
    from lightgbm_tpu_torch.ops import predict_cuda as pc

    dev = _card()
    X, _ = tabular.make("higgs_like", 262_144, 20261019, dev)
    grown = forest.grow(X[:65_536], 500, 255, 20261019, min_rows=7, leaf_scale=0.05,
                        max_depth=16)
    bst = lgt.Booster(model_str=forest.model_text(grown, X.shape[1]))
    walk = bst._gbdt._packed(0, -1)["walk"]
    assert walk["depth"] <= 16 and walk["leaf_value"].shape == (500, 255)
    x = X.float().contiguous()
    got = pc.predict_trees(x, walk)
    assert torch.equal(got, _plain_on_card(x, walk, 1))
    pc.reset_counts()
    Xh = X.cpu().numpy()
    raw = [bst.predict(Xh[:n], raw_score=True) for n in (1, 16_384, 262_144)]
    assert pc.launches["predict_trees"] == 3
    assert np.array_equal(raw[-1], got.cpu().numpy().astype(np.float64))


@pytest.mark.parametrize("k", [1, 3])
def test_traversal_kernel_windows_match_the_plain_windows(k):
    """The early stop's window mode: each window of trees onto the margins
    so far, rows switched off as the windows go, bitwise the plain
    predict_raw_window on the card; a row that runs every window ends at
    the full prediction."""
    from lightgbm_tpu_torch.ops import predict_cuda as pc

    dev = _card()
    rng = np.random.RandomState(5 + k)
    trees = _random_trees(rng, 24 * k, 31, 28, (2,))
    walk = _stacked_on(trees, dev)
    n = 3001
    x = torch.as_tensor(_edge_rows(rng, n, 28, (2,)), device=dev)
    shape = (n,) if k == 1 else (n, k)
    base = torch.zeros(shape, dtype=torch.float32, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    window = 4 * k
    for lo in range(0, len(trees), window):
        got = pc.predict_trees(x, walk, k, tree_lo=lo, window=window, base=base,
                               active=active)
        want = _plain_on_card(x, walk, k, tree_lo=lo, window=window, base=base,
                              active=active)
        assert torch.equal(got, want), lo
        base = got
        active = active & torch.as_tensor(rng.rand(n) < 0.8, device=dev)
    running = active.cpu().numpy()
    assert 0 < running.sum() < n
    full = pc.predict_trees(x, walk, k)
    assert torch.equal(base[active], full[active])


def test_traversal_kernel_counts_the_leaf_depths_it_walked():
    """A traced call's counts: the useful steps are the sum of the leaf
    depths the plain walk's leaves give; the issued steps are whole warps'
    (32 lanes a step), at least the useful ones and at most 32 x the warps
    x the trees x the deepest tree."""
    from lightgbm_tpu_torch.models.gbdt import _leaf_depths
    from lightgbm_tpu_torch.ops import predict as tpredict
    from lightgbm_tpu_torch.ops import predict_cuda as pc

    dev = _card()
    rng = np.random.RandomState(9)
    trees = _random_trees(rng, 60, 63, 28, (4,))
    walk = _stacked_on(trees, dev)
    n = 10_007
    x = torch.as_tensor(_edge_rows(rng, n, 28, (4,)), device=dev)
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    got = pc.predict_trees(x, walk, counts=counts)
    assert torch.equal(got, pc.predict_trees(x, walk))  # counting changes no bit
    leaf = tpredict.leaf_index(x, **tpredict.walk_args(walk))
    depth = torch.as_tensor(_leaf_depths(trees, walk["leaf_value"].shape[1]), device=dev)
    issued, useful = counts.tolist()
    assert useful == int(torch.gather(depth, 1, leaf).sum())
    warps = -(-n // 32)
    assert issued % 32 == 0 and useful <= issued <= 32 * warps * len(trees) * walk["depth"]


def test_pinned_buffers_are_the_models_and_bounded_in_bytes(monkeypatch):
    """The pinned host buffers belong to the model, not to a pack: after a
    version bump the new pack reads through the same buffers and nothing
    is pinned again.  A rung whose buffer would hold more than
    _PINNED_MAX_BYTES stages through two pinned chunk buffers in turns
    (59 chunks here, each written again only after its last upload) and
    predicts the same bits."""
    from lightgbm_tpu_torch.models import gbdt as gm

    _card()
    bst, X, _, _ = _card_booster()
    g = bst._gbdt
    want = {n: bst.predict(X[:n]) for n in (1024, 5000)}
    held = dict(g._pinned.bufs)
    assert held and g._pinned.nbytes() > 0
    g._invalidate_pred_cache("test")
    assert np.array_equal(bst.predict(X[:1024]), want[1024])
    assert g._pinned.bufs.keys() == held.keys()
    assert all(g._pinned.bufs[k] is v for k, v in held.items())
    g._pinned.bufs.clear()
    monkeypatch.setattr(gm, "_PINNED_MAX_BYTES", 1 << 12)  # under rung 8192's
    assert np.array_equal(bst.predict(X[:5000]), want[5000])
    assert not any(k[0][0] == 8192 for k in g._pinned.bufs)
    chunks = [b for k, b in g._pinned.bufs.items() if k[2] > 0]
    assert len(chunks) == 2
    assert all(b.numel() * b.element_size() <= 1 << 12 for b in chunks)


def test_pinned_staging_is_reused_only_after_its_upload():
    """1,000 coalesced batches through the runtime, their rows changing
    every batch, so a pinned pair written again before its upload landed
    would corrupt a batch: every response bitwise its Booster.predict."""
    import threading

    from lightgbm_tpu_torch.serve import ServingRuntime

    _card()
    bst, X, _, _ = _card_booster()
    sizes = (1, 7, 64, 300)
    keys = [((i * 37) % 19_000, sizes[i % 4]) for i in range(250)]
    want = {k: bst.predict(X[k[0]:k[0] + k[1]]) for k in set(keys)}
    errors, done = [], []
    with ServingRuntime(bst, max_wait_ms=0.5, shed_unhealthy=False) as rt:
        def client(t):
            try:
                for j in range(250):
                    o, n = keys[(j + t * 61) % len(keys)]
                    got = rt.predict(X[o:o + n], timeout=120)
                    assert np.array_equal(got, want[(o, n)]), (o, n)
                    done.append(1)
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        ts = [threading.Thread(target=client, args=(t,)) for t in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(300)
        batches = rt.stats()
    from lightgbm_tpu_torch.obs import metrics as obs

    assert not errors, errors[:3]
    assert len(done) == 1000 and batches["queue_depth"] == 0
    assert obs.counter("serve_batches_total").value >= 250


def test_training_in_graph_mode_while_a_runtime_serves():
    """A training thread captures and replays its rounds while serving
    threads launch, allocate, pin and read: the capture (thread-local mode,
    ops/graphs.py) succeeds and the trees are those of the training alone."""
    import threading

    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.serve import ServingRuntime

    _card()
    bst, X, y, p = _card_booster()
    want = bst.predict(X[:300])
    stop, errors, served = threading.Event(), [], [0]
    with ServingRuntime(bst, max_wait_ms=0.5, shed_unhealthy=False) as rt:
        def client():
            try:
                while not stop.is_set():
                    assert np.array_equal(rt.predict(X[:300], timeout=120), want)
                    served[0] += 1
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        ts = [threading.Thread(target=client) for _ in range(3)]
        for t in ts:
            t.start()
        try:
            during = lgt.train({**p, "seed": 3}, lgt.Dataset(X, label=y, params=p), 5)
        finally:
            stop.set()
            for t in ts:
                t.join(120)
    alone = lgt.train({**p, "seed": 3}, lgt.Dataset(X, label=y, params=p), 5)
    st = during._gbdt.round_stats
    assert not errors and served[0] > 0
    assert sum(s["captures"] for s in st) >= 1 and all(s["replays"] == s["rounds"] for s in st)
    assert during.model_to_string() == alone.model_to_string()


_GLOBAL_CAPTURE = """
import sys, threading
import numpy as np, torch
sys.path.insert(0, {repo!r})
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.ops import graphs
graphs.CAPTURE_ERROR_MODE = "global"
rng = np.random.RandomState(0)
X = rng.randn(20000, 12); y = (X[:, 0] > 0).astype(float)
p = {{"objective": "binary", "num_leaves": 31, "verbosity": -1}}
stop = threading.Event()
def reads():
    while not stop.is_set():
        torch.ones(1000, device="cuda").sum().item()
        torch.empty(1 << 16, pin_memory=True)
t = threading.Thread(target=reads, daemon=True); t.start()
try:
    lgt.train(p, lgt.Dataset(X, label=y, params=p), 5)
    print("GLOBAL_CAPTURE_OK")
except Exception as e:
    print("GLOBAL_CAPTURE_FAILED", type(e).__name__, str(e)[:200])
stop.set()
"""


def test_global_capture_mode_is_broken_by_a_reading_thread():
    """Why ops/graphs.py captures in thread-local mode: with torch's default
    global mode, another thread that reads the card and pins host memory
    while a training captures makes the capture (or that thread's call)
    fail.  Run in a subprocess, whose CUDA context the failure may spoil."""
    import os
    import subprocess
    import sys

    _card()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", _GLOBAL_CAPTURE.format(repo=repo)],
                       capture_output=True, text=True, timeout=600)
    print(r.stdout[-2000:], r.stderr[-2000:])
    assert "GLOBAL_CAPTURE_OK" not in r.stdout, "global-mode capture survived"


# ---------------------------------------------------------------------------
# the kernel modes of the fleet and the out-of-core spill grower: B1 and B2
# over a lane axis, B1's carried accumulator (all bitwise)
# ---------------------------------------------------------------------------
from lightgbm_tpu_torch.ops import hist_cuda as hc  # noqa: E402
from lightgbm_tpu_torch.ops import partition_cuda as pcu  # noqa: E402


def _lane_inputs(dev, lanes, n, f, b, w, tile, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    bins = torch.randint(0, b, (n, f), generator=g, device=dev, dtype=torch.int16)
    grad = torch.randn(lanes, n, generator=g, device=dev) * 3
    hess = torch.rand(lanes, n, generator=g, device=dev)
    mask = torch.rand(lanes, n, generator=g, device=dev) < 0.8
    rows = torch.randint(0, n, (lanes, w), generator=g, device=dev, dtype=torch.int32)
    slot = torch.randint(-1, tile + 1, (lanes, w), generator=g, device=dev,
                         dtype=torch.int32)
    shift = torch.stack([hc.fixed_shift_tensor(grad[l], hess[l]) for l in range(lanes)])
    return bins, grad, hess, mask, rows, slot, shift


@pytest.mark.parametrize("lanes,n,f,b,w,tile", [(3, 5000, 6, 63, 1500, 4),
                                                (16, 40000, 28, 255, 9000, 8)])
def test_lane_histograms_match_plain_and_solo(lanes, n, f, b, w, tile):
    dev = _card()
    bins, grad, hess, mask, rows, slot, shift = _lane_inputs(dev, lanes, n, f, b, w, tile)
    cpu = [t.cpu() for t in (bins, grad, hess, mask, rows, slot, shift)]
    for prec in ("f32", "bf16"):
        got = hc.histogram_multi_lanes(bins, grad, hess, mask, rows, slot, shift, tile, b,
                                       precision=prec)
        want = hc.histogram_multi_lanes(*cpu, tile, b, precision=prec)
        assert torch.equal(got.cpu(), want)
        for l in (0, lanes - 1):  # each lane is its solo call on its gathered rows
            r = torch.where(slot[l] >= 0, rows[l], 0).long()
            solo = hc.histogram_multi(bins[r].contiguous(), grad[l][r], hess[l][r],
                                      mask[l][r], slot[l].contiguous(), 0, tile, b,
                                      shift=shift[l].contiguous(), precision=prec)
            assert torch.equal(got[l], solo)
    gq = torch.randint(-16, 17, (lanes, n), device=dev, dtype=torch.int8)
    hq = torch.randint(0, 17, (lanes, n), device=dev, dtype=torch.int8)
    got = hc.histogram_multi_quantized_lanes(bins, gq, hq, mask, rows, slot, tile, b)
    want = hc.histogram_multi_quantized_lanes(cpu[0], gq.cpu(), hq.cpu(), cpu[3], cpu[4],
                                              cpu[5], tile, b)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("lanes,n,s", [(2, 9000, 3), (16, 60000, 8), (64, 3000, 16),
                                       (65, 3000, 16), (300, 5000, 31), (3, 20000, 1024)])
def test_partition_lanes_match_plain(lanes, n, s):
    dev = _card()
    g = torch.Generator().manual_seed(lanes)
    order = torch.stack([torch.randperm(n, generator=g) for _ in range(lanes)]).to(
        torch.int32)
    cuts = torch.sort(torch.randint(0, n, (lanes, 2 * s), generator=g), dim=1).values
    seg_start, seg_len = cuts[:, 0::2].to(torch.int32), (cuts[:, 1::2] - cuts[:, 0::2]
                                                         ).to(torch.int32)
    seg_len[:, 0] = 0  # an empty segment
    go = torch.rand(lanes, n, generator=g) < 0.4
    want = pcu.partition_segments_lanes(order, seg_start, seg_len, go)
    # more lanes than 1024 // s take several lane groups in the one launch;
    # two launches in a row (the scratch's epochs keep them apart)
    for _ in range(2):
        got = pcu.partition_segments_lanes(*(t.to(dev) for t in (order, seg_start,
                                                                 seg_len, go)))
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    # 1025 segments a lane exceed one chunk table: refused
    zi = torch.zeros((2, 1025), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="segments"):
        pcu.partition_segments_lanes(torch.zeros((2, 2000), dtype=torch.int32, device=dev),
                                     zi, zi, torch.zeros((2, 2000), dtype=torch.bool,
                                                         device=dev))


def test_wide_fleet_takes_several_lane_groups_on_card():
    """160 lanes x a leaf tile of 8 are 1280 segments a round: B2's lane
    mode takes them as two lane groups in its one launch, and the lanes
    stay bitwise their solo runs."""
    import lightgbm_tpu_torch as lgt

    _card()
    rng = np.random.RandomState(4)
    n, f, lanes = 3000, 6, 160
    X = rng.randn(n, f)
    labels = ((X[None, :, 0] + rng.randn(lanes, n) * 0.5) > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 15, "verbosity": -1}
    pcu.reset_counts()
    fb = lgt.train_fleet(dict(p), lgt.Dataset(X, label=labels[0]), labels,
                         num_boost_round=2)
    torch.cuda.synchronize()
    assert fb._proto._leaf_tile * lanes > pcu.MAX_SEGMENTS
    st = fb.round_stats
    assert pcu.launches["partition_segments_lanes"] == sum(
        s["rounds"] + s["captures"] for s in st)
    for l in (0, 97, lanes - 1):
        solo = lgt.train({**p, "tree_growth_mode": "windowed", "megakernel": "0"},
                         lgt.Dataset(X, label=labels[l]), 2)
        assert fb.booster(l).model_to_string() == solo.model_to_string()


def test_out_of_core_on_card_is_bitwise_in_memory(tmp_path):
    """The chunks' uploads run on prefetch_device's copy stream: resident
    training from a stored cache is bitwise in-memory training, and spill
    training bitwise the in-memory strict grower, on the card."""
    import lightgbm_tpu_torch as lgt

    _card()
    rng = np.random.RandomState(8)
    n, f = 20000, 8
    X = rng.randn(n, f)
    y = (X[:, 0] + X[:, 1] * X[:, 2] + rng.randn(n) * 0.5 > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 15, "verbosity": -1}
    path = str(tmp_path / "c.bin")
    lgt.Dataset(X, label=y, params=p).construct().save_binary(path)
    mem = lgt.train(p, lgt.Dataset(X, label=y, params=p), 3).model_to_string()
    q = {**p, "out_of_core": True, "out_of_core_chunk_rows": 3000}
    ds = lgt.Dataset(path, params=q)
    assert lgt.train(q, ds, 3).model_to_string() == mem
    assert ds.bins_device.is_cuda and not ds.ooc_spill
    strict = {**p, "tree_growth_mode": "strict"}
    want = lgt.train(strict, lgt.Dataset(X, label=y, params=p), 3).model_to_string()
    for chunk in (3000, 7001):
        q = {**p, "out_of_core": True, "max_rows_in_hbm": 5000,
             "out_of_core_chunk_rows": chunk}
        ds = lgt.Dataset(path, params=q)
        assert lgt.train(q, ds, 3).model_to_string() == want, chunk
        assert ds.ooc_spill and ds.staging().stream is not None


@pytest.mark.parametrize("chunk", [7, 4096, 30000, 100000])
def test_carried_histogram_equals_one_call(chunk):
    dev = _card()
    n, f, b, tile = 100000, 28, 255, 1
    x = _inputs(dev, n, f, b, tile)
    slot = torch.zeros(n, dtype=torch.int32, device=dev)
    shift = hc.fixed_shift_tensor(x["grad"], x["hess"])
    one = hc.histogram_multi(x["bins"], x["grad"], x["hess"], x["mask"], slot, 0, tile, b,
                             shift=shift)
    acc = hc.CarryAccumulator(tile, f, b, shift, dev)
    out = None
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        out = hc.histogram_multi_carry(x["bins"][lo:hi], x["grad"][lo:hi],
                                       x["hess"][lo:hi], x["mask"][lo:hi], slot[lo:hi],
                                       0, acc, finalize=hi == n)
    assert torch.equal(out, one)
    cacc = hc.CarryAccumulator(tile, f, b, shift.cpu(), "cpu")
    plain = hc.histogram_multi_carry(x["bins"].cpu(), x["grad"].cpu(), x["hess"].cpu(),
                                     x["mask"].cpu(), slot.cpu(), 0, cacc, finalize=True)
    assert torch.equal(plain, one.cpu())


@pytest.mark.parametrize("quant", [False, True])
def test_fleet_lanes_equal_solo_runs_on_card_graph_and_eager(quant):
    import lightgbm_tpu_torch as lgt

    _card()
    rng = np.random.RandomState(3)
    n, f, lanes = 6000, 8, 5
    X = rng.randn(n, f)
    labels = ((X[None, :, 0] + rng.randn(lanes, n) * 0.5) > 0).astype(float)
    for fused in (True, False):
        p = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
             "fused_training": fused}
        if quant:
            p.update(use_quantized_grad=True, num_grad_quant_bins=16)
        hc.reset_counts()
        pcu.reset_counts()
        fb = lgt.train_fleet(dict(p), lgt.Dataset(X, label=labels[0]), labels,
                             num_boost_round=3)
        torch.cuda.synchronize()
        st = fb.round_stats
        rounds = sum(s["rounds"] for s in st)
        warm = sum(s["captures"] for s in st)
        name = "histogram_multi_quantized_lanes" if quant else "histogram_multi_lanes"
        assert hc.launches[name] == rounds + warm
        assert pcu.launches["partition_segments_lanes"] == rounds + warm
        assert sum(s["replays"] for s in st) == (rounds if fused else 0)
        for l in (0, lanes - 1):
            # the port's solo run: train() on the three-pass windowed grower
            solo = lgt.train({**p, "tree_growth_mode": "windowed", "megakernel": "0"},
                             lgt.Dataset(X, label=labels[l]), 3)
            assert fb.booster(l).model_to_string() == solo.model_to_string()
            assert torch.equal(fb._score[l], solo._gbdt._score)


# ---------------------------------------------------------------------------
# distributed training: B3 unfused, the exact merge over NCCL, card binning
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,f,b,T", [(60_000, 40, 255, 10), (100_003, 257, 63, 6)])
def test_unfused_round_matches_plain(n, f, b, T):
    """B3 without its tail (round_cuda.round_partition_window): the new
    order and the fixed-point window sums bitwise its plain version's, and
    their conversion (the carried kernel's finalize) too."""
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    from lightgbm_tpu_torch.ops import round_cuda as rc
    from lightgbm_tpu_torch.ops.treegrow_windowed import _window_size

    dev = _card()
    x = _inputs(dev, n, f, b, T, seed=n)
    sp = chip_smoke.split_case(x["bins"], b, T, seed=f, ragged=(f % 2 == 1))
    W = _window_size(int(sp["win_cnt"].sum()), n)
    shift = hc.fixed_shift_tensor(x["grad"], x["hess"])
    args = (x["bins"], sp["order"], sp["go"], x["grad"], x["hess"], x["mask"],
            sp["seg_start"], sp["seg_len"], sp["n_left"], sp["win_start"], sp["win_cnt"])
    rc.reset_counts()
    got = rc.round_partition_window(*args, num_bins=b, W=W, shift=shift)
    want = rc.round_partition_window_plain(*args, num_bins=b, W=W, shift=shift)
    torch.cuda.synchronize()
    assert rc.launches["round_megakernel_unfused"] == 1
    for name, a, w in zip(("order", "acc64", "acc32"), got, want):
        assert torch.equal(a, w), name
    assert torch.equal(hc.carry_convert(got[1], got[2], shift),
                       hc.carry_convert_plain(want[1].cpu(), want[2].cpu(), shift.cpu()).to(dev))


def test_nccl_world_one_windowed_tree_is_serial(tmp_path):
    """grow_tree_windowed_data_parallel over a one-rank NCCL group, psum and
    scatter merges, megakernel on: B3 unfused every round, and the tree and
    leaf ids of the serial windowed tree (fused megakernel) bit for bit."""
    import torch.distributed as dist

    from lightgbm_tpu_torch.ops import round_cuda as rc
    from lightgbm_tpu_torch.ops.split import SplitParams
    from lightgbm_tpu_torch.ops.treegrow_windowed import grow_tree_windowed
    from lightgbm_tpu_torch.parallel import data_parallel as dpar
    from lightgbm_tpu_torch.parallel.mesh import make_mesh

    dev = _card()
    n, f, b = 120_000, 600, 63
    x = _inputs(dev, n, f, b, 1, seed=3)
    g = x["grad"] + (x["bins"][:, 0] > 30).float() * 2 - (x["bins"][:, 9] < 10).float()
    nbpf = torch.full((f,), b, dtype=torch.int32, device=dev)
    mbpf = torch.full((f,), -1, dtype=torch.int32, device=dev)
    mbpf[4] = b - 1
    ones = (torch.ones(n, dtype=torch.bool, device=dev), torch.ones(n, device=dev),
            torch.ones(f, dtype=torch.bool, device=dev))
    hess = x["hess"] + 0.1
    common = dict(num_leaves=127, num_bins=b, params=SplitParams(min_data_in_leaf=20),
                  leaf_tile=10)
    st = {}
    want, want_leaf = grow_tree_windowed(x["bins"], g, hess, *ones, nbpf, mbpf, stats=st,
                                         **common)
    assert st["megakernel"]
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        sd = dpar.ShardedData(make_mesh(), x["bins"], nbpf, mbpf)
        for merge in ("psum", "scatter"):
            rc.reset_counts()
            sst = {}
            got, leaf = dpar.grow_tree_windowed_data_parallel(sd, g, hess, *ones,
                                                              merge=merge, stats=sst,
                                                              **common)
            torch.cuda.synchronize()
            assert rc.launches["round_megakernel_unfused"] == sst["rounds"] > 5
            assert rc.launches["round_megakernel"] == 0
            for name, a, w in zip(got._fields, got, want):
                if a is not None:
                    assert torch.equal(a, w), (merge, name)
            assert torch.equal(leaf, want_leaf)
    finally:
        dist.destroy_process_group()


def test_card_binning_matches_numpy():
    """DatasetBinner.transform on the card (torch.searchsorted over the
    float64 bounds) bitwise its numpy path: NaN, zeros as missing, a
    categorical column, float32 and float64 input."""
    from lightgbm_tpu_torch.binning import DatasetBinner

    dev = _card()
    rng = np.random.RandomState(0)
    X = rng.randn(50_000, 30).astype(np.float32)
    X[rng.rand(50_000, 30) < 0.03] = np.nan
    X[:, 4] = np.where(rng.rand(50_000) < 0.4, 0.0, X[:, 4])
    X[:, 6] = rng.randint(0, 9, 50_000)
    X[0, 7], X[1, 7] = np.inf, -np.inf
    for kw in ({}, {"zero_as_missing": True}, {"use_missing": False}):
        binner = DatasetBinner.fit(X, max_bin=255, categorical_features=[6], **kw)
        want = binner.transform(X)
        assert np.array_equal(binner.transform(X, device=dev), want), kw
        assert np.array_equal(binner.transform(X.astype(np.float64), device=dev), want), kw


_TWO_RANKS = r"""
import os, numpy as np, torch
from lightgbm_tpu_torch.parallel import data_parallel as DP, feature_parallel as FP
from lightgbm_tpu_torch.parallel.mesh import make_mesh
from lightgbm_tpu_torch.ops.split import SplitParams
from lightgbm_tpu_torch.ops.treegrow import grow_tree
from lightgbm_tpu_torch.ops.treegrow_windowed import grow_tree_windowed
dev = torch.device("cuda", 0)
d = np.load(os.path.join(WORKDIR, "in.npz"))
bins, g, h = (torch.as_tensor(d[k], device=dev) for k in ("bins", "g", "h"))
n, f = bins.shape
per = -(-n // WORLD)
lo, hi = RANK * per, min(n, (RANK + 1) * per)
nbpf = torch.full((f,), 63, dtype=torch.int32, device=dev)
mbpf = torch.full((f,), -1, dtype=torch.int32, device=dev)
def ones(m):
    return (torch.ones(m, dtype=torch.bool, device=dev), torch.ones(m, device=dev),
            torch.ones(f, dtype=torch.bool, device=dev))
mesh = make_mesh()
sp = SplitParams(min_data_in_leaf=20)
common = dict(num_leaves=63, num_bins=63, params=sp, leaf_tile=10)
want = grow_tree_windowed(bins, g, h, *ones(n), nbpf, mbpf, **common)[0]
sd = DP.ShardedData(mesh, bins[lo:hi], nbpf, mbpf)
ok = {}
for merge in ("psum", "scatter"):
    got = DP.grow_tree_windowed_data_parallel(sd, g[lo:hi], h[lo:hi], *ones(hi - lo),
                                              merge=merge, **common)[0]
    ok[merge] = all(torch.equal(a, b) for a, b in zip(got, want) if a is not None)
strict = grow_tree(bins, g, h, *ones(n), nbpf, mbpf, num_leaves=31, num_bins=63,
                   params=sp)[0]
fsd = FP.FeatureShardedData(mesh, bins, nbpf, mbpf)
got = FP.grow_tree_feature_parallel(fsd, g, h, *ones(n), num_leaves=31, num_bins=63,
                                    params=sp)[0]
ok["feature"] = all(torch.equal(a, b) for a, b in zip(got, strict) if a is not None)
with open(os.path.join(WORKDIR, f"ok{RANK}.txt"), "w") as fh:
    fh.write(repr(ok))
"""


def test_two_gloo_ranks_on_the_card_grow_the_serial_trees(tmp_path):
    """Two ranks on the one card (gloo over CUDA tensors): the windowed
    round with psum and scatter merges and the feature-parallel strict
    grower give the serial trees bit for bit.  On the card a reduction's
    order follows its input's layout, so the rank holding feature 0 of a
    feature block sums the root totals at the serial width
    (ops/treegrow.py::serial_totals)."""
    from lightgbm_tpu_torch.parallel.launcher import run_spmd

    _card()
    rng = np.random.RandomState(0)
    n, f = 200_000, 300
    bins = rng.randint(0, 63, (n, f)).astype(np.int16)
    g = (rng.randn(n) + 2 * (bins[:, 0] > 30) - (bins[:, 9] < 10)).astype(np.float32)
    np.savez(tmp_path / "in.npz", bins=bins, g=g, h=(rng.rand(n) + 0.1).astype(np.float32))
    run_spmd(_TWO_RANKS, 2, str(tmp_path), timeout_s=240, cuda=True)
    for r in range(2):
        ok = eval((tmp_path / f"ok{r}.txt").read_text())
        assert ok == {"psum": True, "scatter": True, "feature": True}, (r, ok)


_MESH_2D = r"""
import os, numpy as np, torch
from lightgbm_tpu_torch.ops.split import SplitParams
from lightgbm_tpu_torch.ops.treegrow_windowed import grow_tree_windowed
from lightgbm_tpu_torch.parallel.feature2d import Sharded2DData, grow_tree_windowed_feature2d
from lightgbm_tpu_torch.parallel.mesh import make_mesh_2d
torch.set_num_threads(2)
dev = torch.device("cuda", 0)
d = np.load(os.path.join(WORKDIR, "in.npz"))
bins, g, h = (torch.as_tensor(d[k], device=dev) for k in ("bins", "g", "h"))
n, f = bins.shape
nbpf = torch.full((f,), 63, dtype=torch.int32, device=dev)
mbpf = torch.full((f,), -1, dtype=torch.int32, device=dev)
mbpf[3] = 62
def ones(m):
    return (torch.ones(m, dtype=torch.bool, device=dev), torch.ones(m, device=dev),
            torch.ones(f, dtype=torch.bool, device=dev))
mesh = make_mesh_2d(2, 2)
lo, hi = mesh.coords[0] * n // 2, (mesh.coords[0] + 1) * n // 2
sd = Sharded2DData(mesh, bins[lo:hi], nbpf, mbpf)
ok = {}
for q, tile in ((0, 10), (15, 20)):
    common = dict(num_leaves=63, num_bins=63, params=SplitParams(min_data_in_leaf=20),
                  leaf_tile=tile, quantize_bins=q)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    want, want_leaf = grow_tree_windowed(bins, g, h, *ones(n), nbpf, mbpf, generator=gen,
                                         megakernel_opt="0", **common)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    got, leaf = grow_tree_windowed_feature2d(sd, g[lo:hi], h[lo:hi], *ones(hi - lo),
                                             generator=gen, **common)
    ok[q] = (all(torch.equal(a, b) for a, b in zip(got, want) if a is not None)
             and torch.equal(leaf, want_leaf[lo:hi]) and int(got.num_leaves) == 63)
with open(os.path.join(WORKDIR, f"ok{RANK}.txt"), "w") as fh:
    fh.write(repr(ok))
"""


def test_2d_mesh_on_the_card_grows_the_serial_trees(tmp_path):
    """Four gloo ranks on the one card as a 2 x 2 (data, feature) mesh: the
    float and int8 windowed trees (B1's carried mode merged over the data
    axis, B2, the election over the feature axis) and each row block's
    leaf ids are the serial three-pass trees' bit for bit."""
    from lightgbm_tpu_torch.parallel.launcher import run_spmd

    _card()
    rng = np.random.RandomState(1)
    n, f = 120_000, 301
    bins = rng.randint(0, 63, (n, f)).astype(np.int16)
    g = (rng.randn(n) + 2 * (bins[:, 0] > 30) - (bins[:, 200] < 10)).astype(np.float32)
    np.savez(tmp_path / "in.npz", bins=bins, g=g, h=(rng.rand(n) + 0.1).astype(np.float32))
    run_spmd(_MESH_2D, 4, str(tmp_path), timeout_s=300, cuda=True)
    for r in range(4):
        ok = eval((tmp_path / f"ok{r}.txt").read_text())
        assert ok == {0: True, 15: True}, (r, ok)


def test_predict_over_a_device_mesh_on_the_card_is_predict():
    """predict(mesh=) over two entries of the one card: the pack's tables
    placed once a device, each block's margins the single-device ones bit
    for bit, multiclass and binary."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.parallel.mesh import make_device_mesh

    dev = _card()
    rng = np.random.RandomState(2)
    X = rng.randn(50_001, 12)
    mesh = make_device_mesh([dev, dev])
    for extra, y in (({"objective": "binary"}, (X[:, 0] + X[:, 1] > 0).astype(float)),
                     ({"objective": "multiclass", "num_class": 3},
                      np.digitize(X[:, 2], [-0.5, 0.5]))):
        p = {**extra, "verbosity": -1, "num_leaves": 31}
        bst = lgb.train(p, lgb.Dataset(X, label=y, params=p), 10)
        for raw in (False, True):
            assert np.array_equal(bst.predict(X, raw_score=raw, mesh=mesh),
                                  bst.predict(X, raw_score=raw)), (extra, raw)


def test_c_api_training_on_the_card_is_the_python_api():
    """The port's C library (native.c_api_library) on the card: a Dataset
    from a matrix, its label, a Booster and 10 LGBM_BoosterUpdateOneIter
    give the model text lgb.train gives, bit for bit, and the per-call
    finish report makes no blocking read."""
    import ctypes

    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch import native
    from lightgbm_tpu_torch.utils import sanitizer as san

    _card()
    lib = ctypes.CDLL(native.c_api_library())
    lib.LGBM_GetLastError.restype = ctypes.c_char_p
    X, y = chip_smoke.higgs_like(50_000, 3)
    Xc = np.ascontiguousarray(X)
    yc = np.ascontiguousarray(y, np.float32)
    ds, bh, fin = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_int()
    assert lib.LGBM_DatasetCreateFromMat(Xc.ctypes.data_as(ctypes.c_void_p), 1,
                                         Xc.shape[0], Xc.shape[1], 1, b"max_bin=255",
                                         None, ctypes.byref(ds)) == 0
    assert lib.LGBM_DatasetSetField(ds, b"label", yc.ctypes.data_as(ctypes.c_void_p),
                                    len(yc), 0) == 0
    p = {"objective": "binary", "num_leaves": 31, "verbosity": -1, "seed": 7}
    assert lib.LGBM_BoosterCreate(ds, " ".join(
        f"{k}={v}" for k, v in {**p, "num_iterations": 10}.items()).encode(),
        ctypes.byref(bh)) == 0, lib.LGBM_GetLastError()
    with san.DispatchCounter() as c:
        for _ in range(10):
            assert lib.LGBM_BoosterUpdateOneIter(bh, ctypes.byref(fin)) == 0
    assert c.stats()["host_syncs"] == 0
    need = ctypes.c_int64()
    lib.LGBM_BoosterSaveModelToString(bh, 0, -1, 0, ctypes.c_int64(0),
                                      ctypes.byref(need), None)
    buf = ctypes.create_string_buffer(need.value)
    assert lib.LGBM_BoosterSaveModelToString(bh, 0, -1, 0, need, ctypes.byref(need),
                                             buf) == 0
    bst = lgb.train(p, lgb.Dataset(X, label=y, params={"max_bin": 255}), 10)
    assert buf.value.decode() == bst.model_to_string()
    lib.LGBM_BoosterFree(bh)
    lib.LGBM_DatasetFree(ds)


def test_refit_site_histogram_matches_plain():
    """B1 at LGBM_BoosterRefit's site (capi_helpers.booster_refit_leaf_preds:
    one int16 feature whose bin is the leaf id, every row in slot 0) on
    the card == its plain version bit for bit."""
    from lightgbm_tpu_torch.ops import hist_cuda

    dev = _card()
    n, leaves = 100_000, 31
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    leaf = torch.randint(0, leaves, (n, 1), generator=g, device=dev, dtype=torch.int16)
    grad = torch.randn(n, generator=g, device=dev)
    hess = torch.rand(n, generator=g, device=dev)
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    slot = torch.zeros(n, dtype=torch.int32, device=dev)
    args = (leaf, grad, hess, ones, slot)
    k = hist_cuda.histogram_multi(*args, 0, 1, leaves)
    p = hist_cuda.histogram_multi(*[a.cpu() for a in args], 0, 1, leaves)
    assert torch.equal(k.cpu(), p)


def _small_call_cases(dev, n, f, b, one_bin, seed=0):
    """B1 direct-call inputs at one slot: random bins, or every row in bin
    b - 1 (every lane of a warp on one address: the worst contention)."""
    x = _inputs(dev, n, f, b, 1, seed)
    if one_bin:
        x["bins"] = torch.full((n, f), b - 1, dtype=torch.int16, device=dev)
    x["slot"] = torch.zeros(n, dtype=torch.int32, device=dev)
    return x


@pytest.mark.parametrize("n,f,b,one_bin", [
    (100_000, 1, 2, False), (100_000, 1, 31, False), (100_000, 1, 255, False),
    (100_000, 1, 31, True), (1, 1, 31, False), (1, 28, 255, False), (131_072, 28, 255, False),
    (1024, 1, 1024, False), (1024, 1, 1025, False)])
def test_small_call_matches_plain(n, f, b, one_bin):
    """B1's small calls (the refit site's one feature, the spill chunk's
    shape, n = 1, one block of 1,024 threads over 1,024 and 1,025 cells)
    bit for bit against the plain version: float with the exponents derived
    and given, bf16, int8."""
    dev = _card()
    x = _small_call_cases(dev, n, f, b, one_bin)
    args = (x["bins"], x["grad"], x["hess"], x["mask"], x["slot"], 0, 1, b)
    cpu = [a.cpu() if torch.is_tensor(a) else a for a in args]
    shift = hc.fixed_shift_tensor(x["grad"], x["hess"])
    for kw in ({}, {"shift": shift}, {"precision": "bf16"}):
        pkw = {k: (v.cpu() if torch.is_tensor(v) else v) for k, v in kw.items()}
        assert torch.equal(hc.histogram_multi(*args, **kw).cpu(),
                           hc.histogram_multi_plain(*cpu, **pkw)), kw
    q = (x["bins"], x["gq"], x["hq"], x["mask"], x["slot"], 0, 1, b)
    assert torch.equal(hc.histogram_multi_quantized(*q).cpu(),
                       hc.histogram_multi_quantized_plain(*[a.cpu() if torch.is_tensor(a)
                                                            else a for a in q]))


def _window_case(dev, n, f, b, T, W, seed):
    """Windows at T slots over a stable partition of N rows by leaf: the
    first window empty, the last one all masked, and their rows past W."""
    x = _inputs(dev, n, f, b, T, seed)
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    leaf = torch.randint(0, 2 * T, (n,), generator=g, device=dev)
    leaf[leaf == 0] = 1  # window 0 empty
    order = torch.sort(leaf, stable=True).indices.to(torch.int32)
    cnt = torch.bincount(leaf, minlength=2 * T)[:T].to(torch.int32)
    start = (torch.cumsum(cnt, 0) - cnt).to(torch.int32)
    last = order[int(start[-1]):int(start[-1]) + int(cnt[-1])].long()
    x["mask"][last] = False
    x.update(order=order, win_start=start, win_cnt=cnt, W=W, T=T)
    return x


@pytest.mark.parametrize("n,f,b,T,frac", [
    (200_000, 17, 256, 8, 0.5), (200_000, 17, 256, 8, 0.25), (40_000, 17, 256, 8, 0.5),
    (40_000, 300, 255, 20, 0.5)])
def test_window_entries_match_the_gathered_route(n, f, b, T, frac):
    """B1's window mode (float, bf16, int8, carried) bit for bit against its
    plain version and against the gathered route (window_rows + index_select
    + the direct kernel), W past and within the windows' rows."""
    dev = _card()
    W = int(n * frac)
    x = _window_case(dev, n, f, b, T, W, seed=T + f)
    rows, slot, valid = hc.window_rows(x["order"], x["win_start"], x["win_cnt"], W)
    gm = x["mask"][rows] & valid
    shift = hc.fixed_shift_tensor(x["grad"], x["hess"])
    wargs = (x["bins"], x["grad"], x["hess"], x["mask"], x["order"], x["win_start"],
             x["win_cnt"], T, b)
    cpu = [a.cpu() if torch.is_tensor(a) else a for a in wargs]
    for prec in ("f32", "bf16"):
        k = hc.histogram_window(*wargs, W=W, shift=shift, precision=prec)
        assert torch.equal(k, hc.histogram_multi(
            x["bins"].index_select(0, rows), x["grad"][rows], x["hess"][rows], gm, slot, 0,
            T, b, shift=shift, precision=prec)), prec
        assert torch.equal(k.cpu(), hc.histogram_window_plain(*cpu, W=W, shift=shift.cpu(),
                                                              precision=prec)), prec
    qargs = (x["bins"], x["gq"], x["hq"]) + wargs[3:]
    k = hc.histogram_window_quantized(*qargs, W=W)
    assert torch.equal(k, hc.histogram_multi_quantized(
        x["bins"].index_select(0, rows), x["gq"][rows], x["hq"][rows], gm, slot, 0, T, b))
    assert torch.equal(k.cpu(), hc.histogram_window_quantized_plain(
        *[a.cpu() if torch.is_tensor(a) else a for a in qargs], W=W))
    acc = hc.CarryAccumulator(T, f, b, shift, dev)
    hc.histogram_window_carry(*wargs[:7], acc, W=W)
    ref = hc.CarryAccumulator(T, f, b, shift, dev)
    hc.histogram_multi_carry(x["bins"].index_select(0, rows), x["grad"][rows],
                             x["hess"][rows], gm, slot, 0, ref)
    assert torch.equal(acc.acc64, ref.acc64) and torch.equal(acc.acc32, ref.acc32)
    cacc = hc.CarryAccumulator(T, f, b, shift.cpu(), "cpu")
    hc.histogram_window_carry_plain(*cpu[:7], cacc, W=W)
    assert torch.equal(acc.acc64.cpu(), cacc.acc64)
    assert torch.equal(acc.acc32.cpu(), cacc.acc32)


@pytest.mark.parametrize("name", ["windowed_round_megakernel", "windowed_round_quantized",
                                  "ooc_split_chunk", "predict_warm_converted"])
def test_trace_audit_contract_on_card(name):
    """The trace audit on the card (analysis/trace_audit.py): the contract's
    body at its fixture shape, one recorded eager run with the real kernels
    (J1-J7 clean, no copy between host and card), then one capture through
    ops/graphs.py whose launch tally is the declared launches."""
    from lightgbm_tpu_torch.analysis import trace_audit as ta
    from lightgbm_tpu_torch.analysis.contracts import CONTRACTS

    dev = _card()
    c = CONTRACTS[name]
    r = ta.audit_contract(c, dev, capture=True)
    assert r.ok, [f.format() for f in r.findings]
    assert r.detail["graph_launches"] == r.detail["declared_launches"] == \
        r.detail["wrappers"]
    assert r.detail["h2d_bytes"] == 0
    assert 0 < r.detail["device_peak_bytes"] <= r.detail["live_budget"]
