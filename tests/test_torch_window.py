"""B1's window mode (ops/hist_cuda.py::histogram_window, _quantized and
_carry): the three-pass round's windows read through the row order.

On the CPU each entry takes its plain version, which gathers the window's
rows (hist_cuda.window_rows) and histograms them; these tests hold that
plain version, bit for bit, to the multi-leaf plain histogram over the
window gathered with ``index_select`` -- the route the three-pass round
took before it read the windows through the order -- for float, bf16 and
int8 payloads and the carried sums, on the window edges (empty windows,
positions past W, an all-masked window) and on a bundled (EFB) matrix;
and the gathered window against the JAX package's one-hot histogram of
the same rows (int8 bitwise, float within the 2e-4 of tests/
test_torch_hist.py: the JAX side splits products bf16x2).  The card runs
the kernel against these in tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops.histogram import (histogram_onehot_multi,
                                        histogram_onehot_multi_quantized)
from lightgbm_tpu_torch.ops import hist_cuda

# geometry -> (windows' starts, counts, W) over N = 600 positions
GEOMETRIES = {
    "plain": ([10, 200, 390], [40, 120, 75], 300),
    "empty_windows": ([0, 50, 0, 300], [0, 80, 0, 33], 200),
    "past_W": ([5, 100, 400], [90, 150, 120], 256),
    "all_masked": ([0, 100, 300], [60, 50, 70], 256),
    "all_empty": ([0, 0], [0, 0], 64),
}
N, F, B = 600, 6, 63


def _case(geometry, seed=0, f=F, b=B):
    rng = np.random.RandomState(seed)
    start, cnt, W = GEOMETRIES[geometry]
    mask = rng.rand(N) < 0.85
    order = rng.permutation(N).astype(np.int32)
    if geometry == "all_masked":  # the second window's rows all masked out
        mask[order[start[1]:start[1] + cnt[1]]] = False
    return dict(
        bins=torch.as_tensor(rng.randint(0, b, (N, f)).astype(np.int16)),
        grad=torch.as_tensor(rng.randn(N).astype(np.float32) * 3),
        hess=torch.as_tensor(rng.rand(N).astype(np.float32)),
        gq=torch.as_tensor(rng.randint(-8, 9, N).astype(np.int8)),
        hq=torch.as_tensor(rng.randint(0, 17, N).astype(np.int8)),
        mask=torch.as_tensor(mask), order=torch.as_tensor(order),
        win_start=torch.tensor(start, dtype=torch.int32),
        win_cnt=torch.tensor(cnt, dtype=torch.int32), W=W, T=len(cnt))


def _gathered(x, bins, vals):
    """The window copied as the three-pass round used to copy it."""
    rows, slot, valid = hist_cuda.window_rows(x["order"], x["win_start"], x["win_cnt"],
                                              x["W"])
    return (bins.index_select(0, rows), vals[0][rows], vals[1][rows],
            x["mask"][rows] & valid, slot)


def _window_args(x, bins, vals):
    return (bins, vals[0], vals[1], x["mask"], x["order"], x["win_start"], x["win_cnt"],
            x["T"])


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_float_window_equals_the_gathered_window(geometry, precision):
    x = _case(geometry)
    shift = hist_cuda.fixed_shift_tensor(x["grad"], x["hess"])
    vals = (x["grad"], x["hess"])
    want = hist_cuda.histogram_multi_plain(*_gathered(x, x["bins"], vals), 0, x["T"], B,
                                           shift=shift, precision=precision)
    args = _window_args(x, x["bins"], vals)
    got = hist_cuda.histogram_window_plain(*args, B, W=x["W"], shift=shift,
                                           precision=precision)
    assert torch.equal(got, want)
    # the dispatching entry takes the plain version for CPU tensors
    assert torch.equal(hist_cuda.histogram_window(*args, B, W=x["W"], shift=shift,
                                                  precision=precision), want)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_int8_window_equals_the_gathered_window(geometry):
    x = _case(geometry, seed=1)
    vals = (x["gq"], x["hq"])
    want = hist_cuda.histogram_multi_quantized_plain(*_gathered(x, x["bins"], vals), 0,
                                                     x["T"], B)
    args = _window_args(x, x["bins"], vals)
    assert torch.equal(hist_cuda.histogram_window_quantized_plain(*args, B, W=x["W"]),
                       want)
    assert torch.equal(hist_cuda.histogram_window_quantized(*args, B, W=x["W"]), want)
    # positions past W and masked rows add nothing
    rows, _, valid = hist_cuda.window_rows(x["order"], x["win_start"], x["win_cnt"],
                                           x["W"])
    assert int(want[:, 2, 0].sum()) == int((x["mask"][rows] & valid).sum())


@pytest.mark.parametrize("geometry", ["plain", "empty_windows", "past_W"])
def test_carried_window_equals_the_carried_gathered_window(geometry):
    x = _case(geometry, seed=2)
    shift = hist_cuda.fixed_shift_tensor(x["grad"], x["hess"])
    want = hist_cuda.CarryAccumulator(x["T"], F, B, shift, "cpu")
    hist_cuda.carry_sums_plain(*_gathered(x, x["bins"], (x["grad"], x["hess"])), 0, want)
    for fn in (hist_cuda.histogram_window_carry, hist_cuda.histogram_window_carry_plain):
        acc = hist_cuda.CarryAccumulator(x["T"], F, B, shift, "cpu")
        # two calls add: the carried sums of the window twice
        for _ in range(2):
            fn(*_window_args(x, x["bins"], (x["grad"], x["hess"]))[:-1], acc, W=x["W"])
        assert torch.equal(acc.acc64, 2 * want.acc64)
        assert torch.equal(acc.acc32, 2 * want.acc32)
    # converted once, the float window's histogram
    one = hist_cuda.CarryAccumulator(x["T"], F, B, shift, "cpu")
    hist_cuda.histogram_window_carry(*_window_args(x, x["bins"], (x["grad"], x["hess"]))[:-1],
                                     one, W=x["W"])
    assert torch.equal(hist_cuda.carry_convert(one.acc64, one.acc32, shift),
                       hist_cuda.histogram_window_plain(
                           *_window_args(x, x["bins"], (x["grad"], x["hess"])), B,
                           W=x["W"], shift=shift))


@pytest.mark.parametrize("quantized", [False, True])
def test_window_over_a_bundled_matrix(quantized):
    """An EFB bundled matrix (io/efb.py::find_bundles over one-hot-like
    columns): fewer, wider columns, bins beyond any one feature's."""
    from lightgbm_tpu_torch.io.efb import find_bundles

    rng = np.random.RandomState(4)
    n_raw, b = 12, 16
    raw = np.zeros((N, n_raw), np.int32)
    hot = rng.randint(0, n_raw, N)
    raw[np.arange(N), hot] = rng.randint(1, b, N)
    plan = find_bundles(raw, np.full(n_raw, b), 255)
    bundled = torch.as_tensor(plan.bundled_bins.astype(np.int16))
    assert bundled.shape[1] < n_raw and int(bundled.max()) > b
    x = _case("past_W", seed=5)
    nb = int(bundled.max()) + 1
    vals = (x["gq"], x["hq"]) if quantized else (x["grad"], x["hess"])
    args = _window_args(x, bundled, vals)
    if quantized:
        want = hist_cuda.histogram_multi_quantized_plain(*_gathered(x, bundled, vals), 0,
                                                         x["T"], nb)
        got = hist_cuda.histogram_window_quantized(*args, nb, W=x["W"])
    else:
        shift = hist_cuda.fixed_shift_tensor(x["grad"], x["hess"])
        want = hist_cuda.histogram_multi_plain(*_gathered(x, bundled, vals), 0, x["T"], nb,
                                               shift=shift)
        got = hist_cuda.histogram_window(*args, nb, W=x["W"], shift=shift)
    assert torch.equal(got, want)


@pytest.mark.parametrize("quantized", [False, True])
def test_window_matches_the_jax_onehot_histogram_of_its_rows(quantized):
    x = _case("past_W", seed=6)
    vals = (x["gq"], x["hq"]) if quantized else (x["grad"], x["hess"])
    bins, g, h, m, slot = (t.numpy() for t in _gathered(x, x["bins"], vals))
    jargs = (jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h), jnp.asarray(m),
             jnp.asarray(slot), 0, x["T"], B)
    args = _window_args(x, x["bins"], vals)
    if quantized:
        ref = np.asarray(histogram_onehot_multi_quantized(*jargs))
        got = hist_cuda.histogram_window_quantized(*args, B, W=x["W"]).numpy()
        np.testing.assert_array_equal(got, ref)
        return
    ref = np.asarray(histogram_onehot_multi(*jargs), np.float64)
    got = hist_cuda.histogram_window(*args, B, W=x["W"],
                                     shift=hist_cuda.fixed_shift_tensor(x["grad"],
                                                                        x["hess"]))
    got = got.numpy().astype(np.float64)
    for c in range(3):
        scale = max(np.abs(ref[:, c]).max(), 1.0)
        np.testing.assert_allclose(got[:, c], ref[:, c], rtol=2e-4, atol=2e-4 * scale)


def test_window_entries_check_their_inputs_and_need_the_shift():
    x = _case("plain")
    args = _window_args(x, x["bins"], (x["grad"], x["hess"]))
    with pytest.raises(TypeError, match="exponent pair"):
        hist_cuda.histogram_window(*args, B, W=x["W"], shift=None)
    # the plain version counts its calls, the kernel's launches stay 0
    hist_cuda.reset_counts()
    hist_cuda.histogram_window(*args, B, W=x["W"], shift=(40, 40))
    hist_cuda.histogram_window_quantized(*_window_args(x, x["bins"], (x["gq"], x["hq"])),
                                         B, W=x["W"])
    assert hist_cuda.plain_calls["histogram_window"] == 1
    assert hist_cuda.plain_calls["histogram_window_quantized"] == 1
    assert sum(hist_cuda.launches.values()) == 0
