"""Histogram parity: lightgbm_tpu_torch's plain histogram against the JAX
package's Pallas kernel (run through the Pallas interpreter) and its XLA
one-hot einsum.

On the CPU the port's wrappers take the plain PyTorch version, the same
arithmetic the Hopper kernel does (64-bit fixed point for float payloads,
exact int32 for int8).  Tolerances:

* int8: bitwise -- both sides add the same integers exactly;
* float: 2e-4 relative to the channel's largest magnitude -- the JAX side
  splits payloads bf16x2 (about 17 mantissa bits per product), the port
  sums in fixed point (about 42 bits below the largest value);
* float against a float64 numpy sum: 1e-6 relative -- the fixed point is
  rounded to f32 once, at the end.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas

from lightgbm_tpu.ops import hist_pallas
from lightgbm_tpu.ops.histogram import (histogram_onehot_multi,
                                        histogram_onehot_multi_quantized)
from lightgbm_tpu_torch.ops import hist_cuda
from lightgbm_tpu_torch.ops import histogram as port_hist

# (num_bins, tile, rows, leaf_base): every B in {16, 63, 255}, every tile in
# {1, 8, 20}, ragged row counts and leaf_base > 0
CASES = [
    (16, 1, 1000, 0),
    (63, 8, 2049, 3),
    (255, 20, 3001, 5),
    (255, 8, 1537, 0),
]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def interpret(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode on the CPU."""
    monkeypatch.setattr(pallas, "pallas_call",
                        functools.partial(pallas.pallas_call, interpret=True))


def _inputs(b, tile, n, base, f=5, seed=0):
    rng = np.random.RandomState(seed + b + tile)
    bins = rng.randint(0, b, (n, f)).astype(np.int16)
    grad = rng.randn(n).astype(np.float32)
    hess = (rng.rand(n) * 0.25).astype(np.float32)
    mask = rng.rand(n) < 0.85
    # ids below base, -1 and beyond the tile contribute nothing
    leaf = rng.randint(-1, base + tile + 2, n).astype(np.int32)
    gq = rng.randint(-8, 9, n).astype(np.int8)
    hq = rng.randint(0, 17, n).astype(np.int8)
    return bins, grad, hess, mask, leaf, gq, hq


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close_f32(port, ref):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    for c in range(3):
        scale = max(np.abs(ref[:, c]).max(), 1.0)
        np.testing.assert_allclose(port[:, c], ref[:, c], rtol=2e-4,
                                   atol=2e-4 * scale)


@pytest.mark.parametrize("b,tile,n,base", CASES)
def test_float_matches_pallas_interpret_and_onehot(interpret, b, tile, n, base):
    bins, grad, hess, mask, leaf, _, _ = _inputs(b, tile, n, base)
    jargs = (jnp.asarray(bins), jnp.asarray(grad), jnp.asarray(hess),
             jnp.asarray(mask), jnp.asarray(leaf), base, tile, b)
    ref_pallas = np.asarray(hist_pallas.histogram_pallas_multi(*jargs))
    ref_onehot = np.asarray(histogram_onehot_multi(*jargs))
    port = port_hist.histogram_multi(_t(bins), _t(grad), _t(hess), _t(mask),
                                     _t(leaf), base, tile, b)
    assert port.dtype == torch.float32 and port.shape == (tile, 3, 5, b)
    _close_f32(port.numpy(), ref_pallas)
    _close_f32(port.numpy(), ref_onehot)


@pytest.mark.parametrize("b,tile,n,base", CASES)
def test_int8_bitwise_pallas_interpret_and_onehot(interpret, b, tile, n, base):
    bins, _, _, mask, leaf, gq, hq = _inputs(b, tile, n, base)
    jargs = (jnp.asarray(bins), jnp.asarray(gq), jnp.asarray(hq),
             jnp.asarray(mask), jnp.asarray(leaf), base, tile, b)
    ref_pallas = np.asarray(hist_pallas.histogram_pallas_multi_quantized(*jargs))
    ref_onehot = np.asarray(histogram_onehot_multi_quantized(*jargs))
    port = port_hist.histogram_multi_quantized(
        _t(bins), _t(gq), _t(hq), _t(mask), _t(leaf), base, tile, b)
    assert port.dtype == torch.int32
    np.testing.assert_array_equal(port.numpy(), ref_pallas)
    np.testing.assert_array_equal(port.numpy(), ref_onehot)


def test_float_fixed_point_against_float64_sum():
    b, tile, n, base = 255, 8, 4001, 2
    bins, grad, hess, mask, leaf, _, _ = _inputs(b, tile, n, base, f=7, seed=3)
    grad = grad * np.float32(1e3)  # magnitudes far from 1 take the shift
    want = np.zeros((tile, 3, 7, b))
    s = leaf.astype(np.int64) - base
    for r in np.nonzero(mask & (s >= 0) & (s < tile))[0]:
        for j in range(7):
            want[s[r], :, j, bins[r, j]] += (grad[r], hess[r], 1.0)
    got = hist_cuda.histogram_multi(_t(bins), _t(grad), _t(hess), _t(mask),
                                    _t(leaf), base, tile, b).numpy()
    for c in range(3):
        scale = np.abs(want[:, c]).max()
        np.testing.assert_allclose(got[:, c], want[:, c], rtol=1e-6,
                                   atol=1e-6 * scale)


def test_single_leaf_entries_are_tile_one_calls():
    b = 63
    bins, grad, hess, mask, _, gq, hq = _inputs(b, 1, 900, 0, seed=5)
    zero = np.zeros(900, np.int32)
    one = hist_cuda.histogram(_t(bins), _t(grad), _t(hess), _t(mask), b)
    multi = hist_cuda.histogram_multi(_t(bins), _t(grad), _t(hess), _t(mask),
                                      _t(zero), 0, 1, b)
    assert torch.equal(one, multi[0])
    q = hist_cuda.histogram_quantized(_t(bins), _t(gq), _t(hq), _t(mask), b)
    qm = hist_cuda.histogram_multi_quantized(_t(bins), _t(gq), _t(hq), _t(mask),
                                             _t(zero), 0, 1, b)
    assert torch.equal(q, qm[0])
    # the channels are (grad, hess, count) of the masked rows
    np.testing.assert_allclose(one[2].sum(1).numpy(), mask.sum())
    assert int(q[0].sum(1)[0]) == int(gq[mask].astype(np.int64).sum())


def test_cpu_dispatch_counts_plain_calls_only():
    hist_cuda.reset_counts()
    bins, grad, hess, mask, leaf, gq, hq = _inputs(16, 8, 300, 0)
    hist_cuda.histogram_multi(_t(bins), _t(grad), _t(hess), _t(mask),
                              _t(leaf), 0, 8, 16)
    hist_cuda.histogram_multi_quantized(_t(bins), _t(gq), _t(hq), _t(mask),
                                        _t(leaf), 0, 8, 16)
    assert hist_cuda.launches == {"histogram_multi": 0,
                                  "histogram_multi_quantized": 0}
    assert hist_cuda.plain_calls == {"histogram_multi": 1,
                                     "histogram_multi_quantized": 1}


@pytest.mark.parametrize("bad", ["bins_dtype", "grad_dtype", "mask_dtype",
                                 "slot_shape", "strided", "tile"])
def test_wrapper_input_checks(bad):
    n = 64
    args = dict(bins=torch.zeros((n, 3), dtype=torch.int16),
                grad=torch.zeros(n), hess=torch.zeros(n),
                mask=torch.ones(n, dtype=torch.bool),
                slot=torch.zeros(n, dtype=torch.int32), tile=2)
    if bad == "bins_dtype":
        args["bins"] = args["bins"].int()
    elif bad == "grad_dtype":
        args["grad"] = args["grad"].double()
    elif bad == "mask_dtype":
        args["mask"] = args["mask"].float()
    elif bad == "slot_shape":
        args["slot"] = args["slot"][:-1]
    elif bad == "strided":
        args["grad"] = torch.zeros(2 * n)[::2]
    elif bad == "tile":
        args["tile"] = 0
    with pytest.raises((TypeError, ValueError)):
        hist_cuda._check(args["bins"], (args["grad"], args["hess"]),
                         args["mask"], args["slot"], torch.float32,
                         args["tile"], 16)


def test_leaf_tile_policy_matches_jax():
    for b, f, nl, q in [(255, 28, 31, False), (255, 28, 31, True),
                        (63, 5, 15, False), (255, 2000, 255, True),
                        (255, 2000, 255, False), (16, 3, 4, False)]:
        assert hist_cuda.recommended_leaf_tile(b, f, nl, quantized=q) == \
            hist_pallas.recommended_leaf_tile(b, f, nl, quantized=q)
    assert hist_cuda.recommended_leaf_tile(255, 28, 31) == 8
    assert hist_cuda.recommended_leaf_tile(255, 28, 31, quantized=True) == 20


def test_jax_is_on_cpu():
    assert jax.default_backend() == "cpu"
