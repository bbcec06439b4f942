"""Hand-written Hopper kernels against their plain versions, on the card.

Marked ``gpu``; each test decides inside itself whether a card is present
and skips otherwise.  Run on a machine with a card (no JAX needed there):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Tolerances: int8 histograms are exact; float histograms are held to
1e-5 * (max|hess| + 1), the f32 summation-order bound, though the 64-bit
fixed point makes kernel and plain version agree bit for bit.
"""

import numpy as np
import pytest
import torch

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
    p = {"objective": "binary", "num_leaves": 15, "verbosity": -1}
    hc.reset_counts()
    bst = tlgb.train(p, tlgb.Dataset(X, label=y, params=p), 5)
    assert hc.launches["histogram_multi"] >= 5
    assert hc.plain_calls == {"histogram_multi": 0, "histogram_multi_quantized": 0}
    pc = {**p, "device_type": "cpu"}
    ref = tlgb.train(pc, tlgb.Dataset(X, label=y, params=pc), 5)
    np.testing.assert_allclose(bst.predict(X), ref.predict(X), atol=1e-4)
