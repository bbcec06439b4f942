"""Seeded tables of the public sets' shapes, made on the device.

Frozen copies of ``chip_smoke.py::higgs_like`` and ``chip_smoke.py::epsilon_like``
(the port's bring-up script), vectorised in float32 with torch so that a set of
11M rows is made in a few large calls on the card.  The shapes are those of the
originals; the values differ from theirs (another generator), and are the same
for the same seed on the same device.

Each returns ``(X, y)``: X float32 (n, F) with 1% NaN, y float32 in {0, 1}.
"""

from __future__ import annotations

import math

import torch

HIGGS_FEATURES = 28
EPSILON_FEATURES = 2000


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def higgs_like(n: int, seed: int, device):
    """UCI HIGGS's shape: 21 low-level kinematic columns, then 7
    high-level masses; ~53% signal."""
    g = generator(seed, device)
    dev = torch.device(device)

    def rand(*shape):
        return torch.rand(*shape, generator=g, device=dev)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    def lognormal(mu, sigma):
        return torch.exp(mu + sigma * randn(n))

    y = (rand(n) < 0.53).float()
    X = torch.empty((n, HIGGS_FEATURES), dtype=torch.float32, device=dev)
    # lepton pT / eta / phi, missing energy magnitude / phi
    X[:, 0] = lognormal(-0.1 + 0.1 * y, 0.5)
    X[:, 1] = randn(n) * 1.1
    X[:, 2] = (rand(n) * 2 - 1) * math.pi
    X[:, 3] = lognormal(-0.2 + 0.15 * y, 0.6)
    X[:, 4] = (rand(n) * 2 - 1) * math.pi
    # 4 jets x (pT, eta, phi, b-tag)
    for j in range(4):
        c = 5 + 4 * j
        X[:, c] = lognormal(-0.1 * j + 0.05 * y, 0.5)
        X[:, c + 1] = randn(n) * (1.0 + 0.1 * j)
        X[:, c + 2] = (rand(n) * 2 - 1) * math.pi
        p_b = 0.25 + 0.2 * y * float(j < 2)
        X[:, c + 3] = (torch.where(rand(n) < p_b, 2.17, 0.0)
                       + torch.where(rand(n) < 0.1, 1.09, 0.0))
    # 7 high-level masses: signal peaks, background broad
    peaks = (1.0, 1.02, 0.98, 0.95, 0.85, 1.05, 1.1)
    for k, peak in enumerate(peaks):
        sig = peak + (0.12 + 0.03 * k) * randn(n)
        bkg = lognormal(math.log(peak) + 0.1, 0.45)
        X[:, 21 + k] = torch.where((y > 0) & (rand(n) < 0.6), sig, bkg)
    # some missing values, as users' data have
    X[rand(n, HIGGS_FEATURES) < 0.01] = float("nan")
    return X, y


def epsilon_like(n: int, seed: int, device, features: int = EPSILON_FEATURES):
    """PASCAL "epsilon"'s shape: dense standardised features, a balanced
    label from a noisy linear model plus pairwise interactions."""
    g = generator(seed, device)
    dev = torch.device(device)
    X = torch.randn((n, features), generator=g, device=dev)
    w = torch.randn(features, generator=g, device=dev) * torch.exp(
        -torch.arange(features, device=dev, dtype=torch.float32) / 300.0)
    # float64 for the label's linear part: no TF32, the same bits on any card
    z = (X.double() @ w.double()).float() / torch.sqrt((w * w).sum())
    for a, b in ((0, 1), (2, 3), (10, 20), (30, 40)):
        if b < features:
            z += 0.5 * X[:, a] * X[:, b]
    z += torch.randn(n, generator=g, device=dev)
    y = (z > z.median()).float()
    X[torch.rand((n, features), generator=g, device=dev) < 0.01] = float("nan")
    return X, y


TABLES = {"higgs_like": higgs_like, "epsilon_like": epsilon_like}


def make(name: str, n: int, seed: int, device, **kw):
    """The table ``name`` of ``n`` rows from ``seed`` on ``device``."""
    return TABLES[name](n, seed, device, **kw)
