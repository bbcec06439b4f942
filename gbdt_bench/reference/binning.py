"""Plain reference of the port's feature binning (LightGBM's greedy
equal-count bins over a row sample, a last bin for NaN).

Semantics, per numerical feature, over the sampled rows' values as float64:
  * the rows are sampled as LightGBM's port samples them: when the set has
    more than ``sample_cnt`` rows, ``numpy.random.RandomState(seed).choice(n,
    sample_cnt, replace=False)``; otherwise all rows;
  * NaN values take their own bin, last, when the sample has any; the other
    bins then number at most ``max_bin - 1``;
  * with at most that many distinct values: a bound at the midpoint of two
    neighbouring values wherever the bin so far holds ``min_data_in_bin``
    values and the rest can still fill one;
  * otherwise greedy equal-count bins: a value whose count reaches the mean
    bin size stands alone; a bin closes at the first distinct value j where
    j is such a value, or j + 1 is, or the running count reaches
    ceil(mean bin size) (the mean recomputed over the values that do not
    stand alone); its bound is the midpoint of values j and j + 1;
  * the last bound is +inf; a value's bin is the first bound >= it.

The greedy walk runs on every feature at once, one step a bin, in torch.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch


def sample_rows(n: int, sample_cnt: int, seed: int):
    """Indices of the binning sample (None: every row)."""
    if n <= sample_cnt:
        return None
    return np.random.RandomState(seed).choice(n, size=sample_cnt, replace=False)


def _few_values(vals: np.ndarray, cnts: np.ndarray, min_data_in_bin: int) -> List[float]:
    total = int(cnts.sum())
    bounds, cur, seen = [], 0, 0
    for i in range(len(vals) - 1):
        cur += int(cnts[i])
        seen += int(cnts[i])
        if cur >= min_data_in_bin and total - seen >= min_data_in_bin:
            bounds.append((float(vals[i]) + float(vals[i + 1])) / 2.0)
            cur = 0
    return bounds + [math.inf]


def bin_bounds(sample: torch.Tensor, max_bin: int, min_data_in_bin: int = 3,
               chunk: int = 256) -> List[np.ndarray]:
    """Upper bounds of every column of ``sample`` ((S, F) float64), and
    whether each column has a NaN bin: returns (bounds, has_nan)."""
    S, F = sample.shape
    bounds: List[np.ndarray] = [None] * F
    has_nan = torch.isnan(sample).any(0).cpu().numpy()
    for lo in range(0, F, chunk):
        cols = sample[:, lo:lo + chunk].T.contiguous()  # (C, S)
        C = cols.shape[0]
        srt = torch.sort(cols, dim=1).values  # NaN last
        n_clean = (~torch.isnan(srt)).sum(1)
        pos = torch.arange(S, device=srt.device)
        clean = pos[None, :] < n_clean[:, None]
        new = clean.clone()
        new[:, 1:] &= srt[:, 1:] != srt[:, :-1]
        slot = torch.cumsum(new.long(), 1) - 1
        D = new.sum(1)
        vals = torch.full((C, S), math.inf, dtype=torch.float64, device=srt.device)
        cnts = torch.zeros((C, S), dtype=torch.int64, device=srt.device)
        rows = torch.arange(C, device=srt.device)[:, None].expand(C, S)
        vals[rows[new], slot[new]] = srt[new]
        cnts.index_put_((rows[clean], slot[clean]), torch.ones_like(slot[clean]),
                        accumulate=True)
        n_avail = torch.full((C,), max_bin, dtype=torch.int64, device=srt.device)
        n_avail -= torch.as_tensor(has_nan[lo:lo + C], device=srt.device).long()
        n_avail.clamp_(min=1)
        cum = torch.cumsum(cnts, 1)
        total = n_clean.double()
        mean = torch.maximum(total / n_avail, torch.full_like(total, float(min_data_in_bin)))
        idx = pos[None, :].expand(C, S)
        big = (cnts.double() >= mean[:, None]) & (idx < D[:, None])
        rest_cnt = total - torch.where(big, cnts, 0).sum(1).double()
        rest_bins = n_avail - big.sum(1)
        mean = torch.where(rest_bins > 0,
                           torch.maximum(rest_cnt / rest_bins.clamp(min=1).double(),
                                         torch.full_like(total, float(min_data_in_bin))),
                           mean)
        need = torch.ceil(mean).long()
        # next_big[c, i]: the first value at or after i that stands alone
        nb = torch.where(big, idx, S)
        next_big = torch.flip(torch.cummin(torch.flip(nb, [1]), 1).values, [1])
        next_big = torch.cat([next_big, torch.full((C, 1), S, device=srt.device,
                                                   dtype=torch.int64)], 1)
        i = torch.zeros(C, dtype=torch.int64, device=srt.device)
        base = torch.zeros(C, dtype=torch.int64, device=srt.device)
        live = (D > n_avail) & (D > 1)
        found = torch.zeros((C, max_bin), dtype=torch.float64, device=srt.device)
        count = torch.zeros(C, dtype=torch.int64, device=srt.device)
        for _ in range(max_bin):
            live &= (i < D - 1) & (count < n_avail - 1)
            if not bool(live.any()):
                break
            j = next_big.gather(1, i[:, None])[:, 0].clamp(max=S)
            j = torch.where(j >= D, D, j)
            nxt = next_big.gather(1, (i + 1).clamp(max=S)[:, None])[:, 0]
            j = torch.where(nxt < D, torch.minimum(j, nxt - 1), j)
            target = (base + need)[:, None]
            j = torch.minimum(j, torch.searchsorted(cum, target, side="left")[:, 0])
            live &= j < D - 1
            jj = j.clamp(max=S - 2)
            mid = (vals.gather(1, jj[:, None]) + vals.gather(1, (jj + 1)[:, None]))[:, 0] / 2.0
            found[rows[:, 0][live], count[live]] = mid[live]
            base = torch.where(live, cum.gather(1, jj[:, None])[:, 0], base)
            i = torch.where(live, j + 1, i)
            count = count + live.long()
        found_h, count_h = found.cpu().numpy(), count.cpu().numpy()
        D_h, n_avail_h = D.cpu().numpy(), n_avail.cpu().numpy()
        for c in range(C):
            if D_h[c] <= n_avail_h[c]:
                d = int(D_h[c])
                v = vals[c, :d].cpu().numpy()
                k = cnts[c, :d].cpu().numpy()
                b = _few_values(v, k, min_data_in_bin) if d else [math.inf]
            else:
                b = list(found_h[c, :count_h[c]]) + [math.inf]
            bounds[lo + c] = np.unique(np.asarray(b, dtype=np.float64))
    return bounds, has_nan


def transform(X: torch.Tensor, bounds: List[np.ndarray], has_nan,
              rows_per_chunk: int = 1 << 21) -> torch.Tensor:
    """Bins (N, F) uint8 of raw values X ((N, F) float32, on the device):
    the first bound >= the value, the last bound for values beyond, and the
    NaN bin (after the others) for NaN where the feature has one."""
    N, F = X.shape
    dev = X.device
    K = max(len(b) for b in bounds)
    ub = torch.full((F, K), math.inf, dtype=torch.float64, device=dev)
    for j, b in enumerate(bounds):
        ub[j, :len(b)] = torch.as_tensor(b, device=dev)
    last = torch.as_tensor([len(b) - 1 for b in bounds], device=dev)[:, None]
    nan_bin = torch.where(torch.as_tensor(np.asarray(has_nan), device=dev),
                          last[:, 0] + 1, last[:, 0])[:, None]
    out = torch.empty((N, F), dtype=torch.uint8, device=dev)
    for lo in range(0, N, rows_per_chunk):
        v = X[lo:lo + rows_per_chunk].double().T.contiguous()
        b = torch.minimum(torch.searchsorted(ub, v, side="left"), last)
        b = torch.where(torch.isnan(v), nan_bin, b)
        out[lo:lo + rows_per_chunk] = b.T.to(torch.uint8)
    return out


def tables(bounds: List[np.ndarray], has_nan, device):
    """Per feature: number of bins (with the NaN bin) and the NaN bin (-1:
    none)."""
    nb = np.asarray([len(b) + int(h) for b, h in zip(bounds, has_nan)], np.int64)
    mb = np.where(np.asarray(has_nan), nb - 1, -1)
    return (torch.as_tensor(nb, device=device), torch.as_tensor(mb, device=device))
