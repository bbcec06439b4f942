"""Per-leaf linear models (linear trees).

Counterpart of lightgbm_tpu/ops/linear.py (reference:
src/treelearner/linear_tree_learner.cpp -> CalculateLinear): after a tree's
structure is grown with constant leaves, each leaf gets a ridge-regularised
linear model over the numerical features on its path, the Newton step
(X^T H X + lambda I) beta = -X^T g, with the constant leaf value kept for
under-determined leaves and for rows with NaN in a path feature.

As in the JAX package, every leaf's (K+1)x(K+1) moment matrix comes from
K+1 masked products over all rows (the leaf one-hot times the weighted
design rows), and all leaves are solved in one batched solve: fixed shapes,
no per-leaf row lists.  These are plain dense products, so they run as
torch.matmul and torch.linalg.solve_ex in f32, on the card or the CPU.
solve_ex runs without its error check, which would read the card: every
system is positive definite (ridge term), and a non-finite solution marks
its leaf as not fitted.
"""

from __future__ import annotations

import torch


def _path_values(raw, leaf_id, feat_idx, nfeat):
    """Each row's values of its leaf's path features: (vals (N, K) with 0 in
    unused slots and at NaNs, finite (N,) no NaN in a used slot)."""
    k = feat_idx.shape[1]
    lid = leaf_id.long()
    ft = feat_idx[lid].long()  # (N, K)
    ok = torch.arange(k, device=raw.device)[None, :] < nfeat[lid][:, None]
    vals_raw = raw.gather(1, ft)
    fin = torch.isfinite(vals_raw)
    finite = torch.where(ok, fin, True).all(dim=1)
    return torch.where(ok & fin, vals_raw, 0.0), finite


def fit_linear_leaves(raw, leaf_id, grad, hess, row_mask, used, leaf_value,
                      linear_lambda: float, *, K: int, num_leaves: int):
    """Fit every leaf's model.  raw (N, F) f32 raw features (NaN allowed),
    leaf_id (N,), grad / hess (N,) f32, row_mask (N,) bool in-bag rows, used
    (L, F) bool features on each leaf's path, leaf_value (L,) the constant
    outputs.  Each leaf takes its first min(K, path length) path features in
    index order.  Returns (coef (L, K), const (L,), feat_idx (L, K) i32,
    nfeat (L,) i32, pred (N,) each row's output, good (L,) fitted)."""
    dev = raw.device
    L = num_leaves
    n = raw.shape[0]
    nfeat_full = used.sum(dim=1).to(torch.int32)
    # stable: the path features in index order first
    feat_idx = torch.argsort((~used).to(torch.int8), dim=1,
                             stable=True)[:, :K].to(torch.int32)
    nfeat = torch.clamp_max(nfeat_full, K)
    slot_ok = torch.arange(K, device=dev)[None, :] < nfeat[:, None]  # (L, K)

    vals, finite = _path_values(raw, leaf_id, feat_idx, nfeat)
    mrow = row_mask & finite
    w = hess * mrow
    z = torch.cat([vals, torch.ones((n, 1), device=dev)], dim=1)  # (N, K+1)
    u = z * torch.sqrt(torch.clamp_min(w, 0.0))[:, None]
    onehot = (leaf_id.long()[:, None]
              == torch.arange(L, device=dev)[None, :]).float()  # (N, L)
    # (L, K+1, K+1) moments: K+1 masked products over the rows
    M = torch.stack([(onehot * u[:, j:j + 1]).T @ u for j in range(K + 1)], dim=1)
    R = -((onehot * (grad * mrow)[:, None]).T @ z)  # (L, K+1)
    lam = linear_lambda + 1e-6
    eye = torch.eye(K + 1, device=dev)
    # padded slots get a unit diagonal, so the system stays well posed and
    # their coefficients come out ~0 (then masked exactly)
    pad_diag = torch.cat([(~slot_ok).float(), torch.zeros((L, 1), device=dev)], dim=1)
    A = M + (lam * eye)[None] + pad_diag[:, :, None] * eye[None]
    beta = torch.linalg.solve_ex(A, R[..., None], check_errors=False)[0][..., 0]
    coef = torch.where(slot_ok, beta[:, :K], 0.0)
    const = beta[:, K]

    cnt = (onehot * mrow[:, None]).sum(dim=0)  # (L,)
    good = ((nfeat > 0) & torch.isfinite(beta).all(dim=1)
            & (cnt > nfeat.float() + 1.0))
    coef = torch.where(good[:, None], coef, 0.0)
    const = torch.where(good, const, leaf_value)
    lid = leaf_id.long()
    pred = const[lid] + (coef[lid] * vals).sum(dim=1)
    pred = torch.where(finite & good[lid], pred, leaf_value[lid])
    return coef, const, feat_idx, nfeat, pred, good


def predict_linear_rows(raw, leaf_id, coef, const, feat_idx, nfeat, leaf_value):
    """Each row's output of a linear tree from its leaf: (N,) f32; rows with
    NaN in a path feature take the constant ``leaf_value`` of their leaf."""
    vals, finite = _path_values(raw, leaf_id, feat_idx, nfeat)
    lid = leaf_id.long()
    pred = const[lid] + (coef[lid] * vals).sum(dim=1)
    return torch.where(finite, pred, leaf_value[lid])
