"""Faults planted under the timed path, to show that ``correct`` catches them
(``--fault``; never in the benchmark's own runs).

Training:
  * ``unchanged``: a boosting step that returns and leaves the model and
    the scores as they were;
  * ``half_batch``: the second half of the rows left out of every step's
    gradients and hessians (each leaf's value is then a ratio over the
    rest);
  * ``altered``: the first leaf of every tree 1% off its value, where the
    grower hands the tree over.
Prediction:
  * ``half_batch``: the second half of each call's answers replaced by the
    mean of the first half's;
  * ``altered``: each call's first answer moved by 0.01.
"""

from __future__ import annotations

import numpy as np

TRAIN = ("unchanged", "half_batch", "altered")
PREDICT = ("half_batch", "altered")


def plant(name: str, kind: str):
    """Plant fault ``name`` in the port's classes; returns the call that
    takes it out again."""
    if name is None:
        return lambda: None
    allowed = TRAIN if kind == "train" else PREDICT
    if name not in allowed:
        raise ValueError(f"fault {name!r}: a {kind} run plants one of {allowed}")
    from lightgbm_tpu_torch import objectives
    from lightgbm_tpu_torch.models import gbdt

    saved = [(gbdt.GBDT, k, gbdt.GBDT.__dict__[k])
             for k in ("train_one_iter", "_renew", "predict")]
    saved.append((objectives.BinaryLogloss, "get_gradients",
                  objectives.BinaryLogloss.__dict__["get_gradients"]))

    def undo():
        for cls, k, v in saved:
            setattr(cls, k, v)
    if kind == "train" and name == "unchanged":
        gbdt.GBDT.train_one_iter = lambda self, grad=None, hess=None: False
    elif kind == "train" and name == "half_batch":
        inner = objectives.BinaryLogloss.get_gradients

        def half(self, score, label, weight):
            g, h = inner(self, score, label, weight)
            n = g.shape[0] // 2
            g, h = g.clone(), h.clone()
            g[n:] = 0.0
            h[n:] = 0.0
            return g, h
        objectives.BinaryLogloss.get_gradients = half
    elif kind == "train" and name == "altered":
        inner = gbdt.GBDT._renew

        def renew(self, arrays, leaf_id, c):
            arrays = inner(self, arrays, leaf_id, c)
            v = arrays.leaf_value.clone()
            v[0] = v[0] * 1.01
            return arrays._replace(leaf_value=v)
        gbdt.GBDT._renew = renew
    else:
        inner = gbdt.GBDT.predict

        def predict(self, X, *a, **kw):
            out = np.array(inner(self, X, *a, **kw))
            if name == "altered":
                out[0] += 0.01
            else:
                n = len(out) // 2
                out[n:] = out[:n].mean()
            return out
        gbdt.GBDT.predict = predict
    return undo
