"""idle_share.train: 1 - device busy / wall over the traced stretch of
training steps (busy: the union of kernel, copy and set intervals).  Moves
train_iter_s."""

from gbdt_bench.harness.readings import of_kind


def read(r):
    if not of_kind(r, "train"):
        return None
    s = r["stretch"]
    return 1.0 - s["busy_s"] / s["window_s"]
