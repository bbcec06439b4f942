"""kernels_per_iter.train: device kernels an iteration in the traced
stretch, launched alone or replayed in a graph.  Moves train_iter_s."""

from gbdt_bench.harness.readings import of_kind


def read(r):
    if not of_kind(r, "train"):
        return None
    return r["stretch"]["kernels"] / r["steps"]
