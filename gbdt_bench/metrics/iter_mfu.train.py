"""iter_mfu.train: the whole iteration's share of the card's peak, in %:
the bytes the traced trees need (histograms, partition, gradients, score
update; ``roofline/needed_bytes.py::iteration_bytes``) at the HBM peak,
over the wall time an iteration after the traced stretch.  Training does
almost no arithmetic a byte, so bandwidth is the peak that binds.  Moves
train_iter_s."""

from gbdt_bench.harness.readings import of_kind, roofline_pct


def read(r):
    if not of_kind(r, "train"):
        return None
    return roofline_pct(r, r["bytes"]["total"], r["wall_per_step_s"], 1)
