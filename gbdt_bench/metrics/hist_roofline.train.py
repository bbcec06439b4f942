"""hist_roofline.train: the histogram bytes the traced trees need
(``roofline/needed_bytes.py::hist_bytes``) at the card's HBM peak, over the
device time of B1's kernels (csrc/hist.cu, hist_common.cuh) in the traced
stretch, in %.  Moves train_iter_s."""

from gbdt_bench.harness.readings import device_seconds, of_kind, roofline_pct

KERNELS = ("hist_kernel", "absmax_kernel", "finalize_kernel", "finalize_lanes_kernel")


def read(r):
    if not of_kind(r, "train"):
        return None
    return roofline_pct(r, r["bytes"]["hist"], device_seconds(r, KERNELS), r["steps"])
