"""round_roofline.train: the histogram and partition bytes the traced trees
need (``roofline/needed_bytes.py``) at the card's HBM peak, over the device
time of B3's, B2's and B1's kernels (csrc/round.cu, partition*.cu*,
hist*.cu*) in the traced stretch, in %.  Moves train_iter_s."""

from gbdt_bench.harness.readings import device_seconds, of_kind, roofline_pct

KERNELS = ("gain_kernel", "cat_gain_kernel", "subtract_kernel", "partition_kernel",
           "partition_fused_kernel", "partition_lanes_kernel", "hist_kernel",
           "absmax_kernel", "finalize_kernel", "finalize_lanes_kernel")


def read(r):
    if not of_kind(r, "train"):
        return None
    b = r["bytes"]["hist"] + r["bytes"]["partition"]
    return roofline_pct(r, b, device_seconds(r, KERNELS), r["steps"])
