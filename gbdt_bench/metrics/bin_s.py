"""bin_s: seconds of the benchmark's span around ``Dataset`` construction
(binning and the upload of the binned matrix).  Moves setup_s."""


def read(r):
    return r.get("bin_s") if r.get("kind") == "train" else None
