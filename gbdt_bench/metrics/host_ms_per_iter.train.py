"""host_ms_per_iter.train: the median host time of one ``Booster.update()``
call after the traced stretch, from the benchmark's spans around each call,
with no synchronize inside: the host's own share of an iteration, unless
the launch queue is full.  Moves train_iter_s."""

import statistics


def read(r):
    if r.get("kind") != "train" or not r.get("host_s"):
        return None
    return 1e3 * statistics.median(r["host_s"])
