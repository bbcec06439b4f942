"""host_syncs_per_iter.train: blocking reads an iteration, from the port's
``boost_round`` spans (``host_syncs``) of the window after the traced
stretch.  Moves train_iter_s."""

SPAN = "boost_round"


def read(r):
    if r.get("kind") != "train":
        return None
    syncs = [int(s["attrs"].get("host_syncs", 0))
             for s in r["port_spans"]["window"] if s["name"] == SPAN]
    return sum(syncs) / len(syncs) if syncs else None
