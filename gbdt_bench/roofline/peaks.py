"""Published peaks the rooflines divide by.

NVIDIA H100 SXM5 80GB data sheet, dense rates, at the full 700 W power
limit: HBM3 at 3.35 TB/s.  GBDT training and tree traversal do almost no
arithmetic a byte, so their bound is bandwidth; a card set below 700 W reads
lower against the same peak, so every run prints its ``power.limit``.
"""

HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def hbm_bytes_per_s(kind: str) -> float:
    """The peak of the card named ``kind`` (its torch device name); H100
    SXM's for a name not listed."""
    return HBM_BYTES_PER_S.get(kind, 3.35e12)
