"""Non-finite guard rail (counterpart of lightgbm_tpu/utils/guards.py).

The windowed grower folds a finite flag into the info vector it already
reads one round behind, and raises this error when the flag is down."""


class NonFiniteError(ValueError):
    """Non-finite values reached training.  Subclasses ValueError so
    generic callers treat it as bad input, which it is."""
