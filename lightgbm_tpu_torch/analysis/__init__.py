"""jaxlint for the port: static analysis of lightgbm_tpu_torch.

Counterpart of lightgbm_tpu/analysis/, in three layers with one pragma
format and one reporter:

* the AST rules R1-R21 (rules.py), each the torch meaning of the JAX
  package's rule of the same ID (R3 and R11 are registered but scoped
  out: they have none);
* the concurrency layer L1-L5 (locks.py), the JAX package's lock model
  and rules, copied;
* the trace audit J1-J7 (trace_audit.py over the contracts of
  contracts.py): each contract's round body, run once under a recorder
  at a small fixture shape, against the collectives, buffers, dtypes,
  host reads, host copies, live bytes and bin-matrix sweeps it declares.
  It is not imported here; ``--trace`` loads it.

Usage::

    python -m lightgbm_tpu_torch.analysis lightgbm_tpu_torch/        # R + L
    python -m lightgbm_tpu_torch.analysis --rules R1,R13 lightgbm_tpu_torch/ops
    python -m lightgbm_tpu_torch.analysis --strict-pragmas       # stale = fail
    python -m lightgbm_tpu_torch.analysis --locks                # L1-L5 only
    python -m lightgbm_tpu_torch.analysis --trace                # J1-J7
    python -m lightgbm_tpu_torch.analysis --trace --contract windowed_round_float

or from tests::

    from lightgbm_tpu_torch.analysis import run
    report = run([pkg_dir])
    assert report.ok, "\\n".join(f.format() for f in report.findings)

Suppressions are inline pragmas with a mandatory reason::

    n = int(cnt.item())  # jaxlint: disable=R1 (the one read a tree)
"""

from .core import (Finding, PackageIndex, Pragma, Report, RULES,
                   register_rule, run)
from . import rules  # noqa: F401  — registers R1-R21 on import
from . import locks  # noqa: F401  — registers the concurrency layer L1-L5

__all__ = ["Finding", "PackageIndex", "Pragma", "Report", "RULES",
           "register_rule", "run"]
