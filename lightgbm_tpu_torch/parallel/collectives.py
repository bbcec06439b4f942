"""The JAX collectives the growers use, in torch.distributed terms.

No JAX file corresponds: under shard_map the JAX package calls
``jax.lax.psum`` and its siblings inside the traced grower.  Here each is a
collective over a ``Mesh``'s process group (parallel/mesh.py), called with
that group explicitly:

* ``psum`` / ``pmax`` / ``pmin``: ``all_reduce`` with SUM / MAX / MIN (bool
  tensors travel as uint8);
* ``psum_scatter``: ``reduce_scatter`` over dim 0 (the caller lays the
  tensor out with the scattered axis first and padded to a multiple of R,
  as lightgbm_tpu/parallel/data_parallel.py pads the feature axis);
* ``all_gather``: the ranks' tensors concatenated over dim 0, in rank order;
* ``axis_index``: the rank.

The operations run on the tensors where they lie.  NCCL takes CUDA
tensors; gloo takes CPU tensors and, in the PyTorch of the card's machine
(2.11), CUDA tensors for every operation used here (probed on the H100:
all_reduce SUM / MAX on int64, int32, float32 and uint8,
reduce_scatter_tensor and all_gather_into_tensor), so no collective is
staged through host memory.  The names reduce_scatter_single and
all_gather_single (newer PyTorch; the older names warn there) are used
where they exist.

All ranks must call the same collectives in the same order: the growers
keep every decision that chooses a collective replicated.  Each call
counts itself and its input's bytes in the stats of the Mesh it runs over
(``_count``), so a 2-D or hierarchical mesh's counts are per axis, and
reports itself to the trace audit's recorder when one is installed
(utils/audit_hooks.py; analysis/trace_audit.py J1).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..utils import audit_hooks as _hooks
from .mesh import Mesh

_reduce_scatter = (getattr(dist, "reduce_scatter_single", None)
                   or dist.reduce_scatter_tensor)
_all_gather = (getattr(dist, "all_gather_single", None)
               or dist.all_gather_into_tensor)


def _count(x: torch.Tensor, mesh: Mesh, op: str) -> None:
    nbytes = x.numel() * x.element_size()
    mesh.stats["collectives"] += 1
    mesh.stats["bytes"] += nbytes
    _hooks.collective(op, mesh.axis, nbytes)


def _reduce(x: torch.Tensor, mesh: Mesh, op, name: str) -> torch.Tensor:
    _count(x, mesh, name)
    if x.dtype == torch.bool:
        y = x.to(torch.uint8)
        dist.all_reduce(y, op=op, group=mesh.group)
        return y.bool()
    y = x.contiguous().clone()
    dist.all_reduce(y, op=op, group=mesh.group)
    return y


def psum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum over the ranks of ``x`` (a new tensor)."""
    return _reduce(x, mesh, dist.ReduceOp.SUM, "psum")


def pmax(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _reduce(x, mesh, dist.ReduceOp.MAX, "pmax")


def pmin(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _reduce(x, mesh, dist.ReduceOp.MIN, "pmin")


def psum_scatter(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the sum over the ranks: rows [r * k, (r + 1) * k)
    of the summed ``x``, k = x.shape[0] / R."""
    _count(x, mesh, "psum_scatter")
    r = mesh.size
    if x.shape[0] % r:
        raise ValueError(f"psum_scatter: dim 0 ({x.shape[0]}) is not a multiple "
                         f"of the {r} ranks")
    x = x.contiguous()
    out = torch.empty((x.shape[0] // r,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _reduce_scatter(out, x, op=dist.ReduceOp.SUM, group=mesh.group)
    return out


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ranks' ``x`` (equal shapes) concatenated over dim 0, rank order."""
    _count(x, mesh, "all_gather")
    x = x.contiguous()
    out = torch.empty((x.shape[0] * mesh.size,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _all_gather(out, x, group=mesh.group)
    return out


def all_gather_ragged(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``all_gather`` of tensors whose dim 0 differs between ranks (their
    other dims equal): one gather of the lengths, one of the padded rows."""
    n = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
    lens = [int(v) for v in all_gather(n, mesh).cpu()]
    top = max(lens)
    pad = torch.zeros((top - x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    full = all_gather(torch.cat([x, pad]), mesh)
    return torch.cat([full[r * top: r * top + lens[r]] for r in range(mesh.size)])


def axis_index(mesh: Mesh) -> int:
    return mesh.rank


def broadcast_from(x: torch.Tensor, owner: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` of the rank ``owner`` (a 0-d tensor, the same on every rank, or
    one owner per leading element), by a masked psum: the JAX package's
    psum-masking broadcast, which needs no host read of the owner.  Floats
    travel as their bit patterns (an integer sum with zeros), so the
    owner's values arrive bit for bit, a negative zero too."""
    mine = owner == mesh.rank
    m = mine.reshape(mine.shape + (1,) * (x.dim() - mine.dim()))
    if x.dtype == torch.bool:
        return psum(torch.where(m, x, False).to(torch.int32), mesh) > 0
    bits = {torch.float32: torch.int32, torch.float64: torch.int64}.get(x.dtype)
    v = x.contiguous().view(bits) if bits is not None else x
    got = psum(torch.where(m, v, torch.zeros((), dtype=v.dtype, device=v.device)),
               mesh)
    return got.view(x.dtype) if bits is not None else got
