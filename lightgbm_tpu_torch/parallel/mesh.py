"""The ranks of a distributed training, as the growers see them.

Counterpart of lightgbm_tpu/parallel/mesh.py.  There a mesh is a
jax.sharding.Mesh over devices and a grower runs inside shard_map; here a
rank is a process of a torch.distributed process group, a ``Mesh`` names
that group, and each grower runs its rank's part with the collectives of
parallel/collectives.py where the JAX package's stand.  The axis names are
kept for the tree learners' vocabulary: ``DATA_AXIS`` (rows sharded:
tree_learner=data and voting) and ``FEATURE_AXIS`` (features sharded:
tree_learner=feature).

``RowShard`` is what a grower needs of its rows' place in the whole: the
mesh, the rank's first global row and the global row count.  With them
every sum over rows follows the serial path's arithmetic (the tree's
fixed-point exponents from the global N and maxima, stochastic-rounding
draws sliced from the serial draw), so R ranks grow the serial tree bit
for bit (ops/histogram.py::merge_carry).

The 2-D (feature, row) and the hierarchical (dcn, ici) meshes are ROADMAP
A13b; making one raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch.distributed as dist

DATA_AXIS = "data"  # rows sharded (reference: tree_learner=data / voting)
FEATURE_AXIS = "feature"  # features sharded (reference: tree_learner=feature)


class Mesh:
    """A process group as a 1-D mesh: its group (None is the default
    group), this process's rank in it and its size.  ``stats`` counts what
    the collectives moved: histogram merges and their bytes (the parallel
    layer's metrics, PERF.md section 3) and the other collectives."""

    def __init__(self, group=None, axis: str = DATA_AXIS):
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError("Mesh needs an initialized torch.distributed "
                               "process group (parallel/distributed.py::"
                               "init_distributed)")
        self.group = group
        self.axis = axis
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))
        self.stats = {"merges": 0, "merge_bytes": 0, "collectives": 0}

    def reset_stats(self) -> None:
        for k in self.stats:
            self.stats[k] = 0

    def __repr__(self) -> str:
        return (f"Mesh(axis={self.axis!r}, rank={self.rank}, size={self.size}, "
                f"backend={self.backend!r})")


class RowShard(NamedTuple):
    """A rank's rows in the whole: rows [offset, offset + n_local) of
    ``num_data`` global rows, over ``mesh``; ``num_feature``, the global
    feature count where the features are sharded (tree_learner=feature)."""
    mesh: Mesh
    offset: int
    num_data: int
    num_feature: Optional[int] = None


def make_mesh(group=None) -> Mesh:
    """1-D data mesh over the process group (the default one by default)."""
    return Mesh(group, DATA_AXIS)


def data_axis_size(mesh: Mesh) -> int:
    """Ranks along the data axis: the R of the scatter merge's padding."""
    return int(mesh.size)


def make_mesh_2d(*_args, **_kwargs):
    raise NotImplementedError("make_mesh_2d: the 2-D (feature, row) mesh "
                              "(tree_learner=feature2d) is ROADMAP queue A13b")


def make_mesh_hierarchical(*_args, **_kwargs):
    raise NotImplementedError("make_mesh_hierarchical: the nested (dcn, ici) "
                              "mesh (num_slices > 1) is ROADMAP queue A13b")


def current_mesh() -> Optional[Mesh]:
    """The default group as a mesh when a distributed run of more than one
    rank is up, else None."""
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return make_mesh()
    return None
