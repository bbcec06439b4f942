"""The ranks of a distributed training, as the growers see them.

Counterpart of lightgbm_tpu/parallel/mesh.py.  There a mesh is a
jax.sharding.Mesh over devices and a grower runs inside shard_map; here a
rank is a process of a torch.distributed process group, a ``Mesh`` names
that group, and each grower runs its rank's part with the collectives of
parallel/collectives.py where the JAX package's stand.  The axis names are
kept for the tree learners' vocabulary: ``DATA_AXIS`` (rows sharded:
tree_learner=data and voting), ``FEATURE_AXIS`` (features sharded:
tree_learner=feature, and the feature axis of the 2-D mesh), ``ICI_AXIS``
and ``DCN_AXIS`` (the ranks inside one slice, and the ranks of one place
across slices, of the hierarchical mesh).

``RowShard`` is what a grower needs of its rows' place in the whole: the
mesh, the rank's first global row and the global row count.  With them
every sum over rows follows the serial path's arithmetic (the tree's
fixed-point exponents from the global N and maxima, stochastic-rounding
draws sliced from the serial draw), so R ranks grow the serial tree bit
for bit (ops/histogram.py::merge_carry).

A 2-D (``make_mesh_2d``) or hierarchical (``make_mesh_hierarchical``)
mesh is the one default world with one subgroup per row of each axis
(``dist.new_group``: every rank creates every group, in the same order,
members or not, as NCCL requires).  Its ``stats`` hold each axis's counts,
so the bytes that crossed one axis (the dcn axis of the hierarchical
merge) can be read apart.  ``make_device_mesh`` is the JAX package's
other meaning of a mesh: one process, several devices, for
``predict(mesh=)``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"  # rows sharded (reference: tree_learner=data / voting)
FEATURE_AXIS = "feature"  # features sharded (reference: tree_learner=feature)
# the hierarchical mesh: ICI_AXIS joins the ranks of one slice (full
# histogram merges), DCN_AXIS the ranks at one place of every slice (only
# top-k-shaped traffic crosses it); WORLD_AXIS names the whole world's
# group, which carries the scalars every rank must agree on
ICI_AXIS = "ici"
DCN_AXIS = "dcn"
WORLD_AXIS = "world"


def _new_stats() -> dict:
    return {"merges": 0, "merge_bytes": 0, "collectives": 0, "bytes": 0}


class Mesh:
    """A process group as one axis: its group (None is the default group),
    this process's rank in it and its size.  ``stats`` counts what the
    collectives over it moved: histogram merges and their bytes (the
    parallel layer's metrics, PERF.md section 3), every collective and
    the bytes of its input."""

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
        self.stats = _new_stats()

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


class GridMesh:
    """A 2-D or hierarchical mesh: the default world laid out as a (rows,
    columns) grid of ranks, rank r at (r // cols, r % cols), with one
    subgroup per row (the ``col_axis``: ranks of one grid row) and one per
    column (the ``row_axis``).  ``axes`` maps each axis name (and
    WORLD_AXIS) to this rank's Mesh over it; ``stats`` their counts."""

    def __init__(self, shape: Tuple[int, int], names: Tuple[str, str]):
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError("a 2-D or hierarchical mesh needs an initialized "
                               "torch.distributed process group")
        rows, cols = (int(v) for v in shape)
        world = dist.get_world_size()
        if rows * cols != world:
            raise ValueError(f"a {rows} x {cols} mesh needs {rows * cols} ranks, "
                             f"the world has {world}")
        self.shape = (rows, cols)
        self.row_axis, self.col_axis = names
        r = dist.get_rank()
        self.coords = (r // cols, r % cols)
        mine = {}
        # every rank creates every group in the same order, members or not
        for i in range(rows):
            g = dist.new_group([i * cols + j for j in range(cols)])
            if i == self.coords[0]:
                mine[self.col_axis] = Mesh(g, self.col_axis)
        for j in range(cols):
            g = dist.new_group([i * cols + j for i in range(rows)])
            if j == self.coords[1]:
                mine[self.row_axis] = Mesh(g, self.row_axis)
        mine[WORLD_AXIS] = Mesh(None, WORLD_AXIS)
        self.axes = mine
        self.rank = r
        self.size = world

    @property
    def stats(self) -> dict:
        return {name: m.stats for name, m in self.axes.items()}

    def reset_stats(self) -> None:
        for m in self.axes.values():
            m.reset_stats()

    def __repr__(self) -> str:
        return (f"GridMesh({self.row_axis}={self.shape[0]}, "
                f"{self.col_axis}={self.shape[1]}, rank={self.rank})")


def make_mesh_2d(n_data: int, n_feature: int) -> GridMesh:
    """The (data, feature) mesh of tree_learner=feature2d over the default
    world of n_data * n_feature ranks: rank r holds row block r //
    n_feature and feature block r % n_feature.  ``axes[DATA_AXIS]`` joins
    the ranks of one feature block (the histogram merge),
    ``axes[FEATURE_AXIS]`` the ranks of one row block (the election)."""
    return GridMesh((n_data, n_feature), (DATA_AXIS, FEATURE_AXIS))


def make_mesh_hierarchical(num_slices: int,
                           ranks_per_slice: Optional[int] = None) -> GridMesh:
    """The nested (dcn, ici) mesh over the default world: ``num_slices``
    slices of ``ranks_per_slice`` consecutive ranks.  ``axes[ICI_AXIS]``
    joins the ranks of this rank's slice, ``axes[DCN_AXIS]`` the ranks at
    its place in every slice."""
    num_slices = int(num_slices)
    if num_slices < 1:
        raise ValueError(f"num_slices must be >= 1, got {num_slices}")
    world = dist.get_world_size()
    if ranks_per_slice is None:
        if world % num_slices:
            raise ValueError(f"{world} ranks do not divide into {num_slices} slices")
        ranks_per_slice = world // num_slices
    return GridMesh((num_slices, int(ranks_per_slice)), (DCN_AXIS, ICI_AXIS))


def slice_axis_sizes(mesh: GridMesh) -> Tuple[int, int]:
    """(num_slices, ranks_per_slice) of a hierarchical mesh."""
    return mesh.shape


def feature2d_axis_sizes(mesh: GridMesh) -> Tuple[int, int]:
    """(d_row, d_feature) of a 2-D mesh."""
    return mesh.shape


class DeviceMesh:
    """Several devices of this process (the JAX package's single-controller
    mesh), for ``predict(mesh=)``: rows split into contiguous blocks, one
    a device."""

    def __init__(self, devices: Sequence):
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a device mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"DeviceMesh({[str(d) for d in self.devices]})"


def make_device_mesh(devices: Sequence) -> DeviceMesh:
    """A mesh over the torch devices ``devices`` of this process (the same
    device may appear more than once)."""
    return DeviceMesh(devices)


def current_mesh() -> Optional[Mesh]:
    """The default group as a mesh when a distributed run of more than one
    rank is up, else None."""
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return make_mesh()
    return None
