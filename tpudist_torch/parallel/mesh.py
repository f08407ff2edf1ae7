"""Device mesh construction.

Counterpart of ``tpudist/parallel/mesh.py``. The mesh is the parallelism
config: a 6-axis ``torch.distributed.device_mesh.DeviceMesh`` over
``('data', 'pipe', 'fsdp', 'expert', 'tensor', 'context')``, one card a
process, so a mesh position is a process and its device id is the
process's rank. Axes of size 1 cost nothing, so every workload uses the
same mesh shape: data parallelism is ``(n, 1, 1, 1, 1, 1)``.

The ranks fill the mesh in C order, as the JAX package reshapes its
devices: the last axes vary fastest, so with ``data 2 x fsdp 2`` ranks
{0, 1} and {2, 3} are the fsdp groups and {0, 2}, {1, 3} the data
groups. :meth:`DeviceMesh.get_group` hands out each axis's process
group.

The slice and fabric functions below are plain Python over device ids,
as in the JAX package. They take any mesh with a ``mesh`` array of
device ids and ``mesh_dim_names`` (a ``DeviceMesh`` is one), so they run
without a process group too.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from tpudist_torch.config import ParallelConfig

# canonical axis order, most-global first
AXIS_NAMES: Tuple[str, ...] = ("data", "pipe", "fsdp", "expert", "tensor",
                               "context")


@dataclass(frozen=True)
class MeshAxes:
    data: str = "data"
    pipe: str = "pipe"
    fsdp: str = "fsdp"
    expert: str = "expert"
    tensor: str = "tensor"
    context: str = "context"


def resolve_axis_sizes(cfg: ParallelConfig, n_devices: int
                       ) -> Tuple[int, int, int, int, int, int]:
    """Resolve ``data=-1`` to "all remaining devices" and validate the
    factorisation: shapes come from the live device count, never
    hard-coded."""
    fixed = cfg.pipe * cfg.fsdp * cfg.expert * cfg.tensor * cfg.context
    if fixed <= 0:
        raise ValueError(f"axis sizes must be >=1, got {cfg}")
    data = cfg.data
    if data == -1:
        if n_devices % fixed:
            raise ValueError(
                f"{n_devices} devices not divisible by pipe*fsdp*expert*"
                f"tensor*context={fixed}")
        data = n_devices // fixed
    if data * fixed != n_devices:
        raise ValueError(
            f"mesh {data}x{cfg.pipe}x{cfg.fsdp}x{cfg.expert}x{cfg.tensor}"
            f"x{cfg.context} != {n_devices} devices")
    return (data, cfg.pipe, cfg.fsdp, cfg.expert, cfg.tensor, cfg.context)


def build_mesh(cfg: Optional[ParallelConfig] = None, *,
               device_type: str = "cuda"):
    """The ``DeviceMesh`` of ``cfg`` over the processes of the process
    group (which must be up: a world of one is a one-rank group), ranks
    in C order over :data:`AXIS_NAMES`."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    cfg = cfg or ParallelConfig()
    sizes = resolve_axis_sizes(cfg, dist.get_world_size())
    return init_device_mesh(device_type, sizes, mesh_dim_names=AXIS_NAMES)


class RankGrid(NamedTuple):
    """A mesh's ranks without its process groups: what the slice and
    fabric functions read, for a mesh no process group backs (the
    replicated data-parallel run builds no ``DeviceMesh``)."""
    mesh: np.ndarray
    mesh_dim_names: Tuple[str, ...]


def rank_grid(cfg: ParallelConfig, n_devices: int) -> RankGrid:
    """Ranks ``0 .. n_devices-1`` in C order over ``cfg``'s axis
    sizes."""
    sizes = resolve_axis_sizes(cfg, n_devices)
    return RankGrid(np.arange(n_devices).reshape(sizes), AXIS_NAMES)


def mesh_devices(mesh) -> np.ndarray:
    """The mesh's device ids (ranks) as an int array of the mesh's
    shape."""
    ids = mesh.mesh
    return np.asarray(ids.tolist() if hasattr(ids, "tolist") else ids,
                      dtype=np.int64).reshape(tuple(ids.shape))


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis: size}``, the JAX ``Mesh.shape`` mapping."""
    return dict(zip(mesh.mesh_dim_names, mesh_devices(mesh).shape))


def axis_size(mesh, axis: str) -> int:
    return mesh_shape(mesh).get(axis, 1)


def axes_group(mesh, axes: Tuple[str, ...]):
    """The process group of the ranks that differ from this one only
    along ``axes`` (``("data", "fsdp")``: the ranks a batch splits
    over), for a ``DeviceMesh`` with a process group up. Every process
    makes every such group, in one order, as ``new_group`` asks; the
    mesh keeps them, so a mesh makes them once."""
    import torch.distributed as dist

    made = mesh.__dict__.setdefault("_axes_groups", {})
    if axes not in made:
        devs = mesh_devices(mesh)
        names = list(mesh.mesh_dim_names)
        inner = [names.index(a) for a in axes]
        outer = [i for i in range(devs.ndim) if i not in inner]
        ways = int(np.prod([devs.shape[i] for i in inner]))
        rank = dist.get_rank()
        for ranks in np.transpose(devs, outer + inner).reshape(-1, ways):
            group = dist.new_group([int(r) for r in ranks])
            if rank in ranks:
                made[axes] = group
    return made[axes]


# ------------------------------------------------- slice / fabric layout
#
# A pod of several slices (NVLink domains, hosts) puts an axis on the
# slower fabric when it crosses slices. ``TPUDIST_SLICE_MAP`` scripts the
# slices by device id: an integer N ("split the devices into N equal
# contiguous slices") or a comma list of per-device slice indices. The
# map changes only LABELING (axis_fabric -> "dcn", the comm grading),
# never the program. A device the map does not name is on slice 0.


def resolve_slice_map(n_devices: int) -> Optional[List[int]]:
    """``TPUDIST_SLICE_MAP`` -> per-device slice index for a full
    world of ids ``0..n_devices-1``, or None when unset. A list view
    over :func:`slice_assignment`, the one parser of the variable.
    Malformed values raise."""
    assigned = slice_assignment(range(n_devices))
    if assigned is None:
        return None
    return [assigned[i] for i in range(n_devices)]


def slice_assignment(devices) -> Optional[Dict[int, int]]:
    """The scripted slice of each of THESE device ids (``{device_id:
    slice}``), or None when ``TPUDIST_SLICE_MAP`` is unset. The integer
    form splits the given ids, sorted, into N contiguous runs; the
    explicit list form is global by device id and must cover every id
    present."""
    raw = os.environ.get("TPUDIST_SLICE_MAP")
    if not raw:
        return None
    vals = [int(p) for p in raw.split(",") if p.strip()]
    ids = sorted(int(d) for d in devices)
    if len(vals) == 1:
        n_slices = vals[0]
        if n_slices < 1 or len(ids) % n_slices:
            raise ValueError(
                f"TPUDIST_SLICE_MAP={raw!r}: {len(ids)} devices not "
                f"divisible into {n_slices} equal slices")
        per = len(ids) // n_slices
        return {d: i // per for i, d in enumerate(ids)}
    for d in ids:
        if d < 0 or d >= len(vals):
            raise ValueError(
                f"TPUDIST_SLICE_MAP={raw!r}: {len(vals)} entries do "
                f"not cover device id {d}")
    return {d: vals[d] for d in ids}


def device_slice_index(device: int,
                       scripted: Optional[Dict[int, int]] = None) -> int:
    """One device id's slice: the scripted map's, else 0 (one slice)."""
    if scripted is not None and int(device) in scripted:
        return scripted[int(device)]
    return 0


def _axis_columns(mesh, axis: str) -> Tuple[np.ndarray, Dict[int, int]]:
    """The device ids with ``axis`` first and every other axis flattened
    (column ``j`` is one position of the other axes), and the scripted
    slices of the mesh's ids."""
    devs = mesh_devices(mesh)
    scripted = slice_assignment(devs.ravel())
    idx = list(mesh.mesh_dim_names).index(axis)
    cols = np.moveaxis(devs, idx, 0).reshape(devs.shape[idx], -1)
    return cols, scripted


def axis_fabric(mesh, axis: str) -> str:
    """Label a mesh axis ``ici`` or ``dcn`` from the devices it spans:
    fix every other axis and look at the slices along this one; more
    than one distinct slice anywhere means the slower fabric."""
    cols, scripted = _axis_columns(mesh, axis)
    for j in range(cols.shape[1]):
        slices = {device_slice_index(d, scripted) for d in cols[:, j]}
        if len(slices) > 1:
            return "dcn"
    return "ici"


def axis_hops(mesh, axis: str) -> List[str]:
    """Per-hop fabric along a mesh axis: entry ``i`` labels the edge
    from axis position ``i`` to ``(i+1) % size`` (the last is the ring's
    wrap hop). A hop is ``dcn`` when any pair of devices it connects
    (over all positions of the other axes) sits on different slices."""
    cols, scripted = _axis_columns(mesh, axis)
    size = cols.shape[0]
    hops: List[str] = []
    for i in range(size):
        j = (i + 1) % size
        crossed = any(
            device_slice_index(cols[i, c], scripted)
            != device_slice_index(cols[j, c], scripted)
            for c in range(cols.shape[1]))
        hops.append("dcn" if crossed else "ici")
    return hops


def mesh_fabrics(mesh) -> Dict[str, str]:
    """Every size>1 axis's fabric label: the ``axis_fabric`` map the
    devtime record carries (an axis of size 1 has no collective)."""
    shape = mesh_shape(mesh)
    return {axis: axis_fabric(mesh, axis)
            for axis in mesh.mesh_dim_names if shape[axis] > 1}


def data_fabric(mesh) -> str:
    """The gradient all-reduce's fabric: the ``data`` axis label when
    that axis is real, else ICI (no cross-device reduce at all)."""
    if axis_size(mesh, "data") > 1:
        return axis_fabric(mesh, "data")
    return "ici"


def mesh_device_slices(mesh) -> List[int]:
    """Slice index of every mesh device in FLAT (C-order) mesh
    position."""
    devs = [int(d) for d in mesh_devices(mesh).ravel()]
    scripted = slice_assignment(devs)
    return [device_slice_index(d, scripted) for d in devs]


@dataclass(frozen=True)
class SliceGroups:
    """The slice structure of the ``data`` axis, as collective
    subgroups: ``in_slice[s]`` holds the data-axis indices of slice
    ``s``'s members (the in-slice reduce-scatter / all-gather groups),
    ``cross_slice[j]`` holds the ``j``-th member of every slice (the
    cross-slice all-reduce groups)."""

    n_slices: int
    slice_size: int
    in_slice: Tuple[Tuple[int, ...], ...]
    cross_slice: Tuple[Tuple[int, ...], ...]


def data_slice_groups(mesh) -> Optional[SliceGroups]:
    """The data axis's :class:`SliceGroups`, or None when there is no
    slice structure to exploit (data axis of size 1, or every data
    position on one slice).

    Raises when a single data position spans slices, and when slices are
    unequal."""
    n = axis_size(mesh, "data")
    if n <= 1:
        return None
    cols, scripted = _axis_columns(mesh, "data")
    pos_slice: List[int] = []
    for i in range(n):
        seen = {device_slice_index(d, scripted) for d in cols[i]}
        if len(seen) > 1:
            raise ValueError(
                f"data position {i} spans slices {sorted(seen)}: "
                f"in-slice/cross-slice grouping needs every data-axis "
                f"position on ONE slice")
        pos_slice.append(seen.pop())
    by_slice: Dict[int, List[int]] = {}
    for i, s in enumerate(pos_slice):
        by_slice.setdefault(s, []).append(i)
    if len(by_slice) == 1:
        return None
    groups = [tuple(v) for _, v in sorted(by_slice.items())]
    sizes = {len(g) for g in groups}
    if len(sizes) > 1:
        raise ValueError(
            f"unequal slice sizes {sorted(len(g) for g in groups)} on "
            f"the data axis: the hierarchical schedule shards each "
            f"reduce 1/slice_size and needs equal slices")
    per = sizes.pop()
    cross = tuple(tuple(g[j] for g in groups) for j in range(per))
    return SliceGroups(n_slices=len(groups), slice_size=per,
                       in_slice=tuple(groups), cross_slice=cross)
