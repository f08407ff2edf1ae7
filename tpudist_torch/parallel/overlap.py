"""Gradient all-reduce overlap: bucketed reduces issued as the backward
produces each bucket, and the slice ladder on a multi-slice data axis.

Counterpart of ``tpudist/parallel/overlap.py``, over the list of param
grads the replicated data-parallel step reduces (``engine``'s step body
with a process group up and no mesh: the JAX package's pure-DP path).

* ``--grad-overlap off`` (:func:`barrier_mean`): one all-reduce SUM a
  grad, in the order given, after the whole backward, then a divide by
  the world: the JAX package's pinned trailing-barrier baseline. Eager
  PyTorch issues collectives in program order, after the ops that
  produce their inputs, so no barrier op is needed: nothing reduces
  before ``autograd.grad`` has returned every grad.
* ``--grad-overlap bucketed`` (:class:`BucketedMean`): :func:`plan_buckets`
  packs the grads in reverse order under the bound, as the JAX function
  packs ``jax.tree.leaves(params)`` (the engine hands them over in that
  order: bucket 0 is the last leaf's). A hook on each param counts its
  bucket down; the last of the bucket's grads the backward produces
  issues the bucket's all-reduces (``async_op=True``) while the earlier
  layers' backward runs. Buckets are issued in plan order on every rank,
  or the collectives would pair up wrongly across ranks: a bucket ready
  before its predecessor waits for it (a ready prefix, the JAX chain
  through ``optimization_barrier``). Every work is waited, and the
  divide by the world done, after the backward. The per-grad sizes are
  those of ``off``, so each grad's sum and the step's bits are the same.

On a data axis that ``TPUDIST_SLICE_MAP`` splits into slices, each
bucket (or ``off``'s whole grad list) reduces over the slice ladder
(:func:`_slice_ladder_mean`), one ladder a dtype over the concatenated
grads: ``flat`` an in-slice all-reduce then a cross-slice all-reduce of
the whole vector, ``hierarchical`` an in-slice reduce-scatter (the
vector zero-padded to the slice size), a cross-slice all-reduce of the
shard and an in-slice all-gather. Each element is summed in the same
association either way (in-slice, then across slices), so the two are
bitwise equal; the cross-slice phase moves 1/slice_size of the bytes
under ``hierarchical``. A one-slice data axis keeps the per-grad
all-reduces.

Every collective is noted into ``reduced`` as ``(op, dtype, bytes,
dcn_participants)``: the payload of one instance (the whole vector a
reduce-scatter consumes or an all-gather produces) and, for a group
that spans slices, the world's count of participants, as
``tpudist/obs/devtime.py::collective_bytes`` prices a lowered program's
replica groups (``obs.devtime.collective_bytes`` folds them).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from tpudist_torch.parallel import tensor as tensor_lib

# --grad-overlap vocabulary (config.resolve_grad_overlap validates)
GRAD_OVERLAP_MODES = ("off", "bucketed")

# --cross-slice vocabulary (config.resolve_cross_slice validates; the
# engine downgrades hierarchical to flat on a one-slice data axis)
CROSS_SLICE_MODES = ("flat", "hierarchical")

# Default bucket bound: big enough that a bucket's all-reduce amortises
# its latency, small enough that the first reduce issues early in the
# backward. The tuner (tune.search) probes the ladder around it.
DEFAULT_BUCKET_MB = 4.0


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Reverse-order bucketing of a list of grads.

    ``buckets`` holds list indices, grouped; bucket 0 is the FIRST to
    reduce (the last leaves). Shapes and dtypes only: the plan costs no
    device byte."""

    buckets: tuple          # tuple[tuple[int, ...], ...]
    leaf_bytes: tuple       # per-leaf nbytes, list order
    bucket_bytes: int

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    @property
    def total_bytes(self) -> int:
        return sum(self.leaf_bytes)


def _itemsize(dtype: Any) -> int:
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return np.dtype(dtype if dtype is not None else np.float32).itemsize


def leaf_nbytes(leaf: Any) -> int:
    """Byte size of a tensor (or anything with ``shape`` and ``dtype``)
    from its shape and dtype alone."""
    size = 1
    for d in getattr(leaf, "shape", ()):
        size *= int(d)
    return size * _itemsize(getattr(leaf, "dtype", None))


def plan_buckets(leaves: Sequence[Any], bucket_bytes: int) -> BucketPlan:
    """Greedy reverse-order packing of ``leaves`` under ``bucket_bytes``.

    A leaf larger than the bound gets its own bucket (it cannot be split
    without changing the collective's shape); ``bucket_bytes <= 0``
    degenerates to one leaf a bucket, the finest legal schedule."""
    sizes = tuple(leaf_nbytes(x) for x in leaves)
    buckets: List[tuple] = []
    cur: List[int] = []
    cur_bytes = 0
    for i in reversed(range(len(sizes))):
        if cur and cur_bytes + sizes[i] > max(int(bucket_bytes), 1):
            buckets.append(tuple(cur))
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += sizes[i]
    if cur:
        buckets.append(tuple(cur))
    return BucketPlan(buckets=tuple(buckets), leaf_bytes=sizes,
                      bucket_bytes=int(bucket_bytes))


@dataclasses.dataclass
class SliceComms:
    """A multi-slice data axis as process groups: this rank's slice
    (``in_slice``: the reduce-scatter, all-gather and flat in-slice
    all-reduce) and its column across slices (``cross_slice``), with
    the layout's ``n_slices`` x ``slice_size``."""

    n_slices: int
    slice_size: int
    in_slice: Any
    cross_slice: Any

    @property
    def world(self) -> int:
        return self.n_slices * self.slice_size


def slice_comms(groups) -> Optional[SliceComms]:
    """The process groups of ``groups`` (``mesh.data_slice_groups``'s
    :class:`~tpudist_torch.parallel.mesh.SliceGroups` over the world's
    ranks, or None: one slice). Every rank makes every group, in one
    order, as ``dist.new_group`` asks."""
    if groups is None:
        return None
    rank = dist.get_rank()
    mine = {}
    for kind in ("in_slice", "cross_slice"):
        for ranks in getattr(groups, kind):
            g = dist.new_group([int(r) for r in ranks])
            if rank in ranks:
                mine[kind] = g
    return SliceComms(n_slices=groups.n_slices,
                      slice_size=groups.slice_size, **mine)


def _note(reduced: Optional[list], op: str, t: torch.Tensor,
          dcn: int = 0) -> None:
    if reduced is not None:
        reduced.append((op, t.dtype, t.numel() * t.element_size(), dcn))


def _slice_ladder_mean(vals: Sequence[torch.Tensor], sc: SliceComms,
                       cross: str, reduced: Optional[list] = None
                       ) -> List[torch.Tensor]:
    """The global means of ``vals`` over the slice ladder: same-dtype
    grads flattened and concatenated into one vector (element-wise
    identity math) and each dtype's vector through ONE ladder,

      flat:         all-reduce (in-slice) -> all-reduce (cross-slice, the
                    whole vector)
      hierarchical: reduce-scatter (in-slice) -> all-reduce (cross-slice,
                    the 1/slice_size shard) -> all-gather (in-slice)

    then divided by the world and split back into views of ``vals``'
    shapes. The hierarchical vector is zero-padded to a slice_size
    multiple; the padding reduces zeros that the trailing cut drops."""
    n = sc.world
    by_dtype: dict = {}
    for pos, v in enumerate(vals):
        by_dtype.setdefault(v.dtype, []).append(pos)
    out: List[Optional[torch.Tensor]] = [None] * len(vals)
    for positions in by_dtype.values():
        parts = [vals[p].reshape(-1) for p in positions]
        vec = torch.cat(parts)
        size = vec.shape[0]
        if cross == "hierarchical":
            pad = (-size) % sc.slice_size
            if pad:
                vec = torch.cat([vec, vec.new_zeros((pad,))])
            shard = vec.new_empty((vec.shape[0] // sc.slice_size,))
            _note(reduced, "reduce_scatter", vec)
            tensor_lib.collective(dist.reduce_scatter_tensor, shard, vec,
                                  op=dist.ReduceOp.SUM, group=sc.in_slice)
            _note(reduced, "all_reduce", shard, n)
            dist.all_reduce(shard, op=dist.ReduceOp.SUM,
                            group=sc.cross_slice)
            _note(reduced, "all_gather", vec)
            tensor_lib.collective(dist.all_gather_into_tensor, vec, shard,
                                  group=sc.in_slice)
            vec = vec[:size]
        else:
            _note(reduced, "all_reduce", vec)
            dist.all_reduce(vec, op=dist.ReduceOp.SUM, group=sc.in_slice)
            _note(reduced, "all_reduce", vec, n)
            dist.all_reduce(vec, op=dist.ReduceOp.SUM,
                            group=sc.cross_slice)
        vec.div_(n)
        off = 0
        for p in positions:
            ln = vals[p].numel()
            out[p] = vec[off:off + ln].view(vals[p].shape)
            off += ln
    return out


def barrier_mean(grads: Sequence[torch.Tensor], *, world: int,
                 cross: str = "flat", slices: Optional[SliceComms] = None,
                 reduced: Optional[list] = None) -> List[torch.Tensor]:
    """``--grad-overlap off``: every grad reduced after the whole
    backward. On a multi-slice data axis the slice ladder (one a dtype);
    otherwise one all-reduce SUM a grad, in place and in order, then the
    divide by ``world`` (psum, then divide: ``ReduceOp.AVG`` does not
    exist on gloo)."""
    if slices is not None:
        return _slice_ladder_mean(grads, slices, cross, reduced)
    for t in grads:
        _note(reduced, "all_reduce", t)
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        t.div_(world)
    return list(grads)


class BucketedMean:
    """``--grad-overlap bucketed`` over a list of grads (the step's
    params' order): ``plan``'s buckets (list indices) issued in plan
    order, each as soon as it and every bucket before it are ready.

    :meth:`hooked` arms one backward: a hook on each param takes its
    FINAL grad (``g``, or ``(prev + g) * inv`` under
    ``--grad-accum-steps``: the accumulated microbatches' sum and scale,
    the bits ``off`` reduces), and the last grad of a bucket calls
    :meth:`ready`. A param the backward gives no grad reduces zeros,
    handed over when the block ends, which issues the buckets still
    waiting, in order. :meth:`finish` waits every work, divides by the
    world and returns the means in list order.

    Per-grad reduces (a one-slice axis) are issued with ``async_op=True``
    on the backward's stream: NCCL's stream waits for the grad, then
    runs beside the earlier layers' backward. A slice ladder's phases
    depend on each other: on the card they run in turn on a side stream
    that the step's stream joins in :meth:`finish`."""

    def __init__(self, plan: BucketPlan, *, world: int, cross: str = "flat",
                 slices: Optional[SliceComms] = None,
                 reduced: Optional[list] = None):
        self.plan, self.world = plan, world
        self.cross, self.slices, self.reduced = cross, slices, reduced
        self._side: Optional["torch.cuda.Stream"] = None
        self._reset(len(plan.leaf_bytes))

    def _reset(self, n: int) -> None:
        self.grads: List[Optional[torch.Tensor]] = [None] * n
        self._ready = [False] * self.plan.n_buckets
        self._next = 0
        self._works: list = []
        self._means: List[Optional[torch.Tensor]] = [None] * n
        self._joined = None

    def ready(self, b: int) -> None:
        """Bucket ``b`` holds every final grad: issue it and every ready
        bucket after it, in plan order."""
        self._ready[b] = True
        while self._next < len(self._ready) and self._ready[self._next]:
            self._issue(self.plan.buckets[self._next])
            self._next += 1

    def _issue(self, bucket: Sequence[int]) -> None:
        vals = [self.grads[i] for i in bucket]
        if self.slices is None:
            for t in vals:
                _note(self.reduced, "all_reduce", t)
                self._works.append(dist.all_reduce(
                    t, op=dist.ReduceOp.SUM, async_op=True))
            return
        if vals[0].is_cuda:
            main = torch.cuda.current_stream(vals[0].device)
            if self._side is None:
                self._side = torch.cuda.Stream(vals[0].device)
            self._side.wait_stream(main)
            self._joined = main
            ctx = torch.cuda.stream(self._side)
        else:
            ctx = contextlib.nullcontext()
        with ctx:
            means = _slice_ladder_mean(vals, self.slices, self.cross,
                                       self.reduced)
        for i, m in zip(bucket, means):
            self._means[i] = m

    @contextlib.contextmanager
    def hooked(self, params: Sequence[torch.Tensor],
               prev: Optional[Sequence[torch.Tensor]] = None,
               inv: Optional[float] = None):
        """Arm the backward run inside the block (see the class)."""
        self._reset(len(params))
        owner = {i: b for b, bucket in enumerate(self.plan.buckets)
                 for i in bucket}
        left = [len(bucket) for bucket in self.plan.buckets]

        def final(i, g):
            if g is None:
                g = torch.zeros_like(params[i])
            self.grads[i] = g if prev is None else (prev[i] + g) * inv
            b = owner[i]
            left[b] -= 1
            if left[b] == 0:
                self.ready(b)

        # a param's tensor hook fires once, on its whole grad (a tied
        # weight's uses summed first), under autograd.grad too; the
        # multi-grad hook refuses leaves there
        handles = [p.register_hook(lambda g, i=i: final(i, g))
                   for i, p in enumerate(params)]
        try:
            yield self
        finally:
            for h in handles:
                h.remove()
        for i in range(len(params)):
            if self.grads[i] is None:
                final(i, None)

    def finish(self) -> List[torch.Tensor]:
        """Every bucket's reduce waited; the grads' means, list order."""
        if self._next < len(self._ready):
            raise RuntimeError(
                f"bucket {self._next} of {len(self._ready)} was never "
                f"issued")
        for w in self._works:
            w.wait()
        if self._joined is not None:
            self._joined.wait_stream(self._side)
        if self.slices is None:
            return [g.div_(self.world) for g in self.grads]
        return list(self._means)
