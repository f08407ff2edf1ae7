"""Epoch staging: how an epoch's batches move from the host to the device.

Counterpart of ``tpudist/parallel/sharding.py``'s ``SlabPlan`` /
``plan_slabs`` (copied as written) and ``put_epoch``. The superstep
train loop (``train._superstep_epoch``) stages one ``(slab_steps,
local_batch, ...)`` slab while the previous slab's supersteps run:
double-buffered, so at most two slabs are resident and ``2 * slab_bytes
<= budget_bytes`` by construction.

On the card :func:`put_slab` copies a slab into pinned host memory and
issues the host-to-device copy on a side stream, recording an event; the
compute stream waits on that event (:meth:`StagedSlab.arrays_for`)
before it reads the slab, and the host can block on it
(:meth:`StagedSlab.synchronize`) to measure exposed transfer. On the CPU
it is a plain copy. Integer arrays (token ids) are staged as int64, the
dtype the models index with, so a slab's bytes count that dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SlabPlan:
    """How one epoch's batches move host->device under the staging budget.

    ``slab_steps`` is the staging granularity: the train loop materialises
    and stages one ``(slab_steps, local_batch, ...)`` slab while the
    previous slab's supersteps run, so at most two slabs are resident and
    ``2 * slab_bytes <= budget_bytes`` by construction. The fast path
    (``streamed=False``) is the degenerate one-slab plan: the whole epoch
    (padded to a ``k``-multiple) stages in one transfer.
    """

    n_steps: int            # true steps in the epoch
    k: int                  # superstep length (steps per dispatch)
    slab_steps: int         # steps per staged slab (a k-multiple)
    n_slabs: int
    step_bytes: int         # per-device bytes of one step's batch
    budget_bytes: Optional[int]
    streamed: bool

    @property
    def slab_bytes(self) -> int:
        return self.slab_steps * self.step_bytes


def plan_slabs(n_steps: int, k: int, step_bytes: int,
               budget_bytes: Optional[int]) -> SlabPlan:
    """Cut an epoch into double-buffered staging slabs under
    ``budget_bytes`` of per-device staging memory.

    * epoch fits the budget (or no budget) -> the full-epoch fast path:
      one slab, ``streamed=False``.
    * otherwise -> the largest ``k``-multiple slab with two copies inside
      the budget (current + in-flight next).
    * budget too small to double-buffer even one ``k``-step slab -> a
      clear config error, not a silent OOM at dispatch time.
    """
    if n_steps < 1:
        raise ValueError(f"epoch must have >= 1 step, got {n_steps}")
    if k < 1:
        raise ValueError(f"superstep length must be >= 1, got {k}")
    step_bytes = max(int(step_bytes), 1)
    padded = -(-n_steps // k) * k
    # the fast path stages the PADDED epoch, so the fit check must use
    # it too — an epoch just under budget must stream, not stage k-1
    # extra padded steps past the budget
    if budget_bytes is None or padded * step_bytes <= budget_bytes:
        return SlabPlan(n_steps, k, padded, 1, step_bytes, budget_bytes,
                        streamed=False)
    slab_steps = (budget_bytes // 2) // step_bytes // k * k
    if slab_steps < k:
        need = 2 * k * step_bytes
        raise ValueError(
            f"staging budget {budget_bytes / 2**20:.2f} MB cannot hold a "
            f"double-buffered pair of k={k}-step slabs "
            f"({need / 2**20:.2f} MB needed at "
            f"{step_bytes / 2**20:.3f} MB/step): raise --staging-budget-mb "
            f"or lower --steps-per-dispatch")
    slab_steps = min(slab_steps, padded)
    n_slabs = -(-padded // slab_steps)
    return SlabPlan(n_steps, k, slab_steps, n_slabs, step_bytes,
                    budget_bytes, streamed=True)


def staged_dtype(dtype: np.dtype) -> np.dtype:
    """The dtype a host array is staged in: int64 for integers (token
    ids), else its own."""
    return np.dtype(np.int64) if np.dtype(dtype).kind in "iu" \
        else np.dtype(dtype)


def step_bytes(arrays: Sequence[np.ndarray], local_batch: int) -> int:
    """Device bytes of one staged ``(local_batch, ...)`` step of the
    source ``arrays`` (``(n_samples, ...)`` each), in the staged dtype.
    One device a process, so these are per-device bytes."""
    return sum(local_batch * int(np.prod(a.shape[1:], dtype=np.int64))
               * staged_dtype(a.dtype).itemsize for a in arrays)


@dataclasses.dataclass
class StagedSlab:
    """A slab on its device: the ``(steps, local_batch, ...)`` tensors
    and, on the card, the event its copies recorded on the staging
    stream."""

    arrays: Tuple[torch.Tensor, ...]
    event: Optional["torch.cuda.Event"] = None

    def synchronize(self) -> None:
        """Block the host until the slab has landed."""
        if self.event is not None:
            self.event.synchronize()

    def arrays_for(self) -> Tuple[torch.Tensor, ...]:
        """The tensors, with the current stream made to wait for the
        copies and the tensors marked as used there, so the allocator
        does not hand their memory to the next slab before that stream is
        done with them."""
        if self.event is None:
            return self.arrays
        stream = torch.cuda.current_stream(self.arrays[0].device)
        stream.wait_event(self.event)
        for t in self.arrays:
            t.record_stream(stream)
        return self.arrays


def put_slab(arrays: Sequence[np.ndarray], device: torch.device,
             stream=None) -> StagedSlab:
    """Stage host ``(steps, local_batch, ...)`` arrays on ``device``.

    On the card: each array is copied into pinned host memory and then
    to the device by a ``non_blocking`` copy on ``stream`` (a side
    stream; a new one from the pool when None), which records the
    returned slab's event. The call returns once the copies are issued,
    so the transfer overlaps whatever compute is already enqueued. On the
    CPU: a plain copy."""
    host = [np.ascontiguousarray(a, dtype=staged_dtype(a.dtype))
            for a in arrays]
    if device.type != "cuda":
        return StagedSlab(tuple(torch.from_numpy(a).clone() for a in host))
    stream = stream or torch.cuda.Stream(device)
    pinned = [torch.from_numpy(a).pin_memory() for a in host]
    with torch.cuda.stream(stream):
        out = tuple(torch.empty(p.shape, dtype=p.dtype, device=device)
                    for p in pinned)
        for dst, src in zip(out, pinned):
            dst.copy_(src, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
    return StagedSlab(out, event)
