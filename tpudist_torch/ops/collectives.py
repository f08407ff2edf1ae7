"""Measured collectives: the fabric-acceptance core.

Counterpart of ``tpudist/ops/collectives.py`` over a
``torch.distributed`` process group (NCCL on the card, gloo on the
CPU): each kind is the group's own collective, issued by every rank,
with correct bus-bandwidth accounting.

Bus-bandwidth convention (nccl-tests / ring-algorithm):
    reported size S = the logical message (see each kind below)
    all_reduce      busBW = 2(n-1)/n x S / t
    all_gather      busBW =  (n-1)/n x S / t   (S = full gathered buffer)
    reduce_scatter  busBW =  (n-1)/n x S / t   (S = full input buffer)
    all_to_all      busBW =  (n-1)/n x S / t   (S = per-rank send buffer)
    ppermute        busBW =            S / t   (S = per-hop message: each
                                                rank's buffer one hop
                                                around the ring)

Every rank holds DISTINCT data: its own slice of the iota the JAX
package lays out over its devices (``_sharded_iota``), made on the card,
so a rank's input is its device's shard of the JAX op's input and the
results equal the JAX op's shard for shard.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from tpudist_torch.parallel import tensor as tensor_lib

KINDS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
         "ppermute")

BUS_FACTOR: Dict[str, Callable[[int], float]] = {
    "all_reduce": lambda n: 2 * (n - 1) / n,
    "all_gather": lambda n: (n - 1) / n,
    "reduce_scatter": lambda n: (n - 1) / n,
    "all_to_all": lambda n: (n - 1) / n,
    "ppermute": lambda n: 1.0,
}


def build_op(kind: str, group=None, *, message_bytes: int,
             dtype: torch.dtype = torch.float32,
             device: Optional[torch.device] = None
             ) -> Tuple[Callable[[], torch.Tensor], torch.Tensor, int]:
    """``(op, input, actual message bytes)`` for one collective at one
    message size over ``group`` (None: the world), this rank's share.
    ``op()`` issues the collective and returns this rank's output buffer
    (the same tensor each call; the all-reduce sums in place, so only
    its first call's result is the JAX op's).

    ``message_bytes`` is the logical message size S of the module
    docstring, rounded down so shapes tile evenly over the group, as the
    JAX ``build_op`` rounds it: E = max(S // itemsize, n), floored to a
    multiple of n."""
    if kind not in KINDS:
        raise ValueError(f"unknown collective {kind!r}; one of {KINDS}")
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    item = torch.empty((), dtype=dtype).element_size()
    elems = max(message_bytes // item, n)
    elems = (elems // n) * n

    def iota(lo, count):
        return torch.arange(lo, lo + count, dtype=dtype, device=device)

    if kind == "all_reduce":
        # row r of the (n, E) iota: each rank a DISTINCT full buffer,
        # reduced in place (no copy inside the timed call)
        x = iota(r * elems, elems)
        out = x.clone()

        def op():
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
            return out
    elif kind == "reduce_scatter":
        x = iota(r * elems, elems)
        out = x.new_empty((elems // n,))

        def op():
            tensor_lib.collective(dist.reduce_scatter_tensor, out, x,
                                  op=dist.ReduceOp.SUM, group=group)
            return out
    elif kind == "all_gather":
        # shards of E/n gather into the full E buffer on every rank
        x = iota(r * (elems // n), elems // n)
        out = x.new_empty((elems,))

        def op():
            tensor_lib.collective(dist.all_gather_into_tensor, out, x,
                                  group=group)
            return out
    elif kind == "all_to_all":
        # each rank's send buffer is E (global n*E), exchanged n ways
        x = iota(r * elems, elems)
        out = torch.empty_like(x)

        def op():
            dist.all_to_all_single(out, x, group=group)
            return out
    else:
        # ppermute: each rank passes its E-buffer one hop around the ring
        x = iota(r * elems, elems)
        out = torch.empty_like(x)
        ranks = dist.get_process_group_ranks(group) if group is not None \
            else list(range(n))

        def op():
            if n == 1:
                return out.copy_(x)
            works = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, x, ranks[(r + 1) % n], group),
                dist.P2POp(dist.irecv, out, ranks[(r - 1) % n], group)])
            for w in works:
                w.wait()
            return out
    return op, x, elems * item


def expected(kind: str, n: int, r: int, message_bytes: int,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Rank ``r``'s output of ``kind`` over ``n`` ranks at
    ``message_bytes`` in closed form (on the CPU, in float64, then cast):
    the check of a collective's result at a size whose sums the dtype
    holds exactly."""
    item = torch.empty((), dtype=dtype).element_size()
    elems = max(message_bytes // item, n)
    elems = (elems // n) * n
    e = torch.arange(elems, dtype=torch.float64)
    c = elems // n
    if kind == "all_reduce":
        out = n * e + elems * (n * (n - 1) // 2)
    elif kind == "reduce_scatter":
        out = (n * e + elems * (n * (n - 1) // 2))[r * c:(r + 1) * c]
    elif kind == "all_gather":
        out = e
    elif kind == "all_to_all":
        # chunk r of every rank's buffer, in rank order
        out = torch.cat([j * elems + e[r * c:(r + 1) * c]
                         for j in range(n)])
    elif kind == "ppermute":
        out = ((r - 1) % n) * elems + e
    else:
        raise ValueError(f"unknown collective {kind!r}; one of {KINDS}")
    return out.to(dtype)


@dataclass
class CollectiveTiming:
    kind: str
    n_devices: int
    message_bytes: int
    mean_s: float
    min_s: float
    algo_gbps: float       # message_bytes / min_s
    bus_gbps: float        # algo x bus factor


def time_collective(kind: str, group=None, *, message_bytes: int,
                    dtype: torch.dtype = torch.float32, iters: int = 10,
                    warmup: int = 3,
                    device: Optional[torch.device] = None
                    ) -> CollectiveTiming:
    """Time one collective at one message size: ``warmup`` calls (the
    communicator's first use and first touch), a barrier, then ``iters``
    calls each timed alone, by CUDA events around it on the card (the
    step's stream waits for the collective before the end event) and by
    the host clock on the CPU. An iteration's time is the slowest rank's
    (a MAX all-reduce of the times), so every rank reports one record."""
    n = dist.get_world_size(group)
    op, _, actual_bytes = build_op(kind, group, message_bytes=message_bytes,
                                   dtype=dtype, device=device)
    cuda = device is not None and torch.device(device).type == "cuda"
    for _ in range(warmup):
        op()
    if cuda:
        torch.cuda.synchronize(device)
    dist.barrier(group=group)
    times: List[float] = []
    for _ in range(iters):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            op()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            op()
            times.append(time.perf_counter() - t0)
    slowest = torch.tensor(times, dtype=torch.float64,
                           device=device if cuda else None)
    dist.all_reduce(slowest, op=dist.ReduceOp.MAX, group=group)
    times = slowest.tolist()
    mean_s = sum(times) / len(times)
    min_s = min(times)
    algo = actual_bytes / min_s / 1e9
    return CollectiveTiming(kind=kind, n_devices=n,
                            message_bytes=actual_bytes, mean_s=mean_s,
                            min_s=min_s, algo_gbps=algo,
                            bus_gbps=algo * BUS_FACTOR[kind](n))
