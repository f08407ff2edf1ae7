"""Multi-process initialization and process-level topology.

Counterpart of ``tpudist/parallel/distributed.py`` on
``torch.distributed``, with the same env contract (the launcher sets it):

    TPUDIST_COORDINATOR    host:port of process 0
    TPUDIST_NUM_PROCESSES  the number of processes
    TPUDIST_PROCESS_ID     this process's rank

One process drives one device: NCCL on the card (rank ``r`` takes card
``r % visible cards``), gloo on the CPU. Single-process mode is
first-class: with none of the variables set, :func:`initialize` is a
no-op and everything downstream runs as one process.

Beside the default group, which carries the gradient reduce,
:func:`initialize` creates a gloo group on the host for the barriers and
the verdict aggregation: a host collective that waits on a dead peer can
be left behind by a thread that stops waiting for it, which an NCCL
collective on the card cannot.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.distributed as dist

_HOST_GROUP = None   # the gloo group of barriers and verdicts


@dataclass(frozen=True)
class DistContext:
    """One process drives one device, so the job's device count is
    ``process_count``."""
    process_index: int
    process_count: int
    device: torch.device        # this process's device
    backend: Optional[str] = None   # None: one process, no process group

    @property
    def is_coordinator(self) -> bool:
        """Rank-0 predicate, which gates logging and the final verdict."""
        return self.process_index == 0


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value is None else int(value)


def check_one_card_a_rank(cards: Sequence[str], backend: str) -> None:
    """``cards`` holds each rank's card id, by rank. NCCL cannot put two
    ranks on one card ("Duplicate GPU detected" at the first collective):
    say so now, and never fall back to gloo behind the caller's back."""
    if backend != "nccl":
        return
    seen = {}
    for rank, card in enumerate(cards):
        if card in seen:
            raise ValueError(
                f"ranks {seen[card]} and {rank} would share one card "
                f"({card}): NCCL takes one card a rank; launch at most "
                f"as many processes on a host as it has visible cards")
        seen[card] = rank


def _card_id(device: torch.device) -> str:
    """The card's UUID, unique across hosts."""
    return str(torch.cuda.get_device_properties(device).uuid)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               device, backend: Optional[str] = None) -> DistContext:
    """Join the process group that the arguments or the env contract
    describe, else run as one process. ``device`` is where the caller
    trains (``cuda`` or ``cpu``); on the card this rank's card becomes
    the current device before the group is created. The backend is NCCL
    on the card and gloo on the CPU; ``backend`` overrides it (gloo on the
    card lets several ranks share one card, through host copies)."""
    global _HOST_GROUP
    device = torch.device(device)
    coordinator_address = (coordinator_address
                           or os.environ.get("TPUDIST_COORDINATOR") or None)
    if num_processes is None:
        num_processes = _env_int("TPUDIST_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("TPUDIST_PROCESS_ID")
    if coordinator_address is None and (num_processes or 1) == 1:
        return DistContext(0, 1, device)
    if coordinator_address is None:
        raise ValueError(
            f"TPUDIST_NUM_PROCESSES={num_processes} needs "
            f"TPUDIST_COORDINATOR (host:port of process 0)")
    world = 1 if num_processes is None else num_processes
    rank = 0 if process_id is None and world == 1 else process_id
    if rank is None or not 0 <= rank < world:
        raise ValueError(
            f"TPUDIST_PROCESS_ID={process_id} is not a rank of "
            f"TPUDIST_NUM_PROCESSES={world}")
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}", rank=rank,
            world_size=world)
    if _HOST_GROUP is None:
        _HOST_GROUP = dist.new_group(backend="gloo")
    if device.type == "cuda":
        cards = [None] * world
        dist.all_gather_object(cards, _card_id(device), group=_HOST_GROUP)
        try:
            check_one_card_a_rank(cards, dist.get_backend())
        except ValueError:
            shutdown()
            raise
    return DistContext(process_index=dist.get_rank(),
                       process_count=dist.get_world_size(),
                       device=device, backend=dist.get_backend())


def barrier() -> None:
    """Cross-process sync point over the host group. No-op
    single-process."""
    if dist.is_initialized():
        dist.barrier(group=_HOST_GROUP)


def barrier_bounded(name: str = "tpudist_barrier",
                    timeout_s: Optional[float] = None) -> bool:
    """:func:`barrier` with a bounded wait; returns True iff it TIMED OUT.

    A peer whose own verdict aggregation timed out skips this barrier and
    exits, so an unbounded wait here would hang on it. The wait is
    ``TPUDIST_AGGREGATE_TIMEOUT_S`` (120 s) unless given; on timeout the
    caller must start no further collective, shutdown included. ``name``
    labels the timeout line."""
    if not dist.is_initialized():
        return False
    if timeout_s is None:
        timeout_s = float(os.environ.get("TPUDIST_AGGREGATE_TIMEOUT_S", 120))
    done: list = []

    def go():
        barrier()
        done.append(True)

    t = threading.Thread(target=go, daemon=True)
    t.start()
    t.join(timeout_s)
    if not done:
        print(f"tpudist: end barrier {name!r} timed out after {timeout_s}s "
              "(a peer left without reaching it); skipping shutdown",
              flush=True)
    return not done


def host_group():
    """The gloo group on the host (None single-process)."""
    return _HOST_GROUP


def shutdown() -> None:
    """Leave the process group; best-effort."""
    global _HOST_GROUP
    try:
        if dist.is_initialized():
            dist.destroy_process_group()
    except Exception:
        pass
    _HOST_GROUP = None
