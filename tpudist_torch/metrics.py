"""Rank-0 logging, step timing and the JSONL metrics stream.

Counterpart of ``tpudist/metrics.py``: the same record shapes (the serve
lane's ``kind=serve`` / ``serve_request`` / ``serve_tick``, the train
lane's ``step`` / ``epoch`` / ``ckpt`` / ``timing`` / ``attempt`` /
``hosts`` / ``memledger``, each stamped with wall ``ts`` and monotonic
``mono`` clocks and the run's identity), so the JAX package's offline
readers fold the port's runs unchanged, and the epoch staging
pipeline's accounting (:class:`StagingStats`).
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import IO, Any, Dict, List, Optional

import torch

from tpudist_torch.obs import trace as trace_lib


def _rank() -> int:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return 0


def log0(msg: str) -> None:
    """Print on rank 0 only."""
    if _rank() == 0:
        print(msg, flush=True)


@dataclass
class StepTimer:
    """Wall clock over completed device work.

    ``stop_many(result, n)`` copies ``result`` to the host before reading
    the clock (PyTorch returns before the card finishes, so the copy is
    the fence), and counts ``n`` steps. The first stop (the first step:
    the kernels' build and the allocator's first growth) is kept out of
    the throughput aggregate. ``chips`` is the job's device count, one a
    process."""

    WARMUP = 1
    chips: int = 1
    t0: float = 0.0
    elapsed: float = 0.0
    steps: int = 0
    warmup_s: float = 0.0
    _seen: int = 0

    def start(self) -> None:
        self.t0 = time.perf_counter()

    @property
    def warming(self) -> bool:
        """Still inside the warmup stops."""
        return self._seen < self.WARMUP

    def stop_many(self, result: Any, n: int) -> float:
        if n <= 0:
            return 0.0
        if isinstance(result, torch.Tensor):
            with trace_lib.span("fence", cat="dispatch", steps=n):
                result.detach().cpu()
        dt = time.perf_counter() - self.t0
        self._seen += 1
        if self._seen <= self.WARMUP:
            self.warmup_s += dt
        else:
            self.elapsed += dt
            self.steps += n
        return dt

    def split(self) -> Dict[str, Any]:
        """Warmup-vs-run wall split for the metrics stream, full
        precision."""
        return {"compile_warmup_s": self.warmup_s,
                "run_s": self.elapsed, "steps": self.steps}

    def steps_per_sec(self) -> float:
        return self.steps / self.elapsed if self.elapsed > 0 else 0.0

    def steps_per_sec_per_chip(self) -> float:
        return self.steps_per_sec() / max(self.chips, 1)


@dataclass
class MetricsLogger:
    """JSONL metrics stream, rank 0 only.

    Writes are BUFFERED: ``log()`` only serialises the record into
    memory, and file I/O happens at ``flush()`` and ``close()``, so it
    never lands inside a timed window. An ``atexit`` hook flushes the
    tail on any interpreter exit, and the stall watchdog flushes from
    its thread (a lock pairs that with the main thread's ``log()``).

    ``extra`` is stamped into EVERY record under the record's own keys
    (a record naming a key itself wins): the run's ``run_id`` and
    ``requeue_attempt``. ``history`` keeps the records, whose tail a
    flight record carries. ``emitter`` is the live fan-out: when set,
    every record also goes to ``emitter.emit(rec)`` (the serve CLI's
    loopback into :class:`~tpudist_torch.obs.live.LiveAggregator`); one
    ``is not None`` check when unset. ``all_ranks`` lifts the rank-0
    gate for a stream of a rank's own (the selfcheck's drills, each rank
    in its own directory)."""

    path: Optional[str] = None
    _fh: Optional[IO] = None
    history: List[Dict] = field(default_factory=list)
    _buf: List[str] = field(default_factory=list)
    extra: Dict[str, Any] = field(default_factory=dict)
    emitter: Any = None
    all_ranks: bool = False

    def __post_init__(self) -> None:
        self._lock = threading.Lock()
        atexit.register(self.flush)

    def log(self, **kv) -> None:
        if not self.all_ranks and _rank() != 0:
            return
        rec = {"ts": time.time(), "mono": time.perf_counter(),
               **self.extra, **kv}
        with self._lock:
            self.history.append(rec)
            if self.path:
                self._buf.append(json.dumps(rec))
        if self.emitter is not None:
            # outside the lock: the emitter may log alerts back
            self.emitter.emit(rec)

    def flush(self) -> None:
        with self._lock:
            if not (self.path and self._buf):
                return
            if self._fh is None:
                d = os.path.dirname(self.path)
                if d:
                    os.makedirs(d, exist_ok=True)
                self._fh = open(self.path, "a")
            self._fh.write("\n".join(self._buf) + "\n")
            self._fh.flush()
            self._buf.clear()

    def close(self) -> None:
        self.flush()
        with self._lock:
            if self._fh:
                self._fh.close()
                self._fh = None
        atexit.unregister(self.flush)


@dataclass
class StagingStats:
    """Host-side accounting of the epoch staging pipeline
    (``train._superstep_epoch``): how many bytes were staged, the peak
    resident staging footprint, and how much wall time the host spent
    BLOCKED on a slab that compute was already waiting for.

    ``wait_s`` is the exposure metric: the streaming loop fences compute
    at slab boundaries, so by the time it blocks on the next slab's event
    the device is idle, and any time spent there is host-to-device
    transfer the pipeline failed to hide behind the previous slab's
    compute. ``overlap_fraction`` folds that into one number for the
    verdict and the metrics stream: 1.0 = all steady-state transfer
    hidden.
    """
    streamed: bool = False
    slabs: int = 0
    staged_bytes: int = 0      # cumulative per-device H2D bytes
    resident_bytes: int = 0
    peak_bytes: int = 0
    stage_host_s: float = 0.0  # host time materialising + issuing slabs
    wait_s: float = 0.0        # host blocked on an un-arrived slab

    def note_staged(self, nbytes: int, host_s: float) -> None:
        self.slabs += 1
        self.staged_bytes += nbytes
        self.resident_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.resident_bytes)
        self.stage_host_s += host_s

    def note_released(self, nbytes: int) -> None:
        self.resident_bytes = max(0, self.resident_bytes - nbytes)

    def note_wait(self, slab) -> float:
        """Block until ``slab`` (a ``parallel.staging.StagedSlab``) has
        landed, on its copies' event; account the exposed time. Called
        with the previous slab's compute already drained."""
        t0 = time.perf_counter()
        with trace_lib.span("slab_wait", cat="staging"):
            slab.synchronize()
        dt = time.perf_counter() - t0
        self.wait_s += dt
        return dt

    def overlap_fraction(self, run_s: float) -> Optional[float]:
        """Fraction of steady-state wall time NOT exposed to staging
        waits; None when nothing streamed (fast path: one slab, whose
        transfer overlaps the warm-up by construction)."""
        if not self.streamed or run_s <= 0:
            return None
        return max(0.0, min(1.0, 1.0 - self.wait_s / run_s))

    def split(self) -> Dict[str, Any]:
        """Staging-vs-compute fields for the ``kind=timing`` record."""
        return {"staging_streamed": self.streamed,
                "staging_slabs": self.slabs,
                "staged_bytes": self.staged_bytes,
                "staged_bytes_peak": self.peak_bytes,
                "stage_host_s": round(self.stage_host_s, 3),
                "stage_wait_s": round(self.wait_s, 3)}
