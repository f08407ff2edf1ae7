"""Rank-0 logging, step timing and the JSONL metrics stream.

Counterpart of ``tpudist/metrics.py``: the same record shapes (the serve
lane's ``kind=serve`` / ``serve_request`` / ``serve_tick``, the train
lane's ``step`` / ``epoch`` / ``ckpt`` / ``timing`` / ``attempt``, each
stamped with wall ``ts`` and monotonic ``mono`` clocks), so the JAX
package's offline readers fold the port's runs unchanged.
"""

from __future__ import annotations

import atexit
import json
import os
import time
from dataclasses import dataclass, field
from typing import IO, Any, Dict, List, Optional

import torch


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
    tail on any interpreter exit."""

    path: Optional[str] = None
    _fh: Optional[IO] = None
    _buf: List[str] = field(default_factory=list)

    def __post_init__(self) -> None:
        atexit.register(self.flush)

    def log(self, **kv) -> None:
        if _rank() != 0 or not self.path:
            return
        rec = {"ts": time.time(), "mono": time.perf_counter(), **kv}
        self._buf.append(json.dumps(rec))

    def flush(self) -> None:
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
        if self._fh:
            self._fh.close()
            self._fh = None
        atexit.unregister(self.flush)
