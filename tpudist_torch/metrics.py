"""Rank-0 logging and the JSONL metrics stream.

Counterpart of the serving lane's part of ``tpudist/metrics.py``: the
same record shapes (``kind=serve`` / ``serve_request`` / ``serve_tick``,
each stamped with wall ``ts`` and monotonic ``mono`` clocks), so the JAX
package's offline readers fold the port's runs unchanged.
"""

from __future__ import annotations

import atexit
import json
import os
import time
from dataclasses import dataclass, field
from typing import IO, List, Optional

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
