"""Flight-record dump: the post-mortem a hung run leaves behind.

Copy of ``tpudist/obs/flightrec.py`` for the port. The dump holds
faulthandler stacks of every thread (a wedged collective's frame is
right there), each local card's ``torch.cuda.memory_stats``, the last
progress beacon, the span tracer's tails and the tail of the in-memory
metrics history: one JSON artifact per worker (``flightrec.worker<i>``),
written atomically.

The writer must itself be hang-proof and must not disturb a CUDA-graph
capture running on another thread: it touches the device runtime only
through the caching allocator's host-side counters (``memory_stats``),
never synchronises, and swallows per-section failures.
"""

from __future__ import annotations

import faulthandler
import json
import os
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

FLIGHTREC_SCHEMA_VERSION = 1


def thread_stacks() -> str:
    """All threads' stacks as text, via :mod:`faulthandler` (the signal-
    safe dumper — it walks frames without allocating, so it works even
    when the main thread is wedged holding internal locks). faulthandler
    needs a real file descriptor, so route it through a TemporaryFile."""
    try:
        with tempfile.TemporaryFile(mode="w+") as tf:
            faulthandler.dump_traceback(file=tf, all_threads=True)
            tf.seek(0)
            return tf.read()
    except Exception as e:   # a diagnosis tool must not raise
        return f"<thread stack dump failed: {e!r}>"


def collect_memory_stats() -> List[Dict[str, Any]]:
    """Each local card's ``torch.cuda.memory_stats`` (the caching
    allocator's host-side counters: no device call, no fence); an empty
    list on a machine without a card or before CUDA is initialised."""
    out: List[Dict[str, Any]] = []
    try:
        import torch
        if not torch.cuda.is_initialized():
            return out
        for d in range(torch.cuda.device_count()):
            try:
                stats = dict(torch.cuda.memory_stats(d))
            except Exception:
                stats = None
            out.append({"id": d,
                        "kind": torch.cuda.get_device_properties(d).name,
                        "stats": stats})
    except Exception:
        pass
    return out


def dump_flight_record(path: str, *, reason: str,
                       progress: Optional[Dict[str, Any]] = None,
                       stall_s: Optional[float] = None,
                       last_metrics: Optional[List[Dict]] = None,
                       spans: Optional[List[Dict]] = None,
                       extra: Optional[Dict[str, Any]] = None) -> str:
    """Write one flight-record artifact to ``path`` and return the path.

    The artifact is a single JSON object (CI parses it) with:
    ``reason`` (why the dump fired), ``progress`` (the last beacon:
    step/epoch/phase/ts), ``thread_stacks`` (faulthandler text),
    ``memory_stats`` (per device), ``last_metrics`` (tail of the
    in-memory record history), ``spans`` (the span tracer's per-thread
    buffer tails + open-span stacks — what phase each thread was in
    when the dump fired), and any ``extra`` observer state (HBM
    watermarks). Atomic write: tmp + ``os.replace``."""
    payload: Dict[str, Any] = {
        "schema": FLIGHTREC_SCHEMA_VERSION,
        "reason": reason,
        "ts": time.time(),
        "pid": os.getpid(),
        "python": sys.version.split()[0],
        "stall_s": stall_s,
        "progress": progress or {},
        "thread_stacks": thread_stacks(),
        "memory_stats": collect_memory_stats(),
        "last_metrics": list(last_metrics or []),
        "spans": spans,
    }
    if extra:
        payload["extra"] = extra
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1, default=str)
    os.replace(tmp, path)
    return path
