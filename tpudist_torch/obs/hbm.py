"""Device-memory watermark sampler: "the staging budget was nearly
blown" as a number, not a guess.

Counterpart of ``tpudist/obs/hbm.py``. A background thread reads the
CUDA caching allocator's counters (``torch.cuda.memory_stats``) every
``period_s`` and keeps the high-water mark across the run. The reads are
host-side: they enqueue no device work, call no ``synchronize`` and
allocate nothing on the card, so sampling cannot disturb the training it
observes, nor a CUDA graph being captured on the main thread.

``hbm_peak_bytes`` is the allocator's bytes in use
(``allocated_bytes.all.current`` and ``.peak``), as the JAX package's is
the device's bytes in use. A CUDA graph's private pool is reserved, not
allocated, once its capture ends, so it shows in ``hbm_bytes_reserved``
(``reserved_bytes.all.current``) and ``hbm_fragmentation_bytes``
(reserved minus in use), not in the peak. The card's size is read once
at start (``get_device_properties().total_memory``).

Without a card (the CPU) the watermark falls back to the process's peak
RSS, and ``hbm_source`` says which estimate is read.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Sequence


def _rss_peak_bytes() -> Optional[int]:
    """Peak RSS of this process in bytes (Linux ru_maxrss is KiB)."""
    try:
        import resource
        import sys
        ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return int(ru) if sys.platform == "darwin" else int(ru) * 1024
    except Exception:
        return None


class HbmSampler:
    """Background high-water-mark tracker over ``devices`` (CUDA device
    indices; none: the CPU, which reads RSS).

    ``period_s > 0`` starts a daemon thread; ``period_s == 0`` makes the
    sampler manual (callers invoke :meth:`sample` themselves). One
    synchronous sample is always taken at construction so short runs
    still report a watermark.
    """

    def __init__(self, period_s: float = 2.0,
                 devices: Sequence[int] = ()):
        if period_s < 0:
            raise ValueError(f"period_s must be >= 0, got {period_s}")
        self.period_s = float(period_s)
        self.devices = tuple(int(d) for d in devices)
        self.peak_in_use = 0        # max over time of max over devices
        self.last_in_use = 0
        self.last_reserved: Optional[int] = None  # allocator reservation
        self.limit_bytes: Optional[int] = None
        self.source = "none"        # memory_stats | rss | none
        self.samples = 0
        if self.devices:
            import torch
            self.limit_bytes = max(
                int(torch.cuda.get_device_properties(d).total_memory)
                for d in self.devices)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.sample()
        if self.period_s > 0:
            self._thread = threading.Thread(
                target=self._loop, name="tpudist-hbm", daemon=True)
            self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.period_s):
            self.sample()

    def sample(self) -> None:
        """One read of every device's allocator counters, folded into the
        high-water mark. Never raises: a failing read must not kill the
        thread."""
        in_use = peak_reported = reserved = 0
        got_stats = False
        if self.devices:
            try:
                import torch
                for d in self.devices:
                    stats = torch.cuda.memory_stats(d)
                    if not stats:
                        continue
                    got_stats = True
                    in_use = max(in_use, int(stats.get(
                        "allocated_bytes.all.current", 0)))
                    peak_reported = max(peak_reported, int(stats.get(
                        "allocated_bytes.all.peak", 0)))
                    reserved = max(reserved, int(stats.get(
                        "reserved_bytes.all.current", 0)))
            except Exception:
                got_stats = False
        if got_stats:
            self.source = "memory_stats"
            self.last_in_use = in_use
            self.last_reserved = reserved
            self.peak_in_use = max(self.peak_in_use, in_use, peak_reported)
        elif self.source != "memory_stats":
            # RSS only where the card never reported: one failed read
            # mid-run must not fold host RSS into a device watermark
            rss = _rss_peak_bytes()
            if rss is not None:
                self.source = "rss"
                self.last_in_use = rss
                self.peak_in_use = max(self.peak_in_use, rss)
        self.samples += 1

    def split(self) -> Dict[str, Any]:
        """Watermark fields for the ``kind=timing`` record and the
        flight-record dump (the JAX package's schema)."""
        frac = None
        if self.limit_bytes and self.peak_in_use:
            frac = round(self.peak_in_use / self.limit_bytes, 4)
        # fragmentation: what the allocator holds beyond live tensors
        # (graph pools and cached blocks); only from the card's counters
        frag = None
        if self.last_reserved is not None \
                and self.source == "memory_stats":
            frag = max(0, self.last_reserved - self.last_in_use)
        return {"hbm_peak_bytes": self.peak_in_use or None,
                "hbm_bytes_in_use": self.last_in_use or None,
                "hbm_bytes_reserved": self.last_reserved,
                "hbm_fragmentation_bytes": frag,
                "hbm_limit_bytes": self.limit_bytes,
                "hbm_peak_fraction": frac,
                "hbm_source": self.source}

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self.sample()   # final watermark covers the run's tail
