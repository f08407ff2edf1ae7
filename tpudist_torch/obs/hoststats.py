"""Per-host step-time aggregation: straggler detection at epoch ends.

Copy of ``tpudist/obs/hoststats.py`` for the port. At each epoch end
every process contributes its steady-state step-wall stats for that
epoch, gathered over the host gloo group
(``parallel.distributed.host_group``; the epoch end is already a point
every process reaches), and rank 0 logs a ``kind=hosts`` record listing
every host's mean step time with the three-valued ``straggler_status``
(``verdict.straggler_status``: FAIL when any host's step time exceeds
the pod median by ``TPUDIST_STRAGGLER_FACTOR``).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch.distributed as dist

from tpudist_torch import verdict as verdict_lib
from tpudist_torch.parallel import distributed


class HostStepStats:
    """Epoch-over-epoch per-host step-time tracker.

    Holds the last epoch's straggler verdict in ``status`` (folded into
    the run-end ``kind=timing`` record) and the deltas that turn the
    run-long ``StepTimer`` aggregate into per-epoch means.
    """

    def __init__(self, process_index: int = 0, process_count: int = 1):
        self.process_index = process_index
        self.process_count = process_count
        self.status = verdict_lib.UNGATEABLE
        self.last_hosts: List[Dict[str, Any]] = []
        self._last_steps = 0
        self._last_elapsed = 0.0

    def _local_epoch_stats(self, timer) -> tuple[int, float]:
        """This epoch's (steps, mean step seconds) from the run-long
        timer aggregate; warm-up-only epochs report (0, 0)."""
        d_steps = timer.steps - self._last_steps
        d_elapsed = timer.elapsed - self._last_elapsed
        self._last_steps = timer.steps
        self._last_elapsed = timer.elapsed
        mean = d_elapsed / d_steps if d_steps > 0 else 0.0
        return d_steps, mean

    def _gather(self, steps: int, mean: float) -> np.ndarray:
        """(n_hosts, 3) rows of [process_index, steps, step_s_mean]."""
        local = np.asarray(
            [float(self.process_index), float(steps), mean], np.float32)
        if self.process_count == 1:
            return local[None, :]
        rows: List[Any] = [None] * self.process_count
        dist.all_gather_object(rows, local, group=distributed.host_group())
        return np.stack(rows)

    def epoch_end(self, epoch: int, timer, metrics) -> str:
        """Aggregate this epoch's per-host step stats; log the
        ``kind=hosts`` record (rank 0: MetricsLogger gates itself) and
        update ``status``. Every process must call this (it holds a
        collective when there is more than one)."""
        steps, mean = self._local_epoch_stats(timer)
        try:
            rows = self._gather(steps, mean)
        except Exception:
            # observability never fails a run: a broken host group fails
            # training on its own terms; degrade to the local row
            rows = np.asarray(
                [[float(self.process_index), float(steps), mean]],
                np.float32)
        hosts = [{"process": int(r[0]), "steps": int(r[1]),
                  "step_s_mean": float(r[2])} for r in rows]
        means = [h["step_s_mean"] for h in hosts if h["steps"] > 0]
        median = float(np.median(means)) if means else 0.0
        self.status = verdict_lib.straggler_status(means)
        self.last_hosts = hosts
        worst = max(means) if means else 0.0
        metrics.log(kind="hosts", epoch=epoch, hosts=hosts,
                    median_step_s=median, worst_step_s=worst,
                    straggler_ratio=(worst / median if median > 0
                                     else None),
                    straggler_status=self.status)
        return self.status
