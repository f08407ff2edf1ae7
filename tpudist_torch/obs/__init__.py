"""tpudist_torch.obs — the observability a default run writes.

Counterpart of ``tpudist/obs``, the part every default JAX run switches
on (ROADMAP Queue A item 11a):

  * :mod:`trace` — the host-side span tracer, its per-worker Chrome
    traces and the merged ``pod_trace.json``;
  * :mod:`heartbeat` — the per-process beacon and stall watchdog, which
    dumps a :mod:`flightrec` record before the launcher kills a hung run;
  * :mod:`hbm` — the device-memory watermark sampler;
  * :mod:`hoststats` — the epoch-end per-host step times and the
    straggler verdict (``kind=hosts``);
  * :mod:`mfu` — the step's flop count and the MFU fields;
  * :mod:`memledger` — the exact per-card memory ledger;
  * :mod:`live` — the run's correlation id, and the live aggregator's
    file half (``alerts.jsonl``, ``live_status.json``), which the serve
    CLI runs under ``TPUDIST_LIVE=on``;
  * :mod:`goodput` — the goodput ledger: the requeue loop's
    ``attempts.jsonl``, which the drills write, the attempt-local
    ``kind=goodput`` record and the cross-attempt partition the chaos
    verifier reads.

The JAX package's jax-free offline tools (``tpudist.obs.report``,
``goodput``, the ``memledger`` CLI, ``tpudist.serve.flight``) read a
port run's artifacts unchanged. :class:`PodObserver` is the facade the
train loop wires through: one object to start, feed progress, ask for
record fields, and close.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

from tpudist_torch.obs import trace
from tpudist_torch.obs.hbm import HbmSampler
from tpudist_torch.obs.heartbeat import FlightRecorder


class PodObserver:
    """The train loop's one observability handle: the flight recorder
    (beacon and watchdog), the HBM watermark sampler and the per-host
    straggler tracking, started together and closed together.

    A stall window of 0 or a sample period of 0 turns that piece's
    thread off (the beacon still beats; the sampler then reads only when
    asked); every method works whichever pieces are on.
    """

    def __init__(self, *, out_dir: str, stall_timeout_s: float = 300.0,
                 hbm_sample_s: float = 2.0, metrics: Any = None,
                 process_index: int = 0, process_count: int = 1,
                 devices: Sequence[int] = (), requeue_attempt: int = 0):
        from tpudist_torch.obs.hoststats import HostStepStats
        self.hbm = (HbmSampler(period_s=hbm_sample_s, devices=devices)
                    if hbm_sample_s > 0 else None)
        self.hosts = HostStepStats(process_index=process_index,
                                   process_count=process_count)
        # the last assembled memory ledger: a later flight record
        # carries the final bucket partition
        self.last_memledger: Optional[Dict[str, Any]] = None

        def _extra_state() -> Dict[str, Any]:
            out = dict(self.hbm.split()) if self.hbm is not None else {}
            if self.last_memledger is not None:
                out["memledger"] = self.last_memledger
            return out

        def _beacon_extra() -> Dict[str, Any]:
            # a counter read only: no fence, no device call
            if self.hbm is None:
                return {}
            return {"hbm_peak_bytes": self.hbm.peak_in_use or None}

        self.recorder = FlightRecorder(
            out_dir, stall_timeout_s=stall_timeout_s,
            process_index=process_index, metrics=metrics,
            extra_state=_extra_state, tracer=trace.get(),
            beacon_extra=_beacon_extra, requeue_attempt=requeue_attempt)
        self._closed = False

    @classmethod
    def from_config(cls, cfg, *, metrics=None, process_index: int = 0,
                    process_count: int = 1,
                    devices: Sequence[int] = ()) -> "PodObserver":
        from tpudist_torch.config import resolve_obs, resolve_requeue_attempt
        stall_s, out_dir, hbm_s = resolve_obs(cfg)
        return cls(out_dir=out_dir, stall_timeout_s=stall_s,
                   hbm_sample_s=hbm_s, metrics=metrics,
                   process_index=process_index,
                   process_count=process_count, devices=devices,
                   requeue_attempt=resolve_requeue_attempt(cfg))

    def note_progress(self, **kv: Any) -> None:
        self.recorder.note_progress(**kv)

    def beacon_now(self) -> None:
        """One beacon written now, off the watchdog's cadence: a scripted
        kill stamps it before ``os._exit``."""
        self.recorder.beacon_now()

    def epoch_end(self, epoch: int, timer, metrics) -> str:
        """Per-host step-stat aggregation (a collective with more than
        one process: every process calls this at every epoch end)."""
        return self.hosts.epoch_end(epoch, timer, metrics)

    def sample_hbm(self) -> None:
        """Fold the allocator's counters into the watermark now."""
        if self.hbm is not None:
            self.hbm.sample()

    def hbm_fields(self) -> Dict[str, Any]:
        if self.hbm is None:
            # HbmSampler.split's schema: every hbm_* key in every timing
            # record, None = not derived
            return {"hbm_peak_bytes": None, "hbm_bytes_in_use": None,
                    "hbm_bytes_reserved": None,
                    "hbm_fragmentation_bytes": None,
                    "hbm_limit_bytes": None, "hbm_peak_fraction": None,
                    "hbm_source": "off"}
        self.hbm.sample()   # final watermark before the record is cut
        return self.hbm.split()

    def timing_fields(self, timer, dispatch_fn: Any) -> Dict[str, Any]:
        """The observability slice of the run-end ``kind=timing``
        record: MFU from the dispatch's flop count, the HBM watermarks
        and the last epoch's straggler verdict."""
        from tpudist_torch.obs import mfu
        step_s = (timer.elapsed / timer.steps) if timer.steps else 0.0
        fields = mfu.mfu_fields(mfu.dispatch_cost(dispatch_fn), step_s)
        fields.update(self.hbm_fields())
        fields["straggler_status"] = self.hosts.status
        return fields

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.recorder.close()
        if self.hbm is not None:
            self.hbm.close()
