"""Per-process heartbeat beacon and stall watchdog.

Copy of ``tpudist/obs/heartbeat.py`` for the port. The train loop calls
:meth:`FlightRecorder.note_progress` at step boundaries (two attribute
assignments, nothing fenced); a daemon thread writes a small JSON beacon
(``heartbeat.worker<i>``: step, epoch, phase, ts) every few seconds,
ships it on the live bus when there is one, and, when no progress was
noted for ``stall_timeout_s``, runs the stall hook, dumps a flight
record (:mod:`tpudist_torch.obs.flightrec`) and flushes the buffered
metrics before the launcher kills the job. The thread touches the card only
through the caching allocator's counters, so it cannot disturb a CUDA
graph being captured or replayed on the main thread.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, Optional

from tpudist_torch.obs import flightrec

# beacon/watchdog wake period is derived from the stall window (a 0.5 s
# test window needs sub-second checks; a production 300 s window does
# not) and clamped to these bounds
_MIN_PERIOD_S = 0.05
_MAX_PERIOD_S = 2.0


class FlightRecorder:
    """Heartbeat beacon + stall watchdog for one process.

    Parameters:
      * ``out_dir`` — where ``heartbeat.worker<i>`` and
        ``flightrec.worker<i>`` land (the launcher collects this
        directory when a run times out).
      * ``stall_timeout_s`` — no step progress for this long ⇒ dump a
        flight record. ``0`` disables the watchdog (the beacon still
        beats).
      * ``process_index`` — names the artifacts; cached at construction
        so the watchdog thread never calls into the process group.
      * ``metrics`` — a ``MetricsLogger``; the stall dump embeds the
        tail of its history and flushes its buffer (the records matter
        most in exactly the runs that die).
      * ``extra_state`` — optional callable returning a dict folded into
        the dump (the HBM sampler's watermarks ride along here).
      * ``tracer`` — an ``obs.trace.Tracer``; the stall dump embeds the
        tail of its span buffers (what phase each thread was in when
        the run hung) and exports the worker's local Chrome trace next
        to the flight record — a hung run leaves its TIMELINE, not
        just its stacks.
      * ``stall_hook`` — optional callable fired at dump time, BEFORE
        the record is written; a path it returns is recorded as
        ``profile_capture`` in the flight record, a dict is folded into
        the record's extras. The windowed device profiler
        (``obs.devtime.WindowProfiler.emergency_stop``) hangs off this:
        ``torch.profiler`` cannot be stopped from the watchdog's thread,
        so an open window reports its capture lost and why
        (``profile_capture_lost``) instead of a path.
      * ``emitter`` — a live-telemetry emitter (obs.live
        ``TelemetryEmitter``): every beacon ALSO ships as a
        ``kind=heartbeat`` record to the coordinator's aggregator (the
        per-host liveness signal the on-line stall alert keys off),
        and the stall dump ships a ``kind=stall_dump`` record FIRST —
        before the slow stack/memory collection below — so the firing
        alert reaches the Prometheus exporter while the launcher's
        outer timeout is still minutes away. ``emit`` is a lock-free
        bounded put: a wedged run cannot wedge its own telemetry.
      * ``beacon_extra`` — optional callable whose dict folds into
        every beacon (live staging/HBM counters ride along; failures
        are swallowed — the beacon is best-effort by contract).
    """

    def __init__(self, out_dir: str, *, stall_timeout_s: float = 300.0,
                 process_index: int = 0, metrics: Any = None,
                 extra_state: Optional[Callable[[], Dict]] = None,
                 tracer: Any = None, last_n_metrics: int = 50,
                 last_n_spans: int = 64,
                 stall_hook: Optional[Callable[[], Any]] = None,
                 emitter: Any = None,
                 beacon_extra: Optional[Callable[[], Dict]] = None,
                 requeue_attempt: int = 0):
        if stall_timeout_s < 0:
            raise ValueError(
                f"stall_timeout_s must be >= 0, got {stall_timeout_s}")
        self.out_dir = out_dir
        self.stall_timeout_s = float(stall_timeout_s)
        self.process_index = process_index
        self.metrics = metrics
        self.extra_state = extra_state
        self.tracer = tracer
        self.stall_hook = stall_hook
        self.emitter = emitter
        self.beacon_extra = beacon_extra
        self.last_n_metrics = last_n_metrics
        self.last_n_spans = last_n_spans
        self.requeue_attempt = int(requeue_attempt)
        self.beacon_path = os.path.join(
            out_dir, f"heartbeat.worker{process_index}")
        self.flightrec_path = os.path.join(
            out_dir, f"flightrec.worker{process_index}")
        self.dumps = 0          # flight records written (tests read this)
        self.beacons = 0        # beacon writes (tests read this)
        # beacon namespacing across requeue attempts: an earlier
        # attempt's beacon left in a shared obs dir must never read as
        # THIS attempt's progress (the goodput ledger and the launcher's
        # vanished-worker inference both key off beacons per attempt) —
        # archive it under its own attempt suffix before the first
        # write. The dead attempt's progress counters survive under
        # heartbeat.worker<i>.attempt<K>, where the cross-attempt
        # ledger finds them.
        self._archive_stale_beacon()
        # progress is replaced wholesale (never mutated) so the watchdog
        # thread always reads a consistent snapshot without a lock
        self._progress: Dict[str, Any] = {
            "phase": "init", "step": -1, "epoch": -1, "ts": time.time(),
            "process_index": process_index, "pid": os.getpid(),
            "requeue_attempt": self.requeue_attempt}
        self._count = 0
        self._stop = threading.Event()
        period = _MAX_PERIOD_S
        if self.stall_timeout_s > 0:
            period = min(_MAX_PERIOD_S,
                         max(_MIN_PERIOD_S, self.stall_timeout_s / 4.0))
        self._period_s = period
        self._thread = threading.Thread(
            target=self._loop, name="tpudist-flightrec", daemon=True)
        self._thread.start()

    def _archive_stale_beacon(self) -> None:
        """Move a previous attempt's beacon aside (best-effort): the
        payload names its own attempt, so the archive keeps the attempt
        the data belongs to — NOT the one that found it."""
        try:
            with open(self.beacon_path) as f:
                payload = json.load(f)
        except (OSError, ValueError):
            return     # absent or torn: this attempt's writes overwrite
        stale = payload.get("requeue_attempt")
        stale = int(stale) if isinstance(stale, (int, float)) else 0
        if stale == self.requeue_attempt:
            return     # same attempt restarted in place: just overwrite
        try:
            os.replace(self.beacon_path,
                       f"{self.beacon_path}.attempt{stale}")
        except OSError:
            try:
                os.remove(self.beacon_path)
            except OSError:
                pass   # unremovable beats unreadable: first write wins

    # ------------------------------------------------------- hot path
    def note_progress(self, **kv: Any) -> None:
        """Record step progress. Called from the train loop's hot path:
        two attribute assignments, no I/O, no locks, no device work."""
        kv["ts"] = time.time()
        self._progress = {**self._progress, **kv}
        self._count += 1

    @property
    def progress(self) -> Dict[str, Any]:
        return self._progress

    def beacon_now(self) -> None:
        """Write one beacon synchronously, off the watchdog cadence.
        The scripted preemption (train._maybe_test_kill) calls this
        before ``os._exit``: at production step rates the periodic
        beacon is at most a step or two stale when a reaper lands, but
        a CPU drill runs its whole epoch inside one beacon period —
        this stamp reproduces the realistic ~fresh beacon a real kill
        leaves, so the lost-step accounting stays deterministic."""
        self._write_beacon()

    # ------------------------------------------------- watchdog thread
    def _loop(self) -> None:
        last_count = self._count
        last_change = time.monotonic()
        dumped_this_stall = False
        while not self._stop.wait(self._period_s):
            self._write_beacon()
            now = time.monotonic()
            if self._count != last_count:
                last_count = self._count
                last_change = now
                dumped_this_stall = False   # progress resumed; re-arm
                continue
            if (self.stall_timeout_s > 0 and not dumped_this_stall
                    and now - last_change >= self.stall_timeout_s):
                self.dump(reason="stall",
                          stall_s=round(now - last_change, 3))
                dumped_this_stall = True

    def _write_beacon(self) -> None:
        # progress_n is the note_progress call counter — the SAME
        # signal this watchdog's own stall detection keys off (any
        # progress re-arms it: phase flips during long eval/ckpt
        # included, not just step advances), shipped so the live
        # aggregator's stall-age accounting agrees with the watchdog
        payload = {**self._progress, "beacon_ts": time.time(),
                   "progress_n": self._count}
        if self.beacon_extra is not None:
            try:
                payload.update(self.beacon_extra())
            except Exception:
                pass   # extras are a bonus; the beacon core still beats
        try:
            os.makedirs(self.out_dir, exist_ok=True)
            tmp = f"{self.beacon_path}.tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, self.beacon_path)
            self.beacons += 1
        except Exception:
            # the beacon is best-effort; a full disk must not kill the
            # watchdog (the flight record is the part that matters)
            pass
        if self.emitter is not None:
            # the live bus's per-host liveness signal: the aggregator's
            # progress-age accounting (and so the on-line stall alert)
            # keys off these, so they flow even when the FILE write
            # above failed — a full disk must not blind the exporter
            self.emitter.emit({"kind": "heartbeat", **payload})

    # ----------------------------------------------------------- dump
    def dump(self, reason: str = "manual",
             stall_s: Optional[float] = None) -> str:
        """Write the flight record now (the watchdog calls this on
        stall; the launcher-facing contract is the artifact's existence,
        so it is also callable directly for drills/tests)."""
        if self.emitter is not None:
            # FIRST, before the slow stack/memory collection below: the
            # measured stall rides to the aggregator so the stall alert
            # is firing — on disk in live_status.json and scrapeable at
            # /metrics — before the launcher's kill, not after
            self.emitter.emit({"kind": "stall_dump", "reason": reason,
                               "stall_s": stall_s, **self._progress})
        history = []
        if self.metrics is not None:
            # the stall dump also lands in the metrics stream itself:
            # the offline report's Alerts cross-check reads
            # metrics.jsonl
            try:
                self.metrics.log(kind="stall_dump", reason=reason,
                                 stall_s=stall_s,
                                 **{k: self._progress.get(k)
                                    for k in ("phase", "step", "epoch",
                                              "process_index")})
            except Exception:
                pass
            try:
                history = list(self.metrics.history)[-self.last_n_metrics:]
            except Exception:
                pass
        extra = None
        if self.extra_state is not None:
            try:
                extra = self.extra_state()
            except Exception:
                extra = None
        if self.stall_hook is not None:
            # e.g. close an open device-profiler window: fired before
            # the write so the record can say what became of it
            try:
                capture = self.stall_hook()
            except Exception:
                capture = None
            if isinstance(capture, dict):
                extra = {**(extra or {}), **capture}
            elif capture:
                extra = {**(extra or {}), "profile_capture": capture}
        spans = None
        if self.tracer is not None and getattr(self.tracer, "enabled",
                                               False):
            # the span-buffer tail: WHAT PHASE each thread was in when
            # the run hung (the open-span stack is the live answer) —
            # and the full local timeline as a Chrome trace next to the
            # flight record, since a wedged pod never reaches the
            # run-end merged export (its collectives would hang too)
            try:
                spans = self.tracer.tail(per_thread=self.last_n_spans)
            except Exception:
                spans = None
            try:
                from tpudist_torch.obs import trace as trace_mod
                self.tracer.export_local(
                    os.path.join(self.out_dir, trace_mod.worker_trace_name(
                        self.process_index)),
                    process_index=self.process_index)
            except Exception:
                pass
        path = flightrec.dump_flight_record(
            self.flightrec_path, reason=reason, progress=self._progress,
            stall_s=stall_s, last_metrics=history, spans=spans,
            extra=extra)
        if self.metrics is not None:
            # the buffered JSONL stream would otherwise die with the run
            # — these are the records that matter most. Flushed before
            # the dumps counter ticks: the counter is the "dump
            # complete" signal watchers key off.
            try:
                self.metrics.flush()
            except Exception:
                pass
        self.dumps += 1
        return path

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._write_beacon()   # final beacon: phase as of shutdown
