"""On-line alert engine: the at-exit gates, evaluated mid-run. A copy
of ``tpudist/obs/alerts.py`` over the port's :mod:`tpudist_torch.rules`
(``tests/test_torch_obs.py`` holds it to its source).

A gate the run grades at exit is a number the run already produces
while it runs; this engine watches those numbers and turns threshold
breaches into **alerts** with a fire/resolve lifecycle. The thresholds
come from the same rules table the exit graders read, so on-line and
at-exit grading cannot drift. The serving scheduler feeds it the SLO
observables (``ttft``, ``itl``, ``serve_shed``, ``tokens_per_chip``)
and reports its transition count as the summary's ``alert_events``.

Standard library only, and clock-injectable: a fake clock makes
durations deterministic in tests.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from tpudist_torch import rules as rules_lib

SUCCESS = "success"   # the verdict vocabulary
FAIL = "fail"

FIRING = "firing"
RESOLVED = "resolved"


class AlertEngine:
    """Threshold-breach tracker over the live observation stream.

    ``observe(rule, value)`` evaluates one observation against the
    rule's CURRENT threshold (env read at call time —
    :func:`tpudist_torch.rules.resolve`) and manages the alert keyed by
    ``(rule, host)``: a clear→breach transition FIRES it, breach→clear
    RESOLVES it, repeated breaches update its value/duration. Each
    transition produces a ``kind=alert`` record (returned, appended to
    ``history``, and passed to ``on_event`` — the aggregator fans it
    into ``alerts.jsonl``, the metrics stream and ``live_status.json``).

    ``host=None`` is a pod-level alert (straggler ratio, regression);
    per-host rules (stall, staging) pass the host index so one wedged
    worker cannot mask another's recovery.
    """

    def __init__(self, *, on_event: Optional[Callable[[Dict], None]] = None,
                 clock: Callable[[], float] = time.time):
        self.on_event = on_event
        self.clock = clock
        self.active: Dict[Tuple[str, Optional[int]], Dict[str, Any]] = {}
        self.history: List[Dict[str, Any]] = []
        self.events = 0

    def observe(self, rule: str, value: Optional[float], *,
                host: Optional[int] = None, step: Optional[int] = None,
                ts: Optional[float] = None, detail: Optional[str] = None,
                threshold: Optional[float] = None
                ) -> Optional[Dict[str, Any]]:
        """Feed one observation; returns the transition record when the
        alert fired or resolved, else None. ``value=None`` never fires
        (no measurement is ungateable, not bad) and never resolves (a
        gap in the signal is not evidence of recovery). ``threshold``
        overrides the rules-table resolution for callers holding a
        per-run value (the aggregator's stall window comes from the
        ``--stall-timeout-s`` FLAG, which the env-only resolve cannot
        see)."""
        if value is None:
            return None
        if threshold is None:
            threshold = rules_lib.resolve(rule)
        breach = rules_lib.breached(rule, value, threshold)
        now = self.clock() if ts is None else ts
        key = (rule, host)
        alert = self.active.get(key)
        if breach and alert is None:
            alert = {
                "kind": "alert", "alert": rule, "state": FIRING,
                "host": host, "value": value, "threshold": threshold,
                "sense": rules_lib.get(rule).sense,
                "first_ts": now, "first_step": step, "last_ts": now,
                "last_step": step, "duration_s": 0.0, "detail": detail,
            }
            self.active[key] = alert
            self.history.append(alert)
            return self._event(alert)
        if breach:
            alert["value"] = value
            alert["last_ts"] = now
            alert["last_step"] = step if step is not None else alert[
                "last_step"]
            alert["duration_s"] = max(0.0, now - alert["first_ts"])
            return None
        if alert is not None:
            del self.active[key]
            alert["state"] = RESOLVED
            alert["last_ts"] = now
            alert["last_step"] = step if step is not None else alert[
                "last_step"]
            alert["duration_s"] = max(0.0, now - alert["first_ts"])
            return self._event(alert)
        return None

    def _event(self, alert: Dict[str, Any]) -> Dict[str, Any]:
        self.events += 1
        rec = dict(alert)
        if self.on_event is not None:
            try:
                self.on_event(rec)
            except Exception:
                pass   # alerting must never take down the aggregator
        return rec

    def firing(self) -> List[Dict[str, Any]]:
        """Currently-firing alerts (copies, stable order)."""
        return [dict(a) for a in self.active.values()]

    def snapshot(self) -> Dict[str, Any]:
        """The alert slice of ``live_status.json``: what fires now plus
        the full fire/resolve history with first-fire step/time and
        duration — the shape the report CLI's Alerts section ingests."""
        return {"firing": self.firing(),
                "history": [dict(a) for a in self.history],
                "events": self.events}
