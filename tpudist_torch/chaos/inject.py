"""ChaosRuntime: fires a parsed fault schedule into a live serve run.

Counterpart of ``tpudist/chaos/inject.py`` with its serving surface
only (the step and checkpoint surfaces come with ROADMAP Queue A item
10, and the train CLI refuses ``--chaos`` until then):

  * the **serve dispatch boundary** (``on_serve_dispatch``) — the
    serving scheduler calls it before every decode dispatch;
    ``serve_kill`` dies there (a captured program is never torn
    mid-replay) and ``serve_slow`` stalls the dispatch, returning the
    injected seconds so a virtual-clock run can account them;
  * the **arrival stream** (``consume_request_garbage``) — the serve
    CLI folds the plan's ``request_garbage`` malformed requests into the
    schedule once; admission rejects them.

Every fired event is logged as a flushed ``kind=chaos`` metrics record
BEFORE its effect lands (a kill must not eat its own evidence), and a
scripted death stamps the observer's beacon, when there is one, before
``os._exit``: no ``finally`` blocks, no verdict, no drain.

Standard library only: the runtime touches host-side state (a sleep,
``os._exit``, the metrics logger) and nothing on the card.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict

from tpudist_torch.chaos import plan as plan_mod


class ChaosRuntime:
    """Mutable firing state + the serve injection callbacks for one run."""

    def __init__(self, plan: plan_mod.ChaosPlan, *,
                 process_index: int = 0, observer: Any = None,
                 metrics: Any = None):
        self.plan = plan
        self.process_index = int(process_index)
        self.observer = observer
        self.metrics = metrics
        self.fired = 0
        # the schedule is immutable: the serve events are snapshotted
        # once, so the per-dispatch hook is a loop over a cached tuple
        self._serve_events = plan.serve_events
        # per-event mutable state: {"done": bool, "count": int}
        self._state: Dict[int, Dict[str, Any]] = {
            e.index: {} for e in plan.events}
        # injectable for tests (an in-process test cannot os._exit)
        self._exit = os._exit
        self._sleep = time.sleep

    # ------------------------------------------------------- plumbing
    def _record(self, event: plan_mod.FaultEvent, **extra: Any) -> None:
        """One flushed kind=chaos record per fired event, the JAX
        runtime's line and fields."""
        self.fired += 1
        print(f"tpudist: chaos fired: {event.describe()} "
              f"(rank {self.process_index})", flush=True)
        if self.metrics is not None:
            try:
                self.metrics.log(kind="chaos", fault=event.kind,
                                 epoch=event.epoch, step=event.step,
                                 rank=self.process_index,
                                 spec=event.describe(), **extra)
                self.metrics.flush()
            except Exception:
                pass     # injection must not depend on the logger

    def _die(self, event: plan_mod.FaultEvent, rc: int) -> None:
        """The scripted un-orderly death: the beacon stamp (an atomic
        file write that survives the exit), then ``os._exit``."""
        if self.observer is not None:
            try:
                self.observer.beacon_now()
            except Exception:
                pass
        self._exit(rc)

    # ---------------------------------------------------- serve surface
    def on_serve_dispatch(self, dispatch: int) -> float:
        """Called by the serving scheduler before decode dispatch
        ``dispatch`` (0-based; the trigger's step coordinate, epoch
        fixed at 0). Returns the seconds of stall injected into THIS
        dispatch (``serve_slow``) so a virtual-clock run can account the
        delay; ``serve_kill`` never returns."""
        injected = 0.0
        for ev in self._serve_events:
            st = self._state[ev.index]
            if st.get("done"):
                continue
            if not ev.matches(0, dispatch, self.process_index):
                continue
            if ev.kind == "serve_slow":
                if not st.get("count"):
                    self._record(ev, at_dispatch=dispatch)
                st["count"] = st.get("count", 0) + 1
                s = float(ev.args.get("s", 0.05))
                self._sleep(s)
                injected += s
                if st["count"] >= int(ev.args.get("steps", 1)):
                    st["done"] = True
                continue
            if ev.kind == "serve_kill":
                st["done"] = True
                self._record(ev, at_dispatch=dispatch)
                # rc 137 by default: the preemption reaper's SIGKILL
                # code, which a requeue policy classifies from the exit
                # code alone
                self._die(ev, int(ev.args.get("rc", 137)))
            # request_garbage is not a dispatch-surface event: the CLI
            # consumed it when it built the arrival stream
        return injected

    def consume_request_garbage(self) -> list:
        """Mark every ``request_garbage`` event fired and return it: the
        serve CLI calls this ONCE while building the arrival stream (the
        fault's effect is the malformed requests themselves), so the
        flushed ``kind=chaos`` evidence lands before the first of them
        arrives."""
        out = []
        for ev in self._serve_events:
            if ev.kind != "request_garbage":
                continue
            st = self._state[ev.index]
            if st.get("done"):
                continue
            st["done"] = True
            self._record(ev, n=int(ev.args.get("n", 4)))
            out.append(ev)
        return out
