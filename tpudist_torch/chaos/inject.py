"""ChaosRuntime: fires a parsed fault schedule into a live run.

A port of ``tpudist/chaos/inject.py``, with its three injection surfaces:

  * the **step boundary** (``on_step``) — the train loop calls it where
    it checks ``TPUDIST_TEST_KILL``; ``kill``, ``hang``, ``slow`` and
    ``telemetry_garbage`` fire here (the train CLI has no live bus yet,
    ROADMAP Queue A item 11b, so ``telemetry_garbage`` records its event
    and has no emitter to feed);
  * the **checkpoint write path** (``ckpt_fault``) — installed as
    :mod:`tpudist_torch.elastic.ckpt`'s module-level fault hook;
    ``corrupt_shard``, ``torn_manifest`` and ``fs_error`` fire inside
    ``ShardedCheckpointer._write`` at named points;
  * the **serve dispatch boundary** (``on_serve_dispatch``) — the
    serving scheduler calls it before every decode dispatch;
    ``serve_kill`` dies there (a captured program is never torn
    mid-replay) and ``serve_slow`` stalls the dispatch, returning the
    injected seconds so a virtual-clock run can account them; the serve
    CLI folds ``request_garbage`` into the arrival stream once
    (``consume_request_garbage``).

Every fired event is logged as a flushed ``kind=chaos`` metrics record
BEFORE its effect lands (a kill must not eat its own evidence), and a
scripted death stamps the observer's beacon, when there is one, before
``os._exit``: no ``finally`` blocks, no verdict, no drain.

Standard library only: the runtime touches host-side state (files, a
sleep, ``os._exit``, the metrics logger) and nothing on the card.
"""

from __future__ import annotations

import errno as errno_mod
import os
import sys
import time
from typing import Any, Dict, Optional

from tpudist_torch.chaos import plan as plan_mod

# fs_error errno spellings accepted in specs
_ERRNOS = {"EIO": errno_mod.EIO, "ENOSPC": errno_mod.ENOSPC,
           "EDQUOT": getattr(errno_mod, "EDQUOT", errno_mod.ENOSPC)}

# hang: give up wedging after this long when no watchdog is armed — a
# chaos drill must never hold a card past the fault it scripts
HANG_MAX_S = 120.0


class ChaosRuntime:
    """Mutable firing state + the injection callbacks for one run."""

    def __init__(self, plan: plan_mod.ChaosPlan, *,
                 process_index: int = 0, observer: Any = None,
                 emitter: Any = None, metrics: Any = None):
        self.plan = plan
        self.process_index = int(process_index)
        self.observer = observer
        self.emitter = emitter
        self.metrics = metrics
        self.fired = 0
        # the schedule is immutable: snapshot the per-surface event
        # lists once, so the per-step hook really is two attribute
        # reads and a loop over a cached (usually tiny) tuple
        self._step_events = plan.step_events
        self._ckpt_events = plan.ckpt_events
        self._serve_events = plan.serve_events
        # per-event mutable state: {"done": bool, "count": int,
        # "bound": (epoch, step) for ckpt events, "remaining": int}
        self._state: Dict[int, Dict[str, Any]] = {
            e.index: {} for e in plan.events}
        self._installed = False
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

    # ---------------------------------------------------- step surface
    def on_step(self, epoch: int, step: int) -> None:
        """Called at every step boundary (next to the TEST_KILL check).
        No events → two attribute reads and out."""
        for ev in self._step_events:
            st = self._state[ev.index]
            if st.get("done"):
                continue
            if not ev.matches(epoch, step, self.process_index):
                continue
            if ev.kind == "slow":
                if not st.get("count"):
                    self._record(ev, at_step=step)
                st["count"] = st.get("count", 0) + 1
                self._sleep(float(ev.args.get("s", 0.05)))
                if st["count"] >= int(ev.args.get("steps", 1)):
                    st["done"] = True
                continue
            st["done"] = True
            if ev.kind == "telemetry_garbage":
                self._record(ev, at_step=step)
                if self.emitter is not None and hasattr(
                        self.emitter, "inject_garbage"):
                    self.emitter.inject_garbage(
                        plan_mod.garbage_bytes(self.plan, ev))
                continue
            if ev.kind == "kill":
                self._record(ev, at_step=step)
                self._die(ev, int(ev.args.get("rc", 113)))
                continue
            if ev.kind == "hang":
                self._record(ev, at_step=step)
                self._hang(ev)

    def _hang(self, event: plan_mod.FaultEvent) -> None:
        """Wedge without progress notes until the watchdog dumps its
        flight record (the evidence the requeue policy's stall
        classification reads), then die with ``timeout -k``'s SIGKILL
        code — the grace-window kill a real wedged pod run eats. After
        the dump a short settle lets the in-flight telemetry land (the
        ``kind=stall_dump`` frame → the live stall alert → disk): a
        real wedged run sits for the launcher's whole grace window, so
        the settle under-approximates reality, not the reverse."""
        max_s = float(event.args.get("max_s", HANG_MAX_S))
        deadline = time.monotonic() + max_s
        recorder = getattr(self.observer, "recorder", None)
        dumps0 = getattr(recorder, "dumps", None)
        while time.monotonic() < deadline:
            if dumps0 is not None and recorder.dumps > dumps0:
                break            # the stall dump landed; the kill comes
            self._sleep(0.05)
        settle = time.monotonic() + float(event.args.get("settle_s", 1.0))
        hard = time.monotonic() + 5.0    # settle extensions stay bounded
        while time.monotonic() < min(settle, hard):
            q = getattr(self.emitter, "_q", None)
            if q is not None and not q.empty():
                settle = time.monotonic() + 0.2   # frames still in flight
            self._sleep(0.05)
        self._die(event, int(event.args.get("rc", 137)))

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

    # ----------------------------------------------- checkpoint surface
    def ckpt_fault(self, point: str, *, step: int, epoch: int,
                   step_in_epoch: int, path: Optional[str] = None) -> None:
        """The :mod:`tpudist_torch.elastic.ckpt` write-path hook. Each event
        BINDS to the first save matching its trigger (later saves of
        the same run must not re-fire a consumed schedule entry)."""
        for ev in self._ckpt_events:
            st = self._state[ev.index]
            if st.get("done"):
                continue
            if ev.rank >= 0 and ev.rank != self.process_index:
                continue
            if epoch != ev.epoch or step_in_epoch < ev.step:
                continue
            bound = st.setdefault("bound", (epoch, step_in_epoch))
            if bound != (epoch, step_in_epoch):
                continue
            if ev.kind == "fs_error":
                if point != "shard_write":
                    continue
                remaining = st.setdefault(
                    "remaining", int(ev.args.get("n", 1)))
                if remaining <= 0:
                    st["done"] = True
                    continue
                st["remaining"] = remaining - 1
                if st["remaining"] <= 0:
                    st["done"] = True
                self._record(ev, point=point, at_save=step_in_epoch)
                eno = _ERRNOS.get(str(ev.args.get("errno", "EIO")),
                                  errno_mod.EIO)
                raise OSError(eno, f"chaos: injected transient fs error "
                                   f"({ev.describe()})")
            if ev.kind == "corrupt_shard" and point == "shard_written":
                st["done"] = True
                self._record(ev, point=point, at_save=step_in_epoch,
                             path=path)
                self._corrupt(ev, path)
                continue
            if ev.kind == "torn_manifest" and point == "index_written":
                st["done"] = True
                self._record(ev, point=point, at_save=step_in_epoch)
                self._die(ev, int(ev.args.get("rc", 113)))

    def _corrupt(self, event: plan_mod.FaultEvent,
                 path: Optional[str]) -> None:
        """Damage the landed shard file in place: seeded byte flips
        (crc-detectable wrong data) or truncation (unreadable zip)."""
        if not path or not os.path.exists(path):
            return
        mode = str(event.args.get("mode", "flip"))
        try:
            size = os.path.getsize(path)
            if mode == "truncate":
                with open(path, "r+b") as f:
                    f.truncate(max(size // 2, 1))
                return
            with open(path, "r+b") as f:
                for pos in plan_mod.corrupt_positions(
                        self.plan, event, size):
                    f.seek(pos)
                    b = f.read(1)
                    f.seek(pos)
                    f.write(bytes([b[0] ^ 0xFF]) if b else b"\xff")
        except OSError as e:
            print(f"tpudist: chaos corrupt_shard could not damage "
                  f"{path}: {e!r}", file=sys.stderr, flush=True)

    # -------------------------------------------------------- install
    def install(self) -> None:
        """Wire the checkpoint-path hook into elastic.ckpt (no-op when
        the plan schedules no checkpoint faults)."""
        if not self.plan.ckpt_events:
            return
        from tpudist_torch.elastic import ckpt as ckpt_mod
        self._hook = self.ckpt_fault     # ONE bound ref, for uninstall
        ckpt_mod.set_fault_hook(self._hook)
        self._installed = True

    def uninstall(self) -> None:
        if not self._installed:
            return
        from tpudist_torch.elastic import ckpt as ckpt_mod
        if ckpt_mod._FAULT_HOOK is self._hook:
            ckpt_mod.set_fault_hook(None)
        self._installed = False
