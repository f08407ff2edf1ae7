"""The serve lane's pod-trace presentation: per-slot request tracks and
KV-pool occupancy counters.

The part of ``tpudist/serve/flight.py`` the port's serve CLI needs:
:func:`build_extra_events` turns the scheduler's lifecycle events into
the extra Chrome events the CLI appends to its worker trace before the
pod merge (``obs.trace.export_pod_trace(extra_events=)``). The flight
verifier itself stays in the JAX package's stdlib-only module, which
reads the port's run directory unchanged. The dense lane records no
``kv_pages`` instant, so its counter track is empty, as in the JAX
package's dense lane.
"""

from __future__ import annotations

from typing import Any, Dict, List

SERVE_CAT = "serve"             # lifecycle spans/instants, keyed by rid
COUNTER_CAT = "serve_counter"   # KV-pool occupancy samples

# Per-slot Perfetto tracks: slot i's copies land on tid BASE+i — far
# above the tracer's small per-thread tid enumeration, so the slot rows
# sort below the host threads and never collide with them.
SLOT_TID_BASE = 1000


# --------------------------------------------------- pod-trace presentation

def slot_track_events(events: List[Dict[str, Any]], *,
                      process_index: int = 0) -> List[Dict[str, Any]]:
    """Per-slot track copies of the serve lifecycle events.

    Every ``cat=serve`` event whose args carry a ``slot`` is duplicated
    onto tid ``SLOT_TID_BASE + slot`` (with a ``thread_name`` metadata
    row naming the track ``slot<i>``), so Perfetto shows one row per
    serving slot with that slot's admissions, prefills, decode
    emissions and terminals in arrival order. Copies are tagged
    ``args.track = "slot"`` so the ledger's span accounting can skip
    them (they are presentation, not new evidence)."""
    out: List[Dict[str, Any]] = []
    slots = set()
    for e in events:
        if e.get("cat") != SERVE_CAT:
            continue
        args = e.get("args") or {}
        slot = args.get("slot")
        if slot is None or args.get("track"):
            continue
        ev = dict(e)
        ev["pid"] = process_index
        ev["tid"] = SLOT_TID_BASE + int(slot)
        ev["args"] = dict(args, track="slot")
        out.append(ev)
        slots.add(int(slot))
    meta = [{"ph": "M", "name": "thread_name", "pid": process_index,
             "tid": SLOT_TID_BASE + s, "args": {"name": f"slot{s}"}}
            for s in sorted(slots)]
    return meta + out


def kv_counter_events(events: List[Dict[str, Any]], *,
                      process_index: int = 0) -> List[Dict[str, Any]]:
    """ph="C" Chrome counter events from the scheduler's ``kv_pages``
    occupancy samples (``cat=serve_counter`` instants, one per decode
    dispatch). Emitted as a stacked used/free pair (the stack height IS
    the pool size) plus a separate shared-prefix refcount series, on
    the same timestamps as the request spans."""
    out: List[Dict[str, Any]] = []
    for e in events:
        if e.get("cat") != COUNTER_CAT or e.get("name") != "kv_pages":
            continue
        a = e.get("args") or {}
        used = int(a.get("used") or 0)
        total = int(a.get("total") or 0)
        base = {"cat": COUNTER_CAT, "ph": "C", "ts": e.get("ts", 0.0),
                "pid": process_index, "tid": 0}
        out.append(dict(base, name="kv_pages",
                        args={"used": used,
                              "free": max(total - used, 0)}))
        out.append(dict(base, name="kv_shared_refs",
                        args={"refs": int(a.get("shared_refs") or 0)}))
    return out


def build_extra_events(events: List[Dict[str, Any]], *,
                       process_index: int = 0) -> List[Dict[str, Any]]:
    """Everything the serve CLI appends to its worker trace doc before
    the pod merge: per-slot request tracks + KV occupancy counters."""
    return (slot_track_events(events, process_index=process_index)
            + kv_counter_events(events, process_index=process_index))
