"""The goodput ledger: cross-attempt wall-clock accounting, copied from
``tpudist/obs/goodput.py`` (``tests/test_torch_policy.py`` and
``tests/test_torch_chaos_train.py`` hold each function to its source).

``attempts.jsonl`` holds one ``kind=attempt`` record an attempt, in the
shape the launcher's ``append_attempt`` shell function writes, so a
ledger the drills write and one a launcher writes are interchangeable.
:func:`attempt_record` is the attempt-local estimate the train loop logs
at run end (``kind=goodput``); :func:`build_from_dir` partitions a run
directory's whole wall clock, across all its requeue attempts, into the
buckets (productive, compile, rewarmup, staging_exposed, ckpt, eval,
lost, startup, off_pod, residue) from ``attempts.jsonl``, every
``metrics.jsonl`` and the heartbeat beacons: the ledger the chaos
verifier (:mod:`tpudist_torch.chaos.verify`) reads. The JAX package's
jax-free goodput CLI (``python -m tpudist.obs.goodput``) folds a port
run's directory unchanged. Standard library only.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

from tpudist_torch import rules as rules_lib

GOODPUT_SCHEMA_VERSION = 1
ATTEMPTS_NAME = "attempts.jsonl"
LEDGER_NAME = "goodput.json"

# Partition exactness: the pinned tolerance (fraction of the wall being
# partitioned) past which the ledger flags itself inexact — the same
# ±1% discipline the devtime decomposition pins (compute + exposed_comm
# + idle == window).
TOLERANCE = 0.01

SUCCESS = "success"     # the verdict vocabulary, without the import
FAIL = "fail"
UNGATEABLE = "ungateable"

# The goodput floor lives in tpudist_torch.rules with every other gate
# (TPUDIST_GOODPUT_MIN, resolved at call time).
GOODPUT_MIN = rules_lib.GOODPUT_MIN

# Cross-attempt bucket names, display order. Per-attempt rows carry all
# but ``off_pod`` (time between attempts belongs to no attempt).
BUCKETS = ("productive", "compile", "rewarmup", "staging_exposed",
           "ckpt", "eval", "lost", "startup", "off_pod", "residue")
ATTEMPT_BUCKETS = tuple(b for b in BUCKETS if b != "off_pod")


def goodput_status(fraction: Optional[float],
                   min_fraction: Optional[float] = None) -> str:
    """Three-valued goodput verdict: UNGATEABLE with nothing measured
    (an empty ledger must not read as a goodput pass), else
    SUCCESS/FAIL by whether the productive fraction clears
    ``TPUDIST_GOODPUT_MIN``. Advisory, like the comm/staging gates — a
    run that completed with bad goodput is a capacity-efficiency
    finding, not a correctness failure."""
    if fraction is None:
        return UNGATEABLE
    if min_fraction is None:
        min_fraction = rules_lib.resolve("goodput")
    return SUCCESS if fraction >= min_fraction else FAIL


# ------------------------------------------------------------- ingestion


# ------------------------------------------------------------- ingestion


def load_jsonl(path: str) -> List[Dict[str, Any]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue    # a torn tail line is not evidence
            if isinstance(rec, dict):
                out.append(rec)
    return out


def load_attempts(path: str) -> List[Dict[str, Any]]:
    """The launcher's per-invocation records, sorted by attempt index.
    Only parseable records with both timestamps count — the ledger's
    spine must be well-formed or absent, never guessed."""
    recs = [r for r in load_jsonl(path)
            if isinstance(r.get("start_ts"), (int, float))
            and isinstance(r.get("end_ts"), (int, float))]
    return sorted(recs, key=lambda r: int(r.get("attempt", 0)))


def find_metrics(run_dir: str) -> List[str]:
    """Every metrics.jsonl under the run directory: the top-level one
    (records self-identify by ``requeue_attempt``, so one appended file
    holds every attempt) plus per-attempt collection subdirs
    (``attempt<N>/metrics.jsonl``, the launcher's failure-path
    layout)."""
    paths = set(glob.glob(os.path.join(run_dir, "metrics.jsonl")))
    paths |= set(glob.glob(os.path.join(run_dir, "*", "metrics.jsonl")))
    return sorted(paths)


def find_beacons(run_dir: str) -> Dict[int, Dict[int, Dict[str, Any]]]:
    """``{attempt: {worker: beacon payload}}`` from every heartbeat
    file under the run dir (recursively — collection may nest
    per-attempt subdirs). The attempt comes from the payload's own
    ``requeue_attempt`` stamp (the archived ``.attempt<K>`` filename
    suffix is a fallback for beacons too old to carry it); duplicate
    (attempt, worker) pairs keep the furthest-progressed payload."""
    out: Dict[int, Dict[int, Dict[str, Any]]] = {}
    pattern = os.path.join(run_dir, "**", "heartbeat.worker*")
    for path in sorted(set(glob.glob(pattern, recursive=True))):
        tail = os.path.basename(path).rsplit(".worker", 1)[-1]
        suffix_attempt = None
        if "." in tail:
            tail, _, suffix = tail.partition(".")
            if suffix.startswith("attempt") and suffix[7:].isdigit():
                suffix_attempt = int(suffix[7:])
            else:
                continue        # .tmp or foreign suffix: not a beacon
        if not tail.isdigit():
            continue
        worker = int(tail)
        try:
            with open(path) as f:
                payload = json.load(f)
        except (OSError, ValueError):
            continue
        att = payload.get("requeue_attempt")
        att = int(att) if isinstance(att, (int, float)) else suffix_attempt
        if att is None:
            att = 0
        cur = out.setdefault(att, {}).get(worker)
        if cur is None or _progress_key(payload) > _progress_key(cur):
            out[att][worker] = payload
    return out


def _progress_key(payload: Dict[str, Any]) -> Tuple[int, int]:
    """Beacon ordering: (epoch, step_in_epoch) LEXICOGRAPHIC — a stale
    epoch-0/step-7 beacon must never beat a fresher epoch-1/step-2 one
    (step resets every epoch)."""
    epoch = payload.get("epoch")
    step = payload.get("step")
    return (int(epoch) if isinstance(epoch, (int, float)) else -1,
            int(step) if isinstance(step, (int, float)) else -1)


# ------------------------------------------------- per-attempt buckets


def _kind(recs: List[Dict[str, Any]], kind: str) -> List[Dict[str, Any]]:
    return [r for r in recs if r.get("kind") == kind]


def _ckpt_seconds(recs: List[Dict[str, Any]]) -> float:
    """Checkpoint cost: per-save enqueue (what the step path paid,
    ``kind=ckpt``) plus the run-total drain stall (``kind=ckpt_drain``
    — the honest enqueue/drain split from the checkpointing work)."""
    s = sum(float(r.get("enqueue_ms") or 0.0) for r in _kind(recs, "ckpt"))
    drains = _kind(recs, "ckpt_drain")
    if drains:
        s += float(drains[-1].get("drain_ms") or 0.0)
    return s / 1e3


def _eval_seconds(recs: List[Dict[str, Any]]) -> float:
    return sum(float(r.get("eval_s") or 0.0) for r in _kind(recs, "epoch"))


def attempt_record(history: Sequence[Dict[str, Any]], *,
                   wall_s: float, requeue_attempt: int = 0
                   ) -> Optional[Dict[str, Any]]:
    """The ATTEMPT-local goodput estimate the train loop logs at run
    end (``kind=goodput``): the same bucket math the cross-attempt
    ledger applies to a completed attempt, over this process's own
    record history and wall clock. The live aggregator observes its
    ``fraction`` against the goodput rule, so a badput-heavy run alerts
    mid-fleet — the offline ledger then refines it with startup/off-pod
    time only the launcher can see. None when nothing was measured."""
    timings = [r for r in history if r.get("kind") == "timing"]
    if not timings or wall_s <= 0:
        return None
    t = timings[-1]
    warm = float(t.get("compile_warmup_s") or 0.0)
    wait = float(t.get("stage_wait_s") or 0.0)
    productive = max(0.0, float(t.get("run_s") or 0.0) - wait)
    buckets = {
        ("compile" if requeue_attempt == 0 else "rewarmup"): warm,
        "staging_exposed": wait,
        "productive": productive,
        "ckpt": _ckpt_seconds(list(history)),
        "eval": _eval_seconds(list(history)),
    }
    frac = round(productive / wall_s, 6)
    return {"fraction": frac, "status": goodput_status(frac),
            "wall_s": round(wall_s, 6),
            "requeue_attempt": requeue_attempt,
            **{f"{k}_s": round(v, 6) for k, v in buckets.items()}}


def _completed_into(buckets: Dict[str, float], recs, timing,
                    first_attempt: bool) -> Dict[str, Any]:
    warm = float(timing.get("compile_warmup_s") or 0.0)
    buckets["compile" if first_attempt else "rewarmup"] += warm
    wait = float(timing.get("stage_wait_s") or 0.0)
    buckets["staging_exposed"] += wait
    run_s = float(timing.get("run_s") or 0.0)
    buckets["productive"] += max(0.0, run_s - wait)
    steps = timing.get("steps")
    sps = (steps / run_s) if steps and run_s > 0 else None
    return {"steps_done": steps, "lost_steps": 0,
            "steps_per_sec": round(sps, 4) if sps else None}


def _beacon_progress(beacons: Optional[Dict[int, Dict[str, Any]]]
                     ) -> Tuple[Optional[int], Optional[int]]:
    """(step_in_epoch, epoch) of the furthest-progressed worker beacon
    for one attempt — how far the attempt REALLY got before dying.
    Ordered by (epoch, step): step resets per epoch, so a straggler's
    epoch-0/step-7 beacon must not outrank a peer's epoch-1/step-2."""
    best = None
    for payload in (beacons or {}).values():
        step = payload.get("step")
        if not isinstance(step, (int, float)) or step < 0:
            continue
        if best is None or _progress_key(payload) > _progress_key(best):
            best = payload
    if best is None:
        return None, None
    return int(best["step"]), best.get("epoch")


def _dead_into(buckets: Dict[str, float], recs, *, first_ts,
               next_resume, beacons, first_attempt: bool,
               wall: float = float("inf")) -> Dict[str, Any]:
    """Bucket a KILLED attempt from what survived: flushed step/ckpt
    records give the rate and committed progress, the final beacon the
    true progress, the resuming attempt's record what was kept.
    Unmeasurable remainder (the kill's whole point) stays residue."""
    steps = _kind(recs, "step")
    ckpts = _kind(recs, "ckpt")
    resumes = [r for r in _kind(recs, "resume")
               if r.get("status") == SUCCESS]
    sps = None
    for r in reversed(steps):
        v = r.get("steps_per_sec")
        if isinstance(v, (int, float)) and v > 0:
            sps = float(v)
            break
    g0 = int(resumes[-1].get("resumed_from_step") or 0) if resumes else 0
    b_step, b_epoch = _beacon_progress(beacons)
    # final global step: the last flushed record's global step, extended
    # by the beacon's in-epoch progress when both sit in the same epoch
    g1 = None
    if ckpts:
        base = ckpts[-1]
        g1 = int(base.get("step") or 0)
        if b_step is not None and b_epoch == base.get("epoch"):
            g1 += max(0, b_step - int(base.get("step_in_epoch") or 0))
    elif steps:
        g1 = int(steps[-1].get("step") or 0)
        if b_step is not None and b_epoch == 0 and g0 == 0:
            g1 = max(g1, b_step)    # fresh epoch-0 run: global == in-epoch
    elif b_step is not None and b_epoch == 0 and g0 == 0:
        g1 = b_step
    steps_done = max(0, g1 - g0) if g1 is not None else None

    # lost steps: the resuming attempt's own accounting first (it read
    # the SAME beacon at restore time), the beacon-vs-resume-point diff
    # as the independent cross-check the acceptance drill pins
    lost_beacon = None
    if next_resume is not None and b_step is not None \
            and next_resume.get("epoch") == b_epoch:
        lost_beacon = max(0, b_step - int(
            next_resume.get("step_in_epoch") or 0))
    if next_resume is not None and next_resume.get("status") == SUCCESS:
        lost = next_resume.get("steps_lost")
        lost = int(lost) if isinstance(lost, (int, float)) else lost_beacon
    else:
        # no successful restore: EVERYTHING this attempt computed was
        # thrown away (a fresh start redoes it all)
        lost = steps_done
    lost = int(lost or 0)
    if steps_done is not None:
        lost = min(lost, steps_done)
    if sps:
        buckets["lost"] += lost / sps
        kept = max(0, (steps_done if steps_done is not None else lost)
                   - lost)
        buckets["productive"] += kept / sps
        if steps and first_ts is not None:
            # compile estimate: the gap from the first metrics record to
            # the first logged step, minus the step time that interval
            # covered — the trace+compile cost a dead attempt's missing
            # timing record never reported
            t1 = steps[0].get("ts")
            n1 = max(0, int(steps[0].get("step") or 0) - g0)
            if isinstance(t1, (int, float)):
                est = (float(t1) - first_ts) - n1 / sps
                # the estimate is a timestamp inference, and inferring
                # MORE than the attempt's unaccounted wall is by
                # definition overcounting — clamp to the remaining
                # headroom, so estimator noise on a dead attempt cannot
                # flag the partition inexact (measured buckets keep
                # their own double-counting check)
                est = min(max(0.0, est),
                          max(0.0, wall - sum(buckets.values())))
                buckets["compile" if first_attempt
                        else "rewarmup"] += est
    return {"steps_done": steps_done, "lost_steps": lost,
            "lost_steps_beacon": lost_beacon,
            "beacon_step": b_step,
            "steps_per_sec": round(sps, 4) if sps else None}


# ------------------------------------------------------------ the ledger


def build_ledger(attempts: List[Dict[str, Any]],
                 records: List[Dict[str, Any]], *,
                 beacons: Optional[Dict[int, Dict[int, Dict]]] = None,
                 tolerance: float = TOLERANCE,
                 run_id: Optional[str] = None) -> Dict[str, Any]:
    """Partition the run's total wall-clock (first attempt start →
    last attempt end, from ``attempts.jsonl``) into the goodput
    buckets. The sum of all buckets equals the total EXACTLY by
    construction (residue is the remainder); ``exact`` certifies the
    measured buckets never exceeded any attempt's wall (no double
    counting) and the attempt stamps never overlapped, within the
    pinned tolerance."""
    attempts = [dict(a) for a in attempts]
    if not attempts:
        raise ValueError("no attempt records — attempts.jsonl is the "
                         "ledger's spine (the launcher and the drill "
                         "both write it)")
    if run_id is None:
        # the NEWEST stamped launch is the run being accounted: a retry
        # from the same artifacts dir appends a fresh run_id, and stale
        # runs' evidence must not fold into this ledger
        run_id = next((a.get("run_id") for a in reversed(attempts)
                       if a.get("run_id")), None) \
            or next((r.get("run_id") for r in reversed(records)
                     if r.get("run_id")), None)

    def _ours(rec: Dict[str, Any]) -> bool:
        # unstamped evidence stays (scripted/old artifacts); a DIFFERENT
        # run_id is another launch's leftovers
        rid = rec.get("run_id")
        return run_id is None or not rid or rid == run_id

    attempts = sorted((a for a in attempts if _ours(a)),
                      key=lambda a: int(a.get("attempt", 0)))
    if not attempts:
        raise ValueError(f"no attempt records for run_id {run_id!r}")
    beacons = {att: {w: p for w, p in workers.items() if _ours(p)}
               for att, workers in (beacons or {}).items()}
    by_att: Dict[int, List[Dict[str, Any]]] = {}
    for r in records:
        if not _ours(r):
            continue
        a = r.get("requeue_attempt")
        by_att.setdefault(int(a) if isinstance(a, (int, float)) else 0,
                          []).append(r)
    for recs in by_att.values():
        recs.sort(key=lambda r: r.get("ts") or 0)

    t0 = float(attempts[0]["start_ts"])
    t1 = float(attempts[-1]["end_ts"])
    total_wall = max(0.0, t1 - t0)
    scale = max(total_wall, 1e-9)
    totals = {k: 0.0 for k in BUCKETS}
    rows: List[Dict[str, Any]] = []
    exact = True
    problems: List[str] = []
    prev_end: Optional[float] = None

    for i, a in enumerate(attempts):
        att = int(a.get("attempt", i))
        start, end = float(a["start_ts"]), float(a["end_ts"])
        wall = max(0.0, end - start)
        if prev_end is not None:
            gap = start - prev_end
            if gap < -tolerance * scale:
                exact = False
                problems.append(f"attempt {att} overlaps the previous "
                                f"attempt by {-gap:.3f}s")
            totals["off_pod"] += max(0.0, gap)
        prev_end = end

        recs = by_att.get(att, [])
        buckets = {k: 0.0 for k in ATTEMPT_BUCKETS}
        first_ts = None
        ts_vals = [float(r["ts"]) for r in recs
                   if isinstance(r.get("ts"), (int, float))]
        if ts_vals:
            first_ts = min(ts_vals)
            buckets["startup"] = min(max(0.0, first_ts - start), wall)
        timings = _kind(recs, "timing")
        next_resumes = [r for r in by_att.get(att + 1, [])
                        if r.get("kind") == "resume"]
        # measured ckpt/eval land FIRST so the dead-attempt estimator
        # sees the true remaining headroom when it clamps
        buckets["ckpt"] += _ckpt_seconds(recs)
        buckets["eval"] += _eval_seconds(recs)
        info: Dict[str, Any] = {}
        if timings:
            info = _completed_into(buckets, recs, timings[-1],
                                   first_attempt=(i == 0))
        else:
            info = _dead_into(
                buckets, recs, first_ts=first_ts,
                next_resume=next_resumes[-1] if next_resumes else None,
                beacons=beacons.get(att), first_attempt=(i == 0),
                wall=wall)
        measured = sum(v for k, v in buckets.items() if k != "residue")
        buckets["residue"] = wall - measured
        if buckets["residue"] < -tolerance * max(wall, 1e-9):
            exact = False
            problems.append(
                f"attempt {att}: measured buckets exceed its "
                f"{wall:.3f}s wall by {-buckets['residue']:.3f}s — "
                f"double counting")
        for k, v in buckets.items():
            totals[k] += v
        rows.append({
            "attempt": att, "start_ts": start, "end_ts": end,
            "wall_s": round(wall, 6), "rc": a.get("rc"),
            "verdict": a.get("verdict"), "records": len(recs),
            "buckets": {k: round(v, 6) for k, v in buckets.items()},
            **info})

    drift = abs(sum(totals.values()) - total_wall)
    if drift > tolerance * scale:
        exact = False
        problems.append(f"bucket sum drifts {drift:.3f}s from the "
                        f"{total_wall:.3f}s total wall")
    lost_steps = sum(int(r.get("lost_steps") or 0) for r in rows)
    frac = (round(totals["productive"] / total_wall, 6)
            if total_wall > 0 else None)
    return {
        "schema": GOODPUT_SCHEMA_VERSION,
        "run_id": run_id,
        "attempts": rows,
        "totals": {k: round(v, 6) for k, v in totals.items()},
        "total_wall_s": round(total_wall, 6),
        "goodput_fraction": frac,
        "goodput_status": goodput_status(frac),
        "goodput_min": rules_lib.resolve("goodput"),
        "lost_steps": lost_steps,
        "exact": exact,
        "tolerance": tolerance,
        "problems": problems,
    }


def build_from_dir(run_dir: str, *,
                   attempts_path: Optional[str] = None,
                   tolerance: float = TOLERANCE
                   ) -> Optional[Dict[str, Any]]:
    """Discover a run directory's artifacts (attempts.jsonl, every
    metrics.jsonl, all beacon generations) and build the ledger; None
    when there is no attempts.jsonl to anchor wall-clock to."""
    path = attempts_path or os.path.join(run_dir, ATTEMPTS_NAME)
    if not os.path.exists(path):
        return None
    attempts = load_attempts(path)
    if not attempts:
        return None
    records: List[Dict[str, Any]] = []
    for mp in find_metrics(run_dir):
        records.extend(load_jsonl(mp))
    return build_ledger(attempts, records, beacons=find_beacons(run_dir),
                        tolerance=tolerance)


def append_attempt(path: str, *, attempt: int, start_ts: float,
                   end_ts: float, rc: int, verdict: str,
                   run_id: Optional[str] = None,
                   mode: str = "train") -> None:
    """One attempts.jsonl record — the same shape launch_tpu.sh's
    ``append_attempt`` shell function writes, so drill- and
    launcher-produced ledgers are interchangeable."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    rec = {"kind": "attempt", "run_id": run_id, "mode": mode,
           "attempt": int(attempt), "start_ts": start_ts,
           "end_ts": end_ts, "rc": int(rc), "verdict": verdict}
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")
