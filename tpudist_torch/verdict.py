"""Machine-readable job verdict: the acceptance-test signal.

Copy of the part of ``tpudist/verdict.py`` the serving and training
lanes use: the three-valued status vocabulary, the per-worker and final
verdict files, written atomically (a ``gs://`` path goes through
``gsutil``), the bounded AND-aggregation over processes, and the
advisory staging, straggler, tuning and trace verdicts of the
``kind=timing`` record.
"""

from __future__ import annotations

import os
import subprocess
import threading
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from tpudist_torch import rules as rules_lib
from tpudist_torch.metrics import _rank
from tpudist_torch.parallel import distributed

SUCCESS = "success"
FAIL = "fail"
UNGATEABLE = "ungateable"


def staging_status(streamed: bool, overlap_fraction,
                   min_overlap: Optional[float] = None) -> str:
    """Three-valued staging verdict for the run log + metrics stream:
    UNGATEABLE when the epoch took the full-staging fast path (no
    steady-state H2D to hide), else SUCCESS/FAIL by whether the measured
    overlap fraction clears the threshold ($TPUDIST_STAGING_OVERLAP_MIN,
    default ``rules.STAGING_OVERLAP_MIN``) — so a pod run failing to hide
    H2D is flagged in the artifact stream, not silently slow."""
    if min_overlap is None:
        min_overlap = rules_lib.resolve("staging")
    if not streamed or overlap_fraction is None:
        return UNGATEABLE
    return SUCCESS if overlap_fraction >= min_overlap else FAIL


def straggler_status(step_s_means, factor: Optional[float] = None) -> str:
    """Three-valued per-host straggler verdict (``obs.hoststats``):
    UNGATEABLE with fewer than two hosts reporting steady-state step
    times (a single-host run must not read as a straggler regression),
    else FAIL when any host's mean step time exceeds the pod median by
    the threshold factor ($TPUDIST_STRAGGLER_FACTOR, default
    ``rules.STRAGGLER_FACTOR``)."""
    import statistics
    if factor is None:
        factor = rules_lib.resolve("straggler")
    valid = [float(s) for s in step_s_means if s and s > 0]
    if len(valid) < 2:
        return UNGATEABLE
    median = statistics.median(valid)
    if median <= 0:
        return UNGATEABLE
    return FAIL if max(valid) > factor * median else SUCCESS


def trace_status(enabled: bool, spans: int, dropped: int,
                 exported: bool, drop_max: Optional[float] = None) -> str:
    """Three-valued span-tracing verdict (``obs.trace``) for the run log
    and the ``kind=timing`` record: UNGATEABLE with tracing off; SUCCESS
    when the run-end export wrote a trace and the ring buffers kept
    (most of) the timeline; FAIL when tracing was on but the export
    failed or overwrote more than the drop threshold
    ($TPUDIST_TRACE_DROP_MAX). Advisory, like the staging and straggler
    verdicts."""
    if not enabled:
        return UNGATEABLE
    if drop_max is None:
        drop_max = rules_lib.resolve("trace_drop")
    if not exported or spans <= 0:
        return FAIL
    total = spans + dropped
    if total > 0 and dropped / total > drop_max:
        return FAIL
    return SUCCESS


def resume_status(requested: bool, restored: bool,
                  error: bool = False) -> str:
    """Three-valued elastic-resume verdict (the JAX package's
    ``verdict.resume_status``): UNGATEABLE when no resume was requested
    or nothing existed to restore (a launcher's first attempt runs
    ``--resume auto`` against an empty save dir); SUCCESS when a
    committed checkpoint was restored; FAIL when a restore was attempted
    and errored (under ``--resume auto`` the run then starts fresh)."""
    if not requested:
        return UNGATEABLE
    if error:
        return FAIL
    return SUCCESS if restored else UNGATEABLE


def comm_status(exposed_frac, max_frac: Optional[float] = None,
                fabric: Optional[str] = None) -> str:
    """Three-valued exposed-communication verdict over a
    ``--profile-window`` capture (the JAX package's
    ``verdict.comm_status``): UNGATEABLE with no device window measured,
    else SUCCESS/FAIL by whether the exposed-comm fraction stays under
    the fabric's ceiling (``TPUDIST_COMM_EXPOSED_MAX``, or
    ``TPUDIST_COMM_EXPOSED_MAX_DCN`` for a ``dcn`` row). It lives in
    ``obs.devtime`` beside the interval math that produces the
    fraction; the train loop's verdicts stay in one place (a lazy
    import: devtime imports this module for the status words)."""
    from tpudist_torch.obs.devtime import comm_status as _impl
    return _impl(exposed_frac, max_frac, fabric=fabric)


def tuning_status(mode: str, *, source: str = "heuristic",
                  tuned_steps_per_sec: Optional[float] = None,
                  baseline_steps_per_sec: Optional[float] = None) -> str:
    """Three-valued autotune verdict for the run log + ``kind=timing``
    record: UNGATEABLE when tuning was off (nothing measured, nothing to
    certify) or a ``cache-only`` run missed the cache; SUCCESS when a
    measured operating point was committed — from the cache, or from a
    probe search whose commit did not regress the measured seed
    heuristic; FAIL when ``probe`` mode had to fall back or the
    committed point measured slower than the heuristic start
    (``tpudist_torch.tune.autotune``)."""
    if mode == "off":
        return UNGATEABLE
    if source == "cache":
        return SUCCESS
    if source == "probe":
        # a dead heuristic start (baseline 0: the guess itself OOMed)
        # with a live tuned point is the tuner WORKING, not a regression
        if tuned_steps_per_sec and tuned_steps_per_sec >= (
                baseline_steps_per_sec or 0.0):
            return SUCCESS
        return FAIL
    return UNGATEABLE if mode == "cache-only" else FAIL


def _write(path: str, content: str) -> None:
    if path.startswith("gs://"):
        # shell-free: path/content go as argv/stdin
        subprocess.run(["gsutil", "cp", "-", path], input=content.encode(),
                       check=True, timeout=120)
    else:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(content)
        os.replace(tmp, path)


def write_worker_verdict(path: str, ok: bool) -> None:
    """Per-worker verdict at ``<path>.worker<rank>`` (every rank writes
    one)."""
    _write(f"{path}.worker{_rank()}", SUCCESS if ok else FAIL)


def write_final_verdict(path: str, ok: bool) -> None:
    """Coordinator-only aggregate verdict at ``path`` itself; call after
    :func:`aggregate_status`."""
    write_final_status(path, SUCCESS if ok else FAIL)


def write_final_status(path: str, status: str) -> None:
    """Coordinator-only: write an explicit status string (SUCCESS /
    FAIL / UNGATEABLE) at ``path``."""
    if _rank() == 0:
        _write(path, status)


def aggregate_status(local_ok: bool, timeout_s: Optional[float] = None
                     ) -> Tuple[bool, bool]:
    """AND-reduce success over all processes (one bad worker fails the
    job) -> ``(all_ok, timed_out)``.

    A peer that died or is late never joins the reduce, which then waits
    on it. So it runs on the host's gloo group in a daemon thread, and
    the wait is bounded by ``TPUDIST_AGGREGATE_TIMEOUT_S`` (120 s) unless
    ``timeout_s`` is given: past it, or when the reduce raises (gloo sees
    a peer's connection close), the result is ``(False, True)``.
    ``timed_out`` tells the caller to start no further collective (the
    end barrier, shutdown) and just exit: they would wait on the same
    peer or race the abandoned reduce."""
    if not dist.is_initialized():
        return local_ok, False
    if timeout_s is None:
        timeout_s = float(os.environ.get("TPUDIST_AGGREGATE_TIMEOUT_S", 120))
    result: list = []

    def gather():
        flag = torch.tensor([1 if local_ok else 0], dtype=torch.int32)
        try:
            dist.all_reduce(flag, op=dist.ReduceOp.MIN,
                            group=distributed.host_group())
        except RuntimeError as e:
            result.append(e)
            return
        result.append(bool(flag.item() == 1))

    t = threading.Thread(target=gather, daemon=True)
    t.start()
    t.join(timeout_s)
    if not result:
        print(f"tpudist: verdict aggregation timed out after {timeout_s}s "
              "(a peer likely died before the barrier) -> fail", flush=True)
        return False, True
    if isinstance(result[0], RuntimeError):
        print(f"tpudist: verdict aggregation failed ({result[0]}): a peer "
              "left -> fail", flush=True)
        return False, True
    return result[0], False
