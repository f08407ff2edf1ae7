"""Device-time attribution: compute vs exposed communication, from a
``torch.profiler`` capture.

The port of ``tpudist/obs/devtime.py``. The host spans' ``fence`` lumps
device compute, collective time and straggler wait into one number; this
module is the layer that reads what the CARD did:

  * a parser for the Chrome trace that ``torch.profiler`` (Kineto)
    writes (``export_chrome_trace``): :func:`device_op_tracks` keeps one
    track per CUDA device from the events whose ``cat`` is ``kernel``,
    ``gpu_memcpy`` or ``gpu_memset``, and drops the host's runtime
    events (``cuda_runtime``, ``cuda_driver``, ``python_function``,
    ``user_annotation``). A capture with no device event (the CPU) folds
    its ``cpu_op`` events, and gloo's collectives, into one synthetic
    host track, the JAX module's CPU rule, so the plumbing is testable
    without a card;
  * :func:`classify`, the port's own rule over those names: NCCL's
    kernels (``ncclDevKernel_*``, ``ncclKernel_*``), and on the host
    c10d's and gloo's collectives, are ``comm``; every other op is
    ``compute``. (The JAX rule reads XLA's op names: ``all-reduce.3``,
    ``ncclAllReduce``, and drops runtime scopes by their spelling; here
    the event's ``cat`` already says which events are ops);
  * the interval math, the attribution, :func:`comm_status` and
    :func:`device_events`, copied from the JAX module
    (``tests/test_torch_devtime.py`` pins their code to it): exposed
    communication is comm time not overlapped by compute on the same
    track, and ``compute + exposed_comm + idle == window`` per device;
  * :class:`WindowProfiler` (``--profile-window N``): N mid-run
    dispatches captured on every process into ``profile/worker<i>``
    and ingested at run end into the ``kind=devtime`` record, the
    ``comm_status`` verdict and device tracks under the host's row in
    ``pod_trace.json``;
  * :func:`collective_bytes`: the per-step collective volume of the
    gradient mean (the JAX function reads the lowered program's text,
    which the port does not have).
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from tpudist_torch import rules as rules_lib
from tpudist_torch.verdict import FAIL, SUCCESS, UNGATEABLE

Interval = Tuple[float, float]

# ------------------------------------------------------- classification

# NCCL's device kernels, and the host side's collectives: c10d's ops
# (cpu_op "c10d::allreduce_") and the work gloo runs on its own threads
# (user_annotation "gloo:all_reduce")
_COMM_RE = re.compile(r"^(?:nccl(?:Dev)?Kernel|c10d::|gloo:)")


def classify(name: str) -> Optional[str]:
    """``"comm"`` / ``"compute"`` for an op of a track
    (:func:`device_op_tracks` keeps ops only), ``None`` for a nameless
    event."""
    if not name:
        return None
    return "comm" if _COMM_RE.match(name) else "compute"


# -------------------------------------------------- collective bytes

_DTYPE_NAMES = {torch.float64: "f64", torch.float32: "f32",
                torch.float16: "f16", torch.bfloat16: "bf16",
                torch.int64: "i64", torch.int32: "i32", torch.int8: "i8",
                torch.uint8: "ui8", torch.bool: "i1"}


def collective_bytes(operands: Iterable[tuple]) -> Dict[str, Any]:
    """The per-step collective accounting of the train step, in the JAX
    ``collective_bytes`` schema: ``{"ops": [row...], "dcn_bytes_total",
    "ici_bytes_total", "n_collectives"}``, each row ``op``, ``dtype``
    (MLIR spelling), ``bytes`` (payload of one instance: the larger of
    operand and result, the whole tensor a reduce-scatter consumes or an
    all-gather produces), ``count``, ``fabric``, ``dcn_bytes``.

    ``operands`` are what the step body noted in one step (its
    ``reduced_operands()``): ``(dtype, bytes)`` for an all-reduce
    ``engine.pmean`` issues (the replicated step's loss),
    ``(op, dtype, bytes)`` from the sharded body (``all_gather``,
    ``reduce_scatter``, ``all_reduce``), or ``(op, dtype, bytes,
    dcn_participants)`` from the gradient mean of ``parallel.overlap``.
    The JAX function reads them off the lowered StableHLO text, which the
    port does not have. A collective whose group spans slices
    (``dcn_participants`` > 0, the world's members of its groups) is
    labelled ``dcn`` and prices ``bytes`` once a participant, as the JAX
    function prices a slice-spanning replica group; every other row is
    ``ici``."""
    agg: Dict[tuple, Dict[str, Any]] = {}
    for operand in operands:
        if len(operand) == 2:
            operand = ("all_reduce", *operand)
        op, dtype, nbytes, dcn = (*operand, 0)[:4]
        name = _DTYPE_NAMES.get(dtype, str(dtype).replace("torch.", ""))
        fabric = "dcn" if dcn else "ici"
        row = agg.setdefault((op, name, int(nbytes), fabric, int(dcn)), {
            "op": op, "dtype": name, "bytes": int(nbytes),
            "count": 0, "fabric": fabric, "dcn_bytes": 0})
        row["count"] += 1
        row["dcn_bytes"] += int(nbytes) * int(dcn)
    ops = sorted(agg.values(),
                 key=lambda r: (-r["dcn_bytes"], -r["bytes"], r["op"]))
    return {"ops": ops,
            "dcn_bytes_total": sum(r["dcn_bytes"] for r in ops),
            "ici_bytes_total": sum(r["bytes"] * r["count"] for r in ops
                                   if r["fabric"] == "ici"),
            "n_collectives": sum(r["count"] for r in ops)}


# -------------------------------------------------------- interval math


def merge_intervals(intervals: Sequence[Interval]) -> List[Interval]:
    """Sorted disjoint union of ``intervals`` (zero-length dropped)."""
    ivs = sorted((lo, hi) for lo, hi in intervals if hi > lo)
    out: List[Interval] = []
    for lo, hi in ivs:
        if out and lo <= out[-1][1]:
            if hi > out[-1][1]:
                out[-1] = (out[-1][0], hi)
        else:
            out.append((lo, hi))
    return out


def measure(intervals: Sequence[Interval]) -> float:
    """Total length of a DISJOINT interval list."""
    return sum(hi - lo for lo, hi in intervals)


def subtract_intervals(a: Sequence[Interval],
                       b: Sequence[Interval]) -> List[Interval]:
    """``a \\ b``, the parts of ``a`` not covered by ``b`` (both are
    union-normalised first): the exposed-communication operator,
    ``subtract(comm, compute)``."""
    a = merge_intervals(a)
    b = merge_intervals(b)
    out: List[Interval] = []
    j = 0
    for lo, hi in a:
        cur = lo
        while j < len(b) and b[j][1] <= cur:
            j += 1
        k = j
        while k < len(b) and b[k][0] < hi:
            blo, bhi = b[k]
            if blo > cur:
                out.append((cur, blo))
            cur = max(cur, bhi)
            if cur >= hi:
                break
            k += 1
        if cur < hi:
            out.append((cur, hi))
    return out


def intersect_intervals(a: Sequence[Interval],
                        b: Sequence[Interval]) -> List[Interval]:
    """``a ∩ b`` (union-normalised)."""
    a = merge_intervals(a)
    b = merge_intervals(b)
    out: List[Interval] = []
    i = j = 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            out.append((lo, hi))
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return out


# ------------------------------------------------------ capture parsing

# the events of a device's timeline (Kineto's ``cat``)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_TRACK = "host:CPU"
# the marker WindowProfiler records right after the profiler starts: its
# ``ts`` against the host clock read just before it is the measured
# offset between the capture's timebase and the tracer's
ANCHOR_NAME = "tpudist_profile_anchor"


def find_captures(capture_dir: str) -> List[str]:
    """The Chrome trace files under a capture directory
    (``<worker>.pt.trace.json``, gzipped or not)."""
    pats = (os.path.join(capture_dir, "**", "*.trace.json.gz"),
            os.path.join(capture_dir, "**", "*.trace.json"))
    out: List[str] = []
    for p in pats:
        out.extend(glob.glob(p, recursive=True))
    return sorted(out)


def load_capture_doc(path: str) -> Dict[str, Any]:
    """One capture file -> its Chrome trace document."""
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return json.load(f)
    with open(path) as f:
        return json.load(f)


def device_op_tracks(doc: Dict[str, Any]
                     ) -> Dict[str, List[Tuple[float, float, str]]]:
    """Op intervals per device track of one Kineto trace:
    ``{track: [(t0_us, t1_us, op_name), ...]}``.

    On the card every ``kernel`` / ``gpu_memcpy`` / ``gpu_memset`` event
    lands on its device's track, ``cuda:<i> <card name>`` (the name from
    the trace's ``deviceProperties``); a CUDA graph's replay shows its
    kernels one by one. The host's events count as neither compute nor
    communication there. A capture without device events (the CPU)
    folds its ``cpu_op`` events, and gloo's collectives (the
    ``gloo:*`` annotations its worker threads record), into one
    synthetic ``host:CPU`` track: nested host ops overlap, which the
    interval unions absorb."""
    names = {p.get("id"): p.get("name")
             for p in doc.get("deviceProperties") or []
             if isinstance(p, dict)}
    device: Dict[str, List[Tuple[float, float, str]]] = {}
    host: List[Tuple[float, float, str]] = []
    for e in doc.get("traceEvents", []):
        if e.get("ph") != "X" or "ts" not in e or "dur" not in e:
            continue
        cat, name = e.get("cat"), e.get("name", "")
        t0 = float(e["ts"])
        op = (t0, t0 + float(e["dur"]), name)
        if cat in DEVICE_CATS:
            dev = (e.get("args") or {}).get("device", e.get("pid"))
            track = f"cuda:{dev}" + (f" {names[dev]}" if names.get(dev)
                                     else "")
            device.setdefault(track, []).append(op)
        elif (cat == "cpu_op" or (cat == "user_annotation"
                                  and name.startswith("gloo:"))) \
                and classify(name) is not None:
            host.append(op)
    if device:
        return device
    return {HOST_TRACK: host} if host else {}


def anchor_ts(doc: Dict[str, Any]) -> Optional[float]:
    """The ``ts`` of :data:`ANCHOR_NAME` in a capture, or None."""
    for e in doc.get("traceEvents", []):
        if e.get("name") == ANCHOR_NAME and "ts" in e:
            return float(e["ts"])
    return None


# ---------------------------------------------------------- attribution


def attribute_classed(classed: Dict[str, List[Interval]],
                      window: Optional[Interval] = None) -> Dict[str, Any]:
    """One device track's compute/comm interval unions -> the exact,
    mutually exclusive decomposition (all times in SECONDS, inputs µs):

        compute_s + exposed_comm_s + idle_s == window_s

    ``comm_s`` is the TOTAL collective time; ``exposed_comm_s = comm \\
    compute`` is the part the schedule failed to hide."""
    compute = merge_intervals(classed.get("compute", []))
    comm = merge_intervals(classed.get("comm", []))
    if window is None:
        allv = compute + comm
        window = ((min(lo for lo, _ in allv), max(hi for _, hi in allv))
                  if allv else (0.0, 0.0))
    win_us = max(0.0, window[1] - window[0])
    exposed = subtract_intervals(comm, compute)
    busy = merge_intervals(compute + comm)
    compute_us = measure(compute)
    comm_us = measure(comm)
    exposed_us = measure(exposed)
    idle_us = max(0.0, win_us - measure(busy))
    out = {
        "window_s": win_us / 1e6,
        "compute_s": compute_us / 1e6,
        "comm_s": comm_us / 1e6,
        "exposed_comm_s": exposed_us / 1e6,
        "idle_s": idle_us / 1e6,
    }
    if win_us > 0:
        out["compute_frac"] = compute_us / win_us
        out["exposed_comm_frac"] = exposed_us / win_us
        out["idle_frac"] = idle_us / win_us
    else:
        out["compute_frac"] = out["exposed_comm_frac"] = None
        out["idle_frac"] = None
    return out


def attribute_tracks(tracks: Dict[str, List[Tuple[float, float, str]]]
                     ) -> Dict[str, Any]:
    """All device tracks of one capture -> per-device attribution plus
    the per-class interval unions (the merged-trace export reuses them).
    The idle window is the CAPTURE-wide op extent, shared by every
    track, so a device idling while its peers compute reads as idle."""
    classed: Dict[str, Dict[str, List[Interval]]] = {}
    lo = hi = None
    for name, ops in tracks.items():
        c = classed.setdefault(name, {"compute": [], "comm": []})
        for t0, t1, op in ops:
            cls = classify(op)
            if cls is None:
                continue
            c[cls].append((t0, t1))
            lo = t0 if lo is None else min(lo, t0)
            hi = t1 if hi is None else max(hi, t1)
    window = (lo, hi) if lo is not None else None
    devices = {name: attribute_classed(c, window)
               for name, c in sorted(classed.items())}
    intervals = {name: {cls: merge_intervals(iv)
                        for cls, iv in c.items()}
                 for name, c in classed.items()}
    pod = {
        "devices": len(devices),
        "window_s": (max(0.0, (window[1] - window[0]) / 1e6)
                     if window else 0.0),
        "compute_s": sum(d["compute_s"] for d in devices.values()),
        "comm_s": sum(d["comm_s"] for d in devices.values()),
        "exposed_comm_s": sum(d["exposed_comm_s"]
                              for d in devices.values()),
    }
    denom = pod["window_s"] * max(len(devices), 1)
    pod["exposed_comm_frac"] = (pod["exposed_comm_s"] / denom
                                if denom > 0 else None)
    return {"devices": devices, "intervals": intervals, "pod": pod,
            "window_us": window}


def analyze_capture(capture_dir: str) -> Dict[str, Any]:
    """Parse every capture file under ``capture_dir`` and attribute
    device time; ``anchor_ts`` is the window's marker when the capture
    holds one. Raises ``FileNotFoundError`` when the dir holds no trace
    (an aborted capture)."""
    paths = find_captures(capture_dir)
    if not paths:
        raise FileNotFoundError(
            f"no *.trace.json(.gz) under {capture_dir}")
    tracks: Dict[str, List[Tuple[float, float, str]]] = {}
    anchor = None
    for p in paths:
        doc = load_capture_doc(p)
        for name, ops in device_op_tracks(doc).items():
            tracks.setdefault(name, []).extend(ops)
        if anchor is None:
            anchor = anchor_ts(doc)
    out = attribute_tracks(tracks)
    out["capture_files"] = paths
    out["tracks"] = tracks
    out["anchor_ts"] = anchor
    return out


# ------------------------------------------------------------ verdict

# Exposed-communication gate, shared with the live alert engine through
# tpudist_torch.rules (TPUDIST_COMM_EXPOSED_MAX, read at call time);
# DCN-labelled rows grade against their own ceiling
COMM_EXPOSED_MAX = rules_lib.COMM_EXPOSED_MAX
COMM_EXPOSED_MAX_DCN = rules_lib.COMM_EXPOSED_MAX_DCN


def comm_status(exposed_frac: Optional[float],
                max_frac: Optional[float] = None,
                fabric: Optional[str] = None) -> str:
    """Three-valued exposed-communication verdict: UNGATEABLE when no
    device window was measured (capture off or empty), else
    SUCCESS/FAIL by whether the exposed-comm fraction of the device
    window stays under the fabric's ceiling
    (``tpudist_torch.rules.resolve_comm``). An explicit ``max_frac``
    wins."""
    if max_frac is None:
        max_frac = rules_lib.resolve_comm(fabric)
    if exposed_frac is None:
        return UNGATEABLE
    return SUCCESS if exposed_frac <= max_frac else FAIL


# --------------------------------------------- merged-trace device rows

# Device tracks ride under each host's pid in pod_trace.json on
# synthetic tids far above the tracer's per-thread ids.
DEVICE_TID_BASE = 1000
DEVTIME_CAT = "devtime"


def device_events(analysis: Dict[str, Any], *, process_index: int,
                  anchor_us: float) -> List[Dict[str, Any]]:
    """The capture's per-class busy intervals as Chrome trace events for
    the pod merge: one synthetic thread per device track under the
    host's pid, events named ``compute``/``comm`` over the merged
    interval unions (coalesced, not one event an op).

    ``anchor_us`` takes a capture ``ts`` onto the host tracer's
    ``perf_counter`` timebase (:meth:`WindowProfiler.offset_us`, which
    measures it), so the existing clock-offset merge aligns the device
    rows pod-wide."""
    out: List[Dict[str, Any]] = []
    for i, (name, classed) in enumerate(sorted(
            analysis["intervals"].items())):
        tid = DEVICE_TID_BASE + i
        out.append({"ph": "M", "name": "thread_name",
                    "pid": process_index, "tid": tid,
                    "args": {"name": f"device:{name}"}})
        for cls in ("compute", "comm"):
            for lo, hi in classed.get(cls, []):
                out.append({"name": cls, "cat": DEVTIME_CAT, "ph": "X",
                            "ts": anchor_us + lo, "dur": hi - lo,
                            "pid": process_index, "tid": tid,
                            "args": {"device": name}})
    return out


# ------------------------------------------------------ window capture

# why a window open when the watchdog fires is lost: stopping Kineto from
# a thread other than the one that started it finds no session there
# (and a later export of that session crashes the process)
LOST_ON_WATCHDOG = ("the stall watchdog fired with the capture window "
                    "open; torch.profiler stops only on the thread that "
                    "started it (the train loop's, which is wedged), so "
                    "the capture is dropped")


class WindowProfiler:
    """``--profile-window N``: capture N mid-run dispatches with
    ``torch.profiler`` into ``<out_dir>/worker<i>`` and hand the capture
    to :func:`analyze_capture` at run end, with the JAX class's contract.

    It arms at the MIDDLE epoch's first dispatch (steady state: the
    builds, captures and first staging are over), counts dispatches,
    fences once on the N-th dispatch's result and stops; :meth:`close`,
    at run end and off the timed steps, writes the Kineto trace
    (``stop_s`` and ``export_s`` time the two). The host clock is read before the profiler starts
    (``anchor_ns``) and again just before a marker event, whose ``ts``
    in the trace gives the measured offset to the tracer's clock
    (:meth:`offset_us`). The profiler records no shapes, stacks or
    memory and adds no callback inside a captured graph: the card
    computes the same bits with the window on.

    :meth:`close` and :meth:`emergency_stop` are idempotent. Unlike
    ``jax.profiler``, ``torch.profiler`` cannot be stopped from the stall
    watchdog's thread: :meth:`emergency_stop` there marks the window
    ``lost`` (:data:`LOST_ON_WATCHDOG`) and returns the reason for the
    flight record, without touching the profiler or waiting on the main
    thread; the main thread's :meth:`close` stops it later, if the run
    gets there, and keeps no capture.
    """

    def __init__(self, out_dir: str, n_dispatches: int, *,
                 process_index: int = 0, trigger_epoch: int = 0,
                 device: Optional[torch.device] = None):
        if n_dispatches < 1:
            raise ValueError(
                f"profile window must be >= 1 dispatch, got {n_dispatches}")
        self.capture_dir = os.path.join(out_dir,
                                        f"worker{process_index}")
        self.n = n_dispatches
        self.trigger_epoch = trigger_epoch
        self.process_index = process_index
        self.device = device
        self.state = "armed"            # armed -> open -> (lost ->) done
        self.seen = 0
        self.captured = False
        self.anchor_ns: Optional[int] = None
        self.marker_ns: Optional[int] = None
        self.lost: Optional[str] = None
        self.stop_s: Optional[float] = None
        self.export_s: Optional[float] = None
        self._lock = threading.Lock()
        self._span = None
        self._prof = None
        self._owner: Optional[int] = None

    @classmethod
    def from_config(cls, cfg, *, out_dir: str, process_index: int = 0,
                    device: Optional[torch.device] = None
                    ) -> Optional["WindowProfiler"]:
        """``None`` when the window is off (the train loop's calls all
        no-op through a plain ``if win is not None``)."""
        from tpudist_torch.config import resolve_profile_window
        n = resolve_profile_window(cfg)
        if n <= 0:
            return None
        return cls(os.path.join(out_dir, "profile"), n,
                   process_index=process_index,
                   trigger_epoch=max(0, cfg.epochs // 2), device=device)

    # ------------------------------------------------------ train hooks
    def maybe_start(self, epoch: int) -> None:
        """Epoch-top hook: open the capture at the trigger epoch."""
        if self.state != "armed" or epoch < self.trigger_epoch:
            return
        from torch.profiler import ProfilerActivity, profile, record_function

        from tpudist_torch.obs import trace as trace_lib
        os.makedirs(self.capture_dir, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if self.device is not None and self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._span = trace_lib.get().begin("profile_window",
                                           cat="profile", n=self.n)
        self.anchor_ns = time.perf_counter_ns()
        self._prof = profile(activities=activities)
        self._prof.start()
        self._owner = threading.get_ident()
        self.marker_ns = time.perf_counter_ns()
        with record_function(ANCHOR_NAME):
            pass
        self.state = "open"

    def note_dispatch(self, result: Any = None) -> None:
        """Per-dispatch hook; closes the window after ``n`` dispatches.
        The fence makes the captured dispatches' device work land inside
        the capture: stopping behind asynchronous launches would cut the
        timeline short."""
        if self.state != "open":
            return
        self.seen += 1
        if self.seen < self.n:
            return
        if isinstance(result, torch.Tensor) and result.is_cuda:
            torch.cuda.synchronize(result.device)
        self._stop()

    def close(self) -> None:
        """Run end, on the loop's thread: stops a window larger than the
        run (a partial capture) and writes the stopped capture's trace.
        Idempotent."""
        self._stop()
        with self._lock:
            if self._prof is None:
                return
            t0 = time.perf_counter()
            try:
                self._prof.export_chrome_trace(os.path.join(
                    self.capture_dir,
                    f"worker{self.process_index}.pt.trace.json"))
                self.captured = True
            except Exception as e:
                self.lost = repr(e)
            self.export_s = time.perf_counter() - t0
            self._prof = None

    def emergency_stop(self) -> Any:
        """Watchdog hook. On the thread that opened the window it stops
        the capture and returns its path; on any other thread (the
        watchdog's) it marks the window lost and returns
        ``{"profile_capture_lost": reason}``; ``None`` when no window is
        open."""
        if self.state != "open":
            return None
        if threading.get_ident() == self._owner:
            self.close()
            return self.capture_dir if self.captured else None
        with self._lock:
            if self.state != "open":
                return None
            self.state = "lost"
            self.lost = LOST_ON_WATCHDOG
        return {"profile_capture_lost": self.lost}

    def offset_us(self, analysis: Dict[str, Any]) -> float:
        """The measured offset from the capture's ``ts`` to the tracer's
        clock (``perf_counter`` µs): the host clock read before the
        marker minus the marker's ``ts`` (:func:`analyze_capture`)."""
        if analysis.get("anchor_ts") is None or self.marker_ns is None:
            raise ValueError("the capture holds no anchor marker")
        return self.marker_ns / 1e3 - analysis["anchor_ts"]

    def _stop(self) -> None:
        """Stop the profiler (the loop's thread); a lost window's session
        is dropped, an open one's kept for :meth:`close` to write."""
        with self._lock:
            if self.state not in ("open", "lost"):
                return
            keep = self.state == "open"
            self.state = "done"
            t0 = time.perf_counter()
            try:
                self._prof.stop()
            except Exception as e:
                self.lost = self.lost or repr(e)
                keep = False
            self.stop_s = time.perf_counter() - t0
            if not keep:
                self._prof = None
            if self._span is not None:
                from tpudist_torch.obs import trace as trace_lib
                trace_lib.get().end(self._span)
                self._span = None
