"""Live pod telemetry: the streaming metrics bus, the on-line status,
the Prometheus exporter, and the run's correlation id: the port of
``tpudist/obs/live.py``.

  * :func:`encode_frame` / :class:`FrameDecoder` — the wire format, a
    copy of the JAX codec (``tests/test_torch_live_bus.py`` holds the
    bytes equal and each decoder to the other's frames): magic, length,
    header and payload crc32s, so garbage on the stream costs frames,
    never the stream;
  * :class:`TelemetryEmitter` — per-worker and non-blocking: records go
    onto a bounded queue (a full queue drops and counts) and a daemon
    thread ships them as frames over TCP or UDP to the coordinator;
  * :class:`LiveAggregator` — coordinator-side, a copy of the JAX class
    method for method, but for :meth:`~LiveAggregator.tick`'s live
    straggler ratio, which takes a host's rate only from
    :data:`MIN_RATE_BEACONS` beacons of one epoch on (:func:`live_rate`):
    ingests every worker's stream (heartbeat beacons,
    the rank-0 metrics fan-out, the watchdog's ``stall_dump``) through
    :meth:`~LiveAggregator.ingest` or its TCP/UDP listener, keeps
    rolling windows, drives the on-line
    :class:`~tpudist_torch.obs.alerts.AlertEngine` over the thresholds
    the exit verdict applies (:mod:`tpudist_torch.rules`), appends each
    alert transition to ``alerts.jsonl`` and rewrites
    ``live_status.json`` atomically;
  * :func:`prometheus_text` and :class:`LiveHttpServer` — ``/metrics``,
    ``/status.json`` and ``/healthz``, served from the aggregator's last
    snapshot without its ingest lock;
  * :class:`LiveRun` — the train loop's handle: the coordinator's
    aggregator and exporter, every process's emitter.

``--live off`` (the default) constructs none of it: no socket, no
thread, no queue. The serve CLI feeds an aggregator in-process (its
loopback emitter) under ``TPUDIST_LIVE=on`` and serves it under
``--live-port``. The JAX package's ``python -m tpudist.obs.live tail``
reads this module's ``/status.json`` and ``live_status.json`` as they
are.

Every record a run writes carries ``run_id`` (``MetricsLogger.extra``),
as do its trace documents (``Tracer.run_info``) and its flight records,
so the artifacts of one run, and of its requeue attempts, stay
correlatable (:func:`resolve_run_id`).
"""

from __future__ import annotations

import json
import os
import socket
import struct
import threading
import time
import uuid
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch.distributed as dist

from tpudist_torch import rules as rules_lib
from tpudist_torch.obs import alerts as alerts_lib
from tpudist_torch.parallel import distributed

LIVE_SCHEMA_VERSION = 1
STATUS_NAME = "live_status.json"
ALERTS_NAME = "alerts.jsonl"

# Emitter queue depth: at the train loop's record rate (a few records
# per logging boundary plus one beacon every couple of seconds) this
# holds minutes of backlog; past it the emitter DROPS — the step loop
# never blocks on telemetry.
DEFAULT_QUEUE_SLOTS = 1024
# A frame longer than this is a corrupt length prefix, not a record —
# the decoder resynchronises by dropping its buffer.
MAX_FRAME_BYTES = 1 << 20


# ------------------------------------------------------------ wire format

_LEN = struct.Struct(">I")
_CRC = struct.Struct(">I")
# Frame marker: the decoder's resynchronisation anchor. A naked length
# prefix cannot recover from garbage on the stream (any 4 bytes read as
# a length), so each frame leads with this magic and carries a payload
# crc32 — garbage between frames is skipped by scanning to the next
# marker, and a frame whose bytes were torn mid-stream (truncation, a
# chance marker inside garbage) fails its crc and costs ONLY itself:
# the decoder rescans the very bytes it tentatively consumed, so
# buffered and subsequent valid frames still decode (pinned by the
# fuzz test in tests/test_live.py — the chaos plane's
# telemetry_garbage drill injects exactly this).
FRAME_MAGIC = b"TPLF"
# header layout: magic + payload length + header crc32 (over the magic
# and length bytes — a TORN length field is rejected the moment the
# header arrives, instead of stalling the stream on a phantom payload
# that never comes) + payload crc32
_HEADER = len(FRAME_MAGIC) + _LEN.size + 2 * _CRC.size


def encode_frame(rec: Dict[str, Any]) -> bytes:
    """One record as a framed JSON message: 4-byte magic + big-endian
    payload length + header crc32 + payload crc32 + UTF-8 payload. The
    same framing rides TCP streams and UDP datagrams, so both
    transports share one codec."""
    import zlib
    payload = json.dumps(rec, separators=(",", ":"),
                         default=str).encode("utf-8")
    head = FRAME_MAGIC + _LEN.pack(len(payload))
    return (head + _CRC.pack(zlib.crc32(head) & 0xFFFFFFFF)
            + _CRC.pack(zlib.crc32(payload) & 0xFFFFFFFF) + payload)


class FrameDecoder:
    """Incremental, SELF-RESYNCHRONISING frame parser for one TCP
    connection (or one UDP datagram). Tolerates partial reads; garbage
    bytes, corrupt length prefixes and torn frames bump ``bad`` and the
    decoder scans forward to the next frame marker — one bad peer (or a
    chaos-injected garbage burst) can neither wedge the aggregator nor
    cost the valid frames around the damage."""

    def __init__(self) -> None:
        self._buf = b""
        self.bad = 0

    def _discard_to_marker(self) -> bool:
        """Drop bytes that cannot start a frame; keep a possible marker
        prefix at the tail. True when a full marker heads the buffer."""
        i = self._buf.find(FRAME_MAGIC)
        if i == 0:
            return True
        if i > 0:
            self.bad += 1             # garbage before the marker
            self._buf = self._buf[i:]
            return True
        keep = 0
        for k in range(min(len(FRAME_MAGIC) - 1, len(self._buf)), 0, -1):
            if self._buf.endswith(FRAME_MAGIC[:k]):
                keep = k
                break
        if len(self._buf) > keep:
            self.bad += 1             # pure garbage discarded
            self._buf = self._buf[len(self._buf) - keep:] if keep else b""
        return False

    def feed(self, data: bytes) -> List[Dict[str, Any]]:
        import zlib
        self._buf += data
        out: List[Dict[str, Any]] = []
        while self._buf:
            if not self._discard_to_marker():
                break                 # no full marker buffered yet
            if len(self._buf) < _HEADER:
                break
            (n,) = _LEN.unpack_from(self._buf, len(FRAME_MAGIC))
            (hcrc,) = _CRC.unpack_from(self._buf,
                                       len(FRAME_MAGIC) + _LEN.size)
            head = self._buf[:len(FRAME_MAGIC) + _LEN.size]
            if n > MAX_FRAME_BYTES \
                    or zlib.crc32(head) & 0xFFFFFFFF != hcrc:
                # torn/corrupt header (or a chance marker inside
                # garbage): reject NOW — waiting out a phantom length
                # would stall the stream — skip just this marker and
                # rescan what follows
                self.bad += 1
                self._buf = self._buf[1:]
                continue
            if len(self._buf) < _HEADER + n:
                break                 # wait for the rest of the frame
            (crc,) = _CRC.unpack_from(
                self._buf, len(FRAME_MAGIC) + _LEN.size + _CRC.size)
            raw = self._buf[_HEADER:_HEADER + n]
            if zlib.crc32(raw) & 0xFFFFFFFF != crc:
                # torn frame (truncated sender, garbage with a chance
                # marker): the bytes we tentatively framed may CONTAIN
                # the next valid frame — skip only the marker and
                # rescan them instead of discarding
                self.bad += 1
                self._buf = self._buf[1:]
                continue
            self._buf = self._buf[_HEADER + n:]
            try:
                rec = json.loads(raw)
                if isinstance(rec, dict):
                    out.append(rec)
                else:
                    self.bad += 1
            except Exception:
                self.bad += 1         # well-framed but unparseable
        return out


def parse_endpoint(endpoint: str) -> Tuple[str, Tuple[str, int]]:
    """``[tcp://|udp://]host:port`` → ``(transport, (host, port))``."""
    transport = "tcp"
    rest = endpoint
    if "://" in endpoint:
        scheme, rest = endpoint.split("://", 1)
        if scheme not in ("tcp", "udp"):
            raise ValueError(
                f"live endpoint transport must be tcp or udp, got "
                f"{scheme!r} in {endpoint!r}")
        transport = scheme
    host, sep, port_s = rest.rpartition(":")
    if not sep or not port_s.isdigit():
        raise ValueError(
            f"live endpoint must be [tcp://|udp://]host:port, got "
            f"{endpoint!r}")
    return transport, (host or "127.0.0.1", int(port_s))


# --------------------------------------------------------------- emitter


class TelemetryEmitter:
    """Per-worker non-blocking record shipper.

    ``emit()`` is the ONLY entry point the train loop (and the beacon
    thread) touches: a ``put_nowait`` onto a bounded queue — a full
    queue drops the record and bumps ``dropped``, it never waits. The
    sender thread owns every socket operation; connect/send timeouts
    plus a reconnect backoff mean a dead or wedged coordinator costs
    dropped records, never a blocked caller. Same posture as the span
    tracer: telemetry must not be able to slow the thing it observes.
    """

    def __init__(self, endpoint: str, *,
                 queue_slots: int = DEFAULT_QUEUE_SLOTS,
                 connect_timeout_s: float = 2.0,
                 send_timeout_s: float = 2.0,
                 retry_s: float = 0.5):
        import queue as queue_mod
        self.transport, self.addr = parse_endpoint(endpoint)
        self.endpoint = endpoint
        self.connect_timeout_s = connect_timeout_s
        self.send_timeout_s = send_timeout_s
        self.retry_s = retry_s
        self._q: Any = queue_mod.Queue(maxsize=max(1, queue_slots))
        self._full = queue_mod.Full
        self._empty = queue_mod.Empty
        self.sent = 0
        self.dropped = 0
        self.errors = 0
        self._sock: Optional[socket.socket] = None
        self._next_connect = 0.0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="tpudist-live-emit", daemon=True)
        self._thread.start()

    # ------------------------------------------------------- hot path
    def emit(self, rec: Dict[str, Any]) -> None:
        """Enqueue one record; never blocks, never raises."""
        if self._stop.is_set():
            return
        try:
            self._q.put_nowait(rec)
        except self._full:
            self.dropped += 1

    def inject_garbage(self, data: bytes) -> None:
        """Chaos-plane hook (tpudist_torch.chaos ``telemetry_garbage``):
        enqueue raw UNFRAMED bytes that the sender ships verbatim —
        scripted stream damage the aggregator's FrameDecoder must
        resynchronise through. Same non-blocking discipline as emit."""
        if self._stop.is_set():
            return
        try:
            self._q.put_nowait(bytes(data))
        except self._full:
            self.dropped += 1

    # --------------------------------------------------- sender thread
    def _loop(self) -> None:
        while True:
            try:
                rec = self._q.get(timeout=0.1)
            except self._empty:
                if self._stop.is_set():
                    return
                continue
            self._send(rec)

    def _send(self, rec: Any) -> None:
        try:
            # raw bytes = chaos-injected garbage, shipped unframed
            frame = (bytes(rec) if isinstance(rec, (bytes, bytearray))
                     else encode_frame(rec))
            if self.transport == "udp":
                if self._sock is None:
                    self._sock = socket.socket(socket.AF_INET,
                                               socket.SOCK_DGRAM)
                self._sock.sendto(frame, self.addr)
            else:
                if self._sock is None:
                    if time.monotonic() < self._next_connect:
                        raise ConnectionError("reconnect backoff")
                    s = socket.create_connection(
                        self.addr, timeout=self.connect_timeout_s)
                    s.settimeout(self.send_timeout_s)
                    self._sock = s
                self._sock.sendall(frame)
            self.sent += 1
        except Exception:
            # drop-not-block: the record is lost, counted, and the
            # sender moves on; the NEXT connect attempt is rate-limited
            self.errors += 1
            self.dropped += 1
            if self._sock is not None:
                try:
                    self._sock.close()
                except Exception:
                    pass
                self._sock = None
            self._next_connect = time.monotonic() + self.retry_s

    def close(self, drain_s: float = 1.0) -> None:
        """Bounded drain then stop — run exit must not hang on a dead
        coordinator (whatever is still queued past the deadline is
        counted as dropped by omission)."""
        deadline = time.monotonic() + max(0.0, drain_s)
        while (not self._q.empty() and self._thread.is_alive()
               and time.monotonic() < deadline):
            time.sleep(0.02)
        self._stop.set()
        self._thread.join(timeout=2.0)
        if self._sock is not None:
            try:
                self._sock.close()
            except Exception:
                pass
            self._sock = None

    def stats(self) -> Dict[str, Any]:
        return {"endpoint": self.endpoint, "sent": self.sent,
                "dropped": self.dropped, "errors": self.errors,
                "queued": self._q.qsize()}


# ------------------------------------------------------- rolling windows


class RollingWindow:
    """Monotone counter samples within the last ``window_s`` seconds;
    ``rate()`` is the counter's slope over the surviving span."""

    def __init__(self, window_s: float = 30.0):
        self.window_s = float(window_s)
        self._pts: deque = deque()

    def add(self, t: float, v: float) -> None:
        self._pts.append((t, v))
        cutoff = t - self.window_s
        while len(self._pts) > 1 and self._pts[0][0] < cutoff:
            self._pts.popleft()

    def rate(self) -> Optional[float]:
        if len(self._pts) < 2:
            return None
        (t0, v0), (t1, v1) = self._pts[0], self._pts[-1]
        return (v1 - v0) / (t1 - t0) if t1 > t0 else None

    def last(self) -> Optional[float]:
        return self._pts[-1][1] if self._pts else None


# A host's beacon-derived step rate joins the live straggler ratio only
# once its window holds this many stepped beacons with no counter reset
# among them. The beacon samples the per-epoch step every beacon period
# (at most 2 s), at a phase of its own on each host: over fewer beacons
# two ranks stepping in lockstep read rates apart by up to one period
# in the span (3 beacons of a seconds-long run: 1.254 between two gloo
# ranks, past the 1.25 factor), and a window across an epoch's reset
# reads no rate at all. Eight beacons span at least seven periods, so
# the phase moves the ratio by at most 1/7.
MIN_RATE_BEACONS = 8


def live_rate(window: RollingWindow) -> Optional[float]:
    """The window's step rate for the live straggler ratio, or None
    while it holds fewer than :data:`MIN_RATE_BEACONS` samples, or a
    step counter that went back (an epoch's reset)."""
    pts = list(window._pts)
    if len(pts) < MIN_RATE_BEACONS or any(
            b[1] < a[1] for a, b in zip(pts, pts[1:])):
        return None
    r = window.rate()
    return r if r and r > 0 else None


# ------------------------------------------------------------ aggregator


class LiveAggregator:
    """Coordinator-side rolling view of the pod + the on-line alerts.

    ``ingest(rec)`` accepts any record from the bus — heartbeat beacons
    from every worker, the rank-0 metrics fan-out (``kind=step/epoch/
    hosts/timing/ckpt/devtime/resume``), and the watchdog's last-gasp
    ``kind=stall_dump`` — updates the rolling windows, and feeds the
    alert engine. ``tick()`` evaluates the time-based rules (stall ages,
    live straggler ratios from beacon-derived rates). Both rebuild
    ``self._status``, a plain dict REPLACED WHOLESALE so the exporter
    and the flight recorder's stall dump read it without any lock
    (:meth:`snapshot`), and write ``live_status.json`` atomically
    (rate-limited; alert transitions force a write so a breach is on
    disk and scrapeable before any launcher kill).

    Scripted tests pass ``start_ticker=False`` plus explicit ``now=``
    values, and a fake ``wall`` clock into the engine, making windows
    and alert durations deterministic.
    """

    def __init__(self, *, out_dir: str, run_id: Optional[str] = None,
                 requeue_attempt: int = 0,
                 stall_timeout_s: Optional[float] = None,
                 window_s: float = 30.0,
                 regress_baseline_sps: Optional[float] = None,
                 metrics: Any = None,
                 status_min_interval_s: float = 0.25,
                 clock: Callable[[], float] = time.monotonic,
                 wall: Callable[[], float] = time.time,
                 start_ticker: bool = True):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.status_path = os.path.join(out_dir, STATUS_NAME)
        self.alerts_path = os.path.join(out_dir, ALERTS_NAME)
        self.run_id = run_id
        self.requeue_attempt = requeue_attempt
        self.stall_timeout_s = (rules_lib.resolve("stall")
                                if stall_timeout_s is None
                                else float(stall_timeout_s))
        self.window_s = window_s
        if regress_baseline_sps is None:
            raw = os.environ.get("TPUDIST_LIVE_BASELINE_SPS")
            try:
                regress_baseline_sps = float(raw) if raw else None
            except ValueError:
                regress_baseline_sps = None
        self.regress_baseline_sps = regress_baseline_sps
        self.metrics = metrics
        self.clock = clock
        self.wall = wall
        self.engine = alerts_lib.AlertEngine(on_event=self._on_event,
                                             clock=wall)
        self._lock = threading.RLock()
        self._hosts: Dict[int, Dict[str, Any]] = {}
        self._pod: Dict[str, Any] = {
            "step": None, "epoch": None, "loss": None,
            "steps_per_sec": None, "straggler_ratio": None,
            "staging_overlap_fraction": None, "exposed_comm_frac": None,
            "dcn_bytes_total": None,
            "ckpt_last_enqueue_ms": None, "ckpt_drain_ms": None,
            "ckpt_saves": 0, "resume": None, "timing_seen": False}
        self._pod_window = RollingWindow(window_s)
        self.records = 0
        self.bad_frames = 0
        self._alerts_fh = None
        self._last_write = 0.0
        # serialises the throttle check + tmp-file write/rename: ingest
        # threads, the ticker, and forced alert writes all land here,
        # and two writers sharing one .tmp path would tear the file
        self._write_lock = threading.Lock()
        self.status_min_interval_s = status_min_interval_s
        self._servers: List[Any] = []
        self._conns: List[socket.socket] = []
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        self._status: Dict[str, Any] = {}
        self._rebuild(force_write=False)
        if start_ticker:
            period = 0.5
            if self.stall_timeout_s > 0:
                period = min(1.0, max(0.05, self.stall_timeout_s / 4.0))
            t = threading.Thread(target=self._tick_loop, args=(period,),
                                 name="tpudist-live-agg", daemon=True)
            t.start()
            self._threads.append(t)

    # ---------------------------------------------------------- ingest
    def ingest(self, rec: Dict[str, Any],
               now: Optional[float] = None) -> None:
        now = self.clock() if now is None else now
        with self._lock:
            self._ingest_locked(rec, now)
        self._rebuild()

    def _ingest_locked(self, rec: Dict[str, Any], now: float) -> None:
        self.records += 1
        if self.run_id is None and rec.get("run_id"):
            self.run_id = str(rec["run_id"])
        kind = rec.get("kind")
        if kind == "heartbeat":
            self._ingest_heartbeat(rec, now)
        elif kind == "step":
            step = rec.get("step")
            if isinstance(step, (int, float)):
                self._pod["step"] = int(step)
                self._pod_window.add(now, float(step))
            for k in ("epoch", "loss"):
                if rec.get(k) is not None:
                    self._pod[k] = rec[k]
            self._observe_rate(rec.get("steps_per_sec"))
        elif kind == "epoch":
            for k in ("epoch", "steps_per_sec"):
                if rec.get(k) is not None:
                    self._pod[k] = rec[k]
            if rec.get("avg_loss") is not None:
                self._pod["loss"] = rec["avg_loss"]
            self._observe_rate(rec.get("steps_per_sec"))
        elif kind == "hosts":
            ratio = rec.get("straggler_ratio")
            self._pod["straggler_ratio"] = ratio
            self.engine.observe("straggler", ratio,
                                step=self._pod.get("step"))
        elif kind == "timing":
            self._pod["timing_seen"] = True
            ov = rec.get("staging_overlap_fraction")
            if ov is not None:
                self._pod["staging_overlap_fraction"] = ov
                self.engine.observe("staging", ov,
                                    step=self._pod.get("step"))
        elif kind == "devtime":
            frac = rec.get("exposed_comm_frac")
            self._pod["exposed_comm_frac"] = frac
            fabric = rec.get("fabric")
            if fabric is not None:
                self._pod["comm_fabric"] = fabric
            if rec.get("dcn_bytes_total") is not None:
                # program-derived per-step DCN byte volume (cross-slice
                # schedule telemetry) — a gauge, not a counter: the
                # program is fixed for the run
                self._pod["dcn_bytes_total"] = rec["dcn_bytes_total"]
            # fabric-graded: a DCN-labeled record substitutes the DCN
            # ceiling but keeps the ONE "comm" rule key, so the at-exit
            # comm_status cross-check still finds its matching alert
            self.engine.observe("comm", frac,
                                threshold=rules_lib.resolve_comm(fabric),
                                step=self._pod.get("step"))
        elif kind == "ckpt":
            self._pod["ckpt_saves"] += 1
            if rec.get("enqueue_ms") is not None:
                self._pod["ckpt_last_enqueue_ms"] = rec["enqueue_ms"]
        elif kind == "ckpt_drain":
            if rec.get("drain_ms") is not None:
                self._pod["ckpt_drain_ms"] = rec["drain_ms"]
        elif kind == "resume":
            self._pod["resume"] = {
                k: rec.get(k) for k in ("status", "source",
                                        "resumed_from_step",
                                        "requeue_attempt")}
        elif kind in ("serve_tick", "serve"):
            # the serving loop's periodic SLO observations (and its
            # final summary): latest values win the status doc, and the
            # three serve gates ride the SAME alert engine the training
            # rules do — an SLO breach fires mid-run, not at exit
            sv = self._pod.setdefault("serve", {})
            for k in ("queue_depth", "active_slots", "completed",
                      "generated_tokens", "ttft_p99_s", "itl_p99_s",
                      "tokens_per_sec_per_chip", "status",
                      "shed_total", "shed_fraction", "adapt_level",
                      "decode_k", "kv_pages_used", "kv_pages_total",
                      "kv_shared_refs", "spec_accept_rate",
                      "ttft_hist", "itl_hist"):
                if rec.get(k) is not None:
                    sv[k] = rec[k]
            step = sv.get("completed")
            self.engine.observe("ttft", rec.get("ttft_p99_s"),
                                step=step)
            self.engine.observe("itl", rec.get("itl_p99_s"), step=step)
            self.engine.observe("tokens_per_chip",
                                rec.get("tokens_per_sec_per_chip"),
                                step=step)
            self.engine.observe("serve_shed", rec.get("shed_fraction"),
                                step=step)
        elif kind == "serve_adapt":
            # the pressure controller's ladder transitions, mirrored
            # into the live view: latest level wins the status doc and
            # the tpudist_serve_adapt_level gauge; the full transition
            # history stays in metrics.jsonl for the report/verifier
            sv = self._pod.setdefault("serve", {})
            for k in ("adapt_level", "decode_k"):
                src = "to_level" if k == "adapt_level" else k
                if rec.get(src) is not None:
                    sv[k] = rec[src]
        elif kind == "goodput":
            # the run-end attempt-local goodput estimate
            # (obs.goodput.attempt_record): the same observable the
            # offline cross-attempt ledger refines, graded against the
            # same rules-table floor
            frac = rec.get("fraction")
            self._pod["goodput_fraction"] = frac
            self.engine.observe("goodput", frac,
                                step=self._pod.get("step"))
        elif kind == "memledger":
            # the run-end HBM ledger (obs.memledger.ledger_record):
            # per-bucket bytes become the tpudist_hbm_bytes{bucket=...}
            # gauge family and the headroom fraction is graded live
            # against the TPUDIST_HBM_HEADROOM_MIN floor — an
            # over-committed device alerts before the allocation spike
            # that would kill it
            ml = self._pod.setdefault("memledger", {})
            for k in ("total_hbm_bytes", "headroom_fraction",
                      "hbm_headroom_status", "exact", "mode",
                      "watermark_source"):
                if rec.get(k) is not None:
                    ml[k] = rec[k]
            for k in ("params", "opt_state", "slabs", "kv_pool",
                      "program_temp", "headroom", "residue"):
                if rec.get(f"{k}_bytes") is not None:
                    ml.setdefault("buckets", {})[k] = rec[f"{k}_bytes"]
            self.engine.observe("hbm_headroom",
                                rec.get("headroom_fraction"),
                                step=self._pod.get("step"))
        elif kind == "stall_dump":
            # the watchdog's last gasp: the worker MEASURED this many
            # seconds without step progress before dumping — observe it
            # directly so the alert is firing (and scrapeable) without
            # waiting for this side's age accounting to catch up
            pi = int(rec.get("process_index", 0) or 0)
            stall_s = rec.get("stall_s")
            if isinstance(stall_s, (int, float)) \
                    and self.stall_timeout_s > 0:
                self.engine.observe("stall", float(stall_s), host=pi,
                                    step=rec.get("step"),
                                    threshold=self.stall_timeout_s)
        # kind == "alert" (our own loopback echo) and unknown kinds:
        # counted, otherwise ignored

    def _ingest_heartbeat(self, rec: Dict[str, Any], now: float) -> None:
        pi = int(rec.get("process_index", 0) or 0)
        h = self._hosts.setdefault(pi, {
            "window": RollingWindow(self.window_s),
            "last_progress": now, "last_seen": now, "step": None,
            "epoch": None, "phase": None, "progress_n": None,
            "hbm_peak_bytes": None,
            "staging_overlap_fraction": None})
        step = rec.get("step")
        stepped = (isinstance(step, (int, float)) and step >= 0
                   and h["step"] != int(step))
        # stall re-arm: prefer the beacon's note_progress counter — the
        # SAME any-progress signal the watchdog re-arms on (phase flips
        # during a long eval or ckpt drain count, so those phases don't
        # read as stalls) — falling back to step advances for scripted
        # or older beacons that don't carry it
        pn = rec.get("progress_n")
        if pn is not None:
            if h["progress_n"] != pn:
                h["last_progress"] = now
            h["progress_n"] = pn
        elif stepped:
            h["last_progress"] = now
        if isinstance(step, (int, float)) and step >= 0:
            if stepped:
                h["window"].add(now, float(step))
            h["step"] = int(step)
        for k in ("epoch", "phase"):
            if rec.get(k) is not None:
                h[k] = rec[k]
        if rec.get("hbm_peak_bytes") is not None:
            h["hbm_peak_bytes"] = rec["hbm_peak_bytes"]
        h["last_seen"] = now
        # live staging overlap from the beacon's cheap counters: the
        # SAME observable the exit verdict grades, available mid-run
        run_s = rec.get("run_s")
        wait_s = rec.get("staging_wait_s")
        if (rec.get("staging_streamed")
                and isinstance(run_s, (int, float)) and run_s > 0
                and isinstance(wait_s, (int, float))):
            ov = max(0.0, min(1.0, 1.0 - wait_s / run_s))
            h["staging_overlap_fraction"] = ov
            self.engine.observe("staging", ov, host=pi, step=h["step"])

    def _observe_rate(self, sps: Any) -> None:
        if not isinstance(sps, (int, float)) or sps <= 0:
            return   # warmup/empty timer: nothing measured yet
        self._pod["steps_per_sec"] = sps
        if self.regress_baseline_sps:
            self.engine.observe("regress",
                                sps / self.regress_baseline_sps,
                                step=self._pod.get("step"))

    # ------------------------------------------------------------ tick
    def tick(self, now: Optional[float] = None) -> None:
        """Time-based rule evaluation: per-host progress ages (stall)
        and the live straggler ratio from beacon-derived rates
        (:func:`live_rate`: the JAX package's, from
        :data:`MIN_RATE_BEACONS` beacons of one epoch on)."""
        now = self.clock() if now is None else now
        with self._lock:
            import statistics
            step_times = []
            for pi, h in self._hosts.items():
                age = max(0.0, now - h["last_progress"])
                h["age_s"] = age
                if self.stall_timeout_s > 0:
                    # the per-RUN stall window (--stall-timeout-s), not
                    # the env-only rules resolve: live and the watchdog
                    # must agree on when a host counts as wedged (0 =
                    # disabled, same contract as the watchdog)
                    self.engine.observe("stall", age, host=pi,
                                        step=h.get("step"),
                                        threshold=self.stall_timeout_s)
                r = live_rate(h["window"])
                if r and now - h["last_seen"] < self.window_s:
                    step_times.append(1.0 / r)
            if len(step_times) >= 2:
                med = statistics.median(step_times)
                if med > 0:
                    self.engine.observe("straggler",
                                        max(step_times) / med,
                                        step=self._pod.get("step"))
        self._rebuild()

    def _tick_loop(self, period: float) -> None:
        while not self._stop.wait(period):
            try:
                self.tick()
            except Exception:
                pass   # the view must never take down the run

    # ---------------------------------------------------------- status
    def _on_event(self, rec: Dict[str, Any]) -> None:
        """Alert transition fan-out: alerts.jsonl + the metrics stream
        (rank 0's buffered JSONL — the report CLI's Alerts section reads
        both) + an immediate forced status rewrite so the breach is on
        disk and scrapeable NOW, not at the next throttled write."""
        try:
            if self._alerts_fh is None:
                self._alerts_fh = open(self.alerts_path, "a")
            self._alerts_fh.write(json.dumps(rec, default=str) + "\n")
            self._alerts_fh.flush()
        except Exception:
            pass
        if self.metrics is not None:
            try:
                self.metrics.log(**rec)
            except Exception:
                pass
        self._rebuild(force_write=True)

    def _rebuild(self, force_write: bool = False) -> None:
        with self._lock:
            hosts = {}
            for pi, h in sorted(self._hosts.items()):
                hosts[str(pi)] = {
                    "step": h["step"], "epoch": h["epoch"],
                    "phase": h["phase"],
                    "steps_per_sec": h["window"].rate(),
                    "age_s": round(h.get("age_s", 0.0), 3),
                    "hbm_peak_bytes": h["hbm_peak_bytes"],
                    "staging_overlap_fraction":
                        h["staging_overlap_fraction"]}
            alerts = self.engine.snapshot()
            doc = {
                "schema": LIVE_SCHEMA_VERSION,
                "run_id": self.run_id,
                "requeue_attempt": self.requeue_attempt,
                "ts": self.wall(),
                "status": "alert" if alerts["firing"] else "ok",
                "pod": dict(self._pod,
                            steps_per_sec_window=self._pod_window.rate()),
                "hosts": hosts,
                "alerts": alerts,
                "counters": {"records": self.records,
                             "bad_frames": self.bad_frames},
            }
        self._status = doc
        now = self.clock()
        with self._write_lock:
            if force_write or now - self._last_write >= \
                    self.status_min_interval_s:
                self._last_write = now
                self._write_status(doc)

    def _write_status(self, doc: Dict[str, Any]) -> None:
        try:
            tmp = f"{self.status_path}.tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f, default=str)
            os.replace(tmp, self.status_path)
        except Exception:
            pass   # a full disk must not kill the aggregator

    def snapshot(self) -> Dict[str, Any]:
        """The last built status doc. LOCK-FREE by design (a wholesale-
        replaced reference): the exporter's scrape handler and the
        flight recorder's stall dump both read it while the run may be
        wedged — neither can afford to wait on the ingest lock."""
        return self._status

    # ------------------------------------------------------ networking
    def serve_ingest(self, host: str = "127.0.0.1",
                     port: int = 0) -> int:
        """Bind the ingest listener (TCP stream + UDP datagrams on the
        same port number) and start the accept/receive threads; returns
        the bound port (``port=0`` picks an ephemeral one)."""
        tcp = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        tcp.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        tcp.bind((host, port))
        tcp.listen(32)
        bound = tcp.getsockname()[1]
        udp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            udp.bind((host, bound))
        except OSError:
            udp = None
        self._servers += [s for s in (tcp, udp) if s is not None]
        t = threading.Thread(target=self._accept_loop, args=(tcp,),
                             name="tpudist-live-tcp", daemon=True)
        t.start()
        self._threads.append(t)
        if udp is not None:
            tu = threading.Thread(target=self._udp_loop, args=(udp,),
                                  name="tpudist-live-udp", daemon=True)
            tu.start()
            self._threads.append(tu)
        return bound

    def _accept_loop(self, tcp: socket.socket) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = tcp.accept()
            except OSError:
                return   # listener closed
            self._conns.append(conn)
            t = threading.Thread(target=self._conn_loop, args=(conn,),
                                 name="tpudist-live-conn", daemon=True)
            t.start()
            self._threads.append(t)

    def _conn_loop(self, conn: socket.socket) -> None:
        dec = FrameDecoder()
        try:
            while not self._stop.is_set():
                data = conn.recv(65536)
                if not data:
                    break
                for rec in dec.feed(data):
                    self.ingest(rec)
                self.bad_frames += dec.bad
                dec.bad = 0
        except Exception:
            pass
        finally:
            try:
                conn.close()
            except Exception:
                pass

    def _udp_loop(self, udp: socket.socket) -> None:
        while not self._stop.is_set():
            try:
                data, _ = udp.recvfrom(65536)
            except OSError:
                return
            dec = FrameDecoder()
            for rec in dec.feed(data):
                self.ingest(rec)
            self.bad_frames += dec.bad

    def close(self) -> None:
        """Final status write + teardown. Deliberately NO stall
        evaluation here: a run in orderly shutdown is not stalled."""
        self._stop.set()
        for s in self._servers:
            try:
                s.close()
            except Exception:
                pass
        # unblock the per-connection reader threads too: a thread parked
        # in recv() on a still-open worker connection would otherwise
        # eat its full join timeout below — shutdown must stay O(1), not
        # O(workers)
        for c in self._conns:
            try:
                c.close()
            except Exception:
                pass
        self._rebuild(force_write=True)
        if self._alerts_fh is not None:
            try:
                self._alerts_fh.close()
            except Exception:
                pass
            self._alerts_fh = None
        for t in self._threads:
            t.join(timeout=1.0)


# --------------------------------------------------- prometheus text

_PROM_HELP = {
    "tpudist_up": "Live aggregator is running.",
    "tpudist_info": "Run identity (labels carry run_id and attempt).",
    "tpudist_run_info": "Info-style run/attempt identity: join scrapes "
                        "from different requeue attempts of one run_id "
                        "on these labels.",
    "tpudist_step": "Last global step seen on the metrics stream.",
    "tpudist_epoch": "Last epoch seen on the metrics stream.",
    "tpudist_steps_per_sec": "Pod steps/s (last measured).",
    "tpudist_steps_per_sec_window": "Pod steps/s over the rolling "
                                    "window.",
    "tpudist_loss": "Last training loss.",
    "tpudist_staging_overlap_fraction": "Staging overlap fraction "
                                        "(1.0 = all H2D hidden).",
    "tpudist_exposed_comm_fraction": "Exposed-communication fraction "
                                     "of the device window.",
    "tpudist_dcn_bytes_total": "Per-step cross-slice (DCN) collective "
                               "bytes, derived from the lowered "
                               "program.",
    "tpudist_straggler_ratio": "Worst host step time over pod median.",
    "tpudist_goodput_fraction": "Attempt-local productive fraction of "
                                "wall clock (run-end estimate; the "
                                "cross-attempt ledger refines it).",
    "tpudist_hbm_bytes": "Per-device HBM bytes per memory-ledger "
                         "bucket (the partition sums to device HBM).",
    "tpudist_hbm_total_bytes": "Device HBM size the memory ledger "
                               "partitions.",
    "tpudist_hbm_headroom_fraction": "Unattributed free fraction of "
                                     "device HBM (obs.memledger).",
    "tpudist_memledger_exact": "1 when the ledger's watermark "
                               "reconciliation met the pinned "
                               "tolerance.",
    "tpudist_ckpt_last_enqueue_ms": "Last checkpoint enqueue cost.",
    "tpudist_ckpt_drain_ms": "Run-total checkpoint drain cost.",
    "tpudist_host_step": "Per-host last step from its heartbeat.",
    "tpudist_host_steps_per_sec": "Per-host rolling step rate.",
    "tpudist_host_progress_age_seconds": "Seconds since the host's "
                                         "step last advanced.",
    "tpudist_host_hbm_peak_bytes": "Per-host HBM high-water mark.",
    "tpudist_serve_queue_depth": "Requests waiting for a slot.",
    "tpudist_serve_active_slots": "Slots holding a live sequence.",
    "tpudist_serve_completed_total": "Requests completed so far.",
    "tpudist_serve_generated_tokens_total": "Tokens generated so far.",
    "tpudist_serve_ttft_p99_seconds": "p99 time-to-first-token.",
    "tpudist_serve_itl_p99_seconds": "p99 inter-token latency.",
    "tpudist_serve_tokens_per_sec_per_chip": "Decode throughput per "
                                             "chip.",
    "tpudist_serve_shed_total": "Arrivals turned away without service "
                                "(shed at admission + expired in "
                                "queue + rejected malformed).",
    "tpudist_serve_shed_fraction": "Shed share of all arrivals (the "
                                   "serve_shed gate's observable).",
    "tpudist_serve_adapt_level": "Graceful-degradation ladder level "
                                 "(0 = full service).",
    "tpudist_serve_kv_pages_used": "KV cache pages currently held "
                                   "(slots + shared-prefix registry).",
    "tpudist_serve_kv_pages_total": "KV cache pool capacity in pages.",
    "tpudist_serve_kv_shared_refs": "Refcounts currently held on the "
                                    "shared-prefix pages.",
    "tpudist_serve_spec_accept_rate": "Fraction of drafted tokens the "
                                      "target model accepted.",
    "tpudist_serve_ttft_seconds": "Time-to-first-token distribution "
                                  "(native histogram, fixed buckets).",
    "tpudist_serve_itl_seconds": "Inter-token latency distribution "
                                 "(native histogram, fixed buckets).",
    "tpudist_alert_firing": "1 while the named alert rule fires.",
    "tpudist_alerts_total": "Alert fire/resolve transitions so far.",
    "tpudist_records_total": "Telemetry records ingested.",
    "tpudist_bad_frames_total": "Undecodable frames dropped.",
}


def _prom_escape(v: Any) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace(
        "\n", r"\n")


def _prom_num(v: Any) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return f"{f:.10g}"


def prometheus_text(status: Dict[str, Any]) -> str:
    """Render a status doc (:meth:`LiveAggregator.snapshot`) as
    Prometheus text exposition format (version 0.0.4). Pure function —
    the golden test pins the exact output for a scripted status."""
    out: List[str] = []

    def metric(name: str, samples: List[Tuple[Dict[str, str], Any]],
               mtype: str = "gauge") -> None:
        rows = [(lbl, v) for lbl, v in samples if v is not None]
        if not rows:
            return
        out.append(f"# HELP {name} {_PROM_HELP[name]}")
        out.append(f"# TYPE {name} {mtype}")
        for lbl, v in rows:
            label_s = ",".join(f'{k}="{_prom_escape(x)}"'
                               for k, x in lbl.items())
            out.append(f"{name}{{{label_s}}} {_prom_num(v)}"
                       if label_s else f"{name} {_prom_num(v)}")

    def hist(name: str, h: Any) -> None:
        # a native histogram family from the self-describing hist
        # record the serve loop ships on every tick (per-bucket counts
        # + overflow bin; cumulated HERE into le= rows, the exposition
        # format's convention). A malformed or absent record renders
        # nothing — same None-skipping posture as metric()
        if not isinstance(h, dict):
            return
        buckets, counts = h.get("buckets"), h.get("counts")
        if (not isinstance(buckets, list) or not isinstance(counts, list)
                or len(counts) != len(buckets) + 1):
            return
        out.append(f"# HELP {name} {_PROM_HELP[name]}")
        out.append(f"# TYPE {name} histogram")
        cum = 0
        for ub, c in zip(buckets, counts):
            cum += int(c)
            out.append(f'{name}_bucket{{le="{_prom_num(ub)}"}} {cum}')
        cum += int(counts[-1])
        out.append(f'{name}_bucket{{le="+Inf"}} {cum}')
        out.append(f"{name}_sum {_prom_num(h.get('sum', 0.0))}")
        out.append(f"{name}_count {cum}")

    pod = status.get("pod", {})
    hosts = status.get("hosts", {})
    alerts = status.get("alerts", {})
    counters = status.get("counters", {})
    metric("tpudist_up", [({}, 1)])
    metric("tpudist_info", [({"run_id": status.get("run_id") or "",
                              "requeue_attempt":
                                  str(status.get("requeue_attempt", 0))},
                             1)])
    # the info-style join key for cross-attempt dashboards: scrapes
    # from different requeue attempts of one run_id join on exactly
    # these labels (tpudist_info predates it and stays for compat)
    metric("tpudist_run_info",
           [({"run_id": status.get("run_id") or "",
              "requeue_attempt":
                  str(status.get("requeue_attempt", 0))}, 1)])
    metric("tpudist_step", [({}, pod.get("step"))])
    metric("tpudist_epoch", [({}, pod.get("epoch"))])
    metric("tpudist_steps_per_sec", [({}, pod.get("steps_per_sec"))])
    metric("tpudist_steps_per_sec_window",
           [({}, pod.get("steps_per_sec_window"))])
    metric("tpudist_loss", [({}, pod.get("loss"))])
    metric("tpudist_staging_overlap_fraction",
           [({}, pod.get("staging_overlap_fraction"))])
    metric("tpudist_exposed_comm_fraction",
           [({}, pod.get("exposed_comm_frac"))])
    metric("tpudist_dcn_bytes_total",
           [({}, pod.get("dcn_bytes_total"))])
    metric("tpudist_straggler_ratio",
           [({}, pod.get("straggler_ratio"))])
    metric("tpudist_goodput_fraction",
           [({}, pod.get("goodput_fraction"))])
    ml = pod.get("memledger") or {}
    metric("tpudist_hbm_bytes",
           [({"bucket": b}, (ml.get("buckets") or {}).get(b))
            for b in ("params", "opt_state", "slabs", "kv_pool",
                      "program_temp", "headroom", "residue")])
    metric("tpudist_hbm_total_bytes", [({}, ml.get("total_hbm_bytes"))])
    metric("tpudist_hbm_headroom_fraction",
           [({}, ml.get("headroom_fraction"))])
    metric("tpudist_memledger_exact",
           [({}, (1 if ml.get("exact") else 0) if ml else None)])
    metric("tpudist_ckpt_last_enqueue_ms",
           [({}, pod.get("ckpt_last_enqueue_ms"))])
    metric("tpudist_ckpt_drain_ms", [({}, pod.get("ckpt_drain_ms"))])
    metric("tpudist_host_step",
           [({"host": pi}, h.get("step")) for pi, h in hosts.items()])
    metric("tpudist_host_steps_per_sec",
           [({"host": pi}, h.get("steps_per_sec"))
            for pi, h in hosts.items()])
    metric("tpudist_host_progress_age_seconds",
           [({"host": pi}, h.get("age_s")) for pi, h in hosts.items()])
    metric("tpudist_host_hbm_peak_bytes",
           [({"host": pi}, h.get("hbm_peak_bytes"))
            for pi, h in hosts.items()])
    sv = pod.get("serve") or {}
    metric("tpudist_serve_queue_depth", [({}, sv.get("queue_depth"))])
    metric("tpudist_serve_active_slots",
           [({}, sv.get("active_slots"))])
    metric("tpudist_serve_completed_total", [({}, sv.get("completed"))],
           mtype="counter")
    metric("tpudist_serve_generated_tokens_total",
           [({}, sv.get("generated_tokens"))], mtype="counter")
    metric("tpudist_serve_ttft_p99_seconds",
           [({}, sv.get("ttft_p99_s"))])
    metric("tpudist_serve_itl_p99_seconds", [({}, sv.get("itl_p99_s"))])
    metric("tpudist_serve_tokens_per_sec_per_chip",
           [({}, sv.get("tokens_per_sec_per_chip"))])
    metric("tpudist_serve_shed_total", [({}, sv.get("shed_total"))],
           mtype="counter")
    metric("tpudist_serve_shed_fraction",
           [({}, sv.get("shed_fraction"))])
    metric("tpudist_serve_adapt_level", [({}, sv.get("adapt_level"))])
    metric("tpudist_serve_kv_pages_used",
           [({}, sv.get("kv_pages_used"))])
    metric("tpudist_serve_kv_pages_total",
           [({}, sv.get("kv_pages_total"))])
    metric("tpudist_serve_kv_shared_refs",
           [({}, sv.get("kv_shared_refs"))])
    metric("tpudist_serve_spec_accept_rate",
           [({}, sv.get("spec_accept_rate"))])
    hist("tpudist_serve_ttft_seconds", sv.get("ttft_hist"))
    hist("tpudist_serve_itl_seconds", sv.get("itl_hist"))
    # one series per alert RULE: 1 when any (rule, host) key fires —
    # a fixed label set scrapers can alert on without knowing hosts
    firing_rules = {a["alert"] for a in alerts.get("firing", [])}
    metric("tpudist_alert_firing",
           [({"alert": r.name}, 1 if r.name in firing_rules else 0)
            for r in rules_lib.ALERT_RULES])
    metric("tpudist_alerts_total", [({}, alerts.get("events", 0))],
           mtype="counter")
    metric("tpudist_records_total", [({}, counters.get("records", 0))],
           mtype="counter")
    metric("tpudist_bad_frames_total",
           [({}, counters.get("bad_frames", 0))], mtype="counter")
    return "\n".join(out) + "\n"


# -------------------------------------------------------- http exporter


class LiveHttpServer:
    """Stdlib HTTP front of the aggregator: ``/metrics`` (Prometheus
    text format), ``/status.json`` (the raw snapshot — the tail CLI's
    source), ``/healthz``. Handlers read only
    :meth:`LiveAggregator.snapshot` — no lock shared with ingest."""

    def __init__(self, aggregator: LiveAggregator, *, port: int = 0,
                 host: str = "127.0.0.1"):
        import http.server

        agg = aggregator

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):   # noqa: N802 (stdlib API name)
                if self.path.split("?")[0] in ("/metrics", "/metrics/"):
                    body = prometheus_text(agg.snapshot()).encode()
                    ctype = ("text/plain; version=0.0.4; "
                             "charset=utf-8")
                elif self.path.split("?")[0] == "/status.json":
                    body = json.dumps(agg.snapshot(),
                                      default=str).encode()
                    ctype = "application/json"
                elif self.path.split("?")[0] == "/healthz":
                    body = b'{"ok": true}'
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):   # scrapes must not spam stdout
                pass

        self._server = http.server.ThreadingHTTPServer((host, port),
                                                       Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self.host = host
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="tpudist-live-http", daemon=True)
        self._thread.start()

    def close(self) -> None:
        try:
            self._server.shutdown()
            self._server.server_close()
        except Exception:
            pass
        self._thread.join(timeout=2.0)


# ------------------------------------------------------------- run id


def resolve_run_id(process_count: int = 1) -> str:
    """``$TPUDIST_RUN_ID`` when the launcher set one (cut to 64
    characters; the same id then spans every requeue attempt), else rank
    0's ``uuid4().hex[:12]``, gathered over the host gloo group so every
    process stamps the same id. One process makes no collective."""
    rid = os.environ.get("TPUDIST_RUN_ID")
    if rid:
        return rid.strip()[:64]
    rid = uuid.uuid4().hex[:12]
    if process_count <= 1:
        return rid
    ids: List[Any] = [None] * process_count
    dist.all_gather_object(ids, rid, group=distributed.host_group())
    return ids[0]


# ------------------------------------------------------------ run facade


class LiveRun:
    """The train loop's one live-telemetry handle: the coordinator gets
    the aggregator + HTTP exporter, every process gets an emitter back
    to the coordinator. ``--live off`` never constructs one — the
    disabled path is the absence of this object."""

    def __init__(self, *, aggregator: Optional[LiveAggregator] = None,
                 exporter: Optional[LiveHttpServer] = None,
                 emitter: Optional[TelemetryEmitter] = None,
                 endpoint: Optional[str] = None):
        self.aggregator = aggregator
        self.exporter = exporter
        self.emitter = emitter
        self.endpoint = endpoint

    @classmethod
    def start(cls, *, is_coordinator: bool, process_index: int,
              out_dir: str, run_id: Optional[str] = None,
              requeue_attempt: int = 0, port: int = 0,
              endpoint: Optional[str] = None,
              stall_timeout_s: Optional[float] = None,
              metrics: Any = None) -> "LiveRun":
        """Wire this process's live pieces. With no explicit endpoint
        (single-host runs, CI) the coordinator binds loopback on an
        ephemeral port and talks to itself — the SAME socket path a pod
        exercises, not a shortcut. The launcher passes
        ``TPUDIST_LIVE_ENDPOINT=<coordinator>:<port>`` so workers on
        other hosts reach the aggregator; the coordinator then binds
        all interfaces on that port."""
        aggregator = exporter = emitter = None
        if is_coordinator:
            aggregator = LiveAggregator(
                out_dir=out_dir, run_id=run_id,
                requeue_attempt=requeue_attempt,
                stall_timeout_s=stall_timeout_s, metrics=metrics)
            bind_host, bind_port = "127.0.0.1", 0
            if endpoint:
                _, (_, bind_port) = parse_endpoint(endpoint)
                bind_host = "0.0.0.0"
            actual = aggregator.serve_ingest(host=bind_host,
                                             port=bind_port)
            exporter = LiveHttpServer(
                aggregator, port=port,
                host="0.0.0.0" if endpoint else "127.0.0.1")
            if not endpoint:
                endpoint = f"127.0.0.1:{actual}"
        if endpoint:
            emitter = TelemetryEmitter(endpoint)
        return cls(aggregator=aggregator, exporter=exporter,
                   emitter=emitter, endpoint=endpoint)

    def emit(self, rec: Dict[str, Any]) -> None:
        if self.emitter is not None:
            self.emitter.emit(rec)

    def snapshot_fields(self) -> Optional[Dict[str, Any]]:
        """The aggregator's last rolling-window snapshot, for the
        flight recorder's pre-kill dump (lock-free — see
        :meth:`LiveAggregator.snapshot`); None off-coordinator."""
        if self.aggregator is None:
            return None
        return self.aggregator.snapshot()

    def close(self, drain_s: float = 1.0) -> None:
        """Emitter drain first (its tail records must reach the
        aggregator), then a short settle for in-flight frames, then the
        aggregator's final status write. Every wait is bounded: run
        exit must not hang on telemetry."""
        if self.emitter is not None:
            self.emitter.close(drain_s=drain_s)
        if self.aggregator is not None:
            deadline = time.monotonic() + drain_s
            seen = -1
            while time.monotonic() < deadline:
                n = self.aggregator.records
                if n == seen:
                    break
                seen = n
                time.sleep(0.05)
            self.aggregator.close()
        if self.exporter is not None:
            self.exporter.close()
