"""The port's live telemetry bus (``tpudist_torch.obs.live``) against the
JAX package's (``tpudist.obs.live``): the frame codec byte for byte,
each decoder on the other's frames through seeded garbage, the emitter
over loopback TCP and UDP into both packages' aggregators (the same
``alerts.jsonl`` and ``live_status.json``, timestamps aside), the
Prometheus text, the HTTP exporter's endpoints, the JAX ``tail`` CLI
over the port's status, and the copies' code pinned to their sources.
Ports are bound at 0 only."""

import ast
import inspect
import json
import socket
import textwrap
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tpudist.obs import live as jlive
from tpudist_torch.obs import live as tlive

torch.set_num_threads(1)


def _code(obj) -> str:
    """``obj``'s AST without docstrings: the copies keep the JAX code and
    may word their docstrings for the port."""
    tree = ast.parse(inspect.getsource(obj).lstrip())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.FunctionDef, ast.ClassDef,
                              ast.AsyncFunctionDef)) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


PINNED = ("encode_frame", "FrameDecoder", "parse_endpoint",
          "TelemetryEmitter", "RollingWindow", "_prom_escape", "_prom_num",
          "prometheus_text", "LiveHttpServer", "LiveRun")
AGG_METHODS = ("__init__", "ingest", "_ingest_locked", "_ingest_heartbeat",
               "_observe_rate", "tick", "_tick_loop", "_on_event",
               "_rebuild", "_write_status", "snapshot", "serve_ingest",
               "_accept_loop", "_conn_loop", "_udp_loop", "close")


@pytest.mark.parametrize("name", PINNED)
def test_copies_pinned_to_their_sources(name):
    assert _code(getattr(tlive, name)) == _code(getattr(jlive, name)), name


# the port's one change to the JAX aggregator: tick's live straggler
# ratio takes a host's rate through live_rate (enough beacons, no reset)
PORT_EDITS = {"tick": (
    """                r = h["window"].rate()
                if r and r > 0 and now - h["last_seen"] < self.window_s:""",
    """                r = live_rate(h["window"])
                if r and now - h["last_seen"] < self.window_s:""")}


def _jax_code(method) -> str:
    """The JAX method's code with the port's edit of it applied."""
    src = inspect.getsource(getattr(jlive.LiveAggregator, method))
    if method in PORT_EDITS:
        old, new = PORT_EDITS[method]
        assert src.count(old) == 1, method
        src = src.replace(old, new)
    tree = ast.parse(textwrap.dedent(src))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.FunctionDef, ast.ClassDef,
                              ast.AsyncFunctionDef)) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("method", AGG_METHODS)
def test_aggregator_pinned_method_by_method(method):
    """Every method is the JAX code, ``tick`` with the port's one edit
    (:data:`PORT_EDITS`)."""
    assert _code(getattr(tlive.LiveAggregator, method)) == _jax_code(
        method), method


def test_live_rate_needs_enough_beacons_of_one_epoch(tmp_path):
    """The live straggler ratio's rate: None under MIN_RATE_BEACONS
    stepped beacons or across a reset of the step counter, else the
    window's rate (two lockstep ranks' 3-beacon rates no longer make a
    ratio)."""
    n = tlive.MIN_RATE_BEACONS
    w = tlive.RollingWindow(60.0)
    for i in range(n - 1):
        w.add(2.0 * i, 5.0 * i)
    assert tlive.live_rate(w) is None and w.rate() == 2.5
    w.add(2.0 * (n - 1), 5.0 * (n - 1))
    assert tlive.live_rate(w) == w.rate() == 2.5
    w.add(2.0 * n, 1.0)   # the next epoch's first step
    assert tlive.live_rate(w) is None
    agg = tlive.LiveAggregator(out_dir=str(tmp_path), window_s=60.0,
                               start_ticker=False, clock=lambda: 100.0)
    for t, (a, b) in enumerate(((1, 1), (3, 6), (6, 12))):
        agg.ingest({"kind": "heartbeat", "process_index": 0, "step": a},
                   now=2.0 * t)
        agg.ingest({"kind": "heartbeat", "process_index": 1, "step": b},
                   now=2.0 * t + 0.5)
    agg.tick(now=5.0)
    jagg = jlive.LiveAggregator(out_dir=str(tmp_path / "j"), window_s=60.0,
                                start_ticker=False, clock=lambda: 100.0)
    for t, (a, b) in enumerate(((1, 1), (3, 6), (6, 12))):
        jagg.ingest({"kind": "heartbeat", "process_index": 0, "step": a},
                    now=2.0 * t)
        jagg.ingest({"kind": "heartbeat", "process_index": 1, "step": b},
                    now=2.0 * t + 0.5)
    jagg.tick(now=5.0)
    # the JAX aggregator reads a ratio of 1.375 from three beacons a rank
    assert "straggler" in {a["alert"] for a in jagg.engine.history}
    jagg.close()
    assert "straggler" not in {a["alert"] for a in agg.engine.history}
    agg.close()


def test_wire_constants_and_help_equal():
    assert (tlive.FRAME_MAGIC, tlive.MAX_FRAME_BYTES, tlive._HEADER,
            tlive.DEFAULT_QUEUE_SLOTS) == (
        jlive.FRAME_MAGIC, jlive.MAX_FRAME_BYTES, jlive._HEADER,
        jlive.DEFAULT_QUEUE_SLOTS)
    assert tlive._PROM_HELP == jlive._PROM_HELP
    # the exporter's tpudist_alert_firing family: one series a rule
    assert [r.name for r in tlive.rules_lib.ALERT_RULES] == [
        r.name for r in jlive.rules_lib.ALERT_RULES]


def _records(seed: int, n: int = 24):
    """Seeded records of the shapes the bus carries."""
    rng = np.random.default_rng(seed)
    kinds = ("heartbeat", "step", "epoch", "timing", "serve_tick",
             "hosts", "ckpt")
    out = []
    for i in range(n):
        rec = {"kind": kinds[int(rng.integers(len(kinds)))], "step": i,
               "process_index": int(rng.integers(2)),
               "loss": float(rng.normal()),
               "steps_per_sec": float(rng.uniform(0.5, 9.0)),
               "phase": ["train", "eval", "ckpt"][int(rng.integers(3))],
               "progress_n": i, "run_id": "bus-parity",
               "note": "é" * int(rng.integers(4))}
        if rng.uniform() < 0.3:
            rec["blob"] = [float(x) for x in rng.normal(size=8)]
        out.append(rec)
    return out


def test_encode_frame_bytes_equal_jax():
    for rec in _records(0):
        assert tlive.encode_frame(rec) == jlive.encode_frame(rec)


def _stream(encode, seed: int):
    """Frames of seeded records with seeded garbage between them (some of
    it a chance marker, some a torn frame), cut into seeded chunks."""
    rng = np.random.default_rng(seed)
    recs = _records(seed)
    buf = b""
    for rec in recs:
        r = rng.uniform()
        if r < 0.25:
            buf += rng.bytes(int(rng.integers(1, 40)))
        elif r < 0.35:
            buf += tlive.FRAME_MAGIC + rng.bytes(int(rng.integers(1, 12)))
        elif r < 0.45:
            buf += encode({"kind": "torn", "x": 1})[:-3]
        buf += encode(rec)
    cuts = sorted(rng.integers(0, len(buf), size=30).tolist())
    chunks, prev = [], 0
    for c in cuts + [len(buf)]:
        chunks.append(buf[prev:c])
        prev = c
    return recs, chunks


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_each_decoder_reads_the_others_frames_through_garbage(seed):
    for encode in (tlive.encode_frame, jlive.encode_frame):
        recs, chunks = _stream(encode, seed)
        got = {}
        for name, dec in (("port", tlive.FrameDecoder()),
                          ("jax", jlive.FrameDecoder())):
            out = []
            for c in chunks:
                out += dec.feed(c)
            got[name] = (out, dec.bad)
        assert got["port"] == got["jax"]
        assert got["port"][0] == [r for r in recs]
        assert got["port"][1] >= 1


def test_parse_endpoint_equal_jax():
    for ep in ("127.0.0.1:9100", "tcp://h:1", "udp://10.0.0.2:7", ":5"):
        assert tlive.parse_endpoint(ep) == jlive.parse_endpoint(ep)
    for bad in ("http://h:1", "host", "h:x"):
        for mod in (tlive, jlive):
            with pytest.raises(ValueError):
                mod.parse_endpoint(bad)


def _script():
    """A record stream that moves the aggregator's state and fires
    alerts: beacons of two hosts, steps, a serve tick over the TTFT gate,
    a watchdog's stall dump."""
    recs = [{"kind": "heartbeat", "process_index": pi, "step": s,
             "epoch": 0, "phase": "train", "progress_n": s,
             "hbm_peak_bytes": 1000 + s}
            for s in range(3) for pi in (0, 1)]
    recs += [{"kind": "step", "step": s, "epoch": 0, "loss": 1.0 / (s + 1),
              "steps_per_sec": 4.0 + s} for s in range(3)]
    recs += [{"kind": "serve_tick", "queue_depth": 3, "active_slots": 2,
              "completed": 5, "generated_tokens": 40, "ttft_p99_s": 9.5,
              "itl_p99_s": 0.01, "tokens_per_sec_per_chip": 50.0,
              "shed_fraction": 0.0,
              "ttft_hist": {"buckets": [0.1, 1.0], "counts": [1, 2, 3],
                            "sum": 4.5}},
             {"kind": "stall_dump", "process_index": 1, "stall_s": 7.5,
              "step": 2, "reason": "stall"},
             {"kind": "epoch", "epoch": 0, "avg_loss": 0.5,
              "steps_per_sec": 5.0}]
    return recs


def _aggregator(mod, out_dir):
    return mod.LiveAggregator(out_dir=str(out_dir), run_id="bus-parity",
                              stall_timeout_s=5.0, start_ticker=False,
                              status_min_interval_s=0.0,
                              clock=lambda: 100.0, wall=lambda: 1000.0)


def _wait(agg, n: int, timeout_s: float = 10.0) -> None:
    deadline = time.monotonic() + timeout_s
    while agg.records < n and time.monotonic() < deadline:
        time.sleep(0.02)
    assert agg.records == n, (agg.records, n)


def _files(d):
    alerts = [{k: v for k, v in json.loads(line).items()
               if k not in ("first_ts", "last_ts")}
              for line in (d / "alerts.jsonl").read_text().splitlines()]
    status = json.loads((d / "live_status.json").read_text())
    status.pop("ts")
    for a in status["alerts"]["firing"] + status["alerts"]["history"]:
        a.pop("first_ts", None)
        a.pop("last_ts", None)
    return alerts, status


@pytest.mark.parametrize("transport", ["tcp", "udp"])
def test_emitter_to_both_aggregators_over_loopback(transport, tmp_path):
    """The port's emitter ships the scripted stream over loopback to the
    port's aggregator and to the JAX one (each listening on port 0): the
    two write the same alerts.jsonl and live_status.json, timestamps
    aside, with the TTFT and stall alerts firing and every frame
    decoded."""
    recs = _script()
    aggs = {}
    for name, mod in (("port", tlive), ("jax", jlive)):
        agg = aggs[name] = _aggregator(mod, tmp_path / name)
        port = agg.serve_ingest(port=0)
        em = tlive.TelemetryEmitter(f"{transport}://127.0.0.1:{port}")
        for rec in recs:
            em.emit(rec)
            if transport == "udp":
                time.sleep(0.002)
        em.close(drain_s=5.0)
        assert em.stats()["sent"] == len(recs) and em.dropped == 0
        _wait(agg, len(recs))
        agg.close()
    port_files, jax_files = (_files(tmp_path / n) for n in ("port", "jax"))
    assert port_files == jax_files
    alerts, status = port_files
    assert {(a["alert"], a["state"]) for a in alerts} >= {
        ("ttft", "firing"), ("stall", "firing")}
    assert status["counters"] == {"records": len(recs), "bad_frames": 0}
    assert sorted(status["hosts"]) == ["0", "1"]
    assert status["status"] == "alert"


def test_garbage_on_the_socket_counts_bad_frames(tmp_path):
    """``inject_garbage`` ships raw bytes between frames: the aggregator's
    decoder resynchronises, counts them, and ingests every record."""
    agg = _aggregator(tlive, tmp_path)
    port = agg.serve_ingest(port=0)
    em = tlive.TelemetryEmitter(f"127.0.0.1:{port}")
    em.emit({"kind": "step", "step": 1})
    em.inject_garbage(np.random.default_rng(7).bytes(64))
    em.emit({"kind": "step", "step": 2})
    em.close(drain_s=5.0)
    _wait(agg, 2)
    agg.close()
    status = json.loads((tmp_path / "live_status.json").read_text())
    assert status["counters"]["bad_frames"] >= 1
    assert status["pod"]["step"] == 2 and status["status"] == "ok"


def test_emitter_drops_and_never_blocks(tmp_path):
    """A dead endpoint costs dropped records, never a blocked caller; a
    full queue drops at once."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead = s.getsockname()[1]
    s.close()
    em = tlive.TelemetryEmitter(f"127.0.0.1:{dead}", queue_slots=2,
                                retry_s=0.05)
    t0 = time.monotonic()
    for i in range(50):
        em.emit({"kind": "step", "step": i})
    assert time.monotonic() - t0 < 0.5
    em.close(drain_s=0.5)
    assert em.dropped >= 48 and em.sent == 0


def _status_doc(tmp_path):
    agg = _aggregator(tlive, tmp_path)
    for rec in _script():
        agg.ingest(rec)
    agg.ingest({"kind": "memledger", "total_hbm_bytes": 80e9,
                "headroom_fraction": 0.5, "exact": True,
                "params_bytes": 10, "kv_pool_bytes": 5})
    agg.ingest({"kind": "devtime", "exposed_comm_frac": 0.1,
                "fabric": "ici", "dcn_bytes_total": 0})
    return agg


def test_prometheus_text_equal_jax(tmp_path):
    agg = _status_doc(tmp_path)
    doc = agg.snapshot()
    text = tlive.prometheus_text(doc)
    assert text == jlive.prometheus_text(doc)
    for series in ("tpudist_up 1", "tpudist_steps_per_sec 5",
                   'tpudist_alert_firing{alert="ttft"} 1',
                   "tpudist_serve_ttft_seconds_bucket",
                   'tpudist_hbm_bytes{bucket="params"} 10',
                   "tpudist_bad_frames_total 0"):
        assert series in text, series
    agg.close()


def test_http_exporter_endpoints_and_the_jax_tail(tmp_path, capsys):
    """``/metrics``, ``/status.json`` and ``/healthz`` from the last
    snapshot (404 elsewhere); the JAX ``tail`` CLI renders the port's
    ``/status.json`` and its ``live_status.json`` file as they are."""
    agg = _status_doc(tmp_path)
    server = tlive.LiveHttpServer(agg, port=0)
    base = f"http://127.0.0.1:{server.port}"
    try:
        with urllib.request.urlopen(base + "/metrics", timeout=5) as r:
            assert r.headers["Content-Type"].startswith("text/plain")
            assert r.read().decode() == tlive.prometheus_text(
                agg.snapshot())
        with urllib.request.urlopen(base + "/status.json", timeout=5) as r:
            status = json.loads(r.read())
        assert status == json.loads(json.dumps(agg.snapshot(),
                                               default=str))
        with urllib.request.urlopen(base + "/healthz", timeout=5) as r:
            assert json.loads(r.read()) == {"ok": True}
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nope", timeout=5)
        assert jlive.main(["tail", "--url", base + "/status.json",
                           "--once"]) == 0
        out = capsys.readouterr().out
        assert out.strip() == jlive.render_status(status)
        assert "[ttft]" in out and "ALERTS FIRING" in out
    finally:
        server.close()
        agg.close()
    assert jlive.main(["tail", "--status",
                       str(tmp_path / tlive.STATUS_NAME), "--once"]) == 0
    assert "tpudist live · run bus-parity" in capsys.readouterr().out


def test_live_run_loops_back_and_closes_everything(tmp_path):
    """``LiveRun.start`` on the coordinator with no endpoint: the
    aggregator, the exporter and an emitter looped back over an
    ephemeral port; ``close`` drains within its bound and takes every
    socket and thread down."""
    import threading
    before = {t.name for t in threading.enumerate()}
    live = tlive.LiveRun.start(is_coordinator=True, process_index=0,
                               out_dir=str(tmp_path), run_id="loop",
                               stall_timeout_s=0)
    assert live.endpoint.startswith("127.0.0.1:")
    for i in range(5):
        live.emit({"kind": "step", "step": i, "steps_per_sec": 2.0})
    t0 = time.monotonic()
    live.close(drain_s=2.0)
    assert time.monotonic() - t0 < 10.0
    assert live.aggregator.records == 5
    leftover = {t.name for t in threading.enumerate()
                if t.name.startswith("tpudist-live")} - before
    assert not leftover
    status = json.loads((tmp_path / tlive.STATUS_NAME).read_text())
    assert status["pod"]["step"] == 4 and status["status"] == "ok"
