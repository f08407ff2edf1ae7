"""The live telemetry bus through the port's CLIs on the CPU: the train
CLI with ``--live on`` in one process (its exporter scraped while it
runs) and in two gloo ranks (a heartbeat from each on the coordinator's
aggregator), ``--live off`` opening no socket and starting no thread of
the bus, a wedged step under ``--stall-timeout-s`` firing the mid-run
stall alert and the stall hook, and the serve CLI's exporter scraped
while it serves. Ports come from ``_torch_ranks.free_port``: below the
kernel's ephemeral range, a block a pytest-xdist worker."""

import contextlib
import json
import os
import socket
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path
from unittest import mock

import pytest
import torch

from tpudist_torch import train as ttrain
from tpudist_torch.obs import devtime as tdev
from tpudist_torch.obs import live as tlive
from tpudist_torch.serve import cli as tserve
from _torch_ranks import free_port as _free_port

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
ARGV = ["--device", "cpu", "--epochs", "2", "--n-samples", "512",
        "--log-every", "4"]



@contextlib.contextmanager
def _scraper(port, paths):
    """GET ``paths`` from the exporter every 50 ms while the block runs;
    yields ``{path: [bodies]}``."""
    got = {p: [] for p in paths}
    stop = threading.Event()

    def loop():
        while not stop.wait(0.05):
            for p in paths:
                try:
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{port}{p}", timeout=2) as r:
                        got[p].append(r.read().decode())
                except OSError:
                    pass
    t = threading.Thread(target=loop, daemon=True)
    t.start()
    try:
        yield got
    finally:
        stop.set()
        t.join(timeout=5)


@pytest.fixture
def quiet_goodput(monkeypatch):
    """A tiny CPU run is start-up dominated: the goodput floor would fire
    its alert and the live status would end ``alert`` for a reason that
    is not the bus's (the drills set the same floor)."""
    monkeypatch.setenv("TPUDIST_GOODPUT_MIN", "0.00001")


def test_train_cli_live_on_one_process(tmp_path, capsys, quiet_goodput):
    port = _free_port()
    with _scraper(port, ("/healthz", "/metrics")) as got:
        assert ttrain.main(ARGV + ["--live", "on", "--live-port", str(port),
                                   "--save-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert f"Prometheus /metrics on :{port}" in out
    assert "tpudist: live ok: " in out and "Training completed." in out
    assert got["/healthz"] and all(json.loads(b) == {"ok": True}
                                   for b in got["/healthz"])
    assert any("\ntpudist_step " in b for b in got["/metrics"])
    status = json.loads((tmp_path / tlive.STATUS_NAME).read_text())
    recs = [json.loads(ln) for ln in (tmp_path / "metrics.jsonl")
            .read_text().splitlines()]
    assert status["status"] == "ok"
    assert status["counters"]["bad_frames"] == 0
    assert status["counters"]["records"] >= len(recs)
    assert list(status["hosts"]) == ["0"]
    assert status["run_id"] == recs[0]["run_id"]
    assert status["pod"]["timing_seen"]


def test_train_cli_live_on_two_gloo_ranks(tmp_path):
    """Two ranks with ``--live-endpoint`` (the launcher's way of naming
    the coordinator's ingest): the coordinator's aggregator hears a
    heartbeat from each rank and ends ``ok``; every rank's verdict is
    success."""
    port, ingest = _free_port(), _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, TPUDIST_COORDINATOR=f"127.0.0.1:{port}",
                   TPUDIST_NUM_PROCESSES="2", TPUDIST_PROCESS_ID=str(rank),
                   TPUDIST_GOODPUT_MIN="0.00001", OMP_NUM_THREADS="1",
                   PYTHONPATH=str(REPO),
                   TPUDIST_VERDICT_PATH=str(tmp_path / "job_status.txt"))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tpudist_torch.train", *ARGV,
             "--epochs", "3", "--live", "on", "--live-endpoint",
             f"tcp://127.0.0.1:{ingest}", "--stall-timeout-s", "8",
             "--save-dir", str(tmp_path)], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=240)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs[0][-2000:]
    assert "tpudist: live ok: " in outs[0]
    assert "tpudist: live" not in outs[1]
    status = json.loads((tmp_path / tlive.STATUS_NAME).read_text())
    assert status["status"] == "ok", status["alerts"]
    assert sorted(status["hosts"]) == ["0", "1"]
    assert (tmp_path / "job_status.txt").read_text() == "success"


def test_live_off_opens_no_socket_and_starts_no_thread(tmp_path,
                                                       monkeypatch):
    """The default (``--live off``, ``TPUDIST_LIVE`` unset) constructs
    none of the bus: no socket, no live thread, no emitter on the
    metrics stream."""
    monkeypatch.delenv("TPUDIST_LIVE", raising=False)
    sockets, threads, loggers = [], [], []
    real_socket, real_start = socket.socket, threading.Thread.start

    class Socket(real_socket):
        def __init__(self, *a, **kw):
            sockets.append(a)
            super().__init__(*a, **kw)

    def start(self):
        threads.append(self.name)
        return real_start(self)
    real_log = ttrain.MetricsLogger.log

    def log(self, **kv):
        loggers.append(self.emitter)
        return real_log(self, **kv)
    with mock.patch.object(socket, "socket", Socket), \
            mock.patch.object(threading.Thread, "start", start), \
            mock.patch.object(ttrain.MetricsLogger, "log", log):
        assert ttrain.main(ARGV + ["--save-dir", str(tmp_path)]) == 0
    assert sockets == []
    assert threads and not [t for t in threads if "live" in t]
    assert loggers and all(e is None for e in loggers)
    assert not (tmp_path / tlive.STATUS_NAME).exists()


def test_a_wedged_step_fires_the_stall_alert_and_the_hook(tmp_path,
                                                          capsys,
                                                          quiet_goodput):
    """A step held 1.5 s (the chaos plane's ``slow``) under a 0.5 s
    watchdog, with the bus on and a capture window open: the watchdog's
    stall dump reaches the aggregator as a mid-run ``stall`` alert
    (``alerts.jsonl``), its hook marks the window lost (the flight record
    says why: the profiler stops only on its own thread), the run goes on
    to exit 0 and resolves the alert, and no devtime record claims a
    capture."""
    assert ttrain.main(ARGV + [
        "--epochs", "1", "--live", "on", "--stall-timeout-s", "0.5",
        "--profile-window", "100", "--chaos", "slow@0:3,s=1.5,steps=1",
        "--save-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "the capture was lost" in out
    alerts = [json.loads(ln) for ln in (tmp_path / tlive.ALERTS_NAME)
              .read_text().splitlines()]
    assert ("stall", "firing") in {(a["alert"], a["state"]) for a in alerts}
    flight = json.loads((tmp_path / "flightrec.worker0").read_text())
    assert flight["reason"] == "stall"
    assert flight["extra"]["profile_capture_lost"] == tdev.LOST_ON_WATCHDOG
    recs = [json.loads(ln) for ln in (tmp_path / "metrics.jsonl")
            .read_text().splitlines()]
    assert [r for r in recs if r["kind"] == "stall_dump"]
    assert not [r for r in recs if r["kind"] == "devtime"]
    assert [r["comm_status"] for r in recs if r["kind"] == "timing"] == [
        "ungateable"]


def test_serve_cli_exporter_scraped_while_it_serves(tmp_path):
    """``--live-port P`` serves the aggregator while the serve CLI runs
    (scraped from another thread; one decode step a dispatch, a
    ``serve_tick`` every 8, and the chaos plane's ``serve_slow`` holding
    dispatches 10-12 for 0.1 s each after the first tick, so the tiny CPU
    run is scraped between its ticks, every 50 ms); ``--live-port 0``
    leaves the bus off, as in the JAX CLI (a port of 0 is no port). The
    stall rides every queued request's TTFT, so it is kept to 0.3 s: at
    0.9 s a loaded host took the p99 past the 2.0 s serve gate."""
    port = _free_port()
    argv = ["--device", "cpu", "--requests", "16", "--max-new-tokens", "32",
            "--decode-steps-per-dispatch", "1", "--request-rate", "200",
            "--chaos", "serve_slow@0:10,s=0.1,steps=3"]
    with _scraper(port, ("/metrics",)) as got:
        assert tserve.main(argv + ["--live-port", str(port), "--save-dir",
                                   str(tmp_path / "on")]) == 0
    assert any("tpudist_serve_" in b for b in got["/metrics"])
    status = json.loads((tmp_path / "on" / tlive.STATUS_NAME).read_text())
    assert status["pod"]["serve"]["completed"] == 16
    assert tserve.main(argv + ["--live-port", "0", "--save-dir",
                               str(tmp_path / "off")]) == 0
    assert not (tmp_path / "off" / tlive.STATUS_NAME).exists()
