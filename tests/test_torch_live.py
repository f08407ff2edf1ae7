"""The port's live aggregator (``tpudist_torch.obs.live.LiveAggregator``)
against the JAX package's, and ``MetricsLogger``'s emitter hook.

* One record stream, fed to both aggregators on a fake clock with the
  ticker off: a recorded port serve CLI run's ``metrics.jsonl`` (the
  drill's overload flags under a tightened ``TPUDIST_SERVE_SHED_MAX``),
  and scripted heartbeats of two hosts (one stalls, one's staging
  overlap sags), ``hosts``, ``step``/``epoch`` (a baseline regression),
  ``timing``, ``devtime`` on both fabrics, ``ckpt``/``ckpt_drain``,
  ``resume``, ``goodput``, ``stall_dump``, an echoed alert and an
  unknown kind, with ticks between. ``alerts.jsonl`` is equal record by
  record, ``live_status.json`` equal with ``ts`` left out, and so is
  every snapshot along the way.
* The serve CLI under ``TPUDIST_LIVE=on`` writes what a JAX aggregator
  fed its ``metrics.jsonl`` writes, wall-clock stamps left out.
* A ``MetricsLogger`` without an emitter writes the bytes it wrote
  before the hook (the JAX logger's, on the same clocks); with one, the
  same bytes, and the emitter sees every record.
"""

import json
import os
import time
from unittest import mock

import pytest
import torch

from tpudist import metrics as jmetrics
from tpudist.obs import live as jlive
from tpudist_torch import metrics as tmetrics
from tpudist_torch import rules as trules
from tpudist_torch.obs import live as tlive
from tpudist_torch.serve import cli as tcli

torch.set_num_threads(1)

# the serve drill's overload scenario (tpudist/serve/drill.py), on the CPU
OVERLOAD = ["--device", "cpu", "--vocab-size", "64", "--n-layers", "2",
            "--d-model", "32", "--n-heads", "4", "--n-kv-heads", "2",
            "--d-ff", "64", "--slots", "4", "--max-seq", "32",
            "--prompt-pad", "8", "--seed", "3", "--virtual-clock",
            "--requests", "80", "--request-rate", "500",
            "--max-new-tokens", "8", "--decode-steps-per-dispatch", "4",
            "--queue-cap", "16", "--ttft-deadline-ms", "40"]
SHED_ENV = {"TPUDIST_SERVE_SHED_MAX": "0.05", "TPUDIST_TTFT_P99_MAX": "0.5",
            "TPUDIST_ITL_P99_MAX": "0.1",
            "TPUDIST_TOKENS_PER_CHIP_MIN": "0.001"}
# wall-clock stamps of an alert record
STAMPS = ("first_ts", "last_ts", "duration_s")


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The port serve CLI's overload run with the shed gate at 0.05 and
    the live aggregator on: (its save dir, its records)."""
    save = tmp_path_factory.mktemp("served")
    env = {**SHED_ENV, "TPUDIST_LIVE": "on", "TPUDIST_RUN_ID": "live-parity"}
    with mock.patch.dict(os.environ, env):
        assert tcli.main(OVERLOAD + ["--save-dir", str(save)]) == 1
    recs = [json.loads(line) for line in
            (save / "metrics.jsonl").read_text().splitlines()]
    return save, recs


def _scripted():
    """Two hosts' beacons and the train lane's records: host 1 stops
    stepping at step 3 (stall, straggler), its streamed staging sags
    (staging); the pod's steps/s fall under the baseline (regress)."""
    recs = []
    for i in range(10):
        for pi in (0, 1):
            step = i if pi == 0 or i < 4 else 3
            recs.append({"kind": "heartbeat", "process_index": pi,
                         "step": step, "epoch": 0, "phase": "train",
                         "progress_n": step if pi else None,
                         "hbm_peak_bytes": 1 << 20 + i,
                         "staging_streamed": True, "run_s": 1.0 + i,
                         "staging_wait_s": 0.8 + i if pi else 0.1})
        recs.append({"kind": "step", "step": i, "epoch": 0,
                     "loss": 2.0 / (i + 1), "steps_per_sec": 12.0 - i})
    recs += [{"kind": "epoch", "epoch": 0, "avg_loss": 0.5,
              "steps_per_sec": 5.0},
             {"kind": "hosts", "straggler_ratio": 1.6},
             {"kind": "timing", "staging_overlap_fraction": 0.3},
             {"kind": "devtime", "exposed_comm_frac": 0.3,
              "fabric": "dcn", "dcn_bytes_total": 4096},
             {"kind": "devtime", "exposed_comm_frac": 0.5,
              "fabric": "ici"},
             {"kind": "ckpt", "enqueue_ms": 12.5},
             {"kind": "ckpt_drain", "drain_ms": 40.0},
             {"kind": "resume", "status": "success", "source": "manifest",
              "resumed_from_step": 3, "requeue_attempt": 1},
             {"kind": "goodput", "fraction": 0.3},
             {"kind": "stall_dump", "process_index": 1, "stall_s": 9.0,
              "step": 3},
             {"kind": "hosts", "straggler_ratio": 1.1},
             {"kind": "timing", "staging_overlap_fraction": 0.9},
             {"kind": "alert", "alert": "stall"}, {"kind": "mystery"}]
    return recs


def _strip(status):
    return {k: v for k, v in status.items() if k != "ts"}


def _feed(tmp_path, recs):
    """Both aggregators over ``recs`` on one fake clock, a tick every
    three records; every snapshot equal along the way. Returns the two
    output directories."""
    dirs, aggs, clocks = [], [], []
    for mod, name in ((tlive, "t"), (jlive, "j")):
        clk = FakeClock()
        d = tmp_path / name
        aggs.append(mod.LiveAggregator(
            out_dir=str(d), requeue_attempt=1, stall_timeout_s=2.0,
            regress_baseline_sps=8.0, window_s=3.0, clock=clk, wall=clk,
            start_ticker=False))
        dirs.append(d)
        clocks.append(clk)
    for i, rec in enumerate(recs):
        for agg, clk in zip(aggs, clocks):
            clk.t = 1000.0 + 0.5 * i
            agg.ingest(dict(rec), now=clk.t)
            if i % 3 == 2:
                agg.tick(clk.t + 0.25)
        assert _strip(aggs[0].snapshot()) == _strip(aggs[1].snapshot()), i
    for agg in aggs:
        agg.close()
    return dirs


def _files(d):
    alerts = [json.loads(a) for a in
              (d / tlive.ALERTS_NAME).read_text().splitlines()]
    return alerts, json.loads((d / tlive.STATUS_NAME).read_text())


def test_constants_equal_jax():
    assert (tlive.LIVE_SCHEMA_VERSION, tlive.STATUS_NAME,
            tlive.ALERTS_NAME) == (jlive.LIVE_SCHEMA_VERSION,
                                   jlive.STATUS_NAME, jlive.ALERTS_NAME)
    w_t, w_j = tlive.RollingWindow(2.0), jlive.RollingWindow(2.0)
    for t, v in ((0.0, 0), (0.5, 3), (1.0, 4), (2.75, 9), (2.75, 10),
                 (6.0, 11)):
        w_t.add(t, v)
        w_j.add(t, v)
        assert (w_t.rate(), w_t.last()) == (w_j.rate(), w_j.last())
    for fabric in (None, "ici", "dcn", "other"):
        assert trules.resolve_comm(fabric) == jlive.rules_lib.resolve_comm(
            fabric)


def test_scripted_and_served_stream_equal_jax(served, tmp_path, monkeypatch):
    """The scripted records, then the served run's: every rule the
    aggregator grades fires (and some resolve) identically. The port's
    live straggler ratio takes a rate from ``MIN_RATE_BEACONS`` beacons
    on (``tests/test_torch_live_bus.py`` pins that rule); at 2, the
    JAX aggregator's two samples, it is the JAX rule on this stream,
    whose step counters never reset."""
    for k, v in SHED_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("TPUDIST_LIVE_BASELINE_SPS", raising=False)
    monkeypatch.setattr(tlive, "MIN_RATE_BEACONS", 2)
    recs = _scripted() + served[1]
    t_dir, j_dir = _feed(tmp_path, recs)
    t_alerts, t_status = _files(t_dir)
    j_alerts, j_status = _files(j_dir)
    assert t_alerts == j_alerts
    assert _strip(t_status) == _strip(j_status)
    fired = {a["alert"] for a in t_alerts if a["state"] == "firing"}
    assert fired == {"stall", "straggler", "staging", "regress", "comm",
                     "goodput", "serve_shed"}
    assert {a["alert"] for a in t_alerts if a["state"] == "resolved"} \
        >= {"straggler", "staging"}
    assert t_status["counters"]["records"] == len(recs)
    assert t_status["run_id"] == "live-parity"
    assert t_status["pod"]["serve"]["status"] == "fail"
    assert t_status["pod"]["memledger"]["exact"] is True


def test_serve_cli_live_files_equal_a_jax_aggregators(served, tmp_path,
                                                      monkeypatch):
    """The CLI's loopback aggregator (real clocks) against a JAX
    aggregator fed the CLI's ``metrics.jsonl`` afterwards: the same
    alert transitions, and the same status document, wall-clock stamps
    left out."""
    for k, v in SHED_ENV.items():
        monkeypatch.setenv(k, v)
    save, recs = served
    agg = jlive.LiveAggregator(out_dir=str(tmp_path), run_id="live-parity",
                               metrics=None, stall_timeout_s=0,
                               start_ticker=False)
    for rec in recs:
        agg.ingest(rec)
    agg.close()
    j_alerts, j_status = _files(tmp_path)
    t_alerts, t_status = _files(save)

    def unstamped(alerts):
        return [{k: v for k, v in a.items() if k not in STAMPS}
                for a in alerts]
    assert unstamped(t_alerts) == unstamped(j_alerts)
    assert [a["alert"] for a in t_alerts] == ["serve_shed"]
    for doc in (t_status, j_status):
        doc.pop("ts")
        for key in ("firing", "history"):
            doc["alerts"][key] = unstamped(doc["alerts"][key])
    assert t_status == j_status
    assert t_status["counters"]["records"] == len(recs)


def _log_all(logger, clock):
    rows = [dict(kind="serve_tick", queue_depth=3, ttft_p99_s=0.25),
            dict(kind="serve", status="fail", ts=5.0, requeue_attempt=2),
            dict(kind="memledger", exact=True, nested={"a": [1, 2.5]})]
    logger.extra.update(run_id="r", requeue_attempt=0)
    for row in rows:
        clock.t += 0.125
        logger.log(**row)
    logger.close()


def test_metrics_logger_records_unchanged_by_the_hook(tmp_path,
                                                      monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(time, "time", clock)
    monkeypatch.setattr(time, "perf_counter", clock)
    seen = []

    class Emitter:
        def emit(self, rec):
            seen.append(rec)

    out = {}
    for name, make in (
            ("port", lambda p: tmetrics.MetricsLogger(path=p)),
            ("hooked", lambda p: tmetrics.MetricsLogger(path=p,
                                                        emitter=Emitter())),
            ("jax", lambda p: jmetrics.MetricsLogger(path=p))):
        clock.t = 1000.0
        logger = make(str(tmp_path / f"{name}.jsonl"))
        _log_all(logger, clock)
        out[name] = (tmp_path / f"{name}.jsonl").read_bytes()
        if name == "hooked":
            assert seen == logger.history and len(seen) == 3
    assert out["port"] == out["jax"] == out["hooked"]
    assert json.loads(out["port"].splitlines()[1]) == {
        "ts": 5.0, "mono": 1000.25, "run_id": "r", "requeue_attempt": 2,
        "kind": "serve", "status": "fail"}


def test_loopback_emitter_never_raises(tmp_path):
    class Broken:
        def ingest(self, rec):
            raise RuntimeError("down")

    logger = tmetrics.MetricsLogger(path=str(tmp_path / "m.jsonl"),
                                    emitter=tcli._LoopbackEmitter(Broken()))
    logger.log(kind="serve_tick", completed=1)
    logger.close()
    assert len((tmp_path / "m.jsonl").read_text().splitlines()) == 1
