"""The port's observability (``tpudist_torch.obs``, the verdicts, the
resolvers) against the JAX package's (``tpudist.obs``), on the same
inputs.

* Copies pinned to their sources: ``merge_traces`` on scripted offsets,
  the tracer's documents on a scripted clock, ``trace_status`` and
  ``straggler_status``, ``mfu_fields``, the memory ledger
  (``program_temp_bytes``, ``build_ledger``, ``ledger_record``: complete,
  over-committed, incomplete, inexact), ``build_extra_events`` on scripted
  serve events, the ``HbmSampler.split`` and ``PodObserver.hbm_fields``
  key sets, the per-host ``kind=hosts`` record, the flight record's
  keys, ``resolve_run_id``, and ``resolve_trace`` / ``resolve_obs``
  (flag > env > default, the falsy spellings of ``TPUDIST_TRACE``).
* The watchdog dumps a flight record after a short stall window.
* The step's flop count on a tiny transformer equals a closed form,
  per-step and superstep, whichever LM head the step takes: the kernel
  wrappers count their formula and hide their plain bodies, so the
  CPU's count is the card's (``chip_smoke.py`` phase 13a holds the
  card's count to the same closed form at full width).
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from tpudist import config as jconfig
from tpudist import verdict as jverdict
from tpudist.obs import PodObserver as JPodObserver
from tpudist.obs import flightrec as jflightrec
from tpudist.obs import hbm as jhbm
from tpudist.obs import heartbeat as jheartbeat
from tpudist.obs import hoststats as jhoststats
from tpudist.obs import live as jlive
from tpudist.obs import memledger as jmemledger
from tpudist.obs import mfu as jmfu
from tpudist.obs import trace as jtrace
from tpudist.serve import flight as jflight
from tpudist_torch import config as tconfig
from tpudist_torch import data as tdata
from tpudist_torch import engine as tengine
from tpudist_torch import verdict as tverdict
from tpudist_torch.metrics import MetricsLogger
from tpudist_torch.obs import PodObserver as TPodObserver
from tpudist_torch.obs import flightrec as tflightrec
from tpudist_torch.obs import hbm as thbm
from tpudist_torch.obs import heartbeat as theartbeat
from tpudist_torch.obs import hoststats as thoststats
from tpudist_torch.obs import live as tlive
from tpudist_torch.obs import memledger as tmemledger
from tpudist_torch.obs import mfu as tmfu
from tpudist_torch.obs import trace as ttrace
from tpudist_torch.serve import flight as tflight

torch.set_num_threads(1)


# ------------------------------------------------------------ the tracer

def _doc(host: int, events):
    return {"traceEvents": events,
            "metadata": {"spans": len(events), "dropped": host,
                         "clock_sync": {"wall_ts": 1.5 + host,
                                        "mono_us": 10.0 * host},
                         "run_id": "r1" if host else None,
                         "requeue_attempt": 0}}


@pytest.mark.parametrize("offsets", [[0], [0, 250_000], [0, -3_000, 7_000]])
def test_merge_traces_equals_jax(offsets):
    docs = [_doc(i, [
        {"name": "epoch", "cat": "train", "ph": "X", "ts": 100.0 + i,
         "dur": 5.0, "pid": 0, "tid": 0},
        {"name": "thread_name", "ph": "M", "pid": 0, "tid": 0,
         "args": {"name": "MainThread"}},
        {"name": "dispatch", "cat": "dispatch", "ph": "X", "ts": 101.5,
         "dur": 0.25, "pid": 0, "tid": 1, "args": {"k": 4}}])
        for i in range(len(offsets))]
    assert ttrace.merge_traces(docs, offsets) == \
        jtrace.merge_traces(docs, offsets)


def _scripted(monkeypatch, mod):
    clock = iter(range(1_000, 10**9, 1_000))
    monkeypatch.setattr(mod, "_now_ns", lambda: next(clock))


@pytest.mark.parametrize("enabled", [True, False])
def test_tracer_documents_equal_jax(enabled, monkeypatch):
    """The same spans, begin/end pair and instant on the same scripted
    clock give the same Chrome events, thread metadata, tail and counts;
    the disabled tracer records nothing and reads no clock."""
    out = []
    for mod in (jtrace, ttrace):
        _scripted(monkeypatch, mod)
        tr = mod.Tracer(enabled=enabled, capacity=3)
        with tr.span("setup", cat="init"):
            with tr.span("fence", cat="dispatch", steps=4):
                pass
        sp = tr.begin("epoch", cat="train", epoch=0)
        tr.instant("arrive", cat="serve", rid=7)
        tr.end(sp)
        doc = tr.to_doc(process_index=1)
        out.append((doc["traceEvents"], {k: v for k, v in
                                         doc["metadata"].items()
                                         if k != "clock_sync"},
                    tr.tail(per_thread=2), tr.span_count, tr.dropped))
    assert out[0] == out[1]
    assert out[1][3] == (3 if enabled else 0)
    assert out[1][4] == (1 if enabled else 0)


@pytest.mark.parametrize("value", ["on", "off", "0", "false", "no", "OFF",
                                   "No", "1", "yes", ""])
def test_env_enabled_spellings_equal_jax(value, monkeypatch):
    monkeypatch.setenv("TPUDIST_TRACE", value)
    monkeypatch.setenv("TPUDIST_TRACE_CAPACITY", "x")
    assert ttrace._env_enabled() == jtrace._env_enabled()
    assert ttrace._env_capacity() == jtrace._env_capacity()


def test_export_pod_trace_one_process(tmp_path):
    """One process: the local and merged documents written, no
    collective, the summary's keys those of the JAX export."""
    tr = ttrace.configure(enabled=True)
    tr.run_info = {"run_id": "abc", "requeue_attempt": 0}
    with ttrace.span("setup", cat="init"):
        ttrace.instant("arrive", cat="serve", rid=1)
    got = ttrace.export_pod_trace(str(tmp_path), tracer=tr, extra_events=[
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 1000,
         "args": {"name": "slot0"}}])
    jtr = jtrace.Tracer()
    want = jtrace.export_pod_trace(str(tmp_path / "jax"), tracer=jtr)
    assert set(got) == set(want)
    assert got["merged_path"] == str(tmp_path / ttrace.POD_TRACE_NAME)
    assert got["clock_offsets_ns"] == [0] and got["spans"] == 2
    pod = json.loads((tmp_path / "pod_trace.json").read_text())
    assert pod["metadata"]["run_id"] == "abc"
    assert pod["metadata"]["device_tracks"] == 1
    assert ttrace.worker_trace_name(3) == jtrace.worker_trace_name(3)


# -------------------------------------------------------------- verdicts

@pytest.mark.parametrize("means", [[], [0.1], [0.1, 0.1], [0.1, 0.126],
                                   [0.1, 0.124, 0.0], [0.1, 0.2, 0.1, 0.1]])
@pytest.mark.parametrize("factor", [None, "1.5"])
def test_straggler_status_equals_jax(means, factor, monkeypatch):
    if factor:
        monkeypatch.setenv("TPUDIST_STRAGGLER_FACTOR", factor)
    assert tverdict.straggler_status(means) == \
        jverdict.straggler_status(means)


@pytest.mark.parametrize("args", [
    (False, 0, 0, False), (True, 10, 0, True), (True, 0, 0, True),
    (True, 10, 0, False), (True, 10, 11, True), (True, 10, 9, True)])
def test_trace_status_equals_jax(args):
    assert tverdict.trace_status(*args) == jverdict.trace_status(*args)


# ------------------------------------------------------------------- MFU

@pytest.mark.parametrize("cost,step_s", [
    (None, 0.5), ({}, 0.5), ({"flops": 6.6e12}, 0.0775),
    ({"flops": 6.6e12, "bytes accessed": 2e9}, 0.0775),
    ({"flops": 0}, 1.0), ({"flops": 1e9}, 0.0)])
@pytest.mark.parametrize("peak", [None, "989"])
def test_mfu_fields_equal_jax(cost, step_s, peak, monkeypatch):
    if peak:
        monkeypatch.setenv("TPUDIST_PEAK_TFLOPS", peak)
    assert tmfu.mfu_fields(cost, step_s) == jmfu.mfu_fields(cost, step_s)


def test_peak_table_is_the_h100_sxm_row(monkeypatch):
    monkeypatch.delenv("TPUDIST_PEAK_TFLOPS", raising=False)
    assert tmfu.chip_peak_tflops("NVIDIA H100 80GB HBM3") == 989.0
    assert tmfu.chip_peak_tflops("NVIDIA H100 PCIe") is None
    monkeypatch.setenv("TPUDIST_PEAK_TFLOPS", "123")
    assert tmfu.chip_peak_tflops("cpu") == 123.0


# ------------------------------------------------------------ the ledger

PROGRAMS = {
    "complete": {"superstep": {"temp_bytes": 700, "generated_code_bytes": 5},
                 "step": {"temp_bytes": 900}},
    "incomplete": {"superstep": {"temp_bytes": 700}, "prefill": {}},
    "cpu": {"train_step": {}},
    "none": None,
}


@pytest.mark.parametrize("programs", sorted(PROGRAMS))
def test_program_temp_bytes_equals_jax(programs):
    p = PROGRAMS[programs]
    assert tmemledger.program_temp_bytes(p) == \
        jmemledger.program_temp_bytes(p)


@pytest.mark.parametrize("case", [
    # total, params, opt, slabs, kv, programs, watermark, source
    (10_000, 1000, 2000, 300, 0, "complete", 4300, "memory_stats"),
    (10_000, 1000, 2000, 300, 0, "complete", 9000, "memory_stats"),
    (10_000, 1000, 2000, 300, 0, "incomplete", None, "rss"),
    (3_000, 1000, 2000, 300, 0, "complete", 4300, "memory_stats"),
    (10_000, 1000, 0, 0, 500, "cpu", 123456, "rss"),
    (10_000, -5, 0, 0, 0, "none", None, None),
], ids=["exact", "inexact", "incomplete", "over-committed", "cpu",
        "negative"])
def test_build_ledger_and_record_equal_jax(case):
    total, params, opt, slabs, kv, programs, wm, src = case
    kw = dict(total_hbm_bytes=total, params_bytes=params,
              opt_state_bytes=opt, slab_bytes=slabs, kv_pool_bytes=kv,
              programs=PROGRAMS[programs], watermark_bytes=wm,
              watermark_source=src, mode="train", run_id="r")
    got, want = tmemledger.build_ledger(**kw), jmemledger.build_ledger(**kw)
    assert got == want
    assert sum(got["buckets"].values()) == total
    assert tmemledger.ledger_record(got) == jmemledger.ledger_record(want)
    assert tmemledger.hbm_headroom_status(got["headroom_fraction"]) == \
        jmemledger.hbm_headroom_status(got["headroom_fraction"])


def test_ledger_constants_equal_jax():
    for name in ("TOLERANCE", "LEDGER_NAME", "KNOBS", "BUCKETS",
                 "ATTRIBUTED", "MEMLEDGER_SCHEMA_VERSION"):
        assert getattr(tmemledger, name) == getattr(jmemledger, name), name
    with pytest.raises(ValueError):
        tmemledger.build_ledger(total_hbm_bytes=0)


# --------------------------------------------------- serve presentation

def _serve_events():
    ev = []
    for rid, slot in ((0, 0), (1, 1), (2, 0)):
        ev.append({"name": "arrive", "cat": "serve", "ph": "X",
                   "ts": 1.0 + rid, "dur": 0.0, "pid": 0, "tid": 0,
                   "args": {"rid": rid, "arrival_s": 0.0,
                            "prompt_len": 4}})
        for name in ("admitted", "prefill", "decode_emit", "done"):
            ev.append({"name": name, "cat": "serve", "ph": "X",
                       "ts": 2.0 + rid, "dur": 0.5, "pid": 0, "tid": 0,
                       "args": {"rid": rid, "slot": slot, "tokens": 3}})
    ev.append({"name": "kv_pages", "cat": "serve_counter", "ph": "X",
               "ts": 9.0, "dur": 0.0, "pid": 0, "tid": 0,
               "args": {"used": 3, "total": 8, "shared_refs": 1}})
    ev.append({"name": "setup", "cat": "init", "ph": "X", "ts": 0.5,
               "dur": 1.0, "pid": 0, "tid": 0})
    return ev


@pytest.mark.parametrize("process_index", [0, 2])
def test_build_extra_events_equals_jax(process_index):
    ev = _serve_events()
    for fn in ("slot_track_events", "kv_counter_events",
               "build_extra_events"):
        assert getattr(tflight, fn)(ev, process_index=process_index) == \
            getattr(jflight, fn)(ev, process_index=process_index), fn
    assert tflight.SLOT_TID_BASE == jflight.SLOT_TID_BASE


# --------------------------------------------------- sampler and observer

def test_hbm_split_keys_equal_jax():
    t, j = thbm.HbmSampler(period_s=0), jhbm.HbmSampler(period_s=0)
    got, want = t.split(), j.split()
    assert set(got) == set(want)
    # no card here: both read the process's RSS
    assert got["hbm_source"] == want["hbm_source"] == "rss"
    assert got["hbm_peak_bytes"] > 0
    with pytest.raises(ValueError):
        thbm.HbmSampler(period_s=-1)


@pytest.mark.parametrize("hbm_sample_s", [0.0, 0.05])
def test_observer_hbm_fields_keys_equal_jax(hbm_sample_s, tmp_path):
    t = TPodObserver(out_dir=str(tmp_path / "t"), stall_timeout_s=0,
                     hbm_sample_s=hbm_sample_s)
    j = JPodObserver(out_dir=str(tmp_path / "j"), stall_timeout_s=0,
                     hbm_sample_s=hbm_sample_s)
    try:
        got, want = t.hbm_fields(), j.hbm_fields()
        assert set(got) == set(want)
        assert got["hbm_source"] == want["hbm_source"]
    finally:
        t.close()
        j.close()
    assert (tmp_path / "t" / "heartbeat.worker0").is_file()


class _Timer:
    def __init__(self, steps, elapsed):
        self.steps, self.elapsed = steps, elapsed


class _Log:
    def __init__(self):
        self.recs = []

    def log(self, **kv):
        self.recs.append(kv)


def test_hosts_record_equals_jax():
    """One process, three epochs (a warm-up-only one first): the same
    ``kind=hosts`` records and verdict."""
    out = []
    for mod in (thoststats, jhoststats):
        stats, log = mod.HostStepStats(), _Log()
        for epoch, (steps, elapsed) in enumerate(((0, 0.0), (10, 0.5),
                                                  (25, 1.25))):
            stats.epoch_end(epoch, _Timer(steps, elapsed), log)
        out.append((log.recs, stats.status, stats.last_hosts))
    assert out[0] == out[1]
    assert out[0][0][1]["hosts"] == [{"process": 0, "steps": 10,
                                      "step_s_mean": pytest.approx(0.05)}]


# --------------------------------------------------- run identity, config

def test_resolve_run_id_equals_jax(monkeypatch):
    monkeypatch.setenv("TPUDIST_RUN_ID", "  " + "x" * 80 + " ")
    assert tlive.resolve_run_id() == jlive.resolve_run_id() == "x" * 64
    monkeypatch.delenv("TPUDIST_RUN_ID")
    rid = tlive.resolve_run_id()
    assert len(rid) == 12 and int(rid, 16) >= 0


def test_metrics_extra_stamps_every_record_under_its_own_keys(tmp_path):
    m = MetricsLogger(path=str(tmp_path / "metrics.jsonl"))
    m.extra = {"run_id": "r9", "requeue_attempt": 0}
    m.log(kind="step", loss=1.0)
    m.log(kind="resume", requeue_attempt=2)
    m.close()
    recs = [json.loads(ln) for ln in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["run_id"] for r in recs] == ["r9", "r9"]
    assert [r["requeue_attempt"] for r in recs] == [0, 2]
    assert [r["kind"] for r in m.history] == ["step", "resume"]


TRACE_ENV = [None, "on", "off", "0", "false", "no", "OFF", "1", "bogus"]


@pytest.mark.parametrize("flag", [None, "on", "off"])
@pytest.mark.parametrize("env", TRACE_ENV)
def test_resolve_trace_equals_jax(flag, env, monkeypatch):
    """flag > ``TPUDIST_TRACE`` (its falsy spellings read as off) > on;
    ``--trace-dir`` > ``TPUDIST_TRACE_DIR`` > ``--save-dir``."""
    if env is not None:
        monkeypatch.setenv("TPUDIST_TRACE", env)
    for tdir, envdir in ((None, None), (None, "e"), ("f", "e")):
        if envdir:
            monkeypatch.setenv("TPUDIST_TRACE_DIR", envdir)
        t = tconfig.TrainConfig(trace=flag, trace_dir=tdir, save_dir="s")
        j = jconfig.TrainConfig(trace=flag, trace_dir=tdir, save_dir="s")
        assert tconfig.resolve_trace(t) == jconfig.resolve_trace(j)
    with pytest.raises(ValueError):
        tconfig.resolve_trace(tconfig.TrainConfig(trace="maybe"))


OBS_CASES = [
    ({}, {}),
    ({"stall_timeout_s": 5.0, "hbm_sample_s": 0.0, "heartbeat_dir": "h"},
     {}),
    ({}, {"TPUDIST_STALL_TIMEOUT_S": "12", "TPUDIST_HBM_SAMPLE_S": "0.5",
          "TPUDIST_HEARTBEAT_DIR": "hb"}),
    ({"stall_timeout_s": 0.0}, {"TPUDIST_STALL_TIMEOUT_S": "12"}),
    ({}, {"TPUDIST_STALL_TIMEOUT_S": "soon", "TPUDIST_HBM_SAMPLE_S": ""}),
]


@pytest.mark.parametrize("flags,env", OBS_CASES)
def test_resolve_obs_equals_jax(flags, env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    t = tconfig.TrainConfig(save_dir="s", **flags)
    j = jconfig.TrainConfig(save_dir="s", **flags)
    assert tconfig.resolve_obs(t) == jconfig.resolve_obs(j)


@pytest.mark.parametrize("bad", [{"stall_timeout_s": -1.0},
                                 {"hbm_sample_s": -0.5}])
def test_resolve_obs_refuses_negative_flags(bad):
    with pytest.raises(ValueError):
        tconfig.resolve_obs(tconfig.TrainConfig(**bad))


def test_obs_flags_parse_as_jax():
    argv = ["--trace", "off", "--trace-dir", "t", "--stall-timeout-s", "3",
            "--heartbeat-dir", "h", "--hbm-sample-s", "0"]
    t, j = tconfig.parse_args(argv), jconfig.parse_args(argv)
    for f in ("trace", "trace_dir", "stall_timeout_s", "heartbeat_dir",
              "hbm_sample_s"):
        assert getattr(t, f) == getattr(j, f), f
    tconfig.check_supported(t)


# ---------------------------------------------------- the flight recorder

def _wait(pred, timeout_s=10.0):
    t0 = time.monotonic()
    while not pred() and time.monotonic() - t0 < timeout_s:
        time.sleep(0.02)
    return pred()


def test_watchdog_dumps_a_flight_record_after_a_short_window(tmp_path):
    """No progress for 0.2 s: the watchdog writes the flight record
    (the JAX record's keys: reason, progress, stacks, per-card
    memory_stats, the metrics tail, the span tails), a ``kind=stall_dump``
    record, the local trace and the beacon; progress re-arms it."""
    m = MetricsLogger(path=str(tmp_path / "metrics.jsonl"))
    m.log(kind="attempt", phase="start")
    tr = ttrace.Tracer()
    with tr.span("setup", cat="init"):
        pass
    rec = theartbeat.FlightRecorder(str(tmp_path), stall_timeout_s=0.2,
                                    metrics=m, tracer=tr,
                                    extra_state=lambda: {"x": 1})
    try:
        rec.note_progress(phase="train", step=3, epoch=0)
        assert _wait(lambda: rec.dumps >= 1)
    finally:
        rec.close()
        m.close()
    doc = json.loads((tmp_path / "flightrec.worker0").read_text())
    jdoc = json.loads(open(jflightrec.dump_flight_record(
        str(tmp_path / "j" / "flightrec.worker0"), reason="stall",
        progress={}, spans=[], extra={"x": 1})).read())
    assert set(doc) == set(jdoc)
    assert doc["reason"] == "stall" and doc["progress"]["step"] == 3
    assert "File" in doc["thread_stacks"]
    assert doc["memory_stats"] == tflightrec.collect_memory_stats() == []
    assert doc["last_metrics"][0]["kind"] == "attempt"
    assert doc["spans"][0]["spans"][0]["name"] == "setup"
    assert doc["extra"] == {"x": 1}
    assert (tmp_path / "trace.worker0.json").is_file()
    assert json.loads((tmp_path / "heartbeat.worker0").read_text())[
        "step"] == 3
    kinds = [json.loads(ln)["kind"] for ln in
             (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert "stall_dump" in kinds


def test_beacon_of_another_attempt_is_archived_as_jax(tmp_path):
    for mod, d in ((theartbeat, tmp_path / "t"), (jheartbeat,
                                                  tmp_path / "j")):
        os.makedirs(d)
        (d / "heartbeat.worker0").write_text(json.dumps(
            {"step": 5, "requeue_attempt": 1}))
        mod.FlightRecorder(str(d), stall_timeout_s=0).close()
    assert sorted(os.listdir(tmp_path / "t")) == \
        sorted(os.listdir(tmp_path / "j"))


# ------------------------------------------------------- the flop count

TINY = ["--model", "transformer", "--vocab-size", "256", "--n-layers", "2",
        "--d-model", "256", "--n-heads", "2", "--d-ff", "256", "--seq-len",
        "128", "--train-batch-size", "4", "--device", "cpu"]


def _closed_form(b, s, L, d, h, kv, dff, V):
    """6 x tokens x the linear layers' and the tied head's weights (a
    GEMM's backward is twice its forward), plus the causal attention's
    two products over s(s+1)/2 pairs, three times (forward + backward)."""
    hd = d // h
    linear = L * (d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * dff)
    pairs = s * (s + 1) // 2
    return 6 * b * s * (linear + V * d) + 3 * 4 * b * h * hd * pairs * L


@pytest.mark.parametrize("head", ["plain", "fused"])
@pytest.mark.parametrize("k", [1, 2])
def test_step_flops_equal_the_closed_form(head, k):
    """The per-step dispatcher and the superstep count one step, the
    same whichever LM head the step takes; the step's losses are those
    of an uncounted step, bitwise."""
    cfg = tconfig.parse_args(TINY + ["--lm-head", head])
    dev = torch.device("cpu")
    batch = tdata.to_device((tdata.make_synthetic_tokens(
        4 * k, 129, 256, 43),), dev)
    window = (batch[0].reshape(k, 4, 129),)
    want = {"flops": _closed_form(4, 128, 2, 256, 2, 2, 256, 256)}
    if k == 1:
        step = tengine.make_train_step(cfg, dev)
        assert step.cost_analysis() is None
        state = tengine.init_state(cfg, dev)
        _, loss = step(state, (window[0][0],))
        counted = [float(loss)]
        assert tmfu.dispatch_cost(step) == want
        # the second call runs uncounted: a fresh state gives the same
        state = tengine.init_state(cfg, dev)
        assert [float(step(state, (window[0][0],))[1])] == counted
    else:
        sup = tengine.make_superstep(cfg, dev, k)
        state = tengine.init_state(cfg, dev)
        zero = torch.zeros(())
        sup(state, zero, window, 0, k)
        assert tmfu.dispatch_cost(sup) == want


@pytest.mark.parametrize("causal", [True, False])
def test_kernel_wrappers_count_their_formula_and_hide_the_plain_body(
        causal):
    """Inside a count the flash wrapper's work is its formula (forward,
    then twice that backward) and nothing of its plain body's einsums;
    the fused head's is 2 t V d, then twice that."""
    from tpudist_torch.ops.cuda import flash_attention as tfa
    from tpudist_torch.ops.cuda import fused_xent as tfx
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 128, 2, 128, generator=gen,
                           requires_grad=True) for _ in range(3))
    with tmfu.FlopCount() as n:
        o = tfa.flash_attention(q, k, v, causal=causal)
        torch.autograd.grad(o.sum(), [q, k, v])
    fwd = tfa.attention_flops(q.shape, k.shape, causal)
    pairs = 128 * 129 // 2 if causal else 128 * 128
    assert fwd == 4 * 2 * 2 * 128 * pairs
    assert n.total == n.kernel_flops == 3 * fwd
    h = torch.randn(16, 64, generator=gen, requires_grad=True)
    emb = torch.randn(40, 64, generator=gen, requires_grad=True)
    tgt = torch.randint(0, 40, (16,), generator=gen)
    with tmfu.FlopCount() as n:
        torch.autograd.grad(tfx.fused_lm_head_xent(h, emb, tgt), [h, emb])
    assert n.total == n.kernel_flops == 6 * 16 * 40 * 64


def test_flop_counts_do_not_nest():
    with tmfu.FlopCount():
        with pytest.raises(RuntimeError):
            tmfu.FlopCount().__enter__()
    with tmfu.kernel_work(10):          # outside a count: nothing
        pass
    assert tmfu.dispatch_cost(object()) is None


def test_mlp_step_flops():
    """fc1's input needs no gradient: its GEMM counts forward and dW
    only; fc2 counts all three."""
    cfg = tconfig.parse_args(["--device", "cpu"])
    dev = torch.device("cpu")
    batch = tdata.to_device(tdata.make_synthetic_data(64, 20, 43), dev)
    step = tengine.make_train_step(cfg, dev)
    step(tengine.init_state(cfg, dev), batch)
    assert step.cost_analysis() == {
        "flops": 4 * 64 * 20 * 64 + 6 * 64 * 64 * 1}


def test_hbm_sampler_reads_no_card_here():
    s = thbm.HbmSampler(period_s=0.01)
    try:
        assert _wait(lambda: s.samples >= 3)
    finally:
        s.close()
    assert s.split()["hbm_source"] == "rss" and s.limit_bytes is None
    assert np.isfinite(s.peak_in_use)
