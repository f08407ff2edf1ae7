"""The port's serve chaos surface, requeue replay and ``alert_events``
against the JAX package's.

* ``chaos/plan.py``'s copy parses the same specs to the same events,
  raises the same errors and gives the same ``garbage_bytes``.
* ``make_garbage_requests`` is bitwise the JAX function, and every mode
  is rejected at admission with the JAX reason.
* The runtime's serve surface (``on_serve_dispatch``,
  ``consume_request_garbage``, injected ``_exit`` / ``_sleep``) fires as
  the JAX runtime does, record for record.
* ``_prior_outcomes`` equals the JAX function's on a file with a torn
  tail.
* A kill-then-requeue pair of port CLI runs on the CPU under
  ``--virtual-clock`` (the kill a real ``os._exit`` in a subprocess)
  gives the JAX CLI pair's lost rids, ``completed_prior``, replayed count
  and resumed-summary fields.
* ``serve_slow`` and ``request_garbage`` runs of ``run_serve`` under
  virtual time on carried params equal the JAX ones on every key both
  carry, and a tightened-shed overload's ``alert_events`` and fired
  alerts equal the JAX summary's.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tpudist.chaos import inject as jinject
from tpudist.chaos import plan as jplan
from tpudist.config import ModelConfig, ParallelConfig
from tpudist.obs import alerts as jalerts
from tpudist.parallel import build_mesh
from tpudist.parallel import mesh as jmesh
from tpudist.serve import cli as jcli
from tpudist.serve import resilience as jres
from tpudist.serve import scheduler as jsched
from tpudist.serve.engine import ServeEngine as JServeEngine
from tpudist.serve.engine import init_params
from tpudist_torch import convert
from tpudist_torch.chaos import inject as tinject
from tpudist_torch.chaos import plan as tplan
from tpudist_torch.config import ModelConfig as TModelConfig
from tpudist_torch.models import transformer as ttf
from tpudist_torch.obs import alerts as talerts
from tpudist_torch.serve import cli as tcli
from tpudist_torch.serve import resilience as tres
from tpudist_torch.serve import scheduler as tsched
from tpudist_torch.serve.engine import ServeEngine as TServeEngine

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_TF = ModelConfig(name="transformer", vocab_size=64, n_layers=2,
                      d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                      max_seq_len=32)
ENGINE_KW = dict(slots=4, max_seq=32, prompt_pad=8, decode_k=4)
# the JAX serve drill's engine flags and its serve_kill scenario
# (tpudist/serve/drill.py), with the span tracer off
ENGINE_FLAGS = ["--vocab-size", "64", "--n-layers", "2", "--d-model", "32",
                "--n-heads", "4", "--n-kv-heads", "2", "--d-ff", "64",
                "--slots", "4", "--max-seq", "32", "--prompt-pad", "8",
                "--seed", "3", "--virtual-clock", "--trace", "off"]
KILL_FLAGS = ENGINE_FLAGS + ["--requests", "24", "--request-rate", "300",
                             "--max-new-tokens", "8",
                             "--decode-steps-per-dispatch", "4",
                             "--queue-cap", "40"]
SPECS = ["serve_kill@0:6,rc=137", "serve_slow@0:2,s=0.02,steps=4",
         "request_garbage@0:0,n=6",
         "serve_kill@0:6,rc=137; serve_slow@0:2,s=0.02,steps=4;"
         "request_garbage@0:0,n=6; kill@0:5",
         " kill@1:2:3 , rc=9 ;; hang@0:1,max_s=1.5,settle_s=0.25 ",
         "corrupt_shard@0:6,mode=flip,flips=3; fs_error@0:3,n=2,errno=ENOSPC",
         "telemetry_garbage@0:4,n=17; slow@2:0:1,s=0.5", "", None]
BAD_SPECS = ["explode@0:5", "kill", "kill@0", "kill@0:1:2:3", "kill@a:1",
             "kill@0:1,rc", "kill@0:1,=3", "serve_kill0:3"]


class RecMetrics:
    """A MetricsLogger stand-in that records instead of writing."""

    def __init__(self):
        self.recs = []

    def log(self, **kv):
        self.recs.append(kv)

    def flush(self):
        pass


def _tcfg(cfg: ModelConfig) -> TModelConfig:
    return TModelConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(TModelConfig)})


# ------------------------------------------------------------- the plan


def _events(pkg, spec, seed=0):
    p = pkg.ChaosPlan.parse(spec, seed=seed)
    return p, [dataclasses.asdict(e) for e in p.events]


@pytest.mark.parametrize("spec", SPECS)
def test_plan_copy_parses_as_jax(spec):
    for seed in (0, 7):
        tp, tev = _events(tplan, spec, seed)
        jp, jev = _events(jplan, spec, seed)
        assert tev == jev and tp.describe() == jp.describe()
        for surface in ("step_events", "ckpt_events", "serve_events"):
            assert [e.index for e in getattr(tp, surface)] == \
                [e.index for e in getattr(jp, surface)]
        for te, je in zip(tp.events, jp.events):
            assert te.describe() == je.describe()
            for n in (None, 1, 33, 100):
                assert tplan.garbage_bytes(tp, te, n) == \
                    jplan.garbage_bytes(jp, je, n)
            assert tplan.corrupt_positions(tp, te, 4096) == \
                jplan.corrupt_positions(jp, je, 4096)
            for epoch, step, rank in ((0, 0, 0), (0, 6, 0), (1, 2, 3),
                                      (2, 9, 1)):
                assert te.matches(epoch, step, rank) == \
                    je.matches(epoch, step, rank)


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_plan_copy_raises_as_jax(spec):
    with pytest.raises(ValueError) as want:
        jplan.ChaosPlan.parse(spec)
    with pytest.raises(ValueError) as got:
        tplan.ChaosPlan.parse(spec)
    assert str(got.value) == str(want.value)


def test_plan_copy_families_equal_jax():
    for name in ("FAULT_KINDS", "SERVE_KINDS", "ALL_KINDS", "STEP_KINDS",
                 "CKPT_KINDS"):
        assert getattr(tplan, name) == getattr(jplan, name), name


# ---------------------------------------------------- malformed requests


@pytest.mark.parametrize("spec,kw", [
    ("request_garbage@0:0,n=48", dict(rid_base=100, prompt_pad=8,
                                      vocab_size=64, span_s=1.0)),
    ("request_garbage@0:0,n=6", dict(rid_base=24, prompt_pad=512,
                                     vocab_size=32000, span_s=0.0)),
    ("kill@0:1; request_garbage@0:0", dict(rid_base=0, prompt_pad=4,
                                           vocab_size=16, span_s=0.25)),
])
def test_garbage_requests_bitwise_jax_and_rejected_as_jax(spec, kw):
    """Every field of every request bitwise (dtype and shape of the
    tokens included), and the port's admission rejects each with the
    reason the JAX validation names."""
    tp, jp = tplan.ChaosPlan.parse(spec), jplan.ChaosPlan.parse(spec)
    got = tsched.make_garbage_requests(tp, tp.serve_events[0], **kw)
    want = jsched.make_garbage_requests(jp, jp.serve_events[0], **kw)
    assert len(got) == len(want) == int(
        tp.serve_events[0].args.get("n", 4))
    reasons = set()
    for g, w in zip(got, want):
        assert (g.rid, g.arrival_s, g.prompt_len, g.max_new) == (
            w.rid, w.arrival_s, w.prompt_len, w.max_new)
        assert g.tokens.dtype == w.tokens.dtype
        np.testing.assert_array_equal(g.tokens, w.tokens)
        why = tsched.validate_request(g, prompt_pad=kw["prompt_pad"],
                                      vocab_size=kw["vocab_size"])
        assert why is not None and why == jsched.validate_request(
            w, prompt_pad=kw["prompt_pad"], vocab_size=kw["vocab_size"])
        reasons.add(why)
    if len(got) == 48:
        assert reasons == {"bad_token", "bad_prompt_len", "bad_max_new",
                           "bad_shape", "bad_dtype"}


# ------------------------------------------------------------- runtime


class _Exit(Exception):
    def __init__(self, rc):
        self.rc = rc


def _runtime(pkg, spec, metrics=None):
    plan = (tplan if pkg is tinject else jplan).ChaosPlan.parse(spec)
    rt = pkg.ChaosRuntime(plan, metrics=metrics)
    sleeps = []

    def fake_exit(rc):
        raise _Exit(rc)
    rt._exit, rt._sleep = fake_exit, sleeps.append
    return rt, sleeps


def _drive(pkg, spec, dispatches=10):
    """Garbage consumed once, then the dispatch hook: the stalls, the
    sleeps, the kill's rc and the dispatch it fired at, the records."""
    m = RecMetrics()
    rt, sleeps = _runtime(pkg, spec, m)
    out = {"garbage": [e.describe() for e in rt.consume_request_garbage()],
           "again": rt.consume_request_garbage(), "stalls": [],
           "killed": None}
    for d in range(dispatches):
        try:
            out["stalls"].append(rt.on_serve_dispatch(d))
        except _Exit as e:
            out["killed"] = (d, e.rc)
            break
    out.update(sleeps=sleeps, fired=rt.fired, recs=m.recs)
    return out


@pytest.mark.parametrize("spec", [
    "serve_kill@0:6,rc=137", "serve_kill@0:3", "serve_kill@0:2:1",
    "serve_slow@0:2,s=0.25,steps=3", "serve_slow@0:0",
    "request_garbage@0:0,n=5; serve_slow@0:1,s=0.1,steps=2;"
    "serve_kill@0:4,rc=9", "kill@0:1; slow@0:0,s=1", ""])
def test_runtime_serve_surface_fires_as_jax(spec, capsys):
    got = _drive(tinject, spec)
    got_out = capsys.readouterr().out
    want = _drive(jinject, spec)
    assert got == want
    assert got_out == capsys.readouterr().out


def test_runtime_serve_kill_and_slow_as_the_jax_tests_state():
    rt, _ = _runtime(tinject, "serve_kill@0:6,rc=137")
    for d in range(6):
        assert rt.on_serve_dispatch(d) == 0.0
    with pytest.raises(_Exit) as e:
        rt.on_serve_dispatch(6)
    assert e.value.rc == 137 and rt.fired == 1
    rt, sleeps = _runtime(tinject, "serve_slow@0:2,s=0.25,steps=3")
    out = [rt.on_serve_dispatch(d) for d in range(8)]
    assert out == [0.0, 0.0, 0.25, 0.25, 0.25, 0.0, 0.0, 0.0]
    assert sleeps == [0.25, 0.25, 0.25] and rt.fired == 1


# ------------------------------------------------------ requeue replay


def test_prior_outcomes_equal_jax_with_a_torn_tail(tmp_path):
    path = tmp_path / "metrics.jsonl"
    recs = [{"kind": "serve_request", "rid": r, "event": ev}
            for r, ev in ((0, "admitted"), (1, "admitted"), (0, "done"),
                          (2, "shed_admission"), (3, "admitted"),
                          (3, "evicted"), (9, "shed"),
                          (4, "admitted"), (5, "expired_queue"),
                          (6, "rejected"),
                          (7, "admitted"), (7, "lost"), (8, "arrive"))]
    recs += [{"kind": "serve_tick", "rid": 9, "event": "admitted"},
             {"kind": "serve_request", "event": "admitted"}]
    path.write_text("\n".join(json.dumps(r) for r in recs)
                    + '\n{"kind": "serve_request", "rid": 4, "eve')
    got = tcli._prior_outcomes(str(path))
    assert got == jcli._prior_outcomes(str(path))
    assert got == ({0, 2, 3, 5, 6, 7}, {1, 4})
    missing = str(tmp_path / "none.jsonl")
    assert tcli._prior_outcomes(missing) == jcli._prior_outcomes(missing) \
        == (set(), set())


def _records(save):
    return [json.loads(line) for line in
            (save / "metrics.jsonl").read_text().splitlines()]


def _kill_pair_facts(save, rc):
    """What the pair left: the kill's rc, its chaos record, whether it
    wrote a summary, the lost rids and the resume record of attempt 1,
    its summary's supervision fields, and the terminal bucket of every
    rid across the two attempts."""
    recs = _records(save)
    first = [r for r in recs if r.get("requeue_attempt") == 0]
    second = [r for r in recs if r.get("requeue_attempt") == 1]
    terminal = {}
    for r in recs:
        if r["kind"] == "serve_request" and r["event"] in \
                tres.TERMINAL_EVENTS:
            terminal.setdefault(r["rid"], []).append(r["event"])
    resume = [r for r in second if r["kind"] == "serve_resume"]
    summary = [r for r in second if r["kind"] == "serve"]
    return {
        "rc": rc,
        "chaos": [(r["fault"], r["at_dispatch"]) for r in first
                  if r["kind"] == "chaos"],
        "summary_in_attempt_0": any(r["kind"] == "serve" for r in first),
        "lost": sorted(r["rid"] for r in second
                       if r["kind"] == "serve_request"
                       and r["event"] == "lost"),
        "resume": [{k: r[k] for k in ("completed_prior", "lost",
                                      "replayed")} for r in resume],
        "summary": [{k: r[k] for k in (
            "requeue_attempt", "lost", "completed_prior", "requests",
            "arrived", "admitted", "completed", "generated_tokens",
            "dispatches", "partition")} for r in summary],
        "terminal": terminal,
    }


def test_kill_then_requeue_pair_equals_jax(tmp_path, monkeypatch):
    """The drill's serve_kill scenario: attempt 0 dies at dispatch 6
    (exit 137, a flushed chaos record, no summary); attempt 1
    classifies exactly the admitted rids with no terminal event as lost,
    replays the rest, and every rid of the stream ends in exactly one
    terminal bucket across the two attempts — the JAX CLI pair's facts
    exactly."""
    tsave = tmp_path / "torch"
    kill = ["--chaos", "serve_kill@0:6,rc=137", "--requeue-attempt", "0"]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("TPUDIST_")}
    proc = subprocess.run(
        [sys.executable, "-m", "tpudist_torch.serve", "--device", "cpu",
         *KILL_FLAGS, *kill, "--save-dir", str(tsave)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=240)
    assert "chaos fired: serve_kill@0:6,rc=137" in proc.stdout, \
        proc.stdout + proc.stderr
    assert tcli.main(["--device", "cpu", *KILL_FLAGS, "--requeue-attempt",
                      "1", "--save-dir", str(tsave)]) == 0
    got = _kill_pair_facts(tsave, proc.returncode)

    # the JAX pair in this process, on one device, its kill's os._exit
    # raising instead of exiting
    real = jmesh.build_mesh
    monkeypatch.setattr(jmesh, "build_mesh", lambda cfg: real(
        cfg, devices=jax.devices()[:1]))

    def exit_(rc):
        raise SystemExit(rc)
    monkeypatch.setattr(os, "_exit", exit_)
    jsave = tmp_path / "jax"
    with pytest.raises(SystemExit) as died:
        jcli.run(jcli.parse_args(KILL_FLAGS + kill
                                 + ["--save-dir", str(jsave)]))
    jcli.run(jcli.parse_args(KILL_FLAGS + ["--requeue-attempt", "1",
                                           "--save-dir", str(jsave)]))
    want = _kill_pair_facts(jsave, died.value.code)
    assert got == want
    assert got["rc"] == 137 and got["chaos"] == [("serve_kill", 6)]
    assert not got["summary_in_attempt_0"] and got["lost"]
    assert sorted(got["terminal"]) == list(range(24))
    assert all(len(v) == 1 for v in got["terminal"].values())


# ------------------------------------------- run_serve under chaos


@pytest.fixture(scope="module")
def engines():
    """Warmed engines on carried params, (JAX, port)."""
    mesh = build_mesh(ParallelConfig(), devices=jax.devices()[:1])
    jparams = init_params(TINY_TF, mesh, seed=0)
    je = JServeEngine(TINY_TF, mesh, **ENGINE_KW)
    je.warmup(jparams)
    model = ttf.Transformer(_tcfg(TINY_TF), device="cpu")
    model.load_state_dict(convert.params_from_jax(jax.device_get(jparams)))
    te = TServeEngine(_tcfg(TINY_TF), device="cpu", **ENGINE_KW)
    te.warmup(model)
    return (je, jparams), (te, model)


def _chaos_run(pkg, engine, params, spec, res_kw, n=16, rate=300.0):
    """``run_serve`` under virtual time with the chaos plan ``spec``: the
    garbage folded into the stream as the CLI folds it, the runtime's
    sleeps injected. Returns the summary and the metrics records."""
    sched, res, inject, plan = (
        (tsched, tres, tinject, tplan) if pkg == "torch"
        else (jsched, jres, jinject, jplan))
    requests = sched.make_requests(n, prompt_pad=8, vocab_size=64,
                                   max_new=6, rate=rate, seed=3)
    m = RecMetrics()
    rt = inject.ChaosRuntime(plan.ChaosPlan.parse(spec), metrics=m)
    rt._sleep = lambda s: None
    span = max(r.arrival_s for r in requests)
    for ev in rt.consume_request_garbage():
        requests += sched.make_garbage_requests(
            rt.plan, ev, rid_base=len(requests), prompt_pad=8,
            vocab_size=64, span_s=span)
    kw = dict(n_chips=1) if pkg == "jax" else {}
    summary = sched.run_serve(
        engine, params, requests, metrics=m, chaos=rt,
        resilience=res.ResilienceConfig(**res_kw),
        virtual=res.VirtualTiming(prefill_s=0.002, decode_s=0.004), **kw)
    return summary, m.recs


def _assert_summaries_equal(got, want):
    shared = set(got) & set(want)
    assert shared == set(got), set(got) - set(want)
    for key in sorted(shared):
        assert got[key] == want[key], key


def _records_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w), (g, w)
        assert g == w


@pytest.mark.parametrize("spec", ["serve_slow@0:2,s=0.02,steps=4",
                                  "request_garbage@0:0,n=6"])
def test_chaos_summaries_under_virtual_time_equal_jax(engines, spec):
    """Every key both summaries carry, and every metrics record (the
    chaos record, the outcome events, the ticks), equal: the stall shows
    in the ITL percentiles against a clean run; the garbage is rejected
    with the JAX reasons and the well-formed requests' tokens are a
    clean run's."""
    (je, jp), (te, tp) = engines
    res_kw = dict(validate=True)
    got, got_recs = _chaos_run("torch", te, tp, spec, res_kw)
    want, want_recs = _chaos_run("jax", je, jp, spec, res_kw)
    _assert_summaries_equal(got, want)
    _records_equal(got_recs, want_recs)
    clean, _ = _chaos_run("torch", te, tp, "", res_kw)
    if spec.startswith("serve_slow"):
        assert got["itl_p99_s"] > clean["itl_p99_s"]
        assert got["completed"] == clean["completed"] == 16
    else:
        assert got["rejected"] == 6 and got["arrived"] == 22
        reasons = [r["reason"] for r in got_recs
                   if r.get("event") == "rejected"]
        assert len(reasons) == 6 and all(reasons)
        assert {r: v["tokens"] for r, v in got["results"].items()} == \
            {r: v["tokens"] for r, v in clean["results"].items()}


# ------------------------------------------------------ alert_events


def test_tightened_shed_overload_alerts_equal_jax(engines, monkeypatch):
    """The drill's shed_breach: a shed gate tightened below what the
    overload sheds grades fail at exit, and the scheduler's alert engine
    fired the matching ``serve_shed`` alert mid-run: ``alert_events``
    and every fired alert (rule, state, value, threshold) equal the JAX
    run's."""
    monkeypatch.setenv("TPUDIST_SERVE_SHED_MAX", "0.05")
    (je, jp), (te, tp) = engines
    history = {}

    def recording(pkg, real):
        class Recording(real):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                history[pkg] = self.history
        return Recording
    monkeypatch.setattr(tsched, "AlertEngine",
                        recording("torch", talerts.AlertEngine))
    monkeypatch.setattr(jsched, "AlertEngine",
                        recording("jax", jalerts.AlertEngine))
    res_kw = dict(queue_cap=6, ttft_deadline_s=0.025, validate=True)
    got, _ = _chaos_run("torch", te, tp, "", res_kw, n=40, rate=1600.0)
    want, _ = _chaos_run("jax", je, jp, "", res_kw, n=40, rate=1600.0)
    _assert_summaries_equal(got, want)
    assert got["serve_shed_status"] == "fail" and got["status"] == "fail"
    assert got["alert_events"] == want["alert_events"] >= 1

    def fired(pkg):
        return [(a["alert"], a["state"], a["value"], a["threshold"])
                for a in history[pkg]]
    assert fired("torch") == fired("jax")
    rules = {a[0] for a in fired("torch")}
    from tpudist_torch import rules as trules
    for status, rule in trules.SERVE_STATUS_RULES:
        if got[status] == "fail":
            assert rule in rules, status
