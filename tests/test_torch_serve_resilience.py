"""The port's serve resilience plane and program discipline against the
JAX package's.

* Under virtual time a serve summary is a pure function of the schedule
  and the greedy tokens, so on carried params the port's ``run_serve``
  equals the JAX package's on every key both carry: the overload stream
  (bounded queue + TTFT deadline: partition, shed, expired, percentiles,
  histograms, every request's tokens, every metrics record) and the
  adapt-ladder stream (transitions, tokens equal to full service, one
  prefill and one decode program per rung).
* The engine: every output of a scripted prefill/decode sequence equals
  the JAX engine's (tokens, valid flags, the state vectors, the cache
  below each slot's length); the ladder and program pin; a foreign k,
  state or params object raises.
* The scheduler's admission rules as the JAX tests state them
  (expire-first ordering, instant completions, resilience off).
* The copies the port keeps of ``tpudist/serve/resilience.py`` and
  ``validate_request`` equal their sources on scripted inputs.
* The serve CLI declares every JAX serve flag, refuses those it does
  not carry and their environment twins set on (naming the Queue A
  item), reads the twins of those it carries as the JAX parser does, and
  runs the resilience plane end to end on the CPU.
"""

import argparse
import dataclasses
import json
import re
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from tpudist.config import ModelConfig, ParallelConfig
from tpudist.parallel import build_mesh
from tpudist.serve import cli as jcli
from tpudist.serve import resilience as jres
from tpudist.serve import scheduler as jsched
from tpudist.serve.engine import ServeEngine as JServeEngine
from tpudist.serve.engine import init_params
from tpudist_torch import convert
from tpudist_torch.config import ModelConfig as TModelConfig
from tpudist_torch.models import transformer as ttf
from tpudist_torch.serve import cli as tcli
from tpudist_torch.serve import resilience as tres
from tpudist_torch.serve import scheduler as tsched
from tpudist_torch.serve.engine import ServeEngine as TServeEngine

torch.set_num_threads(1)

TINY_TF = ModelConfig(name="transformer", vocab_size=64, n_layers=2,
                      d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                      max_seq_len=32)
ENGINE_KW = dict(slots=2, max_seq=16, prompt_pad=4, decode_k=4)
# the JAX package's overload and adapt drills (tests/test_serve_resilience)
OVERLOAD_KW = dict(n=40, prompt_pad=4, vocab_size=64, max_new=6,
                   rate=800.0, seed=11)
OVERLOAD_RES = dict(queue_cap=6, ttft_deadline_s=0.025, validate=True)
ADAPT_RES = dict(adapt=True, depth_high=4.0, depth_low=1.0, trip_ticks=1,
                 clear_ticks=4, window=2, validate=True)


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


@pytest.fixture(scope="module")
def jparams():
    mesh = build_mesh(ParallelConfig(), devices=jax.devices()[:1])
    return mesh, init_params(TINY_TF, mesh, seed=0)


def _jengine(jparams, **kw):
    mesh, params = jparams
    engine = JServeEngine(TINY_TF, mesh, **{**ENGINE_KW, **kw})
    engine.warmup(params)
    return engine, params


def _tengine(jparams, **kw):
    model = ttf.Transformer(_tcfg(TINY_TF), device="cpu")
    model.load_state_dict(convert.params_from_jax(
        jax.device_get(jparams[1])))
    engine = TServeEngine(_tcfg(TINY_TF), device="cpu", **{**ENGINE_KW,
                                                           **kw})
    engine.warmup(model)
    return engine, model


def _run(pkg, engine, params, requests, metrics=None, res_kw=None,
         virtual=True):
    res, sched = (jres, jsched) if pkg == "jax" else (tres, tsched)
    kw = dict(n_chips=1) if pkg == "jax" else {}
    return sched.run_serve(
        engine, params, requests, metrics=metrics,
        resilience=(res.ResilienceConfig(**res_kw) if res_kw is not None
                    else None),
        virtual=(res.VirtualTiming(prefill_s=0.002, decode_s=0.004)
                 if virtual else None), **kw)


def _assert_summaries_equal(got, want):
    shared = set(got) & set(want)
    # every key of the port's summary is one of the JAX summary's
    assert shared == set(got), set(got) - set(want)
    for key in sorted(shared):
        assert got[key] == want[key], key


# ----------------------------------------- run_serve against the JAX one


def test_overload_summary_equals_jax(jparams):
    """~5x overload on a 2-slot engine, bounded queue, 25 ms deadline:
    the whole summary and every metrics record equal the JAX package's,
    both shed mechanisms fire and the partition is exact."""
    jm, tm = RecMetrics(), RecMetrics()
    je, jp = _jengine(jparams)
    want = _run("jax", je, jp, jsched.make_requests(**OVERLOAD_KW), jm,
                OVERLOAD_RES)
    te, tp = _tengine(jparams)
    got = _run("torch", te, tp, tsched.make_requests(**OVERLOAD_KW), tm,
               OVERLOAD_RES)
    _assert_summaries_equal(got, want)
    assert got["partition"]["admission_exact"] \
        and got["partition"]["outcome_exact"]
    assert got["shed_at_admission"] > 0 and got["expired_in_queue"] > 0
    assert got["completed"] == got["admitted"] == len(got["results"])
    assert got["ttft_hist"]["count"] == got["admitted"]
    assert tm.recs == jm.recs
    assert {r["kind"] for r in tm.recs} == {"serve_request", "serve_tick"}


def test_adapt_ladder_summary_equals_jax(jparams):
    """Sustained queue pressure walks decode_k down the ladder (4, 2, 1):
    the same transitions and serve_adapt records as the JAX package, one
    prefill and three decode programs, and tokens equal to full service
    (the ladder changes pacing, never the math)."""
    jm, tm = RecMetrics(), RecMetrics()
    je, jp = _jengine(jparams, adapt_ladder=(4, 2, 1))
    want = _run("jax", je, jp, jsched.make_requests(**OVERLOAD_KW), jm,
                ADAPT_RES)
    te, tp = _tengine(jparams, adapt_ladder=(4, 2, 1))
    got = _run("torch", te, tp, tsched.make_requests(**OVERLOAD_KW), tm,
               ADAPT_RES)
    _assert_summaries_equal(got, want)
    assert tm.recs == jm.recs
    assert any(t["to_level"] > t["from_level"]
               for t in got["adapt_transitions"])
    assert [r for r in tm.recs if r["kind"] == "serve_adapt"]
    assert (got["prefill_compiles"], got["decode_compiles"]) == (1, 3)
    te.assert_two_programs()
    assert got["completed"] == 40 and got["partition"]["outcome_exact"]
    full = _run("torch", *_tengine(jparams),
                tsched.make_requests(**OVERLOAD_KW),
                res_kw=dict(validate=True))
    assert {rid: r["tokens"] for rid, r in got["results"].items()} == \
        {rid: r["tokens"] for rid, r in full["results"].items()}


def test_deadline_expiry_equals_jax(jparams):
    """Every request present at t=0 on a 1-slot engine with a 4 ms
    deadline: the queue ages as one cohort and expiry pops the FIFO head,
    in rid order, never the slotted request; the same as the JAX
    package."""
    reqs = dict(n=6, prompt_pad=4, vocab_size=64, max_new=6, rate=0.0,
                seed=2)
    res = dict(ttft_deadline_s=0.004)
    jm, tm = RecMetrics(), RecMetrics()
    je, jp = _jengine(jparams, slots=1)
    want = _run("jax", je, jp, jsched.make_requests(**reqs), jm, res)
    te, tp = _tengine(jparams, slots=1)
    got = _run("torch", te, tp, tsched.make_requests(**reqs), tm, res)
    _assert_summaries_equal(got, want)
    assert tm.recs == jm.recs
    expired = [r["rid"] for r in tm.recs
               if r["kind"] == "serve_request"
               and r["event"] == tres.EXPIRED]
    assert expired == sorted(expired) and len(expired) >= 3
    assert 0 not in expired
    assert got["partition"]["admission_exact"]


def test_two_runs_of_one_seed_are_equal(jparams):
    runs = [_run("torch", *_tengine(jparams),
                 tsched.make_requests(**OVERLOAD_KW), res_kw=OVERLOAD_RES)
            for _ in range(2)]
    assert runs[0] == runs[1]


# ------------------------------------------------- the scheduler alone


def test_instant_completions_never_drop_the_queue(jparams):
    """Every admission finishing inside the admit pass (max_new 1, or
    the adapt-time cap of 1) leaves the accepted queue full with the
    slots empty: the loop admits again; and with a future arrival
    pending it admits the queue before warping the clock."""
    engine, model = _tengine(jparams)
    s = tsched.run_serve(engine, model, tsched.make_requests(
        6, prompt_pad=4, vocab_size=64, max_new=1, rate=0.0, seed=4))
    assert s["completed"] == 6 and s["partition"]["admission_exact"]
    engine2, model2 = _tengine(jparams, adapt_ladder=(4, 1))
    res = tres.ResilienceConfig(adapt=True, max_new_cap=1, depth_high=0.5,
                                depth_low=0.0, trip_ticks=1,
                                clear_ticks=99, window=1)
    s2 = tsched.run_serve(engine2, model2, tsched.make_requests(
        8, prompt_pad=4, vocab_size=64, max_new=4, rate=0.0, seed=4),
        resilience=res, virtual=tres.VirtualTiming())
    assert s2["completed"] == 8 and s2["partition"]["admission_exact"]
    engine3, model3 = _tengine(jparams)
    base = tsched.make_requests(4, prompt_pad=4, vocab_size=64, max_new=1,
                                rate=0.0, seed=4)
    reqs3 = [dataclasses.replace(r, arrival_s=a)
             for r, a in zip(base, [0.0, 0.0, 0.0, 5.0])]
    s3 = tsched.run_serve(engine3, model3, reqs3,
                          resilience=tres.ResilienceConfig(
                              ttft_deadline_s=0.05),
                          virtual=tres.VirtualTiming())
    assert s3["completed"] == 4 and s3["expired_in_queue"] == 0, \
        s3["partition"]
    assert s3["ttft_p99_s"] < 0.05


def test_stale_arrival_expires_instead_of_shedding(jparams):
    """At one sampled boundary dead queue heads expire BEFORE fresh
    arrivals meet the cap: rid 3 is accepted and served, rids 1 and 2
    expire, nothing is shed."""
    engine, model = _tengine(jparams, slots=1)
    base = tsched.make_requests(4, prompt_pad=4, vocab_size=64,
                                max_new=12, rate=0.0, seed=6)
    requests = [dataclasses.replace(r, arrival_s=a)
                for r, a in zip(base, [0.0, 0.001, 0.002, 0.010])]
    m = RecMetrics()
    s = tsched.run_serve(engine, model, requests, metrics=m,
                         resilience=tres.ResilienceConfig(
                             queue_cap=2, ttft_deadline_s=0.005),
                         virtual=tres.VirtualTiming())
    assert s["partition"]["admission_exact"]
    assert s["shed_at_admission"] == 0, s["partition"]
    assert {r["rid"] for r in m.recs if r.get("event") == tres.EXPIRED} \
        == {1, 2}
    assert s["admitted"] == 2 and s["completed"] == 2


def test_resilience_off_is_the_open_loop(jparams):
    """The default config is OFF: nothing shed, expired or validated
    away, every request completed, on the one decode program."""
    engine, model = _tengine(jparams)
    s = tsched.run_serve(engine, model, tsched.make_requests(
        8, prompt_pad=4, vocab_size=64, max_new=4, rate=0.0, seed=5))
    assert s["completed"] == 8
    assert s["shed_total"] == 0 and s["shed_fraction"] == 0.0
    assert s["partition"]["admission_exact"]
    assert s["serve_shed_status"] == "success"
    assert s["adapt_level"] == 0 and s["adapt_transitions"] == []
    assert s["decode_k_ladder"] == [4]
    assert (s["prefill_compiles"], s["decode_compiles"]) == (1, 1)


# ------------------------------------------------------------ the engine


def _state_vectors(state):
    return {name: np.asarray(getattr(state, name))
            for name in ("lengths", "last_token", "active", "remaining")}


@pytest.mark.parametrize("layout", ["st", "hs"])
def test_engine_outputs_equal_jax_step_by_step(jparams, layout):
    """A scripted sequence (two admissions, a slot refilled, supersteps
    on every rung, some with no slot active, where the JAX superstep
    skips by lax.cond and the port's masks freeze the batch): the tokens,
    valid flags and state vectors equal the JAX engine's after every
    call, and the cache equals it below each slot's length."""
    ladder = (4, 2, 1)
    je, jp = _jengine(jparams, adapt_ladder=ladder, layout=layout)
    te, tp = _tengine(jparams, adapt_ladder=ladder, layout=layout)
    js, ts = je.init_state(), te.init_state()
    reqs = jsched.make_requests(3, prompt_pad=4, vocab_size=64, max_new=9,
                                rate=0.0, seed=8)
    script = [("prefill", reqs[0], 0, 3), ("prefill", reqs[1], 1, 9),
              ("decode", 4), ("decode", 2), ("prefill", reqs[2], 0, 2),
              ("decode", 1), ("decode", 4), ("decode", 4), ("decode", 4)]
    for step in script:
        if step[0] == "prefill":
            _, r, slot, max_new = step
            js, jfirst = je.prefill(jp, js, r.tokens[None, :], r.prompt_len,
                                    slot, max_new)
            ts, tfirst = te.prefill(tp, ts, r.tokens[None, :], r.prompt_len,
                                    slot, max_new)
            assert int(tfirst) == int(jfirst), step
        else:
            js, jt, jv = je.decode(jp, js, step[1])
            ts, tt, tv = te.decode(tp, ts, step[1])
            np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        want = _state_vectors(js)
        for name, got in _state_vectors(ts).items():
            np.testing.assert_array_equal(got, want[name], err_msg=name)
        for name in ("cache_k", "cache_v"):
            jc = np.asarray(jax.device_get(getattr(js, name)))
            tc = getattr(ts, name).numpy()
            if layout == "hs":
                jc, tc = jc.swapaxes(2, 3), tc.swapaxes(2, 3)
            for slot, n in enumerate(want["lengths"]):
                np.testing.assert_allclose(tc[:, slot, :n], jc[:, slot, :n],
                                           rtol=0, atol=1e-5,
                                           err_msg=f"{name} {step}")
    assert not want["active"].any()
    assert je.compile_counts() == te.compile_counts() == (1, 3)


def test_engine_ladder_and_program_pin(jparams):
    engine, model = _tengine(jparams, adapt_ladder=(4, 2, 1))
    assert engine.compile_counts() == (1, 3)
    engine.warmup(model)                 # builds nothing more
    engine.assert_two_programs()
    state = engine.init_state()
    for k in (4, 2, 1, None):
        state, _, _ = engine.decode(model, state, k)
    assert engine.compile_counts() == (1, 3)
    with pytest.raises(ValueError, match="not a warmed ladder rung"):
        engine.decode(model, state, 3)
    engine.prefill_traces.append("prefill")
    with pytest.raises(AssertionError, match="two-program contract"):
        engine.assert_two_programs()
    for ladder in ((4, 4, 2), (8, 4), (4, 2, 0)):
        with pytest.raises(ValueError, match="adapt_ladder"):
            TServeEngine(_tcfg(TINY_TF), device="cpu", **ENGINE_KW,
                         adapt_ladder=ladder)
    # the CPU route runs no kernel: nothing launched, nothing captured
    assert engine.kernel_launches() == 0


def test_engine_refuses_a_foreign_state_or_params(jparams):
    engine, model = _tengine(jparams)
    state = engine.init_state()
    assert state is engine.init_state()
    other_state = TServeEngine(_tcfg(TINY_TF), device="cpu",
                               **ENGINE_KW).init_state()
    tokens = np.zeros((1, 4), np.int32)
    with pytest.raises(ValueError, match="not this engine's"):
        engine.prefill(model, other_state, tokens, 2, 0, 3)
    with pytest.raises(ValueError, match="not this engine's"):
        engine.decode(model, state._replace(lengths=state.lengths.clone()))
    other_model = ttf.Transformer(_tcfg(TINY_TF), device="cpu")
    other_model.load_state_dict(model.state_dict())
    with pytest.raises(ValueError, match="params are not those"):
        engine.decode(other_model, state)
    with pytest.raises(ValueError, match="params are not those"):
        engine.warmup(other_model)
    engine.prefill(model, state, tokens, 2, 1, 3)
    assert int(state.lengths[1]) == 2 and bool(state.active[1])


# ------------------------------------------------- copies of JAX modules


def test_resilience_copy_equals_jax():
    for name in ("ADMITTED", "SHED", "EXPIRED", "REJECTED", "DONE",
                 "EVICTED", "LOST", "TERMINAL_EVENTS", "ADMISSION_EVENTS",
                 "OUTCOME_EVENTS"):
        assert getattr(tres, name) == getattr(jres, name), name
    for cls in ("ShedLedger", "ResilienceConfig", "VirtualTiming"):
        tf = [(f.name, f.default) for f in
              dataclasses.fields(getattr(tres, cls))]
        jf = [(f.name, f.default) for f in
              dataclasses.fields(getattr(jres, cls))]
        assert tf[:len(jf)] == jf and len(tf) == len(jf), cls
    for k in range(1, 12):
        for levels in (1, 2, 3, 5):
            assert tres.default_ladder(k, levels) == \
                jres.default_ladder(k, levels)
    led = {}
    for lib in (tres, jres):
        led[lib] = lib.ShedLedger()
        assert led[lib].exact and led[lib].shed_fraction() is None
        for field, v in (("arrived", 10), ("admitted", 6),
                         ("shed_admission", 2), ("expired_queue", 1),
                         ("rejected", 1), ("completed", 4), ("evicted", 1),
                         ("lost", 1)):
            setattr(led[lib], field, v)
    assert led[tres].as_dict() == led[jres].as_dict()
    assert led[tres].as_dict()["shed_fraction"] == 0.4
    led[tres].arrived = 11
    assert not led[tres].exact
    for res in (tres, jres):
        assert not res.ResilienceConfig().enabled
        assert res.ResilienceConfig(validate=True).enabled


@pytest.mark.parametrize("cfg_kw,script", [
    (dict(adapt=True, depth_high=5.0, depth_low=1.0, trip_ticks=2,
          clear_ticks=3, window=2),
     [(d, None) for d in [10] * 6 + [3] * 10 + [0] * 13]),
    (dict(adapt=True, depth_high=100.0, depth_low=50.0, itl_high_s=0.01,
          itl_low_s=0.001, trip_ticks=1, clear_ticks=1, window=1),
     [(0, 0.5), (0, 0.0005), (0, 0.02), (0, None), (0, 0.005)]),
])
def test_pressure_controller_and_clock_equal_jax(cfg_kw, script):
    """The controller's transitions (levels and reasons) on scripted
    (depth, itl) series, and the virtual clock, equal the JAX copy's."""
    pcs = [lib.PressureController(lib.ResilienceConfig(**cfg_kw),
                                  max_level=2) for lib in (tres, jres)]
    for depth, itl in script:
        assert pcs[0].observe(depth, itl) == pcs[1].observe(depth, itl)
    assert pcs[0].transitions == pcs[1].transitions
    assert pcs[0].transitions
    clocks = [tres.VirtualClock(), jres.VirtualClock()]
    for op, v in (("advance", 0.5), ("advance", -1.0), ("wait_until", 0.2),
                  ("wait_until", 1.0), ("advance", 0.004)):
        assert getattr(clocks[0], op)(v) == getattr(clocks[1], op)(v)
        assert clocks[0]() == clocks[1]()


def test_validate_request_equals_jax():
    good = tsched.make_requests(16, prompt_pad=8, vocab_size=64, max_new=4,
                                rate=100.0, seed=7)
    base = good[0]
    bad = [dataclasses.replace(base, prompt_len=0),
           dataclasses.replace(base, prompt_len=9),
           dataclasses.replace(base, prompt_len=3.0),
           dataclasses.replace(base, max_new=0),
           dataclasses.replace(base, max_new=-3),
           dataclasses.replace(base, tokens=np.zeros((11,), np.int32)),
           dataclasses.replace(base, tokens=np.zeros((8,), np.float64)),
           dataclasses.replace(base, tokens=np.full((8,), 64, np.int32)),
           dataclasses.replace(base, tokens=np.full((8,), -1, np.int32))]
    reasons = set()
    for r in good + bad:
        got = tsched.validate_request(r, prompt_pad=8, vocab_size=64)
        assert got == jsched.validate_request(r, prompt_pad=8,
                                              vocab_size=64)
        reasons.add(got)
    assert reasons == {None, "bad_prompt_len", "bad_max_new", "bad_shape",
                       "bad_dtype", "bad_token"}


# ------------------------------------------------------------- the CLI


def _options(parse_args):
    """Every option string ``parse_args([])`` declares, with its
    add_argument keywords (recorded by wrapping the parser)."""
    seen = {}
    real = argparse.ArgumentParser.add_argument

    def record(self, *names, **kw):
        seen.update(dict.fromkeys(names, kw))
        return real(self, *names, **kw)
    with mock.patch.object(argparse.ArgumentParser, "add_argument", record):
        parse_args([])
    return seen


def _turn_on(kw, off):
    """Command-line words that give an option a value other than its
    default and its ``off`` values."""
    default = kw.get("default")
    if kw.get("choices"):
        return [next(c for c in kw["choices"]
                     if c != default and c not in off)]
    step = {int: 3, float: 1.5}.get(kw.get("type"))
    return [str((default or 0) + step)] if step else ["x"]


# variables a JAX serve help string names that no port table lists: read
# by the JAX package only under --serve-tune, which the port refuses
ENV_ONLY_UNDER_REFUSED = {"TPUDIST_AUTOTUNE_CACHE_DIR"}
CARRIED_ENV = ("TPUDIST_SERVE_QUEUE_CAP", "TPUDIST_SERVE_TTFT_DEADLINE_MS",
               "TPUDIST_SERVE_ADAPT", "TPUDIST_SERVE_VIRTUAL_CLOCK",
               "TPUDIST_TRACE", "TPUDIST_TRACE_DIR")


def test_every_jax_serve_flag_is_carried_or_refused():
    """Each option string of the JAX serve parser is declared by the
    port's with the JAX default. Those the port does not carry parse at
    their JAX "off" values and are refused at any other naming their
    Queue A item; every ``$TPUDIST_`` variable a JAX help string names
    is a carried twin or refused when set (``ENV_NOT_CARRIED``)."""
    jax_opts = _options(jcli.parse_args)
    port_opts = _options(tcli.parse_args)
    rows = {flag: row for flag, *row in tcli.NOT_CARRIED}
    assert set(rows) <= set(jax_opts)
    for opt, kw in jax_opts.items():
        assert opt in port_opts, opt
        assert port_opts[opt].get("default") == kw.get("default"), opt
        named = re.findall(r"\$(TPUDIST_\w+)", kw.get("help", ""))
        assert set(named) <= set(tcli.ENV_NOT_CARRIED) | set(CARRIED_ENV) \
            | ENV_ONLY_UNDER_REFUSED, (opt, named)
        if opt not in rows:
            continue
        _, off, env, item = rows[opt]
        assert env is None or env in named or env == "TPUDIST_TRACE", opt
        for value in off:
            tcli.parse_args([opt, str(value)])
        with pytest.raises(ValueError,
                           match=f"ROADMAP Queue A item {item}$"):
            tcli.parse_args([opt, *_turn_on(kw, off)])
    args = tcli.parse_args([])
    tcli.check_supported(args)
    with pytest.raises(ValueError, match="ROADMAP Queue A item 6$"):
        tcli.check_supported(tcli.parse_args(["--model", "moe"]))


@pytest.mark.parametrize("flag,words", [
    ("--kv-page-tokens", ["8"]), ("--kv-pages", ["4"]),
    ("--shared-prefix", ["4"]), ("--speculate-k", ["2"]),
    ("--requeue-attempt", ["0"]), ("--chaos", ["serve_kill@0:6"]),
    ("--serve-tune", ["probe"]), ("--tune-cache-dir", ["tune"]),
    ("--model", ["moe"]), ("--trace", ["on"]), ("--trace-dir", ["traces"]),
    ("--live-port", ["9100"]),
])
def test_flags_not_carried_exit_1_naming_their_item(flag, words, tmp_path,
                                                    capsys, monkeypatch):
    """Refused flags exit 1 naming their Queue A item and write nothing;
    ``--trace`` and ``--trace-dir``, refused until the port carried
    them, now serve and put the trace where they say."""
    if flag in ("--trace", "--trace-dir"):
        monkeypatch.chdir(tmp_path)
        assert tcli.main([flag, *words, "--device", "cpu", "--requests",
                          "2", "--max-new-tokens", "2", "--save-dir",
                          str(tmp_path / "run")]) == 0
        traced = tmp_path / ("traces" if flag == "--trace-dir" else "run")
        assert (traced / "pod_trace.json").is_file()
        return
    item = "11b" if flag == "--live-port" else 6
    assert tcli.main([flag, *words, "--device", "cpu", "--save-dir",
                      str(tmp_path)]) == 1
    assert re.search(f"ROADMAP Queue A item {item}'",
                     capsys.readouterr().err)
    assert not (tmp_path / "metrics.jsonl").exists()


ENV_ON = {"TPUDIST_CHAOS": "serve_kill@0:6", "TPUDIST_SERVE_TUNE": "probe",
          "TPUDIST_LIVE": "on"}


@pytest.mark.parametrize("name", sorted(set(tcli.ENV_NOT_CARRIED)
                                        | {"TPUDIST_TRACE",
                                           "TPUDIST_TRACE_DIR"}))
def test_env_twins_of_features_not_carried_are_refused(name, monkeypatch,
                                                       tmp_path, capsys):
    """Each variable is tolerated unset and at the values that leave its
    feature off in the JAX package; set on, the CLI exits 1 naming its
    Queue A item and writes a fail verdict. ``TPUDIST_TRACE`` and
    ``TPUDIST_TRACE_DIR``, refused until the port carried them, now
    serve as the JAX CLI reads them: tracing off, or the trace in that
    directory."""
    if name in ("TPUDIST_TRACE", "TPUDIST_TRACE_DIR"):
        value = "off" if name == "TPUDIST_TRACE" else str(tmp_path / "tr")
        monkeypatch.setenv(name, value)
        monkeypatch.setenv("TPUDIST_VERDICT_PATH", str(tmp_path / "v.txt"))
        assert tcli.main(["--device", "cpu", "--requests", "2",
                          "--max-new-tokens", "2", "--save-dir",
                          str(tmp_path / "run")]) == 0
        assert (tmp_path / "v.txt").read_text() == "success"
        if name == "TPUDIST_TRACE":
            assert not (tmp_path / "run" / "pod_trace.json").exists()
        else:
            assert (tmp_path / "tr" / "pod_trace.json").is_file()
        return
    args = tcli.parse_args([])
    off, item = tcli.ENV_NOT_CARRIED[name]
    for value in off:
        if value is not None:
            monkeypatch.setenv(name, str(value).upper())
            tcli.check_supported(args)
    monkeypatch.setenv(name, ENV_ON.get(name, "3"))
    monkeypatch.setenv("TPUDIST_VERDICT_PATH", str(tmp_path / "v.txt"))
    assert tcli.main(["--device", "cpu", "--save-dir",
                      str(tmp_path)]) == 1
    assert re.search(f"ROADMAP Queue A item {item}'", capsys.readouterr().err)
    assert (tmp_path / "v.txt").read_text() == "fail"


@pytest.mark.parametrize("env", [
    {}, {"TPUDIST_SERVE_QUEUE_CAP": "4"}, {"TPUDIST_SERVE_QUEUE_CAP": "x"},
    {"TPUDIST_SERVE_TTFT_DEADLINE_MS": "12.5"},
    {"TPUDIST_SERVE_TTFT_DEADLINE_MS": "soon"},
    {"TPUDIST_SERVE_ADAPT": "on"}, {"TPUDIST_SERVE_ADAPT": "ON"},
    {"TPUDIST_SERVE_VIRTUAL_CLOCK": "1"},
    {"TPUDIST_SERVE_VIRTUAL_CLOCK": "True"},
    {"TPUDIST_SERVE_VIRTUAL_CLOCK": "no"},
])
def test_carried_twins_are_read_as_jax_reads_them(env, monkeypatch):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    for argv in ([], ["--queue-cap", "2", "--adapt", "off"]):
        t, j = tcli.parse_args(argv), jcli.parse_args(argv)
        for dest in ("queue_cap", "ttft_deadline_ms", "adapt",
                     "adapt_max_new_cap", "virtual_clock",
                     "virtual_prefill_ms", "virtual_decode_ms", "decode_k",
                     "slots", "max_seq", "prompt_pad", "requests",
                     "request_rate", "max_new_tokens", "seed"):
            assert getattr(t, dest) == getattr(j, dest), (env, argv, dest)


def test_cli_runs_the_resilience_plane_on_the_cpu(tmp_path, monkeypatch,
                                                  capsys):
    """The carried twins drive the CLI end to end: a bounded queue, a
    deadline, the (8, 4, 2) ladder and virtual time give an exact
    partition with shedding, four programs, and the new fields in
    BENCH_SERVE.json."""
    monkeypatch.setenv("TPUDIST_SERVE_QUEUE_CAP", "4")
    monkeypatch.setenv("TPUDIST_SERVE_TTFT_DEADLINE_MS", "30")
    monkeypatch.setenv("TPUDIST_SERVE_ADAPT", "on")
    monkeypatch.setenv("TPUDIST_SERVE_VIRTUAL_CLOCK", "on")
    bench = tmp_path / "BENCH_SERVE.json"
    assert tcli.main(["--device", "cpu", "--requests", "24",
                      "--request-rate", "1000", "--save-dir",
                      str(tmp_path), "--bench-out", str(bench)]) == 0
    assert "tpudist: serve success:" in capsys.readouterr().out
    recs = [json.loads(line) for line in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    rec = [r for r in recs if r["kind"] == "serve"][0]
    assert rec["queue_cap"] == 4 and rec["ttft_deadline_s"] == 0.03
    assert rec["decode_k_ladder"] == [8, 4, 2]
    assert (rec["prefill_compiles"], rec["decode_compiles"]) == (1, 3)
    assert rec["partition"]["admission_exact"] \
        and rec["partition"]["outcome_exact"]
    assert rec["shed_total"] > 0 and rec["arrived"] == 24
    detail = json.loads(bench.read_text())["detail"]
    assert detail["shed_fraction"] == rec["shed_fraction"]
    assert detail["decode_compiles"] == 3
