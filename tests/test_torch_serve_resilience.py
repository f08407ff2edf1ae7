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
  runs the resilience plane, the paged plane, the serve tuner and the
  chaos surface end to end on the CPU.
"""

import argparse
import dataclasses
import json
import re
import urllib.request
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
from tpudist_torch.obs import live as tlive
from tpudist_torch.serve import cli as tcli
from tpudist_torch.serve import resilience as tres
from tpudist_torch.serve import scheduler as tsched
from tpudist_torch.serve.engine import ServeEngine as TServeEngine
from _torch_ranks import free_port as _free_port

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


# the paged plane's twins, refused until the port carried them
PAGED_ENV = {"TPUDIST_SERVE_KV_PAGE_TOKENS": "4",
             "TPUDIST_SERVE_KV_PAGES": "24",
             "TPUDIST_SERVE_SHARED_PREFIX": "4",
             "TPUDIST_SERVE_SPECULATE_K": "3"}
# the chaos plane's and the serve tuner's, refused until the port
# carried them (the cache directory's is read under --serve-tune only)
TUNE_CHAOS_ENV = {"TPUDIST_CHAOS": "request_garbage@0:0,n=2",
                  "TPUDIST_SERVE_TUNE": "probe",
                  "TPUDIST_AUTOTUNE_CACHE_DIR": "cache"}
CARRIED_ENV = ("TPUDIST_SERVE_QUEUE_CAP", "TPUDIST_SERVE_TTFT_DEADLINE_MS",
               "TPUDIST_SERVE_ADAPT", "TPUDIST_SERVE_VIRTUAL_CLOCK",
               "TPUDIST_TRACE", "TPUDIST_TRACE_DIR", *PAGED_ENV,
               *TUNE_CHAOS_ENV, "TPUDIST_LIVE_PORT")


def test_every_jax_serve_flag_is_carried_or_refused():
    """Each option string of the JAX serve parser is declared by the
    port's with the JAX default, and every ``$TPUDIST_`` variable a JAX
    help string names is a twin the port reads (``CARRIED_ENV``). Since
    the port carried ``--live-port`` (ROADMAP Queue A item 11b) the
    serve CLI refuses no option, the MoE's included."""
    jax_opts = _options(jcli.parse_args)
    port_opts = _options(tcli.parse_args)
    for opt, kw in jax_opts.items():
        assert opt in port_opts, opt
        assert port_opts[opt].get("default") == kw.get("default"), opt
        named = re.findall(r"\$(TPUDIST_\w+)", kw.get("help", ""))
        assert set(named) <= set(CARRIED_ENV), (opt, named)
    assert not hasattr(tcli, "NOT_CARRIED")
    assert tcli.parse_args(["--model", "moe"]).model == "moe"


@pytest.mark.parametrize("flag,words", [
    ("--kv-page-tokens", ["8"]), ("--kv-pages", ["40"]),
    ("--shared-prefix", ["4"]), ("--speculate-k", ["2"]),
    ("--requeue-attempt", ["0"]), ("--chaos", ["request_garbage@0:0,n=2"]),
    ("--serve-tune", ["probe"]), ("--tune-cache-dir", ["tune"]),
    ("--model", ["moe"]), ("--trace", ["on"]), ("--trace-dir", ["traces"]),
    ("--live-port", []),
])
def test_flags_not_carried_exit_1_naming_their_item(flag, words, tmp_path,
                                                    capsys, monkeypatch):
    """The flags refused until the port carried them serve:
    ``--trace`` and ``--trace-dir``, the paged plane's four flags,
    ``--requeue-attempt``, ``--chaos``, ``--serve-tune`` and
    ``--tune-cache-dir``, and ``--model moe``, refused until the port
    carried them: the trace where they say, a paged run with
    its summary fields set, and a run with the JAX meaning of each
    (:func:`_assert_carried_run`; the MoE's run serves the MoE), and so
    does ``--live-port``, which serves the aggregator on a port picked
    free (:func:`_assert_live_port_run`)."""
    if flag in TUNE_CHAOS_FLAGS or flag == "--model":
        monkeypatch.chdir(tmp_path)
        _assert_carried_run(tmp_path, [flag, *words], flag)
        return
    if flag in PAGED_FLAGS:
        argv = [flag, *words]
        if flag != "--kv-page-tokens":
            argv += ["--kv-page-tokens", "4"]
        _assert_paged_run(tmp_path, argv, {flag[2:].replace("-", "_"):
                                           int(words[0])})
        return
    if flag in ("--trace", "--trace-dir"):
        monkeypatch.chdir(tmp_path)
        assert tcli.main([flag, *words, "--device", "cpu", "--requests",
                          "2", "--max-new-tokens", "2", "--save-dir",
                          str(tmp_path / "run")]) == 0
        traced = tmp_path / ("traces" if flag == "--trace-dir" else "run")
        assert (traced / "pod_trace.json").is_file()
        return
    assert flag == "--live-port"
    _assert_live_port_run(tmp_path, monkeypatch, env=False)



def _assert_live_port_run(tmp_path, monkeypatch, env: bool):
    """``--live-port P`` (or ``TPUDIST_LIVE_PORT=P`` when ``env``) serves
    the live aggregator while the run lives, as the JAX CLI does: the
    exporter's line, ``/metrics`` with the serve gauges, ``/healthz`` and
    ``/status.json`` answered (scraped before the exporter closes), the
    aggregator's ``live_status.json`` counting every record, and the
    run's tokens those of a run without the exporter."""
    port = _free_port()
    scraped = {}
    real_close = tlive.LiveHttpServer.close

    def close(self):
        for path in ("/metrics", "/healthz", "/status.json"):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{self.port}{path}", timeout=5) as r:
                scraped[path] = r.read().decode()
        real_close(self)
    summaries = []
    real_run = tcli.run

    def run(args):
        summaries.append(real_run(args))
        return summaries[-1]
    argv = ["--device", "cpu", "--requests", "4", "--max-new-tokens", "4"]
    if env:
        monkeypatch.setenv("TPUDIST_LIVE_PORT", str(port))
    with mock.patch.object(tcli, "run", run), \
            mock.patch.object(tlive.LiveHttpServer, "close", close):
        assert tcli.main(argv + ([] if env else ["--live-port", str(port)])
                         + ["--save-dir", str(tmp_path / "live")]) == 0
        monkeypatch.delenv("TPUDIST_LIVE_PORT", raising=False)
        assert tcli.main(argv + ["--save-dir", str(tmp_path / "plain")]) == 0
    assert "tpudist_serve_completed_total 4" in scraped["/metrics"]
    assert "tpudist_serve_generated_tokens_total" in scraped["/metrics"]
    assert json.loads(scraped["/healthz"]) == {"ok": True}
    assert json.loads(scraped["/status.json"])["pod"]["serve"][
        "completed"] == 4
    recs = [json.loads(line) for line in (
        tmp_path / "live" / "metrics.jsonl").read_text().splitlines()]
    status = json.loads((tmp_path / "live" / "live_status.json").read_text())
    assert status["counters"]["records"] == len(recs)
    assert not (tmp_path / "plain" / "live_status.json").exists()
    live, plain = ({rid: r["tokens"] for rid, r in sm["results"].items()}
                   for sm in summaries)
    assert live == plain and len(live) == 4


PAGED_FLAGS = ("--kv-page-tokens", "--kv-pages", "--shared-prefix",
               "--speculate-k")
TUNE_CHAOS_FLAGS = ("--requeue-attempt", "--chaos", "--serve-tune",
                    "--tune-cache-dir")


def _assert_carried_run(tmp_path, argv, what):
    """The CLI serves on the CPU with ``argv`` (exit 0, a success
    verdict) with the JAX meaning of ``what``: ``--requeue-attempt``
    stamps its attempt on every record; ``--chaos`` request_garbage
    rejects its requests with named reasons, after a flushed kind=chaos
    record; ``--serve-tune`` (or its twin) tunes by probe into
    ``<save-dir>/tune`` (or ``$TPUDIST_AUTOTUNE_CACHE_DIR``) and serves
    at the committed point; ``--tune-cache-dir`` alone tunes nothing."""
    save = tmp_path / "run"
    verdict = tmp_path / "v.txt"
    with mock.patch.dict("os.environ",
                         {"TPUDIST_VERDICT_PATH": str(verdict)}):
        assert tcli.main(argv + ["--device", "cpu", "--requests", "4",
                                 "--max-new-tokens", "4", "--save-dir",
                                 str(save)]) == 0
    assert verdict.read_text() == "success"
    recs = [json.loads(line) for line in
            (save / "metrics.jsonl").read_text().splitlines()]
    rec = [r for r in recs if r["kind"] == "serve"][0]
    assert rec["model"] == (argv[1] if what == "--model" else "transformer")
    tune = [r for r in recs if r["kind"] == "serve_tune"]
    chaos = [r for r in recs if r["kind"] == "chaos"]
    assert rec["completed"] == 4 and rec["requeue_attempt"] == 0
    assert all(r["requeue_attempt"] == 0 for r in recs)
    if what in ("--chaos", "TPUDIST_CHAOS"):
        assert [c["fault"] for c in chaos] == ["request_garbage"]
        assert rec["rejected"] == 2 and rec["arrived"] == 6
        assert all(r["reason"] for r in recs if r["kind"] ==
                   "serve_request" and r["event"] == "rejected")
    else:
        assert not chaos and rec["rejected"] == 0
    if what in ("--serve-tune", "TPUDIST_SERVE_TUNE",
                "TPUDIST_AUTOTUNE_CACHE_DIR"):
        cache = tmp_path / "cache" if what == "TPUDIST_AUTOTUNE_CACHE_DIR" \
            else save / "tune"
        assert len(tune) == 1 and tune[0]["source"] == "probe"
        assert tune[0]["status"] == "success" and tune[0]["pruned"] == 0
        assert rec["decode_k"] == tune[0]["decode_k"]
        assert len(list(cache.glob("serve-*.json"))) == 1
    else:
        assert not tune and not (save / "tune").exists()
        assert not (tmp_path / "tune").exists()
# the summary key each paged flag and twin sets
PAGED_KEY = {"kv_page_tokens": "kv_page_tokens",
             "kv_pages": "kv_pages_total",
             "shared_prefix": "shared_prefix_len",
             "speculate_k": "speculate_k"}


def _assert_paged_run(tmp_path, argv, want):
    """The CLI serves every request on the CPU through the paged engine
    with ``argv``, exit 0, and its kind=serve record carries the paged
    fields, ``want`` among them."""
    save = tmp_path / "run"
    assert tcli.main(argv + ["--device", "cpu", "--requests", "4",
                             "--max-new-tokens", "4", "--save-dir",
                             str(save)]) == 0
    recs = [json.loads(line) for line in
            (save / "metrics.jsonl").read_text().splitlines()]
    rec = [r for r in recs if r["kind"] == "serve"][0]
    assert rec["completed"] == 4 and rec["kv_page_tokens"] > 0
    assert rec["kv_pages_used_peak"] >= 1
    assert rec["verify_compiles"] == (1 if rec["speculate_k"] else 0)
    for dest, value in want.items():
        assert rec[PAGED_KEY[dest]] == value, dest


def _assert_live_run(tmp_path, monkeypatch):
    """``TPUDIST_LIVE`` on (``on``, ``1``, ``true``) runs the live
    aggregator over every record the CLI logs, under a tightened shed
    gate: ``live_status.json`` counts the records ``metrics.jsonl``
    holds, and ``alerts.jsonl`` holds the ``serve_shed`` alert the
    failed gate had mid-run; any other value (``off``) writes neither
    file, as in the JAX CLI."""
    monkeypatch.setenv("TPUDIST_SERVE_SHED_MAX", "0.05")
    argv = ["--device", "cpu", "--virtual-clock", "--requests", "24",
            "--request-rate", "500", "--queue-cap", "2",
            "--max-new-tokens", "4"]
    for value in ("on", "1", "TRUE", "off"):
        monkeypatch.setenv("TPUDIST_LIVE", value)
        save = tmp_path / value
        assert tcli.main(argv + ["--save-dir", str(save)]) == 1
        recs = [json.loads(line) for line in
                (save / "metrics.jsonl").read_text().splitlines()]
        assert [r["serve_shed_status"] for r in recs
                if r["kind"] == "serve"] == ["fail"]
        if value == "off":
            assert not (save / "live_status.json").exists()
            assert not (save / "alerts.jsonl").exists()
            continue
        status = json.loads((save / "live_status.json").read_text())
        assert status["counters"]["records"] == len(recs)
        assert status["run_id"] == recs[0]["run_id"]
        assert status["pod"]["serve"]["shed_fraction"] > 0.05
        alerts = [json.loads(a) for a in
                  (save / "alerts.jsonl").read_text().splitlines()]
        assert [(a["alert"], a["state"]) for a in alerts][0] == (
            "serve_shed", "firing")


# the twins refused until the port carried them, run as the JAX CLI
# reads them: the live aggregator's files and its exporter, the
# platform's device
LIVE_PLATFORM_ENV = ("TPUDIST_LIVE", "TPUDIST_LIVE_PORT", "TPUDIST_PLATFORM")


@pytest.mark.parametrize("name", sorted({"TPUDIST_TRACE",
                                         "TPUDIST_TRACE_DIR"}
                                        | set(PAGED_ENV)
                                        | set(TUNE_CHAOS_ENV)
                                        | set(LIVE_PLATFORM_ENV)))
def test_env_twins_of_features_not_carried_are_refused(name, monkeypatch,
                                                       tmp_path, capsys):
    """Each twin the JAX serve CLI reads, refused by the port until it
    carried it, serves as the JAX CLI reads it. ``TPUDIST_TRACE`` and
    ``TPUDIST_TRACE_DIR``, the paged plane's four twins,
    ``TPUDIST_CHAOS`` and ``TPUDIST_SERVE_TUNE`` (with
    ``TPUDIST_AUTOTUNE_CACHE_DIR``), ``TPUDIST_LIVE`` and
    ``TPUDIST_LIVE_PORT``: tracing off, the trace in that directory, a
    paged run with the twin's value in its summary, a chaos run, a tuned
    run, the live aggregator's files, or its exporter. ``TPUDIST_PLATFORM`` picks the device ``--device`` leaves
    unset, and any word but cpu, cuda or gpu exits 1 naming it."""
    if name == "TPUDIST_LIVE":
        _assert_live_run(tmp_path, monkeypatch)
        return
    if name == "TPUDIST_LIVE_PORT":
        _assert_live_port_run(tmp_path, monkeypatch, env=True)
        return
    if name == "TPUDIST_PLATFORM":
        monkeypatch.setenv(name, "cpu")
        monkeypatch.setenv("TPUDIST_VERDICT_PATH", str(tmp_path / "v.txt"))
        assert tcli.main(["--requests", "2", "--max-new-tokens", "2",
                          "--save-dir", str(tmp_path / "run")]) == 0
        assert "[cpu, float32" in capsys.readouterr().out
        monkeypatch.setenv(name, "tpu")
        assert tcli.main(["--save-dir", str(tmp_path / "tpu")]) == 1
        assert "TPUDIST_PLATFORM=tpu:" in capsys.readouterr().err
        assert (tmp_path / "v.txt").read_text() == "fail"
        return
    if name in TUNE_CHAOS_ENV:
        monkeypatch.chdir(tmp_path)
        monkeypatch.setenv(name, TUNE_CHAOS_ENV[name])
        if name == "TPUDIST_AUTOTUNE_CACHE_DIR":
            monkeypatch.setenv("TPUDIST_SERVE_TUNE", "probe")
        _assert_carried_run(tmp_path, [], name)
        return
    if name in PAGED_ENV:
        monkeypatch.setenv(name, PAGED_ENV[name])
        if name != "TPUDIST_SERVE_KV_PAGE_TOKENS":
            monkeypatch.setenv("TPUDIST_SERVE_KV_PAGE_TOKENS", "8")
        dest = name[len("TPUDIST_SERVE_"):].lower()
        _assert_paged_run(tmp_path, [], {dest: int(PAGED_ENV[name])})
        return
    assert name in ("TPUDIST_TRACE", "TPUDIST_TRACE_DIR")
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


@pytest.mark.parametrize("env", [
    {}, {"TPUDIST_SERVE_QUEUE_CAP": "4"}, {"TPUDIST_SERVE_QUEUE_CAP": "x"},
    {"TPUDIST_SERVE_TTFT_DEADLINE_MS": "12.5"},
    {"TPUDIST_SERVE_TTFT_DEADLINE_MS": "soon"},
    {"TPUDIST_SERVE_ADAPT": "on"}, {"TPUDIST_SERVE_ADAPT": "ON"},
    {"TPUDIST_SERVE_VIRTUAL_CLOCK": "1"},
    {"TPUDIST_SERVE_VIRTUAL_CLOCK": "True"},
    {"TPUDIST_SERVE_VIRTUAL_CLOCK": "no"},
    {"TPUDIST_SERVE_KV_PAGE_TOKENS": "8", "TPUDIST_SERVE_KV_PAGES": "12"},
    {"TPUDIST_SERVE_SHARED_PREFIX": "6", "TPUDIST_SERVE_SPECULATE_K": "x"},
    {"TPUDIST_SERVE_SPECULATE_K": "4", "TPUDIST_SERVE_KV_PAGES": "0"},
    {"TPUDIST_CHAOS": "serve_kill@0:6", "TPUDIST_SERVE_TUNE": "probe"},
    {"TPUDIST_SERVE_TUNE": "cache-only",
     "TPUDIST_AUTOTUNE_CACHE_DIR": "d"},
])
def test_carried_twins_are_read_as_jax_reads_them(env, monkeypatch):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    for argv in ([], ["--queue-cap", "2", "--adapt", "off"],
                 ["--requeue-attempt", "1", "--tune-cache-dir", "c"]):
        t, j = tcli.parse_args(argv), jcli.parse_args(argv)
        for dest in ("queue_cap", "ttft_deadline_ms", "adapt",
                     "adapt_max_new_cap", "virtual_clock",
                     "virtual_prefill_ms", "virtual_decode_ms", "decode_k",
                     "slots", "max_seq", "prompt_pad", "requests",
                     "request_rate", "max_new_tokens", "seed",
                     "kv_page_tokens", "kv_pages", "shared_prefix",
                     "speculate_k", "chaos", "serve_tune",
                     "tune_cache_dir", "requeue_attempt"):
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


def test_speculate_without_paging_exits_as_jax(tmp_path):
    """``--speculate-k`` without ``--kv-page-tokens`` is the JAX CLI's
    SystemExit naming the flag it needs, before anything is served."""
    for cli, extra in ((tcli, ["--device", "cpu"]), (jcli, [])):
        with pytest.raises(SystemExit, match="kv-page-tokens") as err:
            cli.main(["--speculate-k", "4", "--requests", "1",
                      "--save-dir", str(tmp_path)] + extra)
        assert str(err.value) == ("tpudist: --speculate-k needs the paged "
                                  "KV cache (--kv-page-tokens > 0)")
    assert not (tmp_path / "metrics.jsonl").exists()
