"""The port's measured-probe autotuner (``tpudist_torch.tune``) against the
JAX package's (``tpudist.tune``), and the train CLI's ``--autotune``.

* Search: the port's ``coordinate_search``, ``k_candidates`` and
  ``build_space`` equal the JAX package's on the scripted harnesses of
  ``tests/test_tune.py::TestCoordinateSearch`` and
  ``tpudist/selfcheck.py::check_autotune`` (the same fake timings give
  the same ``best``, ``trials``, ``pruned``, ``exhausted`` and trial
  log), and the constants are the JAX package's.
* Wiring: ``autotune`` of both packages, each with its
  ``probe_candidate`` replaced by one scripted table keyed by the
  candidate, commits the same point from the same probe sequence, with
  the same source, status, trials and ``kind=tune`` record: a probe
  then a cache hit, a cache-only miss, a changed workload that probes
  again, a winner that dies on re-measure.
* Cache and resolvers: round trip, a corrupt or insane file is a miss,
  no tmp file left, the fingerprint's terms; ``resolve_autotune*``
  equal the JAX package's; ``--compilation-cache-dir`` /
  ``TPUDIST_COMPILATION_CACHE_DIR`` set the kernels' build root.
* Probes on the CPU: the real superstep measured, an infeasible slab
  plan pruned, the effective-program key equal to the JAX package's, a
  failing probe pruned, the launch counters, the caller's state and the
  global generator left as they were.
* End to end: a tuned CLI run's per-epoch and per-step losses bitwise
  those of the untuned run at the committed point, then a pure cache
  hit; two gloo ranks whose scripted timings differ both commit rank
  0's point; ``--remat`` leaves the per-step losses as they were.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import pytest
import torch

from tpudist import config as jconfig
from tpudist import data as jdata
from tpudist import tune as jtune
from tpudist.parallel import build_mesh
from tpudist.tune import probe as jprobe
from tpudist.tune import search as jsearch
from tpudist_torch import config as tconfig
from tpudist_torch import data as tdata
from tpudist_torch import engine as tengine
from tpudist_torch import train as ttrain
from tpudist_torch import tune as ttune
from tpudist_torch.ops.cuda import build as tbuild
from tpudist_torch.ops.cuda import flash_attention as tfa
from tpudist_torch.parallel import staging
from tpudist_torch.tune import cache as tcache
from tpudist_torch.tune import probe as tprobe
from tpudist_torch.tune import search as tsearch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _cfgs(**kw):
    """The same TrainConfig in both packages (tests/test_tune.py's
    ``_cfg``)."""
    base = dict(batch_size=16, epochs=1, lr=1e-2, seed=0)
    base.update(kw)
    model = base.pop("model", None)
    j = jconfig.TrainConfig(
        data=jconfig.DataConfig(n_samples=16 * 12),
        **({"model": jconfig.ModelConfig(name=model)} if model else {}),
        **base)
    t = tconfig.TrainConfig(
        data=tconfig.DataConfig(n_samples=16 * 12),
        **({"model": tconfig.ModelConfig(name=model)} if model else {}),
        **base)
    return j, t


# ------------------------------------------------------------- search

def _trial_log(out):
    return [(c.as_dict(), bool(r.feasible), float(r.steps_per_sec),
             bool(getattr(r, "counted", True))) for c, r in out.log]


def _outcome(out):
    return dict(best=out.best.as_dict(), best_sps=out.best_sps,
                baseline=out.baseline.as_dict(),
                baseline_sps=out.baseline_sps, trials=out.trials,
                pruned=out.pruned, exhausted=out.exhausted,
                log=_trial_log(out))


K_AXES = {"k": [1, 2, 4, 8, 16, 32], "staging_budget_mb": [None],
          "remat": [False], "grad_accum_steps": [1]}


def _by_k(table, infeasible=(), raising=()):
    def script(c):
        if c.k in raising:
            raise RuntimeError("scripted probe crash")
        if c.k in infeasible:
            return 0.0, False, 0.0, True
        return table[c.k], True, 0.0, True
    return script


# (start, axes, trial budget, script: candidate -> (steps/s, feasible,
# spread, counted)): TestCoordinateSearch's cases, then check_autotune's
SEARCH_CASES = {
    "plateau": (8, K_AXES, 16, _by_k(
        {1: 100, 2: 180, 4: 300, 8: 500, 16: 995, 32: 1000})),
    "budget": (8, K_AXES, 3, lambda c: (100.0 * c.k, True, 0.0, True)),
    "memo": (8, K_AXES, 16,
             lambda c: (100.0 * c.k, True, 0.0, c.k != 1)),
    "early_stop": (8, K_AXES, 16, _by_k(
        {1: 100, 2: 400, 4: 800, 8: 500, 16: 60, 32: 55})),
    "infeasible_stops_ascent": (8, K_AXES, 16, _by_k(
        {k: 100.0 * k for k in (1, 2, 4, 8)}, infeasible=(16, 32))),
    "never_regress": (8, K_AXES, 16, lambda c: (
        500.0 if c.k == 8 else 400.0, True, 0.0, True)),
    "math_small_win": (8, {"k": [8], "staging_budget_mb": [None],
                           "remat": [False, True],
                           "grad_accum_steps": [1]}, 8,
                       lambda c: (505.0 if c.remat else 500.0, True, 0.0,
                                  True)),
    "math_clear_win": (8, {"k": [8], "staging_budget_mb": [None],
                           "remat": [False, True],
                           "grad_accum_steps": [1]}, 8,
                       lambda c: (600.0 if c.remat else 500.0, True, 0.0,
                                  True)),
    "noise_floor_loud": (8, {"k": [8], "staging_budget_mb": [None],
                             "remat": [False],
                             "grad_accum_steps": [1, 2]}, 8,
                         lambda c: (550.0 if c.grad_accum_steps == 2
                                    else 500.0, True, 0.2, True)),
    "noise_floor_quiet": (8, {"k": [8], "staging_budget_mb": [None],
                              "remat": [False],
                              "grad_accum_steps": [1, 2]}, 8,
                          lambda c: (550.0 if c.grad_accum_steps == 2
                                     else 500.0, True, 0.01, True)),
    "budget_axis_memo": (4, {"k": [1, 2, 4],
                             "staging_budget_mb": [64.0, None, 128.0],
                             "remat": [False, True],
                             "grad_accum_steps": [1, 2, 4]}, 12,
                         lambda c: (300.0 * c.k ** 0.5
                                    / c.grad_accum_steps
                                    * (1.3 if c.remat else 1.0)
                                    * (1.01 if c.staging_budget_mb is None
                                       else 1.0), True, 0.05, True)),
    "check_autotune_hbm_wall": (8, K_AXES, 16, _by_k(
        {1: 100.0, 2: 180.0, 4: 300.0, 8: 500.0, 16: 640.0},
        infeasible=(32,))),
    "check_autotune_regression_floor": (8, K_AXES, 16, lambda c: (
        500.0 if c.k == 8 else 200.0, True, 0.0, True)),
    "check_autotune_raising_probe": (8, K_AXES, 16, _by_k(
        {1: 100.0, 2: 180.0, 4: 300.0, 8: 500.0, 16: 640.0},
        raising=(32,))),
}


def _run_search(search_mod, probe_mod, start_k, axes, budget, script):
    def measure(c):
        sps, feasible, spread, counted = script(c)
        return probe_mod.ProbeResult(
            sps, 1000.0 / sps if sps else float("inf"), 8, 3,
            feasible=feasible, counted=counted, spread=spread)
    start = search_mod.Candidate(k=start_k, staging_budget_mb=(
        axes["staging_budget_mb"][0]), remat=False, grad_accum_steps=1)
    return search_mod.coordinate_search(start, axes, measure,
                                        trial_budget=budget)


@pytest.mark.parametrize("case", sorted(SEARCH_CASES))
def test_coordinate_search_equals_jax(case):
    start_k, axes, budget, script = SEARCH_CASES[case]
    want = _run_search(jsearch, jprobe, start_k, axes, budget, script)
    got = _run_search(tsearch, tprobe, start_k, axes, budget, script)
    assert _outcome(got) == _outcome(want)


def test_search_cases_reach_the_jax_tests_verdicts():
    """The scripted cases land where the JAX package's own tests say."""
    def run(case):
        return _run_search(tsearch, tprobe, *SEARCH_CASES[case])
    assert run("plateau").best.k == 16
    assert run("budget").exhausted and run("budget").trials == 3
    assert run("early_stop").best.k == 4
    assert run("infeasible_stops_ascent").pruned == 1
    assert run("never_regress").best.k == 8
    assert not run("math_small_win").best.remat
    assert run("math_clear_win").best.remat
    assert run("noise_floor_loud").best.grad_accum_steps == 1
    assert run("noise_floor_quiet").best.grad_accum_steps == 2
    out = run("check_autotune_hbm_wall")
    assert (out.best.k, out.pruned) == (16, 1)
    assert run("check_autotune_regression_floor").best.k == 8
    out = run("check_autotune_raising_probe")
    assert (out.best.k, out.pruned) == (16, 1)


@pytest.mark.parametrize("log_every,ckpt_every,fail_at", [
    (4, 6, None), (32, 0, None), (100, 0, None), (0, 0, None),
    (1, 0, None), (12, 18, None), (64, 0, None), (100, 10, None),
    (8, 0, None), (100, 0, 1), (16, 0, None), (100, 64, None),
])
def test_k_candidates_equal_jax(log_every, ckpt_every, fail_at):
    j, t = _cfgs(log_every=log_every, ckpt_every_steps=ckpt_every,
                 fail_at=fail_at)
    assert tsearch.k_candidates(t) == jsearch.k_candidates(j)


@pytest.mark.parametrize("model,batch,ways,budget,accum,remat", [
    ("mlp", 16, 8, None, 1, False),
    ("mlp", 64, 1, None, 1, False),
    ("mlp", 64, 1, 512.5, 1, False),
    ("transformer", 8, 1, 35000.0, 1, False),
    ("transformer", 8, 2, None, 1, True),
    ("transformer", 6, 1, None, 3, False),
    ("mlp", 64, 4, 100.0, 2, False),
    ("transformer", 128, 1, 0.3333, 1, False),
])
def test_build_space_equals_jax(model, batch, ways, budget, accum, remat):
    j, t = _cfgs(model=model, batch_size=batch, grad_accum_steps=accum,
                 remat=remat, log_every=8)
    assert tsearch.build_space(t, batch_ways=ways,
                               heuristic_budget_mb=budget) == \
        jsearch.build_space(j, batch_ways=ways, heuristic_budget_mb=budget)


def test_constants_and_candidate_equal_jax():
    for name in ("AXES", "ORDERED_AXES", "MATH_AXES", "PLATEAU_TOL",
                 "IMPROVE_MIN", "REGRESS_STOP"):
        assert getattr(tsearch, name) == getattr(jsearch, name), name
    for name in ("DEFAULT_PROBE_STEPS", "DEFAULT_PROBE_REPEATS",
                 "HBM_HEADROOM_FRACTION"):
        assert getattr(tprobe, name) == getattr(jprobe, name), name
    assert tcache.SCHEMA == jtune.cache_mod.SCHEMA
    assert (tconfig.AUTOTUNE_MODES, tconfig.AUTOTUNE_DEFAULT_TRIALS) == (
        jconfig.AUTOTUNE_MODES, jconfig.AUTOTUNE_DEFAULT_TRIALS)
    assert tconfig.SUPERSTEP_CAP == jconfig.SUPERSTEP_CAP
    assert [f.name for f in dataclasses.fields(tsearch.Candidate)] == \
        [f.name for f in dataclasses.fields(jsearch.Candidate)]
    jfields = {f.name for f in dataclasses.fields(jprobe.ProbeResult)}
    tfields = {f.name for f in dataclasses.fields(tprobe.ProbeResult)}
    assert tfields - jfields == {"launches"} and jfields <= tfields
    assert tsearch.Candidate().as_dict() == jsearch.Candidate().as_dict()
    assert ttune.CROSS_SLICE_ENUM == jtune.CROSS_SLICE_ENUM


def test_candidate_apply_folds_the_four_knobs():
    _, t = _cfgs()
    c = tsearch.Candidate(k=4, staging_budget_mb=1.5, remat=True,
                          grad_accum_steps=2, pipeline_interleave=1,
                          cross_slice="flat")
    got = c.apply(t)
    assert (got.steps_per_dispatch, got.staging_budget_mb, got.remat,
            got.grad_accum_steps) == (4, 1.5, True, 2)
    assert dataclasses.replace(got, steps_per_dispatch=0,
                               staging_budget_mb=None, remat=False,
                               grad_accum_steps=1) == t


# ------------------------------------------------------- wiring (autotune)

class _Records:
    """A metrics sink: ``_log_record``'s ``metrics.log`` calls."""

    def __init__(self):
        self.recs = []

    def log(self, **kv):
        self.recs.append(kv)


def _scripted(package, table, calls):
    """``probe_candidate`` for ``package`` (``"jax"`` or ``"port"``)
    answering from ``table(candidate, calls) -> (steps/s, feasible,
    spread)``, with the real effective-program key; ``calls`` records
    each probed candidate, this one last."""
    def fake(cfg, where, cand, plan, *, n_steps, repeats):
        calls.append(cand.as_dict())
        sps, feasible, spread = table(cand, calls)
        if package == "jax":
            key = jprobe.candidate_key(cfg, where, cand, plan, n_steps)
            mod = jprobe
        else:
            key = tprobe.candidate_key(cfg, cand, plan, n_steps)
            mod = tprobe
        return mod.ProbeResult(
            sps, 1000.0 / sps if sps else float("inf"), n_steps, repeats,
            feasible=feasible, spread=spread, key=key,
            error=None if feasible else "scripted: out of memory")
    return fake


def _plans(j, t):
    jplan = jdata.plan_epoch(
        jdata.make_synthetic_data(j.data.n_samples, j.data.n_features,
                                  j.data.seed),
        batch_size=j.batch_size, seed=j.seed, epoch=0)
    tplan = tdata.plan_epoch(
        tdata.make_synthetic_data(t.data.n_samples, t.data.n_features,
                                  t.data.seed),
        batch_size=t.batch_size, seed=t.seed, epoch=0)
    return jplan, tplan


def _both_autotune(monkeypatch, tmp_path, table, mode="probe", **kw):
    """One autotune call in each package on one scripted table; returns
    (jax, port) as (outcome, probe calls, tune records)."""
    j, t = _cfgs(log_every=4, autotune_trials=8, **kw)
    j = dataclasses.replace(j, autotune_cache_dir=str(tmp_path / "j"))
    t = dataclasses.replace(t, autotune_cache_dir=str(tmp_path / "t"))
    jplan, tplan = _plans(j, t)
    mesh = build_mesh(j.parallel, devices=jax.devices()[:1])
    out = []
    for package in ("jax", "port"):
        calls, recs = [], _Records()
        if package == "jax":
            monkeypatch.setattr(jprobe, "probe_candidate",
                                _scripted("jax", table, calls))
            o = jtune.autotune(j, mesh, jplan, mode=mode, metrics=recs,
                               state_bytes=10**6, hbm_bytes=16e9,
                               n_steps=8, repeats=1)
        else:
            monkeypatch.setattr(tprobe, "probe_candidate",
                                _scripted("port", table, calls))
            o = ttune.autotune(t, CPU, tplan, mode=mode, metrics=recs,
                               state_bytes=10**6, hbm_bytes=16e9,
                               n_steps=8, repeats=1)
        out.append((o, calls, recs.recs))
    return out


def _assert_same_decision(jres, tres):
    (jo, jcalls, jrecs), (to, tcalls, trecs) = jres, tres
    assert tcalls == jcalls
    assert to.tuned.as_dict() == jo.tuned.as_dict()
    for f in ("source", "status", "trials", "pruned", "steps_per_sec",
              "baseline_steps_per_sec"):
        assert getattr(to, f) == getattr(jo, f), f
    assert to.cfg.steps_per_dispatch == jo.cfg.steps_per_dispatch
    assert to.cfg.grad_accum_steps == jo.cfg.grad_accum_steps
    assert len(trecs) == len(jrecs) == 1
    assert trecs[0].keys() == jrecs[0].keys()
    for key in trecs[0]:
        if key != "fingerprint":
            assert trecs[0][key] == jrecs[0][key], key


# k = 2 is the fastest point; grad accumulation slows every step
def _table_k2(c, calls):
    return {1: 100.0, 2: 330.0, 4: 320.0}[c.k] / c.grad_accum_steps, True, \
        0.01


def test_autotune_probe_then_cache_hit_equals_jax(monkeypatch, tmp_path):
    first = _both_autotune(monkeypatch, tmp_path, _table_k2)
    _assert_same_decision(*first)
    (jo, _, _), (to, _, _) = first
    assert (to.source, to.status, to.tuned.k) == ("probe", "success", 2)
    assert to.trials > 0
    again = _both_autotune(monkeypatch, tmp_path, _table_k2)
    _assert_same_decision(*again)
    (_, jcalls, _), (to2, tcalls, _) = again
    assert (to2.source, to2.trials, tcalls) == ("cache", 0, [])
    assert to2.tuned == to.tuned


def test_autotune_cache_only_miss_equals_jax(monkeypatch, tmp_path):
    res = _both_autotune(monkeypatch, tmp_path, _table_k2,
                         mode="cache-only")
    _assert_same_decision(*res)
    (_, _, _), (to, calls, _) = res
    assert (to.source, to.status, to.trials, calls) == (
        "heuristic", "ungateable", 0, [])


def test_autotune_changed_workload_reprobes_equal_jax(monkeypatch,
                                                      tmp_path):
    first = _both_autotune(monkeypatch, tmp_path, _table_k2)
    second = _both_autotune(monkeypatch, tmp_path, _table_k2, batch_size=8)
    _assert_same_decision(*second)
    assert second[1][0].fingerprint != first[1][0].fingerprint
    assert second[1][0].source == "probe" and second[1][0].trials > 0


def test_autotune_winner_dying_on_remeasure_equals_jax(monkeypatch,
                                                       tmp_path):
    """k = 2 wins the search, then fails its confirmation trial: the
    commit falls back to the heuristic start."""
    def winner(d):
        return (d["k"], d["grad_accum_steps"]) == (2, 1)

    def table(c, calls):
        if winner(c.as_dict()) and sum(map(winner, calls)) > 1:
            return 0.0, False, 0.0     # the re-measure
        return _table_k2(c, calls)
    res = _both_autotune(monkeypatch, tmp_path, table)
    _assert_same_decision(*res)
    to, calls, _ = res[1]
    assert to.source == "probe" and to.tuned.k == 4
    assert sum(map(winner, calls)) == 2


# ---------------------------------------------------- cache and resolvers

def _fp(**kw):
    _, t = _cfgs(**kw)
    return tcache.fingerprint(t, CPU)


def test_fingerprint_terms():
    assert _fp() == _fp()
    assert _fp(log_every=4) != _fp(log_every=8)
    assert _fp(batch_size=8) != _fp()
    assert _fp(dtype="bfloat16") != _fp()
    assert _fp(adam_nu_dtype="bfloat16") != _fp()
    assert _fp(ckpt_every_steps=10) != _fp()
    _, t = _cfgs()
    assert tcache.fingerprint(t, CPU, world=2) != _fp()
    assert tcache.fingerprint(t, CPU, device_kind="NVIDIA H100") != _fp()
    m = dataclasses.replace(t, model=tconfig.ModelConfig(hidden=128))
    assert tcache.fingerprint(m, CPU) != _fp()
    # knobs the tuner commits are not terms: a tuned run looks its own
    # fingerprint up
    assert tcache.fingerprint(dataclasses.replace(
        t, steps_per_dispatch=4, remat=True, grad_accum_steps=2,
        staging_budget_mb=3.0), CPU) == _fp()


def test_fingerprint_covers_the_kernel_sources(tmp_path, monkeypatch):
    for src in (*tfa.SOURCES, *tfa.BWD_SOURCES, "fused_xent.cu",
                "mma_common.cuh"):
        (tmp_path / src).write_bytes((tbuild.CSRC / src).read_bytes())
    monkeypatch.setattr(tbuild, "CSRC", tmp_path)
    first = _fp()
    assert len(tcache.kernel_sources()) == 3
    (tmp_path / "mma_common.cuh").write_text("// changed\n")
    assert _fp() != first


def test_cache_store_load_roundtrip_and_atomic(tmp_path):
    fp = _fp()
    tuned = tsearch.Candidate(k=8, staging_budget_mb=1.5,
                              pipeline_interleave=1,
                              cross_slice="flat").as_dict()
    assert tcache.store(str(tmp_path), fp, {"tuned": tuned,
                                            "steps_per_sec": 100.0})
    rec = tcache.load(str(tmp_path), fp)
    assert rec["tuned"] == tuned and rec["fingerprint"] == fp
    assert rec["schema"] == tcache.SCHEMA
    assert tcache.load(str(tmp_path), "0" * 16) is None
    assert os.listdir(str(tmp_path)) == [f"tune-{fp}.json"]


@pytest.mark.parametrize("tuned", [
    "{not json",
    {"k": 0, "staging_budget_mb": None, "remat": False,
     "grad_accum_steps": 1},
    {"k": 4, "staging_budget_mb": "1.5", "remat": False,
     "grad_accum_steps": 1},
    {"k": 4, "staging_budget_mb": -2.0, "remat": False,
     "grad_accum_steps": 1},
    {"k": 4, "staging_budget_mb": 0, "remat": False,
     "grad_accum_steps": 1},
    {"k": 4, "staging_budget_mb": True, "remat": False,
     "grad_accum_steps": 1},
    {"k": 4, "staging_budget_mb": None, "remat": False},
    # overlap-plane points the port does not run
    {"k": 4, "staging_budget_mb": None, "remat": False,
     "grad_accum_steps": 1, "grad_bucket_mb": 4.0},
    {"k": 4, "staging_budget_mb": None, "remat": False,
     "grad_accum_steps": 1, "pipeline_interleave": 2},
    {"k": 4, "staging_budget_mb": None, "remat": False,
     "grad_accum_steps": 1, "cross_slice": "hierarchical"},
])
def test_corrupt_or_insane_cache_file_is_a_miss(tuned, tmp_path):
    fp = _fp()
    path = tcache.cache_path(str(tmp_path), fp)
    with open(path, "w") as f:
        if isinstance(tuned, str):
            f.write(tuned)
        else:
            json.dump({"schema": tcache.SCHEMA, "fingerprint": fp,
                       "tuned": tuned}, f)
    assert tcache.load(str(tmp_path), fp) is None


@pytest.mark.parametrize("flag,env,fail_at", [
    (None, None, None), (None, "probe", None), ("off", "probe", None),
    ("cache-only", None, None), ("probe", None, 1), (None, "probe", 0),
    ("always", None, None), (None, "sometimes", None),
])
def test_resolve_autotune_equals_jax(flag, env, fail_at, monkeypatch):
    if env is None:
        monkeypatch.delenv("TPUDIST_AUTOTUNE", raising=False)
    else:
        monkeypatch.setenv("TPUDIST_AUTOTUNE", env)
    j, t = _cfgs(autotune=flag, fail_at=fail_at)
    try:
        want = jconfig.resolve_autotune(j)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tconfig.resolve_autotune(t)
        assert str(got.value) == str(e)
        return
    assert tconfig.resolve_autotune(t) == want


@pytest.mark.parametrize("flag,env", [
    (None, None), ("/flag/dir", "/env/dir"), (None, "/env/dir")])
def test_resolve_autotune_cache_dir_equals_jax(flag, env, monkeypatch):
    if env is None:
        monkeypatch.delenv("TPUDIST_AUTOTUNE_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("TPUDIST_AUTOTUNE_CACHE_DIR", env)
    j, t = _cfgs(autotune_cache_dir=flag, save_dir="/sv")
    assert tconfig.resolve_autotune_cache_dir(t) == \
        jconfig.resolve_autotune_cache_dir(j)


@pytest.mark.parametrize("flag,env", [
    (0, None), (0, "3"), (7, "3"), (0, "x"), (0, "0"), (-1, None)])
def test_resolve_autotune_trials_equals_jax(flag, env, monkeypatch):
    if env is None:
        monkeypatch.delenv("TPUDIST_AUTOTUNE_TRIALS", raising=False)
    else:
        monkeypatch.setenv("TPUDIST_AUTOTUNE_TRIALS", env)
    j, t = _cfgs(autotune_trials=flag)
    if flag < 0:
        for fn, cfg in ((jconfig.resolve_autotune_trials, j),
                        (tconfig.resolve_autotune_trials, t)):
            with pytest.raises(ValueError, match="autotune-trials"):
                fn(cfg)
        return
    assert tconfig.resolve_autotune_trials(t) == \
        jconfig.resolve_autotune_trials(j)


def test_parser_carries_the_tuning_flags():
    argv = ["--autotune", "probe", "--autotune-cache-dir", "/x",
            "--autotune-trials", "5", "--compilation-cache-dir", "/c"]
    t, j = tconfig.parse_args(argv), jconfig.parse_args(argv)
    for name in ("autotune", "autotune_cache_dir", "autotune_trials",
                 "compilation_cache_dir"):
        assert getattr(t, name) == getattr(j, name), name
    tconfig.check_supported(t)


def test_compilation_cache_dir_sets_the_build_root(tmp_path, monkeypatch):
    """Flag (``set_build_root``) > ``TPUDIST_COMPILATION_CACHE_DIR`` >
    ``build/tpudist_torch``; ``library_path`` keeps its
    ``<name>-<hash>/lib<name>.so`` under whichever root."""
    monkeypatch.delenv("TPUDIST_COMPILATION_CACHE_DIR", raising=False)
    try:
        tbuild.set_build_root(None)
        default = tbuild.library_path(tfa.LIBRARY, tfa.SOURCES)
        assert tbuild.build_root() == tbuild.BUILD_ROOT
        assert default.parent.parent == tbuild.BUILD_ROOT
        monkeypatch.setenv("TPUDIST_COMPILATION_CACHE_DIR",
                           str(tmp_path / "env"))
        env = tbuild.library_path(tfa.LIBRARY, tfa.SOURCES)
        assert env == tmp_path / "env" / default.parent.name / default.name
        tbuild.set_build_root(str(tmp_path / "flag"))
        flag = tbuild.library_path(tfa.LIBRARY, tfa.SOURCES)
        assert flag == tmp_path / "flag" / default.parent.name / \
            default.name
    finally:
        tbuild.set_build_root(None)


def test_train_cli_takes_the_compilation_cache_dir(tmp_path, monkeypatch):
    monkeypatch.delenv("TPUDIST_COMPILATION_CACHE_DIR", raising=False)
    seen = []
    real = tbuild.set_build_root

    def record(path):
        real(path)
        seen.append(tbuild.build_root())
    monkeypatch.setattr(tbuild, "set_build_root", record)
    try:
        argv = ["--device", "cpu", "--epochs", "1", "--n-samples", "128",
                "--save-dir", str(tmp_path / "ck")]
        assert ttrain.main(argv + ["--compilation-cache-dir",
                                   str(tmp_path / "cc")]) == 0
        assert ttrain.main(argv) == 0
    finally:
        real(None)
    assert seen == [tmp_path / "cc", tbuild.BUILD_ROOT]


# -------------------------------------------------------- probes (CPU)

def _probe_setup(n_samples=16 * 12):
    """The port's config and epoch-0 plan: batch 16, --log-every 4."""
    _, t = _cfgs(log_every=4)
    t = dataclasses.replace(t, data=tconfig.DataConfig(n_samples=n_samples))
    plan = tdata.plan_epoch(
        tdata.make_synthetic_data(n_samples, 20, t.data.seed),
        batch_size=t.batch_size, seed=t.seed, epoch=0)
    return t, plan


def test_probe_measures_the_real_superstep():
    cfg, plan = _probe_setup()
    cand = tsearch.Candidate(k=4)
    res = tprobe.probe_candidate(cfg, CPU, cand, plan, n_steps=8,
                                 repeats=2)
    assert res.feasible and res.steps_per_sec > 0 and res.error is None
    assert res.n_steps == 8 and res.key == (4, (8, False), False, 1,
                                            (None, 0))
    assert res.hbm_peak_bytes is None          # no card, no watermark
    assert res.launches == dict.fromkeys(tengine.kernel_launch_counts(), 0)


def test_infeasible_slab_plan_is_pruned_not_raised():
    cfg, plan = _probe_setup()
    res = tprobe.probe_candidate(
        cfg, CPU, tsearch.Candidate(k=4, staging_budget_mb=1e-6), plan,
        n_steps=8, repeats=1)
    assert not res.feasible and "staging budget" in res.error


@pytest.mark.parametrize("cand", [
    dict(k=1), dict(k=4, staging_budget_mb=1000.0),
    dict(k=4, staging_budget_mb=0.012), dict(k=2, remat=True),
    dict(k=4, grad_accum_steps=2, staging_budget_mb=0.03),
])
def test_candidate_key_equals_jax(cand):
    j, t = _cfgs(log_every=4)
    jplan, tplan = _plans(j, t)
    mesh = build_mesh(j.parallel, devices=jax.devices()[:1])
    assert tprobe.candidate_key(t, tsearch.Candidate(**cand), tplan, 12) \
        == jprobe.candidate_key(j, mesh, jsearch.Candidate(**cand), jplan,
                                12)


def test_candidate_key_dedupes_equal_programs():
    cfg, plan = _probe_setup()
    a = tprobe.candidate_key(cfg, tsearch.Candidate(
        k=4, staging_budget_mb=1000.0), plan, 12)
    b = tprobe.candidate_key(cfg, tsearch.Candidate(
        k=4, staging_budget_mb=2000.0), plan, 12)
    assert a == b
    assert tprobe.candidate_key(cfg, tsearch.Candidate(
        k=4, staging_budget_mb=0.012), plan, 12) != a


def test_runner_k1_is_the_per_step_path():
    cfg, plan = _probe_setup()
    runner = tprobe.EpochRunner(cfg, CPU, 1, plan, 6)
    state, times, compile_s = tprobe.time_runner(runner, repeats=1)
    assert len(times) == 1 and times[0] > 0 and compile_s > 0
    assert state.step == 12 and runner.superstep is None


def test_runner_superstep_epoch_equals_per_step():
    """The probe's k = 4 epoch over streamed slabs and a partial tail
    (10 steps) leaves bitwise the state the per-step epoch leaves."""
    cfg, plan = _probe_setup(n_samples=160)
    step = staging.step_bytes(plan.arrays, plan.local_batch)
    states = []
    for k, budget in ((1, None), (4, 2 * 4 * step)):
        runner = tprobe.EpochRunner(cfg, CPU, k, plan, 10,
                                    budget_bytes=budget)
        if k > 1:
            assert (runner.splan.streamed, runner.splan.n_slabs) == (True,
                                                                     3)
        state = runner.init_state()
        state, loss = runner.run_epoch(state)
        states.append((state, float(loss)))
        runner.close()
    (a, la), (b, lb) = states
    assert la == lb and a.step == b.step == 10
    for p, q in zip(a.params.parameters(), b.params.parameters()):
        assert torch.equal(p, q)


def test_probe_leaves_counters_state_and_generator_alone(monkeypatch):
    """Launches inside a probe do not move the run's counters (they ride
    on the result), the caller's state is not touched (the probe builds
    its own from the seed) and the global generator does not move."""
    cfg, plan = _probe_setup()
    real = tengine.make_train_step

    def launching(*a, **kw):
        step = real(*a, **kw)

        def counted(state, batch):
            tfa.launches += 1        # as a kernel wrapper would
            return step(state, batch)
        return counted
    monkeypatch.setattr(tengine, "make_train_step", launching)
    counts = dict.fromkeys(tengine.kernel_launch_counts(), 7)
    tengine.set_kernel_launch_counts(counts)
    state = tengine.init_state(cfg, CPU)
    before = [p.clone() for p in state.params.parameters()]
    rng = torch.get_rng_state()
    try:
        res = tprobe.probe_candidate(cfg, CPU, tsearch.Candidate(k=1), plan,
                                     n_steps=6, repeats=2)
        assert tengine.kernel_launch_counts() == counts
    finally:
        tengine.set_kernel_launch_counts(dict.fromkeys(counts, 0))
    assert res.feasible and res.launches["flash_attention_fwd"] == 3 * 6
    assert all(torch.equal(p, q) for p, q in
               zip(before, state.params.parameters()))
    assert state.step == 0 and torch.equal(rng, torch.get_rng_state())


def test_failing_probe_is_pruned_and_restores_counters(monkeypatch):
    cfg, plan = _probe_setup()

    class Boom(tengine.Superstep):
        def __call__(self, *a, **kw):
            tfa.launches += 1
            raise torch.cuda.OutOfMemoryError("scripted: OOM in capture")
    monkeypatch.setattr(tengine, "make_superstep", Boom)
    tengine.set_kernel_launch_counts(
        dict.fromkeys(tengine.kernel_launch_counts(), 0))
    res = tprobe.probe_candidate(cfg, CPU, tsearch.Candidate(k=4), plan,
                                 n_steps=8, repeats=1)
    assert not res.feasible and "OutOfMemoryError" in res.error
    assert res.launches["flash_attention_fwd"] == 1
    assert tengine.kernel_launch_counts()["flash_attention_fwd"] == 0


# ------------------------------------------------------------ end to end

CLI = ["--device", "cpu", "--epochs", "2", "--train-batch-size", "64",
       "--n-samples", "640", "--log-every", "2"]


def _cli(tmp_path, name, extra, capsys):
    save = tmp_path / name
    rc = ttrain.main(CLI + ["--save-dir", str(save)] + extra)
    out = capsys.readouterr().out
    assert rc == 0, out
    recs = [json.loads(ln) for ln in
            (save / "metrics.jsonl").read_text().splitlines()]
    return out, recs


def _steps(recs):
    return [(r["epoch"], r["step"], r["loss"]) for r in recs
            if r["kind"] == "step"]


def _epochs(recs):
    return [(r["avg_loss"], r["eval_loss"]) for r in recs
            if r["kind"] == "epoch"]


def test_cli_tuned_run_bitwise_matches_untuned(tmp_path, capsys,
                                               monkeypatch):
    """A tuned run's per-step and per-epoch losses are bitwise those of
    the untuned run at the committed point, and a second tuned run is a
    pure cache hit with zero probe trials and the same commit."""
    monkeypatch.delenv("TPUDIST_AUTOTUNE", raising=False)
    tune_argv = ["--autotune", "probe", "--autotune-trials", "4",
                 "--autotune-cache-dir", str(tmp_path / "cache")]
    out, tuned = _cli(tmp_path, "tuned", tune_argv, capsys)
    t1, = [r for r in tuned if r["kind"] == "tune"]
    assert (t1["source"], t1["status"]) == ("probe", "success")
    assert 0 < t1["trials"] <= 4 + 2
    assert f"tpudist: tuning success (probe): k={t1['steps_per_dispatch']}" \
        in out
    timing, = [r for r in tuned if r["kind"] == "timing"]
    assert timing["tuning_status"] == "success"
    assert timing["steps_per_dispatch"] == t1["steps_per_dispatch"]
    point = ["--steps-per-dispatch", str(t1["steps_per_dispatch"]),
             "--grad-accum-steps", str(t1["grad_accum_steps"])]
    if t1["staging_budget_mb"] is not None:
        point += ["--staging-budget-mb", str(t1["staging_budget_mb"])]
    _, ref = _cli(tmp_path, "ref", point, capsys)
    assert _steps(tuned) == _steps(ref) and _epochs(tuned) == _epochs(ref)
    ref_timing, = [r for r in ref if r["kind"] == "timing"]
    assert ref_timing["tuning_status"] == "ungateable"

    out2, tuned2 = _cli(tmp_path, "tuned2", tune_argv, capsys)
    t2, = [r for r in tuned2 if r["kind"] == "tune"]
    assert (t2["source"], t2["trials"]) == ("cache", 0)
    for key in ("steps_per_dispatch", "staging_budget_mb", "remat",
                "grad_accum_steps"):
        assert t2[key] == t1[key], key
    assert "(0 probe trials, 0 pruned)" in out2
    assert _steps(tuned2) == _steps(ref)


def test_cli_cache_only_miss_and_env_twin(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("TPUDIST_AUTOTUNE", "cache-only")
    monkeypatch.setenv("TPUDIST_AUTOTUNE_CACHE_DIR", str(tmp_path / "c"))
    out, recs = _cli(tmp_path, "co", [], capsys)
    t, = [r for r in recs if r["kind"] == "tune"]
    assert (t["source"], t["status"], t["trials"]) == (
        "heuristic", "ungateable", 0)
    assert "tpudist: tuning ungateable (heuristic)" in out
    # the env twins probe and fill the cache the next cache-only run hits
    monkeypatch.setenv("TPUDIST_AUTOTUNE", "probe")
    monkeypatch.setenv("TPUDIST_AUTOTUNE_TRIALS", "2")
    _, recs = _cli(tmp_path, "pr", [], capsys)
    t, = [r for r in recs if r["kind"] == "tune"]
    assert t["source"] == "probe" and 0 < t["trials"] <= 2 + 2
    monkeypatch.setenv("TPUDIST_AUTOTUNE", "cache-only")
    _, recs = _cli(tmp_path, "hit", [], capsys)
    t, = [r for r in recs if r["kind"] == "tune"]
    assert (t["source"], t["status"]) == ("cache", "success")


def test_fail_at_forces_tuning_off(tmp_path, capsys):
    rc = ttrain.main(CLI + ["--autotune", "probe", "--fail-at", "0",
                            "--save-dir", str(tmp_path)])
    assert rc == 1
    out = capsys.readouterr().out
    assert "tpudist: tuning" not in out


TINY_TF = ["--device", "cpu", "--model", "transformer", "--vocab-size",
           "256", "--n-layers", "2", "--d-model", "64", "--n-heads", "2",
           "--d-ff", "128", "--seq-len", "32", "--n-samples", "24",
           "--train-batch-size", "4", "--epochs", "2", "--log-every", "1",
           "--steps-per-dispatch", "1"]


@pytest.mark.parametrize("head", ["plain", "fused"])
def test_remat_keeps_the_per_step_losses(head, tmp_path, capsys):
    runs = []
    for remat in ([], ["--remat"]):
        save = tmp_path / f"r{len(runs)}"
        assert ttrain.main(TINY_TF + ["--lm-head", head, "--save-dir",
                                      str(save)] + remat) == 0
        recs = [json.loads(ln) for ln in
                (save / "metrics.jsonl").read_text().splitlines()]
        runs.append((_steps(recs), _epochs(recs)))
    capsys.readouterr()
    assert len(runs[0][0]) == 12
    assert runs[1] == runs[0]


# one rank of a two-process gloo job: argv[1] the port, argv[2] the rank,
# argv[3] the cache dir; the rank's scripted timings peak at another k
CHILD = r"""
import json, sys
for name in ("jax", "jaxlib", "optax", "orbax", "tpudist"):
    sys.modules[name] = None
import torch
torch.set_num_threads(1)
from tpudist_torch import config, data, tune
from tpudist_torch.parallel import distributed
from tpudist_torch.tune import probe

port, rank, cache = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
ctx = distributed.initialize(f"localhost:{port}", 2, rank, device="cpu")
table = ({1: 100.0, 2: 400.0, 4: 200.0}, {1: 100.0, 2: 200.0, 4: 400.0})[rank]

def fake(cfg, device, cand, plan, *, n_steps, repeats):
    sps = table[cand.k] / cand.grad_accum_steps
    return probe.ProbeResult(sps, 1000.0 / sps, n_steps, repeats,
                             key=probe.candidate_key(cfg, cand, plan,
                                                     n_steps))
probe.probe_candidate = fake
cfg = config.parse_args(["--device", "cpu", "--n-samples", "192",
                         "--train-batch-size", "16", "--log-every", "4",
                         "--autotune-cache-dir", cache])
plan = data.plan_epoch(data.make_synthetic_data(192, 20, 42),
                       batch_size=16, seed=42, epoch=0, process_index=rank,
                       process_count=2)
out = tune.autotune(cfg, ctx.device, plan, mode="probe",
                    is_coordinator=ctx.is_coordinator, n_steps=8, repeats=1)
print(json.dumps({"tuned": out.tuned.as_dict(), "trials": out.trials,
                  "sps": out.steps_per_sec, "source": out.source}))
distributed.shutdown()
"""


def test_two_ranks_commit_rank_zeros_point(tmp_path):
    """Rank 0's scripted curve peaks at k = 2, rank 1's at k = 4 (the
    start): every search decision rides rank 0's broadcast measurements,
    so both ranks walk one trial sequence and commit k = 2, and only
    rank 0 writes the cache."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, str(port), str(rank),
         str(tmp_path / "cache")], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in (0, 1)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-2000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert outs[0] == outs[1]
    assert outs[0]["source"] == "probe" and outs[0]["tuned"]["k"] == 2
    assert outs[0]["sps"] == 400.0
    assert len(os.listdir(tmp_path / "cache")) == 1
