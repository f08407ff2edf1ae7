"""The port's serve tuner (``tpudist_torch.serve.tune``) against the JAX
package's (``tpudist.serve.tune``).

* The ladders, probe defaults and ``validate_serve_tuned`` equal the JAX
  ones on a table of records.
* ``_search`` walks the same candidates in the same order and returns
  the same result on scripted measure tables: the regress stop, the
  plateau, a layout win, a page-size win, a speculation win, infeasible
  rungs, budget exhaustion and the floor revert.
* ``autotune_serve``'s off, probe, cache-hit (0 trials), cache-only miss
  and probe-failure outcomes, and its ``kind=serve_tune`` record, equal
  the JAX tuner's on the same scripted probe; train and serve records
  share a cache directory without aliasing.
* ``probe_candidate`` on carried params counts the JAX probe's tokens
  for dense ``st`` and ``hs``, paged and paged + speculative candidates.
* The serve CLI tunes, caches and serves at the committed point: its
  tokens equal an untuned run's at that point.
"""

import dataclasses
import json

import jax
import pytest
import torch

from tpudist.config import ModelConfig, ParallelConfig
from tpudist.parallel import build_mesh
from tpudist.serve import tune as jtune
from tpudist.serve.engine import init_params
from tpudist.tune import cache as jcache
from tpudist_torch import convert
from tpudist_torch.config import ModelConfig as TModelConfig
from tpudist_torch.models import transformer as ttf
from tpudist_torch.serve import cli as tcli
from tpudist_torch.serve import tune as ttune
from tpudist_torch.tune import cache as tcache

torch.set_num_threads(1)

TINY_TF = ModelConfig(name="transformer", vocab_size=64, n_layers=2,
                      d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                      max_seq_len=32)
SHAPE = dict(slots=2, max_seq=32, prompt_pad=8)


def _tcfg(cfg: ModelConfig) -> TModelConfig:
    return TModelConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(TModelConfig)})


class RecMetrics:
    """A MetricsLogger stand-in that records instead of writing."""

    def __init__(self):
        self.recs = []

    def log(self, **kv):
        self.recs.append(kv)

    def flush(self):
        pass


@pytest.fixture(scope="module")
def carried():
    """(mesh, JAX params, the port's model on the same params)."""
    mesh = build_mesh(ParallelConfig(), devices=jax.devices()[:1])
    jparams = init_params(TINY_TF, mesh, seed=0)
    model = ttf.Transformer(_tcfg(TINY_TF), device="cpu")
    model.load_state_dict(convert.params_from_jax(jax.device_get(jparams)))
    return mesh, jparams, model


# ------------------------------------------------------ constants, schema


def test_ladders_and_probe_defaults_equal_jax():
    for name in ("DECODE_K_LADDER", "KV_PAGE_TOKENS_LADDER",
                 "SPECULATE_K_LADDER", "DEFAULT_PROBE_DISPATCHES",
                 "DEFAULT_PROBE_REPEATS", "DEFAULT_TRIALS"):
        assert getattr(ttune, name) == getattr(jtune, name), name
    assert ttune.ServeCandidate().as_dict() == jtune.ServeCandidate() \
        .as_dict()
    assert [f.name for f in dataclasses.fields(ttune.ServeProbeResult)] \
        == [f.name for f in dataclasses.fields(jtune.ServeProbeResult)]
    assert [f.name for f in dataclasses.fields(ttune.ServeTuneOutcome)] \
        == [f.name for f in dataclasses.fields(jtune.ServeTuneOutcome)]


OK = {"decode_k": 8, "layout": "st", "kv_page_tokens": 8,
      "speculate_k": 4}
RECORDS = [
    OK, {"decode_k": 8, "layout": "st"},
    dict(OK, speculate_k=1), dict(OK, kv_page_tokens=0),
    dict(OK, kv_page_tokens=0, speculate_k=0), dict(OK, kv_page_tokens=-1),
    dict(OK, speculate_k=-2), dict(OK, decode_k=0), dict(OK, decode_k=32),
    dict(OK, layout="hs"), dict(OK, layout="zz"),
    {"decode_k": 8, "layout": "st", "kv_page_tokens": 0, "speculate_k": 0},
    {"decode_k": 0, "layout": "st", "kv_page_tokens": 0, "speculate_k": 0},
    {"decode_k": 8, "layout": "zz", "kv_page_tokens": 0, "speculate_k": 0},
]


@pytest.mark.parametrize("rec", RECORDS, ids=range(len(RECORDS)))
def test_validate_serve_tuned_equals_jax(rec):
    assert ttune.validate_serve_tuned(rec) == jtune.validate_serve_tuned(rec)


# -------------------------------------------------------------- _search


def _curve(curve, layouts=None):
    """tokens/s by decode_k from ``curve`` (0 = infeasible), scaled per
    layout (hs slightly worse by default); dense only."""
    layouts = layouts or {"st": 1.0, "hs": 0.9}
    return lambda c: curve.get(c["decode_k"], 0.0) * layouts[c["layout"]]


def _table(base, **bonus):
    """``base`` tokens/s plus, for each ``field=(value, gain)``, ``gain``
    where the candidate's field equals value; a gain of None makes the
    point infeasible."""
    def tps(c):
        out = base
        for field, (value, gain) in bonus.items():
            if c[field] == value:
                if gain is None:
                    return 0.0
                out += gain
        return out
    return tps


# (start, table, search kwargs)
SEARCHES = {
    "plateau": (dict(decode_k=1), _curve(
        {1: 100.0, 2: 190.0, 4: 360.0, 8: 365.0, 16: 366.0, 32: 350.0}),
        dict(max_decode_k=32, trial_budget=16)),
    "regress_stop": (dict(decode_k=1), _curve(
        {1: 100.0, 2: 190.0, 4: 300.0, 8: 200.0, 16: 900.0, 32: 900.0}),
        dict(max_decode_k=32, trial_budget=16)),
    "mid_ladder_start": (dict(decode_k=8), _curve(
        {8: 500.0, 1: 100.0, 2: 120.0, 4: 130.0, 16: 90.0, 32: 80.0}),
        dict(max_decode_k=32, trial_budget=16)),
    "layout_in_tolerance": (dict(decode_k=1), _curve(
        {1: 100.0, 2: 200.0, 4: 200.0}, {"st": 1.0, "hs": 1.01}),
        dict(max_decode_k=4, trial_budget=16)),
    "layout_win": (dict(decode_k=1), _curve(
        {1: 100.0, 2: 200.0, 4: 200.0}, {"st": 1.0, "hs": 1.5}),
        dict(max_decode_k=4, trial_budget=16)),
    "infeasible_rung": (dict(decode_k=1), _curve(
        {1: 100.0, 2: 200.0, 4: 0.0, 8: 400.0}),
        dict(max_decode_k=8, trial_budget=16)),
    "page_size_win": (dict(decode_k=8), _table(
        100.0, kv_page_tokens=(16, 50.0)),
        dict(max_decode_k=8, trial_budget=32, max_page_tokens=32)),
    "speculation_win": (dict(decode_k=8), _table(
        100.0, kv_page_tokens=(16, 50.0), speculate_k=(4, 50.0)),
        dict(max_decode_k=8, trial_budget=32, max_page_tokens=32)),
    "paged_tie_keeps_dense": (dict(decode_k=8), _table(100.0),
                              dict(max_decode_k=8, trial_budget=32,
                                   max_page_tokens=32)),
    "paged_axes_off": (dict(decode_k=8), _table(
        100.0, kv_page_tokens=(8, 500.0)),
        dict(max_decode_k=8, trial_budget=32)),
    "infeasible_pages": (dict(decode_k=4), _table(
        100.0, kv_page_tokens=(8, None), speculate_k=(8, None),
        layout=("hs", None)),
        dict(max_decode_k=8, trial_budget=32, max_page_tokens=16)),
    "budget_exhaustion": (dict(decode_k=1), _curve(
        {1: 100.0, 2: 190.0, 4: 360.0, 8: 700.0}),
        dict(max_decode_k=8, trial_budget=3, max_page_tokens=32)),
    "floor_revert": (dict(decode_k=8),
                     lambda c: 100.0 if c == dict(
                         ttune.ServeCandidate().as_dict()) else 1.0,
                     dict(max_decode_k=32, trial_budget=32,
                          max_page_tokens=32)),
    "dead_start": (dict(decode_k=8), _table(
        100.0, decode_k=(8, None)),
        dict(max_decode_k=32, trial_budget=32, max_page_tokens=32)),
}


def _walk(pkg, start, table, kw):
    calls = []

    def measure(cand):
        calls.append(cand.as_dict())
        tps = table(cand.as_dict())
        if tps <= 0:
            return pkg.ServeProbeResult(0.0, float("inf"), feasible=False,
                                        error="scripted OOM")
        return pkg.ServeProbeResult(tps, 1.0)
    out = pkg._search(measure, pkg.ServeCandidate(**start), **kw)
    return calls, dict(out, best=out["best"].as_dict())


@pytest.mark.parametrize("case", sorted(SEARCHES))
def test_search_walks_as_jax(case):
    """The same candidates in the same order, the same committed point,
    counts and rates; the commit never measures below the start."""
    start, table, kw = SEARCHES[case]
    got = _walk(ttune, start, table, kw)
    assert got == _walk(jtune, start, table, kw)
    out = got[1]
    assert out["best_tps"] >= out["baseline_tps"]
    assert out["trials"] == len(got[0]) <= kw["trial_budget"]


# ------------------------------------------------------- autotune_serve


def _fake_probe(pkg, calls):
    def probe(model_cfg, where, params, cand, **kw):
        calls.append(cand.as_dict())
        tps = 100.0 * cand.decode_k if cand.decode_k <= 4 else 390.0
        return pkg.ServeProbeResult(tps + 10.0 * (cand.layout == "hs"),
                                    1.0, tokens=7)
    return probe


def _outcomes(pkg, where, cfg, cache_dir, monkeypatch, failing=False):
    """off, probe (cold), the cache hit, cache-only on a cold directory
    and, with ``failing``, probe whose search raises: each outcome with
    its serve_tune record and the probes it ran."""
    calls = []
    monkeypatch.setattr(pkg, "probe_candidate", _fake_probe(pkg, calls))
    out = []
    runs = [("off", cache_dir), ("probe", cache_dir), ("probe", cache_dir),
            ("cache-only", cache_dir + "-cold")]
    for mode, d in runs:
        m = RecMetrics()
        o = pkg.autotune_serve(cfg, where, None, mode=mode, cache_dir=d,
                               metrics=m, **SHAPE)
        out.append((dataclasses.replace(o, fingerprint="", cache_dir=""),
                    {k: v for k, v in m.recs[0].items()
                     if k != "fingerprint"}, len(calls)))
    if failing:
        def boom(*a, **k):
            raise RuntimeError("scripted probe crash")
        monkeypatch.setattr(pkg, "_search", boom)
        m = RecMetrics()
        o = pkg.autotune_serve(cfg, where, None, mode="probe",
                               cache_dir=cache_dir + "-fail", metrics=m,
                               **SHAPE)
        out.append((dataclasses.replace(o, fingerprint="", cache_dir=""),
                    {k: v for k, v in m.recs[0].items()
                     if k != "fingerprint"}, len(calls)))
    return out, calls


def _plain(outcomes):
    return [(dict(dataclasses.asdict(o), tuned=o.tuned.as_dict()), rec, n)
            for o, rec, n in outcomes]


def test_autotune_serve_outcomes_equal_jax(carried, tmp_path, monkeypatch):
    mesh = carried[0]
    got, got_calls = _outcomes(ttune, "cpu", _tcfg(TINY_TF),
                               str(tmp_path / "t"), monkeypatch,
                               failing=True)
    want, want_calls = _outcomes(jtune, mesh, TINY_TF, str(tmp_path / "j"),
                                 monkeypatch, failing=True)
    assert _plain(got) == _plain(want)
    assert got_calls == want_calls
    (off, _, _), (probe, rec, n), (hit, _, n2), (cold, _, _), \
        (failed, _, _) = got
    assert (off.source, off.trials, off.status) == ("heuristic", 0,
                                                    "ungateable")
    assert probe.source == "probe" and probe.trials == n > 0
    assert (hit.source, hit.trials, n2) == ("cache", 0, n)
    assert hit.tuned == probe.tuned
    assert (cold.source, cold.trials, cold.status) == ("heuristic", 0,
                                                       "ungateable")
    assert (failed.source, failed.status) == ("heuristic", "fail")
    assert set(rec) == {"kind", "status", "source", "trials", "pruned",
                        "decode_k", "layout", "kv_page_tokens",
                        "speculate_k", "tokens_per_sec",
                        "baseline_tokens_per_sec"}


def test_serve_and_train_records_share_a_directory(tmp_path):
    """``prefix="serve"`` puts a serve record beside the train tuner's
    record of the same fingerprint, named as the JAX cache names them;
    each reads back under its own schema and as a miss under the
    other's."""
    d, fp = str(tmp_path), "0123456789abcdef"
    train = {"k": 4, "staging_budget_mb": None, "remat": False,
             "grad_accum_steps": 1}
    serve = ttune.ServeCandidate(decode_k=4, layout="hs").as_dict()
    assert tcache.store(d, fp, {"tuned": train})
    assert tcache.store(d, fp, {"tuned": serve}, prefix="serve")
    assert tcache.cache_path(d, fp) == jcache.cache_path(d, fp)
    assert tcache.cache_path(d, fp, "serve") == jcache.cache_path(
        d, fp, "serve") != tcache.cache_path(d, fp)
    assert tcache.load(d, fp)["tuned"] == train
    got = tcache.load(d, fp, prefix="serve",
                      validate=ttune.validate_serve_tuned)
    assert got["tuned"] == serve
    assert tcache.load(d, fp, prefix="serve") is None
    assert tcache.load(d, fp, validate=ttune.validate_serve_tuned) is None
    # the JAX reader reads the port's serve record the same way
    assert jcache.load(d, fp, prefix="serve",
                       validate=jtune.validate_serve_tuned)["tuned"] == serve


def test_fingerprint_moves_with_the_serve_shape():
    cfg = _tcfg(TINY_TF)
    fp = ttune.fingerprint(cfg, "cpu", **SHAPE)
    assert fp == ttune.fingerprint(cfg, "cpu", **SHAPE) and len(fp) == 16
    for kw in (dict(SHAPE, slots=4), dict(SHAPE, max_seq=64),
               dict(SHAPE, prompt_pad=4)):
        assert ttune.fingerprint(cfg, "cpu", **kw) != fp
    assert ttune.fingerprint(cfg, "cpu", dtype=torch.bfloat16,
                             **SHAPE) != fp
    assert ttune.fingerprint(cfg, "cpu", device_kind="NVIDIA H100",
                             **SHAPE) != fp
    assert ttune.fingerprint(dataclasses.replace(cfg, n_layers=3), "cpu",
                             **SHAPE) != fp


# ------------------------------------------------------- probe_candidate


PROBES = {
    "dense-st": dict(decode_k=2),
    "dense-hs": dict(decode_k=2, layout="hs"),
    "paged": dict(decode_k=2, kv_page_tokens=8),
    "paged-spec2": dict(decode_k=2, kv_page_tokens=8, speculate_k=2),
    "paged-spec4": dict(decode_k=4, kv_page_tokens=8, speculate_k=4),
}


@pytest.mark.parametrize("name", sorted(PROBES))
def test_probe_counts_the_jax_probes_tokens(carried, name):
    """The device's own ``lengths`` delta over the timed dispatches: the
    same count as the JAX probe's on carried params (a speculative
    candidate's count depends on the drafts the greedy tokens accept)."""
    mesh, jparams, model = carried
    kw = dict(SHAPE, n_dispatches=3, repeats=2)
    got = ttune.probe_candidate(_tcfg(TINY_TF), "cpu", model,
                                ttune.ServeCandidate(**PROBES[name]), **kw)
    want = jtune.probe_candidate(TINY_TF, mesh, jparams,
                                 jtune.ServeCandidate(**PROBES[name]), **kw)
    assert got.feasible and want.feasible, (got.error, want.error)
    assert got.tokens == want.tokens > 0
    assert got.tokens_per_sec > 0 and got.dispatch_ms > 0


def test_probe_prunes_a_failing_candidate_and_restores_counters(carried):
    """Never raises: a candidate the engine refuses comes back pruned
    with its error, and the launch counters are where they were."""
    from tpudist_torch import engine as engine_lib
    _, _, model = carried
    before = engine_lib.kernel_launch_counts()
    res = ttune.probe_candidate(_tcfg(TINY_TF), "cpu", model,
                                ttune.ServeCandidate(decode_k=2,
                                                     layout="zz"),
                                **SHAPE)
    assert not res.feasible and "ValueError" in res.error
    assert res.dispatch_ms == float("inf") and res.tokens_per_sec == 0.0
    assert engine_lib.kernel_launch_counts() == before


def test_released_engine_serves_no_more(carried):
    from tpudist_torch.serve.engine import ServeEngine
    _, _, model = carried
    engine = ServeEngine(_tcfg(TINY_TF), device="cpu", decode_k=2,
                         **SHAPE)
    engine.warmup(model)
    engine.release()
    with pytest.raises(RuntimeError, match="released"):
        engine.init_state()
    assert engine.compile_counts() == (1, 1)


# ------------------------------------------------------------- the CLI


CLI = ["--device", "cpu", "--requests", "6", "--max-new-tokens", "6",
       "--slots", "2", "--max-seq", "32", "--prompt-pad", "8"]


def _serve_records(save):
    return [json.loads(line) for line in
            (save / "metrics.jsonl").read_text().splitlines()]


def test_cli_tunes_caches_and_serves_the_committed_point(tmp_path):
    """``--serve-tune probe`` logs one kind=serve_tune record and serves
    at the committed point, with the tokens of an untuned run at that
    point; ``cache-only`` on the same directory is a hit with 0 trials.
    The cache directory resolves as the flag, then
    ``$TPUDIST_AUTOTUNE_CACHE_DIR``, then ``<save-dir>/tune``."""
    tuned = tcli.run(tcli.parse_args(
        CLI + ["--serve-tune", "probe", "--tune-cache-dir",
               str(tmp_path / "cache"), "--save-dir", str(tmp_path / "a")]))
    recs = _serve_records(tmp_path / "a")
    tune = [r for r in recs if r["kind"] == "serve_tune"]
    assert len(tune) == 1 and tune[0]["source"] == "probe"
    assert tune[0]["status"] == "success" and tune[0]["pruned"] == 0
    assert 0 < tune[0]["trials"] <= ttune.DEFAULT_TRIALS
    t = tune[0]
    assert (tuned["decode_k"], tuned["kv_page_tokens"],
            tuned["speculate_k"]) == (t["decode_k"], t["kv_page_tokens"],
                                      t["speculate_k"])
    if not t["kv_page_tokens"]:          # the paged engine stores "st"
        assert tuned["kv_layout"] == t["layout"]
    point = ["--decode-steps-per-dispatch", str(t["decode_k"]),
             "--kv-layout", t["layout"]]
    if t["kv_page_tokens"]:
        point += ["--kv-page-tokens", str(t["kv_page_tokens"]),
                  "--speculate-k", str(t["speculate_k"])]
    plain = tcli.run(tcli.parse_args(CLI + point + [
        "--save-dir", str(tmp_path / "b")]))
    assert {r: v["tokens"] for r, v in tuned["results"].items()} == \
        {r: v["tokens"] for r, v in plain["results"].items()}
    hit = tcli.run(tcli.parse_args(
        CLI + ["--serve-tune", "cache-only", "--tune-cache-dir",
               str(tmp_path / "cache"), "--save-dir", str(tmp_path / "c")]))
    rec = [r for r in _serve_records(tmp_path / "c")
           if r["kind"] == "serve_tune"][0]
    assert (rec["source"], rec["trials"]) == ("cache", 0)
    assert hit["decode_k"] == tuned["decode_k"]
    assert len(list((tmp_path / "cache").glob("serve-*.json"))) == 1
