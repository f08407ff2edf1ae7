"""The train side of the port's chaos plane against the JAX package's.

* ``ChaosRuntime``'s step and checkpoint surfaces, the cases of
  ``tests/test_chaos.py`` run through the port's runtime and the JAX
  one side by side: the same fires, exit codes, sleeps, raised errors
  and records (kill with its beacon, slow, rank scoping, telemetry
  garbage on an emitter and with none, hang waiting for the watchdog's
  dump, fs_error bound to the first matching save, torn_manifest, the
  hook's install/uninstall); ``corrupt_shard`` leaves a file byte for
  byte equal to the one the JAX runtime leaves from the same input file
  and plan, flipped and truncated.
* The copies pinned to their sources: ``drill.FAMILIES`` and
  ``BASE_FLAGS`` by value, and the
  copied functions of ``inject``, ``verify`` and ``obs.goodput`` by
  source text (module paths aside).
* ``attempt_record`` and ``build_from_dir`` of both packages on one port
  run directory (a killed attempt and its ``--resume auto`` requeue):
  equal ledgers, and the run's own ``kind=goodput`` record equal to
  ``attempt_record`` over its records.
"""

import inspect
import json
import os
import subprocess
import sys
import time
from unittest import mock

import pytest
import torch

from tpudist.chaos import drill as jdrill
from tpudist.chaos import inject as jinject
from tpudist.chaos import plan as jplan
from tpudist.chaos import verify as jverify
from tpudist.elastic import ckpt as jeck
from tpudist.obs import goodput as jgoodput
from tpudist_torch import rules as trules
from tpudist_torch.chaos import drill as tdrill
from tpudist_torch.chaos import inject as tinject
from tpudist_torch.chaos import plan as tplan
from tpudist_torch.chaos import verify as tverify
from tpudist_torch.elastic import ckpt as teck
from tpudist_torch.obs import goodput as tgoodput

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Exit(Exception):
    def __init__(self, rc):
        self.rc = rc


class _Metrics:
    def __init__(self):
        self.recs = []

    def log(self, **kv):
        self.recs.append(kv)

    def flush(self):
        pass


def _runtimes(spec, **kw):
    """The JAX runtime and the port's on one spec, each with a fake
    exit, a recorded sleep and a metrics sink."""
    out = []
    for inject, plan in ((jinject, jplan), (tinject, tplan)):
        rt = inject.ChaosRuntime(plan.ChaosPlan.parse(spec),
                                 metrics=_Metrics(), **kw)
        rt.sleeps = []

        def fake_exit(rc):
            raise _Exit(rc)
        rt._exit = fake_exit
        rt._sleep = rt.sleeps.append
        out.append(rt)
    return out


def _drive(rt, calls):
    """Each ``(surface, args, kwargs)`` call on ``rt``: what it returned
    or raised, then the runtime's fires, sleeps and records."""
    seen = []
    for surface, args, kwargs in calls:
        try:
            seen.append(("ok", getattr(rt, surface)(*args, **kwargs)))
        except _Exit as e:
            seen.append(("exit", e.rc))
        except OSError as e:
            seen.append(("oserror", e.errno))
    return seen, rt.fired, rt.sleeps, rt.metrics.recs


STEPS = [("on_step", (0, s), {}) for s in range(1, 9)]


def _ckpt(point, step, epoch=0, path=None):
    return ("ckpt_fault", (point,), dict(step=step, epoch=epoch,
                                         step_in_epoch=step, path=path))


@pytest.mark.parametrize("spec,kw,calls", [
    ("kill@0:5,rc=77", {}, STEPS),
    ("kill@0:5", {}, STEPS),
    ("slow@0:3,s=0.25,steps=2", {}, STEPS),
    ("kill@0:5:2", {"process_index": 0}, STEPS),
    ("kill@0:5:2", {"process_index": 2}, STEPS),
    ("telemetry_garbage@0:4,n=32", {}, STEPS),
    ("fs_error@0:3,n=2", {}, [_ckpt("shard_write", 3)] * 3
     + [_ckpt("shard_write", 6)]),
    ("fs_error@0:3,n=99,errno=ENOSPC", {}, [_ckpt("shard_write", 3)] * 5),
    ("torn_manifest@0:6", {}, [_ckpt("shard_write", 6),
                               _ckpt("shard_written", 6),
                               _ckpt("index_written", 6)]),
    ("fs_error@0:3,n=2;fs_error@0:6,n=99", {},
     [_ckpt(p, s, e) for s, e in ((3, 0), (6, 0), (0, 1))
      for p in ("shard_write",) * 5 + ("shard_written", "index_written")]),
])
def test_step_and_ckpt_surfaces_equal_jax(spec, kw, calls):
    class Obs:
        beacons = 0

        def beacon_now(self):
            self.beacons += 1
    jobs, tobs = Obs(), Obs()
    j, t = _runtimes(spec, **kw)
    j.observer, t.observer = jobs, tobs
    assert _drive(t, calls) == _drive(j, calls)
    assert tobs.beacons == jobs.beacons


def test_telemetry_garbage_feeds_an_emitter_as_jax():
    class Em:
        def __init__(self):
            self.blobs = []

        def inject_garbage(self, data):
            self.blobs.append(bytes(data))
    j, t = _runtimes("telemetry_garbage@0:4,n=32")
    j.emitter, t.emitter = Em(), Em()
    for rt in (j, t):
        rt.on_step(0, 4)
        rt.on_step(0, 5)
    assert t.emitter.blobs == j.emitter.blobs
    assert len(t.emitter.blobs) == 1 and len(t.emitter.blobs[0]) == 32


def test_hang_waits_for_the_watchdogs_dump_as_jax():
    codes = []
    for rt in _runtimes("hang@0:5,rc=137,max_s=30,settle_s=0"):
        class Rec:
            dumps = 0

        class Obs:
            recorder = Rec()

            def beacon_now(self):
                pass
        rt.observer = Obs()
        waits = {"n": 0}

        def fake_sleep(s, rt=rt, waits=waits):
            waits["n"] += 1
            if waits["n"] == 3:
                rt.observer.recorder.dumps = 1   # the watchdog fires
        rt._sleep = fake_sleep
        with pytest.raises(_Exit) as e:
            rt.on_step(0, 5)
        codes.append((e.value.rc, waits["n"] >= 3))
    assert codes[0] == codes[1] == (137, True)


@pytest.mark.parametrize("mode", ["flip", "truncate"])
def test_corrupt_shard_damages_the_file_as_jax(tmp_path, mode):
    """The same input file and plan: the port's runtime leaves the bytes
    the JAX runtime leaves."""
    payload = bytes(range(256)) * 37
    spec = f"corrupt_shard@0:6,mode={mode}"
    out = []
    for rt, name in zip(_runtimes(spec), ("jax", "port")):
        p = tmp_path / f"{name}.npz"
        p.write_bytes(payload)
        rt.ckpt_fault("shard_write", step=6, epoch=0, step_in_epoch=6,
                      path=str(p))
        rt.ckpt_fault("shard_written", step=6, epoch=0, step_in_epoch=6,
                      path=str(p))
        out.append(p.read_bytes())
    assert out[0] == out[1] and out[1] != payload


def test_install_and_uninstall_the_ports_hook():
    j, t = _runtimes("torn_manifest@0:6")
    t.install()
    assert teck._FAULT_HOOK == t.ckpt_fault and jeck._FAULT_HOOK is None
    t.uninstall()
    assert teck._FAULT_HOOK is None
    _, t2 = _runtimes("kill@0:5")
    t2.install()
    assert teck._FAULT_HOOK is None


# ------------------------------------------------------------ the pins


def _src(obj):
    return inspect.getsource(obj)


def _pin(jmod, tmod, names):
    for name in names:
        assert _src(getattr(tmod, name)) == _src(getattr(
            jmod, name)).replace("tpudist.", "tpudist_torch."), name


def test_drill_tables_equal_jax(tmp_path):
    assert tdrill.FAMILIES == jdrill.FAMILIES
    assert tdrill.BASE_FLAGS == jdrill.BASE_FLAGS
    assert (tdrill.RESULTS_NAME, tdrill.BASELINE_DIR, tdrill.MAX_REQUEUES,
            tdrill.BACKOFF_BASE_S) == (
        jdrill.RESULTS_NAME, jdrill.BASELINE_DIR, jdrill.MAX_REQUEUES,
        jdrill.BACKOFF_BASE_S)
    # nothing is left undrilled: the default matrix runs every family,
    # in the JAX table's order
    drilled = []
    with mock.patch.object(tdrill, "run_baseline", return_value={}), \
            mock.patch.object(tdrill, "run_family",
                              side_effect=lambda d, f, **kw: drilled.append(
                                  f) or {"rcs": []}), \
            mock.patch.object(tdrill, "write_results"):
        results = tdrill.run_matrix(str(tmp_path))
    assert drilled == list(jdrill.FAMILIES)
    assert "not_drilled" not in results


def test_status_rules_grade_alertable_rules():
    """Each at-exit field of ``STATUS_RULES`` (held equal to the JAX
    table in ``tests/test_torch_serve.py``) names an alert rule."""
    assert {rule for _, rule in trules.STATUS_RULES} <= {
        t.name for t in trules.THRESHOLDS if t.alert}


def test_copied_functions_equal_their_sources():
    _pin(jinject.ChaosRuntime, tinject.ChaosRuntime,
         ("on_step", "_hang", "ckpt_fault",
          "_corrupt", "install", "uninstall"))
    assert tinject._ERRNOS == jinject._ERRNOS
    assert tinject.HANG_MAX_S == jinject.HANG_MAX_S
    _pin(jverify, tverify, ("_load_json", "crc_signature",
                            "_avg_loss_lines", "verify_family",
                            "bench_artifact", "run_and_verify",
                            "verify_matrix"))
    assert tverify.REPORT_NAME == jverify.REPORT_NAME
    _pin(jgoodput, tgoodput, (
        "goodput_status", "load_jsonl", "load_attempts", "find_metrics",
        "find_beacons", "_progress_key", "_kind", "_ckpt_seconds",
        "_eval_seconds", "attempt_record", "_completed_into",
        "_beacon_progress", "_dead_into", "build_ledger",
        "build_from_dir", "append_attempt"))
    for name in ("GOODPUT_SCHEMA_VERSION", "ATTEMPTS_NAME", "LEDGER_NAME",
                 "TOLERANCE", "SUCCESS", "FAIL", "UNGATEABLE",
                 "GOODPUT_MIN", "BUCKETS", "ATTEMPT_BUCKETS"):
        assert getattr(tgoodput, name) == getattr(jgoodput, name), name


# ------------------------------------- the ledgers on a port run's dir

ARGV = ["--epochs", "1", "--train-batch-size", "8", "--n-samples", "64",
        "--log-every", "2", "--lr", "1e-2", "--seed", "3", "--ckpt-mode",
        "sharded", "--ckpt-every-steps", "3", "--device", "cpu"]


@pytest.fixture(scope="module")
def killed_run(tmp_path_factory):
    """A port run killed at step 5, then requeued with ``--resume auto``,
    ``attempts.jsonl`` written around both attempts as a launcher
    does. The killed attempt saves synchronously, so its step-3 commit
    has landed before the kill: an asynchronous writer starved of the
    CPU could still be writing it when the process dies."""
    d = str(tmp_path_factory.mktemp("run"))
    env = dict(os.environ, OMP_NUM_THREADS="1", TPUDIST_RUN_ID="gp")
    for attempt, (extra, e) in enumerate((
            (["--ckpt-sync"], {"TPUDIST_TEST_KILL": "0:5"}),
            (["--resume", "auto", "--requeue-attempt", "1"], {}))):
        t0 = time.time()
        rc = subprocess.run(
            [sys.executable, "-m", "tpudist_torch.train", *ARGV,
             "--save-dir", d, *extra], cwd=REPO, env=dict(env, **e),
            capture_output=True, timeout=240).returncode
        tgoodput.append_attempt(
            os.path.join(d, tgoodput.ATTEMPTS_NAME), attempt=attempt,
            start_ts=t0, end_ts=time.time(), rc=rc,
            verdict="success" if rc == 0 else "preemption", run_id="gp")
        assert rc == (113 if attempt == 0 else 0)
    return d


def test_build_from_dir_equals_jax(killed_run):
    t = tgoodput.build_from_dir(killed_run)
    assert t == jgoodput.build_from_dir(killed_run)
    assert t["exact"] and t["lost_steps"] == 2
    assert [a["attempt"] for a in t["attempts"]] == [0, 1]


def test_attempt_record_equals_jax_and_the_runs_own(killed_run):
    recs = tgoodput.load_jsonl(os.path.join(killed_run, "metrics.jsonl"))
    mine = [r for r in recs if r.get("requeue_attempt") == 1]
    (own,) = [r for r in mine if r["kind"] == "goodput"]
    history = mine[:mine.index(own)]
    for wall in (own["wall_s"], 1.0, 0.0):
        for att in (0, 1):
            assert tgoodput.attempt_record(
                history, wall_s=wall, requeue_attempt=att) == \
                jgoodput.attempt_record(history, wall_s=wall,
                                        requeue_attempt=att)
    again = tgoodput.attempt_record(history, wall_s=own["wall_s"],
                                    requeue_attempt=1)
    assert {k: own[k] for k in again} == again
    (drain,) = [r for r in mine if r["kind"] == "ckpt_drain"]
    assert {"drain_ms", "saves", "write_errors", "write_retries",
            "write_skips"} <= set(drain)
    assert drain["saves"] == 2
    assert json.dumps(own)     # a plain JSON record
