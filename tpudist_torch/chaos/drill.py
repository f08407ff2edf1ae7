"""The chaos drill matrix: the fault families against the real train CLI.

A port of ``tpudist/chaos/drill.py``: it runs ``python -m
tpudist_torch.train`` in subprocesses under each fault family, replaying
the launcher's own loop for the fatal ones (scripted fault → exit code →
requeue-policy classification, :mod:`tpudist_torch.elastic.policy` →
backoff → ``--resume auto --requeue-attempt 1`` rerun) and writing
``attempts.jsonl`` around every invocation as the launcher would, so the
goodput ledger accounts each drill's wall.

The workload is the JAX drill's (:data:`BASE_FLAGS`: 8 steps an epoch,
sharded saves at steps 3 and 6 and the epoch end, per-step dispatch), so
every fault's outcome is deterministic and pinned in :data:`FAMILIES`,
both held equal to the JAX package's; :mod:`tpudist_torch.chaos.verify`
replays the artifacts against them. Where the JAX drill gives its
attempts a 4-device CPU mesh, the port's attempts run one process on
``TPUDIST_PLATFORM`` (``cpu`` unless the caller names the card), and
``model`` appends flags after :data:`BASE_FLAGS` (a later flag wins), so
the same matrix runs a full-width model on the card. Two families run
with the train CLI's live telemetry bus on: ``hang`` (the watchdog's
stall dump must reach the aggregator as a mid-run ``stall`` alert) and
``telemetry_garbage`` (garbage on the socket: the decoder must
resynchronise, ``bad_frames`` > 0, and the run end ``status: ok``).

The module imports neither torch nor numpy; only the subprocesses do.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from typing import Any, Dict, Optional, Sequence, Tuple

from tpudist_torch.elastic import policy
from tpudist_torch.obs import goodput as goodput_mod

RESULTS_NAME = "chaos_results.json"
BASELINE_DIR = "baseline"

# The drill workload: 64 samples / batch 8 = 8 steps in one epoch;
# log-every 2 and ckpt-every 3 share no divisor > 1, so dispatch is
# per-step and every trigger lands on its exact step. Sharded sync
# saves commit at steps 3 and 6 plus the epoch-end step 8.
BASE_FLAGS = ("--epochs", "1", "--train-batch-size", "8",
              "--n-samples", "64", "--log-every", "2", "--lr", "1e-2",
              "--seed", "3", "--ckpt-mode", "sharded", "--ckpt-sync",
              "--ckpt-every-steps", "3")
# the drill's policy loop (mirrors MAX_REQUEUES/REQUEUE_BACKOFF_S)
MAX_REQUEUES = 2
BACKOFF_BASE_S = 0.2

# Per-family script + pinned expectations. ``expect_rc`` is the fault's
# exit code; families with ``resumed_from`` run the policy→requeue→
# resume loop and must come back from exactly that committed step with
# exactly ``lost`` recomputed steps (dead beacon − resume point). Every
# family must end bitwise-identical to the unfaulted baseline (final
# committed shard-index crc32s — the unchanged-mesh parity pin).
FAMILIES: Dict[str, Dict[str, Any]] = {
    "kill": dict(
        spec="kill@0:5",
        expect_rc=113, policy="preemption", resumed_from=3, lost=2),
    "hang": dict(
        # the wedge trips the 0.5 s watchdog (stall flight record +
        # live stall alert), then dies with `timeout -k`'s SIGKILL
        # code — the policy must read rc 137 + stall dump as STALL
        spec="hang@0:5,rc=137",
        attempt_flags=("--stall-timeout-s", "0.5", "--live", "on"),
        live=True, stall_alert=True,
        expect_rc=137, policy="stall", resumed_from=3, lost=2),
    "slow": dict(
        # a straggler is not fatal: the run completes with identical
        # math (the Avg-loss line must match the baseline's, bitwise)
        spec="slow@0:3,s=0.05,steps=3",
        expect_rc=0, loss_parity=True),
    "corrupt_shard": dict(
        # the step-6 shard is flipped AFTER it landed (the commit
        # proceeds); the post-kill resume must crc-reject step 6 and
        # fall back to step 3 — losing 4 steps instead of 1, which the
        # ledger must count
        spec="corrupt_shard@0:6,mode=flip;kill@0:7",
        expect_rc=113, policy="preemption",
        resumed_from=3, lost=4, fallback_from=6),
    "torn_manifest": dict(
        # killed between the step-6 index landing and the commit: the
        # step-3 manifest stays authoritative, never a torn checkpoint
        spec="torn_manifest@0:6",
        expect_rc=113, policy="preemption", resumed_from=3, lost=3),
    "fs_error": dict(
        # two transient EIOs at the step-3 save retry away (commit
        # lands); exhaustion at step 6 skips THAT commit without
        # wedging the writer or the run — steps 3 and 8 commit, 6 not
        spec="fs_error@0:3,n=2;fs_error@0:6,n=99",
        expect_rc=0, write_retries_min=2, write_skips=1,
        committed=(3, 8), uncommitted=(6,)),
    "telemetry_garbage": dict(
        # seeded garbage on the live bus mid-run: the aggregator's
        # decoder must resynchronise (bad_frames > 0) and keep
        # ingesting to the final step, ending status ok
        spec="telemetry_garbage@0:4,n=64",
        attempt_flags=("--live", "on"), live=True,
        expect_rc=0, bad_frames=True),
}



class ChaosDrillError(RuntimeError):
    """A drill attempt did not follow its script (distinct from an
    INVARIANT violation, which verify reports rather than raises)."""


def _attempt(python: str, save_dir: str, *, extra: Sequence[str] = (),
             model: Sequence[str] = (),
             env_extra: Optional[Dict[str, str]] = None,
             log_name: str = "attempt.log",
             timeout_s: float = 900.0
             ) -> Tuple[subprocess.CompletedProcess, float, float]:
    """One train-CLI invocation with a clean TPUDIST_* environment
    (outer chaos/live/kill knobs must not leak into a drill) but the
    platform and the kernels' build root, one CPU thread on the CPU (a
    multi-threaded CPU run is not bitwise reproducible), and the goodput
    floor out of the way (a drill is start-up dominated: the gate must
    grade the wiring, not this host's start-up); its output kept next to
    the artifacts."""
    env = dict(os.environ)
    keep = {"TPUDIST_PLATFORM", "TPUDIST_COMPILATION_CACHE_DIR"}
    for k in list(env):
        if k.startswith("TPUDIST_") and k not in keep:
            env.pop(k)
    env.setdefault("TPUDIST_PLATFORM", "cpu")
    if env["TPUDIST_PLATFORM"].lower() == "cpu":
        env.setdefault("OMP_NUM_THREADS", "1")
    env["TPUDIST_GOODPUT_MIN"] = "0.00001"
    env.update(env_extra or {})
    start = time.time()
    proc = subprocess.run(
        [python, "-m", "tpudist_torch.train", "--save-dir", save_dir,
         *BASE_FLAGS, *model, *extra],
        env=env, capture_output=True, text=True, timeout=timeout_s)
    end = time.time()
    try:
        with open(os.path.join(save_dir, log_name), "w") as f:
            f.write(proc.stdout)
            if proc.stderr:
                f.write("\n--- stderr ---\n" + proc.stderr)
    except OSError:
        pass
    return proc, start, end


def _tail(proc: subprocess.CompletedProcess, n: int = 30) -> str:
    lines = (proc.stdout + "\n" + proc.stderr).splitlines()
    return "\n".join(lines[-n:])


def run_baseline(run_dir: str, *, python: Optional[str] = None,
                 model: Sequence[str] = ()) -> Dict[str, Any]:
    """The unfaulted reference run every family's final state is
    compared against (bitwise, by committed shard-index crc)."""
    python = python or sys.executable
    d = os.path.join(run_dir, BASELINE_DIR)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d, exist_ok=True)
    proc, start, end = _attempt(
        python, d, model=model,
        env_extra={"TPUDIST_RUN_ID": "chaos-baseline"},
        log_name="baseline.log")
    if proc.returncode != 0:
        raise ChaosDrillError(
            f"baseline run exited {proc.returncode}:\n{_tail(proc)}")
    goodput_mod.append_attempt(
        os.path.join(d, goodput_mod.ATTEMPTS_NAME), attempt=0,
        start_ts=start, end_ts=end, rc=0, verdict="success",
        run_id="chaos-baseline")
    return {"dir": BASELINE_DIR, "rc": 0,
            "wall_s": round(end - start, 3)}


def run_family(run_dir: str, family: str, *,
               python: Optional[str] = None,
               model: Sequence[str] = ()) -> Dict[str, Any]:
    """One family's scripted drill: fault run, policy classification,
    and (for fatal families) the backoff + ``--resume auto`` rerun —
    the launcher's loop, replayed with the real standard-library
    policy."""
    cfg = FAMILIES[family]
    python = python or sys.executable
    d = os.path.join(run_dir, family)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d, exist_ok=True)
    run_id = f"chaos-{family}"
    attempts_path = os.path.join(d, goodput_mod.ATTEMPTS_NAME)
    out: Dict[str, Any] = {
        "family": family, "spec": cfg["spec"], "dir": family,
        "expect": {k: v for k, v in cfg.items() if k != "attempt_flags"},
        "rcs": []}

    p0, s0, e0 = _attempt(
        python, d, extra=cfg.get("attempt_flags", ()), model=model,
        env_extra={"TPUDIST_CHAOS": cfg["spec"],
                   "TPUDIST_RUN_ID": run_id},
        log_name="attempt0.log")
    out["rcs"].append(p0.returncode)
    if p0.returncode != cfg["expect_rc"]:
        raise ChaosDrillError(
            f"{family}: attempt 0 exited {p0.returncode}, the script "
            f"expected {cfg['expect_rc']}:\n{_tail(p0)}")
    if cfg["expect_rc"] == 0:
        goodput_mod.append_attempt(
            attempts_path, attempt=0, start_ts=s0, end_ts=e0, rc=0,
            verdict="success", run_id=run_id)
        return out

    # the launcher's requeue-or-stop call, verbatim: rc + this
    # attempt's collected evidence (beacons/flight records land in the
    # save dir — the default heartbeat dir)
    decision = policy.decide(p0.returncode, attempt=0,
                             max_requeues=MAX_REQUEUES,
                             flightrec_dir=d, base_s=BACKOFF_BASE_S)
    out["policy"] = {"verdict": decision.verdict,
                     "requeue": decision.requeue,
                     "backoff_s": decision.backoff_s,
                     "reason": decision.reason}
    goodput_mod.append_attempt(
        attempts_path, attempt=0, start_ts=s0, end_ts=e0,
        rc=p0.returncode, verdict=decision.verdict, run_id=run_id)
    if not decision.requeue:
        raise ChaosDrillError(
            f"{family}: policy refused to requeue — "
            f"{decision.shell_line()}")
    time.sleep(decision.backoff_s)      # the measured off-pod gap

    p1, s1, e1 = _attempt(
        python, d, extra=("--resume", "auto", "--requeue-attempt", "1"),
        model=model, env_extra={"TPUDIST_RUN_ID": run_id},
        log_name="attempt1.log")
    out["rcs"].append(p1.returncode)
    goodput_mod.append_attempt(
        attempts_path, attempt=1, start_ts=s1, end_ts=e1,
        rc=p1.returncode,
        verdict="success" if p1.returncode == 0 else "crash",
        run_id=run_id)
    if p1.returncode != 0:
        raise ChaosDrillError(
            f"{family}: resume attempt exited {p1.returncode}:\n"
            f"{_tail(p1)}")
    return out


def write_results(run_dir: str, results: Dict[str, Any]) -> None:
    """``chaos_results.json``, atomically: what verify replays offline."""
    path = os.path.join(run_dir, RESULTS_NAME)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(results, f, indent=1)
    os.replace(tmp, path)


def run_matrix(run_dir: str, *, python: Optional[str] = None,
               families: Optional[Sequence[str]] = None,
               model: Sequence[str] = ()) -> Dict[str, Any]:
    """The matrix: baseline + each family (default: all seven), results
    persisted as ``chaos_results.json`` so verify can replay them
    offline."""
    os.makedirs(run_dir, exist_ok=True)
    python = python or sys.executable
    results: Dict[str, Any] = {
        "schema": 1,
        "baseline": run_baseline(run_dir, python=python, model=model),
        "families": {}}
    for family in (families or FAMILIES):
        results["families"][family] = run_family(
            run_dir, family, python=python, model=model)
        print(f"tpudist: chaos drill {family}: scripted outcome held "
              f"(rcs {results['families'][family]['rcs']})", flush=True)
    write_results(run_dir, results)
    return results
