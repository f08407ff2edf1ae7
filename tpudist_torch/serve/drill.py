"""The serve resilience drill: overload + serve fault matrix, verified.

A port of ``tpudist/serve/drill.py``: it runs the port's REAL
serve CLI (``python -m tpudist_torch.serve``) in subprocesses under
scripted overload and the serve-surface chaos families, replaying the
launcher's requeue loop for the fatal one (serve_kill -> exit code -> the
requeue policy, :mod:`tpudist_torch.elastic.policy` -> backoff ->
``--requeue-attempt 1`` rerun, with ``attempts.jsonl`` written like
``launch_tpu.sh``), and a verifier replays the artifacts and asserts
the resilience contract end to end:

  * **overload** (2x sustained capacity, virtual clock): the admitted
    traffic's p99 TTFT stays bounded by the deadline (+ one scheduler
    boundary of slack), the shed partition of ALL arrivals is exact
    (``arrived == admitted + shed + expired + rejected``), both shed
    mechanisms actually fired, and two runs of the same seed produced
    BITWISE-identical SLO summaries (the virtual clock's whole point);
  * **shed_breach**: a tightened ``TPUDIST_SERVE_SHED_MAX`` makes the
    same overload grade FAIL — the exit code goes 1 and every failed
    gate has its matching mid-run alert in the live aggregator's
    ``alerts.jsonl`` (``rules.SERVE_STATUS_RULES``);
  * **serve_kill**: a hard kill at a dispatch boundary is classified
    (preemption), requeued, and the resumed attempt replays the
    still-live queued requests while classifying the dead attempt's
    in-flight slots as LOST — every rid ends in exactly one terminal
    bucket across attempts, and the restarted engine built exactly its
    warmup budget (1 prefill + 1 decode program per ladder rung);
  * **request_garbage**: every seeded malformed request is rejected at
    admission with a named reason — the engine never crashes;
  * **serve_slow**: the per-dispatch stall is visible in the (virtual,
    deterministic) ITL percentiles and the run still completes;
  * **adapt**: sustained pressure downshifts the decode_k ladder
    (logged ``kind=serve_adapt``) with zero recompiles past warmup.

The JAX drill's scenarios, flags and checks are kept as they are
(``tests/test_torch_serve_drill*.py`` run the JAX package's verifier on
this drill's artifacts too). Every attempt runs on the CPU unless the
caller's ``TPUDIST_PLATFORM`` names the card. ``world`` (default 1)
runs each attempt as that many serve CLI processes under the
``TPUDIST_COORDINATOR`` / ``TPUDIST_NUM_PROCESSES`` /
``TPUDIST_PROCESS_ID`` contract, one serve mesh, as the JAX drill's
attempts run on its device mesh: the attempt's exit code is rank 0's
(the scheduler's, where the faults fire), the others' are recorded
beside it (``follower_rcs``), and each rank's output goes to the
attempt's log (``.rank<r>`` for a follower). ``run_scenario`` and ``run_matrix``
take ``model``, which replaces the model part of ``ENGINE_FLAGS`` and its
cache and prompt shape (``MODEL_OPTIONS``), so the same matrix can run at
a full width on the card with prompts the flash kernel takes. The module imports neither torch nor numpy itself; only the
subprocesses need torch. ``python -m tpudist_torch.serve.drill
drill|verify`` is the CLI.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import shutil
import socket
import subprocess
import sys
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from tpudist_torch import rules as rules_lib
from tpudist_torch.elastic import policy
from tpudist_torch.obs import goodput as goodput_mod
from tpudist_torch.serve import resilience as res_lib

RESULTS_NAME = "serve_resilience_results.json"
REPORT_NAME = "serve_resilience_report.json"
MAX_REQUEUES = 2
BACKOFF_BASE_S = 0.2

# The drill workload: a tiny transformer on the CPU,
# virtual-clock timing (prefill 2 ms, decode dispatch 4 ms) so every
# scenario's shed decisions and percentiles are a pure function of the
# seed. Measured capacity of this shape is ~250 admitted requests/s;
# the overload scenarios arrive at 500/s — sustained 2x.
ENGINE_FLAGS = ("--model", "transformer", "--vocab-size", "64",
                "--n-layers", "2", "--d-model", "32", "--n-heads", "4",
                "--n-kv-heads", "2", "--d-ff", "64",
                "--slots", "4", "--max-seq", "32", "--prompt-pad", "8",
                "--seed", "3", "--virtual-clock")
# the options of ENGINE_FLAGS that ``model`` may replace: the model's
# widths and depth, and the cache and prompt shape (the flash kernel
# takes prompts of a multiple of 128 tokens only; the slots stay)
MODEL_OPTIONS = ("--vocab-size", "--n-layers", "--d-model", "--n-heads",
                 "--n-kv-heads", "--d-ff", "--max-seq", "--prompt-pad")
OVERLOAD_FLAGS = ENGINE_FLAGS + (
    "--requests", "80", "--request-rate", "500",
    "--max-new-tokens", "8", "--decode-steps-per-dispatch", "4",
    "--queue-cap", "16", "--ttft-deadline-ms", "40")
OVERLOAD_DEADLINE_S = 0.040
# one scheduler boundary of TTFT slack past the deadline: a request can
# clear the expiry check and still wait out the in-flight dispatch
# (4 ms) plus a slot-refill round of prefills (4 x 2 ms) before its own
# prefill lands
OVERLOAD_SLACK_S = 0.020

SCENARIOS: Dict[str, Dict[str, Any]] = {
    "overload": dict(
        flags=OVERLOAD_FLAGS, runs=2, expect_rc=0,
        bitwise=True, shed_admission=True, expired=True,
        ttft_bound_s=OVERLOAD_DEADLINE_S + OVERLOAD_SLACK_S,
        min_shed_fraction=0.2),
    "shed_breach": dict(
        flags=OVERLOAD_FLAGS, expect_rc=1,
        env={"TPUDIST_SERVE_SHED_MAX": "0.05"},
        fail_gates=("serve_shed_status",), alert_parity=True),
    "serve_kill": dict(
        flags=ENGINE_FLAGS + (
            "--requests", "24", "--request-rate", "300",
            "--max-new-tokens", "8", "--decode-steps-per-dispatch", "4",
            "--queue-cap", "40"),
        chaos="serve_kill@0:6,rc=137",
        expect_rc=137, policy="preemption", resume=True, min_lost=1),
    "request_garbage": dict(
        flags=ENGINE_FLAGS + (
            "--requests", "12", "--request-rate", "300",
            "--max-new-tokens", "6", "--decode-steps-per-dispatch", "4"),
        chaos="request_garbage@0:0,n=6",
        expect_rc=0, rejected=6, reject_reasons_min=2),
    "serve_slow": dict(
        flags=ENGINE_FLAGS + (
            "--requests", "16", "--request-rate", "300",
            "--max-new-tokens", "8", "--decode-steps-per-dispatch", "4"),
        chaos="serve_slow@0:2,s=0.02,steps=4",
        expect_rc=0, itl_inflated=True),
    "adapt": dict(
        flags=ENGINE_FLAGS + (
            "--requests", "100", "--request-rate", "600",
            "--max-new-tokens", "12",
            "--decode-steps-per-dispatch", "8", "--adapt", "on"),
        expect_rc=0, adapt_transitions=True, ladder_len=3),
}


class ServeDrillError(RuntimeError):
    """A drill attempt did not follow its script (distinct from an
    INVARIANT violation, which verify reports rather than raises)."""


def _with_model(flags: Sequence[str],
                model: Optional[Dict[str, Any]]) -> Tuple[str, ...]:
    """``flags`` with the value after each option of ``model``
    ({option: value}, options of ``MODEL_OPTIONS``) replaced."""
    bad = set(model or {}) - set(MODEL_OPTIONS)
    if bad:
        raise ValueError(f"model replaces {MODEL_OPTIONS} only, not "
                         f"{sorted(bad)}")
    out = list(flags)
    for i, flag in enumerate(out[:-1]):
        if flag in (model or {}):
            out[i + 1] = str(model[flag])
    return tuple(out)


def attempt_env(environ: Mapping[str, str],
                env_extra: Optional[Dict[str, str]] = None
                ) -> Dict[str, str]:
    """An attempt's environment: ``environ`` with a clean TPUDIST_* set
    (outer chaos/live/threshold knobs must not leak into a drill), the
    live bus on exporter-less (alerts.jsonl for the parity checks), and
    load-decoupled gates: the virtual clock makes TTFT/ITL
    deterministic, so the ceilings can be TIGHT in virtual seconds
    without grading this host's load; then ``env_extra``."""
    env = dict(environ)
    keep = {"TPUDIST_PLATFORM", "TPUDIST_COMPILATION_CACHE_DIR"}
    for k in list(env):
        if k.startswith("TPUDIST_") and k not in keep:
            env.pop(k)
    env.setdefault("TPUDIST_PLATFORM", "cpu")
    env["TPUDIST_LIVE"] = "on"
    env["TPUDIST_TTFT_P99_MAX"] = "0.5"
    env["TPUDIST_ITL_P99_MAX"] = "0.1"
    env["TPUDIST_TOKENS_PER_CHIP_MIN"] = "0.001"
    env.update(env_extra or {})
    return env


def _attempt(python: str, save_dir: str, flags: Sequence[str], *,
             env_extra: Optional[Dict[str, str]] = None,
             log_name: str = "attempt.log", timeout_s: float = 600.0,
             world: int = 1
             ) -> Tuple[subprocess.CompletedProcess, float, float,
                        List[int]]:
    """One serve-CLI invocation in :func:`attempt_env`'s environment:
    ``world`` processes of one serve mesh where ``world`` > 1. Returns
    rank 0's process, the wall stamps and the followers' exit codes."""
    env = attempt_env(os.environ, env_extra)
    argv = [python, "-m", "tpudist_torch.serve", "--save-dir", save_dir,
            *flags]
    envs = [env]
    if world > 1:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        envs = [dict(env, TPUDIST_COORDINATOR=f"localhost:{port}",
                     TPUDIST_NUM_PROCESSES=str(world),
                     TPUDIST_PROCESS_ID=str(r)) for r in range(world)]
    start = time.time()
    running = [subprocess.Popen(argv, env=e, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
               for e in envs]
    procs = []
    try:
        for p in running:
            out, err = p.communicate(timeout=timeout_s)
            procs.append(subprocess.CompletedProcess(argv, p.returncode,
                                                     out, err))
    finally:
        for p in running:
            p.kill()
    end = time.time()
    for r, proc in enumerate(procs):
        name = log_name if r == 0 else f"{log_name}.rank{r}"
        try:
            with open(os.path.join(save_dir, name), "w") as f:
                f.write(proc.stdout)
                if proc.stderr:
                    f.write("\n--- stderr ---\n" + proc.stderr)
        except OSError:
            pass
    return procs[0], start, end, [p.returncode for p in procs[1:]]


def _tail(proc: subprocess.CompletedProcess, n: int = 30) -> str:
    lines = (proc.stdout + "\n" + proc.stderr).splitlines()
    return "\n".join(lines[-n:])


def run_scenario(run_dir: str, name: str, *,
                 python: Optional[str] = None,
                 model: Optional[Dict[str, Any]] = None,
                 world: int = 1) -> Dict[str, Any]:
    """One scenario's scripted drill. Fatal scenarios (expect_rc != 0
    with a ``policy`` expectation) replay the launcher's loop: fault →
    policy classification → backoff → ``--requeue-attempt 1``
    rerun, with attempts.jsonl stamped around every invocation.
    ``model`` replaces options of ``MODEL_OPTIONS`` in its flags;
    ``world`` is each attempt's process count (:func:`_attempt`)."""
    cfg = SCENARIOS[name]
    flags = _with_model(cfg["flags"], model)
    python = python or sys.executable
    out: Dict[str, Any] = {"scenario": name, "dir": name,
                           "expect": {k: v for k, v in cfg.items()
                                      if k not in ("flags", "env")},
                           "rcs": [], "dirs": [], "world": world,
                           "follower_rcs": []}
    runs = int(cfg.get("runs", 1))
    env_extra = dict(cfg.get("env") or {})
    if cfg.get("chaos"):
        env_extra["TPUDIST_CHAOS"] = cfg["chaos"]
        out["chaos"] = cfg["chaos"]
    for r in range(runs):
        d = os.path.join(run_dir, name if runs == 1 else f"{name}{r}")
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d, exist_ok=True)
        out["dirs"].append(os.path.basename(d))
        run_id = f"serve-drill-{name}"
        attempts_path = os.path.join(d, goodput_mod.ATTEMPTS_NAME)
        env_extra["TPUDIST_RUN_ID"] = run_id
        p0, s0, e0, f0 = _attempt(python, d, flags,
                                  env_extra=env_extra,
                                  log_name="attempt0.log", world=world)
        out["rcs"].append(p0.returncode)
        out["follower_rcs"].append(f0)
        if p0.returncode != cfg["expect_rc"]:
            raise ServeDrillError(
                f"{name}: attempt 0 exited {p0.returncode}, the script "
                f"expected {cfg['expect_rc']}:\n{_tail(p0)}")
        if "policy" not in cfg:
            goodput_mod.append_attempt(
                attempts_path, attempt=0, start_ts=s0, end_ts=e0,
                rc=p0.returncode,
                verdict="success" if p0.returncode == 0 else "crash",
                run_id=run_id, mode="serve")
            continue
        # the launcher's requeue-or-stop call, verbatim (rc + this
        # attempt's collected evidence — the serve lane classifies from
        # the exit code alone, there are no beacons to consult)
        decision = policy.decide(p0.returncode, attempt=0,
                                 max_requeues=MAX_REQUEUES,
                                 flightrec_dir=d, base_s=BACKOFF_BASE_S)
        out["policy"] = {"verdict": decision.verdict,
                         "requeue": decision.requeue,
                         "backoff_s": decision.backoff_s,
                         "reason": decision.reason}
        goodput_mod.append_attempt(
            attempts_path, attempt=0, start_ts=s0, end_ts=e0,
            rc=p0.returncode, verdict=decision.verdict, run_id=run_id,
            mode="serve")
        if not decision.requeue:
            raise ServeDrillError(
                f"{name}: policy refused to requeue — "
                f"{decision.shell_line()}")
        time.sleep(decision.backoff_s)       # the measured off-pod gap
        env1 = {k: v for k, v in env_extra.items()
                if k != "TPUDIST_CHAOS"}
        p1, s1, e1, f1 = _attempt(python, d,
                                  (*flags, "--requeue-attempt", "1"),
                                  env_extra=env1, log_name="attempt1.log",
                                  world=world)
        out["rcs"].append(p1.returncode)
        out["follower_rcs"].append(f1)
        goodput_mod.append_attempt(
            attempts_path, attempt=1, start_ts=s1, end_ts=e1,
            rc=p1.returncode,
            verdict="success" if p1.returncode == 0 else "crash",
            run_id=run_id, mode="serve")
        if p1.returncode != 0:
            raise ServeDrillError(
                f"{name}: resume attempt exited {p1.returncode}:\n"
                f"{_tail(p1)}")
    return out


def run_matrix(run_dir: str, *, python: Optional[str] = None,
               scenarios: Optional[Sequence[str]] = None,
               model: Optional[Dict[str, Any]] = None,
               world: int = 1, lanes: int = 1) -> Dict[str, Any]:
    """The whole matrix, each attempt on ``world`` processes; results
    persisted as ``serve_resilience_results.json`` so verify can replay
    offline. ``lanes`` scenarios run side by side (each in directories
    of its own, its attempts one after another; the virtual clock keeps
    their summaries those of a run alone), the results in table
    order."""
    os.makedirs(run_dir, exist_ok=True)
    python = python or sys.executable
    results: Dict[str, Any] = {"schema": 1, "scenarios": {}}

    def one(name):
        return run_scenario(run_dir, name, python=python, model=model,
                            world=world)

    names = list(scenarios or SCENARIOS)
    with concurrent.futures.ThreadPoolExecutor(max(1, lanes)) as pool:
        for name, res in zip(names, pool.map(one, names)):
            results["scenarios"][name] = res
            print(f"tpudist: serve drill {name}: scripted outcome held "
                  f"(rcs {res['rcs']})", flush=True)
    path = os.path.join(run_dir, RESULTS_NAME)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(results, f, indent=1)
    os.replace(tmp, path)
    return results


# ------------------------------------------------------------- verifier


def _load_jsonl(path: str) -> List[Dict[str, Any]]:
    return goodput_mod.load_jsonl(path) if os.path.exists(path) else []


def _serve_summaries(recs: List[Dict[str, Any]]
                     ) -> List[Dict[str, Any]]:
    return [r for r in recs if r.get("kind") == "serve"]


_VOLATILE = ("ts", "mono")     # wall-clock stamps: the ONLY fields a
#                                virtual-clock rerun may legitimately vary


def _canonical_summary(rec: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in rec.items() if k not in _VOLATILE}


def _terminal_events(recs: List[Dict[str, Any]]
                     ) -> Dict[int, List[str]]:
    out: Dict[int, List[str]] = {}
    for r in recs:
        if r.get("kind") != "serve_request":
            continue
        if r.get("event") in res_lib.TERMINAL_EVENTS:
            out.setdefault(int(r["rid"]), []).append(r["event"])
    return out


def verify_scenario(run_dir: str, result: Dict[str, Any]
                    ) -> Dict[str, Any]:
    """One scenario's invariants against its artifacts. Returns
    ``{"ok", "problems", "facts"}`` — problems name exactly which leg
    of the resilience contract broke."""
    name = result["scenario"]
    expect = result.get("expect", {})
    dirs = [os.path.join(run_dir, d) for d in result.get("dirs", [name])]
    problems: List[str] = []
    facts: Dict[str, Any] = {"rcs": result.get("rcs")}

    recs_per_dir = [_load_jsonl(os.path.join(d, "metrics.jsonl"))
                    for d in dirs]
    if not any(recs_per_dir):
        problems.append("no metrics.jsonl survived the drill")
        return {"ok": False, "problems": problems, "facts": facts}
    recs = recs_per_dir[0]
    summaries = _serve_summaries(recs)
    summ = summaries[-1] if summaries else {}

    # -- scheduled chaos fired (flushed kind=chaos evidence)
    if result.get("chaos"):
        from tpudist_torch.chaos import plan as plan_mod
        want = {e.kind for e in
                plan_mod.ChaosPlan.parse(result["chaos"]).events}
        fired = {r.get("fault") for r in recs if r.get("kind") == "chaos"}
        if want - fired:
            problems.append(f"scheduled fault(s) never fired: "
                            f"{sorted(want - fired)}")
        facts["fired"] = sorted(k for k in fired if k)

    # -- exact shed partition, recomputed two ways: the summary's own
    # checked ledger AND the replayed per-request event stream
    part = summ.get("partition") or {}
    facts["partition"] = {k: part.get(k) for k in
                          ("arrived", "admitted", "shed_at_admission",
                           "expired_in_queue", "rejected", "completed",
                           "evicted", "lost", "shed_fraction")}
    if not summaries:
        problems.append("no kind=serve summary record")
    else:
        if not (part.get("admission_exact")
                and part.get("outcome_exact")):
            problems.append(f"shed partition INEXACT: {part}")
        n_arrived = part.get("arrived") or 0
        n_events = sum(
            1 for r in recs if r.get("kind") == "serve_request"
            and r.get("event") in (res_lib.SHED, res_lib.EXPIRED,
                                   res_lib.REJECTED, res_lib.DONE,
                                   res_lib.EVICTED))
        if result.get("rcs", [None])[0] == 0 and "policy" not in expect \
                and n_events != n_arrived:
            problems.append(
                f"event stream accounts {n_events} arrivals, the "
                f"ledger says {n_arrived} — the two books diverged")

    # -- overload: bounded admitted-traffic TTFT, both shed mechanisms,
    # bitwise determinism across the same-seed rerun
    if expect.get("ttft_bound_s") is not None and summaries:
        facts["ttft_p99_s"] = summ.get("ttft_p99_s")
        if not summ.get("ttft_p99_s") \
                or summ["ttft_p99_s"] > expect["ttft_bound_s"]:
            problems.append(
                f"admitted-traffic p99 TTFT {summ.get('ttft_p99_s')}s "
                f"exceeded the deadline bound "
                f"{expect['ttft_bound_s']}s under 2x overload — "
                f"admission control failed its one job")
        if summ.get("ttft_status") != "success":
            problems.append(f"ttft gate graded "
                            f"{summ.get('ttft_status')!r} on the "
                            f"admitted traffic")
    if expect.get("shed_admission") and not (summ.get(
            "shed_at_admission") or 0) > 0:
        problems.append("the bounded queue never shed at admission")
    if expect.get("expired") and not (summ.get(
            "expired_in_queue") or 0) > 0:
        problems.append("no queued request expired past its deadline")
    if expect.get("min_shed_fraction") is not None:
        sf = summ.get("shed_fraction") or 0.0
        facts["shed_fraction"] = sf
        if sf < expect["min_shed_fraction"]:
            problems.append(
                f"shed fraction {sf} under {expect['min_shed_fraction']}"
                f" — the scripted 2x overload never materialised")
    if expect.get("bitwise") and len(dirs) > 1:
        canon = []
        for rs in recs_per_dir:
            ss = _serve_summaries(rs)
            canon.append(_canonical_summary(ss[-1]) if ss else None)
        if any(c is None for c in canon):
            problems.append("a rerun left no kind=serve summary")
        elif any(c != canon[0] for c in canon[1:]):
            diff = [k for k in canon[0]
                    if any(c.get(k) != canon[0][k] for c in canon[1:])]
            problems.append(
                f"same-seed virtual-clock reruns were NOT bitwise "
                f"identical (diverging keys: {diff})")
        else:
            facts["bitwise_identical_runs"] = len(canon)

    # -- SLO-fail ↔ mid-run-alert parity (rules.SERVE_STATUS_RULES —
    # the same table the report CLI's cross-check reads)
    alerts = _load_jsonl(os.path.join(dirs[0], "alerts.jsonl"))
    fired_rules = {a.get("alert") for a in alerts}
    facts["alert_rules"] = sorted(r for r in fired_rules if r)
    for status_key, rule in rules_lib.SERVE_STATUS_RULES:
        if summ.get(status_key) == "fail" and rule not in fired_rules:
            problems.append(f"at-exit {status_key}=fail had no mid-run "
                            f"{rule!r} alert")
    for gate in expect.get("fail_gates", ()):
        if summ.get(gate) != "fail":
            problems.append(f"expected {gate}=fail, got "
                            f"{summ.get(gate)!r}")
        facts[gate] = summ.get(gate)

    # -- serve_kill: classification, requeue, honest lost accounting,
    # every rid terminal exactly once ACROSS attempts, engine restart
    # within its compiled-program budget
    if "policy" in expect:
        got = (result.get("policy") or {}).get("verdict")
        facts["policy"] = got
        if got != expect["policy"]:
            problems.append(f"policy classified the fault as {got!r}, "
                            f"expected {expect['policy']!r}")
        if not (result.get("policy") or {}).get("requeue"):
            problems.append("policy did not requeue a recoverable "
                            "serve fault")
        resumes = [r for r in recs if r.get("kind") == "serve_resume"]
        res = resumes[-1] if resumes else None
        if res is None:
            problems.append("no kind=serve_resume record from the "
                            "requeued attempt")
        else:
            facts["resume"] = {k: res.get(k) for k in
                               ("completed_prior", "lost", "replayed")}
            if (res.get("lost") or 0) < expect.get("min_lost", 1):
                problems.append(
                    f"resume classified {res.get('lost')} in-flight "
                    f"slot(s) as lost, expected >= "
                    f"{expect.get('min_lost', 1)}")
            if summ.get("completed") != res.get("replayed"):
                problems.append(
                    f"resumed attempt completed {summ.get('completed')}"
                    f" of its {res.get('replayed')} replayed requests")
        term = _terminal_events(recs)
        doubles = {r: evs for r, evs in term.items() if len(evs) > 1}
        if doubles:
            problems.append(f"rid(s) with more than one terminal "
                            f"outcome across attempts: {doubles}")
        total = summ.get("requests", 0) + (res or {}).get(
            "completed_prior", 0) + (res or {}).get("lost", 0)
        if total and len(term) != total:
            problems.append(
                f"{len(term)} rid(s) ended terminal across attempts, "
                f"expected every one of {total}")
        facts["terminal_rids"] = len(term)
        if summaries and (summ.get("prefill_compiles"),
                          summ.get("decode_compiles")) != (
                1, len(summ.get("decode_k_ladder") or [1])):
            problems.append(
                f"restarted engine compiled "
                f"{summ.get('prefill_compiles')} prefill / "
                f"{summ.get('decode_compiles')} decode program(s) — "
                f"past its warmup budget")
        attempts = _load_jsonl(os.path.join(
            dirs[0], goodput_mod.ATTEMPTS_NAME))
        facts["attempts"] = [(a.get("attempt"), a.get("rc"),
                              a.get("verdict")) for a in attempts]
        if [a.get("verdict") for a in attempts] != \
                [expect["policy"], "success"]:
            problems.append(f"attempts.jsonl verdicts "
                            f"{facts['attempts']} != "
                            f"[{expect['policy']}, success]")

    # -- request_garbage: every malformed request rejected, with seeded
    # variety in the reasons; the engine survived (rc 0, all valid
    # requests completed)
    if "rejected" in expect:
        rej = [r for r in recs if r.get("kind") == "serve_request"
               and r.get("event") == res_lib.REJECTED]
        reasons = {r.get("reason") for r in rej}
        facts["rejected"] = {"n": len(rej),
                             "reasons": sorted(r for r in reasons if r)}
        if len(rej) != expect["rejected"]:
            problems.append(f"{len(rej)} garbage request(s) rejected, "
                            f"expected {expect['rejected']}")
        if len(reasons) < expect.get("reject_reasons_min", 1):
            problems.append(f"rejection reasons {sorted(reasons)} show "
                            f"no seeded variety")
        if summaries and summ.get("completed") != (
                summ.get("requests", 0) - expect["rejected"]):
            problems.append(
                f"completed {summ.get('completed')} != the "
                f"{summ.get('requests', 0) - expect['rejected']} "
                f"well-formed requests — garbage cost the engine more "
                f"than its own rejection")

    # -- serve_slow: the stall is visible in the deterministic ITL
    if expect.get("itl_inflated") and summaries:
        facts["itl_p99_s"] = summ.get("itl_p99_s")
        # the un-stalled virtual per-token cost is decode_s / k = 1 ms;
        # four stalled dispatches must push the p99 above it
        if not summ.get("itl_p99_s") or summ["itl_p99_s"] <= 0.001:
            problems.append(
                f"serve_slow stall invisible in itl_p99 "
                f"{summ.get('itl_p99_s')} (expected > the 0.001s "
                f"un-stalled virtual per-token cost)")
        if summ.get("completed") != summ.get("requests"):
            problems.append("a straggler stall must not cost "
                            "completions")

    # -- adapt: the ladder moved under pressure, without a recompile
    if expect.get("adapt_transitions"):
        trans = [r for r in recs if r.get("kind") == "serve_adapt"]
        facts["adapt_transitions"] = [
            (r.get("from_level"), r.get("to_level"), r.get("decode_k"))
            for r in trans]
        if not any(r.get("to_level", 0) > r.get("from_level", 0)
                   for r in trans):
            problems.append("sustained pressure produced no downshift "
                            "transition")
        ladder = summ.get("decode_k_ladder") or []
        if len(ladder) != expect.get("ladder_len", len(ladder)):
            problems.append(f"ladder {ladder} has "
                            f"{len(ladder)} rung(s), expected "
                            f"{expect.get('ladder_len')}")
        if (summ.get("prefill_compiles"),
                summ.get("decode_compiles")) != (1, len(ladder)):
            problems.append(
                f"adapt run compiled {summ.get('prefill_compiles')} "
                f"prefill / {summ.get('decode_compiles')} decode "
                f"program(s), expected (1, {len(ladder)}) — a "
                f"downshift paid a recompile")
        if summ.get("completed") != summ.get("requests"):
            problems.append("degraded service must still complete the "
                            "(uncapped) stream")

    return {"ok": not problems, "problems": problems, "facts": facts}


def verify_matrix(run_dir: str,
                  results: Optional[Dict[str, Any]] = None
                  ) -> Dict[str, Any]:
    """Verify every scenario of a drill run; write
    ``serve_resilience_report.json`` next to the artifacts (the CI
    lane's uploaded acceptance record)."""
    if results is None:
        path = os.path.join(run_dir, RESULTS_NAME)
        try:
            with open(path) as f:
                results = json.load(f)
        except (OSError, ValueError):
            raise FileNotFoundError(
                f"no {RESULTS_NAME} under {run_dir} — run the drill "
                f"first (python -m tpudist_torch.serve.drill drill)")
    scenarios = {name: verify_scenario(run_dir, res)
                 for name, res in results.get("scenarios", {}).items()}
    report = {
        "schema": 1,
        "ok": all(s["ok"] for s in scenarios.values())
        and bool(scenarios),
        "scenarios": scenarios,
    }
    path = os.path.join(run_dir, REPORT_NAME)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(report, f, indent=1)
    os.replace(tmp, path)
    return report


def bench_artifact(report: Dict[str, Any]) -> Dict[str, Any]:
    """BENCH_SERVE_RESILIENCE.json on the shared BENCH_* harness shape:
    headline = resilience scenarios ending green, detail = the full
    report (the JAX package's shape, so its consumers read it)."""
    sc = report.get("scenarios", {})
    return {
        "metric": "serve_resilience_scenarios_green",
        "value": sum(1 for s in sc.values() if s.get("ok")),
        "unit": f"resilience scenarios ending green of {len(sc)} "
                f"drilled",
        "detail": report,
    }


def run_and_verify(run_dir: Optional[str] = None, *,
                   scenarios=None, world: int = 1) -> Dict[str, Any]:
    """The whole acceptance sequence in one call — drill the matrix,
    replay the invariants, persist the report — the CLI's ``drill``.
    ``run_dir`` defaults to ``$TPUDIST_SERVE_DRILL_DIR``, else a temp
    dir."""
    import tempfile

    if run_dir is None:
        run_dir = os.environ.get("TPUDIST_SERVE_DRILL_DIR") \
            or tempfile.mkdtemp(prefix="tpudist_serve_drill_")
    results = run_matrix(run_dir, scenarios=scenarios, world=world)
    report = verify_matrix(run_dir, results)
    report["run_dir"] = run_dir
    return report


def _summarise(report: Dict[str, Any]) -> None:
    for name, sc in sorted(report.get("scenarios", {}).items()):
        status = "green" if sc.get("ok") else "RED"
        print(f"tpudist: serve drill {name}: {status}"
              + ("" if sc.get("ok")
                 else " — " + "; ".join(sc.get("problems", []))))
    print(f"tpudist: serve resilience matrix "
          f"{'green' if report.get('ok') else 'RED'} "
          f"({len(report.get('scenarios', {}))} scenarios)")


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m tpudist_torch.serve.drill",
        description="serve resilience drills (overload + serve fault "
                    "matrix) + the invariant checker, over the port's "
                    "serve CLI")
    sub = p.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("drill", help="run the matrix then verify")
    d.add_argument("--run-dir", type=str, required=True)
    d.add_argument("--scenario", action="append", default=None,
                   choices=sorted(SCENARIOS),
                   help="drill only these scenarios (repeatable; "
                        "default: all)")
    d.add_argument("--bench-out", type=str, default=None,
                   help="also write BENCH_SERVE_RESILIENCE.json")
    d.add_argument("--world", type=int, default=1,
                   help="serve CLI processes an attempt (one serve mesh; "
                        "default 1)")
    v = sub.add_parser("verify", help="re-check an existing drill dir")
    v.add_argument("--run-dir", type=str, required=True)
    args = p.parse_args(argv)

    if args.cmd == "drill":
        report = run_and_verify(args.run_dir, scenarios=args.scenario,
                                world=args.world)
        if args.bench_out:
            tmp = f"{args.bench_out}.tmp"
            os.makedirs(os.path.dirname(args.bench_out) or ".",
                        exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(bench_artifact(report), f, indent=1)
            os.replace(tmp, args.bench_out)
    else:
        try:
            report = verify_matrix(args.run_dir)
        except FileNotFoundError as e:
            print(f"tpudist_torch.serve.drill: {e}", file=sys.stderr)
            return 2
    _summarise(report)
    return 0 if report.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())
