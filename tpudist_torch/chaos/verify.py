"""The chaos invariant checker: replay a drill's artifacts, assert the contract.

A copy of ``tpudist/chaos/verify.py`` (``tests/test_torch_chaos_train.py``
holds each function to its source, module paths aside). Given a drill
directory (:mod:`tpudist_torch.chaos.drill` layout: a ``baseline/`` run
plus one subdir per fault family, each holding the run's
``metrics.jsonl``, ``attempts.jsonl``, heartbeat beacons and the
committed manifest tree), it re-derives the recovery contract from the
artifacts alone:

  * the scheduled faults actually FIRED (``kind=chaos`` records);
  * the requeue policy classified each fault correctly;
  * resume came back from the newest *committed* step — bitwise on the
    unchanged layout, proven by comparing the final committed manifest's
    shard-index crc32s against the unfaulted baseline's — and the
    corrupted-shard family FELL BACK past its crc-rejected newest
    manifest instead of raising or fresh-starting;
  * the goodput ledger's partition stayed exact and counted exactly the
    steps the kill cost (beacon vs resume point);
  * every at-exit fail verdict had its matching mid-run alert
    (:data:`tpudist_torch.rules.STATUS_RULES`) on the live families.

Standard library only: bitwise parity is checked through the crc32s the
checkpoint writer recorded, never by loading array bytes. The JAX
package's verifier reads a port drill's directory the same way.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

from tpudist_torch import rules as rules_lib
from tpudist_torch.chaos import drill as drill_mod
from tpudist_torch.chaos import plan as plan_mod
from tpudist_torch.obs import goodput as goodput_mod

REPORT_NAME = "chaos_report.json"


def _load_json(path: str) -> Optional[Dict[str, Any]]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def crc_signature(save_dir: str) -> Optional[Dict[str, Any]]:
    """The committed checkpoint's bitwise fingerprint: every leaf's
    ``(shard span, crc32)`` rows from the manifest's worker indexes.
    Two runs whose final states agree byte-for-byte (same mesh, same
    sharding) produce identical signatures — the stdlib-only parity
    check the whole drill plane pins on."""
    man = _load_json(os.path.join(save_dir, "elastic", "manifest.json"))
    if man is None:
        return None
    d = os.path.join(save_dir, "elastic", man["dir"])
    leaves: Dict[str, List] = {}
    for i in range(int(man.get("process_count", 1))):
        idx = _load_json(os.path.join(d, f"worker{i}.json"))
        if idx is None:
            return None
        for name, rec in idx.get("leaves", {}).items():
            rows = leaves.setdefault(name, [])
            for sh in rec.get("shards", []):
                rows.append([list(sh.get("start", [])),
                             sh.get("crc32")])
    return {"step": int(man["step"]),
            "leaves": {k: sorted(v) for k, v in leaves.items()}}


def _avg_loss_lines(log_path: str) -> List[str]:
    try:
        with open(log_path) as f:
            return [ln.strip() for ln in f
                    if "Avg loss:" in ln or "eval loss:" in ln]
    except OSError:
        return []


def verify_family(run_dir: str, result: Dict[str, Any]
                  ) -> Dict[str, Any]:
    """One family's invariants against its artifacts. Returns
    ``{"ok", "problems", "facts"}`` — problems name exactly which leg
    of the contract broke."""
    family = result["family"]
    expect = result.get("expect", {})
    d = os.path.join(run_dir, result.get("dir", family))
    problems: List[str] = []
    facts: Dict[str, Any] = {"rcs": result.get("rcs")}

    recs = goodput_mod.load_jsonl(os.path.join(d, "metrics.jsonl")) \
        if os.path.exists(os.path.join(d, "metrics.jsonl")) else []
    if not recs:
        problems.append("no metrics.jsonl survived the drill")

    # -- the scheduled faults fired (kind=chaos records, flushed
    # BEFORE each fault's effect — a kill must not eat its evidence)
    spec_kinds = {e.kind
                  for e in plan_mod.ChaosPlan.parse(result["spec"]).events}
    fired_kinds = {r.get("fault") for r in recs
                   if r.get("kind") == "chaos"}
    missing = spec_kinds - fired_kinds
    if missing:
        problems.append(f"scheduled fault(s) never fired: "
                        f"{sorted(missing)}")
    facts["fired"] = sorted(k for k in fired_kinds if k)

    # -- exit code + policy classification
    if result.get("rcs") and result["rcs"][0] != expect.get("expect_rc"):
        problems.append(f"attempt 0 exited {result['rcs'][0]}, expected "
                        f"{expect.get('expect_rc')}")
    if "policy" in expect:
        got = (result.get("policy") or {}).get("verdict")
        if got != expect["policy"]:
            problems.append(f"policy classified the fault as {got!r}, "
                            f"expected {expect['policy']!r}")
        if not (result.get("policy") or {}).get("requeue"):
            problems.append("policy did not requeue a recoverable fault")
        facts["policy"] = got

    # -- resume: newest committed step, fallback flags, lost steps
    if "resumed_from" in expect:
        resumes = [r for r in recs if r.get("kind") == "resume"
                   and r.get("requeue_attempt") == 1]
        res = resumes[-1] if resumes else None
        if res is None:
            problems.append("no kind=resume record from the requeued "
                            "attempt")
        else:
            facts["resume"] = {k: res.get(k) for k in
                               ("status", "source", "resumed_from_step",
                                "steps_lost", "fallback_from",
                                "corrupt_shard")}
            if res.get("status") != "success" \
                    or res.get("source") != "manifest":
                problems.append(f"resume was not a manifest success: "
                                f"{facts['resume']}")
            if res.get("resumed_from_step") != expect["resumed_from"]:
                problems.append(
                    f"resumed from step {res.get('resumed_from_step')}, "
                    f"expected the newest committed step "
                    f"{expect['resumed_from']}")
            if res.get("steps_lost") != expect.get("lost"):
                problems.append(
                    f"resume counted {res.get('steps_lost')} lost "
                    f"step(s), expected {expect.get('lost')}")
            want_fb = expect.get("fallback_from")
            if res.get("fallback_from") != want_fb:
                problems.append(
                    f"fallback_from={res.get('fallback_from')!r}, "
                    f"expected {want_fb!r}")
            if want_fb is not None and not res.get("corrupt_shard"):
                problems.append("fallback resume did not name the "
                                "corrupt shard")

    # -- bitwise parity on the unchanged mesh: the final committed
    # state's shard crc32s must equal the unfaulted baseline's
    base_sig = crc_signature(os.path.join(run_dir,
                                          drill_mod.BASELINE_DIR))
    fam_sig = crc_signature(d)
    if base_sig is None:
        problems.append("baseline run left no committed manifest")
    elif fam_sig is None:
        problems.append("family run left no committed manifest")
    else:
        facts["final_step"] = fam_sig["step"]
        if fam_sig != base_sig:
            problems.append(
                f"final committed state (step {fam_sig['step']}) is NOT "
                f"bitwise-identical to the baseline (step "
                f"{base_sig['step']}) — recovery diverged the "
                f"trajectory")

    # -- the goodput partition stayed exact and counted the lost steps
    ledger = goodput_mod.build_from_dir(d)
    if ledger is None:
        problems.append("no attempts.jsonl — the goodput ledger has no "
                        "spine")
    else:
        facts["goodput"] = {"fraction": ledger.get("goodput_fraction"),
                            "lost_steps": ledger.get("lost_steps"),
                            "exact": ledger.get("exact")}
        if not ledger.get("exact"):
            problems.append(f"goodput partition INEXACT: "
                            f"{ledger.get('problems')}")
        want_lost = expect.get("lost", 0)
        if ledger.get("lost_steps") != want_lost:
            problems.append(
                f"ledger counted {ledger.get('lost_steps')} lost "
                f"step(s), expected {want_lost}")
        if "resumed_from" in expect \
                and (ledger.get("totals") or {}).get("off_pod", 0) <= 0:
            problems.append("ledger missed the requeue backoff "
                            "(off_pod bucket empty)")

    # -- fail-verdict ↔ mid-run-alert parity (live families)
    if expect.get("live"):
        alerts = goodput_mod.load_jsonl(os.path.join(
            d, "alerts.jsonl")) if os.path.exists(
            os.path.join(d, "alerts.jsonl")) else []
        fired_rules = {a.get("alert") for a in alerts}
        facts["alert_rules"] = sorted(r for r in fired_rules if r)
        if expect.get("stall_alert") and "stall" not in fired_rules:
            problems.append("the wedged attempt fired NO mid-run "
                            "'stall' alert")
        if any(r.get("kind") == "stall_dump" for r in recs) \
                and "stall" not in fired_rules:
            problems.append("watchdog stall dump recorded but no "
                            "mid-run 'stall' alert fired")
        for t in (r for r in recs if r.get("kind") == "timing"):
            for field, rule in rules_lib.STATUS_RULES:
                if t.get(field) == "fail" and rule not in fired_rules:
                    problems.append(
                        f"at-exit {field}=fail had no mid-run "
                        f"{rule!r} alert")

    # -- transient-fs-error hardening: retries absorbed, exhaustion
    # skipped exactly that step's commit, the writer never wedged
    if "write_retries_min" in expect:
        drains = [r for r in recs if r.get("kind") == "ckpt_drain"]
        drain = drains[-1] if drains else {}
        facts["ckpt"] = {k: drain.get(k) for k in
                         ("write_retries", "write_errors", "write_skips")}
        if (drain.get("write_retries") or 0) \
                < expect["write_retries_min"]:
            problems.append(f"expected >= {expect['write_retries_min']} "
                            f"fs-error retries, saw "
                            f"{drain.get('write_retries')}")
        if (drain.get("write_skips") or 0) != expect.get("write_skips"):
            problems.append(f"expected {expect.get('write_skips')} "
                            f"abandoned save(s), saw "
                            f"{drain.get('write_skips')}")
        for s in expect.get("committed", ()):
            p = os.path.join(d, "elastic", "steps", f"{s:08d}",
                             "manifest.json")
            if not os.path.exists(p):
                problems.append(f"step {s} should have committed but "
                                f"has no per-step manifest")
        for s in expect.get("uncommitted", ()):
            p = os.path.join(d, "elastic", "steps", f"{s:08d}",
                             "manifest.json")
            if os.path.exists(p):
                problems.append(f"step {s}'s commit should have been "
                                f"SKIPPED but a manifest landed")

    # -- decoder resynchronisation: garbage cost frames, not the run
    if expect.get("bad_frames"):
        status = _load_json(os.path.join(d, "live_status.json")) or {}
        counters = status.get("counters") or {}
        facts["bad_frames"] = counters.get("bad_frames")
        if not (counters.get("bad_frames") or 0) > 0:
            problems.append("injected garbage produced no bad_frames — "
                            "the fault never reached the decoder")
        if (status.get("pod") or {}).get("step") != 8:
            problems.append(
                f"aggregator stopped ingesting after the garbage "
                f"(last step {(status.get('pod') or {}).get('step')}, "
                f"expected 8)")
        if status.get("status") != "ok":
            problems.append(f"live status ended "
                            f"{status.get('status')!r}, expected ok")

    # -- a straggler must not change the math: bitwise stdout parity
    if expect.get("loss_parity"):
        base = _avg_loss_lines(os.path.join(
            run_dir, drill_mod.BASELINE_DIR, "baseline.log"))
        fam = _avg_loss_lines(os.path.join(d, "attempt0.log"))
        if not base or base != fam:
            problems.append(f"loss lines diverged from baseline: "
                            f"{fam} vs {base}")

    return {"ok": not problems, "problems": problems, "facts": facts}


def bench_artifact(report: Dict[str, Any]) -> Dict[str, Any]:
    """BENCH_CHAOS.json on the shared BENCH_* harness shape: headline =
    fault families ending green, detail = the full report. The ONE
    shaper behind ``python -m tpudist_torch.chaos``, ``bench.py
    --chaos-drill`` and any future consumer."""
    fams = report.get("families", {})
    return {
        "metric": "chaos_families_green",
        "value": sum(1 for f in fams.values() if f.get("ok")),
        "unit": f"fault families ending green of {len(fams)} drilled",
        "detail": report,
    }


def run_and_verify(run_dir: Optional[str] = None, *,
                   families=None) -> Dict[str, Any]:
    """The whole acceptance sequence in one call — drill the matrix,
    replay the invariants, persist ``chaos_report.json`` — shared by
    the CLI, ``bench.py --chaos-drill`` and ``selfcheck check_chaos``
    so the dir-resolution and orchestration cannot drift. ``run_dir``
    defaults to ``$TPUDIST_CHAOS_DRILL_DIR`` (CI uploads it), else a
    temp dir; the report carries the resolved path as ``run_dir``."""
    import tempfile

    if run_dir is None:
        run_dir = os.environ.get("TPUDIST_CHAOS_DRILL_DIR") \
            or tempfile.mkdtemp(prefix="tpudist_chaos_")
    results = drill_mod.run_matrix(run_dir, families=families)
    report = verify_matrix(run_dir, results)
    report["run_dir"] = run_dir
    return report


def verify_matrix(run_dir: str,
                  results: Optional[Dict[str, Any]] = None
                  ) -> Dict[str, Any]:
    """Verify every family of a drill run; write ``chaos_report.json``
    next to the artifacts (the CI lane's uploaded acceptance record)."""
    if results is None:
        results = _load_json(os.path.join(run_dir,
                                          drill_mod.RESULTS_NAME))
        if results is None:
            raise FileNotFoundError(
                f"no {drill_mod.RESULTS_NAME} under {run_dir} — run the "
                f"drill first (python -m tpudist_torch.chaos drill)")
    families = {name: verify_family(run_dir, res)
                for name, res in results.get("families", {}).items()}
    base_sig = crc_signature(os.path.join(run_dir,
                                          drill_mod.BASELINE_DIR))
    report = {
        "schema": 1,
        "ok": all(f["ok"] for f in families.values()) and bool(families),
        "families": families,
        "baseline_step": base_sig["step"] if base_sig else None,
    }
    path = os.path.join(run_dir, REPORT_NAME)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(report, f, indent=1)
    os.replace(tmp, path)
    return report
