"""The port's chaos drill, part 2: the checkpoint-path families
``torn_manifest`` and ``fs_error`` and the two families that run the
train CLI's live telemetry bus (``hang``: the watchdog's stall dump and
the mid-run ``stall`` alert; ``telemetry_garbage``: garbage frames on the
socket, ``bad_frames``), through ``run_matrix`` and both verifiers. Part
1 is ``tests/test_torch_chaos_drill.py``.
"""

import json
import os
from pathlib import Path
from unittest import mock

import pytest
import torch

from tpudist.chaos import verify as jverify
from tpudist_torch.chaos import drill as tdrill
from tpudist_torch.chaos import verify as tverify

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
FAMILIES = ("torn_manifest", "fs_error", "hang", "telemetry_garbage")


@pytest.fixture(scope="module")
def drilled(tmp_path_factory):
    run_dir = tmp_path_factory.mktemp("chaos")
    with mock.patch.dict(os.environ, {"PYTHONPATH": str(REPO)}):
        results = tdrill.run_matrix(str(run_dir), families=FAMILIES)
    return run_dir, results


def test_torn_manifest_resumes_from_the_previous_commit(drilled):
    run_dir, results = drilled
    res = results["families"]["torn_manifest"]
    mine = tverify.verify_family(str(run_dir), res)
    assert mine == jverify.verify_family(str(run_dir), res)
    assert mine["ok"], mine["problems"]
    assert mine["facts"]["rcs"] == [113, 0]
    assert mine["facts"]["policy"] == "preemption"
    assert (mine["facts"]["resume"]["resumed_from_step"],
            mine["facts"]["resume"]["steps_lost"]) == (3, 3)
    assert mine["facts"]["final_step"] == 8


def test_fs_error_retries_then_skips_one_commit(drilled):
    run_dir, results = drilled
    res = results["families"]["fs_error"]
    mine = tverify.verify_family(str(run_dir), res)
    assert mine == jverify.verify_family(str(run_dir), res)
    assert mine["ok"], mine["problems"]
    ckpt = mine["facts"]["ckpt"]
    assert ckpt["write_skips"] == 1 and ckpt["write_retries"] >= 2
    steps = run_dir / "fs_error" / "elastic" / "steps"
    assert sorted(p.name for p in steps.iterdir()
                  if (p / "manifest.json").exists()) == [
        "00000003", "00000008"]


def test_both_verify_matrices_green(drilled):
    run_dir, results = drilled
    mine = tverify.verify_matrix(str(run_dir), results)
    theirs = jverify.verify_matrix(str(run_dir))
    assert mine["ok"] and theirs["ok"]
    assert mine["families"] == theirs["families"]
    assert sorted(results["families"]) == sorted(FAMILIES)
    assert "not_drilled" not in results


# the live families' facts, as the JAX drill pins them
# (tpudist/chaos/drill.py:61-70,94-99)
LIVE_FACTS = {
    "hang": {"rcs": [137, 0], "policy": "stall", "fired": ["hang"],
             "final_step": 8, "resume": (3, 2), "lost": 2},
    "telemetry_garbage": {"rcs": [0], "fired": ["telemetry_garbage"],
                          "final_step": 8, "lost": 0},
}


@pytest.mark.parametrize("family", ["hang", "telemetry_garbage"])
def test_live_bus_families_are_refused_naming_11b(family, drilled):
    """The two families that need the live bus, refused until the port
    carried it, drill: ``hang`` wedges at step 5 under a 0.5 s watchdog,
    whose stall dump reaches the aggregator as a mid-run ``stall`` alert
    (``alerts.jsonl``) before the SIGKILL code; the policy reads STALL
    and the resume comes back from step 3, losing 2. ``telemetry_garbage``
    puts seeded garbage on the socket at step 4: the decoder
    resynchronises (``bad_frames`` >= 1) and ingests to step 8, ending
    ``status: ok``. Both verifiers agree."""
    run_dir, results = drilled
    res = results["families"][family]
    mine = tverify.verify_family(str(run_dir), res)
    assert mine == jverify.verify_family(str(run_dir), res)
    assert mine["ok"], mine["problems"]
    facts, want = mine["facts"], LIVE_FACTS[family]
    assert (facts["rcs"], facts.get("policy"), facts["fired"],
            facts["final_step"], facts["goodput"]["lost_steps"]) == (
        want["rcs"], want.get("policy"), want["fired"],
        want["final_step"], want["lost"])
    status = json.loads((run_dir / family / "live_status.json").read_text())
    if family == "hang":
        assert (facts["resume"]["resumed_from_step"],
                facts["resume"]["steps_lost"]) == want["resume"]
        assert "stall" in facts["alert_rules"]
        flight = json.loads((run_dir / family / "flightrec.worker0"
                             ).read_text())
        assert flight["reason"] == "stall"
    else:
        assert facts["bad_frames"] >= 1
        assert status["status"] == "ok" and status["pod"]["step"] == 8
