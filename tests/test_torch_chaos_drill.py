"""The port's chaos drill (``python -m tpudist_torch.chaos``), part 1:
the baseline and the ``kill``, ``slow`` and ``corrupt_shard`` families
through the CLI.

The drill runs the port's train CLI in subprocesses on the CPU
(``TPUDIST_PLATFORM=cpu``, as it sets it) under each family's seeded
schedule, replays the launcher's policy → backoff → ``--resume auto``
loop, and verifies: every family green, with the facts the JAX drill
pins (rcs, policy, the resume step, the steps lost, the fallback, the
final step), and the JAX package's own verifier (stdlib only) agrees on
the same directory, fact for fact. A negative case alters a family's
final shard crc in a copy, and both verifiers name the divergence. Part
2 (``tests/test_torch_chaos_drill_faults.py``) drills ``torn_manifest``
and ``fs_error`` and the refusal of the two live-bus families.
"""

import json
import os
import shutil
from pathlib import Path
from unittest import mock

import pytest
import torch

from tpudist.chaos import verify as jverify
from tpudist_torch.chaos import __main__ as tcli
from tpudist_torch.chaos import verify as tverify

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
FAMILIES = ("kill", "slow", "corrupt_shard")
FACTS = {
    "kill": {"rcs": [113, 0], "policy": "preemption", "final_step": 8,
             "resume": {"resumed_from_step": 3, "steps_lost": 2,
                        "fallback_from": None}},
    "slow": {"rcs": [0], "final_step": 8},
    "corrupt_shard": {"rcs": [113, 0], "policy": "preemption",
                      "final_step": 8,
                      "resume": {"resumed_from_step": 3, "steps_lost": 4,
                                 "fallback_from": 6}},
}


@pytest.fixture(scope="module")
def drilled(tmp_path_factory):
    """``python -m tpudist_torch.chaos drill`` over this file's families,
    once: (run dir, exit code, report)."""
    run_dir = tmp_path_factory.mktemp("chaos")
    argv = ["drill", "--run-dir", str(run_dir),
            "--bench-out", str(run_dir / "BENCH_CHAOS.json")]
    for f in FAMILIES:
        argv += ["--family", f]
    with mock.patch.dict(os.environ, {"PYTHONPATH": str(REPO)}):
        rc = tcli.main(argv)
    report = json.loads((run_dir / tverify.REPORT_NAME).read_text())
    return run_dir, rc, report


def test_cli_drill_is_green(drilled, capsys):
    run_dir, rc, report = drilled
    assert rc == 0 and report["ok"] and report["baseline_step"] == 8
    assert sorted(report["families"]) == sorted(FAMILIES)
    assert sorted(report["not_drilled"]) == [
        "fs_error", "hang", "telemetry_garbage", "torn_manifest"]
    assert "11b" in report["not_drilled"]["hang"]
    bench = json.loads((run_dir / "BENCH_CHAOS.json").read_text())
    assert (bench["metric"], bench["value"]) == ("chaos_families_green", 3)
    assert tcli.main(["verify", "--run-dir", str(run_dir)]) == 0
    out = capsys.readouterr().out
    assert "tpudist: chaos matrix green (3 families)" in out
    assert "tpudist: chaos hang: not drilled" in out


@pytest.mark.parametrize("family", FAMILIES)
def test_family_facts_and_the_jax_verifier_agree(drilled, family):
    run_dir, _, report = drilled
    results = json.loads((run_dir / "chaos_results.json").read_text())
    res = results["families"][family]
    mine = tverify.verify_family(str(run_dir), res)
    theirs = jverify.verify_family(str(run_dir), res)
    assert mine == theirs == report["families"][family]
    assert mine["ok"], mine["problems"]
    facts = mine["facts"]
    for key, want in FACTS[family].items():
        if key == "resume":
            for k, v in want.items():
                assert facts["resume"][k] == v, (family, k)
            assert facts["resume"]["source"] == "manifest"
        else:
            assert facts[key] == want, (family, key)
    assert facts["goodput"]["exact"]
    assert facts["goodput"]["lost_steps"] == FACTS[family].get(
        "resume", {}).get("steps_lost", 0)


def test_the_jax_verify_matrix_reads_the_ports_drill(drilled, tmp_path):
    run_dir, _, report = drilled
    copy = tmp_path / "copy"
    shutil.copytree(run_dir, copy)
    theirs = jverify.verify_matrix(str(copy))
    assert theirs["ok"] and theirs["families"] == report["families"]


def test_a_diverged_final_state_both_verifiers_name_it(drilled, tmp_path):
    run_dir, _, _ = drilled
    copy = tmp_path / "copy"
    shutil.copytree(run_dir, copy)
    man = json.loads((copy / "kill" / "elastic" /
                      "manifest.json").read_text())
    ipath = copy / "kill" / "elastic" / man["dir"] / "worker0.json"
    idx = json.loads(ipath.read_text())
    sh = idx["leaves"]["params.fc1.w"]["shards"][0]
    sh["crc32"] = (sh["crc32"] + 1) & 0xFFFFFFFF
    ipath.write_text(json.dumps(idx))
    results = json.loads((copy / "chaos_results.json").read_text())
    for verify in (tverify, jverify):
        got = verify.verify_family(str(copy), results["families"]["kill"])
        assert not got["ok"]
        assert any("NOT bitwise-identical to the baseline" in p
                   for p in got["problems"]), got["problems"]
