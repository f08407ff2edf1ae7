"""The port's chaos drill, part 2: the checkpoint-path families
``torn_manifest`` and ``fs_error`` through ``run_matrix``, both
verifiers, and the two families that need the live telemetry bus
(``hang``, ``telemetry_garbage``), refused by name until ROADMAP Queue A
item 11b. Part 1 is ``tests/test_torch_chaos_drill.py``.
"""

import json
import os
from pathlib import Path
from unittest import mock

import pytest
import torch

from tpudist.chaos import verify as jverify
from tpudist_torch.chaos import __main__ as tcli
from tpudist_torch.chaos import drill as tdrill
from tpudist_torch.chaos import verify as tverify

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
FAMILIES = ("torn_manifest", "fs_error")


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
    assert sorted(results["not_drilled"]) == [
        "corrupt_shard", "hang", "kill", "slow", "telemetry_garbage"]


@pytest.mark.parametrize("family", ["hang", "telemetry_garbage"])
def test_live_bus_families_are_refused_naming_11b(family, tmp_path,
                                                  capsys):
    with pytest.raises(ValueError, match="ROADMAP Queue A item 11b"):
        tdrill.run_family(str(tmp_path), family)
    with pytest.raises(ValueError, match="ROADMAP Queue A item 11b"):
        tdrill.run_matrix(str(tmp_path / "m"), families=[family])
    assert tcli.main(["drill", "--run-dir", str(tmp_path / "c"),
                      "--family", family]) == 2
    assert "ROADMAP Queue A item 11b" in capsys.readouterr().err
    assert not (tmp_path / "c" / tverify.REPORT_NAME).exists()
    assert family in tdrill.NOT_CARRIED and family not in tdrill.CARRIED
    assert json.dumps(tdrill.NOT_CARRIED)
