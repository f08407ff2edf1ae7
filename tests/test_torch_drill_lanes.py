"""The drills' families and scenarios side by side (``run_matrix(...,
lanes=N)``, what the selfcheck runs on the card): every family and
scenario green under its verifier, the results in table order."""

import os

import torch

from tpudist_torch.chaos import drill as chaos_drill
from tpudist_torch.chaos import verify as chaos_verify
from tpudist_torch.serve import drill as serve_drill

torch.set_num_threads(1)


def test_serve_scenarios_side_by_side(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUDIST_PLATFORM", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    results = serve_drill.run_matrix(str(tmp_path), lanes=4)
    assert list(results["scenarios"]) == list(serve_drill.SCENARIOS)
    report = serve_drill.verify_matrix(str(tmp_path), results)
    assert report["ok"], {n: s["problems"]
                          for n, s in report["scenarios"].items()}


def test_chaos_families_side_by_side(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUDIST_PLATFORM", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    families = ["kill", "slow", "fs_error"]
    results = chaos_drill.run_matrix(str(tmp_path), families=families,
                                     lanes=3)
    assert list(results["families"]) == families
    report = chaos_verify.verify_matrix(str(tmp_path), results)
    assert report["ok"], {n: f["problems"]
                          for n, f in report["families"].items()}
    assert os.path.exists(tmp_path / chaos_drill.RESULTS_NAME)
