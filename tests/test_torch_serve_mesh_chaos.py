"""The serve CLI's operations on a serve mesh of two gloo ranks, part 2:
serve chaos's kill, the requeued attempt and the serve drill at
``world`` 2 (``tpudist_torch/serve/cli.py``,
``tpudist_torch/serve/engine.py``'s lost-leader exit,
``tpudist_torch/serve/drill.py``). Part 1 is
``tests/test_torch_serve_mesh_ops.py``.

* ``serve_kill``: rank 0 exits 137 with its flushed ``kind=chaos``
  record and no summary; the follower leaves non-zero within 60 s,
  naming its lost leader, with a ``fail`` worker verdict.
* The requeued attempt on two ranks: its lost rids are exactly attempt
  0's admitted rids without a terminal event, and every rid lands in one
  terminal bucket across the attempts.
* The drill's ``serve_kill`` scenario at ``world=2`` is graded ``ok`` by
  the port's verifier and the JAX package's.
"""

import os
from pathlib import Path
from unittest import mock

import pytest
import torch

from _torch_ranks import serve_cli, serve_records
from tpudist.serve import drill as jdrill
from tpudist_torch.serve import drill as tdrill
from tpudist_torch.serve import resilience as res_lib

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
ARGV = ["--requests", "8", "--max-new-tokens", "8", "--slots", "4",
        "--decode-steps-per-dispatch", "2", "--kv-page-tokens", "8"]
KILL_BOUND_S = 60


@pytest.fixture(scope="module")
def killed(tmp_path_factory):
    """Attempt 0 killed at dispatch 3 on two ranks, then attempt 1 on two
    ranks in the same save dir: (save, attempt 0's and 1's (exit codes,
    outputs, wall), attempt 0's records read before attempt 1 ran)."""
    save = tmp_path_factory.mktemp("killed")
    first = serve_cli(save, 2, ARGV + ["--chaos", "serve_kill@0:3",
                                       "--requeue-attempt", "0"])
    before = serve_records(save, "serve_request")
    verdicts = [open(save / f"verdict.txt.worker{r}").read()
                if (save / f"verdict.txt.worker{r}").exists() else None
                for r in range(2)]
    second = serve_cli(save, 2, ARGV + ["--requeue-attempt", "1"])
    return save, first, second, before, verdicts


def test_serve_kill_ends_every_rank_in_bounded_time(killed):
    save, (rcs, outs, wall), _, before, verdicts = killed
    assert rcs[0] == 137 and rcs[1] != 0, outs
    assert wall < KILL_BOUND_S
    assert "chaos fired: serve_kill" in outs[0]
    assert "lost its leader (rank 0)" in outs[1]
    assert verdicts[1] == "fail"
    recs = [r for r in serve_records(save, "serve")
            if r.get("requeue_attempt") == 0]
    assert recs == []              # a kill writes no summary
    assert [r["fault"] for r in serve_records(save, "chaos")] \
        == ["serve_kill"]


def test_requeued_attempt_lost_bucket_is_exact(killed):
    save, _, (rcs, outs, _), before, _ = killed
    assert rcs == [0, 0], outs
    admitted = {r["rid"] for r in before if r["event"] == res_lib.ADMITTED}
    done = {r["rid"] for r in before
            if r["event"] in res_lib.TERMINAL_EVENTS}
    assert admitted - done          # the kill took in-flight slots
    events = serve_records(save, "serve_request")
    lost = {r["rid"] for r in events[len(before):]
            if r["event"] == res_lib.LOST}
    assert lost == admitted - done
    terminal = {}
    for r in events:
        if r["event"] in res_lib.TERMINAL_EVENTS:
            terminal.setdefault(r["rid"], []).append(r["event"])
    assert sorted(terminal) == list(range(8))
    assert all(len(evs) == 1 for evs in terminal.values()), terminal
    resume, = serve_records(save, "serve_resume")
    serve, = serve_records(save, "serve")
    assert (resume["lost"], resume["completed_prior"]) \
        == (len(lost), len(done))
    assert serve["completed"] == resume["replayed"] \
        == 8 - len(lost) - len(done)
    assert serve["n_chips"] == 2


def test_drill_serve_kill_at_world_two_is_ok(tmp_path):
    env = {"PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    with mock.patch.dict(os.environ, env):
        result = tdrill.run_scenario(str(tmp_path), "serve_kill", world=2)
    assert result["rcs"] == [137, 0] and result["world"] == 2
    assert result["follower_rcs"][0][0] != 0
    assert result["follower_rcs"][1] == [0]
    for verify in (tdrill.verify_scenario, jdrill.verify_scenario):
        report = verify(str(tmp_path), result)
        assert report["ok"], report["problems"]
    assert (tmp_path / "serve_kill" / "attempt0.log.rank1").is_file()
