"""The train CLI's elastic resume, in subprocesses (a scripted
``os._exit`` cannot run in the pytest process).

For the MLP (here) and a narrow transformer with a bf16 second moment
(``tests/test_torch_train_resume_tf.py``): an uninterrupted run with
asynchronous sharded saves; per-step and at ``--steps-per-dispatch 2``,
a run killed by ``TPUDIST_TEST_KILL=0:5`` (rc 113, after one beacon);
its ``--resume auto --requeue-attempt 1`` rerun, which must
come back from the newest committed step and end with a committed crc
signature (``tpudist_torch.chaos.verify.crc_signature``) equal to the
uninterrupted run's: the bitwise-resume pin. ``kind=resume`` carries
``steps_lost`` 2 and ``source``; ``kind=resume``, ``kind=ckpt_drain`` and
``kind=goodput`` carry every field name the JAX train CLI logs for them
(read from ``tpudist/train.py``'s ``metrics.log`` calls). A flipped shard
of the newest commit makes the rerun fall back to the previous one and
say so.
"""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from tpudist_torch.chaos import verify as tverify
from tpudist_torch.elastic import ckpt as eck

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--epochs", "1", "--log-every", "2", "--lr", "1e-2", "--seed", "3",
        "--ckpt-mode", "sharded", "--device", "cpu"]
MODELS = {
    "mlp": ["--train-batch-size", "8", "--n-samples", "64"],
    "tiny_tf": ["--model", "transformer", "--vocab-size", "128",
                "--n-layers", "1", "--d-model", "128", "--n-heads", "1",
                "--d-ff", "128", "--seq-len", "128", "--n-samples", "32",
                "--train-batch-size", "4", "--adam-nu-dtype", "bfloat16"],
}
# per-step: saves at 3 and 6, the kill at 5 -> back from 3; k = 2: saves
# at 4, the kill at the superstep edge 6 -> back from 4. 2 steps lost.
DISPATCH = {"per_step": (["--ckpt-every-steps", "3",
                          "--steps-per-dispatch", "1"], 3),
            "k2": (["--ckpt-every-steps", "4", "--steps-per-dispatch",
                    "2"], 4)}


def _cli(save, argv, env=None):
    proc = subprocess.run(
        [sys.executable, "-m", "tpudist_torch.train", *argv,
         "--save-dir", str(save)], cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1", **(env or {})),
        capture_output=True, text=True, timeout=300)
    return proc.returncode, proc.stdout + proc.stderr


def _recs(save):
    return [json.loads(ln) for ln in open(os.path.join(save,
                                                       "metrics.jsonl"))]


def _jax_fields(kind):
    """The keyword names of the JAX train CLI's ``metrics.log(kind=...)``
    calls for ``kind``."""
    tree = ast.parse(open(os.path.join(REPO, "tpudist", "train.py")).read())
    names = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "log" and any(k.arg == "kind" and isinstance(
                    k.value, ast.Constant) and k.value.value == kind
                    for k in node.keywords)):
            names |= {k.arg for k in node.keywords if k.arg}
    assert names, kind
    return names


def whole_run(tmp_path_factory, model):
    """``model``'s uninterrupted run (asynchronous saves, per-step): its
    final committed crc signature, which no dispatch or checkpoint
    cadence may change."""
    save = tmp_path_factory.mktemp(f"{model}_whole")
    rc, log = _cli(save, BASE + MODELS[model] + DISPATCH["per_step"][0])
    assert rc == 0, log
    return tverify.crc_signature(str(save))


def killed_and_resumed(tmp_path_factory, model, dispatch, whole):
    """``model`` killed at step 5 under ``dispatch``, then resumed:
    (its directory, the committed step, the rerun's output, ``whole``)."""
    flags, committed = DISPATCH[dispatch]
    argv = BASE + MODELS[model] + flags + ["--ckpt-sync"]
    root = tmp_path_factory.mktemp(f"{model}_{dispatch}")
    rc, out = _cli(root / "killed", argv, {"TPUDIST_TEST_KILL": "0:5"})
    assert rc == 113, out
    assert "TEST KILL (preemption drill) at epoch 0" in out
    rc, out = _cli(root / "killed", argv + [
        "--resume", "auto", "--requeue-attempt", "1"])
    assert rc == 0, out
    return root, committed, out, whole


@pytest.fixture(scope="module")
def whole(tmp_path_factory):
    return whole_run(tmp_path_factory, "mlp")


@pytest.fixture(scope="module", params=list(DISPATCH))
def drill(request, tmp_path_factory, whole):
    return killed_and_resumed(tmp_path_factory, "mlp", request.param,
                              whole)


def check_bitwise(drill):
    root, committed, out, whole = drill
    assert f"Resumed at epoch 0, step {committed} (global step " \
        f"{committed})." in out
    assert "tpudist: resume success (manifest): from step " \
        f"{committed}, ~2 step(s) lost, requeue attempt 1" in out
    resumed = tverify.crc_signature(str(root / "killed"))
    assert whole is not None and whole["step"] == 8
    assert resumed == whole


def check_records(drill):
    root, committed, _, _ = drill
    recs = _recs(root / "killed")
    (res,) = [r for r in recs if r["kind"] == "resume"]
    assert (res["status"], res["source"], res["steps_lost"],
            res["resumed_from_step"], res["requeue_attempt"]) == (
        "success", "manifest", 2, committed, 1)
    assert res["fallback_from"] is None
    for kind in ("resume", "ckpt_drain", "goodput"):
        got = [r for r in recs if r["kind"] == kind
               and r["requeue_attempt"] == 1]
        assert len(got) == 1, kind
        if kind == "goodput":
            want = {"fraction", "status", "wall_s", "requeue_attempt",
                    "rewarmup_s", "staging_exposed_s", "productive_s",
                    "ckpt_s", "eval_s"}
        else:
            want = _jax_fields(kind) - {"kind"}
        assert want <= set(got[0]), (kind, want - set(got[0]))
    (drain,) = [r for r in recs if r["kind"] == "ckpt_drain"]
    assert drain["write_errors"] == drain["write_skips"] == 0
    assert drain["saves"] == (2 if committed == 3 else 1)


def test_killed_run_resumes_bitwise(drill):
    check_bitwise(drill)


def test_resume_drain_and_goodput_records(drill):
    check_records(drill)


def test_flipped_newest_shard_falls_back(tmp_path):
    argv = BASE + MODELS["mlp"] + DISPATCH["per_step"][0] + ["--ckpt-sync"]
    rc, out = _cli(tmp_path, argv,
                   {"TPUDIST_CHAOS": "corrupt_shard@0:6,mode=flip;kill@0:7"})
    assert rc == 113, out
    assert int(eck.latest_manifest(str(tmp_path))["step"]) == 6
    rc, out = _cli(tmp_path, argv + ["--resume", "auto",
                                     "--requeue-attempt", "1"])
    assert rc == 0, out
    assert "tpudist: resume fallback: step 6 checkpoint is corrupt" in out
    (res,) = [r for r in _recs(tmp_path) if r["kind"] == "resume"]
    assert (res["resumed_from_step"], res["fallback_from"],
            res["steps_lost"]) == (3, 6, 4)
    assert res["corrupt_shard"]
