"""The port's context parallelism through the train CLI: ``python -m
tpudist_torch.train --context 2`` at two gloo processes, with the ring
(zigzag) and with Ulysses, against one process and against the JAX CLI
at ``--context 2`` (eight virtual CPU devices: data 4 x context 2), on
the JAX package's permutations and init (the token data is numpy on both
sides), through ``tpudist_torch/data.py``'s hooks.

* Each step's loss and the epoch's Avg and eval loss within rtol 2e-3 /
  atol 2e-4 (``tests/test_torch_fsdp_train.py``'s tolerance) of one
  process's and of the JAX CLI's; the contract on rank 0, every verdict
  ``success``, the mesh and the rotations in the log.
* The superstep (k = 2) at ``--context 2`` bitwise its per-step run.
* The ``--context 2`` runs' checkpoints (the default layout, and the
  sharded manifest of the superstep's run) resumed at one process and at
  ``--fsdp 2``: the second epoch's losses within the tolerance of one
  process's uninterrupted two epochs.
"""

import os
import re
import shutil

import numpy as np
import pytest
import torch

from _torch_ranks import jax_cli_reference, launch_cli, records, verdicts
from tpudist import train as jtrain

torch.set_num_threads(1)

RTOL, ATOL = 2e-3, 2e-4
CONTRACT = re.compile(r"^(Epoch +\d+ (finished\. Avg|eval) loss: .*"
                      r"|Training completed\.)$", re.M)

TF = ["--model", "transformer", "--seq-len", "16", "--d-model", "32",
      "--n-layers", "2", "--n-heads", "4", "--n-kv-heads", "2", "--d-ff",
      "64", "--vocab-size", "96", "--lm-head", "plain", "--n-samples",
      "32", "--train-batch-size", "8", "--log-every", "2", "--seed", "3",
      "--lr", "1e-2"]
PER_STEP = ["--steps-per-dispatch", "1"]
C2 = ["--context", "2"]
ULY = ["--cp-impl", "ulysses"]
IMPLS = {"ring": [], "uly": ULY}


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Every CLI run of this file: the first epochs together, the JAX
    CLI at ``--context 2`` (both impls) in this process meanwhile, then
    the two resumes of the ``--context 2`` runs' checkpoints."""
    root = tmp_path_factory.mktemp("context_cli")
    ref = str(root / "tf_ref.npz")
    jax_cli_reference(ref, TF + ["--epochs", "2"])
    one_epoch = TF + ["--epochs", "1"]
    runs = {
        "tf1": (TF + ["--epochs", "2"] + PER_STEP, 1),
        "tf_c2_ring": (one_epoch + PER_STEP + C2, 2),
        "tf_c2_uly": (one_epoch + PER_STEP + C2 + ULY, 2),
        # the sharded manifest layout: res_f2 resumes from it
        "tf_c2_k2": (one_epoch + ["--steps-per-dispatch", "2",
                                  "--ckpt-mode", "sharded"] + C2, 2),
    }
    waits = {tag: launch_cli(str(root / tag), argv, n, ref)
             for tag, (argv, n) in runs.items()}
    for impl, extra in IMPLS.items():
        assert jtrain.main(one_epoch + PER_STEP + C2 + extra + [
            "--save-dir", str(root / f"jax_{impl}" / "ck")]) == 0
    done = {tag: wait() for tag, wait in waits.items()}
    for tag, (rcs, outs) in done.items():
        assert rcs == [0] * runs[tag][1], (tag, outs)
    resumes = {"res1": (TF + ["--epochs", "2", "--resume"] + PER_STEP, 1),
               "res_f2": (TF + ["--epochs", "2", "--resume", "--fsdp",
                                "2"] + PER_STEP, 2)}
    for tag, src in (("res1", "tf_c2_ring"), ("res_f2", "tf_c2_k2")):
        shutil.copytree(root / src / "ck", root / tag / "ck")
    waits = {tag: launch_cli(str(root / tag), argv, n, ref)
             for tag, (argv, n) in resumes.items()}
    for tag, wait in waits.items():
        done[tag] = wait()
        assert done[tag][0] == [0] * resumes[tag][1], (tag, done[tag][1])
    return root, done


def _epoch(root, tag, epoch=0):
    (rec,) = [r for r in records(str(root / tag), "epoch")
              if r["epoch"] == epoch]
    return rec


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("impl", list(IMPLS))
def test_context2_cli_matches_one_process_and_jax(cli_runs, impl):
    root, done = cli_runs
    tag = f"tf_c2_{impl}"
    c2, one = (records(str(root / d), "step") for d in (tag, "tf1"))
    assert len(c2) == 2
    _close([r["loss"] for r in c2], [r["loss"] for r in one[:2]])
    got = _epoch(root, tag)
    for want in (_epoch(root, "tf1"), _epoch(root, f"jax_{impl}")):
        _close([got["avg_loss"], got["eval_loss"]],
               [want["avg_loss"], want["eval_loss"]])
    outs = done[tag][1]
    assert len(CONTRACT.findall(outs[0])) == 3
    assert outs[0].rstrip().endswith("Training completed.")
    assert "Epoch" not in outs[1]
    assert "2 process(es) (gloo)" in outs[0]
    name = "ring" if impl == "ring" else "ulysses"
    assert f"mesh data 1 x fsdp 1 x context 2 ({name})" in outs[0]
    # the step's collectives name the ring's rotations (k and v of a
    # layer's hop, forward and backward: a rank's (8, 8, 2, 8) f32 block)
    # or Ulysses's all-to-alls (q and o, then k and v, of a layer, forward
    # and backward)
    (line,) = [ln for ln in outs[0].splitlines()
               if ln.startswith("tpudist: collectives")]
    if impl == "ring":
        assert "; collective_permute f32 4096 B x 8" in line
    else:
        assert "; all_to_all f32 8192 B x 8" in line
        assert "; all_to_all f32 4096 B x 8" in line
    assert verdicts(str(root / tag), 2) == ("success", ["success"] * 2)


def test_context2_superstep_is_bitwise_its_per_step_run(cli_runs):
    root, done = cli_runs
    per, sup = (records(str(root / d), "step") for d in ("tf_c2_ring",
                                                          "tf_c2_k2"))
    assert len(per) == len(sup) == 2
    assert [(r["step"], r["loss"]) for r in sup] == [
        (r["step"], r["loss"]) for r in per]
    a, b = _epoch(root, "tf_c2_ring"), _epoch(root, "tf_c2_k2")
    assert (a["avg_loss"], a["eval_loss"]) == (b["avg_loss"],
                                               b["eval_loss"])
    assert "superstep dispatch k=2" in done["tf_c2_k2"][1][0]
    assert verdicts(str(root / "tf_c2_k2"), 2) == ("success",
                                                   ["success"] * 2)


@pytest.mark.parametrize("tag,n", [("res1", 1), ("res_f2", 2)])
def test_context2_checkpoint_resumes_at_one_process_and_at_fsdp2(
        cli_runs, tag, n):
    """The ``--context 2`` runs wrote their whole params once (no spec
    splits over ``context``: the lowest rank writes each), in the step
    directories and in the sharded manifest; one process and fsdp 2
    assemble their own regions from them and train the second epoch as
    one process's uninterrupted run does."""
    root, done = cli_runs
    outs = done[tag][1]
    assert "Epoch  2 finished" in outs[0]
    assert "Epoch  1 finished" not in outs[0]
    got, want = _epoch(root, tag, 1), _epoch(root, "tf1", 1)
    _close([got["avg_loss"], got["eval_loss"]],
           [want["avg_loss"], want["eval_loss"]])
    assert verdicts(str(root / tag), n)[0] == "success"
    assert os.path.isdir(root / tag / "ck")
