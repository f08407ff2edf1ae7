"""The port's expert parallelism through the train CLI: ``python -m
tpudist_torch.train --model moe --expert 2`` at two gloo processes and
``--data 2 --expert 2`` at four, against one process and the JAX CLI at
``--expert 2`` (eight virtual CPU devices: data 4 x expert 2), on the JAX
package's permutations and init (the token data is numpy on both sides),
through ``tpudist_torch/data.py``'s hooks.

* Each step's loss and the epoch's Avg and eval loss within rtol 2e-3 /
  atol 2e-4 (``tests/test_torch_tp_train.py``'s tolerance) of one
  process's and of the JAX CLI's; the contract on rank 0, every verdict
  ``success``, the mesh and the expert shards in the log, a rank's
  params below the whole state's in the memory ledger.
* The superstep (k = 2) at ``--expert 2`` bitwise its per-step run.
* The sharded checkpoint of the ``--data 2 --expert 2`` run (each
  expert shard written once, by its owner) resumed at ``--fsdp 2``: the
  second epoch within the tolerance of one process's uninterrupted two
  epochs.
* ``--lm-head auto`` on an expert mesh picks what the JAX package's
  ``_auto_lm_head`` picks on the same mesh (the expert FFN params a
  device divided by ``expert``), over a sweep of device memories that
  crosses its boundary.
"""

import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

from _torch_ranks import jax_cli_reference, launch_cli, records, verdicts
from tpudist import config as jconfig
from tpudist import engine as jengine
from tpudist import train as jtrain
from tpudist.parallel import build_mesh
from tpudist_torch import config as tconfig
from tpudist_torch import engine as tengine
from tpudist_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

RTOL, ATOL = 2e-3, 2e-4
CONTRACT = re.compile(r"^(Epoch +\d+ (finished\. Avg|eval) loss: .*"
                      r"|Training completed\.)$", re.M)

MOE = ["--model", "moe", "--seq-len", "16", "--d-model", "32",
       "--n-layers", "2", "--n-heads", "4", "--d-ff", "32", "--vocab-size",
       "96", "--n-experts", "4", "--moe-group-size", "64", "--lm-head",
       "plain", "--n-samples", "32", "--train-batch-size", "8",
       "--log-every", "2", "--seed", "3", "--lr", "1e-2"]
PER_STEP = ["--steps-per-dispatch", "1"]
ONE = ["--epochs", "1"]
E2 = ["--expert", "2"]
D2E2 = ["--data", "2", "--expert", "2"]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Every CLI run of this file: the first epochs together, the JAX
    CLI at ``--expert 2`` in this process meanwhile, then the resume of
    the ``--data 2 --expert 2`` run's sharded checkpoint at ``--fsdp
    2``."""
    root = tmp_path_factory.mktemp("expert_cli")
    ref = str(root / "ref.npz")
    jax_cli_reference(ref, MOE + ["--epochs", "2"])
    runs = {
        "one": (MOE + ["--epochs", "2"] + PER_STEP, 1),
        "e2": (MOE + ONE + PER_STEP + E2, 2),
        "e2_k2": (MOE + ONE + ["--steps-per-dispatch", "2"] + E2, 2),
        "d2e2": (MOE + ONE + PER_STEP + ["--ckpt-mode", "sharded"]
                 + D2E2, 4),
    }
    waits = {tag: launch_cli(str(root / tag), argv, n, ref)
             for tag, (argv, n) in runs.items()}
    assert jtrain.main(MOE + ONE + PER_STEP + E2 + [
        "--save-dir", str(root / "jax" / "ck")]) == 0
    done = {tag: wait() for tag, wait in waits.items()}
    for tag, (rcs, outs) in done.items():
        assert rcs == [0] * runs[tag][1], (tag, outs)
    shutil.copytree(root / "d2e2" / "ck", root / "res_f2" / "ck")
    done["res_f2"] = launch_cli(
        str(root / "res_f2"), MOE + ["--epochs", "2", "--resume", "--fsdp",
                                     "2"] + PER_STEP, 2, ref)()
    assert done["res_f2"][0] == [0, 0], done["res_f2"][1]
    return root, done


def _epoch(root, tag, epoch=0):
    (rec,) = [r for r in records(str(root / tag), "epoch")
              if r["epoch"] == epoch]
    return rec


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("tag,n,mesh", [
    ("e2", 2, "mesh data 1 x fsdp 1 x expert 2"),
    ("d2e2", 4, "mesh data 2 x fsdp 1 x expert 2")])
def test_expert_cli_matches_one_process_and_jax(cli_runs, tag, n, mesh):
    root, done = cli_runs
    got, one = (records(str(root / t), "step") for t in (tag, "one"))
    assert len(got) == 2
    _close([r["loss"] for r in got], [r["loss"] for r in one[:2]])
    ep = _epoch(root, tag)
    for want in (_epoch(root, "one"), _epoch(root, "jax")):
        _close([ep["avg_loss"], ep["eval_loss"]],
               [want["avg_loss"], want["eval_loss"]])
    outs = done[tag][1]
    assert len(CONTRACT.findall(outs[0])) == 3
    assert outs[0].rstrip().endswith("Training completed.")
    assert all("Epoch" not in o for o in outs[1:])
    assert f"{n} process(es) (gloo)" in outs[0]
    assert mesh in outs[0]
    assert "x expert 2)" in outs[0]
    assert "its experts split over expert 2" in outs[0]
    assert verdicts(str(root / tag), n) == ("success", ["success"] * n)
    # a rank holds half the experts: the expert weights are 4/5 of the
    # state here
    (led,), (led1,) = (records(str(root / t), "memledger")
                       for t in (tag, "one"))
    assert led["params_bytes"] < 0.7 * led1["params_bytes"]


def test_expert_superstep_is_bitwise_its_per_step_run(cli_runs):
    root, done = cli_runs
    per, sup = (records(str(root / t), "step") for t in ("e2", "e2_k2"))
    assert len(per) == len(sup) == 2
    assert [(r["step"], r["loss"]) for r in sup] == [
        (r["step"], r["loss"]) for r in per]
    a, b = _epoch(root, "e2"), _epoch(root, "e2_k2")
    assert (a["avg_loss"], a["eval_loss"]) == (b["avg_loss"],
                                               b["eval_loss"])
    assert "superstep dispatch k=2" in done["e2_k2"][1][0]
    assert verdicts(str(root / "e2_k2"), 2) == ("success", ["success"] * 2)


def test_expert_checkpoint_resumes_at_fsdp2(cli_runs):
    """The ``--data 2 --expert 2`` run's sharded manifest holds each
    expert shard once (rank 0 and rank 1 write the two halves of the
    experts, ranks 2 and 3 nothing of them); fsdp 2 assembles its own
    regions from them and trains the second epoch as one process's
    uninterrupted run does."""
    root, done = cli_runs
    outs = done["res_f2"][1]
    assert "Epoch  2 finished" in outs[0]
    assert "Epoch  1 finished" not in outs[0]
    got, want = _epoch(root, "res_f2", 1), _epoch(root, "one", 1)
    _close([got["avg_loss"], got["eval_loss"]],
           [want["avg_loss"], want["eval_loss"]])
    assert verdicts(str(root / "res_f2"), 2)[0] == "success"
    steps = root / "d2e2" / "ck" / "elastic" / "steps"
    last = max(os.listdir(steps), key=int)
    starts = {}
    for r in range(4):
        with open(steps / last / f"worker{r}.json") as f:
            leaves = json.load(f)["leaves"]
        starts[r] = sorted(tuple(sh["start"]) for name, leaf in
                           leaves.items() if name.endswith("w_gate")
                           for sh in leaf["shards"])
    # w_gate's params, mu and nu: experts [0, 2) on rank 0, [2, 4) on 1
    assert {st[1] for st in starts[0]} == {0}
    assert {st[1] for st in starts[1]} == {2}
    assert len(starts[0]) == len(starts[1]) == 3
    assert starts[2] == starts[3] == []


# bench.py's MoE row (bench.py:165-168) at phase 18a's seq 512, bf16
BENCH_MOE = ["--model", "moe", "--vocab-size", "32000", "--n-layers", "4",
             "--d-model", "2048", "--n-heads", "16", "--n-kv-heads", "16",
             "--d-ff", "2752", "--n-experts", "8", "--expert-top-k", "2",
             "--moe-group-size", "256", "--seq-len", "512",
             "--train-batch-size", "8", "--dtype", "bfloat16",
             "--lm-head", "auto"]


@pytest.mark.parametrize("axes", [dict(expert=4), dict(data=2, expert=2),
                                  dict(fsdp=2, expert=2),
                                  dict(tensor=2, expert=2)])
def test_auto_head_counts_the_expert_shards_as_jax(devices8, monkeypatch,
                                                   axes):
    jm = build_mesh(jconfig.ParallelConfig(**axes), devices=devices8[:4])
    grid = tmesh.RankGrid(np.vectorize(lambda d: d.id)(jm.devices),
                          tmesh.AXIS_NAMES)
    picks = []
    for hbm in (1e9, 2e9, 3e9, 4e9, 5e9, 6e9, 8e9, 12e9, 80e9):
        monkeypatch.setenv("TPUDIST_HBM_BYTES", str(hbm))
        t = tengine._resolve_lm_head(tconfig.parse_args(BENCH_MOE),
                                     torch.device("cpu"), grid)
        assert t == jengine._resolve_lm_head(jconfig.parse_args(BENCH_MOE),
                                             jm), hbm
        picks.append(t)
    assert {(False, 0), (True, 0)} <= set(picks)


def test_auto_head_at_expert4_keeps_the_plain_head_where_one_card_fuses(
        monkeypatch):
    """At 6 GB one card holds the bench row's whole 673.8 M-param state
    and fuses the head; at ``--expert 4`` a card holds 2 of the 8
    experts and keeps the plain head, in both packages."""
    monkeypatch.setenv("TPUDIST_HBM_BYTES", "6e9")
    cfg = tconfig.parse_args(BENCH_MOE)
    assert tengine._resolve_lm_head(cfg, torch.device("cpu")) == (True, 0)
    grid = tmesh.rank_grid(tconfig.ParallelConfig(expert=4), 4)
    assert tengine._resolve_lm_head(cfg, torch.device("cpu"),
                                    grid) == (False, 0)
