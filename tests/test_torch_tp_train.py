"""The port's tensor parallelism through the train CLI: ``python -m
tpudist_torch.train --tensor 2`` at two gloo processes against one
process and against the JAX CLI at ``--tensor 2`` (eight virtual CPU
devices: data 4 x tensor 2), on the JAX package's permutations and init
(the token data is numpy on both sides), through
``tpudist_torch/data.py``'s hooks.

* The transformer (vocab 96 over tensor 2: the vocab-parallel head and
  lookup; GQA kv 2, resident) and the MoE (routing over the global
  batch, the experts' hidden dim over tensor): each step's loss and the
  epoch's Avg and eval loss within rtol 2e-3 / atol 2e-4
  (``tests/test_torch_fsdp_train.py``'s tolerance) of one process's and
  of the JAX CLI's; the contract on rank 0, every verdict ``success``,
  the mesh in the log.
* The transformer's superstep (k = 2) at ``--tensor 2`` bitwise its
  per-step run.
* The ``--tensor 2`` runs' checkpoints (the default layout, and the
  sharded manifest of the superstep's run) resumed replicated (one
  process) and at ``--fsdp 2``: the second epoch's losses within the
  tolerance of one process's uninterrupted two epochs.
* ``--pipe`` refused beside ``--tensor``, naming ROADMAP Queue A item
  8b; ``--context`` beside it carried (at one process only its mesh of
  four is refused); ``--expert`` beside it splits the experts over
  expert and their hidden dim over tensor.
"""

import os
import re
import shutil

import numpy as np
import pytest
import torch

from _torch_ranks import jax_cli_reference, launch_cli, records, verdicts
from tpudist import train as jtrain
from tpudist_torch import config as tconfig
from tpudist_torch import train as ttrain

torch.set_num_threads(1)

RTOL, ATOL = 2e-3, 2e-4
CONTRACT = re.compile(r"^(Epoch +\d+ (finished\. Avg|eval) loss: .*"
                      r"|Training completed\.)$", re.M)

TF = ["--model", "transformer", "--seq-len", "16", "--d-model", "32",
      "--n-layers", "2", "--n-heads", "4", "--n-kv-heads", "2", "--d-ff",
      "64", "--vocab-size", "96", "--lm-head", "plain", "--n-samples",
      "32", "--train-batch-size", "8", "--log-every", "2", "--seed", "3",
      "--lr", "1e-2"]
MOE = ["--model", "moe", "--seq-len", "16", "--d-model", "32",
       "--n-layers", "2", "--n-heads", "4", "--d-ff", "32", "--vocab-size",
       "96", "--n-experts", "4", "--moe-group-size", "64", "--lm-head",
       "plain", "--n-samples", "32", "--train-batch-size", "8",
       "--log-every", "2", "--steps-per-dispatch", "1", "--seed", "3",
       "--epochs", "1"]
PER_STEP = ["--steps-per-dispatch", "1"]
T2 = ["--tensor", "2"]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Every CLI run of this file: the first epochs together, the JAX
    CLI at ``--tensor 2`` in this process meanwhile, then the two
    resumes of the ``--tensor 2`` run's checkpoint."""
    root = tmp_path_factory.mktemp("tp_cli")
    refs = {}
    for model, argv in (("tf", TF + ["--epochs", "2"]), ("moe", MOE)):
        refs[model] = str(root / f"{model}_ref.npz")
        jax_cli_reference(refs[model], argv)
    one_epoch = TF + ["--epochs", "1"]
    runs = {
        "tf1": ("tf", TF + ["--epochs", "2"] + PER_STEP, 1),
        "tf_t2": ("tf", one_epoch + PER_STEP + T2, 2),
        # the sharded manifest layout: res_f2 resumes from it
        "tf_t2_k2": ("tf", one_epoch + ["--steps-per-dispatch", "2",
                                        "--ckpt-mode", "sharded"] + T2, 2),
        "moe1": ("moe", MOE, 1),
        "moe_t2": ("moe", MOE + T2, 2),
    }
    waits = {tag: launch_cli(str(root / tag), argv, n, refs[model])
             for tag, (model, argv, n) in runs.items()}
    for model, argv in (("tf", one_epoch + PER_STEP), ("moe", MOE)):
        assert jtrain.main(argv + T2 + ["--save-dir", str(
            root / f"jax_{model}" / "ck")]) == 0
    done = {tag: wait() for tag, wait in waits.items()}
    for tag, (rcs, outs) in done.items():
        assert rcs == [0] * runs[tag][2], (tag, outs)
    resumes = {"res1": (TF + ["--epochs", "2", "--resume"] + PER_STEP, 1),
               "res_f2": (TF + ["--epochs", "2", "--resume", "--fsdp",
                                "2"] + PER_STEP, 2)}
    for tag, src in (("res1", "tf_t2"), ("res_f2", "tf_t2_k2")):
        shutil.copytree(root / src / "ck", root / tag / "ck")
    waits = {tag: launch_cli(str(root / tag), argv, n, refs["tf"])
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


@pytest.mark.parametrize("model", ["tf", "moe"])
def test_tensor2_cli_matches_one_process_and_jax(cli_runs, model):
    root, done = cli_runs
    t2, one = (records(str(root / f"{model}{d}"), "step")
               for d in ("_t2", "1"))
    assert len(t2) == 2
    _close([r["loss"] for r in t2], [r["loss"] for r in one[:2]])
    got = _epoch(root, f"{model}_t2")
    for want in (_epoch(root, f"{model}1"), _epoch(root, f"jax_{model}")):
        _close([got["avg_loss"], got["eval_loss"]],
               [want["avg_loss"], want["eval_loss"]])
    outs = done[f"{model}_t2"][1]
    assert len(CONTRACT.findall(outs[0])) == 3
    assert outs[0].rstrip().endswith("Training completed.")
    assert "Epoch" not in outs[1]
    assert "2 process(es) (gloo)" in outs[0]
    assert "mesh data 1 x fsdp 1 x tensor 2" in outs[0]
    assert "shards over fsdp 1 x tensor 2" in outs[0]
    if model == "moe":
        assert "MoE routing over the global batch" in outs[0]
    assert verdicts(str(root / f"{model}_t2"), 2) == ("success",
                                                      ["success"] * 2)
    # each tensor rank holds its part of the split leaves
    (led,), (led1,) = (records(str(root / f"{model}{d}"), "memledger")
                       for d in ("_t2", "1"))
    assert led["params_bytes"] < 0.6 * led1["params_bytes"]


def test_tensor2_superstep_is_bitwise_its_per_step_run(cli_runs):
    root, done = cli_runs
    per, sup = (records(str(root / d), "step") for d in ("tf_t2",
                                                          "tf_t2_k2"))
    assert len(per) == len(sup) == 2
    assert [(r["step"], r["loss"]) for r in sup] == [
        (r["step"], r["loss"]) for r in per]
    a, b = _epoch(root, "tf_t2"), _epoch(root, "tf_t2_k2")
    assert (a["avg_loss"], a["eval_loss"]) == (b["avg_loss"],
                                               b["eval_loss"])
    assert "superstep dispatch k=2" in done["tf_t2_k2"][1][0]
    assert verdicts(str(root / "tf_t2_k2"), 2) == ("success",
                                                   ["success"] * 2)


@pytest.mark.parametrize("tag,n", [("res1", 1), ("res_f2", 2)])
def test_tensor2_checkpoint_resumes_replicated_and_at_fsdp2(cli_runs, tag,
                                                            n):
    """The ``--tensor 2`` runs wrote their tensor shards (the table's
    vocab over ``(fsdp, tensor)``), in the step directories and in the
    sharded manifest; one process and fsdp 2 assemble their own regions
    from them and train the second epoch as one process's uninterrupted
    run does."""
    root, done = cli_runs
    outs = done[tag][1]
    assert "Epoch  2 finished" in outs[0]
    assert "Epoch  1 finished" not in outs[0]
    got, want = _epoch(root, tag, 1), _epoch(root, "tf1", 1)
    _close([got["avg_loss"], got["eval_loss"]],
           [want["avg_loss"], want["eval_loss"]])
    assert verdicts(str(root / tag), n)[0] == "success"
    assert os.path.isdir(root / tag / "ck")


@pytest.mark.parametrize("axis", ["--context", "--pipe"])
def test_other_axes_stay_refused_beside_tensor(axis, tmp_path):
    argv = ["--model", "moe", "--tensor", "2", axis, "2", "--device",
            "cpu", "--save-dir", str(tmp_path)]
    # the context axis is carried beside tensor: at one process its mesh
    # of four is refused as any mesh wider than the world is
    match = (r"^1 devices not divisible by pipe\*fsdp\*expert\*tensor"
             if axis == "--context" else "ROADMAP Queue A item 8b$")
    with pytest.raises(ValueError, match=match):
        ttrain.run(tconfig.parse_args(argv))


def test_expert_beside_tensor_splits_both():
    """``--tensor 2 --expert 2``: a rank's ``w_gate`` / ``w_up`` /
    ``w_down`` keep the experts of its expert coordinate and the hidden
    columns of its tensor coordinate; the router stays whole."""
    from tpudist_torch import engine as tengine
    from tpudist_torch.parallel import mesh as tmesh
    argv = MOE + ["--tensor", "2", "--expert", "2", "--device", "cpu"]
    cfg = tconfig.parse_args(argv)
    cpu = torch.device("cpu")
    shapes = {n: tuple(p.shape) for n, p in
              tengine.init_state(cfg, cpu).params.named_parameters()}
    grid = tmesh.rank_grid(cfg.parallel, 4)
    E, dff = cfg.model.n_experts, cfg.model.d_ff
    for rank in range(4):
        e, t = divmod(rank, 2)       # C order: expert before tensor
        lay = tengine.make_layout(cfg, grid, shapes, rank=rank)
        spans = dict(zip(lay.names, map(lay.span, range(len(lay.names)))))
        experts = (e * E // 2, (e + 1) * E // 2)
        cols = (t * dff // 2, (t + 1) * dff // 2)
        assert spans["layers.w_gate"][1:] == (experts, (0, 32), cols)
        assert spans["layers.w_down"][1:] == (experts, cols, (0, 32))
        assert spans["layers.w_router"] == tuple(
            (0, n) for n in shapes["layers.w_router"])
