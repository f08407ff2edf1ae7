"""The port's FSDP training against data parallelism, one process and
the JAX package: the sharded step body on gloo ranks, and ``python -m
tpudist_torch.train --fsdp``.

* The step body on four gloo ranks, at fsdp 4 and at data 2 x fsdp 2
  (``--grad-accum-steps 2``), for the MLP and a tiny transformer, and at
  fsdp 4 for a tiny MoE (routing over the global batch, its aux loss's
  sums all-reduced over the ranks), from the JAX package's initial
  params on its global batches: each step's loss and the final params
  within rtol 2e-3 / atol 2e-4 (``tests/test_fsdp.py:51``) of the JAX
  package's step at the same mesh on four virtual CPU devices, and of
  the replicated body at four ranks (the MoE's losses only: that body
  routes each rank's rows). A MoE routing group that spans ranks
  (``--moe-group-size 128`` at fsdp 4, 64 tokens a rank) builds, with
  the JAX package's group.
* The CLI at two gloo processes with ``--fsdp 2`` (template
  ``tests/test_multiprocess.py:87-95``), on the JAX package's
  permutations and init (and its data for the MLP; the token data is
  numpy on both sides), through ``tpudist_torch/data.py``'s hooks: the
  MLP, the transformer and the MoE (routing over the global batch)
  within the tolerance of one process's epochs and of the JAX CLI's at
  ``--fsdp 2``; the contract on rank 0, every verdict ``success``, the
  mesh and the shards in the log, the collectives in ``kind=devtime``'s
  schema and the memory ledger's halves; the transformer's superstep
  (k = 2) bitwise its per-step run at fsdp 2, and its
  ``--grad-accum-steps 2`` at fsdp 2 (each rank's rows microbatch-major)
  within the tolerance of one process's steps and the JAX CLI's epoch.
"""

import json
import re

import jax
import numpy as np
import pytest
import torch

from _torch_ranks import jax_cli_reference as _jax_reference
from _torch_ranks import launch_cli as _launch
from _torch_ranks import records as _records
from _torch_ranks import start_ranks
from _torch_ranks import verdicts as _verdicts
from tpudist import config as jconfig
from tpudist import data as jdata
from tpudist import engine as jengine
from tpudist import train as jtrain
from tpudist.parallel import build_mesh
from tpudist_torch import convert

torch.set_num_threads(1)

RTOL, ATOL = 2e-3, 2e-4
CONTRACT = re.compile(r"^(Epoch +\d+ (finished\. Avg|eval) loss: .*"
                      r"|Training completed\.)$", re.M)

# ---------------------------------------------- the step body, 4 ranks

TF = ["--model", "transformer", "--seq-len", "16", "--d-model", "32",
      "--n-layers", "2", "--n-heads", "4", "--n-kv-heads", "2", "--d-ff",
      "64", "--vocab-size", "96", "--lm-head", "plain"]
MOE = ["--model", "moe", "--seq-len", "16", "--d-model", "32",
       "--n-layers", "2", "--n-heads", "4", "--d-ff", "32", "--vocab-size",
       "96", "--n-experts", "4", "--moe-group-size", "64", "--lm-head",
       "plain"]
BODY_RUNS = {
    "mlp_dp": ["--lr", "1e-2"],
    "mlp_f4": ["--lr", "1e-2", "--fsdp", "4"],
    "mlp_d2f2": ["--lr", "1e-2", "--fsdp", "2",
                 "--grad-accum-steps", "2"],
    "tf_dp": TF + ["--lr", "1e-2"],
    "tf_f4": TF + ["--lr", "1e-2", "--fsdp", "4"],
    "tf_d2f2": TF + ["--lr", "1e-2", "--fsdp", "2",
                     "--grad-accum-steps", "2"],
    # routing groups of 64 tokens, a rank's share of the global batch
    "moe_dp": MOE + ["--lr", "1e-2"],
    "moe_f4": MOE + ["--lr", "1e-2", "--fsdp", "4"],
}
STEPS, BATCH = 3, 16

BODY = r"""
import json
from tpudist_torch import config, data, engine
from tpudist_torch.parallel import mesh as mesh_lib
cpu = torch.device("cpu")
out = ARGS[0]
a = np.load(f"{out}/ref.npz")
res, meshes = {}, {}
for tag, argv in json.loads(ARGS[1]).items():
    cfg = config.parse_args(argv + ["--device", "cpu",
                                    "--train-batch-size", "16"])
    mesh = None
    if cfg.parallel.fsdp > 1:
        if cfg.parallel.fsdp not in meshes:
            meshes[cfg.parallel.fsdp] = mesh_lib.build_mesh(
                cfg.parallel, device_type="cpu")
        mesh = meshes[cfg.parallel.fsdp]
    state = engine.init_state(cfg, cpu, mesh)
    model = tag.split("_")[0]
    with torch.no_grad():
        for i, (n, p) in enumerate(state.params.named_parameters()):
            w = torch.from_numpy(a[f"{model}.param.{n}"])
            p.copy_(state.layout.shard(i, w) if mesh is not None else w)
    step = engine.make_train_step(cfg, cpu, mesh)
    batches = [a[k] for k in (f"{model}.x", f"{model}.y") if k in a]
    losses = []
    for i in range(batches[0].shape[0]):
        # a rank's batch shard: its position in (data, fsdp), its rank
        local = tuple(b[i].reshape(WORLD, -1, *b.shape[2:])[RANK]
                      for b in batches)
        state, loss = step(state, data.to_device(local, cpu))
        losses.append(float(loss))
    with torch.no_grad():
        whole = (engine.gather_params(state) if mesh is not None
                 else list(state.params.parameters()))
    res[tag] = {"losses": losses, "params": {
        n: t.detach().clone() for (n, _), t in
        zip(state.params.named_parameters(), whole)}}
if RANK == 0:
    torch.save(res, f"{out}/body.pt")
"""


def _jax_body_reference(out, devices8):
    """The JAX package's initial params and global batches in
    ``ref.npz``, the port's ranks started on them; the JAX package's
    losses and final params at each fsdp mesh meanwhile. Returns those
    and the ranks' ``wait``."""
    arrays, want = {}, {}
    x, y = jdata.make_synthetic_data(STEPS * BATCH, 20, 42)
    tokens = jdata.make_synthetic_tokens(STEPS * BATCH, 17, 96, 42)
    batches = {"mlp": (x.reshape(STEPS, BATCH, 20),
                       y.reshape(STEPS, BATCH)),
               "tf": (tokens.reshape(STEPS, BATCH, 17),),
               "moe": (tokens.reshape(STEPS, BATCH, 17),)}
    arrays.update({"mlp.x": batches["mlp"][0], "mlp.y": batches["mlp"][1],
                   "tf.x": batches["tf"][0], "moe.x": batches["moe"][0]})
    runs = {}
    for tag, argv in BODY_RUNS.items():
        jcfg = jconfig.parse_args(argv + ["--train-batch-size",
                                          str(BATCH)])
        mesh = build_mesh(jcfg.parallel, devices=devices8[:4])
        runs[tag] = (jcfg, mesh, jengine.init_state(
            jax.random.PRNGKey(jcfg.seed), jcfg, mesh))
        if tag.endswith("_dp"):
            for k, v in convert.params_from_jax(
                    jax.device_get(runs[tag][2].params)).items():
                arrays[f"{tag.split('_')[0]}.param.{k}"] = v.numpy()
    np.savez(out / "ref.npz", **arrays)
    wait = start_ranks(BODY, 4, out, json.dumps(BODY_RUNS))
    for tag, (jcfg, mesh, state) in runs.items():
        if tag.endswith("_dp"):
            continue
        model = tag.split("_")[0]
        step = jengine.make_train_step(jcfg, mesh)
        losses = []
        for i in range(STEPS):
            state, loss = step(state, tuple(b[i] for b in batches[model]))
            losses.append(float(loss))
        want[tag] = {"losses": losses, "params": {
            k: v.numpy() for k, v in convert.params_from_jax(
                jax.device_get(state.params)).items()}}
    return want, wait


@pytest.fixture(scope="module")
def body_runs(tmp_path_factory, devices8):
    out = tmp_path_factory.mktemp("fsdp_body")
    want, wait = _jax_body_reference(out, devices8)
    wait()
    return torch.load(out / "body.pt", weights_only=True), want


@pytest.mark.parametrize("tag", ["mlp_f4", "mlp_d2f2", "tf_f4", "tf_d2f2",
                                 "moe_f4"])
def test_sharded_body_matches_dp_and_jax_on_four_ranks(body_runs, tag):
    got, want = body_runs
    dp = got[tag.split("_")[0] + "_dp"]
    mine = got[tag]
    assert len(mine["losses"]) == STEPS
    np.testing.assert_allclose(mine["losses"], dp["losses"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(mine["losses"], want[tag]["losses"],
                               rtol=RTOL, atol=ATOL)
    assert set(mine["params"]) == set(want[tag]["params"])
    for name, t in mine["params"].items():
        if not tag.startswith("moe"):
            # the replicated MoE body routes and takes its aux loss over
            # each rank's rows (the JAX package's DP path); the sharded
            # one over the global batch, as the JAX step at the same mesh
            np.testing.assert_allclose(
                t.numpy(), dp["params"][name].numpy(), rtol=RTOL,
                atol=ATOL, err_msg=name)
        np.testing.assert_allclose(t.numpy(), want[tag]["params"][name],
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    # the params moved
    assert mine["losses"][-1] < mine["losses"][0]


def test_moe_group_across_ranks_is_routed_not_refused():
    """The JAX package routes the global batch of 256 tokens in groups of
    128; at fsdp 4 a rank holds 64 of them, so a group spans two ranks.
    The port builds the train step, the superstep and the eval for the
    shape (``tests/test_torch_moe_global.py`` holds its steps to the
    JAX package's), with the JAX package's group."""
    from tpudist_torch import config as tconfig
    from tpudist_torch import engine as tengine
    from tpudist_torch.models import moe as tmoe
    from tpudist_torch.parallel import mesh as tmesh
    argv = MOE + ["--fsdp", "4", "--train-batch-size", str(BATCH),
                  "--device", "cpu"]
    argv[argv.index("--moe-group-size") + 1] = "128"
    cfg = tconfig.parse_args(argv)
    grid = tmesh.rank_grid(cfg.parallel, 4)
    cpu = torch.device("cpu")
    assert callable(tengine.make_train_step(cfg, cpu, grid))
    assert tengine.make_superstep(cfg, cpu, 2, grid).k == 2
    assert callable(tengine.make_eval_fn(cfg, cpu, grid))
    from tpudist.models import moe as jmoe_
    jm = jconfig.parse_args(argv[:-2]).model
    assert tmoe.group_size(cfg.model, BATCH * 16) == jmoe_.group_size(
        jm, BATCH * 16) == 128
    assert (BATCH // 4 * 16) % 128


# ---------------------------------------------------- the CLI, 2 ranks

MLP = ["--epochs", "2", "--n-samples", "256", "--train-batch-size", "32",
       "--steps-per-dispatch", "1", "--seed", "7", "--lr", "1e-2"]
TF_CLI = TF[:-2] + ["--epochs", "1", "--n-samples", "32",
                    "--train-batch-size", "8", "--log-every", "2",
                    "--seed", "3", "--lr", "1e-2"]
MOE_CLI = MOE + ["--epochs", "1", "--n-samples", "32",
                 "--train-batch-size", "8", "--log-every", "2",
                 "--steps-per-dispatch", "1", "--seed", "3"]

@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Every CLI run of this file, started together; the JAX CLI at
    ``--fsdp 2`` in this process meanwhile."""
    root = tmp_path_factory.mktemp("fsdp_cli")
    refs = {}
    for model, argv in (("mlp", MLP), ("tf", TF_CLI), ("moe", MOE_CLI)):
        refs[model] = str(root / f"{model}_ref.npz")
        _jax_reference(refs[model], argv)
    runs = {
        "mlp1": ("mlp", MLP, 1), "mlp_f2": ("mlp", MLP + ["--fsdp", "2"], 2),
        "tf1": ("tf", TF_CLI + ["--steps-per-dispatch", "1"], 1),
        "tf_f2": ("tf", TF_CLI + ["--steps-per-dispatch", "1", "--fsdp",
                                  "2"], 2),
        "tf_f2_k2": ("tf", TF_CLI + ["--steps-per-dispatch", "2", "--fsdp",
                                     "2"], 2),
        "tf_f2_accum": ("tf", TF_CLI + ["--steps-per-dispatch", "1",
                                        "--fsdp", "2",
                                        "--grad-accum-steps", "2"], 2),
        "moe1": ("moe", MOE_CLI, 1),
        "moe_f2": ("moe", MOE_CLI + ["--fsdp", "2"], 2),
    }
    waits = {tag: _launch(str(root / tag), argv, n, refs[model])
             for tag, (model, argv, n) in runs.items()}
    for model, argv in (("mlp", MLP), ("tf", TF_CLI), ("moe", MOE_CLI)):
        # per-step: one program to compile (the Avg lines are bitwise the
        # superstep's)
        assert jtrain.main(argv + ["--fsdp", "2", "--steps-per-dispatch",
                                   "1", "--save-dir", str(
                                       root / f"jax_{model}" / "ck")]) == 0
    done = {tag: wait() for tag, wait in waits.items()}
    for tag, (rcs, outs) in done.items():
        assert rcs == [0] * runs[tag][2], (tag, outs)
    return root, done


def test_mlp_fsdp2_cli_matches_one_process_and_jax(cli_runs):
    root, done = cli_runs
    f2, one, jx = (_records(str(root / d), "epoch")
                   for d in ("mlp_f2", "mlp1", "jax_mlp"))
    assert len(f2) == len(one) == len(jx) == 2
    for key in ("avg_loss", "eval_loss"):
        got = [r[key] for r in f2]
        np.testing.assert_allclose(got, [r[key] for r in one], rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(got, [r[key] for r in jx], rtol=RTOL,
                                   atol=ATOL)
    assert [r["steps_counted"] for r in f2] == [8, 8]
    outs = done["mlp_f2"][1]
    assert CONTRACT.findall(outs[0]) and outs[0].rstrip().endswith(
        "Training completed.")
    assert len(CONTRACT.findall(outs[0])) == 5
    assert "2 process(es) (gloo)" in outs[0]
    assert "mesh data 1 x fsdp 2" in outs[0]
    assert "this device's 1/2 shards" in outs[0]
    assert "Epoch" not in outs[1]
    assert _verdicts(str(root / "mlp_f2"), 2) == ("success",
                                                  ["success"] * 2)
    # a step's collectives: a gather and a reduce-scatter a sharded leaf
    # (fc1.w, fc1.b, fc2.w), an all-reduce for fc2.b and the loss
    assert "tpudist: collectives 8 op(s)/step" in outs[0]
    (led,) = _records(str(root / "mlp_f2"), "memledger")
    (led1,) = _records(str(root / "mlp1"), "memledger")
    # params and Adam's moments: 1/2 of every sharded leaf a device
    assert led["params_bytes"] == (20 * 32 + 32 + 32 + 1) * 4
    assert led1["params_bytes"] == (20 * 64 + 64 + 64 + 1) * 4
    assert led["opt_state_bytes"] == 2 * led["params_bytes"]


def test_transformer_fsdp2_superstep_is_bitwise_its_per_step_run(cli_runs):
    root, done = cli_runs
    per, sup, one = (_records(str(root / d), "step")
                     for d in ("tf_f2", "tf_f2_k2", "tf1"))
    assert len(per) == len(sup) == 2
    assert [(r["step"], r["loss"]) for r in sup] == [
        (r["step"], r["loss"]) for r in per]
    ep = [_records(str(root / d), "epoch")[0] for d in ("tf_f2",
                                                         "tf_f2_k2", "tf1")]
    assert (ep[0]["avg_loss"], ep[0]["eval_loss"]) == (
        ep[1]["avg_loss"], ep[1]["eval_loss"])
    np.testing.assert_allclose([r["loss"] for r in per],
                               [r["loss"] for r in one], rtol=RTOL,
                               atol=ATOL)
    jx = _records(str(root / "jax_tf"), "epoch")[0]
    for want in (ep[2], jx):
        np.testing.assert_allclose(
            [ep[0]["avg_loss"], ep[0]["eval_loss"]],
            [want["avg_loss"], want["eval_loss"]], rtol=RTOL, atol=ATOL)
    assert "superstep dispatch k=2" in done["tf_f2_k2"][1][0]
    for d in ("tf_f2", "tf_f2_k2"):
        assert _verdicts(str(root / d), 2) == ("success", ["success"] * 2)


def test_transformer_fsdp2_accumulates_the_global_microbatches(cli_runs):
    """``--grad-accum-steps 2`` at fsdp 2: each rank's rows microbatch-major
    (its microbatch i its half of the global microbatch i, as the JAX
    package's ``_microbatch`` splits the global batch), which for a dense
    model means the same mean loss and grads as one process's whole
    batch."""
    root, done = cli_runs
    acc, one = (_records(str(root / d), "step")
                for d in ("tf_f2_accum", "tf1"))
    assert len(acc) == len(one) == 2
    np.testing.assert_allclose([r["loss"] for r in acc],
                               [r["loss"] for r in one], rtol=RTOL,
                               atol=ATOL)
    ep, jx = (_records(str(root / d), "epoch")[0]
              for d in ("tf_f2_accum", "jax_tf"))
    np.testing.assert_allclose([ep["avg_loss"], ep["eval_loss"]],
                               [jx["avg_loss"], jx["eval_loss"]],
                               rtol=RTOL, atol=ATOL)
    assert "mesh data 1 x fsdp 2" in done["tf_f2_accum"][1][0]
    assert _verdicts(str(root / "tf_f2_accum"), 2) == ("success",
                                                       ["success"] * 2)


def test_moe_fsdp2_matches_one_process_and_jax(cli_runs):
    """Routing groups of 64 tokens: a rank's shard of a step (4 x 16
    tokens) at fsdp 2, half of one process's batch and of the JAX
    package's global one, so all three route the same groups and take
    the aux loss over the global batch."""
    root, done = cli_runs
    f2, dp = (_records(str(root / d), "step") for d in ("moe_f2", "moe1"))
    assert len(f2) == len(dp) == 2
    np.testing.assert_allclose([r["loss"] for r in f2],
                               [r["loss"] for r in dp], rtol=RTOL,
                               atol=ATOL)
    e_f2, e_dp, e_jx = (_records(str(root / d), "epoch")[0]
                        for d in ("moe_f2", "moe1", "jax_moe"))
    for want in (e_dp, e_jx):
        np.testing.assert_allclose([e_f2["avg_loss"], e_f2["eval_loss"]],
                                   [want["avg_loss"], want["eval_loss"]],
                                   rtol=RTOL, atol=ATOL)
    assert done["moe_f2"][1][0].rstrip().endswith("Training completed.")
    assert _verdicts(str(root / "moe_f2"), 2) == ("success",
                                                  ["success"] * 2)
