"""The port's data-parallel train lane against one process and against the
JAX package.

N processes of the port's train CLI (``--device cpu``, gloo) under the
JAX package's env contract (``TPUDIST_COORDINATOR`` /
``TPUDIST_NUM_PROCESSES`` / ``TPUDIST_PROCESS_ID``):

* the MLP at 2 and 4 processes: every epoch's Avg and eval loss within
  1e-6 of one process of the port (the reduction order is all that
  differs) and within 1e-5 of the JAX CLI on the same data, permutation
  and initial params (itself an 8-way data-parallel mesh on the CPU);
  every process ends with bitwise the same params, only rank 0 prints
  the contract and writes the metrics, every process writes its own
  verdict: one coordinated job, where the port used to run one whole
  uncoordinated copy a process;
* the superstep (k = 4) at 2 processes over gloo: every epoch within
  1e-6 of one process at the same k, which is bitwise one process's
  per-step run;
* a tiny transformer at 2 processes: the final checkpoint's params within
  f32 1e-5 of one process's;
* the failure paths: ``--fail-at 0`` on every process, or on one alone
  while the other waits on it in the gradient reduce, turns every
  process's exit code and the final verdict to fail, and a late peer
  times the aggregation out with no hang;
* units: each process's epoch shard against the JAX ``_epoch_index``,
  the env contract's errors, the one-card-a-rank rule of NCCL.

The children import nothing of JAX: the parent computes the JAX package's
data, permutations and MLP init with numpy in hand and passes them in a
``.npz``, which each child hands to the port through
``tpudist_torch.data.reference_data`` / ``reference_permutation``.
"""

import json
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tpudist import config as jconfig
from tpudist import data as jdata
from tpudist import train as jtrain
from tpudist.models import mlp as jmlp
from tpudist_torch import config as tconfig
from tpudist_torch import convert
from tpudist_torch import data as tdata
from tpudist_torch.metrics import StepTimer
from tpudist_torch.parallel import distributed
from _torch_ranks import free_port as _free_port

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONTRACT = re.compile(r"^(Epoch +\d+ (finished\. Avg|eval) loss: .*"
                      r"|Training completed\.)$", re.M)
MLP_ARGV = ["--epochs", "3", "--n-samples", "512", "--train-batch-size",
            "64", "--steps-per-dispatch", "1", "--seed", "7"]
# the superstep: k = 4 (the later flag wins), two full windows an epoch
SUPERSTEP_ARGV = MLP_ARGV + ["--steps-per-dispatch", "4", "--log-every",
                             "4"]
# the _TF shape of tests/test_multiprocess.py
TF_ARGV = ["--model", "transformer", "--n-samples", "32",
           "--train-batch-size", "8", "--seq-len", "64", "--d-model", "128",
           "--n-layers", "2", "--n-heads", "4", "--d-ff", "256",
           "--vocab-size", "256", "--epochs", "1"]

# One process of the train CLI: argv[1] is an .npz of the JAX package's
# arrays ("-" for the port's own), argv[2] where to save the final
# params, the rest the CLI's flags.
CHILD = r"""
import sys
for name in ("jax", "jaxlib", "optax", "orbax", "tpudist"):
    sys.modules[name] = None
import numpy as np
import torch
torch.set_num_threads(1)
from tpudist_torch import data, engine, train
from tpudist_torch.models import mlp

ref, dump, argv = sys.argv[1], sys.argv[2], sys.argv[3:]
if ref != "-":
    a = dict(np.load(ref))
    data.reference_data = lambda n, f, seed: (
        (a["x"], a["y"]) if n == len(a["x"]) else (a["ex"], a["ey"]))
    data.reference_permutation = lambda seed, epoch, n: a[f"perm{epoch}"]

    def carried_init(cfg, *, generator):
        model = mlp.MLP(cfg, device=generator.device)
        model.load_state_dict({k[6:]: torch.from_numpy(v) for k, v in
                               a.items() if k.startswith("param.")})
        return model
    mlp.init = carried_init
states = []
real_init = engine.init_state
engine.init_state = lambda cfg, dev: states.append(real_init(cfg, dev)) \
    or states[-1]
rc = train.main(argv)
if states:
    torch.save(states[-1].params.state_dict(), dump)
sys.exit(rc)
"""



def _launch(tmp, argv, nprocs, ref="-", env_by_rank=None,
            argv_by_rank=None):
    """Start ``nprocs`` processes of one job in ``tmp``, each with ``argv``
    and its own flags of ``argv_by_rank``; the returned ``wait`` gives
    their exit codes and outputs."""
    os.makedirs(tmp, exist_ok=True)
    port = _free_port()
    procs = []
    for rank in range(nprocs):
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   TPUDIST_VERDICT_PATH=os.path.join(tmp, "job_status.txt"))
        if nprocs > 1:
            env.update(TPUDIST_COORDINATOR=f"localhost:{port}",
                       TPUDIST_NUM_PROCESSES=str(nprocs),
                       TPUDIST_PROCESS_ID=str(rank))
        env.update((env_by_rank or {}).get(rank, {}))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", CHILD, ref,
             os.path.join(tmp, f"params.rank{rank}.pt"), *argv,
             "--device", "cpu", "--save-dir", os.path.join(tmp, "ck"),
             *(argv_by_rank or {}).get(rank, ())],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))

    def wait(timeout=120):
        outs, rcs = [], []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout)[0])
                rcs.append(p.returncode)
        finally:
            for p in procs:
                p.kill()
        return rcs, outs
    return wait


def _epochs(tmp):
    return [r for r in (json.loads(line) for line in open(
        os.path.join(tmp, "ck", "metrics.jsonl")))
        if r["kind"] == "epoch"]


def _params(tmp, rank):
    return torch.load(os.path.join(tmp, f"params.rank{rank}.pt"),
                      weights_only=True)


def _verdicts(tmp, nprocs):
    read = lambda name: open(os.path.join(tmp, name)).read()  # noqa: E731
    return read("job_status.txt"), [read(f"job_status.txt.worker{r}")
                                    for r in range(nprocs)]


def _jax_reference(path):
    """The JAX package's data, permutations and MLP init for MLP_ARGV, as
    numpy in an .npz."""
    cfg = jconfig.parse_args(MLP_ARGV)
    n, f, seed = cfg.data.n_samples, cfg.data.n_features, cfg.data.seed
    x, y = jdata.make_synthetic_data(n, f, seed)
    ex, ey = jdata.make_synthetic_data(cfg.batch_size, f, seed + 1)
    arrays = {"x": x, "y": y, "ex": ex, "ey": ey}
    for e in range(cfg.epochs):
        arrays[f"perm{e}"] = jdata.epoch_permutation(cfg.seed, e, n)
    params = jmlp.init(jax.random.PRNGKey(cfg.seed), cfg.model)
    for k, v in convert.params_from_jax(jax.device_get(params)).items():
        arrays[f"param.{k}"] = v.numpy()
    np.savez(path, **{k: np.asarray(v) for k, v in arrays.items()})


@pytest.fixture(scope="module")
def mlp_runs(tmp_path_factory):
    """The MLP CLI at 1, 2 and 4 processes of the port (run together) on
    the JAX package's data, and the JAX CLI in this process."""
    root = tmp_path_factory.mktemp("dp_mlp")
    ref = str(root / "ref.npz")
    _jax_reference(ref)
    waits = {n: _launch(str(root / f"p{n}"), MLP_ARGV, n, ref=ref)
             for n in (1, 2, 4)}
    waits.update({f"k4-{n}": _launch(str(root / f"pk4-{n}"),
                                     SUPERSTEP_ARGV, n, ref=ref)
                  for n in (1, 2)})
    assert jtrain.main(MLP_ARGV + ["--save-dir",
                                   str(root / "jax" / "ck")]) == 0
    runs = {n: wait() for n, wait in waits.items()}
    return root, runs


@pytest.mark.parametrize("nprocs", [2, 4])
def test_mlp_processes_match_one_process_and_jax(nprocs, mlp_runs):
    root, runs = mlp_runs
    rcs, outs = runs[nprocs]
    assert rcs == [0] * nprocs, outs
    one, jax_dir = str(root / "p1"), str(root / "jax")
    assert runs[1][0] == [0], runs[1][1]
    dp, sp, jx = (_epochs(d) for d in (str(root / f"p{nprocs}"), one,
                                       jax_dir))
    assert len(dp) == len(sp) == len(jx) == 3
    for key in ("avg_loss", "eval_loss"):
        got = [r[key] for r in dp]
        np.testing.assert_allclose(got, [r[key] for r in sp], rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(got, [r[key] for r in jx], rtol=0,
                                   atol=1e-5)
    # each process trained its shard of every global batch: 8 steps an
    # epoch, as one process takes
    assert [r["steps_counted"] for r in dp] == [8, 8, 8]
    # one coordinated job: rank 0 alone prints the contract and the
    # process count, every rank writes its verdict, rank 0 the final one
    assert CONTRACT.findall(outs[0]) == CONTRACT.findall(runs[1][1][0])
    assert len(CONTRACT.findall(outs[0])) == 7
    assert f"{nprocs} process(es) (gloo)" in outs[0]
    assert f"on {nprocs} chip(s)" in outs[0]
    for out in outs[1:]:
        assert "Epoch" not in out and "Training completed" not in out, out
    assert _verdicts(str(root / f"p{nprocs}"), nprocs) == (
        "success", ["success"] * nprocs)
    # the replicas stay bitwise alike
    p0 = _params(str(root / f"p{nprocs}"), 0)
    for rank in range(1, nprocs):
        for name, t in _params(str(root / f"p{nprocs}"), rank).items():
            assert torch.equal(t, p0[name]), (rank, name)


def test_superstep_on_two_processes_matches_one(mlp_runs):
    root, runs = mlp_runs
    for n in (1, 2):
        rcs, outs = runs[f"k4-{n}"]
        assert rcs == [0] * n, outs
        assert "tpudist: superstep dispatch k=4" in outs[0]
    one, per_step = (_epochs(str(root / d)) for d in ("pk4-1", "p1"))
    dp = _epochs(str(root / "pk4-2"))
    assert len(dp) == 3
    assert [(r["avg_loss"], r["eval_loss"]) for r in one] == [
        (r["avg_loss"], r["eval_loss"]) for r in per_step]
    for key in ("avg_loss", "eval_loss"):
        np.testing.assert_allclose([r[key] for r in dp],
                                   [r[key] for r in one], rtol=0, atol=1e-6)
    assert _verdicts(str(root / "pk4-2"), 2) == ("success",
                                                 ["success"] * 2)
    p0, p1 = (_params(str(root / "pk4-2"), r) for r in (0, 1))
    for name, t in p0.items():
        assert torch.equal(t, p1[name]), name


def test_transformer_on_two_processes_matches_one(tmp_path):
    waits = [_launch(str(tmp_path / f"p{n}"), TF_ARGV, n) for n in (1, 2)]
    (rc1, out1), (rcs, outs) = (w() for w in waits)
    assert rc1 == [0] and rcs == [0, 0], (out1, outs)
    assert len(CONTRACT.findall(outs[0])) == 3
    assert "Epoch" not in outs[1], outs[1]
    ck = lambda d: torch.load(  # noqa: E731
        tmp_path / d / "ck" / "4" / "state.pt", weights_only=True)
    one, dp = ck("p1"), ck("p2")
    assert dp["step"] == one["step"] == 4
    for name, t in one["params"].items():
        np.testing.assert_allclose(dp["params"][name].numpy(), t.numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)
    p0, p1 = (_params(str(tmp_path / "p2"), r) for r in (0, 1))
    for name, t in p0.items():
        assert torch.equal(t, p1[name]), name
        assert torch.equal(t, dp["params"][name]), name


def test_fail_at_on_two_processes_fails_every_process(tmp_path):
    rcs, outs = _launch(str(tmp_path), ["--epochs", "2", "--n-samples",
                                        "256", "--fail-at", "0"], 2)()
    assert rcs == [1, 1], outs
    assert _verdicts(str(tmp_path), 2) == ("fail", ["fail", "fail"])
    for out in outs:
        assert "fault injection: --fail-at 0" in out


def test_one_failing_process_fails_every_process(tmp_path):
    """Rank 1 alone fails, at the end of epoch 0, while rank 0 goes on into
    epoch 1 and waits in the gradient reduce for it. Rank 1's aggregation
    times out (2 s) and it exits; its closed connection ends rank 0's
    reduce with an error, so rank 0 fails too: exit 1 on both, every
    verdict fail, and no hang."""
    rcs, outs = _launch(
        str(tmp_path), ["--epochs", "2", "--n-samples", "256"], 2,
        env_by_rank={r: {"TPUDIST_AGGREGATE_TIMEOUT_S": "2"}
                     for r in (0, 1)},
        argv_by_rank={1: ["--fail-at", "0"]})(timeout=60)
    assert rcs == [1, 1], outs
    assert "fault injection: --fail-at 0" in outs[1], outs[1]
    assert "fault injection" not in outs[0], outs[0]
    assert "Epoch  1 finished" in outs[0], outs[0]
    assert "training failed" in outs[0], outs[0]
    assert _verdicts(str(tmp_path), 2) == ("fail", ["fail", "fail"])


def test_slow_peer_times_out_without_hang(tmp_path):
    """Rank 1 trains fine but comes to the verdict 5 s late, past the 2 s
    aggregation timeout: rank 0 writes a fail final verdict and exits 1,
    rank 1 finds its peer gone and exits too; neither hangs (each wait
    is bounded), and both workers' own verdicts say success."""
    rcs, outs = _launch(
        str(tmp_path), ["--epochs", "1", "--n-samples", "256"], 2,
        env_by_rank={0: {"TPUDIST_AGGREGATE_TIMEOUT_S": "2"},
                     1: {"TPUDIST_AGGREGATE_TIMEOUT_S": "2",
                         "TPUDIST_TEST_PRE_VERDICT_SLEEP_S": "5"}})(
        timeout=60)
    assert rcs[0] == 1 and rcs[1] != 0, (rcs, outs)
    assert "verdict aggregation timed out after 2.0s" in outs[0], outs[0]
    assert _verdicts(str(tmp_path), 2) == ("fail", ["success", "success"])


# ------------------------------------------------------------------ units

@pytest.mark.parametrize("process_count", [1, 2, 4])
def test_epoch_shards_match_jax(process_count, monkeypatch):
    """Each process's shard equals the JAX package's, and the shards of
    the processes tile every global batch in rank order."""
    monkeypatch.setattr(tdata, "reference_permutation",
                        jdata.epoch_permutation)
    kw = dict(batch_size=16, seed=3, epoch=1, process_count=process_count)
    shards = []
    for pi in range(process_count):
        t = tdata._epoch_index(100, process_index=pi, **kw)
        assert np.array_equal(t, jdata._epoch_index(100, process_index=pi,
                                                    **kw))
        assert t.shape == (6, 16 // process_count)
        shards.append(t)
    perm = jdata.epoch_permutation(3, 1, 100)[:96].reshape(6, 16)
    assert np.array_equal(np.concatenate(shards, axis=1), perm)


@pytest.mark.parametrize("flag", [
    ["--tensor", "2", "--pipe", "2"], ["--context", "2", "--pipe", "2"],
    ["--pipe", "2"],
])
def test_other_mesh_axes_stay_refused(flag):
    # --tensor and --context are carried (the first two cases are refused
    # for their pipe axis)
    tconfig.check_supported(tconfig.parse_args(["--tensor", "2"]))
    tconfig.check_supported(tconfig.parse_args(["--tensor", "2",
                                                "--context", "2"]))
    with pytest.raises(ValueError,
                       match="data x fsdp x expert x tensor x context mesh "
                             "only.*ROADMAP Queue A item 8b$"):
        tconfig.check_supported(tconfig.parse_args(flag))


def test_the_moe_carries_the_expert_axis():
    """``--expert`` passes the check for the MoE, beside the other
    carried axes (``--context`` among them); ``--pipe`` beside it is
    still refused."""
    for flag in (["--expert", "2"], ["--data", "2", "--fsdp", "2",
                                     "--expert", "2", "--tensor", "2"],
                 ["--expert", "2", "--context", "2"]):
        tconfig.check_supported(tconfig.parse_args(
            ["--model", "moe"] + flag))
    with pytest.raises(ValueError, match="ROADMAP Queue A item 8b$"):
        tconfig.check_supported(tconfig.parse_args(
            ["--model", "moe", "--expert", "2", "--pipe", "2"]))


@pytest.mark.parametrize("argv,env", [
    (["--grad-overlap", "bucketed"], {}),
    (["--cross-slice", "hierarchical"], {}),
    ([], {"TPUDIST_GRAD_OVERLAP": "bucketed"}),
])
def test_overlapped_and_hierarchical_reduces_stay_refused(argv, env,
                                                          monkeypatch):
    """The overlap plane's flags (and their twins) are carried: the
    config check passes them, and the replicated step takes them. They
    stay refused only where the JAX package refuses them: on a mesh that
    splits more than the data axis (``--data 2 --fsdp 2``), with the
    JAX engine's message."""
    from tpudist import engine as jengine
    from tpudist.parallel import build_mesh
    from tpudist_torch import engine as tengine
    from tpudist_torch.parallel import mesh as tmesh

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    tconfig.check_supported(tconfig.parse_args(argv))
    sharded = argv + ["--data", "2", "--fsdp", "2"]
    jcfg = jconfig.parse_args(sharded)
    with pytest.raises(ValueError) as want:
        jengine.make_train_step(jcfg, build_mesh(
            jcfg.parallel, devices=jax.devices()[:4]))
    grid = tmesh.rank_grid(tconfig.parse_args(sharded).parallel, 4)
    with pytest.raises(ValueError) as got:
        tengine.grad_overlap(tconfig.parse_args(sharded), grid)
    assert str(got.value) == str(want.value)
    assert "requires the explicit-collective pure-DP mesh" in str(got.value)


def test_the_env_contract_is_read_not_refused():
    for name in ("TPUDIST_COORDINATOR", "TPUDIST_NUM_PROCESSES",
                 "TPUDIST_PROCESS_ID", "TPUDIST_AGGREGATE_TIMEOUT_S",
                 "TPUDIST_TEST_PRE_VERDICT_SLEEP_S"):
        assert name not in tconfig.ENV_NOT_CARRIED


def test_initialize_without_the_contract_is_one_process(monkeypatch):
    for name in ("TPUDIST_COORDINATOR", "TPUDIST_NUM_PROCESSES",
                 "TPUDIST_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    ctx = distributed.initialize(device="cpu")
    assert (ctx.process_index, ctx.process_count, ctx.backend) == (0, 1,
                                                                   None)
    assert ctx.is_coordinator and not torch.distributed.is_initialized()
    assert distributed.barrier_bounded("t") is False


@pytest.mark.parametrize("env,match", [
    ({"TPUDIST_NUM_PROCESSES": "2", "TPUDIST_PROCESS_ID": "0"},
     "needs TPUDIST_COORDINATOR"),
    ({"TPUDIST_COORDINATOR": "localhost:1", "TPUDIST_NUM_PROCESSES": "2"},
     "is not a rank of"),
    ({"TPUDIST_COORDINATOR": "localhost:1", "TPUDIST_NUM_PROCESSES": "2",
      "TPUDIST_PROCESS_ID": "2"}, "is not a rank of"),
])
def test_initialize_refuses_a_broken_contract(env, match, monkeypatch):
    for name in ("TPUDIST_COORDINATOR", "TPUDIST_NUM_PROCESSES",
                 "TPUDIST_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match=match):
        distributed.initialize(device="cpu")


def test_a_coordinator_alone_makes_a_group_of_one():
    """A coordinator with one process joins a real group (NCCL at world 1
    on a one-card machine); the step and eval then reduce over it."""
    ctx = distributed.initialize(f"localhost:{_free_port()}", 1, 0,
                                 device="cpu")
    try:
        assert (ctx.process_count, ctx.backend) == (1, "gloo")
        assert distributed.barrier_bounded("t") is False
        assert distributed.host_group() is not None
        t = torch.tensor([3.0])
        from tpudist_torch import engine
        assert engine.pmean([t])[0].item() == 3.0
    finally:
        distributed.shutdown()
    assert not torch.distributed.is_initialized()
    assert distributed.host_group() is None


def test_two_nccl_ranks_on_one_card_are_refused():
    distributed.check_one_card_a_rank(["GPU-a", "GPU-b"], "nccl")
    distributed.check_one_card_a_rank(["GPU-a", "GPU-a"], "gloo")
    with pytest.raises(ValueError, match="ranks 0 and 2 would share one "
                                         "card"):
        distributed.check_one_card_a_rank(["GPU-a", "GPU-b", "GPU-a"],
                                          "nccl")


def test_steps_per_sec_per_chip_divides_by_the_chips():
    timer = StepTimer(chips=4)
    timer.elapsed, timer.steps = 2.0, 10
    assert timer.steps_per_sec() == 5.0
    assert timer.steps_per_sec_per_chip() == 1.25
