"""The port's train lane with ``--model moe`` (``python -m
tpudist_torch.train``) against itself and the JAX package.

* A CPU run of the CLI converges and writes the stdout contract, the
  records and the verdict.
* The superstep (k = 4, a full window and a partial tail an epoch):
  every epoch's Avg and eval loss bitwise the per-step run's.
* Two gloo processes: the first step's loss within f32 1e-5 of the mean
  of the JAX ``loss_fn`` over each process's half of the batch, at the
  same params (the JAX package's shard_map DP routes each shard's own
  batch, ``tpudist/models/moe.py:34-41``), and the replicas bitwise
  equal after 2 steps.
* ``--lm-head auto`` picks what the JAX package picks for the MoE, whose
  train state holds n_experts FFNs a layer, at bench.py's MoE row and a
  few batches and device memories.
* Without a card and without ``--device cpu`` the CLI fails; nothing
  falls back to the CPU. ``--expert`` splits the expert weights'
  experts dim (``tests/test_torch_expert.py`` trains it).
"""

import dataclasses
import json
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudist import config as jconfig
from tpudist import engine as jengine
from tpudist.models import moe as jmoe
from tpudist_torch import config as tconfig
from tpudist_torch import data as tdata
from tpudist_torch import engine as tengine
from tpudist_torch import train as ttrain
from _torch_ranks import free_port as _free_port

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONTRACT = re.compile(r"^(Epoch +\d+ (finished\. Avg|eval) loss: .*"
                      r"|Training completed\.)$", re.M)
# head_dim 128 at seq 128 (the flash wrapper's plain versions run),
# routing in groups of 64 tokens
TINY = ["--model", "moe", "--vocab-size", "256", "--n-layers", "2",
        "--d-model", "256", "--n-heads", "2", "--n-kv-heads", "1",
        "--d-ff", "64", "--seq-len", "128", "--n-experts", "4",
        "--expert-top-k", "2", "--moe-group-size", "64", "--seed", "5",
        "--device", "cpu"]


def _records(save_dir, kind):
    return [r for r in (json.loads(line) for line in
                        (save_dir / "metrics.jsonl").read_text()
                        .splitlines()) if r["kind"] == kind]


def _run(tmp_path, name, argv, monkeypatch):
    save = tmp_path / name
    monkeypatch.setenv("TPUDIST_VERDICT_PATH", str(save / "job_status.txt"))
    assert ttrain.main(argv + ["--save-dir", str(save)]) == 0
    return save


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The CLI per-step and as the superstep (k = 4) over 6 steps an
    epoch, 2 epochs, at --lr 1e-2."""
    root = tmp_path_factory.mktemp("moe_cli")
    argv = TINY + ["--n-samples", "24", "--train-batch-size", "4",
                   "--epochs", "2", "--lr", "1e-2", "--log-every", "4"]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for how, k in (("per_step", "1"), ("superstep", "4")):
            save = _run(root, how, argv + ["--steps-per-dispatch", k], mp)
            out[how] = save
    return out


def test_cli_converges_and_writes_the_records(cli_runs, capsys):
    save = cli_runs["per_step"]
    assert (save / "job_status.txt").read_text() == "success"
    epochs = _records(save, "epoch")
    assert [e["epoch"] for e in epochs] == [0, 1]
    assert epochs[1]["avg_loss"] < epochs[0]["avg_loss"]
    assert all(np.isfinite([e["avg_loss"], e["eval_loss"]]).all()
               for e in epochs)
    steps = _records(save, "step")
    assert steps and steps[-1]["loss"] < steps[0]["loss"]
    timing = _records(save, "timing")[-1]
    assert timing["steps"] > 0 and timing["model_flops_per_step"] > 0
    assert (save / "pod_trace.json").is_file()


def test_superstep_epochs_bitwise_per_step(cli_runs):
    a, b = (_records(cli_runs[h], "epoch") for h in ("per_step",
                                                     "superstep"))
    assert [(e["avg_loss"], e["eval_loss"]) for e in a] == \
        [(e["avg_loss"], e["eval_loss"]) for e in b]
    assert _records(cli_runs["superstep"], "timing")[-1][
        "steps_per_dispatch"] == 4


def test_cli_prints_the_contract(tmp_path, capsys, monkeypatch):
    _run(tmp_path, "run", TINY + ["--n-samples", "8", "--train-batch-size",
                                  "4", "--epochs", "1"], monkeypatch)
    out = capsys.readouterr().out
    assert len(CONTRACT.findall(out)) == 3, out
    assert "model moe" in out


# ------------------------------------------------------- two processes

CHILD = r"""
import sys
for name in ("jax", "jaxlib", "optax", "orbax", "tpudist"):
    sys.modules[name] = None
import torch
torch.set_num_threads(1)
from tpudist_torch import engine, train

dump, argv = sys.argv[1], sys.argv[2:]
states = []
real_init = engine.init_state
engine.init_state = lambda cfg, dev: states.append(real_init(cfg, dev)) \
    or states[-1]
rc = train.main(argv)
if states:
    torch.save(states[-1].params.state_dict(), dump)
sys.exit(rc)
"""

DP_ARGV = TINY + ["--n-samples", "8", "--train-batch-size", "4",
                  "--epochs", "1", "--log-every", "1"]



def _jax_params(state_dict):
    """A port state_dict as the JAX package's nested params dict."""
    out = {}
    for name, t in state_dict.items():
        *path, leaf = name.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(t.numpy())
    return out


def test_two_gloo_processes_route_their_own_halves(tmp_path):
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   TPUDIST_VERDICT_PATH=str(tmp_path / "job_status.txt"),
                   TPUDIST_COORDINATOR=f"localhost:{port}",
                   TPUDIST_NUM_PROCESSES="2", TPUDIST_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", CHILD, str(tmp_path / f"p{rank}.pt"),
             *DP_ARGV, "--save-dir", str(tmp_path / "ck")], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    try:
        outs = [p.communicate(timeout=150)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    assert "2 process(es) (gloo)" in outs[0]

    # the JAX loss_fn on each process's half of step 1, at the seeded
    # params both processes start from, then their mean
    cfg = tconfig.parse_args(DP_ARGV)
    params = tengine.init_state(cfg, torch.device("cpu")).params
    jparams = _jax_params(params.state_dict())
    jm = jconfig.ModelConfig(**{f.name: getattr(cfg.model, f.name) for f
                                in dataclasses.fields(cfg.model)})
    sources = (tdata.make_synthetic_tokens(
        cfg.data.n_samples, cfg.model.max_seq_len + 1,
        cfg.model.vocab_size, cfg.data.seed),)
    halves = []
    for rank in range(2):
        plan = tdata.plan_epoch(sources, batch_size=cfg.batch_size,
                                seed=cfg.seed, epoch=0, process_index=rank,
                                process_count=2)
        tokens = plan.slab(0, 1)[0][0]
        assert tokens.shape == (2, 129)
        halves.append(float(jmoe.loss_fn(jparams, jnp.asarray(tokens), jm,
                                         dtype=jnp.float32)))
    steps = _records(tmp_path / "ck", "step")
    assert [s["step"] for s in steps][:2] == [1, 2]
    np.testing.assert_allclose(steps[0]["loss"], np.mean(halves),
                               rtol=1e-5)
    p0, p1 = (torch.load(tmp_path / f"p{r}.pt", weights_only=True)
              for r in range(2))
    assert set(p0) == set(params.state_dict())
    for name, t in p0.items():
        assert torch.equal(t, p1[name]), name


# ------------------------------------------------------- the auto head

# bench.py's MoE row (bench.py:165-168): V 32000, L 4, d 2048, h 16,
# kv 16, d_ff 2752 an expert, 8 experts, top 2, group 256, seq 512, bf16,
# 32 a chip
BENCH_MOE = dict(name="moe", vocab_size=32000, n_layers=4, d_model=2048,
                 n_heads=16, n_kv_heads=16, d_ff=2752, max_seq_len=512,
                 n_experts=8, expert_top_k=2, moe_group_size=256)


@pytest.mark.parametrize("batch,dtype,nu", [
    (32, "bfloat16", "float32"), (8, "bfloat16", "bfloat16"),
    (8, "float32", "float32"), (64, "bfloat16", "bfloat16")])
@pytest.mark.parametrize("hbm", [12e9, 16e9, 80e9])
def test_auto_head_counts_the_experts_as_jax(batch, dtype, nu, hbm,
                                             monkeypatch):
    monkeypatch.setenv("TPUDIST_HBM_BYTES", str(hbm))
    kw = dict(batch_size=batch, dtype=dtype, adam_nu_dtype=nu)
    jcfg = jconfig.TrainConfig(model=jconfig.ModelConfig(**BENCH_MOE), **kw)
    tcfg = tconfig.TrainConfig(model=tconfig.ModelConfig(**BENCH_MOE), **kw)
    assert tengine._resolve_lm_head(tcfg) == \
        jengine._resolve_lm_head(jcfg, None)


def test_auto_head_at_the_bench_row_picks_fused_where_the_experts_tip_it(
        monkeypatch):
    """At 12 GB the bench row's state with its 541 M expert params leaves
    too little for the logits pair: fused, in both packages; counting
    one FFN a layer would have picked plain."""
    monkeypatch.setenv("TPUDIST_HBM_BYTES", "12e9")
    tcfg = tconfig.TrainConfig(batch_size=32, dtype="bfloat16",
                               model=tconfig.ModelConfig(**BENCH_MOE))
    assert tengine._resolve_lm_head(tcfg) == (True, 0)
    dense = dataclasses.replace(tcfg, model=dataclasses.replace(
        tcfg.model, name="transformer"))
    assert tengine._resolve_lm_head(dense) == (False, 0)


def test_without_a_card_the_moe_does_not_fall_back(tmp_path, monkeypatch,
                                                   capsys):
    monkeypatch.delenv("TPUDIST_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in TINY if a not in ("--device", "cpu")]
    assert ttrain.main(argv + ["--save-dir", str(tmp_path)]) == 1
    assert "CUDA is not available" in capsys.readouterr().err
    assert not (tmp_path / "metrics.jsonl").exists()


def test_expert_axis_splits_the_experts():
    """At ``--expert 2`` each rank's layout keeps half the experts of the
    three expert weights (and of their moments), every other param
    whole; the state a rank holds is below the whole one's."""
    from tpudist_torch.parallel import mesh as tmesh
    cfg = tconfig.parse_args(TINY + ["--expert", "2"])
    cpu = torch.device("cpu")
    whole = tengine.init_state(cfg, cpu)
    shapes = {n: tuple(p.shape) for n, p in whole.params.named_parameters()}
    grid = tmesh.rank_grid(cfg.parallel, 2)
    E = cfg.model.n_experts
    for rank in (0, 1):
        lay = tengine.make_layout(cfg, grid, shapes, rank=rank)
        for i, name in enumerate(lay.names):
            span = lay.span(i)
            if name in ("layers.w_gate", "layers.w_up", "layers.w_down"):
                assert span[1] == (rank * E // 2, (rank + 1) * E // 2)
            else:
                assert span == tuple((0, n) for n in shapes[name]), name
