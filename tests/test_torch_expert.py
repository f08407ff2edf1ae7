"""The port's expert parallelism (the expert half of
``engine.ShardLayout``, ``StepGroups``'s expert group and
``models/moe.py::_moe_ffn``) against the JAX package's MoE on the same
meshes (``tests/test_moe.py:112-134,235-256``).

* The step body on four gloo ranks from the JAX package's initial params
  on its global batches, 3 steps at each mesh below, against the JAX
  step at the same mesh on four virtual CPU devices and the JAX
  single-device step, at ``tests/test_moe.py``'s MODEL (V 128, L 2, d
  32, h 2, kv 2, d_ff 48, seq 16, 4 experts, top 2, cf 2.0), batch 8,
  f32 (``tests/_torch_moe_mesh.py``): each step's loss within rtol 2e-5
  (``tests/test_moe.py:133``), each rank's shard of Adam's ``mu`` and
  ``nu`` and of every param's change within 3e-3 in 2-norm of the JAX
  state's region:

  - ``expert 4``, ``data 2 x expert 2`` (its group of 128 tokens over
    two batch places), ``fsdp 2 x expert 2`` and ``tensor 2 x expert
    2`` (the experts' partials reduced over the expert x tensor ranks of
    a place in one call);
  - GQA (h 4, kv 2) at ``expert 4``, at rtol / atol 2e-4
    (``tests/test_moe.py:256``);
  - 6 experts at ``expert 4``: the experts dim does not divide, so the
    weights stay whole on every rank (no expert group) and the losses
    are the same.

  Each rank holds its expert coordinate's experts and a state below the
  whole one.
* A one-rank expert group (a one-rank gloo mesh whose expert group the
  layout takes): bitwise the replicated body after 4 steps (losses,
  params, ``mu``, ``nu``, the eval), its three operators a layer issued.
* ``--expert 2`` for a model that is not the MoE: the JAX package's
  refusal and message, from ``check_supported``.
"""


import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_moe_mesh import GQA, GQA_TOL, MODEL, check_run, jax_body_runs
from _torch_moe_mesh import with_flags
from tpudist import config as jconfig
from tpudist import engine as jengine
from tpudist.parallel import build_mesh
from tpudist_torch import config as tconfig
from tpudist_torch import data as tdata
from tpudist_torch import engine as tengine
from tpudist_torch.parallel import mesh as tmesh
from _torch_ranks import free_port as _free_port

torch.set_num_threads(1)

CPU = torch.device("cpu")
RUNS = {
    "e4": MODEL + ["--expert", "4"],
    "d2e2": MODEL + ["--data", "2", "--expert", "2"],
    "f2e2": MODEL + ["--fsdp", "2", "--expert", "2"],
    "t2e2": MODEL + ["--tensor", "2", "--expert", "2"],
    "gqa_e4": GQA + ["--expert", "4"],
    "six_e4": with_flags(MODEL, n_experts=6) + ["--expert", "4"],
}


@pytest.fixture(scope="module")
def expert_runs(tmp_path_factory, devices8):
    return jax_body_runs(tmp_path_factory.mktemp("expert_body"), devices8,
                         RUNS)


@pytest.mark.parametrize("tag", list(RUNS))
def test_expert_body_matches_jax_on_four_ranks(expert_runs, tag):
    got, want = expert_runs
    if tag.startswith("gqa"):
        check_run(got, want, tag, GQA_TOL, GQA_TOL)
    else:
        check_run(got, want, tag)


@pytest.mark.parametrize("tag,ways", [("e4", 4), ("d2e2", 2),
                                      ("f2e2", 2), ("t2e2", 2),
                                      ("gqa_e4", 4)])
def test_each_rank_holds_its_experts(expert_runs, tag, ways):
    """The expert weights' experts dim splits ``expert`` ways, rank
    ``r`` holding the experts of its expert coordinate; the other
    params are not split over ``expert``; a rank's state below the
    whole state's."""
    got, _ = expert_runs
    grid = tmesh.rank_grid(tconfig.parse_args(RUNS[tag]).parallel, 4)
    axis = tmesh.AXIS_NAMES.index("expert")
    for r, ranks in enumerate(got):
        mine = ranks[tag]
        assert mine["expert_group"]
        e = int(np.argwhere(grid.mesh == r)[0][axis])
        n_e = 4 // ways
        for name, span in zip(mine["names"], mine["spans"]):
            if name in ("layers.w_gate", "layers.w_up", "layers.w_down"):
                assert span[1] == (e * n_e, (e + 1) * n_e), (r, name)
            elif name == "layers.w_router":
                assert span[2] == (0, 4)
    whole = tengine.state_bytes_per_device(tengine.init_state(
        tconfig.parse_args(RUNS[tag] + ["--device", "cpu"]), CPU))
    for g in got:
        assert g[tag]["bytes"] < whole


def test_experts_that_expert_does_not_divide_stay_whole(expert_runs):
    """6 experts at ``expert 4``: the sanitized spec drops the axis, so
    every rank holds every expert and computes them alike, and no
    expert collective is issued."""
    got, _ = expert_runs
    for g in got:
        mine = g["six_e4"]
        assert not mine["expert_group"]
        for name, span, t in zip(mine["names"], mine["spans"],
                                 mine["params"]):
            if name in ("layers.w_gate", "layers.w_up", "layers.w_down"):
                assert t.shape[1] == 6 and span[1] == (0, 6)


# --------------------------------------------- one rank, in-process


@pytest.fixture
def world1():
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        yield tmesh.build_mesh(tconfig.ParallelConfig(), device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_one_rank_expert_group_is_bitwise_the_replicated_body(world1):
    cfg = tconfig.parse_args(MODEL + ["--device", "cpu", "--dtype",
                                      "bfloat16"])
    a = tengine.init_state(cfg, CPU)
    b = tengine.init_state(cfg, CPU, world1)
    plain = tengine.init_state(cfg, CPU, world1)
    b.layout.expert_group = world1.get_group("expert")
    step_a = tengine.make_train_step(cfg, CPU)
    step_b = tengine.make_train_step(cfg, CPU, world1)
    step_p = tengine.make_train_step(cfg, CPU, world1)
    src = (tdata.make_synthetic_tokens(32, cfg.model.max_seq_len + 1,
                                       cfg.model.vocab_size, 42),)
    slab = tdata.plan_epoch(src, batch_size=8, seed=42, epoch=0).slab(0, 4)
    for i in range(4):
        batch = tdata.to_device(tuple(x[i] for x in slab), CPU)
        a, la = step_a(a, batch)
        b, lb = step_b(b, batch)
        plain, _ = step_p(plain, batch)
        assert torch.equal(la, lb), i
    for x, y in zip([*a.params.parameters(), *a.opt_state.mu,
                     *a.opt_state.nu],
                    [*b.params.parameters(), *b.opt_state.mu,
                     *b.opt_state.nu]):
        assert x.dtype == y.dtype and torch.equal(x, y)
    ev = tengine.make_eval_fn(cfg, CPU, world1)(b, batch)
    assert torch.equal(ev, tengine.make_eval_fn(cfg, CPU)(a, batch))
    # a layer's operators: the tokens' and the combine's entries (their
    # backward all-reduces) and the output's exit
    kinds = [[op for op, _, _ in step.reduced_operands()]
             for step in (step_b, step_p)]
    assert {k: kinds[0].count(k) - kinds[1].count(k)
            for k in set(kinds[0])} == {
        "all_reduce": 3 * cfg.model.n_layers, "all_gather": 0,
        "reduce_scatter": 0}


@pytest.mark.parametrize("model", ["mlp", "transformer"])
def test_expert_axis_is_refused_for_a_model_without_experts(devices8,
                                                            model):
    argv = ["--model", model, "--data", "2", "--expert", "2"]
    jcfg = jconfig.parse_args(argv)
    jmesh = build_mesh(jcfg.parallel, devices=devices8[:4])
    with pytest.raises(ValueError) as want:
        jengine.make_loss_fn(jcfg, jmesh)
    cfg = tconfig.parse_args(argv + ["--device", "cpu"])
    with pytest.raises(ValueError) as got:
        tconfig.check_supported(cfg)
    assert str(got.value) == str(want.value)
    assert "--expert > 1 requires --model moe" in str(got.value)
