"""The port's MoE routing over the global batch where a routing group
spans ranks, and its gradient accumulation on a split batch, against the
JAX package's jit+shardings step, which routes every (micro)batch
globally (``tpudist/models/moe.py:34-41``, ``tpudist/engine.py:398-417``).

The step body on four gloo ranks from the JAX package's initial params
on its global batches, at ``tests/test_torch_fsdp_train.py``'s MoE (d 32,
h 4, d_ff 32, V 96, 4 experts, cf 1.25), batch 16, f32, 3 steps (one run
8), against the JAX step at the same mesh on four virtual CPU devices
and at one device (``tests/_torch_moe_mesh.py``): each step's loss within rtol
2e-5, each rank's shard of Adam's ``mu`` and ``nu`` and of every param's
change within 3e-3 in 2-norm of the JAX state's region.

* ``fsdp 4`` with ``--moe-group-size 128``: 64 tokens a rank, the JAX
  package's groups of 128 spanning two ranks (the router probabilities
  all-gathered over the batch ranks, their grads reduce-scattered);
* ``fsdp 4`` at seq 13, batch 4, ``--moe-group-size 12``: 52 global
  tokens have no divisor in [6, 12], so ``group_size`` falls back to one
  global group of 52 over ranks of 13 tokens;
* ``--grad-accum-steps 2`` at ``data 2 x fsdp 2`` and at ``data 2 x
  expert 2``: each rank's rows microbatch-major
  (``data.microbatch_major``), its microbatch ``i`` its share of the
  JAX package's global microbatch ``i``;
* ``data 2 x expert 2`` over 8 steps, where the card's f32 run at that
  mesh parted from one card's (``PERF.md`` §6): the same holds;

and the plan itself: ``data.plan_epoch``'s microbatch-major rows are the
epoch's global microbatches cut by rank, and without accumulation (or
at one process) they are ``_epoch_index``'s (the JAX function's copy,
pinned by ``tests/test_torch_distributed.py``).
"""

import numpy as np
import pytest
import torch

from _torch_moe_mesh import FSDP_MOE, check_run, jax_body_runs, with_flags
from tpudist_torch import data as tdata
from tpudist_torch.models import moe as tmoe

torch.set_num_threads(1)

RUNS = {
    "f4_span": with_flags(FSDP_MOE, moe_group_size=128) + ["--fsdp", "4"],
    "f4_prime": with_flags(FSDP_MOE, seq_len=13, train_batch_size=4,
                           moe_group_size=12) + ["--fsdp", "4"],
    "d2f2_accum": FSDP_MOE + ["--data", "2", "--fsdp", "2",
                              "--grad-accum-steps", "2"],
    "d2e2_accum": FSDP_MOE + ["--data", "2", "--expert", "2",
                              "--grad-accum-steps", "2"],
    "d2e2_8": FSDP_MOE + ["--data", "2", "--expert", "2"],
}
# eight steps, where the card's f32 run at --data 2 --expert 2 parts
# from one card's by 0.026 (PERF.md §6)
STEPS = {"d2e2_8": 8}


@pytest.fixture(scope="module")
def global_runs(tmp_path_factory, devices8):
    return jax_body_runs(tmp_path_factory.mktemp("moe_global"), devices8,
                         RUNS, STEPS)


@pytest.mark.parametrize("tag", list(RUNS))
def test_global_routing_matches_jax_on_four_ranks(global_runs, tag):
    got, want = global_runs
    check_run(got, want, tag)


def test_the_shapes_route_across_ranks():
    """The two routing shapes are the ones that span ranks: 128-token
    groups over 64 tokens a rank, and the near-prime fallback's one
    group of 52 over 13 a rank."""
    from tpudist_torch import config as tconfig
    m = tconfig.parse_args(RUNS["f4_span"]).model
    assert tmoe.group_size(m, 256) == 128
    m = tconfig.parse_args(RUNS["f4_prime"]).model
    assert tmoe.group_size(m, 52) == 52 and 13 % 52


@pytest.mark.parametrize("n_accum,ways", [(2, 2), (2, 4), (4, 2)])
def test_microbatch_major_plan_is_the_global_microbatches(n_accum, ways):
    n, batch = 100, 16
    kw = dict(batch_size=batch, seed=3, epoch=1)
    whole = tdata._epoch_index(n, process_index=0, process_count=1, **kw)
    micro = whole.reshape(6, n_accum, batch // n_accum)
    src = (np.arange(n),)
    for r in range(ways):
        (rows,) = tdata.plan_epoch(src, process_index=r,
                                   process_count=ways, n_accum=n_accum,
                                   **kw).slab(0, 6)
        m = batch // (n_accum * ways)
        assert rows.shape == (6, n_accum * m)
        for i in range(n_accum):
            assert np.array_equal(rows[:, i * m:(i + 1) * m],
                                  micro[:, i, r * m:(r + 1) * m])
    # one process, or no accumulation: _epoch_index's rows
    for pc, na, pi in ((1, n_accum, 0), (ways, 1, ways - 1)):
        (rows,) = tdata.plan_epoch(src, process_index=pi,
                                   process_count=pc, n_accum=na,
                                   **kw).slab(0, 6)
        assert np.array_equal(rows, tdata._epoch_index(
            n, process_index=pi, process_count=pc, **kw))
