"""The port's context parallelism for the MoE (``models/moe.py::
make_cp_loss_fn`` on the engine's context axis) against the JAX
package's (``tpudist/models/moe.py:298-321``, ``tests/test_moe.py:
135-180``).

The step body on four gloo ranks from the JAX package's initial params
on its global batches, 3 steps at each mesh below, against the JAX step
at the same mesh on four virtual CPU devices
(``tests/_torch_moe_mesh.py``), at ``tests/test_moe.py``'s MODEL: each
step's loss within rtol 2e-5, each rank's shard of Adam's ``mu`` and
``nu`` and of every param's change within ``STATE_TOL`` of the JAX
state's region.

* ``data 2 x context 2`` at the default capacity (1.25): each context
  shard routes its own (zigzag-ordered) sequence slice of the batch its
  data ranks split, the JAX program's token-major ``(B_global,
  s_local)`` order, over the data ranks at its context coordinate. That
  is not one device's routing, so the one-device hold is left out: a
  routing group widened to the context ranks would still give plausible
  losses, and only the JAX mesh step tells it apart.
* The same at capacity 4.0, where no pair drops and shard-local routing
  is global routing: also within rtol 2e-4 of one device
  (``tests/test_moe.py:159``).
* ``expert 2 x context 2``: the experts split over the expert ranks of a
  context shard.
"""

import numpy as np
import pytest
import torch

from _torch_moe_mesh import MODEL, check_run, jax_body_runs, with_flags

torch.set_num_threads(1)

RUNS = {
    "moe_d2c2": with_flags(MODEL, capacity_factor=1.25) + [
        "--data", "2", "--context", "2"],
    "moe_d2c2_ample": with_flags(MODEL, capacity_factor=4.0) + [
        "--data", "2", "--context", "2"],
    "moe_e2c2": MODEL + ["--expert", "2", "--context", "2"],
}


@pytest.fixture(scope="module")
def moe_context_runs(tmp_path_factory, devices8):
    return jax_body_runs(tmp_path_factory.mktemp("moe_context_body"),
                         devices8, RUNS)


@pytest.mark.parametrize("tag", list(RUNS))
def test_moe_context_body_matches_jax_on_four_ranks(moe_context_runs, tag):
    got, want = moe_context_runs
    check_run(got, want, tag, one=False)
    if tag == "moe_d2c2_ample":
        for g in got:
            np.testing.assert_allclose(g[tag]["losses"], want[tag]["one"],
                                       rtol=2e-4)


def test_each_context_shard_routes_over_its_data_ranks(moe_context_runs):
    """At the default capacity the JAX step at ``data 2 x context 2``
    is not one device's (routing per context shard drops other pairs),
    and the port's ranks follow the mesh step, not one device's."""
    got, want = moe_context_runs
    w = want["moe_d2c2"]
    mine = got[0]["moe_d2c2"]["losses"]
    assert not np.allclose(w["losses"], w["one"], rtol=2e-5, atol=0)
    assert np.abs(np.subtract(mine, w["losses"])).max() < np.abs(
        np.subtract(mine, w["one"])).max()
