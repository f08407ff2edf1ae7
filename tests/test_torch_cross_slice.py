"""The port's cross-slice gradient mean (``--cross-slice``, the slice
ladder of ``tpudist_torch.parallel.overlap``) against the JAX package's
(``tpudist/parallel/overlap.py``), which ``tests/test_cross_slice.py``
holds.

* ``resolve_cross_slice`` equals the JAX resolver (flag > env > flat,
  the same errors).
* On four gloo ranks under ``TPUDIST_SLICE_MAP=2`` (two slices of two
  ranks), the tiny transformer from the JAX package's init on its
  global batches, 3 steps: ``flat`` and ``hierarchical``, each under
  ``--grad-overlap off`` and ``bucketed``, bitwise equal (every loss,
  param and moment); their losses within rtol 2e-5 of the JAX 4-device
  DP step at the same map; the step's collective rows (op, dtype,
  bytes, count, fabric, dcn bytes) equal the JAX ``collective_bytes``
  of the lowered JAX step at the same map and modes, the hierarchical
  cross-slice bytes half the flat ones.
* Without a map, ``hierarchical`` is downgraded to flat with the JAX
  line; on a mesh that splits more than the data axis both flags are
  refused with the JAX engine's messages.
* The tuner's ``build_space`` opens the cross-slice axis on a
  multi-slice data-parallel run only, as the JAX package's does.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from _torch_moe_mesh import with_flags
from _torch_ranks import start_ranks
from tpudist import config as jconfig
from tpudist import data as jdata
from tpudist import engine as jengine
from tpudist.obs import devtime as jdev
from tpudist.parallel import build_mesh
from tpudist.parallel import mesh as jmesh
from tpudist.parallel import sharding as jshd
from tpudist.tune import search as jsearch
from tpudist_torch import config as tconfig
from tpudist_torch import convert
from tpudist_torch import engine as tengine
from tpudist_torch.parallel import mesh as tmesh
from tpudist_torch.tune import search as tsearch

torch.set_num_threads(1)

# every leaf's element count even: the hierarchical shard tiles the two
# slices without padding, so the cross-slice bytes halve exactly
TF = ["--model", "transformer", "--seq-len", "16", "--d-model", "32",
      "--n-layers", "2", "--n-heads", "4", "--d-ff", "64", "--vocab-size",
      "96", "--lm-head", "plain", "--lr", "1e-2", "--seed", "0",
      "--train-batch-size", "8", "--data", "4"]
BUCKET = ["--grad-overlap", "bucketed", "--grad-bucket-mb", "0.03"]
MODES = {"flat": [], "hier": ["--cross-slice", "hierarchical"],
         "bflat": BUCKET, "bhier": BUCKET + ["--cross-slice",
                                             "hierarchical"]}
STEPS = 3


@pytest.mark.parametrize("flag,env", [
    (None, None), ("hierarchical", None), (None, "hierarchical"),
    ("flat", "hierarchical"), ("ring", None), (None, "ring")])
def test_resolve_cross_slice_equals_jax(flag, env, monkeypatch):
    if env is None:
        monkeypatch.delenv("TPUDIST_CROSS_SLICE", raising=False)
    else:
        monkeypatch.setenv("TPUDIST_CROSS_SLICE", env)
    j = dataclasses.replace(jconfig.TrainConfig(), cross_slice=flag)
    t = dataclasses.replace(tconfig.TrainConfig(), cross_slice=flag)
    try:
        want = jconfig.resolve_cross_slice(j)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tconfig.resolve_cross_slice(t)
        assert str(got.value) == str(e)
        return
    assert tconfig.resolve_cross_slice(t) == want


BODY = r"""
import json
from tpudist_torch import config, engine
from tpudist_torch.obs import devtime
cpu = torch.device("cpu")
out = ARGS[0]
a = np.load(f"{out}/ref.npz")
tokens = torch.from_numpy(a["tokens"])
rows = tokens.reshape(tokens.shape[0], WORLD, -1, tokens.shape[-1])[:, RANK]
res = {}
for tag, argv in json.loads(ARGS[1]).items():
    cfg = config.parse_args(argv + ["--device", "cpu"])
    state = engine.init_state(cfg, cpu)
    with torch.no_grad():
        for n, p in state.params.named_parameters():
            p.copy_(torch.from_numpy(a[f"param.{n}"]))
    step = engine.make_train_step(cfg, cpu)
    losses = []
    for i in range(rows.shape[0]):
        state, loss = step(state, (rows[i],))
        losses.append(float(loss))
    res[tag] = {"losses": losses,
                "params": [p.detach().clone()
                           for p in state.params.parameters()],
                "mu": [t.clone() for t in state.opt_state.mu],
                "nu": [t.clone() for t in state.opt_state.nu],
                "coll": devtime.collective_bytes(step.reduced_operands())}
torch.save(res, f"{out}/rank{RANK}.pt")
"""


def _lowered_collectives(jcfg, mesh, toks):
    """The JAX ``collective_bytes`` of the lowered DP step (its body in
    the explicit-collective shard_map, as ``tests/test_cross_slice.py``
    lowers it)."""
    from jax.sharding import PartitionSpec as P

    from tpudist.utils import compat
    state = jengine.init_state(jax.random.PRNGKey(0), jcfg, mesh)
    body, dp, _ = jengine._build_step_body(jcfg, mesh)
    assert dp

    def jitted(state, batch):
        bspecs = jax.tree.map(lambda x: jshd.batch_spec(x.ndim), batch)
        return compat.shard_map(body, mesh=mesh, in_specs=(P(), bspecs),
                                out_specs=(P(), P()),
                                check_vma=False)(state, batch)
    staged = jshd.put_batch(mesh, (toks,))
    text = jax.jit(jitted).lower(state, staged).as_text()
    return jdev.collective_bytes(text, jmesh.mesh_device_slices(mesh))


@pytest.fixture(scope="module")
def sliced_runs(tmp_path_factory, devices8):
    out = tmp_path_factory.mktemp("cross_slice")
    mp = pytest.MonkeyPatch()
    mp.setenv("TPUDIST_SLICE_MAP", "2")
    try:
        jcfg = jconfig.parse_args(TF)
        m = jcfg.model
        tokens = np.asarray(jdata.make_synthetic_tokens(
            STEPS * jcfg.batch_size, m.max_seq_len + 1, m.vocab_size, 5
        )).reshape(STEPS, jcfg.batch_size, -1)
        mesh = build_mesh(jcfg.parallel, devices=devices8[:4])
        init = jengine.init_state(jax.random.PRNGKey(0), jcfg, mesh)
        arrays = {"tokens": tokens, **{
            f"param.{k}": v.numpy() for k, v in convert.params_from_jax(
                jax.device_get(init.params)).items()}}
        np.savez(out / "ref.npz", **arrays)
        wait = start_ranks(BODY, 4, out, json.dumps(
            {tag: TF + flags for tag, flags in MODES.items()}))
        want = {}
        for tag, flags in MODES.items():
            jc = jconfig.parse_args(TF + flags)
            state = jengine.init_state(jax.random.PRNGKey(0), jc, mesh)
            step = jengine.make_train_step(jc, mesh)
            losses = []
            for batch in tokens:
                state, loss = step(state, (batch,))
                losses.append(float(loss))
            want[tag] = {"losses": losses,
                         "coll": _lowered_collectives(jc, mesh, tokens[0])}
        wait(240)
    finally:
        mp.undo()
    got = [torch.load(out / f"rank{r}.pt", weights_only=True)
           for r in range(4)]
    return got, want


def test_flat_equals_hierarchical_bitwise_under_both_overlaps(sliced_runs):
    got, want = sliced_runs
    for r, ranks in enumerate(got):
        base = ranks["flat"]
        for tag in MODES:
            mine = ranks[tag]
            assert mine["losses"] == base["losses"], (r, tag)
            for kind in ("params", "mu", "nu"):
                assert all(torch.equal(x, y) for x, y in
                           zip(mine[kind], base[kind])), (r, tag, kind)
            assert mine["losses"] == got[0][tag]["losses"]
        np.testing.assert_allclose(base["losses"], want["flat"]["losses"],
                                   rtol=2e-5)
    assert want["flat"]["losses"] == want["hier"]["losses"]
    assert base["losses"][-1] < base["losses"][0]


@pytest.mark.parametrize("tag", list(MODES))
def test_collective_rows_equal_the_lowered_jax_step(sliced_runs, tag):
    got, want = sliced_runs
    mine, theirs = got[0][tag]["coll"], want[tag]["coll"]
    assert mine == theirs
    assert {r["fabric"] for r in mine["ops"]} == {"ici", "dcn"}


def test_hierarchical_halves_the_cross_slice_bytes(sliced_runs):
    got, _ = sliced_runs

    def grad_dcn(tag):
        return sum(r["dcn_bytes"] for r in got[0][tag]["coll"]["ops"]
                   if r["bytes"] > 64)
    for flat, hier in (("flat", "hier"), ("bflat", "bhier")):
        assert grad_dcn(flat) == 2 * grad_dcn(hier) > 0
        ops = {r["op"] for r in got[0][hier]["coll"]["ops"]}
        assert ops == {"reduce_scatter", "all_reduce", "all_gather"}


DOWNGRADE = r"""
from tpudist_torch import config, engine
cfg = config.parse_args(json.loads(ARGS[0]) + ["--device", "cpu"])
engine.make_train_step(cfg, torch.device("cpu"))
"""


def test_one_slice_downgrades_hierarchical_with_the_jax_line(devices8,
                                                            capsys,
                                                            monkeypatch):
    monkeypatch.delenv("TPUDIST_SLICE_MAP", raising=False)
    argv = TF + ["--cross-slice", "hierarchical"]
    outs = start_ranks("import json\n" + DOWNGRADE, 4, json.dumps(argv))(
        120)
    jcfg = jconfig.parse_args(argv)
    capsys.readouterr()
    jengine.make_train_step(jcfg, build_mesh(jcfg.parallel,
                                             devices=devices8[:4]))
    (line,) = [ln for ln in capsys.readouterr().out.splitlines()
               if "downgraded" in ln]
    assert line == ("tpudist: --cross-slice hierarchical downgraded to "
                    "flat: single-slice mesh (no cross-slice DCN phase to "
                    "shard)")
    assert [ln for ln in outs[0].splitlines() if "downgraded" in ln] == [
        line]
    assert not any("downgraded" in o for o in outs[1:])


@pytest.mark.parametrize("mesh", [dict(data=2, fsdp=2), dict(tensor=4),
                                  dict(data=2, context=2)])
@pytest.mark.parametrize("flags", [["--grad-overlap", "bucketed"],
                                   ["--cross-slice", "hierarchical"]])
def test_sharded_meshes_refuse_both_flags_with_the_jax_message(
        mesh, flags, devices8):
    argv = with_flags(TF + flags, **{"data": 1, **mesh})
    jcfg = jconfig.parse_args(argv)
    with pytest.raises(ValueError) as want:
        jengine.make_train_step(jcfg, build_mesh(jcfg.parallel,
                                                 devices=devices8[:4]))
    cfg = tconfig.parse_args(argv)
    with pytest.raises(ValueError) as got:
        tengine.grad_overlap(cfg, tmesh.rank_grid(cfg.parallel, 4))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("cross,dp,n_slices", [
    (None, True, 2), ("hierarchical", True, 2), ("hierarchical", True, 1),
    ("flat", False, 2), (None, True, 4)])
def test_build_space_cross_axis_equals_jax(cross, dp, n_slices,
                                           monkeypatch):
    monkeypatch.delenv("TPUDIST_CROSS_SLICE", raising=False)
    kw = dict(cross_slice=cross, grad_overlap="bucketed", log_every=8,
              batch_size=16)
    j = dataclasses.replace(jconfig.TrainConfig(), **kw)
    t = dataclasses.replace(tconfig.TrainConfig(), **kw)
    assert tsearch.build_space(t, batch_ways=4, dp_overlap=dp,
                               n_slices=n_slices) == jsearch.build_space(
        j, batch_ways=4, dp_overlap=dp, n_slices=n_slices)
