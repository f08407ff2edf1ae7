"""The port's gradient overlap plane (``tpudist_torch.parallel.overlap``,
``engine``'s replicated data-parallel step body) against the JAX
package's (``tpudist/parallel/overlap.py``), which
``tests/test_overlap.py`` holds.

* ``plan_buckets`` over the three models' params (``engine.bucket_plan``:
  packed in the JAX leaf order, named in the port's) equals the JAX
  plan over ``jax.tree.leaves(params)``, name for name, at bounds 0,
  1 MB, 4 MB and 1 GB; ``leaf_nbytes``; the vocabularies and the default
  bound equal the JAX package's and the port's config.
* ``resolve_grad_overlap`` equals the JAX resolver: flag > env >
  default, and the same errors.
* ``BucketedMean.hooked`` over one backward on four gloo ranks equals
  ``barrier_mean`` bitwise over grads of mixed dtypes (a param without
  a grad reducing zeros), the ranks' mean.
* On four gloo ranks, the tiny transformer and MoE from the JAX
  package's init on its global batches, 4 steps each: ``off`` equals
  ``bucketed`` at two bounds (many one-param buckets, one bucket)
  bitwise (every loss, every param, Adam's ``mu`` and ``nu``), also
  under ``--grad-accum-steps 2`` and under the k = 2 superstep; the
  bucketed step's losses within rtol 2e-5 of the JAX 4-device DP step
  at ``--grad-overlap bucketed``, its params' change and moments within
  ``STATE_TOL``; the step's collective rows the same in both modes.
* The train CLI at ``--data 4 --grad-overlap bucketed`` on four gloo
  ranks: the JAX line, every rank's verdict, the step losses bitwise
  the ``off`` run's.
* The tuner: ``build_space``'s bucket axis, the heuristic start and
  ``Candidate.apply`` against the JAX package's.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from _torch_moe_mesh import STATE_TOL, with_flags
from _torch_ranks import (jax_cli_reference, launch_cli, records,
                          start_ranks, verdicts)
from tpudist import config as jconfig
from tpudist import data as jdata
from tpudist import engine as jengine
from tpudist.parallel import build_mesh
from tpudist.parallel import overlap as joverlap
from tpudist.tune import search as jsearch
from tpudist_torch import config as tconfig
from tpudist_torch import convert
from tpudist_torch import engine as tengine
from tpudist_torch.models import get_model
from tpudist_torch.parallel import overlap as toverlap
from tpudist_torch.tune import search as tsearch

torch.set_num_threads(1)

MODELS = {
    "mlp": ["--model", "mlp"],
    "transformer": ["--model", "transformer", "--vocab-size", "4096",
                    "--d-model", "128", "--n-layers", "2", "--n-heads", "4",
                    "--d-ff", "512", "--seq-len", "16"],
    "moe": ["--model", "moe", "--vocab-size", "2048", "--d-model", "128",
            "--n-layers", "2", "--n-heads", "4", "--d-ff", "256",
            "--seq-len", "16", "--n-experts", "4"],
}
BOUNDS_MB = (0, 1, 4, 1024)


def _jax_params(argv, devices):
    jcfg = jconfig.parse_args(argv)
    mesh = build_mesh(jconfig.ParallelConfig(data=1), devices=devices[:1])
    return jengine.init_state(jax.random.PRNGKey(0), jcfg, mesh).params


@pytest.mark.parametrize("model", list(MODELS))
def test_plan_buckets_equal_jax_by_name(model, devices8):
    jparams = _jax_params(MODELS[model], devices8)
    paths = jax.tree_util.tree_flatten_with_path(jparams)[0]
    jnames = [".".join(str(k.key) for k in path) for path, _ in paths]
    cfg = tconfig.parse_args(MODELS[model])
    params = get_model(model).init(
        cfg.model, generator=torch.Generator().manual_seed(0))
    names = [n for n, _ in params.named_parameters()]
    assert sorted(names) == sorted(jnames)
    split = False
    for mb in BOUNDS_MB:
        want = joverlap.plan_buckets(jparams, int(mb * 2**20))
        got = tengine.bucket_plan(params, int(mb * 2**20))
        assert [[names[i] for i in b] for b in got.buckets] == \
            [[jnames[i] for i in b] for b in want.buckets], mb
        assert dict(zip(names, got.leaf_bytes)) == dict(
            zip(jnames, want.leaf_bytes))
        assert (got.n_buckets, got.total_bytes, got.bucket_bytes) == (
            want.n_buckets, want.total_bytes, want.bucket_bytes)
        split = split or 1 < got.n_buckets < len(names)
    # a bound that splits the model somewhere short of one leaf a bucket
    assert split or model == "mlp"


@pytest.mark.parametrize("shape,dtype", [((3, 5), torch.float32),
                                         ((7,), torch.bfloat16),
                                         ((), torch.float32)])
def test_leaf_nbytes_and_the_plan_rules_equal_jax(shape, dtype):
    t = torch.zeros(shape, dtype=dtype)
    j = jax.ShapeDtypeStruct(shape, {torch.float32: np.float32,
                                     torch.bfloat16: jax.numpy.bfloat16
                                     }[dtype])
    assert toverlap.leaf_nbytes(t) == joverlap.leaf_nbytes(j)
    leaves = [torch.zeros(n) for n in (10, 300, 20, 20, 5)]
    jleaves = [np.zeros(n, np.float32) for n in (10, 300, 20, 20, 5)]
    for bound in (-1, 0, 100, 200, 4000):
        assert dataclasses.astuple(toverlap.plan_buckets(leaves, bound)) \
            == dataclasses.astuple(joverlap.plan_buckets(jleaves, bound))


def test_vocabularies_and_default_bound_equal_jax():
    assert toverlap.GRAD_OVERLAP_MODES == tconfig.GRAD_OVERLAP_MODES == \
        joverlap.GRAD_OVERLAP_MODES == jconfig.GRAD_OVERLAP_MODES
    assert toverlap.CROSS_SLICE_MODES == tconfig.CROSS_SLICE_MODES == \
        joverlap.CROSS_SLICE_MODES == jconfig.CROSS_SLICE_MODES
    assert toverlap.DEFAULT_BUCKET_MB == tconfig.GRAD_BUCKET_MB_DEFAULT \
        == joverlap.DEFAULT_BUCKET_MB == jconfig.GRAD_BUCKET_MB_DEFAULT
    assert tsearch.GRAD_BUCKET_LADDER_MB == jsearch.GRAD_BUCKET_LADDER_MB


@pytest.mark.parametrize("flag,flag_mb,env,env_mb", [
    (None, None, None, None), ("bucketed", None, None, None),
    (None, None, "bucketed", "8"), ("off", 2.0, "bucketed", "8"),
    (None, 0.5, None, None), ("sideways", None, None, None),
    (None, None, "sideways", None), (None, 0.0, None, None),
    (None, None, None, "-1"),
])
def test_resolve_grad_overlap_equals_jax(flag, flag_mb, env, env_mb,
                                         monkeypatch):
    for name, value in (("TPUDIST_GRAD_OVERLAP", env),
                        ("TPUDIST_GRAD_BUCKET_MB", env_mb)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    j = dataclasses.replace(jconfig.TrainConfig(), grad_overlap=flag,
                            grad_bucket_mb=flag_mb)
    t = dataclasses.replace(tconfig.TrainConfig(), grad_overlap=flag,
                            grad_bucket_mb=flag_mb)
    try:
        want = jconfig.resolve_grad_overlap(j)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tconfig.resolve_grad_overlap(t)
        assert str(got.value) == str(e)
        return
    assert tconfig.resolve_grad_overlap(t) == want


# ----------------------------------------- four gloo ranks, one process

TF = ["--model", "transformer", "--seq-len", "16", "--d-model", "32",
      "--n-layers", "2", "--n-heads", "4", "--d-ff", "64", "--vocab-size",
      "97", "--lm-head", "plain", "--lr", "1e-2", "--seed", "0",
      "--train-batch-size", "8"]
MOE = ["--model", "moe", "--vocab-size", "128", "--n-layers", "2",
       "--d-model", "32", "--n-heads", "2", "--n-kv-heads", "2",
       "--d-ff", "48", "--seq-len", "16", "--n-experts", "4",
       "--expert-top-k", "2", "--capacity-factor", "2.0", "--lm-head",
       "plain", "--lr", "1e-2", "--seed", "0", "--train-batch-size", "8"]
BUCKETED = ["--grad-overlap", "bucketed"]
STEPS = 4
# per model: (tag, flags, superstep k)
VARIANTS = [("off", [], 1),
            ("fine", BUCKETED + ["--grad-bucket-mb", "0.000001"], 1),
            ("one", BUCKETED + ["--grad-bucket-mb", "100"], 1),
            ("accum_off", ["--grad-accum-steps", "2"], 1),
            ("accum", BUCKETED + ["--grad-bucket-mb", "0.001",
                                  "--grad-accum-steps", "2"], 1),
            ("k2_off", [], 2),
            ("k2", BUCKETED + ["--grad-bucket-mb", "0.001"], 2)]

BODY = r"""
import json
from tpudist_torch import config, data, engine
from tpudist_torch.obs import devtime
cpu = torch.device("cpu")
out = ARGS[0]
a = np.load(f"{out}/ref.npz")
res = {}
for model, runs in json.loads(ARGS[1]).items():
    for tag, argv, k in runs:
        cfg = config.parse_args(argv + ["--device", "cpu"])
        state = engine.init_state(cfg, cpu)
        with torch.no_grad():
            for n, p in state.params.named_parameters():
                p.copy_(torch.from_numpy(a[f"{model}.param.{n}"]))
        tokens = torch.from_numpy(a[f"{model}.tokens"])
        rows = tokens.reshape(tokens.shape[0], WORLD, -1,
                              tokens.shape[-1])[:, RANK]
        if k == 1:
            step = engine.make_train_step(cfg, cpu)
            losses = []
            for i in range(rows.shape[0]):
                state, loss = step(state, (rows[i],))
                losses.append(float(loss))
        else:
            step = engine.make_superstep(cfg, cpu, k)
            losses = []
            for w in range(rows.shape[0] // k):
                total = torch.zeros(())
                state, total, ls = step(state, total,
                                        (rows[w * k:(w + 1) * k],), 0, k)
                losses += [float(x) for x in ls]
        res[f"{model}.{tag}"] = {
            "losses": losses,
            "params": [p.detach().clone()
                       for p in state.params.parameters()],
            "names": [n for n, _ in state.params.named_parameters()],
            "mu": [t.clone() for t in state.opt_state.mu],
            "nu": [t.clone() for t in state.opt_state.nu],
            "reduced": devtime.collective_bytes(
                step.reduced_operands())}
# the hooked reducer the step runs, against off: one backward over
# params of mixed dtypes whose grads are this rank's random vectors (the
# last param unused: its bucket reduces zeros), one param a bucket and a
# few a bucket, each over fresh params
from tpudist_torch.parallel import overlap
gen = torch.Generator().manual_seed(RANK)
shapes = ((300, torch.float32), (7, torch.bfloat16), (1000, torch.float32),
          (64, torch.bfloat16), (5, torch.float32))
ws = [torch.randn(n, generator=gen).to(dt) for n, dt in shapes[:-1]]
res["grads"] = [w.clone() for w in ws] + [torch.zeros(5)]
for mode, bound in (("off", 0), ("bucketed", 0), ("bucketed", 2048)):
    ps = [torch.zeros(n, dtype=dt, requires_grad=True) for n, dt in shapes]
    loss = sum((p.float() * w.float()).sum() for p, w in zip(ps, ws))
    if mode == "off":
        gs = torch.autograd.grad(loss, ps, allow_unused=True)
        means = overlap.barrier_mean(
            [torch.zeros_like(p) if g is None else g
             for p, g in zip(ps, gs)], world=WORLD)
    else:
        red = overlap.BucketedMean(overlap.plan_buckets(ps, bound),
                                   world=WORLD)
        with red.hooked(ps):
            torch.autograd.grad(loss, ps, allow_unused=True)
        means = red.finish()
    res[f"mean.{mode}.{bound}"] = means
torch.save(res, f"{out}/rank{RANK}.pt")
"""


@pytest.fixture(scope="module")
def four_rank_runs(tmp_path_factory, devices8):
    out = tmp_path_factory.mktemp("overlap_ranks")
    base = {"transformer": TF, "moe": MOE}
    arrays, runs = {}, {}
    for model, argv in base.items():
        jcfg = jconfig.parse_args(argv)
        m = jcfg.model
        tokens = np.asarray(jdata.make_synthetic_tokens(
            STEPS * jcfg.batch_size, m.max_seq_len + 1, m.vocab_size, 5
        )).reshape(STEPS, jcfg.batch_size, -1)
        arrays[f"{model}.tokens"] = tokens
        init = _jax_params(argv, devices8)
        for k, v in convert.params_from_jax(jax.device_get(init)).items():
            arrays[f"{model}.param.{k}"] = v.numpy()
        runs[model] = [(tag, argv + flags, k) for tag, flags, k in VARIANTS]
    np.savez(out / "ref.npz", **arrays)
    wait = start_ranks(BODY, 4, out, json.dumps(runs))
    # meanwhile the JAX 4-device DP step at --grad-overlap bucketed
    want = {}
    for model, argv in base.items():
        jcfg = jconfig.parse_args(with_flags(
            argv, data=4, grad_overlap="bucketed",
            grad_bucket_mb=0.001))
        mesh = build_mesh(jcfg.parallel, devices=devices8[:4])
        state = jengine.init_state(jax.random.PRNGKey(0), jcfg, mesh)
        step = jengine.make_train_step(jcfg, mesh)
        losses = []
        for batch in arrays[f"{model}.tokens"]:
            state, loss = step(state, (batch,))
            losses.append(float(loss))
        (adam,) = [s for s in jax.tree.leaves(
            state.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
            if hasattr(s, "mu")]
        want[model] = {"losses": losses, **{
            kind: {k: v.numpy() for k, v in convert.params_from_jax(
                jax.device_get(tree)).items()}
            for kind, tree in (("params", state.params), ("mu", adam.mu),
                               ("nu", adam.nu))}}
    wait(240)
    got = [torch.load(out / f"rank{r}.pt", weights_only=True)
           for r in range(4)]
    return got, want, arrays


def _bitwise(a, b):
    return a["losses"] == b["losses"] and all(
        torch.equal(x, y) for kind in ("params", "mu", "nu")
        for x, y in zip(a[kind], b[kind]))


@pytest.mark.parametrize("model", ["transformer", "moe"])
@pytest.mark.parametrize("pair", [("off", "fine"), ("off", "one"),
                                  ("accum_off", "accum"), ("k2_off", "k2"),
                                  ("off", "k2")])
def test_off_equals_bucketed_bitwise_on_four_ranks(four_rank_runs, model,
                                                    pair):
    got, _, _ = four_rank_runs
    for r, ranks in enumerate(got):
        a, b = (ranks[f"{model}.{t}"] for t in pair)
        assert _bitwise(a, b), (r, pair, a["losses"], b["losses"])
        # every rank holds the same replica
        assert _bitwise(b, got[0][f"{model}.{pair[1]}"])
    # the same collectives, a grad a param then the loss, in both modes
    a, b = (got[0][f"{model}.{t}"] for t in pair)
    assert a["reduced"] == b["reduced"]
    assert a["reduced"]["n_collectives"] == len(a["params"]) + 1


@pytest.mark.parametrize("bound", [0, 2048])
def test_hooked_bucketed_mean_equals_off_bitwise(four_rank_runs, bound):
    """``overlap.BucketedMean.hooked`` over one backward (one param a
    bucket, or a few; a param the backward gives no grad reducing
    zeros) is ``barrier_mean``'s per-param all-reduces, bitwise, on
    every rank, in each grad's dtype, and the ranks' mean."""
    got, _, _ = four_rank_runs
    for ranks in got:
        off = ranks["mean.off.0"]
        mine = ranks[f"mean.bucketed.{bound}"]
        assert all(torch.equal(a, b) and a.dtype == b.dtype
                   for a, b in zip(off, mine))
        for i, m in enumerate(off):
            want = sum(g["grads"][i].double() for g in got) / 4
            np.testing.assert_allclose(m.double().numpy(), want.numpy(),
                                       atol=2e-2 if m.dtype ==
                                       torch.bfloat16 else 1e-6)


@pytest.mark.parametrize("model", ["transformer", "moe"])
def test_bucketed_step_matches_the_jax_dp_step(four_rank_runs, model):
    got, want, arrays = four_rank_runs
    w = want[model]
    for ranks in got:
        mine = ranks[f"{model}.k2"]
        np.testing.assert_allclose(mine["losses"], w["losses"], rtol=2e-5)
        for kind in ("params", "mu", "nu"):
            for name, t in zip(mine["names"], mine[kind]):
                t, ref = t.numpy(), w[kind][name]
                if kind == "params":
                    init = arrays[f"{model}.param.{name}"]
                    t, ref = t - init, ref - init
                err = np.linalg.norm(t - ref) / np.linalg.norm(ref)
                assert err <= STATE_TOL, (kind, name, err)
    assert w["losses"][-1] < w["losses"][0]


# ------------------------------------------------------------- the CLI

CLI = ["--model", "transformer", "--seq-len", "16", "--d-model", "32",
       "--n-layers", "2", "--n-heads", "4", "--d-ff", "64", "--vocab-size",
       "97", "--lm-head", "plain", "--n-samples", "32",
       "--train-batch-size", "8", "--epochs", "1", "--log-every", "1",
       "--steps-per-dispatch", "1", "--data", "4"]


def test_train_cli_bucketed_on_four_ranks(tmp_path):
    """``python -m tpudist_torch.train --data 4 --grad-overlap bucketed
    --grad-bucket-mb 0.0078125`` on four gloo ranks: the JAX package's line,
    every verdict success, the step losses bitwise the ``off`` run's."""
    ref = str(tmp_path / "ref.npz")
    jax_cli_reference(ref, CLI)
    waits = {mode: launch_cli(str(tmp_path / mode), CLI + flags, 4, ref)
             for mode, flags in (("off", []), ("bucketed", BUCKETED + [
                 "--grad-bucket-mb", "0.0078125"]))}
    steps = {}
    for mode, wait in waits.items():
        rcs, outs = wait(240)
        assert rcs == [0] * 4, outs[0][-3000:]
        assert verdicts(str(tmp_path / mode), 4) == ("success",
                                                     ["success"] * 4)
        line = ("tpudist: grad overlap bucketed: bucket 0.0078125 MB over "
                "the data axis (reduce dispatched as backward produces each "
                "bucket)")
        assert (line in outs[0]) == (mode == "bucketed")
        steps[mode] = [r["loss"] for r in records(str(tmp_path / mode),
                                                  "step")]
    assert len(steps["off"]) == 4 and steps["off"] == steps["bucketed"]


# ------------------------------------------------------------ the tuner

def _cfgs(**kw):
    return (dataclasses.replace(jconfig.TrainConfig(), **kw),
            dataclasses.replace(tconfig.TrainConfig(), **kw))


@pytest.mark.parametrize("mode,mb,dp", [
    ("off", None, True), ("bucketed", None, True), ("bucketed", 16.0, True),
    ("bucketed", 2.5, True), ("bucketed", 4.0, False)])
def test_build_space_bucket_axis_equals_jax(mode, mb, dp):
    j, t = _cfgs(grad_overlap=mode, grad_bucket_mb=mb, log_every=8,
                 batch_size=16)
    assert tsearch.build_space(t, batch_ways=4, dp_overlap=dp) == \
        jsearch.build_space(j, batch_ways=4, dp_overlap=dp)


@pytest.mark.parametrize("mode,mb", [("off", None), ("bucketed", 2.0)])
def test_heuristic_start_and_apply_equal_jax(mode, mb, monkeypatch):
    from tpudist import tune as jtune
    from tpudist_torch import tune as ttune
    monkeypatch.delenv("TPUDIST_CROSS_SLICE", raising=False)
    j, t = _cfgs(grad_overlap=mode, grad_bucket_mb=mb, log_every=8)
    want = jtune._heuristic_candidate(j)
    got = ttune._heuristic_candidate(t)
    assert got.as_dict() == dataclasses.replace(
        want, pipeline_interleave=1).as_dict()
    cand = tsearch.Candidate(k=2, grad_bucket_mb=16.0,
                             cross_slice="hierarchical")
    jcand = jsearch.Candidate(**cand.as_dict())
    applied, japplied = cand.apply(t), jcand.apply(j)
    for name in ("steps_per_dispatch", "grad_bucket_mb", "cross_slice",
                 "grad_overlap"):
        assert getattr(applied, name) == getattr(japplied, name), name
