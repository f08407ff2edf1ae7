"""The port's superstep dispatch (``engine.make_superstep``, the train
CLI's ``--steps-per-dispatch``) against the port's per-step path and
against the JAX package.

* ``config.resolve_steps_per_dispatch`` and
  ``resolve_staging_budget_bytes`` equal the JAX package's, errors
  included (the cases of ``tests/test_superstep.py``).
* The superstep on the CPU (a loop of the step body under the ``[lo,
  hi)`` masking) bitwise equal to per-step dispatch: every epoch's Avg
  and eval loss, every param, both Adam moments and the counters, for
  the MLP at k = 4 (full windows and a partial tail), a tiny
  transformer with the fused head and the bf16 second moment, a resume
  that realigns a window (``lo > 0``), and direct calls of the
  superstep. The five JAX reference reds (ROADMAP Queue C) are in the
  JAX superstep's own masked-step contract, so the port's superstep is
  held to its own per-step path, and to the JAX CLI's Avg loss within
  f32 1e-5.
* The train CLI against the JAX CLI at the auto k: the Avg and eval
  losses within f32 1e-5, and the ``kind=timing`` record carrying the
  JAX package's dispatch, staging and tuning keys with the same k.
* Adam from the device-side step scalars (``StepScalars``) bitwise equal
  to the host-scalar update the port ran before them, in f32 and with
  the bf16 moments.
"""

import json
import shutil

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
from tpudist_torch import engine as tengine
from tpudist_torch import train as ttrain
from tpudist_torch.models import mlp as tmlp

torch.set_num_threads(1)

# (fields of both packages' TrainConfig, the k or the error's words): the
# cases of tests/test_superstep.py::TestResolveStepsPerDispatch
RESOLVE_CASES = [
    ({}, 25),
    ({"log_every": 100, "ckpt_every_steps": 10}, 10),
    ({"log_every": 1}, 1),
    ({"fail_at": 0}, 1),
    ({"log_every": 0}, tconfig.SUPERSTEP_CAP),
    ({"steps_per_dispatch": 7, "log_every": 100}, "log-every"),
    ({"steps_per_dispatch": 4, "log_every": 8, "ckpt_every_steps": 6},
     "ckpt-every-steps"),
    ({"steps_per_dispatch": 4, "log_every": 8, "fail_at": 1}, "fail-at"),
    ({"steps_per_dispatch": -1}, "steps-per-dispatch"),
    ({"steps_per_dispatch": 4, "log_every": 8, "ckpt_every_steps": 16}, 4),
    ({"log_every": 12, "ckpt_every_steps": 18}, 6),
    ({"log_every": 64}, 32),
]


@pytest.mark.parametrize("fields,want", RESOLVE_CASES)
def test_resolve_steps_per_dispatch_equals_jax(fields, want):
    jcfg = jconfig.TrainConfig(**fields)
    tcfg = tconfig.TrainConfig(**fields)
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want) as jerr:
            jconfig.resolve_steps_per_dispatch(jcfg)
        with pytest.raises(ValueError, match=want) as terr:
            tconfig.resolve_steps_per_dispatch(tcfg)
        assert str(terr.value) == str(jerr.value)
        return
    assert tconfig.resolve_steps_per_dispatch(tcfg) == \
        jconfig.resolve_steps_per_dispatch(jcfg) == want


def test_profiling_forces_per_step_in_jax_and_is_refused_by_the_port():
    """The JAX resolver's third per-step case, full-run profiling, which
    the port refused until it carried ``--profile-dir``: in both
    packages it resolves to per-step dispatch with autotuning off, while
    the windowed capture keeps the superstep and the tuner."""
    for argv in (["--profile-dir", "/tmp/prof"],
                 ["--profile-dir", "/tmp/prof", "--log-every", "4",
                  "--autotune", "probe"]):
        t, j = tconfig.parse_args(argv), jconfig.parse_args(argv)
        assert tconfig.resolve_steps_per_dispatch(t) == \
            jconfig.resolve_steps_per_dispatch(j) == 1
        assert tconfig.resolve_autotune(t) == jconfig.resolve_autotune(j) \
            == "off"
    argv = ["--profile-window", "2", "--log-every", "4", "--autotune",
            "probe"]
    t, j = tconfig.parse_args(argv), jconfig.parse_args(argv)
    assert tconfig.resolve_steps_per_dispatch(t) == \
        jconfig.resolve_steps_per_dispatch(j) == 4
    assert tconfig.resolve_autotune(t) == jconfig.resolve_autotune(j) \
        == "probe"


@pytest.mark.parametrize("flag,env,state,hbm,temp", [
    (None, None, 0, None, None),
    (None, None, 10**9, 16e9, None),
    (None, None, 3 * 10**9, 16e9, None),      # the floor: 4x state > hbm
    (None, None, 2 * 10**9, 80e9, None),
    (None, None, 2 * 10**9, 80e9, 5 * 10**9),  # a measured margin
    (None, "64", 10**9, 16e9, None),
    (0.5, "64", 10**9, 16e9, None),
    (-1.0, None, 0, 16e9, None),
])
def test_resolve_staging_budget_bytes_equals_jax(flag, env, state, hbm, temp,
                                                monkeypatch):
    if env is None:
        monkeypatch.delenv("TPUDIST_STAGING_BUDGET_MB", raising=False)
    else:
        monkeypatch.setenv("TPUDIST_STAGING_BUDGET_MB", env)
    kw = dict(state_bytes=state, hbm_bytes=hbm, program_temp_bytes=temp)
    jcfg = jconfig.TrainConfig(staging_budget_mb=flag)
    tcfg = tconfig.TrainConfig(staging_budget_mb=flag)
    if flag is not None and flag <= 0:
        for fn, cfg in ((jconfig.resolve_staging_budget_bytes, jcfg),
                        (tconfig.resolve_staging_budget_bytes, tcfg)):
            with pytest.raises(ValueError, match="> 0"):
                fn(cfg, **kw)
        return
    assert tconfig.resolve_staging_budget_bytes(tcfg, **kw) == \
        jconfig.resolve_staging_budget_bytes(jcfg, **kw)
    assert (tconfig.STAGING_STATE_HEADROOM, tconfig.STAGING_FREE_FRACTION,
            tconfig.STAGING_FLOOR_FRACTION) == (
        jconfig.STAGING_STATE_HEADROOM, jconfig.STAGING_FREE_FRACTION,
        jconfig.STAGING_FLOOR_FRACTION)


def test_the_parser_carries_the_dispatch_and_staging_flags():
    cfg = tconfig.parse_args(["--steps-per-dispatch", "4",
                              "--staging-budget-mb", "0.5"])
    assert (cfg.steps_per_dispatch, cfg.staging_budget_mb) == (4, 0.5)


# ---------------------------------------------- superstep vs per-step


def _records(save_dir, kind):
    return [r for r in (json.loads(line) for line in
                        (save_dir / "metrics.jsonl").read_text()
                        .splitlines()) if r["kind"] == kind]


def _final_state(save_dir):
    step = max(int(p.name) for p in save_dir.iterdir() if p.name.isdigit())
    return torch.load(save_dir / str(step) / "state.pt", weights_only=True)


def _assert_same_run(a, b):
    """Two CLI runs' epochs (Avg, eval) and final checkpoints, bitwise."""
    ea, eb = _records(a, "epoch"), _records(b, "epoch")
    assert [(r["avg_loss"], r["eval_loss"], r["steps_counted"])
            for r in ea] == [(r["avg_loss"], r["eval_loss"],
                              r["steps_counted"]) for r in eb]
    sa, sb = _final_state(a), _final_state(b)
    assert (sa["step"], sa["opt_count"], sa["epoch"]) == (
        sb["step"], sb["opt_count"], sb["epoch"])
    for name, t in sa["params"].items():
        assert torch.equal(t, sb["params"][name]), name
    for i, (x, y) in enumerate(zip(sa["mu"] + sa["nu"],
                                   sb["mu"] + sb["nu"])):
        assert x.dtype == y.dtype and torch.equal(x, y), i


MLP = ["--epochs", "2", "--train-batch-size", "64", "--seed", "3",
       "--device", "cpu", "--log-every", "4"]
TINY_TF = ["--model", "transformer", "--vocab-size", "256", "--n-layers",
           "2", "--d-model", "256", "--n-heads", "2", "--d-ff", "256",
           "--seq-len", "128", "--train-batch-size", "4", "--epochs", "2",
           "--device", "cpu", "--log-every", "4"]


@pytest.mark.parametrize("argv,steps", [
    (MLP + ["--n-samples", "512"], 8),                 # full windows
    (MLP + ["--n-samples", "640"], 10),                # + a 2-step tail
    (MLP + ["--n-samples", "64"], 1),                  # a tail alone
    (TINY_TF + ["--n-samples", "24", "--lm-head", "fused",
                "--adam-nu-dtype", "bfloat16"], 6),
    (TINY_TF + ["--n-samples", "24", "--dtype", "bfloat16",
                "--adam-nu-dtype", "bfloat16"], 6),
], ids=["mlp-k4", "mlp-tail", "mlp-short", "tf-fused-bf16nu",
        "tf-bf16-bf16nu"])
def test_superstep_is_bitwise_per_step(argv, steps, tmp_path, capsys):
    assert ttrain.main(argv + ["--steps-per-dispatch", "1", "--save-dir",
                               str(tmp_path / "one")]) == 0
    assert ttrain.main(argv + ["--save-dir", str(tmp_path / "k")]) == 0
    out = capsys.readouterr().out
    assert "tpudist: superstep dispatch k=4 (auto)" in out
    _assert_same_run(tmp_path / "one", tmp_path / "k")
    assert [r["steps_counted"] for r in _records(tmp_path / "k", "epoch")] \
        == [steps, steps]
    assert [r["steps_per_dispatch"] for r in
            _records(tmp_path / "one", "timing") +
            _records(tmp_path / "k", "timing")] == [1, 4]
    # logging lands on superstep edges: the same step records
    assert [(r["step"], r["loss"]) for r in
            _records(tmp_path / "k", "step")] == [
        (r["step"], r["loss"]) for r in _records(tmp_path / "one", "step")]


def test_resume_realigns_a_window(tmp_path, capsys):
    """A per-step run checkpoints every 3 steps; its step-6 checkpoint
    resumed at k = 4 starts inside the second window (``lo = 2``). The
    result equals the uninterrupted per-step run's, bitwise."""
    base = MLP + ["--n-samples", "640", "--epochs", "1"]
    assert ttrain.main(base + ["--steps-per-dispatch", "1", "--save-dir",
                               str(tmp_path / "ref")]) == 0
    save = tmp_path / "resumed"
    assert ttrain.main(base + ["--steps-per-dispatch", "1",
                               "--ckpt-every-steps", "3", "--save-dir",
                               str(save)]) == 0
    for step in (9, 10):
        shutil.rmtree(save / str(step))
    assert ttrain.main(base + ["--steps-per-dispatch", "4", "--resume",
                               "--save-dir", str(save)]) == 0
    out = capsys.readouterr().out
    assert "Resumed at epoch 0, step 6 (global step 6)." in out
    ref, got = _final_state(tmp_path / "ref"), _final_state(save)
    assert (got["step"], got["opt_count"]) == (ref["step"],
                                               ref["opt_count"]) == (10, 10)
    for name, t in ref["params"].items():
        assert torch.equal(t, got["params"][name]), name
    for x, y in zip(ref["mu"] + ref["nu"], got["mu"] + got["nu"]):
        assert torch.equal(x, y)
    # the resumed epoch counts the 4 steps after the resume point
    assert _records(save, "epoch")[-1]["steps_counted"] == 4


def test_superstep_call_masks_and_accumulates_in_step_order():
    """The superstep's contract on direct calls: ``total`` grows by each
    valid step's loss in step order, entries outside [lo, hi) are left
    0, and masked steps change nothing."""
    cfg = tconfig.parse_args(["--device", "cpu", "--train-batch-size", "8",
                              "--seed", "5"])
    dev = torch.device("cpu")
    rng = np.random.default_rng(0)
    slab = (torch.from_numpy(rng.standard_normal((4, 8, 20))
                             .astype(np.float32)),
            torch.from_numpy((rng.random((4, 8)) > 0.5)
                             .astype(np.float32)))
    a = tengine.init_state(cfg, dev)
    b = tengine.init_state(cfg, dev)
    step = tengine.make_train_step(cfg, dev)
    sup = tengine.make_superstep(cfg, dev, 4)
    total, want_losses = None, []
    for i in (1, 2):
        a, loss = step(a, tuple(x[i] for x in slab))
        total = loss if total is None else total + loss
        want_losses.append(loss)
    b, got_total, losses = sup(b, torch.zeros(()), slab, 1, 3)
    assert torch.equal(got_total, total)
    assert torch.equal(losses[1:3], torch.stack(want_losses))
    assert losses[0] == 0 and losses[3] == 0
    assert (b.step, b.opt_state.count) == (a.step, a.opt_state.count) == \
        (2, 2)
    for p, q in zip(a.params.parameters(), b.params.parameters()):
        assert torch.equal(p, q)
    assert sup.programs == 0 and sup.kernel_launches() == dict.fromkeys(
        tengine.kernel_launch_counts(), 0)
    with pytest.raises(ValueError, match="lo < hi"):
        sup(b, got_total, slab, 2, 2)
    with pytest.raises(ValueError, match="exactly k"):
        sup(b, got_total, tuple(x[:3] for x in slab), 0, 3)
    with pytest.raises(ValueError, match=">= 1"):
        tengine.make_superstep(cfg, dev, 0)


# ------------------------------------------------------ against JAX


@pytest.fixture
def jax_reference(monkeypatch):
    """The port draws the JAX package's data, permutation and MLP init."""
    monkeypatch.setattr(tdata, "reference_data", lambda n, f, seed: tuple(
        np.asarray(a) for a in jdata.make_synthetic_data(n, f, seed)))
    monkeypatch.setattr(tdata, "reference_permutation",
                        jdata.epoch_permutation)

    def carried_init(cfg, *, generator):
        jcfg = jconfig.ModelConfig(name="mlp", n_features=cfg.n_features,
                                   hidden=cfg.hidden)
        params = jmlp.init(jax.random.PRNGKey(11), jcfg)
        model = tmlp.MLP(cfg, device=generator.device)
        model.load_state_dict(convert.params_from_jax(
            jax.device_get(params)))
        return model
    monkeypatch.setattr(tmlp, "init", carried_init)


def test_cli_at_auto_k_matches_jax_cli(tmp_path, capsys, jax_reference):
    """Both CLIs at the auto k (25 under --log-every 100): 28 steps an
    epoch, one full window and a 3-step tail; the epochs' losses within
    f32 1e-5 and the timing record's dispatch, staging and tuning keys."""
    argv = ["--epochs", "2", "--n-samples", "1792", "--train-batch-size",
            "64", "--seed", "11"]
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    assert jtrain.main(argv + ["--save-dir", str(jdir)]) == 0
    jout = capsys.readouterr().out
    assert ttrain.main(argv + ["--save-dir", str(tdir), "--device",
                               "cpu"]) == 0
    tout = capsys.readouterr().out
    for line in ("tpudist: superstep dispatch k=25 (auto)",
                 "tpudist: staging budget auto 7629 MB (heuristic 4x-state "
                 "margin)"):
        assert line in jout and line in tout
    jep, tep = _records(jdir, "epoch"), _records(tdir, "epoch")
    assert [r["steps_counted"] for r in tep] == [
        r["steps_counted"] for r in jep] == [28, 28]
    for key in ("avg_loss", "eval_loss"):
        np.testing.assert_allclose([r[key] for r in tep],
                                   [r[key] for r in jep], rtol=0, atol=1e-5)
    jt, tt = _records(jdir, "timing")[0], _records(tdir, "timing")[0]
    keys = ("steps_per_dispatch", "staging_streamed", "staging_slabs",
            "staging_overlap_fraction", "staging_status", "tuning_status")
    assert {k: tt[k] for k in keys} == {k: jt[k] for k in keys}
    assert tt["steps_per_dispatch"] == 25
    # the JAX package counts per-device bytes over its CPU mesh's devices;
    # the port's one device holds the whole local batch
    for key in ("staged_bytes", "staged_bytes_peak"):
        assert tt[key] == jt[key] * jax.device_count()
    for key in ("stage_host_s", "stage_wait_s"):
        assert key in tt and key in jt


# ------------------------------------------ the device-side scalars


def _host_scalar_update(tx, grads, state, params):
    """The port's Adam update as it ran before the device-side scalars:
    the bias corrections as Python floats from the host's count."""
    b1, b2 = tx.b1, tx.b2
    count = state.count + 1
    c1 = float(1 - np.float32(b1) ** np.float32(count))
    c2 = float(1 - np.float32(b2) ** np.float32(count))
    with torch.no_grad():
        for i, (p, g, mu, nu) in enumerate(zip(params, grads, state.mu,
                                               state.nu)):
            if tx.nu_bf16:
                g = g.to(torch.float32)
                m = b1 * mu.to(torch.float32) + (1 - b1) * g
                v = b2 * nu.to(torch.float32) + (1 - b2) * g * g
                p.add_((-tx.lr * (m / c1)) / (torch.sqrt(v / c2) + tx.eps))
                nu.copy_(tengine._stochastic_round_bf16(v, count,
                                                        state.salts[i]))
                mu.copy_(m)
                continue
            b1_mu = float(torch.tensor(b1, dtype=mu.dtype))
            m = (1 - b1) * g + b1_mu * mu.to(torch.float32)
            nu.copy_((1 - b2) * (g * g) + b2 * nu)
            p.add_(-tx.lr * ((m / c1) / (torch.sqrt(nu / c2) + tx.eps)))
            mu.copy_(m)
    state.count = count


@pytest.mark.parametrize("dtype,nu", [("float32", "float32"),
                                      ("bfloat16", "float32"),
                                      ("float32", "bfloat16"),
                                      ("bfloat16", "bfloat16")])
def test_device_scalar_adam_is_bitwise_the_host_scalar_update(dtype, nu):
    rng = np.random.default_rng(2)
    shapes = {"a": (33, 17), "b": (129,), "c": (4, 5, 6)}
    cfg = tconfig.TrainConfig(lr=3e-3, dtype=dtype, adam_nu_dtype=nu)
    init = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in shapes.values()]
    runs = []
    for update in ("device", "host"):
        tx = tengine.make_optimizer(cfg)
        params = [p.clone() for p in init]
        st = tx.init(params, list(shapes))
        grng = np.random.default_rng(3)
        for _ in range(5):
            grads = [torch.from_numpy(grng.standard_normal(s)
                                      .astype(np.float32))
                     for s in shapes.values()]
            if update == "device":
                tx.update(grads, st, params)
            else:
                _host_scalar_update(tx, grads, st, params)
        runs.append((st, params))
    (da, dp), (ha, hp) = runs
    assert da.count == ha.count == 5
    for x, y in zip(dp + da.mu + da.nu, hp + ha.mu + ha.nu):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_step_scalars_fill_rows_from_a_count():
    tx = tengine.make_optimizer(tconfig.TrainConfig())
    sc = tengine.StepScalars(tx, 4, torch.device("cpu"))
    sc.fill(7)
    for i in range(4):
        count, c1, c2 = sc.row(i)
        t = 7 + i
        assert int(count) == t
        assert c1.item() == float(1 - np.float32(0.9) ** np.float32(t))
        assert c2.item() == float(1 - np.float32(0.999) ** np.float32(t))
    sc.fill(100, 1)
    assert [int(c) for c in sc.count] == [100, 8, 9, 10]
