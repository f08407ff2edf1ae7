"""The port's train lane (``tpudist_torch.train`` and what it runs)
against the JAX package's.

* The MLP CLI of both packages on the same data, permutation and initial
  params (the JAX package's, handed to the port through
  ``tpudist_torch.data.reference_data`` / ``reference_permutation`` and
  its carried params): every per-epoch Avg and eval loss within f32 1e-5,
  and the same stdout contract lines.
* The CLI's contract on the port alone: ``--fail-at``, ``--resume``
  (epoch and mid-epoch), the verdict files, refused flags, no card.
* A tiny transformer (hd 128, GQA, seq 128 and 256) on carried params:
  loss and every param grad against ``jax.value_and_grad`` of the JAX
  ``engine.make_loss_fn`` (f32 1e-5 of each grad's largest element; bf16
  3e-2). The port's attention runs the flash wrapper's plain versions,
  forward and backward, while the JAX package takes its dense path on the
  CPU.
* Adam against optax, data helpers, configs, and the copies the port
  keeps of JAX-package code (``verdict``, ``pick_lm_head``) pinned to
  their sources (the serve thresholds of ``rules.py`` are pinned in
  ``tests/test_torch_serve.py``).
"""

import argparse
import dataclasses
import json
import re
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpudist import config as jconfig
from tpudist import data as jdata
from tpudist import engine as jengine
from tpudist import train as jtrain
from tpudist import verdict as jverdict
from tpudist.models import mlp as jmlp
from tpudist.models import transformer as jtf
from tpudist.obs import report as jreport
from tpudist_torch import config as tconfig
from tpudist_torch import convert
from tpudist_torch import data as tdata
from tpudist_torch import engine as tengine
from tpudist_torch import train as ttrain
from tpudist_torch import verdict as tverdict
from tpudist_torch.models import mlp as tmlp
from tpudist_torch.models import transformer as ttf
from tpudist_torch.ops.cuda import flash_attention as tfa

torch.set_num_threads(1)

CONTRACT = re.compile(r"^(Epoch +\d+ (finished\. Avg|eval) loss: .*"
                      r"|Training completed\.)$")
MLP_ARGV = ["--epochs", "3", "--n-samples", "512", "--train-batch-size",
            "64", "--steps-per-dispatch", "1", "--seed", "7"]


def _records(save_dir, kind):
    return [r for r in (json.loads(line) for line in
                        (save_dir / "metrics.jsonl").read_text()
                        .splitlines()) if r["kind"] == kind]


def _contract(out: str):
    return [ln for ln in out.splitlines() if CONTRACT.match(ln)]


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
        params = jmlp.init(jax.random.PRNGKey(7), jcfg)
        model = tmlp.MLP(cfg, device=generator.device)
        model.load_state_dict(convert.params_from_jax(
            jax.device_get(params)))
        return model
    monkeypatch.setattr(tmlp, "init", carried_init)


def test_mlp_cli_matches_jax_cli(tmp_path, capsys, jax_reference):
    """Both CLIs on the same data: every epoch's Avg and eval loss, and
    the printed contract lines."""
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    assert jtrain.main(MLP_ARGV + ["--save-dir", str(jdir)]) == 0
    jout = capsys.readouterr().out
    assert ttrain.main(MLP_ARGV + ["--save-dir", str(tdir),
                                   "--device", "cpu"]) == 0
    tout = capsys.readouterr().out
    jep, tep = _records(jdir, "epoch"), _records(tdir, "epoch")
    assert len(tep) == len(jep) == 3
    for key in ("avg_loss", "eval_loss"):
        np.testing.assert_allclose([r[key] for r in tep],
                                   [r[key] for r in jep], rtol=0, atol=1e-5)
    assert [r["steps_counted"] for r in tep] == [8, 8, 8]
    assert _contract(tout) == _contract(jout)
    assert len(_contract(tout)) == 7
    avg = [r["avg_loss"] for r in tep]
    assert avg[-1] < avg[0]


def test_cli_writes_records_and_verdict(tmp_path, capsys, monkeypatch):
    vpath = tmp_path / "v" / "job_status.txt"
    monkeypatch.setenv("TPUDIST_VERDICT_PATH", str(vpath))
    save = tmp_path / "ck"
    assert ttrain.main(["--epochs", "2", "--n-samples", "256", "--device",
                        "cpu", "--save-dir", str(save), "--log-every",
                        "2"]) == 0
    out = capsys.readouterr().out
    assert "Epoch  2 finished. Avg loss:" in out
    assert out.rstrip().endswith("Training completed.")
    assert vpath.read_text() == "success"
    assert (tmp_path / "v" / "job_status.txt.worker0").read_text() \
        == "success"
    kinds = {r["kind"] for r in _records(save, "attempt") +
             _records(save, "step") + _records(save, "epoch") +
             _records(save, "ckpt") + _records(save, "timing")}
    assert kinds == {"attempt", "step", "epoch", "ckpt", "timing"}
    # one checkpoint per epoch end, keyed by the global step
    assert sorted(int(p.name) for p in save.iterdir()
                  if p.name.isdigit()) == [4, 8]
    # the JAX package's offline report folds the port's run
    rep = jreport.build_report(
        jreport.load_metrics(str(save / "metrics.jsonl")), {})
    timing = _records(save, "timing")[0]
    assert rep["run"]["epochs"] == 2
    # 8 steps, dispatched k = 2 at a time (auto under --log-every 2): the
    # warm-up takes the first superstep, as the JAX CLI's does
    assert timing["steps_per_dispatch"] == 2
    assert rep["run"]["steps"] == timing["steps"] == 6
    assert rep["run"]["final_avg_loss"] == _records(save, "epoch")[-1][
        "avg_loss"]


def test_fail_at_exits_1_with_a_fail_verdict(tmp_path, capsys, monkeypatch):
    vpath = tmp_path / "s.txt"
    monkeypatch.setenv("TPUDIST_VERDICT_PATH", str(vpath))
    rc = ttrain.main(["--epochs", "3", "--fail-at", "0", "--n-samples",
                      "128", "--device", "cpu", "--save-dir",
                      str(tmp_path / "ck")])
    captured = capsys.readouterr()
    assert rc == 1
    assert vpath.read_text() == "fail"
    assert "Epoch  1 finished" in captured.out
    assert "Epoch  2 finished" not in captured.out
    assert "fault injection: --fail-at 0" in captured.err


def test_resume_continues_the_trajectory(tmp_path, capsys):
    base = ["--n-samples", "256", "--device", "cpu"]
    assert ttrain.main(base + ["--epochs", "4", "--save-dir",
                               str(tmp_path / "a")]) == 0
    assert ttrain.main(base + ["--epochs", "2", "--save-dir",
                               str(tmp_path / "b")]) == 0
    capsys.readouterr()
    assert ttrain.main(base + ["--epochs", "4", "--resume", "--save-dir",
                               str(tmp_path / "b")]) == 0
    out = capsys.readouterr().out
    assert "Resumed at epoch 2, step 0 (global step 8)." in out
    assert "Epoch  3 finished" in out and "Epoch  1 finished" not in out
    a = [r["avg_loss"] for r in _records(tmp_path / "a", "epoch")]
    b = [r["avg_loss"] for r in _records(tmp_path / "b", "epoch")]
    assert b == a      # the same trajectory, bitwise, on the CPU


def test_mid_epoch_resume_reproduces_the_params(tmp_path):
    """Keep only the mid-epoch save at step 6 of 8, resume: the final
    params equal the uninterrupted run's."""
    base = ["--epochs", "1", "--n-samples", "64", "--train-batch-size", "8",
            "--lr", "1e-2", "--device", "cpu"]
    assert ttrain.main(base + ["--save-dir", str(tmp_path / "a")]) == 0
    assert ttrain.main(base + ["--save-dir", str(tmp_path / "b"),
                               "--ckpt-every-steps", "3"]) == 0
    assert sorted(int(p.name) for p in (tmp_path / "b").iterdir()
                  if p.name.isdigit()) == [3, 6, 8]
    import shutil
    shutil.rmtree(tmp_path / "b" / "8")
    assert ttrain.main(base + ["--save-dir", str(tmp_path / "b"),
                               "--resume"]) == 0
    load = lambda d: torch.load(d / "8" / "state.pt",   # noqa: E731
                                weights_only=True)
    a, b = load(tmp_path / "a"), load(tmp_path / "b")
    assert a["step"] == b["step"] == 8
    for name, t in a["params"].items():
        assert torch.equal(t, b["params"][name]), name


def test_resume_auto_starts_fresh_from_a_broken_checkpoint(tmp_path,
                                                            capsys):
    (tmp_path / "5").mkdir()
    (tmp_path / "5" / "state.pt").write_bytes(b"torn")
    argv = ["--epochs", "1", "--n-samples", "128", "--device", "cpu",
            "--save-dir", str(tmp_path)]
    assert ttrain.main(argv + ["--resume", "auto"]) == 0
    assert "resume fail: restore failed, starting fresh" in \
        capsys.readouterr().out
    (tmp_path / "99").mkdir()
    (tmp_path / "99" / "state.pt").write_bytes(b"torn")
    assert ttrain.main(argv + ["--resume"]) == 1


@pytest.mark.parametrize("flag", [
    ["--fsdp", "2"], ["--tensor", "2"], ["--context", "2"], ["--pipe", "2"],
    ["--expert", "2"], ["--model", "moe"], ["--tensor", "4"],
    ["--live", "on"], ["--pipe", "4", "--context", "2"],
])
def test_flags_this_slice_does_not_carry_are_refused(flag):
    cfg = tconfig.parse_args(flag + ["--device", "cpu"])
    with pytest.raises(ValueError, match="ROADMAP Queue A item"):
        ttrain.run(cfg)


TINY_TF_ARGV = ["--model", "transformer", "--vocab-size", "256",
                "--n-layers", "2", "--d-model", "256", "--n-heads", "2",
                "--d-ff", "256", "--seq-len", "128", "--n-samples", "8",
                "--train-batch-size", "4", "--epochs", "1", "--device",
                "cpu"]


@pytest.mark.parametrize("flag", [
    ["--lm-head", "fused"], ["--lm-head", "chunked"], ["--fused-xent"],
    ["--xent-chunks", "4"], ["--adam-nu-dtype", "bfloat16"],
])
def test_head_and_nu_flags_train_a_tiny_transformer(flag, tmp_path, capsys,
                                                    monkeypatch):
    vpath = tmp_path / "job_status.txt"
    monkeypatch.setenv("TPUDIST_VERDICT_PATH", str(vpath))
    assert ttrain.main(TINY_TF_ARGV + flag + ["--save-dir",
                                              str(tmp_path / "ck")]) == 0
    assert "Training completed." in capsys.readouterr().out
    assert vpath.read_text() == "success"


def test_without_a_card_the_default_device_is_an_error(tmp_path,
                                                       monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = ttrain.main(["--epochs", "1", "--save-dir", str(tmp_path)])
    assert rc == 1
    assert "CUDA is not available" in capsys.readouterr().err


def _options(parse_args):
    """Every option string ``parse_args([])`` declares, with its
    add_argument keywords (recorded by wrapping the parser)."""
    seen = {}
    real = argparse.ArgumentParser.add_argument

    def record(self, *names, **kw):
        seen.update(dict.fromkeys(names, kw))
        return real(self, *names, **kw)
    with mock.patch.object(argparse.ArgumentParser, "add_argument", record):
        parse_args([])
    return seen


def _turn_on(kw, off):
    """Command-line words that give an option a value other than its
    default and its ``off`` values."""
    if kw.get("action") == "store_true":
        return []
    default = kw.get("default")
    if kw.get("choices"):
        return [next(c for c in kw["choices"]
                     if c != default and c not in off)]
    step = {int: 3, float: 1.5}.get(kw.get("type"))
    return [str((default or 0) + step)] if step else ["x"]


# the $TPUDIST_ twins of carried options, each read as the JAX package
# reads it (tests/test_torch_staging.py drives the staging budget's,
# tests/test_torch_tune.py the tuner's and the build root's)
# the observability twins (tests/test_torch_obs.py holds their
# resolvers to the JAX package's)
OBS_ENV = {"TPUDIST_TRACE", "TPUDIST_TRACE_DIR", "TPUDIST_STALL_TIMEOUT_S",
           "TPUDIST_HEARTBEAT_DIR", "TPUDIST_HBM_SAMPLE_S"}
# the elastic and chaos twins (tests/test_torch_train_resume.py drives
# them through the CLI)
ELASTIC_ENV = {"TPUDIST_CKPT_MODE", "TPUDIST_REQUEUE_ATTEMPT",
               "TPUDIST_CHAOS"}
ENV_CARRIED = {"TPUDIST_STAGING_BUDGET_MB", "TPUDIST_AUTOTUNE",
               "TPUDIST_AUTOTUNE_CACHE_DIR", "TPUDIST_AUTOTUNE_TRIALS",
               "TPUDIST_COMPILATION_CACHE_DIR"} | OBS_ENV | ELASTIC_ENV


def test_every_jax_train_flag_is_carried_or_refused():
    """Each option string of the JAX train parser is declared by the
    port's (so none is swallowed by parse_known_args). Those the port does
    not carry keep the JAX default, parse at their JAX "off" values, and
    are refused at any other value naming their Queue A item. Every
    ``$TPUDIST_`` variable a JAX help string names is carried
    (``ENV_CARRIED``) or refused when set (``ENV_NOT_CARRIED``), and the
    port pairs a refused one with the same option."""
    jax_opts = _options(jconfig.parse_args)
    port_opts = _options(tconfig.parse_args)
    rows = {flag: row for flag, *row in tconfig.NOT_CARRIED}
    assert set(rows) <= set(jax_opts)
    tconfig.check_supported(tconfig.parse_args([]))
    for opt, kw in jax_opts.items():
        assert opt in port_opts, opt
        named = re.findall(r"\$(TPUDIST_\w+)", kw.get("help", ""))
        assert set(named) <= set(tconfig.ENV_NOT_CARRIED) | ENV_CARRIED, (
            opt, named)
        if opt not in rows:
            continue
        _, off, env, item = rows[opt]
        assert named == ([env] if env else []), opt
        assert port_opts[opt].get("default") == kw.get("default"), opt
        for value in off:
            tconfig.parse_args([opt, str(value)])
        with pytest.raises(ValueError,
                           match=f"ROADMAP Queue A item {item}$"):
            tconfig.parse_args([opt, *_turn_on(kw, off)])


ENV_ON = {"TPUDIST_LIVE": "on",
          "TPUDIST_GRAD_OVERLAP": "bucketed",
          "TPUDIST_CROSS_SLICE": "hierarchical", "TPUDIST_NO_FLASH": "1"}


# the observability twins were refused until the port carried them:
# each is now read as the JAX package reads it
OBS_ENV_READ = {"TPUDIST_TRACE": ("off", lambda c: tconfig.resolve_trace(c)[0],
                                  False),
                "TPUDIST_TRACE_DIR": ("traces",
                                      lambda c: tconfig.resolve_trace(c)[1],
                                      "traces"),
                "TPUDIST_STALL_TIMEOUT_S": (
                    "7", lambda c: tconfig.resolve_obs(c)[0], 7.0),
                "TPUDIST_HEARTBEAT_DIR": (
                    "beats", lambda c: tconfig.resolve_obs(c)[1], "beats"),
                "TPUDIST_HBM_SAMPLE_S": (
                    "0", lambda c: tconfig.resolve_obs(c)[2], 0.0)}


# the JAX CLIs' platform switch, read as the default of --device
# (tests/test_torch_platform.py drives both CLIs with it)
ENV_READ = {**OBS_ENV_READ,
            "TPUDIST_PLATFORM": ("gpu", lambda c: tconfig.parse_args(
                []).device, "cuda"),
            # the elastic and chaos twins, refused until the port carried
            # them (ROADMAP Queue A item 10)
            "TPUDIST_CKPT_MODE": ("sharded", tconfig.resolve_ckpt_mode,
                                  "sharded"),
            "TPUDIST_REQUEUE_ATTEMPT": ("2", tconfig.resolve_requeue_attempt,
                                        2),
            "TPUDIST_CHAOS": ("kill@0:1", tconfig.resolve_chaos, "kill@0:1"),
            "TPUDIST_TEST_KILL": ("0:5:1", lambda c: _kill_spec(), (0, 5, 1))}


def _kill_spec():
    """The train CLI's parse of TPUDIST_TEST_KILL, fresh (it caches)."""
    with mock.patch.object(ttrain, "_KILL_SPEC", None):
        return ttrain._test_kill_spec()


@pytest.mark.parametrize("name", sorted(set(tconfig.ENV_NOT_CARRIED)
                                        | set(ENV_READ)))
def test_env_twins_of_features_not_carried_are_refused(name, monkeypatch):
    """Each variable is tolerated unset and at the values that leave its
    feature off in the JAX package, and refused by ``run`` at any other,
    naming its Queue A item. ``TPUDIST_NO_FLASH`` is refused too: the
    port's attention always takes its flash kernels. The observability
    twins and ``TPUDIST_PLATFORM``, which the port carries, pass
    ``check_supported`` and are read by its resolvers."""
    cfg = tconfig.parse_args(["--device", "cpu"])
    if name in ENV_READ:
        value, read, want = ENV_READ[name]
        monkeypatch.setenv(name, value)
        tconfig.check_supported(cfg)
        assert read(cfg) == want
        return
    off, item = tconfig.ENV_NOT_CARRIED[name]
    for value in off:
        if value is not None:
            monkeypatch.setenv(name, str(value).upper())
            tconfig.check_supported(cfg)
    monkeypatch.setenv(name, ENV_ON.get(name, "3"))
    want = ("its attention always takes the flash kernels$" if item is None
            else f"ROADMAP Queue A item {item}$")
    with pytest.raises(ValueError, match=want):
        ttrain.run(cfg)


def test_unknown_flags_are_tolerated():
    cfg = tconfig.parse_args(["--epochs", "1", "--deepspeed",
                              "--distributed-backend", "nccl"])
    assert cfg.epochs == 1


def test_configs_and_parse_args_match_jax():
    for tcls, jcls in ((tconfig.DataConfig, jconfig.DataConfig),
                       (tconfig.ModelConfig, jconfig.ModelConfig),
                       (tconfig.ParallelConfig, jconfig.ParallelConfig)):
        for f in dataclasses.fields(tcls):
            assert getattr(tcls(), f.name) == getattr(jcls(), f.name), f
    shared = [f.name for f in dataclasses.fields(tconfig.TrainConfig)
              if f.name not in ("device", "data", "model", "parallel")]
    assert tconfig.flagship_model_config(1024) == tconfig.ModelConfig(
        **{f.name: getattr(jconfig.flagship_model_config(1024), f.name)
           for f in dataclasses.fields(tconfig.ModelConfig)})
    for argv in ([], ["--model", "transformer", "--seq-len", "256",
                      "--n-heads", "4", "--n-kv-heads", "2", "--dtype",
                      "bfloat16", "--resume", "--fail-at", "1",
                      "--grad-accum-steps", "2", "--remat",
                      "--ckpt-every-steps", "5", "--lm-head", "plain"]):
        t, j = tconfig.parse_args(argv), jconfig.parse_args(argv)
        for name in shared:
            assert getattr(t, name) == getattr(j, name), (argv, name)
        for sub in ("data", "model", "parallel"):
            tsub = getattr(t, sub)
            for f in dataclasses.fields(tsub):
                assert getattr(tsub, f.name) == getattr(getattr(j, sub),
                                                        f.name), (argv, f)


# ------------------------------------------------------------ transformer

def _tiny(seq: int):
    return jconfig.ModelConfig(name="transformer", vocab_size=256,
                               n_layers=2, d_model=256, n_heads=2,
                               n_kv_heads=1, d_ff=512, max_seq_len=seq)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 3e-2)])
@pytest.mark.parametrize("seq", [128, 256])
def test_transformer_loss_and_grads_match_jax(seq, dtype, tol, monkeypatch):
    jm = _tiny(seq)
    tm = tconfig.ModelConfig(**{f.name: getattr(jm, f.name) for f in
                                dataclasses.fields(tconfig.ModelConfig)})
    jparams = jtf.init(jax.random.PRNGKey(0), jm)
    model = ttf.Transformer(tm, device="cpu")
    model.load_state_dict(convert.params_from_jax(jax.device_get(jparams)))
    tokens = jdata.make_synthetic_tokens(4, seq + 1, 256, seed=3)
    assert np.array_equal(tdata.make_synthetic_tokens(4, seq + 1, 256, 3),
                          np.asarray(tokens))

    calls = []
    real_bwd = tfa._bwd_plain
    monkeypatch.setattr(tfa, "_bwd_plain",
                        lambda *a: calls.append(1) or real_bwd(*a))

    jcfg = jconfig.TrainConfig(model=jm, lm_head="plain", dtype=dtype)
    tcfg = tconfig.TrainConfig(model=tm, lm_head="plain", dtype=dtype)
    jloss, jgrads = jax.value_and_grad(jengine.make_loss_fn(jcfg))(
        jparams, (jnp.asarray(tokens),))
    tloss = tengine.make_loss_fn(tcfg)(
        model, (torch.from_numpy(np.asarray(tokens)).long(),))
    names, params = zip(*model.named_parameters())
    tgrads = torch.autograd.grad(tloss, params)
    # every layer's attention went through the flash backward (plain)
    assert len(calls) == (1 if seq <= 512 else 2) * tm.n_layers

    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=tol)
    want = convert.params_from_jax(jax.device_get(jgrads))
    for name, g in zip(names, tgrads):
        w = want[name].float()
        err = (g.float() - w).abs().max() / w.abs().max()
        assert err <= tol, (name, float(err))


def test_remat_gives_the_same_grads():
    tm = tconfig.ModelConfig(**{f.name: getattr(_tiny(128), f.name) for f in
                                dataclasses.fields(tconfig.ModelConfig)})
    model = ttf.init(tm, generator=torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(tdata.make_synthetic_tokens(2, 129, 256)).long()
    grads = []
    for remat in (False, True):
        loss = ttf.loss_fn(model, tokens, tm, dtype=torch.float32,
                           remat=remat)
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_xent_backward_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 3
    targets = rng.integers(0, 11, (2, 5)).astype(np.int32)
    jl, jg = jax.value_and_grad(jtf._xent)(jnp.asarray(logits),
                                           jnp.asarray(targets))
    t = torch.from_numpy(logits).requires_grad_()
    tl = ttf._xent(t, torch.from_numpy(targets))
    tg, = torch.autograd.grad(tl, t)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-7)


def test_head_loss_refuses_the_fused_and_chunked_heads():
    """Both strategies at once, and a chunk count that does not divide
    the sequence, are errors (the JAX package's ``head_loss``)."""
    h, emb = torch.zeros(1, 6, 4), torch.zeros(8, 4)
    t = torch.zeros(1, 6, dtype=torch.long)
    with pytest.raises(ValueError, match="mutually exclusive"):
        ttf.head_loss(emb, h, t, fused_xent=True, xent_chunks=2)
    with pytest.raises(ValueError, match="not divisible by xent_chunks=4"):
        ttf.head_loss(emb, h, t, xent_chunks=4)


def test_pick_lm_head_equals_jax():
    for n_tok in (512, 16384, 10**6):
        for vocab in (256, 32000):
            for dtype_bytes in (2, 4):
                for state in (0.0, 3.2e9, 9e10):
                    for hbm in (16e9, 80e9):
                        args = (n_tok, vocab, 2048, 4, dtype_bytes, state,
                                hbm)
                        assert ttf.pick_lm_head(*args) == \
                            jtf.pick_lm_head(*args), args


def test_auto_head_resolves_plain_at_the_slice_shape(monkeypatch, capsys):
    """BASELINE config #5 at batch 8, seq 2048, f32 on an 80 GB card
    (the chip run's shape) resolves to the plain head in both packages."""
    monkeypatch.setenv("TPUDIST_HBM_BYTES", str(80 * 2**30))
    kw = dict(batch_size=8, model=None)
    jcfg = jconfig.TrainConfig(**{**kw, "model": jconfig.ModelConfig(
        name="transformer")})
    tcfg = tconfig.TrainConfig(**{**kw, "model": tconfig.ModelConfig(
        name="transformer")})
    assert tengine._resolve_lm_head(tcfg) == jengine._resolve_lm_head(
        jcfg, None) == (False, 0)
    # past the budget both packages pick the fused head
    big = dataclasses.replace(tcfg, batch_size=512)
    assert tengine._resolve_lm_head(big) == jengine._resolve_lm_head(
        dataclasses.replace(jcfg, batch_size=512), None) == (True, 0)


# --------------------------------------------------------- engine, data

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adam_steps_match_optax(dtype):
    """Three Adam steps against optax ``adam(lr, mu_dtype=bf16 under
    mixed precision)``, jitted as the JAX trainer runs it: params and both
    moments."""
    rng = np.random.default_rng(1)
    shapes = {"a": (3, 5), "b": (7,)}
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()}
    grads = [{n: rng.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()} for _ in range(3)]
    jtx = jengine.make_optimizer(jconfig.TrainConfig(lr=1e-2, dtype=dtype))
    jp = {n: jnp.asarray(p) for n, p in params.items()}
    jst = jtx.init(jp)
    update = jax.jit(jtx.update)
    for g in grads:
        upd, jst = update({n: jnp.asarray(x) for n, x in g.items()}, jst, jp)
        jp = optax.apply_updates(jp, upd)
    ttx = tengine.make_optimizer(tconfig.TrainConfig(lr=1e-2, dtype=dtype))
    tp = [torch.from_numpy(params[n].copy()) for n in shapes]
    tst = ttx.init(tp, list(shapes))
    for g in grads:
        ttx.update([torch.from_numpy(g[n]) for n in shapes], tst, tp)
    adam = jst[0]
    assert tst.count == int(adam.count) == 3
    for i, n in enumerate(shapes):
        assert tst.mu[i].dtype == (torch.bfloat16 if dtype == "bfloat16"
                                   else torch.float32)
        np.testing.assert_allclose(tp[i].numpy(), np.asarray(jp[n]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tst.mu[i].float().numpy(),
                                   np.asarray(adam.mu[n], np.float32),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tst.nu[i].numpy(),
                                   np.asarray(adam.nu[n]), rtol=1e-6)


def test_grad_accumulation_matches_jax():
    jm = jconfig.ModelConfig()
    jparams = jmlp.init(jax.random.PRNGKey(0), jm)
    model = tmlp.MLP(tconfig.ModelConfig(), device="cpu")
    model.load_state_dict(convert.params_from_jax(jax.device_get(jparams)))
    x, y = (np.asarray(a) for a in jdata.make_synthetic_data(16, 20, 5))
    jl, jg = jengine._microbatch(
        jengine.make_loss_fn(jconfig.TrainConfig()), jparams,
        (jnp.asarray(x), jnp.asarray(y)), 4)
    tl, tg = tengine._microbatch(
        tengine.make_loss_fn(tconfig.TrainConfig()), model,
        (torch.from_numpy(x), torch.from_numpy(y)), 4)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    want = convert.params_from_jax(jax.device_get(jg))
    for (name, _), g in zip(model.named_parameters(), tg):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   atol=1e-6)


def test_mlp_params_carry_name_for_name():
    jparams = jax.device_get(jmlp.init(jax.random.PRNGKey(0),
                                       jconfig.ModelConfig()))
    model = tmlp.MLP(tconfig.ModelConfig(), device="cpu")
    flat = convert.params_from_jax(jparams)
    assert set(flat) == set(model.state_dict()) == {
        "fc1.w", "fc1.b", "fc2.w", "fc2.b"}
    model.load_state_dict(flat)
    x = np.random.default_rng(0).standard_normal((6, 20)).astype(np.float32)
    np.testing.assert_allclose(
        tmlp.apply(model, torch.from_numpy(x)).detach().numpy(),
        np.asarray(jmlp.apply(jparams, jnp.asarray(x))), atol=1e-6)


def test_epoch_plans_match_jax_on_the_same_permutation(monkeypatch):
    monkeypatch.setattr(tdata, "reference_permutation",
                        jdata.epoch_permutation)
    x = np.arange(100 * 3, dtype=np.float32).reshape(100, 3)
    y = np.arange(100, dtype=np.float32)
    for pc, pi in ((1, 0), (2, 1)):
        kw = dict(batch_size=16, seed=3, epoch=2, process_index=pi,
                  process_count=pc)
        tp, jp = tdata.plan_epoch((x, y), **kw), jdata.plan_epoch((x, y),
                                                                  **kw)
        assert tp.n_steps == jp.n_steps == 6
        for a, b in zip(tp.slab(1, 4), jp.slab(1, 4)):
            assert np.array_equal(a, b)
        for a, b in zip(tdata.shard_epoch(x, y, **kw),
                        jdata.shard_epoch(jnp.asarray(x), jnp.asarray(y),
                                          **kw)):
            assert np.array_equal(a, np.asarray(b))
    with pytest.raises(ValueError, match="zero steps"):
        tdata.plan_epoch((x,), batch_size=128, seed=0, epoch=0)


def test_port_draws_its_own_data_deterministically():
    x, y = tdata.make_synthetic_data(50, 6, seed=1)
    assert x.shape == (50, 6) and x.dtype == np.float32
    assert np.array_equal(y, (x[:, :3].sum(1) > 0).astype(np.float32))
    assert np.array_equal(x, tdata.make_synthetic_data(50, 6, seed=1)[0])
    p0 = tdata.epoch_permutation(1, 0, 40)
    assert sorted(p0) == list(range(40))
    assert np.array_equal(p0, tdata.epoch_permutation(1, 0, 40))
    assert not np.array_equal(p0, tdata.epoch_permutation(1, 1, 40))


def test_verdict_copies_equal_jax(tmp_path):
    for ok in (True, False):
        for mod, d in ((tverdict, "t"), (jverdict, "j")):
            mod.write_worker_verdict(str(tmp_path / d / "v.txt"), ok)
            mod.write_final_verdict(str(tmp_path / d / "v.txt"), ok)
        for name in ("v.txt", "v.txt.worker0"):
            assert (tmp_path / "t" / name).read_bytes() == \
                (tmp_path / "j" / name).read_bytes()
        assert tverdict.aggregate_status(ok) == jverdict.aggregate_status(ok)
