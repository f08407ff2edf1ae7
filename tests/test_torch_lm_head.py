"""The port's LM-head strategies in training, and the bf16 second moment,
against the JAX package's.

* ``head_loss``'s fused and chunked heads on a tiny transformer with
  carried params: the loss and every param grad against
  ``jax.value_and_grad`` of the JAX ``engine.make_loss_fn`` (f32 1e-5 of
  each grad's largest element, bf16 3e-2). The port's fused head runs the
  kernels' plain versions on the CPU, the JAX one the Pallas interpreter.
* ``engine._resolve_lm_head`` on a table of argv lists parsed by both
  packages' ``parse_args``, with the device memory pinned.
* ``engine._stochastic_round_bf16`` bitwise against the JAX package's,
  and three Adam steps with the bf16 second moment against
  ``jax.jit(_adam_low_precision_nu(...).update)``.
* The train CLI of both packages with ``--lm-head fused`` on the same
  data, permutation and initial params: every per-epoch Avg and eval
  loss within f32 1e-5.
"""

import dataclasses
import json

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
from tpudist.models import transformer as jtf
from tpudist_torch import config as tconfig
from tpudist_torch import convert
from tpudist_torch import data as tdata
from tpudist_torch import engine as tengine
from tpudist_torch import train as ttrain
from tpudist_torch.models import transformer as ttf
from tpudist_torch.ops.cuda import fused_xent as tfx

torch.set_num_threads(1)

TINY = jconfig.ModelConfig(name="transformer", vocab_size=256, n_layers=2,
                           d_model=256, n_heads=2, n_kv_heads=1, d_ff=512,
                           max_seq_len=128)


def _tcfg(jm):
    return tconfig.ModelConfig(**{f.name: getattr(jm, f.name) for f in
                                  dataclasses.fields(tconfig.ModelConfig)})


# ----------------------------------------------------------- head strategies

@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 3e-2)])
@pytest.mark.parametrize("lm_head,chunks", [("fused", 0), ("chunked", 2),
                                            ("chunked", 4)])
def test_head_strategies_match_jax(lm_head, chunks, dtype, tol,
                                   monkeypatch):
    jparams = jtf.init(jax.random.PRNGKey(0), TINY)
    model = ttf.Transformer(_tcfg(TINY), device="cpu")
    model.load_state_dict(convert.params_from_jax(jax.device_get(jparams)))
    tokens = jdata.make_synthetic_tokens(4, TINY.max_seq_len + 1, 256, seed=3)

    calls = []
    for name in ("fused_xent_fwd_plain", "fused_xent_bwd_plain"):
        real = getattr(tfx, name)
        monkeypatch.setattr(tfx, name, lambda *a, _n=name, _f=real:
                            calls.append(_n) or _f(*a))

    kw = dict(lm_head=lm_head, xent_chunks=chunks, dtype=dtype)
    jcfg = jconfig.TrainConfig(model=TINY, **kw)
    tcfg = tconfig.TrainConfig(model=_tcfg(TINY), **kw)
    assert tengine._resolve_lm_head(tcfg) == jengine._resolve_lm_head(
        jcfg, None) == ((True, 0) if lm_head == "fused" else (False, chunks))
    jloss, jgrads = jax.value_and_grad(jengine.make_loss_fn(jcfg))(
        jparams, (jnp.asarray(tokens),))
    tloss = tengine.make_loss_fn(tcfg)(
        model, (torch.from_numpy(np.array(tokens)).long(),))
    names, params = zip(*model.named_parameters())
    tgrads = torch.autograd.grad(tloss, params)
    # the fused head went through the port's Function, forward and backward
    assert calls == (["fused_xent_fwd_plain", "fused_xent_bwd_plain"]
                     if lm_head == "fused" else [])

    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=tol)
    want = convert.params_from_jax(jax.device_get(jgrads))
    for name, g in zip(names, tgrads):
        w = want[name].float()
        err = (g.float() - w).abs().max() / w.abs().max()
        assert err <= tol, (name, float(err))


def test_chunked_head_equals_the_plain_head():
    """Sequence chunks with recompute change the order of the sums, not
    the function: loss and grads within f32 1e-6 of the plain head."""
    gen = torch.Generator().manual_seed(0)
    emb = torch.randn(50, 16, generator=gen, requires_grad=True)
    h = torch.randn(2, 12, 16, generator=gen, requires_grad=True)
    tgt = torch.randint(0, 50, (2, 12), generator=gen)
    out = {}
    for chunks in (0, 3):
        loss = ttf.head_loss(emb, h, tgt, xent_chunks=chunks)
        out[chunks] = (loss, *torch.autograd.grad(loss, (emb, h)))
    for a, b in zip(out[0], out[3]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------- lm-head policy

BASE = ["--model", "transformer", "--seq-len", "2048",
        "--train-batch-size", "8"]
# (argv, TPUDIST_HBM_BYTES): each forced mode, auto with and without
# explicit flags, auto past the budget, and a budget that only bf16 nu
# fits (the state estimate charges nu at its storage dtype)
RESOLVE = [
    (["--lm-head", "plain"], 80e9),
    (["--lm-head", "fused"], 80e9),
    (["--lm-head", "chunked"], 80e9),
    (["--lm-head", "chunked", "--xent-chunks", "8"], 80e9),
    ([], 80e9),
    (["--fused-xent"], 80e9),
    (["--xent-chunks", "2"], 80e9),
    (["--train-batch-size", "512"], 80e9),
    ([], 17.1e9),
]
CONTRADICTIONS = [
    ["--lm-head", "plain", "--fused-xent"],
    ["--lm-head", "plain", "--xent-chunks", "2"],
    ["--lm-head", "fused", "--xent-chunks", "2"],
    ["--lm-head", "chunked", "--fused-xent"],
]


@pytest.mark.parametrize("nu", ["float32", "bfloat16"])
def test_resolve_lm_head_equals_jax(nu, monkeypatch):
    got = {}
    for argv, hbm in RESOLVE:
        monkeypatch.setenv("TPUDIST_HBM_BYTES", str(hbm))
        argv = BASE + argv + ["--adam-nu-dtype", nu]
        t = tengine._resolve_lm_head(tconfig.parse_args(argv))
        j = jengine._resolve_lm_head(jconfig.parse_args(argv), None)
        assert t == j, (argv, hbm, t, j)
        got[(tuple(argv), hbm)] = t
    assert list(got.values())[:8] == [(False, 0), (True, 0), (False, 4),
                                      (False, 8), (False, 0), (True, 0),
                                      (False, 2), (True, 0)]
    # the boundary budget: fused with an f32 nu, plain with a bf16 one
    assert list(got.values())[8] == ((True, 0) if nu == "float32"
                                     else (False, 0))
    for argv in CONTRADICTIONS:
        with pytest.raises(ValueError, match="contradicts"):
            tengine._resolve_lm_head(tconfig.parse_args(BASE + argv))
        with pytest.raises(ValueError, match="contradicts"):
            jengine._resolve_lm_head(jconfig.parse_args(BASE + argv), None)


def test_auto_logs_the_chosen_head(monkeypatch, capsys):
    monkeypatch.setattr(tengine, "_AUTO_HEAD_LOGGED", set())
    monkeypatch.setenv("TPUDIST_HBM_BYTES", str(80e9))
    for batch in ("8", "512", "8"):
        tengine._resolve_lm_head(tconfig.parse_args(
            BASE[:-1] + [batch]))
    out = capsys.readouterr().out
    assert out.count("tpudist: --lm-head auto -> plain") == 1
    assert out.count("tpudist: --lm-head auto -> fused") == 1


# --------------------------------------------------------- bf16 second moment

@pytest.mark.parametrize("count", [1, 7, 100_003])
def test_stochastic_round_is_bitwise_the_jax_one(count):
    """2^20 elements over a wide range of magnitudes and signs; every
    index past 1 wraps the 32-bit index product, and counts past 1 the
    count product."""
    rng = np.random.default_rng(count)
    x = (rng.standard_normal((1024, 1024))
         * 10.0 ** rng.uniform(-20, 20, (1024, 1024))).astype(np.float32)
    for salt in (0, 3, 10):
        want = jengine._stochastic_round_bf16(jnp.asarray(x),
                                              jnp.int32(count), salt)
        got = tengine._stochastic_round_bf16(torch.from_numpy(x), count,
                                             salt)
        assert got.dtype == torch.bfloat16
        assert np.array_equal(got.view(torch.int16).numpy(),
                              np.asarray(want).view(np.int16)), salt


def test_jax_leaf_order_sorts_keys_at_every_level():
    """The salts: each port param's index among the JAX params' leaves,
    whose order (sorted keys) is not the module's."""
    jparams = jtf.init(jax.random.PRNGKey(0), TINY)
    model = ttf.Transformer(_tcfg(TINY), device="cpu")
    names = [n for n, _ in model.named_parameters()]
    leaves = jax.tree_util.tree_flatten_with_path(jparams)[0]
    jnames = [".".join(k.key for k in path) for path, _ in leaves]
    assert sorted(names) == sorted(jnames) and names != jnames
    assert [jnames[i] for i in tengine.jax_leaf_order(names)] == names


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adam_with_bf16_nu_matches_jax(dtype):
    """Three steps against the jitted JAX update, salts in JAX leaf order
    (the port's param order differs). The moments and the update are the
    same f32 expressions in the same order; XLA may contract a product
    and a sum into one FMA where the port rounds twice, so the f32 values
    may differ in the last bit, and a one-ulp difference in nu before
    the stochastic rounding can move the bf16 nu by one bf16 ulp: params
    and mu within f32 1e-6, nu within one bf16 ulp (2^-7 relative)."""
    rng = np.random.default_rng(1)
    shapes = {"w": (64, 33), "b": (97,), "a": {"z": (40,), "c": (8, 16)}}
    names = ["w", "b", "a.z", "a.c"]

    def leaf(tree, name):
        for k in name.split("."):
            tree = tree[k]
        return tree

    def draw():
        return jax.tree.map(lambda s: rng.standard_normal(s).astype(
            np.float32), shapes, is_leaf=lambda s: isinstance(s, tuple))
    params, grads = draw(), [draw() for _ in range(3)]

    mu_dtype = jnp.bfloat16 if dtype == "bfloat16" else None
    jtx = jengine._adam_low_precision_nu(1e-2, mu_dtype=mu_dtype)
    assert isinstance(jengine.make_optimizer(jconfig.TrainConfig(
        lr=1e-2, dtype=dtype, adam_nu_dtype="bfloat16")),
        optax.GradientTransformation)
    jp = jax.tree.map(jnp.asarray, params)
    jst = jtx.init(jp)
    update = jax.jit(jtx.update)
    for g in grads:
        upd, jst = update(jax.tree.map(jnp.asarray, g), jst, jp)
        jp = optax.apply_updates(jp, upd)

    ttx = tengine.make_optimizer(tconfig.TrainConfig(
        lr=1e-2, dtype=dtype, adam_nu_dtype="bfloat16"))
    tp = [torch.from_numpy(leaf(params, n).copy()) for n in names]
    tst = ttx.init(tp, names)
    assert tst.salts == [3, 2, 1, 0]
    for g in grads:
        ttx.update([torch.from_numpy(leaf(g, n)) for n in names], tst, tp)
    assert tst.count == int(jst.count) == 3
    for i, n in enumerate(names):
        assert tst.nu[i].dtype == torch.bfloat16
        assert tst.mu[i].dtype == (torch.bfloat16 if dtype == "bfloat16"
                                   else torch.float32)
        np.testing.assert_allclose(tp[i].numpy(), np.asarray(leaf(jp, n)),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(
            tst.mu[i].float().numpy(),
            np.asarray(leaf(jst.mu, n), np.float32), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(
            tst.nu[i].float().numpy(),
            np.asarray(leaf(jst.nu, n), np.float32), rtol=2.0 ** -7)


# --------------------------------------------------------------- the CLI

CLI_ARGV = ["--model", "transformer", "--vocab-size", "256", "--n-layers",
            "2", "--d-model", "256", "--n-heads", "2", "--n-kv-heads", "1",
            "--d-ff", "512", "--seq-len", "128", "--n-samples", "32",
            "--train-batch-size", "8", "--epochs", "2", "--seed", "7",
            "--steps-per-dispatch", "1", "--lm-head", "fused"]


def _records(save_dir, kind):
    return [r for r in (json.loads(line) for line in
                        (save_dir / "metrics.jsonl").read_text()
                        .splitlines()) if r["kind"] == kind]


def test_fused_head_cli_matches_jax_cli(tmp_path, capsys, monkeypatch):
    """Both CLIs with ``--lm-head fused`` on the same token stream,
    permutation and initial params (the JAX package's, carried): every
    epoch's Avg and eval loss within f32 1e-5."""
    monkeypatch.setattr(tdata, "reference_permutation",
                        jdata.epoch_permutation)

    def carried_init(cfg, *, generator):
        jm = jconfig.ModelConfig(**{f.name: getattr(cfg, f.name) for f in
                                    dataclasses.fields(tconfig.ModelConfig)})
        params = jtf.init(jax.random.PRNGKey(7), jm)
        model = ttf.Transformer(cfg, device=generator.device)
        model.load_state_dict(convert.params_from_jax(
            jax.device_get(params)))
        return model
    monkeypatch.setattr(ttf, "init", carried_init)

    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    assert jtrain.main(CLI_ARGV + ["--save-dir", str(jdir)]) == 0
    capsys.readouterr()
    backwards = []
    real = tfx.fused_xent_bwd_plain
    monkeypatch.setattr(tfx, "fused_xent_bwd_plain",
                        lambda *a: backwards.append(1) or real(*a))
    assert ttrain.main(CLI_ARGV + ["--save-dir", str(tdir),
                                   "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert len(backwards) == 8          # the fused head, 2 epochs x 4 steps
    jep, tep = _records(jdir, "epoch"), _records(tdir, "epoch")
    assert len(tep) == len(jep) == 2
    for key in ("avg_loss", "eval_loss"):
        np.testing.assert_allclose([r[key] for r in tep],
                                   [r[key] for r in jep], rtol=0, atol=1e-5)
    assert "Training completed." in out
    assert tep[-1]["avg_loss"] < tep[0]["avg_loss"]
