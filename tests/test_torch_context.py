"""The port's context parallelism in the train step (``engine``'s
context axis, the models' ``make_cp_loss_fn``) against the JAX package's
(``tpudist/engine.py:282-317``, ``tpudist/models/transformer.py:752-853``,
``tpudist/models/moe.py:298-321``), which ``tests/test_context_parallel.py``
and ``tests/test_moe.py:135-180`` hold.

* The step body on four gloo ranks from the JAX package's initial params
  on its global batches, 3 steps at each mesh below, against the JAX
  step at the same mesh on four virtual CPU devices
  (``tests/_torch_moe_mesh.py``): each step's loss within rtol 2e-5
  (GQA 2e-4) of the JAX mesh step's and of the JAX single-device
  step's, each rank's shard of Adam's ``mu`` and ``nu`` and of every
  param's change within ``STATE_TOL`` of the JAX state's region:

  the transformer at ``context 4`` with the ring (zigzag) and with
  Ulysses, at ``data 2 x context 2`` and ``fsdp 2 x context 2`` (ring),
  GQA (kv 2 of h 4) at ``data 2 x context 2`` with both, and at ``tensor
  2 x context 2`` (vocab 128: the vocab-parallel head on a context
  shard's tokens). The MoE's runs are ``tests/test_torch_context_moe.py``.
* ``precompute_rope``'s ``offset`` and ``positions`` and both models'
  ``hidden_states(rope_offset=, rope_positions=)`` against the JAX
  package's (a Ulysses shard's offset, a zigzag shard's two chunks).
* The refusals with the JAX messages: Ulysses's heads the context ranks
  do not divide (at the step, on four ranks), the sequence the layout
  cannot cut, the MLP at ``--context 2``, pipe beside context and a
  model without a context-parallel loss.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_moe_mesh import (GQA_TOL, MODEL, RTOL, check_run, jax_body_runs,
                             with_flags)
from _torch_ranks import start_ranks
from tpudist import config as jconfig
from tpudist import data as jdata
from tpudist import engine as jengine
from tpudist import train as jtrain
from tpudist.models import moe as jmoe
from tpudist.models import transformer as jtf
from tpudist.parallel import build_mesh
from tpudist_torch import config as tconfig
from tpudist_torch import convert
from tpudist_torch import engine as tengine
from tpudist_torch import train as ttrain
from tpudist_torch.models import get_model
from tpudist_torch.models import moe as tmoe
from tpudist_torch.models import transformer as ttf
from tpudist_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

CPU = torch.device("cpu")
TF = ["--model", "transformer", "--seq-len", "16", "--d-model", "32",
      "--n-layers", "2", "--n-heads", "4", "--n-kv-heads", "4", "--d-ff",
      "64", "--vocab-size", "97", "--lm-head", "plain", "--lr", "1e-2",
      "--seed", "0", "--train-batch-size", "8"]
GQA_TF = with_flags(TF, n_kv_heads=2)
ULY = ["--cp-impl", "ulysses"]
RUNS = {
    "tf_c4": TF + ["--context", "4"],
    "tf_c4_uly": TF + ["--context", "4"] + ULY,
    "tf_d2c2": TF + ["--data", "2", "--context", "2"],
    "tf_f2c2": TF + ["--fsdp", "2", "--context", "2"],
    "gqa_d2c2": GQA_TF + ["--data", "2", "--context", "2"],
    "gqa_d2c2_uly": GQA_TF + ["--data", "2", "--context", "2"] + ULY,
    "tf_t2c2": with_flags(TF, vocab_size=128) + ["--tensor", "2",
                                                 "--context", "2"],
}

# the step at --context 4 --cp-impl ulysses over 2 heads, on four ranks
REFUSAL = r"""
from tpudist_torch import config, engine
from tpudist_torch.parallel import mesh as mesh_lib
cfg = config.parse_args(json.loads(ARGS[1]) + ["--device", "cpu"])
mesh = mesh_lib.build_mesh(cfg.parallel, device_type="cpu")
state = engine.init_state(cfg, torch.device("cpu"), mesh)
step = engine.make_train_step(cfg, torch.device("cpu"), mesh)
tokens = torch.zeros((8, cfg.model.max_seq_len + 1), dtype=torch.long)
try:
    step(state, (tokens[:8],))
    msg = None
except ValueError as e:
    msg = str(e)
with open(f"{ARGS[0]}/refusal{RANK}.json", "w") as f:
    json.dump(msg, f)
"""
REFUSED = MODEL + ["--context", "4"] + ULY


@pytest.fixture(scope="module")
def context_runs(tmp_path_factory, devices8):
    out = tmp_path_factory.mktemp("context_body")
    wait = start_ranks("import json\n" + REFUSAL, 4, out,
                       json.dumps(REFUSED))
    got, want = jax_body_runs(out, devices8, RUNS)
    wait()
    refusals = [json.load(open(out / f"refusal{r}.json")) for r in range(4)]
    return got, want, refusals


@pytest.mark.parametrize("tag", list(RUNS))
def test_context_body_matches_jax_on_four_ranks(context_runs, tag):
    got, want, _ = context_runs
    if tag.startswith("gqa"):
        check_run(got, want, tag, GQA_TOL, GQA_TOL)
    else:
        check_run(got, want, tag, RTOL)


def test_context_ranks_hold_the_same_shards(context_runs):
    """No spec splits a param over ``context``: at ``fsdp 2 x context
    2`` ranks 0 and 1 (one fsdp coordinate) hold the same regions, and
    at ``context 4`` every rank holds every param whole."""
    got, _, _ = context_runs
    assert got[0]["tf_f2c2"]["spans"] == got[1]["tf_f2c2"]["spans"]
    assert got[0]["tf_f2c2"]["spans"] != got[2]["tf_f2c2"]["spans"]
    for g in got:
        for t, p in zip(g["tf_c4"]["params"], got[0]["tf_c4"]["params"]):
            assert t.shape == p.shape


def test_ulysses_refuses_heads_the_context_ranks_do_not_divide(
        context_runs, devices8):
    _, _, refusals = context_runs
    jcfg = jconfig.parse_args(REFUSED)
    mesh = build_mesh(jcfg.parallel, devices=devices8[:4])
    state = jengine.init_state(jax.random.PRNGKey(0), jcfg, mesh)
    step = jengine.make_train_step(jcfg, mesh)
    toks = jdata.make_synthetic_tokens(8, jcfg.model.max_seq_len + 1,
                                       jcfg.model.vocab_size, seed=0)
    with pytest.raises(ValueError) as want:
        step(state, (toks,))
    assert refusals == [str(want.value)] * 4
    assert "ulysses needs q heads (2) divisible by the context axis size " \
           "(4)" in refusals[0]


@pytest.mark.parametrize("argv", [
    ["--model", "transformer", "--seq-len", "20", "--context", "4"],
    ["--model", "moe", "--seq-len", "18", "--context", "4", "--cp-impl",
     "ulysses"],
    ["--model", "mlp", "--context", "2"],
])
def test_context_refusals_carry_the_jax_messages(devices8, argv):
    """The JAX train CLI's refusals (``tpudist/train.py:142-153``): a
    sequence the ring's 2 x context chunks (Ulysses's context chunks) do
    not divide, and a model without a sequence."""
    jcfg = jconfig.parse_args(argv + ["--data", str(8 // int(
        argv[argv.index("--context") + 1]))])
    with pytest.raises(ValueError) as want:
        jtrain.run(dataclasses.replace(jcfg, save_dir="/nonexistent"))
    cfg = tconfig.parse_args(argv + ["--device", "cpu"])
    tconfig.check_supported(cfg)
    with pytest.raises(ValueError) as got:
        ttrain.check_context(cfg, cfg.parallel.context)
    assert str(got.value) == str(want.value)


def test_pipe_beside_context_is_refused_as_jax(devices8):
    argv = ["--model", "transformer", "--pipe", "2", "--context", "2"]
    jcfg = jconfig.parse_args(argv)
    with pytest.raises(ValueError) as want:
        jengine.make_loss_fn(jcfg, build_mesh(jcfg.parallel,
                                              devices=devices8[:4]))
    cfg = tconfig.parse_args(argv + ["--device", "cpu"])
    with pytest.raises(ValueError) as got:
        tengine.make_loss_fn(cfg, CPU, tmesh.rank_grid(cfg.parallel, 4))
    assert str(got.value) == str(want.value)
    # the train CLI refuses the pipe axis first, naming its item
    with pytest.raises(ValueError, match="ROADMAP Queue A item 8b$"):
        tconfig.check_supported(cfg)


def test_a_model_without_a_context_loss_is_refused_as_jax(devices8,
                                                          monkeypatch):
    monkeypatch.delattr(jmoe, "make_cp_loss_fn")
    monkeypatch.delattr(tmoe, "make_cp_loss_fn")
    argv = ["--model", "moe", "--context", "2"]
    jcfg = jconfig.parse_args(argv)
    with pytest.raises(ValueError) as want:
        jengine.make_loss_fn(jcfg, build_mesh(jcfg.parallel,
                                              devices=devices8[:2]))
    cfg = tconfig.parse_args(argv + ["--device", "cpu"])
    with pytest.raises(ValueError) as got:
        tengine.make_loss_fn(cfg, CPU, tmesh.rank_grid(cfg.parallel, 2))
    assert str(got.value) == str(want.value)
    assert "context parallelism is not implemented for model 'moe'" == \
        str(got.value)


# ------------------------- RoPE at a context shard's absolute positions

ROPE_CASES = {"offset": dict(rope_offset=24),
              "zigzag": dict(rope_positions=[8, 9, 10, 11, 4, 5, 6, 7]),
              "none": {}}


@pytest.mark.parametrize("case", list(ROPE_CASES))
def test_precompute_rope_offset_and_positions_match_jax(case):
    """``precompute_rope``'s ``offset`` and ``positions`` against
    ``tpudist/models/transformer.py:41-57``."""
    kw = ROPE_CASES[case]
    pos = kw.get("rope_positions")
    want = jtf.precompute_rope(8, 16, 10000.0, offset=kw.get(
        "rope_offset", 0), positions=None if pos is None else np.asarray(pos))
    got = ttf.precompute_rope(8, 16, 10000.0, None if pos is None
                              else torch.tensor(pos),
                              offset=kw.get("rope_offset", 0))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0)


@pytest.mark.parametrize("model", ["transformer", "moe"])
@pytest.mark.parametrize("case", ["offset", "zigzag"])
def test_hidden_states_at_shard_positions_match_jax(model, case):
    """``hidden_states(rope_offset=, rope_positions=)`` of both sequence
    models on the JAX package's params, against the JAX package's, f32
    within 1e-4 (the MoE's aux loss too)."""
    argv = (MODEL if model == "moe" else TF)[:]
    jcfg = jconfig.parse_args(argv).model
    tcfg = tconfig.parse_args(argv).model
    jm = jmoe if model == "moe" else jtf
    jparams = jm.init(jax.random.PRNGKey(0), jcfg)
    tm = get_model(model)
    params = (tm.MoE if model == "moe" else tm.Transformer)(tcfg,
                                                           device="cpu")
    params.load_state_dict(convert.params_from_jax(jax.device_get(jparams)))
    tokens = np.random.default_rng(0).integers(0, tcfg.vocab_size, (2, 8))
    kw = dict(ROPE_CASES[case])
    jkw = dict(kw)
    if "rope_positions" in kw:
        kw["rope_positions"] = torch.tensor(kw["rope_positions"])
        jkw["rope_positions"] = jnp.asarray(jkw["rope_positions"])
    want = jm.hidden_states(jparams, jnp.asarray(tokens), jcfg,
                            dtype=jnp.float32, **jkw)
    with torch.no_grad():
        got = tm.hidden_states(params, torch.from_numpy(tokens), tcfg,
                               dtype=torch.float32, **kw)
    if model == "transformer":
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=0)
