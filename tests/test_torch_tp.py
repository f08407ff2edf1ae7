"""The port's tensor parallelism (``tpudist_torch/parallel/tensor.py``,
the tensor half of ``engine.ShardLayout`` and the sharded step body, the
models' tensor parts) against the JAX package's Megatron layout, which
``tests/test_tensor_parallel.py`` holds.

* Shard shapes: each rank's region of ``wq`` and of the embedding equal
  to JAX's ``NamedSharding`` index for that device, at vocab 128 (the
  table split over ``(fsdp, tensor)``, chunk ``fsdp * tensor + tensor``)
  and 98 (fsdp alone), on the reference's layouts; each rank's param
  bytes ``1/tensor`` of the whole for every leaf whose spec keeps
  ``tensor``.
* The step body on four gloo ranks from the JAX package's initial params
  on its global batches, 3 steps at each mesh below against the JAX
  step at the same mesh on four virtual CPU devices (and its losses
  against one device's): each step's loss, each step's grad shard (the
  grads Adam takes, against ``jax.grad`` of the global loss at the JAX
  step's params) and each final param shard, within rtol 2e-3 / atol
  2e-3 (``tests/test_tensor_parallel.py:54``; GQA 2e-4):

  - the transformer at data 2 x tensor 2 (vocab 97: the head and the
    table replicated over tensor);
  - at fsdp 2 x tensor 2, vocab 128 (the vocab-sharded table, the
    vocab-parallel head: its logits ``(tokens, V / 2)`` a rank), and
    with the chunked head (the whole table on every tensor rank, its
    grad counted once);
  - GQA, kv 2 at data 2 x tensor 2 (kv heads resident);
  - GQA, kv 2 at tensor 4 (``tensor`` cuts inside a kv head: ``wk`` and
    ``wv`` gathered, their grads reduce-scattered);
  - the MoE at data 2 x tensor 2 and at fsdp 2 x tensor 2 (global
    routing, the experts' hidden dim over tensor);
  - the MLP at data 2 x tensor 2 (replicated over tensor).
"""

import concurrent.futures
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from _torch_ranks import start_ranks
from tpudist import config as jconfig
from tpudist import data as jdata
from tpudist import engine as jengine
from tpudist.models import transformer as jtf
from tpudist.parallel import build_mesh
from tpudist_torch import config as tconfig
from tpudist_torch import convert
from tpudist_torch import engine as tengine
from tpudist_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

RTOL = ATOL = 2e-3
GQA_TOL = 2e-4
STEPS, BATCH = 3, 8

TF = ["--model", "transformer", "--seq-len", "16", "--d-model", "32",
      "--n-layers", "2", "--n-heads", "4", "--n-kv-heads", "4", "--d-ff",
      "64", "--lm-head", "plain", "--lr", "1e-2"]
MOE = ["--model", "moe", "--seq-len", "16", "--d-model", "32",
       "--n-layers", "2", "--n-heads", "4", "--d-ff", "32", "--vocab-size",
       "96", "--n-experts", "4", "--moe-group-size", "32", "--lm-head",
       "plain", "--lr", "1e-2"]
RUNS = {
    "tf_d2t2": TF + ["--vocab-size", "97", "--data", "2", "--tensor", "2"],
    "tf_f2t2": TF + ["--vocab-size", "128", "--fsdp", "2", "--tensor",
                     "2"],
    "tf_f2t2_chunked": TF[:-4] + ["--lr", "1e-2", "--lm-head", "chunked",
                                  "--xent-chunks", "2", "--vocab-size",
                                  "128", "--fsdp", "2", "--tensor", "2"],
    "gqa_d2t2": TF + ["--vocab-size", "97", "--n-kv-heads", "2", "--data",
                      "2", "--tensor", "2"],
    "gqa_t4": TF + ["--vocab-size", "128", "--n-kv-heads", "2", "--data",
                    "1", "--tensor", "4"],
    "moe_d2t2": MOE + ["--data", "2", "--tensor", "2"],
    "moe_f2t2": MOE + ["--fsdp", "2", "--tensor", "2"],
    "mlp_d2t2": ["--lr", "1e-2", "--data", "2", "--tensor", "2"],
}


# the reference's TP-against-unsharded cases
# (tests/test_tensor_parallel.py:46-53,86-96,109-135)
UNSHARDED = ("tf_d2t2", "tf_f2t2", "gqa_d2t2")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


# ------------------------------------------------------- shard shapes

@pytest.mark.parametrize("axes,vocab", [
    (dict(data=2, tensor=4), 97), (dict(data=2, tensor=4), 128),
    (dict(data=2, fsdp=2, tensor=2), 128), (dict(fsdp=2, tensor=4), 98),
    (dict(fsdp=2, tensor=4), 128)])
def test_shards_are_the_jax_devices_shards(devices8, axes, vocab):
    """Every rank's region of ``wq`` and of the embedding is the index
    JAX gives that device under the sanitized spec, and its param bytes
    are ``1/tensor`` of the whole (``1/(fsdp x tensor)`` where fsdp cuts
    too) for every leaf whose spec keeps ``tensor``."""
    argv = TF + ["--vocab-size", str(vocab)] + [
        x for a, n in axes.items() for x in (f"--{a}", str(n))]
    jcfg = jconfig.parse_args(argv)
    jm = build_mesh(jcfg.parallel, devices=devices8)
    jsh = _flat(jengine.state_shardings(jcfg, jm).params)
    shapes = {n: s.shape for n, s in _flat(jax.eval_shape(
        lambda: jtf.init(jax.random.PRNGKey(0), jcfg.model))).items()}
    cfg = tconfig.parse_args(argv + ["--device", "cpu"])
    tshapes = {n: tuple(p.shape) for n, p in tengine.init_state(
        cfg, torch.device("cpu")).params.named_parameters()}
    grid = tmesh.RankGrid(np.vectorize(lambda d: d.id)(jm.devices),
                          tmesh.AXIS_NAMES)
    tensor = axes["tensor"]
    for dev in jm.devices.ravel():
        lay = tengine.make_layout(cfg, grid, tshapes, rank=dev.id)
        for name in ("layers.wq", "embed"):
            i = lay.names.index(name)
            want = NamedSharding(jm, jsh[name].spec).devices_indices_map(
                shapes[name])[dev]
            got = lay.span(i)
            assert got == tuple(sl.indices(n)[:2] for sl, n in
                                zip(want, shapes[name])), (name, dev.id)
        for i, name in enumerate(lay.names):
            n_whole = int(np.prod(lay.shapes[i]))
            n_mine = int(np.prod([hi - lo for lo, hi in lay.span(i)]))
            if lay.tdims[i] is not None:
                fs = lay.fsdp if lay.dims[i] is not None else 1
                assert n_mine * tensor * fs == n_whole, name
    if vocab == 128:
        assert lay.tdims[lay.names.index("embed")] == 0
    elif vocab == 98 and axes.get("fsdp") == 2:
        assert lay.tdims[lay.names.index("embed")] is None
        assert lay.dims[lay.names.index("embed")] == 0


# ----------------------------------------------- the step body, 4 ranks

BODY = r"""
import json
from tpudist_torch import config, data, engine
from tpudist_torch.parallel import mesh as mesh_lib
from tpudist_torch.parallel import tensor as tensor_lib
cpu = torch.device("cpu")
out = ARGS[0]
a = np.load(f"{out}/ref.npz")
seen, logits = [], []
apply = engine.Adam.apply
def spy(self, grads, *rest):
    seen.append([g.detach().clone() for g in grads])
    return apply(self, grads, *rest)
engine.Adam.apply = spy
xent = tensor_lib._VocabParallelXent.apply
def spy_xent(lg, *rest):
    logits.append(tuple(lg.shape))
    return xent(lg, *rest)
tensor_lib._VocabParallelXent.apply = spy_xent
res, meshes = {}, {}
for tag, argv in json.loads(ARGS[1]).items():
    cfg = config.parse_args(argv + ["--device", "cpu",
                                    "--train-batch-size", "8"])
    key = json.dumps(dataclasses.asdict(cfg.parallel))
    if key not in meshes:
        meshes[key] = mesh_lib.build_mesh(cfg.parallel, device_type="cpu")
    mesh = meshes[key]
    state = engine.init_state(cfg, cpu, mesh)
    lay = state.layout
    with torch.no_grad():
        for i, (n, p) in enumerate(state.params.named_parameters()):
            p.copy_(lay.shard(i, torch.from_numpy(a[f"{tag}.param.{n}"])))
    step = engine.make_train_step(cfg, cpu, mesh)
    ev = engine.make_eval_fn(cfg, cpu, mesh)
    batches = [a[k] for k in (f"{tag}.x", f"{tag}.y") if k in a]
    seen.clear(), logits.clear()
    losses = []
    for i in range(batches[0].shape[0]):
        local = tuple(b[i].reshape(lay.batch, -1, *b.shape[2:])[
            RANK // lay.tensor] for b in batches)
        state, loss = step(state, data.to_device(local, cpu))
        losses.append(float(loss))
    ev_loss = float(ev(state, data.to_device(tuple(b[0] for b in batches),
                                             cpu)))
    res[tag] = {"losses": losses, "eval": ev_loss, "logits": list(logits),
                "names": lay.names,
                "spans": [lay.span(i) for i in range(len(lay.names))],
                "grads": [list(g) for g in seen],
                "params": [p.detach().clone()
                           for p in state.params.parameters()],
                "bytes": engine.state_bytes_per_device(state)}
torch.save(res, f"{out}/rank{RANK}.pt")
"""


def _jax_runs(out, devices8):
    """The JAX package's initial params and global batches in
    ``ref.npz``, the port's ranks started on them; meanwhile the JAX
    step at each mesh (its losses, its grads at each step's params, its
    final params) and one device's losses."""
    x, y = jdata.make_synthetic_data(STEPS * BATCH, 20, 42)

    def init(tag):
        jcfg = jconfig.parse_args(RUNS[tag] + ["--train-batch-size",
                                               str(BATCH)])
        m = jcfg.model
        if m.name == "mlp":
            batches = (np.asarray(x).reshape(STEPS, BATCH, 20),
                       np.asarray(y).reshape(STEPS, BATCH))
        else:
            tokens = jdata.make_synthetic_tokens(
                STEPS * BATCH, m.max_seq_len + 1, m.vocab_size, 42)
            batches = (np.asarray(tokens).reshape(STEPS, BATCH, -1),)
        mesh = build_mesh(jcfg.parallel, devices=devices8[:4])
        state = jengine.init_state(jax.random.PRNGKey(jcfg.seed), jcfg,
                                   mesh)
        return jcfg, mesh, state, batches

    # the configurations compile side by side (XLA compiles outside the
    # interpreter lock)
    pool = concurrent.futures.ThreadPoolExecutor(4)
    runs = dict(zip(RUNS, pool.map(init, RUNS)))
    arrays = {}
    for tag, (_, _, state, batches) in runs.items():
        for k, b in zip(("x", "y"), batches):
            arrays[f"{tag}.{k}"] = b
        for k, v in convert.params_from_jax(
                jax.device_get(state.params)).items():
            arrays[f"{tag}.param.{k}"] = v.numpy()
    np.savez(out / "ref.npz", **arrays)
    wait = start_ranks("import dataclasses\n" + BODY, 4, out,
                       json.dumps(RUNS))
    def run(tag):
        jcfg, mesh, state, batches = runs[tag]
        step = jengine.make_train_step(jcfg, mesh)
        grad = jax.jit(jax.grad(jengine.make_loss_fn(jcfg)))
        losses, grads = [], []
        for i in range(STEPS):
            batch = tuple(b[i] for b in batches)
            g = grad(jax.device_get(state.params), batch)
            grads.append({k: v.numpy() for k, v in
                          convert.params_from_jax(g).items()})
            state, loss = step(state, batch)
            losses.append(float(loss))
        one_losses = None
        if tag in UNSHARDED:
            one = dataclasses.replace(
                jcfg, parallel=jconfig.ParallelConfig(data=1))
            one_mesh = build_mesh(one.parallel, devices=devices8[:1])
            ostep = jengine.make_train_step(one, one_mesh)
            ostate = jengine.init_state(jax.random.PRNGKey(jcfg.seed), one,
                                        one_mesh)
            one_losses = []
            for i in range(STEPS):
                ostate, loss = ostep(ostate, tuple(b[i] for b in batches))
                one_losses.append(float(loss))
        return {"losses": losses, "grads": grads, "one": one_losses,
                "params": {k: v.numpy() for k, v in convert.params_from_jax(
                    jax.device_get(state.params)).items()}}

    with pool:
        want = dict(zip(runs, pool.map(run, runs)))
    return want, wait


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory, devices8):
    out = tmp_path_factory.mktemp("tp_body")
    want, wait = _jax_runs(out, devices8)
    wait()
    got = [torch.load(out / f"rank{r}.pt", weights_only=True)
           for r in range(4)]
    return got, want


def _region(whole, span):
    return whole[tuple(slice(lo, hi) for lo, hi in span)]


@pytest.mark.parametrize("tag", list(RUNS))
def test_tp_body_matches_jax_on_four_ranks(tp_runs, tag):
    got, want = tp_runs
    tol = GQA_TOL if tag.startswith("gqa") else RTOL
    w = want[tag]
    for r, ranks in enumerate(got):
        mine = ranks[tag]
        np.testing.assert_allclose(mine["losses"], w["losses"], rtol=tol,
                                   atol=tol, err_msg=f"rank {r}")
        if tag in UNSHARDED:
            np.testing.assert_allclose(mine["losses"], w["one"],
                                       rtol=RTOL, atol=ATOL)
        assert len(mine["grads"]) == STEPS
        for s, grads in enumerate(mine["grads"]):
            for name, span, g in zip(mine["names"], mine["spans"], grads):
                assert tuple(g.shape) == tuple(hi - lo for lo, hi in span)
                np.testing.assert_allclose(
                    g.numpy(), _region(w["grads"][s][name], span),
                    rtol=tol, atol=tol,
                    err_msg=f"rank {r} step {s} grad {name}")
        for name, span, p in zip(mine["names"], mine["spans"],
                                 mine["params"]):
            np.testing.assert_allclose(
                p.numpy(), _region(w["params"][name], span), rtol=tol,
                atol=tol, err_msg=f"rank {r} param {name}")
    # every tensor rank of a batch place reports the same loss
    assert len({tuple(g[tag]["losses"]) for g in got}) == 1
    assert len({g[tag]["eval"] for g in got}) == 1
    assert got[0][tag]["losses"][-1] < got[0][tag]["losses"][0]


def test_tp_state_and_head_are_split(tp_runs):
    """Per-rank bytes below the replicated state's, and the plain head's
    logits ``(tokens, V / tensor)`` where tensor divides the vocab
    (``tf_f2t2``: 4 rows x 16 tokens a rank, vocab 128 over tensor 2;
    ``gqa_t4``: 8 x 16 tokens, vocab 128 over tensor 4), none where it
    does not (vocab 97)."""
    got, _ = tp_runs
    for g in got:
        assert g["tf_f2t2"]["logits"] == [(4, 16, 64)] * (STEPS + 1)
        assert g["gqa_t4"]["logits"] == [(8, 16, 32)] * (STEPS + 1)
        assert g["tf_d2t2"]["logits"] == []
        assert g["tf_f2t2_chunked"]["logits"] == []
        assert g["moe_d2t2"]["logits"] == [(4, 16, 48)] * (STEPS + 1)
    whole = {}
    for tag in ("tf_f2t2", "gqa_t4", "moe_f2t2"):
        cfg = tconfig.parse_args(RUNS[tag] + ["--device", "cpu"])
        whole[tag] = tengine.state_bytes_per_device(
            tengine.init_state(cfg, torch.device("cpu")))
        for g in got:
            assert g[tag]["bytes"] < whole[tag] / 2, tag
