"""The MoE's sharded step body on four gloo ranks against the JAX
package's step on the same mesh and on one device: a helper of the
port's MoE mesh tests, which holds no test itself.

:func:`jax_body_runs` writes the JAX package's initial params and
global batches for each run to an .npz, starts four ranks of
:data:`BODY` on it (each rank's rows of a step its place's share of the
global batch, microbatch-major under ``--grad-accum-steps``), and runs
the JAX steps meanwhile; :func:`check_run` holds one run's ranks to
them.
"""

import concurrent.futures
import dataclasses
import json

import jax
import numpy as np
import torch

from _torch_ranks import start_ranks
from tpudist import config as jconfig
from tpudist import data as jdata
from tpudist import engine as jengine
from tpudist.parallel import build_mesh
from tpudist_torch import convert

RTOL = 2e-5
GQA_TOL = 2e-4
# Adam's moments and each param's change after 3 f32 steps, as |got -
# want| / |want| over a shard (2-norms). Elementwise the states part at a
# few elements: a grad near Adam's eps moves its element by lr times a
# ratio of two small moments, and a router probability near a top-k tie
# or a capacity edge flips a routing. By this measure the JAX step at a
# 4-device mesh and at one device differ by up to 2.4e-4 on the tests'
# runs, and the port's ranks differ from the JAX mesh step by up to
# 1.2e-4 without accumulation (t2e2's params) and 1.17e-3 with it
# (d2f2_accum's w_gate change; d2e2_accum's 4.7e-4); a wrong expert
# slice or a grad counted twice differs by 1
STATE_TOL = 3e-3
STEPS = 3

MODEL = ["--model", "moe", "--vocab-size", "128", "--n-layers", "2",
         "--d-model", "32", "--n-heads", "2", "--n-kv-heads", "2",
         "--d-ff", "48", "--seq-len", "16", "--n-experts", "4",
         "--expert-top-k", "2", "--capacity-factor", "2.0", "--lm-head",
         "plain", "--lr", "1e-2", "--seed", "0", "--train-batch-size", "8"]
GQA = MODEL[:MODEL.index("--n-heads")] + [
    "--n-heads", "4", "--n-kv-heads", "2"] + MODEL[
        MODEL.index("--d-ff"):]
# tests/test_torch_fsdp_train.py's MoE
FSDP_MOE = ["--model", "moe", "--seq-len", "16", "--d-model", "32",
            "--n-layers", "2", "--n-heads", "4", "--d-ff", "32",
            "--vocab-size", "96", "--n-experts", "4", "--moe-group-size",
            "64", "--lm-head", "plain", "--lr", "1e-2", "--seed", "0",
            "--train-batch-size", "16"]


def with_flags(argv, **flags):
    """``argv`` with each ``--flag value`` replaced or added."""
    argv = list(argv)
    for k, v in flags.items():
        flag = "--" + k.replace("_", "-")
        if flag in argv:
            argv[argv.index(flag) + 1] = str(v)
        else:
            argv += [flag, str(v)]
    return argv


def _jax_moments(opt_state):
    """Adam's ``mu`` and ``nu`` of a JAX train state, by the port's
    names."""
    (adam,) = [s for s in jax.tree.leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu")]
    return ({k: v.numpy() for k, v in convert.params_from_jax(
        jax.device_get(m)).items()} for m in (adam.mu, adam.nu))


BODY = r"""
import json
from tpudist_torch import config, data, engine
from tpudist_torch.parallel import mesh as mesh_lib
cpu = torch.device("cpu")
out = ARGS[0]
a = np.load(f"{out}/ref.npz")
res, meshes = {}, {}
for tag, argv in json.loads(ARGS[1]).items():
    cfg = config.parse_args(argv + ["--device", "cpu"])
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
    tokens = a[f"{tag}.tokens"]
    losses = []
    n_accum = cfg.grad_accum_steps
    for i in range(tokens.shape[0]):
        idx = np.arange(tokens.shape[1])[None]
        if n_accum > 1:
            rows = data.microbatch_major(idx, n_accum, lay.batch)[
                0, lay.place]
        else:
            rows = idx[0].reshape(lay.batch, -1)[lay.place]
        state, loss = step(state, data.to_device((tokens[i][rows],), cpu))
        losses.append(float(loss))
    res[tag] = {"losses": losses, "names": lay.names,
                "spans": [lay.span(i) for i in range(len(lay.names))],
                "expert_group": lay.expert_group is not None,
                "params": [p.detach().clone()
                           for p in state.params.parameters()],
                "mu": [t.clone() for t in state.opt_state.mu],
                "nu": [t.clone() for t in state.opt_state.nu],
                "bytes": engine.state_bytes_per_device(state)}
torch.save(res, f"{out}/rank{RANK}.pt")
"""


def jax_body_runs(out, devices8, runs_argv, steps=None):
    """The JAX package's initial params and global batches of each run
    (``{tag: argv}``; ``steps[tag]`` steps, :data:`STEPS` by default) in
    ``out/ref.npz``, the port's four ranks started on them; meanwhile
    the JAX step at each run's mesh on four devices (its losses, final
    params and moments) and at one device (its losses). Returns each
    rank's results and the JAX ones, by tag."""
    steps = steps or {}

    def init(tag):
        jcfg = jconfig.parse_args(runs_argv[tag])
        m = jcfg.model
        n = steps.get(tag, STEPS)
        tokens = np.asarray(jdata.make_synthetic_tokens(
            n * jcfg.batch_size, m.max_seq_len + 1, m.vocab_size, 5
        )).reshape(n, jcfg.batch_size, -1)
        mesh = build_mesh(jcfg.parallel, devices=devices8[:4])
        state = jengine.init_state(jax.random.PRNGKey(jcfg.seed), jcfg,
                                   mesh)
        return jcfg, mesh, state, tokens

    pool = concurrent.futures.ThreadPoolExecutor(4)
    runs = dict(zip(runs_argv, pool.map(init, runs_argv)))
    arrays = {}
    for tag, (_, _, state, tokens) in runs.items():
        arrays[f"{tag}.tokens"] = tokens
        for k, v in convert.params_from_jax(
                jax.device_get(state.params)).items():
            arrays[f"{tag}.param.{k}"] = v.numpy()
    np.savez(out / "ref.npz", **arrays)
    wait = start_ranks("import dataclasses\n" + BODY, 4, out,
                       json.dumps(runs_argv))

    def one_device(tag):
        jcfg, _, _, tokens = runs[tag]
        one = dataclasses.replace(
            jcfg, parallel=jconfig.ParallelConfig(data=1))
        one_mesh = build_mesh(one.parallel, devices=devices8[:1])
        ostep = jengine.make_train_step(one, one_mesh)
        ostate = jengine.init_state(jax.random.PRNGKey(jcfg.seed), one,
                                    one_mesh)
        one_losses = []
        for batch in tokens:
            ostate, loss = ostep(ostate, (batch,))
            one_losses.append(float(loss))
        return one_losses

    # one device's run once a configuration and step count: the runs
    # that differ only in their mesh share it
    def key(tag):
        return (repr(dataclasses.replace(
            runs[tag][0], parallel=jconfig.ParallelConfig())),
            len(runs[tag][3]))

    alike = {}
    for tag in runs:
        alike.setdefault(key(tag), tag)
    def run(tag):
        jcfg, mesh, state, tokens = runs[tag]
        step = jengine.make_train_step(jcfg, mesh)
        losses = []
        for batch in tokens:
            state, loss = step(state, (batch,))
            losses.append(float(loss))
        mu, nu = _jax_moments(state.opt_state)
        return {"losses": losses, "mu": mu, "nu": nu,
                "init": {k[len(tag) + 7:]: v for k, v in arrays.items()
                         if k.startswith(f"{tag}.param.")},
                "params": {k: v.numpy() for k, v in convert.params_from_jax(
                    jax.device_get(state.params)).items()}}

    with pool:
        want = dict(zip(runs, pool.map(run, runs)))
        ones = dict(zip(alike.values(), pool.map(one_device,
                                                 alike.values())))
    for tag in runs:
        want[tag]["one"] = ones[alike[key(tag)]]
    wait()
    got = [torch.load(out / f"rank{r}.pt", weights_only=True)
           for r in range(4)]
    return got, want


def _region(whole, span):
    return whole[tuple(slice(lo, hi) for lo, hi in span)]


def check_run(got, want, tag: str, tol: float = RTOL, atol: float = 0,
              one: bool = True):
    """Every rank's losses of run ``tag`` within ``tol`` of the JAX
    step's at the same mesh and at one device (which agree with each
    other; ``one=False`` leaves one device out, for a mesh whose program
    differs from one device's by design), its shards of ``mu``, ``nu``
    and of every param's change within :data:`STATE_TOL` of the JAX
    state's regions, the losses the same on every rank and falling."""
    w = want[tag]
    refs = (w["losses"], w["one"]) if one else (w["losses"],)
    if one:
        np.testing.assert_allclose(w["losses"], w["one"], rtol=tol,
                                   atol=atol)
    for r, ranks in enumerate(got):
        mine = ranks[tag]
        for ref in refs:
            np.testing.assert_allclose(mine["losses"], ref, rtol=tol,
                                       atol=atol, err_msg=f"rank {r}")
        for kind in ("params", "mu", "nu"):
            for name, span, t in zip(mine["names"], mine["spans"],
                                     mine[kind]):
                assert tuple(t.shape) == tuple(hi - lo for lo, hi in span)
                t, ref = t.numpy(), _region(w[kind][name], span)
                if kind == "params":
                    t, ref = (x - _region(w["init"][name], span)
                              for x in (t, ref))
                err = np.linalg.norm(t - ref) / np.linalg.norm(ref)
                assert err <= STATE_TOL, (r, kind, name, err)
    # every rank reports the same loss
    assert len({tuple(g[tag]["losses"]) for g in got}) == 1
    assert got[0][tag]["losses"][-1] < got[0][tag]["losses"][0]


