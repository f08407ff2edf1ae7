"""Serving on several cards: the port's serve mesh
(``tpudist_torch/parallel/sharding.py``'s KV-cache specs,
``serve/kvcache.py``'s slot spans, ``ServeEngine(mesh=...)``, the MoE's
decode routed over the global slot batch, ``run_serve``'s ``n_chips``
and the serve CLI under the env contract) against the JAX package's
single-program serve mesh (``tests/test_serve.py:105-125,165,343-362``).

* (a) The KV-cache spec tables equal JAX's ``kv_cache_specs`` and
  ``paged_kv_cache_specs``; an unknown layout raises.
* (b) Each rank's slot span equals the JAX cache's ``addressable_shards``
  index on a 4-device CPU mesh, both layouts, at slots 4 (one a rank) and
  3 (replicated), and the cache each of four gloo ranks builds has that
  span's slots.
* (c) ``run_serve`` on four gloo ranks over the mesh engine, params
  carried from JAX (``convert.params_from_jax``): every request's greedy
  tokens equal the JAX engine's ``run_serve`` on a 4-device mesh and the
  port's one-rank run, for the transformer at slots 4 and at slots 2
  (the replicated fallback), the MoE at slots 4, and a capacity-bound MoE
  (capacity factor 0.5) at slots 8.
* (d) The same runs: ``n_chips`` 4, and every rank's program pin (1
  prefill, 1 decode a rung) and prefill count.
* (e) One decode step's expert FFN at 8 slots over 4 ranks with capacity
  factor 0.5, where routing each rank's slots alone keeps other
  (token, expert) pairs than routing the global batch (asserted): the
  port's kept pairs and outputs equal JAX's global routing. In one
  process, with the gather replayed: 12 slots whose routing groups lie
  inside a rank, span every rank, or cross rank edges, each equal to
  JAX's FFN over the whole batch.
* (f) The serve CLI on two gloo ranks equals a one-process run: tokens,
  the ``kind=serve`` partition, ``detail.n_chips`` 2, verdict
  ``success``.
* (g) At world 2 the CLI serves the paged plane, speculation, the shared
  prefix, the serve tuner, chaos and the requeue attempt (one run with
  all six on, each flag's effect read from its records); an engine
  refusal that stands (``--speculate-k 1``) fails every rank.
* (h) A follower that raises makes rank 0 exit non-zero, its verdict
  ``fail``, in bounded time.
"""

import dataclasses
import json
import os
import subprocess
import sys
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ranks import REPO, free_port, start_ranks
from tpudist.config import ModelConfig, ParallelConfig
from tpudist.models import moe as jmoe
from tpudist.models import transformer as jtf
from tpudist.parallel import build_mesh
from tpudist.parallel import sharding as jshd
from tpudist.serve import kvcache as jkv
from tpudist.serve import scheduler as jsched
from tpudist.serve.engine import ServeEngine as JDense
from tpudist.serve.engine import init_params
from tpudist_torch import convert
from tpudist_torch.config import ModelConfig as TModelConfig
from tpudist_torch.models import get_model
from tpudist_torch.models import moe as tmoe
from tpudist_torch.parallel import mesh as tmesh
from tpudist_torch.parallel import sharding as tshd
from tpudist_torch.serve import kvcache as tkv
from tpudist_torch.serve import scheduler as tsched
from tpudist_torch.serve.engine import ServeEngine as TDense

torch.set_num_threads(1)

WORLD = 4
# tests/test_serve.py:44,55
TINY_TF = ModelConfig(name="transformer", vocab_size=64, n_layers=2,
                      d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                      max_seq_len=32)
TINY_MOE = ModelConfig(name="moe", vocab_size=64, n_layers=2,
                       d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                       max_seq_len=32, n_experts=4, expert_top_k=2,
                       capacity_factor=4.0)
# capacity-bound: at 8 slots the global group's capacity is 2 an
# expert, a rank's 2 slots alone would get 1
TIGHT_MOE = dataclasses.replace(TINY_MOE, capacity_factor=0.5)
# (model config, slots): the mesh engine's cases
CASES = {"transformer_s4": (TINY_TF, 4), "transformer_s2": (TINY_TF, 2),
         "moe_s4": (TINY_MOE, 4), "moe_tight_s8": (TIGHT_MOE, 8)}
ENGINE = dict(max_seq=32, prompt_pad=8, decode_k=4)
STREAM = dict(n=5, prompt_pad=8, vocab_size=64, max_new=6, rate=0.0,
              seed=3)
SPAN_CASES = [(layout, slots) for layout in ("st", "hs")
              for slots in (4, 3)]
FFN_SEED = 5


def _tcfg(cfg: ModelConfig) -> TModelConfig:
    return TModelConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(TModelConfig)})


def _tokens(summary):
    return {int(rid): r["tokens"] for rid, r in summary["results"].items()}


# every rank: the cache spans, the mesh engine's serve runs, one decode
# step's expert FFN; rank 0 prints the summaries' tokens
RANKS = r"""
import json
import dataclasses
from tpudist_torch.config import ModelConfig, ParallelConfig
from tpudist_torch.models import get_model, moe
from tpudist_torch.parallel import mesh as mesh_lib
from tpudist_torch.serve import kvcache
from tpudist_torch.serve import scheduler as sched
from tpudist_torch.serve.engine import ServeEngine, SlotGroup

a = dict(np.load(ARGS[0]))
cases = json.loads(open(ARGS[1]).read())
mesh = mesh_lib.build_mesh(ParallelConfig(), device_type="cpu")
out = {"rank": RANK, "spans": {}, "runs": {}}

for layout in ("st", "hs"):
    for slots in (4, 3):
        spec = kvcache.CacheSpec(n_layers=2, slots=slots, max_seq=16,
                                 n_kv_heads=2, head_dim=8, layout=layout)
        cache = kvcache.init_cache(spec, "cpu", mesh)
        out["spans"][f"{layout}{slots}"] = [
            kvcache.slot_span(spec, mesh, RANK), list(cache["k"].shape)]


def model(tag, cfg):
    m = get_model(cfg.name).init(cfg, generator=torch.Generator())
    m.load_state_dict({k[len(tag) + 1:]: torch.from_numpy(v)
                       for k, v in a.items() if k.startswith(tag + ".")})
    return m


requests = sched.make_requests(**cases.pop("stream"))
engine_kw = cases.pop("engine")
for name, (cfg_kw, slots) in cases.items():
    cfg = ModelConfig(**cfg_kw)
    params = model(cfg_kw["name"] + str(cfg_kw["capacity_factor"]), cfg)
    engine = ServeEngine(cfg, slots=slots, device="cpu", mesh=mesh,
                         **engine_kw)
    run = {"span": list(engine.span), "split": engine.split}
    if RANK == 0:
        engine.warmup(params)
        summary = sched.run_serve(engine, params, requests)
        engine.stop_followers()
        engine.assert_two_programs()
        run["tokens"] = {rid: r["tokens"]
                         for rid, r in summary["results"].items()}
        run["n_chips"] = summary["n_chips"]
        run["completed"] = summary["completed"]
    else:
        engine.follow(params)
    run["programs"] = list(engine.compile_counts())
    run["prefills"] = engine.local_prefills
    out["runs"][name] = run

# one decode step's expert FFN, this rank's two of the 8 slots, with the
# dispatch the global routing kept
cfg = ModelConfig(**json.loads(open(ARGS[2]).read()))
params = model("ffn", cfg)
lp = {k: v for k, v in params.layers.layer(0).items()}
x = torch.from_numpy(a["ffn_x"])[2 * RANK:2 * RANK + 2]
seen, route = [], moe._route
moe._route = lambda *args: seen.append(route(*args)) or seen[-1]
group = mesh_lib.axes_group(mesh, ("data", "fsdp"))
with torch.no_grad():
    y = moe._moe_ffn_sublayer(x, lp, cfg,
                              slot_group=SlotGroup(group, WORLD, RANK))
moe._route = route
dispatch = seen[0][0]
out["ffn"] = {"out": y.reshape(2, -1).tolist(),
              "kept": dispatch.sum(-1).reshape(8, -1)[
                  2 * RANK:2 * RANK + 2].tolist()}
print("RESULT " + json.dumps(out), flush=True)
"""


def _carried(cfg: ModelConfig, seed: int = 0):
    """JAX's params for ``cfg`` (its serve engine's init) as numpy
    arrays by the port's state-dict names."""
    mesh = build_mesh(ParallelConfig(), devices=jax.devices()[:1])
    params = init_params(cfg, mesh, seed=seed)
    return params, {k: v.numpy() for k, v in convert.params_from_jax(
        jax.device_get(params)).items()}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The four gloo ranks' results (started first, so the JAX runs
    below overlap them), the JAX engine's tokens on a 4-device mesh and
    the port's one-rank tokens, by case."""
    tmp = tmp_path_factory.mktemp("serve_mesh")
    arrays = {}
    for cfg in (TINY_TF, TINY_MOE, TIGHT_MOE):
        tag = f"{cfg.name}{cfg.capacity_factor}"
        _, carried = _carried(cfg)
        arrays.update({f"{tag}.{k}": v for k, v in carried.items()})
    jffn, carried = _carried(TIGHT_MOE, seed=FFN_SEED)
    arrays.update({f"ffn.{k}": v for k, v in carried.items()})
    rng = np.random.default_rng(FFN_SEED)
    x = rng.standard_normal((8, 1, TIGHT_MOE.d_model)).astype(np.float32)
    arrays["ffn_x"] = x
    np.savez(tmp / "params.npz", **arrays)
    cases = {name: (dataclasses.asdict(_tcfg(cfg)), slots)
             for name, (cfg, slots) in CASES.items()}
    cases.update(stream=STREAM, engine=ENGINE)
    (tmp / "cases.json").write_text(json.dumps(cases))
    (tmp / "ffn.json").write_text(json.dumps(dataclasses.asdict(
        _tcfg(TIGHT_MOE))))
    wait = start_ranks(RANKS, WORLD, tmp / "params.npz", tmp / "cases.json",
                       tmp / "ffn.json")

    jmesh = build_mesh(ParallelConfig(), devices=jax.devices()[:WORLD])
    jax_tokens, one_rank = {}, {}
    requests = tsched.make_requests(**STREAM)
    for name, (cfg, slots) in CASES.items():
        tag = f"{cfg.name}{cfg.capacity_factor}"
        jparams = init_params(cfg, jmesh, seed=0)
        eng = JDense(cfg, jmesh, slots=slots, **ENGINE)
        eng.warmup(jparams)
        summary = jsched.run_serve(eng, jparams, jsched.make_requests(
            **STREAM))
        eng.assert_two_programs()
        jax_tokens[name] = _tokens(summary)
        model = get_model(cfg.name).init(_tcfg(cfg),
                                         generator=torch.Generator())
        model.load_state_dict({k[len(tag) + 1:]: torch.from_numpy(v)
                               for k, v in arrays.items()
                               if k.startswith(tag + ".")})
        eng = TDense(_tcfg(cfg), slots=slots, device="cpu", **ENGINE)
        eng.warmup(model)
        summary = tsched.run_serve(eng, model, requests)
        eng.assert_two_programs()
        assert summary["n_chips"] == 1
        one_rank[name] = _tokens(summary)

    ranks = []
    for text in wait(240):
        line, = [ln for ln in text.splitlines()
                 if ln.startswith("RESULT ")]
        ranks.append(json.loads(line[len("RESULT "):]))
    return {"ranks": ranks, "jax": jax_tokens, "one": one_rank,
            "jffn": jffn, "x": x}


# ---------------------------------------------------------------- (a)

@pytest.mark.parametrize("layout", ["st", "hs"])
def test_kv_cache_specs_equal_jax(layout):
    assert tshd.kv_cache_specs(layout) == tuple(jshd.kv_cache_specs(layout))
    assert tshd.KV_CACHE_LAYOUTS == jshd.KV_CACHE_LAYOUTS \
        == tkv.KV_CACHE_LAYOUTS


def test_paged_kv_cache_specs_equal_jax():
    assert tshd.paged_kv_cache_specs() == tuple(jshd.paged_kv_cache_specs())


def test_unknown_layout_raises_as_jax():
    with pytest.raises(ValueError, match="layout"):
        jshd.kv_cache_specs("sx")
    with pytest.raises(ValueError, match="layout"):
        tshd.kv_cache_specs("sx")


@pytest.mark.parametrize("slots,pages", [(4, 32), (3, 24), (8, 33)])
def test_sanitized_cache_specs_equal_jax(devices8, slots, pages):
    """The specs sanitised on a 4-device data mesh: the slot (page) dim
    kept over data where 4 divides it, replicated where it does not."""
    jmesh = build_mesh(ParallelConfig(), devices=devices8[:WORLD])
    grid = tmesh.rank_grid(tmesh.ParallelConfig(), WORLD)
    for layout in ("st", "hs"):
        spec = jkv.CacheSpec.from_model(TINY_TF, slots=slots, max_seq=16,
                                        layout=layout)
        shape = jax.ShapeDtypeStruct(spec.storage_shape, jnp.float32)
        want = jshd.sanitize_specs(shape, jshd.kv_cache_specs(layout),
                                   jmesh)
        tspec = tkv.CacheSpec.from_model(_tcfg(TINY_TF), slots=slots,
                                         max_seq=16, layout=layout)
        assert tkv.cache_spec_on(tspec, grid) == tuple(want)
    shape = (2, pages + 1, 8, 2, 8)
    want = jshd.sanitize_specs(jax.ShapeDtypeStruct(shape, jnp.float32),
                               jshd.paged_kv_cache_specs(), jmesh)
    assert tshd.sanitize_spec(shape, tshd.paged_kv_cache_specs(),
                              tmesh.mesh_shape(grid)) == tuple(want)


# ---------------------------------------------------------------- (b)

@pytest.mark.parametrize("layout,slots", SPAN_CASES)
def test_slot_spans_equal_jax_shards(devices8, served, layout, slots):
    """Rank ``r``'s span and its cache's slots equal the slot slice of
    the JAX cache's shard on the device at data position ``r``."""
    jmesh = build_mesh(ParallelConfig(), devices=devices8[:WORLD])
    spec = jkv.CacheSpec.from_model(TINY_TF, slots=slots, max_seq=16,
                                    layout=layout)
    cache = jkv.init_cache(spec, jmesh)
    by_dev = {s.device: s.index[1] for s in cache["k"].addressable_shards}
    grid = tmesh.rank_grid(tmesh.ParallelConfig(), WORLD)
    tspec = tkv.CacheSpec(n_layers=2, slots=slots, max_seq=16,
                          n_kv_heads=2, head_dim=8, layout=layout)
    for r, dev in enumerate(jmesh.devices.reshape(-1)):
        sl = by_dev[dev]
        want = (sl.start or 0, slots if sl.stop is None else sl.stop)
        assert tkv.slot_span(tspec, grid, r) == want
        span, shape = served["ranks"][r]["spans"][f"{layout}{slots}"]
        assert tuple(span) == want
        assert shape[1] == want[1] - want[0]


# ------------------------------------------------------------ (c), (d)

@pytest.mark.parametrize("case", list(CASES))
def test_mesh_tokens_equal_jax_and_one_rank(served, case):
    got = {int(rid): toks for rid, toks in
           served["ranks"][0]["runs"][case]["tokens"].items()}
    assert served["ranks"][0]["runs"][case]["completed"] == STREAM["n"]
    assert got == served["jax"][case] == served["one"][case]


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_n_chips_pins_and_prefills(served, case):
    _, slots = CASES[case]
    runs = [r["runs"][case] for r in served["ranks"]]
    assert runs[0]["n_chips"] == WORLD
    split = slots % WORLD == 0
    per = slots // WORLD if split else slots
    for r, run in enumerate(runs):
        assert run["programs"] == [1, 1], (r, run)
        assert run["split"] == split
        assert run["span"] == ([r * per, (r + 1) * per] if split
                               else [0, slots])
    prefills = [run["prefills"] for run in runs]
    # the owner prefills a split slot; every rank a replicated one
    assert (sum(prefills) == STREAM["n"] if split
            else prefills == [STREAM["n"]] * WORLD)


# ---------------------------------------------------------------- (e)

def test_moe_decode_routes_the_global_slot_batch(served):
    """The capacity-bound MoE's expert FFN over 8 decode slots: routing
    each rank's 2 slots alone (capacity 1) keeps other pairs than routing
    the 8 together (capacity 2); the port's four ranks keep the global
    pairs, and their outputs are JAX's global FFN's within f32 1e-5."""
    cfg, k = TIGHT_MOE, TIGHT_MOE.expert_top_k
    lp = {n: v[0] for n, v in served["jffn"]["layers"].items()}
    x = jnp.asarray(served["x"])
    want = np.asarray(jmoe._moe_ffn_sublayer(x, lp, cfg)).reshape(8, -1)
    y = jtf.rmsnorm(x, lp["ffn_norm"]).reshape(8, -1)
    probs = jax.nn.softmax(y @ lp["w_router"], axis=-1)
    kept = np.asarray(jmoe._route(probs, k, jmoe.capacity(cfg, 8))[0]
                      .sum(-1))
    alone = np.concatenate([np.asarray(jmoe._route(
        probs[i:i + 2], k, jmoe.capacity(cfg, 2))[0].sum(-1))
        for i in range(0, 8, 2)])
    assert jmoe.capacity(cfg, 8) == 2 and jmoe.capacity(cfg, 2) == 1
    assert not np.array_equal(alone, kept)
    ffn = [r["ffn"] for r in served["ranks"]]
    np.testing.assert_array_equal(
        np.concatenate([f["kept"] for f in ffn]), kept)
    got = np.concatenate([f["out"] for f in ffn])
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


class _Replay:
    """A slot group in one process: the first pass records what every
    rank gathers, the second hands each rank the stacked record, as an
    all-gather over the ranks would."""

    def __init__(self, ways):
        self.ways, self.seen = ways, {}

    def rank(self, index):
        replay = self

        class Rank(NamedTuple):
            ways: int
            index: int

            def gather(self, x):
                if len(replay.seen) < replay.ways:
                    replay.seen[self.index] = x
                    return x.repeat(self.ways, *[1] * (x.dim() - 1))
                return torch.cat([replay.seen[i]
                                  for i in range(self.ways)])

        return Rank(self.ways, index)


# (ranks, moe_group_size) over 12 decode slots: groups of 3 inside a
# rank's 6, one group of 12 over 4 ranks' 3, groups of 4 across ranks' 6
PIECE_CASES = [(2, 3), (4, 0), (2, 4)]


@pytest.mark.parametrize("ways,group", PIECE_CASES)
def test_moe_slot_pieces_route_the_global_groups(ways, group):
    """A rank's decode tokens go through the experts in pieces that each
    lie inside one global routing group, whether its groups are whole,
    one group spans the ranks, or groups cross rank edges: the ranks'
    outputs are JAX's FFN over the 12 slots within f32 1e-5."""
    cfg = dataclasses.replace(TIGHT_MOE, moe_group_size=group)
    jparams, carried = _carried(cfg, seed=FFN_SEED)
    lp = {n: v[0] for n, v in jparams["layers"].items()}
    x = np.random.default_rng(FFN_SEED).standard_normal(
        (12, 1, cfg.d_model)).astype(np.float32)
    want = np.asarray(jmoe._moe_ffn_sublayer(jnp.asarray(x), lp, cfg))
    model = get_model("moe").init(_tcfg(cfg), generator=torch.Generator())
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in carried.items()})
    tlp = model.layers.layer(0)
    t, replay = 12 // ways, _Replay(ways)
    with torch.no_grad():
        for _ in range(2):
            got = [tmoe._moe_ffn_sublayer(
                torch.from_numpy(x[i * t:(i + 1) * t]), tlp, _tcfg(cfg),
                slot_group=replay.rank(i)) for i in range(ways)]
    np.testing.assert_allclose(torch.cat(got).numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


# ---------------------------------------------------------- (f)-(h)

# one serve CLI process; argv: the tokens' json path, the decode count
# after which this rank's mesh decodes raise (-1: never), the CLI flags
CLI = r"""
import json
import sys
for name in ("jax", "jaxlib", "optax", "orbax", "tpudist"):
    sys.modules[name] = None
import torch
torch.set_num_threads(1)
from tpudist_torch.serve import cli, scheduler
from tpudist_torch.serve.engine import ServeEngine

path, fail_after, argv = sys.argv[1], int(sys.argv[2]), sys.argv[3:]
real = scheduler.run_serve


def run_serve(*args, **kw):
    summary = real(*args, **kw)
    with open(path, "w") as f:
        json.dump({rid: r["tokens"] for rid, r in
                   summary["results"].items()}, f)
    return summary
scheduler.run_serve = run_serve
if fail_after >= 0:
    decodes, decode = [], ServeEngine._do_decode

    def failing(self, *args, **kw):
        decodes.append(1)
        if len(decodes) > fail_after:
            raise RuntimeError("a fault injected in this follower")
        return decode(self, *args, **kw)
    ServeEngine._do_decode = failing
sys.exit(cli.main(argv))
"""
LOOSE = {"TPUDIST_TTFT_P99_MAX": "120", "TPUDIST_ITL_P99_MAX": "60",
         "TPUDIST_TOKENS_PER_CHIP_MIN": "0.001"}
CLI_ARGV = ["--device", "cpu", "--requests", "6", "--max-new-tokens", "5",
            "--slots", "4"]


def _serve_cli(tmp, world: int, argv, fail_after=(), timeout=180):
    """``world`` processes of the serve CLI (one without the env
    contract), saving under ``tmp``; returns (exit codes, outputs, wall
    seconds)."""
    import time
    os.makedirs(tmp, exist_ok=True)
    port = free_port()
    procs = []
    t0 = time.monotonic()
    for rank in range(world):
        env = dict(os.environ, OMP_NUM_THREADS="1", **LOOSE,
                   TPUDIST_VERDICT_PATH=os.path.join(tmp, "verdict.txt"))
        if world > 1:
            env.update(TPUDIST_COORDINATOR=f"localhost:{port}",
                       TPUDIST_NUM_PROCESSES=str(world),
                       TPUDIST_PROCESS_ID=str(rank))
        fail = dict(fail_after).get(rank, -1)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", CLI, os.path.join(tmp, "tokens.json"),
             str(fail), *argv, "--save-dir", tmp,
             "--bench-out", os.path.join(tmp, "BENCH_SERVE.json")],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    return [p.returncode for p in procs], outs, time.monotonic() - t0


def _serve_record(tmp):
    recs = [json.loads(line) for line in
            open(os.path.join(tmp, "metrics.jsonl"))]
    serve, = [r for r in recs if r["kind"] == "serve"]
    return serve


@pytest.mark.parametrize("model", ["transformer", "moe"])
def test_cli_on_two_ranks_equals_one_process(tmp_path, model):
    argv = CLI_ARGV + ["--model", model]
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    rcs, outs, _ = _serve_cli(one, 1, argv)
    assert rcs == [0], outs
    rcs, outs, _ = _serve_cli(two, 2, argv)
    assert rcs == [0, 0], outs
    assert "serve mesh of 2 processes (gloo): slots 4 split 2 a rank" \
        in outs[0]
    tokens = [json.load(open(os.path.join(d, "tokens.json")))
              for d in (one, two)]
    assert tokens[0] == tokens[1] and len(tokens[0]) == 6
    recs = [_serve_record(d) for d in (one, two)]
    assert recs[0]["partition"] == recs[1]["partition"]
    assert (recs[0]["n_chips"], recs[1]["n_chips"]) == (1, 2)
    assert recs[1]["completed"] == 6 and recs[1]["status"] == "success"
    bench = json.load(open(os.path.join(two, "BENCH_SERVE.json")))
    assert bench["detail"]["n_chips"] == 2
    # the summary's cache is the whole one, the card's ledger its span
    assert recs[0]["kv_cache_bytes"] == recs[1]["kv_cache_bytes"]
    pools = [json.load(open(os.path.join(d, "memledger.json")))
             ["buckets"]["kv_pool"] for d in (one, two)]
    assert pools == [recs[0]["kv_cache_bytes"],
                     recs[0]["kv_cache_bytes"] // 2]
    assert [open(os.path.join(two, name)).read() for name in (
        "verdict.txt", "verdict.txt.worker0", "verdict.txt.worker1")] \
        == ["success"] * 3


# the six flags a serve mesh refused before it served them, each with what
# its run's records must show
SERVED = {
    "--kv-page-tokens": (["--kv-page-tokens", "8"],
                         lambda s, recs: s["kv_page_tokens"] == 8),
    "--speculate-k": (["--speculate-k", "2"],
                      lambda s, recs: (s["speculate_k"],
                                       s["verify_compiles"]) == (2, 1)),
    "--shared-prefix": (["--shared-prefix", "4"],
                        lambda s, recs: s["shared_prefix_len"] == 4),
    "--serve-tune": (["--serve-tune", "cache-only"],
                     lambda s, recs: [(r["source"], r["trials"]) for r in
                                      recs["serve_tune"]]
                     == [("heuristic", 0)]),
    "--chaos": (["--chaos", "serve_slow@0:1,s=0.01"],
                lambda s, recs: [(r["fault"], r["rank"]) for r in
                                 recs["chaos"]] == [("serve_slow", 0)]),
    "--requeue-attempt": (["--requeue-attempt", "0"],
                          lambda s, recs: s["requeue_attempt"] == 0
                          and len(recs["serve_request"]) > 0),
}


@pytest.fixture(scope="module")
def all_flags(tmp_path_factory):
    """The serve CLI on two gloo ranks with the six flags on at once."""
    tmp = str(tmp_path_factory.mktemp("all_flags"))
    argv = CLI_ARGV + [a for flag_argv, _ in SERVED.values()
                       for a in flag_argv]
    rcs, outs, _ = _serve_cli(tmp, 2, argv)
    recs = [json.loads(line) for line in
            open(os.path.join(tmp, "metrics.jsonl"))]
    by_kind = {}
    for r in recs:
        by_kind.setdefault(r["kind"], []).append(r)
    return tmp, rcs, outs, by_kind


@pytest.mark.parametrize("flag", list(SERVED))
def test_mesh_serves_what_served_on_one_card(all_flags, flag):
    tmp, rcs, outs, recs = all_flags
    assert rcs == [0, 0], outs
    assert "slots 4 on every rank, pool rows replicated" in outs[0]
    serve, = recs["serve"]
    assert (serve["status"], serve["n_chips"]) == ("success", 2)
    assert SERVED[flag][1](serve, recs), (flag, serve)
    assert open(os.path.join(tmp, "verdict.txt")).read() == "success"


def test_cli_refusal_still_fails_every_rank(tmp_path):
    """A refusal that stands on a serve mesh (a one-token verify window)
    fails every rank, each naming it, the verdict ``fail``."""
    rcs, outs, _ = _serve_cli(str(tmp_path), 2, CLI_ARGV + [
        "--kv-page-tokens", "8", "--speculate-k", "1"])
    assert rcs == [1, 1], outs
    assert all("--speculate-k must be 0 (off) or >= 2" in out
               for out in outs)
    assert (tmp_path / "verdict.txt").read_text() == "fail"


def test_failed_follower_fails_the_run_in_bounded_time(tmp_path):
    """Rank 1's second decode raises: rank 1 leaves at once, rank 0's next
    collective with it fails, and rank 0 exits 1 with the verdict
    ``fail`` well inside the aggregation's 120 s."""
    rcs, outs, wall = _serve_cli(str(tmp_path), 2, CLI_ARGV,
                                 fail_after=[(1, 1)], timeout=120)
    assert rcs == [1, 1], outs
    assert "a fault injected in this follower" in outs[1]
    assert "tpudist: serve failed" in outs[0]
    assert (tmp_path / "verdict.txt").read_text() == "fail"
    assert wall < 60
