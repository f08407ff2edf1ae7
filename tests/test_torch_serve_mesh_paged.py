"""The paged plane on a serve mesh: ``PagedServeEngine(mesh=...)`` on four
gloo ranks, its pool replicated or split over the ranks
(``serve/kvcache.py``'s ``pool_span``, ``models/transformer.py``'s
``_paged_attention_split``), against the JAX package's
``PagedServeEngine`` on a 4-device mesh (``tests/test_paged_serve.py``).

* (a) ``test_paged_greedy_matches_dense``'s shapes (slots 2, max_seq 32,
  prompt_pad 8, decode_k 4, page 8, 5 requests, seed 3) with the
  replicated pool (9 rows), for the transformer and the MoE: every
  request's tokens equal the JAX engine's at ``n_dev`` 4 and the port's
  one-rank run; each rank's pin (1, 1, verify 0) and prefill count.
* (b) The page-split pool at slots 4, pages 15 (16 rows, 4 a rank; the
  JAX spec splits them too): the same token equalities, each rank's pool
  rows (its 4 and the discard row). One decode step's split attention
  within f32 1e-5 of each largest element of the replicated pool's (and
  the JAX function's), for a slot whose pages lie on one rank, one whose
  pages span ranks and an inactive slot (finite, the replicated result),
  and each rank's written rows equal the replicated pool's.
* (c) Speculation (``speculate_k`` 4) and the shared prefix (8 and 12
  tokens) on four ranks equal the dense tokens, as
  ``test_speculative_greedy_bitwise_vs_dense`` and
  ``test_shared_prefix_paged_matches_dense`` pin them; the registry's
  pages held after the drain.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ranks import start_ranks
from tpudist.config import ModelConfig, ParallelConfig
from tpudist.models import transformer as jtf
from tpudist.parallel import build_mesh
from tpudist.parallel import sharding as jshd
from tpudist.serve import scheduler as jsched
from tpudist.serve.engine import PagedServeEngine as JPaged
from tpudist.serve.engine import ServeEngine as JDense
from tpudist.serve.engine import init_params
from tpudist_torch import convert
from tpudist_torch.config import ModelConfig as TModelConfig
from tpudist_torch.models import get_model
from tpudist_torch.models import transformer as ttf
from tpudist_torch.parallel import mesh as tmesh
from tpudist_torch.serve import kvcache as tkv
from tpudist_torch.serve import scheduler as tsched
from tpudist_torch.serve.engine import PagedServeEngine as TPaged

torch.set_num_threads(1)

WORLD = 4
# tests/test_paged_serve.py:44-51
TINY_TF = ModelConfig(name="transformer", vocab_size=64, n_layers=2,
                      d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                      max_seq_len=32)
TINY_MOE = ModelConfig(name="moe", vocab_size=64, n_layers=2,
                       d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                       max_seq_len=32, n_experts=4, expert_top_k=2,
                       capacity_factor=4.0)
PAGED = dict(max_seq=32, prompt_pad=8, decode_k=4, page_tokens=8)
STREAM = dict(n=5, prompt_pad=8, vocab_size=64, max_new=6, rate=0.0,
              seed=3)
# name: (model config, engine kwargs, stream, (prefix length, seed))
CASES = {
    "transformer_replicated": (TINY_TF, dict(PAGED, slots=2), STREAM,
                               None),
    "moe_replicated": (TINY_MOE, dict(PAGED, slots=2), STREAM, None),
    "transformer_split": (TINY_TF, dict(PAGED, slots=4, pages=15),
                          STREAM, None),
    "moe_split": (TINY_MOE, dict(PAGED, slots=4, pages=15), STREAM, None),
    # tests/test_paged_serve.py:266-296
    "speculative": (TINY_TF, dict(slots=3, max_seq=32, prompt_pad=16,
                                  decode_k=4, page_tokens=8,
                                  speculate_k=4),
                    dict(n=8, prompt_pad=16, vocab_size=64, max_new=10,
                         rate=0.0, seed=13, prefix_len=8), (8, 13)),
    # tests/test_paged_serve.py:230-263
    **{f"prefix{p}": (TINY_TF, dict(slots=2, max_seq=32, prompt_pad=16,
                                    decode_k=4, page_tokens=8),
                      dict(n=6, prompt_pad=16, vocab_size=64, max_new=6,
                           rate=0.0, seed=5, prefix_len=p), (p, 5))
       for p in (8, 12)},
}
# the attention check: 16 pool rows, 4 a rank; slot 0's pages all on rank
# 1, slot 1's on ranks 0, 1 and 3, slot 2 inactive, slot 3's on ranks 2
# and 0
ATTN_ROWS, PT, MAXP = 16, 8, 4
ATTN_TABLE = [[4, 5, 6, -1], [2, 7, 13, -1], [-1] * 4, [11, 0, -1, -1]]
ATTN_POS = [20, 17, 0, 9]
ATTN_OK = [True, True, False, True]
ATTN_SEED = 7


def _tcfg(cfg: ModelConfig) -> TModelConfig:
    return TModelConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(TModelConfig)})


def _tokens(summary):
    return {int(rid): r["tokens"] for rid, r in summary["results"].items()}


def _prefix(case):
    p = CASES[case][3]
    return None if p is None else tsched.shared_prefix_tokens(
        p[0], 64, seed=p[1])


# every rank: each case's serve run over the mesh engine, then one decode
# step's split attention; rank 0 prints the summaries' tokens
RANKS = r"""
import json
from tpudist_torch.config import ModelConfig, ParallelConfig
from tpudist_torch.models import get_model
from tpudist_torch.models import transformer as T
from tpudist_torch.parallel import mesh as mesh_lib
from tpudist_torch.serve import scheduler as sched
from tpudist_torch.serve.engine import PagedServeEngine, PoolGroup

a = dict(np.load(ARGS[0]))
cases = json.loads(open(ARGS[1]).read())
mesh = mesh_lib.build_mesh(ParallelConfig(), device_type="cpu")
out = {"rank": RANK, "runs": {}}

for name, (cfg_kw, engine_kw, stream, prefix) in cases.items():
    cfg = ModelConfig(**cfg_kw)
    params = get_model(cfg.name).init(cfg, generator=torch.Generator())
    params.load_state_dict({k[len(cfg.name) + 1:]: torch.from_numpy(v)
                            for k, v in a.items()
                            if k.startswith(cfg.name + ".")})
    engine = PagedServeEngine(cfg, device="cpu", mesh=mesh, **engine_kw)
    run = {}
    if RANK == 0:
        engine.warmup(params)
        summary = sched.run_serve(
            engine, params, sched.make_requests(**stream),
            shared_prefix=None if prefix is None else np.asarray(prefix))
        engine.stop_followers()
        engine.assert_two_programs()
        run["tokens"] = {rid: r["tokens"]
                         for rid, r in summary["results"].items()}
        for key in ("completed", "n_chips", "admitted", "verify_compiles",
                    "shared_prefix_len"):
            run[key] = summary[key]
        run["held"] = [engine.alloc.shared_len, engine.alloc.pages_used()]
    else:
        engine.follow(params)
    g = engine.pool_group
    run["programs"] = [*engine.compile_counts(), len(engine.verify_traces)]
    run["prefills"] = engine.local_prefills
    run["pool"] = None if g is None else [g.lo, g.rows, g.n_rows, g.ways]
    run["pool_shape"] = list(engine._state.pool_k.shape)
    out["runs"][name] = run

t = {k: torch.from_numpy(a["attn_" + k]) for k in (
    "q", "k", "v", "pool_k", "pool_v", "table", "pos", "ok")}
rows = a["attn_pool_k"].shape[0] // WORLD
group = mesh_lib.axes_group(mesh, ("data", "fsdp"))
g = PoolGroup(group, WORLD, RANK, RANK * rows, rows, rows * WORLD)
own = lambda p: torch.cat([p[g.lo:g.lo + rows], torch.zeros_like(p[:1])])
with torch.no_grad():
    o, pk, pv = T._paged_attention_split(
        t["q"], t["k"], t["v"], own(t["pool_k"]), own(t["pool_v"]),
        t["table"], t["pos"], t["ok"], 8, g)
out["attn"] = {"o": o.tolist(), "k": pk[:rows].tolist(),
               "v": pv[:rows].tolist()}
print("RESULT " + json.dumps(out), flush=True)
"""


def _carried(cfg: ModelConfig):
    mesh = build_mesh(ParallelConfig(), devices=jax.devices()[:1])
    params = init_params(cfg, mesh, seed=0)
    return {k: v.numpy() for k, v in convert.params_from_jax(
        jax.device_get(params)).items()}


def _attn_inputs():
    rng = np.random.default_rng(ATTN_SEED)
    s, h, kv, hd = len(ATTN_TABLE), 4, 2, 8
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return {"q": f(s, 1, h, hd), "k": f(s, 1, kv, hd), "v": f(s, 1, kv, hd),
            "pool_k": f(ATTN_ROWS, PT, kv, hd),
            "pool_v": f(ATTN_ROWS, PT, kv, hd),
            "table": np.asarray(ATTN_TABLE, np.int64),
            "pos": np.asarray(ATTN_POS, np.int64)[:, None],
            "ok": np.asarray(ATTN_OK)[:, None]}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The four gloo ranks' results (started first, so the JAX runs
    overlap them), the JAX references and the port's one-rank tokens."""
    tmp = tmp_path_factory.mktemp("serve_mesh_paged")
    arrays = {}
    for cfg in (TINY_TF, TINY_MOE):
        arrays.update({f"{cfg.name}.{k}": v
                       for k, v in _carried(cfg).items()})
    attn = _attn_inputs()
    arrays.update({f"attn_{k}": v for k, v in attn.items()})
    np.savez(tmp / "params.npz", **arrays)
    cases = {name: (dataclasses.asdict(_tcfg(cfg)), kw, stream,
                    None if _prefix(name) is None
                    else [int(x) for x in _prefix(name)])
             for name, (cfg, kw, stream, _) in CASES.items()}
    (tmp / "cases.json").write_text(json.dumps(cases))
    wait = start_ranks(RANKS, WORLD, tmp / "params.npz", tmp / "cases.json")

    jmesh = build_mesh(ParallelConfig(), devices=jax.devices()[:WORLD])
    jone = build_mesh(ParallelConfig(), devices=jax.devices()[:1])
    jax_tokens, one_rank = {}, {}
    for name, (cfg, kw, stream, prefix) in CASES.items():
        shared = _prefix(name)
        if prefix is None:
            # the JAX paged engine on four devices
            jparams = init_params(cfg, jmesh, seed=0)
            eng = JPaged(cfg, jmesh, **kw)
        else:
            # the dense engine, which the JAX tests pin these to
            jparams = init_params(cfg, jone, seed=0)
            eng = JDense(cfg, jone, **{k: v for k, v in kw.items()
                                       if k not in ("page_tokens",
                                                    "speculate_k")})
        eng.warmup(jparams)
        summary = jsched.run_serve(eng, jparams,
                                   jsched.make_requests(**stream))
        eng.assert_two_programs()
        jax_tokens[name] = _tokens(summary)
        model = get_model(cfg.name).init(_tcfg(cfg),
                                         generator=torch.Generator())
        model.load_state_dict({k[len(cfg.name) + 1:]: torch.from_numpy(v)
                               for k, v in arrays.items()
                               if k.startswith(cfg.name + ".")})
        eng = TPaged(_tcfg(cfg), device="cpu", **kw)
        eng.warmup(model)
        summary = tsched.run_serve(eng, model, tsched.make_requests(**stream),
                                   shared_prefix=shared)
        eng.assert_two_programs()
        one_rank[name] = _tokens(summary)

    ranks = []
    for text in wait(240):
        line, = [ln for ln in text.splitlines()
                 if ln.startswith("RESULT ")]
        ranks.append(json.loads(line[len("RESULT "):]))
    return {"ranks": ranks, "jax": jax_tokens, "one": one_rank,
            "attn": attn}


def _pool_spec(pages):
    shape = (2, pages + 1, 8, 2, 8)
    jmesh = build_mesh(ParallelConfig(), devices=jax.devices()[:WORLD])
    want = jshd.sanitize_specs(jax.ShapeDtypeStruct(shape, jnp.float32),
                               jshd.paged_kv_cache_specs(), jmesh)
    spec = tkv.PagedCacheSpec.from_model(_tcfg(TINY_TF), slots=4,
                                         max_seq=32, page_tokens=8,
                                         pages=pages)
    grid = tmesh.rank_grid(tmesh.ParallelConfig(), WORLD)
    return tuple(want), tkv.paged_cache_spec_on(spec, grid), spec, grid


# ------------------------------------------------------------ (a)-(c)

@pytest.mark.parametrize("pages,split", [(15, True), (11, True), (8, False),
                                         (16, False)])
def test_pool_spec_and_spans_equal_jax(pages, split):
    """The sanitised pool spec equals JAX's on a 4-device mesh, splitting
    the ``pages + 1`` rows only where 4 divides them; each rank's rows
    are its contiguous chunk, the trash page on the last."""
    want, got, spec, grid = _pool_spec(pages)
    assert got == want
    assert (got[1] == ("data", "fsdp")) == split
    spans = [tkv.pool_span(spec, grid, r) for r in range(WORLD)]
    n = pages + 1
    assert spans == ([(r * n // 4, (r + 1) * n // 4) for r in range(WORLD)]
                     if split else [(0, n)] * WORLD)


@pytest.mark.parametrize("case", list(CASES))
def test_paged_mesh_tokens_equal_jax_and_one_rank(served, case):
    run = served["ranks"][0]["runs"][case]
    assert run["completed"] == CASES[case][2]["n"]
    assert run["n_chips"] == WORLD
    got = {int(rid): t for rid, t in run["tokens"].items()}
    assert got == served["jax"][case] == served["one"][case]


@pytest.mark.parametrize("case", list(CASES))
def test_paged_mesh_pins_prefills_and_pool_rows(served, case):
    """Every rank built 1 prefill, 1 decode and (speculating) 1 verify
    program and ran every prefill (the admissions and a prefix's
    registration); a split pool holds its 4 rows and the discard row."""
    cfg, kw, stream, prefix = CASES[case]
    runs = [r["runs"][case] for r in served["ranks"]]
    want_programs = [1, 1, 1 if kw.get("speculate_k") else 0]
    prefills = runs[0]["admitted"] + (prefix is not None)
    split = "pages" in kw
    for r, run in enumerate(runs):
        assert run["programs"] == want_programs, (r, run)
        assert run["prefills"] == prefills, (r, run)
        if split:
            assert run["pool"] == [4 * r, 4, 16, 4]
            assert run["pool_shape"][1] == 5
        else:
            assert run["pool"] is None
            assert run["pool_shape"][1] == runs[0]["pool_shape"][1]
    if prefix is not None:
        full = prefix[0] // 8 * 8
        assert runs[0]["shared_prefix_len"] == prefix[0]
        assert runs[0]["held"] == [full, full // 8]
        assert runs[0]["verify_compiles"] == want_programs[2]


def test_split_attention_equals_the_replicated_pool(served):
    """One decode step over 4 slots: a slot whose pages lie on one rank,
    one whose pages span three ranks, an inactive slot (every key masked:
    the uniform mean over the whole pool) and a slot across two ranks.
    The four ranks' merged outputs equal the replicated pool's and the
    JAX function's within f32 1e-5 of each largest element, and the
    rows each rank wrote equal the replicated pool's."""
    a = served["attn"]
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    with torch.no_grad():
        want, wk, wv = ttf._paged_attention(
            t["q"], t["k"], t["v"], t["pool_k"].clone(),
            t["pool_v"].clone(), t["table"], t["pos"], t["ok"], PT)
    jo, _, _ = jtf._paged_attention(
        *(jnp.asarray(a[k]) for k in ("q", "k", "v", "pool_k", "pool_v")),
        jnp.asarray(a["table"], jnp.int32), jnp.asarray(a["pos"], jnp.int32),
        jnp.asarray(a["ok"]), PT)
    want = want.numpy()
    np.testing.assert_allclose(np.asarray(jo), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))
    rows = ATTN_ROWS // WORLD
    for r, rank in enumerate(served["ranks"]):
        got = np.asarray(rank["attn"]["o"], np.float32)
        assert np.isfinite(got).all()
        for s in range(len(ATTN_TABLE)):
            np.testing.assert_allclose(
                got[s], want[s], rtol=0,
                atol=1e-5 * float(np.abs(want[s]).max()), err_msg=f"slot {s}")
        np.testing.assert_array_equal(np.asarray(rank["attn"]["k"]),
                                      wk[r * rows:(r + 1) * rows].numpy())
        np.testing.assert_array_equal(np.asarray(rank["attn"]["v"]),
                                      wv[r * rows:(r + 1) * rows].numpy())
    # the inactive slot is the mean of every value in the written pool
    mean = wv.numpy().reshape(-1, 2, 8).mean(0)
    np.testing.assert_allclose(want[2, 0].reshape(4, 8),
                               np.repeat(mean, 2, axis=0), rtol=0, atol=1e-5)
