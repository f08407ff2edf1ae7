"""The port's paged serving plane against the JAX package's.

* ``PageAllocator``: the same operation sequences (FIFO reuse,
  all-or-nothing admission and growth with rollback, refcount underflow,
  eviction mid-share, the copy-on-write fork at a page boundary,
  ``can_ever_admit``, ``set_memory_bound``, seeded random walks) leave
  the port's allocator in the JAX allocator's state and raise the same
  errors; ``PagedCacheSpec`` gives the JAX package's shapes and bytes.
* ``_paged_attention`` on seeded numpy inputs (window 1 and 4, grouped
  kv heads, unmapped rows, masked writes, clamped capacity): ``o`` within
  f32 1e-5 of its largest element, the pools bitwise outside the trash
  page; ``paged_hidden_states`` within f32 1e-5.
* ``make_requests(prefix_len=)``, ``shared_prefix_tokens`` and
  ``ngram_draft`` bitwise the JAX functions.
* Greedy tokens on carried params: the port's paged engine (plain,
  shared prefix 8 and 12, speculative) equals the port's dense engine
  and the JAX ``PagedServeEngine``; a scripted prefill / decode / verify
  sequence equals the JAX engine's output by output.
* The program pins, backpressure against the ``kv_pages_exhausted``
  reject, growth-failure eviction, the fixed-memory pair, the paged
  footprint in ``serve_tick`` and the summary, and, under virtual time,
  the whole summary and every record equal to the JAX ``run_serve``'s.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudist.config import ModelConfig, ParallelConfig
from tpudist.models import transformer as jtf
from tpudist.parallel import build_mesh
from tpudist.serve import kvcache as jkv
from tpudist.serve import resilience as jres
from tpudist.serve import scheduler as jsched
from tpudist.serve.engine import PagedServeEngine as JPaged
from tpudist.serve.engine import init_params
from tpudist_torch import convert
from tpudist_torch.config import ModelConfig as TModelConfig
from tpudist_torch.models import transformer as ttf
from tpudist_torch.serve import cli as tcli
from tpudist_torch.serve import kvcache as tkv
from tpudist_torch.serve import resilience as tres
from tpudist_torch.serve import scheduler as tsched
from tpudist_torch.serve.engine import PagedServeEngine as TPaged
from tpudist_torch.serve.engine import ServeEngine as TDense

torch.set_num_threads(1)

TINY_TF = ModelConfig(name="transformer", vocab_size=64, n_layers=2,
                      d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                      max_seq_len=32)
F32_TOL = 1e-5


def _tcfg(cfg: ModelConfig) -> TModelConfig:
    return TModelConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(TModelConfig)})


class RecMetrics:
    """A MetricsLogger stand-in that records instead of writing."""

    def __init__(self):
        self.recs = []

    def log(self, **kv):
        self.recs.append(kv)

    def flush(self):
        pass


@pytest.fixture(scope="module")
def jparams():
    mesh = build_mesh(ParallelConfig(), devices=jax.devices()[:1])
    return mesh, init_params(TINY_TF, mesh, seed=0)


@pytest.fixture(scope="module")
def tmodel(jparams):
    model = ttf.Transformer(_tcfg(TINY_TF), device="cpu")
    model.load_state_dict(convert.params_from_jax(
        jax.device_get(jparams[1])))
    return model


@pytest.fixture(scope="module")
def engines(jparams, tmodel):
    """Warmed engines by (package, paged, kwargs), built once a module:
    ``run_serve`` resets an engine's state and allocator itself."""
    cache = {}

    def get(pkg, paged=True, **kw):
        key = (pkg, paged, tuple(sorted(kw.items())))
        if key not in cache:
            if pkg == "jax":
                mesh, params = jparams
                from tpudist.serve.engine import ServeEngine as JDense
                eng = (JPaged if paged else JDense)(TINY_TF, mesh, **kw)
            else:
                params = tmodel
                eng = (TPaged if paged else TDense)(_tcfg(TINY_TF),
                                                    device="cpu", **kw)
            eng.warmup(params)
            cache[key] = (eng, params)
        return cache[key]
    return get


def _tokens(summary):
    return {rid: r["tokens"] for rid, r in summary["results"].items()}


def _run(pkg, engine, params, requests, **kw):
    sched = jsched if pkg == "jax" else tsched
    if pkg == "jax":
        kw["n_chips"] = 1
    return sched.run_serve(engine, params, requests, **kw)


# ------------------------------------------------------------ allocator


def _specs(slots=2, max_seq=16, pt=4, pages=0):
    kw = dict(slots=slots, max_seq=max_seq, page_tokens=pt, pages=pages)
    return (jkv.PagedCacheSpec.from_model(TINY_TF, **kw),
            tkv.PagedCacheSpec.from_model(_tcfg(TINY_TF), **kw))


def _alloc_state(a):
    return (a.table.tolist(), list(a.free), a.refcount.tolist(),
            tuple(int(p) for p in a.shared_pages), a.shared_len,
            a.page_cap, a.bound_source, a.pages_used())


class Twin:
    """The JAX and the port allocator driven by one script: each call
    goes to both, and the return values, the errors and the whole state
    must agree after it."""

    def __init__(self, **kw):
        js, ts = _specs(**kw)
        self.j, self.t = jkv.PageAllocator(js), tkv.PageAllocator(ts)

    def __getattr__(self, name):
        def call(*args, **kw):
            out = []
            for a, err in ((self.j, jkv.PageAllocatorError),
                           (self.t, tkv.PageAllocatorError)):
                try:
                    r = getattr(a, name)(*args, **kw)
                    out.append(("ok", r.tolist() if isinstance(
                        r, np.ndarray) else r))
                except err as e:
                    out.append(("raise", str(e)))
            assert out[0] == out[1], (name, args, out)
            assert _alloc_state(self.j) == _alloc_state(self.t), (name,
                                                                   args)
            if out[0][0] == "raise":
                raise tkv.PageAllocatorError(out[0][1])
            return out[1][1]
        return call


def test_allocator_fifo_reuse_and_rollback_equal_jax():
    a = Twin(slots=2, pages=3)
    assert a.admit(0, 8)
    assert not a.admit(1, 8)               # all-or-nothing rollback
    a.free_slot(0)
    assert a.admit(1, 8)
    assert a.row(1)[:2] == [2, 0]          # FIFO: 2 was never used
    assert not a.ensure(1, 15)             # growth rollback
    assert a.ensure(1, 11)
    assert a.pages_used() == 3


def test_allocator_underflow_and_double_admit_raise_as_jax():
    a = Twin(pages=2)
    with pytest.raises(tkv.PageAllocatorError, match="underflow"):
        a._drop(0)
    assert a.admit(0, 4)
    with pytest.raises(tkv.PageAllocatorError, match="still holding"):
        a.admit(0, 4)


def test_allocator_eviction_mid_share_equals_jax():
    a = Twin(slots=3, max_seq=16, pt=4, pages=6)
    assert a.register_shared(8) == (0, 1)
    assert a.admit(0, 12, shared=True)
    assert a.admit(1, 12, shared=True)
    a.free_slot(0)                         # eviction mid-share
    assert a.admit(2, 12, shared=True)
    a.free_slot(1)
    a.free_slot(2)
    a.free_slot(0)                         # an empty slot: a no-op
    assert a.pages_used() == 2
    assert a.j.refcount[:2].tolist() == [1, 1]


def test_allocator_register_and_cow_fork_equal_jax():
    a = Twin(pages=1)
    with pytest.raises(tkv.PageAllocatorError, match="cannot hold"):
        a.register_shared(8)
    assert a.register_shared(4) == (0,)
    with pytest.raises(tkv.PageAllocatorError, match="already"):
        a.register_shared(4)
    assert Twin(pages=2).register_shared(3) == ()
    # a prefix on the page boundary: the prefix-long prompt takes no
    # private page, one token more forks exactly one
    b = Twin(slots=2, max_seq=16, pt=4, pages=4)
    b.register_shared(8)
    assert b.admit(0, 8, shared=True) and b.pages_used() == 2
    assert b.admit(1, 9, shared=True) and b.pages_used() == 3
    assert b.admit_shared_len(True) == 8 and b.admit_shared_len(False) == 0


def test_allocator_can_ever_admit_and_memory_bound_equal_jax():
    a = Twin(slots=2, max_seq=16, pt=4, pages=3)
    a.register_shared(4)
    assert a.can_ever_admit(12, shared=True)
    assert not a.can_ever_admit(12, shared=False)
    assert not a.can_ever_admit(16, shared=True)
    page = 2 * 2 * 4 * 2 * 8 * 4           # K+V, L, pt, kv, hd, f32
    for kw in (dict(hbm_bytes=1e9, params_bytes=1e3),
               dict(hbm_bytes=2 * page + 32, params_bytes=0),
               dict(hbm_bytes=2 * page + 32, params_bytes=0,
                    program_temp_bytes=page),
               dict(hbm_bytes=10, params_bytes=100,
                    program_temp_bytes=None),
               dict(hbm_bytes=5 * page, params_bytes=page / 4)):
        a.set_memory_bound(**kw)
        a.can_ever_admit(8, shared=False)
    a.set_memory_bound(hbm_bytes=2 * page + 32, params_bytes=0)
    assert a.admit(0, 4, shared=True)      # the registry page: no cap hit
    assert not a.admit(1, 8)               # the cap of 2 live pages holds


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_random_walks_equal_jax(seed):
    rng = np.random.default_rng(seed)
    a = Twin(slots=3, max_seq=24, pt=4, pages=9)
    a.register_shared(int(rng.integers(0, 10)))
    held = set()
    for _ in range(60):
        slot = int(rng.integers(0, 3))
        op = rng.integers(0, 4)
        if op == 0 and slot not in held:
            if a.admit(slot, int(rng.integers(1, 17)),
                       shared=bool(rng.integers(0, 2))):
                held.add(slot)
        elif op == 1 and slot in held:
            a.ensure(slot, int(rng.integers(0, 30)))
        elif op == 2:
            a.free_slot(slot)
            held.discard(slot)
        else:
            a.can_ever_admit(int(rng.integers(1, 25)),
                             bool(rng.integers(0, 2)))


@pytest.mark.parametrize("kw", [dict(slots=2, max_seq=16, pt=4, pages=6),
                                dict(slots=3, max_seq=30, pt=8, pages=0),
                                dict(slots=1, max_seq=16, pt=16, pages=0)])
def test_paged_spec_equals_jax(kw):
    js, ts = _specs(**kw)
    for name in ("max_pages_per_slot", "pool_shape", "table_bytes",
                 "bytes", "pages", "page_tokens"):
        assert getattr(ts, name) == getattr(js, name), name
    cfg = _tcfg(TINY_TF)
    jb = jkv.PagedCacheSpec.from_model(TINY_TF, slots=2, max_seq=16,
                                       page_tokens=4, dtype=jnp.bfloat16)
    tb = tkv.PagedCacheSpec.from_model(cfg, slots=2, max_seq=16,
                                       page_tokens=4, dtype=torch.bfloat16)
    assert tb.bytes == jb.bytes
    for bad in (0, 32):
        with pytest.raises(ValueError, match="kv-page-tokens"):
            tkv.PagedCacheSpec.from_model(cfg, slots=2, max_seq=16,
                                          page_tokens=bad)
    pool = tkv.init_paged_cache(ts, "cpu")
    assert tuple(pool["k"].shape) == ts.pool_shape
    assert not pool["v"].any()


# ------------------------------------------------------------ attention


def _attention_inputs(seed, w, s=3, h=4, kv=2, hd=8, pt=4, pages=7,
                      maxp=4):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    max_seq = pt * maxp
    table = np.full((s, maxp), -1, np.int32)
    perm = rng.permutation(pages)
    table[0, :3] = perm[:3]                # slot 0: three pages
    table[1, :2] = perm[3:5]               # slot 1: two pages
    # slot 2 stays unmapped: its writes go to trash, it reads nothing
    lengths = np.array([9, 5, 0])
    raw = lengths[:, None] + np.arange(w)[None, :]
    if w > 1:
        raw[0] = max_seq - 2 + np.arange(w)    # past the capacity
    positions = np.minimum(raw, max_seq - 1).astype(np.int32)
    write_ok = (raw < max_seq) & np.array([True, True, False])[:, None]
    if w > 1:
        write_ok[1, -1] = False            # a masked write
    return dict(q=f(s, w, h, hd), k_new=f(s, w, kv, hd),
                v_new=f(s, w, kv, hd), pool_k=f(pages + 1, pt, kv, hd),
                pool_v=f(pages + 1, pt, kv, hd), page_table=table,
                positions=positions, write_ok=write_ok), pt


@pytest.mark.parametrize("w", [1, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_paged_attention_equals_jax(w, seed):
    ins, pt = _attention_inputs(seed, w)
    jo, jpk, jpv = jtf._paged_attention(
        *(jnp.asarray(ins[k]) for k in ("q", "k_new", "v_new", "pool_k",
                                        "pool_v", "page_table",
                                        "positions", "write_ok")), pt)
    t = {k: torch.from_numpy(np.array(v)) for k, v in ins.items()}
    to, tpk, tpv = ttf._paged_attention(
        t["q"], t["k_new"], t["v_new"], t["pool_k"], t["pool_v"],
        t["page_table"], t["positions"], t["write_ok"], pt)
    jo = np.asarray(jo)
    scale = np.abs(jo).max()
    np.testing.assert_allclose(to.numpy(), jo, rtol=0,
                               atol=F32_TOL * scale)
    # the pools written in place, bitwise outside the trash page
    assert tpk is t["pool_k"]
    np.testing.assert_array_equal(tpk.numpy()[:-1], np.asarray(jpk)[:-1])
    np.testing.assert_array_equal(tpv.numpy()[:-1], np.asarray(jpv)[:-1])


def test_paged_hidden_states_equals_jax(jparams, tmodel):
    rng = np.random.default_rng(3)
    cfg = TINY_TF
    ins, pt = _attention_inputs(4, 4, hd=cfg.d_model // cfg.n_heads)
    pool = rng.standard_normal((cfg.n_layers, 8, pt, cfg.n_kv_heads,
                                cfg.d_model // cfg.n_heads)
                               ).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, size=(3, 4)).astype(np.int32)
    jh, jpk, jpv = jtf.paged_hidden_states(
        jparams[1], jnp.asarray(tokens), cfg, dtype=jnp.float32,
        pool_k=jnp.asarray(pool), pool_v=jnp.asarray(pool * 0.5),
        page_table=jnp.asarray(ins["page_table"]),
        positions=jnp.asarray(ins["positions"]),
        write_ok=jnp.asarray(ins["write_ok"]), page_tokens=pt)
    tk, tv = torch.from_numpy(pool.copy()), torch.from_numpy(pool * 0.5)
    th, tpk, tpv = ttf.paged_hidden_states(
        tmodel, torch.from_numpy(tokens).long(), _tcfg(cfg),
        dtype=torch.float32, pool_k=tk, pool_v=tv,
        page_table=torch.from_numpy(ins["page_table"]),
        positions=torch.from_numpy(ins["positions"]),
        write_ok=torch.from_numpy(ins["write_ok"]), page_tokens=pt)
    for got, want in ((th, jh), (tpk, jpk), (tpv, jpv)):
        want = np.asarray(want)
        if want.ndim == 5:                 # pools: the trash page apart
            got, want = got[:, :-1], want[:, :-1]
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=F32_TOL * np.abs(want).max())


# -------------------------------------------------- requests and drafts


@pytest.mark.parametrize("prefix_len", [0, 5, 8, 20])
@pytest.mark.parametrize("rate", [0.0, 100.0])
def test_make_requests_with_prefix_equals_jax(prefix_len, rate):
    kw = dict(n=9, prompt_pad=16, vocab_size=64, max_new=5, rate=rate,
              seed=4, prefix_len=prefix_len)
    got, want = tsched.make_requests(**kw), jsched.make_requests(**kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.rid, g.arrival_s, g.prompt_len, g.max_new) == \
            (w.rid, w.arrival_s, w.prompt_len, w.max_new)
        assert g.tokens.dtype == w.tokens.dtype
        np.testing.assert_array_equal(g.tokens, w.tokens)
    for n, seed in ((0, 1), (7, 2), (256, 9)):
        np.testing.assert_array_equal(
            tsched.shared_prefix_tokens(n, 32000, seed),
            jsched.shared_prefix_tokens(n, 32000, seed))


def test_ngram_draft_equals_jax():
    assert tsched.ngram_draft([1, 2, 3, 1], 2) == [2, 3]
    assert tsched.ngram_draft([5], 3) == [5, 5, 5]
    rng = np.random.default_rng(8)
    for _ in range(40):
        hist = rng.integers(0, 6, size=int(rng.integers(1, 30)))
        k = int(rng.integers(0, 6))
        assert tsched.ngram_draft(hist, k) == jsched.ngram_draft(hist, k)


# ------------------------------------------------------- greedy tokens


PLAIN = dict(slots=2, max_seq=32, prompt_pad=8, decode_k=4)
PREFIXED = dict(slots=2, max_seq=32, prompt_pad=16, decode_k=4)
SPEC = dict(slots=3, max_seq=32, prompt_pad=16, decode_k=4)


@pytest.mark.parametrize("lane", ["plain", "prefix8", "prefix12", "spec4"])
def test_greedy_tokens_paged_equal_dense_and_jax(engines, lane):
    """Port paged = port dense = JAX paged, bitwise, on carried params:
    plain paging, a shared prefix ending on the page boundary (8: the
    fork takes no private page) and inside a page (12: the tail forked
    by recomputation), and speculation (window 4) over a prefix."""
    kw, prefix, spec, reqs = {
        "plain": (PLAIN, 0, 0, dict(n=5, prompt_pad=8, max_new=6,
                                    seed=3)),
        "prefix8": (PREFIXED, 8, 0, dict(n=6, prompt_pad=16, max_new=6,
                                         seed=5)),
        "prefix12": (PREFIXED, 12, 0, dict(n=6, prompt_pad=16, max_new=6,
                                           seed=5)),
        "spec4": (SPEC, 8, 4, dict(n=8, prompt_pad=16, max_new=10,
                                   seed=13)),
    }[lane]
    shared = (tsched.shared_prefix_tokens(prefix, 64, reqs["seed"])
              if prefix else None)
    stream = dict(vocab_size=64, rate=0.0, prefix_len=prefix, **reqs)
    runs = {}
    for tag, pkg, paged in (("jax", "jax", True), ("dense", "torch", False),
                            ("paged", "torch", True)):
        ekw = dict(kw, page_tokens=8, speculate_k=spec) if paged else kw
        eng, params = engines(pkg, paged, **ekw)
        sched = jsched if pkg == "jax" else tsched
        summary = _run(pkg, eng, params, sched.make_requests(**stream),
                       shared_prefix=shared if paged else None)
        eng.assert_two_programs()
        assert summary["completed"] == reqs["n"], summary["partition"]
        runs[tag] = summary
    assert _tokens(runs["paged"]) == _tokens(runs["dense"])
    assert _tokens(runs["paged"]) == _tokens(runs["jax"])
    got = runs["paged"]
    assert got["shared_prefix_len"] == prefix
    assert got["verify_compiles"] == (1 if spec else 0)
    assert got["speculate_k"] == spec
    if spec:
        assert got["spec_accept_rate"] == runs["jax"]["spec_accept_rate"]
        assert 0.0 <= got["spec_accept_rate"] <= 1.0
    eng = engines("torch", True, **dict(kw, page_tokens=8,
                                        speculate_k=spec))[0]
    full = (prefix // 8) * 8
    # the registry hold keeps the prefix's full pages after the drain
    assert eng.alloc.shared_len == full
    assert eng.alloc.pages_used() == full // 8


def _state(state):
    return {n: np.asarray(getattr(state, n)) for n in
            ("lengths", "last_token", "active", "remaining")}


def test_engine_outputs_equal_jax_step_by_step(jparams, tmodel):
    """A scripted sequence on both engines (a registered prefix, shared
    and private admissions, growth, decode on two rungs and verify with
    partial dispatch masks, a slot refilled): every token, valid flag,
    emitted count and state vector equals the JAX engine's, and the
    pools agree within f32 1e-5 at every position below each slot's
    length."""
    mesh, jp = jparams
    kw = dict(slots=3, max_seq=16, prompt_pad=8, decode_k=4,
              page_tokens=4, pages=10, speculate_k=3, adapt_ladder=(4, 2))
    je = JPaged(TINY_TF, mesh, **kw)
    te = TPaged(_tcfg(TINY_TF), device="cpu", **kw)
    je.warmup(jp)
    te.warmup(tmodel)
    js, ts = je.init_state(), te.init_state()
    je.new_allocator()
    te.new_allocator()
    prefix = jsched.shared_prefix_tokens(5, 64, 2)
    js = je.register_prefix(jp, js, prefix, 5)
    ts = te.register_prefix(tmodel, ts, prefix, 5)
    reqs = jsched.make_requests(4, prompt_pad=8, vocab_size=64, max_new=9,
                                rate=0.0, seed=2, prefix_len=5)
    rng = np.random.default_rng(0)
    # slots left out of a dispatch while live keep their state
    script = [("admit", 0, 0, 9, True), ("admit", 1, 1, 8, False),
              ("decode", 4, [1, 1, 0]), ("verify", [1, 1, 0]),
              ("admit", 2, 2, 3, True), ("decode", 2, [0, 1, 1]),
              ("verify", [1, 0, 1]), ("verify", [1, 1, 1]), ("free", 0),
              ("admit", 3, 0, 6, True), ("verify", [1, 1, 1]),
              ("decode", 4, [1, 1, 1]), ("decode", 4, [1, 1, 1])]
    for step in script:
        if step[0] == "free":
            je.alloc.free_slot(step[1])
            te.alloc.free_slot(step[1])
            continue
        if step[0] == "admit":
            _, rid, slot, max_new, shared = step
            r = reqs[rid]
            for e in (je, te):
                assert e.alloc.admit(slot, r.prompt_len, shared=shared)
            sl = je.alloc.admit_shared_len(shared)
            js, jf = je.prefill(jp, js, r.tokens[None, :], r.prompt_len,
                                slot, max_new, shared_len=sl)
            ts, tf = te.prefill(tmodel, ts, r.tokens[None, :],
                                r.prompt_len, slot, max_new, shared_len=sl)
            assert int(tf) == int(jf), step
        else:
            mask = np.array(step[-1], bool)
            width = 3 if step[0] == "verify" else step[1]
            lengths = _state(js)["lengths"]
            for i in np.flatnonzero(mask):
                for e in (je, te):
                    if (e.alloc.table[i] >= 0).any():
                        e.alloc.ensure(i, min(int(lengths[i]) + width - 1,
                                              15))
            np.testing.assert_array_equal(te.alloc.table, je.alloc.table)
            if step[0] == "decode":
                js, jt, jv = je.decode(jp, js, step[1],
                                       dispatch_active=mask)
                ts, tt, tv = te.decode(tmodel, ts, step[1],
                                       dispatch_active=mask)
            else:
                draft = rng.integers(0, 64, size=(3, 2)).astype(np.int32)
                # one draft the greedy choice accepts: the next token
                draft[0, 0] = int(_state(js)["last_token"][0])
                js, jt, jv, je_ = je.verify(jp, js, draft,
                                            dispatch_active=mask)
                ts, tt, tv, te_ = te.verify(tmodel, ts, draft,
                                            dispatch_active=mask)
                np.testing.assert_array_equal(te_.numpy(), np.asarray(je_))
            np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        want = _state(js)
        for name, got in _state(ts).items():
            np.testing.assert_array_equal(got, want[name],
                                          err_msg=f"{name} {step}")
        for name in ("pool_k", "pool_v"):
            jpool = np.asarray(jax.device_get(getattr(js, name)))
            tpool = getattr(ts, name).numpy()
            for slot, n in enumerate(want["lengths"]):
                row = je.alloc.table[slot]
                for pos in range(min(int(n), 16)):
                    pg = row[pos // 4]
                    if pg < 0:
                        continue
                    np.testing.assert_allclose(
                        tpool[:, pg, pos % 4], jpool[:, pg, pos % 4],
                        rtol=0, atol=F32_TOL * np.abs(jpool).max(),
                        err_msg=f"{name} slot {slot} pos {pos} {step}")
    assert te.compile_counts() == je.compile_counts() == (1, 2)
    assert len(te.verify_traces) == len(je.verify_traces) == 1


# ------------------------------------------------ pins and error paths


def test_program_pins_with_verify():
    cfg = _tcfg(TINY_TF)
    kw = dict(slots=2, max_seq=16, prompt_pad=4, decode_k=2, page_tokens=4,
              device="cpu")
    model = ttf.init(cfg, generator=torch.Generator().manual_seed(0))
    plain = TPaged(cfg, **kw)
    plain.warmup(model)
    plain.assert_two_programs()
    assert plain.verify_traces == [] and plain.compile_counts() == (1, 1)
    assert set(plain.program_memory()) == {"prefill", "decode_k2"}
    spec = TPaged(cfg, speculate_k=2, adapt_ladder=(2, 1), **kw)
    spec.warmup(model)
    spec.warmup(model)                     # builds nothing more
    spec.assert_two_programs()
    assert spec.compile_counts() == (1, 2) and len(spec.verify_traces) == 1
    assert set(spec.program_memory()) == {"prefill", "decode_k2",
                                          "decode_k1", "verify"}
    spec.verify_traces.append("verify")    # a second verify program
    with pytest.raises(AssertionError, match="verify"):
        spec.assert_two_programs()
    for bad in (1, -2):
        with pytest.raises(ValueError, match="speculate-k"):
            TPaged(cfg, speculate_k=bad, **kw)
    with pytest.raises(ValueError, match="requires speculate_k"):
        plain.verify(model, plain.init_state(), np.zeros((2, 1)))
    # the memory bound is the device's, not the run's: a new allocator
    # (one a serve run) keeps it, the registry and the table it drops
    cap = plain.alloc.set_memory_bound(hbm_bytes=3 * 2 * 2 * 4 * 2 * 8 * 4,
                                       params_bytes=0)
    plain.alloc.register_shared(4)
    fresh = plain.new_allocator()
    assert (fresh.page_cap, fresh.bound_source) == (cap, "heuristic")
    assert cap == 2 and fresh.shared_pages == () and fresh.pages_used() == 0
    # the card unless the CPU is asked for; the CPU runs no kernel
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TPaged(cfg, **{k: v for k, v in kw.items() if k != "device"})
    assert spec.kernel_launches() == 0


def _req(rid, prompt_len, pad, max_new=3, step=5):
    toks = np.zeros((pad,), np.int32)
    toks[:prompt_len] = (np.arange(prompt_len) * step + rid + 1) % 64
    return dict(rid=rid, arrival_s=0.0, tokens=toks,
                prompt_len=prompt_len, max_new=max_new)


def test_backpressure_and_exact_reject_equal_jax(engines):
    """rid 0 needs 3 pages of a 2-page pool: rejected
    ``kv_pages_exhausted``; rids 1 and 2 need 2 pages each: rid 2 waits
    for rid 1 (backpressure), then completes. The partition is exact, the
    pool drains, and the summary and every record equal the JAX
    package's."""
    kw = dict(slots=2, max_seq=16, prompt_pad=12, decode_k=2,
              page_tokens=4, pages=2)
    runs = {}
    for pkg, sched in (("jax", jsched), ("torch", tsched)):
        eng, params = engines(pkg, True, **kw)
        m = RecMetrics()
        runs[pkg] = (_run(pkg, eng, params, [
            sched.Request(**_req(0, 12, 12)),
            sched.Request(**_req(1, 5, 12)),
            sched.Request(**_req(2, 5, 12))], metrics=m, tick_every=1,
            virtual=(jres if pkg == "jax" else tres).VirtualTiming()), m)
        assert eng.alloc.pages_used() == 0
    got, m = runs["torch"]
    part = got["partition"]
    assert part["admission_exact"] and part["outcome_exact"], part
    assert (got["rejected"], got["shed_at_admission"]) == (1, 0)
    assert got["completed"] == 2 and sorted(got["results"]) == [1, 2]
    rejects = [r for r in m.recs if r.get("event") == "rejected"]
    assert [(r["rid"], r["reason"]) for r in rejects] == \
        [(0, "kv_pages_exhausted")]
    _assert_summaries_equal(got, runs["jax"][0])
    assert m.recs == runs["jax"][1].recs


def test_growth_failure_evicts_and_frees_pages(engines):
    kw = dict(slots=2, max_seq=16, prompt_pad=4, decode_k=4,
              page_tokens=4, pages=3)
    eng, model = engines("torch", True, **kw)
    reqs = [tsched.Request(**_req(r, 4, 4, max_new=8, step=3))
            for r in range(2)]
    s = tsched.run_serve(eng, model, reqs)
    part = s["partition"]
    assert part["admission_exact"] and part["outcome_exact"], part
    assert s["truncated"] == 1 and part["evicted"] == 1
    assert s["completed"] == 2
    done = [r for r in s["results"].values() if r["why"] == "done"]
    assert len(done) == 1 and done[0]["generated"] == 8
    assert eng.alloc.pages_used() == 0
    jeng, jp = engines("jax", True, **kw)
    want = _run("jax", jeng, jp, [jsched.Request(**_req(r, 4, 4, max_new=8,
                                                        step=3))
                                  for r in range(2)])
    assert _tokens(s) == _tokens(want)


def test_fixed_memory_paged_sustains_more_slots(engines):
    """A paged pool strictly smaller in bytes than the dense arena (the
    trash page and the table included), 6 slots on 14 pages against 4
    dense slots, serves the same shared-prefix load with strictly more
    sequences at once and the same tokens."""
    shared = tsched.shared_prefix_tokens(8, 64, seed=21)
    dense, dm = engines("torch", False, slots=4, max_seq=32, prompt_pad=16,
                        decode_k=8)
    paged, pm = engines("torch", True, slots=6, max_seq=32, prompt_pad=16,
                        decode_k=8, page_tokens=8, pages=14)
    assert paged.spec.bytes < dense.spec.bytes
    reqs = dict(n=16, prompt_pad=16, vocab_size=64, max_new=8, rate=0.0,
                seed=21, prefix_len=8)
    d = tsched.run_serve(dense, dm, tsched.make_requests(**reqs))
    p = tsched.run_serve(paged, pm, tsched.make_requests(**reqs),
                         shared_prefix=shared)
    assert d["completed"] == p["completed"] == 16
    assert p["active_slots_peak"] > d["active_slots_peak"]
    assert 1 <= p["kv_pages_used_peak"] <= 14
    assert _tokens(p) == _tokens(d)


# ------------------------------------------------------------ summaries


def _assert_summaries_equal(got, want):
    shared = set(got) & set(want)
    # every key of the port's summary is one of the JAX summary's
    assert shared == set(got), set(got) - set(want)
    for key in sorted(shared):
        assert got[key] == want[key], key


def test_serve_tick_and_summary_report_paged_footprint(engines):
    eng, model = engines("torch", True, slots=2, max_seq=16, prompt_pad=4,
                         decode_k=2, page_tokens=4, speculate_k=2)
    m = RecMetrics()
    s = tsched.run_serve(eng, model, tsched.make_requests(
        4, prompt_pad=4, vocab_size=64, max_new=4, rate=0.0, seed=7),
        metrics=m, tick_every=1)
    ticks = [r for r in m.recs if r["kind"] == "serve_tick"]
    assert ticks
    for t in ticks:
        assert t["kv_cache_bytes"] == eng.spec.bytes
        assert t["kv_pages_total"] == eng.spec.pages
        assert 0 <= t["kv_pages_used"] <= eng.spec.pages
    assert s["kv_page_tokens"] == 4 and s["kv_pages_total"] == eng.spec.pages
    assert s["kv_pages_used_peak"] >= 1
    assert s["spec_accept_rate"] is not None
    # a dense run reports the paged keys as the JAX package does
    dense, dm = engines("torch", False, **PLAIN)
    d = tsched.run_serve(dense, dm, tsched.make_requests(
        2, prompt_pad=8, vocab_size=64, max_new=3, rate=0.0, seed=1))
    assert {k: d[k] for k in ("verify_compiles", "kv_page_tokens",
                              "kv_pages_total", "kv_pages_used_peak",
                              "spec_accept_rate", "speculate_k",
                              "shared_prefix_len")} == dict(
        verify_compiles=0, kv_page_tokens=0, kv_pages_total=0,
        kv_pages_used_peak=0, spec_accept_rate=None, speculate_k=0,
        shared_prefix_len=0)


@pytest.mark.parametrize("lane", ["paged", "prefix_spec"])
def test_summary_equals_jax_under_virtual_time(engines, lane):
    """Poisson arrivals on a bounded queue with a deadline, under virtual
    time: the whole summary (partition, shed, percentiles, pages peak,
    acceptance) and every metrics record equal the JAX ``run_serve``'s."""
    spec = 4 if lane == "prefix_spec" else 0
    prefix = 6 if lane == "prefix_spec" else 0
    kw = dict(slots=2, max_seq=24, prompt_pad=8, decode_k=4, page_tokens=4,
              pages=9, speculate_k=spec)
    stream = dict(n=24, prompt_pad=8, vocab_size=64, max_new=6, rate=600.0,
                  seed=11, prefix_len=prefix)
    runs = {}
    for pkg, sched, res in (("jax", jsched, jres), ("torch", tsched, tres)):
        eng, params = engines(pkg, True, **kw)
        m = RecMetrics()
        shared = sched.shared_prefix_tokens(prefix, 64, 11) if prefix \
            else None
        runs[pkg] = (_run(
            pkg, eng, params, sched.make_requests(**stream), metrics=m,
            tick_every=2, shared_prefix=shared,
            resilience=res.ResilienceConfig(queue_cap=5,
                                            ttft_deadline_s=0.03,
                                            validate=True),
            virtual=res.VirtualTiming(prefill_s=0.002, decode_s=0.004)), m)
    got, want = runs["torch"][0], runs["jax"][0]
    _assert_summaries_equal(got, want)
    assert runs["torch"][1].recs == runs["jax"][1].recs
    assert got["partition"]["admission_exact"]
    assert got["shed_total"] > 0 and got["kv_pages_used_peak"] > 0
    if spec:
        assert got["spec_accept_rate"] is not None
        assert got["verify_compiles"] == 1


def test_cli_serves_paged_with_the_memory_bound(tmp_path, capsys):
    """``--kv-page-tokens 8 --shared-prefix 8 --speculate-k 4`` on the
    CPU: the memory-bound line, every request, the paged summary line,
    the ledger's kv_pool equal to the pool's bytes and the BENCH_SERVE
    keys."""
    bench = tmp_path / "bench.json"
    assert tcli.main(["--device", "cpu", "--kv-page-tokens", "8",
                      "--shared-prefix", "8", "--speculate-k", "4",
                      "--requests", "8", "--max-new-tokens", "6",
                      "--save-dir", str(tmp_path),
                      "--bench-out", str(bench)]) == 0
    out = capsys.readouterr().out
    assert "tpudist: serve kv memory bound (heuristic): 32/32 pages " \
        "mappable" in out
    assert "1 prefill / 1 decode / 1 verify program(s)" in out
    assert "pages peak, spec accept" in out
    recs = [json.loads(ln) for ln in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    serve = [r for r in recs if r["kind"] == "serve"][0]
    led = [r for r in recs if r["kind"] == "memledger"][0]
    assert serve["completed"] == 8 and serve["kv_page_tokens"] == 8
    assert led["kv_pool_bytes"] == serve["kv_cache_bytes"]
    spec = tkv.PagedCacheSpec.from_model(_tcfg(ModelConfig(
        name="transformer", vocab_size=256, n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128)), slots=4, max_seq=64,
        page_tokens=8)
    assert serve["kv_cache_bytes"] == spec.bytes
    detail = json.loads(bench.read_text())["detail"]
    assert (detail["verify_compiles"], detail["speculate_k"],
            detail["shared_prefix_len"]) == (1, 4, 8)
    assert detail["kv_pages_used_peak"] >= 1
