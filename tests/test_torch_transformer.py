"""The port's transformer (``tpudist_torch.models.transformer``) against
the JAX package's, on the same parameters.

The JAX package's seeded parameters are fetched to numpy and carried
into the port's module name for name (``tpudist_torch.convert``); every
other input is made with numpy and handed to both. Two shapes:

* ``TINY_TF`` (head_dim 8): both packages take the dense attention path;
* ``HD128`` (head_dim 128, GQA 2:1, seq 128): the port routes attention
  through the flash wrapper (its plain version on the CPU, RoPE fused),
  while the JAX package on the CPU takes its dense path.

Tolerance f32 atol 1e-4: the same math summed in other orders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudist.config import ModelConfig, ParallelConfig
from tpudist.models import transformer as jtf
from tpudist.parallel import build_mesh
from tpudist.serve import kvcache as jkv
from tpudist.serve.engine import init_params
from tpudist_torch import convert
from tpudist_torch.config import ModelConfig as TModelConfig
from tpudist_torch.models import transformer as ttf
from tpudist_torch.ops.cuda import flash_attention as tfa
from tpudist_torch.serve import kvcache as tkv

torch.set_num_threads(1)

ATOL = 1e-4
TINY_TF = ModelConfig(name="transformer", vocab_size=64, n_layers=2,
                      d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                      max_seq_len=32)
HD128 = ModelConfig(name="transformer", vocab_size=256, n_layers=2,
                    d_model=256, n_heads=2, n_kv_heads=1, d_ff=512,
                    max_seq_len=256)
CFGS = {"tiny": (TINY_TF, 16), "hd128": (HD128, 128)}   # (cfg, prompt_pad)


def _tcfg(cfg: ModelConfig) -> TModelConfig:
    return TModelConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(TModelConfig)})


def _carried(devices8, cfg: ModelConfig, seed: int = 0):
    """(JAX params on the one-device CPU mesh, the port's module holding
    the same values)."""
    mesh = build_mesh(ParallelConfig(), devices=devices8[:1])
    jparams = init_params(cfg, mesh, seed=seed)
    model = ttf.Transformer(_tcfg(cfg), device="cpu")
    model.load_state_dict(convert.params_from_jax(jax.device_get(jparams)))
    return mesh, jparams, model


def _close(got, want, atol=ATOL, what=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0, err_msg=what)


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts calls of the flash wrapper's plain version (the CPU
    route of the kernel)."""
    calls = []
    real = tfa.flash_attention_plain

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)
    monkeypatch.setattr(tfa, "flash_attention_plain", counting)
    return calls


def test_params_carry_name_for_name(devices8):
    _, jparams, model = _carried(devices8, TINY_TF)
    flat = convert.params_from_jax(jax.device_get(jparams))
    assert set(flat) == set(model.state_dict())
    for name, t in model.state_dict().items():
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), flat[name].numpy())
    assert tuple(model.layers.wq.shape) == (2, 32, 32)
    assert tuple(model.layers.wk.shape) == (2, 32, 16)


def test_rope_tables_and_rotations():
    rng = np.random.default_rng(0)
    for kw in (dict(), dict(positions=rng.integers(0, 64, 12))):
        jkw = {k: (jnp.asarray(v) if k == "positions" else v)
               for k, v in kw.items()}
        tkw = {k: (torch.from_numpy(v) if k == "positions" else v)
               for k, v in kw.items()}
        jc, js = jtf.precompute_rope(12, 16, 500.0, **jkw)
        tc, ts = ttf.precompute_rope(12, 16, 500.0, **tkw)
        _close(tc, jc, 1e-5, f"cos {kw}")
        _close(ts, js, 1e-5, f"sin {kw}")
        x = rng.standard_normal((2, 12, 3, 16)).astype(np.float32)
        _close(ttf.apply_rope(torch.from_numpy(x), tc, ts),
               jtf.apply_rope(jnp.asarray(x), jc, js), 1e-5, "apply_rope")
    pos = rng.integers(0, 64, (3, 4))
    x = rng.standard_normal((3, 4, 2, 16)).astype(np.float32)
    _close(ttf.window_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4),
           jtf.window_rope(jnp.asarray(x), jnp.asarray(pos), 1e4), 1e-5,
           "window_rope")
    _close(ttf.decode_rope(torch.from_numpy(x[:, :1]),
                           torch.from_numpy(pos[:, 0]), 1e4),
           jtf.decode_rope(jnp.asarray(x[:, :1]), jnp.asarray(pos[:, 0]),
                           1e4), 1e-5, "decode_rope")


def test_rmsnorm_and_ffn(devices8):
    _, jparams, model = _carried(devices8, TINY_TF)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    g = rng.standard_normal((32,)).astype(np.float32)
    _close(ttf.rmsnorm(torch.from_numpy(x), torch.from_numpy(g)),
           jtf.rmsnorm(jnp.asarray(x), jnp.asarray(g)), 1e-6, "rmsnorm")
    jlp = jax.tree.map(lambda a: a[1], jparams["layers"])
    with torch.no_grad():
        got = ttf._ffn_sublayer(torch.from_numpy(x), model.layers.layer(1),
                                _tcfg(TINY_TF))
    _close(got, jtf._ffn_sublayer(jnp.asarray(x), jlp, TINY_TF), 1e-5,
           "ffn")


@pytest.mark.parametrize("name", ["tiny", "hd128"])
def test_full_forward_logits_match(devices8, name, plain_calls):
    """Non-cached ``apply``: logits at every position. At hd 128 the
    port's attention runs the flash wrapper (RoPE fused) once a layer."""
    cfg, seq = CFGS[name]
    _, jparams, model = _carried(devices8, cfg)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, seq))
    want = jtf.apply(jparams, jnp.asarray(toks, jnp.int32), cfg,
                     dtype=jnp.float32)
    with torch.no_grad():
        got = ttf.apply(model, torch.from_numpy(toks), _tcfg(cfg),
                        dtype=torch.float32)
    assert got.shape == (2, seq, cfg.vocab_size)
    assert got.dtype == torch.float32
    _close(got, want, what=f"{name} logits")
    assert len(plain_calls) == (cfg.n_layers if name == "hd128" else 0)


@pytest.mark.parametrize("name", ["tiny", "hd128"])
def test_cached_prefill_and_decode_match(devices8, name, plain_calls):
    """Cached prefill seeds the KV cache, then 4 decode steps append one
    token per slot at per-slot positions: the port's logits and cache
    track the JAX package's at every step, on the same token feed."""
    cfg, pad = CFGS[name]
    mesh, jparams, model = _carried(devices8, cfg)
    tcfg = _tcfg(cfg)
    b, max_seq = 2, pad + 8
    lens = np.array([pad - 3, pad], np.int64)
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (b, pad))

    jcache = jkv.init_cache(jkv.CacheSpec.from_model(cfg, slots=b,
                                                     max_seq=max_seq), mesh)
    tcache = tkv.init_cache(tkv.CacheSpec.from_model(tcfg, slots=b,
                                                     max_seq=max_seq), "cpu")
    emb = jparams["embed"]
    jh, jcache = jtf.hidden_states(jparams, jnp.asarray(prompts, jnp.int32),
                                   cfg, dtype=jnp.float32, kv_cache=jcache)
    with torch.no_grad():
        th, tcache = ttf.hidden_states(model, torch.from_numpy(prompts),
                                       tcfg, dtype=torch.float32,
                                       kv_cache=tcache)
    _close(th @ model.embed.T, jh @ emb.T, what=f"{name} prefill")
    _close(tcache["k"], jcache["k"], what=f"{name} prefill cache k")
    _close(tcache["v"], jcache["v"], what=f"{name} prefill cache v")
    assert len(plain_calls) == (cfg.n_layers if name == "hd128" else 0)

    jlog = np.asarray(jh @ emb.T)
    last = np.array([jlog[i, lens[i] - 1].argmax() for i in range(b)])
    pos = lens.copy()
    for step in range(4):
        jh, jcache = jtf.hidden_states(
            jparams, jnp.asarray(last[:, None], jnp.int32), cfg,
            dtype=jnp.float32, kv_cache=jcache,
            cur_index=jnp.asarray(pos, jnp.int32))
        with torch.no_grad():
            th, tcache = ttf.hidden_states(
                model, torch.from_numpy(last[:, None]), tcfg,
                dtype=torch.float32, kv_cache=tcache,
                cur_index=torch.from_numpy(pos))
        jl = np.asarray(jh[:, 0] @ emb.T)
        _close(th[:, 0] @ model.embed.T, jl, what=f"{name} step {step}")
        last = jl.argmax(-1)
        pos = pos + 1
    _close(tcache["k"], jcache["k"], what=f"{name} cache k after decode")
    _close(tcache["v"], jcache["v"], what=f"{name} cache v after decode")


# (b, s, h, kv, hd, causal) and the port's route; off the TPU the JAX
# package routes the flash shapes dense
ROUTES = {
    "dense": ((2, 16, 4, 2, 8, True), "dense"),
    "blockwise": ((1, 2048, 2, 1, 64, True), "blockwise"),
    "flash-causal": ((1, 256, 2, 1, 128, True), "flash"),
    "flash-full": ((1, 256, 2, 2, 128, False), "flash"),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_attention_routes_match_jax(name, plain_calls, monkeypatch):
    """``_attention`` with RoPE tables: the port's flash route (plain
    version on the CPU, RoPE fused), its blockwise and dense routes, all
    against the JAX package's ``_attention`` on the same inputs."""
    (b, s, h, kv, hd, causal), route = ROUTES[name]
    blockwise = []
    real = ttf.blockwise_causal_attention
    monkeypatch.setattr(ttf, "blockwise_causal_attention",
                        lambda *a, **kw: blockwise.append(1) or real(*a, **kw))
    rng = np.random.default_rng(4)
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    jc, js = jtf.precompute_rope(s, hd)
    tc, ts = ttf.precompute_rope(s, hd)
    want = jtf._attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=causal, cos=jc, sin=js)
    got = ttf._attention(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), causal=causal, cos=tc, sin=ts)
    _close(got, want, 1e-5, name)
    assert len(plain_calls) == (1 if route == "flash" else 0)
    assert len(blockwise) == (1 if route == "blockwise" else 0)


@pytest.mark.parametrize("causal", [True, False])
def test_reference_gqa_and_blockwise_match_jax(causal):
    from tpudist.ops.blockwise_attention import \
        blockwise_causal_attention as jblock
    from tpudist.ops.gqa import expand_gqa as jexpand
    from tpudist.ops.reference import dense_attention as jdense
    from tpudist_torch.ops.blockwise_attention import \
        blockwise_causal_attention as tblock
    from tpudist_torch.ops.gqa import expand_gqa as texpand
    from tpudist_torch.ops.reference import dense_attention as tdense

    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((2, 256, n, 16)).astype(np.float32)
               for n in (4, 2, 2))
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    for got, want in zip(texpand(tq, tk, tv), jexpand(jq, jk, jv)):
        _close(got, want, 0.0, "expand_gqa")
    _close(tdense(tq, tk, tv, causal=causal),
           jdense(jq, jk, jv, causal=causal), 1e-5, "dense_attention")
    if causal:
        _close(tblock(tq, tk, tv, chunk=64), jblock(jq, jk, jv, chunk=64),
               1e-5, "blockwise")
