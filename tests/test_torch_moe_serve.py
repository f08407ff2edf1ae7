"""The port's serving lane with the MoE model against the JAX package's.

* Greedy tokens on carried params: the port's dense and paged engines
  over ``tests/test_paged_serve.py``'s ``TINY_MOE`` equal the JAX
  engines', request for request, with the program pins held; a paged
  run with a shared prefix and speculation equals them too.
* The serving forwards alone: the MoE's prefill (cached) and paged
  decode hidden states against the JAX functions within f32 1e-5.
* ``python -m tpudist_torch.serve --model moe`` on the CPU, dense and
  paged: exit 0, every request served, the verdict ``success``, the
  summary naming the model; without ``--device cpu`` and without a card
  it fails as the transformer's does.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudist.config import ModelConfig, ParallelConfig
from tpudist.models import moe as jmoe
from tpudist.parallel import build_mesh
from tpudist.serve import scheduler as jsched
from tpudist.serve.engine import PagedServeEngine as JPaged
from tpudist.serve.engine import ServeEngine as JDense
from tpudist.serve.engine import init_params
from tpudist_torch import convert
from tpudist_torch.config import ModelConfig as TModelConfig
from tpudist_torch.models import moe as tmoe
from tpudist_torch.serve import cli as tcli
from tpudist_torch.serve import scheduler as tsched
from tpudist_torch.serve.engine import PagedServeEngine as TPaged
from tpudist_torch.serve.engine import ServeEngine as TDense

torch.set_num_threads(1)

# tests/test_paged_serve.py:48
TINY_MOE = ModelConfig(name="moe", vocab_size=64, n_layers=2,
                       d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                       max_seq_len=32, n_experts=4, expert_top_k=2,
                       capacity_factor=4.0)


def _tcfg(cfg: ModelConfig) -> TModelConfig:
    return TModelConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(TModelConfig)})


@pytest.fixture(scope="module")
def carried():
    mesh = build_mesh(ParallelConfig(), devices=jax.devices()[:1])
    jparams = init_params(TINY_MOE, mesh, seed=0)
    model = tmoe.MoE(_tcfg(TINY_MOE), device="cpu")
    model.load_state_dict(convert.params_from_jax(jax.device_get(jparams)))
    return mesh, jparams, model


def _tokens(summary):
    return {rid: r["tokens"] for rid, r in summary["results"].items()}


@pytest.mark.parametrize("lane", ["plain", "spec"])
def test_greedy_tokens_equal_jax(carried, lane):
    mesh, jparams, model = carried
    kw = dict(slots=2, max_seq=32, prompt_pad=8, decode_k=4)
    stream = dict(n=5, prompt_pad=8, vocab_size=64, max_new=6, rate=0.0,
                  seed=3)
    prefix, spec = (0, 0) if lane == "plain" else (8, 4)
    if prefix:
        kw["prompt_pad"] = stream["prompt_pad"] = 16
        stream["prefix_len"] = prefix
    shared = tsched.shared_prefix_tokens(prefix, 64, 3) if prefix else None
    runs = {}
    for tag, paged, pkg in (("jax dense", False, "jax"),
                            ("jax paged", True, "jax"),
                            ("dense", False, "torch"),
                            ("paged", True, "torch")):
        ekw = dict(kw, page_tokens=8, speculate_k=spec) if paged else kw
        if pkg == "jax":
            eng = (JPaged if paged else JDense)(TINY_MOE, mesh, **ekw)
            params, sched, extra = jparams, jsched, {"n_chips": 1}
        else:
            eng = (TPaged if paged else TDense)(_tcfg(TINY_MOE),
                                                device="cpu", **ekw)
            params, sched, extra = model, tsched, {}
        eng.warmup(params)
        summary = sched.run_serve(eng, params,
                                  sched.make_requests(**stream),
                                  shared_prefix=shared if paged else None,
                                  **extra)
        eng.assert_two_programs()
        assert summary["completed"] == 5, (tag, summary["partition"])
        runs[tag] = _tokens(summary)
    assert runs["dense"] == runs["jax dense"]
    assert runs["paged"] == runs["jax paged"] == runs["jax dense"]


def test_serving_forwards_equal_jax(carried):
    """The cached prefill and the paged window forward through the
    experts: hidden states within f32 1e-5 of the JAX functions'."""
    _, jparams, model = carried
    cfg, tcfg = TINY_MOE, _tcfg(TINY_MOE)
    L, kv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.d_model // cfg.n_heads
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, 64, (2, 16)).astype(np.int32)
    shape = (L, 2, 32, kv, hd)
    jh, jcache = jmoe.hidden_states(
        jparams, jnp.asarray(tokens), cfg, dtype=jnp.float32,
        kv_cache={"k": jnp.zeros(shape), "v": jnp.zeros(shape)})
    cache = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    with torch.no_grad():
        th, tcache = tmoe.hidden_states(
            model, torch.from_numpy(tokens).long(), tcfg,
            dtype=torch.float32, kv_cache=cache)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0,
                               atol=1e-5 * float(np.abs(jh).max()))
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               rtol=0, atol=1e-5)
    # a paged window of 3 tokens a slot on a pool of 8 pages of 4
    pt, pages = 4, 8
    pool = (L, pages + 1, pt, kv, hd)
    pk = rng.standard_normal(pool).astype(np.float32)
    pv = rng.standard_normal(pool).astype(np.float32)
    table = np.asarray([[0, 2, -1, -1], [5, 1, 3, -1]], np.int32)
    pos = np.asarray([[4, 5, 6], [9, 10, 11]], np.int32)
    ok = np.ones((2, 3), bool)
    win = rng.integers(0, 64, (2, 3)).astype(np.int32)
    jh, _, _ = jmoe.paged_hidden_states(
        jparams, jnp.asarray(win), cfg, dtype=jnp.float32,
        pool_k=jnp.asarray(pk), pool_v=jnp.asarray(pv),
        page_table=jnp.asarray(table), positions=jnp.asarray(pos),
        write_ok=jnp.asarray(ok), page_tokens=pt)
    with torch.no_grad():
        th, _, _ = tmoe.paged_hidden_states(
            model, torch.from_numpy(win).long(), tcfg, dtype=torch.float32,
            pool_k=torch.from_numpy(pk.copy()),
            pool_v=torch.from_numpy(pv.copy()),
            page_table=torch.from_numpy(table),
            positions=torch.from_numpy(pos), write_ok=torch.from_numpy(ok),
            page_tokens=pt)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0,
                               atol=1e-5 * float(np.abs(jh).max()))


@pytest.mark.parametrize("extra", [[], ["--kv-page-tokens", "8"]])
def test_serve_cli_serves_the_moe(extra, tmp_path, monkeypatch):
    save = tmp_path / "run"
    monkeypatch.setenv("TPUDIST_VERDICT_PATH", str(tmp_path / "v.txt"))
    assert tcli.main(["--model", "moe", "--device", "cpu", "--requests",
                      "4", "--max-new-tokens", "4", "--save-dir",
                      str(save)] + extra) == 0
    assert (tmp_path / "v.txt").read_text() == "success"
    recs = [json.loads(line) for line in
            (save / "metrics.jsonl").read_text().splitlines()]
    rec = [r for r in recs if r["kind"] == "serve"][0]
    assert rec["model"] == "moe" and rec["completed"] == 4
    assert rec["kv_page_tokens"] == (8 if extra else 0)
    assert (rec["prefill_compiles"], rec["decode_compiles"]) == (1, 1)


def test_serve_cli_without_a_card_fails(tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("TPUDIST_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tcli.main(["--model", "moe", "--requests", "2", "--save-dir",
                      str(tmp_path)]) == 1
    assert "CUDA is not available" in capsys.readouterr().err
