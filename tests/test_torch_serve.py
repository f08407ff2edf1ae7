"""The port's serving lane (``tpudist_torch.serve``) against the JAX
package's.

* the request stream is bitwise the JAX package's (numpy, one seed);
* the engine + scheduler greedily decode the SAME tokens as the JAX
  engine + scheduler on carried parameters (one-device CPU mesh), at
  head_dim 8 (dense attention) and head_dim 128 (the port's prefill
  through the flash wrapper, once a layer per prefill);
* the CLI runs end to end on the CPU when asked, and refuses to run
  without a card otherwise;
* the copies the port keeps of the JAX package's standard-library
  modules (serve thresholds with the shed gate, SLO grading and
  histograms, verdict file) equal their sources.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tpudist import rules as jrules
from tpudist import verdict as jverdict
from tpudist.config import ModelConfig, ParallelConfig
from tpudist.parallel import build_mesh
from tpudist.serve import scheduler as jsched
from tpudist.serve import slo as jslo
from tpudist.serve.engine import ServeEngine as JServeEngine
from tpudist.serve.engine import init_params
from tpudist_torch import convert
from tpudist_torch import rules as trules
from tpudist_torch import verdict as tverdict
from tpudist_torch.config import ModelConfig as TModelConfig
from tpudist_torch.models import transformer as ttf
from tpudist_torch.ops.cuda import flash_attention as tfa
from tpudist_torch.serve import cli as tcli
from tpudist_torch.serve import scheduler as tsched
from tpudist_torch.serve import slo as tslo
from tpudist_torch.serve.engine import ServeEngine as TServeEngine
from tpudist_torch.serve.engine import init_params as tinit_params

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_TF = ModelConfig(name="transformer", vocab_size=64, n_layers=2,
                      d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                      max_seq_len=32)
HD128 = ModelConfig(name="transformer", vocab_size=256, n_layers=2,
                    d_model=256, n_heads=2, n_kv_heads=1, d_ff=512,
                    max_seq_len=256)
# (cfg, engine kwargs, request count, max_new)
LANES = {
    "tiny-st": (TINY_TF, dict(slots=2, max_seq=32, prompt_pad=8,
                              decode_k=4, layout="st"), 5, 6),
    "tiny-hs": (TINY_TF, dict(slots=2, max_seq=32, prompt_pad=8,
                              decode_k=4, layout="hs"), 5, 6),
    "hd128": (HD128, dict(slots=2, max_seq=144, prompt_pad=128,
                          decode_k=4), 3, 5),
}
SERVE_RULES = ("ttft", "itl", "tokens_per_chip", "serve_shed")
# every rule of the port's table, in the JAX table's order: the train
# lane's straggler factor, staging overlap, stall window and trace drop
# share, the serve rules, and the HBM ledger's headroom floor
PORT_RULES = ("straggler", "staging", "stall", "trace_drop") \
    + SERVE_RULES + ("hbm_headroom",)
# the latency, throughput, shed, program and grade keys of the JAX
# summary that the port's kind=serve record carries
SUMMARY_KEYS = {"ttft_p50_s", "ttft_p99_s", "itl_p50_s", "itl_p99_s",
                "e2e_p50_s", "e2e_p99_s", "tokens_per_sec",
                "tokens_per_sec_per_chip", "wall_s", "generated_tokens",
                "requests", "completed", "status", "ttft_status",
                "itl_status", "tokens_per_chip_status", "shed_fraction",
                "serve_shed_status", "prefill_compiles",
                "decode_compiles"}
# the CLI's green-verdict pin grades the wiring, not this host's load
LOOSE_SLO = {"TPUDIST_TTFT_P99_MAX": "120", "TPUDIST_ITL_P99_MAX": "60",
             "TPUDIST_TOKENS_PER_CHIP_MIN": "0.001"}


def _tcfg(cfg: ModelConfig) -> TModelConfig:
    return TModelConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(TModelConfig)})


@pytest.mark.parametrize("kw", [
    dict(n=16, prompt_pad=512, vocab_size=32000, max_new=32, rate=0.0,
         seed=0),
    dict(n=12, prompt_pad=16, vocab_size=256, max_new=8, rate=200.0,
         seed=7),
    dict(n=5, prompt_pad=8, vocab_size=64, max_new=6, rate=0.0, seed=3,
         prompt_min=2),
])
def test_make_requests_bitwise_equal_to_jax(kw):
    got, want = tsched.make_requests(**kw), jsched.make_requests(**kw)
    assert len(got) == len(want) == kw["n"]
    for g, w in zip(got, want):
        assert (g.rid, g.arrival_s, g.prompt_len, g.max_new) == (
            w.rid, w.arrival_s, w.prompt_len, w.max_new)
        assert g.tokens.dtype == w.tokens.dtype
        np.testing.assert_array_equal(g.tokens, w.tokens)


@pytest.mark.parametrize("lane", sorted(LANES))
def test_greedy_serve_tokens_equal_jax(devices8, lane, monkeypatch):
    """Same params, same request stream: every request's generated
    tokens are equal. With seed 0 (params) and 3 (requests) the smallest
    top-2 logit gap along these greedy paths is 1.1e-2 (head_dim 8) and
    4.0e-4 (head_dim 128), above the packages' logit differences (within
    1e-4, test_torch_transformer), so no step is a near-tie and equal
    tokens are the contract."""
    cfg, eng_kw, n, max_new = LANES[lane]
    mesh = build_mesh(ParallelConfig(), devices=devices8[:1])
    jparams = init_params(cfg, mesh, seed=0)
    requests = jsched.make_requests(n, prompt_pad=eng_kw["prompt_pad"],
                                    vocab_size=cfg.vocab_size,
                                    max_new=max_new, rate=0.0, seed=3)
    jengine = JServeEngine(cfg, mesh, **eng_kw)
    jengine.warmup(jparams)
    want = jsched.run_serve(jengine, jparams, requests)

    plain = []
    real = tfa.flash_attention_plain
    monkeypatch.setattr(tfa, "flash_attention_plain",
                        lambda *a, **kw: plain.append(1) or real(*a, **kw))
    model = ttf.Transformer(_tcfg(cfg), device="cpu")
    model.load_state_dict(convert.params_from_jax(jax.device_get(jparams)))
    tengine = TServeEngine(_tcfg(cfg), device="cpu", **eng_kw)
    tengine.warmup(model)
    got = tsched.run_serve(tengine, model, tsched.make_requests(
        n, prompt_pad=eng_kw["prompt_pad"], vocab_size=cfg.vocab_size,
        max_new=max_new, rate=0.0, seed=3))

    assert got["completed"] == want["completed"] == n
    assert got["truncated"] == want["truncated"] == 0
    assert got["generated_tokens"] == want["generated_tokens"]
    for rid in range(n):
        assert got["results"][rid]["tokens"] == \
            want["results"][rid]["tokens"], f"{lane} rid {rid}"
    # the port's prefill is the only flash caller: once a layer per
    # prefill, the warmup's included; decode is plain attention
    prefills = got["admitted"] + 1
    assert len(plain) == (cfg.n_layers * prefills if lane == "hd128"
                          else 0)


def test_cli_on_the_cpu_end_to_end(tmp_path):
    """``python -m tpudist_torch.serve --device cpu`` at tiny size: exit
    0, the verdict line, a ``kind=serve`` record carrying the latency
    and throughput keys of the JAX package's summary, the bench artifact
    and the verdict file."""
    env = dict(os.environ, **LOOSE_SLO,
               TPUDIST_VERDICT_PATH=str(tmp_path / "verdict.txt"))
    bench = tmp_path / "BENCH_SERVE.json"
    proc = subprocess.run(
        [sys.executable, "-m", "tpudist_torch.serve", "--device", "cpu",
         "--requests", "6", "--max-new-tokens", "5", "--request-rate",
         "200", "--save-dir", str(tmp_path), "--bench-out", str(bench)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:] + proc.stdout[-2000:]
    assert "tpudist: serve success: 6/6 requests" in proc.stdout

    recs = [json.loads(line) for line in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    serves = [r for r in recs if r["kind"] == "serve"]
    assert len(serves) == 1
    rec = serves[0]
    assert SUMMARY_KEYS <= set(rec), SUMMARY_KEYS - set(rec)
    assert rec["completed"] == 6 and rec["device"] == "cpu"
    assert rec["tokens_per_sec_per_chip"] > 0
    assert {r["event"] for r in recs if r["kind"] == "serve_request"} == {
        "admitted", "done"}
    doc = json.loads(bench.read_text())
    assert doc["metric"] == "serve_tokens_per_sec_per_chip"
    assert doc["slo"]["status"] == "success"
    assert (tmp_path / "verdict.txt").read_text() == "success"


def test_jax_summary_carries_the_pinned_keys(devices8):
    """SUMMARY_KEYS are the JAX summary's own latency and throughput
    keys, all of them, so the port's record cannot drift from what the
    JAX package's readers consume."""
    mesh = build_mesh(ParallelConfig(), devices=devices8[:1])
    params = init_params(TINY_TF, mesh, seed=0)
    engine = JServeEngine(TINY_TF, mesh, slots=2, max_seq=32, prompt_pad=8)
    summary = jsched.run_serve(engine, params, jsched.make_requests(
        2, prompt_pad=8, vocab_size=64, max_new=2, rate=0.0, seed=0))
    assert SUMMARY_KEYS <= set(summary)
    assert {k for k in summary if k.endswith(("_p50_s", "_p99_s"))
            or k.startswith("tokens_per_sec")} <= SUMMARY_KEYS


def test_entry_points_refuse_to_run_without_a_card(tmp_path, monkeypatch,
                                                   capsys):
    """Without CUDA, the default device is an error, never the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _tcfg(TINY_TF)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TServeEngine(cfg, slots=1, max_seq=16, prompt_pad=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tinit_params(cfg)
    rc = tcli.main(["--requests", "1", "--save-dir", str(tmp_path)])
    assert rc == 1
    assert "CUDA is not available" in capsys.readouterr().err


def test_serve_thresholds_equal_jax(monkeypatch):
    assert (trules.TTFT_P99_MAX, trules.ITL_P99_MAX,
            trules.TOKENS_PER_CHIP_MIN) == (
        jrules.TTFT_P99_MAX, jrules.ITL_P99_MAX, jrules.TOKENS_PER_CHIP_MIN)
    assert trules.STAGING_OVERLAP_MIN == jrules.STAGING_OVERLAP_MIN
    assert tuple(t.name for t in trules.THRESHOLDS) == PORT_RULES
    for name in PORT_RULES:
        assert dataclasses.asdict(trules.get(name)) == \
            dataclasses.asdict(jrules.get(name))
        assert trules.resolve(name) == jrules.resolve(name)
        env = trules.get(name).env
        for raw in ("0.25", "not-a-number"):
            monkeypatch.setenv(env, raw)
            assert trules.resolve(name) == jrules.resolve(name)
        monkeypatch.delenv(env)
        for v in (None, 0.0, 0.5, 1.0, 2.0, 3.0):
            assert trules.breached(name, v) == jrules.breached(name, v)


def test_slo_grading_equals_jax(monkeypatch):
    rng = np.random.default_rng(5)
    for n in (0, 1, 2, 7, 100, 101):
        xs = list(rng.exponential(0.1, n))
        for q in (0, 1, 50, 99, 100):
            assert tslo.percentile(xs, q) == jslo.percentile(xs, q)
        for buckets in ("TTFT_BUCKETS_S", "ITL_BUCKETS_S"):
            assert tslo.hist_block(xs, getattr(tslo, buckets)) == \
                jslo.hist_block(xs, getattr(jslo, buckets))
    assert (tslo.TTFT_BUCKETS_S, tslo.ITL_BUCKETS_S) == (
        jslo.TTFT_BUCKETS_S, jslo.ITL_BUCKETS_S)
    assert tslo.SERVE_RULES == jslo.SERVE_RULES
    stats_t, stats_j = tslo.LatencyStats(), jslo.LatencyStats()
    for s in (tslo, jslo):
        assert s.SUCCESS == "success" and s.FAIL == "fail"
    for st in (stats_t, stats_j):
        st.note_ttft(0.3)
        st.note_itl(0.01, 3)
        st.note_e2e(0.5)
    assert stats_t.summary() == stats_j.summary()
    assert stats_t.ttft_hist() == stats_j.ttft_hist()
    assert stats_t.itl_hist() == stats_j.itl_hist()
    monkeypatch.setenv("TPUDIST_TTFT_P99_MAX", "0.5")
    vals = (None, 0.1, 0.6, 2.5)
    for ttft in vals:
        for itl in vals:
            for tps in (None, 0.5, 10.0):
                for shed in (None, 0.0, 0.7):
                    assert tslo.grade(ttft, itl, tps, shed) == \
                        jslo.grade(ttft, itl, tps, shed_fraction=shed)
                assert tslo.grade(ttft, itl, tps) == \
                    jslo.grade(ttft, itl, tps)
                assert tslo.serve_status(ttft, itl, tps) == \
                    jslo.serve_status(ttft, itl, tps)


def test_verdict_file_equals_jax(tmp_path):
    for status in (tverdict.SUCCESS, tverdict.FAIL, tverdict.UNGATEABLE):
        tverdict.write_final_status(str(tmp_path / "t" / "v.txt"), status)
        jverdict.write_final_status(str(tmp_path / "j" / "v.txt"), status)
        assert (tmp_path / "t" / "v.txt").read_bytes() == \
            (tmp_path / "j" / "v.txt").read_bytes()
    assert (tverdict.SUCCESS, tverdict.FAIL, tverdict.UNGATEABLE) == (
        jverdict.SUCCESS, jverdict.FAIL, jverdict.UNGATEABLE)
