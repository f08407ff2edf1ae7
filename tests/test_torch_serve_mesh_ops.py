"""The serve CLI's operations on a serve mesh of two gloo ranks, part 1:
the serve tuner in lockstep and the chaos that leaves the run alive
(``tpudist_torch/serve/tune.py``, ``tpudist_torch/serve/cli.py``). Part 2
(``tests/test_torch_serve_mesh_chaos.py``) holds the kill, the requeued
attempt and the drill.

* ``--serve-tune probe``: one ``kind=serve_tune`` record, the same
  committed candidate on both ranks, a fingerprint that carries the mesh
  (it differs from one process's), and a rerun that costs 0 trials.
* ``serve_slow`` and ``request_garbage`` fire on rank 0 only; every
  request's tokens equal one process's.
"""

import json
import os

import pytest
import torch

from _torch_ranks import serve_cli, serve_records
from tpudist_torch.config import ModelConfig
from tpudist_torch.parallel import mesh as tmesh
from tpudist_torch.serve import cli as tcli
from tpudist_torch.serve import tune as ttune

torch.set_num_threads(1)

ARGV = ["--requests", "8", "--max-new-tokens", "8", "--slots", "4",
        "--decode-steps-per-dispatch", "2"]


def _tokens(save):
    return json.load(open(os.path.join(save, "tokens.json")))


def test_serve_tune_commits_one_candidate_on_every_rank(tmp_path):
    argv = ARGV + ["--serve-tune", "probe"]
    rcs, outs, _ = serve_cli(tmp_path, 2, argv)
    assert rcs == [0, 0], outs
    ranks = [json.load(open(tmp_path / f"tune.rank{r}.json"))
             for r in range(2)]
    assert ranks[0] == ranks[1] and ranks[0]["source"] == "probe"
    assert ranks[0]["trials"] > 0
    rec, = serve_records(tmp_path, "serve_tune")
    assert rec["fingerprint"] == ranks[0]["fingerprint"]
    assert {k: rec[k] for k in ranks[0]["tuned"]} == ranks[0]["tuned"]
    # the record names the mesh: one process's fingerprint differs
    a = tcli.parse_args(ARGV)
    cfg = ModelConfig(name=a.model, vocab_size=a.vocab_size,
                      n_layers=a.n_layers, d_model=a.d_model,
                      n_heads=a.n_heads, n_kv_heads=a.n_kv_heads,
                      d_ff=a.d_ff, max_seq_len=a.max_seq,
                      n_experts=a.n_experts, expert_top_k=a.expert_top_k)
    shape = dict(slots=a.slots, max_seq=a.max_seq, prompt_pad=a.prompt_pad)
    grid = tmesh.rank_grid(tmesh.ParallelConfig(), 2)
    assert ttune.fingerprint(cfg, "cpu", mesh=grid, **shape) \
        == rec["fingerprint"] != ttune.fingerprint(cfg, "cpu", **shape)
    assert len(list((tmp_path / "tune").iterdir())) == 1
    # the rerun: a cache hit on both ranks, no trial
    rcs, outs, _ = serve_cli(tmp_path, 2, argv)
    assert rcs == [0, 0], outs
    again = [json.load(open(tmp_path / f"tune.rank{r}.json"))
             for r in range(2)]
    assert [(t["source"], t["trials"], t["tuned"]) for t in again] \
        == [("cache", 0, ranks[0]["tuned"])] * 2


@pytest.mark.parametrize("chaos", ["serve_slow@0:2,s=0.02,steps=3",
                                   "request_garbage@0:0,n=4"])
def test_rank0_chaos_tokens_equal_one_process(tmp_path, chaos):
    argv = ARGV + ["--chaos", chaos, "--kv-page-tokens", "8"]
    one, two = tmp_path / "one", tmp_path / "two"
    rcs, outs, _ = serve_cli(one, 1, argv)
    assert rcs == [0], outs
    rcs, outs, _ = serve_cli(two, 2, argv)
    assert rcs == [0, 0], outs
    assert _tokens(one) == _tokens(two) and len(_tokens(one)) == 8
    fired = serve_records(two, "chaos")
    assert len(fired) == 1 and fired[0]["rank"] == 0
    assert "chaos fired" in outs[0] and "chaos fired" not in outs[1]
    serve, = serve_records(two, "serve")
    if chaos.startswith("request_garbage"):
        assert serve["rejected"] == 4
