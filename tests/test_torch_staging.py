"""The port's epoch staging (``parallel/staging.py``, ``data.pad_steps``,
``metrics.StagingStats``, ``verdict.staging_status`` /
``tuning_status``) against the JAX package's, and streamed staging
against full-epoch staging through the train CLI.

* ``plan_slabs`` equals ``tpudist.parallel.sharding.plan_slabs`` on a
  grid of ``(n_steps, k, step_bytes, budget)``, the "budget too small"
  error included; ``pad_steps`` and ``EpochPlan.slab(pad_to)`` equal the
  JAX package's on the same indices.
* ``StagingStats`` accounts as the JAX package's does, and the staging
  and tuning verdicts grade alike (with ``TPUDIST_STAGING_OVERLAP_MIN``).
* ``put_slab`` on the CPU: the arrays as they came, token ids as int64,
  and ``step_bytes`` in the staged dtype.
* The train CLI with an epoch streamed in double-buffered slabs under a
  small ``TPUDIST_STAGING_BUDGET_MB`` or ``--staging-budget-mb``, bitwise
  the full-epoch run: every epoch's losses, the params, the moments.
"""

import json

import numpy as np
import pytest
import torch

from tpudist import data as jdata
from tpudist import verdict as jverdict
from tpudist.metrics import StagingStats as JStagingStats
from tpudist.parallel import sharding as jsharding
from tpudist_torch import data as tdata
from tpudist_torch import train as ttrain
from tpudist_torch import verdict as tverdict
from tpudist_torch.metrics import StagingStats
from tpudist_torch.parallel import staging

torch.set_num_threads(1)

GRID = [(n, k, b, budget)
        for n in (1, 7, 31, 32)
        for k in (1, 4, 25)
        for b in (1000, 32832)
        for budget in (None, 10**5, 10**6, 10**7)]


@pytest.mark.parametrize("n_steps,k,step_bytes,budget", GRID)
def test_plan_slabs_equals_jax(n_steps, k, step_bytes, budget):
    try:
        want = jsharding.plan_slabs(n_steps, k, step_bytes, budget)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            staging.plan_slabs(n_steps, k, step_bytes, budget)
        assert str(got.value) == str(e)
        assert "cannot hold a double-buffered pair" in str(e)
        return
    got = staging.plan_slabs(n_steps, k, step_bytes, budget)
    assert dataclass_fields(got) == dataclass_fields(want)
    assert got.slab_bytes == want.slab_bytes
    if got.streamed:
        assert 2 * got.slab_bytes <= budget


def dataclass_fields(plan):
    return {f: getattr(plan, f) for f in (
        "n_steps", "k", "slab_steps", "n_slabs", "step_bytes",
        "budget_bytes", "streamed")}


@pytest.mark.parametrize("args", [(0, 4, 10, None), (5, 0, 10, None)])
def test_plan_slabs_rejects_what_jax_rejects(args):
    with pytest.raises(ValueError) as want:
        jsharding.plan_slabs(*args)
    with pytest.raises(ValueError) as got:
        staging.plan_slabs(*args)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("start,stop,pad_to", [(0, 7, 0), (0, 7, 8),
                                               (4, 7, 4), (3, 7, 12)])
def test_slab_and_pad_steps_equal_jax(start, stop, pad_to):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 5)).astype(np.float32)
    tok = rng.integers(0, 50, (64, 9), dtype=np.int32)
    idx = rng.permutation(64)[:56].reshape(7, 8)
    want = jdata.EpochPlan((x, tok), idx).slab(start, stop, pad_to=pad_to)
    got = tdata.EpochPlan((x, tok), idx).slab(start, stop, pad_to=pad_to)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and np.array_equal(g, np.asarray(w))
    assert got[0].shape[0] == max(stop - start, pad_to)
    for w, g in zip(jdata.pad_steps(want, 16), tdata.pad_steps(got, 16)):
        assert np.array_equal(g, np.asarray(w))


def test_staging_stats_equal_jax():
    """The JAX test's sequence of events on both classes, then a wait on
    a slab that has landed."""
    ours, theirs = StagingStats(), JStagingStats()
    for s in (ours, theirs):
        s.note_staged(100, 0.01)
        s.note_staged(100, 0.01)
        s.note_released(100)
        s.note_staged(100, 0.01)
        s.streamed = True
    assert ours.split() == theirs.split()
    assert (ours.peak_bytes, ours.resident_bytes, ours.slabs) == (200, 200, 3)
    slab = staging.put_slab((np.zeros((2, 3), np.float32),),
                            torch.device("cpu"))
    assert ours.note_wait(slab) >= 0.0
    theirs.wait_s = ours.wait_s = 0.25
    for run_s in (1.0, 0.0, 0.1):
        assert ours.overlap_fraction(run_s) == theirs.overlap_fraction(run_s)
    assert ours.split() == theirs.split()


def test_staging_and_tuning_verdicts_equal_jax(monkeypatch):
    for streamed in (False, True):
        for overlap in (None, 0.1, 0.5, 0.9):
            assert tverdict.staging_status(streamed, overlap) == \
                jverdict.staging_status(streamed, overlap)
            assert tverdict.staging_status(streamed, overlap, 0.95) == \
                jverdict.staging_status(streamed, overlap, 0.95)
    monkeypatch.setenv("TPUDIST_STAGING_OVERLAP_MIN", "0.95")
    assert tverdict.staging_status(True, 0.9) == \
        jverdict.staging_status(True, 0.9) == tverdict.FAIL
    for mode in ("off", "probe", "cache-only"):
        for source in ("heuristic", "cache", "probe"):
            for tuned, base in ((None, None), (2.0, 1.0), (1.0, 2.0),
                                (1.0, 0.0)):
                kw = dict(source=source, tuned_steps_per_sec=tuned,
                          baseline_steps_per_sec=base)
                assert tverdict.tuning_status(mode, **kw) == \
                    jverdict.tuning_status(mode, **kw)


def test_put_slab_on_the_cpu_stages_token_ids_as_int64():
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    tok = np.arange(12, dtype=np.int32).reshape(2, 3, 2)
    slab = staging.put_slab((x, tok), torch.device("cpu"))
    assert slab.event is None
    a, t = slab.arrays_for()
    assert a.dtype == torch.float32 and torch.equal(a, torch.from_numpy(x))
    assert t.dtype == torch.int64 and t.tolist() == tok.tolist()
    x[0, 0, 0] = 99                    # a copy, not a view of the host
    assert a[0, 0, 0] == 0
    # one step of 3 rows: 4 f32 and 2 int64 a row
    assert staging.step_bytes((x[0], tok[0]), 3) == 3 * (4 * 4 + 2 * 8)


def _records(save_dir, kind):
    return [r for r in (json.loads(line) for line in
                        (save_dir / "metrics.jsonl").read_text()
                        .splitlines()) if r["kind"] == kind]


MLP = ["--epochs", "2", "--n-samples", "640", "--train-batch-size", "64",
       "--seed", "5", "--device", "cpu", "--log-every", "4"]
TINY_TF = ["--model", "transformer", "--vocab-size", "256", "--n-layers",
           "2", "--d-model", "128", "--n-heads", "1", "--d-ff", "256",
           "--seq-len", "128", "--train-batch-size", "2", "--n-samples",
           "18", "--epochs", "1", "--device", "cpu", "--log-every", "2"]


@pytest.mark.parametrize("argv,budget_mb,slabs", [
    # 10 steps of 64 x (20 f32 + 1 f32) = 5376 B at k = 4 (12 padded,
    # 64512 B): slabs of 4 steps under 0.05 MB (two epochs of 3 slabs)
    (MLP, 0.05, 6),
    # 9 steps of 2 x 129 int64 = 2064 B at k = 2: slabs of 2 steps under
    # 8256 B (one epoch of 5 slabs)
    (TINY_TF, 8256 / 2**20, 5),
], ids=["mlp", "tf-int64"])
@pytest.mark.parametrize("how", ["env", "flag"])
def test_streamed_staging_is_bitwise_full_epoch_staging(
        argv, budget_mb, slabs, how, tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("TPUDIST_STAGING_BUDGET_MB", raising=False)
    assert ttrain.main(argv + ["--save-dir", str(tmp_path / "full")]) == 0
    capsys.readouterr()
    if how == "env":
        monkeypatch.setenv("TPUDIST_STAGING_BUDGET_MB", repr(budget_mb))
        extra = []
    else:
        extra = ["--staging-budget-mb", repr(budget_mb)]
    assert ttrain.main(argv + extra + ["--save-dir",
                                       str(tmp_path / "streamed")]) == 0
    out = capsys.readouterr().out
    assert "tpudist: staging streamed: epoch" in out
    full, streamed = (_records(tmp_path / d, "timing")[0]
                      for d in ("full", "streamed"))
    assert (full["staging_streamed"], full["staging_status"]) == (
        False, "ungateable")
    assert (streamed["staging_streamed"], streamed["staging_slabs"]) == (
        True, slabs)
    assert streamed["staged_bytes_peak"] <= budget_mb * 2**20
    assert streamed["staging_status"] in ("success", "fail")
    assert [(r["avg_loss"], r["eval_loss"]) for r in
            _records(tmp_path / "full", "epoch")] == [
        (r["avg_loss"], r["eval_loss"]) for r in
        _records(tmp_path / "streamed", "epoch")]
    a, b = (torch.load(sorted((tmp_path / d).glob("[0-9]*"),
                              key=lambda p: int(p.name))[-1] / "state.pt",
                       weights_only=True) for d in ("full", "streamed"))
    for name, t in a["params"].items():
        assert torch.equal(t, b["params"][name]), name
    for x, y in zip(a["mu"] + a["nu"], b["mu"] + b["nu"]):
        assert torch.equal(x, y)


def test_a_budget_too_small_for_two_windows_fails_the_run(tmp_path, capsys,
                                                          monkeypatch):
    monkeypatch.setenv("TPUDIST_STAGING_BUDGET_MB", "0.01")
    assert ttrain.main(MLP + ["--save-dir", str(tmp_path)]) == 1
    assert "cannot hold a double-buffered pair of k=4-step slabs" in \
        capsys.readouterr().err
