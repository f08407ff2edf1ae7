"""The port's collective harness (``tpudist_torch.ops.collectives``,
``tpudist_torch.bench.sweep``) against the JAX package's
(``tpudist/ops/collectives.py``, ``tpudist/bench/sweep.py``), which
``tests/test_collectives.py`` holds.

* On four gloo ranks, each kind's input and result on every rank equal
  the JAX ``build_op``'s shard on four CPU devices at the same message
  size, bitwise (integer-valued f32), and the closed form
  ``collectives.expected``; the message rounding equals the JAX one; a
  timing record of each kind is sane.
* ``BUS_FACTOR``, ``sweep_sizes`` and ``gate`` equal the JAX package's
  on the same inputs.
* The CLI: one process has nothing to gate against (exit 3,
  ``ungateable``), ``--min-pct-peak 0`` exits 0 with ``--out`` rows
  carrying the JAX record's keys and ``--bench-out`` the JAX artifact's;
  over two ranks ``--peak-gbps`` far below the measured bus bandwidth
  gives exit 0 and ``success``, far above exit 1 and ``fail``.
"""

import json

import numpy as np
import pytest
import torch

from _torch_ranks import run_ranks, start_ranks
from tpudist.bench import sweep as jsweep
from tpudist.config import ParallelConfig
from tpudist.ops import collectives as jcoll
from tpudist.parallel import build_mesh
from tpudist_torch.bench import sweep as tsweep
from tpudist_torch.ops import collectives as tcoll

torch.set_num_threads(1)

SIZES = (4096, 1000, 12)
# the kinds whose JAX output is split over the devices (the others are
# whole on every device)
SPLIT = {"reduce_scatter", "all_to_all", "ppermute"}

OPS = r"""
from tpudist_torch.ops import collectives
res = {}
for kind in collectives.KINDS:
    for size in json.loads(ARGS[1]):
        op, x, nbytes = collectives.build_op(kind, message_bytes=size)
        res[f"{kind}.{size}"] = {"x": x.clone(), "out": op(),
                                 "bytes": nbytes}
    t = collectives.time_collective(kind, message_bytes=4096, iters=2,
                                    warmup=1)
    res[f"{kind}.timing"] = vars(t)
torch.save(res, f"{ARGS[0]}/rank{RANK}.pt")
"""


@pytest.fixture(scope="module")
def four_rank_ops(tmp_path_factory, devices8):
    out = tmp_path_factory.mktemp("collectives")
    wait = start_ranks("import json\n" + OPS, 4, out, json.dumps(SIZES))
    mesh = build_mesh(ParallelConfig(), devices=devices8[:4])
    want = {}
    for kind in tcoll.KINDS:
        for size in SIZES:
            op, x, nbytes = jcoll.build_op(kind, mesh, "data",
                                           message_bytes=size)
            want[f"{kind}.{size}"] = (np.asarray(x), np.asarray(op(x)),
                                      nbytes)
    wait(180)
    return [torch.load(out / f"rank{r}.pt", weights_only=True)
            for r in range(4)], want


@pytest.mark.parametrize("kind", tcoll.KINDS)
def test_each_kind_equals_the_jax_op_shard_for_shard(four_rank_ops, kind):
    got, want = four_rank_ops
    for size in SIZES:
        x, out, nbytes = want[f"{kind}.{size}"]
        xs = x.reshape(4, -1)
        outs = out.reshape(4, -1) if kind in SPLIT else [out] * 4
        for r, ranks in enumerate(got):
            mine = ranks[f"{kind}.{size}"]
            assert mine["bytes"] == nbytes
            assert mine["x"].dtype == torch.float32
            np.testing.assert_array_equal(mine["x"].numpy(), xs[r])
            np.testing.assert_array_equal(mine["out"].numpy(), outs[r])
            assert torch.equal(mine["out"], tcoll.expected(kind, 4, r, size))


@pytest.mark.parametrize("kind", tcoll.KINDS)
def test_timing_records_are_sane(four_rank_ops, kind):
    got, _ = four_rank_ops
    recs = [ranks[f"{kind}.timing"] for ranks in got]
    assert all(r == recs[0] for r in recs)   # the slowest rank's, on all
    t = recs[0]
    assert t["n_devices"] == 4 and t["message_bytes"] == 4096
    assert 0 < t["min_s"] <= t["mean_s"]
    assert t["bus_gbps"] == pytest.approx(
        t["algo_gbps"] * jcoll.BUS_FACTOR[kind](4))


def test_bus_factors_and_sizes_equal_jax():
    assert set(tcoll.KINDS) == set(jcoll.KINDS) == set(tcoll.BUS_FACTOR)
    for kind in tcoll.KINDS:
        for n in range(1, 9):
            assert tcoll.BUS_FACTOR[kind](n) == jcoll.BUS_FACTOR[kind](n)
    for lo, hi in ((1, 1024), (0.25, 0.25), (0.5, 3), (4, 1)):
        assert tsweep.sweep_sizes(lo, hi) == jsweep.sweep_sizes(lo, hi)


@pytest.mark.parametrize("recs,threshold", [
    ([{"kind": "all_reduce", "pct_of_ring_peak": 95.0},
      {"kind": "all_reduce", "pct_of_ring_peak": 40.0}], 90),
    ([{"kind": "all_reduce", "pct_of_ring_peak": 95.0}], 96),
    ([{"kind": "all_reduce", "pct_of_ring_peak": None}], 90),
    ([{"kind": "all_reduce", "pct_of_ring_peak": 95.0},
      {"kind": "all_gather", "pct_of_ring_peak": 50.0},
      {"kind": "ppermute", "pct_of_ring_peak": 10.0}], 90),
    ([], 90),
])
def test_gate_equals_jax(recs, threshold):
    assert tsweep.gate(recs, threshold) == jsweep.gate(recs, threshold)


def test_artifact_equals_jax_shape(devices8):
    rec = {"kind": "all_gather", "n_devices": 4, "axis": "data",
           "fabric": "ici", "message_bytes": 4096, "mean_s": 1.0,
           "min_s": 0.5, "algo_gbps": 2.0, "bus_gbps": 1.5,
           "pct_of_ring_peak": None}
    got = tsweep.collectives_artifact([rec], "cpu")
    want = jsweep.collectives_artifact([rec])
    want["detail"]["device"] = "cpu"
    assert got == want


ARGV = ["--device", "cpu", "--min-mb", "0.25", "--max-mb", "0.25",
        "--iters", "2"]


def test_cli_one_process_is_ungateable(tmp_path, devices8):
    v, out, art = (tmp_path / n for n in ("v.txt", "o.jsonl", "b.json"))
    assert tsweep.main(ARGV + ["--verdict-path", str(v)]) == 3
    assert v.read_text() == "ungateable"
    assert tsweep.main(ARGV + ["--kinds", "all_reduce,ppermute",
                               "--min-pct-peak", "0", "--out", str(out),
                               "--bench-out", str(art)]) == 0
    rows = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert [r["kind"] for r in rows] == ["all_reduce", "ppermute"]
    jrows = jsweep.run_sweep(("all_reduce",), "data", min_mb=0.25,
                             max_mb=0.25, iters=1)
    assert all(set(r) == set(jrows[0]) for r in rows)
    assert all(r["pct_of_ring_peak"] is None and r["n_devices"] == 1
               for r in rows)
    doc = json.loads(art.read_text())
    assert set(doc) == set(jsweep.collectives_artifact(jrows))
    assert doc["metric"] == "collective_all_reduce_best_bus_gbps"


CLI = r"""
from tpudist_torch.bench import sweep
rc = sweep.main(json.loads(ARGS[1]))
with open(f"{ARGS[0]}/rc{RANK}", "w") as f:
    f.write(str(rc))
"""


@pytest.mark.parametrize("peak,rc,status", [("1e-6", 0, "success"),
                                            ("1e9", 1, "fail")])
def test_cli_peak_override_gates_over_two_ranks(tmp_path, peak, rc,
                                                status):
    v, out = tmp_path / "v.txt", tmp_path / "o.jsonl"
    run_ranks("import json\n" + CLI, 2, tmp_path, json.dumps(
        ARGV + ["--kinds", "all_reduce,all_gather", "--peak-gbps", peak,
                "--min-pct-peak", "90", "--verdict-path", str(v), "--out",
                str(out)]), timeout=120)
    assert [int((tmp_path / f"rc{r}").read_text()) for r in range(2)] == \
        [rc, rc]
    assert v.read_text() == status
    rows = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert [r["n_devices"] for r in rows] == [2, 2]
    for r in rows:
        assert r["pct_of_ring_peak"] == pytest.approx(
            100 * r["bus_gbps"] / float(peak))
