"""The port's CLIs on the CPU write the JAX run's artifact set, and the
JAX package's jax-free offline tools fold the port's run directories
unchanged.

* ``python -m tpudist_torch.train`` (the MLP defaults, cut to 2 epochs,
  and a tiny transformer) writes ``trace.worker0.json``,
  ``pod_trace.json``, ``heartbeat.worker0``, a ``kind=hosts`` record an
  epoch, ``kind=memledger`` and ``memledger.json``, and a ``kind=timing``
  record with every ``mfu`` / ``hbm_*`` / ``straggler_status`` /
  ``trace_status`` key, with ``run_id`` on every record; its losses are
  bitwise those of a run with ``--trace off --stall-timeout-s 0
  --hbm-sample-s 0``.
* ``python -m tpudist_torch.serve`` writes the serve subset (the traces
  with one track per serving slot, ``kind=memledger``,
  ``memledger.json``) and its tokens are those of a ``--trace off`` run.
* A paged serve run (``--kv-page-tokens 8 --shared-prefix 8
  --speculate-k 4``) adds the ``kv_pages`` counter track; the flight
  verifier reads it EXACT, its ``decode_emit`` drafted/accepted sum to
  the summary's acceptance rate, and the report grades that rate.
* ``tpudist.obs.report`` exits 0 on the run directories, the
  ``tpudist.obs.goodput`` partition of a train run is exact, the
  ``tpudist.obs.memledger`` CLI reads the port's ``memledger.json``, and
  ``tpudist.serve.flight`` verifies the serve run exactly.
* Two gloo processes: ``kind=hosts`` has two rows and ``pod_trace.json``
  two host tracks.
"""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from tpudist.obs import goodput as jgoodput
from tpudist.obs import memledger as jmemledger
from tpudist.obs import report as jreport
from tpudist.serve import flight as jflight
from tpudist_torch import train as ttrain
from tpudist_torch.serve import cli as tserve
from _torch_ranks import free_port as _free_port

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBS_OFF = ["--trace", "off", "--stall-timeout-s", "0", "--hbm-sample-s",
           "0"]
MLP = ["--epochs", "2", "--device", "cpu"]
TINY_TF = ["--model", "transformer", "--vocab-size", "256", "--n-layers",
           "2", "--d-model", "256", "--n-heads", "2", "--d-ff", "256",
           "--seq-len", "128", "--n-samples", "24", "--train-batch-size",
           "4", "--epochs", "2", "--log-every", "2", "--lm-head", "fused",
           "--device", "cpu"]
TIMING_KEYS = {"model_flops_per_step", "hbm_bytes_per_step",
               "achieved_tflops_per_chip", "achieved_gbps_per_chip",
               "peak_tflops", "mfu", "hbm_peak_bytes", "hbm_bytes_in_use",
               "hbm_bytes_reserved", "hbm_fragmentation_bytes",
               "hbm_limit_bytes", "hbm_peak_fraction", "hbm_source",
               "straggler_status", "trace_status", "trace_spans",
               "trace_dropped"}
SERVE = ["--device", "cpu", "--requests", "6", "--max-new-tokens", "6",
         "--adapt", "on"]


def _recs(d):
    with open(os.path.join(d, "metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def _train(d, argv):
    """One train run into ``d``, with the launcher's attempts.jsonl
    record around it (what the goodput ledger anchors its wall on)."""
    t0 = time.time()
    rc = ttrain.main(argv + ["--save-dir", d])
    jgoodput.append_attempt(os.path.join(d, jgoodput.ATTEMPTS_NAME),
                            attempt=0, start_ts=t0, end_ts=time.time(),
                            rc=rc, verdict="success" if rc == 0 else "fail")
    return rc, _recs(d)


@pytest.mark.parametrize("argv", [MLP, TINY_TF], ids=["mlp", "tiny_tf"])
def test_default_train_run_writes_the_artifact_set(argv, tmp_path,
                                                   monkeypatch):
    monkeypatch.setenv("TPUDIST_PEAK_TFLOPS", "1")
    d = str(tmp_path / "on")
    rc, recs = _train(d, argv)
    assert rc == 0
    names = set(os.listdir(d))
    assert {"trace.worker0.json", "pod_trace.json", "heartbeat.worker0",
            "memledger.json", "metrics.jsonl"} <= names
    assert "flightrec.worker0" not in names       # no stall
    assert all(r.get("run_id") == recs[0]["run_id"] for r in recs)
    hosts = [r for r in recs if r["kind"] == "hosts"]
    assert [h["epoch"] for h in hosts] == [0, 1]
    assert all(h["straggler_status"] == "ungateable" for h in hosts)
    timing = [r for r in recs if r["kind"] == "timing"][-1]
    assert TIMING_KEYS <= set(timing)
    assert timing["trace_status"] == "success"
    assert timing["hbm_source"] == "rss"
    assert 0 < timing["mfu"] and timing["model_flops_per_step"] > 0
    led = [r for r in recs if r["kind"] == "memledger"]
    assert len(led) == 1 and led[0]["program_temp_complete"] is False
    beat = json.load(open(os.path.join(d, "heartbeat.worker0")))
    assert (beat["phase"], beat["epoch"]) == ("shutdown", 1)
    pod = json.load(open(os.path.join(d, "pod_trace.json")))
    spans = {e["name"] for e in pod["traceEvents"] if e.get("ph") == "X"}
    assert {"distributed_init", "data_materialize", "model_init", "setup",
            "ckpt_open", "epoch", "dispatch", "stage_slab", "fence",
            "eval", "hosts_gather", "ckpt_enqueue"} <= spans
    assert pod["metadata"]["dropped"] == 0
    assert pod["metadata"]["run_id"] == recs[0]["run_id"]

    # the JAX package's offline tools fold the port's run directory
    assert jreport.main(["--run-dir", d]) == 0
    report = json.load(open(os.path.join(d, "run_report.json")))
    assert report["run"]["run_id"] == recs[0]["run_id"]
    assert report["run"]["trace_status"] == "success"
    assert report["memory"]["enabled"] and report["memory"]["exact"]
    ledger = jgoodput.build_from_dir(d)
    assert ledger["exact"] and ledger["goodput_fraction"] > 0
    assert jmemledger.main(["--run-dir", d]) == 0

    # observability off: the same losses, bitwise, and no trace
    off = str(tmp_path / "off")
    rc, recs_off = _train(off, argv + OBS_OFF)
    assert rc == 0
    epochs = [(r["avg_loss"], r["eval_loss"]) for r in recs
              if r["kind"] == "epoch"]
    assert epochs == [(r["avg_loss"], r["eval_loss"]) for r in recs_off
                      if r["kind"] == "epoch"]
    assert [r["loss"] for r in recs if r["kind"] == "step"] == \
        [r["loss"] for r in recs_off if r["kind"] == "step"]
    assert not any(n.endswith(".json") and "trace" in n
                   for n in os.listdir(off))
    t_off = [r for r in recs_off if r["kind"] == "timing"][-1]
    assert (t_off["trace_status"], t_off["hbm_source"],
            t_off["hbm_peak_bytes"]) == ("ungateable", "off", None)


def test_default_serve_run_writes_the_serve_subset(tmp_path):
    d = str(tmp_path / "on")
    on = tserve.run(tserve.parse_args(SERVE + ["--save-dir", d]))
    assert {"trace.worker0.json", "pod_trace.json", "memledger.json",
            "metrics.jsonl"} <= set(os.listdir(d))
    recs = _recs(d)
    assert all(r.get("run_id") == recs[0]["run_id"] for r in recs)
    assert all(r.get("requeue_attempt") == 0 for r in recs)
    assert sum(r["kind"] == "memledger" for r in recs) == 1
    pod = json.load(open(os.path.join(d, "pod_trace.json")))
    tracks = {e["args"]["name"] for e in pod["traceEvents"]
              if e.get("ph") == "M" and e.get("tid", 0) >= 1000}
    served = {f"slot{r['slot']}" for r in recs
              if r["kind"] == "serve_request" and r["event"] == "admitted"}
    assert tracks == served and len(served) > 1
    assert pod["metadata"]["counter_events"] == 0    # the dense lane
    assert jflight.main(["--run-dir", d]) == 0
    assert jreport.main(["--run-dir", d]) == 0
    assert jmemledger.main(["--run-dir", d]) == 0

    off = str(tmp_path / "off")
    no = tserve.run(tserve.parse_args(SERVE + ["--save-dir", off,
                                               "--trace", "off"]))
    assert {k: r["tokens"] for k, r in on["results"].items()} == \
        {k: r["tokens"] for k, r in no["results"].items()}
    assert not os.path.exists(os.path.join(off, "pod_trace.json"))


def test_paged_serve_run_folds_exactly(tmp_path, capsys):
    d = str(tmp_path / "paged")
    summary = tserve.run(tserve.parse_args(
        SERVE + ["--kv-page-tokens", "8", "--shared-prefix", "8",
                 "--speculate-k", "4", "--save-dir", d]))
    assert summary["completed"] == 6 and summary["verify_compiles"] == 1
    capsys.readouterr()
    assert jflight.main(["--run-dir", d]) == 0
    assert "flight: EXACT" in capsys.readouterr().out
    pod = json.load(open(os.path.join(d, "pod_trace.json")))
    assert pod["metadata"]["counter_events"] > 0      # the kv_pages track
    emits = [e["args"] for e in pod["traceEvents"]
             if e.get("name") == "decode_emit"
             and not e["args"].get("track")]
    drafted = sum(a.get("drafted", 0) for a in emits)
    accepted = sum(a.get("accepted", 0) for a in emits)
    assert drafted > 0
    assert summary["spec_accept_rate"] == round(accepted / drafted, 4)
    assert jreport.main(["--run-dir", d]) == 0
    serving = json.load(open(os.path.join(d, "run_report.json")))[
        "serving"]
    assert serving["spec_accept_rate"] == summary["spec_accept_rate"]
    assert serving["spec_accept_status"] == "success"
    assert (serving["verify_compiles"], serving["speculate_k"],
            serving["shared_prefix_len"]) == (1, 4, 8)
    assert serving["kv_pages_used_peak"] == summary["kv_pages_used_peak"]



def test_two_gloo_processes_gather_hosts_and_the_pod_trace(tmp_path):
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   TPUDIST_COORDINATOR=f"localhost:{port}",
                   TPUDIST_NUM_PROCESSES="2", TPUDIST_PROCESS_ID=str(rank),
                   TPUDIST_VERDICT_PATH=str(tmp_path / "job_status.txt"))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tpudist_torch.train", "--device", "cpu",
             "--epochs", "2", "--n-samples", "256", "--save-dir",
             str(tmp_path / "ck")], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    d = str(tmp_path / "ck")
    hosts = [r for r in _recs(d) if r["kind"] == "hosts"]
    assert len(hosts) == 2
    assert [sorted(h["process"] for h in r["hosts"]) for r in hosts] == \
        [[0, 1], [0, 1]]
    pod = json.load(open(os.path.join(d, "pod_trace.json")))
    assert pod["metadata"]["hosts"] == 2
    assert len(pod["metadata"]["clock_offsets_ns"]) == 2
    assert {e["pid"] for e in pod["traceEvents"]
            if e.get("ph") == "X"} == {0, 1}
    assert {"trace.worker0.json", "trace.worker1.json",
            "heartbeat.worker0", "heartbeat.worker1"} <= set(os.listdir(d))
    ids = {json.load(open(os.path.join(d, f"trace.worker{r}.json")))[
        "metadata"]["run_id"] for r in range(2)}
    assert len(ids) == 1
