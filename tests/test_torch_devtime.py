"""The port's device-time attribution (``tpudist_torch.obs.devtime``)
against the JAX package's (``tpudist.obs.devtime``): the copied interval
math, attribution, ``comm_status`` and ``device_events`` on seeded
intervals (and their code pinned), the Kineto parser on a synthetic
two-card trace and on a real CPU capture of ``torch.profiler``, the
window resolver, a windowed CPU train run (losses bitwise a run without
the window, the ``kind=devtime`` record, the JAX report's Device time
section), and the gradient mean's collective bytes against the JAX DP
step's lowered program."""

import ast
import inspect
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from tpudist import config as jconfig
from tpudist.obs import devtime as jdev
from tpudist.obs import report as jreport
from tpudist_torch import config as tconfig
from tpudist_torch import engine as tengine
from tpudist_torch import train as ttrain
from tpudist_torch.obs import devtime as tdev
from _torch_ranks import free_port as _free_port

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _code(obj) -> str:
    """``obj``'s AST without docstrings."""
    tree = ast.parse(inspect.getsource(obj).lstrip())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.FunctionDef, ast.ClassDef)) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("name", [
    "merge_intervals", "measure", "subtract_intervals",
    "intersect_intervals", "attribute_classed", "attribute_tracks",
    "comm_status", "device_events"])
def test_copies_pinned_to_their_sources(name):
    assert _code(getattr(tdev, name)) == _code(getattr(jdev, name)), name
    assert (tdev.DEVICE_TID_BASE, tdev.DEVTIME_CAT, tdev.COMM_EXPOSED_MAX,
            tdev.COMM_EXPOSED_MAX_DCN) == (
        jdev.DEVICE_TID_BASE, jdev.DEVTIME_CAT, jdev.COMM_EXPOSED_MAX,
        jdev.COMM_EXPOSED_MAX_DCN)


def _intervals(rng, n):
    lo = rng.uniform(0, 100, size=n)
    return [(float(a), float(a + d)) for a, d in
            zip(lo, rng.uniform(0, 15, size=n))]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_interval_math_equal_jax(seed):
    rng = np.random.default_rng(seed)
    a, b = _intervals(rng, 12), _intervals(rng, 9)
    for fn in ("merge_intervals",):
        assert getattr(tdev, fn)(a) == getattr(jdev, fn)(a)
    for fn in ("subtract_intervals", "intersect_intervals"):
        assert getattr(tdev, fn)(a, b) == getattr(jdev, fn)(a, b)
    m = tdev.merge_intervals(a)
    assert tdev.measure(m) == jdev.measure(m)
    tot = tdev.measure(m)
    cut = tdev.measure(tdev.subtract_intervals(a, b))
    hit = tdev.measure(tdev.intersect_intervals(a, b))
    assert cut + hit == pytest.approx(tot, abs=1e-9)


def test_interval_edge_cases_as_the_jax_tests_pin_them():
    sub = tdev.subtract_intervals
    assert tdev.merge_intervals(
        [(5, 7), (0, 2), (1, 3), (7, 7), (6, 9)]) == [(0, 3), (5, 9)]
    assert sub([(0, 10)], [(2, 4), (6, 8)]) == [(0, 2), (4, 6), (8, 10)]
    assert sub([(0, 10)], [(0, 10)]) == [] and sub([(0, 10)], []) == [
        (0, 10)]
    assert sub([(0, 4), (6, 10)], [(3, 7)]) == [(0, 3), (7, 10)]
    assert tdev.intersect_intervals([(0, 2)], [(2, 4)]) == []


@pytest.mark.parametrize("seed", [0, 1])
def test_attribute_tracks_and_device_events_equal_jax(seed):
    """The same op intervals, named so that both packages' ``classify``
    agree (an XLA all-reduce name is comm to the JAX rule, an NCCL kernel
    to the port's), attribute the same and coalesce into the same merged
    trace rows."""
    rng = np.random.default_rng(seed)
    tracks_t, tracks_j = {}, {}
    for dev in ("d0", "d1"):
        ops_t, ops_j = [], []
        for t0, t1 in _intervals(rng, 10):
            comm = rng.uniform() < 0.4
            ops_t.append((t0, t1, "ncclDevKernel_AllReduce_Sum_f32"
                          if comm else "void flash_fwd_kernel<float>()"))
            ops_j.append((t0, t1, "all-reduce.1" if comm else "fusion.3"))
        tracks_t[dev], tracks_j[dev] = ops_t, ops_j
    t, j = tdev.attribute_tracks(tracks_t), jdev.attribute_tracks(tracks_j)
    assert t == j
    for d in t["devices"].values():
        assert (d["compute_frac"] + d["exposed_comm_frac"]
                + d["idle_frac"]) == pytest.approx(1.0)
    assert tdev.device_events(t, process_index=3, anchor_us=1e6) == \
        jdev.device_events(j, process_index=3, anchor_us=1e6)
    assert tdev.attribute_tracks({}) == jdev.attribute_tracks({})


def test_comm_status_and_its_env_overrides_equal_jax(monkeypatch):
    from tpudist import verdict as jverdict
    from tpudist_torch import verdict as tverdict
    for env in (None, "0.05", "0.5", "bogus"):
        if env is None:
            monkeypatch.delenv("TPUDIST_COMM_EXPOSED_MAX", raising=False)
        else:
            monkeypatch.setenv("TPUDIST_COMM_EXPOSED_MAX", env)
        for frac in (None, 0.0, 0.1, 0.25, 0.26, 0.9):
            for fabric in (None, "ici", "dcn"):
                want = jdev.comm_status(frac, fabric=fabric)
                assert tdev.comm_status(frac, fabric=fabric) == want
                assert tverdict.comm_status(frac, fabric=fabric) == \
                    jverdict.comm_status(frac, fabric=fabric) == want
    monkeypatch.delenv("TPUDIST_COMM_EXPOSED_MAX")
    assert tdev.comm_status(0.26) == "fail"
    assert tdev.comm_status(0.3, fabric="dcn") == "success"


@pytest.mark.parametrize("name,cls", [
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage)",
     "comm"), ("ncclKernel_AllGather_RING_LL_Sum_int8_t()", "comm"),
    ("c10d::allreduce_", "comm"), ("gloo:all_reduce", "comm"),
    ("void flash_fwd_kernel<__nv_bfloat16, 128>()", "compute"),
    ("Memcpy DtoH (Device -> Pinned)", "compute"), ("aten::mm", "compute"),
    ("", None)])
def test_classify_the_ports_names(name, cls):
    assert tdev.classify(name) == cls


def _kineto_doc():
    """Kineto's trace shape with two cards: kernels, a copy and a memset
    on the devices (two streams on card 0), NCCL kernels, and the host's
    runtime noise (cuda_runtime, cuda_driver, python_function,
    user_annotation, gpu_user_annotation, cpu_op, flow events)."""
    def x(cat, name, ts, dur, pid=0, tid=7, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "pid": pid, "tid": tid, "args": args}
    return {
        "deviceProperties": [{"id": 0, "name": "NVIDIA H100 80GB HBM3"},
                             {"id": 1, "name": "NVIDIA H100 80GB HBM3"}],
        "traceEvents": [
            {"ph": "M", "name": "process_name", "pid": 0,
             "args": {"name": "python3 0"}},
            x("kernel", "void flash_fwd_kernel<float, 128>()", 100.0, 10.0,
              device=0, stream=7),
            x("kernel", "ncclDevKernel_AllReduce_Sum_f32_RING_LL()", 105.0,
              20.0, tid=13, device=0, stream=13),
            x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 130.0, 2.0,
              device=0),
            x("gpu_memset", "Memset (Device)", 133.0, 1.0, device=0),
            x("kernel", "void xent_fwd_kernel<float>()", 100.0, 5.0, pid=1,
              device=1),
            x("kernel", "ncclKernel_AllReduce_RING_LL_Sum_float()", 120.0,
              5.0, pid=1, device=1),
            x("cuda_runtime", "cudaLaunchKernel", 95.0, 3.0, pid=4242),
            x("cuda_driver", "cuLaunchKernel", 96.0, 2.0, pid=4242),
            x("python_function", "train.py(1): run", 0.0, 500.0,
              pid=4242),
            x("user_annotation", "tpudist_profile_anchor", 90.0, 1.0,
              pid=4242),
            x("gpu_user_annotation", "whole_step", 90.0, 100.0),
            x("cpu_op", "aten::mm", 94.0, 4.0, pid=4242),
            {"ph": "s", "cat": "ac2g", "name": "ac2g", "id": 1, "ts": 95.0,
             "pid": 4242, "tid": 1},
        ]}


def test_device_op_tracks_on_a_two_card_kineto_trace():
    tracks = tdev.device_op_tracks(_kineto_doc())
    assert sorted(tracks) == ["cuda:0 NVIDIA H100 80GB HBM3",
                              "cuda:1 NVIDIA H100 80GB HBM3"]
    zero = tracks["cuda:0 NVIDIA H100 80GB HBM3"]
    assert [op[2].split("(")[0] for op in zero] == [
        "void flash_fwd_kernel<float, 128>",
        "ncclDevKernel_AllReduce_Sum_f32_RING_LL",
        "Memcpy DtoH ", "Memset "]
    out = tdev.attribute_tracks(tracks)
    d0 = out["devices"]["cuda:0 NVIDIA H100 80GB HBM3"]
    # the all-reduce [105, 125] under the kernel [100, 110]: 15 µs exposed
    assert d0["exposed_comm_s"] * 1e6 == pytest.approx(15.0)
    assert d0["comm_s"] * 1e6 == pytest.approx(20.0)
    d1 = out["devices"]["cuda:1 NVIDIA H100 80GB HBM3"]
    assert d1["exposed_comm_s"] * 1e6 == pytest.approx(5.0)
    assert out["pod"]["devices"] == 2
    assert tdev.anchor_ts(_kineto_doc()) == 90.0


def test_a_cpu_trace_folds_into_one_host_track():
    doc = _kineto_doc()
    doc["traceEvents"] = [e for e in doc["traceEvents"]
                          if e.get("cat") not in tdev.DEVICE_CATS]
    doc["traceEvents"].append({"ph": "X", "cat": "user_annotation",
                               "name": "gloo:all_reduce", "ts": 200.0,
                               "dur": 8.0, "pid": 4242, "tid": 3})
    tracks = tdev.device_op_tracks(doc)
    assert list(tracks) == [tdev.HOST_TRACK]
    assert sorted(op for _, _, op in tracks[tdev.HOST_TRACK]) == [
        "aten::mm", "gloo:all_reduce"]


def test_a_real_cpu_capture_through_the_window(tmp_path):
    """``WindowProfiler`` on the CPU: it opens at its trigger epoch,
    stops itself after N dispatches, writes at close a Kineto trace that
    ``analyze_capture`` attributes on the host track, and its measured
    clock offset puts the device rows inside the window's host span."""
    from tpudist_torch.obs import trace as trace_lib
    tracer = trace_lib.configure(enabled=True)
    win = tdev.WindowProfiler(str(tmp_path / "profile"), 2,
                              trigger_epoch=1)
    win.maybe_start(0)
    assert win.state == "armed"
    win.maybe_start(1)
    assert win.state == "open" and win.anchor_ns <= win.marker_ns
    x = torch.randn(64, 64)
    for _ in range(3):
        y = x @ x
        win.note_dispatch(y)
    # stopped in the loop; the trace is written at close, off the steps
    assert win.state == "done" and win.seen == 2 and not win.captured
    win.close()
    assert win.captured and win.stop_s >= 0 and win.export_s >= 0
    win.close()
    assert win.emergency_stop() is None
    out = tdev.analyze_capture(win.capture_dir)
    assert list(out["devices"]) == [tdev.HOST_TRACK]
    assert out["pod"]["compute_s"] > 0 and out["pod"]["comm_s"] == 0
    events = tdev.device_events(out, process_index=0,
                                anchor_us=win.offset_us(out))
    (span,) = [s for s in tracer.to_doc()["traceEvents"]
               if s.get("name") == "profile_window"]
    rows = [e for e in events if e["ph"] == "X"]
    assert rows and all(span["ts"] <= e["ts"] and e["ts"] + e["dur"]
                        <= span["ts"] + span["dur"] for e in rows)
    with pytest.raises(FileNotFoundError):
        tdev.analyze_capture(str(tmp_path / "empty"))


def test_a_stall_loses_the_open_window_and_says_why(tmp_path):
    """``torch.profiler`` stops only on the thread that started it, so
    the watchdog's hook cannot keep a partial capture as the JAX one
    does: it marks the window lost without touching the profiler or
    waiting on the main thread, the flight record names the loss and
    why, and the main thread's close stops the profiler and keeps no
    capture (ROADMAP Queue C)."""
    from tpudist_torch.metrics import MetricsLogger
    from tpudist_torch.obs.heartbeat import FlightRecorder

    win = tdev.WindowProfiler(str(tmp_path / "profile"), 100)
    win.maybe_start(0)
    metrics = MetricsLogger(path=None)
    rec = FlightRecorder(str(tmp_path), stall_timeout_s=0.3,
                         metrics=metrics, stall_hook=win.emergency_stop)
    try:
        rec.note_progress(phase="train", epoch=0, step=1)
        deadline = time.monotonic() + 10.0
        while rec.dumps < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert rec.dumps >= 1
        assert win.state == "lost" and win.lost == tdev.LOST_ON_WATCHDOG
    finally:
        rec.close()
        metrics.close()
    art = json.loads(Path(rec.flightrec_path).read_text())
    assert art["extra"]["profile_capture_lost"] == tdev.LOST_ON_WATCHDOG
    assert "profile_capture" not in art["extra"]
    win.close()
    assert win.state == "done" and not win.captured
    assert not tdev.find_captures(win.capture_dir)


def test_the_window_on_its_own_thread_stops_and_keeps_the_capture(
        tmp_path):
    win = tdev.WindowProfiler(str(tmp_path), 5)
    assert win.emergency_stop() is None and win.state == "armed"
    win.maybe_start(0)
    torch.randn(8, 8).sum()
    assert win.emergency_stop() == win.capture_dir
    assert win.captured and tdev.find_captures(win.capture_dir)
    with pytest.raises(ValueError):
        tdev.WindowProfiler(str(tmp_path), 0)


# ------------------------------------------------- config + resolvers


def test_resolve_profile_window_equal_jax(monkeypatch):
    for env in (None, "2", "-3", "x"):
        if env is None:
            monkeypatch.delenv("TPUDIST_PROFILE_WINDOW", raising=False)
        else:
            monkeypatch.setenv("TPUDIST_PROFILE_WINDOW", env)
        for argv in ([], ["--profile-window", "3"],
                     ["--profile-window", "4", "--profile-dir", "/tmp/p"],
                     ["--profile-dir", "/tmp/p"]):
            t, j = tconfig.parse_args(argv), jconfig.parse_args(argv)
            assert tconfig.resolve_profile_window(t) == \
                jconfig.resolve_profile_window(j), (env, argv)
    for mod in (tconfig, jconfig):
        with pytest.raises(ValueError):
            mod.resolve_profile_window(mod.parse_args(
                ["--profile-window", "-1"]))


def test_window_composes_with_autotune_and_keeps_the_superstep():
    argv = ["--profile-window", "2", "--autotune", "probe",
            "--log-every", "4"]
    t, j = tconfig.parse_args(argv), jconfig.parse_args(argv)
    assert tconfig.resolve_autotune(t) == jconfig.resolve_autotune(j) \
        == "probe"
    assert tconfig.resolve_steps_per_dispatch(t) == \
        jconfig.resolve_steps_per_dispatch(j) == 4


# ------------------------------------------------ the windowed CLI run

ARGV = ["--device", "cpu", "--epochs", "2", "--train-batch-size", "64",
        "--n-samples", "512", "--log-every", "4"]


def _run(save, extra=()):
    assert ttrain.main(ARGV + list(extra) + ["--save-dir", str(save)]) == 0
    return [json.loads(ln) for ln in (save / "metrics.jsonl").read_text()
            .splitlines()]


@pytest.fixture(scope="module")
def windowed(tmp_path_factory):
    d = tmp_path_factory.mktemp("win")
    return d, _run(d / "on", ["--profile-window", "2"]), _run(d / "off")


def test_windowed_run_record_and_bitwise_losses(windowed):
    d, on, off = windowed

    def losses(recs):
        return [(r["step"], r["loss"]) for r in recs if r["kind"] == "step"]
    assert losses(on) == losses(off) and losses(on)
    assert [(r["avg_loss"], r["eval_loss"]) for r in on
            if r["kind"] == "epoch"] == [
        (r["avg_loss"], r["eval_loss"]) for r in off if r["kind"] == "epoch"]
    (rec,) = [r for r in on if r["kind"] == "devtime"]
    assert rec["comm_status"] == "success" and rec["dispatches"] == 2
    assert rec["fabric"] == "ici" and rec["axis_fabric"] == {}
    assert [p["device"] for p in rec["per_device"]] == [tdev.HOST_TRACK]
    assert rec["window_s"] > 0 and rec["compute_s"] > 0
    timing = [r for r in on if r["kind"] == "timing"][0]
    assert timing["comm_status"] == "success"
    assert [r for r in off if r["kind"] == "timing"][0][
        "comm_status"] == "ungateable"
    assert not [r for r in off if r["kind"] == "devtime"]
    assert not (d / "off" / "profile").exists()
    assert tdev.find_captures(str(d / "on" / "profile" / "worker0"))


def test_windowed_run_device_rows_and_the_jax_report(windowed):
    d, _, _ = windowed
    pod = json.loads((d / "on" / "pod_trace.json").read_text())
    (span,) = [e for e in pod["traceEvents"]
               if e.get("name") == "profile_window"]
    rows = [e for e in pod["traceEvents"] if e.get("cat") == "devtime"]
    assert rows and all(span["ts"] <= e["ts"] and e["ts"] + e["dur"]
                        <= span["ts"] + span["dur"] for e in rows)
    assert all(e["tid"] >= tdev.DEVICE_TID_BASE and e["pid"] == 0
               for e in rows)
    assert pod["metadata"]["device_tracks"] == 1
    assert jreport.main(["--run-dir", str(d / "on")]) == 0
    rep = json.loads((d / "on" / "run_report.json").read_text())
    assert rep["devtime"]["comm_status"] == "success"
    assert "## Device time" in (d / "on" / "run_report.md").read_text()


# ------------------------------------------------- collective bytes



def _pmean_operands():
    """What the step's all-reduces reduce in one step of the default MLP
    (``overlap.barrier_mean``: the grads, then the loss through
    ``engine.pmean``), as ``(dtype, bytes)``: the step run once in a
    one-process gloo group, ``barrier_mean`` wrapped; the step's own
    notes name the same operands."""
    seen = []
    real = tengine.overlap_lib.barrier_mean

    def barrier_mean(tensors, **kw):
        seen.extend((t.dtype, t.numel() * t.element_size())
                    for t in tensors)
        return real(tensors, **kw)
    cfg = tconfig.parse_args(["--device", "cpu", "--train-batch-size", "8"])
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        with mock.patch.object(tengine.overlap_lib, "barrier_mean",
                               barrier_mean):
            state = tengine.init_state(cfg, torch.device("cpu"))
            step = tengine.make_train_step(cfg, torch.device("cpu"))
            x = torch.zeros(8, 20)
            y = torch.zeros(8, 1)
            step(state, (x, y))
        assert [tuple(op[1:3]) if len(op) == 4 else op
                for op in step.reduced_operands()] == seen
    finally:
        dist.destroy_process_group()
    return seen


def _jax_dp_collectives():
    """``collective_bytes`` over the JAX DP step's lowered text, default
    MLP, global batch 8 over two devices."""
    from jax.sharding import PartitionSpec as P

    from tpudist import data as jdata
    from tpudist import engine as jengine
    from tpudist.parallel import build_mesh
    from tpudist.parallel import sharding as shd
    from tpudist.utils import compat
    cfg = jconfig.TrainConfig(batch_size=8)
    mesh = build_mesh(jconfig.ParallelConfig(data=-1),
                      devices=jax.devices()[:2])
    state = jengine.init_state(jax.random.PRNGKey(0), cfg, mesh)
    body, dp, _ = jengine._build_step_body(cfg, mesh)
    assert dp

    def jitted(state, batch):
        bspecs = jax.tree.map(lambda x: shd.batch_spec(x.ndim), batch)
        return compat.shard_map(body, mesh=mesh, in_specs=(P(), bspecs),
                                out_specs=(P(), P()),
                                check_vma=False)(state, batch)
    staged = shd.put_batch(mesh, jdata.make_synthetic_data(8, 20, 42))
    text = jax.jit(jitted).lower(state, staged).as_text()
    return jdev.collective_bytes(text, [0, 0])


def test_collective_bytes_of_two_gloo_ranks(tmp_path):
    """Two gloo ranks of the train CLI with the window on: the devtime
    record's collective bytes are the operands ``engine.pmean`` reduces
    in a step, its gloo collectives count as comm on the host track, and
    the total equals the JAX ``collective_bytes`` over the JAX DP step's
    lowered program. Both issue one all-reduce a tensor (a grad each,
    then the loss), so the op counts agree too."""
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, TPUDIST_COORDINATOR=f"127.0.0.1:{port}",
                   TPUDIST_NUM_PROCESSES="2", TPUDIST_PROCESS_ID=str(rank),
                   OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tpudist_torch.train", "--device", "cpu",
             "--epochs", "1", "--train-batch-size", "8", "--n-samples",
             "64", "--log-every", "1", "--profile-window", "2",
             "--save-dir", str(tmp_path)], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=240)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs[0][-2000:]
    recs = [json.loads(ln) for ln in (tmp_path / "metrics.jsonl")
            .read_text().splitlines()]
    (rec,) = [r for r in recs if r["kind"] == "devtime"]
    mine = tdev.collective_bytes(_pmean_operands())
    assert rec["collectives"] == mine["ops"]
    assert rec["ici_bytes_total"] == mine["ici_bytes_total"] == sum(
        b for _, b in _pmean_operands())
    assert rec["dcn_bytes_total"] == 0
    assert rec["axis_fabric"] == {"data": "ici"}
    assert rec["comm_s"] > 0          # gloo's all-reduces on the host track
    assert "tpudist: collectives 5 op(s)/step: 0 B dcn" in outs[0]
    theirs = _jax_dp_collectives()
    assert mine["ici_bytes_total"] == theirs["ici_bytes_total"]
    assert mine["n_collectives"] == theirs["n_collectives"]
    assert sorted((r["dtype"], r["bytes"], r["count"]) for r in
                  mine["ops"]) == sorted(
        (r["dtype"], r["bytes"], r["count"]) for r in theirs["ops"])

