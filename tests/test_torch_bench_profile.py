"""The port's step profiler (``python -m tpudist_torch.bench.profile``)
against the JAX tool (``tpudist.bench.profile``): ``summarize`` on the
same op rows, the Kineto trace's rows (device kernels on the card, the
host ops' self time on the CPU), and a CPU run end to end."""

import json

import pytest
import torch

from tpudist.bench import profile as jprof
from tpudist_torch.bench import profile as tprof

torch.set_num_threads(1)

OPS = [
    {"category": "convolution fusion", "hlo_op_name": "fusion.1",
     "total_self_time": 1000.0, "bound_by": "Compute",
     "model_flop_rate": 1.0, "measured_memory_bw": 2.0},
    {"category": "loop fusion", "hlo_op_name": "fusion.2",
     "total_self_time": 500.0, "bound_by": "HBM",
     "model_flop_rate": None, "measured_memory_bw": None},
]


@pytest.mark.parametrize("n_steps,top", [(5, 1), (2, 15), (1, 2)])
def test_summarize_equals_the_jax_tool(n_steps, top):
    assert tprof.summarize(OPS, n_steps, top) == jprof.summarize(
        OPS, n_steps, top)
    s = tprof.summarize(OPS, n_steps=5, top=1)
    assert s["total_us_per_step"] == 300.0
    assert s["by_category_us"]["convolution fusion"] == 200.0
    assert [o["name"] for o in s["top_ops"]] == ["fusion.1"]


def test_op_stats_from_device_kernels_and_host_self_time():
    def x(cat, name, ts, dur, tid=1):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "pid": 0, "tid": tid}
    card = {"traceEvents": [
        x("kernel", "void flash_fwd_kernel<float, 128>()", 0.0, 10.0),
        x("kernel", "void flash_fwd_kernel<float, 128>()", 20.0, 10.0),
        x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 40.0, 3.0),
        x("cpu_op", "aten::mm", 0.0, 50.0),
        x("cuda_runtime", "cudaLaunchKernel", 1.0, 2.0)]}
    rows = {r["hlo_op_name"]: r for r in tprof.op_stats(card)}
    assert set(rows) == {"void flash_fwd_kernel<float, 128>()",
                         "Memcpy HtoD (Pageable -> Device)"}
    assert rows["void flash_fwd_kernel<float, 128>()"][
        "total_self_time"] == 20.0
    assert rows["void flash_fwd_kernel<float, 128>()"]["category"] == \
        "kernel"
    assert all(r["bound_by"] is None and r["model_flop_rate"] is None
               for r in rows.values())
    host = {"traceEvents": [
        x("cpu_op", "aten::linear", 0.0, 100.0),
        x("cpu_op", "aten::addmm", 10.0, 60.0),
        x("cpu_op", "aten::copy_", 20.0, 10.0),
        x("cpu_op", "aten::relu", 80.0, 15.0),
        x("cpu_op", "aten::mul", 0.0, 7.0, tid=2)]}
    rows = {r["hlo_op_name"]: r["total_self_time"]
            for r in tprof.op_stats(host)}
    assert rows == {"aten::linear": 25.0, "aten::addmm": 50.0,
                    "aten::copy_": 10.0, "aten::relu": 15.0,
                    "aten::mul": 7.0}


def test_profile_end_to_end_cpu(tmp_path, capsys):
    rc = tprof.main([
        "--steps", "2", "--top", "3", "--device", "cpu",
        "--trace-dir", str(tmp_path / "trace"),
        "--out", str(tmp_path / "prof.json"),
        "--train-batch-size", "16", "--n-samples", "16",
    ])
    assert rc == 0
    s = json.loads((tmp_path / "prof.json").read_text())
    # a CPU capture has no device kernels: the rows are the host ops'
    # self time, and the profiler gives no rate or bound
    assert s["total_us_per_step"] > 0
    assert list(s["by_category_us"]) == ["cpu_op"]
    assert len(s["top_ops"]) == 3
    assert all(o["bound_by"] is None for o in s["top_ops"])
    assert (tmp_path / "trace" / tprof.TRACE_NAME).is_file()
    assert "total: " in capsys.readouterr().out


def test_without_a_card_the_default_device_is_an_error(tmp_path,
                                                       monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tprof.main(["--steps", "1", "--trace-dir",
                       str(tmp_path)]) == 1
    assert "CUDA is not available" in capsys.readouterr().err
