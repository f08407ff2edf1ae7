"""Step profiler: where does the train step's time go?

The port of ``tpudist/bench/profile.py``: it traces a few steady steps
of the configured workload under ``torch.profiler``, reads the Kineto
trace, and prints a per-category and per-op table. On the card the rows
are the device's kernels, copies and memsets (a kernel's time is its
self time; ``category`` is Kineto's event category); a capture without
device events (the CPU) falls back to the host ops' self time. The
profiler gives no op's flop rate, bandwidth or bound, so those columns
stay ``None``, as the JAX tool prints zeros for CPU xplanes. The trace
stays in ``--trace-dir`` for Perfetto or TensorBoard.

Run:  python -m tpudist_torch.bench.profile [--model transformer]
          [--steps 5] [any tpudist_torch.train flags] [--out profile.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from collections import defaultdict
from typing import Any, Dict, List, Optional

from tpudist_torch.obs import devtime as devtime_lib

TRACE_NAME = "profile.pt.trace.json"


def op_stats(doc: Dict[str, Any]) -> List[Dict[str, Any]]:
    """One Kineto trace -> per-op rows in the JAX tool's ``hlo_stats``
    keys: ``hlo_op_name`` (the kernel's or op's name), ``category``,
    ``total_self_time`` (µs over the capture), and ``bound_by``,
    ``model_flop_rate``, ``measured_memory_bw`` left ``None``."""
    events = [e for e in doc.get("traceEvents", [])
              if e.get("ph") == "X" and "ts" in e and "dur" in e]
    device = [e for e in events if e.get("cat") in devtime_lib.DEVICE_CATS]
    rows = ([(e["name"], e["cat"], float(e["dur"])) for e in device]
            if device else _host_self_times(
                [e for e in events if e.get("cat") == "cpu_op"]))
    agg: Dict[tuple, float] = defaultdict(float)
    for name, cat, us in rows:
        agg[(name, cat)] += us
    return [{"hlo_op_name": name, "category": cat, "total_self_time": us,
             "bound_by": None, "model_flop_rate": None,
             "measured_memory_bw": None}
            for (name, cat), us in agg.items()]


def _host_self_times(events: List[Dict[str, Any]]) -> List[tuple]:
    """Host ops' self time: each op's duration less its direct
    children's on the same thread."""
    threads: Dict[tuple, List[Dict[str, Any]]] = defaultdict(list)
    for e in events:
        threads[(e.get("pid"), e.get("tid"))].append(e)
    out: List[list] = []
    for evs in threads.values():
        evs.sort(key=lambda e: (float(e["ts"]), -float(e["dur"])))
        stack: List[tuple] = []           # (end, row) of the open ops
        for e in evs:
            t0 = float(e["ts"])
            while stack and stack[-1][0] <= t0:
                stack.pop()
            row = [e["name"], e["cat"], float(e["dur"])]
            if stack:
                stack[-1][1][2] -= row[2]
            stack.append((t0 + row[2], row))
            out.append(row)
    return [tuple(r) for r in out]


def summarize(ops, n_steps: int, top: int = 15) -> dict:
    """Aggregate op stats into per-category and top-op tables (µs/step)."""
    by_cat = defaultdict(float)
    total = 0.0
    for op in ops:
        t = float(op.get("total_self_time") or 0) / n_steps
        by_cat[op.get("category")] += t
        total += t
    top_ops = sorted(ops, key=lambda o: -float(o.get("total_self_time")
                                               or 0))[:top]
    return {
        "total_us_per_step": round(total, 1),
        "by_category_us": {k: round(v, 1) for k, v in
                           sorted(by_cat.items(), key=lambda kv: -kv[1])},
        "top_ops": [{
            "us_per_step": round(float(o.get("total_self_time") or 0)
                                 / n_steps, 1),
            "category": o.get("category"),
            "name": o.get("hlo_op_name"),
            "bound_by": o.get("bound_by"),
            "gflops_per_sec": o.get("model_flop_rate"),
            "mem_bw_gbps": o.get("measured_memory_bw"),
        } for o in top_ops],
    }


def profile_step(cfg, trace_dir: str, n_steps: int = 5) -> str:
    """Trace ``n_steps`` steady-state train steps of ``cfg``'s workload
    (after 3 warm-ups) on ``cfg.device``; returns the trace's path."""
    from torch.profiler import ProfilerActivity, profile

    from tpudist_torch import data as data_lib
    from tpudist_torch import engine
    from tpudist_torch.ops.cuda import build as build_lib
    from tpudist_torch.utils.platform import resolve_device

    device = resolve_device(cfg.device)
    build_lib.set_build_root(cfg.compilation_cache_dir)
    state = engine.init_state(cfg, device)
    step = engine.make_train_step(cfg, device)
    if cfg.model.name == "mlp":
        src = data_lib.make_synthetic_data(
            cfg.batch_size, cfg.data.n_features, cfg.data.seed)
    else:
        src = (data_lib.make_synthetic_tokens(
            cfg.batch_size, cfg.model.max_seq_len + 1,
            cfg.model.vocab_size, cfg.data.seed),)
    batch = data_lib.to_device(src, device)
    for _ in range(3):                       # build + warm
        state, loss = step(state, batch)
    float(loss)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        for _ in range(n_steps):
            state, loss = step(state, batch)
        float(loss)                          # fence inside the trace
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, TRACE_NAME)
    prof.export_chrome_trace(path)
    return path


def main(argv: Optional[list] = None) -> int:
    from tpudist_torch.config import parse_args

    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--top", type=int, default=15)
    p.add_argument("--trace-dir", type=str, default=None)
    p.add_argument("--out", type=str, default=None,
                   help="also write the summary as JSON here")
    own, rest = p.parse_known_args(argv)
    if own.steps < 1:
        p.error("--steps must be >= 1")
    cfg = parse_args(rest)

    trace_dir = own.trace_dir or tempfile.mkdtemp(prefix="tpudist_prof_")
    try:
        path = profile_step(cfg, trace_dir, n_steps=own.steps)
    except RuntimeError as e:
        print(f"tpudist_torch.bench.profile: {e}", file=sys.stderr)
        return 1
    s = summarize(op_stats(devtime_lib.load_capture_doc(path)),
                  own.steps, top=own.top)

    print(f"trace: {path}")
    print(f"total: {s['total_us_per_step']:.0f} us/step")
    print(f"{'us/step':>9}  {'%':>5}  category")
    denom = s["total_us_per_step"] or 1.0
    for cat, us in s["by_category_us"].items():
        print(f"{us:9.0f}  {100 * us / denom:5.1f}  {cat}")
    print(f"\n{'us/step':>9}  {'bound':>8}  {'GF/s':>8}  {'GB/s':>7}  op")
    for o in s["top_ops"]:
        print(f"{o['us_per_step']:9.0f}  {str(o['bound_by'])[:8]:>8}  "
              f"{str(o['gflops_per_sec'])[:8]:>8}  "
              f"{str(o['mem_bw_gbps'])[:7]:>7}  {o['name']}")
    if own.out:
        with open(own.out, "w") as f:
            json.dump(s, f, indent=1)
        print(f"\nwrote {own.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
