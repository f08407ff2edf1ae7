"""Collective bandwidth sweep: the counterpart of ``tpudist/bench/sweep.py``.

The measured analogue of "did NCCL work": sweeps message sizes 1 MB to
1 GB per collective kind over one process a card and reports bus
bandwidth and its percentage of the fabric's peak.

Run:  python -m tpudist_torch.bench.sweep [--kinds all_reduce,...]
          [--axis data] [--min-mb 1] [--max-mb 1024] [--iters 10]
          [--min-pct-peak 90] [--peak-gbps G] [--verdict-path p]
          [--out sweep.jsonl] [--bench-out BENCH_COLLECTIVES.json]

under the env contract (``TPUDIST_COORDINATOR`` /
``TPUDIST_NUM_PROCESSES`` / ``TPUDIST_PROCESS_ID``), one process a card;
``--device cpu`` (or ``TPUDIST_PLATFORM=cpu``) runs it over gloo.

The sweep is a GATE: each kind's BEST bucket must reach
``--min-pct-peak`` percent of the peak, else exit 1 and ``fail`` to
``--verdict-path``. The peak is ``--peak-gbps``, else the card's own
NVLink figure (:func:`nvlink_peak_gbps`: the sum of its active links'
per-direction speed, from ``nvidia-smi nvlink --status``). With neither
(the CPU, a card without NVLink) the gate is UNGATEABLE: exit 3 and
``ungateable`` to the verdict path, as in the JAX package. Only rank 0
writes ``--out`` (clean JSONL), ``--bench-out`` and the verdict.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import tempfile
from typing import List, Optional

import torch
import torch.distributed as dist

from tpudist_torch.metrics import log0
from tpudist_torch.ops import collectives
from tpudist_torch.parallel import mesh as mesh_lib
from tpudist_torch.train import device_kind

_LINK_RE = re.compile(r"Link \d+: ([0-9.]+) GB/s")


def _smi(*args: str) -> Optional[str]:
    try:
        return subprocess.run(["nvidia-smi", *args], capture_output=True,
                              text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None


def nvlink_peak_gbps(index: int = 0) -> Optional[float]:
    """The card's NVLink peak, GB/s: the sum of its active links'
    per-direction speed as ``nvidia-smi nvlink --status -i <index>``
    lists them (``Link <k>: <speed> GB/s``; an inactive link is listed
    without a speed). None without ``nvidia-smi`` or an active link."""
    out = _smi("nvlink", "--status", "-i", str(index))
    if not out:
        return None
    speeds = [float(m) for m in _LINK_RE.findall(out)]
    return sum(speeds) if speeds else None


def sweep_sizes(min_mb: float = 1, max_mb: float = 1024) -> List[int]:
    """1 MB -> 1 GB in x4 steps (6 buckets at defaults)."""
    sizes, s = [], int(min_mb * 2**20)
    top = int(max_mb * 2**20)
    while s <= top:
        sizes.append(s)
        s *= 4
    return sizes


def collectives_artifact(records: List[dict],
                         device: str = "unknown") -> dict:
    """BENCH_COLLECTIVES.json in the JAX package's shape: one headline
    metric, the best all-reduce bus bandwidth (or, when the sweep did
    not include all_reduce, the kind it measured best), and the per-kind
    per-size rows in ``detail``; axis and fabric from the records."""
    kind = "all_reduce"
    if not any(r["kind"] == kind for r in records):
        kind = max(records, key=lambda r: r["bus_gbps"])["kind"] \
            if records else "all_reduce"
    best = max((r["bus_gbps"] for r in records if r["kind"] == kind),
               default=0.0)
    return {
        "metric": f"collective_{kind}_best_bus_gbps",
        "value": round(best, 4),
        "unit": f"GB/s bus bandwidth (best {kind} bucket)",
        "detail": {
            "device": device,
            "n_devices": records[0]["n_devices"] if records else 0,
            "axis": records[0]["axis"] if records else None,
            "fabric": records[0]["fabric"] if records else None,
            "kinds": sorted({r["kind"] for r in records}),
            "rows": records,
        },
    }


def write_collectives_artifact(records: List[dict], path: str,
                               device: str = "unknown") -> dict:
    """The one writer of the sweep's BENCH_COLLECTIVES.json artifact."""
    art = collectives_artifact(records, device)
    with open(path, "w") as f:
        json.dump(art, f, indent=1)
    return art


def _axis_group(axis: str):
    """The process group of ``axis`` on the world's rank grid (every
    axis but ``data`` has size 1 there): the world for ``data``, this
    rank alone otherwise (every rank makes every one-rank group)."""
    world = dist.get_world_size()
    grid = mesh_lib.rank_grid(mesh_lib.ParallelConfig(), world)
    if axis not in grid.mesh_dim_names:
        raise ValueError(f"unknown mesh axis {axis!r}; one of "
                         f"{grid.mesh_dim_names}")
    if mesh_lib.axis_size(grid, axis) == world:
        return None, grid
    mine = None
    for r in range(world):
        g = dist.new_group([r])
        if r == dist.get_rank():
            mine = g
    return mine, grid


def run_sweep(kinds=("all_reduce",), axis: str = "data", *,
              min_mb: float = 1, max_mb: float = 1024, iters: int = 10,
              peak_gbps: Optional[float] = None,
              device: Optional[torch.device] = None) -> List[dict]:
    """One record per (kind, size): message size, time, algo/bus GB/s,
    % of the peak (None without a peak, or over one rank). ``peak_gbps``
    is the operator's figure, else the card's own NVLink query."""
    device = torch.device(device or "cuda")
    group, grid = _axis_group(axis)
    n = dist.get_world_size(group)
    if peak_gbps is None and device.type == "cuda":
        peak_gbps = nvlink_peak_gbps(device.index or 0)
    fabric = mesh_lib.axis_fabric(grid, axis)
    out = []
    for kind in kinds:
        for size in sweep_sizes(min_mb, max_mb):
            t = collectives.time_collective(kind, group, message_bytes=size,
                                            iters=iters, device=device)
            rec = {
                "kind": kind, "n_devices": n,
                "axis": axis, "fabric": fabric,
                "message_bytes": t.message_bytes,
                "mean_s": t.mean_s, "min_s": t.min_s,
                "algo_gbps": t.algo_gbps, "bus_gbps": t.bus_gbps,
                "pct_of_ring_peak": (100 * t.bus_gbps / peak_gbps
                                     if peak_gbps and n > 1 else None),
            }
            out.append(rec)
            log0(json.dumps(rec))
    return out


def gate(records: List[dict], min_pct_peak: float) -> dict:
    """The bandwidth acceptance gate: per collective kind, the best
    bucket's ``pct_of_ring_peak`` must reach ``min_pct_peak``.

    Returns {"ok": bool|None, "per_kind": {kind: best_pct}, "reason": str}.
    ``ok`` is None (gate not applicable, NOT a pass) when nothing could be
    measured against a peak: one rank, or no peak."""
    per_kind: dict = {}
    for r in records:
        if r["pct_of_ring_peak"] is None:
            continue
        best = per_kind.get(r["kind"])
        if best is None or r["pct_of_ring_peak"] > best:
            per_kind[r["kind"]] = r["pct_of_ring_peak"]
    if not per_kind:
        return {"ok": None, "per_kind": {},
                "reason": "no gateable records (single device or unknown "
                          "chip peak)"}
    bad = {k: v for k, v in per_kind.items() if v < min_pct_peak}
    if bad:
        return {"ok": False, "per_kind": per_kind,
                "reason": f"below {min_pct_peak}% of ring peak: " + ", ".join(
                    f"{k}={v:.1f}%" for k, v in sorted(bad.items()))}
    return {"ok": True, "per_kind": per_kind,
            "reason": f"all kinds ≥ {min_pct_peak}% of ring peak"}


def _join(device: torch.device):
    """The process group of the env contract; a lone process joins a
    one-rank group of its own over a file store (no port to take)."""
    from tpudist_torch.parallel import distributed
    ctx = distributed.initialize(device=device)
    if not dist.is_initialized():
        store = os.path.join(tempfile.mkdtemp(prefix="tpudist_sweep_"),
                             "store")
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method=f"file://{store}", rank=0, world_size=1)
    return ctx


def main(argv=None) -> int:
    from tpudist_torch import verdict
    from tpudist_torch.parallel import distributed
    from tpudist_torch.utils.platform import platform_device, resolve_device

    p = argparse.ArgumentParser()
    p.add_argument("--kinds", type=str, default="all_reduce")
    p.add_argument("--axis", type=str, default="data")
    p.add_argument("--min-mb", type=float, default=1)
    p.add_argument("--max-mb", type=float, default=1024)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--min-pct-peak", type=float, default=90.0,
                   help="acceptance threshold: best bucket per kind must "
                        "reach this %% of the peak (BASELINE.md); <=0 "
                        "disables the gate")
    p.add_argument("--peak-gbps", type=float, default=None,
                   help="operator figure for the fabric's peak (GB/s of "
                        "bus bandwidth): gates against this instead of "
                        "the card's NVLink query")
    p.add_argument("--verdict-path", type=str, default=None,
                   help="write success/fail here (the reference's "
                        "job_status.txt protocol)")
    p.add_argument("--out", type=str, default=None,
                   help="also write records as clean JSONL to this file")
    p.add_argument("--bench-out", type=str, default=None,
                   help="also write the BENCH_COLLECTIVES.json artifact "
                        "here (headline metric + per-kind per-size rows "
                        "with their fabric labels)")
    p.add_argument("--device", type=str, default=None,
                   choices=("cuda", "cpu"),
                   help="where the collectives run ($TPUDIST_PLATFORM: "
                        "cpu, or cuda/gpu); cuda (the default) fails when "
                        "no card is present")
    # strict: a mistyped flag must error, not silently run a full 1 GB
    # sweep
    args = p.parse_args(argv)
    device = resolve_device(platform_device(args.device))
    ctx = _join(device)
    device = ctx.device
    try:
        if device.type == "cuda" and ctx.process_index == 0:
            limits = _smi("--query-gpu=name,power.limit",
                          "--format=csv,noheader")
            peak = (args.peak_gbps if args.peak_gbps is not None
                    else nvlink_peak_gbps(device.index or 0))
            log0(f"tpudist: sweep on {(limits or device_kind(device)).strip()}"
                 f"; peak {peak} GB/s ("
                 + ("--peak-gbps" if args.peak_gbps is not None
                    else "the card's active NVLink links, per direction")
                 + ")")
        records = run_sweep(tuple(args.kinds.split(",")), args.axis,
                            min_mb=args.min_mb, max_mb=args.max_mb,
                            iters=args.iters, peak_gbps=args.peak_gbps,
                            device=device)
        rank0 = dist.get_rank() == 0
        if args.out and rank0:
            with open(args.out, "w") as f:
                for r in records:
                    f.write(json.dumps(r) + "\n")
        if args.bench_out and rank0:
            write_collectives_artifact(records, args.bench_out,
                                       device_kind(device))
        if args.min_pct_peak <= 0:
            return 0
        g = gate(records, args.min_pct_peak)
        log0(json.dumps({"sweep_gate": g}))
        if g["ok"] is None:
            # nothing could be compared against a peak: absolute GB/s was
            # still measured and recorded; UNGATEABLE (exit 3), never a
            # published success
            if args.verdict_path and rank0:
                verdict.write_final_status(args.verdict_path,
                                           verdict.UNGATEABLE)
            return 3
        if args.verdict_path and rank0:
            verdict.write_final_verdict(args.verdict_path, g["ok"] is True)
        return 0 if g["ok"] is True else 1
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    import sys
    sys.exit(main())
