"""HBM memory ledger: every device byte attributed to a named bucket.

The ledger-building half of ``tpudist/obs/memledger.py``, copied for the
port: the train and serve CLIs partition one card's memory EXACTLY
into::

    params / opt_state / slabs / kv_pool / program_temp
    / headroom / residue        (sum == the card's memory, by construction)

and write it as a ``kind=memledger`` record and ``<save-dir>/memledger
.json``. The forensics CLI (``python -m tpudist.obs.memledger``), the
drill and the Prometheus text stay in the JAX package's jax-free tool,
which reads the port's ``memledger.json`` unchanged.

``program_temp`` is the MAX across programs of their scratch (programs
never run at once on one card). The JAX package reads it from the
compiled program's ``memory_analysis``; the port's programs report
``{"temp_bytes": ...}``: a captured CUDA graph the pool it holds, the
eager per-step path the peak allocated over one step beyond what was
resident before it, and nothing (``{}``) on the CPU, where the ledger
then notes that ``program_temp`` under-counts. ``residue`` reconciles
the derived footprint against the sampler's measured watermark when it
comes from the card's counters, and marks the ledger inexact past
:data:`TOLERANCE`.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

from tpudist_torch import rules as rules_lib

MEMLEDGER_SCHEMA_VERSION = 1
LEDGER_NAME = "memledger.json"

# Partition exactness: the pinned tolerance (fraction of device HBM)
# past which the watermark-reconciliation residue flags the ledger
# inexact — the same ±1% discipline as devtime and goodput.
TOLERANCE = 0.01

SUCCESS = "success"     # the verdict vocabulary (tpudist_torch.verdict),
FAIL = "fail"           # kept here as in the JAX package's module
UNGATEABLE = "ungateable"

# The headroom floor lives in tpudist_torch.rules with every other gate
# (TPUDIST_HBM_HEADROOM_MIN, resolved at call time); the alias is this
# module's documented surface, like goodput's.
HBM_HEADROOM_MIN = rules_lib.HBM_HEADROOM_MIN

# Bucket names, display order. The first five are attributed; headroom
# and residue close the partition (sum over BUCKETS == device HBM).
BUCKETS = ("params", "opt_state", "slabs", "kv_pool", "program_temp",
           "headroom", "residue")
ATTRIBUTED = ("params", "opt_state", "slabs", "kv_pool", "program_temp")

# Forensics: the knob that shrinks each growable bucket — what the CLI
# prints after naming the guilty bucket, so an OOM post-mortem ends
# with an action, not just a diagnosis.
KNOBS = {
    "params": "shard the model further (--fsdp-shard / --tensor-"
              "parallel) or pick a smaller --model",
    "opt_state": "optimizer state scales with params: shard further "
                 "(--fsdp-shard) or reduce the model",
    "slabs": "--staging-budget-mb (env TPUDIST_STAGING_BUDGET_MB): a "
             "smaller budget streams more, smaller slabs",
    "kv_pool": "--kv-pages / --kv-page-tokens (or fewer --slots): "
               "shrink the paged KV pool and page table",
    "program_temp": "--steps-per-dispatch (train superstep scratch) / "
                    "the decode_k ladder and --speculate-k (serve "
                    "scratch)",
}


def hbm_headroom_status(fraction: Optional[float],
                        min_fraction: Optional[float] = None) -> str:
    """Three-valued headroom verdict: UNGATEABLE with nothing derived
    (a run with no ledger must not read as a headroom pass), else
    SUCCESS/FAIL by whether the free fraction clears
    ``TPUDIST_HBM_HEADROOM_MIN``. The default floor is 0.0, so only an
    over-committed device (negative headroom) fails without opt-in —
    how much slack a pod NEEDS is a capacity-planning choice."""
    if fraction is None:
        return UNGATEABLE
    if min_fraction is None:
        min_fraction = rules_lib.resolve("hbm_headroom")
    return SUCCESS if fraction >= min_fraction else FAIL


# ------------------------------------------------------------- the ledger


def program_temp_bytes(programs: Optional[Dict[str, Dict[str, Any]]]
                       ) -> Tuple[int, bool]:
    """(peak scratch bytes, complete) across the pinned programs.

    Programs never run concurrently on one device (the two-compiled-
    programs discipline serializes them), so the resident scratch peak
    is the MAX of each program's temp + generated-code bytes, not the
    sum. ``complete`` is False when any program reported no analysis
    (CPU builds may not implement memory planning) — the bucket then
    under-counts and the ledger records the gap as a note, not a lie.
    """
    peak = 0
    complete = True
    for mem in (programs or {}).values():
        if not mem:
            complete = False
            continue
        peak = max(peak, int(mem.get("temp_bytes") or 0)
                   + int(mem.get("generated_code_bytes") or 0))
    return peak, complete


def build_ledger(*, total_hbm_bytes: float,
                 params_bytes: float = 0,
                 opt_state_bytes: float = 0,
                 slab_bytes: float = 0,
                 kv_pool_bytes: float = 0,
                 programs: Optional[Dict[str, Dict[str, Any]]] = None,
                 watermark_bytes: Optional[float] = None,
                 watermark_source: Optional[str] = None,
                 mode: str = "train",
                 run_id: Optional[str] = None,
                 tolerance: float = TOLERANCE) -> Dict[str, Any]:
    """Partition one device's HBM into the memory buckets.

    All byte inputs are PER-DEVICE numbers (the engine's
    ``state_bytes_per_device`` convention). The sum of all buckets
    equals ``total_hbm_bytes`` EXACTLY by construction: ``residue`` is
    the watermark-vs-derived reconciliation (zero when the watermark is
    not a real device measurement — RSS on the CPU mesh says nothing
    about a device partition) and ``headroom`` is the remainder.
    ``exact`` certifies the reconciliation stayed inside the pinned
    tolerance and nothing over-committed the device.
    """
    total = int(total_hbm_bytes)
    if total <= 0:
        raise ValueError(f"total_hbm_bytes must be > 0, got "
                         f"{total_hbm_bytes!r} — the device HBM size is "
                         f"the partition's spine (TPUDIST_HBM_BYTES "
                         f"pins it on backends that report none)")
    programs = dict(programs or {})
    temp, complete = program_temp_bytes(programs)
    buckets: Dict[str, int] = {
        "params": int(params_bytes),
        "opt_state": int(opt_state_bytes),
        "slabs": int(slab_bytes),
        "kv_pool": int(kv_pool_bytes),
        "program_temp": temp,
    }
    derived = sum(buckets.values())

    exact = True
    problems: List[str] = []
    notes: List[str] = []
    for k, v in buckets.items():
        if v < 0:
            exact = False
            problems.append(f"bucket {k} is negative ({v} bytes) — a "
                            f"byte count can never be")
            buckets[k] = 0
    derived = sum(buckets.values())

    # residue: what the measured watermark saw that the model did not
    # attribute (allocator overhead, fragmentation, untracked buffers)
    # — only a REAL device measurement reconciles; an RSS fallback
    # watermark measures the host, not the device partition
    reconciled = watermark_source == "memory_stats" \
        and watermark_bytes is not None
    residue = int(watermark_bytes) - derived if reconciled else 0
    if reconciled and abs(residue) > tolerance * total:
        exact = False
        if residue > 0:
            problems.append(
                f"measured watermark exceeds the derived footprint by "
                f"{residue} bytes ({residue / total:.1%} of HBM) — "
                f"unattributed allocations")
        else:
            problems.append(
                f"derived footprint exceeds the measured watermark by "
                f"{-residue} bytes ({-residue / total:.1%} of HBM) — "
                f"double counting or never-materialized buffers")
    buckets["residue"] = residue
    buckets["headroom"] = total - derived - residue
    if buckets["headroom"] < 0:
        # over-committed: not an accounting error (the partition is
        # still exact — headroom honestly negative), but the pod is one
        # allocation spike from RESOURCE_EXHAUSTED; the headroom rule's
        # default 0.0 floor breaches on exactly this
        notes.append(f"device over-committed by {-buckets['headroom']} "
                     f"bytes — headroom is negative")
    if not complete:
        missing = sorted(k for k, v in programs.items() if not v)
        notes.append("no memory_analysis for program(s) "
                     f"{', '.join(missing)} — program_temp under-counts "
                     f"(backend does not report memory planning)")

    frac = round(buckets["headroom"] / total, 6)
    return {
        "schema": MEMLEDGER_SCHEMA_VERSION,
        "mode": mode,
        "run_id": run_id,
        "total_hbm_bytes": total,
        "buckets": {k: int(buckets[k]) for k in BUCKETS},
        "programs": {k: dict(v or {}) for k, v in programs.items()},
        "program_temp_complete": complete,
        "watermark_bytes": (int(watermark_bytes)
                            if watermark_bytes is not None else None),
        "watermark_source": watermark_source,
        "headroom_fraction": frac,
        "headroom_status": hbm_headroom_status(frac),
        "headroom_min": rules_lib.resolve("hbm_headroom"),
        "exact": exact,
        "tolerance": tolerance,
        "problems": problems,
        "notes": notes,
    }


def ledger_record(ledger: Dict[str, Any]) -> Dict[str, Any]:
    """The ledger as the flat ``kind=memledger`` metrics record: one
    ``<bucket>_bytes`` field per bucket plus the headroom grade — the
    shape the live aggregator ingests and the report CLI reads back."""
    b = ledger.get("buckets") or {}
    rec: Dict[str, Any] = {
        "total_hbm_bytes": ledger.get("total_hbm_bytes"),
        "headroom_fraction": ledger.get("headroom_fraction"),
        "hbm_headroom_status": ledger.get("headroom_status"),
        "watermark_bytes": ledger.get("watermark_bytes"),
        "watermark_source": ledger.get("watermark_source"),
        "program_temp_complete": ledger.get("program_temp_complete"),
        "exact": ledger.get("exact"),
        "mode": ledger.get("mode"),
    }
    for k in BUCKETS:
        rec[f"{k}_bytes"] = b.get(k)
    return rec


def _atomic_write(path: str, payload: str) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        f.write(payload)
    os.replace(tmp, path)
