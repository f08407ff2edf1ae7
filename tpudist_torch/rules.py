"""The gate thresholds the port grades against, copied from
``tpudist/rules.py``.

The port keeps its own copy of the rules its lanes grade against: the
train lane's per-host straggler factor, staging overlap, stall window
and trace drop share, the serving lane's p99 TTFT, p99 inter-token
latency, tokens/s/chip and shed fraction of arrivals, and the HBM
ledger's headroom floor, with
the same env overrides, read at call time; ``tests/test_torch_serve.py``
holds this copy equal to the JAX package's table so the two cannot
drift. Standard library only.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

# A host whose mean step time exceeds the pod median by this factor is a
# straggler (verdict.straggler_status over obs.hoststats' kind=hosts).
STRAGGLER_FACTOR = 1.25     # verdict.straggler_status
# Minimum steady-state staging overlap fraction (metrics.StagingStats)
# before a streamed run is FLAGGED: below this, host->device transfer is
# not hiding behind compute and the pod is silently input-bound.
# Advisory, not exit-code-bearing.
STAGING_OVERLAP_MIN = 0.5   # verdict.staging_status
# No step progress for this long and the watchdog dumps a flight record
# (obs.heartbeat); the train CLI's --stall-timeout-s default.
STALL_TIMEOUT_S = 300.0     # obs.heartbeat watchdog
# A traced run whose ring buffers overwrote more than this fraction of
# its spans has a timeline with holes (verdict.trace_status).
TRACE_DROP_MAX = 0.5        # verdict.trace_status
# Serving SLOs: latency-percentile bounds plus a throughput floor. The
# defaults are loose enough for a CPU run of a tiny model; deployments
# tighten them per model via the env overrides.
TTFT_P99_MAX = 2.0          # serve: p99 time-to-first-token (seconds)
ITL_P99_MAX = 1.0           # serve: p99 inter-token latency (seconds)
TOKENS_PER_CHIP_MIN = 1.0   # serve: decode throughput floor (tok/s/chip)
# Serve admission shedding (tpudist_torch.serve.resilience): the fraction
# of arrivals turned away (shed at admission + expired in queue +
# rejected). Admission control keeps the ADMITTED percentiles honest
# under overload, so the shed share itself is gated, or a pod could pass
# its latency SLOs by serving almost nobody.
SERVE_SHED_MAX = 0.6        # serve: max shed fraction of arrivals
# The HBM ledger's free fraction floor (obs.memledger): 0.0, so only an
# over-committed device (negative headroom) fails unless a deployment
# opts in.
HBM_HEADROOM_MIN = 0.0      # obs.memledger.hbm_headroom_status


@dataclass(frozen=True)
class Threshold:
    """One gate: its env knob, default, and breach direction. ``sense``
    ``"max"`` breaches when ``value > threshold``, ``"min"`` when
    ``value < threshold``."""

    name: str
    env: str
    default: float
    sense: str              # "max" | "min"
    alert: bool
    observable: str
    description: str


THRESHOLDS: Tuple[Threshold, ...] = (
    Threshold(
        name="straggler", env="TPUDIST_STRAGGLER_FACTOR",
        default=STRAGGLER_FACTOR, sense="max", alert=True,
        observable="worst host mean step time / pod median",
        description="a host slower than the pod median by this factor "
                    "drags every collective to its pace"),
    Threshold(
        name="staging", env="TPUDIST_STAGING_OVERLAP_MIN",
        default=STAGING_OVERLAP_MIN, sense="min", alert=True,
        observable="fraction of steady-state wall NOT exposed to "
                   "staging waits",
        description="below this, host->device transfer is not hiding "
                    "behind compute and the pod is input-bound"),
    Threshold(
        name="stall", env="TPUDIST_STALL_TIMEOUT_S",
        default=STALL_TIMEOUT_S, sense="max", alert=True,
        observable="seconds since the last step-progress signal",
        description="no step progress for this long means a wedged "
                    "host (the watchdog dumps, the alert fires)"),
    Threshold(
        name="trace_drop", env="TPUDIST_TRACE_DROP_MAX",
        default=TRACE_DROP_MAX, sense="max", alert=False,
        observable="fraction of recorded spans the ring overwrote",
        description="a trace with more holes than this under-counts "
                    "exactly the longest runs"),
    Threshold(
        name="ttft", env="TPUDIST_TTFT_P99_MAX",
        default=TTFT_P99_MAX, sense="max", alert=True,
        observable="p99 time-to-first-token in seconds (queue wait + "
                   "prefill)",
        description="users feel the first token; past this the serving "
                    "pod is admission- or prefill-bound"),
    Threshold(
        name="itl", env="TPUDIST_ITL_P99_MAX",
        default=ITL_P99_MAX, sense="max", alert=True,
        observable="p99 inter-token latency in seconds (decode "
                   "superstep wall / steps)",
        description="token streaming stutters past this; the decode "
                    "program or batch shape is mis-sized"),
    Threshold(
        name="tokens_per_chip", env="TPUDIST_TOKENS_PER_CHIP_MIN",
        default=TOKENS_PER_CHIP_MIN, sense="min", alert=True,
        observable="generated tokens per second per chip",
        description="below this floor the pod serves fewer users than "
                    "its chip count should carry"),
    Threshold(
        name="serve_shed", env="TPUDIST_SERVE_SHED_MAX",
        default=SERVE_SHED_MAX, sense="max", alert=True,
        observable="fraction of arrived requests shed at admission, "
                   "expired in queue, or rejected as malformed",
        description="past this the admission controller is the only "
                    "thing meeting the latency SLO — the pod is "
                    "under-provisioned for its offered load"),
    Threshold(
        name="hbm_headroom", env="TPUDIST_HBM_HEADROOM_MIN",
        default=HBM_HEADROOM_MIN, sense="min", alert=True,
        observable="unattributed free fraction of device HBM after the "
                   "ledger's buckets (params, opt state, slabs, KV "
                   "pool, program temp) are carved out",
        description="below the opted-in floor the pod is one "
                    "allocation spike from RESOURCE_EXHAUSTED — the "
                    "ledger names which bucket to shrink; off by "
                    "default (floor 0.0) since needed headroom is a "
                    "capacity-planning choice"),
)

_BY_NAME = {t.name: t for t in THRESHOLDS}


def get(name: str) -> Threshold:
    """The rule named ``name``; KeyError on unknown names."""
    return _BY_NAME[name]


def resolve(name: str) -> float:
    """The effective threshold: env override (read NOW) else default. A
    malformed env value reads as the default."""
    rule = get(name)
    raw = os.environ.get(rule.env)
    if raw:
        try:
            return float(raw)
        except ValueError:
            pass
    return rule.default


def breached(name: str, value: Optional[float],
             threshold: Optional[float] = None) -> bool:
    """Whether ``value`` breaches the rule; ``None`` (no measurement)
    never breaches."""
    if value is None:
        return False
    if threshold is None:
        threshold = resolve(name)
    if get(name).sense == "max":
        return value > threshold
    return value < threshold
