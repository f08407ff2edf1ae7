"""The gate thresholds the port grades against, copied from
``tpudist/rules.py``.

The port keeps its own copy of the rules its lanes grade against: the
train lane's staging overlap, and the serving lane's p99 TTFT, p99
inter-token latency, tokens/s/chip and shed fraction of arrivals, with
the same env overrides, read at call time; ``tests/test_torch_serve.py``
holds this copy equal to the JAX package's table so the two cannot
drift. Standard library only.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

# Minimum steady-state staging overlap fraction (metrics.StagingStats)
# before a streamed run is FLAGGED: below this, host->device transfer is
# not hiding behind compute and the pod is silently input-bound.
# Advisory, not exit-code-bearing.
STAGING_OVERLAP_MIN = 0.5   # verdict.staging_status
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
        name="staging", env="TPUDIST_STAGING_OVERLAP_MIN",
        default=STAGING_OVERLAP_MIN, sense="min", alert=True,
        observable="fraction of steady-state wall NOT exposed to "
                   "staging waits",
        description="below this, host->device transfer is not hiding "
                    "behind compute and the pod is input-bound"),
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
