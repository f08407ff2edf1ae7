"""Latency accounting + SLO verdicts for the serving engine.

Copy of the serve gates of ``tpudist/serve/slo.py`` (standard library
only). The observables:

* **TTFT** — time-to-first-token per request: arrival → the prefill
  that produced its first token (queue wait included).
* **ITL** — inter-token latency: decode tokens come k per dispatch, so
  each token in a dispatch is attributed ``dispatch_wall / k``.
* **tokens/s/chip** — generated tokens (first tokens included) over the
  serving wall clock, per chip.
* **shed fraction** — the resilience plane's admission gate: (shed +
  expired + rejected) / arrived, graded against
  ``TPUDIST_SERVE_SHED_MAX``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from tpudist_torch import rules as rules_lib

SUCCESS = "success"
FAIL = "fail"
UNGATEABLE = "ungateable"

# The serve gates, in grading order; each is (rule name, summary key).
SERVE_RULES = (("ttft", "ttft_p99_s"),
               ("itl", "itl_p99_s"),
               ("tokens_per_chip", "tokens_per_sec_per_chip"),
               ("serve_shed", "shed_fraction"))

# Fixed histogram buckets (upper bounds, seconds): part of the metric
# contract, so two runs' histograms are comparable edge for edge.
TTFT_BUCKETS_S = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0)
ITL_BUCKETS_S = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0)


def hist_block(samples: List[float],
               buckets: tuple) -> Dict[str, Any]:
    """A self-describing histogram record for one latency family:
    per-bucket (NOT cumulative) counts with one overflow bin, plus
    sum/count, with the bucket edges carried along."""
    counts = [0] * (len(buckets) + 1)
    total = 0.0
    for s in samples:
        total += s
        for j, ub in enumerate(buckets):
            if s <= ub:
                counts[j] += 1
                break
        else:
            counts[-1] += 1
    return {"buckets": [float(b) for b in buckets], "counts": counts,
            "sum": round(total, 6), "count": len(samples)}


def percentile(xs: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile (q in [0, 100]); None on no samples.
    Deterministic and interpolation-free."""
    if not xs:
        return None
    s = sorted(xs)
    rank = max(1, math.ceil(q / 100.0 * len(s)))
    return s[min(rank, len(s)) - 1]


@dataclass
class LatencyStats:
    """Per-run latency sample sink; all samples in seconds."""

    ttft_s: List[float] = field(default_factory=list)
    itl_s: List[float] = field(default_factory=list)
    e2e_s: List[float] = field(default_factory=list)

    def note_ttft(self, s: float) -> None:
        self.ttft_s.append(float(s))

    def note_itl(self, s: float, n: int = 1) -> None:
        self.itl_s.extend([float(s)] * max(int(n), 0))

    def note_e2e(self, s: float) -> None:
        self.e2e_s.append(float(s))

    def summary(self) -> Dict[str, Any]:
        return {
            "ttft_p50_s": percentile(self.ttft_s, 50),
            "ttft_p99_s": percentile(self.ttft_s, 99),
            "itl_p50_s": percentile(self.itl_s, 50),
            "itl_p99_s": percentile(self.itl_s, 99),
            "e2e_p50_s": percentile(self.e2e_s, 50),
            "e2e_p99_s": percentile(self.e2e_s, 99),
        }

    def ttft_hist(self) -> Dict[str, Any]:
        return hist_block(self.ttft_s, TTFT_BUCKETS_S)

    def itl_hist(self) -> Dict[str, Any]:
        return hist_block(self.itl_s, ITL_BUCKETS_S)


def rule_status(rule: str, value: Optional[float]) -> str:
    """Three-valued per-gate verdict: no measurement is UNGATEABLE, else
    SUCCESS/FAIL by the rules table (env overrides read at call time)."""
    if value is None:
        return UNGATEABLE
    return FAIL if rules_lib.breached(rule, value) else SUCCESS


def grade(ttft_p99_s: Optional[float], itl_p99_s: Optional[float],
          tokens_per_sec_per_chip: Optional[float],
          shed_fraction: Optional[float] = None) -> Dict[str, str]:
    """Every serve gate + the fold: overall ``status`` is FAIL if any
    gate fails, UNGATEABLE if nothing was measurable, else SUCCESS.
    ``shed_fraction`` None (an empty run) grades the shed gate
    UNGATEABLE."""
    vals = {"ttft_p99_s": ttft_p99_s, "itl_p99_s": itl_p99_s,
            "tokens_per_sec_per_chip": tokens_per_sec_per_chip,
            "shed_fraction": shed_fraction}
    out = {f"{rule}_status": rule_status(rule, vals[key])
           for rule, key in SERVE_RULES}
    statuses = list(out.values())
    if FAIL in statuses:
        overall = FAIL
    elif all(s == UNGATEABLE for s in statuses):
        overall = UNGATEABLE
    else:
        overall = SUCCESS
    out["status"] = overall
    return out


def serve_status(ttft_p99_s: Optional[float], itl_p99_s: Optional[float],
                 tokens_per_sec_per_chip: Optional[float],
                 shed_fraction: Optional[float] = None) -> str:
    """The folded serving verdict alone."""
    return grade(ttft_p99_s, itl_p99_s, tokens_per_sec_per_chip,
                 shed_fraction)["status"]


def slo_block(summary: Dict[str, Any]) -> Dict[str, Any]:
    """The bench artifact's ``slo`` block from a ``run_serve`` summary;
    thresholds resolve through the rules table at call time."""
    return {
        "status": summary["status"],
        **{f"{rule}_status": summary[f"{rule}_status"]
           for rule, _ in SERVE_RULES},
        "thresholds": {rule: rules_lib.resolve(rule)
                       for rule, _ in SERVE_RULES},
    }
