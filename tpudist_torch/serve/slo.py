"""Latency accounting + SLO verdicts for the serving engine.

Copy of the serve gates of ``tpudist/serve/slo.py`` (standard library
only). The observables:

* **TTFT** — time-to-first-token per request: arrival → the prefill
  that produced its first token (queue wait included).
* **ITL** — inter-token latency: decode tokens come k per dispatch, so
  each token in a dispatch is attributed ``dispatch_wall / k``.
* **tokens/s/chip** — generated tokens (first tokens included) over the
  serving wall clock, per chip.
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
               ("tokens_per_chip", "tokens_per_sec_per_chip"))


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


def rule_status(rule: str, value: Optional[float]) -> str:
    """Three-valued per-gate verdict: no measurement is UNGATEABLE, else
    SUCCESS/FAIL by the rules table (env overrides read at call time)."""
    if value is None:
        return UNGATEABLE
    return FAIL if rules_lib.breached(rule, value) else SUCCESS


def grade(ttft_p99_s: Optional[float], itl_p99_s: Optional[float],
          tokens_per_sec_per_chip: Optional[float]) -> Dict[str, str]:
    """Every serve gate + the fold: overall ``status`` is FAIL if any
    gate fails, UNGATEABLE if nothing was measurable, else SUCCESS."""
    vals = {"ttft_p99_s": ttft_p99_s, "itl_p99_s": itl_p99_s,
            "tokens_per_sec_per_chip": tokens_per_sec_per_chip}
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
                 tokens_per_sec_per_chip: Optional[float]) -> str:
    """The folded serving verdict alone."""
    return grade(ttft_p99_s, itl_p99_s, tokens_per_sec_per_chip)["status"]


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
