"""Serve resilience: admission control, deadline shedding, degradation.

The port's own copy of ``tpudist/serve/resilience.py`` (standard library
only; ``tests/test_torch_serve_resilience.py`` pins it to its source).
The host-side control plane that makes overload a bounded,
exactly-accounted event:

* **Admission control** — a bounded request queue (``queue_cap``) with
  a per-request TTFT deadline (``ttft_deadline_s``). Arrivals past the
  cap are shed AT ADMISSION; accepted requests that age past their
  deadline while still queued are EXPIRED before they ever touch a
  slot. Both decisions read ONE clock sample per scheduler boundary,
  so the same seeded arrival schedule sheds the same requests every
  run.
* **Exact accounting** — :class:`ShedLedger` partitions every arrival
  into mutually exclusive buckets and checks the partition exactly::

      arrived  == admitted + shed_admission + expired_queue + rejected
      admitted == completed + evicted + lost

  ``admitted`` means *reached a slot* (prefilled); ``rejected`` is a
  malformed request turned away at validation; ``lost`` an in-flight
  slot a kill took (zero in the port, which has no chaos plane yet).
* **Graceful degradation** — :class:`PressureController`: when rolling
  queue depth or inter-token latency crosses its trip thresholds for
  ``trip_ticks`` consecutive observations, the scheduler downshifts
  ``decode_k`` one rung of the engine's captured ladder (and optionally
  truncates ``max_new`` at admission); pressure clearing below the
  (lower) clear thresholds for ``clear_ticks`` observations restores one
  rung. Dual thresholds + consecutive-tick counters +
  reset-on-transition are the hysteresis that keeps a load step from
  oscillating the ladder.
* **Virtual time** — :class:`VirtualClock`/:class:`VirtualTiming`: the
  request clock is a deterministic function of the schedule (fixed
  per-prefill / per-dispatch costs advance it, the real engine still
  computes every token). Two runs of the same seed produce identical
  SLO summaries.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

# serve_request event vocabulary (the ``event`` field of the flushed
# ``kind=serve_request`` records the scheduler writes)
ADMITTED = "admitted"          # reached a slot (prefill dispatched)
SHED = "shed_admission"        # bounced: queue at cap when it arrived
EXPIRED = "expired_queue"      # aged past its TTFT deadline in queue
REJECTED = "rejected"          # malformed (request_garbage) at admission
DONE = "done"                  # completed its generation budget
EVICTED = "evicted"            # truncated at a full cache page
LOST = "lost"                  # in-flight slot a kill took (classified
#                                by the resumed attempt)

TERMINAL_EVENTS = (SHED, EXPIRED, REJECTED, DONE, EVICTED, LOST)

# The two stages of a request's events: every arrival gets EXACTLY ONE
# admission-stage event; ADMITTED requests get EXACTLY ONE outcome-stage
# event; the other admission verdicts ARE the terminal.
ADMISSION_EVENTS = (ADMITTED, SHED, EXPIRED, REJECTED)
OUTCOME_EVENTS = (DONE, EVICTED, LOST)


@dataclass
class ShedLedger:
    """Mutually-exclusive outcome buckets for every arrival, checked
    exactly — a request that is double-counted or dropped on the floor
    flips ``exact`` to False."""

    arrived: int = 0
    admitted: int = 0           # reached a slot
    shed_admission: int = 0
    expired_queue: int = 0
    rejected: int = 0
    completed: int = 0          # finished: full budget (why=done)
    evicted: int = 0            # finished: truncated at a full page
    lost: int = 0               # in-flight at a kill (resumed attempt)

    def admission_exact(self) -> bool:
        return self.arrived == (self.admitted + self.shed_admission
                                + self.expired_queue + self.rejected)

    def outcome_exact(self) -> bool:
        return self.admitted == self.completed + self.evicted + self.lost

    @property
    def exact(self) -> bool:
        return self.admission_exact() and self.outcome_exact()

    def shed_total(self) -> int:
        """Arrivals turned away without service."""
        return self.shed_admission + self.expired_queue + self.rejected

    def shed_fraction(self) -> Optional[float]:
        """Shed share of all arrivals; None before the first arrival
        (nothing measured is ungateable, not a clean 0.0)."""
        if self.arrived <= 0:
            return None
        return self.shed_total() / self.arrived

    def as_dict(self) -> Dict[str, Any]:
        return {
            "arrived": self.arrived, "admitted": self.admitted,
            "shed_at_admission": self.shed_admission,
            "expired_in_queue": self.expired_queue,
            "rejected": self.rejected, "completed": self.completed,
            "evicted": self.evicted, "lost": self.lost,
            "shed_total": self.shed_total(),
            "shed_fraction": self.shed_fraction(),
            "admission_exact": self.admission_exact(),
            "outcome_exact": self.outcome_exact(),
        }


@dataclass(frozen=True)
class ResilienceConfig:
    """The admission/degradation knobs one serve run applies.

    Zero values mean OFF and reproduce the open-loop scheduler exactly
    (unbounded queue, no deadlines, fixed decode_k) until an operator
    opts in with ``--queue-cap``/``--ttft-deadline-ms``/``--adapt``.
    """

    queue_cap: int = 0              # 0 = unbounded
    ttft_deadline_s: float = 0.0    # 0 = no deadline
    adapt: bool = False             # pressure-driven decode_k downshift
    max_new_cap: int = 0            # adapted admission truncation (0=off)
    validate: bool = False          # reject malformed requests
    # pressure thresholds (adapt=True): rolling queue depth and mean
    # per-token latency trip/clear levels, in the controller's units
    depth_high: float = 8.0
    depth_low: float = 2.0
    itl_high_s: float = 0.0         # 0 = depth-only pressure
    itl_low_s: float = 0.0
    trip_ticks: int = 2
    clear_ticks: int = 4
    window: int = 8

    @property
    def enabled(self) -> bool:
        return bool(self.queue_cap or self.ttft_deadline_s
                    or self.adapt or self.validate)


def default_ladder(decode_k: int, levels: int = 3) -> Tuple[int, ...]:
    """The degradation ladder for ``decode_k``: each rung halves the
    superstep (shorter dispatches drain the queue sooner and cut the
    per-token amortised stall under pressure), floored at 1 and
    deduplicated — ``(8, 4, 2)``, ``(2, 1)``, ``(1,)``."""
    out: List[int] = []
    k = max(int(decode_k), 1)
    for _ in range(max(levels, 1)):
        if not out or out[-1] != k:
            out.append(k)
        if k == 1:
            break
        k = max(1, (k + 1) // 2)
    return tuple(out)


class PressureController:
    """Hysteretic level controller over (queue depth, inter-token
    latency) observations.

    ``observe()`` is called on the scheduler's SLO tick cadence; it
    returns a ``(from_level, to_level, reason)`` transition exactly
    when the ladder moves, else None. Level 0 is full service; higher
    levels are deeper degradation (the scheduler maps them onto the
    engine's decode_k ladder and the admission-time ``max_new`` cap).

    Hysteresis, spelled out: a downshift needs ``trip_ticks``
    CONSECUTIVE observations past the high thresholds; an upshift
    needs ``clear_ticks`` consecutive observations below the (strictly
    lower) low thresholds; any transition resets both counters. A load
    step that parks pressure between the two thresholds therefore
    holds the current level forever instead of oscillating.
    """

    def __init__(self, cfg: ResilienceConfig, *, max_level: int):
        self.cfg = cfg
        self.max_level = max(int(max_level), 0)
        self.level = 0
        self._hot = 0
        self._cool = 0
        self._depths: List[float] = []
        self.transitions: List[Dict[str, Any]] = []

    def _rolling_depth(self, depth: float) -> float:
        self._depths.append(float(depth))
        if len(self._depths) > max(self.cfg.window, 1):
            self._depths.pop(0)
        return sum(self._depths) / len(self._depths)

    def observe(self, depth: float, itl_s: Optional[float] = None
                ) -> Optional[Tuple[int, int, str]]:
        mean_depth = self._rolling_depth(depth)
        itl = itl_s if (itl_s is not None and self.cfg.itl_high_s > 0) \
            else None
        hot = mean_depth > self.cfg.depth_high \
            or (itl is not None and itl > self.cfg.itl_high_s)
        cool = mean_depth <= self.cfg.depth_low \
            and (itl is None or itl <= (self.cfg.itl_low_s
                                        or self.cfg.itl_high_s))
        self._hot = self._hot + 1 if hot else 0
        self._cool = self._cool + 1 if cool else 0
        if hot and self.level < self.max_level \
                and self._hot >= max(self.cfg.trip_ticks, 1):
            return self._move(self.level + 1,
                              f"pressure: rolling depth "
                              f"{mean_depth:.2f} / itl {itl}")
        if cool and self.level > 0 \
                and self._cool >= max(self.cfg.clear_ticks, 1):
            return self._move(self.level - 1,
                              f"cleared: rolling depth "
                              f"{mean_depth:.2f} / itl {itl}")
        return None

    def _move(self, to_level: int, reason: str
              ) -> Tuple[int, int, str]:
        frm, self.level = self.level, to_level
        self._hot = self._cool = 0       # reset: the hysteresis anchor
        t = (frm, to_level, reason)
        self.transitions.append({"from_level": frm, "to_level": to_level,
                                 "reason": reason})
        return t


class VirtualClock:
    """A deterministic request clock the scheduler advances by scripted
    costs instead of reading wall time. Callable (drop-in for the
    scheduler's ``clock=``), monotone, and shared by every decision in
    the run — the whole serve summary becomes a pure function of
    (seed, schedule, costs)."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += max(float(dt), 0.0)
        return self.t

    def wait_until(self, t: float) -> float:
        self.t = max(self.t, float(t))
        return self.t


@dataclass
class VirtualTiming:
    """Virtual-time mode for
    :func:`tpudist_torch.serve.scheduler.run_serve`: each prefill
    advances the clock ``prefill_s``, each decode dispatch ``decode_s``.
    The engine still runs for real — only the latency accounting is
    scripted, which is what makes the shed decisions and percentiles
    bitwise reproducible."""

    clock: VirtualClock = field(default_factory=VirtualClock)
    prefill_s: float = 0.002
    decode_s: float = 0.004
