"""Deterministic coordinate-descent search over the dispatch/staging/remat
knob space: a copy of ``tpudist/tune/search.py`` (pure Python), with the
port's ``SUPERSTEP_CAP`` and ``TrainConfig``.

The port trains on the data x fsdp mesh, its gradient reduced after the
backward, and refuses the overlap plane's flags (``--grad-overlap``,
``--cross-slice``, ``--pipeline-interleave``: ROADMAP Queue A item 8b),
so :func:`build_space` leaves their three axes empty and
:meth:`Candidate.apply` folds only the four knobs the port carries.
:class:`Candidate` keeps every field, so cache records have the JAX
package's keys.

The search is MEASUREMENT-DRIVEN but measurement-agnostic: it never
touches a device itself. Callers hand it a ``measure(candidate) ->
ProbeResult-like`` function (``tpudist_torch.tune.probe`` for real
on-device trials; the tests inject scripted fake timers) and
the search only reads three fields off the result: ``feasible``,
``steps_per_sec``, and ``counted`` (False = the measurement was served
from a memo and must not consume trial budget).

Guarantees the rest of the system leans on:

  * **Deterministic.** Axis order, candidate order within an axis, and
    every tie-break are fixed — on a multi-host pod every process walks
    the identical trial sequence, so the probes' collectives line up
    (the committed point is still broadcast from the coordinator,
    tune.autotune, because *measured times* differ per host).
  * **Bounded.** At most ``trial_budget`` counted measurements; the
    budget running out mid-axis commits the incumbent, it does not
    raise.
  * **Never regresses the seed heuristic.** The start point is measured
    first and the final commit is taken against it: if every explored
    point is slower (or infeasible), the answer IS the start point.
  * **Prunes, never crashes.** An infeasible result (HBM OOM, a staging
    budget that cannot double-buffer, a measure() that raises) removes
    that point from consideration; on ordered axes (k, grad-accum) it
    also stops the ascent — a bigger value of a monotone-memory knob
    cannot become feasible again.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from tpudist_torch.config import SUPERSTEP_CAP, TrainConfig

# Axis walk order: the k axis carries the order-of-magnitude spread
# (the MLP default's steps/s per-step against replayed, PERF.md §6),
# so it is searched first and every later axis rides the committed k.
# The overlap-plane knobs (grad bucket bytes, the cross-slice reduce,
# pipeline virtual stages: empty in the port) sit between the dispatch
# knobs and the math knobs:
# both are pure SCHEDULE coordinates — bitwise-identical loss at every
# value — so they never need the math-axis commit margin, just a
# measured win.
AXES = ("k", "staging_budget_mb", "grad_bucket_mb", "cross_slice",
        "pipeline_interleave", "remat", "grad_accum_steps")

# Axes where the knob monotonically raises memory/recompute pressure:
# an infeasible point stops the ascent instead of probing bigger ones.
ORDERED_AXES = frozenset({"k", "grad_accum_steps"})

# Math-affecting knobs (remat changes the backward schedule, grad-accum
# changes the reduction order): committed only on a MEASURED win past
# max(IMPROVE_MIN, the trials' own repeat spread), never on a tie — a
# tie keeps the trajectory-identical seed value, preserving bitwise
# parity with the untuned run, and the noise floor requirement means a
# loaded host's +-20% jitter cannot smuggle a math change in as a
# "win" (a genuine 30% remat win on quiet hardware still clears it).
MATH_AXES = frozenset({"remat", "grad_accum_steps"})

# Plateau preference: among candidates within this fraction of the axis
# best, commit the SMALLEST (shorter supersteps = tighter log/ckpt
# boundaries at indistinguishable speed). Kept tight so the committed
# point stays well inside the acceptance criterion's 10%-of-best band.
PLATEAU_TOL = 0.02

# A math knob must beat the incumbent by this fraction to be committed.
IMPROVE_MIN = 0.02

# Early stop on regression: once a later point on an ordered axis falls
# this far below the PREVIOUS point, the curve has turned down
# decisively — stop scanning the far side of the plateau.
REGRESS_STOP = 0.10


@dataclasses.dataclass(frozen=True, order=True)
class Candidate:
    """One point in the knob space. ``apply`` folds it into a TrainConfig
    as EXPLICIT settings (tuned values outrank env vars exactly like
    flags do — a tuned commit is a flag the measurement wrote)."""

    k: int = 1
    staging_budget_mb: Optional[float] = None
    remat: bool = False
    grad_accum_steps: int = 1
    # overlap-plane coordinates (None / 0 = leave cfg's setting alone —
    # the axes only enter the space when the run's mesh makes them real)
    grad_bucket_mb: Optional[float] = None
    pipeline_interleave: int = 0
    # cross-slice reduce schedule: a pure SCHEDULE coordinate like the
    # bucket size (parallel.overlap pins bitwise parity across modes),
    # gated to multi-slice DP meshes by build_space
    cross_slice: Optional[str] = None

    def apply(self, cfg: TrainConfig) -> TrainConfig:
        out = dataclasses.replace(
            cfg, steps_per_dispatch=self.k,
            staging_budget_mb=self.staging_budget_mb,
            remat=self.remat, grad_accum_steps=self.grad_accum_steps)
        if self.grad_bucket_mb is not None:
            out = dataclasses.replace(out,
                                      grad_bucket_mb=self.grad_bucket_mb)
        if self.cross_slice is not None:
            out = dataclasses.replace(out, cross_slice=self.cross_slice)
        return out

    def replace(self, **kw) -> "Candidate":
        return dataclasses.replace(self, **kw)

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def k_candidates(cfg: TrainConfig) -> List[int]:
    """The superstep lengths this run may legally dispatch: divisors of
    ``--log-every``/``--ckpt-every-steps`` up to :data:`SUPERSTEP_CAP`
    (the same constraint ``config.resolve_steps_per_dispatch`` enforces),
    thinned to a geometric ladder (each kept value >= 2x the previous)
    so the trial budget buys coverage of the whole curve, with the
    largest legal value always kept — that is where the dispatch-bound
    plateau lives."""
    if cfg.fail_at is not None:
        return [1]   # defined in per-step terms (the port refuses the
        # JAX package's other such mode, --profile-dir)
    valid = []
    for d in range(1, SUPERSTEP_CAP + 1):
        if cfg.log_every > 0 and cfg.log_every % d:
            continue
        if cfg.ckpt_every_steps and cfg.ckpt_every_steps % d:
            continue
        valid.append(d)
    ladder = []
    for d in valid:
        if not ladder or d >= 2 * ladder[-1]:
            ladder.append(d)
    if valid and ladder[-1] != valid[-1]:
        ladder.append(valid[-1])
    return ladder


# Bucket-size ladder for --grad-overlap bucketed, MB: geometric like the
# k ladder, spanning "reduce almost per-leaf" to "one bucket ≈ barrier".
GRAD_BUCKET_LADDER_MB = (1.0, 4.0, 16.0)


def build_space(cfg: TrainConfig, *, batch_ways: int = 1,
                heuristic_budget_mb: Optional[float] = None,
                dp_overlap: bool = False,
                n_slices: int = 1) -> Dict[str, List[Any]]:
    """The bounded search space for this run's config.

    * ``k``: the legal divisor ladder (:func:`k_candidates`).
    * ``staging_budget_mb``: the heuristic estimate, unbounded (the
      full-epoch fast path), and 2x the estimate — only when a heuristic
      estimate exists at all.
    * ``grad_bucket_mb``: the geometric bucket ladder, led by the run's
      configured value — only when ``dp_overlap`` says the run is the
      replicated data-parallel step (world > 1, no sharded mesh) AND
      ``--grad-overlap bucketed`` is on (a bucket size is meaningless
      otherwise).
    * ``cross_slice``: both reduce schedules, led by the run's resolved
      mode — only on a multi-slice data-parallel run (``n_slices > 1``
      with ``dp_overlap``): a one-slice hierarchical downgrades to flat
      anyway, so the coordinate would probe the identical program twice.
    * ``pipeline_interleave``: empty (the JAX package opens it on a
      pipeline mesh; the port refuses the pipe axis, ROADMAP Queue A
      item 8b).
    * ``remat``: both settings for layered models; the mlp has no layers
      to checkpoint.
    * ``grad_accum_steps``: {1, 2, 4} filtered to divide the per-shard
      batch (the same divisibility train.run enforces).
    """
    from tpudist_torch.config import (resolve_cross_slice,
                                      resolve_grad_overlap)
    budgets: List[Optional[float]] = [heuristic_budget_mb]
    if heuristic_budget_mb is not None:
        budgets += [None, round(heuristic_budget_mb * 2, 4)]
    layered = cfg.model.name in ("transformer", "moe")
    gas = [g for g in (1, 2, 4)
           if cfg.batch_size % (max(batch_ways, 1) * g) == 0]
    if cfg.grad_accum_steps not in gas:
        gas = sorted(set(gas) | {cfg.grad_accum_steps})
    buckets: List[Optional[float]] = []
    mode, bucket_bytes = resolve_grad_overlap(cfg)
    if dp_overlap and mode == "bucketed":
        lead = round(bucket_bytes / 2**20, 4)
        buckets = [lead] + [b for b in GRAD_BUCKET_LADDER_MB if b != lead]
    cross: List[Optional[str]] = []
    if dp_overlap and n_slices > 1:
        lead = resolve_cross_slice(cfg)
        cross = [lead] + [m for m in ("flat", "hierarchical")
                          if m != lead]
    return {
        "k": k_candidates(cfg),
        "staging_budget_mb": budgets,
        "grad_bucket_mb": buckets,
        "cross_slice": cross,
        "pipeline_interleave": [],
        "remat": ([cfg.remat, not cfg.remat] if layered else [cfg.remat]),
        "grad_accum_steps": gas,
    }


@dataclasses.dataclass
class SearchOutcome:
    best: Candidate
    best_sps: float
    baseline: Candidate
    baseline_sps: float
    trials: int                 # counted (device-touching) measurements
    pruned: int                 # infeasible points removed from play
    exhausted: bool             # trial budget ran out mid-search
    log: List[Tuple[Candidate, Any]] = dataclasses.field(
        default_factory=list)


def _sps(res: Any) -> float:
    return float(getattr(res, "steps_per_sec", 0.0) or 0.0)


def _spread(res: Any) -> float:
    """A trial's own repeat spread — its measured noise floor."""
    return float(getattr(res, "spread", 0.0) or 0.0)


def coordinate_search(start: Candidate, axes: Dict[str, Sequence[Any]],
                      measure: Callable[[Candidate], Any], *,
                      trial_budget: int = 12) -> SearchOutcome:
    """Coordinate descent from ``start`` over ``axes`` (walked in
    :data:`AXES` order), committing one axis before moving to the next.
    See the module docstring for the guarantees."""
    memo: Dict[Candidate, Any] = {}
    out = SearchOutcome(best=start, best_sps=0.0, baseline=start,
                        baseline_sps=0.0, trials=0, pruned=0,
                        exhausted=False)

    def run(cand: Candidate) -> Any:
        if cand in memo:
            return memo[cand]
        if out.trials >= trial_budget:
            out.exhausted = True
            return None
        try:
            res = measure(cand)
        except Exception as e:   # a crashing probe is a pruned point
            res = _Infeasible(f"{type(e).__name__}: {str(e)[:200]}")
        if res is None:
            res = _Infeasible("measure returned None")
        if getattr(res, "counted", True):
            out.trials += 1
        if not getattr(res, "feasible", False):
            out.pruned += 1
        memo[cand] = res
        out.log.append((cand, res))
        return res

    base_res = run(start)
    out.baseline_sps = _sps(base_res) if getattr(
        base_res, "feasible", False) else 0.0
    out.best_sps = out.baseline_sps

    for axis in AXES:
        values = list(axes.get(axis, []))
        if len(values) <= 1:
            continue
        incumbent_v = getattr(out.best, axis)
        measured: List[Tuple[Any, float, Any]] = []
        if getattr(memo.get(out.best), "feasible", False):
            measured.append((incumbent_v, _sps(memo[out.best]),
                             memo[out.best]))
        prev_sps: Optional[float] = None
        for v in values:
            if v == incumbent_v:
                prev_sps = _sps(memo[out.best]) if measured else prev_sps
                continue
            cand = out.best.replace(**{axis: v})
            res = run(cand)
            if res is None:          # budget exhausted mid-axis
                break
            if not res.feasible:
                if axis in ORDERED_AXES:
                    break            # bigger k / accum cannot refit HBM
                continue
            sps = _sps(res)
            measured.append((v, sps, res))
            if (axis in ORDERED_AXES and prev_sps is not None
                    and sps < prev_sps * (1 - REGRESS_STOP)):
                break                # past the plateau, curve turned down
            prev_sps = sps
        if not measured:
            continue
        axis_best_sps = max(s for _, s, _ in measured)
        if axis in MATH_AXES:
            # math knobs: move off the seed value only on a win clearing
            # BOTH trials' measured noise floors
            cur = next(((s, r) for v, s, r in measured
                        if v == incumbent_v), (0.0, None))
            winner_v, winner_sps, winner_res = max(measured,
                                                   key=lambda t: t[1])
            need = 1 + max(IMPROVE_MIN, _spread(cur[1]),
                           _spread(winner_res))
            if (winner_v != incumbent_v and winner_sps > 0
                    and winner_sps >= cur[0] * need):
                out.best = out.best.replace(**{axis: winner_v})
                out.best_sps = winner_sps
        else:
            # plateau preference: smallest value within tolerance of best
            # (ordered axes scan ascending; the budget axis keeps its
            # measurement order, which leads with the heuristic estimate)
            if axis in ORDERED_AXES:
                measured = sorted(measured, key=lambda t: t[0])
            for v, sps, _ in measured:
                if sps >= axis_best_sps * (1 - PLATEAU_TOL):
                    if v != getattr(out.best, axis):
                        out.best = out.best.replace(**{axis: v})
                    out.best_sps = sps
                    break
        if out.exhausted:
            break

    # the hard floor: NEVER commit a point slower than the measured seed
    # heuristic (selfcheck.check_autotune drills exactly this)
    if out.best != out.baseline and out.best_sps < out.baseline_sps:
        out.best, out.best_sps = out.baseline, out.baseline_sps
    return out


class _Infeasible:
    """Minimal ProbeResult stand-in for a measure() that raised."""

    feasible = False
    counted = True
    steps_per_sec = 0.0

    def __init__(self, error: str):
        self.error = error

    def __repr__(self) -> str:
        return f"_Infeasible({self.error!r})"
