"""tpudist_torch.tune — the measured-probe autotuner: the JAX package's
``tpudist/tune/`` over the port's superstep and staging.

``config.resolve_steps_per_dispatch`` and
``resolve_staging_budget_bytes`` GUESS the dispatch/staging operating
point by static heuristic, and the choice moves steps/s by up to an
order of magnitude on the card (the MLP default per-step against
replayed, ``PERF.md`` §6). This package replaces the guess with a
measurement: short trials of the *real* superstep on the device
(:mod:`probe`) over a bounded knob space — superstep length ``k``,
staging budget, ``remat``, ``grad_accum_steps`` — walked by a
deterministic coordinate search (:mod:`search`) and persisted in a
fingerprint-keyed JSON cache (:mod:`cache`), so the SECOND run of the
same workload costs zero probe trials. The heuristics are not gone:
they are the search's START POINT, and the search never commits a point
that measures slower than them.

:func:`autotune` is the train loop's one entry: resolve mode
(``--autotune`` / ``TPUDIST_AUTOTUNE``), consult the cache, probe on a
miss, broadcast the committed point from rank 0 over the host gloo
group (measured times differ per process — the commit must not, and
every rank must walk the same trial sequence so the probes'
all-reduces line up), persist, and report a ``kind=tune`` metrics record
plus the three-valued ``tuning_status`` for the verdict stream.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from tpudist_torch import config as config_lib
from tpudist_torch import verdict as verdict_lib
from tpudist_torch.metrics import log0
from tpudist_torch.parallel import distributed
from tpudist_torch.parallel import mesh as mesh_lib
from tpudist_torch.parallel.mesh import AXIS_NAMES, resolve_axis_sizes
from tpudist_torch.tune import cache as cache_mod
from tpudist_torch.tune import probe as probe_mod
from tpudist_torch.tune import search as search_mod
from tpudist_torch.tune.search import Candidate

__all__ = ["Candidate", "TuneOutcome", "autotune", "cache_mod",
           "probe_mod", "search_mod"]

# wire order for the multi-process broadcast: index+1 is the enum value
CROSS_SLICE_ENUM = ("flat", "hierarchical")


@dataclasses.dataclass(frozen=True)
class TuneOutcome:
    """What the tuner decided and how it got there."""

    cfg: Any                      # TrainConfig with the commit folded in
    tuned: Candidate
    source: str                   # cache | probe | heuristic
    status: str                   # verdict SUCCESS/FAIL/UNGATEABLE
    trials: int                   # probe trials actually run
    pruned: int
    fingerprint: str
    cache_dir: str
    steps_per_sec: Optional[float] = None
    baseline_steps_per_sec: Optional[float] = None


def _heuristic_candidate(cfg, *, state_bytes: int = 0,
                         hbm_bytes: Optional[float] = None) -> Candidate:
    """The static heuristics' pick — the search's start point and the
    floor the commit may never fall below. The pipeline's coordinate is
    GPipe's (the port refuses the pipe axis)."""
    budget = config_lib.resolve_staging_budget_bytes(
        cfg, state_bytes=state_bytes, hbm_bytes=hbm_bytes)
    mode, bucket_bytes = config_lib.resolve_grad_overlap(cfg)
    return Candidate(
        k=config_lib.resolve_steps_per_dispatch(cfg),
        staging_budget_mb=(None if budget is None
                           else round(budget / 2**20, 4)),
        remat=cfg.remat, grad_accum_steps=cfg.grad_accum_steps,
        grad_bucket_mb=(round(bucket_bytes / 2**20, 4)
                        if mode == "bucketed" else None),
        pipeline_interleave=1,
        cross_slice=config_lib.resolve_cross_slice(cfg))


def _broadcast(values: List[float]) -> List[float]:
    """Rank 0's ``values`` on every rank, over the host gloo group; the
    values as given without a process group."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return values
    t = torch.tensor(values, dtype=torch.float64)
    dist.broadcast(t, src=0, group=distributed.host_group())
    return t.tolist()


def _sync_candidate(cand: Optional[Candidate],
                    hit: bool) -> tuple[Optional[Candidate], bool]:
    """Multi-process agreement: rank 0's (cache-hit?, candidate) decision
    is broadcast so every process dispatches the same programs — a cache
    file present for one process but not another, or per-process timing
    jitter in the probes, must not fork the job. No-op single-process."""
    dec = _broadcast([
        1.0 if hit else 0.0,
        1.0 if cand is not None else 0.0,
        float(cand.k if cand else 0),
        -1.0 if (cand is None or cand.staging_budget_mb is None)
        else float(cand.staging_budget_mb),
        1.0 if (cand and cand.remat) else 0.0,
        float(cand.grad_accum_steps if cand else 0),
        -1.0 if (cand is None or cand.grad_bucket_mb is None)
        else float(cand.grad_bucket_mb),
        float(cand.pipeline_interleave if cand else 0),
        # cross_slice enum: 0 = None, 1 = flat, 2 = hierarchical
        0.0 if (cand is None or cand.cross_slice is None)
        else float(1 + CROSS_SLICE_ENUM.index(cand.cross_slice)),
    ])
    if dec[1] < 0.5:
        return None, bool(dec[0] > 0.5)
    return Candidate(
        k=int(dec[2]),
        staging_budget_mb=(None if dec[3] < 0 else float(dec[3])),
        remat=bool(dec[4] > 0.5),
        grad_accum_steps=int(dec[5]),
        grad_bucket_mb=(None if dec[6] < 0 else float(dec[6])),
        pipeline_interleave=int(dec[7]),
        cross_slice=(None if int(dec[8]) == 0
                     else CROSS_SLICE_ENUM[int(dec[8]) - 1])
    ), bool(dec[0] > 0.5)


def _sync_result(res: "probe_mod.ProbeResult") -> "probe_mod.ProbeResult":
    """Multi-process agreement at TRIAL granularity: every search
    decision (plateau pick, early stop, budget count) is a threshold on
    measured numbers, and per-process clocks differ by enough to land on
    opposite sides of a threshold — which would fork the deterministic
    trial sequence and deadlock the next probe's all-reduces. Broadcast
    rank 0's measurement so every process feeds the search identical
    inputs. No-op single-process."""
    dec = _broadcast([1.0 if res.feasible else 0.0, res.steps_per_sec,
                      res.step_ms, res.spread])
    return dataclasses.replace(
        res, feasible=bool(dec[0] > 0.5), steps_per_sec=float(dec[1]),
        step_ms=float(dec[2]), spread=float(dec[3]))


def autotune(cfg, device, plan, *, mode: str, metrics: Any = None,
             is_coordinator: bool = True, state_bytes: int = 0,
             hbm_bytes: Optional[float] = None,
             n_steps: Optional[int] = None,
             repeats: int = probe_mod.DEFAULT_PROBE_REPEATS,
             mesh=None) -> TuneOutcome:
    """Resolve this run's operating point per ``mode`` (``probe`` |
    ``cache-only``): cache hit → committed with zero trials; miss under
    ``probe`` → measured search; miss under ``cache-only`` (or a probing
    failure) → the heuristics, honestly labeled. ``plan`` is epoch 0's
    :class:`~tpudist_torch.data.EpochPlan` — probes consume the run's own
    first batches, so trial shapes are the real shapes. ``mesh`` is the
    run's sharded mesh (None: replicated), on which every trial runs."""
    start = _heuristic_candidate(cfg, state_bytes=state_bytes,
                                 hbm_bytes=hbm_bytes)
    cache_dir = config_lib.resolve_autotune_cache_dir(cfg)
    fp = cache_mod.fingerprint(cfg, device)
    trials_budget = config_lib.resolve_autotune_trials(cfg)
    probe_steps = (probe_mod.DEFAULT_PROBE_STEPS
                   if n_steps is None else int(n_steps))

    tuned: Optional[Candidate] = None
    hit = False
    rec = cache_mod.load(cache_dir, fp) if is_coordinator else None
    if rec is not None:
        t = rec["tuned"]
        tuned = Candidate(k=int(t["k"]),
                          staging_budget_mb=t["staging_budget_mb"],
                          remat=bool(t["remat"]),
                          grad_accum_steps=int(t["grad_accum_steps"]),
                          grad_bucket_mb=t.get("grad_bucket_mb"),
                          pipeline_interleave=int(
                              t.get("pipeline_interleave") or 0),
                          cross_slice=t.get("cross_slice"))
        hit = True
    tuned, hit = _sync_candidate(tuned, hit)
    if hit and tuned is not None:
        try:   # defensive: a cached k must still satisfy the constraints
            config_lib.resolve_steps_per_dispatch(tuned.apply(cfg))
        except ValueError:
            tuned, hit = None, False
    if hit and tuned is not None:
        sps = rec.get("steps_per_sec") if rec else None
        base = rec.get("baseline_steps_per_sec") if rec else None
        out = TuneOutcome(cfg=tuned.apply(cfg), tuned=tuned,
                          source="cache",
                          status=verdict_lib.tuning_status(
                              mode, source="cache"),
                          trials=0, pruned=0, fingerprint=fp,
                          cache_dir=cache_dir, steps_per_sec=sps,
                          baseline_steps_per_sec=base)
        return _log_record(out, metrics)

    if mode != "probe":
        # cache-only miss: nothing measured, nothing to gate — run on
        # the heuristics and say so
        out = TuneOutcome(cfg=cfg, tuned=start, source="heuristic",
                          status=verdict_lib.tuning_status(
                              mode, source="heuristic"),
                          trials=0, pruned=0, fingerprint=fp,
                          cache_dir=cache_dir)
        return _log_record(out, metrics)

    try:
        outcome = _probe_search(cfg, device, plan, start,
                                trials_budget=trials_budget,
                                n_steps=probe_steps, repeats=repeats,
                                mesh=mesh)
    except Exception as e:
        # probing must never kill a run the heuristics could serve
        log0(f"tpudist: autotune probing failed ({e!r}); "
             f"falling back to heuristics")
        out = TuneOutcome(cfg=cfg, tuned=start, source="heuristic",
                          status=verdict_lib.tuning_status(
                              mode, source="heuristic"),
                          trials=0, pruned=0, fingerprint=fp,
                          cache_dir=cache_dir)
        return _log_record(out, metrics)

    tuned, _ = _sync_candidate(outcome.best, False)
    tuned = tuned if tuned is not None else outcome.best
    status = verdict_lib.tuning_status(
        mode, source="probe", tuned_steps_per_sec=outcome.best_sps,
        baseline_steps_per_sec=outcome.baseline_sps)
    if is_coordinator:
        cache_mod.store(cache_dir, fp, {
            "tuned": tuned.as_dict(),
            "steps_per_sec": outcome.best_sps,
            "baseline_steps_per_sec": outcome.baseline_sps,
            "trials": outcome.trials,
            "pruned": outcome.pruned,
            "probe_steps": probe_steps,
            "probe_repeats": repeats,
        })
    out = TuneOutcome(cfg=tuned.apply(cfg), tuned=tuned, source="probe",
                      status=status, trials=outcome.trials,
                      pruned=outcome.pruned, fingerprint=fp,
                      cache_dir=cache_dir,
                      steps_per_sec=outcome.best_sps,
                      baseline_steps_per_sec=outcome.baseline_sps)
    return _log_record(out, metrics)


def _probe_search(cfg, device, plan, start: Candidate, *,
                  trials_budget: int, n_steps: int, repeats: int,
                  mesh=None) -> search_mod.SearchOutcome:
    """Wire the real probe into the coordinate search, memoised on the
    EFFECTIVE program key — budget candidates the probe epoch cannot
    tell apart (all full-epoch fast path at probe scale) share one
    trial instead of re-measuring the identical program."""
    # the batch splits over data x fsdp: one process a position
    world = dist.get_world_size() if dist.is_initialized() else 1
    sizes = dict(zip(AXIS_NAMES, resolve_axis_sizes(cfg.parallel, world)))
    # the overlap-plane axes exist only where the run makes them real:
    # the replicated data-parallel step (no sharded mesh, world > 1)
    dp = mesh is None and world > 1
    sg = (mesh_lib.data_slice_groups(mesh_lib.rank_grid(cfg.parallel, world))
          if dp else None)
    axes = search_mod.build_space(
        cfg, batch_ways=sizes["data"] * sizes["fsdp"],
        heuristic_budget_mb=start.staging_budget_mb, dp_overlap=dp,
        n_slices=sg.n_slices if sg is not None else 1)
    by_key: Dict[tuple, probe_mod.ProbeResult] = {}

    def raw_probe(cand: Candidate) -> probe_mod.ProbeResult:
        return _sync_result(probe_mod.probe_candidate(
            cfg, device, cand, plan, n_steps=n_steps, repeats=repeats,
            mesh=mesh))

    def measure(cand: Candidate) -> probe_mod.ProbeResult:
        try:
            key = probe_mod.candidate_key(cfg, cand, plan, n_steps)
        except Exception as e:   # infeasible plan — pruned, not crashed
            return probe_mod.ProbeResult(
                0.0, float("inf"), n_steps, repeats, feasible=False,
                error=f"{type(e).__name__}: {str(e)[:200]}")
        prior = by_key.get(key)
        if prior is not None:
            return dataclasses.replace(prior, counted=False)
        res = raw_probe(cand)
        if res.key is not None:
            by_key[res.key] = res
        return res

    # the process's very FIRST trial runs cold (kernel builds, allocator
    # growth, lazy module loads) — biasing the search AGAINST whichever
    # point is probed first, which is always the heuristic start. Burn
    # the cold trial on the start candidate and discard it; uncounted
    # against the budget by design.
    probe_mod.probe_candidate(cfg, device, start, plan, n_steps=n_steps,
                              repeats=1, mesh=mesh)
    out = search_mod.coordinate_search(start, axes, measure,
                                       trial_budget=trials_budget)
    if out.best != out.baseline:
        # measure-then-commit confirmation: re-probe the provisional
        # winner and the heuristic back-to-back (same process state, no
        # order bias between them) and fold in by best-observed — the
        # commit must survive a SECOND look before it displaces the seed
        confirm_best = raw_probe(out.best)
        confirm_base = raw_probe(out.baseline)
        out.trials += 2
        if confirm_best.feasible:
            out.best_sps = max(out.best_sps, confirm_best.steps_per_sec)
        else:
            out.best_sps = 0.0   # the winner died on re-measure: reject
        if confirm_base.feasible:
            out.baseline_sps = max(out.baseline_sps,
                                   confirm_base.steps_per_sec)
        floor = out.baseline_sps
        if (out.best.remat != out.baseline.remat
                or out.best.grad_accum_steps
                != out.baseline.grad_accum_steps):
            # a math-knob commit costs bitwise parity with the untuned
            # trajectory: it must ALSO clear the improvement margin and
            # both confirmation trials' noise floors on the re-measure,
            # not just tie the heuristic
            floor *= 1 + max(search_mod.IMPROVE_MIN,
                             confirm_best.spread, confirm_base.spread)
        if out.best_sps < floor:
            out.best, out.best_sps = out.baseline, out.baseline_sps
    return out


def _log_record(out: TuneOutcome, metrics: Any) -> TuneOutcome:
    """One ``kind=tune`` record per tuning decision — the committed
    knobs, where they came from, and what the probes measured."""
    if metrics is not None:
        metrics.log(kind="tune", status=out.status, source=out.source,
                    trials=out.trials, pruned=out.pruned,
                    fingerprint=out.fingerprint,
                    steps_per_dispatch=out.tuned.k,
                    staging_budget_mb=out.tuned.staging_budget_mb,
                    remat=out.tuned.remat,
                    grad_accum_steps=out.tuned.grad_accum_steps,
                    grad_bucket_mb=out.tuned.grad_bucket_mb,
                    pipeline_interleave=out.tuned.pipeline_interleave,
                    cross_slice=out.tuned.cross_slice,
                    steps_per_sec=out.steps_per_sec,
                    baseline_steps_per_sec=out.baseline_steps_per_sec)
    return out
