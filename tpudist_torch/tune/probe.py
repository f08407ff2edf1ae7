"""Measured probe trials of the REAL dispatch path: the JAX package's
``tpudist/tune/probe.py`` over the port's dispatch.

One probe = build exactly what the run would dispatch
(``engine.make_train_step`` with its per-step host transfer at ``k ==
1``; ``engine.make_superstep`` over ``staging.plan_slabs`` /
``put_slab`` slabs at ``k > 1``, driven window by window as
``train._superstep_epoch`` drives it, the partial tail's one-step graph
and streamed slabs included) from a fresh ``TrainState`` made from the
seed, warm it with one epoch (on the card: the superstep's eager first
window and its two CUDA-graph captures), then time ``repeats`` epochs
fenced by a loss copied to the host, and report steps/s plus the
trial's peak reserved device memory. The probe either completes with a
number or reports ``feasible=False`` (an OOM, a capture that fails, a
staging budget that cannot double-buffer, a watermark past the card's
limit) — an infeasible point is a *result* the search prunes, never a
crash.

Each trial on the card captures its own pair of graphs into its own
pool. It ends by releasing them, its state and its slabs, and emptying
the allocator's cache, so the next trial starts from the same reserved
memory; an OOM inside a capture leaves the capture closed (``torch.cuda
.graph``'s exit ends it) and its pool freed with the graph. The kernel
wrappers' launch counters are restored after each trial, so a run's
counts hold its own launches only; the trial's launches (eager and
replayed) ride on its result.

:class:`EpochRunner` is the compile-once/run-many harness itself.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from tpudist_torch import config as config_lib
from tpudist_torch import data as data_lib
from tpudist_torch import engine
from tpudist_torch.obs import trace as trace_lib
from tpudist_torch.parallel import staging

# Probe length/repeats: long enough that per-epoch fixed costs (one
# staging transfer, one fence) amortise like a real epoch, short enough
# that a full search stays a startup blip next to the timed run. The
# estimator over repeats is the MIN epoch time: host-scheduler noise is
# one-sided (a load spike only ever slows an epoch down), so the fastest
# observed epoch is the least-contaminated measurement of the program.
DEFAULT_PROBE_STEPS = 64
DEFAULT_PROBE_REPEATS = 5

# A probe whose reserved-memory watermark lands above this fraction of
# the card's memory is pruned even though it survived: the timed run
# keeps more alive (checkpoint snapshots, the second staged slab at
# epoch scale) and a point with no headroom is one allocator hiccup from
# OOM.
HBM_HEADROOM_FRACTION = 0.95


@dataclasses.dataclass(frozen=True)
class ProbeResult:
    """One candidate's measured trial (or its reason for being pruned)."""

    steps_per_sec: float
    step_ms: float
    n_steps: int
    repeats: int
    hbm_peak_bytes: Optional[int] = None
    compile_s: float = 0.0
    feasible: bool = True
    error: Optional[str] = None
    key: Optional[tuple] = None   # effective-program key (dedupe)
    counted: bool = True          # False = memo hit, no budget consumed
    spread: float = 0.0           # (max-min)/min over repeats: the trial's
    # own measured noise floor — math-knob commits must clear it
    launches: Optional[Dict[str, int]] = None  # kernel launches the trial
    # ran, eager and replayed, by kernel name


class EpochRunner:
    """Build-once / run-many epoch harness over the real dispatch path.

    ``k == 1`` runs the per-step path — ``make_train_step`` including its
    per-step host-to-device copy, the real thing the superstep replaces.
    ``k > 1`` stages slabs per ``plan_slabs`` (full-epoch fast path, or
    double-buffered streaming under ``budget_bytes``) and dispatches
    supersteps exactly as ``train._superstep_epoch`` does; :meth:`close`
    releases the superstep's graphs."""

    def __init__(self, cfg, device, k: int, plan, n_steps: int, *,
                 budget_bytes: Optional[int] = None):
        self.cfg, self.device, self.k = cfg, torch.device(device), int(k)
        self.n_steps = min(int(n_steps), plan.n_steps)
        if self.n_steps < 1:
            raise ValueError(f"probe needs >= 1 step, got {self.n_steps}")
        self._plan = plan
        self.superstep = None
        if self.k == 1:
            # one host-side gather up front; the host-to-device copy
            # stays per-step
            self._host = plan.slab(0, self.n_steps)
            self.dispatch_fn = engine.make_train_step(cfg, self.device)
            self.splan = None
        else:
            self.splan = staging.plan_slabs(
                self.n_steps, self.k,
                staging.step_bytes(plan.arrays, plan.local_batch),
                budget_bytes)
            self.superstep = engine.make_superstep(cfg, self.device, self.k)
            self.dispatch_fn = self.superstep
            self._stream = (torch.cuda.Stream(self.device)
                            if self.device.type == "cuda" else None)

    def init_state(self):
        """A fresh TrainState from the seed (the run's own state and
        generators are never touched)."""
        return engine.init_state(self.cfg, self.device)

    def run_epoch(self, state) -> Tuple[Any, Any]:
        """Dispatch one epoch; returns ``(state, last_loss)`` with the
        device work still in flight — callers fence on the loss."""
        if self.k == 1:
            loss = None
            for i in range(self.n_steps):
                batch = data_lib.to_device(tuple(a[i] for a in self._host),
                                           self.device)
                state, loss = self.dispatch_fn(state, batch)
            return state, loss
        splan, k = self.splan, self.k
        S = splan.slab_steps
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        last = None

        def stage(s):
            start, stop = s * S, min(self.n_steps, s * S + S)
            pad_to = -(-(stop - start) // k) * k
            return staging.put_slab(
                self._plan.slab(start, stop, pad_to=pad_to), self.device,
                self._stream)

        nxt = stage(0)
        for s in range(splan.n_slabs):
            cur = nxt
            if s + 1 < splan.n_slabs:
                # double buffer: next slab's copy overlaps this compute
                nxt = stage(s + 1)
            arrays = cur.arrays_for()
            base = s * S
            for j in range(arrays[0].shape[0] // k):
                gstart = base + j * k
                if gstart >= self.n_steps:
                    break
                hi = min(self.n_steps - gstart, k)
                window = tuple(a[j * k:(j + 1) * k] for a in arrays)
                state, total, losses = self.dispatch_fn(state, total,
                                                        window, 0, hi)
                last = losses[hi - 1]
            if s + 1 < splan.n_slabs and last is not None:
                float(last)    # slab-boundary fence (train parity)
            cur = arrays = window = None
        return state, last

    def launches(self, since: Dict[str, int]) -> Dict[str, int]:
        """Kernel launches since the counters read ``since``: the
        wrappers' (eager) ones plus those the superstep's replays ran."""
        now = engine.kernel_launch_counts()
        out = {name: now[name] - since[name] for name in now}
        if self.superstep is not None:
            for name, n in self.superstep.kernel_launches().items():
                out[name] += n
        return out

    def close(self) -> None:
        """Drop the superstep's graphs, their pool and static buffers."""
        if self.superstep is not None:
            self.superstep.release()


def time_runner(runner: EpochRunner, *, repeats: int = DEFAULT_PROBE_REPEATS,
                state: Any = None) -> Tuple[Any, List[float], float]:
    """Warm (kernel builds, staging, captures) one epoch, then time
    ``repeats`` epochs. Returns ``(state, ms_per_step_per_epoch,
    compile_s)``; the fence is a copy of the last loss to the host."""
    state = runner.init_state() if state is None else state
    t0 = time.perf_counter()
    state, loss = runner.run_epoch(state)
    float(loss)
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        state, loss = runner.run_epoch(state)
        float(loss)
        times.append((time.perf_counter() - t0) * 1000 / runner.n_steps)
    return state, times, compile_s


def candidate_key(cfg, candidate, plan, n_steps: int) -> tuple:
    """The EFFECTIVE program a candidate dispatches, as a hashable key.
    Distinct candidates can dispatch the same program at probe scale
    (every staging budget the probe epoch fits inside is the same
    full-epoch fast path) — the search memoises on this key so the trial
    budget is spent on points that can actually differ. Raises where the
    plan itself is infeasible (plan_slabs's double-buffer error), which
    the caller converts to a pruned point."""
    overlap = (candidate.grad_bucket_mb, candidate.pipeline_interleave)
    if candidate.k == 1:
        return (1, None, candidate.remat, candidate.grad_accum_steps,
                overlap)
    budget = config_lib.resolve_staging_budget_bytes(candidate.apply(cfg))
    splan = staging.plan_slabs(
        min(int(n_steps), plan.n_steps), candidate.k,
        staging.step_bytes(plan.arrays, plan.local_batch), budget)
    return (candidate.k, (splan.slab_steps, splan.streamed),
            candidate.remat, candidate.grad_accum_steps, overlap)


def device_memory(device) -> Tuple[Optional[int], Optional[int]]:
    """``(peak reserved bytes since the last reset_peak_memory_stats,
    the card's memory)``: graph pools live in reserved memory, not in
    allocated memory. ``(None, None)`` off the card."""
    device = torch.device(device)
    if device.type != "cuda":
        return None, None
    return (torch.cuda.max_memory_reserved(device),
            torch.cuda.mem_get_info(device)[1])


def release_memory(device) -> None:
    """Give back what a trial left: collect its garbage, drain the card,
    drop cuBLAS's workspaces and empty the allocator's cache (a released
    graph's pool included). cuBLAS keeps a workspace from the caching
    allocator for each stream it has run on; a captured graph replays
    into the workspace of its capture stream, so they are dropped only
    here, between trials, where the trial's graphs are released and the
    run has captured none yet."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.empty_cache()


def probe_candidate(cfg, device, candidate, plan, *,
                    n_steps: int = DEFAULT_PROBE_STEPS,
                    repeats: int = DEFAULT_PROBE_REPEATS) -> ProbeResult:
    """Run one candidate's measured trial; never raises — any failure
    (OOM, a failed capture, an infeasible slab plan, a build error)
    comes back as a pruned ``feasible=False`` result carrying the error
    string. The trial's superstep, state and slabs are released and the
    launch counters restored whatever happened."""
    device = torch.device(device)
    n = min(int(n_steps), plan.n_steps)
    counts = engine.kernel_launch_counts()
    runner = None
    launches = None
    try:
        key = candidate_key(cfg, candidate, plan, n)
        pcfg = candidate.apply(cfg)
        budget = (config_lib.resolve_staging_budget_bytes(pcfg)
                  if candidate.k > 1 else None)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        runner = EpochRunner(pcfg, device, candidate.k, plan, n,
                             budget_bytes=budget)
        # the trial's state is not kept: its memory goes back below
        with trace_lib.span("probe_trial", cat="tune", k=candidate.k,
                            remat=candidate.remat,
                            grad_accum=candidate.grad_accum_steps):
            times, compile_s = time_runner(runner, repeats=repeats)[1:]
        launches = runner.launches(counts)
        peak, limit = device_memory(device)
        ms = min(times)   # one-sided noise: fastest epoch is cleanest
        spread = (max(times) - ms) / ms if ms > 0 else 0.0
        if peak and limit and peak > HBM_HEADROOM_FRACTION * limit:
            res = ProbeResult(
                0.0, ms, n, repeats, hbm_peak_bytes=peak,
                compile_s=compile_s, feasible=False, key=key,
                error=f"device memory watermark {peak} of {limit} B "
                      f"leaves no headroom")
        else:
            res = ProbeResult(1000.0 / ms, ms, n, repeats,
                              hbm_peak_bytes=peak, compile_s=compile_s,
                              key=key, spread=spread)
    except Exception as e:
        if runner is not None:
            launches = runner.launches(counts)
        res = ProbeResult(0.0, float("inf"), n, repeats, feasible=False,
                          error=f"{type(e).__name__}: {str(e)[:200]}")
    finally:
        if runner is not None:
            runner.close()
        runner = None
        engine.set_kernel_launch_counts(counts)
        release_memory(device)
    return dataclasses.replace(res, launches=launches)
