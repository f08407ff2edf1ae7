"""Measured-probe autotuner for the serving engine's knobs.

Counterpart of ``tpudist/serve/tune.py`` over the port's engines. The
decode superstep length (``decode_k``, tokens per dispatch per slot),
the KV cache's storage layout (``st`` | ``hs``,
:mod:`tpudist_torch.serve.kvcache`) and the paged axes (page size
``kv_page_tokens``, speculation window ``speculate_k``) all move decode
throughput, and the right answer depends on the model shape and the
card. The train tuner's machinery serves here too: the fingerprint-keyed
JSON cache (:mod:`tpudist_torch.tune.cache`, ``prefix="serve"``, so the
two knob schemas never share a file), the walk's discipline (ordered
ascent with plateau preference and a regress stop,
:mod:`tpudist_torch.tune.search`'s constants) and its contract: the
search NEVER commits a point that measures slower than the heuristic
start, a second run of the same (model, card, serve shape) costs zero
probe trials, and a probing failure degrades to the heuristics, never to
a dead run.

The probe is closed-loop decode throughput: build the candidate's
engine (on the card: capture its prefill and decode graphs, plus verify
when speculating), prefill every slot, then time whole decode supersteps
with every slot active — tokens/s at full occupancy, the number the
``tokens_per_chip`` SLO gate grades. Each trial releases its engine
(graphs, KV cache, scratch) and the allocator's cache before the next,
and restores the kernels' launch counters, so a served run's counts
hold its own launches only.

On a serve mesh (``mesh=``, the serve CLI's under the env contract) every
rank runs the tuner in lockstep: each trial's engine is built on the mesh
on every rank, rank 0 drives and times it while the others follow its
commands, and rank 0's measurement (and its cache decision) is broadcast
so every rank walks the search the same way; the fingerprint carries the
mesh's shape and card count, so a record of several cards never answers
one card's run.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import torch

from tpudist_torch import verdict as verdict_lib
from tpudist_torch.serve.kvcache import KV_CACHE_LAYOUTS
from tpudist_torch.tune import _broadcast
from tpudist_torch.tune import cache as cache_mod
from tpudist_torch.tune import search as search_mod

# Decode-k ladder: geometric like the train tuner's k axis — the curve's
# knee is what matters, not every integer. Capped where per-dispatch
# latency starts to dominate ITL attribution (slo: ITL = wall / k).
DECODE_K_LADDER = (1, 2, 4, 8, 16, 32)
# Paged-axis ladders: page sizes worth probing (0 — the dense arena — is
# always the walk's committed fallback) and verify window widths (the
# window includes the pending last token, so 2 is the smallest real
# speculation).
KV_PAGE_TOKENS_LADDER = (8, 16, 32)
SPECULATE_K_LADDER = (2, 4, 8)

DEFAULT_PROBE_DISPATCHES = 8
DEFAULT_PROBE_REPEATS = 3
DEFAULT_TRIALS = 8


@dataclasses.dataclass(frozen=True)
class ServeCandidate:
    """One point in the serve knob space. ``kv_page_tokens = 0`` is the
    dense arena; > 0 selects the paged engine at that page size.
    ``speculate_k = 0`` is plain decode; >= 2 is the draft+verify
    window (meaningful only with paging — the walk gates it so)."""

    decode_k: int = 8
    layout: str = "st"
    kv_page_tokens: int = 0
    speculate_k: int = 0

    def replace(self, **kw) -> "ServeCandidate":
        return dataclasses.replace(self, **kw)

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def validate_serve_tuned(tuned: Dict[str, Any]) -> bool:
    """Knob sanity for a cached serve record (the ``validate`` hook of
    :func:`tpudist_torch.tune.cache.load`): an insane decode_k, unknown
    layout, or a pre-paging record missing the paged knobs is a cache
    MISS (re-probe), never a crash in the engine."""
    if "kv_page_tokens" not in tuned or "speculate_k" not in tuned:
        return False              # pre-paging schema: re-probe
    if int(tuned["decode_k"]) < 1:
        return False
    pt, sk = int(tuned["kv_page_tokens"]), int(tuned["speculate_k"])
    if pt < 0 or sk < 0 or sk == 1:
        return False
    if sk >= 2 and pt == 0:
        return False              # speculation needs the paged engine
    return tuned["layout"] in KV_CACHE_LAYOUTS


def fingerprint(model_cfg, device, *, slots: int, max_seq: int,
                prompt_pad: int, dtype=torch.float32,
                device_kind: Optional[str] = None, mesh=None) -> str:
    """Fingerprint of the serve tuning situation: the train tuner's
    recipe (:func:`tpudist_torch.tune.cache.fingerprint`: the card's
    name, torch and CUDA versions, the kernels' source hash) over the
    serve workload — model shape, cache geometry, activation dtype — and,
    as the JAX fingerprint, the serve mesh's shape and its card and
    process counts (one card without a mesh)."""
    import hashlib
    import json

    from tpudist_torch import __version__
    from tpudist_torch.parallel.mesh import mesh_devices, mesh_shape
    if device_kind is None:
        device_kind = (torch.cuda.get_device_name(device)
                       if torch.device(device).type == "cuda" else "cpu")
    payload = {
        "schema": cache_mod.SCHEMA,
        "what": "serve",
        # knob-space generation: records from a walk without the paged
        # knobs never alias a fingerprint whose search space they never
        # saw
        "knobs": 2,
        "model": dataclasses.asdict(model_cfg),
        "slots": int(slots),
        "max_seq": int(max_seq),
        "prompt_pad": int(prompt_pad),
        "dtype": str(dtype),
        "mesh": None if mesh is None else mesh_shape(mesh),
        "n_devices": 1 if mesh is None else int(mesh_devices(mesh).size),
        "n_processes": 1 if mesh is None else int(
            mesh_devices(mesh).size),
        "device_kind": device_kind,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "tpudist_torch": __version__,
        "kernels": cache_mod.kernel_sources(),
    }
    blob = json.dumps(payload, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class ServeProbeResult:
    """One candidate's measured decode-throughput trial."""

    tokens_per_sec: float
    dispatch_ms: float
    feasible: bool = True
    error: Optional[str] = None
    spread: float = 0.0      # (max-min)/min over repeats: noise floor
    tokens: int = 0          # tokens actually generated per timed run


def probe_candidate(model_cfg, device, params, cand: ServeCandidate, *,
                    slots: int, max_seq: int, prompt_pad: int,
                    dtype=torch.float32,
                    n_dispatches: int = DEFAULT_PROBE_DISPATCHES,
                    repeats: int = DEFAULT_PROBE_REPEATS,
                    mesh=None) -> ServeProbeResult:
    """Measure one candidate: build its engine on ``device`` and warm it
    (on the card: capture its graphs, off the timed path), then time its
    decode at full occupancy (:func:`_time_decode`). Never raises — any
    failure (an OOM, a failed capture) is a pruned ``feasible=False``
    result. The trial's engine is released, the allocator's cache
    emptied and the launch counters restored whatever happened.

    On a serve ``mesh`` every rank builds the engine on it; rank 0 times
    it and stops the followers, which follow its commands and then return
    a placeholder (:func:`autotune_serve` hands every rank rank 0's
    result). A follower that fails inside a command raises: rank 0 waits
    on it in a collective, which its exit then fails."""
    from tpudist_torch import engine as engine_lib
    from tpudist_torch.serve.engine import PagedServeEngine, ServeEngine
    from tpudist_torch.tune.probe import release_memory

    device = torch.device(device)
    counts = engine_lib.kernel_launch_counts()
    engine = None
    leading = False
    try:
        if cand.kv_page_tokens > 0:
            engine = PagedServeEngine(
                model_cfg, slots=slots, max_seq=max_seq,
                prompt_pad=prompt_pad, decode_k=cand.decode_k,
                page_tokens=cand.kv_page_tokens,
                speculate_k=cand.speculate_k, dtype=dtype, device=device,
                mesh=mesh)
        else:
            engine = ServeEngine(model_cfg, slots=slots, max_seq=max_seq,
                                 prompt_pad=prompt_pad,
                                 decode_k=cand.decode_k,
                                 layout=cand.layout, dtype=dtype,
                                 device=device, mesh=mesh)
        if mesh is not None and torch.distributed.get_rank() != 0:
            try:
                engine.follow(params)
            except AssertionError as e:  # rank 0 stopped a failed trial
                return ServeProbeResult(0.0, float("inf"), feasible=False,
                                        error=f"AssertionError: {e}")
            return ServeProbeResult(0.0, float("inf"))
        leading = mesh is not None
        engine.warmup(params)
        return _time_decode(engine, params, n_dispatches=n_dispatches,
                            repeats=repeats)
    except Exception as e:
        if mesh is not None and not leading:
            raise
        return ServeProbeResult(
            0.0, float("inf"), feasible=False,
            error=f"{type(e).__name__}: {str(e)[:200]}")
    finally:
        if leading:
            engine.stop_followers()
        if engine is not None:
            engine.release()
        engine = None
        engine_lib.set_kernel_launch_counts(counts)
        release_memory(device)


def _time_decode(engine, params, *, n_dispatches: int,
                 repeats: int) -> ServeProbeResult:
    """Prefill every slot, then time ``repeats`` runs of
    ``n_dispatches`` decode supersteps at full occupancy; the estimator
    over repeats is the MIN elapsed (host noise is one-sided). A paged
    engine runs on its full-capacity pool (the probe measures the
    program, not a page famine); a speculative one times draft+verify
    dispatches and counts the tokens the verifies emitted — the
    ``lengths`` delta read after the fence, never ``k x dispatches``,
    since crediting rejected drafts would let speculation look free. The
    state it holds dies with the call, before the trial's release."""
    import numpy as np

    from tpudist_torch.serve.scheduler import ngram_draft

    paged = engine.paged
    slots, max_seq, prompt_pad = engine.slots, engine.max_seq, \
        engine.prompt_pad
    spec_k = engine.speculate_k
    # per-slot decode budget must cover every timed dispatch so the
    # whole probe runs at full occupancy (an emptying batch would
    # flatter small decode_k); shrink the dispatch count if the cache
    # cannot hold that many tokens
    width = spec_k if spec_k >= 2 else engine.decode_k
    room = (max_seq - prompt_pad - 1) // width
    n_disp = max(1, min(int(n_dispatches), room))
    budget = n_disp * width + 2
    prompt = np.arange(prompt_pad, dtype=np.int32) \
        % engine.model_cfg.vocab_size

    def fill() -> Any:
        state = engine.init_state()
        if paged:
            engine.new_allocator()
        outs = []
        for s in range(slots):
            if paged:
                engine.alloc.admit(s, prompt_pad)  # full-capacity pool:
                # cannot fail at probe shapes
            state, first = engine.prefill(params, state, prompt[None, :],
                                          prompt_pad, s, budget)
            # fence: on the card the graph's output, which the next
            # prefill overwrites
            outs.append([int(x) for x in prompt] + [int(first)])
        if paged:
            # map every page up front: the probe times dispatch compute,
            # not incremental host allocation
            for s in range(slots):
                engine.alloc.ensure(s, max_seq - 1)
        return state, outs

    def dispatch(state, outs):
        if spec_k >= 2:
            draft = np.zeros((slots, spec_k - 1), np.int32)
            for s in range(slots):
                draft[s] = ngram_draft(outs[s], spec_k - 1)
            state, toks, valid, _ = engine.verify(params, state, draft)
            # fence: the NEXT draft needs these tokens; part of the cost
            tv, vv = toks.cpu().numpy(), valid.cpu().numpy()
            for s in range(slots):
                outs[s].extend(int(x) for x in tv[vv[:, s], s])
            return state, toks, valid
        return engine.decode(params, state)

    # warm: the timed path's host work once, off the clock
    state, outs = fill()
    state, toks, _ = dispatch(state, outs)
    toks.cpu()
    times: List[float] = []
    tokens = 0
    for _ in range(repeats):
        state, outs = fill()
        len0 = int(state.lengths.sum())   # fence too
        valid_sum = 0
        t0 = time.perf_counter()
        toks = None
        for _ in range(n_disp):
            state, toks, valid = dispatch(state, outs)
            if engine.split:              # host flags, gathered already
                valid_sum += int(valid.sum())
        toks.cpu()                        # fence on the tokens
        times.append(time.perf_counter() - t0)
        # honest token count from the device's own ledger: every emitted
        # token advanced a slot's length by exactly one, a frozen slot's
        # by zero — so an oversized decode_k or a rejected draft can
        # never inflate the estimate. A serve mesh that splits the slots
        # holds rank 0's lengths only: there every rank's valid flags,
        # one a token, count them
        tokens = valid_sum if engine.split \
            else int(state.lengths.sum()) - len0
    best = min(times)
    spread = (max(times) - best) / best if best > 0 else 0.0
    return ServeProbeResult(
        tokens_per_sec=tokens / best if best > 0 else 0.0,
        dispatch_ms=best * 1000.0 / n_disp, spread=spread, tokens=tokens)


@dataclasses.dataclass(frozen=True)
class ServeTuneOutcome:
    """What the serve tuner decided and how it got there."""

    tuned: ServeCandidate
    source: str                   # cache | probe | heuristic
    status: str                   # verdict SUCCESS/FAIL/UNGATEABLE
    trials: int
    pruned: int
    fingerprint: str
    cache_dir: str
    tokens_per_sec: Optional[float] = None
    baseline_tokens_per_sec: Optional[float] = None


def _search(measure, start: ServeCandidate, *, max_decode_k: int,
            trial_budget: int,
            max_page_tokens: int = 0) -> Dict[str, Any]:
    """Deterministic axis walk sharing the train search's discipline:
    decode_k first (ordered ascent, regress early-stop,
    plateau-prefers-smallest within PLATEAU_TOL — shorter supersteps
    mean honester ITL at indistinguishable throughput), then layout at
    the committed decode_k (best wins; ties keep the start's layout),
    then the paged axes: ``kv_page_tokens`` (a real win over the
    committed point switches storage discipline; a tie keeps it — the
    dense arena is the simpler program) and, only at a committed page
    size, ``speculate_k`` (same real-win bar: acceptance-rate-dependent
    speedups must MEASURE, never be assumed). The committed point NEVER
    measures slower than the start."""
    memo: Dict[ServeCandidate, ServeProbeResult] = {}
    out = {"best": start, "best_tps": 0.0, "baseline_tps": 0.0,
           "trials": 0, "pruned": 0}

    def run(cand: ServeCandidate) -> Optional[ServeProbeResult]:
        if cand in memo:
            return memo[cand]
        if out["trials"] >= trial_budget:
            return None
        res = measure(cand)
        out["trials"] += 1
        if not res.feasible:
            out["pruned"] += 1
        memo[cand] = res
        return res

    base = run(start)
    if base is not None and base.feasible:
        out["baseline_tps"] = out["best_tps"] = base.tokens_per_sec

    ladder = [k for k in DECODE_K_LADDER if k <= max_decode_k]
    if start.decode_k not in ladder:
        ladder = sorted(set(ladder) | {start.decode_k})
    measured = [(start.decode_k, out["best_tps"])] \
        if out["best_tps"] > 0 else []
    prev: Optional[float] = None   # previous LADDER point, scan order —
    # comparing each k against the (possibly mid-ladder) start would
    # false-trigger the regress stop on the very first rung
    for k in ladder:
        if k == start.decode_k:
            prev = out["best_tps"] or prev
            continue
        res = run(start.replace(decode_k=k))
        if res is None:
            break
        if not res.feasible:
            break                # bigger supersteps cannot refit memory
        measured.append((k, res.tokens_per_sec))
        if prev is not None and res.tokens_per_sec \
                < prev * (1 - search_mod.REGRESS_STOP):
            break                # past the plateau, curve turned down
        prev = res.tokens_per_sec
    if measured:
        axis_best = max(t for _, t in measured)
        for k, tps in sorted(measured):
            if tps >= axis_best * (1 - search_mod.PLATEAU_TOL):
                out["best"] = out["best"].replace(decode_k=k)
                out["best_tps"] = tps
                break

    for layout in KV_CACHE_LAYOUTS:
        if layout == out["best"].layout:
            continue
        res = run(out["best"].replace(layout=layout))
        if res is None or not res.feasible:
            continue
        if res.tokens_per_sec > out["best_tps"] * (
                1 + search_mod.PLATEAU_TOL):
            out["best"] = out["best"].replace(layout=layout)
            out["best_tps"] = res.tokens_per_sec

    # ---- the paged axes ----
    if max_page_tokens > 0:
        for pt in KV_PAGE_TOKENS_LADDER:
            if pt > max_page_tokens \
                    or pt == out["best"].kv_page_tokens:
                continue
            # page size probes without speculation: one axis at a time
            res = run(out["best"].replace(kv_page_tokens=pt,
                                          speculate_k=0))
            if res is None or not res.feasible:
                continue
            if res.tokens_per_sec > out["best_tps"] * (
                    1 + search_mod.PLATEAU_TOL):
                out["best"] = out["best"].replace(kv_page_tokens=pt,
                                                  speculate_k=0)
                out["best_tps"] = res.tokens_per_sec
        if out["best"].kv_page_tokens > 0:
            for sk in SPECULATE_K_LADDER:
                if sk == out["best"].speculate_k:
                    continue
                res = run(out["best"].replace(speculate_k=sk))
                if res is None or not res.feasible:
                    continue
                if res.tokens_per_sec > out["best_tps"] * (
                        1 + search_mod.PLATEAU_TOL):
                    out["best"] = out["best"].replace(speculate_k=sk)
                    out["best_tps"] = res.tokens_per_sec

    # the hard floor: never commit a point slower than the measured start
    if out["best"] != start and out["best_tps"] < out["baseline_tps"]:
        out["best"], out["best_tps"] = start, out["baseline_tps"]
    return out


def autotune_serve(model_cfg, device, params, *, slots: int, max_seq: int,
                   prompt_pad: int, mode: str, cache_dir: str,
                   start: Optional[ServeCandidate] = None,
                   trials: int = DEFAULT_TRIALS,
                   n_dispatches: int = DEFAULT_PROBE_DISPATCHES,
                   repeats: int = DEFAULT_PROBE_REPEATS,
                   dtype=torch.float32,
                   metrics: Any = None, mesh=None) -> ServeTuneOutcome:
    """Resolve the serve operating point per ``mode`` (``off`` |
    ``probe`` | ``cache-only``), as the train tuner does: a cache hit
    costs zero trials; a miss under ``probe`` runs the measured search
    and persists it; a miss under ``cache-only`` (or a probing failure)
    keeps the heuristic start, honestly labelled. On a serve ``mesh``
    every rank calls it: rank 0's cache decision and each trial's
    measurement are broadcast (the train tuner's ``_sync_candidate`` /
    ``_sync_result``), so every rank commits rank 0's candidate; only
    rank 0 writes the cache, and a follower's failure fails its run."""
    start = start or ServeCandidate()
    fp = fingerprint(model_cfg, device, slots=slots, max_seq=max_seq,
                     prompt_pad=prompt_pad, dtype=dtype, mesh=mesh)
    lead = mesh is None or torch.distributed.get_rank() == 0
    if mode == "off":
        return _log(ServeTuneOutcome(
            tuned=start, source="heuristic",
            status=verdict_lib.tuning_status("off"), trials=0, pruned=0,
            fingerprint=fp, cache_dir=cache_dir), metrics)

    rec = cache_mod.load(cache_dir, fp, prefix="serve",
                         validate=validate_serve_tuned) if lead else None
    tuned = None
    if rec is not None:
        t = rec["tuned"]
        tuned = ServeCandidate(decode_k=int(t["decode_k"]),
                               layout=t["layout"],
                               kv_page_tokens=int(t["kv_page_tokens"]),
                               speculate_k=int(t["speculate_k"]))
        if tuned.decode_k > max_seq - prompt_pad:
            tuned = None
    tuned = _sync_candidate(tuned)
    if tuned is not None:
        rec = rec or {}                  # a follower has no record
        return _log(ServeTuneOutcome(
            tuned=tuned, source="cache",
            status=verdict_lib.tuning_status(mode, source="cache"),
            trials=0, pruned=0, fingerprint=fp, cache_dir=cache_dir,
            tokens_per_sec=rec.get("tokens_per_sec"),
            baseline_tokens_per_sec=rec.get("baseline_tokens_per_sec")),
            metrics)

    if mode != "probe":
        return _log(ServeTuneOutcome(
            tuned=start, source="heuristic",
            status=verdict_lib.tuning_status(mode, source="heuristic"),
            trials=0, pruned=0, fingerprint=fp, cache_dir=cache_dir),
            metrics)

    def measure(cand: ServeCandidate) -> ServeProbeResult:
        return _sync_result(probe_candidate(
            model_cfg, device, params, cand, slots=slots, max_seq=max_seq,
            prompt_pad=prompt_pad, dtype=dtype, n_dispatches=n_dispatches,
            repeats=repeats, mesh=mesh))

    try:
        out = _search(measure, start,
                      max_decode_k=max(1, max_seq - prompt_pad - 1),
                      trial_budget=trials,
                      max_page_tokens=max_seq)
    except Exception as e:
        if not lead:
            raise
        from tpudist_torch.metrics import log0
        log0(f"tpudist: serve autotune probing failed ({e!r}); "
             f"falling back to heuristics")
        return _log(ServeTuneOutcome(
            tuned=start, source="heuristic",
            status=verdict_lib.tuning_status(mode, source="heuristic"),
            trials=0, pruned=0, fingerprint=fp, cache_dir=cache_dir),
            metrics)

    status = verdict_lib.tuning_status(
        mode, source="probe", tuned_steps_per_sec=out["best_tps"],
        baseline_steps_per_sec=out["baseline_tps"])
    if lead:
        cache_mod.store(cache_dir, fp, {
            "tuned": out["best"].as_dict(),
            "tokens_per_sec": out["best_tps"],
            "baseline_tokens_per_sec": out["baseline_tps"],
            "trials": out["trials"], "pruned": out["pruned"],
        }, prefix="serve")
    return _log(ServeTuneOutcome(
        tuned=out["best"], source="probe", status=status,
        trials=out["trials"], pruned=out["pruned"], fingerprint=fp,
        cache_dir=cache_dir, tokens_per_sec=out["best_tps"],
        baseline_tokens_per_sec=out["baseline_tps"]), metrics)


def _sync_candidate(cand: Optional[ServeCandidate]
                    ) -> Optional[ServeCandidate]:
    """Rank 0's cache decision (its hit, or None) on every rank of a
    serve mesh; the value as given in one process."""
    dec = _broadcast([-1.0] * 4 if cand is None else [
        float(cand.decode_k), float(KV_CACHE_LAYOUTS.index(cand.layout)),
        float(cand.kv_page_tokens), float(cand.speculate_k)])
    if dec[0] < 0:
        return None
    return ServeCandidate(decode_k=int(dec[0]),
                          layout=KV_CACHE_LAYOUTS[int(dec[1])],
                          kv_page_tokens=int(dec[2]),
                          speculate_k=int(dec[3]))


def _sync_result(res: ServeProbeResult) -> ServeProbeResult:
    """Rank 0's measurement of a trial on every rank of a serve mesh, so
    every rank's search takes the same steps (one process: as given)."""
    dec = _broadcast([1.0 if res.feasible else 0.0, res.tokens_per_sec,
                      res.dispatch_ms, res.spread, float(res.tokens)])
    return dataclasses.replace(
        res, feasible=dec[0] > 0.5, tokens_per_sec=dec[1],
        dispatch_ms=dec[2], spread=dec[3], tokens=int(dec[4]))


def _log(out: ServeTuneOutcome, metrics: Any) -> ServeTuneOutcome:
    """One ``kind=serve_tune`` record per tuning decision."""
    if metrics is not None:
        metrics.log(kind="serve_tune", status=out.status,
                    source=out.source, trials=out.trials,
                    pruned=out.pruned, fingerprint=out.fingerprint,
                    decode_k=out.tuned.decode_k, layout=out.tuned.layout,
                    kv_page_tokens=out.tuned.kv_page_tokens,
                    speculate_k=out.tuned.speculate_k,
                    tokens_per_sec=out.tokens_per_sec,
                    baseline_tokens_per_sec=out.baseline_tokens_per_sec)
    return out
