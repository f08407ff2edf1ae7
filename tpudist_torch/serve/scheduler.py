"""Continuous batching: seeded arrivals, slot admission, SLO accounting.

Counterpart of the dense path of ``tpudist/serve/scheduler.py`` (no
admission control, no chaos, no paged engine, no speculation). Requests
arrive on a seeded open-loop Poisson schedule, queue until a slot frees,
prefill into the free slot, and decode continuously: every dispatch is
one superstep over the WHOLE slot batch, with completed slots freed and
refilled between dispatches.

Latency accounting happens here because only the host sees the request
clock: TTFT spans arrival → the fenced prefill that produced the first
token (queue wait included); ITL attributes each token in a decode
dispatch ``dispatch_wall / decode_k`` (see :mod:`tpudist_torch.serve.slo`).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np

from tpudist_torch import rules as rules_lib
from tpudist_torch.serve import slo as slo_lib
from tpudist_torch.serve.engine import ServeEngine

# per-request outcome events (the JAX package's resilience vocabulary)
ADMITTED = "admitted"
DONE = "done"
EVICTED = "evicted"

TICK_EVERY = 8           # dispatches between kind=serve_tick records
N_CHIPS = 1


@dataclasses.dataclass(frozen=True)
class Request:
    """One synthetic inference request."""

    rid: int
    arrival_s: float          # offset from run start
    tokens: np.ndarray        # (prompt_pad,) int32, padded prompt
    prompt_len: int
    max_new: int


def make_requests(n: int, *, prompt_pad: int, vocab_size: int,
                  max_new: int, rate: float, seed: int,
                  prompt_min: int = 0) -> List[Request]:
    """Seeded synthetic request stream, bitwise the JAX package's.

    Arrivals: Poisson process at ``rate`` requests/s; ``rate <= 0``
    means every request is present at t=0 (closed loop). Prompts follow
    the deterministic next-token chain ``t -> (7 t + 3) % vocab`` from a
    seeded first token, with lengths drawn from [prompt_min,
    prompt_pad] (prompt_min defaults to prompt_pad // 2)."""
    rng = np.random.default_rng(seed)
    if rate > 0:
        arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n))
    else:
        arrivals = np.zeros(n)
    prompt_min = min(max(1, prompt_min or prompt_pad // 2), prompt_pad)
    lens = rng.integers(prompt_min, prompt_pad + 1, size=n)
    first = rng.integers(0, vocab_size, size=(n, 1)).astype(np.int32)
    toks = np.empty((n, prompt_pad), np.int32)
    toks[:, :1] = first
    for t in range(1, prompt_pad):
        toks[:, t] = (toks[:, t - 1] * 7 + 3) % vocab_size
    out = []
    for i in range(n):
        padded = toks[i].copy()
        padded[lens[i]:] = 0     # pad-token tail, masked by prompt_len
        out.append(Request(rid=i, arrival_s=float(arrivals[i]),
                           tokens=padded, prompt_len=int(lens[i]),
                           max_new=int(max_new)))
    return out


@dataclasses.dataclass
class _Slot:
    req: Request
    generated: int
    first_token_s: float
    output: List[int]


def run_serve(engine: ServeEngine, params, requests: List[Request], *,
              metrics: Any = None) -> Dict[str, Any]:
    """Drive the engine over the request stream; returns the run summary
    (percentiles, throughput, per-gate SLO statuses, per-request
    results).

    Warm the engine first (:meth:`ServeEngine.warmup`) so the request
    clock never pays the kernel build. ``metrics`` (a MetricsLogger)
    receives ``kind=serve_tick`` records every ``TICK_EVERY`` dispatches
    and per-request ``kind=serve_request`` outcome events; the caller
    logs the final ``kind=serve`` summary. One engine drives one card,
    so throughput per chip is throughput."""
    stats = slo_lib.LatencyStats()
    pending = deque(sorted(requests, key=lambda r: (r.arrival_s, r.rid)))
    waiting: deque = deque()         # arrived, not yet slotted
    slots: List[Optional[_Slot]] = [None] * engine.slots
    state = engine.init_state()
    results: Dict[int, Dict[str, Any]] = {}
    generated = truncated = dispatches = arrived = admitted = 0
    active_peak = 0
    queue_depths: List[int] = []
    t0 = time.perf_counter()

    def now() -> float:
        return time.perf_counter() - t0

    def event(rid: int, ev: str, **kw: Any) -> None:
        if metrics is not None:
            metrics.log(kind="serve_request", rid=rid, event=ev,
                        t_s=round(now(), 6), **kw)

    def finish(i: int, why: str) -> None:
        nonlocal truncated
        s = slots[i]
        t_done = now()     # ONE sample: results/stats/event agree
        results[s.req.rid] = {
            "tokens": list(s.output), "prompt_len": s.req.prompt_len,
            "generated": s.generated, "why": why,
            "e2e_s": t_done - s.req.arrival_s}
        stats.note_e2e(t_done - s.req.arrival_s)
        if why == "evicted":
            truncated += 1
        event(s.req.rid, DONE if why == "done" else EVICTED, slot=i,
              generated=s.generated,
              e2e_s=round(t_done - s.req.arrival_s, 6),
              decode_s=round(t_done - s.first_token_s, 6))
        slots[i] = None

    def pump(t: float) -> None:
        nonlocal arrived
        while pending and pending[0].arrival_s <= t:
            waiting.append(pending.popleft())
            arrived += 1

    def admit() -> None:
        nonlocal generated, state, admitted
        t = now()
        pump(t)
        for i in range(engine.slots):
            if slots[i] is not None or not waiting:
                continue
            req = waiting.popleft()
            state, first = engine.prefill(params, state,
                                          req.tokens[None, :],
                                          req.prompt_len, i, req.max_new)
            first = int(first)           # fence: the token exists NOW
            t_first = now()
            admitted += 1
            event(req.rid, ADMITTED, slot=i,
                  waited_s=round(t_first - req.arrival_s, 6),
                  queue_wait_s=round(t - req.arrival_s, 6),
                  prefill_s=round(t_first - t, 6))
            stats.note_ttft(t_first - req.arrival_s)
            generated += 1
            slots[i] = _Slot(req=req, generated=1, first_token_s=t_first,
                             output=[first])
            if req.max_new <= 1 or req.prompt_len >= engine.max_seq:
                finish(i, "done" if req.max_new <= 1 else "evicted")
            t = now()
            pump(t)        # arrivals that landed during the prefill

    while len(results) < len(requests):
        admit()
        occupied = [i for i in range(engine.slots) if slots[i] is not None]
        if not occupied:
            if waiting:
                # every slot finished inside this admit pass: admit again
                continue
            if pending:
                # nothing running and nothing queued: wait out the gap
                # to the next scheduled arrival
                time.sleep(min(0.002, max(0.0,
                                          pending[0].arrival_s - now())))
                continue
            break
        queue_depths.append(len(waiting))
        t_dispatch = time.perf_counter()
        state, toks, valid = engine.decode(params, state)
        toks = toks.cpu().numpy()          # fence: tokens on host
        valid = valid.cpu().numpy()
        dt = time.perf_counter() - t_dispatch
        dispatches += 1
        active_peak = max(active_peak, len(occupied))
        per_tok = dt / engine.decode_k
        for i in occupied:
            col_valid = valid[:, i]
            n_new = int(col_valid.sum())
            if n_new:
                slots[i].output.extend(int(t) for t in toks[col_valid, i])
                slots[i].generated += n_new
                generated += n_new
                stats.note_itl(per_tok, n_new)
            s = slots[i]
            if s.generated >= s.req.max_new:
                finish(i, "done")
            elif s.req.prompt_len + s.generated > engine.max_seq:
                # aligned with the device freeze (lengths >= max_seq):
                # the slot is evicted exactly when its cache row filled
                finish(i, "evicted")
        if metrics is None or dispatches % TICK_EVERY != 0:
            continue
        summ = stats.summary()
        wall = now()
        metrics.log(kind="serve_tick", t_s=round(wall, 4),
                    queue_depth=len(waiting),
                    active_slots=sum(s is not None for s in slots),
                    completed=len(results), generated_tokens=generated,
                    decode_k=engine.decode_k,
                    ttft_p99_s=summ["ttft_p99_s"],
                    itl_p99_s=summ["itl_p99_s"],
                    tokens_per_sec_per_chip=(
                        round(generated / wall / N_CHIPS, 3)
                        if wall > 0 else None))

    wall_s = now()
    # an empty run measured NOTHING: throughput is None (the gate grades
    # UNGATEABLE), not a 0.0 that would read as an SLO fail
    tps = (generated / wall_s) if generated and wall_s > 0 else None
    tps_chip = tps / N_CHIPS if tps is not None else None
    summ = stats.summary()
    grade = slo_lib.grade(summ["ttft_p99_s"], summ["itl_p99_s"], tps_chip)
    return {
        "requests": len(requests), "completed": len(results),
        "generated_tokens": generated, "truncated": truncated,
        "wall_s": round(wall_s, 4), "dispatches": dispatches,
        "slots": engine.slots, "decode_k": engine.decode_k,
        "kv_layout": engine.layout,
        "tokens_per_sec": round(tps, 3) if tps is not None else None,
        "tokens_per_sec_per_chip": (round(tps_chip, 3)
                                    if tps_chip is not None else None),
        "n_chips": N_CHIPS,
        "queue_depth_max": max(queue_depths, default=0),
        "queue_depth_mean": (round(float(np.mean(queue_depths)), 3)
                             if queue_depths else 0.0),
        "arrived": arrived, "admitted": admitted,
        **{k: (round(v, 6) if v is not None else None)
           for k, v in summ.items()},
        **grade,
        "active_slots_peak": active_peak,
        "results": results,
        "thresholds": {rule: rules_lib.resolve(rule)
                       for rule, _ in slo_lib.SERVE_RULES},
    }
