"""Continuous batching: seeded arrivals, admission control, slot
admission, SLO accounting.

Counterpart of the dense path of ``tpudist/serve/scheduler.py`` (no
chaos, no paged engine, no speculation). Requests arrive on a
seeded open-loop Poisson schedule, pass ADMISSION CONTROL (bounded
queue, per-request TTFT deadlines, malformed-request rejection —
:mod:`tpudist_torch.serve.resilience`), queue until a slot frees,
prefill into the free slot, and decode continuously: every dispatch is
one superstep over the WHOLE slot batch, with completed slots freed and
refilled between dispatches. Under pressure the controller walks
``decode_k`` down the engine's ladder of captured programs.

Every arrival lands in exactly one ledger bucket (``arrived == admitted
+ shed_at_admission + expired_in_queue + rejected``, checked exactly),
and every shed/expiry decision reads ONE clock sample per scheduler
boundary, so the seeded schedule sheds the same requests every run
(bitwise, under virtual time).

Latency accounting happens here because only the host sees the request
clock: TTFT spans arrival → the fenced prefill that produced the first
token (queue wait included); ITL attributes each token in a decode
dispatch ``dispatch_wall / decode_k`` (see :mod:`tpudist_torch.serve.slo`).

Every request's lifecycle also lands on the span tracer
(:mod:`tpudist_torch.obs.trace`, ``cat=serve``, keyed by ``rid``), with
the JAX scheduler's names and fields: an ``arrive`` instant, one instant
per admission verdict and outcome, ``admit`` and ``prefill`` spans, a
``decode_step`` span a dispatch and a ``decode_emit`` instant per slot;
the JAX package's flight verifier (``tpudist.serve.flight``) folds them
with the ``kind=serve_request`` stream.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from tpudist_torch import rules as rules_lib
from tpudist_torch.obs import trace as trace_lib
from tpudist_torch.serve import resilience as res_lib
from tpudist_torch.serve import slo as slo_lib
from tpudist_torch.serve.engine import ServeEngine

N_CHIPS = 1              # one engine drives one card


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


def validate_request(req: Request, *, prompt_pad: int,
                     vocab_size: int) -> Optional[str]:
    """Admission-time request validation: the reason a malformed
    request is rejected, or None for a well-formed one. The engine's
    prefill program assumes a (prompt_pad,) integer prompt with an
    in-range true length and a positive budget; anything else is turned
    away here, never handed to the engine."""
    pl, mn = req.prompt_len, req.max_new
    if not isinstance(pl, (int, np.integer)) or not (0 < pl <= prompt_pad):
        return "bad_prompt_len"
    if not isinstance(mn, (int, np.integer)) or mn < 1:
        return "bad_max_new"
    try:
        toks = np.asarray(req.tokens)
    except (TypeError, ValueError):
        return "bad_tokens"
    if toks.shape != (prompt_pad,):
        return "bad_shape"
    if not np.issubdtype(toks.dtype, np.integer):
        return "bad_dtype"
    if ((toks[:pl] < 0) | (toks[:pl] >= vocab_size)).any():
        return "bad_token"
    return None


@dataclasses.dataclass
class _Slot:
    req: Request
    generated: int
    first_token_s: float
    output: List[int]
    budget: int               # max_new after any adapt-time truncation


def run_serve(engine: ServeEngine, params, requests: List[Request], *,
              metrics: Any = None, tick_every: int = 8,
              clock: Callable[[], float] = time.perf_counter,
              resilience: Optional[res_lib.ResilienceConfig] = None,
              virtual: Optional[res_lib.VirtualTiming] = None
              ) -> Dict[str, Any]:
    """Drive the engine over the request stream; returns the run summary
    (percentiles, throughput, per-gate SLO statuses, the exact shed
    partition, program counts, per-request results).

    Warm the engine first (:meth:`ServeEngine.warmup`) so the request
    clock never pays a kernel build or a capture. ``metrics`` (a
    MetricsLogger) receives ``kind=serve_tick`` records every
    ``tick_every`` dispatches, per-request ``kind=serve_request`` outcome
    events and a flushed ``kind=serve_adapt`` record at every ladder
    move; the caller logs the final ``kind=serve`` summary.

    ``resilience`` turns on admission control and degradation
    (:class:`~tpudist_torch.serve.resilience.ResilienceConfig`; None
    keeps the open-loop behaviour). ``virtual`` switches the request
    clock to deterministic virtual time
    (:class:`~tpudist_torch.serve.resilience.VirtualTiming`): each
    prefill advances it ``prefill_s``, each dispatch ``decode_s``. One
    engine drives one card, so throughput per chip is throughput."""
    res = resilience or res_lib.ResilienceConfig()
    if virtual is not None:
        clock = virtual.clock
    flush_events = res.enabled
    tracer = trace_lib.get()
    stats = slo_lib.LatencyStats()
    led = res_lib.ShedLedger()
    controller = None
    if res.adapt and len(engine.ladder) > 1:
        controller = res_lib.PressureController(
            res, max_level=len(engine.ladder) - 1)
    cur_level = 0
    cur_k = engine.ladder[0]
    pending = deque(sorted(requests, key=lambda r: (r.arrival_s, r.rid)))
    waiting: deque = deque()         # accepted, not yet slotted
    slots: List[Optional[_Slot]] = [None] * engine.slots
    state = engine.init_state()
    results: Dict[int, Dict[str, Any]] = {}
    generated = truncated = dispatches = 0
    active_peak = 0
    queue_depths: List[int] = []
    recent_tok: deque = deque(maxlen=max(res.window, 1))
    t0 = clock()

    def now() -> float:
        return clock() - t0

    def event(rid: int, ev: str, **kw: Any) -> None:
        # every outcome is also a lifecycle instant, from the same call
        # site: the flight verifier cross-checks the two streams
        tracer.instant(ev, cat="serve", rid=rid, **kw)
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
            "adapt_truncated": s.budget < s.req.max_new,
            "e2e_s": t_done - s.req.arrival_s}
        stats.note_e2e(t_done - s.req.arrival_s)
        if why == "evicted":
            truncated += 1
            led.evicted += 1
        else:
            led.completed += 1
        event(s.req.rid, res_lib.DONE if why == "done" else
              res_lib.EVICTED, slot=i, generated=s.generated,
              e2e_s=round(t_done - s.req.arrival_s, 6),
              decode_s=round(t_done - s.first_token_s, 6))
        slots[i] = None

    def expire(t: float) -> None:
        # the accepted queue's head is always the oldest (FIFO in
        # arrival order), so deadline expiry only ever pops from there
        while waiting and t - waiting[0].arrival_s \
                > res.ttft_deadline_s:
            r = waiting.popleft()
            led.expired_queue += 1
            event(r.rid, res_lib.EXPIRED,
                  waited_s=round(t - r.arrival_s, 6))

    def pump(t: float) -> None:
        """Admission control at ONE sampled time ``t``: first expire the
        deadline-aged queue heads, THEN judge arrivals against the
        post-expiry queue, so a fresh arrival is never shed at the cap
        by requests already dead at the same instant. An arrival whose
        own deadline passed in the schedule backlog counts expired, not
        shed. No clock reads in here."""
        if res.ttft_deadline_s > 0:
            expire(t)
        while pending and pending[0].arrival_s <= t:
            req = pending.popleft()
            led.arrived += 1
            # the flight chain's opening marker, one an arrived rid
            tracer.instant("arrive", cat="serve", rid=req.rid,
                           arrival_s=round(req.arrival_s, 6),
                           prompt_len=req.prompt_len)
            why = validate_request(
                req, prompt_pad=engine.prompt_pad,
                vocab_size=engine.model_cfg.vocab_size) \
                if res.validate else None
            if why is not None:
                led.rejected += 1
                event(req.rid, res_lib.REJECTED, reason=why)
            elif res.ttft_deadline_s > 0 \
                    and t - req.arrival_s > res.ttft_deadline_s:
                led.expired_queue += 1
                event(req.rid, res_lib.EXPIRED,
                      waited_s=round(t - req.arrival_s, 6))
            elif res.queue_cap and len(waiting) >= res.queue_cap:
                led.shed_admission += 1
                event(req.rid, res_lib.SHED, queue_depth=len(waiting))
            else:
                waiting.append(req)

    def admit() -> None:
        nonlocal generated, state
        t = now()
        pump(t)
        for i in range(engine.slots):
            if slots[i] is not None or not waiting:
                continue
            req = waiting.popleft()
            budget = req.max_new
            if cur_level > 0 and res.max_new_cap:
                budget = min(budget, res.max_new_cap)
            with tracer.span("admit", cat="serve", rid=req.rid, slot=i):
                pass   # the admission decision itself is host-trivial
            with tracer.span("prefill", cat="serve", rid=req.rid, slot=i,
                             prompt_len=req.prompt_len):
                state, first = engine.prefill(params, state,
                                              req.tokens[None, :],
                                              req.prompt_len, i, budget)
                first = int(first)       # fence: the token exists NOW
            if virtual is not None:
                virtual.clock.advance(virtual.prefill_s)
            t_first = now()
            led.admitted += 1
            event(req.rid, res_lib.ADMITTED, slot=i,
                  waited_s=round(t_first - req.arrival_s, 6),
                  queue_wait_s=round(t - req.arrival_s, 6),
                  prefill_s=round(t_first - t, 6))
            stats.note_ttft(t_first - req.arrival_s)
            generated += 1
            slots[i] = _Slot(req=req, generated=1, first_token_s=t_first,
                             output=[first], budget=budget)
            if budget <= 1 or req.prompt_len >= engine.max_seq:
                finish(i, "done" if budget <= 1 else "evicted")
            t = now()
            pump(t)        # arrivals that landed during the prefill

    while len(results) + led.shed_total() < len(requests):
        admit()
        occupied = [i for i in range(engine.slots) if slots[i] is not None]
        if not occupied:
            if waiting:
                # every slot FINISHED inside this admit pass (an instant
                # budget <= 1 completion): admit again before any wait,
                # or a clock warp would expire servable queued requests
                continue
            if pending:
                # nothing running and nothing queued: wait out the gap
                # to the next scheduled arrival
                if virtual is not None:
                    virtual.clock.wait_until(t0 + pending[0].arrival_s)
                else:
                    time.sleep(min(0.002, max(
                        0.0, pending[0].arrival_s - now())))
                continue
            break
        # depth sampled once per DISPATCH, not per idle pass
        queue_depths.append(len(waiting))
        t_dispatch = clock()
        with tracer.span("decode_step", cat="serve",
                         active=len(occupied), decode_k=cur_k):
            state, toks, valid = engine.decode(params, state, cur_k)
            toks = toks.cpu().numpy()      # fence: tokens on host
            valid = valid.cpu().numpy()
        if virtual is not None:
            dt = virtual.decode_s
            virtual.clock.advance(dt)
        else:
            dt = clock() - t_dispatch
        dispatches += 1
        active_peak = max(active_peak, len(occupied))
        per_tok = dt / cur_k
        recent_tok.append(per_tok)
        for i in occupied:
            col_valid = valid[:, i]
            n_new = int(col_valid.sum())
            if n_new:
                slots[i].output.extend(int(t) for t in toks[col_valid, i])
                slots[i].generated += n_new
                generated += n_new
                stats.note_itl(per_tok, n_new)
            s = slots[i]
            # per-slot decode attribution: the flight verifier sums these
            # per rid against the terminal event's generated count
            tracer.instant("decode_emit", cat="serve", rid=s.req.rid,
                           slot=i, tokens=n_new, dispatch=dispatches)
            if s.generated >= s.budget:
                finish(i, "done")
            elif s.req.prompt_len + s.generated > engine.max_seq:
                # aligned with the device freeze (lengths >= max_seq):
                # the slot is evicted exactly when its cache row filled
                finish(i, "evicted")
        # SLO grading and the controller on the tick cadence: summary()
        # sorts every sample, host work that would inflate the ITL
        if dispatches % max(tick_every, 1) != 0:
            continue
        if flush_events and metrics is not None:
            metrics.flush()
        summ = stats.summary()
        if controller is not None:
            recent_itl = (sum(recent_tok) / len(recent_tok)
                          if recent_tok else None)
            trans = controller.observe(len(waiting), recent_itl)
            if trans is not None:
                frm, to, reason = trans
                cur_level = to
                cur_k = engine.ladder[min(to, len(engine.ladder) - 1)]
                if metrics is not None:
                    metrics.log(kind="serve_adapt",
                                t_s=round(now(), 4), from_level=frm,
                                to_level=to, decode_k=cur_k,
                                queue_depth=len(waiting),
                                reason=reason)
                    metrics.flush()
        if metrics is not None:
            wall = now()
            metrics.log(kind="serve_tick", t_s=round(wall, 4),
                        queue_depth=len(waiting),
                        active_slots=sum(s is not None for s in slots),
                        completed=len(results),
                        generated_tokens=generated,
                        shed_total=led.shed_total(),
                        shed_fraction=led.shed_fraction(),
                        adapt_level=cur_level,
                        decode_k=cur_k,
                        ttft_p99_s=summ["ttft_p99_s"],
                        itl_p99_s=summ["itl_p99_s"],
                        tokens_per_sec_per_chip=(
                            round(generated / wall / N_CHIPS, 3)
                            if wall > 0 else None),
                        ttft_hist=stats.ttft_hist(),
                        itl_hist=stats.itl_hist())

    wall_s = now()
    # an empty run measured NOTHING: throughput is None (the gate grades
    # UNGATEABLE), not a 0.0 that would read as an SLO fail
    tps = (generated / wall_s) if generated and wall_s > 0 else None
    tps_chip = tps / N_CHIPS if tps is not None else None
    summ = stats.summary()
    grade = slo_lib.grade(summ["ttft_p99_s"], summ["itl_p99_s"], tps_chip,
                          shed_fraction=led.shed_fraction())
    prefill_compiles, decode_compiles = engine.compile_counts()
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
        # the exact shed partition (headline fields lifted; the full
        # checked block under "partition")
        "arrived": led.arrived, "admitted": led.admitted,
        "shed_at_admission": led.shed_admission,
        "expired_in_queue": led.expired_queue,
        "rejected": led.rejected, "lost": led.lost,
        "shed_total": led.shed_total(),
        "shed_fraction": led.shed_fraction(),
        "partition": led.as_dict(),
        "queue_cap": res.queue_cap,
        "ttft_deadline_s": res.ttft_deadline_s,
        "adapt_level": cur_level, "decode_k_current": cur_k,
        "decode_k_ladder": list(engine.ladder),
        "adapt_transitions": (list(controller.transitions)
                              if controller is not None else []),
        **{k: (round(v, 6) if v is not None else None)
           for k, v in summ.items()},
        **grade,
        "prefill_compiles": prefill_compiles,
        "decode_compiles": decode_compiles,
        "active_slots_peak": active_peak,
        "ttft_hist": stats.ttft_hist(),
        "itl_hist": stats.itl_hist(),
        "results": results,
        "thresholds": {rule: rules_lib.resolve(rule)
                       for rule, _ in slo_lib.SERVE_RULES},
    }
