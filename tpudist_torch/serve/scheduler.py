"""Continuous batching: seeded arrivals, admission control, slot
admission, SLO accounting.

Counterpart of ``tpudist/serve/scheduler.py``. Requests arrive on a seeded open-loop Poisson schedule, pass ADMISSION
CONTROL (bounded queue, per-request TTFT deadlines, malformed-request
rejection — :mod:`tpudist_torch.serve.resilience`), queue until a slot
frees, prefill into the free slot, and decode continuously: every
dispatch is one superstep over the WHOLE slot batch, with completed
slots freed and refilled between dispatches. Under pressure the controller walks
``decode_k`` down the engine's ladder of captured programs. A PAGED
engine (:class:`~tpudist_torch.serve.engine.PagedServeEngine`) adds the
page allocator to admission and dispatch, a shared system-prompt prefix
registered once, and n-gram speculation verified by one batched forward.

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

The loop feeds every SLO observation to an
:class:`~tpudist_torch.obs.alerts.AlertEngine` over the shared rules
table, so a breach fires as an alert mid-run, and a chaos plan's serve
surface (:mod:`tpudist_torch.chaos`) at every decode-dispatch boundary.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from tpudist_torch import rules as rules_lib
from tpudist_torch.obs import trace as trace_lib
from tpudist_torch.obs.alerts import AlertEngine
from tpudist_torch.serve import resilience as res_lib
from tpudist_torch.serve import slo as slo_lib
from tpudist_torch.serve.engine import ServeEngine


@dataclasses.dataclass(frozen=True)
class Request:
    """One synthetic inference request."""

    rid: int
    arrival_s: float          # offset from run start
    tokens: np.ndarray        # (prompt_pad,) int32, padded prompt
    prompt_len: int
    max_new: int


def shared_prefix_tokens(prefix_len: int, vocab_size: int,
                         seed: int) -> np.ndarray:
    """The run's shared system-prompt prefix: ``prefix_len`` seeded
    tokens every ``--shared-prefix`` request starts with, bitwise the JAX
    package's. One function, used by both the request generator and the
    engine's prefix registration, so the two agree on the bytes."""
    rng = np.random.default_rng([int(seed), 17])
    return rng.integers(0, vocab_size,
                        size=(int(prefix_len),)).astype(np.int32)


def make_requests(n: int, *, prompt_pad: int, vocab_size: int,
                  max_new: int, rate: float, seed: int,
                  prompt_min: int = 0,
                  prefix_len: int = 0) -> List[Request]:
    """Seeded synthetic request stream, bitwise the JAX package's.

    Arrivals: Poisson process at ``rate`` requests/s; ``rate <= 0``
    means every request is present at t=0 (closed loop). Prompts follow
    the deterministic next-token chain ``t -> (7 t + 3) % vocab`` from a
    seeded first token, with lengths drawn from [prompt_min,
    prompt_pad] (prompt_min defaults to prompt_pad // 2).
    ``prefix_len > 0`` gives every request the same
    :func:`shared_prefix_tokens` prefix (prompt lengths never undercut
    it); ``prefix_len = 0`` is the stream without (the same draws)."""
    rng = np.random.default_rng(seed)
    if rate > 0:
        arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n))
    else:
        arrivals = np.zeros(n)
    prompt_min = min(max(1, prompt_min or prompt_pad // 2), prompt_pad)
    if prefix_len > 0:
        prefix_len = min(int(prefix_len), prompt_pad)
        prompt_min = max(prompt_min, prefix_len)
    lens = rng.integers(prompt_min, prompt_pad + 1, size=n)
    first = rng.integers(0, vocab_size, size=(n, 1)).astype(np.int32)
    toks = np.empty((n, prompt_pad), np.int32)
    toks[:, :1] = first
    for t in range(1, prompt_pad):
        toks[:, t] = (toks[:, t - 1] * 7 + 3) % vocab_size
    if prefix_len > 0:
        # the head becomes the shared prefix; the tail keeps each
        # request's own chain (seeded from its own first token)
        toks[:, :prefix_len] = shared_prefix_tokens(
            prefix_len, vocab_size, seed)[None, :]
    out = []
    for i in range(n):
        padded = toks[i].copy()
        padded[lens[i]:] = 0     # pad-token tail, masked by prompt_len
        out.append(Request(rid=i, arrival_s=float(arrivals[i]),
                           tokens=padded, prompt_len=int(lens[i]),
                           max_new=int(max_new)))
    return out


def ngram_draft(history, k: int) -> List[int]:
    """The host-side draft proposer for speculative decoding: repeat what
    followed the last occurrence of the current token in the sequence so
    far (n-gram lookup, n=1), else the token itself. Deterministic and
    model-free: the verify forward accepts exactly the prefix of the
    draft that matches the greedy choices, so a bad draft costs only its
    acceptance rate."""
    h = [int(t) for t in history]
    out: List[int] = []
    for _ in range(int(k)):
        last = h[-1]
        nxt = last
        for i in range(len(h) - 2, -1, -1):
            if h[i] == last:
                nxt = h[i + 1]
                break
        out.append(nxt)
        h.append(nxt)
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


def make_garbage_requests(plan, event, *, rid_base: int, prompt_pad: int,
                          vocab_size: int, span_s: float
                          ) -> List[Request]:
    """The ``request_garbage`` chaos family's payload, bitwise the JAX
    package's: ``n`` seeded malformed requests spread over the arrival
    window, each broken a deterministically chosen way (out-of-range
    token, zero or oversized prompt_len, dead budget, wrong shape, float
    tokens), drawn from the plan's keyed byte stream, so the same spec
    injects the same garbage every run."""
    from tpudist_torch.chaos import plan as plan_mod
    n = int(event.args.get("n", 4))
    raw = plan_mod.garbage_bytes(plan, event, n=8 * max(n, 1))
    modes = ("bad_token", "zero_len", "over_len", "bad_max_new",
             "bad_shape", "bad_dtype")
    out: List[Request] = []
    for i in range(n):
        chunk = raw[8 * i:8 * i + 8]
        arrival = (int.from_bytes(chunk[:4], "big") / 0xFFFFFFFF) \
            * max(span_s, 0.0)
        mode = modes[chunk[4] % len(modes)]
        tokens = np.zeros((prompt_pad,), np.int32)
        prompt_len, max_new = max(1, prompt_pad // 2), 4
        if mode == "bad_token":
            tokens[0] = vocab_size + 1 + chunk[5]
        elif mode == "zero_len":
            prompt_len = 0
        elif mode == "over_len":
            prompt_len = prompt_pad + 1 + chunk[5] % 8
        elif mode == "bad_max_new":
            max_new = -int(chunk[5])
        elif mode == "bad_shape":
            tokens = np.zeros((prompt_pad + 3,), np.int32)
        elif mode == "bad_dtype":
            tokens = np.zeros((prompt_pad,), np.float64) + 0.5
        out.append(Request(rid=rid_base + i, arrival_s=float(arrival),
                           tokens=tokens, prompt_len=prompt_len,
                           max_new=max_new))
    return out


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
              chaos: Any = None,
              virtual: Optional[res_lib.VirtualTiming] = None,
              flush_events: Optional[bool] = None,
              shared_prefix: Optional[np.ndarray] = None
              ) -> Dict[str, Any]:
    """Drive the engine over the request stream; returns the run summary
    (percentiles, throughput, per-gate SLO statuses, the exact shed
    partition, program counts, alert transitions, per-request results).

    Warm the engine first (:meth:`ServeEngine.warmup`) so the request
    clock never pays a kernel build or a capture. ``metrics`` (a
    MetricsLogger) receives ``kind=serve_tick`` records every
    ``tick_every`` dispatches, per-request ``kind=serve_request`` outcome
    events and a flushed ``kind=serve_adapt`` record at every ladder
    move; the caller logs the final ``kind=serve`` summary.

    ``resilience`` turns on admission control and degradation
    (:class:`~tpudist_torch.serve.resilience.ResilienceConfig`; None
    keeps the open-loop behaviour). ``chaos`` is a
    :class:`~tpudist_torch.chaos.inject.ChaosRuntime` whose serve surface
    (``on_serve_dispatch``) fires before every decode dispatch; a stall
    it injects is added to that dispatch's time on either clock.
    ``virtual`` switches the request clock to deterministic virtual time
    (:class:`~tpudist_torch.serve.resilience.VirtualTiming`): each
    prefill advances it ``prefill_s``, each dispatch ``decode_s``.
    ``flush_events`` arms BOUNDARY flushes of the buffered per-request
    outcome events, before every chaos hook and on the tick cadence, so
    a kill cannot eat the evidence a resumed attempt classifies from
    (default: on when chaos or resilience is armed; the CLI also arms it
    under requeue supervision). Throughput per chip divides by the
    engine's cards (``engine.n_chips``: a serve mesh's, else 1).

    A PAGED engine (``engine.paged``) changes admission and dispatch,
    never the accounting: admission also asks the page allocator (a pool
    too full RIGHT NOW leaves the request waiting: backpressure, not
    shedding; a request too big to EVER fit is ``rejected`` with reason
    ``kv_pages_exhausted``, in the same exact partition); each dispatch
    first grows every live slot's mapping over the positions it will
    write (a slot that cannot grow is evicted, its pages freed);
    finishing a slot returns its pages. ``shared_prefix`` (tokens)
    registers a refcounted shared prefix once, served from the same
    pages to every admission whose prompt starts with it. With
    ``engine.speculate_k >= 2`` a dispatch at adapt level 0 is draft +
    verify: :func:`ngram_draft` proposes, the engine's one batched
    verify forward accepts; the tokens stay those of plain decode."""
    res = resilience or res_lib.ResilienceConfig()
    n_chips = getattr(engine, "n_chips", 1)
    if virtual is not None:
        clock = virtual.clock
    if flush_events is None:
        flush_events = chaos is not None or res.enabled
    tracer = trace_lib.get()
    stats = slo_lib.LatencyStats()
    led = res_lib.ShedLedger()
    alerts = AlertEngine()
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
    paged = bool(getattr(engine, "paged", False))
    alloc = engine.new_allocator() if paged else None
    prefix_len = 0
    prefix_arr: Optional[np.ndarray] = None
    if paged and shared_prefix is not None and len(shared_prefix) > 0:
        prefix_arr = np.asarray(shared_prefix, np.int32)
        prefix_len = int(min(len(prefix_arr), engine.prompt_pad))
        prefix_arr = prefix_arr[:prefix_len]
        # fills the prefix's full pages with the ONE prefill program; a
        # pool that cannot hold the prefix is a config error, raised
        state = engine.register_prefix(params, state, prefix_arr,
                                       prefix_len)
    spec_k = int(getattr(engine, "speculate_k", 0))
    results: Dict[int, Dict[str, Any]] = {}
    generated = truncated = dispatches = 0
    drafted = accepted = 0          # speculative-draft acceptance
    active_peak = pages_peak = 0
    queue_depths: List[int] = []
    recent_tok: deque = deque(maxlen=max(res.window, 1))
    t0 = clock()

    def is_shared(req: Request) -> bool:
        # a request rides the shared prefix iff its prompt starts with
        # it: byte-checked, never assumed
        return (prefix_arr is not None
                and req.prompt_len >= prefix_len
                and np.array_equal(np.asarray(req.tokens)[:prefix_len],
                                   prefix_arr))

    def now() -> float:
        return clock() - t0

    def event(rid: int, ev: str, **kw: Any) -> None:
        # every outcome is also a lifecycle instant, from the same call
        # site: the flight verifier cross-checks the two streams
        tracer.instant(ev, cat="serve", rid=rid, **kw)
        if metrics is not None:
            metrics.log(kind="serve_request", rid=rid, event=ev,
                        t_s=round(now(), 6), **kw)

    def shared_refs() -> int:
        # refcounts held on the shared-prefix pages (the registry's own
        # keep-cached hold included)
        if alloc is None or not alloc.shared_pages:
            return 0
        return int(sum(int(alloc.refcount[p]) for p in alloc.shared_pages))

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
        if paged:
            # pages return to the pool (shared prefix pages drop one
            # count; the registry hold keeps them cached). The device
            # slot is frozen or masked out of every later dispatch
            alloc.free_slot(i)

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
            shared = False
            if paged:
                # peek-then-pop: a denied admission leaves the request
                # at the queue head
                req = waiting[0]
                shared = is_shared(req)
                if not alloc.can_ever_admit(req.prompt_len, shared):
                    # structurally unservable at this pool size: reject
                    # (a partition bucket) instead of wedging the queue
                    waiting.popleft()
                    led.rejected += 1
                    event(req.rid, res_lib.REJECTED,
                          reason="kv_pages_exhausted")
                    continue
                need = -(-req.prompt_len // engine.spec.page_tokens)
                reused = min(need, len(alloc.shared_pages)) \
                    if shared else 0
                if not alloc.admit(i, req.prompt_len, shared=shared):
                    # pool full RIGHT NOW: backpressure, not shedding
                    tracer.instant("kv_backpressure", cat="serve",
                                   rid=req.rid, slot=i, pages=need)
                    break
                tracer.instant("kv_admit", cat="serve", rid=req.rid,
                               slot=i, pages=need,
                               pages_granted=need - reused,
                               shared_pages_reused=reused)
            req = waiting.popleft()
            budget = req.max_new
            if cur_level > 0 and res.max_new_cap:
                budget = min(budget, res.max_new_cap)
            with tracer.span("admit", cat="serve", rid=req.rid, slot=i):
                pass   # the admission decision itself is host-trivial
            with tracer.span("prefill", cat="serve", rid=req.rid, slot=i,
                             prompt_len=req.prompt_len):
                kw = ({"shared_len": alloc.admit_shared_len(shared)}
                      if paged else {})
                state, first = engine.prefill(params, state,
                                              req.tokens[None, :],
                                              req.prompt_len, i, budget,
                                              **kw)
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

    def observe_slos(summ: Dict[str, Any]) -> None:
        alerts.observe("ttft", summ["ttft_p99_s"])
        alerts.observe("itl", summ["itl_p99_s"])
        alerts.observe("serve_shed", led.shed_fraction())
        wall = now()
        if wall > 0 and generated:
            alerts.observe("tokens_per_chip", generated / wall / n_chips)

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
        # speculation only at full service: the ladder's rungs are plain
        # decode programs
        spec_on = paged and spec_k >= 2 and cur_level == 0
        if paged:
            # grow each live slot's mapping over every position this
            # dispatch can write; a slot the pool cannot grow for is
            # evicted (truncated output, its pages fund the others)
            width = spec_k if spec_on else cur_k
            for i in occupied:
                s = slots[i]
                last = min(s.req.prompt_len + s.generated + width - 2,
                           engine.max_seq - 1)
                if not alloc.ensure(i, last):
                    finish(i, "evicted")
            occupied = [i for i in range(engine.slots)
                        if slots[i] is not None]
            if not occupied:
                continue
        # the chaos serve surface: serve_kill dies HERE, at a dispatch
        # boundary (a captured program is never torn mid-replay);
        # serve_slow returns the stall it injected. The buffered outcome
        # events are flushed FIRST: a kill here must not eat the
        # evidence the resumed attempt's lost classification replays
        stall_s = 0.0
        if chaos is not None:
            if flush_events and metrics is not None:
                metrics.flush()
            stall_s = float(chaos.on_serve_dispatch(dispatches) or 0.0)
        t_dispatch = clock()
        if spec_on:
            occ_mask = np.array([s is not None for s in slots])
            draft = np.zeros((engine.slots, spec_k - 1), np.int32)
            for i in occupied:
                s = slots[i]
                draft[i] = ngram_draft(
                    list(s.req.tokens[:s.req.prompt_len]) + s.output,
                    spec_k - 1)
            with tracer.span("verify_step", cat="serve",
                             active=len(occupied), window=spec_k):
                state, toks, valid, _emitted = engine.verify(
                    params, state, draft, dispatch_active=occ_mask)
                toks = toks.cpu().numpy()  # fence: tokens on host
                valid = valid.cpu().numpy()
        else:
            kw = ({"dispatch_active": np.array([s is not None
                                                for s in slots])}
                  if paged else {})
            with tracer.span("decode_step", cat="serve",
                             active=len(occupied), decode_k=cur_k):
                state, toks, valid = engine.decode(params, state, cur_k,
                                                   **kw)
                toks = toks.cpu().numpy()  # fence: tokens on host
                valid = valid.cpu().numpy()
        if virtual is not None:
            dt = virtual.decode_s + stall_s
            virtual.clock.advance(dt)
        else:
            dt = (clock() - t_dispatch) + stall_s
        dispatches += 1
        active_peak = max(active_peak, len(occupied))
        if paged:
            pages_peak = max(pages_peak, alloc.pages_used())
            if tracer.enabled:
                # KV-pool occupancy, one sample a dispatch: the ph="C"
                # counter track of pod_trace.json
                tracer.instant("kv_pages", cat="serve_counter",
                               used=alloc.pages_used(),
                               total=engine.spec.pages,
                               shared_refs=shared_refs())
        if spec_on:
            # a verify dispatch emits a VARIABLE count per slot: ITL
            # attributes the dispatch wall over each slot's accepted run
            mean_new = int(valid.sum()) / max(len(occupied), 1)
            recent_tok.append(dt / mean_new if mean_new > 0 else dt)
            per_tok = None
        else:
            per_tok = dt / cur_k
            recent_tok.append(per_tok)
        for i in occupied:
            col_valid = valid[:, i]
            n_new = int(col_valid.sum())
            if n_new:
                slots[i].output.extend(int(t) for t in toks[col_valid, i])
                slots[i].generated += n_new
                generated += n_new
                stats.note_itl(dt / n_new if spec_on else per_tok, n_new)
                if spec_on:
                    accepted += n_new - 1    # minus the bonus token
                    drafted += spec_k - 1
            s = slots[i]
            # per-slot decode attribution: the flight verifier sums these
            # per rid against the terminal event's generated count
            spec_kw = (dict(drafted=spec_k - 1, accepted=max(n_new - 1, 0))
                       if spec_on else {})
            tracer.instant("decode_emit", cat="serve", rid=s.req.rid,
                           slot=i, tokens=n_new, dispatch=dispatches,
                           **spec_kw)
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
        observe_slos(summ)
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
            extra: Dict[str, Any] = {}
            if paged:
                # the PAGED footprint: what is allocated (pool + table),
                # not the dense slots x max_seq formula
                extra = {"kv_pages_used": alloc.pages_used(),
                         "kv_pages_total": engine.spec.pages,
                         "kv_cache_bytes": engine.spec.bytes,
                         "kv_shared_refs": shared_refs(),
                         "spec_accept_rate": (
                             round(accepted / drafted, 4)
                             if drafted else None)}
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
                            round(generated / wall / n_chips, 3)
                            if wall > 0 else None),
                        ttft_hist=stats.ttft_hist(),
                        itl_hist=stats.itl_hist(),
                        **extra)

    wall_s = now()
    # an empty run measured NOTHING: throughput is None (the gate grades
    # UNGATEABLE), not a 0.0 that would read as an SLO fail
    tps = (generated / wall_s) if generated and wall_s > 0 else None
    tps_chip = tps / n_chips if tps is not None else None
    summ = stats.summary()
    if requests:
        observe_slos(summ)   # runs shorter than a tick still fire
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
        "n_chips": n_chips,
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
        "alert_events": alerts.events,
        "prefill_compiles": prefill_compiles,
        "decode_compiles": decode_compiles,
        "verify_compiles": len(getattr(engine, "verify_traces", [])),
        "active_slots_peak": active_peak,
        "kv_page_tokens": engine.spec.page_tokens if paged else 0,
        "kv_pages_total": engine.spec.pages if paged else 0,
        "kv_pages_used_peak": pages_peak,
        "spec_accept_rate": (round(accepted / drafted, 4)
                             if drafted else None),
        "speculate_k": spec_k,
        "shared_prefix_len": prefix_len,
        "ttft_hist": stats.ttft_hist(),
        "itl_hist": stats.itl_hist(),
        "results": results,
        "thresholds": {rule: rules_lib.resolve(rule)
                       for rule, _ in slo_lib.SERVE_RULES},
    }
