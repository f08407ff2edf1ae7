"""``python -m tpudist_torch.serve`` — the serving acceptance lane.

Counterpart of ``tpudist/serve/cli.py``: build the model's params (the
transformer, or the MoE with ``--model moe``) on the card (``--device
cuda``, the default) or, when asked, on the CPU; optionally let the
serve tuner pick ``decode_k``, the KV layout and the
paged knobs by measured probe (``--serve-tune``,
:mod:`tpudist_torch.serve.tune`); build the KV cache and engine at that
point, dense or paged (``--kv-page-tokens``, with ``--kv-pages``,
``--shared-prefix`` and ``--speculate-k``); warm the engine (the first
call builds the CUDA kernel, then the prefill, each decode rung and the
speculative verify are captured as CUDA graphs); bound the paged pool's
mappable pages by the device's memory; run the continuous-batching loop
over a seeded request stream, with admission control, deadline shedding
and graceful degradation when the resilience knobs are on
(``--queue-cap``, ``--ttft-deadline-ms``, ``--adapt``;
:mod:`tpudist_torch.serve.resilience`), on a virtual clock under
``--virtual-clock``, and under a scripted serve fault plan under
``--chaos`` (:mod:`tpudist_torch.chaos`); pin the program count; grade
the latency SLOs and the shed gate. Under a launcher's requeue loop
(``--requeue-attempt``), a restarted attempt replays the still-live
requests of the seeded schedule and classifies the dead attempt's
in-flight slots as lost. Artifacts: ``metrics.jsonl`` (``kind=serve`` /
``serve_tick`` / ``serve_request`` / ``serve_adapt`` / ``serve_tune`` /
``serve_resume`` / ``serve_warmup`` / ``chaos`` / ``memledger`` records,
each stamped with the run's ``run_id`` and ``requeue_attempt``), the
memory ledger ``memledger.json``, with ``TPUDIST_LIVE=on`` or
``--live-port`` the live aggregator's ``alerts.jsonl`` and
``live_status.json`` (:class:`~tpudist_torch.obs.live.LiveAggregator`,
fed every record; a port also serves it as Prometheus ``/metrics``,
``/status.json`` and ``/healthz`` while the run lives) and,
with the span tracer on (the default; ``--trace off``),
``trace.worker0.json`` and ``pod_trace.json`` with one track per serving
slot, under ``--save-dir`` (the traces under ``--trace-dir``),
the serve tuner's cache (``--tune-cache-dir``), an optional
``BENCH_SERVE.json`` (``--bench-out``) and the verdict file
(``TPUDIST_VERDICT_PATH``). Exit code: 0 unless an SLO gate FAILED or
the run failed.

Under the env contract (``TPUDIST_COORDINATOR`` /
``TPUDIST_NUM_PROCESSES`` / ``TPUDIST_PROCESS_ID``, one process a card,
as the train CLI) the run serves on a serve mesh
(:class:`~tpudist_torch.serve.engine.ServeEngine` and
:class:`~tpudist_torch.serve.engine.PagedServeEngine`, ``mesh=``): rank 0
runs the scheduler, the page allocator, the drafts, the chaos plan and
the requeue replay, and writes every artifact, ``n_chips`` the
processes; the other ranks follow its engine calls. The serve tuner runs
on every rank in lockstep. Every rank writes its worker verdict; a rank
that fails leaves at once, so the run fails in bounded time (a follower
whose leader died leaves naming it).

``parse_args`` declares every option of the JAX serve CLI, with its
default.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Any, Dict, Optional, Sequence

from tpudist_torch.serve import slo as slo_lib
from tpudist_torch.utils.platform import platform_device

DEFAULT_SLOTS = 4
DEFAULT_MAX_SEQ = 64
DEFAULT_PROMPT_PAD = 16
DEFAULT_DECODE_K = 8

def _env_int(name: str) -> Optional[int]:
    raw = os.environ.get(name)
    try:
        return int(raw) if raw else None
    except ValueError:
        return None


def _env_float(name: str) -> Optional[float]:
    raw = os.environ.get(name)
    try:
        return float(raw) if raw else None
    except ValueError:
        return None


def parse_args(argv: Optional[Sequence[str]] = None
               ) -> argparse.Namespace:
    """CLI -> Namespace, the JAX serve CLI's options and defaults (the
    resilience knobs and the exporter's port read their environment
    twins as it does)."""
    p = argparse.ArgumentParser(
        prog="python -m tpudist_torch.serve",
        description="tpudist serving acceptance lane on PyTorch/CUDA: "
                    "continuous batching + KV cache + latency-SLO verdict")
    p.add_argument("--model", choices=("transformer", "moe"),
                   default="transformer")
    p.add_argument("--vocab-size", type=int, default=256)
    p.add_argument("--n-layers", type=int, default=2)
    p.add_argument("--d-model", type=int, default=64)
    p.add_argument("--n-heads", type=int, default=4)
    p.add_argument("--n-kv-heads", type=int, default=2,
                   help="GQA: compact kv heads stored in the cache")
    p.add_argument("--d-ff", type=int, default=128)
    # the MoE model's shape, read by --model moe only (the rest of it
    # takes ModelConfig's defaults, as in the JAX serve CLI)
    p.add_argument("--n-experts", type=int, default=4)
    p.add_argument("--expert-top-k", type=int, default=2)
    p.add_argument("--slots", type=int, default=DEFAULT_SLOTS,
                   help="concurrent sequences (KV cache rows)")
    p.add_argument("--max-seq", type=int, default=DEFAULT_MAX_SEQ,
                   help="per-slot cache row length")
    p.add_argument("--prompt-pad", type=int, default=DEFAULT_PROMPT_PAD,
                   help="static prompt width every admission pads to "
                        "(one captured prefill program)")
    p.add_argument("--decode-steps-per-dispatch", type=int,
                   default=DEFAULT_DECODE_K, dest="decode_k",
                   help="decode superstep length (tokens per dispatch "
                        "per slot)")
    p.add_argument("--kv-layout", choices=("st", "hs"), default="st",
                   help="KV cache physical storage layout "
                        "(tpudist_torch.serve.kvcache)")
    # ---- the paged plane (PagedServeEngine) ----
    p.add_argument("--kv-page-tokens", type=int,
                   default=_env_int("TPUDIST_SERVE_KV_PAGE_TOKENS")
                   or 0,
                   help="PAGED KV cache: fixed page length in "
                        "positions; 0 keeps the dense per-slot arena "
                        "($TPUDIST_SERVE_KV_PAGE_TOKENS)")
    p.add_argument("--kv-pages", type=int,
                   default=_env_int("TPUDIST_SERVE_KV_PAGES") or 0,
                   help="paged pool size in pages (+1 trash page is "
                        "added internally); 0 = full dense capacity "
                        "slots*ceil(max_seq/page_tokens) "
                        "($TPUDIST_SERVE_KV_PAGES)")
    p.add_argument("--shared-prefix", type=int,
                   default=_env_int("TPUDIST_SERVE_SHARED_PREFIX")
                   or 0,
                   help="every request starts with this many shared "
                        "system-prompt tokens; the paged engine stores "
                        "their full pages ONCE (refcounted, "
                        "copy-on-write fork of the partial tail) "
                        "($TPUDIST_SERVE_SHARED_PREFIX)")
    p.add_argument("--speculate-k", type=int,
                   default=_env_int("TPUDIST_SERVE_SPECULATE_K") or 0,
                   help="speculative decoding verify-window width: "
                        "last token + k-1 n-gram draft tokens scored "
                        "in ONE batched forward; 0 = off, needs "
                        "--kv-page-tokens ($TPUDIST_SERVE_SPECULATE_K)")
    p.add_argument("--requests", type=int, default=32,
                   help="synthetic request count")
    p.add_argument("--request-rate", type=float, default=0.0,
                   help="Poisson arrival rate in requests/s "
                        "(<= 0: closed loop, all present at t=0)")
    p.add_argument("--max-new-tokens", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    # ---- the resilience plane (tpudist_torch.serve.resilience) ----
    p.add_argument("--queue-cap", type=int,
                   default=_env_int("TPUDIST_SERVE_QUEUE_CAP") or 0,
                   help="bounded admission queue: arrivals past this "
                        "many waiting requests are SHED "
                        "($TPUDIST_SERVE_QUEUE_CAP; 0 = unbounded)")
    p.add_argument("--ttft-deadline-ms", type=float,
                   default=_env_float("TPUDIST_SERVE_TTFT_DEADLINE_MS")
                   or 0.0,
                   help="per-request TTFT deadline: accepted requests "
                        "still queued past this age are EXPIRED "
                        "($TPUDIST_SERVE_TTFT_DEADLINE_MS; 0 = off)")
    p.add_argument("--adapt", choices=("off", "on"),
                   default=os.environ.get("TPUDIST_SERVE_ADAPT", "off"),
                   help="graceful degradation: downshift decode_k on "
                        "the captured ladder when rolling queue "
                        "depth/ITL crosses the pressure thresholds, "
                        "restore when it clears ($TPUDIST_SERVE_ADAPT)")
    p.add_argument("--adapt-max-new-cap", type=int, default=0,
                   help="under degradation, truncate admitted "
                        "requests' generation budget to this many "
                        "tokens (0 = no truncation)")
    p.add_argument("--virtual-clock", action="store_true",
                   default=os.environ.get(
                       "TPUDIST_SERVE_VIRTUAL_CLOCK", "").lower()
                   in ("on", "1", "true"),
                   help="deterministic mode: the request clock advances "
                        "by scripted per-prefill/per-dispatch costs "
                        "instead of wall time; two runs of one seed give "
                        "identical SLO summaries "
                        "($TPUDIST_SERVE_VIRTUAL_CLOCK)")
    p.add_argument("--virtual-prefill-ms", type=float, default=2.0)
    p.add_argument("--virtual-decode-ms", type=float, default=4.0)
    # ---- supervision, chaos and the serve tuner ----
    p.add_argument("--requeue-attempt", type=int, default=None,
                   help="requeue loop attempt index: its PRESENCE arms "
                        "supervision (per-request outcome events get "
                        "boundary flushes so a preemption cannot eat "
                        "them), and attempt > 0 replays the seeded "
                        "stream MINUS the requests a prior attempt "
                        "finished, classifying its in-flight slots as "
                        "lost")
    p.add_argument("--chaos", type=str,
                   default=os.environ.get("TPUDIST_CHAOS"),
                   help="scripted serve-surface fault plan "
                        "(tpudist_torch.chaos: serve_kill@0:<dispatch>, "
                        "serve_slow, request_garbage; $TPUDIST_CHAOS)")
    p.add_argument("--serve-tune", choices=("off", "probe", "cache-only"),
                   default=os.environ.get("TPUDIST_SERVE_TUNE", "off"),
                   help="autotune decode_k, the KV layout and the paged "
                        "knobs by measured probe "
                        "(tpudist_torch.serve.tune; $TPUDIST_SERVE_TUNE)")
    p.add_argument("--tune-cache-dir", type=str, default=None,
                   help="serve tuner cache dir (default "
                        "$TPUDIST_AUTOTUNE_CACHE_DIR, else "
                        "<save-dir>/tune; shared with the train tuner, "
                        "a distinct file prefix)")
    p.add_argument("--save-dir", type=str, default="ckpt",
                   help="metrics.jsonl destination")
    p.add_argument("--bench-out", type=str, default=None,
                   help="write the run summary as BENCH_SERVE.json here")
    p.add_argument("--dtype", choices=("float32", "bfloat16"),
                   default="float32",
                   help="activation and KV cache dtype (weights are kept "
                        "in f32 and cast at use)")
    p.add_argument("--trace", choices=("on", "off"), default=None,
                   help="span tracing (request flight timelines); "
                        "default on, resolved as the train lane does: "
                        "flag > $TPUDIST_TRACE > on")
    p.add_argument("--trace-dir", type=str,
                   default=os.environ.get("TPUDIST_TRACE_DIR"),
                   help="span-trace export dir ($TPUDIST_TRACE_DIR, "
                        "else --save-dir)")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="where the model runs ($TPUDIST_PLATFORM: cpu, or "
                        "cuda/gpu); cuda (the default) fails when no card "
                        "is present rather than falling back to the CPU")
    p.add_argument("--live-port", type=int, default=_env_int(
        "TPUDIST_LIVE_PORT"),
        help="serve Prometheus /metrics + /status.json on this port "
             "while the run lives ($TPUDIST_LIVE_PORT)")
    args = p.parse_args(argv)
    args.device = platform_device(args.device)
    return args


def _prior_outcomes(path: str):
    """Replay a dead attempt's flushed ``kind=serve_request`` events:
    returns ``(accounted_rids, lost_rids)`` — rids with a terminal
    outcome in ANY prior attempt, and rids admitted to a slot with none
    (the in-flight slots the kill took, which THIS attempt classifies
    as lost rather than re-serving half-generated work)."""
    from tpudist_torch.serve import resilience as res_lib
    admitted, terminal = set(), set()
    try:
        with open(path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue          # a torn tail line is not evidence
                if rec.get("kind") != "serve_request":
                    continue
                rid, ev = rec.get("rid"), rec.get("event")
                if rid is None:
                    continue
                if ev == res_lib.ADMITTED:
                    admitted.add(int(rid))
                elif ev in res_lib.TERMINAL_EVENTS:
                    terminal.add(int(rid))
    except OSError:
        return set(), set()
    return terminal, admitted - terminal


class _LoopbackEmitter:
    """MetricsLogger -> LiveAggregator fan-out without a socket: the
    serve CLI is one process, so records are ingested directly (the
    record shapes the JAX package's telemetry bus carries)."""

    def __init__(self, agg):
        self.agg = agg

    def emit(self, rec: Dict[str, Any]) -> None:
        try:
            self.agg.ingest(rec)
        except Exception:
            pass   # telemetry must never take down the serve loop


def device_name(device) -> str:
    import torch
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def run(args: argparse.Namespace) -> Dict[str, Any]:
    import torch

    from tpudist_torch import engine as engine_lib
    from tpudist_torch.config import ModelConfig, ParallelConfig, resolve_trace
    from tpudist_torch.metrics import MetricsLogger, log0
    from tpudist_torch.obs import live as live_lib
    from tpudist_torch.obs import memledger as memledger_lib
    from tpudist_torch.obs import trace as trace_lib
    from tpudist_torch.parallel import distributed
    from tpudist_torch.parallel import mesh as mesh_lib
    from tpudist_torch.serve import flight as flight_lib
    from tpudist_torch.serve import resilience as res_lib
    from tpudist_torch.serve import scheduler as sched
    from tpudist_torch.serve import tune as serve_tune
    from tpudist_torch.serve.engine import (PagedServeEngine, ServeEngine,
                                            init_params)
    from tpudist_torch.utils.platform import resolve_device

    if args.speculate_k and not args.kv_page_tokens:
        raise SystemExit("tpudist: --speculate-k needs the paged KV "
                         "cache (--kv-page-tokens > 0)")
    # the span tracer, on by default as in the train lane
    trace_on, trace_dir = resolve_trace(args)
    tracer = trace_lib.configure(enabled=trace_on)
    model_cfg = ModelConfig(
        name=args.model, vocab_size=args.vocab_size,
        n_layers=args.n_layers, d_model=args.d_model,
        n_heads=args.n_heads, n_kv_heads=args.n_kv_heads,
        d_ff=args.d_ff, max_seq_len=args.max_seq,
        n_experts=args.n_experts, expert_top_k=args.expert_top_k)
    dtype = getattr(torch, args.dtype)
    # under the env contract one process a card: the serve mesh's slots
    # split over the ranks, rank 0 the scheduler, the others following
    # its engine calls (ServeEngine.follow)
    ctx = distributed.initialize(device=resolve_device(args.device))
    device, world = ctx.device, ctx.process_count
    mesh = (mesh_lib.build_mesh(ParallelConfig(), device_type=device.type)
            if world > 1 else None)

    # --requeue-attempt's PRESENCE (any value, 0 included) means a
    # launcher's supervision loop owns this run: outcome events must
    # reach disk at boundaries, because a preemption may kill it and the
    # NEXT attempt classifies from what survived
    supervised = args.requeue_attempt is not None
    attempt = args.requeue_attempt or 0
    os.makedirs(args.save_dir, exist_ok=True)
    metrics_path = os.path.join(args.save_dir, "metrics.jsonl")
    # a resumed attempt reads the DEAD attempt's flushed outcome events
    # before this attempt appends its own
    prior_done, prior_lost = (set(), set())
    if attempt > 0 and ctx.is_coordinator:
        prior_done, prior_lost = _prior_outcomes(metrics_path)
    metrics = MetricsLogger(path=metrics_path)
    # the run's identity on every record and trace document
    run_id = live_lib.resolve_run_id()
    metrics.extra.update(run_id=run_id, requeue_attempt=attempt)
    tracer.run_info.update(run_id=run_id, requeue_attempt=attempt)

    # the live aggregator (its alert engine, alerts.jsonl and
    # live_status.json), fed every record, whenever live is on:
    # $TPUDIST_LIVE=on without a port keeps it exporter-less (the drills'
    # mode); a port also serves Prometheus /metrics
    agg = server = None
    if ctx.is_coordinator and (args.live_port or os.environ.get(
            "TPUDIST_LIVE", "").lower() in ("on", "1", "true")):
        agg = live_lib.LiveAggregator(out_dir=args.save_dir, run_id=run_id,
                                      metrics=None, stall_timeout_s=0)
        if args.live_port:
            server = live_lib.LiveHttpServer(agg, port=args.live_port)
            log0(f"tpudist: serve live exporter on "
                 f":{server.port}/metrics")
        metrics.emitter = _LoopbackEmitter(agg)

    # the chaos plane's serve surface (--chaos / $TPUDIST_CHAOS):
    # serve_kill / serve_slow fire at decode-dispatch boundaries through
    # the scheduler's hook; request_garbage folds seeded malformed
    # requests into the arrival stream below. Off constructs nothing
    chaos_rt = None
    if args.chaos:
        from tpudist_torch import chaos as chaos_lib
        chaos_rt = chaos_lib.ChaosRuntime(
            chaos_lib.ChaosPlan.parse(args.chaos), metrics=metrics)
        log0(f"tpudist: chaos on: {chaos_rt.plan.describe()}")

    resilience = res_lib.ResilienceConfig(
        queue_cap=max(args.queue_cap, 0),
        ttft_deadline_s=max(args.ttft_deadline_ms, 0.0) / 1e3,
        adapt=args.adapt == "on",
        max_new_cap=max(args.adapt_max_new_cap, 0),
        # malformed-request rejection is on whenever a resilience or
        # chaos knob is: the garbage family's contract is an admission
        # rejection, never an engine crash
        validate=bool(args.chaos or args.queue_cap or args.ttft_deadline_ms
                      or args.adapt == "on"))
    params = init_params(model_cfg, seed=args.seed, device=device)
    if mesh is not None:
        # replicated params: rank 0's, whatever each card drew
        for p in params.parameters():
            torch.distributed.broadcast(p.data, src=0)

    cand = serve_tune.ServeCandidate(
        decode_k=args.decode_k, layout=args.kv_layout,
        kv_page_tokens=max(args.kv_page_tokens, 0),
        speculate_k=max(args.speculate_k, 0))
    if args.serve_tune != "off":
        cache_dir = (args.tune_cache_dir
                     or os.environ.get("TPUDIST_AUTOTUNE_CACHE_DIR")
                     or os.path.join(args.save_dir, "tune"))
        with trace_lib.span("serve_tune", cat="tune",
                            mode=args.serve_tune):
            out = serve_tune.autotune_serve(
                model_cfg, device, params, slots=args.slots,
                max_seq=args.max_seq, prompt_pad=args.prompt_pad,
                mode=args.serve_tune, cache_dir=cache_dir, start=cand,
                dtype=dtype, metrics=metrics, mesh=mesh)
        cand = out.tuned
        log0(f"tpudist: serve tune {out.status} ({out.source}): "
             f"decode_k={cand.decode_k} layout={cand.layout} "
             f"kv_page_tokens={cand.kv_page_tokens} "
             f"speculate_k={cand.speculate_k} "
             f"[{out.trials} trial(s)]")

    ladder = (res_lib.default_ladder(cand.decode_k)
              if resilience.adapt else None)
    if cand.kv_page_tokens > 0:
        engine = PagedServeEngine(
            model_cfg, slots=args.slots, max_seq=args.max_seq,
            prompt_pad=args.prompt_pad, decode_k=cand.decode_k,
            page_tokens=cand.kv_page_tokens, pages=max(args.kv_pages, 0),
            speculate_k=max(cand.speculate_k, 0), dtype=dtype,
            device=device, adapt_ladder=ladder, mesh=mesh)
    else:
        engine = ServeEngine(model_cfg, slots=args.slots,
                             max_seq=args.max_seq,
                             prompt_pad=args.prompt_pad,
                             decode_k=cand.decode_k, layout=cand.layout,
                             dtype=dtype, device=device,
                             adapt_ladder=ladder, mesh=mesh)
    if mesh is not None:
        if engine.paged:
            g = engine.pool_group
            where = (f"slots {args.slots} on every rank, pool rows "
                     + (f"split {g.rows} a rank of {g.n_rows}" if g else
                        f"replicated ({engine.spec.pages + 1} rows, data "
                        f"{world} does not divide them)"))
        else:
            where = (f"slots {args.slots} split "
                     f"{engine.span[1] - engine.span[0]} a rank"
                     if engine.split else
                     f"slots {args.slots} replicated (data {world} does "
                     f"not divide them)")
        log0(f"tpudist: serve mesh of {world} processes ({ctx.backend}): "
             + where
             + ("; MoE decode routed over the global slot batch"
                if args.model == "moe" and engine.split else ""))
        if not ctx.is_coordinator:
            engine.follow(params)
            # NCCL destroys no communicator a live graph captured work on
            engine.release()
            return None
    with trace_lib.span("serve_warmup", cat="serve"):
        engine.warmup(params)
    # the warm-up's wall and memory: facts of the card and the run, kept
    # off kind=serve, whose fields a virtual-clock rerun reproduces
    metrics.log(kind="serve_warmup", device=device_name(engine.device),
                capture_s=round(engine.capture_s, 6),
                graph_pool_bytes=engine.graph_pool_bytes)

    # the programs are built: their memory (the graph pools on the card)
    # and the params bound how many pages the paged pool may map (the 4x
    # params heuristic where no program reports its scratch, the CPU)
    program_mem = engine.program_memory()
    params_bytes = sum(p.numel() * p.element_size()
                       for p in params.parameters())
    hbm_bytes = int(engine_lib._device_hbm_bytes(engine.device))
    if engine.paged:
        temp, temp_complete = memledger_lib.program_temp_bytes(program_mem)
        cap = engine.alloc.set_memory_bound(
            hbm_bytes=hbm_bytes, params_bytes=params_bytes,
            program_temp_bytes=temp if temp_complete else None,
            ways=engine.pool_ways)
        log0(f"tpudist: serve kv memory bound "
             f"({engine.alloc.bound_source}): {cap}/{engine.spec.pages} "
             f"pages mappable in {hbm_bytes / 2**20:.0f} MB HBM")

    prefix_len = max(args.shared_prefix, 0)
    shared_prefix = (sched.shared_prefix_tokens(
        min(prefix_len, args.prompt_pad), args.vocab_size, args.seed)
        if prefix_len else None)
    requests = sched.make_requests(
        args.requests, prompt_pad=args.prompt_pad,
        vocab_size=args.vocab_size, max_new=args.max_new_tokens,
        rate=args.request_rate, seed=args.seed, prefix_len=prefix_len)
    if chaos_rt is not None:
        # request_garbage: the fault IS the malformed requests, folded
        # into the (deterministic) schedule; admission rejects them
        span = max((r.arrival_s for r in requests), default=0.0)
        rid_base = len(requests)
        for ev in chaos_rt.consume_request_garbage():
            garbage = sched.make_garbage_requests(
                chaos_rt.plan, ev, rid_base=rid_base,
                prompt_pad=args.prompt_pad, vocab_size=args.vocab_size,
                span_s=span)
            requests.extend(garbage)
            rid_base += len(garbage)

    n_lost = 0
    if attempt > 0:
        # honest supervision accounting: a prior attempt's in-flight
        # slots are LOST (their KV state died with the engine; a
        # half-generated answer is not resumable), its queued and
        # unserved requests are replayed from the deterministic schedule
        for rid in sorted(prior_lost):
            metrics.log(kind="serve_request", rid=rid,
                        event=res_lib.LOST)
            tracer.instant(res_lib.LOST, cat="serve", rid=rid)
            n_lost += 1
        remaining = [r for r in requests
                     if r.rid not in prior_done
                     and r.rid not in prior_lost]
        shift = min((r.arrival_s for r in remaining), default=0.0)
        requests = [dataclasses.replace(r, arrival_s=r.arrival_s - shift)
                    for r in remaining]
        metrics.log(kind="serve_resume",
                    completed_prior=len(prior_done), lost=n_lost,
                    replayed=len(requests))
        metrics.flush()
        log0(f"tpudist: serve resume (attempt {attempt}): "
             f"{len(prior_done)} done in prior attempt(s), {n_lost} "
             f"in-flight lost, replaying {len(requests)}")

    virtual = None
    if args.virtual_clock:
        virtual = res_lib.VirtualTiming(
            prefill_s=args.virtual_prefill_ms / 1e3,
            decode_s=args.virtual_decode_ms / 1e3)
    summary = sched.run_serve(engine, params, requests, metrics=metrics,
                              resilience=resilience, chaos=chaos_rt,
                              virtual=virtual,
                              flush_events=True if supervised else None,
                              shared_prefix=shared_prefix)
    engine.stop_followers()
    engine.assert_two_programs()
    summary["run_id"] = run_id
    summary["model"] = args.model
    summary["requeue_attempt"] = attempt
    if attempt > 0:
        # the summary's ``lost`` is what THIS attempt knows was lost: a
        # kill that takes slots never writes a summary, so the resumed
        # attempt's classification of the dead attempt's in-flight slots
        # IS the number (the ``partition`` block stays the attempt-local
        # checked ledger, where lost is 0 by construction)
        summary["lost"] = n_lost
        summary["completed_prior"] = len(prior_done)
    summary["dtype"] = args.dtype
    summary["device"] = device_name(engine.device)
    cache_bytes = engine.spec.bytes
    summary["kv_cache_bytes"] = cache_bytes
    summary["capture_s"] = round(engine.capture_s, 6)
    summary["graph_pool_bytes"] = engine.graph_pool_bytes
    metrics.log(kind="serve",
                **{k: v for k, v in summary.items()
                   if k not in ("results", "alert_events", "thresholds",
                                "capture_s", "graph_pool_bytes")})
    metrics.flush()

    # the serve lane's memory ledger: params, the KV cache (paged: pool
    # pages with the trash page + the table, ``spec.bytes``; on a serve
    # mesh this rank's span of the slots, or its chunk of a split pool's
    # rows with its discard row, while ``kv_cache_bytes`` above stays the
    # whole cache, as in the JAX summary) and the captured
    # programs' graph pools, partitioned against the card's memory.
    # Advisory: a failure logs a line
    card_cache_bytes = engine.card_kv_bytes()
    try:
        ledger = memledger_lib.build_ledger(
            total_hbm_bytes=hbm_bytes, params_bytes=params_bytes,
            kv_pool_bytes=card_cache_bytes, programs=program_mem,
            mode="serve", run_id=run_id)
        metrics.log(kind="memledger",
                    **memledger_lib.ledger_record(ledger))
        metrics.flush()
        memledger_lib._atomic_write(
            os.path.join(args.save_dir, memledger_lib.LEDGER_NAME),
            json.dumps(ledger, indent=1))
        log0(f"tpudist: memledger {ledger['headroom_status']}: "
             f"{100 * ledger['headroom_fraction']:.1f}% headroom of "
             f"{ledger['total_hbm_bytes'] / 2**20:.0f} MB HBM "
             f"(params {params_bytes / 2**20:.1f} MB, kv_pool "
             f"{card_cache_bytes / 2**20:.2f} MB, temp "
             f"{ledger['buckets']['program_temp'] / 2**20:.1f} MB, "
             f"{'exact' if ledger['exact'] else 'INEXACT'})")
    except Exception as e:
        log0(f"tpudist: memledger skipped ({e!r})")
    if server is not None:
        server.close()
    if agg is not None:
        agg.close()
    metrics.close()

    log0(f"tpudist: serve {summary['status']}: "
         f"{summary['completed']}/{summary['requests']} requests, "
         f"{summary['generated_tokens']} tokens in "
         f"{summary['wall_s']:.3f}s "
         f"({summary['tokens_per_sec_per_chip']} tok/s/chip), "
         f"ttft p99 {summary['ttft_p99_s']}s, "
         f"itl p99 {summary['itl_p99_s']}s, "
         f"shed {summary['shed_total']}/{summary['arrived']} "
         f"[{summary['device']}, {args.dtype}, "
         f"{summary['prefill_compiles']} prefill / "
         f"{summary['decode_compiles']} decode / "
         f"{summary['verify_compiles']} verify program(s), "
         f"kv cache {cache_bytes / 2**20:.2f} MB"
         + (f", {summary['kv_pages_used_peak']}"
            f"/{summary['kv_pages_total']} pages peak, "
            f"spec accept {summary['spec_accept_rate']}"
            if engine.paged else "") + "]")
    if args.bench_out:
        _write_bench(args.bench_out, summary)
        log0(f"tpudist: serve bench -> {args.bench_out}")
    if tracer.enabled:
        # the pod export, with one track per serving slot appended;
        # advisory: a failed export logs and never fails the run
        try:
            extra = flight_lib.build_extra_events(
                tracer.events(process_index=0), process_index=0)
            tinfo = trace_lib.export_pod_trace(
                trace_dir, tracer=tracer, extra_events=extra)
            log0(f"tpudist: serve trace -> {tinfo['local_path']} "
                 f"({tinfo['spans']} spans, {len(extra)} slot-track/"
                 f"counter events, merged {tinfo['merged_path']})")
        except Exception as e:
            log0(f"tpudist: serve trace export failed ({e!r})")
    if mesh is not None:
        engine.release()     # before the process group goes (follow())
    return summary


def _write_bench(path: str, summary: Dict[str, Any]) -> None:
    """BENCH_SERVE.json: one metric headline, per-gate detail,
    thresholds, and the device the numbers came from."""
    doc = {
        "metric": "serve_tokens_per_sec_per_chip",
        "value": summary["tokens_per_sec_per_chip"],
        "unit": "tokens/s/chip",
        "detail": {k: summary.get(k) for k in (
            "run_id", "model", "dtype", "requests", "completed",
            "generated_tokens", "truncated", "wall_s", "dispatches",
            "slots", "decode_k",
            "kv_layout", "kv_cache_bytes", "tokens_per_sec",
            "queue_depth_max", "queue_depth_mean", "ttft_p50_s",
            "ttft_p99_s", "itl_p50_s", "itl_p99_s", "e2e_p50_s",
            "e2e_p99_s", "prefill_compiles", "decode_compiles",
            "verify_compiles", "capture_s", "graph_pool_bytes", "n_chips",
            "arrived", "admitted", "shed_at_admission",
            "expired_in_queue", "rejected", "lost", "completed_prior",
            "shed_fraction", "queue_cap", "ttft_deadline_s", "adapt_level",
            "decode_k_ladder", "requeue_attempt", "kv_page_tokens",
            "kv_pages_total",
            "kv_pages_used_peak", "active_slots_peak",
            "spec_accept_rate", "speculate_k", "shared_prefix_len")},
        "slo": slo_lib.slo_block(summary),
        "device": summary["device"],
    }
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
    os.replace(tmp, path)


def main(argv: Optional[Sequence[str]] = None) -> int:
    verdict_path = os.environ.get("TPUDIST_VERDICT_PATH")
    status, ok = slo_lib.FAIL, False
    try:
        summary = run(parse_args(argv))
        # a serve mesh's follower serves; rank 0's summary grades
        status = slo_lib.SUCCESS if summary is None else summary["status"]
        ok = True
    except Exception as e:
        print(f"tpudist: serve failed: {e!r}", file=sys.stderr, flush=True)
    import torch.distributed as dist
    if dist.is_initialized():
        return _end_mesh_run(verdict_path, ok, status)
    if verdict_path:
        import subprocess

        from tpudist_torch import verdict as verdict_lib
        try:
            verdict_lib.write_final_status(verdict_path, status)
        except (OSError, subprocess.SubprocessError) as e:
            print(f"tpudist: verdict plumbing failed: {e!r}",
                  file=sys.stderr, flush=True)
    # an UNGATEABLE run (nothing measured) is not a latency regression
    return 1 if status == slo_lib.FAIL else 0


def _end_mesh_run(verdict_path: Optional[str], ok: bool, status: str
                  ) -> int:
    """A serve mesh's end, on every rank. A rank that failed writes its
    verdicts (rank 0 the final ``fail``) and leaves at once, joining no
    further collective: its peers' next collective with it then fails on
    the closed connection instead of waiting, so a failed follower fails
    the run in bounded time. Otherwise the verdicts are ANDed over the
    ranks (bounded, as in training), rank 0 writes the final one, and the
    ranks meet at a bounded end barrier before leaving the group."""
    from tpudist_torch import verdict as verdict_lib
    from tpudist_torch.parallel import distributed

    def write(ok: bool, status: str) -> None:
        if not verdict_path:
            return
        try:
            verdict_lib.write_worker_verdict(verdict_path, ok)
            verdict_lib.write_final_status(verdict_path, status)
        except OSError as e:
            print(f"tpudist: verdict plumbing failed: {e!r}",
                  file=sys.stderr, flush=True)

    if not ok:
        write(False, slo_lib.FAIL)
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    all_ok, timed_out = verdict_lib.aggregate_status(True)
    if not all_ok:
        status = slo_lib.FAIL
    write(True, status)
    if not timed_out and not distributed.barrier_bounded("tpudist_serve_end"):
        distributed.shutdown()
    code = 1 if status == slo_lib.FAIL else 0
    if timed_out:
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)
    return code


if __name__ == "__main__":
    sys.exit(main())
