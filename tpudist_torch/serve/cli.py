"""``python -m tpudist_torch.serve`` — the serving acceptance lane.

Counterpart of the dense path of ``tpudist/serve/cli.py``: build the
transformer and its KV cache on the card (``--device cuda``, the
default) or, when asked, on the CPU; warm the engine (the first call
builds the CUDA kernel, then the prefill and each decode rung are
captured as CUDA graphs); run the continuous-batching loop over a seeded
request stream, with admission control, deadline shedding and graceful
degradation when the resilience knobs are on (``--queue-cap``,
``--ttft-deadline-ms``, ``--adapt``; :mod:`tpudist_torch.serve.resilience`)
and on a virtual clock under ``--virtual-clock``; pin the program count;
grade the latency SLOs and the shed gate. Artifacts: ``metrics.jsonl``
(``kind=serve`` / ``serve_tick`` / ``serve_request`` / ``serve_adapt`` /
``memledger`` records, each stamped with the run's ``run_id``), the
memory ledger ``memledger.json`` and, with the span tracer on (the
default; ``--trace off``), ``trace.worker0.json`` and ``pod_trace.json``
with one track per serving slot, under ``--save-dir`` (the traces under
``--trace-dir``), an optional ``BENCH_SERVE.json`` (``--bench-out``) and
the verdict file (``TPUDIST_VERDICT_PATH``). Exit code: 0 unless an SLO
gate FAILED or the run failed.

``parse_args`` declares every option of the JAX serve CLI. Those this
slice does not carry (``NOT_CARRIED``) are refused unless left off, and
their environment twins (``ENV_NOT_CARRIED``) when set on, each naming
the ROADMAP Queue A item that brings it, as the train CLI does
(:mod:`tpudist_torch.config`).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, Optional, Sequence

from tpudist_torch.config import _is_off, _refusal
from tpudist_torch.serve import slo as slo_lib

DEFAULT_SLOTS = 4
DEFAULT_MAX_SEQ = 64
DEFAULT_PROMPT_PAD = 16
DEFAULT_DECODE_K = 8

# The JAX serve CLI's options this slice does not carry: option string;
# its argparse keywords (type, choices, the JAX default when its
# environment variable is unset); the values besides the default that
# leave the feature off in the JAX package; that variable; the ROADMAP
# Queue A item that brings it. parse_args refuses any other value,
# check_supported any other setting of the variable.
NOT_CARRIED = (
    ("--kv-page-tokens", dict(type=int, default=0), (),
     "TPUDIST_SERVE_KV_PAGE_TOKENS", 6),
    ("--kv-pages", dict(type=int, default=0), (), "TPUDIST_SERVE_KV_PAGES",
     6),
    ("--shared-prefix", dict(type=int, default=0), (),
     "TPUDIST_SERVE_SHARED_PREFIX", 6),
    ("--speculate-k", dict(type=int, default=0), (),
     "TPUDIST_SERVE_SPECULATE_K", 6),
    ("--requeue-attempt", dict(type=int), (), None, 6),
    ("--chaos", dict(type=str), (), "TPUDIST_CHAOS", 6),
    ("--serve-tune", dict(choices=("off", "probe", "cache-only"),
                          default="off"), (), "TPUDIST_SERVE_TUNE", 6),
    ("--tune-cache-dir", dict(type=str), (), None, 6),
    ("--live-port", dict(type=int), (0,), "TPUDIST_LIVE_PORT", "11b"),
)

# The environment variables the JAX serve CLI reads for what this slice
# does not carry: the values that leave each off there, and its item.
ENV_NOT_CARRIED = {
    **{env: ((kw.get("default"), *off), item)
       for _, kw, off, env, item in NOT_CARRIED if env},
    "TPUDIST_LIVE": (("off",), "11b"),
}


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
    resilience knobs read their environment twins as it does). An option
    of ``NOT_CARRIED`` is refused with a ``ValueError`` unless its value
    leaves the feature off."""
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
    # the MoE model's shape: read by --model moe only, which is refused
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
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the model runs; cuda fails when no card "
                        "is present rather than falling back to the CPU")
    for flag, kw, _, _, _ in NOT_CARRIED:
        p.add_argument(flag, **kw)
    args = p.parse_args(argv)
    for flag, _, off, _, item in NOT_CARRIED:
        dest = flag[2:].replace("-", "_")
        value = getattr(args, dest)
        if value != p.get_default(dest) and not _is_off(value, off):
            raise _refusal(f"{flag} {value}", item)
    return args


def check_supported(args: argparse.Namespace) -> None:
    """Refuse what this slice of the port does not carry, naming the
    ROADMAP item (Queue A) that brings it."""
    if args.model != "transformer":
        raise ValueError(
            f"--model {args.model}: the port serves the transformer; the "
            f"MoE serving path comes with ROADMAP Queue A item 6")
    for name, (off, item) in ENV_NOT_CARRIED.items():
        value = os.environ.get(name, "")
        if value and not _is_off(value, off):
            raise _refusal(f"{name}={value}", item)


def device_name(device) -> str:
    import torch
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def run(args: argparse.Namespace) -> Dict[str, Any]:
    import torch

    from tpudist_torch import engine as engine_lib
    from tpudist_torch.config import ModelConfig, resolve_trace
    from tpudist_torch.metrics import MetricsLogger, log0
    from tpudist_torch.obs import live as live_lib
    from tpudist_torch.obs import memledger as memledger_lib
    from tpudist_torch.obs import trace as trace_lib
    from tpudist_torch.serve import flight as flight_lib
    from tpudist_torch.serve import resilience as res_lib
    from tpudist_torch.serve import scheduler as sched
    from tpudist_torch.serve.engine import ServeEngine, init_params

    check_supported(args)
    # the span tracer, on by default as in the train lane
    trace_on, trace_dir = resolve_trace(args)
    tracer = trace_lib.configure(enabled=trace_on)
    model_cfg = ModelConfig(
        name=args.model, vocab_size=args.vocab_size,
        n_layers=args.n_layers, d_model=args.d_model,
        n_heads=args.n_heads, n_kv_heads=args.n_kv_heads,
        d_ff=args.d_ff, max_seq_len=args.max_seq)
    dtype = getattr(torch, args.dtype)
    resilience = res_lib.ResilienceConfig(
        queue_cap=max(args.queue_cap, 0),
        ttft_deadline_s=max(args.ttft_deadline_ms, 0.0) / 1e3,
        adapt=args.adapt == "on",
        max_new_cap=max(args.adapt_max_new_cap, 0),
        # malformed-request rejection is on whenever a resilience knob is
        validate=bool(args.queue_cap or args.ttft_deadline_ms
                      or args.adapt == "on"))
    ladder = (res_lib.default_ladder(args.decode_k)
              if resilience.adapt else None)
    engine = ServeEngine(model_cfg, slots=args.slots, max_seq=args.max_seq,
                         prompt_pad=args.prompt_pad, decode_k=args.decode_k,
                         layout=args.kv_layout, dtype=dtype,
                         device=args.device, adapt_ladder=ladder)
    os.makedirs(args.save_dir, exist_ok=True)
    metrics = MetricsLogger(path=os.path.join(args.save_dir,
                                              "metrics.jsonl"))
    # the run's identity on every record and trace document; the serve
    # lane has no requeue loop yet (ROADMAP Queue A item 6)
    run_id = live_lib.resolve_run_id()
    metrics.extra.update(run_id=run_id, requeue_attempt=0)
    tracer.run_info.update(run_id=run_id, requeue_attempt=0)
    params = init_params(model_cfg, seed=args.seed, device=engine.device)
    with trace_lib.span("serve_warmup", cat="serve"):
        engine.warmup(params)
    requests = sched.make_requests(
        args.requests, prompt_pad=args.prompt_pad,
        vocab_size=args.vocab_size, max_new=args.max_new_tokens,
        rate=args.request_rate, seed=args.seed)
    virtual = None
    if args.virtual_clock:
        virtual = res_lib.VirtualTiming(
            prefill_s=args.virtual_prefill_ms / 1e3,
            decode_s=args.virtual_decode_ms / 1e3)
    summary = sched.run_serve(engine, params, requests, metrics=metrics,
                              resilience=resilience, virtual=virtual)
    engine.assert_two_programs()
    summary["model"] = args.model
    summary["dtype"] = args.dtype
    summary["device"] = device_name(engine.device)
    cache_bytes = engine.spec.bytes
    summary["kv_cache_bytes"] = cache_bytes
    summary["capture_s"] = round(engine.capture_s, 6)
    summary["graph_pool_bytes"] = engine.graph_pool_bytes
    metrics.log(kind="serve",
                **{k: v for k, v in summary.items()
                   if k not in ("results", "thresholds")})
    metrics.flush()

    # the serve lane's memory ledger: params, the KV cache and the
    # captured programs' graph pools, partitioned against the card's
    # memory. Advisory: a failure logs a line
    try:
        params_bytes = sum(p.numel() * p.element_size()
                           for p in params.parameters())
        ledger = memledger_lib.build_ledger(
            total_hbm_bytes=int(engine_lib._device_hbm_bytes(
                engine.device)),
            params_bytes=params_bytes, kv_pool_bytes=cache_bytes,
            programs=engine.program_memory(), mode="serve", run_id=run_id)
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
             f"{cache_bytes / 2**20:.2f} MB, temp "
             f"{ledger['buckets']['program_temp'] / 2**20:.1f} MB, "
             f"{'exact' if ledger['exact'] else 'INEXACT'})")
    except Exception as e:
        log0(f"tpudist: memledger skipped ({e!r})")
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
         f"{summary['decode_compiles']} decode program(s), "
         f"kv cache {cache_bytes / 2**20:.2f} MB]")
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
    return summary


def _write_bench(path: str, summary: Dict[str, Any]) -> None:
    """BENCH_SERVE.json: one metric headline, per-gate detail,
    thresholds, and the device the numbers came from."""
    doc = {
        "metric": "serve_tokens_per_sec_per_chip",
        "value": summary["tokens_per_sec_per_chip"],
        "unit": "tokens/s/chip",
        "detail": {k: summary.get(k) for k in (
            "model", "dtype", "requests", "completed", "generated_tokens",
            "truncated", "wall_s", "dispatches", "slots", "decode_k",
            "kv_layout", "kv_cache_bytes", "tokens_per_sec",
            "queue_depth_max", "queue_depth_mean", "ttft_p50_s",
            "ttft_p99_s", "itl_p50_s", "itl_p99_s", "e2e_p50_s",
            "e2e_p99_s", "prefill_compiles", "decode_compiles",
            "capture_s", "graph_pool_bytes", "n_chips", "arrived",
            "admitted", "shed_at_admission", "expired_in_queue",
            "rejected", "lost", "shed_fraction", "queue_cap",
            "ttft_deadline_s", "adapt_level", "decode_k_ladder",
            "active_slots_peak")},
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
    status = slo_lib.FAIL
    try:
        summary = run(parse_args(argv))
        status = summary["status"]
    except Exception as e:
        print(f"tpudist: serve failed: {e!r}", file=sys.stderr, flush=True)
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


if __name__ == "__main__":
    sys.exit(main())
