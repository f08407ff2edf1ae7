"""``python -m tpudist_torch.serve`` — the serving acceptance lane.

Counterpart of the dense path of ``tpudist/serve/cli.py``: build the
transformer and its KV cache on the card (``--device cuda``, the
default) or, when asked, on the CPU; warm the engine (the first call
builds the CUDA kernel); run the continuous-batching loop over a seeded
request stream; grade the latency SLOs. Artifacts: ``metrics.jsonl``
(``kind=serve`` / ``serve_tick`` / ``serve_request`` records) under
``--save-dir``, an optional ``BENCH_SERVE.json`` (``--bench-out``) and
the verdict file (``TPUDIST_VERDICT_PATH``). Exit code: 0 unless an SLO
gate FAILED or the run failed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, Optional, Sequence

from tpudist_torch.serve import slo as slo_lib

DEFAULT_SLOTS = 4
DEFAULT_MAX_SEQ = 64
DEFAULT_PROMPT_PAD = 16
DEFAULT_DECODE_K = 8


def parse_args(argv: Optional[Sequence[str]] = None
               ) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m tpudist_torch.serve",
        description="tpudist serving acceptance lane on PyTorch/CUDA: "
                    "continuous batching + KV cache + latency-SLO verdict")
    p.add_argument("--model", choices=("transformer",),
                   default="transformer")
    p.add_argument("--vocab-size", type=int, default=256)
    p.add_argument("--n-layers", type=int, default=2)
    p.add_argument("--d-model", type=int, default=64)
    p.add_argument("--n-heads", type=int, default=4)
    p.add_argument("--n-kv-heads", type=int, default=2,
                   help="GQA: compact kv heads stored in the cache")
    p.add_argument("--d-ff", type=int, default=128)
    p.add_argument("--slots", type=int, default=DEFAULT_SLOTS,
                   help="concurrent sequences (KV cache rows)")
    p.add_argument("--max-seq", type=int, default=DEFAULT_MAX_SEQ,
                   help="per-slot cache row length")
    p.add_argument("--prompt-pad", type=int, default=DEFAULT_PROMPT_PAD,
                   help="static prompt width every admission pads to")
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
    p.add_argument("--save-dir", type=str, default="ckpt",
                   help="metrics.jsonl destination")
    p.add_argument("--bench-out", type=str, default=None,
                   help="write the run summary as BENCH_SERVE.json here")
    p.add_argument("--dtype", choices=("float32", "bfloat16"),
                   default="float32",
                   help="activation and KV cache dtype (weights are kept "
                        "in f32 and cast at use)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the model runs; cuda fails when no card "
                        "is present rather than falling back to the CPU")
    return p.parse_args(argv)


def device_name(device) -> str:
    import torch
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def run(args: argparse.Namespace) -> Dict[str, Any]:
    import torch

    from tpudist_torch.config import ModelConfig
    from tpudist_torch.metrics import MetricsLogger, log0
    from tpudist_torch.serve import scheduler as sched
    from tpudist_torch.serve.engine import ServeEngine, init_params

    model_cfg = ModelConfig(
        name=args.model, vocab_size=args.vocab_size,
        n_layers=args.n_layers, d_model=args.d_model,
        n_heads=args.n_heads, n_kv_heads=args.n_kv_heads,
        d_ff=args.d_ff, max_seq_len=args.max_seq)
    dtype = getattr(torch, args.dtype)
    engine = ServeEngine(model_cfg, slots=args.slots, max_seq=args.max_seq,
                         prompt_pad=args.prompt_pad, decode_k=args.decode_k,
                         layout=args.kv_layout, dtype=dtype,
                         device=args.device)
    os.makedirs(args.save_dir, exist_ok=True)
    metrics = MetricsLogger(path=os.path.join(args.save_dir,
                                              "metrics.jsonl"))
    params = init_params(model_cfg, seed=args.seed, device=engine.device)
    engine.warmup(params)
    requests = sched.make_requests(
        args.requests, prompt_pad=args.prompt_pad,
        vocab_size=args.vocab_size, max_new=args.max_new_tokens,
        rate=args.request_rate, seed=args.seed)
    summary = sched.run_serve(engine, params, requests, metrics=metrics)
    summary["model"] = args.model
    summary["dtype"] = args.dtype
    summary["device"] = device_name(engine.device)
    cache_bytes = engine.spec.bytes
    summary["kv_cache_bytes"] = cache_bytes
    metrics.log(kind="serve",
                **{k: v for k, v in summary.items()
                   if k not in ("results", "thresholds")})
    metrics.close()

    log0(f"tpudist: serve {summary['status']}: "
         f"{summary['completed']}/{summary['requests']} requests, "
         f"{summary['generated_tokens']} tokens in "
         f"{summary['wall_s']:.3f}s "
         f"({summary['tokens_per_sec_per_chip']} tok/s/chip), "
         f"ttft p99 {summary['ttft_p99_s']}s, "
         f"itl p99 {summary['itl_p99_s']}s "
         f"[{summary['device']}, {args.dtype}, "
         f"kv cache {cache_bytes / 2**20:.2f} MB]")
    if args.bench_out:
        _write_bench(args.bench_out, summary)
        log0(f"tpudist: serve bench -> {args.bench_out}")
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
            "e2e_p99_s", "n_chips", "arrived", "admitted",
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
    args = parse_args(argv)
    verdict_path = os.environ.get("TPUDIST_VERDICT_PATH")
    status = slo_lib.FAIL
    try:
        summary = run(args)
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
