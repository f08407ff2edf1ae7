#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``tpudist_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py              # the acceptance run
    python3 chip_smoke.py --profile    # plus a torch.profiler breakdown

Phases, each of which fails the script (non-zero exit, no result line):

1. device: the card's name and power limit; TF32 switched off for f32
   matmuls and convolutions, so f32 means f32;
2. build: the CUDA kernel of the serving path, from the sources in the
   checkout (``nvcc`` for sm_90a);
3. kernel vs plain: each kernel's wrapper against its plain PyTorch
   version on the card over the listed shapes (f32 within 1e-4, bf16
   within 3e-2), and its time beside its bound, the plain version's and
   one PyTorch library call's at the serving path's shape;
4. the serving slice at full width (BASELINE config #5, f32): warmup and
   16 requests through ``ServeEngine`` + ``run_serve`` with the launch
   counts set to 0 just before and read just after, every request
   completed, and one prefill's logits through the engine (kernel)
   against the non-cached forward through the plain version.

The last two lines are the kernels' JSON record and the result line
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense): f32 outside the tensor
# cores (the flash kernel's f32 path refuses TF32), bf16 tensor cores,
# HBM3 bandwidth
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12
ATOL = {"float32": 1e-4, "bfloat16": 3e-2}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def time_ms(torch, fn, *, warmup: int = 3, runs: int = 25,
            inner: int = 10) -> float:
    """Median over ``runs`` of the mean time of ``inner`` back-to-back
    calls, by CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def attention_bound(b, s, sk, h, kv, hd, dtype: str, causal: bool):
    """(bound_ms, bound_by) of one attention forward: the larger of the
    FLOPs of the two products over the peak for ``dtype`` and the bytes
    of q, k, v, o and lse (each once) over HBM bandwidth. Causal counts
    the s(s+1)/2 query-key pairs the mask keeps."""
    pairs = s * (s + 1) // 2 if causal else s * sk
    flops = 4 * b * h * hd * pairs
    elt = 4 if dtype == "float32" else 2
    nbytes = elt * (2 * b * s * h * hd + 2 * b * sk * kv * hd) \
        + 4 * b * h * s
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_flash(torch, fa, F):
    """Phase 3: the flash kernel against its plain version, and its
    times at the serving path's shape. Returns the kernel's record."""
    from tpudist_torch.ops.rope import apply_rope

    shapes = [(1, 512, 16, 16, 128, "float32", True, False)]   # serving
    for (b, s, h) in ((4, 512, 8), (1, 2048, 4)):            # selfcheck
        for kv in ((8, 2) if h == 8 else (4, 2)):
            for dt in ("bfloat16", "float32"):
                for causal in (True, False):
                    for rope in (False, True):
                        shapes.append((b, s, h, kv, 128, dt, causal, rope))
    for dt in ("bfloat16", "float32"):                       # hd 256
        shapes.append((1, 512, 4, 2, 256, dt, True, True))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    bad = []
    serving_err = None
    print(f"{'shape':44s} {'o err':>10s} {'lse err':>10s} {'atol':>7s}")
    for (b, s, h, kv, hd, dt, causal, rope) in shapes:
        dtype = getattr(torch, dt)
        q = torch.randn(b, s, h, hd, device="cuda", generator=gen).to(dtype)
        k = torch.randn(b, s, kv, hd, device="cuda", generator=gen).to(dtype)
        v = torch.randn(b, s, kv, hd, device="cuda", generator=gen).to(dtype)
        cos = sin = None
        if rope:
            ang = torch.rand(s, hd // 2, device="cuda", generator=gen) * 6.3
            cos, sin = ang.cos(), ang.sin()
        with torch.no_grad():
            if rope:
                o = fa.flash_attention(q, k, v, cos=cos, sin=sin,
                                       causal=causal)
                qr, kr = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
                _, lse = fa.flash_attention_with_lse(qr, kr, v,
                                                     causal=causal)
            else:
                o, lse = fa.flash_attention_with_lse(q, k, v,
                                                     causal=causal)
            torch.cuda.synchronize()
            po, plse = fa.flash_attention_plain(q, k, v, cos=cos, sin=sin,
                                                causal=causal)
        o_err = (o.float() - po.float()).abs().max().item()
        l_err = (lse - plse).abs().max().item()
        name = (f"b{b} s{s} h{h} kv{kv} hd{hd} {dt} "
                f"{'causal' if causal else 'full'}"
                f"{' rope' if rope else ''}")
        ok = max(o_err, l_err) <= ATOL[dt] and bool(
            torch.isfinite(o.float()).all() and torch.isfinite(lse).all())
        print(f"{name:44s} {o_err:10.3e} {l_err:10.3e} {ATOL[dt]:7.0e}"
              f"{'' if ok else '  FAIL'}")
        if not ok:
            bad.append(name)
        if serving_err is None:
            serving_err = max(o_err, l_err)
    if bad:
        fail(f"flash kernel disagrees with its plain version on "
             f"{len(bad)} shape(s): {bad}")

    b, s, h, kv, hd = 1, 512, 16, 16, 128
    q, k, v = (torch.randn(b, s, n, hd, device="cuda", generator=gen)
               for n in (h, kv, kv))
    with torch.no_grad():
        kernel_ms = time_ms(torch, lambda: fa.flash_attention(q, k, v))
        plain_ms = time_ms(torch, lambda: fa.flash_attention_plain(q, k, v))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
    bound_ms, bound_by = attention_bound(b, s, s, h, kv, hd, "float32",
                                         True)
    print(f"flash_attention_fwd at b{b} s{s} h{h} kv{kv} hd{hd} float32 "
          f"causal: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"scaled_dot_product_attention {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by})")
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "tpudist_torch/csrc/flash_attention_fwd.cu",
            "replaces": "tpudist/ops/pallas/flash_attention.py:149",
            "launches": None, "max_abs_err": serving_err,
            "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "shape": f"b{b} s{s} h{h} kv{kv} hd{hd} float32 causal"}


def serve_slice(torch, fa, profile: bool):
    """Phase 4: the serving slice at full width. Returns the flash
    kernel's launch count from the main path's run."""
    from tpudist_torch.config import ModelConfig
    from tpudist_torch.models import transformer
    from tpudist_torch.serve import scheduler as sched
    from tpudist_torch.serve.engine import ServeEngine, init_params

    cfg = ModelConfig(name="transformer")
    engine = ServeEngine(cfg, slots=8, max_seq=1024, prompt_pad=512,
                         decode_k=8, dtype=torch.float32, device="cuda")
    params = init_params(cfg, seed=0, device="cuda")
    n_params = sum(p.numel() for p in params.parameters())
    print(f"serve slice: V{cfg.vocab_size} L{cfg.n_layers} d{cfg.d_model} "
          f"h{cfg.n_heads} kv{cfg.n_kv_heads} d_ff{cfg.d_ff} float32; "
          f"params {n_params * 4 / 1e9:.3f} GB, kv cache "
          f"{engine.spec.bytes / 1e9:.3f} GB; slots {engine.slots} "
          f"max_seq {engine.max_seq} prompt_pad {engine.prompt_pad} "
          f"decode_k {engine.decode_k}")
    requests = sched.make_requests(16, prompt_pad=engine.prompt_pad,
                                   vocab_size=cfg.vocab_size, max_new=32,
                                   rate=0.0, seed=0)

    fa.launches = 0
    t0 = time.perf_counter()
    engine.warmup(params)
    warm_s = time.perf_counter() - t0
    summary = sched.run_serve(engine, params, requests)
    torch.cuda.synchronize()
    launches = fa.launches

    prefills = summary["admitted"] + 1          # + the warmup's
    want = cfg.n_layers * prefills
    print(f"serve slice: {summary['completed']}/{summary['requests']} "
          f"requests, {summary['generated_tokens']} tokens in "
          f"{summary['wall_s']} s; warmup {warm_s:.3f} s; flash kernel "
          f"launches {launches} (want n_layers x prefills = "
          f"{cfg.n_layers} x {prefills} = {want})")
    print(f"serve slice: tokens/s/chip {summary['tokens_per_sec_per_chip']}"
          f"; ttft p50 {summary['ttft_p50_s']} s p99 "
          f"{summary['ttft_p99_s']} s; itl p50 {summary['itl_p50_s']} s "
          f"p99 {summary['itl_p99_s']} s; e2e p50 {summary['e2e_p50_s']} "
          f"s p99 {summary['e2e_p99_s']} s; SLO {summary['status']}")
    if summary["completed"] != len(requests) or summary["truncated"]:
        fail(f"serve slice completed {summary['completed']}/"
             f"{len(requests)} ({summary['truncated']} truncated)")
    if launches != want:
        fail(f"flash kernel launched {launches} times in the serve run, "
             f"want {want}")
    for rid, res in summary["results"].items():
        toks = res["tokens"]
        if len(toks) != 32 or not all(0 <= t < cfg.vocab_size
                                      for t in toks):
            fail(f"request {rid} produced {toks!r}")

    # one prefill's last-position logits through the engine (cached
    # path, kernel, q/k rotated up front) against the non-cached forward
    # with RoPE fused into the plain version
    def plain_attention(q, k, v, *, cos=None, sin=None, causal=True):
        return fa.flash_attention_plain(q, k, v, cos=cos, sin=sin,
                                        causal=causal)[0]
    plain_attention.accepts_rope = True

    req = requests[0]
    n0 = fa.launches
    got = engine.prefill_logits(params, engine.init_state(),
                                req.tokens[None, :], req.prompt_len, 0)[0]
    if fa.launches != n0 + cfg.n_layers:
        fail("the engine's prefill did not run the flash kernel")
    tokens = torch.as_tensor(req.tokens[None, :], dtype=torch.int64,
                             device="cuda")
    with torch.no_grad():
        ref = transformer.apply(params, tokens, cfg, dtype=torch.float32,
                                attn_impl=plain_attention)[
            0, req.prompt_len - 1]
    err = (got - ref).abs().max().item()
    same = int(got.argmax()) == int(ref.argmax())
    print(f"serve slice: prefill logits (rid {req.rid}, prompt_len "
          f"{req.prompt_len}) engine vs plain forward: max |d| {err:.3e} "
          f"(atol 1e-3), argmax equal {same}")
    if got.shape != (cfg.vocab_size,) or not bool(torch.isfinite(got).all()):
        fail(f"prefill logits shape {tuple(got.shape)} or not finite")
    if err > 1e-3:
        fail(f"prefill logits differ from the plain forward by {err:.3e}")

    if profile:
        profile_serve(torch, engine, params, requests)
    return launches


def profile_serve(torch, engine, params, requests):
    """Device time by kernel in two windows at the slice's shapes, one
    prefill per slot and then one decode superstep over the full batch,
    and the device's busy share of each window's wall time (the
    profiler's own host cost is inside the wall)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    def window(name, fn):
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        rows = [(e.key, e.device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_time_total > 0 and e.device_type.name == "CUDA"]
        busy = sum(r[1] for r in rows)
        print(f"profile: {name}: {wall:.3f} ms wall, device kernel time "
              f"{busy:.3f} ms ({100 * busy / wall:.1f}% busy)")
        for key, ms, count in sorted(rows, key=lambda r: -r[1])[:8]:
            print(f"profile:   {ms:9.3f} ms {count:5d}x  {key[:80]}")

    state = engine.init_state()

    def prefills():
        nonlocal state
        for slot, req in enumerate(requests[:engine.slots]):
            state, first = engine.prefill(params, state,
                                          req.tokens[None, :],
                                          req.prompt_len, slot,
                                          req.max_new)

    def superstep():
        engine.decode(params, state)[1].cpu()

    window(f"{engine.slots} prefills", prefills)
    window(f"one decode superstep ({engine.decode_k} steps, "
           f"{engine.slots} slots)", superstep)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="add a torch.profiler breakdown of the serve "
                         "slice")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from tpudist_torch.ops.cuda import build
    from tpudist_torch.ops.cuda import flash_attention as fa

    # phase 1: device
    card = card_line()
    print(card)
    print(f"device: {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("device: TF32 off for f32 matmuls and cuDNN convolutions")

    # phase 2: build every kernel of the path from the checkout
    res = build.build(fa.LIBRARY, fa.SOURCES)
    ptxas = [ln.strip() for ln in res.log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"build: {fa.LIBRARY}: {res.path.name} ({res.seconds:.2f} s): "
          + "; ".join(ptxas))

    # phase 3: kernel vs plain, timings
    record = check_flash(torch, fa, F)

    # phase 4: the serving slice at full width
    record["launches"] = serve_slice(torch, fa, args.profile)
    if record["launches"] < 1:
        fail("the serving path launched the flash kernel no time")

    print(card)
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
