#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``tpudist_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py              # the acceptance run
    python3 chip_smoke.py --profile    # plus a torch.profiler breakdown

Phases, each of which fails the script (non-zero exit, no result line):

1. device: the card's name and power limit; TF32 switched off for f32
   matmuls and convolutions, so f32 means f32;
2. build: the three CUDA libraries (flash-attention forward; the dq,
   dk/dv and merged backward kernels; the fused LM-head cross-entropy
   forward and backward) from the sources in the checkout, one ``nvcc``
   for sm_90a each, started together; ptxas's register and spill report;
3. kernels vs plain: the forward kernel against its plain version (o and
   lse within f32 1e-4 / bf16 3e-2, two calls bitwise equal) on 41
   shapes (35 that take its 64-row blocks with split kv tiles, 6 whose
   grids take its 128-row blocks), and the three backward kernels,
   through the autograd Function, against ``flash_attention_bwd_plain``
   (each gradient's max |d| / max |plain| within f32 1e-4 / bf16 5e-2, a
   nonzero lse cotangent, two calls bitwise equal, the predicted route)
   on 55 shapes, 10 of them at the edges of the split pair's tiling, 6
   at the merged kernel's (seq 128 and 256, seq 512 over 256 keys) and
   the slice's three (b8 s2048 f32, b8 s512 f32 and bf16);
   each kernel's time at its main paths' shapes beside its bound (on the
   tensor cores' peak at hd 128), the plain version's and one PyTorch
   library call's (``scaled_dot_product_attention``, forward or
   ``autograd.grad`` through it): the forward at the serving prefill (b1
   s512 f32), the training slice (b8 s2048 f32, RoPE in the kernel) and
   phase 9 (b8 s512 bf16, RoPE in the kernel), where the library call
   takes q/k rotated before it and its time excludes the rotation; the
   dq + dk/dv pair's sum beside that call's whole backward; the merged
   kernel at seq 512 in f32 (phase 6) and bf16 (phase 9), with the split
   pair called on its inputs as a yardstick;
   3c. the fused LM-head kernels (tensor cores, ``mma.sync``: f32 as
   3xTF32, bf16), through their autograd Function, against
   ``fused_xent_fwd_plain`` / ``fused_xent_bwd_plain`` on 11 shapes:
   ``tpudist/selfcheck.py``'s four (d 256 f32), the bench geometry (t
   1024, V 32000, d 2048, bf16), phase 9's (t 4096, bf16), the slice's
   (t 16384, f32) and four at the edges of the kernels' tiling (t, V
   and d off the tiles and off 16-byte rows; d not a multiple of 8 in
   bf16; just over one backward chunk; t 16), two calls bitwise equal;
   their times at the slice's shape (f32) and at phase 9's (bf16)
   beside their bounds on the tensor cores, the plain versions' and
   ``F.cross_entropy(h @ emb.T)``'s in the same dtype (forward, and
   ``autograd.grad`` through it), and the head's peak device memory at
   the slice's shape, fused against that;
4. the serving slice at full width (BASELINE config #5, f32) on the
   graph engine: warmup (each body once eagerly, then the prefill and
   the decode ladder (8, 4, 2) captured as CUDA graphs) and 16 requests
   through ``ServeEngine`` + ``run_serve``, every request completed, the
   program pin (1 prefill, 3 decode graphs), the flash forward launched
   exactly n_layers x prefills (counted through the engine's graph
   accounting: a replay does not move the wrapper's counter), every
   request's tokens and one replayed prefill's first token against the
   engine's bodies called eagerly (a check, not a route), and that
   prefill's logits against the non-cached forward through the plain
   version;
   4b. serve overload on the same engine: a Poisson stream of 64
   requests at twice the requests/s phase 4 completed, a queue cap of 8,
   a TTFT deadline of 4 x phase 4's TTFT p50 and the ladder walked by
   the pressure controller: the exact shed partition, the pin, every
   admitted request completed with the tokens it gets in an unloaded
   run, the flash launches exact; then two runs of one seed on virtual
   time with equal summaries;
5. the train CLI at full width (BASELINE config #5, f32, batch 8,
   ``--lm-head auto``) at seq 2048 for 2 epochs (8 steps): the dq and
   dk/dv kernels in every layer's backward;
6. the same at seq 512 (the JAX package's bench shape) for 1 epoch (4
   steps): the merged backward kernel;
7. one full-width training step at seq 512 and 2048, and at 2048 with
   the fused head: the loss and every param grad through the kernels
   against the plain versions on the card (f32, 1e-4 of each tensor's
   largest element); with the fused head it also reports the head alone
   (lse, dh, dE) against float64, kernels and plain versions;
8. the train CLI at seq 2048 with ``--lm-head fused``, 1 epoch (4 steps):
   the fused head's kernels beside the flash kernels;
9. the train CLI at seq 512 in bf16 with ``--lm-head auto`` and
   ``--adam-nu-dtype bfloat16``, the device memory pinned so that auto
   picks the fused head, 1 epoch (4 steps);
10. data parallelism: (a) the train CLI as one process per visible card
   under the ``TPUDIST_COORDINATOR`` / ``TPUDIST_NUM_PROCESSES`` /
   ``TPUDIST_PROCESS_ID`` contract, NCCL, at seq 512, f32, ``--lm-head
   fused``, global batch 8, 1 epoch (4 steps): the contract on rank 0
   only, every rank's verdict and the final one, and each rank's own
   launch counts; (b) two ranks on the one card: NCCL refused (two ranks
   cannot share a card), then gloo passed explicitly (host copies) for
   two steps of the engine's data-parallel step at local batch 4, against
   one process at the global batch of 8: the losses and the gradients
   each step hands to Adam within f32 1e-4 (of each gradient's largest
   element), the two ranks' params bitwise equal, the params after the 2
   steps within 1e-4 of each param's largest element wherever the first
   gradient's |g| is at least 1 % of that tensor's largest (the elements
   left out are counted), and the step time labelled as gloo through
   host memory;
11. the superstep (k training steps a dispatch, CUDA graphs): (a) phase
   9's configuration with ``--log-every 4`` over 80 samples (10 steps
   an epoch: two full windows of k = 4 and a 2-step tail), 2 epochs,
   per-step and as the superstep under a ``TPUDIST_STAGING_BUDGET_MB``
   that holds two 4-step slabs of the staged token ids (each epoch
   streams in 3 slabs): each epoch's Avg and eval loss bitwise equal
   between the two, the programs pinned at 2, the replays those of the
   windows, both step times, the capture time, the graph pool and the
   staging verdict; (b) the MLP at the reference defaults (31 steps an
   epoch, auto k = 25), per-step and as the superstep in turns
   (per-step, superstep, superstep, per-step), the Avg and eval losses
   bitwise equal, the steps/s of each run; (c) phase 10a's spawn at
   80 samples with ``--log-every 4 --steps-per-dispatch 4``, the NCCL
   all-reduce captured: every rank's verdict, launches, programs and
   replays;
12. the measured-probe autotuner (``--autotune probe``), each trial
   printed (k, staging budget, remat, accumulation, steps/s and spread,
   peak reserved memory, graph pool, reserved memory after it, feasible
   or its error) with the reserved memory before and after the search:
   (a) the MLP at the reference defaults (the k ladder 1, 2, 4, 10, 20,
   25): the search succeeds from a probe within its 12 trials (plus two
   confirmations), the commit measures at least the heuristic start's
   steps/s, the card holds at most one trial's graph pool more after
   the search, every epoch's Avg and eval loss is bitwise an untuned
   run's at the committed point, and a second run on the same cache is
   a hit with 0 trials at the same point; then an OOM raised inside a
   probe's capture comes back as a pruned trial with the capture
   closed, the counters and reserved memory where they were, and the
   same probe then measures; (b) one full-width step (seq 512, f32,
   fused head) with and without ``--remat``, each replayed from a
   graph, the loss and every grad within f32 1e-4; then phase 11a's
   configuration at ``--log-every 8`` over 128 samples (16 steps; the k
   ladder 1, 2, 4, 8), 1 epoch, ``--autotune-trials 8``: the same
   search checks, the remat and accumulation points measured inside
   captured probes or pruned with their error, the timed run's launches
   exact with the probes' shown apart, its losses bitwise an untuned
   run's at the committed point (within f32 1e-4 of the committed
   schedule alone if a math knob moved), and the cached rerun;
13. the observability every default run writes (on in every CLI run
   above): (a) phase 11a's superstep run's directory: both traces with
   the JAX span names and nothing dropped, the beacon at the final
   step, a ``kind=hosts`` record an epoch, the memory ledger (its
   partition summing to the card's memory), ``kind=timing`` with
   ``0 < mfu <= 1.05`` over a flop count equal to its closed form,
   ``hbm_source`` ``memory_stats`` and a watermark at or above the run's
   ``max_memory_allocated``, ``run_id`` on every record; then the same
   configuration with ``--trace off --stall-timeout-s 0 --hbm-sample-s
   0`` and on again: the losses bitwise, the programs, replays and
   launches the same, the step times in turns; (b) phase 4's serving
   configuration through ``python -m tpudist_torch.serve`` (its
   ``run``), traced and with ``--trace off``: one slot track per slot
   that served, the ledger, the tokens equal, the program pin, the
   flash launches exact, tokens/s/chip of each; (c) a CUDA graph
   captured while an ``HbmSampler`` reads every millisecond (the capture
   holds, its replay equals the eager body), then a stall drill: a
   ``FlightRecorder`` with a 2 s window and no progress while that
   graph replays writes ``flightrec.worker0`` with the threads' stacks
   and the card's ``memory_stats``, the replays' output unchanged.

Phases 4, 4b, 5-6, 8-9, 10a, 11a, 11c, 12b, 13a and 13b are the main
paths: each
runs with every launch count set to 0 just before and read just after
(10a and 11c in each rank's process; 12b's timed run, not its probes,
which restore the counters and report their launches apart), and each
kernel must have launched the
exact number of times its path calls it, counting the launches a CUDA
graph's replays ran (the superstep's record of its captures times its
replays; a replay does not move the wrappers' counters). The training
phases also check the stdout contract, a falling loss and the
``success`` verdict files.
``--profile`` adds torch.profiler breakdowns of the serving windows (8
prefills and one decode superstep, replayed and as eager bodies, with
the flash kernels counted in the replayed prefills) and of two training
steps at seq 2048 (plain and
fused head), 512 and 512 in bf16 with the fused head (phase 9's
configuration; device time by kernel, busy share), of one replayed
superstep against as many per-step steps (phase 11's MLP at k = 25 and
seq 512 bf16 at k = 4; wall, kernel time, busy share), and the rates
mma.sync reaches (``tpudist_torch/csrc/mma_peak.cu``).
The last two lines are the kernels' JSON record and the result line
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import shutil
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): f32 outside the tensor
# cores (the flash backward at hd 256 does f32 FMA), bf16 tensor cores,
# HBM3 bandwidth
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# the flash forward, the flash backward at hd 128 and the fused LM-head
# kernels run their f32 products on the tensor cores as 3xTF32:
# three TF32 products for each f32 one, so a third of the 495 TFLOP/s
# TF32 peak
TC_PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12
ATOL = {"float32": 1e-4, "bfloat16": 3e-2}
# backward gradients: max |kernel - plain| / max |plain|
BWD_RTOL = {"float32": 1e-4, "bfloat16": 5e-2}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def build_all(build, fa, fx):
    """Phase 2: build every kernel library of the port's paths from the
    checkout, one nvcc each, all started together; print ptxas's
    register and spill report."""
    from concurrent.futures import ThreadPoolExecutor

    libs = ((fa.LIBRARY, fa.SOURCES), (fa.BWD_LIBRARY, fa.BWD_SOURCES),
            (fx.LIBRARY, fx.SOURCES))
    with ThreadPoolExecutor(len(libs)) as pool:
        results = list(pool.map(lambda lib: build.build(*lib), libs))
    for (name, _), res in zip(libs, results):
        ptxas = [ln.strip() for ln in res.log.splitlines()
                 if "registers" in ln or "spill" in ln
                 or "Compiling entry" in ln]
        print(f"build: {name}: {res.path.name} ({res.seconds:.2f} s)")
        for ln in ptxas:
            print(f"build:   {ln}")


def time_ms(torch, fn, *, warmup: int = 3, runs: int = 25,
            inner: int = 10) -> float:
    """Median over ``runs`` of the mean device time of ``inner``
    back-to-back calls, by CUDA events, after ``warmup`` calls. Each run
    first queues a ~10 ms spin on the card, so the host has queued the
    calls before the start event: a call shorter than its own host-side
    cost is timed on the device, not at the host's pace."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)   # cycles
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def attention_bound(b, s, sk, h, kv, hd, dtype: str, causal: bool,
                    rope: bool = False):
    """(bound_ms, bound_by) of one attention forward: the larger of the
    FLOPs of the two products over the tensor cores' peak for ``dtype``
    (``TC_PEAK_FLOPS``: 3xTF32 for f32) and the bytes
    of q, k, v, o and lse (each once; and the f32 RoPE tables with
    ``rope``) over HBM bandwidth. Causal counts the s(s+1)/2 query-key
    pairs the mask keeps."""
    pairs = s * (s + 1) // 2 if causal else s * sk
    flops = 4 * b * h * hd * pairs
    elt = 4 if dtype == "float32" else 2
    nbytes = elt * (2 * b * s * h * hd + 2 * b * sk * kv * hd) \
        + 4 * b * h * s + (2 * 4 * s * hd // 2 if rope else 0)
    t_ops = flops / TC_PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_flash(torch, fa, F):
    """Phase 3: the flash kernel against its plain version, two calls
    bitwise equal, on every shape; and its times at the main paths'
    shapes. Returns the kernel's record."""
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
    # grids that fill the card: the kernel's 128-row blocks (the shapes
    # above take its 64-row blocks with split kv tiles)
    for dt in ("bfloat16", "float32"):
        shapes += [(8, 512, 16, 16, 128, dt, True, True),
                   (8, 512, 16, 4, 128, dt, False, dt == "bfloat16"),
                   (8, 512, 16, 8, 256, dt, True, True)]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    bad = []
    serving_err = None
    print(f"{'shape':44s} {'o err':>10s} {'lse err':>10s} {'atol':>7s} "
          f"bitwise")
    for (b, s, h, kv, hd, dt, causal, rope) in shapes:
        dtype = getattr(torch, dt)
        q = torch.randn(b, s, h, hd, device="cuda", generator=gen).to(dtype)
        k = torch.randn(b, s, kv, hd, device="cuda", generator=gen).to(dtype)
        v = torch.randn(b, s, kv, hd, device="cuda", generator=gen).to(dtype)
        cos = sin = None
        if rope:
            ang = torch.rand(s, hd // 2, device="cuda", generator=gen) * 6.3
            cos, sin = ang.cos(), ang.sin()

        def run():
            if rope:
                o = fa.flash_attention(q, k, v, cos=cos, sin=sin,
                                       causal=causal)
                qr, kr = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
                return o, fa.flash_attention_with_lse(qr, kr, v,
                                                      causal=causal)[1]
            return fa.flash_attention_with_lse(q, k, v, causal=causal)
        with torch.no_grad():
            o, lse = run()
            o2, lse2 = run()
            torch.cuda.synchronize()
            po, plse = fa.flash_attention_plain(q, k, v, cos=cos, sin=sin,
                                                causal=causal)
        o_err = (o.float() - po.float()).abs().max().item()
        l_err = (lse - plse).abs().max().item()
        bitwise = torch.equal(o, o2) and torch.equal(lse, lse2)
        name = (f"b{b} s{s} h{h} kv{kv} hd{hd} {dt} "
                f"{'causal' if causal else 'full'}"
                f"{' rope' if rope else ''}")
        ok = max(o_err, l_err) <= ATOL[dt] and bitwise and bool(
            torch.isfinite(o.float()).all() and torch.isfinite(lse).all())
        print(f"{name:44s} {o_err:10.3e} {l_err:10.3e} {ATOL[dt]:7.0e} "
              f"{bitwise}{'' if ok else '  FAIL'}")
        if not ok:
            bad.append(name)
        if serving_err is None:
            serving_err = max(o_err, l_err)
    if bad:
        fail(f"flash kernel disagrees with its plain version (or is not "
             f"deterministic) on {len(bad)} shape(s): {bad}")

    # the main paths' shapes: serving prefill (b1 s512, no RoPE), the
    # training slice (b8 s2048, RoPE in the kernel) and phase 9 (b8 s512
    # bf16, RoPE in the kernel)
    rows = []
    few = dict(warmup=1, runs=5, inner=2)
    for (b, s, h, kv, hd, dt, rope) in (
            (1, 512, 16, 16, 128, "float32", False),
            (8, 2048, 16, 16, 128, "float32", True),
            (8, 512, 16, 16, 128, "bfloat16", True)):
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(b, s, n, hd, device="cuda",
                               generator=gen).to(dtype)
                   for n in (h, kv, kv))
        cos = sin = None
        if rope:
            ang = torch.rand(s, hd // 2, device="cuda", generator=gen) * 6.3
            cos, sin = ang.cos(), ang.sin()
        big = b * s > 4096   # the plain version's scores take seconds
        with torch.no_grad():
            kernel_ms = time_ms(torch, lambda: fa.flash_attention(
                q, k, v, cos=cos, sin=sin))
            plain_ms = time_ms(torch, lambda: fa.flash_attention_plain(
                q, k, v, cos=cos, sin=sin), **(few if big else {}))
            # the library call takes q/k rotated up front: its time
            # excludes the rotation
            qr, kr = ((apply_rope(q, cos, sin), apply_rope(k, cos, sin))
                      if rope else (q, k))
            qt, kt, vt = (x.transpose(1, 2) for x in (qr, kr, v))
            library_ms = time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True))
        bound_ms, bound_by = attention_bound(b, s, s, h, kv, hd, dt, True,
                                             rope)
        shape = (f"b{b} s{s} h{h} kv{kv} hd{hd} {dt} causal"
                 f"{' rope' if rope else ''}")
        note = " (on q/k rotated before it, not timed)" if rope else ""
        print(f"flash_attention_fwd at {shape}: kernel {kernel_ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, scaled_dot_product_attention "
              f"{library_ms:.4f} ms{note}, bound {bound_ms:.4f} ms "
              f"({bound_by})")
        rows.append({"shape": shape, "ms": kernel_ms, "plain_ms": plain_ms,
                     "library_ms": library_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by})
        del q, k, v, qr, kr, qt, kt, vt
        torch.cuda.empty_cache()
    serving = rows[0]
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "tpudist_torch/csrc/flash_attention_fwd.cu",
            "replaces": "tpudist/ops/pallas/flash_attention.py:149",
            "launches": None, "max_abs_err": serving_err,
            "ms": serving["ms"], "plain_ms": serving["plain_ms"],
            "bound_ms": serving["bound_ms"],
            "bound_by": serving["bound_by"],
            "library_ms": serving["library_ms"], "shape": serving["shape"],
            "timings": rows}


def backward_peak(hd: int):
    """The peak a flash backward kernel's operations are bounded by: every
    backward kernel runs on the tensor cores at hd 128 (``TC_PEAK_FLOPS``)
    and does f32 FMA on the CUDA cores at hd 256 (``PEAK_FLOPS``)."""
    return TC_PEAK_FLOPS if hd == 128 else PEAK_FLOPS


def backward_bound(b, s, h, kv, hd, dtype: str, causal: bool,
                   products: int, outputs: str, peak):
    """(bound_ms, bound_by) of one flash backward kernel: ``products``
    matrix products over the kept query-key pairs (dq 3, dk/dv 4, merged
    5) over ``peak[dtype]`` (:func:`backward_peak`), against the bytes of
    q, k, v, do, lse, delta and the RoPE tables read once and of
    ``outputs`` (a string of q/k/v: which gradients it writes) written
    once. The merged kernel's workspace is its own traffic, not the
    function's."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = products * 2 * b * h * hd * pairs
    elt = 4 if dtype == "float32" else 2
    qsz, ksz = b * s * h * hd, b * s * kv * hd
    nbytes = (elt * (2 * qsz + 2 * ksz) + 2 * 4 * b * h * s
              + 2 * 4 * s * hd // 2
              + elt * sum(qsz if o == "q" else ksz for o in outputs))
    t_ops = flops / peak[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _bwd_inputs(torch, gen, b, s, h, kv, hd, dtype, rope, sk=None):
    sk = s if sk is None else sk
    q = torch.randn(b, s, h, hd, device="cuda", generator=gen).to(dtype)
    k = torch.randn(b, sk, kv, hd, device="cuda", generator=gen).to(dtype)
    v = torch.randn(b, sk, kv, hd, device="cuda", generator=gen).to(dtype)
    do = torch.randn(b, s, h, hd, device="cuda", generator=gen).to(dtype)
    dlse = torch.randn(b, h, s, device="cuda", generator=gen) * 0.1
    cos = sin = None
    if rope:
        ang = torch.rand(s, hd // 2, device="cuda", generator=gen) * 6.3
        cos, sin = ang.cos(), ang.sin()
    return q, k, v, do, dlse, cos, sin


def check_flash_bwd(torch, fa):
    """Phase 3b: the three backward kernels, through the autograd
    Function, against ``flash_attention_bwd_plain`` on the same forward
    outputs; each gradient judged by max |d| / max |plain| (f32 1e-4,
    bf16 5e-2), two calls bitwise equal, and the route the Python rule
    (``uses_merged_backward``) predicts. Beside selfcheck's shapes and the
    slice's, shapes at the edges of the split pair's tensor-core tiling:
    seq 384 (the split pair, as in the JAX package) and 640, four q heads
    a kv head at seq 1024, a non-causal seq 512 over 1024 keys and a grid
    of 64 blocks (b1 h4 s2048); and at the merged kernel's: one key tile
    (seq 128, four q heads a kv head), two (seq 256) and a non-causal seq
    512 over 256 keys; each in f32 and bf16. The slice's shapes are b8
    h16 kv16 hd128 causal with RoPE: seq 2048 f32 (the split pair), seq
    512 f32 (phase 6) and bf16 (phase 9; the merged kernel). Returns each
    kernel's max |kernel - plain| over its own outputs at the slice's
    shapes, keyed by (kernel, dtype)."""
    shapes = []   # (b, s, sk, h, kv, hd, dtype, causal, rope)
    for (b, s, h) in ((4, 512, 8), (1, 2048, 4)):            # selfcheck
        for kv in ((8, 2) if h == 8 else (4, 2)):
            for dt in ("bfloat16", "float32"):
                for causal in (True, False):
                    for rope in (False, True):
                        shapes.append((b, s, s, h, kv, 128, dt, causal,
                                       rope))
    for dt in ("bfloat16", "float32"):                       # hd 256
        shapes.append((1, 512, 512, 4, 2, 256, dt, True, True))
        shapes.append((1, 1024, 1024, 4, 2, 256, dt, False, True))
    for dt in ("bfloat16", "float32"):                       # tiling edges
        shapes += [(2, 384, 384, 8, 2, 128, dt, True, True),
                   (2, 640, 640, 4, 4, 128, dt, True, True),
                   (2, 1024, 1024, 16, 4, 128, dt, True, True),
                   (2, 512, 1024, 8, 8, 128, dt, False, False),
                   (1, 2048, 2048, 4, 4, 128, dt, True, True)]
    for dt in ("bfloat16", "float32"):                       # merged edges
        shapes += [(4, 128, 128, 8, 2, 128, dt, True, True),
                   (4, 256, 256, 8, 8, 128, dt, True, True),
                   (4, 512, 256, 8, 4, 128, dt, False, False)]
    shapes.append((8, 2048, 2048, 16, 16, 128, "float32", True,
                   True))                                    # slice
    for dt in ("float32", "bfloat16"):                      # phases 6, 9
        shapes.append((8, 512, 512, 16, 16, 128, dt, True, True))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    bad, slice_err = [], {}
    print(f"{'backward shape':52s} {'kernel':>6s} {'dq':>9s} {'dk':>9s} "
          f"{'dv':>9s} {'tol':>6s} bitwise")
    for (b, s, sk, h, kv, hd, dt, causal, rope) in shapes:
        tol = BWD_RTOL[dt]
        q, k, v, do, dlse, cos, sin = _bwd_inputs(
            torch, gen, b, s, h, kv, hd, getattr(torch, dt), rope, sk)
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        counts = (fa.dq_launches, fa.dkv_launches, fa.dqkv_launches)
        o, lse = fa._Flash.apply(q, k, v, cos, sin, causal)
        grads = torch.autograd.grad((o, lse), (q, k, v), (do, dlse),
                                    retain_graph=True)
        again = torch.autograd.grad((o, lse), (q, k, v), (do, dlse))
        torch.cuda.synchronize()
        ran = [n for n, c0, c1 in zip(
            ("dq", "dkv", "dqkv"), counts,
            (fa.dq_launches, fa.dkv_launches, fa.dqkv_launches))
            if c1 > c0]
        with torch.no_grad():
            ref = fa.flash_attention_bwd_plain(
                q.detach(), k.detach(), v.detach(), o.detach(),
                lse.detach(), do, dlse, cos=cos, sin=sin, causal=causal)
        abs_errs = [(g.float() - r.float()).abs().max().item()
                    for g, r in zip(grads, ref)]
        errs = [e / max(r.float().abs().max().item(), 1e-30)
                for e, r in zip(abs_errs, ref)]
        bitwise = all(torch.equal(x, y) for x, y in zip(grads, again))
        finite = all(bool(torch.isfinite(g.float()).all()) for g in grads)
        want = (["dqkv"] if fa.uses_merged_backward(s, sk)
                else ["dq", "dkv"])
        ok = max(errs) <= tol and bitwise and finite and ran == want
        name = (f"b{b} s{s}{f' sk{sk}' if sk != s else ''} h{h} kv{kv} "
                f"hd{hd} {dt} {'causal' if causal else 'full'}"
                f"{' rope' if rope else ''}")
        print(f"{name:52s} {'+'.join(ran):>6s} {errs[0]:9.2e} "
              f"{errs[1]:9.2e} {errs[2]:9.2e} {tol:6.0e} {bitwise}"
              f"{'' if ok else '  FAIL'}")
        if not ok:
            bad.append(name)
        if b == 8:   # the slice's shapes: each kernel's own outputs
            outputs = {"dq": (0,), "dkv": (1, 2), "dqkv": (0, 1, 2)}
            for kname in ran:
                slice_err[kname, dt] = max(abs_errs[i]
                                           for i in outputs[kname])
        del q, k, v, o, lse, grads, again, ref
    torch.cuda.empty_cache()
    if bad:
        fail(f"flash backward kernels disagree with their plain version "
             f"(or are not deterministic, or took the wrong route) on "
             f"{len(bad)} shape(s): {bad}")
    return slice_err


def time_flash_bwd(torch, fa, F, slice_err):
    """Phase 3c: each backward kernel's time at the shapes its main paths
    give it (b8 h16 kv16 hd128 causal with RoPE: dq and dk/dv at seq 2048
    f32; the merged kernel at seq 512 in f32, phase 6, and in bf16, phase
    9), beside its bound, the plain backward's time and
    torch.autograd.grad through scaled_dot_product_attention at the same
    shape and dtype; the dq + dk/dv pair's sum, the function that library
    call computes, beside it; and at seq 512 the split pair called
    directly on the merged kernel's inputs, a yardstick (not a route).
    Returns the kernels' records (launches filled in by the training
    phases)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    records = {}
    for s, dt, kernels in ((2048, "float32", ("dq", "dkv")),
                           (512, "float32", ("dqkv",)),
                           (512, "bfloat16", ("dqkv",))):
        b, h, kv, hd = 8, 16, 16, 128
        q, k, v, do, dlse, cos, sin = _bwd_inputs(
            torch, gen, b, s, h, kv, hd, getattr(torch, dt), True)
        kw = dict(cos=cos, sin=sin, causal=True)
        with torch.no_grad():
            o, lse = fa._Flash.apply(q, k, v, cos, sin, True)
            delta = fa._delta(o, do, dlse)
            plain_ms = time_ms(torch, lambda: fa.flash_attention_bwd_plain(
                q, k, v, o, lse, do, dlse, **kw))
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        dout = do.transpose(1, 2)
        library_ms = time_ms(torch, lambda: torch.autograd.grad(
            out, (qt, kt, vt), dout, retain_graph=True))
        shape = f"b{b} s{s} h{h} kv{kv} hd{hd} {dt} causal rope"
        peak = backward_peak(hd)
        bound_peak = ("cuda cores fma" if peak is PEAK_FLOPS else
                      "tensor cores 3xTF32" if dt == "float32"
                      else "tensor cores bf16")
        for name in kernels:
            fn = {"dq": fa.flash_attention_bwd_dq,
                  "dkv": fa.flash_attention_bwd_dkv,
                  "dqkv": fa.flash_attention_bwd_dqkv}[name]
            with torch.no_grad():
                kernel_ms = time_ms(torch, lambda: fn(q, k, v, do, lse,
                                                      delta, **kw))
            products, outputs = {"dq": (3, "q"), "dkv": (4, "kv"),
                                 "dqkv": (5, "qkv")}[name]
            bound_ms, bound_by = backward_bound(b, s, h, kv, hd, dt, True,
                                                products, outputs, peak)
            print(f"flash_attention_bwd_{name} at {shape}: kernel "
                  f"{kernel_ms:.4f} ms, plain backward {plain_ms:.4f} ms, "
                  f"autograd.grad through scaled_dot_product_attention "
                  f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}, {bound_peak} "
                  f"{peak[dt] / 1e12:.0f} TFLOP/s)")
            timing = {"max_abs_err": slice_err.get((name, dt)),
                      "ms": kernel_ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "bound_peak": bound_peak, "library_ms": library_ms,
                      "shape": shape}
            if dt == "bfloat16":
                records[name]["bf16"] = timing
                continue
            records[name] = {
                "name": f"flash_attention_bwd_{name}", "route": "cuda",
                "source": "tpudist_torch/csrc/flash_attention_bwd.cu",
                "replaces": {"dq": "tpudist/ops/pallas/flash_attention.py"
                                   ":296",
                             "dkv": "tpudist/ops/pallas/flash_attention.py"
                                    ":354",
                             "dqkv": "tpudist/ops/pallas/flash_attention"
                                     ".py:423"}[name],
                "launches": None, **timing}
        if s == 2048:
            pair = [records["dq"], records["dkv"]]
            pair_ms = sum(r["ms"] for r in pair)
            bound_ms = sum(r["bound_ms"] for r in pair)
            for r in pair:
                r["pair_ms"] = pair_ms
            print(f"flash backward pair (dq + dk/dv) at {shape}: "
                  f"{pair_ms:.4f} ms, bound {bound_ms:.4f} ms; "
                  f"autograd.grad through scaled_dot_product_attention "
                  f"(all three gradients) {library_ms:.4f} ms "
                  f"({pair_ms / library_ms:.2f}x)")
        else:
            fa.dqkv_workspace_slots = None
            with torch.no_grad():
                fa.flash_attention_bwd_dqkv(q, k, v, do, lse, delta, **kw)
                slots = fa.dqkv_workspace_slots
                split_ms = time_ms(torch, lambda: (
                    fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw),
                    fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                               **kw)))
            rec = records["dqkv"] if dt == "float32" \
                else records["dqkv"]["bf16"]
            rec["split_pair_ms"] = split_ms
            rec["workspace_slots"] = slots
            print(f"flash backward at {shape}: merged kernel "
                  f"{rec['ms']:.4f} ms; the split pair (dq + dk/dv called "
                  f"directly, a yardstick, not a route) {split_ms:.4f} ms; "
                  f"the merged kernel's f32 workspace {slots} slots, "
                  f"{4 * slots * b * h * s * hd / 1e6:.1f} MB")
        del q, k, v, do, o, lse, delta, qt, kt, vt, out
        torch.cuda.empty_cache()
    return list(records.values())


def xent_bound(t, v, d, dtype: str, products: int, backward: bool):
    """(bound_ms, bound_by) of the fused head: ``products`` matrix
    products of 2 t V d operations over the tensor cores' peak for
    ``dtype`` (``TC_PEAK_FLOPS``: 3xTF32 for f32), against
    the bytes of h, E, the int64 targets and the f32 per-token vectors
    (loss and lse out; or lse and ct in, dh and dE out) moved once."""
    flops = products * 2 * t * v * d
    elt = 4 if dtype == "float32" else 2
    operands = elt * (t * d + v * d)
    nbytes = operands * (2 if backward else 1) + 8 * t + 2 * 4 * t
    t_ops = flops / TC_PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _xent_inputs(torch, gen, t, v, d, dtype):
    """selfcheck's data: h ~ N(0, 1), E ~ 0.02 N(0, 1), uniform targets."""
    h = torch.randn(t, d, device="cuda", generator=gen).to(dtype)
    emb = (torch.randn(v, d, device="cuda", generator=gen) * 0.02).to(dtype)
    tgt = torch.randint(0, v, (t,), device="cuda", generator=gen)
    return h, emb, tgt


def check_fused_xent(torch, fx):
    """Phase 3c: the fused LM-head kernels, through the autograd Function
    (mean loss, grads by ``torch.autograd.grad``), against
    ``fused_xent_fwd_plain`` / ``fused_xent_bwd_plain`` on the card.
    ``tpudist/selfcheck.py``'s shapes at d 256 f32 (loss rtol 1e-4; dh
    and dE rtol 1e-3, atol 5e-3/t), the bench geometry in bf16 (loss
    within 5e-2 of the f32 plain loss, grads finite and within 5e-2 of
    each gradient's largest element against the bf16 plain version), the
    slice's shape in f32 and four shapes at the edges of the kernels'
    tiling, each held to its dtype's tolerance; every shape also run
    twice, bitwise equal.
    The bf16 case at t 4096 (= b8 x s512, phase 9's shape) is above the
    backward's 2048-token chunk, so it holds the separate f32 dE
    accumulator and its final cast to bf16 against the plain version.
    Returns each kernel's max |kernel - plain| at the slice's shape."""
    shapes = [(512, 4096, 256, "float32"), (400, 4096, 256, "float32"),
              (512, 5000, 256, "float32"), (20000, 4096, 256, "float32"),
              (1024, 32000, 2048, "bfloat16"),
              (4096, 32000, 2048, "bfloat16"),
              (16384, 32000, 2048, "float32"),
              # the edges of the kernels' tiling: t, V and d all off the
              # 128-wide tiles and off 16-byte rows; d not a multiple of 8
              # in bf16; just over one backward chunk; a tiny t that the
              # vocab split has to spread over the card
              (384, 4099, 255, "float32"), (300, 1000, 250, "bfloat16"),
              (2100, 4096, 256, "float32"), (16, 32000, 2048, "float32")]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    bad, slice_err = [], {}
    print(f"{'fused xent shape':34s} {'loss':>9s} {'dh':>9s} {'dE':>9s} "
          f"bitwise")
    for t, v, d, dt in shapes:
        h, emb, tgt = _xent_inputs(torch, gen, t, v, d, getattr(torch, dt))
        h.requires_grad_()
        emb.requires_grad_()
        n0 = (fx.fwd_launches, fx.bwd_launches)
        runs = []
        for _ in range(2):
            per_token = fx._FusedXent.apply(h, emb, tgt)
            loss = torch.mean(per_token)
            runs.append((per_token.detach(), loss.detach(),
                         *torch.autograd.grad(loss, (h, emb))))
        torch.cuda.synchronize()
        ran = (fx.fwd_launches - n0[0], fx.bwd_launches - n0[1]) == (2, 2)
        per_token, loss, dh, de = runs[0]
        bitwise = all(torch.equal(a, b) for a, b in zip(*runs))
        finite = all(bool(torch.isfinite(x.float()).all())
                     for x in (per_token, dh, de))
        with torch.no_grad():
            hd, ed = h.detach(), emb.detach()
            p_tok, p_lse = fx.fused_xent_fwd_plain(hd, ed, tgt)
            ct = torch.full((t,), 1.0 / t, device="cuda")
            p_dh, p_de = fx.fused_xent_bwd_plain(hd, ed, tgt, p_lse, ct)
            if dt == "float32":
                p_loss = p_tok.mean()
                loss_err = (abs(loss.item() - p_loss.item())
                            / abs(p_loss.item()))
                loss_ok = loss_err <= 1e-4
                # allclose(rtol 1e-3, atol 5e-3 / t), as the ratio of
                # each element's error to its allowance
                errs = [((g.float() - r.float()).abs()
                         / (5e-3 / t + 1e-3 * r.float().abs())).max().item()
                        for g, r in ((dh, p_dh), (de, p_de))]
                grads_ok = max(errs) <= 1.0
            else:
                f32_loss = fx.fused_xent_fwd_plain(hd.float(), ed.float(),
                                                   tgt)[0].mean()
                loss_err = (abs(loss.item() - f32_loss.item())
                            / abs(f32_loss.item()))
                loss_ok = loss_err <= 5e-2
                errs = [((g.float() - r.float()).abs().max()
                         / r.float().abs().max()).item()
                        for g, r in ((dh, p_dh), (de, p_de))]
                grads_ok = max(errs) <= 5e-2
        ok = loss_ok and grads_ok and bitwise and finite and ran
        name = f"t{t} V{v} d{d} {dt}"
        print(f"{name:34s} {loss_err:9.2e} {errs[0]:9.2e} {errs[1]:9.2e} "
              f"{bitwise}{'' if ok else '  FAIL'}")
        if not ok:
            bad.append(name)
        if t == 16384:
            slice_err = {
                "fused_xent_fwd": (per_token - p_tok).abs().max().item(),
                "fused_xent_bwd": max((dh - p_dh).abs().max().item(),
                                      (de - p_de).abs().max().item())}
        del h, emb, tgt, runs, per_token, loss, dh, de, p_tok, p_lse, ct, \
            p_dh, p_de
        torch.cuda.empty_cache()
    print("fused xent: loss |d| / |plain|; f32 grads max |d| / (5e-3/t + "
          "1e-3 |plain|) (pass <= 1); bf16 grads max |d| / max |plain|")
    if bad:
        fail(f"fused xent kernels disagree with their plain versions (or "
             f"are not deterministic) on {len(bad)} shape(s): {bad}")
    return slice_err


def time_fused_xent(torch, fx, F, slice_err):
    """Phase 3c, timings: each fused kernel at the training slice's shape
    (t 16384 = b8 x s2048, V 32000, d 2048, f32) and at phase 9's (t 4096
    = b8 x s512, bf16) beside its bound, its plain version and one
    PyTorch call in the same dtype (forward ``F.cross_entropy(h @ emb.T,
    tgt)``; backward ``torch.autograd.grad`` through it w.r.t. (h,
    emb)); and the device memory the head adds over its inputs at the
    slice's shape, forward and backward, fused against that library
    head. Returns the kernels' records."""
    few = dict(warmup=1, runs=5, inner=2)

    def times(t, v, d, dtype, seed):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        h, emb, tgt = _xent_inputs(torch, gen, t, v, d, dtype)
        with torch.no_grad():
            _, lse = fx.fused_xent_fwd(h, emb, tgt)
            ct = torch.full((t,), 1.0 / t, device="cuda")
            out = {
                "fwd": time_ms(torch, lambda: fx.fused_xent_fwd(
                    h, emb, tgt), **few),
                "fwd_plain": time_ms(torch, lambda: fx.fused_xent_fwd_plain(
                    h, emb, tgt), **few),
                "fwd_lib": time_ms(torch, lambda: F.cross_entropy(
                    h @ emb.T, tgt), **few),
                "bwd": time_ms(torch, lambda: fx.fused_xent_bwd(
                    h, emb, tgt, lse, ct), **few),
                "bwd_plain": time_ms(torch, lambda: fx.fused_xent_bwd_plain(
                    h, emb, tgt, lse, ct), **few)}
        hl, el = (x.detach().requires_grad_() for x in (h, emb))
        loss = F.cross_entropy(hl @ el.T, tgt)
        out["bwd_lib"] = time_ms(torch, lambda: torch.autograd.grad(
            loss, (hl, el), retain_graph=True), **few)
        del loss, lse, ct
        return out, (hl, el, tgt)

    t, v, d = 16384, 32000, 2048
    ms, (hl, el, tgt) = times(t, v, d, torch.float32, 4)

    def head_peak(fn):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        grads = fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        del grads
        return peak / 1e9
    fused_gb = head_peak(lambda: torch.autograd.grad(
        fx.fused_lm_head_xent(hl, el, tgt), (hl, el)))
    lib_gb = head_peak(lambda: torch.autograd.grad(
        F.cross_entropy(hl @ el.T, tgt), (hl, el)))
    del hl, el, tgt
    torch.cuda.empty_cache()
    shape = f"t{t} V{v} d{d} float32"
    print(f"fused xent peak device memory over the inputs, forward + "
          f"backward at {shape}: fused {fused_gb:.4f} GB, "
          f"F.cross_entropy(h @ emb.T) {lib_gb:.4f} GB")
    bt = 4096
    bms = times(bt, v, d, torch.bfloat16, 5)[0]
    torch.cuda.empty_cache()
    bshape = f"t{bt} V{v} d{d} bfloat16"
    records = []
    for name, key, products, backward, line, lib in (
            ("fused_xent_fwd", "fwd", 1, False, 74,
             "F.cross_entropy(h @ emb.T, tgt)"),
            ("fused_xent_bwd", "bwd", 3, True, 168,
             "autograd.grad through it")):
        bound_ms, bound_by = xent_bound(t, v, d, "float32", products,
                                        backward)
        bbound_ms, bbound_by = xent_bound(bt, v, d, "bfloat16", products,
                                          backward)
        for sh, m, b_ms, b_by in ((shape, ms, bound_ms, bound_by),
                                  (bshape, bms, bbound_ms, bbound_by)):
            print(f"{name} at {sh}: kernel {m[key]:.4f} ms, plain "
                  f"{m[key + '_plain']:.4f} ms, {lib} "
                  f"{m[key + '_lib']:.4f} ms, bound {b_ms:.4f} ms "
                  f"({b_by}, tensor cores)")
        records.append({
            "name": name, "route": "cuda",
            "source": "tpudist_torch/csrc/fused_xent.cu",
            "replaces": f"tpudist/ops/pallas/fused_xent.py:{line}",
            "launches": None, "max_abs_err": slice_err[name],
            "ms": ms[key], "plain_ms": ms[key + "_plain"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_peak": "tensor cores 3xTF32",
            "library_ms": ms[key + "_lib"], "shape": shape,
            "head_peak_gb": fused_gb, "library_head_peak_gb": lib_gb,
            "bf16": {"shape": bshape, "ms": bms[key],
                     "plain_ms": bms[key + "_plain"],
                     "library_ms": bms[key + "_lib"],
                     "bound_ms": bbound_ms, "bound_by": bbound_by,
                     "bound_peak": "tensor cores bf16"}})
    return records


class _EagerBodies:
    """The serve engine with ``prefill``/``decode`` running its bodies
    eagerly instead of replaying its graphs: the reference the graphs
    are held to, never a serving route."""

    def __init__(self, engine):
        self.engine = engine

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def prefill(self, *args):
        return self.engine.eager_prefill(*args)

    def decode(self, *args):
        return self.engine.eager_decode(*args)


def _serve_counts(engine):
    """The serve paths' launch counts: the flash forward's through the
    engine's graph accounting, no other kernel."""
    return {"flash_attention_fwd": engine.kernel_launches()}


def _tokens_of(summary, rids=None):
    return {rid: r["tokens"] for rid, r in summary["results"].items()
            if rids is None or rid in rids}


def serve_slice(torch, fa, fx, profile: bool):
    """Phase 4: the serving slice at full width on the graph engine, the
    ladder (8, 4, 2) captured. Returns the engine, its params, phase 4's
    summary and the kernels' launch counts from the main path's run."""
    from tpudist_torch.config import ModelConfig
    from tpudist_torch.models import transformer
    from tpudist_torch.serve import resilience as res_lib
    from tpudist_torch.serve import scheduler as sched
    from tpudist_torch.serve.engine import ServeEngine, init_params

    cfg = ModelConfig(name="transformer")
    engine = ServeEngine(cfg, slots=8, max_seq=1024, prompt_pad=512,
                         decode_k=8, dtype=torch.float32, device="cuda",
                         adapt_ladder=res_lib.default_ladder(8))
    params = init_params(cfg, seed=0, device="cuda")
    n_params = sum(p.numel() for p in params.parameters())
    print(f"serve slice: V{cfg.vocab_size} L{cfg.n_layers} d{cfg.d_model} "
          f"h{cfg.n_heads} kv{cfg.n_kv_heads} d_ff{cfg.d_ff} float32; "
          f"params {n_params * 4 / 1e9:.3f} GB, kv cache "
          f"{engine.spec.bytes / 1e9:.3f} GB; slots {engine.slots} "
          f"max_seq {engine.max_seq} prompt_pad {engine.prompt_pad} "
          f"decode_k ladder {engine.ladder}")
    requests = sched.make_requests(16, prompt_pad=engine.prompt_pad,
                                   vocab_size=cfg.vocab_size, max_new=32,
                                   rate=0.0, seed=0)

    _reset_launches(fa, fx)
    t0 = time.perf_counter()
    engine.warmup(params)
    warm_s = time.perf_counter() - t0
    summary = sched.run_serve(engine, params, requests)
    torch.cuda.synchronize()
    counts = _serve_counts(engine)
    launches = counts["flash_attention_fwd"]
    engine.assert_two_programs()

    prefills = summary["admitted"] + 1     # + the warmup's eager body
    want = cfg.n_layers * prefills
    print(f"serve slice: {summary['completed']}/{summary['requests']} "
          f"requests, {summary['generated_tokens']} tokens in "
          f"{summary['wall_s']} s over {summary['dispatches']} "
          f"dispatches; warmup {warm_s:.3f} s, of it capture "
          f"{engine.capture_s:.3f} s of 1 prefill + "
          f"{len(engine.ladder)} decode graphs holding "
          f"{engine.graph_pool_bytes / 1e6:.1f} MB; flash kernel "
          f"launches {launches} (want n_layers x prefills = "
          f"{cfg.n_layers} x {prefills} = {want}), "
          f"{fa.launches} of them outside a graph; programs "
          f"{engine.compile_counts()}")
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
    if fa.launches != cfg.n_layers:
        fail(f"{fa.launches} flash launches outside the graphs, want the "
             f"warmup's {cfg.n_layers}: a prefill did not replay")
    for rid, res in summary["results"].items():
        toks = res["tokens"]
        if len(toks) != 32 or not all(0 <= t < cfg.vocab_size
                                      for t in toks):
            fail(f"request {rid} produced {toks!r}")

    # the graphs against the engine's bodies called eagerly: every
    # request's tokens, then one prefill's first token and logits
    eager = sched.run_serve(_EagerBodies(engine), params, requests)
    same = _tokens_of(eager) == _tokens_of(summary)
    print(f"serve slice: every request's tokens, graphs vs the eager "
          f"bodies: equal {same}")
    if not same:
        fail("the graph engine's tokens differ from its eager bodies'")

    # one replayed prefill's last-position logits (cached path, kernel,
    # q/k rotated up front) against the non-cached forward with RoPE
    # fused into the plain version, and against the eager body
    def plain_attention(q, k, v, *, cos=None, sin=None, causal=True):
        return fa.flash_attention_plain(q, k, v, cos=cos, sin=sin,
                                        causal=causal)[0]
    plain_attention.accepts_rope = True

    req = requests[0]
    args = (req.tokens[None, :], req.prompt_len, 0, req.max_new)
    n0 = engine.kernel_launches()
    _, first = engine.prefill(params, engine.init_state(), *args)
    got = engine.last_logits[0].clone()
    first = int(first)
    if engine.kernel_launches() != n0 + cfg.n_layers:
        fail("the replayed prefill did not count its flash kernels")
    _, first_eager = engine.eager_prefill(params, engine.init_state(),
                                          *args)
    d_eager = (got - engine.last_logits[0]).abs().max().item()
    tokens = torch.as_tensor(req.tokens[None, :], dtype=torch.int64,
                             device="cuda")
    with torch.no_grad():
        ref = transformer.apply(params, tokens, cfg, dtype=torch.float32,
                                attn_impl=plain_attention)[
            0, req.prompt_len - 1]
    err = (got - ref).abs().max().item()
    same = first == int(got.argmax()) == int(ref.argmax())
    print(f"serve slice: replayed prefill (rid {req.rid}, prompt_len "
          f"{req.prompt_len}): first token {first}, eager body's "
          f"{int(first_eager)} (logits max |d| {d_eager:.3e}); logits vs "
          f"plain forward max |d| {err:.3e} (atol 1e-3), argmax equal "
          f"{same}")
    if got.shape != (cfg.vocab_size,) or not bool(torch.isfinite(got).all()):
        fail(f"prefill logits shape {tuple(got.shape)} or not finite")
    if err > 1e-3:
        fail(f"prefill logits differ from the plain forward by {err:.3e}")
    if first != int(first_eager):
        fail("the replayed prefill's first token differs from the eager "
             "body's")

    if profile:
        profile_serve(torch, engine, params, requests)
    return engine, params, summary, counts


def serve_overload(torch, engine, params, base):
    """Phase 4b: overload on phase 4's graph engine. A Poisson stream of
    64 requests at twice the requests/s phase 4 completed, a queue cap of
    8, a TTFT deadline of 4 x phase 4's TTFT p50 and ``--adapt``'s ladder
    with the JAX package's adapt-drill thresholds. Hard checks: the exact
    partition, the program pin, every admitted request completed, and
    the admitted requests' tokens equal to the same requests' in an
    unloaded run; then two runs of one seed on virtual time give equal
    summaries. Returns the launch counts of the overload run."""
    from tpudist_torch.serve import resilience as res_lib
    from tpudist_torch.serve import scheduler as sched

    rate = 2 * base["completed"] / base["wall_s"]
    deadline_s = 4 * base["ttft_p50_s"]
    # the JAX package's adapt drill thresholds (its resilience tests):
    # --adapt's default depth_high of 8 never trips under a cap of 8
    res = res_lib.ResilienceConfig(queue_cap=8, ttft_deadline_s=deadline_s,
                                   adapt=True, validate=True,
                                   depth_high=4.0, depth_low=1.0,
                                   trip_ticks=1, clear_ticks=4, window=2)

    def stream(r):
        return sched.make_requests(64, prompt_pad=engine.prompt_pad,
                                   vocab_size=engine.model_cfg.vocab_size,
                                   max_new=32, rate=r, seed=1)

    engine.reset_kernel_launches()
    s = sched.run_serve(engine, params, stream(rate), resilience=res)
    torch.cuda.synchronize()
    counts = _serve_counts(engine)
    engine.assert_two_programs()
    part = s["partition"]
    want = engine.model_cfg.n_layers * s["admitted"]
    moves = [(t["from_level"], t["to_level"])
             for t in s["adapt_transitions"]]
    print(f"serve overload: 64 requests at {rate:.2f}/s, queue cap 8, "
          f"deadline {deadline_s * 1e3:.3f} ms, ladder {engine.ladder}: "
          f"admitted {s['admitted']}, completed {s['completed']}, shed "
          f"at admission {s['shed_at_admission']}, expired in queue "
          f"{s['expired_in_queue']}, rejected {s['rejected']} (shed "
          f"fraction {s['shed_fraction']}); adapt transitions "
          f"{moves}, final decode_k {s['decode_k_current']}; ttft p50 "
          f"{s['ttft_p50_s']} s p99 {s['ttft_p99_s']} s; itl p99 "
          f"{s['itl_p99_s']} s; tokens/s/chip "
          f"{s['tokens_per_sec_per_chip']}; flash launches "
          f"{counts['flash_attention_fwd']} (want {want})")
    if not (part["admission_exact"] and part["outcome_exact"]) \
            or part["arrived"] != 64:
        fail(f"serve overload partition is not exact: {part}")
    if s["completed"] != s["admitted"] or s["truncated"]:
        fail(f"serve overload completed {s['completed']} of "
             f"{s['admitted']} admitted ({s['truncated']} truncated)")
    if counts["flash_attention_fwd"] != want:
        fail(f"flash kernel launched {counts['flash_attention_fwd']} "
             f"times in the overload run, want {want}")
    # the same requests, every one present at t=0 and none shed
    unloaded = sched.run_serve(engine, params, [
        dataclasses.replace(r, arrival_s=0.0) for r in stream(rate)])
    admitted = set(s["results"])
    same = _tokens_of(s) == _tokens_of(unloaded, admitted)
    print(f"serve overload: the {len(admitted)} admitted requests' tokens "
          f"vs an unloaded run of the stream: equal {same}")
    if not same:
        fail("the overload run's tokens differ from the unloaded run's")

    virtual = [sched.run_serve(
        engine, params, stream(rate), resilience=res,
        virtual=res_lib.VirtualTiming(prefill_s=0.005,
                                      decode_s=8 * base["itl_p50_s"]))
        for _ in range(2)]
    same = virtual[0] == virtual[1]
    v = virtual[0]
    print(f"serve overload: two virtual-time runs of one seed: summaries "
          f"equal {same}; admitted {v['admitted']}, shed "
          f"{v['shed_total']}, transitions {len(v['adapt_transitions'])}, "
          f"ttft p99 {v['ttft_p99_s']} s (virtual)")
    if not same:
        fail("two virtual-time runs of one seed gave different summaries")
    return counts


class _Tee(io.TextIOBase):
    """stdout that is also kept, to read the train CLI's contract."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.out.write(s)
        self.buf.write(s)
        return len(s)

    def flush(self):
        self.out.flush()


def _launch_counts(fa, fx):
    return {"flash_attention_fwd": fa.launches,
            "flash_attention_bwd_dq": fa.dq_launches,
            "flash_attention_bwd_dkv": fa.dkv_launches,
            "flash_attention_bwd_dqkv": fa.dqkv_launches,
            "fused_xent_fwd": fx.fwd_launches,
            "fused_xent_bwd": fx.bwd_launches}


def _reset_launches(fa, fx):
    fa.launches = fa.dq_launches = fa.dkv_launches = fa.dqkv_launches = 0
    fx.fwd_launches = fx.bwd_launches = 0


def check_contract(tag: str, out: str, epochs: int, losses) -> None:
    """The train CLI's stdout contract on ``out`` and falling, finite step
    ``losses``."""
    for epoch in range(1, epochs + 1):
        for line in (f"Epoch {epoch:2d} finished. Avg loss: ",
                     f"Epoch {epoch:2d} eval loss: "):
            if line not in out:
                fail(f"train {tag}: no {line!r} line on stdout")
    if "Training completed." not in out:
        fail(f"train {tag}: no 'Training completed.' line")
    if not (losses and all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]):
        fail(f"train {tag}: step losses {losses} do not fall")


def want_launches(fa, m, seq: int, steps: int, epochs: int, fused: bool):
    """Each kernel's launches in one process of a training run of
    ``steps`` steps over ``epochs`` epochs of model ``m``."""
    fwd = m.n_layers * (steps + epochs)       # + one eval forward an epoch
    split = not fa.uses_merged_backward(seq, seq)
    return {"flash_attention_fwd": fwd,
            "flash_attention_bwd_dq": m.n_layers * steps if split else 0,
            "flash_attention_bwd_dkv": m.n_layers * steps if split else 0,
            "flash_attention_bwd_dqkv": 0 if split else m.n_layers * steps,
            # the fused head: one forward a step and an eval batch an
            # epoch, one backward a step
            "fused_xent_fwd": steps + epochs if fused else 0,
            "fused_xent_bwd": steps if fused else 0}


@contextlib.contextmanager
def _supersteps():
    """Every superstep the train CLI makes inside the block (through
    ``engine.make_superstep``), for the kernel launches its graphs'
    replays ran: a replay does not move the wrappers' counters."""
    from tpudist_torch import engine as engine_lib

    made, real = [], engine_lib.make_superstep

    def make(*args, **kw):
        made.append(real(*args, **kw))
        return made[-1]
    engine_lib.make_superstep = make
    try:
        yield made
    finally:
        engine_lib.make_superstep = real


def _path_launches(fa, fx, supersteps):
    """The kernels' launches on a path: the wrappers' counters (eager
    launches) plus each superstep's replayed ones."""
    counts = _launch_counts(fa, fx)
    for sup in supersteps:
        for name, n in sup.kernel_launches().items():
            counts[name] += n
    return counts


@contextlib.contextmanager
def _tuner_watch(torch, made, trials, search):
    """Every probe trial the tuner runs inside the block, appended to
    ``trials`` with the device's reserved memory after it and the graph
    pool its superstep captured, and the search's reserved memory before
    and after in ``search``. The supersteps a probe made leave ``made``
    (``_supersteps``), so a path's launches are the timed run's own: the
    probes restore the wrappers' counters and carry their launches on
    their results."""
    from tpudist_torch import tune

    real_probe, real_tune = tune.probe_mod.probe_candidate, tune.autotune

    def probe(cfg, device, cand, plan, **kw):
        n = len(made)
        res = real_probe(cfg, device, cand, plan, **kw)
        mine, made[n:] = made[n:], []
        trials.append({"cand": cand, "res": res,
                       "reserved": torch.cuda.memory_reserved(),
                       "pool": max((m.graph_pool_bytes for m in mine),
                                   default=0)})
        return res

    def autotune(*args, **kw):
        torch.cuda.synchronize()
        search["before"] = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        out = real_tune(*args, **kw)
        search["wall"] = time.perf_counter() - t0
        search["after"] = torch.cuda.memory_reserved()
        return out
    tune.probe_mod.probe_candidate, tune.autotune = probe, autotune
    try:
        yield
    finally:
        tune.probe_mod.probe_candidate, tune.autotune = real_probe, real_tune


def _cli_run(torch, fa, fx, tag: str, argv, env=None, tuner=None,
             keep: bool = False):
    """``python -m tpudist_torch.train`` (its ``main``) on the card with
    ``argv`` (plus a ``--save-dir`` of its own) and ``env``, the launch
    counts set to 0 just before and read just after. Fails unless it
    exits 0 with a ``success`` verdict and a timing record. Returns its
    stdout, metrics records, launches, supersteps, wall and peak device
    memory. ``tuner`` = ``(trials, search)`` watches the autotuner
    (``_tuner_watch``). ``keep`` leaves the run directory (``run["dir"]``)
    for the caller to read and remove."""
    from tpudist_torch import train as train_lib

    save = ROOT / "build" / "chip_smoke_train" / tag
    shutil.rmtree(save, ignore_errors=True)
    env = {"TPUDIST_VERDICT_PATH": str(save / "job_status.txt"),
           **(env or {})}
    os.environ.update(env)
    try:
        tee = _Tee(sys.stdout)
        torch.cuda.reset_peak_memory_stats()
        _reset_launches(fa, fx)
        t0 = time.perf_counter()
        with _supersteps() as made, contextlib.redirect_stdout(tee), (
                _tuner_watch(torch, made, *tuner) if tuner
                else contextlib.nullcontext()):
            rc = train_lib.main(argv + ["--save-dir", str(save)])
        torch.cuda.synchronize()
    finally:
        for k in env:
            del os.environ[k]
    run = {"wall": time.perf_counter() - t0, "dir": save,
           "counts": _path_launches(fa, fx, made), "supersteps": made,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "out": tee.buf.getvalue(),
           "recs": [json.loads(ln) for ln in
                    (save / "metrics.jsonl").read_text().splitlines()]}
    verdict = save / "job_status.txt"
    status = verdict.read_text() if verdict.is_file() else None
    if not keep:
        shutil.rmtree(save, ignore_errors=True)
    torch.cuda.empty_cache()
    run["timing"] = [r for r in run["recs"] if r["kind"] == "timing"]
    if rc != 0 or status != "success" or not run["timing"]:
        fail(f"train {tag}: exit {rc}, verdict {status!r}")
    run["timing"] = run["timing"][-1]
    return run


def _step_line(run, per_step: int, unit: str = "tokens") -> str:
    t = run["timing"]
    sps = t["steps"] / t["run_s"]
    return (f"{sps:.4f} steps/s, {sps * per_step:.1f} {unit}/s, step "
            f"{1e3 * t['run_s'] / t['steps']:.3f} ms (over {t['steps']} "
            f"steps after the warm-up); warm-up + builds "
            f"{t['compile_warmup_s']:.2f} s; wall {run['wall']:.2f} s; "
            f"peak device memory {run['peak_gb']:.3f} GB")


def train_slice(torch, fa, fx, tag: str, seq: int, epochs: int,
                n_samples: int, extra=(), hbm_bytes=None, want_head=None):
    """Phases 5, 6, 8 and 9, the path ``tag``: ``python -m
    tpudist_torch.train`` (its ``main``) on the card at full width:
    BASELINE config #5, global batch 8, seed 42, f32 and ``--lm-head
    auto`` unless ``extra`` flags say otherwise; ``hbm_bytes`` pins the auto head policy's device memory
    (``TPUDIST_HBM_BYTES``), and the resolved head must be ``want_head``
    when given. The launch counts are set to 0 just before and read just
    after; the stdout contract, a falling loss, the verdict file and the
    exact launch counts are checked. Returns the counts."""
    from tpudist_torch import config as config_lib
    from tpudist_torch import engine as engine_lib

    argv = ["--model", "transformer", "--seq-len", str(seq),
            "--train-batch-size", "8", "--n-samples", str(n_samples),
            "--epochs", str(epochs), "--seed", "42", "--log-every", "1",
            *extra]
    cfg = config_lib.parse_args(argv)
    env = {} if hbm_bytes is None else {"TPUDIST_HBM_BYTES": str(hbm_bytes)}
    os.environ.update(env)
    try:
        fused, chunks = engine_lib._resolve_lm_head(cfg,
                                                    torch.device("cuda"))
    finally:
        for k in env:
            del os.environ[k]
    head = "fused" if fused else f"chunked({chunks})" if chunks \
        else "plain"
    m = cfg.model
    print(f"train {tag}: V{m.vocab_size} L{m.n_layers} d{m.d_model} "
          f"h{m.n_heads} kv{m.n_kv_heads} d_ff{m.d_ff} {cfg.dtype}, "
          f"batch {cfg.batch_size}, {n_samples} samples, {epochs} "
          f"epoch(s), adam nu {cfg.adam_nu_dtype}; --lm-head "
          f"{cfg.lm_head} -> {head}"
          + ("" if hbm_bytes is None
             else f" (TPUDIST_HBM_BYTES={hbm_bytes:.0f})"))
    if want_head is not None and head != want_head:
        fail(f"train {tag}: the head resolved to {head}, want "
             f"{want_head}")
    run = _cli_run(torch, fa, fx, tag, argv, env)
    counts = run["counts"]
    losses = [r["loss"] for r in run["recs"] if r["kind"] == "step"]
    check_contract(tag, run["out"], epochs, losses)
    want = want_launches(fa, m, seq, epochs * (n_samples // cfg.batch_size),
                         epochs, fused)
    print(f"train {tag}: step losses {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"verdict success; "
          + _step_line(run, cfg.batch_size * m.max_seq_len))
    print(f"train {tag}: kernel launches {counts} (want {want})")
    if counts != want:
        fail(f"train {tag}: kernel launches {counts}, want {want}")
    return counts


def _epochs_of(run):
    """Each epoch's (Avg loss, eval loss) of a run's metrics."""
    return [(r["avg_loss"], r["eval_loss"]) for r in run["recs"]
            if r["kind"] == "epoch"]


def _graphs_line(run) -> str:
    sup = run["supersteps"][0]
    return (f"{sup.programs} captured programs, capture "
            f"{sup.capture_s:.3f} s, graph pool "
            f"{sup.graph_pool_bytes / 2**20:.1f} MB, replays "
            f"{sup.replays}")


# phase 11's kernel paths
SUPERSTEP = ("train_seq512_bf16_per_step", "train_seq512_bf16_superstep",
             "train_seq512_dp_superstep")


def superstep_slice(torch, fa, fx, card: str):
    """Phase 11a, the paths ``train_seq512_bf16_per_step`` and
    ``train_seq512_bf16_superstep``: phase 9's configuration (BASELINE
    config #5 at seq 512, bf16, bf16 Adam nu, ``--lm-head fused``, global
    batch 8, seed 42) with ``--log-every 4`` over 80 samples (10 steps an
    epoch: two full windows of k = 4 and a 2-step tail), 2 epochs, run
    per-step (``--steps-per-dispatch 1``) and as the superstep (``0``,
    auto -> 4) under a ``TPUDIST_STAGING_BUDGET_MB`` that holds two
    4-step slabs of the staged (int64) token ids, so each epoch streams
    in 3 slabs. Each epoch's Avg and eval loss must be bitwise equal
    between the two runs, each run's launches exact over the 20 true
    steps and 2 evals, the superstep's programs 2 and its replays those
    of the windows. Returns each path's launches."""
    from tpudist_torch import config as config_lib

    seq, epochs, n_samples, k = 512, 2, 80, 4
    argv = ["--model", "transformer", "--seq-len", str(seq),
            "--train-batch-size", "8", "--n-samples", str(n_samples),
            "--epochs", str(epochs), "--seed", "42", "--log-every", str(k),
            "--dtype", "bfloat16", "--adam-nu-dtype", "bfloat16",
            "--lm-head", "fused"]
    cfg = config_lib.parse_args(argv)
    m = cfg.model
    step_bytes = cfg.batch_size * (seq + 1) * 8
    budget_mb = 2 * k * step_bytes / 2**20
    print(f"superstep: V{m.vocab_size} L{m.n_layers} d{m.d_model} "
          f"h{m.n_heads} kv{m.n_kv_heads} d_ff{m.d_ff} {cfg.dtype}, adam "
          f"nu {cfg.adam_nu_dtype}, --lm-head fused, batch "
          f"{cfg.batch_size}, {n_samples} samples, {epochs} epochs, "
          f"--log-every {k}; staged step {step_bytes} B, "
          f"TPUDIST_STAGING_BUDGET_MB={budget_mb!r}; {card}")
    tokens = cfg.batch_size * seq
    want = want_launches(fa, m, seq, epochs * (n_samples // cfg.batch_size),
                         epochs, fused=True)
    runs, paths = {}, {}
    for how, extra, env in (
            ("per_step", ["--steps-per-dispatch", "1"], {}),
            ("superstep", ["--steps-per-dispatch", "0"],
             {"TPUDIST_STAGING_BUDGET_MB": repr(budget_mb)})):
        tag = f"train_seq512_bf16_{how}"
        # the superstep's run directory is phase 13a's default run
        run = runs[how] = _cli_run(torch, fa, fx, tag, argv + extra, env,
                                   keep=how == "superstep")
        t = run["timing"]
        losses = [r["loss"] for r in run["recs"] if r["kind"] == "step"]
        check_contract(tag, run["out"], epochs, losses)
        print(f"superstep {how}: k={t['steps_per_dispatch']}, "
              + _step_line(run, tokens))
        print(f"superstep {how}: kernel launches {run['counts']} (want "
              f"{want})")
        if run["counts"] != want:
            fail(f"superstep {how}: kernel launches {run['counts']}, want "
                 f"{want}")
        paths[tag] = run["counts"]
    sup, t = runs["superstep"], runs["superstep"]["timing"]
    print(f"superstep: {_graphs_line(sup)}; staging {t['staging_status']}"
          f", {t['staging_slabs']} slabs, stage_wait_s "
          f"{t['stage_wait_s']}, overlap {t['staging_overlap_fraction']}")
    graphs = sup["supersteps"][0]
    # the first window is the eager warm-up; the 10-step epochs have two
    # full windows and a 2-step tail each
    want_replays = {"superstep": 2 * epochs - 1, "step": 2 * epochs}
    if (t["steps_per_dispatch"], graphs.programs, graphs.replays) != (
            k, 2, want_replays):
        fail(f"superstep: k={t['steps_per_dispatch']}, "
             f"{graphs.programs} programs, replays {graphs.replays}; "
             f"want k={k}, 2 programs, replays {want_replays}")
    if not t["staging_streamed"] or t["staging_slabs"] != 3 * epochs:
        fail(f"superstep: staging streamed {t['staging_streamed']} in "
             f"{t['staging_slabs']} slabs, want 3 slabs an epoch")
    a, b = _epochs_of(runs["per_step"]), _epochs_of(sup)
    print(f"superstep: epochs (Avg, eval) per-step {a}, superstep {b}")
    if a != b or len(a) != epochs:
        fail(f"superstep: the epochs' losses differ: per-step {a}, "
             f"superstep {b}")
    p, q = (runs[h]["timing"] for h in ("per_step", "superstep"))
    print(f"superstep: step {1e3 * p['run_s'] / p['steps']:.3f} ms "
          f"per-step, {1e3 * q['run_s'] / q['steps']:.3f} ms superstep "
          f"(ratio {(p['run_s'] / p['steps']) / (q['run_s'] / q['steps']):.4f}"
          f"); {card}")
    return paths, sup, argv + ["--steps-per-dispatch", "0"], {
        "TPUDIST_STAGING_BUDGET_MB": repr(budget_mb)}


def superstep_mlp(torch, fa, fx, card: str):
    """Phase 11b: ``python -m tpudist_torch.train`` at the reference
    defaults (the MLP, 2000 samples, batch 64, 5 epochs: 31 steps an
    epoch), per-step and at the auto k = 25 (one full window and a
    6-step tail an epoch, the full-epoch fast path). The Avg and eval
    losses must be bitwise equal, the superstep's programs 2 and its
    replays those of the windows."""
    runs, rates = {}, {"per_step": [], "superstep": []}
    # in turns: the host-bound rates spread from run to run
    for how in ("per_step", "superstep", "superstep", "per_step"):
        extra = ["--steps-per-dispatch", "1"] if how == "per_step" else []
        run = _cli_run(torch, fa, fx, f"train_mlp_{how}", extra)
        if how in runs and _epochs_of(run) != _epochs_of(runs[how]):
            fail(f"mlp: two {how} runs differ")
        runs[how] = run
        rates[how].append(run["timing"]["steps"] / run["timing"]["run_s"])
        print(f"mlp {how}: k={run['timing']['steps_per_dispatch']}, "
              + _step_line(run, 64, "samples"))
    sup = runs["superstep"]
    graphs = sup["supersteps"][0]
    want_replays = {"superstep": 4, "step": 5 * 6}
    if (sup["timing"]["steps_per_dispatch"], graphs.programs,
            graphs.replays) != (25, 2, want_replays):
        fail(f"mlp: k={sup['timing']['steps_per_dispatch']}, "
             f"{graphs.programs} programs, replays {graphs.replays}")
    a, b = _epochs_of(runs["per_step"]), _epochs_of(sup)
    print(f"mlp: {_graphs_line(sup)}; epochs (Avg, eval) per-step {a}, "
          f"superstep {b}")
    if a != b or len(a) != 5:
        fail(f"mlp: the epochs' losses differ: per-step {a}, superstep "
             f"{b}")
    p, q = (statistics.median(rates[h]) for h in ("per_step", "superstep"))
    print(f"mlp: steps/s per-step {rates['per_step']}, superstep "
          f"{rates['superstep']}; medians {p:.1f} and {q:.1f} (ratio "
          f"{q / p:.4f}); {card}")


# phase 12b's kernel path: the tuned run's timed steps
TUNE_PATH = "tune_seq512_bf16"
MB = 2**20


def _tune_record(tag: str, run):
    recs = [r for r in run["recs"] if r["kind"] == "tune"]
    if len(recs) != 1:
        fail(f"{tag}: {len(recs)} kind=tune records, want 1")
    return recs[0]


def _point(t) -> str:
    return (f"k={t['steps_per_dispatch']}, staging "
            f"{t['staging_budget_mb']} MB, remat={t['remat']}, "
            f"grad_accum={t['grad_accum_steps']}")


def _at_point(t, math: bool = True):
    """The flags of an untuned run at the tuner's committed point (its
    schedule knobs only, unless ``math``)."""
    argv = ["--steps-per-dispatch", str(t["steps_per_dispatch"])]
    if t["staging_budget_mb"] is not None:
        argv += ["--staging-budget-mb", repr(t["staging_budget_mb"])]
    if math:
        argv += ["--grad-accum-steps", str(t["grad_accum_steps"])]
        argv += ["--remat"] if t["remat"] else []
    return argv


def _tuned_search(torch, fa, fx, tag: str, argv, budget: int, card: str):
    """The train CLI with ``--autotune probe`` (``argv`` holds it and a
    fresh ``--autotune-cache-dir``): every trial printed (the discarded
    cold one first) with the device's reserved memory before the search,
    after each trial and after the search. Fails unless the search
    succeeded from a probe within ``budget`` trials (plus the two
    confirmations), the commit measured at least the heuristic start's
    steps/s, the card holds at most one trial's graph pool more than
    before the search, and an infeasible trial carries its error.
    Returns the run, its tune record and the trials."""
    trials, search = [], {}
    run = _cli_run(torch, fa, fx, tag, argv, tuner=(trials, search))
    t = _tune_record(tag, run)
    print(f"{tag}: reserved before the search "
          f"{search['before'] / MB:.1f} MB; {card}")
    for i, tr in enumerate(trials):
        c, r = tr["cand"], tr["res"]
        what = "cold trial (discarded)" if i == 0 else f"trial {i}"
        got = (f"{r.steps_per_sec:.2f} steps/s, spread {r.spread:.4f}"
               if r.feasible else f"pruned: {r.error}")
        peak = ("n/a" if r.hbm_peak_bytes is None
                else f"{r.hbm_peak_bytes / MB:.1f} MB")
        ran = {k: n for k, n in (r.launches or {}).items() if n}
        print(f"{tag}: {what}: k={c.k}, staging {c.staging_budget_mb} MB, "
              f"remat={c.remat}, accum={c.grad_accum_steps}: {got}; "
              f"build+warm-up+capture {r.compile_s:.2f} s, peak reserved "
              f"{peak}, graph pool {tr['pool'] / MB:.1f} MB, reserved "
              f"after {tr['reserved'] / MB:.1f} MB; probe launches {ran}; "
              f"{card}")
        if not r.feasible and not r.error:
            fail(f"{tag}: {what} pruned without an error")
    grown = search["after"] - search["before"]
    pool = max((tr["pool"] for tr in trials), default=0)
    print(f"{tag}: reserved after the search {search['after'] / MB:.1f} MB "
          f"({grown / MB:+.1f} MB; the largest trial pool "
          f"{pool / MB:.1f} MB); search wall {search['wall']:.2f} s; "
          f"{card}")
    sps, base = t["steps_per_sec"], t["baseline_steps_per_sec"]
    print(f"{tag}: tuning {t['status']} ({t['source']}): {_point(t)}; "
          f"{sps} steps/s against the heuristic start's {base}"
          + (f" (x{sps / base:.4f})" if sps and base else "")
          + f", {t['trials']} trials, {t['pruned']} pruned; {card}")
    if (t["source"], t["status"], run["timing"]["tuning_status"]) != (
            "probe", "success", "success"):
        fail(f"{tag}: tuning {t['status']} from {t['source']}, timing "
             f"{run['timing']['tuning_status']}")
    if len(trials) != 1 + t["trials"] or t["trials"] > budget + 2:
        fail(f"{tag}: {len(trials)} probes for {t['trials']} trials "
             f"(budget {budget} + 2 confirmations)")
    if not (sps and base and sps >= base):
        fail(f"{tag}: the commit's {sps} steps/s is not at least the "
             f"heuristic start's {base}")
    if grown > pool:
        fail(f"{tag}: the card holds {grown / MB:.1f} MB more after the "
             f"search, more than one trial's pool ({pool / MB:.1f} MB)")
    if run["timing"]["steps_per_dispatch"] != t["steps_per_dispatch"]:
        fail(f"{tag}: the run dispatched k="
             f"{run['timing']['steps_per_dispatch']}, the tuner committed "
             f"{t['steps_per_dispatch']}")
    return run, t, trials


def _cache_rerun(torch, fa, fx, tag: str, argv, t, card: str,
                 per_step: int, unit: str):
    """The same tuned command again on the same cache directory: a pure
    cache hit, zero probes, the same point. Returns the run."""
    trials, search = [], {}
    run = _cli_run(torch, fa, fx, f"{tag}_cached", argv,
                   tuner=(trials, search))
    t2 = _tune_record(tag, run)
    print(f"{tag} rerun: tuning {t2['status']} ({t2['source']}): "
          f"{_point(t2)}, {t2['trials']} trials, {len(trials)} probes; "
          + _step_line(run, per_step, unit) + f"; {card}")
    keys = ("steps_per_dispatch", "staging_budget_mb", "remat",
            "grad_accum_steps")
    if (t2["source"], t2["trials"], len(trials)) != ("cache", 0, 0) or \
            any(t2[key] != t[key] for key in keys):
        fail(f"{tag} rerun: {t2['source']} with {t2['trials']} trials "
             f"({len(trials)} probes) at {_point(t2)}, want a cache hit "
             f"at {_point(t)}")
    return run


def capture_oom_drill(torch, card: str):
    """Phase 12a's drill: an OOM raised inside a probe's capture (the MLP
    default at k = 25) comes back as a pruned trial, the capture closed,
    the launch counters and the reserved memory where they were, and the
    same probe then measures on the card."""
    from tpudist_torch import config as config_lib
    from tpudist_torch import data as data_lib
    from tpudist_torch import engine as engine_lib
    from tpudist_torch.tune import probe, search

    cfg = config_lib.parse_args([])
    plan = data_lib.plan_epoch(
        data_lib.make_synthetic_data(cfg.data.n_samples,
                                     cfg.data.n_features, cfg.data.seed),
        batch_size=cfg.batch_size, seed=cfg.seed, epoch=0)
    cand = search.Candidate(k=25)
    dev = torch.device("cuda")
    real = engine_lib.Superstep._graph_body

    def oom(self, state, n):
        real(self, state, n)            # some work into the pool first
        raise torch.cuda.OutOfMemoryError("drill: out of memory inside "
                                          "the capture")
    probe.release_memory(dev)
    counts = engine_lib.kernel_launch_counts()
    before = torch.cuda.memory_reserved()
    engine_lib.Superstep._graph_body = oom
    try:
        res = probe.probe_candidate(cfg, dev, cand, plan, repeats=1)
    finally:
        engine_lib.Superstep._graph_body = real
    after = torch.cuda.memory_reserved()
    capturing = torch.cuda.is_current_stream_capturing()
    again = probe.probe_candidate(cfg, dev, cand, plan, repeats=1)
    print(f"capture OOM drill: {res.error}; capturing after "
          f"{capturing}; reserved {before / MB:.1f} -> {after / MB:.1f} MB; "
          f"the same probe then {again.steps_per_sec:.2f} steps/s; {card}")
    if res.feasible or "OutOfMemoryError" not in (res.error or "") \
            or capturing or after > before \
            or engine_lib.kernel_launch_counts() != counts \
            or not again.feasible:
        fail("capture OOM drill: the probe did not come back pruned with "
             "the card as it found it")


def tuner_mlp(torch, fa, fx, card: str):
    """Phase 12a: ``python -m tpudist_torch.train --autotune probe`` at the
    reference defaults (the MLP, 2000 samples, batch 64, 5 epochs,
    --log-every 100: the k ladder 1, 2, 4, 10, 20, 25), the
    dispatch-bound workload. The search must succeed from a probe (see
    ``_tuned_search``), every epoch's Avg and eval loss must be bitwise
    an untuned run's at the committed point, and a second run on the
    same cache must be a pure hit. Then the capture OOM drill."""
    from tpudist_torch import config as config_lib

    cache = ROOT / "build" / "chip_smoke_tune" / "mlp"
    shutil.rmtree(cache, ignore_errors=True)
    argv = ["--autotune", "probe", "--autotune-cache-dir", str(cache)]
    tag = "tune_mlp"
    run, t, _ = _tuned_search(torch, fa, fx, tag, argv,
                              config_lib.AUTOTUNE_DEFAULT_TRIALS, card)
    ref = _cli_run(torch, fa, fx, f"{tag}_untuned", _at_point(t))
    a, b = _epochs_of(run), _epochs_of(ref)
    print(f"{tag}: tuned " + _step_line(run, 64, "samples")
          + "; untuned at the point " + _step_line(ref, 64, "samples")
          + f"; epochs (Avg, eval) tuned {a}, untuned {b}; {card}")
    if a != b or len(a) != 5:
        fail(f"{tag}: the epochs' losses differ: tuned {a}, untuned {b}")
    _cache_rerun(torch, fa, fx, tag, argv, t, card, 64, "samples")
    shutil.rmtree(cache, ignore_errors=True)
    capture_oom_drill(torch, card)


def tuner_full_width(torch, fa, fx, card: str):
    """Phase 12b, the path ``tune_seq512_bf16``: the tuner at full width
    on phase 11a's configuration (BASELINE config #5 at seq 512, bf16,
    bf16 Adam nu, ``--lm-head fused``, global batch 8, seed 42) with
    ``--log-every 8`` over 128 samples (16 steps an epoch: the k ladder
    1, 2, 4, 8), 1 epoch, ``--autotune-trials 8``: the remat and
    grad-accumulation axes and the flash forward, merged backward and
    fused-head kernels inside captured probes. The search must succeed
    (``_tuned_search``), the remat and accumulation points it reached be
    measured or pruned with their error, the run's launches exact (the
    probes' shown apart), its epoch losses bitwise an untuned run's at
    the committed point (and, where a math knob moved, within f32 1e-4
    of an untuned run at the committed schedule alone), and a rerun a
    pure cache hit. Returns the path's launches."""
    from tpudist_torch import config as config_lib

    cache = ROOT / "build" / "chip_smoke_tune" / "seq512"
    shutil.rmtree(cache, ignore_errors=True)
    seq, n_samples = 512, 128
    argv = ["--model", "transformer", "--seq-len", str(seq),
            "--train-batch-size", "8", "--n-samples", str(n_samples),
            "--epochs", "1", "--seed", "42", "--log-every", "8",
            "--dtype", "bfloat16", "--adam-nu-dtype", "bfloat16",
            "--lm-head", "fused"]
    cfg = config_lib.parse_args(argv)
    tuned_argv = argv + ["--autotune", "probe", "--autotune-trials", "8",
                         "--autotune-cache-dir", str(cache)]
    m = cfg.model
    print(f"{TUNE_PATH}: V{m.vocab_size} L{m.n_layers} d{m.d_model} "
          f"h{m.n_heads} kv{m.n_kv_heads} d_ff{m.d_ff} {cfg.dtype}, adam "
          f"nu {cfg.adam_nu_dtype}, --lm-head fused, batch "
          f"{cfg.batch_size}, {n_samples} samples, 1 epoch, --log-every "
          f"8, --autotune probe --autotune-trials 8; {card}")
    run, t, trials = _tuned_search(torch, fa, fx, TUNE_PATH, tuned_argv, 8,
                                   card)
    for axis, probed in (
            ("remat", [tr for tr in trials[1:] if tr["cand"].remat]),
            ("grad_accum", [tr for tr in trials[1:]
                            if tr["cand"].grad_accum_steps > 1])):
        print(f"{TUNE_PATH}: the {axis} axis: " + ("; ".join(
            f"k={tr['cand'].k} accum={tr['cand'].grad_accum_steps} remat="
            f"{tr['cand'].remat}: " + (
                f"{tr['res'].steps_per_sec:.2f} steps/s"
                + (" (captured)" if tr["cand"].k > 1 else " (per-step)")
                if tr["res"].feasible else f"pruned: {tr['res'].error}")
            for tr in probed) or "not reached within the budget"))
    steps = n_samples // cfg.batch_size
    want = want_launches(fa, m, seq, steps, 1, fused=True)
    probes = dict.fromkeys(want, 0)
    for tr in trials:
        for name, n in (tr["res"].launches or {}).items():
            probes[name] += n
    print(f"{TUNE_PATH}: timed run {_step_line(run, cfg.batch_size * seq)}"
          f"; kernel launches {run['counts']} (want {want}); the probes' "
          f"launches apart {probes}; {card}")
    if run["counts"] != want:
        fail(f"{TUNE_PATH}: kernel launches {run['counts']}, want {want}")
    ref = _cli_run(torch, fa, fx, f"{TUNE_PATH}_untuned",
                   argv + _at_point(t))
    a, b = _epochs_of(run), _epochs_of(ref)
    print(f"{TUNE_PATH}: epochs (Avg, eval) tuned {a}, untuned at the "
          f"point {b}")
    if a != b or len(a) != 1:
        fail(f"{TUNE_PATH}: the epochs' losses differ: tuned {a}, "
             f"untuned {b}")
    if t["remat"] != cfg.remat or t["grad_accum_steps"] != 1:
        sched = _cli_run(torch, fa, fx, f"{TUNE_PATH}_schedule",
                         argv + _at_point(t, math=False))
        c = _epochs_of(sched)
        err = max(abs(x - y) / abs(y) for p, q in zip(a, c)
                  for x, y in zip(p, q))
        print(f"{TUNE_PATH}: a math knob moved: epochs at the schedule "
              f"alone {c}, worst relative difference {err:.3e} (tol 1e-4)")
        if err > 1e-4:
            fail(f"{TUNE_PATH}: the math knob moved the losses by {err:.3e}")
    _cache_rerun(torch, fa, fx, TUNE_PATH, tuned_argv, t, card,
                 cfg.batch_size * seq, "tokens")
    shutil.rmtree(cache, ignore_errors=True)
    return run["counts"]


# phase 13: the observability every default run writes
OBS_SPANS = ("distributed_init", "data_materialize", "model_init", "setup",
             "ckpt_open", "epoch", "dispatch", "stage_slab", "fence",
             "slab_wait", "eval", "hosts_gather", "ckpt_enqueue")
OBS_OFF = ["--trace", "off", "--stall-timeout-s", "0", "--hbm-sample-s", "0"]
OBS_PATHS = ("obs_seq512_bf16_off", "obs_seq512_bf16_on")
OBS_SERVE = ("obs_serve_on", "obs_serve_off")


def _read_json(path: Path, what: str):
    if not path.is_file():
        fail(f"{what}: no {path.name} in the run directory")
    try:
        return json.loads(path.read_text())
    except ValueError as e:
        fail(f"{what}: {path.name} does not parse ({e})")


def _x_names(doc):
    return {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"}


def _ledger_line(what: str, d: Path, recs) -> str:
    """The run's memory ledger: one ``kind=memledger`` record and
    ``memledger.json``, whose partition sums to the card's memory."""
    led = _read_json(d / "memledger.json", what)
    n = sum(r["kind"] == "memledger" for r in recs)
    b = led["buckets"]
    if n != 1 or sum(b.values()) != led["total_hbm_bytes"]:
        fail(f"{what}: {n} kind=memledger records, buckets sum "
             f"{sum(b.values())} of {led['total_hbm_bytes']}")
    return (f"ledger {'exact' if led['exact'] else 'INEXACT'}, headroom "
            f"{led['headroom_status']} ({led['headroom_fraction']}) of "
            f"{led['total_hbm_bytes'] / MB:.1f} MB: "
            + ", ".join(f"{k} {v / MB:.1f}" for k, v in b.items())
            + f" MB; program_temp complete "
            f"{led['program_temp_complete']}; problems {led['problems']}")


def step_flops(m, b: int, s: int) -> int:
    """One training step's model flops at batch ``b``, seq ``s`` of model
    ``m``, the count's closed form (``tpudist_torch.obs.mfu``): 6 x
    tokens x the linear layers' and the tied head's weights, plus the
    causal attention's two products over s(s+1)/2 pairs, forward and
    twice that backward."""
    hd = m.d_model // m.n_heads
    linear = m.n_layers * (m.d_model * m.n_heads * hd * 2
                           + 2 * m.d_model * m.n_kv_heads * hd
                           + 3 * m.d_model * m.d_ff)
    pairs = s * (s + 1) // 2
    return (6 * b * s * (linear + m.vocab_size * m.d_model)
            + 12 * b * m.n_heads * hd * pairs * m.n_layers)


def check_obs_dir(what: str, run, epochs: int, n_steps: int, flops: int,
                  card: str) -> None:
    """Phase 13a: a default train run's directory holds the JAX run's
    artifact set: both traces with every span name and nothing dropped,
    the beacon at the final step, a ``kind=hosts`` record an epoch, the
    memory ledger, the timing record's MFU within (0, 1.05] over a flop
    count equal to the closed form ``flops`` (the CPU's count: the
    kernels report the plain versions' formulas), the watermark from the
    card's counters at or above the run's peak allocation, and
    ``run_id`` on every record."""
    d, t = run["dir"], run["timing"]
    for name in ("trace.worker0.json", "pod_trace.json"):
        doc = _read_json(d / name, what)
        missing = set(OBS_SPANS) - _x_names(doc)
        meta = doc["metadata"]
        if missing or meta.get("dropped") != 0 or not meta.get("run_id"):
            fail(f"{what}: {name} lacks spans {sorted(missing)}, dropped "
                 f"{meta.get('dropped')}, run_id {meta.get('run_id')}")
    beat = _read_json(d / "heartbeat.worker0", what)
    if (beat.get("epoch"), beat.get("step")) != (epochs - 1, n_steps):
        fail(f"{what}: the beacon reads epoch {beat.get('epoch')} step "
             f"{beat.get('step')}, want {epochs - 1} and {n_steps}")
    hosts = [r for r in run["recs"] if r["kind"] == "hosts"]
    if [r["epoch"] for r in hosts] != list(range(epochs)) or any(
            "straggler_status" not in r for r in hosts):
        fail(f"{what}: kind=hosts records {hosts}")
    ledger = _ledger_line(what, d, run["recs"])
    unstamped = {r["kind"] for r in run["recs"] if not r.get("run_id")}
    if unstamped or len({r["run_id"] for r in run["recs"]}) != 1:
        fail(f"{what}: records without the run's one run_id: {unstamped}")
    mfu = t.get("mfu")
    if t["model_flops_per_step"] != flops:
        fail(f"{what}: {t['model_flops_per_step']} flops a step, the "
             f"closed form {flops}")
    if not (mfu and 0 < mfu <= 1.05) or t["trace_status"] != "success" \
            or t["hbm_source"] != "memory_stats" \
            or t["hbm_peak_bytes"] < run["peak_bytes"]:
        fail(f"{what}: mfu {mfu}, trace {t['trace_status']}, hbm "
             f"{t['hbm_source']} peak {t['hbm_peak_bytes']} against the "
             f"run's max_memory_allocated {run['peak_bytes']}")
    print(f"{what}: mfu {mfu:.4f} ({t['achieved_tflops_per_chip']:.2f} "
          f"of {t['peak_tflops']} TFLOP/s, {t['model_flops_per_step']:.4e} "
          f"flops a step); hbm peak {t['hbm_peak_bytes'] / MB:.1f} MB "
          f"(max_memory_allocated {run['peak_bytes'] / MB:.1f}), in use "
          f"{t['hbm_bytes_in_use'] / MB:.1f}, reserved "
          f"{t['hbm_bytes_reserved'] / MB:.1f}, fragmentation "
          f"{t['hbm_fragmentation_bytes'] / MB:.1f}, limit "
          f"{t['hbm_limit_bytes'] / MB:.1f} MB; straggler "
          f"{t['straggler_status']}; trace {t['trace_spans']} spans; "
          f"{card}")
    print(f"{what}: {ledger}")


def obs_train(torch, fa, fx, card: str, on, argv, env):
    """Phase 13a: phase 11a's superstep run (``on``: observability on by
    default) is checked by :func:`check_obs_dir`, then the configuration
    runs with ``--trace off --stall-timeout-s 0 --hbm-sample-s 0`` and
    on again, in turns: the losses bitwise equal, the programs, replays
    and launches the same, each run's step time printed. Returns the two
    runs' launches."""
    from tpudist_torch import config as config_lib

    epochs, n_steps = 2, 10
    flops = step_flops(config_lib.parse_args(argv).model, 8, 512)
    check_obs_dir("obs 13a, phase 11a's default run", on, epochs, n_steps,
                  flops, card)
    shutil.rmtree(on["dir"], ignore_errors=True)
    sup = on["supersteps"][0]
    graphs = (sup.programs, sup.replays, sup.captured_launches)
    step_ms = [("on", 1e3 * on["timing"]["run_s"] / on["timing"]["steps"])]
    paths = {}
    for how in ("off", "on"):
        tag = f"obs_seq512_bf16_{how}"
        run = _cli_run(torch, fa, fx, tag,
                       argv + (OBS_OFF if how == "off" else []), env,
                       keep=True)
        t = run["timing"]
        if how == "on":
            check_obs_dir(tag, run, epochs, n_steps, flops, card)
        elif t["trace_status"] != "ungateable" or t["hbm_source"] != "off" \
                or (run["dir"] / "pod_trace.json").exists():
            fail(f"{tag}: trace {t['trace_status']}, hbm "
                 f"{t['hbm_source']}: the observability stayed on")
        shutil.rmtree(run["dir"], ignore_errors=True)
        s2 = run["supersteps"][0]
        same = (_epochs_of(run) == _epochs_of(on)
                and run["counts"] == on["counts"]
                and (s2.programs, s2.replays, s2.captured_launches)
                == graphs)
        print(f"{tag}: epochs (Avg, eval) {_epochs_of(run)}, launches "
              f"{run['counts']}, programs {s2.programs}, replays "
              f"{s2.replays}: equal to the default run's {same}")
        if not same:
            fail(f"{tag}: the losses, launches or graphs differ from the "
                 f"default run's")
        paths[tag] = run["counts"]
        step_ms.append((how, 1e3 * t["run_s"] / t["steps"]))
    print("obs 13a: step ms in turns "
          + ", ".join(f"{h} {ms:.3f}" for h, ms in step_ms) + f"; {card}")
    return paths


@contextlib.contextmanager
def _serve_engines():
    """Every serve engine the serve CLI builds inside the block, for the
    launches its graphs' replays ran."""
    from tpudist_torch.serve import engine as engine_mod

    made, real = [], engine_mod.ServeEngine

    def make(*args, **kw):
        made.append(real(*args, **kw))
        return made[-1]
    engine_mod.ServeEngine = make
    try:
        yield made
    finally:
        engine_mod.ServeEngine = real


# phase 4's serving configuration through the serve CLI
SERVE_ARGV = ["--vocab-size", "32000", "--n-layers", "4", "--d-model",
              "2048", "--n-heads", "16", "--n-kv-heads", "16", "--d-ff",
              "5504", "--slots", "8", "--max-seq", "1024", "--prompt-pad",
              "512", "--decode-steps-per-dispatch", "8", "--adapt", "on",
              "--requests", "16", "--max-new-tokens", "32", "--seed", "0"]


def obs_serve(torch, fa, fx, card: str):
    """Phase 13b: ``python -m tpudist_torch.serve`` (its ``run``) at phase
    4's configuration on the graph engine, its default trace and memory
    ledger, then with ``--trace off``: one slot track in
    ``pod_trace.json`` for each slot that served, the ledger, ``run_id``
    on every record, the tokens equal, the program pin, the flash
    launches exact. Returns each run's launches."""
    from tpudist_torch.serve import cli as serve_cli

    runs, paths = {}, {}
    for how in ("on", "off"):
        tag = f"obs_serve_{how}"
        save = ROOT / "build" / "chip_smoke_serve" / how
        shutil.rmtree(save, ignore_errors=True)
        argv = SERVE_ARGV + ["--save-dir", str(save)] \
            + (["--trace", "off"] if how == "off" else [])
        _reset_launches(fa, fx)
        with _serve_engines() as made:
            summary = serve_cli.run(serve_cli.parse_args(argv))
        torch.cuda.synchronize()
        engine = made[0]
        engine.assert_two_programs()
        counts = {"flash_attention_fwd": engine.kernel_launches()}
        want = engine.model_cfg.n_layers * (summary["admitted"] + 1)
        recs = [json.loads(ln) for ln in
                (save / "metrics.jsonl").read_text().splitlines()]
        print(f"{tag}: {summary['completed']}/{summary['requests']} "
              f"requests, tokens/s/chip "
              f"{summary['tokens_per_sec_per_chip']}, programs "
              f"{engine.compile_counts()}, graph pools "
              f"{engine.graph_pool_bytes / MB:.1f} MB, flash launches "
              f"{counts['flash_attention_fwd']} (want {want}); {card}")
        if summary["completed"] != 16 or counts["flash_attention_fwd"] \
                != want:
            fail(f"{tag}: completed {summary['completed']}, flash "
                 f"launches {counts['flash_attention_fwd']} (want {want})")
        if how == "on":
            pod = _read_json(save / "pod_trace.json", tag)
            tracks = {e["args"]["name"] for e in pod["traceEvents"]
                      if e.get("ph") == "M" and e.get("tid", 0) >= 1000}
            served = {f"slot{r['slot']}" for r in recs
                      if r["kind"] == "serve_request"
                      and r["event"] == "admitted"}
            if not served or tracks != served \
                    or pod["metadata"].get("dropped") != 0:
                fail(f"{tag}: slot tracks {sorted(tracks)}, slots that "
                     f"served {sorted(served)}")
            print(f"{tag}: {len(tracks)} slot tracks, "
                  f"{pod['metadata']['spans']} spans; "
                  + _ledger_line(tag, save, recs))
            if any(not r.get("run_id") for r in recs):
                fail(f"{tag}: a record without run_id")
        elif (save / "pod_trace.json").exists():
            fail(f"{tag}: --trace off wrote a trace")
        runs[how] = summary
        paths[tag] = counts
        shutil.rmtree(save, ignore_errors=True)
        del engine, made
        torch.cuda.empty_cache()
    same = _tokens_of(runs["on"]) == _tokens_of(runs["off"])
    print(f"obs 13b: tokens traced vs --trace off equal {same}; "
          f"tokens/s/chip on {runs['on']['tokens_per_sec_per_chip']}, off "
          f"{runs['off']['tokens_per_sec_per_chip']}; {card}")
    if not same:
        fail("obs 13b: the traced run's tokens differ from --trace off's")
    return paths


def stall_drill(torch, card: str) -> None:
    """Phase 13c: a CUDA graph (64 4096 x 4096 f32 products) is
    captured while an ``HbmSampler`` reads the allocator's counters every
    millisecond from its thread (the capture must hold, its replay equal
    the eager body within f32 1e-5); then a ``FlightRecorder`` with a
    2 s stall window gets no progress while the graph replays: its
    watchdog writes ``flightrec.worker0`` with the threads' stacks and
    the card's ``memory_stats``, and the replays' output stays equal to
    the first replay's."""
    from tpudist_torch.obs.hbm import HbmSampler
    from tpudist_torch.obs.heartbeat import FlightRecorder

    out = ROOT / "build" / "chip_smoke_stall"
    shutil.rmtree(out, ignore_errors=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    x = torch.randn(4096, 4096, device=dev, generator=gen) / 64
    w = torch.randn(4096, 4096, device=dev, generator=gen) / 64

    def body():
        y = x
        for _ in range(64):
            y = torch.tanh(y @ w)
        return y
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    sampler = HbmSampler(period_s=0.001, devices=[0])
    try:
        reads = sampler.samples
        with torch.cuda.graph(graph):
            y = body()
        reads = sampler.samples - reads
    finally:
        sampler.close()
    graph.replay()
    torch.cuda.synchronize()
    ref = y.clone()
    d_eager = (ref - eager).abs().max().item()
    print(f"stall drill: the capture ran beside {reads} sampler reads; "
          f"replay vs eager max |d| {d_eager:.3e}; {card}")
    if reads < 1 or d_eager > 1e-5:
        fail(f"stall drill: {reads} sampler reads during the capture, "
             f"replay vs eager {d_eager:.3e}")
    rec = FlightRecorder(str(out), stall_timeout_s=2.0)
    t0 = time.perf_counter()
    n = 0
    try:
        while rec.dumps < 1 and time.perf_counter() - t0 < 30:
            graph.replay()
            n += 1
            if n % 20 == 0:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        same = torch.equal(y, ref)
    finally:
        rec.close()
    doc = _read_json(out / "flightrec.worker0", "stall drill")
    mem = {m["id"]: m["stats"] for m in doc.get("memory_stats") or []}
    card0 = (mem.get(0) or {}).get("allocated_bytes.all.current", 0)
    print(f"stall drill: flight record after {wall:.2f} s and {n} replays "
          f"(reason {doc['reason']}, stall_s {doc['stall_s']}), stacks "
          f"{len(doc['thread_stacks'].splitlines())} lines, memory_stats "
          f"of {len(mem)} card(s), card 0 allocated {card0 / MB:.1f} MB; "
          f"output equal {same}; {card}")
    if doc["reason"] != "stall" or "File" not in doc["thread_stacks"] \
            or card0 <= 0 or not same:
        fail("stall drill: no stall record with stacks and the card's "
             "memory_stats, or the replay's output changed")
    shutil.rmtree(out, ignore_errors=True)
    del graph, x, w, y, ref, eager
    torch.cuda.empty_cache()


def remat_check(torch, card: str):
    """Phase 12b: one full-width training step (BASELINE config #5, seq
    512, f32, the fused head) with ``--remat`` (each layer checkpointed,
    recomputed in the backward) and without, each captured as a CUDA
    graph after an eager warm-up and replayed: the loss and every param
    grad within f32 1e-4 (max |d| / max |no remat| per tensor)."""
    from tpudist_torch import data as data_lib
    from tpudist_torch.config import flagship_model_config
    from tpudist_torch.models import transformer

    cfg = flagship_model_config(512)
    model = transformer.init(
        cfg, generator=torch.Generator(device="cuda").manual_seed(42))
    tokens = torch.as_tensor(data_lib.make_synthetic_tokens(
        8, 513, cfg.vocab_size, 42), device="cuda").long()
    params = list(model.parameters())

    def step(remat):
        loss = transformer.loss_fn(model, tokens, cfg, dtype=torch.float32,
                                   remat=remat, fused_xent=True)
        return (loss.detach(), *torch.autograd.grad(loss, params))

    outs, pools = {}, {}
    main = torch.cuda.current_stream()
    for remat in (False, True):
        side = torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            step(remat)
        main.wait_stream(side)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = step(remat)
        graph.replay()
        torch.cuda.synchronize()
        pools[remat] = torch.cuda.memory_reserved() - reserved
        outs[remat] = [x.clone() for x in out]
        del graph, out
        torch.cuda.empty_cache()
    ref, got = outs[False], outs[True]
    errs = [((g - r).abs().max() / r.abs().max().clamp_min(1e-30)).item()
            for g, r in zip(got, ref)]
    worst = max(errs)
    print(f"remat check: seq 512 f32 fused head, replayed graphs: loss "
          f"{got[0].item():.6f} (remat) vs {ref[0].item():.6f}; worst "
          f"relative difference {worst:.3e} over the loss and "
          f"{len(errs) - 1} grads (tol 1e-4); graph pools "
          f"{pools[True] / MB:.1f} MB with remat, {pools[False] / MB:.1f} "
          f"MB without; {card}")
    del model, outs, ref, got
    torch.cuda.empty_cache()
    if not worst <= 1e-4:
        fail(f"remat check: remat moved the step by {worst:.3e}")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(target, args_by_rank, timeout_s: float, what: str):
    """Run ``target(*args, queue)`` in one fresh process per entry of
    ``args_by_rank`` (``spawn``: the card's state is not forked); each puts
    one dict with its ``rank`` on the queue. Returns them by rank; fails
    when a process exits non-zero, puts nothing or outlives
    ``timeout_s``. Every process is gone when it returns."""
    import multiprocessing as mp
    import queue as queue_lib

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=target, args=(*args, q))
             for args in args_by_rank]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(results) < len(procs) and time.monotonic() < deadline:
            try:
                r = q.get(timeout=5)
            except queue_lib.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                continue
            results[r["rank"]] = r
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if len(results) < len(procs) or any(codes):
        fail(f"{what}: process exit codes {codes}, results from ranks "
             f"{sorted(results)}")
    return [results[r] for r in range(len(procs))]


def _dp_train_rank(rank, world, port, argv, verdict, queue):
    """Phase 10a, one rank in a process of its own: the train CLI's
    ``main`` under the env contract, its launch counts set to 0 just
    before and read just after."""
    os.environ.update(TPUDIST_COORDINATOR=f"localhost:{port}",
                      TPUDIST_NUM_PROCESSES=str(world),
                      TPUDIST_PROCESS_ID=str(rank),
                      TPUDIST_VERDICT_PATH=verdict)
    import torch

    from tpudist_torch import train as train_lib
    from tpudist_torch.ops.cuda import flash_attention as fa
    from tpudist_torch.ops.cuda import fused_xent as fx

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tee = _Tee(sys.stdout)
    _reset_launches(fa, fx)
    t0 = time.perf_counter()
    with _supersteps() as made, contextlib.redirect_stdout(tee):
        rc = train_lib.main(argv)
    torch.cuda.synchronize()
    queue.put({"rank": rank, "rc": rc,
               "counts": _path_launches(fa, fx, made),
               "graphs": [(sup.programs, sup.replays) for sup in made],
               "out": tee.buf.getvalue(),
               "wall": time.perf_counter() - t0,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9})


def dp_train_slice(torch, fa, card: str, tag: str = "train_seq512_dp",
                   n_samples: int = 32, dispatch=("--log-every", "1"),
                   want_graphs=None):
    """Phase 10a, the path ``train_seq512_dp``: ``python -m
    tpudist_torch.train`` as one process per visible card under the
    ``TPUDIST_COORDINATOR`` / ``TPUDIST_NUM_PROCESSES`` /
    ``TPUDIST_PROCESS_ID`` contract (NCCL, one card a rank), BASELINE
    config #5 at seq 512, f32, ``--lm-head fused``, global batch 8, 32
    samples, 1 epoch. Rank 0 alone prints the contract, every rank's
    verdict and the final one say success, and every rank launches each
    kernel exactly as its share of the path calls it. Returns the
    launches summed over the ranks. Phase 11c runs it as the path ``tag``
    with other ``n_samples`` and ``dispatch`` flags (the superstep, its
    NCCL all-reduce captured), where each rank's ``(programs,
    replays)`` must be ``want_graphs``."""
    from tpudist_torch import config as config_lib

    seq, epochs = 512, 1
    world = torch.cuda.device_count()
    save = ROOT / "build" / "chip_smoke_train" / tag
    shutil.rmtree(save, ignore_errors=True)
    argv = ["--model", "transformer", "--seq-len", str(seq),
            "--train-batch-size", "8", "--n-samples", str(n_samples),
            "--epochs", str(epochs), "--seed", "42", *dispatch,
            "--lm-head", "fused", "--save-dir", str(save)]
    cfg = config_lib.parse_args(argv)
    m = cfg.model
    print(f"train {tag}: V{m.vocab_size} L{m.n_layers} d{m.d_model} "
          f"h{m.n_heads} kv{m.n_kv_heads} d_ff{m.d_ff} {cfg.dtype}, global "
          f"batch {cfg.batch_size} over {world} process(es) (local "
          f"{cfg.batch_size // world}), {n_samples} samples, {epochs} "
          f"epoch(s), --lm-head fused; {card}")
    verdict = save / "job_status.txt"
    port = _free_port()
    ranks = _spawn(_dp_train_rank,
                   [(r, world, port, argv, str(verdict))
                    for r in range(world)], 300, f"train {tag}")
    recs = [json.loads(ln) for ln in
            (save / "metrics.jsonl").read_text().splitlines()]
    timing = [r for r in recs if r["kind"] == "timing"]
    losses = [r["loss"] for r in recs if r["kind"] == "step"]
    statuses = [verdict.read_text() if verdict.is_file() else None] + [
        (save / f"job_status.txt.worker{r}").read_text()
        if (save / f"job_status.txt.worker{r}").is_file() else None
        for r in range(world)]
    shutil.rmtree(save, ignore_errors=True)
    if [r["rc"] for r in ranks] != [0] * world or not timing \
            or statuses != ["success"] * (world + 1):
        fail(f"train {tag}: exit codes {[r['rc'] for r in ranks]}, final "
             f"and worker verdicts {statuses}")
    out = ranks[0]["out"]
    check_contract(tag, out, epochs, losses)
    if f"{world} process(es) (nccl)" not in out:
        fail(f"train {tag}: rank 0 did not report {world} NCCL process(es)")
    for r in ranks[1:]:
        if "Epoch" in r["out"] or "Training completed." in r["out"]:
            fail(f"train {tag}: rank {r['rank']} printed the contract")
    want = want_launches(fa, m, seq, epochs * (n_samples // cfg.batch_size),
                         epochs, fused=True)
    t = timing[-1]
    sps = t["steps"] / t["run_s"]
    print(f"train {tag}: step losses {losses}; "
          f"verdicts {statuses}; {sps:.4f} steps/s, "
          f"{sps * cfg.batch_size * m.max_seq_len:.1f} tokens/s over "
          f"{world} card(s), step {1e3 * t['run_s'] / t['steps']:.2f} ms "
          f"(over {t['steps']} steps after the first); first step + "
          f"loads {t['compile_warmup_s']:.2f} s; rank walls "
          f"{[round(r['wall'], 2) for r in ranks]} s; peak device memory "
          f"by rank {[round(r['peak_gb'], 3) for r in ranks]} GB")
    total = dict.fromkeys(want, 0)
    for r in ranks:
        print(f"train {tag}: rank {r['rank']} kernel launches "
              f"{r['counts']} (want {want})")
        if r["counts"] != want:
            fail(f"train {tag}: rank {r['rank']} kernel launches "
                 f"{r['counts']}, want {want}")
        if want_graphs is not None:
            print(f"train {tag}: rank {r['rank']} (programs, replays) "
                  f"{r['graphs']}")
            if r["graphs"] != [want_graphs]:
                fail(f"train {tag}: rank {r['rank']} (programs, replays) "
                     f"{r['graphs']}, want {[want_graphs]}")
        for k, v in r["counts"].items():
            total[k] += v
    return total


def _dp_batches(torch, cfg, rank: int, world: int, device):
    """Two steps' batches of this rank: its shard of global batches of 8
    (``plan_epoch``), on ``device``."""
    from tpudist_torch import data as data_lib
    tokens = data_lib.make_synthetic_tokens(
        16, cfg.model.max_seq_len + 1, cfg.model.vocab_size, cfg.seed)
    plan = data_lib.plan_epoch((tokens,), batch_size=cfg.batch_size,
                               seed=cfg.seed, epoch=0, process_index=rank,
                               process_count=world)
    slab, = plan.slab(0, 2)
    return [(torch.as_tensor(b, device=device).long(),) for b in slab]


# Phase 10b holds a param to the one process's only where its first |g|
# is at least this share of its tensor's largest. Adam's first steps are
# near lr sign(g), so a gradient that the reduce rounds by dg (~4e-6 of
# the largest) moves its param by ~lr dg / |g|: a good part of lr where
# |g| is small. Measured at full width (PERF.md, PR 9), the params' worst
# distance falls with the floor: 1.5e-3 of the largest element at |g| >=
# 1e-6, 2.3e-4 at 1e-5, 3.2e-5 at 1 % of the largest |g|.
G_FLOOR = 1e-2


def _dp_reduce_rank(rank, ports, queue):
    """Phase 10b, one of two ranks on card 0: NCCL's refusal; on rank 0,
    two steps of one process at the global batch of 8 before any group
    is up; then two steps of the engine's data-parallel step over gloo,
    timed alone. Rank 0 then holds the reduced gradients each step
    handed to Adam against the global batch's gradients at the same
    params, and its losses and params against the one process's (the
    params where the first reduced gradient's |g| is at least ``G_FLOOR``
    of its tensor's largest); the replicas are compared bitwise."""
    os.environ["CUDA_VISIBLE_DEVICES"] = "0"
    import torch
    import torch.distributed as dist

    from tpudist_torch import config as config_lib
    from tpudist_torch import engine as engine_lib
    from tpudist_torch.parallel import distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    refusal = None
    try:
        distributed.initialize(f"localhost:{ports[0]}", 2, rank,
                               device="cuda")
        distributed.shutdown()
    except ValueError as e:
        refusal = str(e)
    # phase 10a's model, f32, fused head
    cfg = config_lib.parse_args(
        ["--model", "transformer", "--seq-len", "512", "--train-batch-size",
         "8", "--lm-head", "fused", "--seed", "42"])
    dev = torch.device("cuda", 0)
    # rank 0 keeps, of each data-parallel step, the reduced gradients
    # the step hands to Adam and the params they were taken at
    taken, live = [], {}
    real_apply = engine_lib.Adam.apply

    def apply(self, grads, state, params, *scalars):
        if live.get("keep"):
            taken.append(([g.detach().clone() for g in grads],
                          [p.detach().clone() for p in params]))
        return real_apply(self, grads, state, params, *scalars)
    engine_lib.Adam.apply = apply

    def two_steps(index, count):
        state = engine_lib.init_state(cfg, dev)
        step = engine_lib.make_train_step(cfg, dev)
        losses, step_ms = [], []
        for batch in _dp_batches(torch, cfg, index, count, dev):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(state, batch)
            losses.append(loss.item())
            step_ms.append((time.perf_counter() - t0) * 1e3)
        return state, losses, step_ms

    if rank == 0:
        one = two_steps(0, 1)
        live["keep"] = True
    distributed.initialize(f"localhost:{ports[1]}", 2, rank, device="cuda",
                           backend="gloo")
    state, losses, step_ms = two_steps(rank, 2)
    same = True
    for p in state.params.parameters():
        theirs = p.detach().clone() if rank == 1 else torch.empty_like(p)
        dist.broadcast(theirs, src=1)
        same = same and torch.equal(theirs, p.detach())
    distributed.shutdown()
    out = {"rank": rank, "refusal": refusal, "losses": losses,
           "step_ms": step_ms, "same": same}
    if rank == 0:
        one_state, out["one_losses"], out["one_step_ms"] = one
        names = [n for n, _ in state.params.named_parameters()]
        out["params"] = {}
        for name, p, w, g1 in zip(names, state.params.parameters(),
                                  one_state.params.parameters(),
                                  taken[0][0]):
            d = (p - w).detach().abs()
            worst = int(d.argmax())
            w_max = w.abs().max().item()

            def within(held):
                """(max |d| / max |w| where held, elements not held)"""
                return ((d[held].max().item() / w_max if held.any()
                         else 0.0), int((~held).sum()))
            out["params"][name] = {
                "err": d.max().item() / w_max,
                "held": within(g1.abs() >= G_FLOOR * g1.abs().max()),
                # the same at absolute floors, for the reader
                "abs_floors": {f: within(g1.abs() >= f)
                               for f in (1e-6, 1e-5)},
                "beyond": int((d > 1e-4 * w_max).sum()),
                "numel": d.numel(), "lr_units": d.max().item() / cfg.lr,
                "g1_at_worst": g1.flatten()[worst].abs().item()}
        # the global batch's gradients at each step's params, in the
        # one process's (now spare) model
        loss_fn = engine_lib.make_loss_fn(cfg, dev)
        scratch = one_state.params
        out["grad_errs"] = []
        for (grads, before), batch in zip(
                taken, _dp_batches(torch, cfg, 0, 1, dev)):
            with torch.no_grad():
                for p, b in zip(scratch.parameters(), before):
                    p.copy_(b)
            _, want = engine_lib._microbatch(loss_fn, scratch, batch, 1)
            out["grad_errs"].append({
                name: ((g - w).abs().max()
                       / w.abs().max().clamp_min(1e-30)).item()
                for name, g, w in zip(names, grads, want)})
    queue.put(out)


def dp_reduce_check(torch, card: str):
    """Phase 10b: the gradient reduce across two ranks on the one card.
    NCCL cannot put two ranks on one card, and ``initialize`` must say so;
    with gloo (host copies) passed explicitly, two steps of the engine's
    data-parallel step at local batch 4: at each, the reduced gradients
    handed to Adam against the global batch of 8's at the same params
    within f32 1e-4 of each gradient's largest element (phase 7's
    yardstick); against one process stepping the global batch on the
    card, the losses within f32 1e-4, and the params after the 2 steps
    within f32 1e-4 of each param's largest element where the first
    gradient's |g| is at least ``G_FLOOR`` of its tensor's largest (the
    elements left out are counted: there Adam's near-sign step turns the
    reduce's rounding of g into a good part of lr); the two ranks' losses
    equal and their params bitwise equal."""
    ports = (_free_port(), _free_port())
    a, b = _spawn(_dp_reduce_rank, [(r, ports) for r in range(2)], 300,
                  "dp reduce")
    for r in (a, b):
        if not (r["refusal"] and "would share one card" in r["refusal"]):
            fail(f"dp reduce: rank {r['rank']}: two NCCL ranks on one "
                 f"card were not refused ({r['refusal']!r})")
    print(f"dp reduce: NCCL refused two ranks on one card: {a['refusal']}")
    loss_err = max(abs(x - y) / abs(y) for x, y in zip(a["losses"],
                                                       a["one_losses"]))
    grad_worst = [max(e, key=e.get) for e in a["grad_errs"]]
    grad_err = max(e[w] for e, w in zip(a["grad_errs"], grad_worst))
    print(f"dp reduce: 2 gloo ranks on one card, local batch 4, 2 steps: "
          f"reduced gradients vs the global batch's at the same params, "
          f"worst of each step "
          + ", ".join(f"{w} {e[w]:.3e}" for e, w in
                      zip(a["grad_errs"], grad_worst))
          + f" of its largest element over {len(a['grad_errs'][0])} "
          f"params (tol 1e-4); losses {a['losses']} (rank 1 "
          f"{b['losses']}) vs one process {a['one_losses']}, relative "
          f"error {loss_err:.3e} (tol 1e-4); ranks' params bitwise "
          f"equal: {a['same'] and b['same']}")
    for name, p in a["params"].items():
        print(f"dp reduce: param {name} after 2 steps vs one process, max "
              f"|d| / its largest element: {p['held'][0]:.3e} where the "
              f"first |g| >= {G_FLOOR:g} of its largest (tol 1e-4; "
              f"{p['held'][1]} of {p['numel']} elements left out); "
              + "; ".join(f"{e:.3e} where |g| >= {f:g} ({n} left out)"
                          for f, (e, n) in p["abs_floors"].items())
              + f"; {p['err']:.3e} over all elements ({p['lr_units']:.3f} "
              f"lr, {p['beyond']} beyond 1e-4), the worst one's first |g| "
              f"{p['g1_at_worst']:.3e}")
    print(f"dp reduce: step times (gloo through host memory, two ranks "
          f"on one card: not a fabric number) rank 0 "
          f"{[round(x, 3) for x in a['step_ms']]} ms, rank 1 "
          f"{[round(x, 3) for x in b['step_ms']]} ms; one process at "
          f"batch 8 {[round(x, 3) for x in a['one_step_ms']]} ms; {card}")
    if len(a["grad_errs"]) != 2 or a["losses"] != b["losses"] \
            or not (a["same"] and b["same"]):
        fail("dp reduce: the two ranks disagree")
    param_worst = max(a["params"], key=lambda n: a["params"][n]["held"][0])
    param_err = a["params"][param_worst]["held"][0]
    if not (loss_err <= 1e-4 and grad_err <= 1e-4 and param_err <= 1e-4):
        fail(f"dp reduce: off by {loss_err:.3e} (loss against one "
             f"process), {grad_err:.3e} (gradients at the same params), "
             f"{param_err:.3e} ({param_worst} after 2 steps, where the "
             f"first |g| >= {G_FLOOR:g} of its largest)")


def plain_attention(torch, fa):
    """Attention through the plain versions on the card, forward and
    backward: the reference the step-level check holds the kernels
    against."""
    class Plain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, cos, sin, causal):
            o, lse = fa.flash_attention_plain(q, k, v, cos=cos, sin=sin,
                                              causal=causal)
            ctx.save_for_backward(q, k, v, o, lse, cos, sin)
            ctx.causal = causal
            return o

        @staticmethod
        def backward(ctx, do):
            q, k, v, o, lse, cos, sin = ctx.saved_tensors
            dq, dk, dv = fa.flash_attention_bwd_plain(
                q, k, v, o, lse, do, torch.zeros_like(lse), cos=cos,
                sin=sin, causal=ctx.causal)
            return dq, dk, dv, None, None, None

    def attention(q, k, v, *, cos=None, sin=None, causal=True):
        return Plain.apply(q, k, v, cos, sin, causal)
    attention.accepts_rope = True
    return attention


def plain_head(torch, fx):
    """The fused head through the kernels' plain versions on the card,
    forward and backward: the step-level check's reference for it."""
    class Plain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, h, emb, tgt):
            loss, lse = fx.fused_xent_fwd_plain(h, emb, tgt)
            ctx.save_for_backward(h, emb, tgt, lse)
            return loss

        @staticmethod
        def backward(ctx, ct):
            h, emb, tgt, lse = ctx.saved_tensors
            return (*fx.fused_xent_bwd_plain(h, emb, tgt, lse, ct), None)

    def head(emb, h, targets):
        b, s, d = h.shape
        return torch.mean(Plain.apply(h.reshape(b * s, d), emb,
                                      targets.reshape(b * s)))
    return head


def head_vs_f64(torch, fx, h, emb, tgt) -> str:
    """The fused head alone at a training step's data: max |x - float64|
    / max |float64| of lse, dh and dE (ct = 1 / t), for the kernels and
    for the plain versions."""
    t = h.shape[0]
    ct = torch.full((t,), 1.0 / t, device="cuda")
    with torch.no_grad():
        _, lse = fx.fused_xent_fwd(h, emb, tgt)
        kernel = (lse, *fx.fused_xent_bwd(h, emb, tgt, lse, ct))
        _, lse = fx.fused_xent_fwd_plain(h, emb, tgt)
        plain = (lse, *fx.fused_xent_bwd_plain(h, emb, tgt, lse, ct))
        hd, ed = h.double(), emb.double()
        dl = hd @ ed.T
        lse = torch.logsumexp(dl, dim=1)
        dl = torch.exp(dl - lse[:, None])
        dl[torch.arange(t, device="cuda"), tgt] -= 1.0
        dl /= t
        exact = (lse, dl @ ed, dl.T @ hd)
        del dl
    errs = []
    for name, k, p, x in zip(("lse", "dh", "dE"), kernel, plain, exact):
        m = x.abs().max()
        errs.append(f"{name} {((k.double() - x).abs().max() / m).item():.2e} "
                    f"(plain {((p.double() - x).abs().max() / m).item():.2e})")
    return "; ".join(errs)


def step_check(torch, fa, fx, seq: int, fused: bool = False):
    """Phase 7: one training step's loss and every param grad at full
    width, through the kernels and through the plain versions on the
    card, within f32 1e-4 (max |d| / max |plain| per tensor). ``fused``
    takes the fused LM head (its kernels against their plain versions)
    where the plain whole-logits head is the default."""
    from tpudist_torch import data as data_lib
    from tpudist_torch.config import flagship_model_config
    from tpudist_torch.models import transformer

    cfg = flagship_model_config(seq)
    model = transformer.init(
        cfg, generator=torch.Generator(device="cuda").manual_seed(42))
    tokens = torch.as_tensor(data_lib.make_synthetic_tokens(
        8, seq + 1, cfg.vocab_size, 42), device="cuda").long()

    def loss_and_grads(attn_impl, head):
        h = transformer.hidden_states(model, tokens[:, :-1], cfg,
                                      dtype=torch.float32,
                                      attn_impl=attn_impl)
        loss = head(model.embed, h, tokens[:, 1:])
        grads = torch.autograd.grad(loss, list(model.parameters()))
        return loss.detach(), grads, h.detach()

    def kernel_head(emb, h, targets):
        return transformer.head_loss(emb, h, targets, fused_xent=fused)

    before = _launch_counts(fa, fx)
    loss_k, grads_k, h = loss_and_grads(transformer._attention, kernel_head)
    ran = {k: v - before[k] for k, v in _launch_counts(fa, fx).items()}
    loss_p, grads_p, _ = loss_and_grads(
        plain_attention(torch, fa),
        plain_head(torch, fx) if fused else kernel_head)
    torch.cuda.synchronize()
    errs = {"loss": abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())}
    for (name, _), gk, gp in zip(model.named_parameters(), grads_k,
                                 grads_p):
        errs[name] = ((gk - gp).abs().max()
                      / gp.abs().max().clamp_min(1e-30)).item()
    worst = max(errs, key=errs.get)
    tag = f"seq {seq}{' fused head' if fused else ''}"
    print(f"step check {tag}: loss {loss_k.item():.6f} (kernels) vs "
          f"{loss_p.item():.6f} (plain); worst relative error "
          f"{errs[worst]:.3e} ({worst}) over the loss and "
          f"{len(errs) - 1} grads (tol 1e-4); kernel launches {ran}")
    if fused:
        print(f"step check {tag}: the head alone against float64, max |d| "
              f"/ max |f64|: " + head_vs_f64(
                  torch, fx, h.reshape(-1, cfg.d_model), model.embed.detach(),
                  tokens[:, 1:].reshape(-1)))
    del model, grads_k, grads_p, h
    torch.cuda.empty_cache()
    if errs[worst] > 1e-4 or not math.isfinite(errs[worst]):
        fail(f"step check {tag}: {worst} off by {errs[worst]:.3e}")
    merged = fa.uses_merged_backward(seq, seq)
    if not ran["flash_attention_bwd_dqkv" if merged
               else "flash_attention_bwd_dkv"]:
        fail(f"step check {tag}: the backward kernels did not run")
    if fused and (ran["fused_xent_fwd"], ran["fused_xent_bwd"]) != (1, 1):
        fail(f"step check {tag}: the fused head kernels did not run once")


def profile_train(torch, seq: int, lm_head: str = "plain",
                  dtype: str = "float32"):
    """--profile: device time by kernel over two steady training steps at
    full width with the ``lm_head`` head in ``dtype`` (bf16 with the bf16
    Adam second moment, as phase 9), and the device's busy share of their
    wall time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from tpudist_torch import config as config_lib
    from tpudist_torch import data as data_lib
    from tpudist_torch import engine as engine_lib

    cfg = config_lib.parse_args(
        ["--model", "transformer", "--seq-len", str(seq),
         "--train-batch-size", "8", "--lm-head", lm_head, "--dtype", dtype]
        + (["--adam-nu-dtype", "bfloat16"] if dtype == "bfloat16" else []))
    dev = torch.device("cuda")
    state = engine_lib.init_state(cfg, dev)
    step = engine_lib.make_train_step(cfg, dev)
    batch = (torch.as_tensor(data_lib.make_synthetic_tokens(
        8, seq + 1, cfg.model.vocab_size), device=dev).long(),)
    state, loss = step(state, batch)
    loss.item()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            state, loss = step(state, batch)
        loss.item()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_time_total > 0 and e.device_type.name == "CUDA"]
    busy = sum(r[1] for r in rows)
    print(f"profile: 2 train steps at seq {seq} {dtype}, --lm-head "
          f"{lm_head}: "
          f"{wall:.3f} ms wall, "
          f"device kernel time {busy:.3f} ms ({100 * busy / wall:.1f}% "
          f"busy)")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:12]:
        print(f"profile:   {ms:9.3f} ms {100 * ms / busy:5.1f}% {count:5d}x"
              f"  {key[:80]}")
    head = [r for r in rows if "xent_" in r[0]]
    if head:
        ms = sum(r[1] for r in head)
        print(f"profile:   the fused head's kernels: {ms:.3f} ms "
              f"({100 * ms / busy:.1f}%, {sum(r[2] for r in head)} "
              f"launches)")
    del state
    torch.cuda.empty_cache()


def mma_peaks(torch, build):
    """--profile: the rate the tensor cores reach through mma.sync, the
    flash forward's instruction (``tpudist_torch/csrc/mma_peak.cu``:
    independent accumulator chains, no loads, 4 blocks of 8 warps an
    SM), beside the data sheet's dense peaks, which only wgmma reaches."""
    import ctypes

    fn = build.load("mma_peak", ("mma_peak.cu",)).tpudist_mma_peak
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_float)]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for kind, name, peak in ((0, "TF32 m16n8k8", 495.0),
                             (1, "bf16 m16n8k16", 989.0)):
        rate = ctypes.c_float()
        err = fn(kind, 4 * sms, 2000, ctypes.byref(rate))
        if err:
            fail(f"mma_peak ({name}) failed: cudaError {err}")
        print(f"profile: mma.sync {name}: {rate.value:.1f} TFLOP/s "
              f"({100 * rate.value / peak:.1f} % of the data sheet's "
              f"{peak:.0f} dense)")


def _profiled(torch, fn):
    """``fn()`` under torch.profiler, fenced: its wall ms and the device
    kernels' (name, ms, count) rows."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return wall, [(e.key, e.device_time_total / 1e3, e.count)
                  for e in prof.key_averages()
                  if e.device_time_total > 0
                  and e.device_type.name == "CUDA"]


def profile_superstep(torch, tag: str, argv, k: int):
    """--profile: phase 11's configuration ``argv``: one replayed k-step
    superstep against k per-step steps on the same state and batches,
    each window's wall, device kernel time and busy share."""
    from tpudist_torch import config as config_lib
    from tpudist_torch import data as data_lib
    from tpudist_torch import engine as engine_lib
    from tpudist_torch.parallel import staging as staging_lib

    cfg = config_lib.parse_args(argv)
    dev = torch.device("cuda")
    if cfg.model.name == "mlp":
        sources = data_lib.make_synthetic_data(
            cfg.data.n_samples, cfg.data.n_features, cfg.data.seed)
    else:
        sources = (data_lib.make_synthetic_tokens(
            cfg.data.n_samples, cfg.model.max_seq_len + 1,
            cfg.model.vocab_size, cfg.data.seed),)
    plan = data_lib.plan_epoch(sources, batch_size=cfg.batch_size,
                               seed=cfg.seed, epoch=0)
    slab = staging_lib.put_slab(plan.slab(0, k), dev).arrays_for()
    state = engine_lib.init_state(cfg, dev)
    sup = engine_lib.make_superstep(cfg, dev, k)
    step = engine_lib.make_train_step(cfg, dev)
    total = torch.zeros((), device=dev)
    for _ in range(2):          # the eager warm-up and captures, a replay
        state, total, _ = sup(state, total, slab, 0, k)
    for i in range(k):
        state, _ = step(state, tuple(a[i] for a in slab))

    def replay():
        sup(state, total, slab, 0, k)[2].cpu()

    def per_step():
        for i in range(k):
            loss = step(state, tuple(a[i] for a in slab))[1]
        loss.cpu()

    for how, fn in (("one replayed superstep", replay),
                    (f"{k} per-step steps", per_step)):
        wall, rows = _profiled(torch, fn)
        busy = sum(r[1] for r in rows)
        print(f"profile: {tag}, {how} (k={k}): {wall:.3f} ms wall, "
              f"device kernel time {busy:.3f} ms "
              f"({100 * busy / wall:.1f}% busy), "
              f"{sum(r[2] for r in rows)} kernels")
    del state, sup, step
    torch.cuda.empty_cache()


def profile_serve(torch, engine, params, requests):
    """Device time by kernel in windows at the slice's shapes, one
    prefill per slot and then one decode superstep over the full batch,
    each replayed from its graph and run as the engine's eager body, and
    the device's busy share of each window's wall time (the profiler's
    own host cost is inside the wall). Returns each window's (wall ms,
    busy ms, flash forward kernels)."""
    out = {}

    def window(name, fn):
        wall, rows = _profiled(torch, fn)
        busy = sum(r[1] for r in rows)
        flash = sum(c for k, _, c in rows if "flash_fwd_kernel" in k)
        print(f"profile: {name}: {wall:.3f} ms wall, device kernel time "
              f"{busy:.3f} ms ({100 * busy / wall:.1f}% busy), "
              f"flash_fwd_kernel x{flash}")
        for key, ms, count in sorted(rows, key=lambda r: -r[1])[:8]:
            print(f"profile:   {ms:9.3f} ms {count:5d}x  {key[:80]}")
        out[name] = (wall, busy, flash)

    for how, eng in (("graphs", engine), ("eager bodies",
                                          _EagerBodies(engine))):
        state = engine.init_state()

        def prefills():
            for slot, req in enumerate(requests[:engine.slots]):
                eng.prefill(params, state, req.tokens[None, :],
                            req.prompt_len, slot, req.max_new)[1].item()

        def superstep():
            eng.decode(params, state)[1].cpu()

        window(f"{engine.slots} prefills, {how}", prefills)
        window(f"one decode superstep ({engine.decode_k} steps, "
               f"{engine.slots} slots), {how}", superstep)
    n = engine.model_cfg.n_layers * engine.slots
    print(f"profile: flash_fwd_kernel in the replayed prefills: "
          f"{out[f'{engine.slots} prefills, graphs'][2]} (n_layers x "
          f"prefills = {n})")
    return out


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
    from tpudist_torch.ops.cuda import fused_xent as fx

    # phase 1: device
    card = card_line()
    print(card)
    print(f"device: {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("device: TF32 off for f32 matmuls and cuDNN convolutions")

    # phase 2: build every kernel of the paths from the checkout
    build_all(build, fa, fx)

    # phase 3: kernels vs plain versions, timings
    fwd = check_flash(torch, fa, F)
    bwd = time_flash_bwd(torch, fa, F, check_flash_bwd(torch, fa))
    xent = time_fused_xent(torch, fx, F, check_fused_xent(torch, fx))

    # phases 4-6 and 8-9: the serving paths and the training paths at
    # full width, each with the launch counts set to 0 just before
    paths = {}
    engine, params, base, paths["serve"] = serve_slice(torch, fa, fx,
                                                       args.profile)
    # phase 4b: overload on the same graph engine
    paths["serve_overload"] = serve_overload(torch, engine, params, base)
    del engine, params
    torch.cuda.empty_cache()
    for tag, seq, epochs, kw in (
            ("train_seq2048", 2048, 2, {}),
            ("train_seq512", 512, 1, {}),
            # phase 8: the fused head at the slice's shape
            ("train_seq2048_fused", 2048, 1,
             dict(extra=("--lm-head", "fused"), want_head="fused")),
            # phase 9: bf16, bf16 Adam nu, the auto policy picking the
            # fused head under a device memory pinned at 3 GB (the state
            # alone is 2.15 GB there)
            ("train_seq512_bf16_auto", 512, 1,
             dict(extra=("--dtype", "bfloat16", "--lm-head", "auto",
                         "--adam-nu-dtype", "bfloat16"),
                  hbm_bytes=3e9, want_head="fused"))):
        paths[tag] = train_slice(torch, fa, fx, tag, seq, epochs=epochs,
                                 n_samples=32, **kw)

    # phase 7: one full-width training step, kernels vs plain versions
    for seq, fused in ((512, False), (2048, False), (2048, True)):
        step_check(torch, fa, fx, seq, fused)

    # phase 10: data parallelism, the CLI at one process a card (NCCL),
    # then the reduce across two ranks on one card (gloo)
    torch.cuda.empty_cache()
    paths["train_seq512_dp"] = dp_train_slice(torch, fa, card)
    dp_reduce_check(torch, card)

    # phase 11: the superstep on CUDA graphs: (a) phase 9's configuration
    # per-step and as the superstep under a streaming staging budget,
    # (b) the MLP default, (c) phase 10a's spawn with the all-reduce
    # captured
    torch.cuda.empty_cache()
    sup_paths, obs_on, obs_argv, obs_env = superstep_slice(torch, fa, fx,
                                                           card)
    paths.update(sup_paths)
    superstep_mlp(torch, fa, fx, card)
    paths["train_seq512_dp_superstep"] = dp_train_slice(
        torch, fa, card, tag="train_seq512_dp_superstep", n_samples=80,
        dispatch=("--log-every", "4", "--steps-per-dispatch", "4"),
        want_graphs=(2, {"superstep": 1, "step": 2}))

    # phase 12: the autotuner on the card: (a) the MLP default and the
    # capture OOM drill, (b) remat against no remat replayed, then the
    # full-width search with remat and accumulation in captured probes
    torch.cuda.empty_cache()
    tuner_mlp(torch, fa, fx, card)
    remat_check(torch, card)
    paths[TUNE_PATH] = tuner_full_width(torch, fa, fx, card)

    # phase 13: the observability every default run writes: (a) phase
    # 11a's default run's artifacts, then its configuration off and on
    # again; (b) phase 4's serving configuration through the serve CLI,
    # traced and not; (c) the stall watchdog during graph replays
    torch.cuda.empty_cache()
    paths.update(obs_train(torch, fa, fx, card, obs_on, obs_argv, obs_env))
    paths.update(obs_serve(torch, fa, fx, card))
    stall_drill(torch, card)
    if args.profile:
        for seq, head, dt in ((2048, "plain", "float32"),
                              (2048, "fused", "float32"),
                              (512, "plain", "float32"),
                              (512, "fused", "bfloat16")):
            profile_train(torch, seq, head, dt)
        profile_superstep(torch, "mlp", [], 25)
        profile_superstep(
            torch, "seq 512 bf16 fused", [
                "--model", "transformer", "--seq-len", "512",
                "--train-batch-size", "8", "--n-samples", "80",
                "--dtype", "bfloat16", "--adam-nu-dtype", "bfloat16",
                "--lm-head", "fused"], 4)
        mma_peaks(torch, build)

    reaches = {"flash_attention_fwd": tuple(paths),
               "flash_attention_bwd_dq": ("train_seq2048",
                                          "train_seq2048_fused"),
               "flash_attention_bwd_dkv": ("train_seq2048",
                                           "train_seq2048_fused"),
               "flash_attention_bwd_dqkv": ("train_seq512",
                                            "train_seq512_bf16_auto",
                                            "train_seq512_dp", *SUPERSTEP,
                                            TUNE_PATH, *OBS_PATHS),
               "fused_xent_fwd": ("train_seq2048_fused",
                                  "train_seq512_bf16_auto",
                                  "train_seq512_dp", *SUPERSTEP,
                                  TUNE_PATH, *OBS_PATHS),
               "fused_xent_bwd": ("train_seq2048_fused",
                                  "train_seq512_bf16_auto",
                                  "train_seq512_dp", *SUPERSTEP,
                                  TUNE_PATH, *OBS_PATHS)}
    records = [fwd] + bwd + xent
    for rec in records:
        by_path = {p: paths[p].get(rec["name"], 0) for p in paths}
        rec["launches_by_path"] = by_path
        rec["launches"] = sum(by_path.values())
        missing = [p for p in reaches[rec["name"]] if by_path[p] < 1]
        if missing:
            fail(f"{rec['name']} launched no time on {missing}")

    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
