"""On-card self-check: hardware truth as an acceptance gate.

Counterpart of ``tpudist/selfcheck.py``. The launcher
(``launcher/slurm_gpu.sbatch``) runs it on every task before training: a
hand-written kernel that builds or computes wrong on the card (a layout,
a tile edge, a dtype path the CPU lane never runs, since on the CPU every
wrapper runs its plain version) turns the job's verdict ``fail`` before
training starts. It runs the same 17 checks as the JAX module, in the
same order, at the same shapes and tolerances, with no pytest (the
workload image carries none), and prints one line a check:

    PASS <name> (<seconds>s)         or      FAIL <name> + the traceback

then, on the card, ``selfcheck: launches {...}`` (the six kernels'
launches the checks made, by kernel name) and ``selfcheck: n/m passed``;
it exits 1 if any check failed.

On the card each kernel check calls the wrapper, whose launch counter
must move (no wrapper runs its plain version for a CUDA tensor), and
holds the kernel against the dense PyTorch reference
(``ops/reference.py``, ``ops/blockwise_attention.py``) and against the
kernel's plain version on the same inputs. ``--allow-cpu`` is the
developer's switch: on the CPU the wrappers run their plain versions, so
the kernel checks there hold the plain versions against the references.

Run:  python3 -m tpudist_torch.selfcheck                 (on the card)
      python3 -m tpudist_torch.selfcheck --only check_live
      python3 -m tpudist_torch.selfcheck --allow-cpu     (CPU, for dev)

Off the card (no CUDA device, or ``TPUDIST_PLATFORM=cpu``) without
``--allow-cpu`` it prints ``refusing`` and exits 2 without running a
check; an unknown ``--only`` name exits 2 and lists the checks. Under
the launcher's environment (``TPUDIST_COORDINATOR``,
``TPUDIST_NUM_PROCESSES``, ``TPUDIST_PROCESS_ID``) every rank joins the
group (:func:`tpudist_torch.parallel.distributed.initialize`) and runs
every check on its own card: the model smokes and the staging check are
then data-parallel steps over NCCL; the drills work in per-rank
directories.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import tempfile
import time
import traceback
from typing import Dict, Optional

import numpy as np
import torch

from tpudist_torch.ops.reference import dense_attention as _ref_attn
from tpudist_torch.ops.reference import lm_head_xent as _ref_xent

_DEVICE: Optional[torch.device] = None   # main's device while it runs
# the six kernels' launches the checks of a main run made, by kernel name
LAUNCHES: Dict[str, int] = {}


def _device() -> torch.device:
    """Where the checks run: the rank's card under :func:`main`, else the
    card when there is one, else the CPU."""
    if _DEVICE is not None:
        return _DEVICE
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _on_card() -> bool:
    return _device().type == "cuda"


def _rank_world():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _run_dir(env: str, prefix: str) -> str:
    """A drill's directory: ``$env`` when set (a ``rank<r>`` directory
    under it when several ranks run the checks), else a new temp dir."""
    base = os.environ.get(env)
    if not base:
        return tempfile.mkdtemp(prefix=prefix)
    rank, world = _rank_world()
    if world > 1:
        base = os.path.join(base, f"rank{rank}")
    os.makedirs(base, exist_ok=True)
    return base


@contextlib.contextmanager
def _launching(*kernels: str):
    """Count the kernel launches of the block into :data:`LAUNCHES`; on
    the card, fail unless each of ``kernels`` launched: the check went
    through the wrapper's kernel, not around it."""
    from tpudist_torch import engine
    before = engine.kernel_launch_counts()
    yield
    after = engine.kernel_launch_counts()
    for name in after:
        LAUNCHES[name] = LAUNCHES.get(name, 0) + after[name] - before[name]
    if _on_card():
        idle = [k for k in kernels if after[k] == before[k]]
        assert not idle, f"kernel(s) {idle} launched no time"


def _close(got, want, what: str, *, rtol: float = 0.0,
           atol: float = 0.0) -> None:
    np.testing.assert_allclose(
        np.asarray(torch.as_tensor(got).detach().float().cpu()),
        np.asarray(torch.as_tensor(want).detach().float().cpu()),
        rtol=rtol, atol=atol, err_msg=what)


class _PlainFlash(torch.autograd.Function):
    """(o, lse) of the flash kernels' plain versions, differentiable: the
    forward ``flash_attention_plain``, the backward
    ``flash_attention_bwd_plain``, as the wrapper's Function pairs the
    kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        from tpudist_torch.ops.cuda import flash_attention as fa
        o, lse = fa.flash_attention_plain(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        from tpudist_torch.ops.cuda import flash_attention as fa
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = fa.flash_attention_bwd_plain(
            q, k, v, o, lse, do, dlse, causal=ctx.causal)
        return dq, dk, dv, None


class _PlainXent(torch.autograd.Function):
    """Per-token loss of the fused head's plain versions, differentiable
    (``fused_xent_fwd_plain`` / ``fused_xent_bwd_plain``)."""

    @staticmethod
    def forward(ctx, h, emb, targets):
        from tpudist_torch.ops.cuda import fused_xent as fx
        loss, lse = fx.fused_xent_fwd_plain(h, emb, targets)
        ctx.save_for_backward(h, emb, targets, lse)
        return loss

    @staticmethod
    def backward(ctx, ct):
        from tpudist_torch.ops.cuda import fused_xent as fx
        h, emb, targets, lse = ctx.saved_tensors
        dh, de = fx.fused_xent_bwd_plain(h, emb, targets, lse, ct)
        return dh, de, None


def _plain_xent(h, emb, targets):
    return torch.mean(_PlainXent.apply(h, emb, targets))


def _value_and_grads(fn, *inputs):
    """``fn(*inputs)`` (a scalar) and its grads in ``inputs``."""
    leaves = [x.detach().requires_grad_() for x in inputs]
    out = fn(*leaves)
    return out.detach(), torch.autograd.grad(out, leaves)


def _xent_data(t, d, v, seed=0, dtype=torch.float32):
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn(t, d, generator=gen, device=dev).to(dtype)
    emb = (torch.randn(v, d, generator=gen, device=dev) * 0.02).to(dtype)
    tgt = torch.randint(0, v, (t,), generator=gen, device=dev)
    return h, emb, tgt


def _check_fused_xent_shape(t: int, v: int):
    """One hazard shape of the fused LM-head xent vs the reference and
    the plain version, forward and both grads. The grad atol scales with
    1/t: the mean loss makes dh entries O(1/t), so a fixed atol goes
    vacuous at large t; large entries stay pinned by rtol either way."""
    from tpudist_torch.ops.cuda import fused_xent as fx
    h, emb, tgt = _xent_data(t, 256, v)
    with _launching("fused_xent_fwd", "fused_xent_bwd"):
        got, g_got = _value_and_grads(
            lambda a, b: fx.fused_lm_head_xent(a, b, tgt), h, emb)
    wants = [("reference", _ref_xent)]
    if _on_card():
        wants.append(("plain", _plain_xent))
    for name, fn in wants:
        want, g_want = _value_and_grads(lambda a, b: fn(a, b, tgt), h, emb)
        _close(got, want, f"fwd t={t} v={v} vs {name}", rtol=1e-4)
        for a, b, which in zip(g_got, g_want, ("dh", "dE")):
            _close(a, b, f"{which} t={t} v={v} vs {name}", rtol=1e-3,
                   atol=5e-3 / t)


def check_fused_xent():
    """Fused LM-head xent vs the reference at the JAX check's hazard
    shapes: aligned, a token remainder, a vocab remainder, and t=20000
    (on the card: several backward token chunks and a partial last
    one)."""
    for t, v in ((512, 4096), (400, 4096), (512, 5000), (20000, 4096)):
        _check_fused_xent_shape(t, v)


def check_fused_xent_bench_geometry():
    """The bench geometry (d 2048, vocab 32000, bf16): the loss within
    5e-2 of the reference and of the plain version, finite grads, and on
    the card the grads within 5e-2 of the plain version's (max |d| / max
    |plain|, chip_smoke's bf16 hold)."""
    from tpudist_torch.ops.cuda import fused_xent as fx
    h, emb, tgt = _xent_data(1024, 2048, 32000, dtype=torch.bfloat16)
    with _launching("fused_xent_fwd", "fused_xent_bwd"):
        loss, (gh, ge) = _value_and_grads(
            lambda a, b: fx.fused_lm_head_xent(a, b, tgt), h, emb)
    _close(loss, _ref_xent(h, emb, tgt), "fwd vs reference", rtol=5e-2)
    assert bool(torch.isfinite(gh.float()).all()), "dh not finite"
    assert bool(torch.isfinite(ge.float()).all()), "dE not finite"
    if _on_card():
        want, g_want = _value_and_grads(
            lambda a, b: _plain_xent(a, b, tgt), h, emb)
        _close(loss, want, "fwd vs plain", rtol=5e-2)
        for a, b, which in zip((gh, ge), g_want, ("dh", "dE")):
            err = ((a.float() - b.float()).abs().max()
                   / b.float().abs().max()).item()
            assert err <= 5e-2, f"{which} vs plain: {err:.3e} > 5e-2"


def _attention_data(b, s, h, kv, hd, seed, dtype, device=None):
    """q (b, s, h, hd), k/v (b, s, kv, hd) and a cotangent like q, from a
    seeded generator on ``device``."""
    dev = device or _device()
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(b, s, n, hd, device=dev, generator=gen)
                 .to(dtype) for n in (h, kv, kv, h))


def _check_attention(kernel, reference, q, k, v, ct, kernels):
    """``kernel`` (the wrapper) against ``reference`` and, on the card,
    the plain version: the forward atol 3e-2 and the three grads of
    <o, ct> atol 0.5 (bf16 operands, values O(30): elementwise ULP-scale
    differences)."""

    def vdot(fn):
        return lambda a, b_, c: (fn(a, b_, c).float() * ct.float()).sum()

    with _launching(*kernels):
        got = kernel(q, k, v)
        _, g_got = _value_and_grads(vdot(kernel), q, k, v)
    wants = [("reference", reference)]
    if _on_card():
        wants.append(("plain", lambda a, b_, c: _PlainFlash.apply(
            a, b_, c, True)[0]))
    for name, fn in wants:
        with torch.no_grad():
            want = fn(q, k, v)
        _close(got, want, f"o vs {name}", atol=3e-2)
        _, g_want = _value_and_grads(vdot(fn), q, k, v)
        for g, w, which in zip(g_got, g_want, "qkv"):
            _close(g, w, f"d{which} vs {name}", atol=0.5)


def _check_flash(kv: int):
    """Flash attention vs dense attention at the bench head geometry,
    bf16, causal (b4 s512 h8 hd128: the merged backward); kv=2 covers
    the grouped-query group sum on the card."""
    from tpudist_torch.ops.cuda import flash_attention as fa
    q, k, v, ct = _attention_data(4, 512, 8, kv, 128, 0, torch.bfloat16)
    _check_attention(fa.flash_attention, _ref_attn, q, k, v, ct,
                     ("flash_attention_fwd", "flash_attention_bwd_dqkv"))


def check_flash_attention():
    _check_flash(kv=8)


def check_flash_attention_gqa():
    _check_flash(kv=2)


def _check_flash_long(kv: int):
    """The multi-block schedule (seq 2048: the online-softmax rescale
    over kv tiles, causal tile skipping, and the split dq and dk/dv
    backward kernels), kv < h adding the group sum under it; against the
    port's blockwise attention."""
    from tpudist_torch.ops.blockwise_attention import \
        blockwise_causal_attention
    from tpudist_torch.ops.cuda import flash_attention as fa
    q, k, v, ct = _attention_data(1, 2048, 4, kv, 128, 1, torch.bfloat16)
    _check_attention(fa.flash_attention, blockwise_causal_attention,
                     q, k, v, ct, ("flash_attention_fwd",
                                   "flash_attention_bwd_dq",
                                   "flash_attention_bwd_dkv"))


def check_flash_attention_long_context():
    _check_flash_long(kv=4)


def check_flash_attention_gqa_long_context():
    _check_flash_long(kv=2)


RING_MERGE_SHAPE = (2, 1024, 4, 2, 128)   # b, s, h, kv, hd


def ring_merge_inputs(dtype, device, seed: int = 25):
    """The ring-merge check's q, k, v and cotangent (``chip_smoke.py``
    phase 25a holds the same inputs)."""
    b, s, h, kv, hd = RING_MERGE_SHAPE
    return _attention_data(b, s, h, kv, hd, seed, dtype, device)


def ring_merge_pair(attn, q, k, v):
    """(merged, whole) f32 outputs: two disjoint-kv calls of ``attn``
    (``(q, k, v) -> (o, lse)``, unmasked) merged by ``merge_partials``,
    and one whole-kv call: the ring's per-hop operation, minus the
    rotation."""
    from tpudist_torch.ops import ring_attention as ring
    c = k.shape[1] // 2
    o1, l1 = attn(q, k[:, :c].contiguous(), v[:, :c].contiguous())
    o2, l2 = attn(q, k[:, c:].contiguous(), v[:, c:].contiguous())
    merged, _ = ring.merge_partials(o1.float(), l1, o2.float(), l2)
    return merged, attn(q, k, v)[0].float()


def check_ring_flash_merge():
    """The ring-attention hop merge on the card: two disjoint-kv kernel
    calls merged with ``merge_partials`` (lse = logaddexp, o = sum of
    exp(lse_i - lse) o_i) must equal one whole-kv kernel call, forward
    and grads (the lse cotangent folding into the backward's delta), at
    b2 s1024 h4 kv2 in bf16; on the card the merged kernels also against
    the merged plain versions."""
    from tpudist_torch.ops.cuda import flash_attention as fa
    q, k, v, ct = ring_merge_inputs(torch.bfloat16, _device())

    def kernel(a, b_, c):
        return fa.flash_attention_with_lse(a, b_, c, causal=False)

    def plain(a, b_, c):
        return _PlainFlash.apply(a, b_, c, False)

    def pick(attn, which):
        return lambda a, b_, c: ring_merge_pair(attn, a, b_, c)[which]

    def vdot(fn):
        return lambda a, b_, c: (fn(a, b_, c) * ct.float()).sum()

    with _launching("flash_attention_fwd", "flash_attention_bwd_dq",
                    "flash_attention_bwd_dkv"):
        with torch.no_grad():
            got, whole = ring_merge_pair(kernel, q, k, v)
        _, g_got = _value_and_grads(vdot(pick(kernel, 0)), q, k, v)
        _, g_whole = _value_and_grads(vdot(pick(kernel, 1)), q, k, v)
    holds = [("one whole-kv call", whole, g_whole)]
    if _on_card():
        with torch.no_grad():
            want = ring_merge_pair(plain, q, k, v)[0]
        _, g_want = _value_and_grads(vdot(pick(plain, 0)), q, k, v)
        holds.append(("the merged plain versions", want, g_want))
    for name, want, g_want in holds:
        _close(got, want, f"merged o vs {name}", atol=3e-2)
        for g, w, which in zip(g_got, g_want, "qkv"):
            _close(g, w, f"merged d{which} vs {name}", atol=0.5)


def _batch_rows(x: np.ndarray):
    """This rank's contiguous rows of a global batch, on its device."""
    rank, world = _rank_world()
    local = x.shape[0] // world
    rows = x[rank * local:(rank + 1) * local]
    return torch.from_numpy(np.ascontiguousarray(rows)).to(
        _device(), torch.int64 if rows.dtype.kind == "i" else None)


def _train_smoke(model_kw):
    """Two bf16 steps of a tiny model: losses finite and falling. The
    batch scales with the ranks, so under the launcher this is a real
    all-card data-parallel step."""
    from tpudist_torch import data as tdata
    from tpudist_torch import engine
    from tpudist_torch.config import (DataConfig, ModelConfig,
                                      ParallelConfig, TrainConfig)
    batch = max(8, _rank_world()[1])
    cfg = TrainConfig(
        batch_size=batch, lr=1e-3, seed=0, dtype="bfloat16",
        data=DataConfig(n_samples=batch), model=ModelConfig(**model_kw),
        parallel=ParallelConfig(data=-1))
    dev = _device()
    state = engine.init_state(cfg, dev)
    step = engine.make_train_step(cfg, dev)
    toks = (_batch_rows(tdata.make_synthetic_tokens(batch, 65, 512,
                                                    seed=0)),)
    state, l0 = step(state, toks)
    state, l1 = step(state, toks)
    l0, l1 = float(l0), float(l1)
    assert np.isfinite(l0) and np.isfinite(l1), f"loss not finite: {l0} {l1}"
    assert l1 < l0, f"loss did not decrease: {l0} -> {l1}"


def check_staging_stream():
    """The streaming input pipeline on the card: a tiny-MLP epoch (10
    steps) run as k=4 supersteps through double-buffered slab staging
    (a budget of 3 slabs and a padded partial last window) must give the
    same per-step losses and epoch total, bitwise, as full-epoch
    staging, each run on its two captured programs on the card (the k-step
    graph and the one-step graph of partial windows; none on the CPU); it
    reports the staged-bytes peak and the overlap fraction as the train
    CLI's ``tpudist: staging ...`` line does."""
    from tpudist_torch import data as tdata
    from tpudist_torch import engine, verdict
    from tpudist_torch.config import DataConfig, ParallelConfig, TrainConfig
    from tpudist_torch.metrics import StagingStats
    from tpudist_torch.parallel import staging

    rank, world = _rank_world()
    dev = _device()
    batch = max(8, world)
    n_steps, k = 10, 4
    cfg = TrainConfig(batch_size=batch, lr=1e-3, seed=0,
                      data=DataConfig(n_samples=n_steps * batch),
                      parallel=ParallelConfig(data=-1))
    plan = tdata.plan_epoch(
        tdata.make_synthetic_data(n_steps * batch, cfg.data.n_features,
                                  cfg.data.seed),
        batch_size=batch, seed=cfg.seed, epoch=0, process_index=rank,
        process_count=world)
    step_bytes = staging.step_bytes(plan.arrays, plan.local_batch)
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def run(budget, stats):
        splan = staging.plan_slabs(n_steps, k, step_bytes, budget)
        state = engine.init_state(cfg, dev)
        superstep = engine.make_superstep(cfg, dev, k)
        total = torch.zeros((), dtype=torch.float32, device=dev)
        losses = []
        S = splan.slab_steps
        stats.streamed = splan.streamed

        def stage(s):
            t0 = time.perf_counter()
            start, stop = s * S, min(n_steps, s * S + S)
            pad_to = -(-(stop - start) // k) * k
            slab = staging.put_slab(plan.slab(start, stop, pad_to=pad_to),
                                    dev, stream)
            stats.note_staged(pad_to * step_bytes, time.perf_counter() - t0)
            return slab, pad_to * step_bytes

        try:
            nxt = stage(0)
            for s in range(splan.n_slabs):
                cur, cur_bytes = nxt
                if s + 1 < splan.n_slabs:
                    nxt = stage(s + 1)
                if s > 0:
                    stats.note_wait(cur)
                arrays = cur.arrays_for()
                base = s * S
                for j in range(arrays[0].shape[0] // k):
                    gstart = base + j * k
                    if gstart >= n_steps:
                        break
                    hi = min(n_steps - gstart, k)
                    window = tuple(a[j * k:(j + 1) * k] for a in arrays)
                    state, total, ls = superstep(state, total, window, 0,
                                                 hi)
                    # the superstep's own buffer: read before the next call
                    losses.extend(ls[:hi].tolist())
                stats.note_released(cur_bytes)
                cur = arrays = window = None
            want = 2 if dev.type == "cuda" else 0
            assert superstep.programs == want, \
                f"superstep captured {superstep.programs} programs, " \
                f"want {want}"
            return np.asarray(losses), float(total)
        finally:
            # a graph holding captured NCCL work must go before the group
            superstep.release()

    t0 = time.perf_counter()
    stream_stats = StagingStats()
    got = run(2 * k * step_bytes, stream_stats)        # 3 slabs, padded tail
    run_s = time.perf_counter() - t0
    want = run(None, StagingStats())                   # full-epoch fast path
    assert stream_stats.slabs == 3, f"{stream_stats.slabs} slabs, want 3"
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1], (got[1], want[1])
    overlap = stream_stats.overlap_fraction(run_s)
    status = verdict.staging_status(stream_stats.streamed, overlap)
    print(f"  staging: {status}, peak {stream_stats.peak_bytes} B staged "
          f"over {stream_stats.slabs} slabs, overlap "
          f"{overlap if overlap is None else round(overlap, 3)}",
          flush=True)


# check_autotune's scripted harness: the JAX check's numbers
# (tpudist/selfcheck.py check_autotune; tests/test_torch_selfcheck.py
# pins them to it)
AUTOTUNE_START = dict(k=8, staging_budget_mb=None, remat=False,
                      grad_accum_steps=1)
AUTOTUNE_AXES = {"k": [1, 2, 4, 8, 16, 32], "staging_budget_mb": [None],
                 "remat": [False], "grad_accum_steps": [1]}
AUTOTUNE_CURVE = {1: 100.0, 2: 180.0, 4: 300.0, 8: 500.0, 16: 640.0}
AUTOTUNE_WALL_K = 32            # the point over the scripted memory wall
AUTOTUNE_SEED_SPS = 500.0       # (b): the seed heuristic's steps/s ...
AUTOTUNE_OTHER_SPS = 200.0      # ... and every other point's
AUTOTUNE_BUDGET = 16


def check_autotune():
    """The autotune search contract on a scripted probe harness (fake
    timers, no device work, so the drill runs the same on every
    backend): (a) an infeasible point over the memory wall is pruned and
    the best feasible point committed; (b) when every explored point
    measures slower than the seed heuristic, the commit is the seed; (c)
    a probe that raises is a pruned point, not a dead search."""
    from tpudist_torch.tune import probe, search

    start = search.Candidate(**AUTOTUNE_START)
    axes = AUTOTUNE_AXES

    def scripted(sps_by_k, infeasible_ks=()):
        def measure(cand):
            if cand.k in infeasible_ks:
                return probe.ProbeResult(
                    0.0, float("inf"), 8, 1, feasible=False,
                    error="out of memory (scripted wall)")
            return probe.ProbeResult(sps_by_k[cand.k],
                                     1000.0 / sps_by_k[cand.k], 8, 1)
        return measure

    # (a) the fastest point on the curve is over the scripted wall: prune
    # it, commit the best feasible point
    out = search.coordinate_search(
        start, axes, scripted(AUTOTUNE_CURVE,
                              infeasible_ks=(AUTOTUNE_WALL_K,)),
        trial_budget=AUTOTUNE_BUDGET)
    assert out.best.k == 16, f"expected k=16 commit, got {out.best}"
    assert out.pruned == 1, f"infeasible point not pruned: {out.pruned}"
    assert out.best_sps >= out.baseline_sps
    assert out.trials <= AUTOTUNE_BUDGET

    # (b) every alternative regresses the seed heuristic: commit the seed
    flat = {k: (AUTOTUNE_SEED_SPS if k == start.k else AUTOTUNE_OTHER_SPS)
            for k in axes["k"]}
    out2 = search.coordinate_search(start, axes, scripted(flat),
                                    trial_budget=AUTOTUNE_BUDGET)
    assert out2.best == start, f"regressing commit: {out2.best}"
    assert out2.best_sps == out2.baseline_sps == AUTOTUNE_SEED_SPS

    # (c) a measure() that raises is a pruned point
    def exploding(cand):
        if cand.k == AUTOTUNE_WALL_K:
            raise RuntimeError("scripted probe crash")
        sps = AUTOTUNE_CURVE[cand.k]
        return probe.ProbeResult(sps, 1000.0 / sps, 8, 1)
    out3 = search.coordinate_search(start, axes, exploding,
                                    trial_budget=AUTOTUNE_BUDGET)
    assert out3.best.k == 16 and out3.pruned == 1, out3
    print(f"  autotune drill: memory-wall commit k={out.best.k} "
          f"({out.trials} trials, {out.pruned} pruned), "
          f"regression floor held at k={out2.best.k}", flush=True)


# check_devtime's scripted track (times in µs): the JAX check's
# intervals and answers under the port's op names, one of each kind the
# port's classify tells apart (tests/test_torch_selfcheck.py pins the
# numbers to the JAX check and each name's kind to the JAX name's)
DEVTIME_OPS = [(0.0, 10.0, "ampere_sgemm_128x64_nn"),
               (20.0, 30.0, "flash_fwd_kernel"),
               (5.0, 12.0, "ncclDevKernel_AllReduce_Sum_f32_RING_LL"),
               (12.0, 14.0, "ncclDevKernel_AllGather_RING_LL"),
               (25.0, 30.0, "ncclKernel_AllReduce_RING_LL_Sum_float"),
               (40.0, 45.0, "ncclDevKernel_SendRecv")]
DEVTIME_WANT_US = {"exposed_comm_s": 9.0, "compute_s": 20.0,
                   "comm_s": 19.0, "idle_s": 16.0}
DEVTIME_STRICT_GATE = 0.10


def check_devtime():
    """The device-time attribution math on a scripted trace fixture (pure
    interval arithmetic, no device work): known compute/comm intervals
    give the exact exposed-communication answer through every overlap
    edge case (comm nested inside compute, back-to-back comm windows
    whose union partly escapes compute, a lone comm burst with no
    compute) and the compute/exposed/idle fractions decompose the window
    exactly."""
    from tpudist_torch.obs import devtime

    # classification: the names the card's trace carries
    assert devtime.classify("ampere_sgemm_128x64_nn") == "compute"
    assert devtime.classify("ncclDevKernel_AllReduce_Sum_f32_RING_LL") \
        == "comm"
    assert devtime.classify("ncclKernel_AllGather_RING_LL") == "comm"
    assert devtime.classify("c10d::allreduce_") == "comm"
    assert devtime.classify("") is None

    #   compute  [0,10] [20,30]
    #   comm     [5,12]+[12,14] back-to-back -> exposed [10,14] = 4
    #            [25,30] nested in compute    -> fully hidden, 0
    #            [40,45] no compute anywhere  -> fully exposed, 5
    out = devtime.attribute_tracks({"dev0": DEVTIME_OPS})
    d = out["devices"]["dev0"]
    for key, want in DEVTIME_WANT_US.items():
        assert abs(d[key] * 1e6 - want) < 1e-9, (key, d)
    s = d["compute_frac"] + d["exposed_comm_frac"] + d["idle_frac"]
    assert abs(s - 1.0) < 1e-9, s
    # 9/45 = 20% exposed clears the default 25% gate but not a 10% one;
    # no measurement is ungateable, not a pass
    assert devtime.comm_status(d["exposed_comm_frac"]) == "success"
    assert devtime.comm_status(d["exposed_comm_frac"],
                               DEVTIME_STRICT_GATE) == "fail"
    assert devtime.comm_status(None) == "ungateable"
    print(f"  devtime drill: exposed {d['exposed_comm_s'] * 1e6:.0f} µs "
          f"of {d['comm_s'] * 1e6:.0f} µs comm "
          f"({100 * d['exposed_comm_frac']:.1f}% of the window)",
          flush=True)


def check_elastic():
    """The preemption-survival contract on a scripted drill (files and
    the sharded checkpointer, no collective): (a) a sharded-manifest save
    commits atomically and restores bitwise onto a fresh state; (b) a
    scripted kill between the shard write and the commit leaves the
    previous manifest authoritative, never a torn checkpoint, and the
    orphaned step directory is reaped on the next open; (c) the requeue
    policy classifies preemption and stall as requeue-able and a
    deterministic crash as stop.

    The JAX check also restores onto half of a host's devices (the N->M
    reshard) where the host has more than one. Here one process drives
    one card, so a rank has one device and skips it, as the JAX check
    does on a one-chip host; ``tests/test_torch_fsdp_ckpt.py`` holds the
    reshard across ranks."""
    from tpudist_torch import engine
    from tpudist_torch.config import DataConfig, TrainConfig
    from tpudist_torch.elastic import ckpt as eck
    from tpudist_torch.elastic import policy
    from tpudist_torch.elastic import resume as eres

    dev = _device()
    cfg = TrainConfig(batch_size=32, data=DataConfig(n_samples=64))
    state = engine.init_state(cfg, dev)
    d = tempfile.mkdtemp(prefix="tpudist_elastic_")

    def assert_bitwise(a, b):
        la, lb = eck.state_leaves(a), eck.state_leaves(b)
        assert [n for n, _ in la] == [n for n, _ in lb]
        for (name, x), (_, y) in zip(la, lb):
            assert x.dtype == y.dtype and torch.equal(x, y), name

    # (a) commit + bitwise restore onto a differently seeded state
    ck = eck.ShardedCheckpointer(d, use_async=False, run_meta={"seed": 0})
    ck.save(state, epoch=1, step_in_epoch=4)
    ck.close()
    man = eck.latest_manifest(d)
    assert man is not None and (man["epoch"], man["step_in_epoch"]) == \
        (1, 4), man
    fresh = engine.init_state(dataclasses.replace(cfg, seed=7), dev)
    got, e, s = eres.restore(d, fresh, run_meta={"seed": 0})
    assert (e, s) == (1, 4)
    assert_bitwise(state, got)

    # (b) kill between the shard write and the commit
    class _KilledBeforeCommit(eck.ShardedCheckpointer):
        def _commit(self, *a, **kw):
            pass                         # the scripted kill point

    state2 = engine.init_state(dataclasses.replace(cfg, seed=1), dev)
    state2.step += 100
    torn = _KilledBeforeCommit(d, use_async=False, run_meta={"seed": 0})
    torn.save(state2, epoch=9, step_in_epoch=0)
    torn.close()
    man2 = eck.latest_manifest(d)
    assert int(man2["step"]) == int(man["step"]), \
        "uncommitted shards must not move the manifest"
    orphan = eck.step_dir(eck.elastic_root(d), 100)
    assert os.path.isdir(orphan), "drill setup: orphan dir should exist"
    removed = eck.cleanup_stale(d)
    assert orphan in removed and not os.path.isdir(orphan), \
        "stale uncommitted step dir must be reaped on the next open"
    fresh = engine.init_state(dataclasses.replace(cfg, seed=7), dev)
    got3, e3, s3 = eres.restore(d, fresh, run_meta={"seed": 0})
    assert (e3, s3) == (1, 4), "restore must still read the committed step"
    assert_bitwise(state, got3)

    # (c) the requeue policy: signal deaths and stalls requeue (with
    # exponential backoff), deterministic crashes stop
    assert policy.decide(137, attempt=0, max_requeues=3).requeue
    assert policy.decide(124, attempt=1, max_requeues=3).backoff_s == 20.0
    assert not policy.decide(1, attempt=0, max_requeues=3).requeue
    assert not policy.decide(137, attempt=3, max_requeues=3).requeue
    print(f"  elastic drill: manifest step {man['step']} survived a "
          f"kill-before-commit, restored bitwise on {dev}, policy "
          f"verdicts held", flush=True)


# the drills' families (scenarios) run this many at a time: each is a few
# CLI processes one after another, bound by their start-up
DRILL_LANES = 4


@contextlib.contextmanager
def _attempts_on_cpu():
    """``TPUDIST_PLATFORM=cpu`` for the drills' attempt processes, which
    take the platform from the environment, and one CPU thread each
    unless ``OMP_NUM_THREADS`` says otherwise (:data:`DRILL_LANES` of
    them run side by side)."""
    saved = {k: os.environ.get(k)
             for k in ("TPUDIST_PLATFORM", "OMP_NUM_THREADS")}
    os.environ["TPUDIST_PLATFORM"] = "cpu"
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def check_chaos():
    """The seeded fault matrix end to end (``tpudist_torch.chaos``): the
    train CLI driven in subprocesses under each of the seven fault
    families (hard kill, a hang the watchdog trips, a slow host,
    checkpoint-shard corruption, a torn manifest, transient filesystem
    errors, garbage on the live telemetry stream), replaying the
    launcher's loop (fault, the standard-library policy's class,
    backoff, ``--resume auto``), and the verifier replays the artifacts:
    every fault classified right, resume from the newest committed step
    (bitwise against the unfaulted baseline by shard crc32), the goodput
    partition exact, every fail verdict with its mid-run alert. It is
    ``chaos.verify.run_and_verify``'s sequence (``run_matrix``, then
    ``verify_matrix``) with :data:`DRILL_LANES` families at a time.

    The attempts run on the CPU, named explicitly through their
    ``TPUDIST_PLATFORM=cpu``, as the JAX check runs its attempts on a CPU
    mesh: this check holds the host machinery (policy, resume, goodput,
    alerts). ``chip_smoke.py`` phase 17 runs the same matrix with every
    attempt on the card. Writes into ``$TPUDIST_CHAOS_DRILL_DIR`` (a
    ``rank<r>`` directory under it when several ranks run) when set,
    else a temp dir."""
    from tpudist_torch.chaos import drill as chaos_drill
    from tpudist_torch.chaos import verify as chaos_verify

    run_dir = _run_dir("TPUDIST_CHAOS_DRILL_DIR", "tpudist_chaos_")
    with _attempts_on_cpu():
        results = chaos_drill.run_matrix(run_dir, lanes=DRILL_LANES)
    report = chaos_verify.verify_matrix(run_dir, results)
    bad = {name: fam["problems"]
           for name, fam in report["families"].items() if not fam["ok"]}
    assert not bad, f"chaos invariants violated: {bad}"
    assert len(report["families"]) == len(chaos_drill.FAMILIES)
    print(f"  chaos matrix: {len(report['families'])} fault families "
          f"green (policy/resume/goodput/alert invariants held; "
          f"report in {run_dir})", flush=True)


def check_serve_resilience():
    """The serve resilience plane end to end (``tpudist_torch.serve.
    drill``): the serve CLI driven in subprocesses under scripted 2x
    overload and the serve-side fault families: bounded-queue shedding
    and deadline expiry with the arrival partition exact, a
    ``serve_kill`` classified by the policy and resumed with the dead
    attempt's in-flight requests counted lost, seeded malformed requests
    rejected at admission, a per-dispatch stall visible in the ITL, and
    the pressure ladder downshifting without a recompile; the virtual
    clock makes two same-seed runs bitwise equal, and the verifier
    replays every invariant from the artifacts. It is
    ``serve.drill.run_and_verify``'s sequence with :data:`DRILL_LANES`
    scenarios at a time.

    The attempts run on the CPU, named explicitly through their
    ``TPUDIST_PLATFORM=cpu``, as the JAX check runs its attempts on a CPU
    mesh: this check holds the host machinery (policy, resume, the shed
    partition). ``chip_smoke.py`` phase 16 runs the same matrix with
    every attempt on the card. Writes into ``$TPUDIST_SERVE_DRILL_DIR``
    (a ``rank<r>`` directory under it when several ranks run) when set,
    else a temp dir."""
    from tpudist_torch.serve import drill as serve_drill

    run_dir = _run_dir("TPUDIST_SERVE_DRILL_DIR", "tpudist_serve_drill_")
    with _attempts_on_cpu():
        results = serve_drill.run_matrix(run_dir, lanes=DRILL_LANES)
    report = serve_drill.verify_matrix(run_dir, results)
    bad = {name: sc["problems"]
           for name, sc in report["scenarios"].items() if not sc["ok"]}
    assert not bad, f"serve resilience invariants violated: {bad}"
    assert len(report["scenarios"]) == len(serve_drill.SCENARIOS)
    print(f"  serve resilience: {len(report['scenarios'])} scenarios "
          f"green (shed partition exact, TTFT bounded under 2x "
          f"overload, kill->requeue->resume honest, report in "
          f"{run_dir})", flush=True)


def check_flight_recorder():
    """The flight-recorder pipeline end to end with a deliberately wedged
    step: progress beacons flow while steps advance, then the step
    blocks past the stall window (the one-process stand-in for a worker
    stuck in a collective) and the watchdog must dump a flight record
    (the threads' stacks with the wedged frame, the cards' memory stats,
    the last progress and metrics) before an outer timeout would kill the
    job. Writes into ``$TPUDIST_OBS_DIR`` (``rank<r>`` under it when
    several ranks run) when set, else a temp dir."""

    from tpudist_torch.metrics import MetricsLogger
    from tpudist_torch.obs import FlightRecorder

    out_dir = _run_dir("TPUDIST_OBS_DIR", "tpudist_obs_")
    stall_s = 0.5
    if _on_card():
        # the card's allocator initialised, as a training run's is
        torch.zeros(1, device=_device())
    metrics = MetricsLogger(path=os.path.join(out_dir, "metrics.jsonl"),
                            all_ranks=True)
    rec = FlightRecorder(out_dir, stall_timeout_s=stall_s,
                         process_index=_rank_world()[0], metrics=metrics)
    try:
        for step in range(3):            # healthy steps: beacon advances
            rec.note_progress(phase="train", epoch=0, step=step)
            metrics.log(kind="step", step=step, loss=1.0 / (step + 1))
            time.sleep(0.05)
        assert rec.dumps == 0, "watchdog fired on a healthy run"

        def wedged_step():               # the hang: no progress notes
            deadline = time.monotonic() + 20 * stall_s
            while rec.dumps == 0 and time.monotonic() < deadline:
                time.sleep(0.05)
        wedged_step()
        assert rec.dumps >= 1, "watchdog never fired on the wedged step"
        # the stall dump itself must have flushed the buffered metrics,
        # asserted before close(), whose flush would mask a missing one
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            assert len(f.readlines()) >= 3, \
                "stall dump did not flush metrics"
    finally:
        rec.close()
        metrics.close()

    with open(rec.flightrec_path) as f:
        art = json.load(f)
    assert art["reason"] == "stall", art["reason"]
    assert art["progress"]["step"] == 2 and art["progress"]["phase"] == \
        "train", art["progress"]
    assert "wedged_step" in art["thread_stacks"], \
        "stall dump missing the wedged frame"
    assert isinstance(art["memory_stats"], list)
    if _on_card():
        assert art["memory_stats"], "stall dump missing the cards' stats"
    assert art["last_metrics"] and art["last_metrics"][-1]["step"] == 2
    with open(rec.beacon_path) as f:
        beacon = json.load(f)
    assert beacon["step"] == 2
    print(f"  flight record: {rec.flightrec_path} "
          f"({len(art['thread_stacks'])} B of stacks)", flush=True)


def check_live():
    """The live-telemetry stall path end to end over real sockets: a
    worker whose step loop wedges must get its ``stall`` alert onto the
    Prometheus exporter and into ``live_status.json`` before any
    launcher kill (emitter -> TCP ingest -> aggregator -> alert engine
    -> /metrics). Every rank runs its own aggregator on ports of its
    own. Writes into ``$TPUDIST_OBS_DIR`` (``rank<r>`` under it when
    several ranks run) when set, else a temp dir."""
    import urllib.request

    from tpudist_torch.metrics import MetricsLogger
    from tpudist_torch.obs import FlightRecorder
    from tpudist_torch.obs import live as live_mod

    out_dir = _run_dir("TPUDIST_OBS_DIR", "tpudist_live_")
    stall_s = 0.4
    live = live_mod.LiveRun.start(
        is_coordinator=True, process_index=0, out_dir=out_dir,
        run_id="live-drill", stall_timeout_s=stall_s)
    metrics = MetricsLogger(path=os.path.join(out_dir, "metrics.jsonl"),
                            all_ranks=True)
    metrics.emitter = live.emitter
    rec = FlightRecorder(
        out_dir, stall_timeout_s=stall_s, process_index=0,
        metrics=metrics, emitter=live.emitter,
        extra_state=lambda: {"live_status": live.snapshot_fields()})
    try:
        for step in range(3):            # healthy steps: beacons flow
            rec.note_progress(phase="train", epoch=0, step=step)
            metrics.log(kind="step", step=step, loss=1.0 / (step + 1))
            time.sleep(0.05)

        deadline = time.monotonic() + 30 * stall_s   # the wedge
        while rec.dumps == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert rec.dumps >= 1, "watchdog never fired on the wedged step"

        # the firing alert must reach the exporter while the process is
        # alive: a bounded wait for the emitter -> TCP -> aggregator hop
        # and the exporter's next rebuild, scraping over real HTTP
        url = f"http://127.0.0.1:{live.exporter.port}/metrics"
        firing = 'tpudist_alert_firing{alert="stall"} 1'
        deadline = time.monotonic() + 5.0
        while True:
            with urllib.request.urlopen(url, timeout=5) as r:
                text = r.read().decode()
            with open(os.path.join(out_dir, "live_status.json")) as f:
                status = json.load(f)
            if (firing in text and status["status"] == "alert") \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        assert firing in text, "stall alert not scrapeable at /metrics"
        assert status["status"] == "alert", status["status"]
        assert any(a["alert"] == "stall"
                   for a in status["alerts"]["firing"]), status["alerts"]
    finally:
        rec.close()
        live.close()
        metrics.close()

    with open(rec.flightrec_path) as f:
        art = json.load(f)
    assert "live_status" in (art.get("extra") or {}), \
        "pre-kill flight record missing the aggregator's live snapshot"
    print(f"  live drill: stall alert scrapeable at :{live.exporter.port}"
          f"/metrics before the kill; {out_dir}/live_status.json = "
          f"{status['status']}", flush=True)


def check_train_step_smoke():
    """Two bf16 train steps of the tiny transformer: finite, falling."""
    _train_smoke(dict(name="transformer", vocab_size=512, n_layers=2,
                      d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
                      max_seq_len=64))


def check_moe_smoke():
    """The MoE's routing, dispatch and expert FFN train on the card."""
    _train_smoke(dict(name="moe", vocab_size=512, n_layers=2, d_model=128,
                      n_heads=4, n_kv_heads=4, d_ff=128, max_seq_len=64,
                      n_experts=4, expert_top_k=2))


CHECKS = [
    check_autotune,
    check_chaos,
    check_devtime,
    check_elastic,
    check_fused_xent,
    check_fused_xent_bench_geometry,
    check_flash_attention,
    check_flash_attention_gqa,
    check_flash_attention_long_context,
    check_flash_attention_gqa_long_context,
    check_ring_flash_merge,
    check_staging_stream,
    check_flight_recorder,
    check_live,
    check_serve_resilience,
    check_train_step_smoke,
    check_moe_smoke,
]


def _device_for(allow_cpu: bool):
    """``(device, None)`` the checks run on, or ``(None, why)`` they must
    not run: off the card (no CUDA device, or ``TPUDIST_PLATFORM``
    naming the CPU) without ``--allow-cpu``, or a ``TPUDIST_PLATFORM``
    the port does not know."""
    from tpudist_torch.utils.platform import platform_device
    try:
        asked = platform_device()
    except ValueError as e:
        return None, str(e)
    if asked != "cpu" and torch.cuda.is_available():
        return "cuda", None
    if allow_cpu:
        return "cpu", None
    return None, ("TPUDIST_PLATFORM=cpu" if asked == "cpu"
                  else "no CUDA device")


def main(argv=None) -> int:
    global _DEVICE
    argv = list(sys.argv[1:] if argv is None else argv)
    device, why = _device_for("--allow-cpu" in argv)
    if device is None:
        # this lane exists to be hardware truth: running the plain
        # versions on the CPU would pass while a kernel is broken
        print(f"selfcheck: {why}, not the card — refusing (pass "
              f"--allow-cpu to run the kernels' plain versions on the "
              f"CPU, for development)", flush=True)
        return 2
    checks = CHECKS
    if "--only" in argv:
        # one named check; an unknown or missing name is an error, not
        # an empty green run
        idx = argv.index("--only") + 1
        name = argv[idx] if idx < len(argv) else None
        checks = [fn for fn in CHECKS if fn.__name__ == name]
        if not checks:
            print(f"selfcheck: no check named {name!r} "
                  f"(have: {', '.join(fn.__name__ for fn in CHECKS)})",
                  flush=True)
            return 2
    from tpudist_torch.parallel import distributed
    # f32 means f32 on the card: the references' matmuls off TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # under the launcher every task runs this on its own card and the
    # model smokes are data-parallel over the group; one process alone
    # when the env contract is unset
    ctx = distributed.initialize(device=device)
    _DEVICE = ctx.device
    LAUNCHES.clear()
    failed = 0
    try:
        for fn in checks:
            t0 = time.perf_counter()
            try:
                fn()
                print(f"PASS {fn.__name__} "
                      f"({time.perf_counter() - t0:.1f}s)", flush=True)
            except Exception:
                failed += 1
                print(f"FAIL {fn.__name__}", flush=True)
                traceback.print_exc()
                sys.stdout.flush()
        if ctx.device.type == "cuda":
            print(f"selfcheck: launches {json.dumps(LAUNCHES)}", flush=True)
        n = len(checks)
        print(f"selfcheck: {n - failed}/{n} passed", flush=True)
    finally:
        _DEVICE = None
        distributed.shutdown()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
