"""``python -m tpudist_torch.train`` — the training acceptance lane.

Counterpart of the data-parallel path of ``tpudist/train.py``:
N processes under the JAX package's env contract (``TPUDIST_COORDINATOR``
/ ``TPUDIST_NUM_PROCESSES`` / ``TPUDIST_PROCESS_ID``; one process when
unset), one device each, NCCL on the card and gloo on the CPU. Seeded
synthetic data and a per-epoch permutation, each process training on its
shard of every global batch; the train step (loss, grads, their
all-reduced mean, Adam), dispatched k steps at a time
(``--steps-per-dispatch``, auto as the JAX CLI resolves it: k = 25 at
the defaults) through the superstep, whose batches are staged a slab at
a time (the whole epoch, or double-buffered slabs under
``--staging-budget-mb``), or one step at a time when k = 1; with
``--autotune probe|cache-only`` those knobs (and ``--remat``,
``--grad-accum-steps``) come from measured trials of the real dispatch
before the timed run, or from the tuning cache
(``tpudist_torch.tune``); the epoch
loop with the stdout contract (``Epoch N
finished. Avg loss: X``, ``Epoch N eval loss: X``, ``Training
completed.``), a checkpoint per epoch (and every ``--ckpt-every-steps``),
``--resume``, ``--fail-at`` fault injection, the ``metrics.jsonl``
records (``kind=attempt`` / ``step`` / ``epoch`` / ``ckpt`` / ``timing``)
and the verdict files at ``TPUDIST_VERDICT_PATH`` (one a process, and
the coordinator's AND over all of them, with a bounded wait for a peer
that is dead or late). Exit code 0 on success, 1 on any failure of any
process. It runs on the card (``--device cuda``, the default) unless
asked for the CPU.

Run:  python -m tpudist_torch.train --epochs 5 --train-batch-size 64
Two processes on the CPU: the same with ``--device cpu`` in each of
    TPUDIST_COORDINATOR=localhost:29500 TPUDIST_NUM_PROCESSES=2 \
    TPUDIST_PROCESS_ID=<0|1> python -m tpudist_torch.train --device cpu
"""

from __future__ import annotations

import json
import os
import signal
import sys
import time
from typing import Optional, Sequence

import torch

from tpudist_torch import checkpoint as ckpt_lib
from tpudist_torch import config as config_lib
from tpudist_torch import data as data_lib
from tpudist_torch import engine as engine_lib
from tpudist_torch import verdict as verdict_lib
from tpudist_torch.config import TrainConfig, parse_args
from tpudist_torch.metrics import MetricsLogger, StagingStats, StepTimer, log0
from tpudist_torch.obs import PodObserver
from tpudist_torch.obs import live as live_lib
from tpudist_torch.obs import memledger as memledger_lib
from tpudist_torch.obs import trace as trace_lib
from tpudist_torch.ops.cuda import build as build_lib
from tpudist_torch.parallel import distributed
from tpudist_torch.parallel import staging as staging_lib
from tpudist_torch.utils.platform import resolve_device


def device_kind(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def run(cfg: TrainConfig) -> float:
    """Train per config; returns the last epoch's average loss. Raises on
    failure: :func:`main` turns exceptions into the fail verdict and
    exit 1."""
    config_lib.check_supported(cfg)
    build_lib.set_build_root(cfg.compilation_cache_dir)
    # span tracing is on by default (host clock reads only: traced and
    # untraced runs compute the same bits); a fresh tracer per run, so
    # back-to-back runs in one process never mix spans
    trace_enabled, trace_dir = config_lib.resolve_trace(cfg)
    tracer = trace_lib.configure(enabled=trace_enabled)
    with trace_lib.span("distributed_init", cat="init"):
        ctx = distributed.initialize(device=resolve_device(cfg.device))
    device, world = ctx.device, ctx.process_count
    if cfg.batch_size % world:
        raise ValueError(
            f"--train-batch-size {cfg.batch_size} must be divisible by "
            f"the process count {world}")
    if cfg.batch_size % (world * cfg.grad_accum_steps):
        raise ValueError(
            f"--train-batch-size {cfg.batch_size} must be divisible by "
            f"processes * --grad-accum-steps = "
            f"{world * cfg.grad_accum_steps}")
    backend = f" ({ctx.backend})" if ctx.backend else ""
    log0(f"tpudist: {world} {device_kind(device)} "
         f"device(s), {world} process(es){backend}, model "
         f"{cfg.model.name}, {cfg.dtype}")

    with trace_lib.span("data_materialize", cat="data"):
        if cfg.model.name == "mlp":
            sources = data_lib.make_synthetic_data(
                cfg.data.n_samples, cfg.data.n_features, cfg.data.seed)
        else:
            # seq_len + 1 tokens: the causal shift consumes one, so the
            # model sees exactly max_seq_len positions
            sources = (data_lib.make_synthetic_tokens(
                cfg.data.n_samples, cfg.model.max_seq_len + 1,
                cfg.model.vocab_size, cfg.data.seed),)

    def epoch_plan(epoch):
        return data_lib.plan_epoch(sources, batch_size=cfg.batch_size,
                                   seed=cfg.seed, epoch=epoch,
                                   process_index=ctx.process_index,
                                   process_count=world)

    with trace_lib.span("model_init", cat="init"):
        state = engine_lib.init_state(cfg, device)
    log0(f"tpudist: train state "
         f"{engine_lib.state_bytes_per_device(state) / 1e9:.3f} GB "
         f"(params + Adam moments)")
    metrics = MetricsLogger(path=os.path.join(cfg.save_dir, "metrics.jsonl"))
    # the run's identity stamps every record and trace document; the
    # port's launcher contract has no requeue loop yet (ROADMAP item 10)
    run_id = live_lib.resolve_run_id(world)
    metrics.extra = {"run_id": run_id, "requeue_attempt": 0}
    tracer.run_info = {"run_id": run_id, "requeue_attempt": 0}
    metrics.log(kind="attempt", phase="start", process_count=world)
    metrics.flush()

    # measured-probe autotune (tpudist_torch.tune): replace the static
    # resolve_* guesses below with short trials of the real superstep on
    # the device (or a cached prior measurement) BEFORE the timed run —
    # the committed knobs land in cfg as explicit settings, so the rest
    # of the loop is oblivious to how they were chosen
    autotune_mode = config_lib.resolve_autotune(cfg)
    tuning_status = verdict_lib.tuning_status(autotune_mode)
    if autotune_mode != "off":
        from tpudist_torch import tune as tune_lib
        with trace_lib.span("autotune", cat="tune", mode=autotune_mode):
            outcome = tune_lib.autotune(
                cfg, device, epoch_plan(0), mode=autotune_mode,
                metrics=metrics, is_coordinator=ctx.is_coordinator,
                state_bytes=engine_lib.state_bytes_per_device(state),
                hbm_bytes=engine_lib._device_hbm_bytes(device))
        cfg = outcome.cfg
        tuning_status = outcome.status
        t = outcome.tuned
        log0(f"tpudist: tuning {outcome.status} ({outcome.source}): "
             f"k={t.k}, staging {t.staging_budget_mb} MB, "
             f"remat={t.remat}, grad_accum={t.grad_accum_steps} "
             f"({outcome.trials} probe trials, {outcome.pruned} pruned)")
    k = config_lib.resolve_steps_per_dispatch(cfg)
    budget_bytes = None
    superstep = train_step = None
    if k > 1:
        superstep = engine_lib.make_superstep(cfg, device, k)
        log0(f"tpudist: superstep dispatch k={k}"
             f"{' (auto)' if not cfg.steps_per_dispatch else ''}")
        # epochs over the budget stream in double-buffered slabs; the
        # margin is the 4x-state heuristic (a prior run's ledger does
        # not feed it forward yet)
        budget_bytes = config_lib.resolve_staging_budget_bytes(
            cfg, state_bytes=engine_lib.state_bytes_per_device(state),
            hbm_bytes=engine_lib._device_hbm_bytes(device),
            program_temp_bytes=None)
        if budget_bytes is not None and cfg.staging_budget_mb is None \
                and not os.environ.get("TPUDIST_STAGING_BUDGET_MB"):
            log0(f"tpudist: staging budget auto "
                 f"{budget_bytes / 2**20:.0f} MB (heuristic 4x-state "
                 f"margin)")
    else:
        train_step = engine_lib.make_train_step(cfg, device)
    staging = StagingStats()
    with trace_lib.span("setup", cat="init"):
        if cfg.model.name == "mlp":
            eval_src = data_lib.make_synthetic_data(
                cfg.batch_size, cfg.data.n_features, cfg.data.seed + 1)
        else:
            eval_src = (data_lib.make_synthetic_tokens(
                cfg.batch_size, cfg.model.max_seq_len + 1,
                cfg.model.vocab_size, cfg.data.seed + 1),)
        eval_batch = data_lib.to_device(eval_src, device)
        eval_fn = engine_lib.make_eval_fn(cfg, device)

    start_epoch, start_step_in_epoch = 0, 0
    resume_mode = config_lib.resolve_resume(cfg)
    resume_verdict = verdict_lib.UNGATEABLE
    if resume_mode:
        restored, err = None, None
        with trace_lib.span("resume_restore", cat="ckpt",
                            mode=resume_mode):
            try:
                restored = ckpt_lib.restore_latest_full(cfg.save_dir,
                                                        state)
            except Exception as e:
                if resume_mode != "auto":
                    raise
                err = e
        if restored is not None:
            state, start_epoch, start_step_in_epoch = restored
            resume_verdict = verdict_lib.SUCCESS
            log0(f"Resumed at epoch {start_epoch}, step "
                 f"{start_step_in_epoch} (global step {state.step}).")
        elif err is not None:
            resume_verdict = verdict_lib.FAIL
            log0(f"tpudist: resume {resume_verdict}: restore failed, "
                 f"starting fresh ({err!r})")
        metrics.log(kind="resume", status=resume_verdict,
                    epoch=start_epoch, step_in_epoch=start_step_in_epoch,
                    resumed_from_step=state.step,
                    error=repr(err) if err else None)

    timer = StepTimer(chips=world)
    # the flight recorder: heartbeat beacon, stall watchdog, the device
    # memory watermark and the per-host straggler verdict. Its threads
    # read host-side counters only (no device call, no fence), so they
    # cannot disturb the CUDA graphs the main thread captures
    observer = PodObserver.from_config(
        cfg, metrics=metrics, process_index=ctx.process_index,
        process_count=world,
        devices=[device.index or 0] if device.type == "cuda" else [])
    observer.note_progress(run_id=run_id, requeue_attempt=0)
    with trace_lib.span("ckpt_open", cat="ckpt"):
        ckpt = ckpt_lib.Checkpointer(cfg.save_dir)
    # the programs' scratch for the memory ledger: the per-step path
    # measures its first step, the superstep reports its graph pool
    programs = {}
    run_ok = False
    try:
        last_avg = _epoch_loop(cfg, device, state, train_step, epoch_plan,
                               start_epoch, start_step_in_epoch, metrics,
                               timer, eval_fn, eval_batch, ckpt,
                               superstep, k, budget_bytes, staging,
                               observer, programs)
        run_ok = True
    finally:
        observer.note_progress(phase="shutdown")
        if superstep is not None:
            if superstep.programs:
                programs["superstep"] = {
                    "temp_bytes": superstep.graph_pool_bytes}
            superstep.release()
        observer.close()   # stop the watchdog and sampler, final beacon
        if tracer.enabled and not run_ok:
            # a dying run exports its local timeline only: the pod
            # merge's collectives would wait on a dead peer
            try:
                tracer.export_local(
                    os.path.join(trace_dir, trace_lib.worker_trace_name(
                        ctx.process_index)),
                    process_index=ctx.process_index)
            except Exception:
                pass
        metrics.close()

    sps = timer.steps_per_sec()
    lm = cfg.model.name != "mlp"
    tokens = cfg.batch_size * (cfg.model.max_seq_len if lm else 1)
    log0(f"throughput: {sps:.2f} steps/s "
         f"({timer.steps_per_sec_per_chip():.2f} steps/s/chip, "
         f"{sps * tokens:.1f} {'tokens' if lm else 'samples'}/s) on "
         f"{world} chip(s)")
    log0(f"timing: compile+warmup {timer.warmup_s:.2f}s, "
         f"run {timer.elapsed:.2f}s over {timer.steps} steps")
    overlap = staging.overlap_fraction(timer.elapsed)
    staging_verdict = verdict_lib.staging_status(staging.streamed, overlap)
    if staging.streamed:
        # a pod whose H2D is not hidden behind compute reads as "staging
        # fail", not as an unexplained steps/s shortfall (the waits stay
        # inside the timed windows, so steps/s itself stays honest)
        log0(f"tpudist: staging {staging_verdict}: "
             f"{staging.slabs} slabs, peak "
             f"{staging.peak_bytes / 2**20:.2f} MB staged, "
             f"overlap {overlap:.3f} "
             f"(exposed wait {staging.wait_s:.2f}s of "
             f"{timer.elapsed:.2f}s run)")
    graphs = {}
    if superstep is not None and superstep.programs:
        graphs = dict(superstep_programs=superstep.programs,
                      capture_s=superstep.capture_s,
                      graph_pool_bytes=superstep.graph_pool_bytes,
                      replays=dict(superstep.replays))
        log0(f"tpudist: superstep graphs: {superstep.programs} captured "
             f"in {superstep.capture_s:.3f}s, pool "
             f"{superstep.graph_pool_bytes / 2**20:.1f} MB, replays "
             f"{superstep.replays}")
    # MFU from the step's flop count, the memory watermark and the last
    # epoch's straggler verdict
    obs_fields = observer.timing_fields(
        timer, superstep if superstep is not None else train_step)
    if obs_fields.get("mfu") is not None:
        log0(f"tpudist: mfu {100 * obs_fields['mfu']:.2f}% "
             f"({obs_fields['achieved_tflops_per_chip']:.2f} of "
             f"{obs_fields['peak_tflops']:.0f} TFLOP/s/chip)")
    if obs_fields.get("hbm_peak_bytes"):
        log0(f"tpudist: hbm peak {obs_fields['hbm_peak_bytes'] / 2**20:.1f}"
             f" MB ({obs_fields['hbm_source']})"
             + (f", {100 * obs_fields['hbm_peak_fraction']:.1f}% of device"
                if obs_fields.get("hbm_peak_fraction") else ""))
    # the run-end pod export: every process writes trace.worker<i>.json,
    # the coordinator the merged pod_trace.json (a collective: the
    # success path, which every process reaches). Advisory: a failed
    # export logs and never fails the run
    trace_summary = trace_err = None
    if tracer.enabled:
        try:
            trace_summary = trace_lib.export_pod_trace(
                trace_dir, process_index=ctx.process_index,
                process_count=world, tracer=tracer)
        except Exception as e:
            trace_err = e
    trace_verdict = verdict_lib.trace_status(
        tracer.enabled, tracer.span_count, tracer.dropped,
        exported=trace_summary is not None)
    if tracer.enabled:
        if trace_summary is not None:
            dest = (trace_summary["merged_path"]
                    or trace_summary["local_path"])
            log0(f"tpudist: trace {trace_verdict}: "
                 f"{trace_summary['spans']} spans from "
                 f"{trace_summary['hosts']} host(s)"
                 + (f", {trace_summary['dropped']} dropped"
                    if trace_summary["dropped"] else "")
                 + f" -> {dest}")
        else:
            log0(f"tpudist: trace {trace_verdict}: export failed "
                 f"({trace_err!r})")
    metrics.log(kind="timing", steps_per_dispatch=k, **timer.split(),
                **staging.split(), staging_overlap_fraction=overlap,
                staging_status=staging_verdict,
                tuning_status=tuning_status,
                samples_per_step=cfg.batch_size, tokens_per_step=tokens,
                resume_status=resume_verdict, device=device_kind(device),
                trace_status=trace_verdict,
                trace_spans=(trace_summary or {}).get("spans"),
                trace_dropped=(trace_summary or {}).get("dropped"),
                **graphs, **obs_fields)
    _log_ledger(cfg, ctx, device, state, programs, staging, superstep,
                obs_fields, metrics, run_id)
    log0("Training completed.")
    metrics.close()
    return last_avg


def _log_ledger(cfg, ctx, device, state, programs, staging, superstep,
                obs_fields, metrics, run_id):
    """The card's memory partitioned into the ledger's buckets
    (``obs.memledger``): params and Adam's moments from the state, the
    staged slabs' resident peak (two slabs when streaming), the programs'
    scratch, against the sampler's watermark; a ``kind=memledger`` record
    and ``<save-dir>/memledger.json``. Advisory: a failure logs a line."""
    try:
        if not programs:
            # the CPU: no program reports its scratch, and the ledger
            # notes that program_temp under-counts
            programs["superstep" if superstep is not None
                     else "train_step"] = {}
        params_b = sum(p.numel() * p.element_size()
                       for p in state.params.parameters())
        ledger = memledger_lib.build_ledger(
            total_hbm_bytes=int(engine_lib._device_hbm_bytes(device)),
            params_bytes=params_b,
            opt_state_bytes=engine_lib.state_bytes_per_device(state)
            - params_b,
            slab_bytes=staging.peak_bytes, programs=programs,
            watermark_bytes=obs_fields.get("hbm_peak_bytes"),
            watermark_source=obs_fields.get("hbm_source"),
            mode="train", run_id=run_id)
    except Exception as e:
        log0(f"tpudist: memledger skipped ({e!r})")
        return
    metrics.log(kind="memledger", **memledger_lib.ledger_record(ledger))
    if ctx.is_coordinator:
        try:
            memledger_lib._atomic_write(
                os.path.join(cfg.save_dir, memledger_lib.LEDGER_NAME),
                json.dumps(ledger, indent=1))
        except OSError as e:
            log0(f"tpudist: memledger.json not written ({e!r})")
    b = ledger["buckets"]
    log0(f"tpudist: memledger {ledger['headroom_status']}: "
         f"{100 * ledger['headroom_fraction']:.1f}% headroom of "
         f"{ledger['total_hbm_bytes'] / 2**20:.0f} MB HBM "
         f"(params {b['params'] / 2**20:.1f} MB, opt "
         f"{b['opt_state'] / 2**20:.1f} MB, slabs "
         f"{b['slabs'] / 2**20:.1f} MB, temp "
         f"{b['program_temp'] / 2**20:.1f} MB, "
         f"{'exact' if ledger['exact'] else 'INEXACT'})")
    for n in ledger["problems"] + ledger["notes"]:
        log0(f"tpudist: memledger note: {n}")


def _superstep_epoch(cfg, k, device, state, superstep, plan, first,
                     n_steps, epoch, metrics, timer, ckpt, budget_bytes,
                     staging, observer):
    """One epoch under superstep dispatch with bounded-memory staging,
    the JAX package's ``train._superstep_epoch``.

    ``staging.plan_slabs`` cuts the epoch into ``(slab_steps, batch,
    ...)`` slabs sized by the budget. When the epoch fits, the plan is
    one slab, the full-epoch fast path. Otherwise the loop streams
    double-buffered: slab ``s+1``'s copy is issued (pinned host memory,
    a side stream) before slab ``s``'s supersteps, so the transfer has
    the whole slab's compute to hide behind, and at most two slabs are
    resident. Compute is fenced at slab boundaries, which bounds the
    queued work to one slab and makes the host's blocked time on the
    next slab's event a true measurement of exposed transfer
    (``StagingStats.note_wait``).

    Every dispatch takes an exactly-``k``-step window; ``[lo, hi)``
    masks the zero-padded tail and the pre-resume steps of the
    realignment window. k divides --log-every/--ckpt-every-steps, so
    logging and checkpoint boundaries land on superstep edges. Returns
    ``(state, total, counted, pending)`` as the per-step loop leaves
    them; ``total`` sums the losses in step order, so Avg loss is
    bitwise per-step dispatch's, streamed or not."""
    step_bytes = staging_lib.step_bytes(plan.arrays, plan.local_batch)
    splan = staging_lib.plan_slabs(n_steps, k, step_bytes, budget_bytes)
    if splan.streamed and not staging.streamed:
        log0(f"tpudist: staging streamed: epoch "
             f"{n_steps * step_bytes / 2**20:.2f} MB/device exceeds "
             f"budget {splan.budget_bytes / 2**20:.2f} MB — "
             f"{splan.n_slabs} double-buffered slabs of "
             f"{splan.slab_steps} steps "
             f"({splan.slab_bytes / 2**20:.2f} MB)")
    staging.streamed = staging.streamed or splan.streamed
    S = splan.slab_steps
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def stage(s):
        """Gather and issue slab ``s`` (steps [s*S, s*S+S) of the epoch,
        zero-padded to a k-multiple); returns (slab, per-device bytes)."""
        t0 = time.perf_counter()
        with trace_lib.span("stage_slab", cat="staging", slab=s):
            start = s * S
            stop = min(n_steps, start + S)
            pad_to = -(-(stop - start) // k) * k
            slab = staging_lib.put_slab(
                plan.slab(start, stop, pad_to=pad_to), device, stream)
        nbytes = pad_to * splan.step_bytes
        staging.note_staged(nbytes, time.perf_counter() - t0)
        return slab, nbytes

    total = torch.zeros((), dtype=torch.float32, device=device)
    counted = pending = 0
    losses = None
    dispatched = False
    s0 = first // S
    nxt = stage(s0)
    for s in range(s0, splan.n_slabs):
        cur, cur_bytes = nxt
        if s + 1 < splan.n_slabs:
            # double buffer: issue the NEXT slab's copy before this slab's
            # compute so it has the whole compute window to hide in
            nxt = stage(s + 1)
        if s > s0:
            # the previous slab's compute drained at its boundary fence,
            # so time blocked here is exposed (un-hidden) transfer
            staging.note_wait(cur)
        arrays = cur.arrays_for()
        base = s * S
        staged_len = arrays[0].shape[0]
        for j in range(staged_len // k):
            gstart = base + j * k
            if gstart + k <= first:
                continue            # fully consumed before the resume point
            if gstart >= n_steps:
                break               # pure padding tail
            lo = max(first - gstart, 0)
            hi = min(n_steps - gstart, k)
            window = tuple(a[j * k:(j + 1) * k] for a in arrays)
            # the enqueue (a replay returns before the card finishes);
            # the device wall lands in the "fence" spans
            with trace_lib.span("dispatch", cat="dispatch"):
                state, total, losses = superstep(state, total, window, lo,
                                                 hi)
            end = gstart + hi       # true steps of the epoch completed
            counted += hi - lo
            pending += hi - lo
            # the watchdog's liveness signal: attribute writes only
            observer.note_progress(phase="train", epoch=epoch, step=end)
            if not dispatched:
                dispatched = True
                if timer.warming:
                    # fence the first superstep alone: the warm-up absorbs
                    # the staging fill, the eager window and the captures
                    timer.stop_many(losses, pending)
                    pending = 0
                    timer.start()
            if cfg.log_every and end % cfg.log_every == 0:
                loss_val = float(losses[hi - 1])         # fence
                timer.stop_many(losses, pending)
                pending = 0
                metrics.log(kind="step", epoch=epoch, step=state.step,
                            loss=loss_val,
                            steps_per_sec=timer.steps_per_sec())
                timer.start()
            elif pending >= 100:
                # bound the queued work even when logging is off
                timer.stop_many(losses, pending)
                pending = 0
                timer.start()
            if (cfg.ckpt_every_steps and end % cfg.ckpt_every_steps == 0
                    and end < n_steps):
                timer.stop_many(losses, pending)
                pending = 0
                ckpt.save(state, epoch=epoch, step_in_epoch=end)
                metrics.log(kind="ckpt", epoch=epoch, step=state.step,
                            step_in_epoch=end,
                            enqueue_ms=round(ckpt.last_enqueue_ms, 1))
                metrics.flush()
                timer.start()
        if s + 1 < splan.n_slabs and pending:
            # slab-boundary fence: bounds queued work to one slab and
            # drains compute so the next note_wait measures pure exposure
            timer.stop_many(losses, pending)
            pending = 0
            timer.start()
        staging.note_released(cur_bytes)
        # drop this slab before the next one is issued: two resident
        cur = arrays = window = None
    return state, total, counted, pending


def _epoch_loop(cfg, device, state, train_step, epoch_plan, start_epoch,
                start_step_in_epoch, metrics, timer, eval_fn, eval_batch,
                ckpt, superstep, k, budget_bytes, staging, observer,
                programs):
    last_avg = float("nan")
    tracer = trace_lib.get()
    for epoch in range(start_epoch, cfg.epochs):
        # one top-level span an epoch: the staging, dispatch, fence,
        # eval and checkpoint spans nest inside it
        epoch_span = tracer.begin("epoch", cat="train", epoch=epoch)
        plan = epoch_plan(epoch)
        n_steps = plan.n_steps
        # mid-epoch resume: the epoch's batch order is stateless by
        # (seed, epoch), so skipping the first batches replays the
        # uninterrupted trajectory
        first = start_step_in_epoch if epoch == start_epoch else 0
        # losses accumulate on the device; the loop fences only at
        # logging and checkpoint boundaries
        total, counted, pending = None, 0, 0
        timer.start()
        if superstep is not None:
            state, total, counted, pending = _superstep_epoch(
                cfg, k, device, state, superstep, plan, first, n_steps,
                epoch, metrics, timer, ckpt, budget_bytes, staging,
                observer)
            last_avg = _epoch_end(cfg, state, total, counted, pending,
                                  n_steps, epoch, metrics, timer, eval_fn,
                                  eval_batch, ckpt, observer)
            tracer.end(epoch_span)
            continue
        with trace_lib.span("stage_slab", cat="staging", slab=0):
            batches = plan.slab(0, n_steps)
        for i in range(first, n_steps):
            batch = data_lib.to_device(tuple(a[i] for a in batches), device)
            measure = device.type == "cuda" and "train_step" not in programs
            if measure:
                # the step's scratch for the memory ledger: the peak the
                # allocator saw over one step beyond what was resident
                # before it (allocator counters: no fence). The run's
                # peak so far goes into the watermark first
                observer.sample_hbm()
                torch.cuda.reset_peak_memory_stats(device)
                resident = torch.cuda.memory_allocated(device)
            with trace_lib.span("dispatch", cat="dispatch"):
                state, loss = train_step(state, batch)
            if measure:
                programs["train_step"] = {"temp_bytes": int(
                    torch.cuda.max_memory_allocated(device) - resident)}
            total = loss if total is None else total + loss
            counted += 1
            pending += 1
            observer.note_progress(phase="train", epoch=epoch, step=i + 1)
            if i == first and timer.warming:
                # the first step alone is the warmup: kernel builds and
                # the allocator's first growth stay out of steps/s
                timer.stop_many(loss, 1)
                pending = 0
                timer.start()
            if cfg.log_every and (i + 1) % cfg.log_every == 0:
                loss_val = float(loss)
                timer.stop_many(loss, pending)
                pending = 0
                metrics.log(kind="step", epoch=epoch, step=state.step,
                            loss=loss_val,
                            steps_per_sec=timer.steps_per_sec())
                timer.start()
            elif pending >= 100:
                timer.stop_many(loss, pending)
                pending = 0
                timer.start()
            if (cfg.ckpt_every_steps and (i + 1) % cfg.ckpt_every_steps == 0
                    and i + 1 < n_steps):
                timer.stop_many(loss, pending)
                pending = 0
                ckpt.save(state, epoch=epoch, step_in_epoch=i + 1)
                metrics.log(kind="ckpt", epoch=epoch, step=state.step,
                            step_in_epoch=i + 1,
                            enqueue_ms=round(ckpt.last_enqueue_ms, 1))
                metrics.flush()
                timer.start()
        last_avg = _epoch_end(cfg, state, total, counted, pending, n_steps,
                              epoch, metrics, timer, eval_fn, eval_batch,
                              ckpt, observer)
        tracer.end(epoch_span)
    return last_avg


def _epoch_end(cfg, state, total, counted, pending, n_steps, epoch, metrics,
               timer, eval_fn, eval_batch, ckpt, observer):
    """Epoch tail: drain, the Avg line, eval, the per-host straggler
    aggregation, the epoch record, the epoch-end checkpoint, fault
    injection."""
    last_avg = float(total) / max(counted, 1) if counted else float("nan")
    timer.stop_many(total, pending)
    log0(f"Epoch {epoch + 1:2d} finished. Avg loss: {last_avg:.4f}")
    observer.note_progress(phase="eval", epoch=epoch, step=n_steps)
    t_eval = time.perf_counter()
    with trace_lib.span("eval", cat="eval", epoch=epoch):
        eval_loss = float(eval_fn(state, eval_batch))
    eval_s = time.perf_counter() - t_eval
    log0(f"Epoch {epoch + 1:2d} eval loss: {eval_loss:.4f}")
    # a collective with more than one process: every process calls it,
    # at a point every process reaches (the epoch fence above)
    with trace_lib.span("hosts_gather", cat="sync", epoch=epoch):
        status = observer.epoch_end(epoch, timer, metrics)
    if status == verdict_lib.FAIL:
        worst = max(h["step_s_mean"] for h in observer.hosts.last_hosts
                    if h["steps"] > 0)
        log0(f"tpudist: straggler fail: worst host step "
             f"{worst * 1e3:.2f} ms vs pod median — see kind=hosts")
    # steps_counted < n_steps marks a resumed partial epoch
    metrics.log(kind="epoch", epoch=epoch, avg_loss=last_avg,
                eval_loss=eval_loss, eval_s=round(eval_s, 6),
                steps_counted=counted, n_steps=n_steps,
                steps_per_sec=timer.steps_per_sec(),
                steps_per_sec_per_chip=timer.steps_per_sec_per_chip())
    observer.note_progress(phase="ckpt", epoch=epoch)
    ckpt.save(state, epoch=epoch + 1, step_in_epoch=0)
    metrics.log(kind="ckpt", epoch=epoch, step=state.step, step_in_epoch=0,
                enqueue_ms=round(ckpt.last_enqueue_ms, 1))
    metrics.flush()
    if cfg.fail_at is not None and epoch >= cfg.fail_at:
        raise RuntimeError(
            f"fault injection: --fail-at {cfg.fail_at} triggered")
    return last_avg


def main(argv: Optional[Sequence[str]] = None) -> int:
    verdict_path = os.environ.get("TPUDIST_VERDICT_PATH")

    # the launcher bounds the job with `timeout` -> SIGTERM: turn it into
    # an orderly exit so the verdict below is still written
    def _sigterm(signum, frame):
        raise SystemExit(128 + signum)
    try:
        prev_sigterm = signal.signal(signal.SIGTERM, _sigterm)
    except (ValueError, OSError):
        prev_sigterm = None
    ok = all_ok = False
    try:
        run(parse_args(argv))
        ok = True
    except SystemExit:
        print("tpudist: training terminated by signal", file=sys.stderr,
              flush=True)
    except Exception as e:
        print(f"tpudist: training failed: {e!r}", file=sys.stderr,
              flush=True)
    finally:
        # per-worker verdict -> bounded AND over the processes -> final
        # verdict (coordinator) -> bounded end barrier -> shutdown
        delay = float(os.environ.get("TPUDIST_TEST_PRE_VERDICT_SLEEP_S",
                                     "0"))
        if delay:
            # fault-drill hook: makes THIS worker late to the verdict
            time.sleep(delay)
        agg_timed_out = False
        try:
            if verdict_path:
                verdict_lib.write_worker_verdict(verdict_path, ok)
            all_ok, agg_timed_out = verdict_lib.aggregate_status(ok)
            if verdict_path:
                verdict_lib.write_final_verdict(verdict_path, all_ok)
        except Exception as e:
            print(f"tpudist: verdict plumbing failed: {e!r}",
                  file=sys.stderr, flush=True)
            all_ok = False
        # after a timeout a peer is dead or gone: any further collective
        # (the barrier, destroying the group) could wait on it forever
        if not agg_timed_out \
                and not distributed.barrier_bounded("tpudist_end"):
            distributed.shutdown()
        if prev_sigterm is not None:
            try:
                signal.signal(signal.SIGTERM, prev_sigterm)
            except (ValueError, OSError):
                pass
    code = 0 if ok and all_ok else 1
    if agg_timed_out:
        # the abandoned reduce's daemon thread still sits in the host
        # group: the interpreter's teardown can abort under it (SIGABRT
        # once torch._dynamo is loaded, as the flop count's dispatch mode
        # loads it), so leave with the verdict's exit code now
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)
    return code


if __name__ == "__main__":
    sys.exit(main())
