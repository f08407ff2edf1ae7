"""``python -m tpudist_torch.train`` — the training acceptance lane.

Counterpart of ``tpudist/train.py`` on its ``data x fsdp x tensor`` mesh:
N processes under the JAX package's env contract (``TPUDIST_COORDINATOR``
/ ``TPUDIST_NUM_PROCESSES`` / ``TPUDIST_PROCESS_ID``; one process when
unset), one device each, NCCL on the card and gloo on the CPU. Seeded
synthetic data and a per-epoch permutation, each process training on its
shard of every global batch; the train step (loss, grads, their
all-reduced mean, Adam; with ``--fsdp N`` the state sharded N ways, each
shard gathered for the step and its gradient reduce-scattered; with
``--tensor N`` each rank keeps its Megatron shard and computes its
heads, FFN columns and vocab columns, the N tensor ranks of a batch
shard seeing the same rows; with ``--context N`` the sequence models'
N context ranks of a batch shard split its sequence, ring or Ulysses
attention by ``--cp-impl``; on a mesh the MoE routes the global
batch),
dispatched k steps at a time
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
completed.``), a checkpoint per epoch (and every ``--ckpt-every-steps``;
asynchronous unless ``--ckpt-sync``, in the port's step directories or
``--ckpt-mode sharded``'s manifest layout), ``--resume`` (the elastic
resume, ``tpudist_torch.elastic``), ``--fail-at`` and the chaos plane
(``--chaos``, ``TPUDIST_TEST_KILL``), the live telemetry bus
(``--live on``: every process's emitter, the coordinator's aggregator
and Prometheus exporter, ``tpudist_torch.obs.live``), device-time
capture (``--profile-window N`` mid-run dispatches ingested into
``kind=devtime`` and device tracks in ``pod_trace.json``;
``--profile-dir``'s full-run trace; ``tpudist_torch.obs.devtime``), the
``metrics.jsonl`` records (``kind=attempt`` / ``step`` / ``epoch`` /
``ckpt`` / ``resume`` / ``ckpt_drain`` / ``devtime`` / ``timing`` /
``goodput``) and the verdict files at ``TPUDIST_VERDICT_PATH`` (one a
process, and the coordinator's AND over all of them, with a bounded wait
for a peer that is dead or late). Exit code 0 on success, 1 on any
failure of any process. It runs on the card (``--device cuda``, the
default) unless asked for the CPU.

Run:  python -m tpudist_torch.train --epochs 5 --train-batch-size 64
Two processes on the CPU: the same with ``--device cpu`` in each of
    TPUDIST_COORDINATOR=localhost:29500 TPUDIST_NUM_PROCESSES=2 \
    TPUDIST_PROCESS_ID=<0|1> python -m tpudist_torch.train --device cpu
"""

from __future__ import annotations

import contextlib
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
from tpudist_torch import rules as rules_lib
from tpudist_torch import verdict as verdict_lib
from tpudist_torch.config import TrainConfig, parse_args
from tpudist_torch.metrics import (MetricsLogger, StagingStats, StepTimer,
                                   _rank, log0)
from tpudist_torch.obs import PodObserver
from tpudist_torch.obs import devtime as devtime_lib
from tpudist_torch.obs import goodput as goodput_lib
from tpudist_torch.obs import live as live_lib
from tpudist_torch.obs import memledger as memledger_lib
from tpudist_torch.obs import trace as trace_lib
from tpudist_torch.ops.cuda import build as build_lib
from tpudist_torch.parallel import distributed
from tpudist_torch.parallel import mesh as mesh_lib
from tpudist_torch.parallel import staging as staging_lib
from tpudist_torch.utils.platform import resolve_device


_KILL_SPEC: Optional[tuple] = None


def _test_kill_spec() -> tuple:
    """``TPUDIST_TEST_KILL="<epoch>:<step>[:<rank>]"`` as ``(epoch, step,
    rank)`` (rank -1: every rank), or ``()`` when unset; parsed once a
    process."""
    global _KILL_SPEC
    if _KILL_SPEC is None:
        raw = os.environ.get("TPUDIST_TEST_KILL", "")
        if raw:
            parts = raw.split(":")
            _KILL_SPEC = (int(parts[0]), int(parts[1]),
                          int(parts[2]) if len(parts) > 2 else -1)
        else:
            _KILL_SPEC = ()
    return _KILL_SPEC


def _maybe_test_kill(epoch: int, step: int, observer=None) -> None:
    """The scripted preemption of the JAX package's
    ``train._maybe_test_kill``: once the epoch reaches the step of
    ``TPUDIST_TEST_KILL``, the matching rank stamps one beacon (an atomic
    file write: the goodput ledger's lost-step count reads it) and dies
    by ``os._exit(113)``: no ``finally``, no verdict, no drain, the death
    a preemption reaper delivers."""
    spec = _test_kill_spec()
    if not spec:
        return
    ke, ks, kr = spec
    if epoch == ke and step >= ks and (kr < 0 or kr == _rank()):
        print(f"tpudist: TEST KILL (preemption drill) at epoch {epoch} "
              f"step {step}", flush=True)
        if observer is not None:
            try:
                observer.beacon_now()
            except Exception:
                pass
        os._exit(113)


def device_kind(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def check_context(cfg: TrainConfig, context: int, *,
                  device_type: str = "cpu", tensor: int = 1,
                  batch_ways: int = 1) -> None:
    """The JAX train CLI's refusals of a context axis (``--context``
    ways) its sequence models cannot take: a model without a sequence,
    and a sequence the layout cannot cut (the ring's zigzag takes 2
    chunks a shard, Ulysses one); on the card, also
    :func:`check_context_kernels`."""
    if context <= 1:
        return
    if cfg.model.name not in ("transformer", "moe"):
        raise ValueError("--context > 1 (sequence parallelism) requires "
                         "a sequence model (--model transformer|moe)")
    ways = 2 * context if cfg.cp_impl == "ring" else context
    if cfg.model.max_seq_len % ways:
        raise ValueError(
            f"--seq-len {cfg.model.max_seq_len} must be divisible by "
            f"{'2x' if cfg.cp_impl == 'ring' else ''}--context "
            f"{context} (cp-impl {cfg.cp_impl})")
    if device_type == "cuda":
        check_context_kernels(cfg, context, tensor=tensor,
                              batch_ways=batch_ways)


def check_context_kernels(cfg: TrainConfig, context: int, *,
                          tensor: int = 1, batch_ways: int = 1) -> None:
    """On the card a context axis's attention runs the flash kernels
    only: the ring's hop chunks (:func:`ring.flash_hops_supported`) or
    Ulysses's head-split full sequence (``transformer._use_flash``) must
    be shapes the kernel takes, else the run is refused here, before
    any launch (the wrappers would raise at the first step). The CPU
    takes every shape, the einsum ring and the dense attention being
    the kernels' plain versions."""
    from tpudist_torch.models.transformer import _use_flash
    from tpudist_torch.ops import ring_attention as ring_lib

    m = cfg.model
    # a rank's heads under --tensor (one kv head a q head where the kv
    # heads do not split evenly, as ``StepGroups.attention_weights``)
    h = m.n_heads // tensor
    kv = m.n_kv_heads // tensor if m.n_kv_heads % tensor == 0 else h
    hd, seq = m.d_model // m.n_heads, m.max_seq_len
    b = max(1, cfg.batch_size // (batch_ways * cfg.grad_accum_steps))
    s_local = seq // context
    if cfg.cp_impl == "ring":
        q_sh, k_sh = (b, s_local, h, hd), (b, s_local, kv, hd)
        ok = ring_lib.flash_hops_supported(q_sh, k_sh, n_shards=context)
        what = f"ring hop shapes q {q_sh} k {k_sh} (zigzag chunks of " \
               f"{s_local // 2})"
    else:
        q_sh, k_sh = (b, seq, h // context, hd), (b, seq, kv // context, hd)
        ok = _use_flash(q_sh, k_sh, True)
        what = f"ulysses head-split shapes q {q_sh} k {k_sh}"
    if not ok:
        raise ValueError(
            f"--context {context} at --seq-len {seq} on the card: {what} "
            f"are shapes the flash kernel does not take (sequence chunks "
            f"of a multiple of 128, head dim 128 or 256); pick a "
            f"--seq-len / --context pair that gives them, or run on the CPU")


def run(cfg: TrainConfig) -> float:
    """Train per config; returns the last epoch's average loss. Raises on
    failure: :func:`main` turns exceptions into the fail verdict and
    exit 1."""
    run_wall_t0 = time.time()   # the attempt-local goodput denominator
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
    # the mesh: one card a process, ranks in C order over the six axes;
    # --fsdp, --expert, --tensor or --context > 1 runs the sharded step
    # over it (the JAX package's jit + shardings path), else the state is
    # replicated and the step all-reduces (its pure-DP path, which needs
    # no DeviceMesh)
    sizes = dict(zip(mesh_lib.AXIS_NAMES,
                     mesh_lib.resolve_axis_sizes(cfg.parallel, world)))
    check_context(cfg, sizes["context"], device_type=device.type,
                  tensor=sizes["tensor"],
                  batch_ways=sizes["data"] * sizes["fsdp"])
    mesh = None
    if any(sizes[a] > 1 for a in ("fsdp", "expert", "tensor", "context")):
        mesh = mesh_lib.build_mesh(cfg.parallel, device_type=device.type)
    # a process's batch shard is its position in (data, fsdp); the
    # expert and tensor ranks of one position share it
    batch_ways = sizes["data"] * sizes["fsdp"]
    if cfg.batch_size % batch_ways:
        raise ValueError(
            f"--train-batch-size {cfg.batch_size} must be divisible by "
            f"data*fsdp mesh size = {batch_ways}")
    if cfg.batch_size % (batch_ways * cfg.grad_accum_steps):
        raise ValueError(
            f"--train-batch-size {cfg.batch_size} must be divisible by "
            f"data*fsdp*grad_accum = {batch_ways * cfg.grad_accum_steps}")
    backend = f" ({ctx.backend})" if ctx.backend else ""
    log0(f"tpudist: {world} {device_kind(device)} "
         f"device(s), {world} process(es){backend}, model "
         f"{cfg.model.name}, {cfg.dtype}"
         + (f", mesh data {sizes['data']} x fsdp {sizes['fsdp']}"
            + (f" x expert {sizes['expert']}" if sizes["expert"] > 1
               else "")
            + (f" x tensor {sizes['tensor']}" if sizes["tensor"] > 1
               else "")
            + (f" x context {sizes['context']} ({cfg.cp_impl})"
               if sizes["context"] > 1 else "") if mesh is not None
            else ""))
    if cfg.model.name == "moe":
        if mesh is None:
            log0("tpudist: MoE routing and aux loss over each process's "
                 "rows (group-local, the JAX package's data-parallel "
                 "path)")
        else:
            log0("tpudist: MoE routing over the global batch"
                 + (" (each context shard its own sequence slice of it)"
                    if sizes["context"] > 1 else "")
                 + ", its aux loss's sums all-reduced over data x fsdp"
                 + (f"; its experts split over expert {sizes['expert']}"
                    if sizes["expert"] > 1 else ""))

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

    # each process computes the loss on its own rows of the batch and the
    # step means the grads. A process's batch shard is its position in
    # ("data", "fsdp"): under C order over the six axes its rank over the
    # expert x tensor x context ways (the expert, tensor and context ranks
    # of a position see the same rows; the context ranks split their
    # sequence). On a mesh, under --grad-accum-steps, a rank's rows
    # are microbatch-major (its microbatch i is its share of the global
    # microbatch i, which the MoE routes over), for every model as the
    # JAX package's jit path splits them; replicated, each rank's
    # microbatches are its own rows, as its data-parallel path's are
    def epoch_plan(epoch):
        return data_lib.plan_epoch(
            sources, batch_size=cfg.batch_size, seed=cfg.seed, epoch=epoch,
            process_index=(ctx.process_index
                           // (sizes["expert"] * sizes["tensor"]
                               * sizes["context"])),
            process_count=batch_ways,
            n_accum=cfg.grad_accum_steps if mesh is not None else 1)

    with trace_lib.span("model_init", cat="init"):
        state = (engine_lib.init_state(cfg, device) if mesh is None
                 else engine_lib.init_state(cfg, device, mesh))
    log0(f"tpudist: train state "
         f"{engine_lib.state_bytes_per_device(state) / 1e9:.3f} GB "
         f"(params + Adam moments"
         + ((f", this device's 1/{sizes['fsdp']} shards)"
             if sizes["tensor"] == sizes["expert"] == 1 else
             f", this device's shards over fsdp {sizes['fsdp']}"
             + (f" x expert {sizes['expert']}" if sizes["expert"] > 1
                else "")
             + (f" x tensor {sizes['tensor']}" if sizes["tensor"] > 1
                else "") + ")") if mesh is not None else ")"))
    metrics = MetricsLogger(path=os.path.join(cfg.save_dir, "metrics.jsonl"))
    # the run's identity and the launcher's requeue attempt stamp every
    # record, trace document, beacon and checkpoint index
    requeue_attempt = config_lib.resolve_requeue_attempt(cfg)
    run_id = live_lib.resolve_run_id(world)
    metrics.extra = {"run_id": run_id, "requeue_attempt": requeue_attempt}
    tracer.run_info = {"run_id": run_id,
                       "requeue_attempt": requeue_attempt}
    metrics.log(kind="attempt", phase="start", process_count=world)
    metrics.flush()

    # the live telemetry bus (--live on): the coordinator runs the
    # aggregator, its alert engine and the Prometheus exporter; every
    # process (the coordinator too: one host loops back over an ephemeral
    # port, the socket path a pod takes) gets a non-blocking emitter that
    # the metrics stream and the heartbeat beacon feed. Off constructs
    # nothing
    live_enabled, live_port, live_endpoint = config_lib.resolve_live(cfg)
    live = None
    if live_enabled:
        stall_s, obs_dir, _ = config_lib.resolve_obs(cfg)
        live = live_lib.LiveRun.start(
            is_coordinator=ctx.is_coordinator,
            process_index=ctx.process_index, out_dir=obs_dir,
            run_id=run_id, requeue_attempt=requeue_attempt,
            port=live_port, endpoint=live_endpoint,
            stall_timeout_s=stall_s, metrics=metrics)
        metrics.emitter = live.emitter
        if live.exporter is not None:
            log0(f"tpudist: live on: ingest {live.endpoint}, Prometheus "
                 f"/metrics on :{live.exporter.port}, live_status.json "
                 f"in {obs_dir}")

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
                hbm_bytes=engine_lib._device_hbm_bytes(device), mesh=mesh)
        cfg = outcome.cfg
        tuning_status = outcome.status
        t = outcome.tuned
        log0(f"tpudist: tuning {outcome.status} ({outcome.source}): "
             f"k={t.k}, staging {t.staging_budget_mb} MB, "
             f"remat={t.remat}, grad_accum={t.grad_accum_steps} "
             f"({outcome.trials} probe trials, {outcome.pruned} pruned)")
    overlap_mode, bucket_bytes = config_lib.resolve_grad_overlap(cfg)
    if overlap_mode != "off" and mesh is None and world > 1:
        # the schedule is claimed only where the step carries it: the
        # replicated data-parallel step (a sharded mesh refuses the flag)
        log0(f"tpudist: grad overlap {overlap_mode}: bucket "
             f"{bucket_bytes / 2**20:g} MB over the data axis (reduce "
             f"dispatched as backward produces each bucket)")
    k = config_lib.resolve_steps_per_dispatch(cfg)
    budget_bytes = None
    superstep = train_step = None
    if k > 1:
        superstep = engine_lib.make_superstep(cfg, device, k, mesh)
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
        train_step = engine_lib.make_train_step(cfg, device, mesh)
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
        eval_fn = engine_lib.make_eval_fn(cfg, device, mesh)

    # elastic resume (tpudist_torch.elastic.resume): the newest of the
    # committed sharded manifest and the orbax step directories; --resume
    # auto (what the launcher's requeue loop passes) degrades a failed
    # restore to a flagged fresh start. The restored (epoch,
    # step_in_epoch) feeds the superstep realignment
    start_epoch, start_step_in_epoch = 0, 0
    resume_mode = config_lib.resolve_resume(cfg)
    resume_verdict = verdict_lib.UNGATEABLE
    # a corrupt-checkpoint fallback's fallback_from / corrupt_shard
    resume_details: dict = {}
    if resume_mode:
        from tpudist_torch.elastic import resume as elastic_resume
        restored, resume_src, resume_err = None, None, None
        with trace_lib.span("resume_restore", cat="ckpt",
                            mode=resume_mode):
            try:
                restored = elastic_resume.restore_for_resume(
                    cfg.save_dir, state,
                    run_meta={"seed": cfg.seed,
                              "batch_size": cfg.batch_size,
                              "model": cfg.model.name},
                    details=resume_details)
            except Exception as e:
                if resume_mode != "auto":
                    raise
                resume_err = e
        if restored is not None:
            state, start_epoch, start_step_in_epoch, resume_src = restored
        resume_verdict = verdict_lib.resume_status(
            True, restored is not None, error=resume_err is not None)
        # steps lost to the preemption: the dead attempt's heartbeat
        # beacon (atomic, it survives any kill) recorded how far training
        # had got past the committed checkpoint
        steps_lost = None
        if restored is not None:
            beacon = os.path.join(
                config_lib.resolve_obs(cfg)[1],
                f"heartbeat.worker{ctx.process_index}")
            try:
                with open(beacon) as f:
                    b = json.load(f)
                if (b.get("epoch") == start_epoch
                        and isinstance(b.get("step"), int)):
                    steps_lost = max(0, b["step"] - start_step_in_epoch)
            except Exception:
                pass
        metrics.log(kind="resume", status=resume_verdict,
                    source=resume_src,
                    epoch=start_epoch, step_in_epoch=start_step_in_epoch,
                    resumed_from_step=int(state.step),
                    steps_lost=steps_lost,
                    requeue_attempt=requeue_attempt,
                    fallback_from=resume_details.get("fallback_from"),
                    corrupt_shard=resume_details.get("corrupt_shard"),
                    error=repr(resume_err) if resume_err else None)
        if restored is not None:
            log0(f"Resumed at epoch {start_epoch}, step "
                 f"{start_step_in_epoch} (global step {state.step}).")
            log0(f"tpudist: resume {resume_verdict} ({resume_src}): "
                 f"from step {state.step}"
                 + (f", ~{steps_lost} step(s) lost"
                    if steps_lost is not None else "")
                 + (f", requeue attempt {requeue_attempt}"
                    if requeue_attempt else ""))
            if resume_details.get("fallback_from") is not None:
                log0(f"tpudist: resume fallback: step "
                     f"{resume_details['fallback_from']} checkpoint is "
                     f"corrupt ({resume_details.get('corrupt_shard')}); "
                     f"restored the previous committed step instead")
        elif resume_err is not None:
            log0(f"tpudist: resume {resume_verdict}: restore failed, "
                 f"starting fresh ({resume_err!r})")

    timer = StepTimer(chips=world)
    # the windowed device capture (--profile-window): N mid-run dispatches
    # of torch.profiler timeline a process, ingested at run end into the
    # compute / exposed-comm split. None when off
    win = devtime_lib.WindowProfiler.from_config(
        cfg, out_dir=trace_dir, process_index=ctx.process_index,
        device=device)
    # the flight recorder: heartbeat beacon, stall watchdog, the device
    # memory watermark and the per-host straggler verdict. Its threads
    # read host-side counters only (no device call, no fence), so they
    # cannot disturb the CUDA graphs the main thread captures. The stall
    # hook tells the flight record what became of an open capture
    # window; with the bus on, every beacon carries the live slice of
    # counters the aggregator grades
    observer = PodObserver.from_config(
        cfg, metrics=metrics, process_index=ctx.process_index,
        process_count=world,
        devices=[device.index or 0] if device.type == "cuda" else [],
        stall_hook=win.emergency_stop if win is not None else None,
        live=live,
        live_fields=lambda: {"run_s": timer.elapsed,
                             "staging_streamed": staging.streamed,
                             "staging_wait_s": staging.wait_s})
    observer.note_progress(run_id=run_id, requeue_attempt=requeue_attempt)

    # the chaos plane (tpudist_torch.chaos, --chaos/TPUDIST_CHAOS): a
    # seeded fault schedule fired at step boundaries and inside the
    # sharded checkpoint's write path, whose hook is installed BEFORE the
    # checkpointer opens. Off (the default) constructs nothing
    chaos_rt = None
    chaos_spec = config_lib.resolve_chaos(cfg)
    if chaos_spec:
        from tpudist_torch import chaos as chaos_lib
        chaos_rt = chaos_lib.ChaosRuntime(
            chaos_lib.ChaosPlan.parse(chaos_spec),
            process_index=ctx.process_index, observer=observer,
            emitter=live.emitter if live is not None else None,
            metrics=metrics)
        chaos_rt.install()
        log0(f"tpudist: chaos on: {chaos_rt.plan.describe()}")

    # one checkpointer for the whole run; --ckpt-mode sharded swaps in
    # the elastic per-worker-shard layout behind the same surface
    ckpt_mode = config_lib.resolve_ckpt_mode(cfg)
    with trace_lib.span("ckpt_open", cat="ckpt", mode=ckpt_mode):
        if ckpt_mode == "sharded":
            from tpudist_torch.elastic import ckpt as elastic_ckpt
            ckpt = elastic_ckpt.ShardedCheckpointer(
                cfg.save_dir, process_index=ctx.process_index,
                process_count=world, use_async=not cfg.ckpt_sync,
                run_meta={"seed": cfg.seed, "batch_size": cfg.batch_size,
                          "model": cfg.model.name,
                          # correlation keys only: resume validates the
                          # data cursor above, any attempt restores
                          "run_id": run_id,
                          "requeue_attempt": requeue_attempt})
        else:
            ckpt = ckpt_lib.Checkpointer(cfg.save_dir,
                                         use_async=not cfg.ckpt_sync)
    # the programs' scratch for the memory ledger: the per-step path
    # measures its first step, the superstep reports its graph pool
    programs = {}
    run_ok = False
    try:
        with _full_run_capture(cfg, ctx.process_index, device):
            last_avg = _epoch_loop(cfg, device, state, train_step,
                                   epoch_plan, start_epoch,
                                   start_step_in_epoch, metrics, timer,
                                   eval_fn, eval_batch, ckpt, superstep, k,
                                   budget_bytes, staging, observer,
                                   programs, chaos_rt, win)
        run_ok = True
    finally:
        if chaos_rt is not None:
            chaos_rt.uninstall()   # the module-level hook must not
            # outlive the run (in-process runs come back to back)
        if win is not None:
            win.close()   # a window wider than the run still stops
        observer.note_progress(phase="shutdown")
        try:
            # drain the writer before the process can exit: a daemon
            # thread still writing at interpreter teardown would lose
            # the save
            ckpt.close(barrier=run_ok)
        finally:
            # the blocked time the per-save enqueue_ms cannot see, and
            # the sharded layout's transient-fs-error counters
            metrics.log(kind="ckpt_drain",
                        drain_ms=round(ckpt.drain_ms, 1), saves=ckpt.saves,
                        write_errors=ckpt.write_errors,
                        write_retries=getattr(ckpt, "write_retries", 0),
                        write_skips=getattr(ckpt, "write_skips", 0),
                        bytes_written=getattr(ckpt, "bytes_written", None),
                        write_s=getattr(ckpt, "write_s", None),
                        mode=ckpt_mode)
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
        if live is not None and not run_ok:
            # a dying run still publishes: a bounded drain of the
            # emitter, the final live_status.json, every socket and
            # thread down (the success path closes at the very end, so
            # the run-end records reach the bus)
            live.close()

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
    coll = None
    operands = (superstep if superstep is not None
                else train_step).reduced_operands()
    if operands:
        # the step's collective volume, from the operands the step body
        # noted: the gradient mean's and the loss's all-reduces (or the
        # slice ladder's phases), and under FSDP the gathers
        # and reduce-scatters too; context parallelism's ring rotations
        # and Ulysses all-to-alls are named with their bytes
        coll = devtime_lib.collective_bytes(operands)
        log0(f"tpudist: collectives {coll['n_collectives']} op(s)/step: "
             f"{coll['dcn_bytes_total']} B dcn, "
             f"{coll['ici_bytes_total']} B ici (from the step body's "
             f"operands)" + "".join(
                 f"; {r['op']} {r['dtype']} {r['bytes']} B x {r['count']}"
                 for r in coll["ops"]
                 if r["op"] in ("collective_permute", "all_to_all")))
    devtime_status, dev_events = _ingest_devtime(
        win, ctx, metrics, coll,
        mesh if mesh is not None else mesh_lib.rank_grid(cfg.parallel,
                                                         world))
    # the run-end pod export: every process writes trace.worker<i>.json,
    # the coordinator the merged pod_trace.json (a collective: the
    # success path, which every process reaches). Advisory: a failed
    # export logs and never fails the run
    trace_summary = trace_err = None
    if tracer.enabled:
        try:
            trace_summary = trace_lib.export_pod_trace(
                trace_dir, process_index=ctx.process_index,
                process_count=world, tracer=tracer,
                extra_events=dev_events)
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
    # this process's kernel launches: the wrappers' counters (from the
    # process's start or the last reset), and the superstep's replays,
    # which do not move them
    launches = engine_lib.kernel_launch_counts()
    if superstep is not None:
        for name, n in superstep.kernel_launches().items():
            launches[name] += n
    metrics.log(kind="timing", steps_per_dispatch=k, **timer.split(),
                **staging.split(), staging_overlap_fraction=overlap,
                staging_status=staging_verdict,
                tuning_status=tuning_status,
                samples_per_step=cfg.batch_size, tokens_per_step=tokens,
                resume_status=resume_verdict, device=device_kind(device),
                comm_status=devtime_status, trace_status=trace_verdict,
                trace_spans=(trace_summary or {}).get("spans"),
                trace_dropped=(trace_summary or {}).get("dropped"),
                kernel_launches=launches, **graphs, **obs_fields)
    _log_ledger(cfg, ctx, device, state, programs, staging, superstep,
                obs_fields, metrics, run_id)
    # the attempt-local goodput estimate: the cross-attempt ledger's
    # bucket math over this attempt's own records and wall, refined
    # offline once the launcher's attempts.jsonl adds what only it sees
    gp = goodput_lib.attempt_record(
        metrics.history, wall_s=time.time() - run_wall_t0,
        requeue_attempt=requeue_attempt)
    if gp is not None:
        metrics.log(kind="goodput", **gp)
        log0(f"tpudist: goodput {gp['status']}: "
             f"{100 * gp['fraction']:.1f}% of this attempt's "
             f"{gp['wall_s']:.2f}s wall was productive step time "
             f"(floor {rules_lib.resolve('goodput'):.0%}; "
             f"cross-attempt ledger: python -m tpudist.obs.goodput)")
    if live is not None:
        # after the run-end records, so they reach the bus: a bounded
        # drain, then the final live_status.json
        live.close()
        if live.aggregator is not None:
            snap = live.aggregator.snapshot()
            n_alerts = (snap.get("alerts") or {}).get("events", 0)
            log0(f"tpudist: live {snap.get('status', 'ok')}: "
                 f"{live.aggregator.records} record(s), {n_alerts} alert "
                 f"event(s) -> {live.aggregator.status_path}")
    log0("Training completed.")
    metrics.close()
    return last_avg


@contextlib.contextmanager
def _full_run_capture(cfg, process_index: int, device):
    """``--profile-dir``: the whole epoch loop under ``torch.profiler``,
    its Kineto trace written to ``<profile-dir>/worker<i>`` on every
    process (a failing run's partial trace too)."""
    if not cfg.profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    out = os.path.join(cfg.profile_dir, f"worker{process_index}")
    os.makedirs(out, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        try:
            prof.export_chrome_trace(os.path.join(
                out, f"worker{process_index}.pt.trace.json"))
        except Exception as e:
            log0(f"tpudist: --profile-dir trace not written ({e!r})")
        log0(f"tpudist: profile -> {out}")


def _ingest_devtime(win, ctx, metrics, coll, mesh):
    """The ``--profile-window`` capture's compute / exposed-comm split:
    the ``kind=devtime`` record (``axis_fabric``: the ``mesh``'s
    ``mesh_fabrics``), the ``devtime ...`` line, and the device tracks
    for the pod trace on the tracer's clock. Returns ``(comm_status,
    device events or None)``. Advisory: a malformed capture logs a line
    and grades FAIL, never fails the run."""
    if win is None or not win.captured:
        if win is not None and win.lost:
            log0(f"tpudist: devtime {verdict_lib.UNGATEABLE}: the capture "
                 f"was lost ({win.lost})")
        return verdict_lib.UNGATEABLE, None
    try:
        with trace_lib.span("devtime_ingest", cat="profile"):
            analysis = devtime_lib.analyze_capture(win.capture_dir)
        pod = analysis["pod"]
        # fabric-graded: the gradient all-reduce rides the data axis,
        # whose label the mesh gives (TPUDIST_SLICE_MAP scripts slices)
        fabric = mesh_lib.data_fabric(mesh)
        fabrics = mesh_lib.mesh_fabrics(mesh)
        status = verdict_lib.comm_status(pod["exposed_comm_frac"],
                                         fabric=fabric)
        events = devtime_lib.device_events(
            analysis, process_index=ctx.process_index,
            anchor_us=win.offset_us(analysis))
        byte_fields = {}
        if coll is not None:
            byte_fields = dict(dcn_bytes_total=coll["dcn_bytes_total"],
                               ici_bytes_total=coll["ici_bytes_total"],
                               collectives=coll["ops"])
        metrics.log(kind="devtime", comm_status=status, fabric=fabric,
                    axis_fabric=fabrics, capture=win.capture_dir,
                    dispatches=win.seen, process_index=ctx.process_index,
                    capture_stop_s=win.stop_s,
                    capture_export_s=win.export_s,
                    **pod, **byte_fields,
                    per_device=[{"device": name, **d}
                                for name, d in analysis["devices"].items()])
        log0(f"tpudist: devtime {status}: compute {pod['compute_s']:.3f}s, "
             f"comm {pod['comm_s']:.3f}s ({pod['exposed_comm_s']:.3f}s "
             f"exposed, {100 * (pod['exposed_comm_frac'] or 0):.1f}% of "
             f"the {pod['window_s']:.3f}s window, {fabric}-graded) over "
             f"{pod['devices']} device track(s)")
        return status, events
    except Exception as e:
        log0(f"tpudist: devtime {verdict_lib.FAIL}: capture ingest failed "
             f"({e!r})")
        return verdict_lib.FAIL, None


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
                     staging, observer, chaos, profiler_win=None):
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
            if profiler_win is not None:
                # a dispatch is one superstep; the window fences and
                # stops itself after its N-th
                profiler_win.note_dispatch(losses)
            end = gstart + hi       # true steps of the epoch completed
            counted += hi - lo
            pending += hi - lo
            # the watchdog's liveness signal: attribute writes only
            observer.note_progress(phase="train", epoch=epoch, step=end)
            _maybe_test_kill(epoch, end, observer)
            if chaos is not None:
                chaos.on_step(epoch, end)
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
                programs, chaos=None, profiler_win=None):
    last_avg = float("nan")
    tracer = trace_lib.get()
    for epoch in range(start_epoch, cfg.epochs):
        # one top-level span an epoch: the staging, dispatch, fence,
        # eval and checkpoint spans nest inside it
        epoch_span = tracer.begin("epoch", cat="train", epoch=epoch)
        if profiler_win is not None:
            # the capture window opens at its trigger epoch's first
            # dispatch: mid-run steady state, not the build epoch
            profiler_win.maybe_start(epoch)
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
                observer, chaos, profiler_win)
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
            if profiler_win is not None:
                profiler_win.note_dispatch(loss)
            if measure:
                programs["train_step"] = {"temp_bytes": int(
                    torch.cuda.max_memory_allocated(device) - resident)}
            total = loss if total is None else total + loss
            counted += 1
            pending += 1
            observer.note_progress(phase="train", epoch=epoch, step=i + 1)
            _maybe_test_kill(epoch, i + 1, observer)
            if chaos is not None:
                chaos.on_step(epoch, i + 1)
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
