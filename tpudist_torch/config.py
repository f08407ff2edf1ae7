"""Configuration: the model, data, parallel and training fields the
port's serving and training lanes read, with the JAX package's defaults
(``tpudist/config.py``; BASELINE config #5, the Llama-style transformer,
is ``ModelConfig(name="transformer")``), and the train CLI's
``parse_args``.

The training lane runs over the processes of the JAX package's env
contract (``tpudist_torch.parallel.distributed``), one device a
process, on a data x fsdp x expert x tensor x context mesh; the pipe
axis stays at 1. ``parse_args``
declares every option of the JAX train CLI; those this slice does not
carry (``NOT_CARRIED``) are refused there unless left off, and their
environment twins, with the JAX package's other switches this slice does
not carry (``ENV_NOT_CARRIED``), are refused by :func:`check_supported`
when set: each names the ROADMAP item that brings it, none is silently
ignored. Flags neither package knows are tolerated
(``parse_known_args``), as the JAX CLI tolerates them.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

from tpudist_torch import rules as rules_lib
from tpudist_torch.utils.platform import platform_device


@dataclass(frozen=True)
class DataConfig:
    """Synthetic dataset shape."""

    n_samples: int = 2000
    n_features: int = 20
    seed: int = 42


@dataclass(frozen=True)
class ModelConfig:
    """Model selection and shape. ``mlp`` is the parity model,
    ``transformer`` the Llama-style block stack, ``moe`` the same blocks
    with a mixture-of-experts FFN."""

    name: str = "mlp"
    n_features: int = 20
    hidden: int = 64
    # transformer-only fields
    vocab_size: int = 32000
    n_layers: int = 4
    d_model: int = 2048
    n_heads: int = 16
    n_kv_heads: int = 16
    d_ff: int = 5504
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    # moe-only fields (``moe``: transformer blocks whose FFN half is a
    # top-k routed mixture of experts)
    n_experts: int = 8
    expert_top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_group_size: int = 4096    # routing group (bounds dispatch memory)


# context parallelism's attention: the zigzag ring or Ulysses all-to-alls
CP_IMPLS = ("ring", "ulysses")


@dataclass(frozen=True)
class ParallelConfig:
    """Mesh axis sizes. ``data`` is -1, "all remaining devices": the
    world size over the other axes, one device a process; the port runs
    the pipe axis at 1."""

    data: int = -1
    pipe: int = 1
    fsdp: int = 1
    expert: int = 1
    tensor: int = 1
    context: int = 1


@dataclass(frozen=True)
class TrainConfig:
    """Top-level training config (the subset of the JAX package's
    ``TrainConfig`` the per-step train path reads, plus ``device``)."""

    batch_size: int = 64          # GLOBAL batch size
    epochs: int = 5
    lr: float = 1e-3
    seed: int = 42
    save_dir: str = "ckpt"
    resume: Any = False           # False | "latest" | "auto"
    ckpt_every_steps: int = 0     # also save mid-epoch every N steps
    grad_accum_steps: int = 1
    dtype: str = "float32"        # compute dtype: float32 | bfloat16
    adam_nu_dtype: str = "float32"
    remat: bool = False           # checkpoint transformer layers
    xent_chunks: int = 0
    fused_xent: bool = False
    lm_head: str = "auto"         # auto | plain | chunked | fused
    cp_impl: str = "ring"         # context parallelism: ring | ulysses
    # the data-parallel gradient mean's schedule (parallel.overlap):
    # off | bucketed, the bucket bound in MB, flat | hierarchical; None =
    # $TPUDIST_GRAD_OVERLAP / _GRAD_BUCKET_MB / _CROSS_SLICE, else off, 4
    # and flat (resolve_grad_overlap, resolve_cross_slice)
    grad_overlap: Optional[str] = None
    grad_bucket_mb: Optional[float] = None
    cross_slice: Optional[str] = None
    fail_at: Optional[int] = None  # fault injection: fail after this epoch
    log_every: int = 100
    steps_per_dispatch: int = 0   # 0 = auto (resolve_steps_per_dispatch)
    staging_budget_mb: Optional[float] = None  # per-device MB of batch
    # slabs; None = $TPUDIST_STAGING_BUDGET_MB, else auto
    # (resolve_staging_budget_bytes)
    compilation_cache_dir: Optional[str] = None  # the kernels' build
    # root (ops/cuda/build.py); None = $TPUDIST_COMPILATION_CACHE_DIR,
    # else build/tpudist_torch
    autotune: Optional[str] = None  # off | probe | cache-only
    autotune_cache_dir: Optional[str] = None  # tuning-cache directory
    autotune_trials: int = 0      # probe-trial budget; 0 = auto
    # observability (tpudist_torch.obs), on by default: None =
    # $TPUDIST_<NAME>, else the default (resolve_trace, resolve_obs)
    trace: Optional[str] = None   # on | off: the span tracer
    trace_dir: Optional[str] = None  # trace.worker<i>.json, pod_trace.json
    stall_timeout_s: Optional[float] = None  # watchdog window; 0 = off
    heartbeat_dir: Optional[str] = None  # heartbeat / flightrec dir
    hbm_sample_s: Optional[float] = None  # sampler period; 0 = off
    # the live telemetry bus (tpudist_torch.obs.live, resolve_live): on |
    # off (None = $TPUDIST_LIVE, else off), the coordinator's exporter
    # port (0 = $TPUDIST_LIVE_PORT, else ephemeral) and the ingest
    # endpoint workers ship to (None = $TPUDIST_LIVE_ENDPOINT, else the
    # coordinator loops back over an ephemeral port)
    live: Optional[str] = None
    live_port: int = 0
    live_endpoint: Optional[str] = None
    # device-time capture (tpudist_torch.obs.devtime): a full-run
    # torch.profiler trace into <profile_dir>/worker<i>, or N mid-run
    # dispatches (resolve_profile_window; 0 = $TPUDIST_PROFILE_WINDOW,
    # else off) ingested into kind=devtime at run end
    profile_dir: Optional[str] = None
    profile_window: int = 0
    # the checkpoint layout (resolve_ckpt_mode) and its write mode
    ckpt_mode: Optional[str] = None  # orbax | sharded; None = env, orbax
    ckpt_sync: bool = False       # synchronous writes (async by default)
    requeue_attempt: int = 0      # which requeued rerun this is
    chaos: Optional[str] = None   # fault plan (tpudist_torch.chaos)
    device: Optional[str] = None  # None = cuda
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    parallel: ParallelConfig = dataclasses.field(
        default_factory=ParallelConfig)


RESUME_MODES = ("latest", "auto")

# The JAX train CLI's options this slice does not carry: option string;
# its argparse keywords (type, choices, the JAX default); the values
# besides the default that leave the feature off in the JAX package; the
# environment variable that package reads when the option is not given;
# the ROADMAP Queue A item that brings it. parse_args refuses any other
# value, check_supported any other setting of the variable.
NOT_CARRIED = (
    ("--pp-microbatches", dict(type=int, default=0), (), None, "8b"),
    ("--pipeline-interleave", dict(type=int, default=0), (1,),
     "TPUDIST_PIPELINE_INTERLEAVE", "8b"),
)

# The environment variables the JAX package reads for what this slice does
# not carry (the twins of NOT_CARRIED, and a switch of its own): the
# values that leave each off there, and the Queue A item that brings it
# (None: no item does; the port's attention always takes its flash
# kernels).
ENV_NOT_CARRIED = {
    **{env: ((kw.get("default"), *off), item)
       for _, kw, off, env, item in NOT_CARRIED if env},
    "TPUDIST_NO_FLASH": ((), None),
}


def _is_off(value: Any, off: Sequence[Any]) -> bool:
    """Is ``value`` (typed, or a string from the environment) one of
    ``off``? Numbers compare as numbers, words case-blind."""
    if isinstance(value, str):
        try:
            value = float(value)
        except ValueError:
            value = value.lower()
    return value in off


def _refusal(what: str, item: Optional[Any]) -> ValueError:
    if item is None:
        return ValueError(
            f"{what}: the port does not carry it; its attention always "
            f"takes the flash kernels")
    return ValueError(
        f"{what}: the port does not carry it yet; it comes with ROADMAP "
        f"Queue A item {item}")


def resolve_resume(cfg: TrainConfig) -> Optional[str]:
    """``--resume`` as a concrete mode or None (off): ``True`` means
    ``latest``, which raises when the newest checkpoint cannot drive this
    run; ``auto`` degrades a failed restore to a fresh start."""
    r = cfg.resume
    if not r:
        return None
    if r is True:
        return "latest"
    if r not in RESUME_MODES:
        raise ValueError(
            f"--resume must be one of {RESUME_MODES}, got {r!r}")
    return r


# The checkpoint layouts: ``orbax``, the default and the JAX package's
# word for its step-keyed manager, is the port's own step-directory
# format (tpudist_torch.checkpoint: one torch.save file a step);
# ``sharded`` is tpudist_torch.elastic.ckpt's per-worker shard files and
# atomically committed manifest, the JAX package's layout key for key.
CKPT_MODES = ("orbax", "sharded")


def resolve_ckpt_mode(cfg: TrainConfig) -> str:
    """``--ckpt-mode`` / ``TPUDIST_CKPT_MODE`` as the concrete layout, as
    the JAX package's ``config.resolve_ckpt_mode``: ``orbax`` (the port's
    step directories) or ``sharded`` (shard files + manifest, the layout
    an elastic resume reads). ``--ckpt-sync`` composes with either."""
    mode = cfg.ckpt_mode
    if mode is None:
        mode = os.environ.get("TPUDIST_CKPT_MODE") or "orbax"
    if mode not in CKPT_MODES:
        raise ValueError(
            f"--ckpt-mode must be one of {CKPT_MODES}, got {mode!r}")
    if mode == "sharded" and "://" in cfg.save_dir:
        raise ValueError(
            f"--ckpt-mode sharded writes plain files on a pod-shared "
            f"filesystem and cannot target {cfg.save_dir!r}; keep "
            f"--ckpt-mode orbax for remote URIs (or mount the bucket)")
    return mode


def resolve_chaos(cfg: TrainConfig) -> Optional[str]:
    """``--chaos`` / ``TPUDIST_CHAOS`` as the raw fault-plan spec, or None
    (no chaos plane). ``ChaosPlan.parse`` validates it at run start."""
    return cfg.chaos or os.environ.get("TPUDIST_CHAOS") or None


def resolve_requeue_attempt(cfg: TrainConfig) -> int:
    """Which requeued rerun this is: the flag, else
    ``TPUDIST_REQUEUE_ATTEMPT``, else 0."""
    if cfg.requeue_attempt:
        return int(cfg.requeue_attempt)
    env = _env_float("TPUDIST_REQUEUE_ATTEMPT")
    return int(env) if env and env > 0 else 0


# The gradient overlap plane (tpudist_torch.parallel.overlap): the DP
# all-reduce schedule knob and its bucket bound, and the cross-slice
# reduce. The vocabularies and the default bucket equal overlap's (a
# test pins them); kept here so config imports nothing of torch.
GRAD_OVERLAP_MODES = ("off", "bucketed")
GRAD_BUCKET_MB_DEFAULT = 4.0
CROSS_SLICE_MODES = ("flat", "hierarchical")


def resolve_grad_overlap(cfg: TrainConfig) -> Tuple[str, int]:
    """``--grad-overlap`` / ``--grad-bucket-mb`` as the concrete ``(mode,
    bucket_bytes)`` the replicated data-parallel step dispatches on.
    Precedence a knob: flag > ``TPUDIST_GRAD_OVERLAP`` /
    ``TPUDIST_GRAD_BUCKET_MB`` > default (off, 4 MB). A sharded mesh
    refuses ``bucketed`` (``engine.grad_overlap``)."""
    mode = cfg.grad_overlap
    if mode is None:
        mode = os.environ.get("TPUDIST_GRAD_OVERLAP") or "off"
    if mode not in GRAD_OVERLAP_MODES:
        raise ValueError(
            f"--grad-overlap must be one of {GRAD_OVERLAP_MODES}, "
            f"got {mode!r}")
    mb = cfg.grad_bucket_mb
    if mb is None:
        mb = _env_float("TPUDIST_GRAD_BUCKET_MB")
    if mb is None:
        mb = GRAD_BUCKET_MB_DEFAULT
    if mb <= 0:
        raise ValueError(f"--grad-bucket-mb must be > 0, got {mb}")
    return mode, int(mb * 2**20)


def resolve_cross_slice(cfg: TrainConfig) -> str:
    """``--cross-slice`` as the concrete cross-slice reduce schedule.
    Precedence: flag > ``TPUDIST_CROSS_SLICE`` > flat. A sharded mesh
    refuses ``hierarchical``; a one-slice data axis downgrades it to flat
    with a logged line (``engine.grad_overlap``)."""
    mode = cfg.cross_slice
    if mode is None:
        mode = os.environ.get("TPUDIST_CROSS_SLICE") or "flat"
    if mode not in CROSS_SLICE_MODES:
        raise ValueError(
            f"--cross-slice must be one of {CROSS_SLICE_MODES}, "
            f"got {mode!r}")
    return mode


def check_supported(cfg: TrainConfig) -> None:
    """Refuse what this slice of the port does not carry, naming the
    ROADMAP item (Queue A) that brings it, and an expert axis for a
    model that is not the MoE, as the JAX package refuses it."""
    p = cfg.parallel
    if p.pipe != 1:
        raise ValueError(
            f"--pipe {p.pipe}: the port trains on the data x fsdp x expert "
            f"x tensor x context mesh only; the pipe axis comes with "
            f"ROADMAP Queue A item 8b")
    if p.expert > 1 and cfg.model.name != "moe":
        # the JAX package's refusal (tpudist/engine.py:268-273): without
        # expert-sharded weights the axis silently replicates all compute
        # — half the slice doing duplicate work is a config error
        raise ValueError(f"--expert > 1 requires --model moe; "
                         f"{cfg.model.name!r} has no expert-sharded params")
    for name, (off, item) in ENV_NOT_CARRIED.items():
        value = os.environ.get(name, "")
        if value and not _is_off(value, off):
            raise _refusal(f"{name}={value}", item)


# auto superstep cap: past ~32 steps per dispatch the per-dispatch
# overhead is already amortised to noise and longer supersteps only delay
# log/fence boundaries
SUPERSTEP_CAP = 32


def resolve_steps_per_dispatch(cfg: TrainConfig) -> int:
    """Resolve/validate ``--steps-per-dispatch`` to the concrete superstep
    length ``k`` for this run, as the JAX package's
    ``config.resolve_steps_per_dispatch`` does.

    The train loop only fences and logs at superstep edges, so ``k`` must
    divide ``--log-every`` and ``--ckpt-every-steps`` (when enabled):
    boundaries then land exactly on superstep edges and the logged
    loss/step stream is indistinguishable from per-step dispatch. An
    explicit ``k`` violating that is a config error, as is ``k > 1``
    combined with ``--fail-at`` (fault-injection timing is defined in
    per-step terms).

    Auto (``0``) picks 1 under ``--log-every 1``, full-run profiling
    (``--profile-dir``) or fault injection (each wants true per-step
    dispatch), else the largest divisor of the log/ckpt intervals <=
    :data:`SUPERSTEP_CAP`. The
    epoch's trailing partial superstep is not a config concern: its
    steps past the epoch are masked (``engine.make_superstep``).
    """
    k = cfg.steps_per_dispatch
    if k < 0:
        raise ValueError(
            f"--steps-per-dispatch must be >= 1 (or 0 = auto), got {k}")
    if k == 0:
        if cfg.profile_dir or cfg.fail_at is not None or cfg.log_every == 1:
            return 1
        cap = SUPERSTEP_CAP if cfg.log_every <= 0 else min(cfg.log_every,
                                                           SUPERSTEP_CAP)
        best = 1
        for d in range(1, cap + 1):
            if cfg.log_every > 0 and cfg.log_every % d:
                continue
            if cfg.ckpt_every_steps and cfg.ckpt_every_steps % d:
                continue
            best = d
        return best
    if k > 1:
        if cfg.fail_at is not None:
            raise ValueError(
                f"--steps-per-dispatch {k} with --fail-at: fault injection "
                f"must observe per-step/epoch boundaries; use "
                f"--steps-per-dispatch 1")
        if cfg.log_every > 0 and cfg.log_every % k:
            raise ValueError(
                f"--steps-per-dispatch {k} must divide --log-every "
                f"{cfg.log_every} so logging boundaries land on superstep "
                f"edges")
        if cfg.ckpt_every_steps and cfg.ckpt_every_steps % k:
            raise ValueError(
                f"--steps-per-dispatch {k} must divide --ckpt-every-steps "
                f"{cfg.ckpt_every_steps} so checkpoint boundaries land on "
                f"superstep edges")
    return k


# Auto staging budget: leave the train state (params + opt moments) plus
# this multiple of it for grads / activations / workspace, then stage
# batches into half of what remains (the other half is slack for the
# allocator: device memory figures are an estimate, not a reservation).
# The floor keeps the budget positive when the 4x estimate exceeds the
# device's memory: a zero budget would make plan_slabs reject every epoch.
STAGING_STATE_HEADROOM = 4.0
STAGING_FREE_FRACTION = 0.5
STAGING_FLOOR_FRACTION = 0.05


def resolve_staging_budget_bytes(cfg: TrainConfig, *, state_bytes: int = 0,
                                 hbm_bytes: Optional[float] = None,
                                 program_temp_bytes: Optional[int] = None
                                 ) -> Optional[int]:
    """Resolve ``--staging-budget-mb`` to a per-device byte budget for
    epoch staging (``parallel.staging.plan_slabs``), or ``None`` for
    "unbounded" (always the full-epoch fast path), as the JAX package's
    ``config.resolve_staging_budget_bytes`` does.

    Precedence: explicit flag > ``TPUDIST_STAGING_BUDGET_MB`` > auto.
    Auto derives from the device's memory minus the train state and its
    working margin: ``state + program_temp_bytes`` when a prior run
    measured the programs' scratch, else ``STAGING_STATE_HEADROOM x
    state`` (the port has no memory ledger yet, so its train loop passes
    None and takes the heuristic). The budget only moves slab cut
    points, which the superstep's ``[lo, hi)`` masking keeps
    loss-invariant."""
    mb = cfg.staging_budget_mb
    if mb is None:
        env = os.environ.get("TPUDIST_STAGING_BUDGET_MB")
        if env:
            mb = float(env)
    if mb is not None:
        if mb <= 0:
            raise ValueError(
                f"--staging-budget-mb must be > 0, got {mb}")
        return int(mb * 2**20)
    if hbm_bytes is None:
        return None
    if program_temp_bytes is not None and program_temp_bytes >= 0:
        margin = state_bytes + program_temp_bytes
    else:
        margin = STAGING_STATE_HEADROOM * state_bytes
    free = max(hbm_bytes - margin, hbm_bytes * STAGING_FLOOR_FRACTION)
    return int(free * STAGING_FREE_FRACTION)


# Autotune (tpudist_torch.tune): the measured-probe search that replaces
# the two resolve_* heuristics above with a measurement when enabled. The
# heuristics stay as the search's START point and its never-regress
# floor.
AUTOTUNE_MODES = ("off", "probe", "cache-only")
AUTOTUNE_DEFAULT_TRIALS = 12


def _env_float(name: str) -> Optional[float]:
    """Optional float env var; a malformed value reads as unset (the JAX
    package's ``config._env_float``)."""
    raw = os.environ.get(name)
    if not raw:
        return None
    try:
        return float(raw)
    except ValueError:
        return None


def resolve_autotune(cfg: TrainConfig) -> str:
    """Resolve ``--autotune`` / ``TPUDIST_AUTOTUNE`` to a concrete mode, as
    the JAX package's ``config.resolve_autotune`` does.

    ``probe`` measures on a cache miss; ``cache-only`` reuses a prior
    measurement but never probes. Fault injection and full-run profiling
    (``--profile-dir``) force ``off``: both are defined in
    per-step-dispatch terms, so every knob the tuner searches is already
    pinned. The windowed capture (``--profile-window``) does not: it
    profiles whatever operating point the run uses, tuned or not.
    """
    mode = cfg.autotune
    if mode is None:
        mode = os.environ.get("TPUDIST_AUTOTUNE") or "off"
    if mode not in AUTOTUNE_MODES:
        raise ValueError(
            f"--autotune must be one of {AUTOTUNE_MODES}, got {mode!r}")
    if mode != "off" and (cfg.fail_at is not None or cfg.profile_dir):
        return "off"
    return mode


def resolve_profile_window(cfg: TrainConfig) -> int:
    """Resolve ``--profile-window`` / ``TPUDIST_PROFILE_WINDOW`` to the
    number of mid-run dispatches to capture (0 = off), as the JAX
    package's ``config.resolve_profile_window``.

    Precedence: explicit flag > env > 0. Full-run ``--profile-dir``
    wins over the window (profiler sessions cannot nest — the whole
    run is already inside one), so the window resolves to 0 there.
    """
    n = cfg.profile_window
    if n < 0:
        raise ValueError(
            f"--profile-window must be >= 0, got {n}")
    if n == 0:
        env = _env_float("TPUDIST_PROFILE_WINDOW")
        n = int(env) if env and env > 0 else 0
    if cfg.profile_dir:
        return 0
    return n


def resolve_autotune_cache_dir(cfg: TrainConfig) -> str:
    """Precedence: flag > ``TPUDIST_AUTOTUNE_CACHE_DIR`` > a ``tune/``
    subdir of ``save_dir`` (next to metrics.jsonl)."""
    return (cfg.autotune_cache_dir
            or os.environ.get("TPUDIST_AUTOTUNE_CACHE_DIR")
            or os.path.join(cfg.save_dir, "tune"))


def resolve_autotune_trials(cfg: TrainConfig) -> int:
    """Probe-trial budget: flag > ``TPUDIST_AUTOTUNE_TRIALS`` > 12."""
    if cfg.autotune_trials < 0:
        raise ValueError(
            f"--autotune-trials must be >= 0, got {cfg.autotune_trials}")
    if cfg.autotune_trials:
        return cfg.autotune_trials
    env = _env_float("TPUDIST_AUTOTUNE_TRIALS")
    return int(env) if env and env > 0 else AUTOTUNE_DEFAULT_TRIALS


# Span tracing (tpudist_torch.obs.trace): on by default, as in the JAX
# package; --trace off / TPUDIST_TRACE=off is the escape hatch.
TRACE_MODES = ("on", "off")


def resolve_trace(cfg) -> Tuple[bool, str]:
    """The span tracer's knobs as ``(enabled, trace_dir)``, as the JAX
    package's ``config.resolve_trace``: flag > env > default (on,
    ``save_dir``). ``TPUDIST_TRACE`` takes the falsy spellings
    off/0/false/no, read by the tracer's own ``_env_enabled``. The serve
    CLI's namespace resolves through here too."""
    from tpudist_torch.obs.trace import _env_enabled
    mode = cfg.trace
    if mode is None:
        mode = "on" if _env_enabled() else "off"
    if mode not in TRACE_MODES:
        raise ValueError(
            f"--trace must be one of {TRACE_MODES}, got {mode!r}")
    out_dir = (cfg.trace_dir or os.environ.get("TPUDIST_TRACE_DIR")
               or cfg.save_dir)
    return mode == "on", out_dir


# The flight recorder's defaults: the stall window (rules.STALL_TIMEOUT_S,
# 300 s) outlasts a cold build of the kernels and the graph captures
# while still firing inside a launcher's outer timeout; the HBM sampler
# reads every 2 s.
OBS_STALL_TIMEOUT_S = rules_lib.STALL_TIMEOUT_S
OBS_HBM_SAMPLE_S = 2.0


def resolve_obs(cfg: TrainConfig) -> Tuple[float, str, float]:
    """The flight recorder's knobs as ``(stall_timeout_s, out_dir,
    hbm_sample_s)``, as the JAX package's ``config.resolve_obs``: flag >
    env > default per knob. A malformed env value reads as unset; a
    negative window or period is an error. The beacon and flight-record
    directory defaults to ``save_dir``, next to ``metrics.jsonl``."""
    stall = cfg.stall_timeout_s
    if stall is None:
        stall = _env_float("TPUDIST_STALL_TIMEOUT_S")
    if stall is None:
        stall = OBS_STALL_TIMEOUT_S
    if stall < 0:
        raise ValueError(f"--stall-timeout-s must be >= 0, got {stall}")
    out_dir = (cfg.heartbeat_dir or os.environ.get("TPUDIST_HEARTBEAT_DIR")
               or cfg.save_dir)
    hbm_s = cfg.hbm_sample_s
    if hbm_s is None:
        hbm_s = _env_float("TPUDIST_HBM_SAMPLE_S")
    if hbm_s is None:
        hbm_s = OBS_HBM_SAMPLE_S
    if hbm_s < 0:
        raise ValueError(f"--hbm-sample-s must be >= 0, got {hbm_s}")
    return stall, out_dir, hbm_s


# Live telemetry (tpudist_torch.obs.live): off by default — unlike the
# span tracer it opens sockets and threads, which a bare acceptance run
# should not do unless an operator (or the launcher) asked for the view.
LIVE_MODES = ("on", "off")


def resolve_live(cfg: TrainConfig) -> Tuple[bool, int, Optional[str]]:
    """Resolve the live-telemetry knobs to ``(enabled, exporter_port,
    ingest_endpoint)``, as the JAX package's ``config.resolve_live``.

    Precedence per knob: explicit flag > env var > default (off, 0 =
    ephemeral exporter port, no endpoint). ``TPUDIST_LIVE`` accepts the
    usual truthy/falsy spellings so launchers can switch the bus
    pod-wide without touching per-worker argv; ``TPUDIST_LIVE_ENDPOINT``
    is how the launcher tells every worker where the coordinator's
    aggregator listens (``[tcp://|udp://]host:port``) — without it a
    single-host run loops back over an ephemeral loopback port, which
    exercises the same socket path a pod does."""
    mode = cfg.live
    if mode is None:
        raw = (os.environ.get("TPUDIST_LIVE") or "off").lower()
        mode = "off" if raw in ("", "off", "0", "false", "no") else "on"
    if mode not in LIVE_MODES:
        raise ValueError(
            f"--live must be one of {LIVE_MODES}, got {mode!r}")
    port = cfg.live_port
    if port < 0:
        raise ValueError(f"--live-port must be >= 0, got {port}")
    if port == 0:
        env = _env_float("TPUDIST_LIVE_PORT")
        port = int(env) if env and env > 0 else 0
    endpoint = (cfg.live_endpoint
                or os.environ.get("TPUDIST_LIVE_ENDPOINT") or None)
    return mode == "on", port, endpoint


def flagship_model_config(max_seq_len: int = 512) -> ModelConfig:
    """BASELINE config #5: the synthetic Llama-block transformer (4
    layers, 2048 hidden, 16 heads, SwiGLU 5504)."""
    return ModelConfig(name="transformer", vocab_size=32000, n_layers=4,
                       d_model=2048, n_heads=16, n_kv_heads=16, d_ff=5504,
                       max_seq_len=max_seq_len)


def parse_args(argv: Optional[Sequence[str]] = None) -> TrainConfig:
    """CLI -> TrainConfig, the JAX CLI's flags and defaults. Unknown
    flags are tolerated; a flag this slice does not carry
    (``NOT_CARRIED``) is refused with a ``ValueError`` unless its value
    leaves the feature off."""
    p = argparse.ArgumentParser(
        prog="python -m tpudist_torch.train",
        description="tpudist synthetic training workload on PyTorch/CUDA")
    p.add_argument("--train-batch-size", type=int, default=64,
                   help="global batch size")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--save-dir", type=str, default="ckpt")
    p.add_argument("--resume", nargs="?", const="latest", default=False,
                   choices=list(RESUME_MODES),
                   help="resume from the newest checkpoint in --save-dir: "
                        "bare/latest raises when it cannot drive this "
                        "run; auto degrades a failed restore to a fresh "
                        "start")
    p.add_argument("--ckpt-every-steps", type=int, default=0,
                   help="also checkpoint mid-epoch every N steps")
    p.add_argument("--ckpt-sync", action="store_true",
                   help="synchronous checkpoint writes (a writer thread "
                        "overlaps them with the next steps by default)")
    p.add_argument("--ckpt-mode", type=str, default=None,
                   choices=list(CKPT_MODES),
                   help="checkpoint layout: orbax, the port's step "
                        "directories (default), or sharded: per-worker "
                        "shard files + an atomically committed "
                        "manifest.json (tpudist_torch.elastic) (default: "
                        "$TPUDIST_CKPT_MODE, else orbax)")
    p.add_argument("--requeue-attempt", type=int, default=0,
                   help="which auto-requeue rerun this is (the launcher "
                        "passes it; lands in the kind=resume record and "
                        "the tpudist: resume line; default: "
                        "$TPUDIST_REQUEUE_ATTEMPT, else 0)")
    p.add_argument("--chaos", type=str, default=None,
                   help="scripted fault-injection plan (tpudist_torch."
                        "chaos): ';'-separated <fault>@<epoch>:<step>"
                        "[:<rank>][,k=v...] events, e.g. "
                        "'corrupt_shard@0:6,mode=flip;kill@0:7' "
                        "(default: $TPUDIST_CHAOS, else off)")
    p.add_argument("--model", type=str, default="mlp",
                   choices=["mlp", "transformer", "moe"])
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--grad-accum-steps", type=int, default=1)
    p.add_argument("--adam-nu-dtype", type=str, default="float32",
                   choices=("float32", "bfloat16"))
    p.add_argument("--remat", action="store_true",
                   help="recompute transformer layers in backward")
    p.add_argument("--xent-chunks", type=int, default=0)
    p.add_argument("--lm-head", type=str, default="auto",
                   choices=("auto", "plain", "chunked", "fused"),
                   help="LM-head strategy; auto picks from the logits-pair "
                        "+ activation memory estimate")
    p.add_argument("--fused-xent", action="store_true")
    p.add_argument("--n-samples", type=int, default=2000)
    p.add_argument("--n-features", type=int, default=20)
    p.add_argument("--vocab-size", type=int, default=32000)
    p.add_argument("--n-layers", type=int, default=4)
    p.add_argument("--d-model", type=int, default=2048)
    p.add_argument("--n-heads", type=int, default=16)
    p.add_argument("--n-kv-heads", type=int, default=None)
    p.add_argument("--d-ff", type=int, default=5504)
    p.add_argument("--seq-len", type=int, default=2048)
    # moe shape
    p.add_argument("--n-experts", type=int, default=8)
    p.add_argument("--expert-top-k", type=int, default=2)
    p.add_argument("--capacity-factor", type=float, default=1.25)
    p.add_argument("--router-aux-weight", type=float, default=0.01)
    p.add_argument("--moe-group-size", type=int, default=4096,
                   help="tokens per routing group (bounds dispatch-tensor "
                        "memory; must divide batch*seq or routing falls "
                        "back to one global group)")
    for axis in ("fsdp", "tensor", "context", "pipe", "expert"):
        p.add_argument(f"--{axis}", type=int, default=1,
                       help=f"{axis} mesh axis size")
    p.add_argument("--grad-overlap", type=str, default=None,
                   choices=list(GRAD_OVERLAP_MODES),
                   help="data-parallel gradient all-reduce schedule "
                        "(tpudist_torch.parallel.overlap): off = one "
                        "all-reduce a param after the whole backward, "
                        "bucketed = size-bounded buckets issued as the "
                        "backward produces them, behind the remaining "
                        "backward; bitwise-identical loss either way "
                        "(default: $TPUDIST_GRAD_OVERLAP, else off)")
    p.add_argument("--grad-bucket-mb", type=float, default=None,
                   help="bucket size bound for --grad-overlap bucketed "
                        "(default: $TPUDIST_GRAD_BUCKET_MB, else 4)")
    p.add_argument("--cross-slice", type=str, default=None,
                   choices=list(CROSS_SLICE_MODES),
                   help="cross-slice data-parallel reduce schedule on a "
                        "data axis $TPUDIST_SLICE_MAP splits into slices "
                        "(tpudist_torch.parallel.overlap): flat = the "
                        "whole gradient across slices, hierarchical = "
                        "reduce-scatter in the slice + all-reduce of the "
                        "1/slice_size shard across slices + all-gather "
                        "in the slice; cuts the cross-slice bytes by the "
                        "slice size; bitwise-identical loss either way "
                        "(default: $TPUDIST_CROSS_SLICE, else flat)")
    p.add_argument("--cp-impl", type=str, default="ring",
                   choices=list(CP_IMPLS),
                   help="context-parallel attention (--context > 1): ring "
                        "(zigzag ring attention, flash-kernel hops) or "
                        "ulysses (head<->sequence all-to-alls; heads must "
                        "divide by --context)")
    p.add_argument("--fail-at", type=int, default=None,
                   help="fault injection: fail after this epoch")
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--steps-per-dispatch", type=int, default=0,
                   help="training steps per dispatch (a superstep); 0 = "
                        "auto: the largest divisor of --log-every and "
                        "--ckpt-every-steps up to 32")
    p.add_argument("--staging-budget-mb", type=float, default=None,
                   help="per-device MB for staged batch slabs; epochs "
                        "over it stream in double-buffered slabs "
                        "(default: $TPUDIST_STAGING_BUDGET_MB, else auto)")
    p.add_argument("--compilation-cache-dir", type=str, default=None,
                   help="build root of the CUDA kernel libraries "
                        "(default: $TPUDIST_COMPILATION_CACHE_DIR, else "
                        "build/tpudist_torch); repeat runs load them "
                        "instead of running nvcc again")
    p.add_argument("--autotune", type=str, default=None,
                   choices=list(AUTOTUNE_MODES),
                   help="measured-probe autotuning of the dispatch/"
                        "staging/remat operating point (tpudist_torch."
                        "tune): probe = short on-device trials before the "
                        "timed run (cached by workload fingerprint; the "
                        "second run costs zero probes), cache-only = "
                        "reuse a prior measurement but never probe "
                        "(default: $TPUDIST_AUTOTUNE, else off)")
    p.add_argument("--autotune-cache-dir", type=str, default=None,
                   help="tuning-cache directory (default: "
                        "$TPUDIST_AUTOTUNE_CACHE_DIR, else "
                        "<save-dir>/tune)")
    p.add_argument("--autotune-trials", type=int, default=0,
                   help="probe-trial budget for the autotune search "
                        "(0 = $TPUDIST_AUTOTUNE_TRIALS, else 12)")
    p.add_argument("--trace", type=str, default=None,
                   choices=list(TRACE_MODES),
                   help="host-side span tracing (tpudist_torch.obs."
                        "trace): on by default; run end writes "
                        "trace.worker<i>.json per process and a merged "
                        "Perfetto pod_trace.json on the coordinator "
                        "(default: $TPUDIST_TRACE, else on)")
    p.add_argument("--trace-dir", type=str, default=None,
                   help="directory for trace.worker<i>.json / "
                        "pod_trace.json (default: $TPUDIST_TRACE_DIR, "
                        "else --save-dir)")
    p.add_argument("--stall-timeout-s", type=float, default=None,
                   help="flight-recorder watchdog: no step progress for "
                        "this long dumps thread stacks + memory stats + "
                        "last-N metrics to flightrec.worker<i> (default: "
                        "$TPUDIST_STALL_TIMEOUT_S, else 300; 0 disables "
                        "the watchdog, the beacon stays on)")
    p.add_argument("--heartbeat-dir", type=str, default=None,
                   help="directory for heartbeat.worker<i> beacons and "
                        "flightrec.worker<i> dumps (default: "
                        "$TPUDIST_HEARTBEAT_DIR, else --save-dir)")
    p.add_argument("--hbm-sample-s", type=float, default=None,
                   help="device-memory watermark sampler period in "
                        "seconds; the high-water mark lands in the "
                        "kind=timing record (default: "
                        "$TPUDIST_HBM_SAMPLE_S, else 2.0; 0 disables)")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="write a full-run torch.profiler trace (Kineto "
                        "Chrome trace) on EVERY process, into "
                        "profile-dir/worker<i>; forces per-step dispatch "
                        "and turns autotuning off")
    p.add_argument("--profile-window", type=int, default=0,
                   help="capture N mid-run dispatches with torch.profiler "
                        "on every process (profile/worker<i> under "
                        "--trace-dir) and ingest the device timeline at "
                        "run end: kind=devtime record, device tracks in "
                        "pod_trace.json, comm_status verdict (default: "
                        "$TPUDIST_PROFILE_WINDOW, else 0 = off; "
                        "--profile-dir wins when both are set)")
    p.add_argument("--live", type=str, default=None,
                   choices=list(LIVE_MODES),
                   help="live telemetry bus (tpudist_torch.obs.live): "
                        "non-blocking per-process emitters stream records "
                        "+ heartbeats to a coordinator aggregator that "
                        "runs the on-line alert engine over the same "
                        "thresholds as the exit verdict, rewrites "
                        "live_status.json, and serves Prometheus /metrics "
                        "(default: $TPUDIST_LIVE, else off)")
    p.add_argument("--live-port", type=int, default=0,
                   help="Prometheus exporter port on the coordinator "
                        "(/metrics, /status.json, /healthz; default: "
                        "$TPUDIST_LIVE_PORT, else an ephemeral port)")
    p.add_argument("--live-endpoint", type=str, default=None,
                   help="ingest endpoint workers ship records to "
                        "([tcp://|udp://]host:port; default: "
                        "$TPUDIST_LIVE_ENDPOINT, else the coordinator "
                        "binds loopback on an ephemeral port)")
    p.add_argument("--device", type=str, default=None,
                   choices=("cuda", "cpu"),
                   help="where the model trains ($TPUDIST_PLATFORM: cpu, "
                        "or cuda/gpu); cuda (the default) fails when no "
                        "card is present rather than falling back to the "
                        "CPU")
    for flag, kw, _, _, _ in NOT_CARRIED:
        p.add_argument(flag, **kw)
    args = p.parse_known_args(argv)[0]
    for flag, _, off, _, item in NOT_CARRIED:
        dest = flag[2:].replace("-", "_")
        value = getattr(args, dest)
        if value != p.get_default(dest) and not _is_off(value, off):
            raise _refusal(f"{flag} {value}", item)
    return TrainConfig(
        batch_size=args.train_batch_size,
        epochs=args.epochs,
        lr=args.lr,
        seed=args.seed,
        save_dir=args.save_dir,
        resume=args.resume,
        ckpt_every_steps=args.ckpt_every_steps,
        grad_accum_steps=args.grad_accum_steps,
        dtype=args.dtype,
        adam_nu_dtype=args.adam_nu_dtype,
        remat=args.remat,
        xent_chunks=args.xent_chunks,
        fused_xent=args.fused_xent,
        lm_head=args.lm_head,
        cp_impl=args.cp_impl,
        grad_overlap=args.grad_overlap,
        grad_bucket_mb=args.grad_bucket_mb,
        cross_slice=args.cross_slice,
        fail_at=args.fail_at,
        log_every=args.log_every,
        steps_per_dispatch=args.steps_per_dispatch,
        staging_budget_mb=args.staging_budget_mb,
        compilation_cache_dir=args.compilation_cache_dir,
        autotune=args.autotune,
        autotune_cache_dir=args.autotune_cache_dir,
        autotune_trials=args.autotune_trials,
        trace=args.trace,
        trace_dir=args.trace_dir,
        stall_timeout_s=args.stall_timeout_s,
        heartbeat_dir=args.heartbeat_dir,
        hbm_sample_s=args.hbm_sample_s,
        live=args.live,
        live_port=args.live_port,
        live_endpoint=args.live_endpoint,
        profile_dir=args.profile_dir,
        profile_window=args.profile_window,
        ckpt_mode=args.ckpt_mode,
        ckpt_sync=args.ckpt_sync,
        requeue_attempt=args.requeue_attempt,
        chaos=args.chaos,
        device=platform_device(args.device),
        data=DataConfig(n_samples=args.n_samples,
                        n_features=args.n_features, seed=args.seed),
        model=ModelConfig(name=args.model, n_features=args.n_features,
                          vocab_size=args.vocab_size,
                          n_layers=args.n_layers, d_model=args.d_model,
                          n_heads=args.n_heads,
                          n_kv_heads=(args.n_kv_heads
                                      if args.n_kv_heads is not None
                                      else args.n_heads),
                          d_ff=args.d_ff, max_seq_len=args.seq_len,
                          n_experts=args.n_experts,
                          expert_top_k=args.expert_top_k,
                          capacity_factor=args.capacity_factor,
                          router_aux_weight=args.router_aux_weight,
                          moe_group_size=args.moe_group_size),
        parallel=ParallelConfig(pipe=args.pipe, fsdp=args.fsdp,
                                expert=args.expert, tensor=args.tensor,
                                context=args.context),
    )
