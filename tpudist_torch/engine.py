"""Training engine: state, optimizer, loss, the train step, the
superstep, eval.

Counterpart of ``tpudist/engine.py``'s replicated data-parallel path
(``--grad-overlap off``). The JAX package's state is a pytree and its
step a compiled pure function; here the params are an ``nn.Module``, the
step runs eagerly, and the optimizer updates the params and its moments
in place (one copy of the train state on the device instead of two).
Every process holds the whole state, made alike from one seed; when a
process group is up (``tpudist_torch.parallel.distributed``), the step
means the gradients and the loss over the processes with an explicit
all-reduce after the whole backward: the collective under test.

One step body serves per-step dispatch (:func:`make_train_step`) and the
k-step superstep (:func:`make_superstep`). It reads Adam's per-step
scalars (the step count and the bias corrections) from device tensors
(:class:`StepScalars`) and no host value that changes from step to step,
so on the card the superstep captures it into CUDA graphs and replays
them; on the CPU the superstep runs the body in a loop.
"""

from __future__ import annotations

import functools
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from tpudist_torch.config import TrainConfig
from tpudist_torch.metrics import log0
from tpudist_torch.models import get_model
from tpudist_torch.models import transformer
from tpudist_torch.obs import mfu
from tpudist_torch.ops.cuda import flash_attention as _fa
from tpudist_torch.ops.cuda import fused_xent as _fx


@dataclass
class AdamState:
    count: int                 # steps taken
    mu: List[torch.Tensor]     # first moments, one per param
    nu: List[torch.Tensor]     # second moments, one per param
    # each param's leaf index in the JAX package's params pytree (sorted
    # dict keys): the salt of the bf16 second moment's rounding dither
    salts: List[int] = field(default_factory=list)


@dataclass
class TrainState:
    step: int                  # global step counter
    params: nn.Module
    opt_state: AdamState


def jax_leaf_order(names: Sequence[str]) -> List[int]:
    """Each ``state_dict`` name's index among ``jax.tree.flatten``'s
    leaves of the JAX package's nested params dict, whose keys flatten
    sorted at every level (``embed``, ``final_norm``, ``layers.*``)."""
    order = sorted(range(len(names)), key=lambda i: names[i].split("."))
    rank = [0] * len(names)
    for leaf, i in enumerate(order):
        rank[i] = leaf
    return rank


def _stochastic_round_bf16(x: torch.Tensor, count,
                           salt: int) -> torch.Tensor:
    """f32 -> bf16 with stochastic rounding, bitwise the JAX package's
    ``_stochastic_round_bf16``: add a uniform dither in [0, ulp) to the
    low 16 bits of the f32 pattern, then truncate. Unbiased, which is what
    lets a bf16-stored EMA track sub-ulp updates that round-to-nearest
    would drop. The dither is a murmur-style hash of (flat element index,
    step count, salt) on uint32, computed here in int64 with every
    product and sum masked to its low 32 bits (exact under int64
    wraparound). ``count`` is an int or a 0-dim int64 tensor (the
    device-side step count a captured step reads)."""
    m32 = 0xFFFFFFFF
    bits = x.to(torch.float32).contiguous().view(torch.int32).to(
        torch.int64) & m32
    idx = torch.arange(x.numel(), dtype=torch.int64,
                       device=x.device).reshape(x.shape)
    h = (idx * 0x9E3779B1) & m32
    h = (h + ((count & m32) * 0x85EBCA6B & m32)
         + (salt * 0xC2B2AE35 & m32)) & m32
    h = h ^ (h >> 15)
    h = (h * 0x27D4EB2F) & m32
    h = h ^ (h >> 13)
    bits = (bits + (h >> 16)) & 0xFFFF0000
    # back to the int32 pattern (two's complement) and its f32 value; the
    # low 16 bits are zero, so the bf16 cast is exact
    bits = torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32)
    return bits.view(torch.float32).to(torch.bfloat16)


class Adam:
    """optax ``adam(lr, mu_dtype=...)`` over a list of params, updating
    them and the moments in place. The update runs in f32 in optax's
    order: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu, then
    (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) times -lr; mu is
    stored in ``mu_dtype`` (bf16 under mixed precision) after the update
    has used its f32 value. f32 runs give ``torch.optim.Adam``'s math.

    ``nu_bf16`` is the JAX package's ``_adam_low_precision_nu``: the same
    math in f32 in that function's order (mu = b1 mu + (1 - b1) g, nu =
    b2 nu + (1 - b2) g g, update -lr (mu / c1) / (sqrt(nu / c2) + eps)),
    with nu stored bf16 by :func:`_stochastic_round_bf16` (salted by the
    state's ``salts``) and upcast at use."""

    def __init__(self, lr: float, *, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, mu_dtype: Optional[torch.dtype] = None,
                 nu_bf16: bool = False):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu_dtype = mu_dtype
        self.nu_bf16 = nu_bf16

    def init(self, params: Sequence[torch.Tensor],
             names: Sequence[str]) -> AdamState:
        """Zero moments for ``params``, whose ``state_dict`` names are
        ``names``; the salts are their JAX leaf indices
        (:func:`jax_leaf_order`)."""
        return AdamState(
            count=0,
            mu=[torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                for p in params],
            nu=[torch.zeros_like(p, dtype=(torch.bfloat16 if self.nu_bf16
                                           else p.dtype)) for p in params],
            salts=jax_leaf_order(names))

    @torch.no_grad()
    def apply(self, grads: Sequence[torch.Tensor], state: AdamState,
              params: Sequence[torch.Tensor], count: torch.Tensor,
              c1: torch.Tensor, c2: torch.Tensor) -> None:
        """One update in place from the step's device scalars
        (:meth:`StepScalars.row`): its count and the bias corrections
        ``c1 = 1 - b1^count``, ``c2 = 1 - b2^count``. The host's
        ``state.count`` is left to the caller, so a captured step reads
        no host value."""
        b1, b2 = self.b1, self.b2
        for i, (p, g, mu, nu) in enumerate(zip(params, grads, state.mu,
                                               state.nu)):
            if self.nu_bf16:
                g = g.to(torch.float32)
                m = b1 * mu.to(torch.float32) + (1 - b1) * g
                v = b2 * nu.to(torch.float32) + (1 - b2) * g * g
                p.add_((-self.lr * (m / c1)) / (torch.sqrt(v / c2)
                                                + self.eps))
                nu.copy_(_stochastic_round_bf16(v, count, state.salts[i]))
                mu.copy_(m)
                continue
            # optax's b1 * mu takes b1 in mu's dtype (JAX weak typing:
            # 0.8984375 for a bf16 mu) and, jitted as the JAX trainer
            # runs it, keeps the product in f32
            b1_mu = float(torch.tensor(b1, dtype=mu.dtype))
            m = (1 - b1) * g + b1_mu * mu.to(torch.float32)
            nu.copy_((1 - b2) * (g * g) + b2 * nu)
            p.add_(-self.lr * ((m / c1) / (torch.sqrt(nu / c2) + self.eps)))
            mu.copy_(m)

    def update(self, grads: Sequence[torch.Tensor], state: AdamState,
               params: Sequence[torch.Tensor]) -> AdamState:
        """One update from the host's count: step ``state.count + 1``'s
        scalars on the params' device, :meth:`apply`, and the count
        advanced."""
        scalars = StepScalars(self, 1, params[0].device)
        scalars.fill(state.count + 1)
        self.apply(grads, state, params, *scalars.row(0))
        state.count += 1
        return state


class StepScalars:
    """Adam's per-step scalars on the device for the ``n`` steps of one
    dispatch: the step count (int64; the bf16 second moment's rounding
    hash reads it) and the bias corrections ``(1 - b1^t, 1 - b2^t)`` in
    f32. The host computes them as optax does (numpy f32, one step at a
    time) and copies them in before each dispatch, from pinned memory
    without a host sync on the card, so per-step dispatch, the CPU
    superstep and a captured graph read one source and stay bitwise
    equal; a graph reads them from these fixed addresses at replay."""

    def __init__(self, tx: Adam, n: int, device: torch.device):
        self.b1, self.b2 = tx.b1, tx.b2
        self.count = torch.zeros((n,), dtype=torch.int64, device=device)
        self.corr = torch.ones((n, 2), dtype=torch.float32, device=device)

    def fill(self, first: int, n: Optional[int] = None) -> None:
        """Rows ``0 .. n-1`` (every row by default) <- the scalars of the
        step counts ``first, first + 1, ...``."""
        n = self.count.shape[0] if n is None else n
        counts = np.arange(first, first + n, dtype=np.int64)
        b1, b2 = np.float32(self.b1), np.float32(self.b2)
        corr = np.array([(1 - b1 ** np.float32(t), 1 - b2 ** np.float32(t))
                         for t in counts], dtype=np.float32).reshape(n, 2)
        cuda = self.count.is_cuda
        for dst, src in ((self.count, counts), (self.corr, corr)):
            src = torch.from_numpy(src)
            dst[:n].copy_(src.pin_memory() if cuda else src,
                          non_blocking=cuda)

    def row(self, i: int) -> Tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
        """Step ``i``'s ``(count, c1, c2)``, 0-dim views."""
        return self.count[i], self.corr[i, 0], self.corr[i, 1]


def make_optimizer(cfg: TrainConfig) -> Adam:
    """Adam; under ``--dtype bfloat16`` the first moment is stored bf16
    (the JAX package's optax ``mu_dtype``); ``--adam-nu-dtype bfloat16``
    stores the second moment bf16 with stochastic rounding."""
    return Adam(cfg.lr, mu_dtype=(torch.bfloat16 if cfg.dtype == "bfloat16"
                                  else None),
                nu_bf16=cfg.adam_nu_dtype == "bfloat16")


def _compute_dtype(cfg: TrainConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _device_hbm_bytes(device: Optional[torch.device] = None) -> float:
    """Device memory for the head policy: ``TPUDIST_HBM_BYTES`` (tests pin
    it), else the card's total memory, else 16 GB (the JAX package's
    default for backends that report none, such as the CPU)."""
    env = os.environ.get("TPUDIST_HBM_BYTES")
    if env:
        return float(env)
    if device is not None and device.type == "cuda":
        return float(torch.cuda.mem_get_info(device)[1])
    return 16e9


def _resolve_lm_head(cfg: TrainConfig,
                     device: Optional[torch.device] = None
                     ) -> Tuple[bool, int]:
    """cfg.lm_head -> concrete (fused_xent, xent_chunks), the JAX
    package's rules: a forced mode with a contradictory explicit flag is
    an error; ``plain`` is (False, 0), ``fused`` (True, 0), ``chunked``
    (False, --xent-chunks or 4); ``auto`` honours an explicit
    --fused-xent/--xent-chunks, else asks :func:`_auto_lm_head`."""
    if cfg.lm_head != "auto":
        if cfg.lm_head == "plain" and (cfg.fused_xent or cfg.xent_chunks):
            raise ValueError(
                "--lm-head plain contradicts --fused-xent/--xent-chunks")
        if cfg.lm_head == "fused" and cfg.xent_chunks:
            raise ValueError("--lm-head fused contradicts --xent-chunks")
        if cfg.lm_head == "chunked" and cfg.fused_xent:
            raise ValueError("--lm-head chunked contradicts --fused-xent")
    if cfg.lm_head == "plain":
        return False, 0
    if cfg.lm_head == "fused":
        return True, 0
    if cfg.lm_head == "chunked":
        return False, cfg.xent_chunks or 4
    if cfg.lm_head != "auto":
        raise ValueError(f"unknown --lm-head {cfg.lm_head!r}")
    if cfg.fused_xent or cfg.xent_chunks:
        return cfg.fused_xent, cfg.xent_chunks
    return _auto_lm_head(cfg, device)


def _auto_lm_head(cfg: TrainConfig,
                  device: Optional[torch.device] = None) -> Tuple[bool, int]:
    """The auto policy's pick, logged once per choice: per-device head
    tokens and an analytic train-state estimate (f32 master + mu and nu
    at their storage dtypes: 12 B/param in f32 down to 8 B with bf16 mu
    and nu) against the device's memory."""
    m = cfg.model
    n_tok = max(cfg.batch_size, 1) * max(m.max_seq_len, 1)
    hd = m.d_model // m.n_heads
    attn = 2 * m.d_model * m.d_model + 2 * m.d_model * m.n_kv_heads * hd
    ffn = 3 * m.d_model * m.d_ff
    n_params = m.vocab_size * m.d_model + m.n_layers * (attn + ffn)
    state_bytes_per_param = (4 + (2 if cfg.dtype == "bfloat16" else 4)
                             + (2 if cfg.adam_nu_dtype == "bfloat16" else 4))
    dtype_bytes = 2 if cfg.dtype == "bfloat16" else 4
    fused_xent, xent_chunks = transformer.pick_lm_head(
        n_tok, m.vocab_size, m.d_model, m.n_layers, dtype_bytes,
        n_params * state_bytes_per_param, _device_hbm_bytes(device))
    choice = ("fused" if fused_xent
              else f"chunked({xent_chunks})" if xent_chunks else "plain")
    if choice not in _AUTO_HEAD_LOGGED:
        _AUTO_HEAD_LOGGED.add(choice)
        log0(f"tpudist: --lm-head auto -> {choice}")
    return fused_xent, xent_chunks


_AUTO_HEAD_LOGGED: set = set()


def make_loss_fn(cfg: TrainConfig,
                 device: Optional[torch.device] = None) -> Callable:
    """(params, batch) -> scalar loss, for the configured model; batch is
    a tuple of device tensors ((x, y) for the MLP, (tokens,) for the
    transformer)."""
    model = get_model(cfg.model.name)
    dt = _compute_dtype(cfg)
    if cfg.model.name == "mlp":
        return functools.partial(model.loss_fn, dtype=dt)
    fused_xent, xent_chunks = _resolve_lm_head(cfg, device)

    def loss(params, batch):
        return model.loss_fn(params, batch[0], cfg.model, dtype=dt,
                             remat=cfg.remat, xent_chunks=xent_chunks,
                             fused_xent=fused_xent)
    return loss


def init_state(cfg: TrainConfig, device: torch.device) -> TrainState:
    """Seeded params (``cfg.seed``) and a fresh optimizer state on
    ``device``."""
    model = get_model(cfg.model.name)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    params = model.init(cfg.model, generator=gen)
    names, plist = zip(*params.named_parameters())
    return TrainState(step=0, params=params,
                      opt_state=make_optimizer(cfg).init(plist, names))


def _microbatch(loss_fn, params: nn.Module, batch, n_accum: int):
    """(loss, grads) over ``n_accum`` microbatches of ``batch``: the
    losses and grads summed in microbatch order, then scaled by
    1/n_accum, as the JAX package's scan does."""
    plist = list(params.parameters())
    if n_accum == 1:
        loss = loss_fn(params, batch)
        return loss.detach(), list(torch.autograd.grad(loss, plist))
    total, grads = None, None
    for i in range(n_accum):
        mb = tuple(x.reshape(n_accum, x.shape[0] // n_accum,
                             *x.shape[1:])[i] for x in batch)
        loss = loss_fn(params, mb)
        g = torch.autograd.grad(loss, plist)
        total = loss.detach() if total is None else total + loss.detach()
        grads = list(g) if grads is None else [a + b for a, b in
                                               zip(grads, g)]
    inv = 1.0 / n_accum
    return total * inv, [g * inv for g in grads]


def pmean(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``lax.pmean`` over the processes, in place: one all-reduce SUM a
    tensor, in order, then a divide by the world size (psum, then divide:
    ``ReduceOp.AVG`` does not exist on gloo)."""
    world = dist.get_world_size()
    for t in tensors:
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        t.div_(world)
    return list(tensors)


def _build_step_body(cfg: TrainConfig,
                     device: Optional[torch.device] = None
                     ) -> Tuple[Callable, Adam]:
    """``(body, tx)``: ``body(state, batch, count, c1, c2) -> loss``, one
    step on device tensors: loss and grads over this process's batch
    (with ``--grad-accum-steps`` microbatching), their mean over the
    processes when a process group is up, then the Adam update in place
    from the step's device scalars. It reads and writes no host counter,
    so a CUDA graph can capture it; the caller advances ``state.step``
    and ``state.opt_state.count``."""
    loss_fn = make_loss_fn(cfg, device)
    tx = make_optimizer(cfg)
    data_parallel = dist.is_initialized()

    def body(state: TrainState, batch, count, c1, c2):
        loss, grads = _microbatch(loss_fn, state.params, batch,
                                  cfg.grad_accum_steps)
        if data_parallel:
            # THE collective under test: the gradient mean over the data
            # axis, one all-reduce a param in param order after the whole
            # backward (the JAX package's --grad-overlap off), and the
            # loss's mean as lax.pmean(loss, "data") gives it
            grads = pmean(grads)
            loss, = pmean([loss])
        tx.apply(grads, state.opt_state, list(state.params.parameters()),
                 count, c1, c2)
        return loss
    return body, tx


def _counted(body: Callable, cost: Dict[str, int], *args):
    """``body(*args)``; the first call a dispatcher makes is counted
    (``obs.mfu.FlopCount``) into ``cost``: one step's model flops, read
    back by the dispatcher's ``cost_analysis``. The count only watches
    the ops run, so the step computes the same bits."""
    if cost:
        return body(*args)
    with mfu.FlopCount() as n:
        out = body(*args)
    cost["flops"] = n.total
    return out


def _advance(state: TrainState, n: int) -> None:
    """The host's counters after ``n`` steps ran."""
    state.opt_state.count += n
    state.step += n


def make_train_step(cfg: TrainConfig,
                    device: Optional[torch.device] = None) -> Callable:
    """``(state, batch) -> (state, loss)``: one step of the step body,
    its scalars filled from the host's count first. ``cost_analysis()``
    is the step's flop count from its first call (None before it)."""
    body, tx = _build_step_body(cfg, device)
    scalars = StepScalars(tx, 1, torch.device(device or "cpu"))
    cost: Dict[str, int] = {}

    def step(state: TrainState, batch):
        scalars.fill(state.opt_state.count + 1)
        loss = _counted(body, cost, state, batch, *scalars.row(0))
        _advance(state, 1)
        return state, loss
    step.cost_analysis = lambda: dict(cost) or None
    return step


# each kernel wrapper's launch counter, by the kernel's name
_COUNTERS = (("flash_attention_fwd", _fa, "launches"),
             ("flash_attention_bwd_dq", _fa, "dq_launches"),
             ("flash_attention_bwd_dkv", _fa, "dkv_launches"),
             ("flash_attention_bwd_dqkv", _fa, "dqkv_launches"),
             ("fused_xent_fwd", _fx, "fwd_launches"),
             ("fused_xent_bwd", _fx, "bwd_launches"))


def kernel_launch_counts() -> Dict[str, int]:
    """The kernel wrappers' launch counters, by kernel name."""
    return {name: getattr(mod, attr) for name, mod, attr in _COUNTERS}


def set_kernel_launch_counts(counts: Dict[str, int]) -> None:
    for name, mod, attr in _COUNTERS:
        setattr(mod, attr, counts[name])


_CAPTURE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The side stream every superstep on ``device`` warms up and
    captures on, one a card as ``torch.cuda.graph`` keeps one default
    capture stream: cuBLAS keeps a workspace from the caching allocator
    for each stream it has run on, so a fresh stream a superstep would
    leave one behind for each (the tuner builds a superstep a trial)."""
    if device not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return _CAPTURE_STREAMS[device]


class Superstep:
    """``superstep(state, total, slab, lo, hi) -> (state, total,
    losses)``: steps ``[lo, hi)`` of a ``(k, local_batch, ...)`` slab of
    device tensors, the JAX package's ``make_superstep`` contract.
    ``total`` accumulates each valid step's loss in step order (start it
    from a device zero: ``0 + l0 == l0``, so the epoch's Avg loss is
    bitwise per-step dispatch's); only entries of ``losses`` in ``[lo,
    hi)`` are meaningful, and the returned tensors may be the
    superstep's own buffers, valid until its next call.

    On the CPU the steps run one after another, each the step body of
    :func:`make_train_step` (the gloo backend cannot be captured anyway).

    On the card a superstep is a CUDA graph of k whole steps (forward,
    ``autograd.grad``, the NCCL all-reduce when a process group is up,
    Adam), replayed once per full window. Masked steps cost no device
    work: a partial window (the epoch's tail, ``hi < k``, or the
    realignment after a resume, ``lo > 0``) replays a second, one-step
    graph ``hi - lo`` times. The first call runs its window eagerly, as
    real steps, on a side stream (the warm-up: kernel builds, lazy
    module loads and NCCL's communicator cannot happen in a capture),
    then captures both graphs into one memory pool; capture executes
    nothing. There are exactly two programs a run (``programs``), and a
    capture that fails raises: there is no eager fallback (nor a second
    capture after :meth:`release`). Before each
    replay the window is copied into the graphs' static input buffer
    (one device-to-device copy) and the step scalars into
    :class:`StepScalars`. A replay does not move the kernel wrappers'
    launch counters: a capture's increments move into this object's
    record, and :meth:`kernel_launches` multiplies them by the
    replays. :meth:`cost_analysis` is one step's flop count, taken over
    the first step the superstep runs (an eager one)."""

    def __init__(self, cfg: TrainConfig, device: Optional[torch.device],
                 k: int):
        if k < 1:
            raise ValueError(f"superstep length must be >= 1, got {k}")
        self.k = k
        self.device = torch.device(device or "cpu")
        self.body, tx = _build_step_body(cfg, device)
        self.scalars = StepScalars(tx, k, self.device)
        self.graphs: Dict[str, "torch.cuda.CUDAGraph"] = {}
        self.captured_launches: Dict[str, Dict[str, int]] = {}
        self.replays: Dict[str, int] = {}
        self.capture_s = 0.0             # the two captures' wall time
        self.graph_pool_bytes = 0        # device memory the captures hold
        self._static: Tuple[torch.Tensor, ...] = ()
        self._total: Optional[torch.Tensor] = None
        self._outputs: Dict[str, torch.Tensor] = {}
        self._partial: Optional[torch.Tensor] = None
        self._cost: Dict[str, int] = {}

    def cost_analysis(self) -> Optional[Dict[str, int]]:
        """One step's model flops (``obs.mfu``) once a step ran: a
        k-step superstep counts one step, as the JAX package's cost
        analysis visits a scan body once."""
        return dict(self._cost) or None

    @property
    def programs(self) -> int:
        """Graphs captured this run (0 on the CPU, or before the first
        call); the count outlives :meth:`release`."""
        return len(self.captured_launches)

    def release(self) -> None:
        """Drop the graphs, their pool and the static buffers; the record
        of captures and replays stays. NCCL cannot destroy a communicator
        while a graph holds work captured on it, so the train loop
        releases the superstep before the process group goes."""
        self.graphs.clear()
        self._outputs.clear()
        self._static, self._total, self._partial = (), None, None

    def kernel_launches(self) -> Dict[str, int]:
        """Kernel launches that replays ran, by kernel name: each graph's
        replays times the launches its capture recorded. The eager
        warm-up window moved the wrappers' counters itself."""
        out = dict.fromkeys(kernel_launch_counts(), 0)
        for name, rec in self.captured_launches.items():
            for key, n in rec.items():
                out[key] += self.replays[name] * n
        return out

    def __call__(self, state: TrainState, total: torch.Tensor, slab,
                 lo: int, hi: int):
        if not 0 <= lo < hi <= self.k:
            raise ValueError(f"superstep bounds need 0 <= lo < hi <= k = "
                             f"{self.k}, got [{lo}, {hi})")
        if any(a.shape[0] != self.k for a in slab):
            raise ValueError(f"superstep slabs hold exactly k = {self.k} "
                             f"steps, got {[a.shape[0] for a in slab]}")
        if self.device.type != "cuda":
            return self._eager(state, total, slab, lo, hi)
        if not self.graphs:
            return self._warm_up_and_capture(state, total, slab, lo, hi)
        return self._replay(state, total, slab, lo, hi)

    def _eager(self, state, total, slab, lo, hi):
        """Steps ``[lo, hi)`` one after another, each the step body: the
        CPU's superstep and the card's warm-up."""
        losses = torch.zeros((self.k,), dtype=torch.float32,
                             device=total.device)
        # row i holds the scalars of the i - lo + 1-th step from here
        self.scalars.fill(state.opt_state.count + 1 - lo)
        for i in range(lo, hi):
            loss = _counted(self.body, self._cost, state,
                            tuple(a[i] for a in slab), *self.scalars.row(i))
            total = total + loss
            losses[i] = loss
        _advance(state, hi - lo)
        return state, total, losses

    def _warm_up_and_capture(self, state, total, slab, lo, hi):
        if self.captured_launches:
            raise RuntimeError("the superstep captures its two programs "
                               "once a run, and was released")
        dev = self.device
        main = torch.cuda.current_stream(dev)
        side = _capture_stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            state, total, losses = self._eager(state, total, slab, lo, hi)
        main.wait_stream(side)
        for t in (total, losses):
            t.record_stream(main)
        self._capture(state, slab, side)
        return state, total, losses

    def _graph_body(self, state, n: int) -> torch.Tensor:
        losses = []
        for i in range(n):
            loss = self.body(state, tuple(a[i] for a in self._static),
                             *self.scalars.row(i))
            self._total.add_(loss)
            losses.append(loss)
        return torch.stack(losses)

    def _capture(self, state, slab, side) -> None:
        """Capture the k-step and the one-step graph into one pool."""
        dev = self.device
        self._static = tuple(torch.empty_like(a) for a in slab)
        self._total = torch.zeros((), dtype=torch.float32, device=dev)
        self._partial = torch.zeros((self.k,), dtype=torch.float32,
                                    device=dev)
        # NCCL's watchdog thread queries its events while this thread
        # captures: "global" mode would refuse those queries
        mode = "thread_local" if dist.is_initialized() else "global"
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        pool = torch.cuda.graph_pool_handle()
        for name, n in (("superstep", self.k), ("step", 1)):
            graph = torch.cuda.CUDAGraph()
            before = kernel_launch_counts()
            with torch.cuda.graph(graph, pool=pool, stream=side,
                                  capture_error_mode=mode):
                out = self._graph_body(state, n)
            # the capture recorded these launches; each replay runs them
            after = kernel_launch_counts()
            self.captured_launches[name] = {
                key: after[key] - before[key] for key in after}
            set_kernel_launch_counts(before)
            self.graphs[name], self._outputs[name] = graph, out
            self.replays[name] = 0
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        self.graph_pool_bytes = torch.cuda.memory_reserved(dev) - reserved

    def _replay(self, state, total, slab, lo, hi):
        count = state.opt_state.count
        if total is not self._total:
            self._total.copy_(total)
        if (lo, hi) == (0, self.k):
            for dst, src in zip(self._static, slab):
                dst.copy_(src)
            self.scalars.fill(count + 1)
            self.graphs["superstep"].replay()
            self.replays["superstep"] += 1
            losses = self._outputs["superstep"]
        else:
            losses = self._partial
            for i in range(lo, hi):
                for dst, src in zip(self._static, slab):
                    dst[0].copy_(src[i])
                self.scalars.fill(count + 1 + i - lo, 1)
                self.graphs["step"].replay()
                self.replays["step"] += 1
                losses[i].copy_(self._outputs["step"][0])
        _advance(state, hi - lo)
        return state, self._total, losses


def make_superstep(cfg: TrainConfig, device: Optional[torch.device],
                   k: int) -> Superstep:
    """The k-step superstep dispatch (:class:`Superstep`)."""
    return Superstep(cfg, device, k)


def make_eval_fn(cfg: TrainConfig,
                 device: Optional[torch.device] = None) -> Callable:
    """``(state, batch) -> loss``, a forward with no update and no graph,
    over the GLOBAL ``batch``: with a process group up, each process
    evaluates its contiguous slice of it (as the JAX package shards the
    eval batch over the data axis) and the mean comes back from an
    all-reduce, the same on every process."""
    loss_fn = make_loss_fn(cfg, device)
    data_parallel = dist.is_initialized()

    @torch.no_grad()
    def ev(state: TrainState, batch):
        if not data_parallel:
            return loss_fn(state.params, batch)
        rank, world = dist.get_rank(), dist.get_world_size()
        local = tuple(x.reshape(world, x.shape[0] // world,
                                *x.shape[1:])[rank] for x in batch)
        loss, = pmean([loss_fn(state.params, local)])
        return loss
    return ev


def state_bytes_per_device(state: TrainState) -> int:
    """Bytes of the params and optimizer moments (every device holds them
    all: they are replicated)."""
    tensors = list(state.params.parameters()) + state.opt_state.mu \
        + state.opt_state.nu
    return sum(t.numel() * t.element_size() for t in tensors)
