"""Training engine: state, optimizer, loss, the train step, eval.

Counterpart of ``tpudist/engine.py``'s replicated data-parallel path
(``--grad-overlap off``). The JAX package's state is a pytree and its
step a compiled pure function; here the params are an ``nn.Module``, the
step runs eagerly, and the optimizer updates the params and its moments
in place (one copy of the train state on the device instead of two).
Every process holds the whole state, made alike from one seed; when a
process group is up (``tpudist_torch.parallel.distributed``), the step
means the gradients and the loss over the processes with an explicit
all-reduce after the whole backward: the collective under test.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from tpudist_torch.config import TrainConfig
from tpudist_torch.metrics import log0
from tpudist_torch.models import get_model
from tpudist_torch.models import transformer


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


def _stochastic_round_bf16(x: torch.Tensor, count: int,
                           salt: int) -> torch.Tensor:
    """f32 -> bf16 with stochastic rounding, bitwise the JAX package's
    ``_stochastic_round_bf16``: add a uniform dither in [0, ulp) to the
    low 16 bits of the f32 pattern, then truncate. Unbiased, which is what
    lets a bf16-stored EMA track sub-ulp updates that round-to-nearest
    would drop. The dither is a murmur-style hash of (flat element index,
    step count, salt) on uint32, computed here in int64 with every
    product and sum masked to its low 32 bits (exact under int64
    wraparound)."""
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
    def update(self, grads: Sequence[torch.Tensor], state: AdamState,
               params: Sequence[torch.Tensor]) -> AdamState:
        b1, b2 = self.b1, self.b2
        count = state.count + 1
        # the bias corrections in f32, as optax computes them
        c1 = float(1 - np.float32(b1) ** np.float32(count))
        c2 = float(1 - np.float32(b2) ** np.float32(count))
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
        state.count = count
        return state


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


def make_train_step(cfg: TrainConfig,
                    device: Optional[torch.device] = None) -> Callable:
    """``(state, batch) -> (state, loss)``: loss and grads over this
    process's batch (with ``--grad-accum-steps`` microbatching), their
    mean over the processes when a process group is up, then the Adam
    update in place."""
    loss_fn = make_loss_fn(cfg, device)
    tx = make_optimizer(cfg)
    data_parallel = dist.is_initialized()

    def step(state: TrainState, batch):
        loss, grads = _microbatch(loss_fn, state.params, batch,
                                  cfg.grad_accum_steps)
        if data_parallel:
            # THE collective under test: the gradient mean over the data
            # axis, one all-reduce a param in param order after the whole
            # backward (the JAX package's --grad-overlap off), and the
            # loss's mean as lax.pmean(loss, "data") gives it
            grads = pmean(grads)
            loss, = pmean([loss])
        tx.update(grads, state.opt_state, list(state.params.parameters()))
        state.step += 1
        return state, loss
    return step


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
