"""Training engine on one process: state, optimizer, loss, step, eval.

Counterpart of the single-device part of ``tpudist/engine.py``. The JAX
package's state is a pytree and its step a compiled pure function; here
the params are an ``nn.Module``, the step runs eagerly, and the
optimizer updates the params and its moments in place (one copy of the
train state on the device instead of two). The data-parallel gradient
mean, the collective under test, comes with ROADMAP Queue A item 4.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
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


@dataclass
class TrainState:
    step: int                  # global step counter
    params: nn.Module
    opt_state: AdamState


class Adam:
    """optax ``adam(lr, mu_dtype=...)`` over a list of params, updating
    them and the moments in place. The update runs in f32 in optax's
    order: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu, then
    (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) times -lr; mu is
    stored in ``mu_dtype`` (bf16 under mixed precision) after the update
    has used its f32 value. f32 runs give ``torch.optim.Adam``'s math."""

    def __init__(self, lr: float, *, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, mu_dtype: Optional[torch.dtype] = None):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu_dtype = mu_dtype

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        return AdamState(
            count=0,
            mu=[torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                for p in params],
            nu=[torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: AdamState,
               params: Sequence[torch.Tensor]) -> AdamState:
        b1, b2 = self.b1, self.b2
        count = state.count + 1
        # the bias corrections in f32, as optax computes them
        c1 = float(1 - np.float32(b1) ** np.float32(count))
        c2 = float(1 - np.float32(b2) ** np.float32(count))
        for p, g, mu, nu in zip(params, grads, state.mu, state.nu):
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
    (the JAX package's optax ``mu_dtype``), the second stays f32."""
    return Adam(cfg.lr, mu_dtype=(torch.bfloat16 if cfg.dtype == "bfloat16"
                                  else None))


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
    """cfg.lm_head -> concrete (fused_xent, xent_chunks). ``plain`` is
    (False, 0); ``auto`` asks :func:`_auto_lm_head`. The fused and
    chunked heads are refused by ``config.check_supported``."""
    if cfg.lm_head == "plain":
        return False, 0
    if cfg.lm_head != "auto" or cfg.fused_xent or cfg.xent_chunks:
        raise ValueError(
            f"--lm-head {cfg.lm_head} (fused_xent={cfg.fused_xent}, "
            f"xent_chunks={cfg.xent_chunks}): the port's head is the plain "
            f"tied head; the others come with ROADMAP Queue A item 5")
    return _auto_lm_head(cfg, device)


def _auto_lm_head(cfg: TrainConfig,
                  device: Optional[torch.device] = None) -> Tuple[bool, int]:
    """The auto policy's pick, logged once per choice: per-device head
    tokens and an analytic train-state estimate (f32 master + mu at its
    storage dtype + f32 nu) against the device's memory."""
    m = cfg.model
    n_tok = max(cfg.batch_size, 1) * max(m.max_seq_len, 1)
    hd = m.d_model // m.n_heads
    attn = 2 * m.d_model * m.d_model + 2 * m.d_model * m.n_kv_heads * hd
    ffn = 3 * m.d_model * m.d_ff
    n_params = m.vocab_size * m.d_model + m.n_layers * (attn + ffn)
    state_bytes_per_param = 4 + (2 if cfg.dtype == "bfloat16" else 4) + 4
    dtype_bytes = 2 if cfg.dtype == "bfloat16" else 4
    fused_xent, xent_chunks = transformer.pick_lm_head(
        n_tok, m.vocab_size, m.d_model, m.n_layers, dtype_bytes,
        n_params * state_bytes_per_param, _device_hbm_bytes(device))
    choice = "fused" if fused_xent else "plain"
    if choice not in _AUTO_HEAD_LOGGED:
        _AUTO_HEAD_LOGGED.add(choice)
        log0(f"tpudist: --lm-head auto -> {choice}")
    if fused_xent:
        raise ValueError(
            "--lm-head auto picked the fused head for this shape (logits "
            "pair + activations over the memory budget); the fused head "
            "comes with ROADMAP Queue A item 5: lower --train-batch-size "
            "or --seq-len")
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
    return TrainState(step=0, params=params,
                      opt_state=make_optimizer(cfg).init(
                          list(params.parameters())))


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


def make_train_step(cfg: TrainConfig,
                    device: Optional[torch.device] = None) -> Callable:
    """``(state, batch) -> (state, loss)``: loss and grads (with
    ``--grad-accum-steps`` microbatching), then the Adam update in
    place. One process, no collective."""
    loss_fn = make_loss_fn(cfg, device)
    tx = make_optimizer(cfg)

    def step(state: TrainState, batch):
        loss, grads = _microbatch(loss_fn, state.params, batch,
                                  cfg.grad_accum_steps)
        tx.update(grads, state.opt_state, list(state.params.parameters()))
        state.step += 1
        return state, loss
    return step


def make_eval_fn(cfg: TrainConfig,
                 device: Optional[torch.device] = None) -> Callable:
    """``(state, batch) -> loss``, a forward with no update and no
    graph."""
    loss_fn = make_loss_fn(cfg, device)

    @torch.no_grad()
    def ev(state: TrainState, batch):
        return loss_fn(state.params, batch)
    return ev


def state_bytes_per_device(state: TrainState) -> int:
    """Bytes of the params and optimizer moments (one device holds them
    all in this slice)."""
    tensors = list(state.params.parameters()) + state.opt_state.mu \
        + state.opt_state.nu
    return sum(t.numel() * t.element_size() for t in tensors)
