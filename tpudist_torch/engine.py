"""Training engine: state, optimizer, loss, the train step, the
superstep, eval.

Counterpart of ``tpudist/engine.py``: its replicated data-parallel path
(every ``--grad-overlap`` and ``--cross-slice`` schedule of
``tpudist_torch.parallel.overlap``) and its sharded path on a ``data x
fsdp x expert x tensor x context`` mesh.
The JAX package's state is a pytree and its step a compiled pure
function; here the params are an ``nn.Module``, the step runs eagerly,
and the optimizer updates the params and its moments in place (one copy
of the train state on the device instead of two).

Without a mesh every process holds the whole state, made alike from one
seed; when a process group is up (``tpudist_torch.parallel.distributed``),
the step means the gradients and the loss over the processes with
explicit all-reduces, after the whole backward or bucket by bucket as
the backward produces the grads: the collective under test.

With a mesh (:func:`init_state`'s ``mesh``; the train CLI passes one when
``--fsdp``, ``--expert`` or ``--tensor`` > 1) each process keeps its
shard of every param whose spec divides (the models' ``param_specs``:
1/fsdp, 1/tensor of the Megatron-split weights, 1/expert of the MoE's
expert weights), and Adam's moments in the same
layout (:class:`ShardLayout`, ZeRO-style as ``tpudist/engine.py:355-395``
lays them out). The step gathers each shard over the fsdp group before
the forward and reduce-scatters its gradient after the backward
(:class:`_GatherShard`), as XLA's partitioner does for the JAX package;
a tensor or expert shard stays resident, and the models compute their
tensor and expert parts with the operators GSPMD would insert
(:mod:`tpudist_torch.parallel.tensor`). The batch splits over data x
fsdp and is replicated over expert and tensor, as the JAX package's
``batch_spec`` lays it out. Under context parallelism (``--context``)
the context ranks of a place share its rows and split their sequence:
the loss is the models' ``make_cp_loss_fn`` (ring or Ulysses
attention over the context group), and the step means the loss and the
grads over data x fsdp x context.

One step body serves per-step dispatch (:func:`make_train_step`) and the
k-step superstep (:func:`make_superstep`). It reads Adam's per-step
scalars (the step count and the bias corrections) from device tensors
(:class:`StepScalars`) and no host value that changes from step to step,
so on the card the superstep captures it into CUDA graphs and replays
them; on the CPU the superstep runs the body in a loop.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from tpudist_torch import config as config_lib
from tpudist_torch.config import TrainConfig
from tpudist_torch.metrics import log0
from tpudist_torch.models import get_model
from tpudist_torch.models import transformer
from tpudist_torch.obs import mfu
from tpudist_torch.ops.cuda import flash_attention as _fa
from tpudist_torch.ops.cuda import fused_xent as _fx
from tpudist_torch.parallel import mesh as mesh_lib
from tpudist_torch.parallel import overlap as overlap_lib
from tpudist_torch.parallel import sharding as shd
from tpudist_torch.parallel import tensor as tensor_lib


@dataclass
class AdamState:
    count: int                 # steps taken
    mu: List[torch.Tensor]     # first moments, one per param
    nu: List[torch.Tensor]     # second moments, one per param
    # each param's leaf index in the JAX package's params pytree (sorted
    # dict keys): the salt of the bf16 second moment's rounding dither
    salts: List[int] = field(default_factory=list)
    # each moment's (whole leaf's shape, span) when it is a shard of its
    # leaf: the rounding dither hashes the WHOLE leaf's flat indices;
    # empty when every moment is whole
    regions: List[Tuple[Tuple[int, ...], tuple]] = field(
        default_factory=list)


@dataclass
class TrainState:
    step: int                  # global step counter
    params: nn.Module
    opt_state: AdamState
    # how params, mu and nu lie on the mesh; None: whole on every process
    layout: Optional["ShardLayout"] = None


def jax_leaf_order(names: Sequence[str]) -> List[int]:
    """Each ``state_dict`` name's index among ``jax.tree.flatten``'s
    leaves of the JAX package's nested params dict, whose keys flatten
    sorted at every level (``embed``, ``final_norm``, ``layers.*``)."""
    order = sorted(range(len(names)), key=lambda i: names[i].split("."))
    rank = [0] * len(names)
    for leaf, i in enumerate(order):
        rank[i] = leaf
    return rank


def flat_index(shape: Sequence[int], span, device=None) -> torch.Tensor:
    """The flat (C-order) indices, within a leaf of ``shape``, of the
    elements of its region ``span`` (per dim ``(start, stop)``), as an
    int64 tensor of the region's shape: ``arange(numel).reshape(shape)``
    for the whole leaf."""
    idx = torch.zeros((), dtype=torch.int64, device=device)
    stride = 1
    for d in reversed(range(len(shape))):
        lo, hi = span[d]
        ax = torch.arange(lo, hi, dtype=torch.int64, device=device)
        idx = (ax * stride).reshape(-1, *([1] * (len(shape) - 1 - d))) \
            + idx
        stride *= int(shape[d])
    return idx


def _stochastic_round_bf16(x: torch.Tensor, count, salt: int,
                           region=None) -> torch.Tensor:
    """f32 -> bf16 with stochastic rounding, bitwise the JAX package's
    ``_stochastic_round_bf16``: add a uniform dither in [0, ulp) to the
    low 16 bits of the f32 pattern, then truncate. Unbiased, which is what
    lets a bf16-stored EMA track sub-ulp updates that round-to-nearest
    would drop. The dither is a murmur-style hash of (flat element index,
    step count, salt) on uint32, computed here in int64 with every
    product and sum masked to its low 32 bits (exact under int64
    wraparound). ``count`` is an int or a 0-dim int64 tensor (the
    device-side step count a captured step reads). ``region`` is
    ``(shape, span)`` when ``x`` is a shard of a leaf of ``shape``: it
    hashes the leaf's flat indices (:func:`flat_index`), as every JAX
    shard of a partitioned iota does, so a shard rounds as the same
    slice of its whole leaf would."""
    m32 = 0xFFFFFFFF
    bits = x.to(torch.float32).contiguous().view(torch.int32).to(
        torch.int64) & m32
    if region is None:
        idx = torch.arange(x.numel(), dtype=torch.int64,
                           device=x.device).reshape(x.shape)
    else:
        idx = flat_index(*region, device=x.device)
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
                nu.copy_(_stochastic_round_bf16(
                    v, count, state.salts[i],
                    state.regions[i] if state.regions else None))
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
                     device: Optional[torch.device] = None,
                     mesh=None) -> Tuple[bool, int]:
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
    return _auto_lm_head(cfg, device, mesh)


def _auto_lm_head(cfg: TrainConfig, device: Optional[torch.device] = None,
                  mesh=None) -> Tuple[bool, int]:
    """The auto policy's pick, logged once per choice: per-device head
    tokens and an analytic train-state estimate (f32 master + mu and nu
    at their storage dtypes: 12 B/param in f32 down to 8 B with bf16 mu
    and nu; the MoE's FFN params times its experts) against the device's
    memory: the JAX package's closed form. Without a mesh every axis is
    1 and the tokens are the whole batch's; with one, the batch splits
    over data x fsdp, the sequence over context and the state over fsdp
    x tensor, the MoE's expert FFN params over expert too."""
    m = cfg.model
    sizes = mesh_lib.mesh_shape(mesh) if mesh is not None else {}
    batch_shards = sizes.get("data", 1) * sizes.get("fsdp", 1)
    wshards = sizes.get("fsdp", 1) * sizes.get("tensor", 1)
    eshards = sizes.get("expert", 1)
    n_tok = (max(cfg.batch_size // batch_shards, 1)
             * max(m.max_seq_len // sizes.get("context", 1), 1))
    hd = m.d_model // m.n_heads
    attn = 2 * m.d_model * m.d_model + 2 * m.d_model * m.n_kv_heads * hd
    ffn = 3 * m.d_model * m.d_ff
    # the MoE holds n_experts FFNs a layer
    expert_mult = m.n_experts if m.name == "moe" else 1
    n_params = (m.vocab_size * m.d_model + m.n_layers * attn
                + m.n_layers * ffn * expert_mult / eshards)
    state_bytes_per_param = (4 + (2 if cfg.dtype == "bfloat16" else 4)
                             + (2 if cfg.adam_nu_dtype == "bfloat16" else 4))
    dtype_bytes = 2 if cfg.dtype == "bfloat16" else 4
    fused_xent, xent_chunks = transformer.pick_lm_head(
        n_tok, m.vocab_size, m.d_model, m.n_layers, dtype_bytes,
        n_params / wshards * state_bytes_per_param,
        _device_hbm_bytes(device))
    choice = ("fused" if fused_xent
              else f"chunked({xent_chunks})" if xent_chunks else "plain")
    if choice not in _AUTO_HEAD_LOGGED:
        _AUTO_HEAD_LOGGED.add(choice)
        log0(f"tpudist: --lm-head auto -> {choice}")
    return fused_xent, xent_chunks


_AUTO_HEAD_LOGGED: set = set()


def make_loss_fn(cfg: TrainConfig, device: Optional[torch.device] = None,
                 mesh=None) -> Callable:
    """(params, batch, groups=None) -> scalar loss, for the configured
    model; batch is a tuple of device tensors ((x, y) for the MLP,
    (tokens,) for the sequence models: the transformer and the MoE).
    ``groups`` (:class:`tensor_lib.StepGroups`) is the sharded step's:
    the MoE then routes over the global batch, and under tensor
    parallelism the models compute their tensor parts. With a mesh whose
    ``context`` axis is > 1 the sequence models run context-parallel
    (their ``make_cp_loss_fn``, ring or Ulysses by ``cfg.cp_impl``), the
    sequence split over ``groups``' context ranks. ``plain_head`` says
    whether the LM head is the plain whole-logits one (the one the vocab
    splits over ``tensor``)."""
    model = get_model(cfg.model.name)
    dt = _compute_dtype(cfg)
    if cfg.model.name == "mlp":
        def mlp_loss(params, batch, groups=None):
            # no tensor dim (tpudist/models/mlp.py:48-57): replicated over
            # tensor, whole on every rank
            return model.loss_fn(params, batch, dtype=dt)
        mlp_loss.plain_head = False
        return mlp_loss
    fused_xent, xent_chunks = _resolve_lm_head(cfg, device, mesh)
    sizes = mesh_lib.mesh_shape(mesh) if mesh is not None else {}
    cp = sizes.get("context", 1) > 1
    if sizes.get("pipe", 1) > 1 and cp:
        raise ValueError(
            "pipe and context parallelism both manualize their own "
            "mesh axis in a shard_map and do not compose; pick one")
    if cp:
        if not hasattr(model, "make_cp_loss_fn"):
            raise ValueError(
                f"context parallelism is not implemented for model "
                f"{cfg.model.name!r}")
        cp_loss = model.make_cp_loss_fn(cfg.model, dtype=dt,
                                        remat=cfg.remat,
                                        xent_chunks=xent_chunks,
                                        fused_xent=fused_xent,
                                        impl=cfg.cp_impl)

        def loss(params, batch, groups=None):
            return cp_loss(params, batch[0], groups)
    else:
        def loss(params, batch, groups=None):
            return model.loss_fn(params, batch[0], cfg.model, dtype=dt,
                                 remat=cfg.remat, xent_chunks=xent_chunks,
                                 fused_xent=fused_xent, groups=groups)
    loss.plain_head = not (fused_xent or xent_chunks)
    return loss


# --------------------------------------------------------- the layout


def gather_dim(shard: torch.Tensor, dim: int, ways: int,
               group) -> torch.Tensor:
    """The whole tensor from each of ``group``'s ``ways`` shards along
    ``dim``: NCCL gathers contiguous chunks, which stack on a new leading
    axis; moving that axis in front of ``dim`` and merging the two puts
    shard ``w`` at ``[w * n, (w + 1) * n)`` of the dim."""
    shape = tuple(shard.shape)
    # the chunks concatenated along dim 0, the shape gloo asks for
    buf = shard.new_empty((ways * shape[0], *shape[1:]))
    tensor_lib.collective(dist.all_gather_into_tensor, buf,
                          shard.contiguous(), group=group)
    full = list(shape)
    full[dim] *= ways
    return buf.view(ways, *shape).movedim(0, dim).reshape(full)


def scatter_dim(full: torch.Tensor, dim: int, ways: int,
                group) -> torch.Tensor:
    """:func:`gather_dim`'s mirror image: ``full`` summed over ``group``
    and this rank's ``1/ways`` of it along ``dim`` kept (a
    reduce-scatter of ``full`` cut into ``ways`` chunks of the dim, each
    moved to a leading axis first)."""
    n = full.shape[dim] // ways
    chunks = full.reshape(*full.shape[:dim], ways, n,
                          *full.shape[dim + 1:]).movedim(dim, 0)
    out = full.new_empty(chunks.shape[1:])
    tensor_lib.collective(dist.reduce_scatter_tensor, out,
                          chunks.contiguous().view(-1, *out.shape[1:]),
                          op=dist.ReduceOp.SUM, group=group)
    return out


@dataclass
class ShardLayout:
    """How the params lie on a ``data x fsdp x expert x tensor x
    context`` mesh,
    Adam's ``mu`` and ``nu`` alike: param ``i`` (``names[i]``, whole
    shape ``shapes[i]``) is split as its sanitized spec ``specs[i]``
    says, ``fsdp`` ways along ``dims[i]``, ``tensor`` ways along
    ``tdims[i]`` (None: not split over that axis) and, for the MoE's
    expert FFN weights, ``expert`` ways along their experts dim, this
    process keeping the shard at its mesh coordinates; a dim split over
    a tuple of axes takes them in the spec's order, the last varying
    fastest (the embedding's ``(fsdp, tensor)``: chunk ``fsdp_index *
    tensor + tensor_index``, as JAX places it). ``owners[i]`` is the
    lowest rank that holds this process's shard of param ``i``: the one
    that writes it to a checkpoint. ``tensor_group`` is None unless
    tensor parallelism is on; ``expert_group`` (the expert x tensor
    ranks of this batch place) is None unless a spec splits the experts
    over ``expert``; ``batch_group`` is the ``data x fsdp`` ranks' group
    at this rank's other coordinates (None: the world), the batch the
    MoE routes. No spec splits a param over ``context``: its ranks
    (``context_group``, None unless ``context`` > 1) hold the same
    shards and split the sequence, so the step's mean runs over
    ``mean_group``, the data x fsdp x context ranks (None: the world),
    and an fsdp-split grad's sum over ``grad_group``, the data x context
    ranks. An expert shard stays resident: a rank computes with its
    experts and never gathers them. ``reduced`` collects the ``(op,
    dtype, bytes)`` of each collective the step issues."""

    names: List[str]
    shapes: List[Tuple[int, ...]]
    dims: List[Optional[int]]
    fsdp: int
    fsdp_index: int
    data: int
    owners: List[int]
    fsdp_group: object = None
    reduced: List[tuple] = field(default_factory=list)
    specs: List[tuple] = field(default_factory=list)
    tdims: List[Optional[int]] = field(default_factory=list)
    tensor: int = 1
    tensor_index: int = 0
    tensor_group: object = None
    batch_group: object = None
    # each mesh axis's (size, this process's index)
    coords: Dict[str, Tuple[int, int]] = field(default_factory=dict)
    expert_group: object = None
    context_group: object = None
    mean_group: object = None
    grad_group: object = None

    def span(self, i: int) -> Tuple[Tuple[int, int], ...]:
        """This process's region of param ``i``: per dim ``(start,
        stop)``."""
        out = [(0, n) for n in self.shapes[i]]
        for d, entry in enumerate(self.specs[i]):
            ways, index = 1, 0
            for a in shd.spec_axes(entry):
                size, at = self.coords[a]
                ways, index = ways * size, index * size + at
            n = self.shapes[i][d] // ways
            out[d] = (index * n, (index + 1) * n)
        return tuple(out)

    def shard(self, i: int, whole: torch.Tensor) -> torch.Tensor:
        """This process's shard of param ``i``'s whole value."""
        return whole[tuple(slice(lo, hi) for lo, hi in self.span(i))]

    def note(self, op: str, t: torch.Tensor) -> None:
        self.reduced.append((op, t.dtype, t.numel() * t.element_size()))

    @property
    def batch(self) -> int:
        """The ranks a batch splits over: data x fsdp."""
        return self.data * self.fsdp

    @property
    def context(self) -> int:
        """The context ways: the ranks that split a place's sequence."""
        return self.coords.get("context", (1, 0))[0]

    @property
    def mean_ways(self) -> int:
        """The ranks the step's loss and grads are a mean over: data x
        fsdp x context."""
        return self.batch * self.context

    @property
    def place(self) -> int:
        """This process's place among the data x fsdp ranks: its batch
        shard (the expert and tensor ranks of a place share it)."""
        return self.coords["data"][1] * self.fsdp + self.fsdp_index

    def step_groups(self, vocab_parallel: bool = False
                    ) -> tensor_lib.StepGroups:
        """What the step's loss reads of the mesh
        (:class:`tensor_lib.StepGroups`), noting into ``reduced``."""
        expert, expert_index = self.coords.get("expert", (1, 0))
        context, context_index = self.coords.get("context", (1, 0))
        return tensor_lib.StepGroups(
            tensor=self.tensor, tensor_index=self.tensor_index,
            tensor_group=self.tensor_group, batch=self.batch,
            batch_group=self.batch_group,
            vocab_parallel=vocab_parallel and self.tensor_group is not None,
            reduced=self.reduced, batch_index=self.place, expert=expert,
            expert_index=expert_index, expert_group=self.expert_group,
            context=context, context_index=context_index,
            context_group=self.context_group)


def make_layout(cfg: TrainConfig, mesh, shapes: Dict[str, Tuple[int, ...]],
                rank: Optional[int] = None) -> ShardLayout:
    """The model's ``param_specs``, sanitized on ``mesh`` for the params'
    whole ``shapes`` (by ``state_dict`` name, in ``named_parameters``
    order), as the :class:`ShardLayout` of ``rank`` (this process's by
    default). Every axis but ``pipe`` may be wider than 1."""
    sizes = mesh_lib.mesh_shape(mesh)
    if sizes["pipe"] > 1:
        raise ValueError(f"pipe axis {sizes['pipe']}: the sharded step "
                         f"body runs on the data x fsdp x expert x tensor "
                         f"x context mesh only")
    if sizes["tensor"] > 1 and cfg.model.name != "mlp" \
            and cfg.model.n_heads < sizes["tensor"]:
        raise ValueError(f"--tensor {sizes['tensor']} over "
                         f"{cfg.model.n_heads} heads: every tensor rank "
                         f"computes at least one head")
    model = get_model(cfg.model.name)
    specs = shd.sanitize_specs(shapes, model.param_specs(cfg.model), mesh)
    names = list(shapes)
    devs = mesh_lib.mesh_devices(mesh)
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    at = [int(c[0]) for c in np.nonzero(devs == rank)]
    axes = list(mesh.mesh_dim_names)
    coords = {a: (devs.shape[k], at[k]) for k, a in enumerate(axes)}

    def owner(spec) -> int:
        # the lowest rank at this process's place along the spec's axes:
        # the writer of that shard
        mine = np.ones(devs.shape, dtype=bool)
        for a in {a for e in spec for a in shd.spec_axes(e)}:
            k = axes.index(a)
            idx = np.arange(devs.shape[k]).reshape(
                [-1 if j == k else 1 for j in range(devs.ndim)])
            mine &= idx == at[k]
        return int(devs[mine].min())

    group = getattr(mesh, "get_group", None)
    tp = sizes["tensor"] > 1 and group is not None
    expert_group = None
    if group is not None and sizes["expert"] > 1 and any(
            shd.sharded_dim(sp, "expert") is not None
            for sp in specs.values()):
        # the experts dim splits (expert divides it): the expert partials
        # reduce over the expert x tensor ranks of the place
        expert_group = (mesh_lib.axes_group(mesh, ("expert", "tensor"))
                        if tp else group("expert"))
    # the world is the step's mean (data x fsdp x context) unless expert
    # or tensor ranks share a place, and the routing batch (data x fsdp)
    # unless context ranks do too
    shared = group is not None and sizes["expert"] * sizes["tensor"] > 1
    cp = group is not None and sizes["context"] > 1
    batch_group = (mesh_lib.axes_group(mesh, ("data", "fsdp"))
                   if shared or cp else None)
    mean_group = None
    if shared:
        mean_group = (mesh_lib.axes_group(mesh, ("data", "fsdp", "context"))
                      if cp else batch_group)
    return ShardLayout(
        names=names, shapes=[shapes[n] for n in names],
        dims=[shd.sharded_dim(specs[n]) for n in names],
        fsdp=sizes["fsdp"], fsdp_index=coords["fsdp"][1],
        data=sizes["data"], owners=[owner(specs[n]) for n in names],
        fsdp_group=group("fsdp") if group else None,
        specs=[specs[n] for n in names],
        tdims=[shd.sharded_dim(specs[n], "tensor") for n in names],
        tensor=sizes["tensor"], tensor_index=coords["tensor"][1],
        tensor_group=group("tensor") if tp else None,
        batch_group=batch_group, coords=coords, expert_group=expert_group,
        context_group=group("context") if cp else None,
        mean_group=mean_group,
        grad_group=(mesh_lib.axes_group(mesh, ("data", "context")) if cp
                    else group("data") if group else None))


def param_regions(state: TrainState) -> List[tuple]:
    """Each param's ``(whole shape, span, owner)`` in ``named_parameters``
    order: the leaf's global shape, this process's region of it (per dim
    ``(start, stop)``), and the lowest rank that holds that region, its
    writer. Adam's ``mu`` and ``nu`` lie the same way. A replicated state
    holds every leaf whole, written by rank 0."""
    lay = state.layout
    if lay is None:
        return [(tuple(p.shape), tuple((0, n) for n in p.shape), 0)
                for p in state.params.parameters()]
    return [(lay.shapes[i], lay.span(i), lay.owners[i])
            for i in range(len(lay.names))]


def init_state(cfg: TrainConfig, device: torch.device,
               mesh=None) -> TrainState:
    """Seeded params (``cfg.seed``) and a fresh optimizer state on
    ``device``. With a ``mesh`` the state is sharded
    (:func:`make_layout`): the whole seeded params are drawn, then each
    process keeps its shards, so every layout starts from the same
    params (the JAX package's "Init is seeded -> deterministic across
    process counts"); ``mu`` and ``nu`` are made in the params'
    layout."""
    model = get_model(cfg.model.name)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    params = model.init(cfg.model, generator=gen)
    layout = None
    if mesh is not None:
        layout = make_layout(cfg, mesh, {
            n: tuple(p.shape) for n, p in params.named_parameters()})
        for i, (owner, leaf) in enumerate(_param_slots(params)):
            whole = owner._parameters[leaf]
            owner._parameters[leaf] = nn.Parameter(
                layout.shard(i, whole.detach()).clone(
                    memory_format=torch.contiguous_format))
    names, plist = zip(*params.named_parameters())
    opt = make_optimizer(cfg).init(plist, names)
    if layout is not None:
        opt.regions = [(layout.shapes[i], layout.span(i))
                       for i in range(len(plist))]
    return TrainState(step=0, params=params, opt_state=opt, layout=layout)


def _param_slots(params: nn.Module) -> List[Tuple[nn.Module, str]]:
    """``(module, name)`` of each parameter in ``named_parameters``
    order: where a step swaps in the gathered tensors."""
    out = []
    for name, _ in params.named_parameters():
        owner, _, leaf = name.rpartition(".")
        out.append((params.get_submodule(owner), leaf))
    return out


@contextlib.contextmanager
def _swapped(params: nn.Module, tensors: Sequence[torch.Tensor]):
    """``params`` computing with ``tensors`` in place of its parameters
    (``named_parameters`` order) inside the block: the models read their
    weights by attribute, so the loss sees the gathered tensors."""
    slots = _param_slots(params)
    saved = [m._parameters[k] for m, k in slots]
    for (m, k), t in zip(slots, tensors):
        m._parameters[k] = t
    try:
        yield params
    finally:
        for (m, k), p in zip(slots, saved):
            m._parameters[k] = p


class _GatherShard(torch.autograd.Function):
    """Forward: a param's value gathered from its shards along each of
    its ``steps`` in turn (``(dim, ways, group, grad, index)``, the
    innermost axis of a dim first: :func:`gather_dim`). Backward: the
    mirror image, each step's part of the gradient reduce-scattered
    (summed: ``grad`` "sum", :func:`scatter_dim`) onto the shard, or cut
    to it (``grad`` "slice": every rank of that group computed the same
    whole gradient, which counts once)."""

    @staticmethod
    def forward(ctx, shard, steps, layout: ShardLayout):
        ctx.steps, ctx.layout = steps, layout
        full = shard
        for dim, ways, group, _, _ in steps:
            full = gather_dim(full, dim, ways, group)
            layout.note("all_gather", full)
        return full

    @staticmethod
    def backward(ctx, g):
        for dim, ways, group, grad, index in reversed(ctx.steps):
            if grad == "sum":
                ctx.layout.note("reduce_scatter", g)
                g = scatter_dim(g, dim, ways, group)
            else:
                n = g.shape[dim] // ways
                g = g.narrow(dim, index * n, n).clone(
                    memory_format=torch.contiguous_format)
        return g, None, None


def _gather_steps(lay: ShardLayout, i: int, role: str = "partial"):
    """Param ``i``'s gathers (:class:`_GatherShard`'s ``steps``): over
    fsdp wherever its spec splits it; over tensor too unless its
    ``role`` (:func:`tensor_lib.roles`) keeps the tensor shard resident
    or tensor parallelism is off; the grad of a ``replicated`` param cut
    to its tensor shard, not summed."""
    out = []
    for d, entry in enumerate(lay.specs[i]):
        for a in reversed(shd.spec_axes(entry)):
            if a == "fsdp":
                out.append((d, lay.fsdp, lay.fsdp_group, "sum",
                            lay.fsdp_index))
            elif (a == "tensor" and lay.tensor_group is not None
                  and role != "resident"):
                out.append((d, lay.tensor, lay.tensor_group,
                            "sum" if role == "partial" else "slice",
                            lay.tensor_index))
    return out


def _gathered(state: TrainState, roles: Sequence[str]
              ) -> List[torch.Tensor]:
    """Every param as the step computes with it: gathered (differentiably,
    into its shard) as :func:`_gather_steps` says for its role."""
    lay = state.layout
    out = []
    for i, p in enumerate(state.params.parameters()):
        steps = _gather_steps(lay, i, roles[i])
        out.append(_GatherShard.apply(p, steps, lay) if steps else p)
    return out


def gather_params(state: TrainState) -> List[torch.Tensor]:
    """Every param whole: the sharded ones gathered over every axis that
    splits them (differentiably, into their shards), the replicated ones
    as they are."""
    return _gathered(state, ["partial"] * len(state.layout.names))


def _step_roles(cfg: TrainConfig, loss_fn, lay: ShardLayout):
    """The sharded step's :class:`tensor_lib.StepGroups` and each
    param's role in it: the plain head (and with it the lookup) is
    vocab-parallel where tensor divides the vocab, as the JAX package
    pins the head's logits to ``P(("data", "fsdp"), None, "tensor")``
    (``tpudist/engine.py:318-328``)."""
    groups = lay.step_groups(loss_fn.plain_head
                             and cfg.model.vocab_size % lay.tensor == 0)
    roles = tensor_lib.roles(lay.names, [d is not None for d in lay.tdims],
                             cfg.model, lay.tensor, groups.vocab_parallel)
    return groups, roles


def _batch_rows(lay: ShardLayout, batch):
    """This process's rows of a global ``batch``: its place among the
    data x fsdp ranks (the expert and tensor ranks of one place share
    them)."""
    return tuple(x.reshape(lay.batch, x.shape[0] // lay.batch,
                           *x.shape[1:])[lay.place] for x in batch)


def _batch_mean(lay: ShardLayout, t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the data x fsdp x context ranks and divided by
    their count, in place (``lax.pmean`` over the batch axes, then over
    ``context``)."""
    lay.note("all_reduce", t)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=lay.mean_group)
    return t.div_(lay.mean_ways)


def _microbatch(loss_fn, params: nn.Module, batch, n_accum: int,
                wrt: Optional[Sequence[torch.Tensor]] = None,
                reduce: Optional[overlap_lib.BucketedMean] = None):
    """(loss, grads) over ``n_accum`` microbatches of ``batch``: the
    losses and grads summed in microbatch order, then scaled by
    1/n_accum, as the JAX package's scan does. The grads are with
    respect to ``wrt`` (the params by default). With ``reduce`` the last
    microbatch's backward hands each final grad (those bits) to it as
    the backward produces them (:meth:`overlap_lib.BucketedMean.hooked`),
    and the grads returned are its means, waited."""
    plist = list(params.parameters()) if wrt is None else list(wrt)
    inv = 1.0 / n_accum
    total, grads = None, None
    for i in range(n_accum):
        mb = batch if n_accum == 1 else tuple(
            x.reshape(n_accum, x.shape[0] // n_accum, *x.shape[1:])[i]
            for x in batch)
        loss = loss_fn(params, mb)
        total = loss.detach() if total is None else total + loss.detach()
        if reduce is not None and i == n_accum - 1:
            with reduce.hooked(plist, grads, None if n_accum == 1 else inv):
                torch.autograd.grad(loss, plist)
            return (total if n_accum == 1 else total * inv), reduce.finish()
        g = torch.autograd.grad(loss, plist)
        grads = list(g) if grads is None else [a + b for a, b in
                                               zip(grads, g)]
    if n_accum == 1:
        return total, grads
    return total * inv, [g * inv for g in grads]


def pmean(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``lax.pmean`` over the processes, in place: one all-reduce SUM a
    tensor, in order, then a divide by the world size (psum, then divide:
    ``ReduceOp.AVG`` does not exist on gloo)."""
    return overlap_lib.barrier_mean(tensors, world=dist.get_world_size())


_OVERLAP_REFUSAL = (
    "{flag} requires the explicit-collective pure-DP mesh (only the "
    "'data' axis > 1); this mesh routes gradients through the "
    "jit+shardings partitioner")

# the slice groups of each (world, slice layout), made once a process:
# every rank makes them in the same order, as dist.new_group asks
_SLICE_COMMS: Dict[tuple, overlap_lib.SliceComms] = {}


def grad_overlap(cfg: TrainConfig, mesh=None):
    """``(mode, bucket_bytes, cross, slices)``: the gradient mean's
    schedule for a step body (``--grad-overlap``, ``--grad-bucket-mb``,
    ``--cross-slice``), as the JAX engine resolves it
    (``tpudist/engine.py:437-479``). On a sharded ``mesh`` a bucketed or
    hierarchical reduce is refused with the JAX message (the reduce there
    is the sharded body's own); without a process group both are inert.
    ``slices`` (:class:`overlap_lib.SliceComms`) is the data axis's slice
    groups when ``TPUDIST_SLICE_MAP`` splits the world into slices, else
    None, and then a hierarchical reduce is downgraded to flat with the
    JAX line."""
    mode, bucket_bytes = config_lib.resolve_grad_overlap(cfg)
    cross = config_lib.resolve_cross_slice(cfg)
    if mesh is not None:
        if mode != "off":
            raise ValueError(_OVERLAP_REFUSAL.format(
                flag=f"--grad-overlap {mode}"))
        if cross == "hierarchical":
            raise ValueError(_OVERLAP_REFUSAL.format(
                flag="--cross-slice hierarchical"))
        return "off", bucket_bytes, "flat", None
    if not dist.is_initialized():
        return "off", bucket_bytes, "flat", None
    world = dist.get_world_size()
    groups = (mesh_lib.data_slice_groups(
        mesh_lib.rank_grid(cfg.parallel, world)) if world > 1 else None)
    if groups is None:
        if cross == "hierarchical" and world > 1:
            log0("tpudist: --cross-slice hierarchical downgraded to "
                 "flat: single-slice mesh (no cross-slice DCN phase to "
                 "shard)")
        return mode, bucket_bytes, "flat", None
    key = (world, groups)
    if key not in _SLICE_COMMS:
        _SLICE_COMMS[key] = overlap_lib.slice_comms(groups)
    return mode, bucket_bytes, cross, _SLICE_COMMS[key]


def bucket_plan(params: nn.Module, bucket_bytes: int
                ) -> overlap_lib.BucketPlan:
    """``--grad-overlap bucketed``'s plan over ``params``: packed in the
    JAX package's leaf order, as its ``plan_buckets`` packs
    ``jax.tree.leaves(params)`` (bucket 0 the last leaves), the indices
    and sizes in ``named_parameters`` order."""
    names, plist = zip(*params.named_parameters())
    rank = jax_leaf_order(names)
    order = sorted(range(len(names)), key=rank.__getitem__)
    plan = overlap_lib.plan_buckets([plist[i] for i in order], bucket_bytes)
    return dataclasses.replace(
        plan, buckets=tuple(tuple(order[i] for i in b)
                            for b in plan.buckets),
        leaf_bytes=tuple(overlap_lib.leaf_nbytes(p) for p in plist))


def _build_step_body(cfg: TrainConfig,
                     device: Optional[torch.device] = None,
                     mesh=None) -> Tuple[Callable, Adam]:
    """``(body, tx)``: ``body(state, batch, count, c1, c2) -> loss``, one
    step on device tensors: loss and grads over this process's batch
    (with ``--grad-accum-steps`` microbatching), their mean over the
    processes when a process group is up, then the Adam update in place
    from the step's device scalars. It reads and writes no host counter,
    so a CUDA graph can capture it; the caller advances ``state.step``
    and ``state.opt_state.count``. ``body.reduced`` lists each
    collective its gradient mean issued, in order: the grads'
    ``(op, dtype, bytes, dcn_participants)`` (``parallel.overlap``),
    then the loss's ``(dtype, bytes)``: a host-side note, written at every eager call
    and at a graph's capture, that ``obs.devtime.collective_bytes``
    turns into the run's collective volume.

    With a ``mesh`` the body is the sharded one
    (:func:`_sharded_step_body`), for a state made on that mesh."""
    loss_fn = make_loss_fn(cfg, device, mesh)
    tx = make_optimizer(cfg)
    mode, bucket_bytes, cross, slices = grad_overlap(cfg, mesh)
    if mesh is not None:
        return _sharded_step_body(cfg, loss_fn, tx), tx
    data_parallel = dist.is_initialized()
    world = dist.get_world_size() if data_parallel else 1
    reduced: List[tuple] = []
    means: List[overlap_lib.BucketedMean] = []

    def bucket_reducer(params: nn.Module) -> overlap_lib.BucketedMean:
        # made at the first (eager) call
        if not means:
            means.append(overlap_lib.BucketedMean(
                bucket_plan(params, bucket_bytes), world=world, cross=cross,
                slices=slices, reduced=reduced))
        return means[0]

    def body(state: TrainState, batch, count, c1, c2):
        # THE collective under test: the gradient mean over the data
        # axis. --grad-overlap off: one all-reduce a param in param order
        # after the whole backward (or the slice ladder over them all);
        # bucketed: each bucket's reduces issued as the backward produces
        # it (parallel.overlap), the same sums. Then the loss's mean, as
        # lax.pmean(loss, "data") gives it
        reduced.clear()
        if data_parallel and mode == "bucketed":
            loss, grads = _microbatch(loss_fn, state.params, batch,
                                      cfg.grad_accum_steps,
                                      reduce=bucket_reducer(state.params))
        else:
            loss, grads = _microbatch(loss_fn, state.params, batch,
                                      cfg.grad_accum_steps)
            if data_parallel:
                grads = overlap_lib.barrier_mean(
                    grads, world=world, cross=cross, slices=slices,
                    reduced=reduced)
        if data_parallel:
            loss, = pmean([loss])
            reduced.append((loss.dtype, loss.element_size())
                           if slices is None else
                           # the world's group spans the slices
                           ("all_reduce", loss.dtype, loss.element_size(),
                            world))
        tx.apply(grads, state.opt_state, list(state.params.parameters()),
                 count, c1, c2)
        return loss
    body.reduced = reduced
    return body, tx


def _sharded_step_body(cfg: TrainConfig, loss_fn: Callable,
                       tx: Adam) -> Callable:
    """The step body on a sharded state (``state.layout``), the JAX
    package's jit+shardings body on a ``data x fsdp x expert x tensor``
    mesh:
    every shard gathered over its fsdp group, and over its tensor group
    unless the rank computes with its tensor shard (:func:`_step_roles`,
    :func:`_gathered`); the loss and the grads over this process's batch
    shard (its ``--grad-accum-steps`` microbatches summed first), the
    models computing their tensor parts with the Megatron operators of
    :mod:`tpudist_torch.parallel.tensor` and the MoE routing over the
    global batch; then ONE backward through the gathers, each grad
    reduce-scattered onto its shard. A grad that is a partial over
    tensor and whose param is whole over it is all-reduced over tensor.
    Then each grad is summed over the rest of data x fsdp x context (over
    data x context for an fsdp-split param, over data x fsdp x context
    for the others) and divided by their count, the loss likewise
    (``lax.pmean`` over the batch axes and ``context``):
    never summed over tensor or expert (an expert shard's grad is whole
    on the rank that computes those experts; every other grad is the
    same on every expert rank). Adam updates the shards and their moments
    in place. ``body.reduced`` is the layout's list of the step's
    collectives, ``(op, dtype, bytes)`` each."""
    reduced: List[tuple] = []

    def body(state: TrainState, batch, count, c1, c2):
        lay = state.layout
        lay.reduced = reduced
        reduced.clear()
        groups, roles = _step_roles(cfg, loss_fn, lay)
        shards = list(state.params.parameters())
        full = _gathered(state, roles)
        with _swapped(state.params, full):
            loss, grads = _microbatch(
                functools.partial(loss_fn, groups=groups), state.params,
                batch, cfg.grad_accum_steps, wrt=full)
        cut = [i for i, (f, s) in enumerate(zip(full, shards)) if f is not s]
        if cut:
            scattered = torch.autograd.grad([full[i] for i in cut],
                                            [shards[i] for i in cut],
                                            [grads[i] for i in cut])
            for i, g in zip(cut, scattered):
                grads[i] = g
        for i, g in enumerate(grads):
            if (roles[i] == "partial" and lay.tdims[i] is None
                    and groups.tp):
                groups.tensor_sum(g)
            if lay.dims[i] is None:
                _batch_mean(lay, g)
                continue
            if lay.data * lay.context > 1:
                lay.note("all_reduce", g)
                dist.all_reduce(g, op=dist.ReduceOp.SUM,
                                group=lay.grad_group)
            g.div_(lay.mean_ways)
        _batch_mean(lay, loss)
        tx.apply(grads, state.opt_state, shards, count, c1, c2)
        return loss
    body.reduced = reduced
    return body


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
                    device: Optional[torch.device] = None,
                    mesh=None) -> Callable:
    """``(state, batch) -> (state, loss)``: one step of the step body
    (the sharded one with a ``mesh``), its scalars filled from the
    host's count first. ``cost_analysis()`` is the step's flop count from
    its first call (None before it); ``reduced_operands()`` the step's
    collectives (``body.reduced``)."""
    body, tx = _build_step_body(cfg, device, mesh)
    scalars = StepScalars(tx, 1, torch.device(device or "cpu"))
    cost: Dict[str, int] = {}

    def step(state: TrainState, batch):
        scalars.fill(state.opt_state.count + 1)
        loss = _counted(body, cost, state, batch, *scalars.row(0))
        _advance(state, 1)
        return state, loss
    step.cost_analysis = lambda: dict(cost) or None
    step.reduced_operands = lambda: list(body.reduced)
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
                 k: int, mesh=None):
        if k < 1:
            raise ValueError(f"superstep length must be >= 1, got {k}")
        self.k = k
        self.device = torch.device(device or "cpu")
        self.body, tx = _build_step_body(cfg, device, mesh)
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

    def reduced_operands(self) -> List[tuple]:
        """One step's collectives as the step body noted them (empty
        without a process group): ``(dtype, bytes)`` an all-reduce, or
        ``(op, dtype, bytes)`` from the sharded body."""
        return list(self.body.reduced)

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
                   k: int, mesh=None) -> Superstep:
    """The k-step superstep dispatch (:class:`Superstep`)."""
    return Superstep(cfg, device, k, mesh)


def make_eval_fn(cfg: TrainConfig, device: Optional[torch.device] = None,
                 mesh=None) -> Callable:
    """``(state, batch) -> loss``, a forward with no update and no graph,
    over the GLOBAL ``batch``: with a process group up, each process
    evaluates its contiguous slice of it (as the JAX package shards the
    eval batch over the data and fsdp axes; a process's place among them
    is its rank, or its data x fsdp place on a mesh, whose tensor ranks
    share a slice) and the mean comes back from an all-reduce, the same
    on every process. A sharded state is gathered for it as the step
    gathers it, and the loss computed as the step computes it."""
    loss_fn = make_loss_fn(cfg, device, mesh)
    data_parallel = dist.is_initialized()

    @torch.no_grad()
    def ev(state: TrainState, batch):
        lay = state.layout
        if lay is not None:
            # the gathers here are not the step's collectives
            lay.reduced = []
            groups, roles = _step_roles(cfg, loss_fn, lay)
            with _swapped(state.params, _gathered(state, roles)):
                loss = loss_fn(state.params, _batch_rows(lay, batch),
                               groups)
            return _batch_mean(lay, loss)
        if not data_parallel:
            return loss_fn(state.params, batch)
        rank, world = dist.get_rank(), dist.get_world_size()
        local = tuple(x.reshape(world, x.shape[0] // world,
                                *x.shape[1:])[rank] for x in batch)
        loss, = pmean([loss_fn(state.params, local)])
        return loss
    return ev


def state_bytes_per_device(state: TrainState) -> int:
    """Bytes of the params and optimizer moments this device holds (all
    of them when replicated, its shards under FSDP)."""
    tensors = list(state.params.parameters()) + state.opt_state.mu \
        + state.opt_state.nu
    return sum(t.numel() * t.element_size() for t in tensors)
