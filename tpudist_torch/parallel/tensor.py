"""Tensor parallelism written out: the Megatron boundary operators, the
vocab-parallel head and lookup, and the groups a sharded step's loss
reads.

The JAX package has no such module: its specs alone shard the weights
(``tpudist/models/transformer.py:547-582``, ``tpudist/models/moe.py:255-277``)
and GSPMD inserts the collectives. The port keeps each rank's tensor
shard resident and computes its own heads, FFN columns and vocab
columns, so it writes the collectives GSPMD would insert:

* :meth:`StepGroups.enter` at the input of a column-parallel block:
  identity forward, all-reduce (sum) over ``tensor`` backward (the
  block's input grads are partial sums, one a rank's columns);
* :meth:`StepGroups.exit` at the output of a row-parallel block:
  all-reduce forward (the partial products summed), identity backward;
* :func:`vocab_parallel_xent`: the plain head's cross-entropy on a
  rank's vocab columns, its logsumexp merged across ranks;
* :meth:`StepGroups.embed`: the lookup of a rank's vocab rows, summed
  over ``tensor``, so the table's grad is a partial a rank.

The routed FFN of the MoE uses the same two operators over its own group
when the experts dim is split over ``expert`` (``expert_group``: the
expert x tensor ranks of one batch place; the JAX package's expert
weights ``P('pipe', 'expert', 'fsdp', 'tensor')``): a rank computes its
experts' capacity rows (and, under ``tensor``, its hidden columns of
them), :meth:`StepGroups.enter` sums the partial grads of the tokens and
the combine weights over the group, :meth:`StepGroups.exit` the partial
outputs. The batch is replicated over ``expert``, as the JAX package's
``batch_spec`` replicates it, so nothing else of the step changes. A
routing group that spans the data x fsdp ranks routes from the router
probabilities :meth:`StepGroups.batch_gather` collects.

Which part of a dim a rank computes is :meth:`StepGroups.part`: the even
split where the dim divides, a nearly even one where it does not (the
weight then reaches the step whole and its grad is summed over
``tensor``; ``engine`` decides that from :func:`roles`).

The context ranks of a place (``context_group``) hold the same rows and
split their sequence; the ring's rotations and Ulysses's all-to-alls
over them live in :mod:`tpudist_torch.ops.ring_attention` and
:mod:`tpudist_torch.ops.ulysses`, which note theirs into ``reduced`` too.

Every collective here is an in-place ``torch.distributed`` call on a
tensor the operator owns, so a CUDA graph captures it as it captures the
FSDP gathers; a note of each goes to the step's ``reduced`` list.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclass
class StepGroups:
    """What a sharded step's loss needs of the mesh: the ``tensor`` ways,
    this rank's index among them and their group (None: tensor
    parallelism off, every model computes whole), the ``data x fsdp``
    ways the batch splits over, this rank's place among them and their
    group (None: the world), whether the plain head and the lookup are
    vocab-parallel (``vocab_parallel``), and the ``expert`` ways, this
    rank's index among them and the group the MoE's expert partials
    reduce over (``expert_group``, the expert x tensor ranks of a batch
    place; None: the experts dim is not split and every rank computes
    every expert), and the ``context`` ways, this rank's index among
    them and their group (``context_group``: the ranks that differ from
    this one only along ``context``, which split the sequence of the
    rows they share). ``reduced`` collects the ``(op, dtype, bytes)`` of
    each collective the operators issue."""

    tensor: int = 1
    tensor_index: int = 0
    tensor_group: object = None
    batch: int = 1
    batch_group: object = None
    vocab_parallel: bool = False
    reduced: List[tuple] = field(default_factory=list)
    batch_index: int = 0
    expert: int = 1
    expert_index: int = 0
    expert_group: object = None
    context: int = 1
    context_index: int = 0
    context_group: object = None

    @property
    def tp(self) -> bool:
        """Is tensor parallelism on (a tensor group to reduce over)?"""
        return self.tensor_group is not None

    def part(self, n: int) -> Tuple[int, int]:
        """This rank's ``[lo, hi)`` of a dim of ``n`` split over
        ``tensor``: ``n / tensor`` each where that divides, else as
        evenly as integers allow."""
        t, ways = self.tensor_index, self.tensor
        return t * n // ways, (t + 1) * n // ways

    def expert_part(self, n: int) -> Tuple[int, int]:
        """This rank's ``[lo, hi)`` of ``n`` experts split over
        ``expert`` (the sanitized spec splits them only where that
        divides)."""
        e, ways = self.expert_index, self.expert
        return e * n // ways, (e + 1) * n // ways

    def _all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM,
                    group=None) -> torch.Tensor:
        self.reduced.append(("all_reduce", t.dtype,
                             t.numel() * t.element_size()))
        dist.all_reduce(t, op=op, group=group)
        return t

    def tensor_sum(self, t: torch.Tensor, op=dist.ReduceOp.SUM
                   ) -> torch.Tensor:
        """``t`` reduced over ``tensor`` in place."""
        return self._all_reduce(t, op, self.tensor_group)

    def enter(self, x: torch.Tensor, group=None) -> torch.Tensor:
        """Identity forward, all-reduce over ``group`` (``tensor`` by
        default) backward."""
        return _Enter.apply(x, self, self.tensor_group if group is None
                            else group)

    def exit(self, x: torch.Tensor, group=None) -> torch.Tensor:
        """All-reduce over ``group`` (``tensor`` by default) forward,
        identity backward."""
        return _Exit.apply(x, self, self.tensor_group if group is None
                           else group)

    def batch_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` of every ``data x fsdp`` rank stacked along its first
        dim in the ranks' place order (this rank's rows at ``batch_index
        * len(x)``), differentiably: the backward reduce-scatters the
        upstream grads onto each rank's rows, summed over the ranks,
        which the step's divide by ``data x fsdp`` turns into the grad
        of a global mean. Identity when the batch is not split."""
        if self.batch == 1:
            return x
        return _BatchGather.apply(x, self)

    def batch_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ``data x fsdp`` ranks, differentiably:
        the backward sums the upstream grads over the same ranks, which
        the step's divide by ``data x fsdp`` turns into the grad of a
        global mean. Identity when the batch is not split."""
        if self.batch == 1:
            return x
        return _BatchSum.apply(x, self)

    def embed(self, table: torch.Tensor, tokens: torch.Tensor,
              dtype) -> torch.Tensor:
        """The vocab-parallel lookup: this rank's vocab rows of the
        whole ``table`` looked up where a token falls in them, zero
        elsewhere, summed over ``tensor`` (one term of each sum is
        nonzero, so the sum is exact); the table's grad on a rank is
        then nonzero on its rows only, a partial that sums over
        ``tensor``."""
        lo, hi = self.part(table.shape[0])
        local = tokens - lo
        inside = (local >= 0) & (local < hi - lo)
        rows = table[lo:hi][local.clamp(0, hi - lo - 1)]
        x = torch.where(inside[..., None], rows, torch.zeros_like(rows))
        return self.exit(x.to(dtype))

    def attention_weights(self, lp: Dict[str, torch.Tensor], n_heads: int,
                          n_kv_heads: int, head_dim: int):
        """This rank's attention weights and heads: ``(wq, wk, wv, wo,
        kv_index)``. The q heads are :meth:`part` of ``n_heads``; ``wq``
        and ``wo`` come resident (split at head boundaries: ``n_heads``
        divides) or whole, and are then cut to those heads. ``wk`` and
        ``wv`` come resident when both head counts divide, else whole,
        cut to the kv heads the rank's q heads read. ``kv_index`` is
        None when the rank's q heads keep compact GQA over those kv
        heads (consecutive q heads sharing one, evenly), else the kv head
        (of those) each q head reads, for the caller to expand."""
        hd = head_dim
        q0, q1 = self.part(n_heads)
        wq, wo = lp["wq"], lp["wo"]
        if wq.shape[-1] == n_heads * hd:
            wq = wq[..., q0 * hd:q1 * hd]
            wo = wo[q0 * hd:q1 * hd]
        group = n_heads // n_kv_heads
        k0, k1 = q0 // group, (q1 - 1) // group + 1
        wk, wv = lp["wk"], lp["wv"]
        if wk.shape[-1] == n_kv_heads * hd:
            wk = wk[..., k0 * hd:k1 * hd]
            wv = wv[..., k0 * hd:k1 * hd]
        nq, nk = q1 - q0, k1 - k0
        reads = [(q0 + j) // group - k0 for j in range(nq)]
        compact = nq % nk == 0 and reads == [j // (nq // nk)
                                             for j in range(nq)]
        return wq, wk, wv, wo, (None if compact else reads)

    def ffn_weights(self, w_in: Sequence[torch.Tensor],
                    w_out: torch.Tensor, d_ff: int):
        """This rank's FFN columns: the column-parallel ``w_in`` (hidden
        on their last dim) and the row-parallel ``w_out`` (hidden on its
        second to last), cut to :meth:`part` of ``d_ff`` where they come
        whole."""
        f0, f1 = self.part(d_ff)
        w_in = [w[..., f0:f1] if w.shape[-1] == d_ff else w for w in w_in]
        if w_out.shape[-2] == d_ff:
            w_out = w_out[..., f0:f1, :]
        return w_in, w_out


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups: StepGroups, group):
        ctx.groups, ctx.group = groups, group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.groups._all_reduce(g.contiguous().clone(),
                                      group=ctx.group), None, None


class _Exit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups: StepGroups, group):
        return groups._all_reduce(x.contiguous().clone(), group=group)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def collective(fn, *args, **kw):
    """A ``torch.distributed`` call by a name both torch versions the
    port meets have (newer ones deprecate ``all_gather_into_tensor`` and
    ``reduce_scatter_tensor`` with a warning a call)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return fn(*args, **kw)


class _BatchGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups: StepGroups):
        ctx.groups = groups
        x = x.contiguous()
        out = x.new_empty((groups.batch * x.shape[0], *x.shape[1:]))
        groups.reduced.append(("all_gather", out.dtype,
                               out.numel() * out.element_size()))
        collective(dist.all_gather_into_tensor, out, x,
               group=groups.batch_group)
        return out

    @staticmethod
    def backward(ctx, g):
        groups = ctx.groups
        g = g.contiguous()
        out = g.new_empty((g.shape[0] // groups.batch, *g.shape[1:]))
        groups.reduced.append(("reduce_scatter", g.dtype,
                               g.numel() * g.element_size()))
        collective(dist.reduce_scatter_tensor, out, g, op=dist.ReduceOp.SUM,
               group=groups.batch_group)
        return out, None


class _BatchSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups: StepGroups):
        ctx.groups = groups
        return groups._all_reduce(x.contiguous().clone(),
                                  group=groups.batch_group)

    @staticmethod
    def backward(ctx, g):
        groups = ctx.groups
        return groups._all_reduce(g.contiguous().clone(),
                                  group=groups.batch_group), None


class _VocabParallelXent(torch.autograd.Function):
    """:class:`tpudist_torch.models.transformer._Xent` on a rank's vocab
    columns ``[lo, lo + V_local)``: the row logsumexp merged across the
    ``tensor`` ranks (an all-reduce of the max of the ranks' lse, then of
    the sum of their exps about it), the gold logit a masked gather
    summed over ``tensor``; the backward the same ``(softmax - onehot)
    * ct / n`` on the rank's columns."""

    @staticmethod
    def forward(ctx, logits, targets, lo: int, groups: StepGroups):
        lf = logits.to(torch.float32)
        n_local = logits.shape[-1]
        local = targets.long() - lo
        inside = (local >= 0) & (local < n_local)
        lse = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, local.clamp(0, n_local - 1)[..., None]
                            )[..., 0]
        gold = torch.where(inside, gold, torch.zeros_like(gold))
        if groups.tp:
            top = groups.tensor_sum(lse.clone(), dist.ReduceOp.MAX)
            lse = top + torch.log(groups.tensor_sum(torch.exp(lse - top)))
            gold = groups.tensor_sum(gold)
        ctx.save_for_backward(logits, lse, local)
        return torch.mean(lse - gold)

    @staticmethod
    def backward(ctx, ct):
        logits, lse, local = ctx.saved_tensors
        n = logits.numel() // logits.shape[-1]
        p = torch.exp(logits.to(torch.float32) - lse[..., None])
        iota = torch.arange(logits.shape[-1], device=logits.device)
        onehot = iota == local[..., None]
        dlogits = ((p - onehot.to(torch.float32)) * (ct / n)).to(
            logits.dtype)
        return dlogits, None, None, None


def vocab_parallel_xent(table: torch.Tensor, h: torch.Tensor,
                        targets: torch.Tensor,
                        groups: StepGroups) -> torch.Tensor:
    """The plain tied head and mean cross-entropy with the vocab split
    over ``tensor``: this rank's ``(tokens, V / tensor)`` logits from its
    rows of the whole ``table``, ``h`` entering as a column-parallel
    block's input (its grad a partial a rank)."""
    lo, hi = groups.part(table.shape[0])
    logits = groups.enter(h) @ table[lo:hi].T
    return _VocabParallelXent.apply(logits, targets, lo, groups)


# the params each model splits over tensor, by role: "qo" the q heads
# (wq, wo), "kv" the kv heads (wk, wv), "ffn" the FFN hidden dim
_TENSOR_ROLES = {"layers.wq": "qo", "layers.wo": "qo", "layers.wk": "kv",
                 "layers.wv": "kv", "layers.w_gate": "ffn",
                 "layers.w_up": "ffn", "layers.w_down": "ffn"}


def roles(names: Sequence[str], tensor_cut: Sequence[bool], model_cfg,
          tensor: int, vocab_parallel: bool) -> List[str]:
    """Each param's part in a tensor-parallel step: ``resident`` (its
    storage split over ``tensor`` is the part the rank computes: no
    tensor collective on it), ``partial`` (it reaches the step whole
    and the rank computes with its part, so its grad is a partial that
    sums over ``tensor``) or ``replicated`` (every tensor rank computes
    it whole and alike, so its grad is counted once). ``tensor_cut``
    says which params' storage the sanitized spec splits over
    ``tensor``. Heads stay whole on a rank: ``wq``/``wo`` are resident
    where ``n_heads`` divides, ``wk``/``wv`` where both head counts do;
    the table is partial under the vocab-parallel head and lookup."""
    h, kv = model_cfg.n_heads, model_cfg.n_kv_heads
    whole_heads = {"qo": h % tensor == 0,
                   "kv": h % tensor == 0 and kv % tensor == 0,
                   "ffn": True}
    out = []
    for name, cut in zip(names, tensor_cut):
        role = _TENSOR_ROLES.get(name)
        if name == "embed":
            out.append("partial" if vocab_parallel else "replicated")
        elif role is None:
            out.append("replicated")
        else:
            out.append("resident" if cut and whole_heads[role]
                       else "partial")
    return out
