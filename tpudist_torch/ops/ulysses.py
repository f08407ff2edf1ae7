"""Ulysses-style sequence parallelism: all-to-all head <-> sequence
reshard.

Counterpart of ``tpudist/ops/ulysses.py``, the second long-context
strategy beside ring attention (:mod:`tpudist_torch.ops.ring_attention`):
instead of rotating key/value blocks around a ring, TWO all-to-alls over
the context group reshard the activations so each rank sees the FULL
sequence for a slice of the heads:

    (batch, s/n, heads, hd)  --all_to_all-->  (batch, s, heads/n, hd)
        attention over the full sequence, local heads only
    (batch, s, heads/n, hd)  --all_to_all-->  (batch, s/n, heads, hd)

The attention in between is the single-device one the transformer routes
(:func:`tpudist_torch.models.transformer._attention`: the flash kernels
where the shapes qualify), with no masking games and perfect causal load
balance; the shards stay CONTIGUOUS (no zigzag permutation), so RoPE
takes plain offset positions.

Trade-off against the ring: Ulysses moves activations twice a layer in
two all-to-alls (about 4 b s d / n a rank) whatever the causality, and
its parallelism is capped by the head count; the ring moves k/v blocks
n-1 times but overlaps transfers with compute and scales past the head
count. Both are first-class: ``--cp-impl ulysses|ring``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def _all_to_all(x: torch.Tensor, split: int, concat: int, group,
                reduced: Optional[list]) -> torch.Tensor:
    """The tiled all-to-all over ``group``'s n ranks: ``x``'s ``split``
    dim cut into n pieces, piece j sent to rank j; the pieces received
    concatenated along ``concat`` in rank order."""
    n = dist.get_world_size(group)
    shape = list(x.shape)
    parts = x.reshape(*shape[:split], n, shape[split] // n,
                      *shape[split + 1:]).movedim(split, 0).contiguous()
    out = torch.empty_like(parts)
    if reduced is not None:
        reduced.append(("all_to_all", x.dtype,
                        parts.numel() * parts.element_size()))
    dist.all_to_all_single(out, parts, group=group)
    whole = list(parts.shape[1:])
    whole[concat] *= n
    return out.movedim(0, concat).reshape(whole)


class _AllToAll(torch.autograd.Function):
    """:func:`_all_to_all` forward; the inverse all-to-all (split and
    concat swapped) backward."""

    @staticmethod
    def forward(ctx, x, split, concat, group, reduced):
        ctx.args = (split, concat, group, reduced)
        return _all_to_all(x, split, concat, group, reduced)

    @staticmethod
    def backward(ctx, g):
        split, concat, group, reduced = ctx.args
        return (_all_to_all(g, concat, split, group, reduced), None, None,
                None, None)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      group=None, *, causal: bool = True, attn_impl=None,
                      reduced: Optional[list] = None) -> torch.Tensor:
    """Attention under sequence sharding over ``group`` (None: the world)
    via head <-> sequence all-to-alls.

    q: (batch, s_local, heads, hd), this rank's contiguous sequence
    shard; k/v may carry fewer (grouped-query) kv heads. Both head counts
    must divide by the group's size. ``attn_impl(q, k, v, causal=)`` is
    the single-device attention (the transformer's ``_attention`` by
    default). Each all-to-all is noted ``("all_to_all", dtype, bytes)``
    into ``reduced`` (a step's collective list) when given. On a CUDA
    tensor the default attention must take the flash kernels at the
    head-split shapes: other shapes raise, never the plain version."""
    n = dist.get_world_size(group)
    for name, x in (("q heads", q.shape[2]), ("kv heads", k.shape[2])):
        if x % n:
            raise ValueError(
                f"ulysses needs {name} ({x}) divisible by the context "
                f"axis size ({n}); use --cp-impl ring when the head "
                f"count doesn't factor over the axis")
    if attn_impl is None:
        from tpudist_torch.models.transformer import _attention, _use_flash
        attn_impl = _attention
        b, s, h, hd = q.shape
        q_sh, k_sh = (b, s * n, h // n, hd), (b, s * n, k.shape[2] // n, hd)
        if q.is_cuda and not _use_flash(q_sh, k_sh, causal):
            raise ValueError(
                f"a CUDA tensor takes the flash kernels only, and ulysses' "
                f"head-split shapes q {q_sh} k {k_sh} (causal={causal}) "
                f"don't satisfy their rules")

    def seq_to_heads(x):
        # (b, s/n, h, hd) -> (b, s, h/n, hd)
        return _AllToAll.apply(x, 2, 1, group, reduced)

    o = attn_impl(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v),
                  causal=causal)
    # (b, s, h/n, hd) -> (b, s/n, h, hd)
    return _AllToAll.apply(o, 1, 2, group, reduced)
