"""Ring attention: context parallelism over the ``context`` ranks.

Counterpart of ``tpudist/ops/ring_attention.py``. The sequence is split
over the ranks of a context group; each rank computes attention for its
own query chunks while the key/value blocks rotate around the ring
(:class:`GroupRotation`: this rank's blocks to the next rank, the
previous rank's to it, ``torch.distributed.batch_isend_irecv``). Memory
per rank is O(S/n) and no rank holds the whole S x S score matrix. Each
hop's rotation is issued *before* the current block is consumed and
waited for only when the next hop reads its blocks, so the transfer has
no data dependence on the hop's compute.

Causal load balance, the ``zigzag`` layout (default): the sequence is
split into 2n chunks and rank r holds the PAIR (r, 2n-1-r), one early
chunk and one late one. Under causality exactly two of the four chunk
pairs of a remote hop are live, and both are fully unmasked:

  * q_high x k_low, always (the high chunk 2n-1-r is later than every
    low chunk src < n);
  * q_low x k_low(src) when src < r, else q_high x k_high(src): the
    "diagonal" pair, strictly ordered either way.

Only the local block needs masks (the intra-chunk causal triangles).
Every rank computes the same two chunk products a hop (three locally).
The loss is a token mean, so the permutation needs no inverse on the
loss path; callers that need outputs in sequence order apply
:func:`zigzag_inverse`. The source rank of a hop is a Python int known
when the step is built, so the diagonal pair is picked with a plain
``if``: its kernel runs once a hop and the step's graph stays static.

Hop compute has two implementations, selected by ``use_flash``:

  * **flash** (wherever the chunk shapes qualify, on every device): each
    hop's chunk attention is a call of
    :func:`tpudist_torch.ops.cuda.flash_attention.flash_attention_with_lse`
    (the Hopper kernels for CUDA tensors, their plain versions for CPU
    tensors), and the partials ``(o_i, lse_i)`` merge with
    :func:`merge_partials`. The kernel's lse output is differentiable
    (its cotangent folds into the backward's delta), so autograd through
    the merge reaches each hop's kernel backward. kv stays compact (GQA)
    on the ring.
  * **einsum**: f32 einsum hops with the explicit online-softmax state
    (:func:`_update`), the reference the flash hops are held to.

The merge, the permutation and the einsum schedule are plain PyTorch, as
the JAX package computes them in XLA outside any Pallas kernel.

The rotation is an object the schedule is given (``rot``): over a
process group (:class:`GroupRotation`) in a run, or over ``n`` virtual
ranks in one process (:class:`VirtualRotation`, each hop's blocks handed
over in ring order), a check harness that drives the same schedule on
one device.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from tpudist_torch.ops.cuda import flash_attention as fa

NEG = -1e30


# ------------------------------------------------------------- zigzag layout


def zigzag_order(n: int) -> List[int]:
    """Chunk ids (of 2n sequence chunks) in on-rank order: rank r holds
    [r, 2n-1-r], concatenated over ranks."""
    out: List[int] = []
    for r in range(n):
        out += [r, 2 * n - 1 - r]
    return out


def zigzag_permute(x: torch.Tensor, n: int, axis: int = 1) -> torch.Tensor:
    """Reorder a sequence axis into zigzag layout: after a contiguous
    n-way split, rank r's slice holds chunks (r, 2n-1-r) of the
    original."""
    s = x.shape[axis]
    if s % (2 * n):
        raise ValueError(f"sequence length {s} not divisible by 2*n={2 * n} "
                         "(zigzag context layout)")
    chunks = torch.chunk(x, 2 * n, dim=axis)
    return torch.cat([chunks[i] for i in zigzag_order(n)], dim=axis)


def zigzag_inverse(x: torch.Tensor, n: int, axis: int = 1) -> torch.Tensor:
    """Inverse of :func:`zigzag_permute`."""
    order = zigzag_order(n)
    inv = [0] * len(order)
    for pos, cid in enumerate(order):
        inv[cid] = pos
    chunks = torch.chunk(x, 2 * n, dim=axis)
    return torch.cat([chunks[i] for i in inv], dim=axis)


def zigzag_positions(me: int, s_local: int, n: int,
                     device=None) -> torch.Tensor:
    """Absolute token positions of rank ``me``'s local zigzag slice
    (chunks me and 2n-1-me), for RoPE."""
    c = s_local // 2
    ar = torch.arange(c, device=device)
    return torch.cat([me * c + ar, (2 * n - 1 - me) * c + ar])


# --------------------------------------------------------- the rotations


class _Rotate(torch.autograd.Function):
    """Forward: ``tensors`` sent to the next rank of ``rot``'s ring, the
    previous rank's received (the wait deferred to :meth:`GroupRotation.
    wait`); backward: the cotangents rotated the other way."""

    @staticmethod
    def forward(ctx, rot, *tensors):
        ctx.rot = rot
        outs, works = rot.issue(tensors, forward=True)
        rot.pending += works
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        rot = ctx.rot
        grads = [g.contiguous() for g in grads]
        outs, works = rot.issue(grads, forward=False)
        for w, _ in works:
            w.wait()
        return (None, *outs)


class GroupRotation:
    """The ring over a process ``group`` (None: the world): ``n`` ranks,
    this one ``rank`` of them. :meth:`rotate` issues the sends and
    receives of one hop (one ``batch_isend_irecv``) and returns the
    receive buffers; :meth:`wait` completes them before a hop reads the
    blocks. Each hop's tensors are noted ``("collective_permute", dtype,
    bytes)`` into ``reduced`` (a step's collective list) when given."""

    def __init__(self, group=None, reduced: Optional[list] = None):
        self.group = group
        self.n = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        ranks = [dist.get_global_rank(group, i) if group is not None else i
                 for i in range(self.n)]
        self.next = ranks[(self.rank + 1) % self.n]
        self.prev = ranks[(self.rank - 1) % self.n]
        self.reduced = reduced
        self.pending: list = []

    def issue(self, tensors: Sequence[torch.Tensor], forward: bool):
        dst, src = (self.next, self.prev) if forward else (self.prev,
                                                          self.next)
        outs = [torch.empty_like(t) for t in tensors]
        ops = []
        for t, o in zip(tensors, outs):
            if self.reduced is not None:
                self.reduced.append(("collective_permute", t.dtype,
                                     t.numel() * t.element_size()))
            ops += [dist.P2POp(dist.isend, t, dst, group=self.group),
                    dist.P2POp(dist.irecv, o, src, group=self.group)]
        # the sent tensors stay referenced by the works until the wait
        return outs, [(w, tensors) for w in dist.batch_isend_irecv(ops)]

    def rotate(self, k: torch.Tensor, v: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        return _Rotate.apply(self, k.contiguous(), v.contiguous())

    def wait(self) -> None:
        for w, _ in self.pending:
            w.wait()
        self.pending.clear()


class VirtualRotation:
    """The ring of virtual rank ``rank`` of ``n`` in one process: hop
    ``i`` hands over rank ``(rank - i) % n``'s blocks of ``ks`` / ``vs``
    (every rank's, in rank order), as the ring would have delivered
    them. A check harness for the schedules on one device; no run takes
    it."""

    def __init__(self, ks: Sequence[torch.Tensor],
                 vs: Sequence[torch.Tensor], rank: int):
        self.ks, self.vs = list(ks), list(vs)
        self.n, self.rank = len(self.ks), rank
        self.hop = 0

    def rotate(self, k, v):
        del k, v
        self.hop += 1
        src = (self.rank - self.hop) % self.n
        return self.ks[src], self.vs[src]

    def wait(self) -> None:
        pass


# --------------------------------------------------------- online softmax


def _update(scores, vf, num, den, mx):
    """Fold one (b,h,q,k) score block into the (num, den, mx) state."""
    blk_max = scores.amax(dim=-1)                          # (b,h,q)
    new_mx = torch.maximum(mx, blk_max)
    corr = torch.exp(mx - new_mx)
    p = torch.exp(scores - new_mx[..., None])              # (b,h,q,k)
    num = num * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vf)
    den = den * corr + p.sum(dim=-1)
    return num, den, new_mx


def flash_hops_supported(q_shape, k_shape, *, layout: str = "zigzag",
                         causal: bool = True, n_shards: int = 2) -> bool:
    """Can the per-hop chunk shapes run the flash kernel? Zigzag hops
    work on half-shard chunks (c = s_local/2), contig hops on whole
    shards; a degenerate size-1 ring (``n_shards=1``) makes exactly one
    whole-shard call, so only that shape must qualify. The causal contig
    schedule masks each hop against its source rank, which the kernel's
    mask cannot express: einsum only."""
    b, s, h, d = q_shape
    kvh = k_shape[2]
    if n_shards == 1:
        return fa.supports((b, s, h, d), (b, k_shape[1], kvh, d),
                           causal=causal)
    if layout == "zigzag" and causal:
        if s % 2:
            return False
        c = s // 2
        # remote hops: unmasked (c x c); local block: causal (s x s)
        return (fa.supports((b, c, h, d), (b, c, kvh, d), causal=False)
                and fa.supports((b, s, h, d), (b, s, kvh, d), causal=True))
    if not causal:
        return fa.supports((b, s, h, d), (b, k_shape[1], kvh, d),
                           causal=False)
    return False


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         rot, *, causal: bool = True,
                         layout: str = "zigzag",
                         use_flash: Optional[bool] = None) -> torch.Tensor:
    """One rank's ring attention.

    q: the local block ``(batch, s_local, heads, head_dim)``; k, v may
    have fewer (grouped-query) kv heads, expanded inside the block
    compute, so only the COMPACT kv blocks travel the ring. ``rot`` is
    the ring (:class:`GroupRotation` or :class:`VirtualRotation`). With
    ``layout="zigzag"`` (causal only) the caller must have permuted the
    sequence with :func:`zigzag_permute`. Returns the local output block
    ``(batch, s_local, heads, head_dim)``.

    ``use_flash``: None takes the flash kernel hops wherever the chunk
    shapes qualify (:func:`flash_hops_supported`); elsewhere it takes the
    einsum hops on a CPU tensor and raises on a CUDA one (a run on the
    card launches the kernels or stops); True forces the kernel (raising
    if the shapes do not qualify); False forces the einsum path, the
    plain version the checks hold the kernel hops against."""
    if layout not in ("zigzag", "contig"):
        raise ValueError(f"unknown ring layout {layout!r}")
    n = rot.n
    supported = flash_hops_supported(q.shape, k.shape, layout=layout,
                                     causal=causal, n_shards=n)
    if use_flash is None and not q.is_cuda:
        use_flash = supported
    elif use_flash is not False:
        if not supported:
            why = ("use_flash=True" if use_flash else
                   "a CUDA tensor takes the flash hops only,")
            raise ValueError(
                f"{why} but hop shapes q {tuple(q.shape)} k "
                f"{tuple(k.shape)} (layout={layout!r}, causal={causal}, "
                f"n={n}) don't satisfy the flash kernel's rules; gate on "
                f"flash_hops_supported()")
        use_flash = True
    # n=1 is a degenerate ring (no remote hops): one local call
    if n == 1:
        if use_flash:
            o, _ = _flash_chunk(q, k, v, causal=causal)
            return o.to(q.dtype)
        return _ring_contig(q, k, v, rot, causal=causal)
    if layout == "zigzag" and causal:
        if use_flash:
            return _ring_zigzag_flash(q, k, v, rot)
        return _ring_zigzag(q, k, v, rot)
    if use_flash and not causal:
        return _ring_contig_flash(q, k, v, rot)
    return _ring_contig(q, k, v, rot, causal=causal)


def _expand_gqa(x: torch.Tensor, rep: int) -> torch.Tensor:
    xf = x.to(torch.float32)
    return xf.repeat_interleave(rep, dim=2) if rep != 1 else xf


def _ring_sweep(k, v, rot, state, consume, *, start: int):
    """The ring loop all four hop schedules share.

    ``consume(i, k_cur, v_cur, state) -> state`` folds hop ``i`` (the
    block that originated ``i`` ranks upstream) into the state. Each
    hop's rotation of the NEXT block is issued before the hop's consume
    and waited for after it; the final hop only consumes. ``start=0``
    consumes the resident local block inside the sweep (contig);
    ``start=1`` expects the caller to have consumed it already and
    begins with one rotation."""
    n = rot.n
    if start:
        k, v = rot.rotate(k, v)
        rot.wait()
    for i in range(start, n - 1):
        k_nxt, v_nxt = rot.rotate(k, v)
        state = consume(i, k, v, state)
        rot.wait()
        k, v = k_nxt, v_nxt
    return consume(n - 1, k, v, state)


def _ring_contig(q, k, v, rot, *, causal: bool) -> torch.Tensor:
    """Contiguous-shard ring: every rank consumes every kv block (the only
    option without causality; under causality prefer zigzag)."""
    n, me = rot.n, rot.rank
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    scale = 1.0 / math.sqrt(d)
    qf = q.to(torch.float32)
    q_pos = me * s + torch.arange(s, device=q.device)

    def consume(i, k_cur, v_cur, st):
        kf = _expand_gqa(k_cur, rep)
        vf = _expand_gqa(v_cur, rep)
        scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
        if causal:
            k_pos = ((me - i) % n) * s + torch.arange(s, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
            scores = torch.where(mask[None, None], scores,
                                 torch.full_like(scores, NEG))
        return _update(scores, vf, *st)

    f32 = dict(dtype=torch.float32, device=q.device)
    state = (torch.zeros((b, h, s, d), **f32), torch.zeros((b, h, s), **f32),
             torch.full((b, h, s), NEG, **f32))
    num, den, _ = _ring_sweep(k, v, rot, state, consume, start=0)
    out = num / den.clamp_min(1e-30)[..., None]               # (b,h,q,d)
    return out.permute(0, 2, 1, 3).to(q.dtype)                # (b,q,h,d)


def _ring_zigzag(q, k, v, rot) -> torch.Tensor:
    """Zigzag-layout causal ring (see the module docstring for the
    schedule)."""
    n, me = rot.n, rot.rank
    b, s, h, d = q.shape
    if s % 2:
        raise ValueError("zigzag layout needs an even local sequence length")
    c = s // 2
    rep = h // k.shape[2]
    scale = 1.0 / math.sqrt(d)
    qf = q.to(torch.float32)
    q_lo, q_hi = qf[:, :c], qf[:, c:]
    ar = torch.arange(c, device=q.device)
    tri = (ar[:, None] >= ar[None, :])[None, None]

    def scores_of(q_chunk, k_chunk, mask=None):
        sc = torch.einsum("bqhd,bkhd->bhqk", q_chunk, k_chunk) * scale
        if mask is not None:
            sc = torch.where(mask, sc, torch.full_like(sc, NEG))
        return sc

    f32 = dict(dtype=torch.float32, device=q.device)

    def zero_state():
        return (torch.zeros((b, h, c, d), **f32),
                torch.zeros((b, h, c), **f32),
                torch.full((b, h, c), NEG, **f32))

    # the local block (the only masked hop): 3 live chunk pairs
    kf = _expand_gqa(k, rep)
    vf = _expand_gqa(v, rep)
    k_lo, k_hi = kf[:, :c], kf[:, c:]
    v_lo, v_hi = vf[:, :c], vf[:, c:]
    lo = _update(scores_of(q_lo, k_lo, tri), v_lo, *zero_state())
    hi = _update(scores_of(q_hi, k_lo), v_lo, *zero_state())
    hi = _update(scores_of(q_hi, k_hi, tri), v_hi, *hi)

    def consume_remote(i, k_cur, v_cur, st):
        """Two unmasked chunk pairs: q_hi x k_lo always; the diagonal
        pair to q_lo (src < me) or to q_hi (src > me)."""
        lo, hi = st
        src = (me - i) % n
        kf = _expand_gqa(k_cur, rep)
        vf = _expand_gqa(v_cur, rep)
        k_lo, k_hi = kf[:, :c], kf[:, c:]
        v_lo, v_hi = vf[:, :c], vf[:, c:]
        hi = _update(scores_of(q_hi, k_lo), v_lo, *hi)
        if src < me:
            lo = _update(scores_of(q_lo, k_lo), v_lo, *lo)
        else:
            hi = _update(scores_of(q_hi, k_hi), v_hi, *hi)
        return lo, hi

    # hops 1..n-1: the local block was consumed above (start=1)
    lo, hi = _ring_sweep(k, v, rot, (lo, hi), consume_remote, start=1)

    def finish(num, den, mx):
        out = num / den.clamp_min(1e-30)[..., None]           # (b,h,c,d)
        return out.permute(0, 2, 1, 3)                        # (b,c,h,d)

    return torch.cat([finish(*lo), finish(*hi)], dim=1).to(q.dtype)


# ----------------------------------------------------- flash-kernel hops


def _flash_chunk(q, k, v, *, causal: bool):
    """One hop's chunk attention through the flash kernel (its plain
    version for CPU tensors): ``(o, lse)``, o (b, c, h, d) upcast to f32
    (the cross-hop merge accumulates in f32 whatever the kernel's
    dtype), lse (b, h, c) f32. q/k arrive rotated: the kernel's RoPE
    fusion is not used here. The chunks are made contiguous, as the
    kernel reads them."""
    o, lse = fa.flash_attention_with_lse(q.contiguous(), k.contiguous(),
                                         v.contiguous(), causal=causal)
    return o.to(torch.float32), lse


def merge_partials(o_a, lse_a, o_b, lse_b):
    """Merge two partial-attention results over disjoint kv sets.

    o: (b, c, h, d) f32 partial outputs; lse: (b, h, c) f32 per-row
    log-sum-exp. ``lse = logaddexp(lse_a, lse_b)`` and the outputs
    combine with weights ``exp(lse_i - lse)``: the online-softmax
    rescale on finished partials. Differentiating through the merge
    feeds each hop's kernel backward a (do, dlse) cotangent pair, which
    the kernel folds into its delta row constant."""
    lse = torch.logaddexp(lse_a, lse_b)
    w_a = torch.exp(lse_a - lse).permute(0, 2, 1)[..., None]
    w_b = torch.exp(lse_b - lse).permute(0, 2, 1)[..., None]
    return o_a * w_a + o_b * w_b, lse


def _ring_zigzag_flash(q, k, v, rot) -> torch.Tensor:
    """Zigzag causal ring with every hop in the flash kernel: the
    schedule of :func:`_ring_zigzag` with finished kernel partials (o,
    lse) merged by :func:`merge_partials`. The local block is ONE causal
    call over the whole local (lo ++ hi) shard: local index order is
    absolute position order within the shard, so the plain causal mask
    is the zigzag local mask. Remote hops are the two unmasked chunk
    calls of the schedule."""
    n, me = rot.n, rot.rank
    b, s, h, d = q.shape
    if s % 2:
        raise ValueError("zigzag layout needs an even local sequence length")
    c = s // 2
    q_lo, q_hi = q[:, :c], q[:, c:]

    o_loc, lse_loc = _flash_chunk(q, k, v, causal=True)
    lo = (o_loc[:, :c], lse_loc[..., :c])
    hi = (o_loc[:, c:], lse_loc[..., c:])

    def consume_remote(i, k_cur, v_cur, st):
        """Two unmasked kernel calls a hop: q_hi x k_lo always; the
        diagonal pair to q_lo (src < me) or to q_hi (src > me)."""
        lo, hi = st
        src = (me - i) % n
        k_lo, k_hi = k_cur[:, :c], k_cur[:, c:]
        v_lo, v_hi = v_cur[:, :c], v_cur[:, c:]
        hi = merge_partials(*hi, *_flash_chunk(q_hi, k_lo, v_lo,
                                               causal=False))
        if src < me:
            lo = merge_partials(*lo, *_flash_chunk(q_lo, k_lo, v_lo,
                                                   causal=False))
        else:
            hi = merge_partials(*hi, *_flash_chunk(q_hi, k_hi, v_hi,
                                                   causal=False))
        return lo, hi

    lo, hi = _ring_sweep(k, v, rot, (lo, hi), consume_remote, start=1)
    return torch.cat([lo[0], hi[0]], dim=1).to(q.dtype)


def _ring_contig_flash(q, k, v, rot) -> torch.Tensor:
    """Non-causal contiguous ring with flash-kernel hops: every hop a
    fully unmasked whole-shard kernel call, merged by lse."""
    state = _flash_chunk(q, k, v, causal=False)

    def consume(i, k_cur, v_cur, st):
        return merge_partials(*st, *_flash_chunk(q, k_cur, v_cur,
                                                 causal=False))

    o, _ = _ring_sweep(k, v, rot, state, consume, start=1)
    return o.to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group=None, *, causal: bool = True,
                   layout: str = "zigzag", use_flash: Optional[bool] = None,
                   rot=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Standalone ring attention over a context ``group`` (None: the
    world), the counterpart of the JAX package's ``make_ring_attention``.

    q, k, v: the WHOLE ``(batch, seq, heads, head_dim)`` tensors in
    natural sequence order, the same on every rank of the group (made
    from one seed). This rank takes its shard of them (its zigzag pair
    of chunks under the causal zigzag layout, else its contiguous
    slice) and runs :func:`ring_attention_local`; ``rot`` replaces the
    group's ring (a :class:`VirtualRotation`). Returns ``(o, positions)``:
    this rank's output shard and the sequence positions its rows hold,
    so ``o`` equals rows ``positions`` of whole-sequence attention."""
    rot = rot or GroupRotation(group)
    n, me = rot.n, rot.rank
    s_local = q.shape[1] // n
    if layout == "zigzag" and causal and n > 1:
        pos = zigzag_positions(me, s_local, n, device=q.device)
    else:
        pos = me * s_local + torch.arange(s_local, device=q.device)
    q, k, v = (x[:, pos] for x in (q, k, v))
    return ring_attention_local(q, k, v, rot, causal=causal, layout=layout,
                                use_flash=use_flash), pos
