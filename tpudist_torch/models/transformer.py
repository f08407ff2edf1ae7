"""Llama-style transformer (BASELINE config #5): forward, serving and
training loss.

Counterpart of ``tpudist/models/transformer.py``: RMSNorm, RoPE, SwiGLU,
grouped-query attention and a tied output head. The model is an
``nn.Module`` whose parameters keep the JAX package's names and stacked
layout (``embed`` (V, d), ``layers.wq`` (L, d, h·hd), …, ``final_norm``
(d,)), so weights carry across name for name
(:func:`tpudist_torch.convert.params_from_jax`). The forward functions
are plain functions of that module and tensors, as the JAX package's are
of its params pytree; the scan over layers is a Python loop.

Attention routing (``_attention``): shapes the flash kernels take go to
:func:`tpudist_torch.ops.cuda.flash_attention.flash_attention`, which
launches the Hopper kernels (forward, and the backward ones under
autograd) for CUDA tensors and runs their plain versions for CPU
tensors; other long causal shapes go blockwise, the rest dense. Training
(:func:`loss_fn`) rotates q/k inside the flash kernels; the serving
prefill rotates them up front, since the cache keeps rotated keys. The
paged serving forward (:func:`paged_hidden_states`) attends a window of
tokens per slot against a paged KV pool in plain PyTorch, as the JAX
package does outside any Pallas kernel. Where a serve mesh splits the
pool's rows over its ranks (``pool_group``), each rank scores its own rows
and the ranks' partial softmaxes are merged
(:func:`_paged_attention_split`).

The training loss's LM head (:func:`head_loss`) is plain (whole logits),
chunked over the sequence with checkpointing, or fused
(:func:`tpudist_torch.ops.cuda.fused_xent.fused_lm_head_xent`: the Hopper
kernels for CUDA tensors, their plain versions for CPU tensors).

Under a sharded step's tensor parallelism (``groups``, a
:class:`tpudist_torch.parallel.tensor.StepGroups`) each rank computes
its heads and FFN columns (Megatron's column- then row-parallel blocks)
and, with the plain head, its vocab columns of the head and the lookup.
Under context parallelism (:func:`make_cp_loss_fn`) each rank holds a
shard of the sequence and attention is ring attention
(:mod:`tpudist_torch.ops.ring_attention`, the zigzag layout) or Ulysses
(:mod:`tpudist_torch.ops.ulysses`) over ``groups``' context ranks, RoPE
at the shard's absolute positions.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from tpudist_torch.config import CP_IMPLS, ModelConfig
from tpudist_torch.ops import ring_attention as ring_lib
from tpudist_torch.ops import ulysses as ulysses_lib
from tpudist_torch.ops.blockwise_attention import blockwise_causal_attention
from tpudist_torch.ops.cuda import flash_attention as fa
from tpudist_torch.ops.cuda import fused_xent as fx
from tpudist_torch.ops.gqa import expand_gqa
from tpudist_torch.ops.rope import apply_rope, rotate
from tpudist_torch.parallel import tensor as tensor_lib


def _layer_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    d, h, kv, L, dff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.n_layers, cfg.d_ff)
    hd = d // h
    return {
        "attn_norm": (L, d),
        "wq": (L, d, h * hd),
        "wk": (L, d, kv * hd),
        "wv": (L, d, kv * hd),
        "wo": (L, h * hd, d),
        "ffn_norm": (L, d),
        "w_gate": (L, d, dff),
        "w_up": (L, d, dff),
        "w_down": (L, dff, d),
    }


class Layers(nn.Module):
    """Every layer's weights, stacked on a leading n_layers dim: one
    parameter a name of ``shapes``."""

    def __init__(self, shapes: Dict[str, tuple], *, device):
        super().__init__()
        for name, shape in shapes.items():
            self.register_parameter(
                name, nn.Parameter(torch.empty(shape, device=device)))

    def layer(self, i: int) -> Dict[str, torch.Tensor]:
        """Layer ``i``'s weights by name (views, no copy)."""
        return {name: p[i] for name, p in self._parameters.items()}


class Transformer(nn.Module):
    """Parameters of the transformer; ``forward`` is :func:`apply`."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(
            (cfg.vocab_size, cfg.d_model), device=device))
        self.layers = Layers(_layer_shapes(cfg), device=device)
        self.final_norm = nn.Parameter(torch.empty((cfg.d_model,),
                                                   device=device))

    def forward(self, tokens: torch.Tensor, **kw):
        return apply(self, tokens, self.cfg, **kw)


@torch.no_grad()
def init(cfg: ModelConfig, *, generator: torch.Generator) -> Transformer:
    """Seeded parameters on ``generator``'s device: weights normal with
    std 1/sqrt(fan_in), norms ones (the JAX package's recipe; the two
    frameworks draw different numbers from one seed)."""
    d, h = cfg.d_model, cfg.n_heads
    return fill_params(Transformer(cfg, device=generator.device),
                       {"wq": d, "wk": d, "wv": d, "wo": h * (d // h),
                        "w_gate": d, "w_up": d, "w_down": cfg.d_ff},
                       generator)


def param_specs(cfg: ModelConfig, *, fsdp_axis: str = "fsdp",
                tensor_axis: str = "tensor", pipe_axis: str = "pipe"):
    """Sharding specs by ``state_dict`` name, the JAX package's: Megatron
    column-parallel (output dim on tensor) wq/wk/wv/w_gate/w_up and
    row-parallel (input dim on tensor) wo/w_down, FSDP on the other dim;
    the embedding's VOCAB dim over fsdp x tensor; the stacked layer dim
    over pipe. :func:`tpudist_torch.parallel.sharding.sanitize_specs`
    drops what a mesh does not divide."""
    del cfg
    f, t, pp = fsdp_axis, tensor_axis, pipe_axis
    col, row = (pp, f, t), (pp, t, f)
    return {"embed": ((f, t), None),
            **{f"layers.{n}": (pp, None) for n in ("attn_norm",
                                                   "ffn_norm")},
            **{f"layers.{n}": col for n in ("wq", "wk", "wv", "w_gate",
                                            "w_up")},
            **{f"layers.{n}": row for n in ("wo", "w_down")},
            "final_norm": (None,)}


def fill_params(model: nn.Module, fan_in: Dict[str, int],
                generator: torch.Generator) -> nn.Module:
    """The JAX package's recipe on a model with ``embed``, ``layers`` and
    ``final_norm``: the embedding and each layer weight named in
    ``fan_in`` normal with std 1/sqrt(fan_in) (the embedding's fan-in is
    d_model), the norms ones."""
    model.embed.normal_(0.0, 1.0 / math.sqrt(model.embed.shape[1]),
                        generator=generator)
    for name, p in model.layers.named_parameters():
        if name in fan_in:
            p.normal_(0.0, 1.0 / math.sqrt(fan_in[name]),
                      generator=generator)
        else:
            p.fill_(1.0)
    model.final_norm.fill_(1.0)
    return model


def precompute_rope(seq_len: int, head_dim: int, theta: float = 10000.0,
                    positions: Optional[torch.Tensor] = None, *,
                    device=None, offset: int = 0):
    """RoPE cos/sin tables of shape (seq_len, head_dim//2), f32, on
    ``device`` (or ``positions``' device). ``offset`` shifts the
    positions to ``offset + arange(seq_len)`` (a Ulysses context shard's
    absolute positions); ``positions`` (a (seq_len,) tensor, a zigzag
    shard's two chunks) overrides the arithmetic."""
    if positions is not None:
        device = positions.device
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))
    if positions is not None:
        t = positions.to(torch.float32)
    else:
        t = torch.arange(seq_len, dtype=torch.float32, device=device) \
            + offset
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def rmsnorm(x: torch.Tensor, g: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype) * g.to(x.dtype)


_BLOCKWISE_MIN_SEQ = 2048
_BLOCKWISE_CHUNK = 1024


def _use_flash(q_shape, k_shape, causal: bool = True) -> bool:
    """Route attention through the flash kernel? Every shape it takes,
    on every device: on the CPU the wrapper runs the kernel's plain
    version."""
    return fa.supports(q_shape, k_shape, causal=causal)


def _attention(q, k, v, *, causal: bool = True, cos=None, sin=None):
    """Local attention. q: (batch, seq, heads, head_dim); k/v may carry
    fewer (grouped-query) kv heads. ``cos``/``sin``: optional RoPE tables
    (seq, head_dim/2) for UNROTATED q/k, rotated inside the flash kernel
    or up front otherwise."""
    if _use_flash(q.shape, k.shape, causal):
        return fa.flash_attention(q, k, v, cos=cos, sin=sin, causal=causal)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    if causal and q.shape[1] >= _BLOCKWISE_MIN_SEQ \
            and q.shape[1] == k.shape[1] \
            and q.shape[1] % _BLOCKWISE_CHUNK == 0:
        return blockwise_causal_attention(q, k, v, chunk=_BLOCKWISE_CHUNK)
    k, v = expand_gqa(q, k, v)
    hd = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    if causal:
        s_q, s_k = scores.shape[-2], scores.shape[-1]
        keep = torch.ones(s_q, s_k, dtype=torch.bool,
                          device=q.device).tril()
        scores = scores.masked_fill(~keep, -1e30)
    probs = torch.softmax(scores.to(torch.float32), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


# capability marker for _attn_sublayer's dispatch: impls that take
# cos/sin and rotate internally
_attention.accepts_rope = True


def _attn_sublayer(x, lp, cfg: ModelConfig, cos, sin, attn_impl,
                   return_kv: bool = False, groups=None):
    """Pre-norm attention + residual. ``return_kv=True`` is the serving
    PREFILL mode: q/k are rotated here, up front, and the rotated compact
    k/v come back with the output to seed the KV cache.

    Under tensor parallelism (``groups.tp``) the block is Megatron's: the
    normed input enters column-parallel ``wq``/``wk``/``wv`` for this
    rank's heads (:meth:`StepGroups.attention_weights`), the flash
    kernels run on those heads, and the row-parallel ``wo``'s partial
    products are summed over ``tensor`` on the way out."""
    b, s, d = x.shape
    h, kv = cfg.n_heads, cfg.n_kv_heads
    hd = d // h
    dt = x.dtype

    y = rmsnorm(x, lp["attn_norm"])
    wq, wk, wv, wo, reads = lp["wq"], lp["wk"], lp["wv"], lp["wo"], None
    tp = groups is not None and groups.tp
    if tp:
        y = groups.enter(y)
        wq, wk, wv, wo, reads = groups.attention_weights(lp, h, kv, hd)
        h, kv = wq.shape[-1] // hd, wk.shape[-1] // hd
    q = (y @ wq.to(dt)).reshape(b, s, h, hd)
    k = (y @ wk.to(dt)).reshape(b, s, kv, hd)
    v = (y @ wv.to(dt)).reshape(b, s, kv, hd)
    if reads is not None:
        # the rank's q heads do not share its kv heads evenly: one kv
        # head a q head
        pick = torch.tensor(reads, device=k.device)
        k, v = k.index_select(2, pick), v.index_select(2, pick)
    if getattr(attn_impl, "accepts_rope", False) and not return_kv:
        o = attn_impl(q, k, v, cos=cos, sin=sin)
    else:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        o = attn_impl(q, k, v)
    o = o.reshape(b, s, h * hd) @ wo.to(dt)
    out = x + (groups.exit(o) if tp else o)
    return (out, k, v) if return_kv else out


def _ffn_sublayer(x, lp, cfg: ModelConfig, groups=None):
    """Pre-norm SwiGLU FFN + residual; under tensor parallelism this
    rank's hidden columns (:meth:`StepGroups.ffn_weights`), column- then
    row-parallel."""
    dt = x.dtype
    y = rmsnorm(x, lp["ffn_norm"])
    (wg, wu), wd = (lp["w_gate"], lp["w_up"]), lp["w_down"]
    tp = groups is not None and groups.tp
    if tp:
        y = groups.enter(y)
        (wg, wu), wd = groups.ffn_weights((wg, wu), wd, cfg.d_ff)
    gate = F.silu(y @ wg.to(dt))
    up = y @ wu.to(dt)
    o = (gate * up) @ wd.to(dt)
    return x + (groups.exit(o) if tp else o)


def _layer(x, lp, cfg: ModelConfig, cos, sin, attn_impl, groups=None):
    """One decoder layer. x: (batch, seq, d_model)."""
    x = _attn_sublayer(x, lp, cfg, cos, sin, attn_impl, groups=groups)
    return _ffn_sublayer(x, lp, cfg, groups)


def window_rope(x: torch.Tensor, positions: torch.Tensor,
                theta: float) -> torch.Tensor:
    """Rotate a window of new tokens per slot at their own absolute
    positions. x: (batch, window, heads, head_dim); positions: (batch,
    window) int. Same pair convention as :func:`apply_rope`."""
    b, w, _, hd = x.shape
    cos, sin = precompute_rope(0, hd, theta,
                               positions=positions.reshape(-1))
    return rotate(x, cos.reshape(b, w, 1, hd // 2),
                  sin.reshape(b, w, 1, hd // 2))


def decode_rope(x: torch.Tensor, positions: torch.Tensor,
                theta: float) -> torch.Tensor:
    """Rotate one new token per slot at its absolute position. x: (batch,
    1, heads, head_dim); positions: (batch,) int."""
    return window_rope(x, positions[:, None], theta)


def _cached_attention(q, k_new, v_new, cache_k, cache_v, pos):
    """One-token incremental attention against a per-slot KV cache.

    q/k_new/v_new: (batch, 1, heads|kv, head_dim), already rotated at
    ``pos``; cache_k/cache_v: (batch, max_seq, kv, head_dim); pos:
    (batch,) per-slot write positions. The new k/v land at ``pos`` and
    attention covers keys ``[0, pos]``: positions past each slot's own
    length are masked, so stale rows never leak into another sequence.
    Returns ``(o, cache_k, cache_v)``, the caches updated in place."""
    b, t = cache_k.shape[0], cache_k.shape[1]
    slot = torch.arange(b, device=cache_k.device)
    # the JAX package's scatter `.at[slot, pos].set` becomes an in-place
    # index_put_: the cache is written where it lies, never copied
    cache_k.index_put_((slot, pos), k_new[:, 0].to(cache_k.dtype))
    cache_v.index_put_((slot, pos), v_new[:, 0].to(cache_v.dtype))
    k, v = expand_gqa(q, cache_k, cache_v)
    hd = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    keep = torch.arange(t, device=pos.device)[None, :] <= pos[:, None]
    scores = scores.masked_fill(~keep[:, None, None, :], -1e30)
    probs = torch.softmax(scores.to(torch.float32), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v), cache_k, cache_v


def _attn_sublayer_cached(x, lp, cfg: ModelConfig, pos, cache_k, cache_v):
    """The decode twin of :func:`_attn_sublayer`: one new token per slot,
    projected and rotated at the slot's own position, attention against
    the layer's KV cache. Returns ``(out, cache_k, cache_v)``."""
    b, s, d = x.shape           # s == 1
    h, kv = cfg.n_heads, cfg.n_kv_heads
    hd = d // h
    dt = x.dtype
    y = rmsnorm(x, lp["attn_norm"])
    q = (y @ lp["wq"].to(dt)).reshape(b, s, h, hd)
    k = (y @ lp["wk"].to(dt)).reshape(b, s, kv, hd)
    v = (y @ lp["wv"].to(dt)).reshape(b, s, kv, hd)
    q = decode_rope(q, pos, cfg.rope_theta)
    k = decode_rope(k, pos, cfg.rope_theta)
    o, cache_k, cache_v = _cached_attention(q, k, v, cache_k, cache_v, pos)
    o = o.reshape(b, s, h * hd)
    return x + o @ lp["wo"].to(dt), cache_k, cache_v


def _embed(params: Transformer, tokens: torch.Tensor, dtype, groups=None):
    """The token embeddings in ``dtype``; vocab-parallel with the head
    (:meth:`StepGroups.embed`)."""
    if groups is not None and groups.vocab_parallel:
        return groups.embed(params.embed, tokens, dtype)
    # gather, then cast: the same values as casting the whole table first
    return params.embed[tokens].to(dtype)


def _cached_hidden_states(params: Transformer, tokens: torch.Tensor,
                          cfg: ModelConfig, *, dtype, kv_cache,
                          cur_index, ffn=_ffn_sublayer):
    """Incremental forward against a per-sequence KV cache, written in
    place. ``kv_cache`` is ``{"k", "v"}`` of canonical shape (n_layers,
    batch, max_seq, n_kv_heads, head_dim) (views are fine).

    * ``cur_index=None`` → PREFILL: full causal forward over ``tokens``
      (batch, prompt_pad); each layer's rotated k/v fill cache positions
      ``[0, prompt_pad)``.
    * ``cur_index`` (batch,) int → DECODE: ``tokens`` (batch, 1), one
      token appended per slot at its own position.

    Returns ``(h, kv_cache)`` with ``h`` final-normed."""
    ck, cv = kv_cache["k"], kv_cache["v"]
    x = _embed(params, tokens, dtype)
    if cur_index is None:
        s = tokens.shape[1]
        hd = cfg.d_model // cfg.n_heads
        cos, sin = precompute_rope(s, hd, cfg.rope_theta,
                                   device=tokens.device)
        for i in range(cfg.n_layers):
            lp = params.layers.layer(i)
            x, k, v = _attn_sublayer(x, lp, cfg, cos, sin, _attention,
                                     return_kv=True)
            x = ffn(x, lp, cfg)
            ck[i, :, :s] = k.to(ck.dtype)
            cv[i, :, :s] = v.to(cv.dtype)
    else:
        for i in range(cfg.n_layers):
            lp = params.layers.layer(i)
            x, _, _ = _attn_sublayer_cached(x, lp, cfg, cur_index, ck[i],
                                            cv[i])
            x = ffn(x, lp, cfg)
    return rmsnorm(x, params.final_norm), {"k": ck, "v": cv}


def _paged_attention(q, k_new, v_new, pool_k, pool_v, page_table,
                     positions, write_ok, page_tokens: int):
    """Windowed incremental attention against a PAGED KV pool, gather-free
    on the read path (the JAX package's ``_paged_attention``).

    q: (slots, window, heads, head_dim); k_new/v_new: (slots, window, kv,
    head_dim), already rotated at ``positions`` (slots, window) int;
    pool_k/pool_v: (pages+1, page_tokens, kv, head_dim), one layer of the
    pool, the last page the TRASH page; page_table: (slots, max_pages)
    int, -1 = unmapped; write_ok: (slots, window) bool, False routes the
    write to the trash page.

    WRITE: the new k/v land in place at their pages (``index_put_``);
    duplicate indices only ever fall on the trash page, which nothing
    reads. READ: no gather: ownership is a one-hot compare of the page
    table against the pool's page ids, each owned page's logical position
    comes from the same one-hot, and attention runs over the whole
    flattened pool masked by ``owned & (key_pos <= query_pos)``, so other
    slots' pages, stale positions and the trash page weigh exactly 0.
    Write-then-attend with that mask gives causality inside the window.
    Same f32-softmax discipline as :func:`_attention`. Returns ``(o,
    pool_k, pool_v)``, the pools written in place."""
    s, w, h, hd = q.shape
    n_pool, pt = pool_k.shape[0], page_tokens
    kv = k_new.shape[2]
    maxp = page_table.shape[1]
    dev = pool_k.device
    page_table = page_table.to(torch.int64)
    positions = positions.to(torch.int64)

    # ---- write: new k/v land at their pages (or the trash page) ----
    pg = torch.gather(page_table, 1, positions // pt)        # (s, w)
    pg = torch.where(write_ok & (pg >= 0), pg, n_pool - 1)
    off = positions % pt
    pool_k.index_put_((pg, off), k_new.to(pool_k.dtype))
    pool_v.index_put_((pg, off), v_new.to(pool_v.dtype))

    # ---- read: ownership + position masks from one one-hot ----
    onehot = page_table[:, :, None] == torch.arange(n_pool, device=dev)
    owned = onehot.any(dim=1)                                # (s, pool)
    # the JAX package's int32 einsum "sjp,j->sp", as a sum (no integer
    # matmul on CUDA); at most one j matches a page, so it is exact
    logical = (onehot.to(torch.int64)
               * torch.arange(maxp, device=dev)[None, :, None]).sum(1)
    kpos = logical[:, :, None] * pt + torch.arange(pt, device=dev)
    mask = owned[:, None, :, None] \
        & (kpos[:, None, :, :] <= positions[:, :, None, None])
    mask = mask.reshape(s, w, n_pool * pt)                   # (s, w, keys)

    kf = pool_k.reshape(n_pool * pt, kv, hd).to(q.dtype)
    vf = pool_v.reshape(n_pool * pt, kv, hd).to(q.dtype)
    qg = q.reshape(s, w, kv, h // kv, hd)      # GQA: group per kv head
    scores = torch.einsum("swkgd,nkd->swkgn", qg, kf) / math.sqrt(hd)
    scores = scores.masked_fill(~mask[:, :, None, None, :], -1e30)
    probs = torch.softmax(scores.to(torch.float32), dim=-1).to(q.dtype)
    o = torch.einsum("swkgn,nkd->swkgd", probs, vf).reshape(s, w, h, hd)
    return o, pool_k, pool_v


def _paged_attention_split(q, k_new, v_new, pool_k, pool_v, page_table,
                           positions, write_ok, page_tokens: int,
                           pool_group):
    """:func:`_paged_attention` over a pool whose rows a serve mesh
    splits: this rank holds ``pool_group.rows`` rows from global row
    ``pool_group.lo`` on (``pool_k``/``pool_v``: those rows plus one
    private DISCARD row, the last), of ``pool_group.n_rows`` in all, the
    global trash page (row ``n_rows - 1``) on the last chunk's ranks.

    WRITE: a new k/v lands on the rank that holds its row (the trash
    page's for a masked write, as in one pool); every other rank routes
    it to its discard row, which no read sees. READ: each rank scores
    its own keys with :func:`_paged_attention`'s masks and ``-1e30``
    fill, keeps its partial ``(max, sum, unnormalised acc)`` per (slot,
    window, head) in f32, and the partials, all-gathered over the group
    (``pool_group.gather``), are merged in rank order: the flash merge.
    A fully masked row (an inactive slot) comes out as the one pool's
    uniform mean over every row, on every rank alike. Returns ``(o,
    pool_k, pool_v)``, the pools written in place."""
    s, w, h, hd = q.shape
    pt, g = page_tokens, pool_group
    kv = k_new.shape[2]
    maxp = page_table.shape[1]
    dev = pool_k.device
    page_table = page_table.to(torch.int64)
    positions = positions.to(torch.int64)

    pg = torch.gather(page_table, 1, positions // pt)        # (s, w)
    pg = torch.where(write_ok & (pg >= 0), pg, g.n_rows - 1) - g.lo
    pg = torch.where((pg >= 0) & (pg < g.rows), pg, g.rows)  # else discard
    off = positions % pt
    pool_k.index_put_((pg, off), k_new.to(pool_k.dtype))
    pool_v.index_put_((pg, off), v_new.to(pool_v.dtype))

    rows = torch.arange(g.lo, g.lo + g.rows, device=dev)
    onehot = page_table[:, :, None] == rows
    owned = onehot.any(dim=1)                                # (s, rows)
    logical = (onehot.to(torch.int64)
               * torch.arange(maxp, device=dev)[None, :, None]).sum(1)
    kpos = logical[:, :, None] * pt + torch.arange(pt, device=dev)
    mask = owned[:, None, :, None] \
        & (kpos[:, None, :, :] <= positions[:, :, None, None])
    mask = mask.reshape(s, w, g.rows * pt)

    kf = pool_k[:g.rows].reshape(g.rows * pt, kv, hd).to(q.dtype)
    vf = pool_v[:g.rows].reshape(g.rows * pt, kv, hd).to(torch.float32)
    qg = q.reshape(s, w, kv, h // kv, hd)
    scores = torch.einsum("swkgd,nkd->swkgn", qg, kf) / math.sqrt(hd)
    scores = scores.masked_fill(~mask[:, :, None, None, :], -1e30).to(
        torch.float32)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    acc = torch.einsum("swkgn,nkd->swkgd", p, vf)
    parts = g.gather(torch.cat([m, p.sum(dim=-1, keepdim=True), acc], -1))
    top = parts[..., :1].amax(dim=0)
    den = torch.zeros_like(top)
    num = torch.zeros_like(acc)
    for r in range(g.ways):                  # rank order
        scale = torch.exp(parts[r, ..., :1] - top)
        den = den + parts[r, ..., 1:2] * scale
        num = num + parts[r, ..., 2:] * scale
    o = (num / den).to(q.dtype).reshape(s, w, h, hd)
    return o, pool_k, pool_v


def _attn_sublayer_paged(x, lp, cfg: ModelConfig, positions, write_ok,
                         pool_k, pool_v, page_table, page_tokens: int,
                         pool_group=None):
    """The paged twin of :func:`_attn_sublayer_cached`: a WINDOW of new
    tokens per slot, q/k/v projected and rotated at each token's own
    position, attention against the layer's paged pool (its rows split
    over ``pool_group``'s ranks when given). Returns ``(out, pool_k,
    pool_v)``."""
    b, w, d = x.shape
    h, kv = cfg.n_heads, cfg.n_kv_heads
    hd = d // h
    dt = x.dtype
    y = rmsnorm(x, lp["attn_norm"])
    q = (y @ lp["wq"].to(dt)).reshape(b, w, h, hd)
    k = (y @ lp["wk"].to(dt)).reshape(b, w, kv, hd)
    v = (y @ lp["wv"].to(dt)).reshape(b, w, kv, hd)
    q = window_rope(q, positions, cfg.rope_theta)
    k = window_rope(k, positions, cfg.rope_theta)
    split = () if pool_group is None else (pool_group,)
    attend = _paged_attention if pool_group is None \
        else _paged_attention_split
    o, pool_k, pool_v = attend(q, k, v, pool_k, pool_v, page_table,
                               positions, write_ok, page_tokens, *split)
    o = o.reshape(b, w, h * hd)
    return x + o @ lp["wo"].to(dt), pool_k, pool_v


def paged_hidden_states(params: Transformer, tokens: torch.Tensor,
                        cfg: ModelConfig, *, dtype, pool_k, pool_v,
                        page_table, positions, write_ok,
                        page_tokens: int, ffn=_ffn_sublayer,
                        pool_group=None):
    """Windowed incremental forward against the PAGED KV pool, the paged
    twin of :func:`_cached_hidden_states`' decode branch.

    tokens/positions/write_ok: (slots, window); pool_k/pool_v:
    (n_layers, pages+1, page_tokens, kv, head_dim), written in place;
    page_table: (slots, max_pages) int, the dispatch's input (the host
    allocator owns the table). Window 1 is the paged decode step; window
    k the speculative VERIFY forward, one batched forward scoring a whole
    draft window. ``pool_group``: a serve mesh's, where it splits the
    pool's rows (:func:`_paged_attention_split`). Returns ``(h, pool_k,
    pool_v)`` with ``h`` final-normed."""
    x = _embed(params, tokens, dtype)
    for i in range(cfg.n_layers):
        lp = params.layers.layer(i)
        x, _, _ = _attn_sublayer_paged(x, lp, cfg, positions, write_ok,
                                       pool_k[i], pool_v[i], page_table,
                                       page_tokens, pool_group)
        x = ffn(x, lp, cfg)
    return rmsnorm(x, params.final_norm), pool_k, pool_v


def hidden_states(params: Transformer, tokens: torch.Tensor,
                  cfg: ModelConfig, *, dtype=torch.bfloat16,
                  attn_impl=_attention, rope_offset: int = 0,
                  rope_positions: Optional[torch.Tensor] = None,
                  remat: bool = False, kv_cache=None, cur_index=None,
                  groups=None, slot_group=None):
    """Backbone forward: tokens (batch, seq) -> final-norm hidden states
    (batch, seq, d_model) in ``dtype``. ``attn_impl`` lets context-
    parallel callers substitute ring or Ulysses attention;
    ``rope_offset`` / ``rope_positions`` give a context shard its
    absolute positions (:func:`precompute_rope`). ``remat`` checkpoints
    each layer (activations recomputed in backward).
    ``kv_cache``/``cur_index`` select the serving path
    (:func:`_cached_hidden_states`) and the return becomes ``(h,
    kv_cache)``. ``groups``: a sharded step's
    (:class:`tpudist_torch.parallel.tensor.StepGroups`). ``slot_group``:
    a serve mesh's, which the dense model does not read (no slot's
    tokens depend on another's)."""
    if kv_cache is not None:
        return _cached_hidden_states(params, tokens, cfg, dtype=dtype,
                                     kv_cache=kv_cache, cur_index=cur_index)
    s = tokens.shape[1]
    hd = cfg.d_model // cfg.n_heads
    cos, sin = precompute_rope(s, hd, cfg.rope_theta, rope_positions,
                               device=tokens.device, offset=rope_offset)
    x = _embed(params, tokens, dtype, groups)
    for i in range(cfg.n_layers):
        lp = params.layers.layer(i)
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                _layer, x, lp, cfg, cos, sin, attn_impl, groups,
                use_reentrant=False)
        else:
            x = _layer(x, lp, cfg, cos, sin, attn_impl, groups)
    return rmsnorm(x, params.final_norm)


def apply(params: Transformer, tokens: torch.Tensor, cfg: ModelConfig, *,
          dtype=torch.bfloat16, attn_impl=_attention, kv_cache=None,
          cur_index=None):
    """Forward: tokens (batch, seq) int -> logits (batch, seq, vocab)
    f32 through the tied output head; with ``kv_cache`` the serving path
    runs and the return is ``(logits, kv_cache)``."""
    if kv_cache is not None:
        x, kv_cache = hidden_states(params, tokens, cfg, dtype=dtype,
                                    kv_cache=kv_cache, cur_index=cur_index)
        return (x @ params.embed.to(dtype).T).to(torch.float32), kv_cache
    x = hidden_states(params, tokens, cfg, dtype=dtype, attn_impl=attn_impl)
    return (x @ params.embed.to(dtype).T).to(torch.float32)


class _Xent(torch.autograd.Function):
    """Mean cross-entropy of (..., vocab) logits against int targets,
    reduced in f32 whatever the logits dtype. The backward is the JAX
    package's ``_xent_bwd``: dlogits = (softmax - onehot) * ct / n with
    the onehot an iota compare, in the logits' own dtype."""

    @staticmethod
    def forward(ctx, logits, targets):
        lf = logits.to(torch.float32)
        logz = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, targets[..., None].long())[..., 0]
        ctx.save_for_backward(logits, logz, targets)
        return torch.mean(logz - gold)

    @staticmethod
    def backward(ctx, ct):
        logits, logz, targets = ctx.saved_tensors
        n = logits.numel() // logits.shape[-1]
        p = torch.exp(logits.to(torch.float32) - logz[..., None])
        iota = torch.arange(logits.shape[-1], device=logits.device)
        onehot = iota == targets[..., None].long()
        dlogits = ((p - onehot.to(torch.float32)) * (ct / n)).to(
            logits.dtype)
        return dlogits, None


def _xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return _Xent.apply(logits, targets)


def pick_lm_head(n_tokens_per_device: int, vocab: int, d_model: int,
                 n_layers: int, dtype_bytes: int, state_bytes: float,
                 hbm_bytes: float) -> tuple[bool, int]:
    """Memory-driven LM-head strategy -> (fused_xent, xent_chunks), a
    copy of the JAX package's policy: the plain whole-logits head while
    the (tokens, vocab) logits pair plus ~12 live (tokens, d_model)
    buffers per layer fit in 0.75 of the memory left beside the train
    state, else the fused head. The 0.75 was fitted on a v5e; the port
    keeps it until an H100 calibration replaces it (ROADMAP)."""
    pair = 2 * n_tokens_per_device * vocab * dtype_bytes
    act = 12 * n_tokens_per_device * d_model * n_layers * dtype_bytes
    if pair + act <= 0.75 * max(hbm_bytes - state_bytes, 0.0):
        return False, 0
    return True, 0


def _chunked_head_xent(embed: torch.Tensor, h: torch.Tensor,
                       targets: torch.Tensor, n_chunks: int) -> torch.Tensor:
    """Tied head + cross-entropy over ``n_chunks`` sequence chunks, each
    chunk's logits recomputed in the backward (``torch.utils.checkpoint``),
    so the whole (batch, seq, vocab) logits tensor never exists: the chunk
    means summed in order in f32, then divided by ``n_chunks``."""
    b, s, d = h.shape
    hc = h.reshape(b, n_chunks, s // n_chunks, d).transpose(0, 1)
    tc = targets.reshape(b, n_chunks, s // n_chunks).transpose(0, 1)

    def chunk_loss(hx, tx, e):
        # logits keep the model dtype; _xent reduces in f32 internally
        return _xent(hx @ e.T, tx)

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n_chunks):
        total = total + torch.utils.checkpoint.checkpoint(
            chunk_loss, hc[i], tc[i], embed, use_reentrant=False)
    return total / n_chunks


def _fused_head_xent(embed: torch.Tensor, h: torch.Tensor,
                     targets: torch.Tensor) -> torch.Tensor:
    """Tied head + cross-entropy through the fused kernels
    (:func:`tpudist_torch.ops.cuda.fused_xent.fused_lm_head_xent`): the
    logits never reach device memory. CPU tensors run the kernels' plain
    versions, so the same code path is CPU-testable."""
    b, s, d = h.shape
    return fx.fused_lm_head_xent(h.reshape(b * s, d), embed,
                                 targets.reshape(b * s))


def head_loss(emb: torch.Tensor, h: torch.Tensor, targets: torch.Tensor,
              *, xent_chunks: int = 0, fused_xent: bool = False,
              groups=None) -> torch.Tensor:
    """Tied LM head + mean cross-entropy, the one head-strategy dispatch.
    ``fused_xent`` routes through the fused kernels (no logits in device
    memory); ``xent_chunks`` > 0 streams the head over that many sequence
    chunks with checkpointing; neither keeps the plain whole-logits path,
    logits in the model dtype, split over the vocab under
    ``groups.vocab_parallel`` (:func:`tensor.vocab_parallel_xent`). The
    fused and chunked heads take the whole table on every tensor rank,
    as the JAX package's fused kernel has no partitioning rule."""
    if fused_xent and xent_chunks:
        raise ValueError("--fused-xent and --xent-chunks are mutually "
                         "exclusive LM-head strategies")
    if fused_xent:
        return _fused_head_xent(emb, h, targets)
    if xent_chunks:
        if targets.shape[1] % xent_chunks:
            # erroring beats silently materialising the full logits tensor
            # the flag was passed to avoid
            raise ValueError(
                f"sequence length {targets.shape[1]} not divisible by "
                f"xent_chunks={xent_chunks}")
        return _chunked_head_xent(emb, h, targets, xent_chunks)
    if groups is not None and groups.vocab_parallel:
        return tensor_lib.vocab_parallel_xent(emb, h, targets, groups)
    return _xent(h @ emb.T, targets)


def loss_fn(params: Transformer, tokens: torch.Tensor, cfg: ModelConfig, *,
            dtype=torch.bfloat16, remat: bool = False, xent_chunks: int = 0,
            fused_xent: bool = False, groups=None) -> torch.Tensor:
    """Causal next-token cross-entropy: tokens (batch, seq + 1) -> the
    mean over the batch's seq positions."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    h = hidden_states(params, inputs, cfg, dtype=dtype, remat=remat,
                      groups=groups)
    return head_loss(params.embed.to(dtype), h, targets,
                     xent_chunks=xent_chunks, fused_xent=fused_xent,
                     groups=groups)


def cp_attention(impl: str, groups, s_local: int, device):
    """Per-shard attention and RoPE position info for a context-parallel
    body (``impl`` ring or ulysses, checked by :func:`make_cp_loss`):
    ``(attn_fn, rope_positions, rope_offset)``, exactly one of the
    two meaningful (a zigzag shard holds two non-adjacent chunks; a
    Ulysses shard is contiguous). ``groups`` (a sharded step's
    :class:`tpudist_torch.parallel.tensor.StepGroups`) gives the context
    ways, this rank's index among them and their group; every rotation
    and all-to-all is noted into ``groups.reduced``. Shared by the
    transformer's and the MoE's loss builders."""
    n, me = groups.context, groups.context_index
    if impl == "ring":
        pos = ring_lib.zigzag_positions(me, s_local, n, device=device)

        def attn(q, k, v):
            rot = ring_lib.GroupRotation(groups.context_group,
                                         groups.reduced)
            return ring_lib.ring_attention_local(q, k, v, rot, causal=True,
                                                 layout="zigzag")
        return attn, pos, 0

    def attn(q, k, v):
        return ulysses_lib.ulysses_attention(
            q, k, v, groups.context_group, reduced=groups.reduced)
    return attn, None, me * s_local


def make_cp_loss(shard_loss_fn, *, impl: str = "ring"):
    """The context-parallel scaffolding every sequence model shares:
    ``loss(params, tokens, groups)`` over the (batch, S + 1) token rows
    this rank holds, whose sequence its context ranks split.

    ``shard_loss_fn(params, inputs, targets, attn, pos, off, groups) ->
    scalar`` computes one shard's loss given the per-shard attention and
    RoPE position info (:func:`cp_attention`); this wrapper owns the
    impl check, the causal shift of the whole rows, the zigzag permute
    (ring) and the cut to this rank's contiguous ``S / n`` of the
    (permuted) sequence. The mean over the context ranks is the step's
    (the JAX package's ``lax.pmean`` over ``context``): the shard's loss
    is the mean over its own tokens."""
    if impl not in CP_IMPLS:
        raise ValueError(f"unknown cp impl {impl!r}: {' | '.join(CP_IMPLS)}")

    def loss(params, tokens: torch.Tensor, groups) -> torch.Tensor:
        n, r = groups.context, groups.context_index
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        if impl == "ring":
            inputs = ring_lib.zigzag_permute(inputs, n)
            targets = ring_lib.zigzag_permute(targets, n)
        s_local = inputs.shape[1] // n
        cut = slice(r * s_local, (r + 1) * s_local)
        attn, pos, off = cp_attention(impl, groups, s_local, tokens.device)
        return shard_loss_fn(params, inputs[:, cut], targets[:, cut], attn,
                             pos, off, groups)
    return loss


def make_cp_loss_fn(cfg: ModelConfig, *, dtype=torch.bfloat16,
                    remat: bool = False, xent_chunks: int = 0,
                    fused_xent: bool = False, impl: str = "ring"):
    """Context-parallel loss: ``loss(params, tokens, groups)``, the
    sequence split over the context ranks of ``groups``.

    ``impl="ring"`` (default): zigzag layout (each shard holds one early
    and one late chunk: balanced causal work), attention through ring
    attention (:mod:`tpudist_torch.ops.ring_attention`), RoPE from the
    shard's absolute positions; the permutation happens before the cut
    and the loss (a token mean) needs no inverse. ``impl="ulysses"``:
    contiguous shards, two all-to-alls reshard heads <-> sequence around
    the full-sequence attention (:mod:`tpudist_torch.ops.ulysses`); the
    head counts must divide by the context ways. q/k are rotated up
    front (the CP attention takes no tables). The scaffolding is shared
    with the MoE (:func:`make_cp_loss`)."""

    def shard_loss(params, inputs, targets, attn, pos, off, groups):
        h = hidden_states(params, inputs, cfg, dtype=dtype, attn_impl=attn,
                          rope_positions=pos, rope_offset=off, remat=remat,
                          groups=groups)
        return head_loss(params.embed.to(dtype), h, targets,
                         xent_chunks=xent_chunks, fused_xent=fused_xent,
                         groups=groups)

    return make_cp_loss(shard_loss, impl=impl)
