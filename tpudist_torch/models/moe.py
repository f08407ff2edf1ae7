"""Mixture-of-experts transformer: forward, serving and training loss.

Counterpart of ``tpudist/models/moe.py``: the dense transformer's blocks
with the FFN half replaced by top-k token-choice routed SwiGLU experts,
plus the Switch load-balancing auxiliary loss (aux = E·Σ_e f_e·P_e, added
to the objective with ``router_aux_weight``). The model is an
``nn.Module`` whose parameters keep the JAX package's names and stacked
layouts (``embed`` (V, d); ``layers.{attn_norm, wq, wk, wv, wo,
ffn_norm}`` as the transformer's; ``layers.w_router`` (L, d, E);
``layers.w_gate`` / ``w_up`` (L, E, d, d_ff); ``layers.w_down`` (L, E,
d_ff, d); ``final_norm``), so weights carry across name for name
(:func:`tpudist_torch.convert.params_from_jax`).

Routing is the GShard dense dispatch: a (tokens, experts, capacity)
one-hot dispatch tensor contracted against the token activations with
einsums. Everything is statically shaped (capacity bounds each expert's
rows; overflow pairs fall through the residual), and nothing reads a
value back to the host: no ``.item()``, ``nonzero`` or mask indexing, the
one-hots are iota compares, so a train step or a serving program with the
experts in it captures into a CUDA graph. Routing, dispatch and the
expert products are plain PyTorch, as they are plain XLA in the JAX
package: no Pallas kernel computes them. The attention half, the norms,
RoPE and the LM head are the transformer's
(:mod:`tpudist_torch.models.transformer`), with its flash kernels and its
fused head.

Routing semantics: routing, capacity and the aux loss are computed over
the batch the loss sees, in groups of ``group_size`` tokens
(``tpudist/models/moe.py:34-41``). Under the port's replicated data
parallelism every process computes its loss on its own batch, so routing
is group-local, as on the JAX package's shard_map DP path:
capacity-constrained routing is not invariant to how the batch is split,
so N processes do not equal one process on the global batch, by design.
On a mesh that is not pure data (``--fsdp``, ``--expert`` or
``--tensor`` > 1, the JAX package's jit+shardings path) the sharded step
passes its ``groups``, and routing is over the GLOBAL batch: the group
size comes from the global token count. A group that lies inside one
rank's tokens is routed there, the aux loss's per-expert sums all-reduced
over the data x fsdp ranks before their product, inside autograd; a
group that spans ranks (it does not divide a rank's tokens, or the
near-prime fallback takes one global group) is routed from the router
probabilities all-gathered over those ranks in global row order, with
the global capacity, and each rank keeps its rows of dispatch and
combine. Under tensor parallelism the experts' hidden dim is split over
``tensor`` (``w_gate``/``w_up`` column-parallel, ``w_down``
row-parallel); under expert parallelism the experts themselves are
split over ``expert``, a rank computing its experts' capacity rows of
the batch every expert rank shares. The router runs whole on every rank.
Serving on a mesh that splits the decode's slot batch, the router
probabilities are all-gathered and routed as one global group
(:func:`_moe_ffn`), as the JAX engine's one program routes them.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from tpudist_torch.config import ModelConfig
from tpudist_torch.models import transformer as T


def _layer_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """The transformer's attention half and norms, then the router and
    the stacked experts."""
    L, d, E, dff = cfg.n_layers, cfg.d_model, cfg.n_experts, cfg.d_ff
    shapes = {name: shape for name, shape in T._layer_shapes(cfg).items()
              if name not in ("w_gate", "w_up", "w_down")}
    shapes.update(w_router=(L, d, E), w_gate=(L, E, d, dff),
                  w_up=(L, E, d, dff), w_down=(L, E, dff, d))
    return shapes


class MoE(nn.Module):
    """Parameters of the mixture-of-experts transformer."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(
            (cfg.vocab_size, cfg.d_model), device=device))
        self.layers = T.Layers(_layer_shapes(cfg), device=device)
        self.final_norm = nn.Parameter(torch.empty((cfg.d_model,),
                                                   device=device))


@torch.no_grad()
def init(cfg: ModelConfig, *, generator: torch.Generator) -> MoE:
    """Seeded parameters on ``generator``'s device: the JAX package's
    fan-in recipe (``tpudist/models/moe.py:91-106``; the two frameworks
    draw different numbers from one seed)."""
    d, h = cfg.d_model, cfg.n_heads
    return T.fill_params(MoE(cfg, device=generator.device),
                         {"wq": d, "wk": d, "wv": d, "wo": h * (d // h),
                          "w_router": d, "w_gate": d, "w_up": d,
                          "w_down": cfg.d_ff}, generator)


def param_specs(cfg: ModelConfig, *, fsdp_axis: str = "fsdp",
                tensor_axis: str = "tensor", pipe_axis: str = "pipe",
                expert_axis: str = "expert"):
    """Sharding specs by ``state_dict`` name, the JAX package's: the
    transformer's for the shared half (but the embedding's vocab over
    fsdp alone), the router's d_model over fsdp, and the expert FFN
    weights' experts dim over ``expert``, then d_model over fsdp and the
    expert-hidden dim over tensor."""
    f, t, pp, e = fsdp_axis, tensor_axis, pipe_axis, expert_axis
    specs = T.param_specs(cfg, fsdp_axis=f, tensor_axis=t, pipe_axis=pp)
    specs.update({"embed": (f, None), "layers.w_router": (pp, f, None),
                  "layers.w_gate": (pp, e, f, t),
                  "layers.w_up": (pp, e, f, t),
                  "layers.w_down": (pp, e, t, f)})
    return specs


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Static per-expert token budget of a routing group of
    ``n_tokens``: ceil(cf · routed pairs / E) over the exact product,
    floored at one row."""
    pairs = n_tokens * cfg.expert_top_k
    return max(1, math.ceil(pairs * cfg.capacity_factor / cfg.n_experts))


def group_size(cfg: ModelConfig, n_tokens: int) -> int:
    """Tokens per routing group: ``moe_group_size``, or the largest
    divisor of ``n_tokens`` at or below it, unless that divisor is under
    half the configured size (near-prime token counts), where one global
    group keeps the capacity and aux semantics; <= 0 disables grouping.
    Groups keep the dispatch tensors linear in the token count."""
    g = cfg.moe_group_size
    if g <= 0 or g >= n_tokens:
        return n_tokens
    d = g
    while n_tokens % d:
        d -= 1
    return d if 2 * d >= g else n_tokens


def _route(probs: torch.Tensor, k: int, cap: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k token-choice routing with capacity, for each routing group.

    probs: (..., t, E) f32 router softmax. Returns (dispatch, combine,
    assigned): dispatch (..., t, E, cap) is the 0/1 token→slot
    assignment, combine is dispatch scaled by the token's renormalised
    gate, and assigned (..., E) counts the assignments BEFORE the
    capacity drop (the aux loss uses these). Slots go in (token, k-slot)
    priority order; pairs past an expert's capacity are dropped.

    The experts are picked by a stable descending sort, so equal
    probabilities pick the lower expert first, as ``lax.top_k`` does (a
    ``topk`` promises no order on ties)."""
    *lead, t, E = probs.shape
    dev = probs.device
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = top.values[..., :k], top.indices[..., :k]     # (..., t, k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    # (..., t, k, E)
    onehot = (idx[..., None] == torch.arange(E, device=dev)).to(
        torch.float32)
    flat = onehot.reshape(*lead, t * k, E)                     # priority order
    # slot within the expert: an exclusive cumsum, exact in f32 (< 2**24)
    pos = torch.cumsum(flat, dim=-2) - flat
    pos = (pos * flat).sum(-1).reshape(*lead, t, k).to(torch.int64)
    kept = onehot * (pos < cap)[..., None].to(torch.float32)
    # (..., t, k, cap)
    slot = (pos[..., None] == torch.arange(cap, device=dev)).to(
        torch.float32)
    dispatch = torch.einsum("...tke,...tkc->...tec", kept, slot)
    # one k-slot a (token, expert) is nonzero: the product is the gate
    combine = torch.einsum("...tke,...tkc->...tec", kept * gates[..., None],
                           slot)
    return dispatch, combine, onehot.sum(dim=(-3, -2))


def _moe_ffn(y: torch.Tensor, lp, cfg: ModelConfig, groups=None,
             slot_group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routed SwiGLU experts. y: (b, s, d) normed activations. Returns
    (ffn_out (b, s, d), aux scalar f32). Groups split the token-major
    order. The router product runs in the model dtype and the softmax in
    f32; dispatch and combine are cast to the model dtype before their
    einsums, so bf16 rounds the gates as the JAX package does.

    A sharded step's ``groups`` route the global batch its data x fsdp
    ranks split (rank ``i`` holds tokens ``[i t, (i + 1) t)``), as a
    serve mesh's ``slot_group`` routes a decode's global slot batch. A
    routing group inside one rank's tokens is routed there; otherwise
    the router probabilities are all-gathered in global order and routed
    as the global batch's groups, with the global capacity, and this
    rank keeps its tokens' rows of dispatch and combine (a serve mesh
    always gathers). A capacity row holds one token, so the experts run
    on any split of this rank's tokens into pieces that each lie inside
    one routing group.

    Under tensor parallelism the experts' hidden dim is this rank's
    part; with the experts dim split over ``expert`` (``groups``'s
    ``expert_group``) the rank runs its own experts on its columns of
    dispatch and combine (module docstring). The tokens and the WHOLE
    combine enter the experts through :meth:`StepGroups.enter` before
    the columns are cut, so their grads, partials of the rank's experts,
    sum over the group; the router and the aux loss read the tokens and
    the probabilities outside it, so their grads, the same on every
    rank, are not summed."""
    b, s, d = y.shape
    dt = y.dtype
    t = b * s
    if groups is not None:
        ways, index, gather = groups.batch, groups.batch_index, \
            groups.batch_gather
    elif slot_group is not None:
        ways, index, gather = slot_group.ways, slot_group.index, \
            slot_group.gather
    else:
        ways, index, gather = 1, 0, None
    total = t * ways
    g = group_size(cfg, total)
    cap = capacity(cfg, g)
    # g, unless a routing group spans ranks: then pieces of it
    p = math.gcd(g, t)
    yg = y.reshape(t // p, p, d)                               # (G, p, d)

    logits = torch.einsum("gtd,de->gte", yg,
                          lp["w_router"].to(dt)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                      # (G, p, E)
    gathered = slot_group is not None or (ways > 1 and t % g)
    if gathered:
        probs = gather(probs.reshape(t, -1)).reshape(
            total // g, g, -1)                                 # (G, g, E)
        dispatch, combine, assigned = _route(probs, cfg.expert_top_k, cap)
        off = index * t
        dispatch, combine = (x.reshape(total, *x.shape[-2:])[off:off + t]
                             .reshape(t // p, p, *x.shape[-2:])
                             for x in (dispatch, combine))
    else:
        dispatch, combine, assigned = _route(probs, cfg.expert_top_k, cap)

    (wg, wu), wd = (lp["w_gate"], lp["w_up"]), lp["w_down"]
    tp = groups is not None and groups.tp
    ep = groups is not None and groups.expert_group is not None
    if tp or ep:
        # the experts' partial sums (this rank's experts, its hidden
        # columns) reduce over the expert x tensor ranks of the place;
        # the router above read the replicated tokens
        group = groups.expert_group if ep else groups.tensor_group
        yg = groups.enter(yg, group)
        combine = groups.enter(combine, group)
        if ep:
            e0, e1 = groups.expert_part(cfg.n_experts)
            dispatch, combine = dispatch[..., e0:e1, :], combine[..., e0:e1, :]
        if tp:
            (wg, wu), wd = groups.ffn_weights((wg, wu), wd, cfg.d_ff)
    xe = torch.einsum("gtd,gtec->gecd", yg, dispatch.to(dt))
    gate = F.silu(torch.einsum("gecd,edf->gecf", xe, wg.to(dt)))
    up = torch.einsum("gecd,edf->gecf", xe, wu.to(dt))
    ye = torch.einsum("gecf,efd->gecd", gate * up, wd.to(dt))
    out = torch.einsum("gecd,gtec->gtd", ye, combine.to(dt))
    if tp or ep:
        # the partial sums, all-reduced after combine: (t, d) rather
        # than (G, E, cap, d), and both products are linear
        out = groups.exit(out, group)

    # Switch aux: the fraction of routed pairs per expert (pre-drop
    # counts) times the mean router probability, scaled by E; routed on
    # a rank's own tokens of a split batch, the per-expert sums are
    # summed over its ranks first
    if ways > 1 and not gathered:
        f_e = groups.batch_sum(assigned.sum(0)) / (total
                                                   * cfg.expert_top_k)
        p_e = groups.batch_sum(probs.sum(dim=(0, 1))) / total
    else:
        f_e = assigned.sum(0) / (total * cfg.expert_top_k)
        p_e = probs.mean(dim=(0, 1))
    aux = cfg.n_experts * torch.sum(f_e * p_e)
    return out.reshape(b, s, d), aux


def _moe_layer(x, lp, cfg: ModelConfig, cos, sin, attn_impl, groups=None):
    """One decoder layer: the transformer's attention half, then the
    experts. Returns ``(x, aux)``."""
    x = T._attn_sublayer(x, lp, cfg, cos, sin, attn_impl, groups=groups)
    ffn, aux = _moe_ffn(T.rmsnorm(x, lp["ffn_norm"]), lp, cfg, groups)
    return x + ffn, aux


def _moe_ffn_sublayer(x, lp, cfg: ModelConfig, slot_group=None):
    """Pre-norm expert FFN + residual, in the shape the transformer's
    serving forwards take as ``ffn``. The aux loss is dropped: serving
    has no objective. Every slot of a decode batch routes, empty ones
    too, and takes capacity, as in the JAX package; a serve mesh's
    ``slot_group`` routes the global slot batch (:func:`_moe_ffn`)."""
    ffn, _aux = _moe_ffn(T.rmsnorm(x, lp["ffn_norm"]), lp, cfg,
                         slot_group=slot_group)
    return x + ffn


def _cached_hidden_states(params: MoE, tokens: torch.Tensor,
                          cfg: ModelConfig, *, dtype, kv_cache, cur_index,
                          slot_group=None):
    """Serving path: the transformer's cache contract
    (:func:`transformer._cached_hidden_states`) with the experts as the
    FFN half, routed over ``slot_group``'s global slot batch when a
    serve mesh splits the slots."""
    ffn = (_moe_ffn_sublayer if slot_group is None
           else functools.partial(_moe_ffn_sublayer, slot_group=slot_group))
    return T._cached_hidden_states(params, tokens, cfg, dtype=dtype,
                                   kv_cache=kv_cache, cur_index=cur_index,
                                   ffn=ffn)


def paged_hidden_states(params: MoE, tokens: torch.Tensor,
                        cfg: ModelConfig, *, dtype, pool_k, pool_v,
                        page_table, positions, write_ok, page_tokens: int,
                        pool_group=None):
    """Paged serving path: :func:`transformer.paged_hidden_states` with
    the experts as the FFN half. The slots are never split here: every
    rank of a serve mesh routes the whole slot batch, as one card
    does."""
    return T.paged_hidden_states(params, tokens, cfg, dtype=dtype,
                                 pool_k=pool_k, pool_v=pool_v,
                                 page_table=page_table, positions=positions,
                                 write_ok=write_ok, page_tokens=page_tokens,
                                 ffn=_moe_ffn_sublayer,
                                 pool_group=pool_group)


def hidden_states(params: MoE, tokens: torch.Tensor, cfg: ModelConfig, *,
                  dtype=torch.bfloat16, attn_impl=T._attention,
                  rope_offset: int = 0, rope_positions=None,
                  remat: bool = False, kv_cache=None, cur_index=None,
                  groups=None, slot_group=None):
    """Backbone forward: tokens (batch, seq) -> (final-norm hidden states
    (batch, seq, d_model) in ``dtype``, the mean aux loss over layers).
    ``attn_impl`` / ``rope_offset`` / ``rope_positions``: a context
    shard's attention and absolute positions (the dense transformer's
    contract). ``remat`` checkpoints each layer.
    ``kv_cache``/``cur_index`` select the serving path and the return
    becomes ``(h, kv_cache)``, its decode routed over ``slot_group``'s
    ranks when given. ``groups``: a sharded step's."""
    if kv_cache is not None:
        return _cached_hidden_states(params, tokens, cfg, dtype=dtype,
                                     kv_cache=kv_cache, cur_index=cur_index,
                                     slot_group=slot_group)
    s = tokens.shape[1]
    hd = cfg.d_model // cfg.n_heads
    cos, sin = T.precompute_rope(s, hd, cfg.rope_theta, rope_positions,
                                 device=tokens.device, offset=rope_offset)
    x = T._embed(params, tokens, dtype, groups)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for i in range(cfg.n_layers):
        lp = params.layers.layer(i)
        if remat:
            x, a = torch.utils.checkpoint.checkpoint(
                _moe_layer, x, lp, cfg, cos, sin, attn_impl, groups,
                use_reentrant=False)
        else:
            x, a = _moe_layer(x, lp, cfg, cos, sin, attn_impl, groups)
        aux = aux + a
    return T.rmsnorm(x, params.final_norm), aux / cfg.n_layers


def loss_fn(params: MoE, tokens: torch.Tensor, cfg: ModelConfig, *,
            dtype=torch.bfloat16, remat: bool = False, xent_chunks: int = 0,
            fused_xent: bool = False, groups=None) -> torch.Tensor:
    """Causal next-token cross-entropy through the transformer's LM head
    (:func:`transformer.head_loss`: plain, chunked or fused) plus the
    router aux loss weighted by ``router_aux_weight``."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    h, aux = hidden_states(params, inputs, cfg, dtype=dtype, remat=remat,
                           groups=groups)
    xent = T.head_loss(params.embed.to(dtype), h, targets,
                       xent_chunks=xent_chunks, fused_xent=fused_xent,
                       groups=groups)
    return xent + cfg.router_aux_weight * aux


def make_cp_loss_fn(cfg: ModelConfig, *, dtype=torch.bfloat16,
                    remat: bool = False, xent_chunks: int = 0,
                    fused_xent: bool = False, impl: str = "ring"):
    """Context-parallel MoE loss: the dense transformer's scheme
    (:func:`transformer.make_cp_loss_fn`: the zigzag ring or Ulysses by
    ``impl``) with the MoE's particulars. Each context shard routes its
    OWN (zigzag-ordered) sequence slice of the batch its data x fsdp
    ranks split: the JAX program's token-major ``(B_global, s_local)``
    order, over ``groups``' batch group (the data x fsdp ranks at this
    rank's context coordinate). The router aux loss is taken per context
    shard and averaged with the xent over the context ranks by the
    step's mean."""

    def shard_loss(params, inputs, targets, attn, pos, off, groups):
        h, aux = hidden_states(params, inputs, cfg, dtype=dtype,
                               attn_impl=attn, rope_positions=pos,
                               rope_offset=off, remat=remat, groups=groups)
        local = T.head_loss(params.embed.to(dtype), h, targets,
                            xent_chunks=xent_chunks, fused_xent=fused_xent,
                            groups=groups)
        return local + cfg.router_aux_weight * aux

    return T.make_cp_loss(shard_loss, impl=impl)
