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
prefill rotates them up front, since the cache keeps rotated keys.

The training loss's LM head (:func:`head_loss`) is plain (whole logits),
chunked over the sequence with checkpointing, or fused
(:func:`tpudist_torch.ops.cuda.fused_xent.fused_lm_head_xent`: the Hopper
kernels for CUDA tensors, their plain versions for CPU tensors).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from tpudist_torch.config import ModelConfig
from tpudist_torch.ops.blockwise_attention import blockwise_causal_attention
from tpudist_torch.ops.cuda import flash_attention as fa
from tpudist_torch.ops.cuda import fused_xent as fx
from tpudist_torch.ops.gqa import expand_gqa
from tpudist_torch.ops.rope import apply_rope, rotate


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
    """Every layer's weights, stacked on a leading n_layers dim."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        for name, shape in _layer_shapes(cfg).items():
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
        self.layers = Layers(cfg, device=device)
        self.final_norm = nn.Parameter(torch.empty((cfg.d_model,),
                                                   device=device))

    def forward(self, tokens: torch.Tensor, **kw):
        return apply(self, tokens, self.cfg, **kw)


@torch.no_grad()
def init(cfg: ModelConfig, *, generator: torch.Generator) -> Transformer:
    """Seeded parameters on ``generator``'s device: weights normal with
    std 1/sqrt(fan_in), norms ones (the JAX package's recipe; the two
    frameworks draw different numbers from one seed)."""
    model = Transformer(cfg, device=generator.device)
    d, h = cfg.d_model, cfg.n_heads
    fan_in = {"wq": d, "wk": d, "wv": d, "wo": h * (d // h),
              "w_gate": d, "w_up": d, "w_down": cfg.d_ff}
    model.embed.normal_(0.0, 1.0 / math.sqrt(d), generator=generator)
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
                    device=None):
    """RoPE cos/sin tables of shape (seq_len, head_dim//2), f32, on
    ``device`` (or ``positions``' device). ``positions`` (a (seq_len,)
    tensor) overrides ``arange(seq_len)``."""
    if positions is not None:
        device = positions.device
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))
    if positions is not None:
        t = positions.to(torch.float32)
    else:
        t = torch.arange(seq_len, dtype=torch.float32, device=device)
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
                   return_kv: bool = False):
    """Pre-norm attention + residual. ``return_kv=True`` is the serving
    PREFILL mode: q/k are rotated here, up front, and the rotated compact
    k/v come back with the output to seed the KV cache."""
    b, s, d = x.shape
    h, kv = cfg.n_heads, cfg.n_kv_heads
    hd = d // h
    dt = x.dtype

    y = rmsnorm(x, lp["attn_norm"])
    q = (y @ lp["wq"].to(dt)).reshape(b, s, h, hd)
    k = (y @ lp["wk"].to(dt)).reshape(b, s, kv, hd)
    v = (y @ lp["wv"].to(dt)).reshape(b, s, kv, hd)
    if getattr(attn_impl, "accepts_rope", False) and not return_kv:
        o = attn_impl(q, k, v, cos=cos, sin=sin)
    else:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        o = attn_impl(q, k, v)
    o = o.reshape(b, s, h * hd)
    out = x + o @ lp["wo"].to(dt)
    return (out, k, v) if return_kv else out


def _ffn_sublayer(x, lp, cfg: ModelConfig):
    """Pre-norm SwiGLU FFN + residual."""
    dt = x.dtype
    y = rmsnorm(x, lp["ffn_norm"])
    gate = F.silu(y @ lp["w_gate"].to(dt))
    up = y @ lp["w_up"].to(dt)
    return x + (gate * up) @ lp["w_down"].to(dt)


def _layer(x, lp, cfg: ModelConfig, cos, sin, attn_impl):
    """One decoder layer. x: (batch, seq, d_model)."""
    x = _attn_sublayer(x, lp, cfg, cos, sin, attn_impl)
    return _ffn_sublayer(x, lp, cfg)


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


def _embed(params: Transformer, tokens: torch.Tensor, dtype):
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


def hidden_states(params: Transformer, tokens: torch.Tensor,
                  cfg: ModelConfig, *, dtype=torch.bfloat16,
                  attn_impl=_attention, remat: bool = False, kv_cache=None,
                  cur_index=None):
    """Backbone forward: tokens (batch, seq) -> final-norm hidden states
    (batch, seq, d_model) in ``dtype``. ``remat`` checkpoints each layer
    (activations recomputed in backward). ``kv_cache``/``cur_index``
    select the serving path (:func:`_cached_hidden_states`) and the
    return becomes ``(h, kv_cache)``."""
    if kv_cache is not None:
        return _cached_hidden_states(params, tokens, cfg, dtype=dtype,
                                     kv_cache=kv_cache, cur_index=cur_index)
    s = tokens.shape[1]
    hd = cfg.d_model // cfg.n_heads
    cos, sin = precompute_rope(s, hd, cfg.rope_theta, device=tokens.device)
    x = _embed(params, tokens, dtype)
    for i in range(cfg.n_layers):
        lp = params.layers.layer(i)
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                _layer, x, lp, cfg, cos, sin, attn_impl,
                use_reentrant=False)
        else:
            x = _layer(x, lp, cfg, cos, sin, attn_impl)
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
              *, xent_chunks: int = 0,
              fused_xent: bool = False) -> torch.Tensor:
    """Tied LM head + mean cross-entropy, the one head-strategy dispatch.
    ``fused_xent`` routes through the fused kernels (no logits in device
    memory); ``xent_chunks`` > 0 streams the head over that many sequence
    chunks with checkpointing; neither keeps the plain whole-logits path,
    logits in the model dtype."""
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
    return _xent(h @ emb.T, targets)


def loss_fn(params: Transformer, tokens: torch.Tensor, cfg: ModelConfig, *,
            dtype=torch.bfloat16, remat: bool = False, xent_chunks: int = 0,
            fused_xent: bool = False) -> torch.Tensor:
    """Causal next-token cross-entropy: tokens (batch, seq + 1) -> the
    mean over the batch's seq positions."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    h = hidden_states(params, inputs, cfg, dtype=dtype, remat=remat)
    return head_loss(params.embed.to(dtype), h, targets,
                     xent_chunks=xent_chunks, fused_xent=fused_xent)
