"""Plain PyTorch references: attention with materialised scores and an f32
softmax; the tied LM head's cross-entropy with whole f32 logits.
Deliberately the naive formulation, because obviousness is the point of
a reference."""

from __future__ import annotations

import math

import torch


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (b, s, h, hd); k/v may carry fewer (grouped-query) heads.
    Softmax in f32, output in q's dtype."""
    h, kv = q.shape[2], k.shape[2]
    if kv != h:
        k = k.repeat_interleave(h // kv, dim=2)
        v = v.repeat_interleave(h // kv, dim=2)
    hd = q.shape[-1]
    sc = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    if causal:
        s_q, s_k = sc.shape[-2], sc.shape[-1]
        # top-left-aligned tril is wrong for rectangular (decode-style)
        # shapes; refuse rather than silently mis-mask
        if s_q != s_k:
            raise ValueError(f"causal reference needs s_q == s_k, got "
                             f"{tuple(q.shape)} {tuple(k.shape)}")
        keep = torch.ones(s_q, s_k, dtype=torch.bool,
                          device=q.device).tril()
        sc = sc.masked_fill(~keep, -1e30)
    p = torch.softmax(sc.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def lm_head_xent(h: torch.Tensor, emb: torch.Tensor,
                 targets: torch.Tensor) -> torch.Tensor:
    """Tied-head mean cross-entropy with whole f32 logits.
    h: (tokens, d); emb: (vocab, d); targets: (tokens,) int."""
    logits = h.float() @ emb.float().T
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[:, None])[:, 0]
    return torch.mean(logz - gold)
