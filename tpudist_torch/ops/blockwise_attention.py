"""Blockwise causal attention: the long-sequence plain path.

The dense path materialises the (b, h, s, s) score tensor; this cuts the
query sequence into chunks and folds key/value chunks through an online
softmax, computing only lower-triangle blocks, so nothing bigger than a
(b, h, chunk, chunk) block exists. ``_attention`` routes long causal
sequences here when the flash kernel does not take their shape.
"""

from __future__ import annotations

import torch

from tpudist_torch.ops.gqa import expand_gqa

NEG = -1e30


def blockwise_causal_attention(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *,
                               chunk: int = 1024) -> torch.Tensor:
    """Causal attention, O(s·chunk) memory. q/k/v: (batch, seq, heads,
    hd); k/v may carry fewer (grouped-query) heads. Returns (b, s, heads,
    hd) in q's dtype. ``seq`` must divide by ``chunk``."""
    b, s, hq, dq = q.shape
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    k, v = expand_gqa(q, k, v)
    qT = q.transpose(1, 2)
    kT = k.transpose(1, 2)
    vT = v.transpose(1, 2)
    scale = dq ** -0.5
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=q.device).tril()
    outs = []
    for qi in range(s // chunk):
        qc = qT[:, :, qi * chunk:(qi + 1) * chunk].float()
        num = torch.zeros((b, hq, chunk, dq), dtype=torch.float32,
                          device=q.device)
        den = torch.zeros((b, hq, chunk), dtype=torch.float32,
                          device=q.device)
        mx = torch.full((b, hq, chunk), NEG, dtype=torch.float32,
                        device=q.device)
        for kj in range(qi + 1):             # lower triangle only
            kc = kT[:, :, kj * chunk:(kj + 1) * chunk]
            vc = vT[:, :, kj * chunk:(kj + 1) * chunk]
            scores = torch.einsum("bhqd,bhkd->bhqk", qc, kc.float()) * scale
            if kj == qi:                      # diagonal block: intra mask
                scores = scores.masked_fill(~tri, NEG)
            nm = torch.maximum(mx, scores.amax(-1))
            corr = torch.exp(mx - nm)
            p = torch.exp(scores - nm[..., None])
            num = num * corr[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(q.dtype).float(), vc.float())
            den = den * corr + p.sum(-1)
            mx = nm
        outs.append((num / den[..., None]).to(q.dtype))
    return torch.cat(outs, dim=2).transpose(1, 2)
