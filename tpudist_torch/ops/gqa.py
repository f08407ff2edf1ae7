"""Grouped-query attention head expansion for the plain attention paths
(dense, blockwise, cached decode). The flash kernel does not use it: it
reads compact k/v and maps q head i to kv head i // (h / kv) itself."""

from __future__ import annotations

from typing import Tuple

import torch


def expand_gqa(q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Repeat grouped kv heads up to q's head count. q: (..., heads, hd);
    k/v: (..., kv_heads, hd) with heads on axis 2 in the (batch, seq,
    heads, hd) layout. Consecutive q heads share one kv head."""
    if k.shape[2] != q.shape[2]:
        rep = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    return k, v
