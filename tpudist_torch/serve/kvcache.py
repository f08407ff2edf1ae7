"""Dense KV cache for the serving engine.

One K and one V tensor of canonical shape ``(n_layers, slots, max_seq,
n_kv_heads, head_dim)``: one private ``max_seq``-long row per slot. The
cache stores the COMPACT kv heads (the layout ``wk``/``wv`` produce);
expansion to the query heads happens inside the attention math.

``layout`` is the physical storage order: ``"st"`` (canonical,
seq-major) or ``"hs"`` (heads-major). The model's cache API always sees
canonical; :func:`to_canonical` / :func:`from_canonical` are permuted
views of the storage, so the model's in-place writes land in it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

KV_CACHE_LAYOUTS = ("st", "hs")


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    """Static shape/dtype/layout of one serving run's KV cache."""

    n_layers: int
    slots: int
    max_seq: int
    n_kv_heads: int
    head_dim: int
    dtype: torch.dtype = torch.float32
    layout: str = "st"

    @classmethod
    def from_model(cls, cfg, *, slots: int, max_seq: int,
                   dtype=torch.float32, layout: str = "st") -> "CacheSpec":
        return cls(n_layers=cfg.n_layers, slots=slots, max_seq=max_seq,
                   n_kv_heads=cfg.n_kv_heads,
                   head_dim=cfg.d_model // cfg.n_heads,
                   dtype=dtype, layout=layout)

    @property
    def canonical_shape(self) -> tuple:
        return (self.n_layers, self.slots, self.max_seq,
                self.n_kv_heads, self.head_dim)

    @property
    def storage_shape(self) -> tuple:
        l, s, t, h, d = self.canonical_shape
        return (l, s, t, h, d) if self.layout == "st" else (l, s, h, t, d)

    @property
    def bytes(self) -> int:
        """Total cache footprint (K + V)."""
        n = 1
        for d in self.canonical_shape:
            n *= d
        return 2 * n * torch.empty((), dtype=self.dtype).element_size()


def to_canonical(arr: torch.Tensor, layout: str) -> torch.Tensor:
    """Storage layout → canonical (L, slots, seq, kv_heads, head_dim), as
    a view. A no-op for ``"st"``; ``"hs"`` swaps seq and heads (the swap
    is its own inverse)."""
    if layout == "st":
        return arr
    if layout == "hs":
        return arr.permute(0, 1, 3, 2, 4)
    raise ValueError(f"unknown kv-cache layout {layout!r}: "
                     f"{' | '.join(KV_CACHE_LAYOUTS)}")


def from_canonical(arr: torch.Tensor, layout: str) -> torch.Tensor:
    """Canonical → storage layout (see :func:`to_canonical`)."""
    return to_canonical(arr, layout)


def init_cache(spec: CacheSpec, device) -> Dict[str, torch.Tensor]:
    """Zero-initialised ``{"k", "v"}`` cache in the storage layout on
    ``device``. Zeros are never read (the length mask guards every
    slot), but a deterministic initial value keeps a serve run a pure
    function of (params, seed)."""
    if spec.layout not in KV_CACHE_LAYOUTS:
        raise ValueError(f"unknown kv-cache layout {spec.layout!r}: "
                         f"{' | '.join(KV_CACHE_LAYOUTS)}")
    return {"k": torch.zeros(spec.storage_shape, dtype=spec.dtype,
                             device=device),
            "v": torch.zeros(spec.storage_shape, dtype=spec.dtype,
                             device=device)}
