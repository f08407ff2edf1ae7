"""KV cache for the serving engine: dense arena OR paged pool.

Counterpart of ``tpudist/serve/kvcache.py``. Two storage disciplines,
one module:

* **Dense arena** (:class:`CacheSpec`): one K and one V tensor of
  canonical shape ``(n_layers, slots, max_seq, n_kv_heads, head_dim)``,
  one private ``max_seq``-long row per slot. ``layout`` is the physical
  storage order: ``"st"`` (canonical, seq-major) or ``"hs"``
  (heads-major). The model's cache API always sees canonical;
  :func:`to_canonical` / :func:`from_canonical` are permuted views of
  the storage, so the model's in-place writes land in it.
* **Paged pool** (:class:`PagedCacheSpec` + :class:`PageAllocator`):
  fixed-size pages of ``page_tokens`` positions in a pool of ``pages``
  (+1 sacrificial TRASH page), mapped to slots through a host-owned
  slot→page table. A slot holds pages only for positions it has
  written, so the pool can be sized below ``slots × max_seq``. Full
  pages of a shared system-prompt prefix are REFCOUNTED and shared by
  every slot (``register_shared``); the partial tail page is forked
  copy-on-write at admission (the prefill recomputes those positions
  into the slot's first private page), so no slot ever writes a shared
  page. Masked or invalid writes go to the trash page (pool index
  ``pages``), which no page table references and the ownership mask
  therefore never reads.

The page table never lives in the device state: the HOST allocator owns
it, and each dispatch copies the current table into the captured
program's input buffer, so admission, eviction and page exhaustion are
host decisions between dispatches and the programs stay the ones the
engine pinned (:mod:`tpudist_torch.serve.engine`).

On a serve mesh a rank holds its slots of the dense arena
(:func:`slot_span`), as the JAX package's ``cache_shardings`` places
them: the spec is :func:`tpudist_torch.parallel.sharding.kv_cache_specs`,
sanitised, so a slot count the batch axes don't divide is replicated.
The paged pool's rows are placed the same way (:func:`pool_span`, the
JAX ``paged_cache_shardings``): split over the batch axes where they
divide ``pages + 1``, else replicated.

Either way the cache stores the COMPACT kv heads (the layout
``wk``/``wv`` produce); expansion to the query heads happens inside the
attention math.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tpudist_torch.config import STAGING_STATE_HEADROOM
from tpudist_torch.parallel import sharding
from tpudist_torch.parallel.mesh import mesh_devices, mesh_shape
from tpudist_torch.parallel.sharding import KV_CACHE_LAYOUTS


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


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
        return 2 * n * _itemsize(self.dtype)


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


def cache_spec_on(spec: CacheSpec, mesh) -> sharding.Spec:
    """The K/V arrays' spec on ``mesh`` (the JAX ``cache_shardings``),
    sanitised as model params are: a slot count the batch axes don't
    divide falls back to replicated instead of erroring."""
    return sharding.sanitize_spec(spec.storage_shape,
                                  sharding.kv_cache_specs(spec.layout),
                                  mesh_shape(mesh))


def slot_span(spec: CacheSpec, mesh, rank: int) -> Tuple[int, int]:
    """The slots ``[lo, hi)`` that ``rank`` (a device id of ``mesh``)
    holds, as ``NamedSharding`` places them: the slot dim cut into equal
    contiguous chunks over its axes, outermost first, chunk ``i`` on the
    devices at position ``i`` of those axes; every slot where the spec
    replicates them."""
    return _span(sharding.spec_axes(cache_spec_on(spec, mesh)[1]),
                 spec.slots, mesh, rank)


def _span(axes, size: int, mesh, rank: int) -> Tuple[int, int]:
    """``rank``'s chunk ``[lo, hi)`` of a dim of ``size`` split over
    ``axes`` of ``mesh`` (the whole dim for no axes)."""
    devs = mesh_devices(mesh)
    names = list(mesh.mesh_dim_names)
    pos = np.argwhere(devs == rank)
    if not len(pos):
        raise ValueError(f"rank {rank} is not a device of the mesh")
    idx, ways = 0, 1
    for a in axes:
        n = devs.shape[names.index(a)]
        idx, ways = idx * n + int(pos[0][names.index(a)]), ways * n
    per = size // ways
    return idx * per, (idx + 1) * per


def init_cache(spec: CacheSpec, device, mesh=None,
               rank: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Zero-initialised ``{"k", "v"}`` cache in the storage layout on
    ``device``; on a ``mesh``, ``rank``'s slots of it
    (:func:`slot_span`; ``rank`` defaults to this process's). Zeros are
    never read (the length mask guards every slot), but a deterministic
    initial value keeps a serve run a pure function of (params, seed)."""
    if spec.layout not in KV_CACHE_LAYOUTS:
        raise ValueError(f"unknown kv-cache layout {spec.layout!r}: "
                         f"{' | '.join(KV_CACHE_LAYOUTS)}")
    shape = list(spec.storage_shape)
    if mesh is not None:
        if rank is None:
            import torch.distributed as dist
            rank = dist.get_rank()
        lo, hi = slot_span(spec, mesh, rank)
        shape[1] = hi - lo
    return {"k": torch.zeros(shape, dtype=spec.dtype, device=device),
            "v": torch.zeros(shape, dtype=spec.dtype, device=device)}


# ------------------------------------------------------------------ #
# paged pool                                                          #
# ------------------------------------------------------------------ #


@dataclasses.dataclass(frozen=True)
class PagedCacheSpec:
    """Static shape/dtype of one serving run's PAGED KV pool.

    ``pages`` is the usable pool size; the physical pool carries one
    extra sacrificial TRASH page at index ``pages`` where every
    masked/invalid write is routed (a page table never references it,
    so the ownership mask never reads it). ``page_tokens`` is the fixed
    page length in positions; ``max_pages_per_slot`` is the page-table
    row width (``ceil(max_seq / page_tokens)``)."""

    n_layers: int
    slots: int
    max_seq: int
    n_kv_heads: int
    head_dim: int
    page_tokens: int
    pages: int
    dtype: torch.dtype = torch.float32

    @classmethod
    def from_model(cls, cfg, *, slots: int, max_seq: int,
                   page_tokens: int, pages: int = 0,
                   dtype=torch.float32) -> "PagedCacheSpec":
        if not 0 < page_tokens <= max_seq:
            raise ValueError(
                f"--kv-page-tokens {page_tokens} must be in (0, "
                f"max_seq {max_seq}]")
        maxp = -(-max_seq // page_tokens)
        if pages <= 0:
            # default pool = full dense capacity: admission can never be
            # denied; operators shrink it to trade capacity for
            # sustained concurrency
            pages = slots * maxp
        return cls(n_layers=cfg.n_layers, slots=slots, max_seq=max_seq,
                   n_kv_heads=cfg.n_kv_heads,
                   head_dim=cfg.d_model // cfg.n_heads,
                   page_tokens=int(page_tokens), pages=int(pages),
                   dtype=dtype)

    @property
    def max_pages_per_slot(self) -> int:
        return -(-self.max_seq // self.page_tokens)

    @property
    def pool_shape(self) -> tuple:
        # +1: the trash page
        return (self.n_layers, self.pages + 1, self.page_tokens,
                self.n_kv_heads, self.head_dim)

    @property
    def table_bytes(self) -> int:
        return self.slots * self.max_pages_per_slot * 4   # int32 table

    @property
    def bytes(self) -> int:
        """The PAGED footprint: pool pages (trash included: it is real
        device memory) × page bytes for K and V, plus the page table's
        int32 bytes. The number serve_tick, the summary and the memory
        ledger report, so a fixed-memory claim is measured against what
        is allocated, not the dense formula."""
        n = 1
        for d in self.pool_shape:
            n *= d
        return 2 * n * _itemsize(self.dtype) + self.table_bytes


def paged_cache_spec_on(spec: PagedCacheSpec, mesh) -> sharding.Spec:
    """The paged pools' spec on ``mesh`` (the JAX
    ``paged_cache_shardings``), sanitised: the ``pages + 1`` pool rows
    ride the batch axes only where those divide them, else the pool is
    replicated (the rule: the trash page makes the row count odd)."""
    return sharding.sanitize_spec(spec.pool_shape,
                                  sharding.paged_kv_cache_specs(),
                                  mesh_shape(mesh))


def pool_span(spec: PagedCacheSpec, mesh, rank: int) -> Tuple[int, int]:
    """The pool rows ``[lo, hi)`` of the ``pages + 1`` that ``rank``
    holds, as ``NamedSharding`` places them (:func:`slot_span`'s rule);
    every row where the spec replicates the pool. The trash page, row
    ``pages``, lies on the last chunk's ranks."""
    return _span(sharding.spec_axes(paged_cache_spec_on(spec, mesh)[1]),
                 spec.pages + 1, mesh, rank)


def init_paged_cache(spec: PagedCacheSpec, device, rows: int = 0
                     ) -> Dict[str, torch.Tensor]:
    """Zero-initialised paged ``{"k", "v"}`` pool (trash page included)
    on ``device``; with ``rows``, a split pool's chunk of that many rows
    plus one private DISCARD row, where this rank routes the writes of
    rows other ranks hold (it belongs to no page and no read sees it)."""
    shape = list(spec.pool_shape)
    if rows:
        shape[1] = rows + 1
    return {"k": torch.zeros(shape, dtype=spec.dtype, device=device),
            "v": torch.zeros(shape, dtype=spec.dtype, device=device)}


class PageAllocatorError(RuntimeError):
    """An allocator invariant broke (refcount underflow, double admit):
    a HOST bug, raised loudly rather than silently corrupting the
    slot→page mapping the captured programs trust."""


class PageAllocator:
    """Host-side page bookkeeping for one paged serve run, a copy of the
    JAX package's (numpy state, the same decisions).

    Owns the slot→page table (``table``, int32 ``(slots,
    max_pages_per_slot)``, -1 = unmapped) and the free list. Pages are
    REFCOUNTED: private pages hold refcount 1 (their slot); shared
    prefix pages hold one count per using slot PLUS one registry hold
    (``register_shared``) so the cached prefix survives every slot
    freeing. Every method is deterministic (the free list is FIFO in
    page order), so a seeded serve run maps the same pages every run.
    """

    def __init__(self, spec: PagedCacheSpec):
        self.spec = spec
        self.free: List[int] = list(range(spec.pages))
        self.refcount = np.zeros((spec.pages,), np.int64)
        self.table = np.full(
            (spec.slots, spec.max_pages_per_slot), -1, np.int32)
        # shared prefix registry: logical page index -> page id, plus
        # how many leading POSITIONS those full pages cover
        self.shared_pages: Tuple[int, ...] = ()
        self.shared_len = 0
        # admission page ceiling: the whole pool by default; a memory
        # bound (set_memory_bound) lowers it when the device cannot
        # afford every configured page beside the params and the
        # programs' scratch
        self.page_cap = spec.pages
        self.bound_source = "none"     # none | ledger | heuristic

    def set_memory_bound(self, *, hbm_bytes: float,
                         params_bytes: float = 0,
                         program_temp_bytes: Optional[int] = None,
                         ways: int = 1) -> int:
        """Cap admissions to the pages device memory can afford.

        The pool is allocated in full either way; this bounds how many
        pages admission will ever MAP, so a pool configured past the
        device's capacity backpressures at admission instead of failing
        the next allocation. The margin beside the pool is the params
        plus the programs' measured scratch (``program_temp_bytes``,
        :mod:`tpudist_torch.obs.memledger`) when known, else
        ``STAGING_STATE_HEADROOM x params``; ``bound_source`` records
        which. ``ways``: the cards a split pool's pages are spread over
        (:func:`pool_span`), each holding ``1/ways`` of every page count,
        so a card affords ``ways`` times the pages. Returns the page cap,
        clamped to [0, spec.pages], never below the shared-prefix
        registry's pages."""
        if program_temp_bytes is not None and program_temp_bytes >= 0:
            margin = float(params_bytes) + float(program_temp_bytes)
            self.bound_source = "ledger"
        else:
            margin = STAGING_STATE_HEADROOM * float(params_bytes)
            self.bound_source = "heuristic"
        page_bytes = 2 * self.spec.n_layers * self.spec.page_tokens \
            * self.spec.n_kv_heads * self.spec.head_dim \
            * _itemsize(self.spec.dtype)
        avail = float(hbm_bytes) - margin - self.spec.table_bytes
        cap = int(avail * ways // page_bytes) if page_bytes > 0 else 0
        cap = max(cap, len(self.shared_pages))
        self.page_cap = min(max(cap, 0), self.spec.pages)
        return self.page_cap

    # ------------------------------------------------------- internal

    def _take(self) -> Optional[int]:
        # the memory bound caps LIVE pages, not just the free list
        if not self.free or self.pages_used() >= self.page_cap:
            return None
        pg = self.free.pop(0)
        self.refcount[pg] += 1
        return pg

    def _drop(self, pg: int) -> None:
        if self.refcount[pg] <= 0:
            raise PageAllocatorError(
                f"page {pg} refcount underflow: freed more times than "
                f"held — the slot→page bookkeeping is corrupt")
        self.refcount[pg] -= 1
        if self.refcount[pg] == 0:
            self.free.append(pg)

    # --------------------------------------------------------- shared

    def register_shared(self, prefix_len: int) -> Tuple[int, ...]:
        """Reserve the FULL pages of a ``prefix_len``-token shared
        prefix (the partial tail page is never shared: admission forks
        it into the slot's first private page by recomputation). Each
        reserved page takes a registry hold. Returns the reserved page
        ids, in logical order."""
        if self.shared_pages:
            raise PageAllocatorError("shared prefix already registered")
        pt = self.spec.page_tokens
        n_full = max(int(prefix_len), 0) // pt
        pages: List[int] = []
        for _ in range(n_full):
            pg = self._take()
            if pg is None:
                for p in pages:        # rollback: nothing half-shared
                    self._drop(p)
                raise PageAllocatorError(
                    f"pool of {self.spec.pages} pages cannot hold the "
                    f"{n_full}-page shared prefix")
            pages.append(pg)
        self.shared_pages = tuple(pages)
        self.shared_len = n_full * pt
        return self.shared_pages

    # ------------------------------------------------------ lifecycle

    def admit(self, slot: int, prompt_len: int,
              shared: bool = False) -> bool:
        """Map pages for one admission: the shared full prefix pages
        (when ``shared``) plus private pages covering positions
        ``[shared_len, prompt_len)``. All-or-nothing: a pool too empty
        rolls back and returns False (the request stays WAITING:
        backpressure, not shedding)."""
        if (self.table[slot] >= 0).any():
            raise PageAllocatorError(
                f"slot {slot} admitted while still holding pages")
        pt = self.spec.page_tokens
        need = -(-int(prompt_len) // pt)            # pages [0, need)
        row = np.full((self.spec.max_pages_per_slot,), -1, np.int32)
        taken: List[int] = []
        for j in range(need):
            if shared and j < len(self.shared_pages):
                pg = self.shared_pages[j]
                self.refcount[pg] += 1              # one hold per slot
            else:
                got = self._take()
                if got is None:
                    for p in taken:
                        self._drop(p)
                    if shared:
                        for jj in range(min(j, len(self.shared_pages))):
                            self._drop(self.shared_pages[jj])
                    return False
                pg = got
                taken.append(pg)
            row[j] = pg
        self.table[slot] = row
        return True

    def admit_shared_len(self, shared: bool) -> int:
        """The prefill's ``shared_len`` input for an admission:
        positions below it are NOT written (their pages are the shared
        prefix, already holding the same content)."""
        return self.shared_len if shared else 0

    def ensure(self, slot: int, last_pos: int) -> bool:
        """Grow a live slot's mapping to cover positions up to
        ``last_pos`` (inclusive, clamped to the cache capacity) before
        a dispatch writes them. All-or-nothing like :meth:`admit`."""
        pt = self.spec.page_tokens
        upto = min(int(last_pos), self.spec.max_seq - 1) // pt
        taken: List[Tuple[int, int]] = []
        for j in range(upto + 1):
            if self.table[slot, j] >= 0:
                continue
            pg = self._take()
            if pg is None:
                for jj, p in taken:
                    self._drop(p)
                    self.table[slot, jj] = -1
                return False
            taken.append((j, pg))
            self.table[slot, j] = pg
        return True

    def free_slot(self, slot: int) -> None:
        """Return a finished/evicted slot's pages. Shared prefix pages
        drop ONE count (the registry hold keeps them cached for the
        next admission); private pages return to the free list."""
        for j in range(self.spec.max_pages_per_slot):
            pg = int(self.table[slot, j])
            if pg >= 0:
                self._drop(pg)
            self.table[slot, j] = -1

    # ------------------------------------------------------- queries

    def row(self, slot: int) -> np.ndarray:
        return self.table[slot].copy()

    def pages_used(self) -> int:
        return self.spec.pages - len(self.free)

    def can_ever_admit(self, prompt_len: int, shared: bool) -> bool:
        """Could this admission EVER succeed, even with every slot
        freed? False means the request is structurally unservable at
        this pool size (or at the memory bound's page cap): reject it,
        since waiting forever would wedge the run. The shared-prefix
        registry holds are the only permanent reservation."""
        pt = self.spec.page_tokens
        need = -(-int(prompt_len) // pt)
        if shared:
            need = max(need - len(self.shared_pages), 0)
        usable = min(self.spec.pages, self.page_cap)
        return need <= usable - len(self.shared_pages)
