"""Sharding layouts: the specs of params, batches, optimizer state and
the serving KV cache.

Counterpart of the layout half of ``tpudist/parallel/sharding.py`` (the
staging half is :mod:`tpudist_torch.parallel.staging`). FSDP is data,
not code: a spec a weight (the models' ``param_specs``), which the
engine turns into the all-gathers and reduce-scatters the JAX package
leaves to XLA's partitioner.

A spec is a tuple with one entry a dim: ``None`` (replicated), an axis
name, or a tuple of axis names (the dim split over their product, in
that order). :func:`placements` maps a spec onto a
``torch.distributed`` mesh as ``Shard(dim)`` / ``Replicate()``, one
entry a mesh axis.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

from tpudist_torch.parallel.mesh import mesh_shape

Spec = Tuple[object, ...]


def spec_axes(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry, outermost first."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def sanitize_spec(shape: Sequence[int], spec: Spec, sizes: Dict[str, int]
                  ) -> Spec:
    """One leaf's spec with the axes that don't divide their dim evenly
    dropped (a vocab of 97 over fsdp=2 stays replicated). A tuple axis
    keeps its longest dividing PREFIX (vocab 1000 over (fsdp=8,
    tensor=4) stays 8-way fsdp-sharded)."""
    dims = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for size, entry in zip(shape, dims):
        kept, ways = [], 1
        for a in spec_axes(entry):
            if size % (ways * sizes.get(a, 1)):
                break
            kept.append(a)
            ways *= sizes.get(a, 1)
        out.append(tuple(kept) if len(kept) > 1
                   else (kept[0] if kept else None))
    return tuple(out)


def sanitize_specs(shapes: Dict[str, Sequence[int]],
                   specs: Dict[str, Spec], mesh) -> Dict[str, Spec]:
    """:func:`sanitize_spec` over ``{name: shape}`` and ``{name: spec}``
    on ``mesh``'s axis sizes: keeps models' specs mesh-agnostic."""
    sizes = mesh_shape(mesh)
    return {name: sanitize_spec(shapes[name], specs[name], sizes)
            for name in specs}


def pure_dp(mesh) -> bool:
    """True when only the ``data`` axis is > 1: the explicit all-reduce
    data-parallel step body. One predicate, shared by the engine's path
    choice and the tuner's axis gating."""
    sizes = mesh_shape(mesh)
    return (sizes.get("data", 1) > 1
            and all(sizes.get(a, 1) == 1
                    for a in ("pipe", "fsdp", "expert", "tensor",
                              "context")))


def batch_spec(ndim: int) -> Spec:
    """Batch arrays shard their leading (batch) dim over data AND fsdp:
    fsdp replicas are extra data-parallel workers for activations."""
    return (("data", "fsdp"), *([None] * (ndim - 1)))


KV_CACHE_LAYOUTS = ("st", "hs")


def kv_cache_specs(layout: str = "st") -> Spec:
    """The serving KV cache's spec, one for the K and the V arrays.
    ``"st"`` stores ``(layers, slots, seq, kv_heads, head_dim)``,
    ``"hs"`` ``(layers, slots, kv_heads, seq, head_dim)``: the slot dim
    rides the batch axes as every activation does (:func:`batch_spec`),
    the kv heads ride ``tensor``, the rest stay whole. Sanitise it
    (:func:`sanitize_spec`), so a slot count the batch axes don't divide
    falls back to replicated."""
    if layout == "st":
        return (None, ("data", "fsdp"), None, "tensor", None)
    if layout == "hs":
        return (None, ("data", "fsdp"), "tensor", None, None)
    raise ValueError(f"unknown kv-cache layout {layout!r}: "
                     f"{' | '.join(KV_CACHE_LAYOUTS)}")


def paged_kv_cache_specs() -> Spec:
    """The PAGED KV pool's spec, ``(layers, pages + 1, page_tokens,
    kv_heads, head_dim)``: pages ride the batch axes, kv heads
    ``tensor``. The trash page makes the pool's size odd as a rule, so
    it sanitises to replicated as a rule."""
    return (None, ("data", "fsdp"), None, "tensor", None)


def sharded_dim(spec: Spec, axis: str = "fsdp") -> Optional[int]:
    """The dim a (sanitized) spec splits over ``axis``, or None."""
    for dim, entry in enumerate(spec):
        if axis in spec_axes(entry):
            return dim
    return None


def placements(spec: Spec, mesh) -> list:
    """``spec`` as ``DTensor`` placements on ``mesh``: ``Shard(dim)`` for
    each mesh axis that splits a dim, ``Replicate()`` for the rest."""
    from torch.distributed.tensor import Replicate, Shard

    out = {a: Replicate() for a in mesh.mesh_dim_names}
    for dim, entry in enumerate(spec):
        for a in spec_axes(entry):
            out[a] = Shard(dim)
    return [out[a] for a in mesh.mesh_dim_names]

