"""Persisted tuning cache: measure once, reuse every run. The JAX
package's ``tpudist/tune/cache.py`` with the port's fingerprint.

A tuned operating point is only valid for the exact situation it was
measured in, so cache entries are keyed by a FINGERPRINT of everything
that moves the curve: the model config, global batch, dtypes, the
log/ckpt intervals (they bound the legal k space), the gradient mean's
schedule (``--grad-overlap``, ``--cross-slice``) and the slice map, the
world size and the mesh shape, the device's name, the torch and CUDA versions, the port's version and the
source hash of its CUDA kernels (a changed kernel is a changed curve).
Any of those changing is a different workload — the lookup MUST miss
and re-probe.

One JSON file per fingerprint under the cache dir, written ATOMICALLY
(tmp + rename) and by the COORDINATOR only — workers on a shared
filesystem must never race partial writes; readers treat any unreadable
or mismatched file as a miss, never an error. A cache hit costs zero
probe trials.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from tpudist_torch import config as config_lib
from tpudist_torch.parallel import mesh as mesh_lib

SCHEMA = 1


def kernel_sources() -> list:
    """Each CUDA library's build key (``<name>-<source hash>``, from
    ``ops.cuda.build.library_path``): the bytes of its sources, the
    headers beside them and the compiler flags."""
    from tpudist_torch.ops.cuda import build
    from tpudist_torch.ops.cuda import flash_attention as fa
    from tpudist_torch.ops.cuda import fused_xent as fx
    return [build.library_path(name, sources).parent.name
            for name, sources in ((fa.LIBRARY, fa.SOURCES),
                                  (fa.BWD_LIBRARY, fa.BWD_SOURCES),
                                  (fx.LIBRARY, fx.SOURCES))]


def _resolved(resolve, cfg, default):
    """``resolve(cfg)``, or ``default`` where the setting is invalid (the
    run refuses it anyway)."""
    try:
        return resolve(cfg)
    except ValueError:
        return default


def _slices(world: int) -> list:
    """The world's slice partition (``TPUDIST_SLICE_MAP`` resolved) as a
    JSON-able list, [] when unsliced or malformed."""
    try:
        return list(mesh_lib.resolve_slice_map(world) or [])
    except ValueError:
        return []


def fingerprint(cfg, device: torch.device, *, world: Optional[int] = None,
                device_kind: Optional[str] = None) -> str:
    """Hex fingerprint of the tuning situation (see module docstring).
    ``world`` defaults to the process group's size (1 without one),
    ``device_kind`` to the card's name (``"cpu"`` on the CPU)."""
    from tpudist_torch import __version__
    if world is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
    if device_kind is None:
        device_kind = (torch.cuda.get_device_name(device)
                       if torch.device(device).type == "cuda" else "cpu")
    payload = {
        "schema": SCHEMA,
        "model": dataclasses.asdict(cfg.model),
        "batch_size": cfg.batch_size,
        "dtype": cfg.dtype,
        "adam_nu_dtype": cfg.adam_nu_dtype,
        "log_every": cfg.log_every,
        "ckpt_every_steps": cfg.ckpt_every_steps,
        # the overlap plane changes the program the knobs tune: a point
        # measured with the per-param all-reduces must not serve a
        # bucketed run, nor a flat one a hierarchical run (and the
        # search space differs)
        "grad_overlap": _resolved(config_lib.resolve_grad_overlap, cfg,
                                  ("off",))[0],
        "cross_slice": _resolved(config_lib.resolve_cross_slice, cfg,
                                 "flat"),
        # the slice partition changes which cross_slice points exist
        "slices": _slices(int(world)),
        "world": int(world),
        # the mesh's axis sizes as configured (data -1: the rest of the
        # world), as the JAX cache key carries the mesh
        "mesh": dataclasses.asdict(cfg.parallel),
        "device_kind": device_kind,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "tpudist_torch": __version__,
        "kernels": kernel_sources(),
    }
    blob = json.dumps(payload, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def cache_path(cache_dir: str, fp: str, prefix: str = "tune") -> str:
    return os.path.join(cache_dir, f"{prefix}-{fp}.json")


def _validate_train_tuned(tuned: Dict[str, Any]) -> bool:
    """The train tuner's knob sanity check: the knobs must all be
    present and sane — an insane value (wrong type, non-positive) is a
    MISS here, not a crash later in resolve_staging_budget_bytes. The
    overlap-plane coordinates are validated when present: a bucket bound
    must be a positive number, the cross-slice mode one of the two, and
    the pipeline's coordinate GPipe's (the port refuses the pipe axis, so
    a record that asks for interleaving cannot be applied)."""
    if int(tuned["k"]) < 1 or int(tuned["grad_accum_steps"]) < 1:
        return False
    bool(tuned["remat"])
    budget = tuned["staging_budget_mb"]
    if budget is not None and (isinstance(budget, bool)
                               or not isinstance(budget, (int, float))
                               or budget <= 0):
        return False
    bucket = tuned.get("grad_bucket_mb")
    if bucket is not None and (isinstance(bucket, bool)
                               or not isinstance(bucket, (int, float))
                               or bucket <= 0):
        return False
    return (tuned.get("pipeline_interleave") in (None, 0, 1)
            and tuned.get("cross_slice") in (None, "flat", "hierarchical"))


def load(cache_dir: str, fp: str, *, prefix: str = "tune",
         validate=_validate_train_tuned) -> Optional[Dict[str, Any]]:
    """The cached record for ``fp``, or None on miss — a corrupt,
    partial, wrong-schema or insane file reads as a miss (re-probe),
    never as an error (a stale cache must not fail a run).
    ``prefix``/``validate`` let another tuner (the serve engine's,
    :mod:`tpudist_torch.serve.tune`) share the one cache mechanism with
    its own file prefix and knob schema; a ``validate`` that raises or
    returns False is a miss."""
    try:
        with open(cache_path(cache_dir, fp, prefix)) as f:
            rec = json.load(f)
        if rec.get("schema") != SCHEMA or rec.get("fingerprint") != fp:
            return None
        if not validate(rec["tuned"]):
            return None
        return rec
    except (OSError, ValueError, KeyError, TypeError):
        return None


def store(cache_dir: str, fp: str, record: Dict[str, Any], *,
          prefix: str = "tune") -> bool:
    """Atomically persist ``record`` (coordinator only — callers gate).
    Best-effort: a read-only cache dir degrades to un-cached runs, not a
    failed one."""
    try:
        os.makedirs(cache_dir, exist_ok=True)
        path = cache_path(cache_dir, fp, prefix)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({**record, "schema": SCHEMA, "fingerprint": fp,
                       "created_unix": time.time()}, f, indent=1)
        os.replace(tmp, path)
        return True
    except OSError:
        return False
