"""Elastic resume: restore a sharded manifest checkpoint onto this run.

A port of ``tpudist/elastic/resume.py``. :func:`restore` reads the newest
committed manifest, validates its data cursor against the resuming run's
config, and assembles this process's region of every leaf (the whole
leaf when the template is replicated, its shard under FSDP) from
whichever saved shards cover it (:func:`_assemble`, the N→M primitive),
so a save at one fsdp size restores at another. Every shard read is checked against the crc32 its
writer recorded; a checkpoint whose bytes are bad is skipped for the
previous committed one. The leaves land on the template's device, in
place: the caller's ``TrainState`` is the template and the result.

:func:`restore_for_resume` is the train loop's one entry: newest wins
between the manifest and the ``orbax`` step directories
(:mod:`tpudist_torch.checkpoint`) of the same ``--save-dir``. The
superstep/staging realignment needs nothing here: the epoch plan is a
pure function of (seed, epoch) and the resume position.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from tpudist_torch.elastic import ckpt as ckpt_mod


class ResumeError(ValueError):
    """A manifest exists but cannot drive this run's resume (structure,
    shape, dtype, or data-cursor mismatch; missing shard coverage).
    ``--resume auto`` turns it into a logged fresh start with a ``fail``
    resume status; ``--resume latest`` lets it propagate."""


class ShardCorruptionError(ResumeError):
    """A committed checkpoint's BYTES are bad: a shard file unreadable or
    truncated, a shard failing its recorded crc32, a missing shard index.
    A restore falls back to the PREVIOUS committed manifest (flagged
    ``fallback_from``/``corrupt_shard`` in ``kind=resume``), where a
    structural mismatch refuses loudly (an older checkpoint would
    mismatch the same way)."""


def _shard_table(save_dir: str, manifest: Dict[str, Any]):
    """Per-leaf shard lists from every worker's index:
    ``name -> [(start, shape, npz, key, crc32), ...]`` plus the open npz
    handles (lazy per-key loads; the caller closes them). Unreadable
    shard files and missing/torn indexes raise
    :class:`ShardCorruptionError`."""
    root = ckpt_mod.elastic_root(save_dir)
    d = os.path.join(root, manifest["dir"])
    table: Dict[str, List[Tuple]] = {}
    handles = []
    try:
        for i in range(int(manifest["process_count"])):
            ipath = os.path.join(d, ckpt_mod.index_name(i))
            if not os.path.exists(ipath):
                raise ShardCorruptionError(
                    f"committed manifest step {manifest['step']} is "
                    f"missing worker {i}'s shard index ({ipath}) — torn "
                    f"tree or hand-pruned steps/ directory")
            try:
                with open(ipath) as f:
                    idx = json.load(f)
            except (OSError, ValueError) as e:
                raise ShardCorruptionError(
                    f"worker {i}'s shard index {ipath} is unreadable "
                    f"({e!r})")
            spath = os.path.join(d, ckpt_mod.shards_name(i))
            try:
                npz = np.load(spath)
            except Exception as e:
                # a truncated npz is a broken zip: np.load raises
                # anything from BadZipFile to OSError
                raise ShardCorruptionError(
                    f"worker {i}'s shard file {spath} is unreadable "
                    f"({e!r}) — corrupt or truncated")
            handles.append(npz)
            for name, rec in idx["leaves"].items():
                rows = table.setdefault(name, [])
                for sh in rec["shards"]:
                    rows.append((tuple(sh["start"]), tuple(sh["shape"]),
                                 npz, sh["key"], sh.get("crc32")))
    except Exception:
        for h in handles:
            try:
                h.close()
            except Exception:
                pass
        raise
    return table, handles


def _shard_data(npz, key: str, crc: Optional[int]) -> np.ndarray:
    """One shard's bytes off disk, verified against the crc32 the writer
    recorded: a bit flip or a short read is a detected
    :class:`ShardCorruptionError`, never silently wrong weights."""
    try:
        arr = np.asarray(npz[key])
    except Exception as e:
        raise ShardCorruptionError(
            f"shard {key} is unreadable ({e!r}) — corrupt or truncated "
            f"shard file")
    if crc is not None and ckpt_mod.crc32(arr) != int(crc):
        raise ShardCorruptionError(
            f"shard {key} failed its crc32 check — the bytes on disk "
            f"are not the bytes the checkpoint wrote")
    return arr


def _assemble(region: Tuple[Tuple[int, int], ...], shards) -> np.ndarray:
    """Fill one requested region of a leaf from the saved shards that
    intersect it (the per-leaf slice-assembly reshard). An exact-match
    shard returns as read; anything else is gathered piecewise with
    full-coverage checking (a hole means the manifest does not tile the
    leaf: refuse rather than resume from garbage). The arrays stay in
    the npz's storage type (``|V2`` for bfloat16 words)."""
    shape = tuple(stop - start for start, stop in region)
    for start, sshape, npz, key, crc in shards:
        if tuple((s, s + d) for s, d in zip(start, sshape)) == region:
            return _shard_data(npz, key, crc)
    out = None
    filled = 0
    for start, sshape, npz, key, crc in shards:
        lo = [max(s, r0) for s, (r0, _) in zip(start, region)]
        hi = [min(s + d, r1) for s, d, (_, r1)
              in zip(start, sshape, region)]
        if any(l >= h for l, h in zip(lo, hi)):
            continue
        data = _shard_data(npz, key, crc)
        if out is None:
            out = np.zeros(shape, dtype=data.dtype)
        out[tuple(slice(l - r0, h - r0)
                  for l, h, (r0, _) in zip(lo, hi, region))] = data[
            tuple(slice(l - s, h - s) for l, h, s in zip(lo, hi, start))]
        filled += int(np.prod([h - l for l, h in zip(lo, hi)],
                              dtype=np.int64))
    size = int(np.prod(shape, dtype=np.int64))
    if filled != size:
        raise ResumeError(
            f"saved shards cover {filled} of {size} elements of region "
            f"{region} — manifest does not tile the leaf (overlap or "
            f"hole); refusing to resume from a torn layout")
    return out


def validate_run_meta(manifest: Dict[str, Any],
                      expect: Optional[Dict[str, Any]]) -> None:
    """The data-cursor check: resuming with a different seed or global
    batch size replays a DIFFERENT epoch permutation, so refuse loudly.
    Only keys present in both are compared."""
    saved = manifest.get("run") or {}
    if not expect:
        return
    bad = {k: (saved[k], v) for k, v in expect.items()
           if k in saved and saved[k] != v}
    if bad:
        raise ResumeError(
            "manifest data cursor disagrees with this run's config: "
            + ", ".join(f"{k}: saved {s!r} vs current {c!r}"
                        for k, (s, c) in bad.items())
            + " — the epoch permutation would not replay; pass a "
              "matching --seed/--train-batch-size or start fresh")


def restore(save_dir: str, template: Any, *,
            run_meta: Optional[Dict[str, Any]] = None,
            details: Optional[Dict[str, Any]] = None
            ) -> Optional[Tuple[Any, int, int]]:
    """Restore the newest RESTORABLE committed manifest into ``template``
    (a ``TrainState``, whose leaves pin names, shapes, dtypes and the
    device) as ``(state, epoch, step_in_epoch)``, or None when no
    manifest was ever committed.

    A checkpoint whose bytes are bad (:class:`ShardCorruptionError`) is
    skipped and the previous committed manifest restores instead; a
    ``details`` dict then gets ``fallback_from`` (the corrupt step) and
    ``corrupt_shard`` (what failed). Structural failures raise at once.
    Every committed manifest corrupt: the newest one's error propagates.
    ``template`` is written only once a manifest restored whole."""
    manifests = ckpt_mod.committed_manifests(save_dir)
    if not manifests:
        return None
    first_corrupt: Optional[Tuple[int, Exception]] = None
    for man in manifests:
        validate_run_meta(man, run_meta)
        try:
            out = _restore_manifest(save_dir, man, template)
        except ShardCorruptionError as e:
            print(f"tpudist: elastic restore: committed step "
                  f"{man['step']} is corrupt ({e}); falling back to "
                  f"the previous committed manifest",
                  file=sys.stderr, flush=True)
            if first_corrupt is None:
                first_corrupt = (int(man["step"]), e)
            continue
        if first_corrupt is not None and details is not None:
            details["fallback_from"] = first_corrupt[0]
            details["corrupt_shard"] = str(first_corrupt[1])
        return out
    raise first_corrupt[1]


def _restore_manifest(save_dir: str, manifest: Dict[str, Any],
                      template: Any) -> Tuple[Any, int, int]:
    """One manifest's restore proper: every leaf read and checked first,
    then written into ``template`` on its device."""
    table, handles = _shard_table(save_dir, manifest)
    try:
        values = []
        for (name, leaf), (shape, span, _) in zip(
                ckpt_mod.state_leaves(template),
                ckpt_mod.leaf_regions(template)):
            saved_meta = (manifest.get("leaves") or {}).get(name)
            shards = table.get(name)
            if not shards:
                raise ResumeError(
                    f"manifest has no shards for leaf {name} — the "
                    f"model/optimizer structure changed since the "
                    f"checkpoint was written")
            shape = tuple(shape)
            dtype = ckpt_mod.dtype_name(leaf.dtype)
            if saved_meta is not None:
                if tuple(saved_meta["shape"]) != shape:
                    raise ResumeError(
                        f"leaf {name}: saved shape "
                        f"{tuple(saved_meta['shape'])} != current "
                        f"{shape} — a reshard can change the LAYOUT, "
                        f"never the global shape")
                if saved_meta["dtype"] != dtype:
                    raise ResumeError(
                        f"leaf {name}: saved dtype {saved_meta['dtype']}"
                        f" != current {dtype}")
            # this process's region of the leaf (all of it when the
            # template is replicated), from whichever saved spans cover
            # it: the N -> M reshard
            arr = _assemble(tuple(tuple(r) for r in span), shards)
            values.append(ckpt_mod.from_words(arr, leaf.dtype))
    finally:
        for h in handles:
            try:
                h.close()
            except Exception:
                pass
    step, *rest = values
    params = list(template.params.parameters())
    opt = template.opt_state
    n = len(params)
    count, mu, nu = rest[n], rest[n + 1:2 * n + 1], rest[2 * n + 1:]
    with torch.no_grad():
        for dst, src in zip(params + opt.mu + opt.nu,
                            rest[:n] + mu + nu):
            dst.copy_(src)
    opt.count = int(count)
    template.step = int(step)
    return template, int(manifest["epoch"]), int(manifest["step_in_epoch"])


def restore_for_resume(save_dir: str, template: Any, *,
                       run_meta: Optional[Dict[str, Any]] = None,
                       details: Optional[Dict[str, Any]] = None
                       ) -> Optional[Tuple[Any, int, int, str]]:
    """The train loop's one resume entry. The elastic tree and the
    ``orbax`` step directories can coexist in one ``--save-dir``, so the
    pick is NEWEST-WINS by global step. A manifest that exists but cannot
    restore falls back to the step directories when they hold anything;
    only without a fallback does the manifest's error propagate. Returns
    ``(state, epoch, step_in_epoch, source)``, source ``"manifest"`` or
    ``"orbax"``, or None for a fresh start."""
    from tpudist_torch import checkpoint as ckpt_lib

    manifest = ckpt_mod.latest_manifest(save_dir)
    orbax_step = ckpt_lib.latest_step(save_dir)
    manifest_err: Optional[Exception] = None
    if manifest is not None and (orbax_step is None
                                 or int(manifest["step"]) >= orbax_step):
        try:
            out = restore(save_dir, template, run_meta=run_meta,
                          details=details)
            if out is not None:
                return (*out, "manifest")
        except Exception as e:
            if orbax_step is None:
                raise
            manifest_err = e
            print(f"tpudist: elastic manifest restore failed ({e!r}); "
                  f"falling back to the orbax checkpoint at step "
                  f"{orbax_step}", file=sys.stderr, flush=True)
    full = ckpt_lib.restore_latest_full(save_dir, template)
    if full is not None:
        return (*full, "orbax")
    if manifest is not None and manifest_err is None:
        # the manifest is older than a step directory that then failed
        # to restore (or vanished between peek and read): still usable
        out = restore(save_dir, template, run_meta=run_meta,
                      details=details)
        if out is not None:
            return (*out, "manifest")
    return None
