"""Sharded manifest checkpoints: each worker writes only its own shards.

A port of ``tpudist/elastic/ckpt.py`` (``--ckpt-mode sharded``), with its
layout and its manifest and index documents key for key:

  * **Per-worker shard files.** Worker ``i`` writes the shards it OWNS
    into ``steps/<step>/worker<i>.npz`` plus a shard index
    (``worker<i>.json``: per leaf its global shape, dtype, and each
    shard's start, shape and the crc32 of its raw bytes). Ownership
    follows the JAX package's ``owned_shard_spans``: a shard held by
    several processes is written once, by the lowest-ranked owner. A
    replicated train state is one full-span shard a leaf, which rank 0
    writes, the other ranks' indexes listing the leaves with no shards;
    under FSDP (``engine.ShardLayout``) each fsdp shard of a param, and
    of its ``mu`` and ``nu``, is written by the lowest rank holding it,
    with its span. :mod:`tpudist_torch.elastic.resume` assembles any
    region from the spans, so a save restores onto another layout.
  * **Atomic two-phase commit.** The index json is written last
    (write-temp + ``os.replace``), so its presence marks "this worker's
    shards landed". The coordinator commits ``manifest.json`` (also
    temp + rename, after a per-step copy) only once EVERY worker's index
    of this attempt has landed: a filesystem rendezvous, not a
    collective, so a worker dying mid-save never wedges the others; the
    commit just never happens and the previous manifest stays
    authoritative.
  * **Transparent layout.** npz + json on a filesystem every process
    shares; a killed run's leftovers are reaped on the next open
    (:func:`cleanup_stale`).

The leaves are the port's own, in a stable order (:func:`state_leaves`):
``step``, each ``params.<name>`` of the module's ``named_parameters``,
``opt.count``, and each ``opt.mu.<name>`` and ``opt.nu.<name>``. numpy
has no bfloat16 on a machine without ``ml_dtypes``, so a bf16 leaf (the
bf16 second moment) is stored as its raw 16-bit words, typed ``|V2`` in
the npz as the JAX writer's bf16 leaves are, with ``"dtype":
"bfloat16"`` in the index; its crc32 covers exactly the bytes the JAX
writer would hash, and the restore maps the words back with
``Tensor.view(torch.bfloat16)``, bit for bit.

:class:`ShardedCheckpointer` has the train loop's checkpointer surface
(``save(state, epoch=, step_in_epoch=)`` / ``wait`` / ``close`` /
``last_enqueue_ms`` / ``drain_ms``). ``save`` returns after the copy to
host memory; the crc32s, the file writes and the commit run on a writer
thread unless ``use_async=False``.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import sys
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from tpudist_torch.obs import trace as trace_lib

MANIFEST_SCHEMA_VERSION = 1
DEFAULT_KEEP = 3
# How long the coordinator's commit waits for every worker's shard index
# to land before giving up (the previous manifest then stays committed).
COMMIT_TIMEOUT_S = 300.0
# Transient filesystem errors retry with backoff; exhaustion costs that
# step's commit, never a wedged writer or a dead training run. Env
# overrides TPUDIST_CKPT_RETRIES / TPUDIST_CKPT_RETRY_BACKOFF_S.
WRITE_RETRIES = 3
WRITE_RETRY_BACKOFF_S = 0.05

# ---------------------------------------------------- chaos fault hook
# The chaos plane (tpudist_torch.chaos) injects write-path faults through
# this hook, called at named points of ShardedCheckpointer._write with
# the save's step context: it may raise OSError (a transient fs error the
# retry loop absorbs), damage the just-landed file (restore's crc check
# must catch it), or os._exit (the torn-manifest kill between the index
# landing and the commit).
_FAULT_HOOK: Optional[Callable[..., None]] = None


def set_fault_hook(hook: Optional[Callable[..., None]]) -> None:
    global _FAULT_HOOK
    _FAULT_HOOK = hook


def _fault(point: str, **ctx: Any) -> None:
    if _FAULT_HOOK is not None:
        _FAULT_HOOK(point, **ctx)


def elastic_root(save_dir: str) -> str:
    """The sharded-manifest tree lives under ``<save_dir>/elastic``, beside
    the ``orbax`` step directories of the same ``--save-dir``."""
    return os.path.join(save_dir, "elastic")


def _steps_dir(root: str) -> str:
    return os.path.join(root, "steps")


def step_dir(root: str, step: int) -> str:
    return os.path.join(_steps_dir(root), f"{step:08d}")


def manifest_path(save_dir: str) -> str:
    return os.path.join(elastic_root(save_dir), "manifest.json")


def index_name(process_index: int) -> str:
    return f"worker{process_index}.json"


def shards_name(process_index: int) -> str:
    return f"worker{process_index}.npz"


def _atomic_json(path: str, payload: Dict[str, Any]) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1)
    os.replace(tmp, path)


def latest_manifest(save_dir: str) -> Optional[Dict[str, Any]]:
    """The committed manifest, or None when ``save_dir`` has none. A
    ``manifest.json.tmp`` torn off by a kill mid-commit is ignored."""
    path = manifest_path(save_dir)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def committed_manifests(save_dir: str) -> List[Dict[str, Any]]:
    """Every committed manifest still on disk, NEWEST FIRST: the
    top-level ``manifest.json`` plus the per-step copies each commit
    leaves in its step directory, which a restore falls back onto when a
    newer checkpoint's shards fail their crc check. Steps newer than the
    top-level manifest are not committed and are skipped."""
    latest = latest_manifest(save_dir)
    if latest is None:
        return []
    out = [latest]
    seen = {int(latest["step"])}
    sdir = _steps_dir(elastic_root(save_dir))
    if not os.path.isdir(sdir):
        return out
    for name in sorted(os.listdir(sdir), reverse=True):
        if not name.isdigit():
            continue
        step = int(name)
        if step in seen or step > int(latest["step"]):
            continue
        p = os.path.join(sdir, name, "manifest.json")
        if not os.path.exists(p):
            continue          # retained but never committed
        try:
            with open(p) as f:
                man = json.load(f)
        except (OSError, ValueError):
            continue          # a torn copy is not a fallback
        if int(man.get("step", -1)) != step:
            continue
        out.append(man)
        seen.add(step)
    return out


def state_leaves(state: Any) -> List[Tuple[str, torch.Tensor]]:
    """``(name, tensor)`` pairs of a ``TrainState`` in a stable order, the
    names the writer and the restorer key on. ``step`` and ``opt.count``
    are 0-dim int64 tensors made from the host counters."""
    names, params = zip(*state.params.named_parameters())
    opt = state.opt_state
    return ([("step", torch.tensor(int(state.step), dtype=torch.int64))]
            + [(f"params.{n}", p) for n, p in zip(names, params)]
            + [("opt.count", torch.tensor(int(opt.count),
                                          dtype=torch.int64))]
            + [(f"opt.mu.{n}", t) for n, t in zip(names, opt.mu)]
            + [(f"opt.nu.{n}", t) for n, t in zip(names, opt.nu)])


def leaf_regions(state: Any) -> List[Tuple[Tuple[int, ...], tuple, int]]:
    """Each leaf of :func:`state_leaves` as ``(whole shape, span,
    owner)``: its global shape, this process's region of it and the rank
    that writes that region (``engine.param_regions`` for the params and
    moments; the 0-dim counters are rank 0's)."""
    from tpudist_torch.engine import param_regions
    counter = ((), (), 0)
    regions = param_regions(state)
    return [counter] + regions + [counter] + regions + regions


def dtype_name(dtype: torch.dtype) -> str:
    """The index's dtype word: numpy's name (``float32``, ``bfloat16``)."""
    return str(dtype).replace("torch.", "")


def to_words(host: torch.Tensor) -> np.ndarray:
    """A host tensor as the numpy array the npz stores: the same bytes;
    a bfloat16 tensor's 16-bit words typed ``|V2``."""
    if host.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy().view(np.dtype("V2"))
    return host.numpy()


def from_words(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """:func:`to_words` inverted, bit for bit."""
    arr = np.ascontiguousarray(arr)
    if dtype == torch.bfloat16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def crc32(arr: np.ndarray) -> int:
    """crc32 of an array's raw bytes, as the JAX writer records it
    (``zlib.crc32(data.tobytes())``), without the copy."""
    flat = np.ascontiguousarray(arr).reshape(-1)
    return zlib.crc32(flat.view(np.uint8)) & 0xFFFFFFFF


def owned_shard_spans(leaf: torch.Tensor, process_index: int,
                      span: Optional[tuple] = None, owner: int = 0):
    """The shards of ``leaf`` (this process's tensor of it) that process
    ``process_index`` writes, as ``[(span, host array), ...]`` (span:
    per-dim ``(start, stop)`` in the whole leaf, the full leaf by
    default): the JAX package's ``owned_shard_spans``, where a region
    held by several processes is written by its lowest-ranked holder,
    ``owner``."""
    if process_index != owner:
        return []
    from tpudist_torch.checkpoint import host_copy
    if span is None:
        span = tuple((0, d) for d in leaf.shape)
    return [(tuple(span), to_words(host_copy(leaf)))]


def cleanup_stale(save_dir: str, *, process_index: int = 0) -> List[str]:
    """Reap a killed run's leftovers: ``*.tmp`` files anywhere in the
    elastic tree, and (coordinator only) step directories NEWER than the
    committed manifest, whose commit never happened. Returns the removed
    paths."""
    root = elastic_root(save_dir)
    removed: List[str] = []
    if not os.path.isdir(root):
        return removed
    for dirpath, _, files in os.walk(root):
        for fn in files:
            if fn.endswith(".tmp"):
                p = os.path.join(dirpath, fn)
                try:
                    os.remove(p)
                    removed.append(p)
                except OSError:
                    pass
    if process_index != 0:
        return removed
    manifest = latest_manifest(save_dir)
    committed = -1 if manifest is None else int(manifest["step"])
    sdir = _steps_dir(root)
    if os.path.isdir(sdir):
        for name in sorted(os.listdir(sdir)):
            try:
                step = int(name)
            except ValueError:
                continue
            if step > committed:
                p = os.path.join(sdir, name)
                shutil.rmtree(p, ignore_errors=True)
                removed.append(p)
    return removed


class ShardedCheckpointer:
    """Per-worker sharded checkpoint writer with coordinator commit.

    Every process constructs one and calls ``save`` at the same train
    boundaries. ``run_meta`` is stored verbatim in the manifest: the
    train loop passes its data cursor (seed, global batch size), so a
    resume can refuse a checkpoint whose batch order the current config
    would not replay, and its ``requeue_attempt`` stamps the indexes.
    """

    def __init__(self, save_dir: str, *, process_index: int = 0,
                 process_count: int = 1, keep: Optional[int] = DEFAULT_KEEP,
                 use_async: bool = True,
                 run_meta: Optional[Dict[str, Any]] = None,
                 commit_timeout_s: Optional[float] = None):
        self.root = elastic_root(save_dir)
        self.save_dir = save_dir
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.keep = keep
        self.use_async = use_async
        self.run_meta = dict(run_meta or {})
        # the commit rendezvous' freshness key: a fallback resume
        # re-reaches steps whose directory still holds the dead attempt's
        # indexes, so indexes stamp the attempt that wrote them and the
        # rendezvous counts only this attempt's
        att = self.run_meta.get("requeue_attempt")
        self._attempt = int(att) if isinstance(att, (int, float)) else None
        if commit_timeout_s is None:
            try:
                commit_timeout_s = float(os.environ.get(
                    "TPUDIST_CKPT_COMMIT_TIMEOUT_S", COMMIT_TIMEOUT_S))
            except ValueError:
                commit_timeout_s = COMMIT_TIMEOUT_S
        self.commit_timeout_s = commit_timeout_s
        try:
            self.write_retries_max = int(os.environ.get(
                "TPUDIST_CKPT_RETRIES", WRITE_RETRIES))
        except ValueError:
            self.write_retries_max = WRITE_RETRIES
        try:
            self.write_retry_backoff_s = float(os.environ.get(
                "TPUDIST_CKPT_RETRY_BACKOFF_S", WRITE_RETRY_BACKOFF_S))
        except ValueError:
            self.write_retry_backoff_s = WRITE_RETRY_BACKOFF_S
        self.last_enqueue_ms: float = 0.0
        self.last_drain_ms: float = 0.0
        self.drain_ms: float = 0.0
        self.saves: int = 0
        self.commits: int = 0           # manifests this process committed
        self.commit_failures: int = 0   # commit waits that timed out
        self.write_errors: int = 0
        self.write_retries: int = 0     # transient fs errors retried away
        self.write_skips: int = 0       # saves abandoned after exhaustion
        self.bytes_written: int = 0     # shard bytes of this process
        self.write_s: float = 0.0       # crc + npz + index seconds
        # steps whose shard write was abandoned: their commit is skipped
        # outright instead of waiting out the timeout
        self._skip_commit_steps: set = set()
        # reap the dead run's tmp files / uncommitted step dirs BEFORE
        # the first save can collide with a half-written leftover
        cleanup_stale(save_dir, process_index=self.process_index)
        self._q: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        if use_async:
            self._thread = threading.Thread(
                target=self._worker, name="tpudist-elastic-ckpt",
                daemon=True)
            self._thread.start()

    @property
    def last_save_ms(self) -> float:
        return self.last_enqueue_ms

    # ------------------------------------------------------------ save
    def save(self, state: Any, *, epoch: int, step_in_epoch: int = 0
             ) -> None:
        """Copy this worker's shards of ``state`` to host memory and hand
        the write (and, on the coordinator, the commit) to the writer
        thread; with ``use_async=False`` do both here."""
        t0 = time.perf_counter()
        step = int(state.step)
        with trace_lib.span("ckpt_enqueue", cat="ckpt", step=step,
                            mode="sharded"):
            leaves = [(name, list(shape), dtype_name(leaf.dtype),
                       owned_shard_spans(leaf, self.process_index, span,
                                         owner))
                      for (name, leaf), (shape, span, owner)
                      in zip(state_leaves(state), leaf_regions(state))]
            job = (step, int(epoch), int(step_in_epoch), leaves)
            if self.use_async:
                self._q.put(("write", job))
                if self.process_index == 0:
                    self._q.put(("commit", job[:3]))
            else:
                # sync mode shares the retry/skip discipline: a
                # transient fs error exhausting its retries skips this
                # step's commit instead of killing the training run
                if self._write_retrying(*job) and self.process_index == 0:
                    self._commit(step, int(epoch), int(step_in_epoch))
        self.last_enqueue_ms = (time.perf_counter() - t0) * 1000
        self.saves += 1

    # -------------------------------------------------- writer thread
    def _worker(self) -> None:
        while True:
            kind, payload = self._q.get()
            try:
                if kind == "stop":
                    return
                elif kind == "write":
                    self._write_retrying(*payload)
                elif kind == "commit":
                    self._commit(*payload)
            except Exception as e:
                # a failed background save must not kill training; the
                # previous manifest stays committed and the error is in
                # the run log and the write_errors counter
                self.write_errors += 1
                print(f"tpudist: sharded ckpt {kind} failed: {e!r}",
                      file=sys.stderr, flush=True)
            finally:
                self._q.task_done()

    def _write_retrying(self, step: int, epoch: int, step_in_epoch: int,
                        leaves) -> bool:
        """Bounded retry with backoff around the shard write: transient
        filesystem errors retry; exhaustion skips THIS step's commit."""
        delay = self.write_retry_backoff_s
        for attempt in range(self.write_retries_max + 1):
            try:
                self._write(step, epoch, step_in_epoch, leaves)
                return True
            except OSError as e:
                if attempt >= self.write_retries_max:
                    self.write_errors += 1
                    self.write_skips += 1
                    self._skip_commit_steps.add(step)
                    print(f"tpudist: sharded ckpt write of step {step} "
                          f"failed {attempt + 1}x ({e!r}); skipping this "
                          f"step's commit — the previous manifest stays "
                          f"committed", file=sys.stderr, flush=True)
                    return False
                self.write_retries += 1
                time.sleep(delay)
                delay *= 2
        return False

    def _write(self, step: int, epoch: int, step_in_epoch: int,
               leaves) -> None:
        t0 = time.perf_counter()
        d = step_dir(self.root, step)
        os.makedirs(d, exist_ok=True)
        npz = os.path.join(d, shards_name(self.process_index))
        _fault("shard_write", step=step, epoch=epoch,
               step_in_epoch=step_in_epoch, path=npz)
        index: Dict[str, Any] = {}
        arrays: Dict[str, np.ndarray] = {}
        for li, (name, shape, dtype, spans) in enumerate(leaves):
            shards = []
            for si, (span, data) in enumerate(spans):
                key = f"L{li}_S{si}"
                arrays[key] = data
                # the crc32 of the shard's bytes, taken from the host
                # copy BEFORE any file I/O: restore verifies it against
                # what the filesystem hands back
                shards.append({"key": key, "start": [s for s, _ in span],
                               "shape": list(data.shape),
                               "crc32": crc32(data)})
            index[name] = {"shape": shape, "dtype": dtype,
                           "shards": shards}
        tmp = f"{npz}.tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, npz)
        _fault("shard_written", step=step, epoch=epoch,
               step_in_epoch=step_in_epoch, path=npz)
        # the index lands LAST: its presence is this worker's "shards
        # landed" marker, the commit's filesystem rendezvous
        ipath = os.path.join(d, index_name(self.process_index))
        _atomic_json(ipath, {
            "schema": MANIFEST_SCHEMA_VERSION, "step": step,
            "epoch": epoch, "step_in_epoch": step_in_epoch,
            "process_index": self.process_index,
            "requeue_attempt": self._attempt, "leaves": index})
        self.bytes_written += sum(a.nbytes for a in arrays.values())
        self.write_s += time.perf_counter() - t0
        _fault("index_written", step=step, epoch=epoch,
               step_in_epoch=step_in_epoch, path=ipath)

    # --------------------------------------------------------- commit
    def _worker_landed(self, step: int, i: int) -> bool:
        p = os.path.join(step_dir(self.root, step), index_name(i))
        if not os.path.exists(p):
            return False
        try:
            with open(p) as f:
                idx = json.load(f)
        except (ValueError, OSError):
            return False
        if int(idx.get("step", -1)) != step:
            return False
        # freshness: a previous attempt's leftover index must not
        # satisfy THIS attempt's rendezvous
        stamped = idx.get("requeue_attempt")
        if self._attempt is not None and stamped is not None \
                and int(stamped) != self._attempt:
            return False
        return True

    def _landed(self, step: int, verified: Optional[set] = None) -> bool:
        """All workers' shard indexes landed for ``step``; ``verified``
        carries the workers already validated across polls."""
        if verified is None:
            verified = set()
        for i in range(self.process_count):
            if i in verified:
                continue
            if not self._worker_landed(step, i):
                return False
            verified.add(i)
        return True

    def _commit(self, step: int, epoch: int, step_in_epoch: int) -> None:
        """Coordinator only: wait (bounded) for every worker's shard
        index, then write the per-step manifest copy and flip
        ``manifest.json`` to this step, and apply retention. On timeout
        the previous manifest stays authoritative."""
        if step in self._skip_commit_steps:
            return
        deadline = time.monotonic() + self.commit_timeout_s
        verified: set = set()
        while not self._landed(step, verified):
            if time.monotonic() >= deadline:
                self.commit_failures += 1
                print(f"tpudist: sharded ckpt commit of step {step} timed "
                      f"out after {self.commit_timeout_s}s waiting for "
                      f"worker shards; previous manifest stays committed",
                      file=sys.stderr, flush=True)
                return
            time.sleep(min(0.05, self.commit_timeout_s / 10 or 0.05))
        with open(os.path.join(step_dir(self.root, step),
                               index_name(0))) as f:
            leaves = {name: {"shape": rec["shape"], "dtype": rec["dtype"]}
                      for name, rec in json.load(f)["leaves"].items()}
        payload = {
            "schema": MANIFEST_SCHEMA_VERSION,
            "step": step, "epoch": epoch, "step_in_epoch": step_in_epoch,
            "process_count": self.process_count,
            "ts": time.time(), "run": self.run_meta, "leaves": leaves,
            "dir": os.path.relpath(step_dir(self.root, step), self.root)}
        _atomic_json(os.path.join(step_dir(self.root, step),
                                  "manifest.json"), payload)
        _atomic_json(manifest_path(self.save_dir), payload)
        self.commits += 1
        self._retain(step)

    def _retain(self, committed: int) -> None:
        if self.keep is None:
            return
        sdir = _steps_dir(self.root)
        if not os.path.isdir(sdir):
            return
        steps = sorted(int(n) for n in os.listdir(sdir) if n.isdigit())
        old = [s for s in steps if s <= committed]
        for s in old[:-max(self.keep, 1)]:
            shutil.rmtree(os.path.join(sdir, f"{s:08d}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- drain
    def wait(self) -> None:
        t0 = time.perf_counter()
        with trace_lib.span("ckpt_drain", cat="ckpt", mode="sharded"):
            if self.use_async:
                self._q.join()
        self.last_drain_ms = (time.perf_counter() - t0) * 1000
        self.drain_ms += self.last_drain_ms

    def close(self, barrier: bool = True) -> None:
        """Drain and stop the writer. ``barrier`` is the orbax
        checkpointer's: the sharded commit is a filesystem rendezvous and
        takes no collective."""
        t0 = time.perf_counter()
        with trace_lib.span("ckpt_drain", cat="ckpt", close=True,
                            mode="sharded"):
            if self.use_async and self._thread is not None:
                self._q.join()
                self._q.put(("stop", None))
                self._thread.join(timeout=10.0)
                self._thread = None
        self.last_drain_ms = (time.perf_counter() - t0) * 1000
        self.drain_ms += self.last_drain_ms
