"""Checkpoint and resume of the train state: the ``orbax`` layout.

``--ckpt-mode orbax`` keeps the JAX package's word for its default
layout, but the format is the port's own: the JAX package writes orbax
step directories, the port ``torch.save`` files. What is kept is the
layout and the resume semantics of ``tpudist/checkpoint.py``: one
directory per save under ``save_dir``, named by the GLOBAL STEP as the
JAX package's ``Checkpointer`` names them (so an epoch-end save sits
beside any ``--ckpt-every-steps`` mid-epoch save), holding ``state.pt``
(the params, the optimizer state and the step) with the RESUME POSITION
``(epoch, step_in_epoch)``: the epoch and batch index training continues
from, ``(finished + 1, 0)`` after an epoch. The newest ``KEEP`` saves are
kept. Each write is atomic (a temporary directory renamed into place), so
a killed run never leaves a half-written newest checkpoint.

Saves are asynchronous by default, as the JAX manager's are: ``save``
copies the state to host memory and returns; a writer thread does the
write. ``wait`` and ``close`` drain it (their blocked time is
``drain_ms``) and raise a write that failed, as the JAX manager does;
``use_async=False`` (``--ckpt-sync``) writes inside ``save``. Under data
parallelism the state is replicated, so rank 0 alone writes, and the
ranks meet at a barrier where the JAX manager waits: at ``wait`` and
``close``, and before the next save, by which point rank 0 has drained
the previous one. Every rank restores, onto its own device.
"""

from __future__ import annotations

import os
import queue
import shutil
import sys
import threading
import time
from typing import Optional, Tuple

import torch

from tpudist_torch.metrics import _rank
from tpudist_torch.obs import trace as trace_lib
from tpudist_torch.parallel import distributed

KEEP = 3
STATE_FILE = "state.pt"


def _steps(save_dir: str):
    if not os.path.isdir(save_dir):
        return []
    return sorted(int(n) for n in os.listdir(save_dir)
                  if n.isdigit() and os.path.isfile(
                      os.path.join(save_dir, n, STATE_FILE)))


def host_copy(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied to host memory: a snapshot the next step's in-place
    updates cannot reach (a CPU tensor is cloned)."""
    t = t.detach()
    return t.clone() if t.device.type == "cpu" else t.to("cpu")


class Checkpointer:
    """Step-keyed saves for the train loop. ``last_enqueue_ms`` is the
    time ``save`` held the caller (the host snapshot and the hand-off, or
    the whole write under ``use_async=False``); ``drain_ms`` sums the
    time blocked on the writer at ``wait``, ``close`` and before a save
    whose predecessor was still being written."""

    def __init__(self, save_dir: str, *, use_async: bool = True):
        self.save_dir = os.path.abspath(os.path.expanduser(save_dir))
        self.use_async = use_async
        self.last_enqueue_ms = 0.0
        self.last_drain_ms = 0.0
        self.drain_ms = 0.0
        self.saves = 0
        self.write_errors = 0
        self._error: Optional[BaseException] = None
        self._q: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        if use_async and _rank() == 0:
            self._thread = threading.Thread(
                target=self._worker, name="tpudist-ckpt", daemon=True)
            self._thread.start()

    @property
    def last_save_ms(self) -> float:
        return self.last_enqueue_ms

    def save(self, state, *, epoch: int, step_in_epoch: int = 0) -> None:
        """Save ``state`` (a ``TrainState``) keyed by its global step, with
        the resume position ``(epoch, step_in_epoch)``. Every rank calls
        it; rank 0 snapshots and writes."""
        if self.saves:
            # the previous save is on disk before the next one starts
            self._drain(barrier=True)
        t0 = time.perf_counter()
        with trace_lib.span("ckpt_enqueue", cat="ckpt",
                            step=int(state.step)):
            if _rank() == 0:
                opt = state.opt_state
                doc = {"step": int(state.step), "epoch": int(epoch),
                       "step_in_epoch": int(step_in_epoch),
                       "params": {k: host_copy(v) for k, v in
                                  state.params.state_dict().items()},
                       "opt_count": int(opt.count),
                       "mu": [host_copy(t) for t in opt.mu],
                       "nu": [host_copy(t) for t in opt.nu]}
                if self._thread is not None:
                    self._q.put(doc)
                else:
                    self._write(doc)
        self.last_enqueue_ms = (time.perf_counter() - t0) * 1000
        self.saves += 1

    def _worker(self) -> None:
        while True:
            doc = self._q.get()
            try:
                if doc is None:
                    return
                self._write(doc)
            except Exception as e:
                # the previous checkpoint stays the newest; the error is
                # logged now and raised at the next drain
                self.write_errors += 1
                self._error = self._error or e
                print(f"tpudist: ckpt write of step {doc['step']} failed: "
                      f"{e!r}", file=sys.stderr, flush=True)
            finally:
                self._q.task_done()

    def _write(self, doc) -> None:
        final = os.path.join(self.save_dir, str(doc["step"]))
        tmp = f"{final}.tmp.{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        torch.save(doc, os.path.join(tmp, STATE_FILE))
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in _steps(self.save_dir)[:-KEEP]:
            shutil.rmtree(os.path.join(self.save_dir, str(old)))

    def _drain(self, *, barrier: bool, stop: bool = False) -> None:
        t0 = time.perf_counter()
        with trace_lib.span("ckpt_drain", cat="ckpt", close=stop):
            if self._thread is not None:
                self._q.join()
                if stop:
                    self._q.put(None)
                    self._thread.join(timeout=10.0)
                    self._thread = None
            if barrier:
                distributed.barrier()
        self.last_drain_ms = (time.perf_counter() - t0) * 1000
        self.drain_ms += self.last_drain_ms
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"checkpoint write failed: {err!r}") from err

    def wait(self) -> None:
        """Block until every save so far is on disk, on every rank."""
        self._drain(barrier=True)

    def close(self, *, barrier: bool = True) -> None:
        """Drain and stop the writer. ``barrier=False`` skips the ranks'
        barrier (a failing run, whose peers may not reach it)."""
        self._drain(barrier=barrier, stop=True)


def latest_step(save_dir: str) -> Optional[int]:
    """The newest checkpoint's global step in ``save_dir``, or None: a
    peek that restores nothing."""
    steps = _steps(os.path.abspath(os.path.expanduser(save_dir)))
    return steps[-1] if steps else None


def restore_latest_full(save_dir: str, template
                        ) -> Optional[Tuple[object, int, int]]:
    """Restore the newest checkpoint into ``template`` (a ``TrainState``
    of the same model, on this rank's device, which the tensors are
    mapped to) as ``(state, epoch, step_in_epoch)``, or None if
    ``save_dir`` holds none."""
    step = latest_step(save_dir)
    if step is None:
        return None
    device = next(template.params.parameters()).device
    doc = torch.load(os.path.join(os.path.abspath(
        os.path.expanduser(save_dir)), str(step), STATE_FILE),
        map_location=device, weights_only=True)
    template.params.load_state_dict(doc["params"])
    opt = template.opt_state
    with torch.no_grad():
        for dst, src in zip(opt.mu + opt.nu, doc["mu"] + doc["nu"]):
            dst.copy_(src)
    opt.count = doc["opt_count"]
    template.step = doc["step"]
    return template, doc["epoch"], doc["step_in_epoch"]
