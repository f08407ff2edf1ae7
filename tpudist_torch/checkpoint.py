"""Checkpoint and resume of the train state.

Counterpart of ``tpudist/checkpoint.py``'s layout and resume semantics,
not of its orbax format: one directory per save under ``save_dir``, named
by the GLOBAL STEP as the JAX package's ``Checkpointer`` names them (so an
epoch-end save sits beside any ``--ckpt-every-steps`` mid-epoch save),
holding ``state.pt`` (``torch.save`` of the params, the optimizer state
and the step) with the RESUME POSITION ``(epoch, step_in_epoch)``: the
epoch and batch index training continues from, ``(finished + 1, 0)``
after an epoch. The newest ``KEEP`` saves are kept, as the JAX package's
checkpoint manager keeps them. Writes are synchronous and atomic (a
temporary directory renamed into place), so a killed run never leaves a
half-written newest checkpoint. Under data parallelism the state is
replicated, so rank 0 alone writes, and every rank waits at a barrier
until the save is on disk; every rank restores, onto its own device.
"""

from __future__ import annotations

import os
import shutil
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


class Checkpointer:
    """Step-keyed saves for the train loop. ``last_enqueue_ms`` is the
    time of the last save (the whole write and the barrier after it:
    saves are synchronous)."""

    def __init__(self, save_dir: str):
        self.save_dir = os.path.abspath(os.path.expanduser(save_dir))
        self.last_enqueue_ms = 0.0

    def save(self, state, *, epoch: int, step_in_epoch: int = 0) -> None:
        """Save ``state`` (a ``TrainState``) keyed by its global step, with
        the resume position ``(epoch, step_in_epoch)``: rank 0 writes, and
        no rank returns before the write is done."""
        t0 = time.perf_counter()
        # the JAX package's span name: here the whole synchronous write
        with trace_lib.span("ckpt_enqueue", cat="ckpt",
                            step=int(state.step)):
            try:
                if _rank() == 0:
                    self._write(state, epoch, step_in_epoch)
            finally:
                # reached on a failed write too, so the ranks' host
                # collectives stay paired
                distributed.barrier()
        self.last_enqueue_ms = (time.perf_counter() - t0) * 1000

    def _write(self, state, epoch: int, step_in_epoch: int) -> None:
        final = os.path.join(self.save_dir, str(int(state.step)))
        tmp = f"{final}.tmp.{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        opt = state.opt_state
        torch.save({"step": int(state.step), "epoch": int(epoch),
                    "step_in_epoch": int(step_in_epoch),
                    "params": state.params.state_dict(),
                    "opt_count": int(opt.count), "mu": opt.mu,
                    "nu": opt.nu}, os.path.join(tmp, STATE_FILE))
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in _steps(self.save_dir)[:-KEEP]:
            shutil.rmtree(os.path.join(self.save_dir, str(old)))


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
