"""Deterministic synthetic data and per-epoch batching.

Counterpart of ``tpudist/data.py``. ``make_synthetic_tokens`` is numpy on
both sides and bitwise equal to the JAX package's. ``make_synthetic_data``
and ``epoch_permutation`` draw from a seeded ``torch.Generator`` here,
where the JAX package draws from jax's threefry; the two give different
numbers from one seed, so parity tests set :data:`reference_data` and
:data:`reference_permutation` to hand the JAX package's arrays and
permutation to the port (unset, the port draws its own).

The batching contract is the JAX package's: global ``batch_size``, global
batch ``b`` is ``perm[b * batch_size:(b + 1) * batch_size]``, each process
owns a contiguous ``local_batch`` slice of every global batch, trailing
samples are dropped.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

# (n_samples, n_features, seed) -> (x, y) and (seed, epoch, n) -> perm:
# set by parity tests to the JAX package's functions
reference_data: Optional[Callable[[int, int, int],
                                  Tuple[np.ndarray, np.ndarray]]] = None
reference_permutation: Optional[Callable[[int, int, int],
                                         np.ndarray]] = None


def make_synthetic_data(n_samples: int = 2000, n_features: int = 20,
                        seed: int = 42) -> Tuple[np.ndarray, np.ndarray]:
    """Linearly separable binary task: ``y = 1[sum of first n_features//2
    columns > 0]`` on ``x ~ N(0, 1)``, f32 numpy arrays, deterministic by
    seed (the convergence oracle)."""
    if reference_data is not None:
        x, y = reference_data(n_samples, n_features, seed)
        return np.asarray(x, np.float32), np.asarray(y, np.float32)
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n_samples, n_features, generator=g)
    y = (x[:, : n_features // 2].sum(dim=1) > 0).to(torch.float32)
    return x.numpy(), y.numpy()


def make_synthetic_tokens(n_samples: int, seq_len: int, vocab_size: int,
                          seed: int = 42) -> np.ndarray:
    """Synthetic token stream: token[t+1] = (7 * token[t] + 3) mod vocab
    from a seeded first column, so a causal LM can learn it (int32)."""
    rng = np.random.default_rng(seed)
    first = rng.integers(0, vocab_size, size=(n_samples, 1), dtype=np.int32)
    toks = np.empty((n_samples, seq_len), dtype=np.int32)
    toks[:, :1] = first
    for t in range(1, seq_len):
        toks[:, t] = (toks[:, t - 1] * 7 + 3) % vocab_size
    return toks


def epoch_permutation(seed: int, epoch: int, n: int) -> np.ndarray:
    """Global shuffle for an epoch, a pure function of ``(seed, epoch)``
    and so identical on every process."""
    if reference_permutation is not None:
        return np.asarray(reference_permutation(seed, epoch, n))
    g = torch.Generator().manual_seed(
        ((seed & 0xFFFFFFFF) << 32) | (epoch & 0xFFFFFFFF))
    return torch.randperm(n, generator=g).numpy()


def _epoch_index(n: int, *, batch_size: int, seed: int, epoch: int,
                 process_index: int, process_count: int) -> np.ndarray:
    """(steps, local_batch) gather indices for this process's epoch."""
    if batch_size % process_count:
        raise ValueError(
            f"global batch_size={batch_size} not divisible by "
            f"process_count={process_count}")
    local_bs = batch_size // process_count
    steps = n // batch_size
    if steps == 0:
        raise ValueError(
            f"n_samples={n} < global batch_size={batch_size}: zero steps")
    perm = epoch_permutation(seed, epoch, n)[: steps * batch_size]
    return perm.reshape(steps, process_count, local_bs)[:, process_index, :]


def pad_steps(arrays: Sequence[np.ndarray],
              to_steps: int) -> Tuple[np.ndarray, ...]:
    """Zero-pad ``(steps, batch, ...)`` arrays along the step axis to
    ``to_steps``. The padded steps are masked out of the superstep
    (``engine.make_superstep``'s ``[lo, hi)`` bounds), so the pad value
    never reaches the trajectory; zeros keep every model's forward
    finite (token id 0 is always in the vocabulary)."""
    def pad(a):
        a = np.asarray(a)
        if a.shape[0] >= to_steps:
            return a
        fill = np.zeros((to_steps - a.shape[0],) + a.shape[1:], a.dtype)
        return np.concatenate([a, fill], axis=0)
    return tuple(pad(a) for a in arrays)


class EpochPlan:
    """One epoch's batches, gathered on demand: the permutation (a pure
    function of ``(seed, epoch)``) and the source arrays; ``slab(start,
    stop)`` gathers that step range into host ``(steps, local_batch,
    ...)`` arrays, so the streaming train loop never needs the whole
    epoch at once."""

    def __init__(self, arrays: Sequence[np.ndarray], idx: np.ndarray):
        self.arrays = tuple(np.asarray(a) for a in arrays)
        self.idx = idx

    @property
    def n_steps(self) -> int:
        return self.idx.shape[0]

    @property
    def local_batch(self) -> int:
        return self.idx.shape[1]

    def slab(self, start: int, stop: int,
             pad_to: int = 0) -> Tuple[np.ndarray, ...]:
        """Steps ``[start, stop)`` as ``(steps, local_batch, ...)`` host
        arrays, zero-padded along the step axis to ``pad_to`` when that
        exceeds the true length (:func:`pad_steps`)."""
        sl = self.idx[start:stop]
        out = tuple(a[sl] for a in self.arrays)
        if pad_to > sl.shape[0]:
            out = pad_steps(out, pad_to)
        return out


def microbatch_major(idx: np.ndarray, n_accum: int,
                     process_count: int) -> np.ndarray:
    """``(steps, batch)`` global gather indices -> ``(steps,
    process_count, batch / process_count)``: process ``r``'s rows of a
    step, microbatch by microbatch, are the global rows ``[i M + r m, i
    M + (r + 1) m)`` of each of the ``n_accum`` microbatches (``M = batch
    / n_accum``, ``m = M / process_count``), so its microbatch ``i`` is
    its share of the global microbatch ``i`` the JAX package's
    ``_microbatch`` splits off."""
    steps, batch = idx.shape
    m = batch // (n_accum * process_count)
    return idx.reshape(steps, n_accum, process_count, m).transpose(
        0, 2, 1, 3).reshape(steps, process_count, n_accum * m)


def plan_epoch(arrays, *, batch_size: int, seed: int, epoch: int,
               process_index: int = 0, process_count: int = 1,
               n_accum: int = 1) -> EpochPlan:
    """This process's :class:`EpochPlan` for one epoch; with ``n_accum``
    > 1 microbatches over several processes, its rows microbatch-major
    (:func:`microbatch_major`)."""
    n = int(np.asarray(arrays[0]).shape[0])
    if n_accum > 1 and process_count > 1:
        if batch_size % (n_accum * process_count):
            raise ValueError(
                f"global batch_size={batch_size} not divisible by "
                f"n_accum*process_count={n_accum * process_count}")
        whole = _epoch_index(n, batch_size=batch_size, seed=seed,
                             epoch=epoch, process_index=0, process_count=1)
        idx = microbatch_major(whole, n_accum, process_count)[
            :, process_index]
    else:
        idx = _epoch_index(n, batch_size=batch_size, seed=seed,
                           epoch=epoch, process_index=process_index,
                           process_count=process_count)
    return EpochPlan(arrays, idx)


def to_device(batch, device: torch.device):
    """Host arrays of one step -> device tensors (token ids as int64)."""
    return tuple(torch.tensor(a).to(device, torch.int64 if a.dtype.kind
                                    == "i" else None) for a in batch)


def shard_epoch(x, y, *, batch_size: int, seed: int, epoch: int,
                process_index: int = 0, process_count: int = 1):
    """This process's ``(steps, local_batch, ...)`` batches for one epoch,
    all at once."""
    idx = _epoch_index(x.shape[0], batch_size=batch_size, seed=seed,
                       epoch=epoch, process_index=process_index,
                       process_count=process_count)
    return x[idx], y[idx]
