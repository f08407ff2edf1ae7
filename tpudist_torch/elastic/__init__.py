"""tpudist_torch.elastic — surviving a preempted run.

Counterpart of ``tpudist/elastic``:

  * :mod:`ckpt` — sharded manifest checkpoints (``--ckpt-mode
    sharded``): each worker writes its own shards and a shard index, and
    the coordinator commits ``manifest.json`` atomically once every
    worker's shards landed, so a kill at any instant leaves the previous
    or the next consistent step, never a torn one;
  * :mod:`resume` — the elastic resume: the newest restorable committed
    manifest (crc-checked, falling back past a corrupt one) or the
    ``orbax`` step directories, whichever is newer, onto this run's
    device;
  * :mod:`policy` — the standard-library requeue-or-stop classifier a
    launcher (and the drills) consults after a failed attempt:
    preemption or stall requeues with exponential backoff, a
    deterministic crash stops.

``policy`` and this ``__init__`` import the standard library only;
``ckpt`` and ``resume`` import torch and numpy, and their callers import
them lazily.
"""

__all__ = ["ckpt", "policy", "resume"]
