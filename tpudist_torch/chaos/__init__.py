"""tpudist_torch.chaos — deterministic fault injection, the drill and its
checker.

Counterpart of ``tpudist/chaos``, in four pieces:

  * :mod:`plan`   — a copy of the JAX package's seeded fault schedule
    (the whole ``--chaos`` / ``TPUDIST_CHAOS`` grammar);
  * :mod:`inject` — :class:`~tpudist_torch.chaos.inject.ChaosRuntime`:
    the train loop's step surface (kill, hang, slow, telemetry garbage),
    the sharded checkpoint writer's fault hook (shard corruption, torn
    manifest, transient filesystem errors) and the serve surface
    (serve_kill, serve_slow, request_garbage);
  * :mod:`drill`  — the matrix driver: the port's train CLI in
    subprocesses under each family, the launcher's kill → policy →
    requeue → resume loop replayed, ``attempts.jsonl`` written;
  * :mod:`verify` — a copy of the JAX package's invariant checker,
    replaying a drill's artifacts.

``python -m tpudist_torch.chaos drill|verify`` is the CLI.
"""

from tpudist_torch.chaos.inject import ChaosRuntime
from tpudist_torch.chaos.plan import FAULT_KINDS, ChaosPlan, FaultEvent

__all__ = ["ChaosPlan", "ChaosRuntime", "FaultEvent", "FAULT_KINDS"]
