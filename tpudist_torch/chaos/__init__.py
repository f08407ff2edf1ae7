"""tpudist_torch.chaos — scripted fault injection, the serving surface.

Counterpart of ``tpudist/chaos``: :mod:`plan` is a copy of the JAX
package's seeded fault schedule (the whole ``--chaos`` /
``TPUDIST_CHAOS`` grammar, train families included), and :mod:`inject`
is :class:`~tpudist_torch.chaos.inject.ChaosRuntime` with its serve
surface (``serve_kill``, ``serve_slow``, ``request_garbage``), which the
serve CLI and scheduler fire. The train surfaces, the drill and
the verifier come with ROADMAP Queue A item 10.
"""

from tpudist_torch.chaos.inject import ChaosRuntime
from tpudist_torch.chaos.plan import FAULT_KINDS, ChaosPlan, FaultEvent

__all__ = ["ChaosPlan", "ChaosRuntime", "FaultEvent", "FAULT_KINDS"]
