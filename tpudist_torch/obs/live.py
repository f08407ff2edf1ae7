"""The run's correlation id: the one piece of ``tpudist/obs/live.py``
the port carries (the live telemetry bus is ROADMAP Queue A item 11b).

Every record a run writes carries ``run_id`` (``MetricsLogger.extra``),
as do its trace documents (``Tracer.run_info``) and its flight records,
so the artifacts of one run, and of its requeue attempts, stay
correlatable.
"""

from __future__ import annotations

import os
import uuid
from typing import Any, List

import torch.distributed as dist

from tpudist_torch.parallel import distributed


def resolve_run_id(process_count: int = 1) -> str:
    """``$TPUDIST_RUN_ID`` when the launcher set one (cut to 64
    characters; the same id then spans every requeue attempt), else rank
    0's ``uuid4().hex[:12]``, gathered over the host gloo group so every
    process stamps the same id. One process makes no collective."""
    rid = os.environ.get("TPUDIST_RUN_ID")
    if rid:
        return rid.strip()[:64]
    rid = uuid.uuid4().hex[:12]
    if process_count <= 1:
        return rid
    ids: List[Any] = [None] * process_count
    dist.all_gather_object(ids, rid, group=distributed.host_group())
    return ids[0]
