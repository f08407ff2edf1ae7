"""Machine-readable job verdict: the acceptance-test signal.

Copy of the part of ``tpudist/verdict.py`` the serving and training
lanes use: the three-valued status vocabulary, the per-worker and final
verdict files, written atomically (a ``gs://`` path goes through
``gsutil``), and the AND-aggregation over processes. Standard library
only, apart from the rank query.
"""

from __future__ import annotations

import os
import subprocess
from typing import Tuple

from tpudist_torch.metrics import _rank

SUCCESS = "success"
FAIL = "fail"
UNGATEABLE = "ungateable"


def _write(path: str, content: str) -> None:
    if path.startswith("gs://"):
        # shell-free: path/content go as argv/stdin
        subprocess.run(["gsutil", "cp", "-", path], input=content.encode(),
                       check=True, timeout=120)
    else:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(content)
        os.replace(tmp, path)


def write_worker_verdict(path: str, ok: bool) -> None:
    """Per-worker verdict at ``<path>.worker<rank>`` (every rank writes
    one)."""
    _write(f"{path}.worker{_rank()}", SUCCESS if ok else FAIL)


def write_final_verdict(path: str, ok: bool) -> None:
    """Coordinator-only aggregate verdict at ``path`` itself; call after
    :func:`aggregate_status`."""
    write_final_status(path, SUCCESS if ok else FAIL)


def write_final_status(path: str, status: str) -> None:
    """Coordinator-only: write an explicit status string (SUCCESS /
    FAIL / UNGATEABLE) at ``path``."""
    if _rank() == 0:
        _write(path, status)


def aggregate_status(local_ok: bool) -> Tuple[bool, bool]:
    """AND-reduce success over all processes -> ``(all_ok, timed_out)``.
    The training lane runs one process, where the local verdict is the
    job's; the bounded all-process reduce comes with data parallelism
    (ROADMAP Queue A item 4)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise NotImplementedError(
            "verdict aggregation over several processes comes with "
            "ROADMAP Queue A item 4")
    return local_ok, False
