"""Machine-readable job verdict: the acceptance-test signal.

Copy of the part of ``tpudist/verdict.py`` the serving lane uses: the
three-valued status vocabulary and the coordinator's final status file,
written atomically (a ``gs://`` path goes through ``gsutil``).
Standard library only, apart from the rank query.
"""

from __future__ import annotations

import os
import subprocess

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


def write_final_status(path: str, status: str) -> None:
    """Coordinator-only: write an explicit status string (SUCCESS /
    FAIL / UNGATEABLE) at ``path``."""
    if _rank() == 0:
        _write(path, status)
