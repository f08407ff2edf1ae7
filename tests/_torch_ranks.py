"""Run a Python snippet as the ranks of one gloo job under the env
contract (``TPUDIST_COORDINATOR`` / ``TPUDIST_NUM_PROCESSES`` /
``TPUDIST_PROCESS_ID``): a helper of the port's FSDP tests, which holds
no test itself.

Each rank runs ``PRELUDE`` (JAX made unimportable, one CPU thread, the
process group joined through ``tpudist_torch.parallel.distributed``;
``RANK``, ``WORLD`` and ``ARGS`` defined), then the snippet, then leaves
the group.
"""

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRELUDE = r"""
import sys
for name in ("jax", "jaxlib", "optax", "orbax", "tpudist"):
    sys.modules[name] = None
import numpy as np
import torch
torch.set_num_threads(1)
from tpudist_torch.parallel import distributed
CTX = distributed.initialize(device="cpu")
RANK, WORLD = CTX.process_index, CTX.process_count
ARGS = sys.argv[1:]
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(code: str, world: int, *args, timeout: float = 180):
    """Run ``code`` as ``world`` ranks (a one-rank process group when
    ``world`` is 1) with ``args`` as its ``ARGS``; returns each rank's
    output, and fails unless every rank exits 0."""
    return start_ranks(code, world, *args)(timeout)


def start_ranks(code: str, world: int, *args):
    """:func:`run_ranks` started: returns its ``wait(timeout=180)``."""
    port = free_port()
    script = PRELUDE + code + "\ndistributed.shutdown()\n"
    procs = []
    for rank in range(world):
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   TPUDIST_COORDINATOR=f"localhost:{port}",
                   TPUDIST_NUM_PROCESSES=str(world),
                   TPUDIST_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", script, *map(str, args)], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))

    def wait(timeout: float = 180):
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                p.kill()
        assert [p.returncode for p in procs] == [0] * world, outs
        return outs
    return wait
