"""Run a Python snippet as the ranks of one gloo job under the env
contract (``TPUDIST_COORDINATOR`` / ``TPUDIST_NUM_PROCESSES`` /
``TPUDIST_PROCESS_ID``), or the train CLI or the serve CLI as the
processes of one: a helper of the port's mesh tests, which holds no test
itself.

Each rank runs ``PRELUDE`` (JAX made unimportable, one CPU thread, the
process group joined through ``tpudist_torch.parallel.distributed``;
``RANK``, ``WORLD`` and ``ARGS`` defined), then the snippet, then leaves
the group. A CLI process runs ``CHILD`` on the JAX package's
permutations, init and (for the MLP) data, which
:func:`jax_cli_reference` writes.
"""

import json
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


def _ephemeral_low() -> int:
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 32768


_BLOCK = 1000
_next_port = [None]


def free_port() -> int:
    """A port no other process is handed while a test's ranks start: one
    below the kernel's ephemeral range (where neither a ``bind`` to port
    0 nor an outgoing connection ever lands), from a block of its own for
    each pytest-xdist worker (``PYTEST_XDIST_WORKER`` gw<i>; one more
    block without xdist), each port handed out once a process and
    checked free by a bind. A port bound at 0 and released could be
    taken by another worker's connection before the ranks bind it."""
    worker = os.environ.get("PYTEST_XDIST_WORKER", "")
    index = int(worker[2:]) if worker[2:].isdigit() else 15
    base = _ephemeral_low() - 16 * _BLOCK + (index % 16) * _BLOCK
    if base < 1024:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            return s.getsockname()[1]
    if _next_port[0] is None:
        _next_port[0] = os.getpid() % _BLOCK
    for _ in range(_BLOCK):
        port = base + _next_port[0] % _BLOCK
        _next_port[0] += 1
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        return port
    raise RuntimeError(f"no free port in [{base}, {base + _BLOCK})")


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


# one process of the train CLI: argv[1] an .npz of the JAX package's
# permutations, init and (for the MLP) data, the rest its flags; the token
# data is numpy on both sides
CHILD = r"""
import sys
for name in ("jax", "jaxlib", "optax", "orbax", "tpudist"):
    sys.modules[name] = None
import numpy as np
import torch
torch.set_num_threads(1)
from tpudist_torch import data, train
from tpudist_torch.models import mlp, moe, transformer

ref, argv = sys.argv[1], sys.argv[2:]
a = dict(np.load(ref))
if "x" in a:
    data.reference_data = lambda n, f, seed: (
        (a["x"], a["y"]) if n == len(a["x"]) else (a["ex"], a["ey"]))
data.reference_permutation = lambda seed, epoch, n: a[f"perm{epoch}"]


def carried(init):
    def carried_init(cfg, *, generator):
        model = init(cfg, generator=generator)
        model.load_state_dict({k[6:]: torch.from_numpy(v) for k, v in
                               a.items() if k.startswith("param.")})
        return model
    return carried_init
for module in (mlp, transformer, moe):
    module.init = carried(module.init)
sys.exit(train.main(argv))
"""


def launch_cli(tmp, argv, nprocs, ref):
    """``nprocs`` processes of the train CLI (:data:`CHILD` on ``ref``)
    with ``argv``, saving under ``tmp/ck``; returns their ``wait(timeout=
    150) -> (exit codes, outputs)``."""
    os.makedirs(tmp, exist_ok=True)
    port = free_port()
    procs = []
    for rank in range(nprocs):
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   TPUDIST_VERDICT_PATH=os.path.join(tmp, "job_status.txt"))
        if nprocs > 1:
            env.update(TPUDIST_COORDINATOR=f"localhost:{port}",
                       TPUDIST_NUM_PROCESSES=str(nprocs),
                       TPUDIST_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", CHILD, ref, *argv, "--device", "cpu",
             "--save-dir", os.path.join(tmp, "ck")], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    def wait(timeout=150):
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                p.kill()
        return [p.returncode for p in procs], outs
    return wait


def records(tmp, kind):
    """The ``kind`` records of a CLI run's ``metrics.jsonl``."""
    return [r for r in (json.loads(line) for line in open(
        os.path.join(tmp, "ck", "metrics.jsonl"))) if r["kind"] == kind]


def verdicts(tmp, nprocs):
    """A CLI run's aggregated verdict and each worker's."""
    read = lambda name: open(os.path.join(tmp, name)).read()  # noqa: E731
    return read("job_status.txt"), [read(f"job_status.txt.worker{r}")
                                    for r in range(nprocs)]


def jax_cli_reference(path, argv):
    """The JAX package's permutations and init for ``argv``, and its
    data for the MLP, in an .npz (JAX imported here: the ranks and CLI
    processes never import it)."""
    import jax
    import numpy as np
    from tpudist import config as jconfig
    from tpudist import data as jdata
    from tpudist.models import mlp as jmlp
    from tpudist.models import moe as jmoe
    from tpudist.models import transformer as jtf
    from tpudist_torch import convert
    cfg = jconfig.parse_args(argv)
    n, f, seed = cfg.data.n_samples, cfg.data.n_features, cfg.data.seed
    arrays = {}
    if cfg.model.name == "mlp":
        x, y = jdata.make_synthetic_data(n, f, seed)
        ex, ey = jdata.make_synthetic_data(cfg.batch_size, f, seed + 1)
        arrays.update(x=x, y=y, ex=ex, ey=ey)
    for e in range(cfg.epochs):
        arrays[f"perm{e}"] = jdata.epoch_permutation(cfg.seed, e, n)
    model = {"mlp": jmlp, "transformer": jtf, "moe": jmoe}[cfg.model.name]
    params = model.init(jax.random.PRNGKey(cfg.seed), cfg.model)
    for k, v in convert.params_from_jax(jax.device_get(params)).items():
        arrays[f"param.{k}"] = v.numpy()
    np.savez(path, **{k: np.asarray(v) for k, v in arrays.items()})


# one serve CLI process: argv[1] a directory for what it reports (rank 0's
# tokens by request in tokens.json, each rank's serve tuner outcome in
# tune.rank<r>.json), the rest its flags
SERVE_CHILD = r"""
import json
import os
import sys
for name in ("jax", "jaxlib", "optax", "orbax", "tpudist"):
    sys.modules[name] = None
import torch
torch.set_num_threads(1)
from tpudist_torch.serve import cli, scheduler, tune

out, argv = sys.argv[1], sys.argv[2:]
rank = os.environ.get("TPUDIST_PROCESS_ID", "0")
serve, autotune = scheduler.run_serve, tune.autotune_serve


def run_serve(*args, **kw):
    summary = serve(*args, **kw)
    with open(os.path.join(out, "tokens.json"), "w") as f:
        json.dump({rid: r["tokens"] for rid, r in
                   summary["results"].items()}, f)
    return summary


def autotune_serve(*args, **kw):
    o = autotune(*args, **kw)
    with open(os.path.join(out, f"tune.rank{rank}.json"), "w") as f:
        json.dump({"tuned": o.tuned.as_dict(), "source": o.source,
                   "trials": o.trials, "fingerprint": o.fingerprint}, f)
    return o
scheduler.run_serve, tune.autotune_serve = run_serve, autotune_serve
sys.exit(cli.main(argv))
"""
# latency gates loose enough for a loaded CPU
SERVE_GATES = {"TPUDIST_TTFT_P99_MAX": "120", "TPUDIST_ITL_P99_MAX": "60",
               "TPUDIST_TOKENS_PER_CHIP_MIN": "0.001"}


def serve_cli(save, world: int, argv, timeout: float = 180):
    """``world`` processes of the serve CLI (:data:`SERVE_CHILD`; one
    without the env contract) on the CPU with ``argv``, saving and
    reporting under ``save``, the verdict at ``save/verdict.txt``;
    returns (exit codes, outputs, wall seconds)."""
    import time
    os.makedirs(save, exist_ok=True)
    port = free_port()
    procs = []
    t0 = time.monotonic()
    for rank in range(world):
        env = dict(os.environ, OMP_NUM_THREADS="1", **SERVE_GATES,
                   TPUDIST_VERDICT_PATH=os.path.join(save, "verdict.txt"))
        env.pop("TPUDIST_CHAOS", None)
        if world > 1:
            env.update(TPUDIST_COORDINATOR=f"localhost:{port}",
                       TPUDIST_NUM_PROCESSES=str(world),
                       TPUDIST_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", SERVE_CHILD, str(save), *argv,
             "--device", "cpu", "--save-dir", str(save)], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    return [p.returncode for p in procs], outs, time.monotonic() - t0


def serve_records(save, kind):
    """The ``kind`` records of a serve CLI run's ``metrics.jsonl``."""
    return [r for r in (json.loads(line) for line in open(
        os.path.join(save, "metrics.jsonl"))) if r["kind"] == kind]
