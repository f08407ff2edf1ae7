"""Build the port's CUDA sources into shared libraries at first use.

Each library is compiled by ``nvcc`` for ``sm_90a`` (Hopper) from the
sources under ``tpudist_torch/csrc/`` into
``<root>/<name>-<hash>/lib<name>.so``, where ``<root>`` is
:func:`build_root` (``build/tpudist_torch`` at the repository root
unless ``--compilation-cache-dir`` or ``TPUDIST_COMPILATION_CACHE_DIR``
names another directory: the port's counterpart of the JAX package's
persistent compilation cache) and ``<hash>`` covers the sources, the
headers beside them and the compiler flags: a checkout builds what it
holds, and a changed source or header never loads a stale library. The
libraries have a plain C interface and are loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds, not minutes).

Nothing here runs at import time: the CPU test lane imports every module
of the port on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "tpudist_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[Path, ctypes.CDLL] = {}
_root: Optional[Path] = None      # set_build_root's directory


def set_build_root(path: Optional[str]) -> None:
    """The train CLI's ``--compilation-cache-dir``: build (and look for)
    the libraries under ``path`` from now on; None leaves the choice to
    :func:`build_root`'s environment and default."""
    global _root
    _root = Path(path) if path else None


def build_root() -> Path:
    """The directory the libraries are built under: the one
    :func:`set_build_root` named, else ``$TPUDIST_COMPILATION_CACHE_DIR``,
    else :data:`BUILD_ROOT`."""
    env = os.environ.get("TPUDIST_COMPILATION_CACHE_DIR")
    return _root or (Path(env) if env else BUILD_ROOT)


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float       # 0.0 when the library was already built
    log: str             # nvcc's output (ptxas register/spill report)


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on
    PATH, else the toolkit's default install prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are built from source at first use")


def library_path(name: str, sources: Sequence[str]) -> Path:
    """Where ``name`` built from ``sources`` (file names under csrc/)
    lives: keyed by the flags and the bytes of the sources and of every
    header under csrc/ (which any source may include)."""
    h = hashlib.sha256("\0".join(NVCC_FLAGS).encode())
    headers = sorted(p.name for p in CSRC.glob("*.cuh"))
    for src in (*sources, *headers):
        h.update(src.encode())
        h.update((CSRC / src).read_bytes())
    return build_root() / f"{name}-{h.hexdigest()[:16]}" / f"lib{name}.so"


def build(name: str, sources: Sequence[str]) -> BuildResult:
    """Build ``name`` from ``sources`` unless it is built already. Raises
    with the compiler's output if the build fails."""
    lib = library_path(name, sources)
    if lib.is_file():
        return BuildResult(lib, 0.0, "")
    lib.parent.mkdir(parents=True, exist_ok=True)
    # compile to a private name and rename: a process building the same
    # library at the same time never loads a half-written one
    tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, lib)
    return BuildResult(lib, time.perf_counter() - t0, proc.stdout)


def load(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """The loaded library for ``name``, building it first if needed."""
    lib = build(name, sources).path
    if lib not in _LOADED:
        _LOADED[lib] = ctypes.CDLL(str(lib))
    return _LOADED[lib]


def libraries():
    """``(name, sources)`` of every kernel library of the port's paths."""
    from tpudist_torch.ops.cuda import flash_attention as fa
    from tpudist_torch.ops.cuda import fused_xent as fx

    return ((fa.LIBRARY, fa.SOURCES), (fa.BWD_LIBRARY, fa.BWD_SOURCES),
            (fx.LIBRARY, fx.SOURCES))


def build_all() -> list:
    """:func:`build` every library of :func:`libraries`, one ``nvcc``
    each, started together; their :class:`BuildResult` in that order."""
    from concurrent.futures import ThreadPoolExecutor

    libs = libraries()
    with ThreadPoolExecutor(len(libs)) as pool:
        return list(pool.map(lambda lib: build(*lib), libs))


def main() -> int:
    """``python -m tpudist_torch.ops.cuda.build``: :func:`build_all`
    under :func:`build_root`. It needs ``nvcc`` but no card: an image
    build runs it, and the SLURM launcher runs it once a node before the
    ranks start, so they load the libraries instead of each building
    them."""
    for (name, _), res in zip(libraries(), build_all()):
        print(f"build: {name}: {res.path} ({res.seconds:.2f} s)",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
