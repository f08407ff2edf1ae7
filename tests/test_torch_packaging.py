"""A wheel built from this tree carries the port's CUDA sources: an
installed port builds its kernels from ``tpudist_torch/csrc/`` at first
use, so a wheel without them would give a port whose first kernel call
fails (``pyproject.toml``'s package data)."""

import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def test_wheel_holds_the_cuda_sources(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    for name in ("pyproject.toml", "README.md"):
        shutil.copy(REPO / name, src / name)
    for pkg in ("tpudist", "tpudist_torch"):
        shutil.copytree(REPO / pkg, src / pkg,
                        ignore=shutil.ignore_patterns("__pycache__"))
    out = tmp_path / "dist"
    r = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "--no-deps",
         "--no-build-isolation", "--no-index", "-q", "-w", str(out),
         str(src)], capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    (wheel,) = out.glob("*.whl")
    names = set(zipfile.ZipFile(wheel).namelist())
    want = {f"tpudist_torch/csrc/{p.name}" for p in
            (REPO / "tpudist_torch" / "csrc").iterdir()
            if p.suffix in (".cu", ".cuh")}
    assert len(want) >= 5 and want <= names, sorted(want - names)
    assert "tpudist_torch/selfcheck.py" in names
    assert "tpudist_torch/ops/cuda/build.py" in names
