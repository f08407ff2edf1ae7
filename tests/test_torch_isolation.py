"""The port stands alone: ``tpudist_torch`` and ``chip_smoke.py`` import
nothing of JAX (``jax``, ``jaxlib``, ``optax``, ``orbax``) and nothing of
the JAX package (``tpudist``), on a machine where those are absent."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "optax", "orbax", "tpudist")
PORT_FILES = sorted(REPO.glob("tpudist_torch/**/*.py")) + [
    REPO / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path):
    """(line, top-level package) of every import statement in ``path``,
    wherever it sits (module level or inside a function)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.lineno, node.module.split(".")[0]


def test_port_files_exist():
    names = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    assert {"chip_smoke.py", "tpudist_torch/__init__.py",
            "tpudist_torch/ops/cuda/flash_attention.py",
            "tpudist_torch/serve/engine.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(REPO).as_posix())
def test_no_jax_or_tpudist_import(path):
    bad = [(line, root) for line, root in _imported_roots(path)
           if root in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_port_imports_and_serves_with_jax_blocked(tmp_path):
    """A fresh interpreter with the JAX stack and the JAX package made
    unimportable imports every module of the port and serves on the CPU
    through the CLI."""
    code = (
        "import sys, pkgutil, importlib\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None\n"
        "import tpudist_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    tpudist_torch.__path__, 'tpudist_torch.')\n"
        "    if not m.name.endswith('__main__')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "from tpudist_torch.serve import cli\n"
        f"rc = cli.main(['--device', 'cpu', '--requests', '2',\n"
        f"               '--max-new-tokens', '3', '--save-dir',\n"
        f"               {str(tmp_path)!r}])\n"
        "leaked = [n for n in sys.modules if n.split('.')[0] in\n"
        f"          {FORBIDDEN!r} and sys.modules[n] is not None]\n"
        "print(len(mods), rc, leaked)\n")
    env = dict(os.environ, TPUDIST_TTFT_P99_MAX="120",
               TPUDIST_ITL_P99_MAX="60", TPUDIST_TOKENS_PER_CHIP_MIN="0.001")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    n_mods, rc, leaked = proc.stdout.strip().splitlines()[-1].split(" ", 2)
    assert int(n_mods) >= 20
    assert rc == "0", proc.stdout[-2000:]
    assert leaked == "[]"
    assert "tpudist: serve success" in proc.stdout
