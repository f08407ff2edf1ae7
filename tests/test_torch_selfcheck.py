"""The port's on-card gate (``tpudist_torch.selfcheck``) on the CPU.

What the CPU can pin: the refusal off the card, the ``--only`` contract,
the check list against ``tpudist/selfcheck.py::CHECKS``, the scripted
checks' fixtures against the JAX check's numbers, the checks that are not
kernel checks passing in-process under the CPU (the kernel checks:
``test_torch_selfcheck_kernels.py`` and ``_xent.py``; the two drills:
their own tests, ``test_torch_chaos_drill*.py`` and
``test_torch_serve_drill*.py``), and a drill report with a bad family
turning its check red. On the card the
checks run through ``chip_smoke.py`` phase 27a.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tpudist import selfcheck as jax_selfcheck
from tpudist.obs import devtime as jax_devtime
from tpudist_torch import selfcheck
from tpudist_torch.obs import devtime

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _run(*args, **env):
    base = {k: v for k, v in os.environ.items()
            if not k.startswith("TPUDIST_")}
    return subprocess.run(
        [sys.executable, "-m", "tpudist_torch.selfcheck", *args], cwd=REPO,
        env=dict(base, OMP_NUM_THREADS="1", **env), capture_output=True,
        text=True, timeout=120)


@pytest.mark.parametrize("env", [{"TPUDIST_PLATFORM": "cpu"},
                                 {"CUDA_VISIBLE_DEVICES": ""},
                                 {"TPUDIST_PLATFORM": "tpu"}],
                         ids=["platform-cpu", "no-card", "platform-tpu"])
def test_refuses_off_the_card(env):
    """Off the card without --allow-cpu: exit 2, distinct from a check
    failure (1), and no check runs."""
    r = _run(**env)
    assert r.returncode == 2, r.stdout + r.stderr
    assert "refusing" in r.stdout
    assert "PASS" not in r.stdout and "FAIL" not in r.stdout
    if env.get("TPUDIST_PLATFORM") == "tpu":
        assert "TPUDIST_PLATFORM=tpu" in r.stdout


def test_only_unknown_name_exits_2_and_lists_the_checks():
    r = _run("--allow-cpu", "--only", "no_such_check")
    assert r.returncode == 2, r.stdout + r.stderr
    assert "no check named 'no_such_check'" in r.stdout
    assert all(fn.__name__ in r.stdout for fn in selfcheck.CHECKS)
    assert "PASS" not in r.stdout
    r = _run("--allow-cpu", "--only")
    assert r.returncode == 2 and "no check named None" in r.stdout


def test_only_runs_one_check_through_main():
    r = _run("--allow-cpu", "--only", "check_devtime",
             TPUDIST_PLATFORM="cpu")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "PASS check_devtime (" in r.stdout
    assert r.stdout.rstrip().endswith("selfcheck: 1/1 passed")
    assert "selfcheck: launches" not in r.stdout       # the card's line


def test_a_failing_check_exits_1(monkeypatch, capsys):
    def check_devtime():
        raise AssertionError("planted")
    monkeypatch.setattr(selfcheck, "CHECKS", [check_devtime])
    monkeypatch.setenv("TPUDIST_PLATFORM", "cpu")
    assert selfcheck.main(["--allow-cpu"]) == 1
    out = capsys.readouterr()
    assert "FAIL check_devtime" in out.out
    assert "selfcheck: 0/1 passed" in out.out
    assert "AssertionError: planted" in out.err


def test_checks_are_the_jax_checks_in_order():
    assert [fn.__name__ for fn in selfcheck.CHECKS] == \
        [fn.__name__ for fn in jax_selfcheck.CHECKS]
    assert len(selfcheck.CHECKS) == 17


# ------------------------------------------------ fixtures pinned to JAX


def _jax_fn(name):
    tree = ast.parse(Path(jax_selfcheck.__file__).read_text())
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _assigned(fn, name):
    (node,) = [n for n in ast.walk(fn) if isinstance(n, ast.Assign)
               and any(isinstance(t, ast.Name) and t.id == name
                       for t in n.targets)]
    return node.value


def _calls(fn, name):
    return [n for n in ast.walk(fn) if isinstance(n, ast.Call) and (
        getattr(n.func, "id", None) == name
        or getattr(n.func, "attr", None) == name)]


def _kw(call, name):
    return ast.literal_eval(next(k.value for k in call.keywords
                                 if k.arg == name))


def test_autotune_fixture_is_the_jax_checks():
    fn = _jax_fn("check_autotune")
    start = _assigned(fn, "start")
    assert {k.arg: ast.literal_eval(k.value) for k in start.keywords} \
        == selfcheck.AUTOTUNE_START
    assert ast.literal_eval(_assigned(fn, "axes")) == selfcheck.AUTOTUNE_AXES
    wall, flat = _calls(fn, "scripted")
    assert ast.literal_eval(wall.args[0]) == selfcheck.AUTOTUNE_CURVE
    assert _kw(wall, "infeasible_ks") == (selfcheck.AUTOTUNE_WALL_K,)
    # {k: (500.0 if k == 8 else 200.0) for k in (1, 2, 4, 8, 16, 32)}
    comp = flat.args[0]
    pick = comp.value
    assert ast.literal_eval(pick.body) == selfcheck.AUTOTUNE_SEED_SPS
    assert ast.literal_eval(pick.orelse) == selfcheck.AUTOTUNE_OTHER_SPS
    assert ast.literal_eval(pick.test.comparators[0]) == \
        selfcheck.AUTOTUNE_START["k"]
    assert list(ast.literal_eval(comp.generators[0].iter)) == \
        selfcheck.AUTOTUNE_AXES["k"]
    assert {_kw(c, "trial_budget") for c in _calls(fn, "coordinate_search")} \
        == {selfcheck.AUTOTUNE_BUDGET}
    # the exploding probe: the same curve, the same crashing point
    exploding = next(n for n in ast.walk(fn)
                     if isinstance(n, ast.FunctionDef)
                     and n.name == "exploding")
    (curve,) = [n for n in ast.walk(exploding) if isinstance(n, ast.Dict)]
    assert ast.literal_eval(curve) == selfcheck.AUTOTUNE_CURVE
    (test,) = [n.test for n in ast.walk(exploding) if isinstance(n, ast.If)]
    assert ast.literal_eval(test.comparators[0]) == selfcheck.AUTOTUNE_WALL_K


def test_devtime_fixture_is_the_jax_checks():
    """The intervals and answers are the JAX check's; each op's name is
    the port's, of the kind the JAX name is under the JAX rule."""
    fn = _jax_fn("check_devtime")
    ops = ast.literal_eval(_assigned(fn, "ops"))
    assert [(a, b) for a, b, _ in ops] == \
        [(a, b) for a, b, _ in selfcheck.DEVTIME_OPS]
    for (_, _, jname), (_, _, name) in zip(ops, selfcheck.DEVTIME_OPS):
        assert devtime.classify(name) == jax_devtime.classify(jname), name
    want = {}
    for node in ast.walk(fn):
        # abs(d["<key>"] * 1e6 - <value>) < 1e-9
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") \
                == "abs" and isinstance(node.args[0], ast.BinOp) \
                and isinstance(node.args[0].left, ast.BinOp):
            key = ast.literal_eval(node.args[0].left.left.slice)
            want[key] = ast.literal_eval(node.args[0].right)
    assert want == selfcheck.DEVTIME_WANT_US
    gates = [c.args[1] for c in _calls(fn, "comm_status") if len(c.args) > 1]
    assert [ast.literal_eval(g) for g in gates] == \
        [selfcheck.DEVTIME_STRICT_GATE]


# ------------------------------------------------ the checks, in-process

HOST_CHECKS = ["check_autotune", "check_devtime", "check_elastic",
               "check_staging_stream", "check_flight_recorder",
               "check_live", "check_train_step_smoke", "check_moe_smoke"]


@pytest.mark.parametrize("name", HOST_CHECKS)
def test_check_passes_on_the_cpu(name, tmp_path, monkeypatch):
    monkeypatch.setenv("TPUDIST_OBS_DIR", str(tmp_path))
    getattr(selfcheck, name)()


def test_every_check_is_covered_on_the_cpu():
    from test_torch_selfcheck_kernels import KERNEL_CHECKS
    from test_torch_selfcheck_xent import XENT_CHECKS
    drills = {"check_chaos", "check_serve_resilience"}
    assert set(HOST_CHECKS) | set(KERNEL_CHECKS) | set(XENT_CHECKS) \
        | drills == {
        fn.__name__ for fn in selfcheck.CHECKS}


def _bad(report, key):
    first = next(iter(report[key]))
    report[key][first] = {"ok": False, "problems": ["planted problem"]}
    return report


def test_chaos_report_with_a_bad_family_is_red(monkeypatch, tmp_path):
    from tpudist_torch.chaos import drill, verify
    seen = {}

    def run_matrix(run_dir, **kw):
        seen.update(kw, run_dir=run_dir,
                    platform=os.environ.get("TPUDIST_PLATFORM"))
        return {}

    def verify_matrix(run_dir, results):
        return _bad({"families": {f: {"ok": True, "problems": []}
                                  for f in drill.FAMILIES}}, "families")
    monkeypatch.setattr(drill, "run_matrix", run_matrix)
    monkeypatch.setattr(verify, "verify_matrix", verify_matrix)
    monkeypatch.setenv("TPUDIST_CHAOS_DRILL_DIR", str(tmp_path))
    monkeypatch.setenv("TPUDIST_PLATFORM", "cuda")
    with pytest.raises(AssertionError, match="planted problem"):
        selfcheck.check_chaos()
    # the attempts were told to run on the CPU, and the platform is back
    assert seen == {"platform": "cpu", "run_dir": str(tmp_path),
                    "lanes": selfcheck.DRILL_LANES}
    assert os.environ["TPUDIST_PLATFORM"] == "cuda"


def test_serve_report_with_a_bad_scenario_is_red(monkeypatch):
    from tpudist_torch.serve import drill

    def run_matrix(run_dir, **kw):
        assert os.environ.get("TPUDIST_PLATFORM") == "cpu"
        return {}

    def verify_matrix(run_dir, results):
        return _bad({"scenarios": {s: {"ok": True, "problems": []}
                                   for s in drill.SCENARIOS}}, "scenarios")
    monkeypatch.setattr(drill, "run_matrix", run_matrix)
    monkeypatch.setattr(drill, "verify_matrix", verify_matrix)
    monkeypatch.delenv("TPUDIST_PLATFORM", raising=False)
    with pytest.raises(AssertionError, match="planted problem"):
        selfcheck.check_serve_resilience()
    assert "TPUDIST_PLATFORM" not in os.environ


def test_drill_dirs_are_per_rank_under_several_ranks(monkeypatch, tmp_path):
    monkeypatch.setenv("TPUDIST_OBS_DIR", str(tmp_path))
    assert selfcheck._run_dir("TPUDIST_OBS_DIR", "x_") == str(tmp_path)
    monkeypatch.setattr(selfcheck, "_rank_world", lambda: (3, 4))
    assert selfcheck._run_dir("TPUDIST_OBS_DIR", "x_") == \
        str(tmp_path / "rank3")
    assert (tmp_path / "rank3").is_dir()


LAUNCHER_ENV = {"TPUDIST_COORDINATOR": "node0:29500",
                "TPUDIST_NUM_PROCESSES": "8", "TPUDIST_PROCESS_ID": "3",
                "TPUDIST_VERDICT_PATH": "/job/obs/job_status.txt",
                "TPUDIST_OBS_DIR": "/job/obs"}


def test_drill_attempts_leave_the_launcher_env_behind(monkeypatch,
                                                      tmp_path):
    """Under the launcher the drills' attempts are processes of their
    own on the CPU: none inherits the rank's env contract, verdict path or
    obs dir."""
    from tpudist_torch.chaos import drill as chaos_drill
    from tpudist_torch.serve import drill as serve_drill
    for k, v in LAUNCHER_ENV.items():
        monkeypatch.setenv(k, v)
    seen = {}

    def fake_run(argv, env=None, **kw):
        seen.update(env)
        return subprocess.CompletedProcess(argv, 0, "", "")
    monkeypatch.setattr(chaos_drill.subprocess, "run", fake_run)
    with selfcheck._attempts_on_cpu():
        serve_env = serve_drill.attempt_env(os.environ)
        chaos_drill._attempt(sys.executable, str(tmp_path))
    for env in (serve_env, seen):
        assert not set(LAUNCHER_ENV) & set(env)
        assert env["TPUDIST_PLATFORM"] == "cpu"
