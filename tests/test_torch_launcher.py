"""The GPU launcher (``launcher/launch_gpu.sh`` and
``launcher/slurm_gpu.sbatch``) against stub SLURM commands.

Every decision the launcher makes (the probe, the submission's shape,
the poll and its timeout, the stages on the tasks, the verdict, the
requeue loop, the sweep gate) is shell logic. These tests run it with a
fake ``scontrol``, ``sbatch``, ``squeue``, ``scancel`` and ``srun`` on
PATH, as ``tests/test_launcher.py`` does for the TPU launcher with
``gcloud``: ``sbatch`` runs the batch script at once with the SLURM job
variables set, ``srun`` runs its command once a task with
``SLURM_PROCID`` / ``SLURM_LOCALID`` / ``SLURM_NTASKS`` set, and in the
scripted cases a ``python3`` stub stands in for the workload modules
(logging each call with its task's env contract and exiting as the case
scripts it) while the policy runs for real. One case runs the batch
script end to end on the CPU: two gloo tasks of the MLP for one epoch.
"""

import json
import os
import re
import stat
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

SCONTROL = r"""#!/usr/bin/env bash
echo "scontrol $*" >> "$STUB_DIR/calls.log"
case "$1 $2" in
  "show nodes")
    for ((i = 0; i < ${STUB_NODES:-2}; i++)); do
      echo "NodeName=node$i Arch=x86_64 CoresPerSocket=32"
      echo "   CfgTRES=cpu=64,mem=1000G,billing=64,gres/gpu=${STUB_GPUS:-4}"
      echo "   State=IDLE"
    done ;;
  "show hostnames")
    for ((i = 0; i < ${SLURM_JOB_NUM_NODES:-1}; i++)); do
      echo "${STUB_HOSTNAME:-node$i}"
    done ;;
esac
"""

# runs the batch script at once (synchronously) with the job's variables
SBATCH = r"""#!/usr/bin/env bash
echo "sbatch $*" >> "$STUB_DIR/calls.log"
[ "${STUB_SBATCH_RC:-0}" = 0 ] || exit "$STUB_SBATCH_RC"
nodes=1 per=1 dir=$PWD out=/dev/null
while [ $# -gt 0 ]; do
  case "$1" in
    --nodes) nodes=$2; shift 2 ;;
    --ntasks-per-node) per=$2; shift 2 ;;
    --chdir) dir=$2; shift 2 ;;
    --output) out=$2; shift 2 ;;
    --error|--gres|--job-name) shift 2 ;;
    --export=*)
      IFS=, read -ra kvs <<< "${1#--export=}"
      for kv in "${kvs[@]}"; do [ "$kv" = ALL ] || export "$kv"; done
      shift ;;
    --*) shift ;;
    *) break ;;
  esac
done
script=$1; shift
n=$(cat "$STUB_DIR/jobs" 2>/dev/null || echo 0)
echo $((n + 1)) > "$STUB_DIR/jobs"
export SLURM_JOB_ID=$((1000 + n)) SLURM_JOB_NUM_NODES=$nodes \
  SLURM_NNODES=$nodes SLURM_NTASKS_PER_NODE=$per \
  SLURM_NTASKS=$((nodes * per)) SLURM_JOB_NODELIST="node[0-$((nodes - 1))]" \
  SLURM_SUBMIT_DIR=$PWD
(cd "$dir" && bash "$script" "$@") > "${out//%j/$SLURM_JOB_ID}" 2>&1
echo "$SLURM_JOB_ID"
"""

SQUEUE = r"""#!/usr/bin/env bash
echo "squeue $*" >> "$STUB_DIR/calls.log"
n=$(cat "$STUB_DIR/squeue_n" 2>/dev/null || echo 0)
echo $((n + 1)) > "$STUB_DIR/squeue_n"
if [ "$n" -lt "${STUB_PENDING_POLLS:-1}" ]; then echo RUNNING; fi
"""

SCANCEL = r"""#!/usr/bin/env bash
echo "scancel $*" >> "$STUB_DIR/calls.log"
touch "$STUB_DIR/cancelled"
"""

# one process a task, all at once; the step's exit code is the largest
SRUN = r"""#!/usr/bin/env bash
echo "srun $*" >> "$STUB_DIR/calls.log"
nodes=${SLURM_JOB_NUM_NODES:-1} per=1
while [ $# -gt 0 ]; do
  case "$1" in
    --nodes=*) nodes=${1#--nodes=}; shift ;;
    --ntasks-per-node=*) per=${1#--ntasks-per-node=}; shift ;;
    --*) shift ;;
    *) break ;;
  esac
done
pids=()
for ((p = 0; p < nodes * per; p++)); do
  SLURM_PROCID=$p SLURM_LOCALID=$((p % per)) SLURM_NODEID=$((p / per)) \
    SLURM_NTASKS=$((nodes * per)) "$@" &
  pids+=($!)
done
rc=0
for pid in "${pids[@]}"; do
  wait "$pid"; r=$?
  [ "$r" -gt "$rc" ] && rc=$r
done
exit "$rc"
"""

# the workload modules, scripted; anything else runs for real
PYTHON3 = r"""#!/usr/bin/env bash
case "$*" in
  *tpudist_torch.selfcheck*|*tpudist_torch.train*|*tpudist_torch.serve*|\
  *tpudist_torch.bench.sweep*|*tpudist_torch.ops.cuda.build*) ;;
  *) exec "$STUB_REAL_PYTHON" "$@" ;;
esac
# one write a line: the tasks log side by side
line=$(printf 'python3'; printf ' %q' "$@"
  echo " [rank=${TPUDIST_PROCESS_ID:-} world=${TPUDIST_NUM_PROCESSES:-}" \
       "coord=${TPUDIST_COORDINATOR:-} verdict=${TPUDIST_VERDICT_PATH:-}" \
       "run_id=${TPUDIST_RUN_ID:-} live=${TPUDIST_LIVE:-}" \
       "live_port=${TPUDIST_LIVE_PORT:-} endpoint=${TPUDIST_LIVE_ENDPOINT:-}]")
echo "$line" >> "$STUB_DIR/calls.log"
hb=""
args=("$@")
for ((i = 0; i < ${#args[@]}; i++)); do
  [ "${args[i]}" = --heartbeat-dir ] && hb=${args[i + 1]}
done
workload() {  # workload <rc> <fail-first-n>
  local rc=$1
  if [ -n "$2" ]; then
    if [ "${ATTEMPT:-0}" -lt "$2" ]; then rc=${rc:-137}; else rc=0; fi
  fi
  rc=${rc:-0}
  [ -n "$hb" ] && echo "{\"step\": 3}" > "$hb/heartbeat.worker$TPUDIST_PROCESS_ID"
  if [ "$rc" = 0 ]; then
    echo -n success > "$TPUDIST_VERDICT_PATH.worker$TPUDIST_PROCESS_ID"
    if [ "$TPUDIST_PROCESS_ID" = 0 ]; then
      echo -n success > "$TPUDIST_VERDICT_PATH"
      [ "${TPUDIST_LIVE:-}" = on ] && echo '{"status": "ok"}' \
        > "$(dirname "$TPUDIST_VERDICT_PATH")/live_status.json"
    fi
  elif [ "$rc" != 137 ]; then   # a signal death leaves no verdict
    echo -n fail > "$TPUDIST_VERDICT_PATH.worker$TPUDIST_PROCESS_ID"
  fi
  exit "$rc"
}
case "$*" in
  *tpudist_torch.ops.cuda.build*) exit "${STUB_BUILD_RC:-0}" ;;
  *tpudist_torch.selfcheck*) exit "${STUB_SELFCHECK_RC:-0}" ;;
  *tpudist_torch.bench.sweep*) exit "${STUB_SWEEP_RC:-0}" ;;
  *tpudist_torch.train*) workload "${STUB_TRAIN_RC:-}" "${STUB_TRAIN_FAIL_N:-}" ;;
  *tpudist_torch.serve*) workload "${STUB_SERVE_RC:-}" "${STUB_SERVE_FAIL_N:-}" ;;
esac
"""


def _stubs(tmp_path, scripted=True):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    stubs = {"scontrol": SCONTROL, "sbatch": SBATCH, "squeue": SQUEUE,
             "scancel": SCANCEL, "srun": SRUN}
    # the test's own interpreter wherever the scripts say python3
    stubs["python3"] = PYTHON3 if scripted else \
        '#!/usr/bin/env bash\nexec "$STUB_REAL_PYTHON" "$@"\n'
    for name, body in stubs.items():
        p = bin_dir / name
        p.write_text(body)
        p.chmod(p.stat().st_mode | stat.S_IEXEC)
    stub_dir = tmp_path / "state"
    stub_dir.mkdir()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPUDIST_", "SLURM_"))}
    env.update(PATH=f"{bin_dir}:{os.environ['PATH']}",
               STUB_DIR=str(stub_dir), STUB_REAL_PYTHON=sys.executable,
               TIMEOUT_S="30", POLL_S="0", RUN_ID="r-test")
    return env, stub_dir


@pytest.fixture()
def stub_env(tmp_path):
    return _stubs(tmp_path)


def launch(env, *flags, timeout=120):
    return subprocess.run(
        [str(REPO / "launcher" / "launch_gpu.sh"), *flags], env=env,
        cwd=env["STUB_DIR"], capture_output=True, text=True,
        timeout=timeout)


def verdict(stub, name="job_status.txt"):
    p = stub / name
    return p.read_text() if p.exists() else None


def calls(stub):
    return (stub / "calls.log").read_text().splitlines()


def lines(stub, module):
    """The python3 stub's calls of ``tpudist_torch.<module>``, each
    argument as ``printf %q`` wrote it (commas unescaped)."""
    return [ln.replace("\\,", ",") for ln in calls(stub)
            if ln.startswith("python3 ") and f"tpudist_torch.{module}" in ln]


def test_happy_path_probe_submit_verdict(stub_env):
    env, stub = stub_env
    r = launch(env, "--epochs", "2")
    assert r.returncode == 0, r.stdout + r.stderr
    assert verdict(stub) == "success"
    log = calls(stub)
    probe = log.index("scontrol show nodes")
    (sub,) = [i for i, ln in enumerate(log) if ln.startswith("sbatch ")]
    assert probe < sub
    assert "probe: 2 node(s), gres/gpu 4,4" in r.stdout
    # the shape as options; the env the job needs rides --export
    assert "--nodes 2 --gres gpu:4 --ntasks-per-node 4" in log[sub]
    assert "--export=ALL,MODE=train,RUN_ID=r-test,ATTEMPT=0" in log[sub]
    assert log[sub].endswith("slurm_gpu.sbatch --epochs 2")
    # the rendezvous on the first host, one task a card, block layout
    trains = lines(stub, "train")
    assert len(trains) == 8
    assert all("coord=node0:29500 " in t and "world=8 " in t
               for t in trains)
    assert sorted(int(re.search(r"rank=(\d+)", t).group(1))
                  for t in trains) == list(range(8))
    srun = [ln for ln in log if ln.startswith("srun ")
            and "tpudist_torch.train" in ln][0]
    assert "--ntasks-per-node=4" in srun and "--distribution=block" in srun
    # the kernels built once a node, before anything else on the tasks
    builds = lines(stub, "ops.cuda.build")
    assert len(builds) == 2
    assert log.index(builds[-1]) < log.index(trains[0])
    assert "--epochs 2" in trains[0]
    assert "--heartbeat-dir" in trains[0] and "--trace-dir" in trains[0]


def test_extra_flags_with_spaces_survive_quoting(stub_env):
    env, stub = stub_env
    r = launch(env, "--save-dir", "dir with spaces")
    assert r.returncode == 0, r.stdout + r.stderr
    assert r"--save-dir dir\ with\ spaces" in lines(stub, "train")[0]


def test_workload_failure_writes_fail_and_exits_1(stub_env):
    """A training failure exits 1 whatever the workload's code: 2, 3 and
    124 mean other things to this script."""
    env, stub = stub_env
    env["STUB_TRAIN_RC"] = "3"
    r = launch(env)
    assert r.returncode == 1
    assert verdict(stub) == "fail"
    assert (stub / "tpudist_job" / "job_rc.txt").read_text().strip() == "3"


def test_a_rank_without_a_success_verdict_fails_the_job(stub_env):
    """Exit code 0 everywhere is not enough: every rank's verdict file
    must say success."""
    env, stub = stub_env
    env["STUB_TRAIN_RC"] = "0"
    sbatch = REPO / "launcher" / "slurm_gpu.sbatch"
    r = subprocess.run(["bash", "-c", f"""
        export SLURM_JOB_ID=7 SLURM_JOB_NUM_NODES=1 SLURM_NTASKS_PER_NODE=2
        export SLURM_NTASKS=2 SLURM_JOB_NODELIST=node0 JOB_DIR={stub}
        export SKIP_SELFCHECK=1 TPUDIST_PLATFORM=cpu
        # rank 1's verdict vanishes after it is written
        srun() {{ command srun "$@"; rc=$?;
                  rm -f {stub}/obs/job_status.txt.worker1; return $rc; }}
        export -f srun
        source {sbatch}"""], env=env, cwd=stub, capture_output=True,
        text=True, timeout=60)
    assert r.returncode == 1, r.stdout + r.stderr
    assert "rank 1 left no success verdict" in r.stdout
    assert (stub / "job_status.txt").read_text() == "fail"


def test_probe_mismatch_fails_before_submitting(stub_env):
    env, stub = stub_env
    for ask in ({"NNODES": "3"}, {"GPUS_PER_NODE": "8"}):
        r = launch(dict(env, **ask))
        assert r.returncode == 1, (ask, r.stdout + r.stderr)
        assert verdict(stub) == "fail"
        assert "not submitted" in r.stdout
        log = calls(stub)
        assert not [ln for ln in log if ln.startswith("sbatch ")], ask
        assert not lines(stub, "train"), "no train process on a bad shape"


def test_probe_defaults_to_the_cluster_shape(stub_env):
    env, stub = stub_env
    r = launch(dict(env, STUB_NODES="3", STUB_GPUS="8", NNODES="2"))
    assert r.returncode == 0, r.stdout + r.stderr
    (sub,) = [ln for ln in calls(stub) if ln.startswith("sbatch ")]
    assert "--nodes 2 --gres gpu:8 --ntasks-per-node 8" in sub
    assert len(lines(stub, "train")) == 16


def test_a_refused_submission_fails(stub_env):
    env, stub = stub_env
    env["STUB_SBATCH_RC"] = "1"
    r = launch(env)
    assert r.returncode == 1, r.stdout + r.stderr
    assert verdict(stub) == "fail"
    assert "sbatch refused the job" in r.stdout
    assert not lines(stub, "train")


def test_queue_timeout_cancels_and_exits_124(stub_env):
    env, stub = stub_env
    env.update(STUB_PENDING_POLLS="1000", TIMEOUT_S="0")
    r = launch(env)
    assert r.returncode == 124, r.stdout + r.stderr
    assert verdict(stub) == "fail"
    assert (stub / "cancelled").exists()
    assert "scancel 1000" in calls(stub)


def test_selfcheck_red_fails_before_training(stub_env):
    """A kernel that is wrong on the card turns the verdict fail before
    any train process starts."""
    env, stub = stub_env
    env["STUB_SELFCHECK_RC"] = "1"
    r = launch(env)
    assert r.returncode == 1
    assert verdict(stub) == "fail"
    assert lines(stub, "selfcheck")
    assert not lines(stub, "train"), \
        "training must not start after a failed selfcheck"
    out = (stub / "tpudist_job" / "logs" / "tpudist-accept_1000.out")
    assert "on-card selfcheck failed" in out.read_text()


def test_selfcheck_runs_on_every_task_before_training(stub_env):
    env, stub = stub_env
    r = launch(env)
    assert r.returncode == 0, r.stdout + r.stderr
    log = calls(stub)
    checks = lines(stub, "selfcheck")
    assert len(checks) == 8
    assert sorted(int(re.search(r"rank=(\d+)", c).group(1))
                  for c in checks) == list(range(8))
    assert all("timeout 900" in ln for ln in log
               if ln.startswith("srun ") and "tpudist_torch.selfcheck" in ln)
    assert max(log.index(c) for c in checks) < min(
        log.index(t) for t in lines(stub, "train"))
    # SKIP_SELFCHECK=1 bypasses it
    (stub / "calls.log").unlink()
    r = launch(dict(env, SKIP_SELFCHECK="1"))
    assert r.returncode == 0 and not lines(stub, "selfcheck")


def test_sweep_gate_failure_exits_2(stub_env):
    env, stub = stub_env
    env.update(RUN_SWEEP="1", STUB_SWEEP_RC="1")
    r = launch(env)
    assert r.returncode == 2, r.stdout + r.stderr
    assert verdict(stub) == "success"              # training did pass
    assert verdict(stub, "job_status.txt.sweep") == "fail"


def test_sweep_ungateable_exits_3(stub_env):
    env, stub = stub_env
    env.update(RUN_SWEEP="1", STUB_SWEEP_RC="3")
    r = launch(env)
    assert r.returncode == 3, r.stdout + r.stderr
    assert verdict(stub) == "success"
    assert verdict(stub, "job_status.txt.sweep") == "ungateable"


def test_sweep_success_and_peak_override_forwarded(stub_env):
    env, stub = stub_env
    env.update(RUN_SWEEP="1", SWEEP_PEAK_GBPS="123.5", SWEEP_MIN_PCT="70")
    r = launch(env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert verdict(stub, "job_status.txt.sweep") == "success"
    sweeps = lines(stub, "bench.sweep")
    assert len(sweeps) == 8
    assert "--min-pct-peak 70 --peak-gbps 123.5" in sweeps[0]
    assert ("--kinds all_reduce,all_gather,reduce_scatter,all_to_all,"
            "ppermute") in sweeps[0]
    # no sweep without RUN_SWEEP
    (stub / "calls.log").unlink()
    env.pop("RUN_SWEEP")
    assert launch(env).returncode == 0
    assert not lines(stub, "bench.sweep")


def _subs(stub):
    return [ln for ln in calls(stub) if ln.startswith("sbatch ")]


def test_requeue_on_preemption_then_success(stub_env):
    """A preemption-shaped exit (137) with a budget is resubmitted with
    --resume auto and the next --requeue-attempt; the failed attempt's
    flight records are collected first."""
    env, stub = stub_env
    env.update(MAX_REQUEUES="2", REQUEUE_BACKOFF_S="0",
               STUB_TRAIN_FAIL_N="1", STUB_TRAIN_RC="137")
    r = launch(env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert verdict(stub) == "success"
    assert "VERDICT=preemption REQUEUE=1" in r.stdout, r.stdout
    subs = _subs(stub)
    assert len(subs) == 2
    assert "ATTEMPT=0,REQUEUE=1" in subs[0]
    assert "ATTEMPT=1,REQUEUE=1" in subs[1]
    trains = lines(stub, "train")
    assert len(trains) == 16
    assert all("--resume auto --requeue-attempt 0" in t
               for t in trains[:8])
    assert all("--resume auto --requeue-attempt 1" in t
               for t in trains[8:])
    assert (stub / "flightrec_artifacts" / "attempt0"
            / "heartbeat.worker0").exists()


def test_crash_is_not_requeued_even_with_budget(stub_env):
    env, stub = stub_env
    env.update(MAX_REQUEUES="3", REQUEUE_BACKOFF_S="0", STUB_TRAIN_RC="1")
    r = launch(env)
    assert r.returncode == 1
    assert verdict(stub) == "fail"
    assert "VERDICT=crash REQUEUE=0" in r.stdout, r.stdout
    assert len(_subs(stub)) == 1


def test_requeue_budget_exhausted_fails(stub_env):
    env, stub = stub_env
    env.update(MAX_REQUEUES="1", REQUEUE_BACKOFF_S="0",
               STUB_TRAIN_FAIL_N="5", STUB_TRAIN_RC="137")
    r = launch(env)
    assert r.returncode == 1
    assert verdict(stub) == "fail"
    assert "requeue budget exhausted" in r.stdout, r.stdout
    assert len(_subs(stub)) == 2                 # the first + 1 requeue


def test_no_requeue_by_default(stub_env):
    env, stub = stub_env
    env["STUB_TRAIN_RC"] = "137"
    r = launch(env)
    assert r.returncode == 1
    assert len(_subs(stub)) == 1
    assert "--requeue-attempt" not in lines(stub, "train")[0]


def test_attempts_log_one_record_an_attempt(stub_env):
    env, stub = stub_env
    env.update(MAX_REQUEUES="2", REQUEUE_BACKOFF_S="0",
               STUB_TRAIN_FAIL_N="1", STUB_TRAIN_RC="137",
               RUN_ID="r-gp-1")
    r = launch(env)
    assert r.returncode == 0, r.stdout + r.stderr
    recs = [json.loads(ln) for ln in (
        stub / "flightrec_artifacts" / "attempts.jsonl").read_text()
        .splitlines()]
    assert [a["attempt"] for a in recs] == [0, 1]
    assert recs[0]["rc"] == 137 and recs[0]["verdict"] == "preemption"
    assert recs[1]["rc"] == 0 and recs[1]["verdict"] == "success"
    for a in recs:
        assert a["run_id"] == "r-gp-1" and a["mode"] == "train"
        assert a["end_ts"] >= a["start_ts"]


def test_requeue_backoff_jitter_deterministic_and_bounded(stub_env):
    env, stub = stub_env
    env.update(MAX_REQUEUES="2", REQUEUE_BACKOFF_S="0.2",
               STUB_TRAIN_FAIL_N="1", STUB_TRAIN_RC="137",
               RUN_ID="jitterpin")
    r = launch(env)
    assert r.returncode == 0, r.stdout + r.stderr
    m = re.search(r"after ([0-9.]+)s backoff \+ ([0-9.]+)s jitter",
                  r.stdout)
    backoff, jitter = float(m.group(1)), float(m.group(2))
    assert backoff == 0.2
    h = int(subprocess.run(["cksum"], input=b"jitterpin:0",
                           capture_output=True).stdout.split()[0])
    assert abs(jitter - 0.2 * 0.25 * (h % 1000) / 1000) < 1e-3


def test_serve_mode(stub_env):
    """MODE=serve runs the serve CLI under the same plumbing, with its
    artifacts in OBS_DIR and the requeue resumed by --requeue-attempt
    alone."""
    env, stub = stub_env
    env.update(MODE="serve", MAX_REQUEUES="2", REQUEUE_BACKOFF_S="0",
               STUB_SERVE_FAIL_N="1", STUB_SERVE_RC="137")
    r = launch(env, "--requests", "8")
    assert r.returncode == 0, r.stdout + r.stderr
    assert verdict(stub) == "success"
    serves = lines(stub, "serve")
    assert len(serves) == 16 and not lines(stub, "train")
    obs = stub / "tpudist_job" / "obs"
    assert f"--save-dir {obs}/serve --bench-out {obs}/BENCH_SERVE.json" \
        in serves[0]
    assert "--requests 8" in serves[0]
    assert "--requeue-attempt 1" in serves[8]
    assert not any("--resume" in s for s in serves)


def test_bad_mode_rejected(stub_env):
    env, stub = stub_env
    r = launch(dict(env, MODE="infer"))
    assert r.returncode == 1
    assert "MODE must be train or serve" in r.stderr
    assert not (stub / "calls.log").exists()


def test_flight_records_collected_on_failure(stub_env):
    env, stub = stub_env
    env["STUB_TRAIN_RC"] = "1"
    r = launch(env)
    assert r.returncode == 1
    got = stub / "flightrec_artifacts" / "attempt0"
    assert {f"heartbeat.worker{i}" for i in range(8)} <= {
        p.name for p in got.iterdir()}
    assert (got / "job_status.txt.worker3").read_text() == "fail"
    assert (got / "tpudist-accept_1000.out").exists()


def test_live_env_and_run_id_reach_every_task(stub_env):
    env, stub = stub_env
    env.update(LIVE_PORT="9109", RUN_ID="r-live-1")
    r = launch(env)
    assert r.returncode == 0, r.stdout + r.stderr
    for t in lines(stub, "train"):
        assert "run_id=r-live-1 live=on live_port=9109 " \
               "endpoint=tcp://node0:9110]" in t
    assert (stub / "flightrec_artifacts" / "live_status.json").exists()
    # without LIVE_PORT the bus stays off, the run id still ships
    (stub / "calls.log").unlink()
    env.pop("LIVE_PORT")
    assert launch(env).returncode == 0
    t = lines(stub, "train")[0]
    assert "run_id=r-live-1 live= " in t


def test_container_image_through_pyxis(stub_env):
    env, stub = stub_env
    env.update(IMAGE="/shared/tpudist.sqsh", CONTAINER_MOUNTS="/data:/data")
    r = launch(env)
    assert r.returncode == 0, r.stdout + r.stderr
    job = stub / "tpudist_job"
    sruns = [ln for ln in calls(stub) if ln.startswith("srun ")]
    assert sruns and all(
        "--container-image=/shared/tpudist.sqsh" in ln
        and f"--container-mounts={job}:{job},/data:/data" in ln
        for ln in sruns)


def test_real_two_task_cpu_run(tmp_path):
    """The batch script end to end for real: two gloo tasks of the MLP
    for one epoch through the srun stub, verdict success."""
    env, stub = _stubs(tmp_path, scripted=False)
    env.update(TPUDIST_PLATFORM="cpu", SKIP_SELFCHECK="1", NNODES="1",
               GPUS_PER_NODE="2", STUB_NODES="1", STUB_GPUS="2",
               OMP_NUM_THREADS="1", TIMEOUT_S="240",
               STUB_HOSTNAME="localhost",
               PYTHONPATH=str(REPO), MASTER_PORT=str(_port()))
    r = launch(env, "--epochs", "1", "--n-samples", "512", timeout=300)
    out = stub / "tpudist_job" / "logs" / "tpudist-accept_1000.out"
    assert r.returncode == 0, r.stdout + r.stderr + out.read_text()
    assert verdict(stub) == "success"
    obs = stub / "tpudist_job" / "obs"
    assert [(obs / f"job_status.txt.worker{i}").read_text()
            for i in (0, 1)] == ["success", "success"]
    log = out.read_text()
    assert "Epoch  1 finished. Avg loss:" in log
    assert "Training completed." in log
    assert "2 cpu device(s), 2 process(es) (gloo)" in log
    recs = [json.loads(ln) for ln in (
        stub / "flightrec_artifacts" / "metrics.jsonl").read_text()
        .splitlines()]
    # the MLP launches no kernel; the record names all six
    (timing,) = [x for x in recs if x["kind"] == "timing"]
    assert timing["kernel_launches"] == dict.fromkeys(
        ("flash_attention_fwd", "flash_attention_bwd_dq",
         "flash_attention_bwd_dkv", "flash_attention_bwd_dqkv",
         "fused_xent_fwd", "fused_xent_bwd"), 0)


def _port():
    sys.path.insert(0, str(REPO / "tests"))
    from _torch_ranks import free_port
    return free_port()
