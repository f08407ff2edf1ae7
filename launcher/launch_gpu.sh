#!/usr/bin/env bash
# GPU-cluster launcher for the PyTorch/CUDA port: one acceptance job on a
# SLURM cluster, in the reference's shape (its CI's test-on-slurm job:
# probe the cluster, submit, poll, read job_status.txt; SURVEY.md §2.5).
# It runs where CI reaches the cluster (the login host, over SSH) and
# submits launcher/slurm_gpu.sbatch, which runs the on-card selfcheck and
# the workload on every card of the allocation.
#
#   1. probe: `scontrol show nodes` (each node's `gres/gpu=N` of CfgTRES,
#      reference ci:115-119); a request for more nodes or cards than the
#      cluster has writes fail and exits 1 before anything is submitted;
#   2. submit: sbatch --nodes N --gres gpu:G --ntasks-per-node G
#      --export=ALL,... launcher/slurm_gpu.sbatch [workload flags], the
#      shape as options (the reference rewrote placeholders with sed);
#   3. poll: `squeue -j ID` every POLL_S up to TIMEOUT_S, then scancel and
#      exit 124;
#   4. verdict: the job's job_status.txt into VERDICT_PATH;
#   5. requeue: a failed attempt's flight records are collected and the
#      port's requeue policy (python3 -m tpudist_torch.elastic.policy,
#      standard library only, run here) decides: a preemption-shaped exit
#      resubmits with --resume auto, a crash stops (MAX_REQUEUES);
#   6. the sweep gate (RUN_SWEEP=1): the job ran
#      python3 -m tpudist_torch.bench.sweep after training; its exit code
#      becomes ${VERDICT_PATH}.sweep and this script's exit code.
#
# Usage (from a directory on the cluster's shared filesystem):
#   NNODES=2 GPUS_PER_NODE=8 ./launcher/launch_gpu.sh [tpudist_torch.train flags]
#
# Optional env:
#   NNODES, GPUS_PER_NODE  the job's shape (default: the probe's, every node
#                       with the most cards any node has)
#   MODE                train (default) or serve (python3 -m
#                       tpudist_torch.serve; its flags ride the same way);
#                       serve failures take the same requeue loop, resumed
#                       by --requeue-attempt alone
#   IMAGE               a container image for pyxis (an enroot .sqsh path
#                       or a registry tag); unset, the tasks run this
#                       repository's package with bare python3
#   CONTAINER_MOUNTS    more pyxis mounts (src:dst[,src:dst])
#   JOB_DIR             the job's directory on the shared filesystem
#                       (default ./tpudist_job): job_status.txt, logs/,
#                       the checkpoints
#   OBS_DIR             heartbeats, flight records, traces and verdict
#                       files (default $JOB_DIR/obs); collected into
#                       ./flightrec_artifacts/attempt<i>/ after a failed
#                       attempt; after a success its pod_trace.json,
#                       metrics.jsonl (and BENCH_SERVE.json) are copied to
#                       ./flightrec_artifacts/
#   VERDICT_PATH        where the verdict lands (default ./job_status.txt)
#   TIMEOUT_S           the queue + run limit of an attempt, and the
#                       workload's own (default 1800)
#   POLL_S              the squeue interval (default 10)
#   RUN_ID              the correlation id every artifact carries
#                       (generated here when unset, the same for every
#                       attempt)
#   LIVE_PORT           turn on the live telemetry bus on every task (the
#                       Prometheus exporter on this port of the first
#                       node); live_status.json and alerts.jsonl are copied
#                       out after a success
#   SKIP_SELFCHECK=1    bypass the pre-training selfcheck
#   ATTEMPTS_LOG        one record per attempt (default
#                       flightrec_artifacts/attempts.jsonl)
#   MAX_REQUEUES        the requeue budget (default 0 = off)
#   REQUEUE_BACKOFF_S   its backoff base (default 10; doubles an attempt,
#                       capped at 300) plus a deterministic jitter of up to
#                       REQUEUE_JITTER_FRAC (0.25) of it, from RUN_ID and
#                       the attempt
#   RUN_SWEEP=1         run the gated collective sweep after training
#   SWEEP_MIN_PCT       its gate (default 90)
#   SWEEP_PEAK_GBPS     the bus peak to gate against (--peak-gbps);
#                       without it the sweep gates on the card's own query
#                       or is ungateable
#
# Exit codes: 0 ok; 1 workload, probe or selfcheck failure; 2 workload ok
# but the sweep gate failed; 3 sweep ungateable; 124 queue + run timeout.

set -euo pipefail

MODE="${MODE:-train}"
case "$MODE" in train|serve) ;; *)
  echo "MODE must be train or serve, got '$MODE'" >&2; exit 1 ;;
esac
SCRIPT_DIR="$(cd "$(dirname "$0")" && pwd)"
REPO_ROOT="$(cd "$SCRIPT_DIR/.." && pwd)"
JOB_DIR="${JOB_DIR:-$PWD/tpudist_job}"
OBS_DIR="${OBS_DIR:-$JOB_DIR/obs}"
VERDICT_PATH="${VERDICT_PATH:-job_status.txt}"
SWEEP_VERDICT_PATH="${SWEEP_VERDICT_PATH:-${VERDICT_PATH}.sweep}"
TIMEOUT_S="${TIMEOUT_S:-1800}"
POLL_S="${POLL_S:-10}"
SWEEP_MIN_PCT="${SWEEP_MIN_PCT:-90}"
MAX_REQUEUES="${MAX_REQUEUES:-0}"
REQUEUE_BACKOFF_S="${REQUEUE_BACKOFF_S:-10}"
REQUEUE_JITTER_FRAC="${REQUEUE_JITTER_FRAC:-0.25}"
RUN_ID="${RUN_ID:-$(date +%Y%m%d%H%M%S)-$$}"
ATTEMPTS_LOG="${ATTEMPTS_LOG:-flightrec_artifacts/attempts.jsonl}"
# one launch = one ledger
rm -f "$ATTEMPTS_LOG" 2>/dev/null || true

verdict() {  # verdict <path> <word>
  mkdir -p "$(dirname "$1")"
  echo -n "$2" > "$1"
}

jitter_s() {  # jitter_s <backoff_s> <attempt> -> seconds in [0, frac*backoff)
  local h
  h=$(printf '%s:%s' "$RUN_ID" "$2" | cksum | cut -d' ' -f1)
  awk -v b="$1" -v h="$h" -v f="$REQUEUE_JITTER_FRAC" \
    'BEGIN{printf "%.3f", b * f * (h % 1000) / 1000}'
}

append_attempt() {  # append_attempt <attempt> <start> <end> <rc> <verdict>
  mkdir -p "$(dirname "$ATTEMPTS_LOG")" 2>/dev/null || true
  printf '{"kind":"attempt","run_id":"%s","mode":"%s","attempt":%d,"start_ts":%d,"end_ts":%d,"rc":%d,"verdict":"%s"}\n' \
    "$RUN_ID" "$MODE" "$1" "$2" "$3" "$4" "$5" >> "$ATTEMPTS_LOG" || true
}

# ---- 1. probe the cluster (reference ci:115-119) ---------------------------
# one line a node: its gres/gpu count (0 without one)
PROBE=$(scontrol show nodes 2>/dev/null | awk '
  /^NodeName=/ { if (n) print g; n++; g = 0 }
  /CfgTRES=/ { if (match($0, /gres\/gpu=[0-9]+/))
                 g = substr($0, RSTART + 9, RLENGTH - 9) }
  END { if (n) print g }') || true
if [ -z "$PROBE" ]; then
  echo "probe failed: scontrol show nodes listed no node"
  verdict "$VERDICT_PATH" fail
  exit 1
fi
MOST=$(printf '%s\n' "$PROBE" | sort -n | tail -n 1)
GPUS_PER_NODE="${GPUS_PER_NODE:-$MOST}"
FIT=$(printf '%s\n' "$PROBE" | awk -v g="$GPUS_PER_NODE" '$1 >= g' | wc -l)
NNODES="${NNODES:-$FIT}"
echo "probe: $(printf '%s\n' "$PROBE" | wc -l) node(s), gres/gpu" \
     "$(printf '%s\n' "$PROBE" | paste -sd, -); $FIT node(s) with" \
     "$GPUS_PER_NODE card(s); request $NNODES x $GPUS_PER_NODE"
if [ "$GPUS_PER_NODE" -lt 1 ] || [ "$NNODES" -lt 1 ] \
    || [ "$NNODES" -gt "$FIT" ]; then
  echo "❌ probe: the cluster has $FIT node(s) with $GPUS_PER_NODE" \
       "card(s), the job asks for $NNODES: not submitted"
  verdict "$VERDICT_PATH" fail
  exit 1
fi

# ---- 2-4. submit, poll, read the verdict -----------------------------------
submit() {  # submit <attempt> <workload flags...>: sets JOB_ID
  local attempt="$1"; shift
  local requeue=0 out
  [ "$MAX_REQUEUES" -gt 0 ] && requeue=1
  mkdir -p "$JOB_DIR/logs"
  rm -f "$JOB_DIR/job_status.txt" "$JOB_DIR/job_rc.txt" \
    "$JOB_DIR/sweep_rc.txt"
  if ! out=$(sbatch --parsable --job-name tpudist-accept \
    --nodes "$NNODES" --gres "gpu:$GPUS_PER_NODE" \
    --ntasks-per-node "$GPUS_PER_NODE" --chdir "$JOB_DIR" \
    --output "$JOB_DIR/logs/tpudist-accept_%j.out" \
    --error "$JOB_DIR/logs/tpudist-accept_%j.err" \
    --export="ALL,MODE=$MODE,RUN_ID=$RUN_ID,ATTEMPT=$attempt,REQUEUE=$requeue,JOB_DIR=$JOB_DIR,OBS_DIR=$OBS_DIR,TIMEOUT_S=$TIMEOUT_S,SWEEP_MIN_PCT=$SWEEP_MIN_PCT,TPUDIST_REPO=$REPO_ROOT" \
    "$SCRIPT_DIR/slurm_gpu.sbatch" "$@"); then
    echo "❌ sbatch refused the job: not submitted"
    verdict "$VERDICT_PATH" fail
    exit 1
  fi
  JOB_ID="${out%%;*}"
  echo "submitted job $JOB_ID (attempt $attempt)"
}

wait_job() {  # poll until the job leaves the queue (reference ci:130-150)
  local deadline=$((SECONDS + TIMEOUT_S)) state
  while :; do
    state=$(squeue -j "$JOB_ID" -h -o %T 2>/dev/null || true)
    [ -z "$state" ] && return 0
    echo "job $JOB_ID: $state"
    if (( SECONDS >= deadline )); then
      echo "❌ job $JOB_ID still $state after ${TIMEOUT_S}s: cancelled"
      scancel "$JOB_ID" || true
      verdict "$VERDICT_PATH" fail
      exit 124
    fi
    sleep "$POLL_S"
  done
}

collect_flight_records() {  # collect_flight_records <dest-dir>
  # the failed attempt's evidence, before the next attempt can overwrite
  # it: heartbeats, flight records, verdict files (the policy's
  # vanished-worker check reads them), logs
  local dest="$1"
  echo "collecting flight-recorder artifacts from $OBS_DIR into $dest ..."
  mkdir -p "$dest"
  cp -r "$OBS_DIR"/. "$dest"/ 2>/dev/null || true
  cp "$JOB_DIR"/logs/*"_$JOB_ID".* "$dest"/ 2>/dev/null || true
  ls -l "$dest"/ 2>/dev/null || true
}

attempt=0
while :; do
  ATT_START=$(date +%s)
  submit "$attempt" "$@"
  wait_job
  ATT_END=$(date +%s)
  STATUS=$(cat "$JOB_DIR/job_status.txt" 2>/dev/null || true)
  if [ "$STATUS" = "success" ]; then
    append_attempt "$attempt" "$ATT_START" "$ATT_END" 0 success
    break
  fi
  # a job that left the queue without its exit code was killed from
  # outside its script: the preemption shape
  RC=$(cat "$JOB_DIR/job_rc.txt" 2>/dev/null || echo 137)
  [ "$RC" -eq 0 ] && RC=1
  echo "❌ job $JOB_ID failed (verdict '${STATUS:-none}', rc=$RC)"
  ATTEMPT_DIR="flightrec_artifacts/attempt$attempt"
  collect_flight_records "$ATTEMPT_DIR"
  rm -f "$OBS_DIR"/flightrec.worker* "$OBS_DIR"/job_status.txt* || true
  set +e
  DECISION=$(PYTHONPATH="$REPO_ROOT${PYTHONPATH:+:$PYTHONPATH}" \
    python3 -m tpudist_torch.elastic.policy --rc "$RC" \
    --attempt "$attempt" --max-requeues "$MAX_REQUEUES" \
    --flightrec-dir "$ATTEMPT_DIR" --backoff-base-s "$REQUEUE_BACKOFF_S")
  POLICY_RC=$?
  set -e
  echo "requeue policy: ${DECISION:-<policy unavailable>}"
  ATT_VERDICT=$(printf '%s\n' "$DECISION" \
    | sed -n 's/.*VERDICT=\([a-z_]*\).*/\1/p')
  append_attempt "$attempt" "$ATT_START" "$ATT_END" "$RC" \
    "${ATT_VERDICT:-unknown}"
  if [ "$POLICY_RC" -eq 0 ]; then
    BACKOFF=$(printf '%s\n' "$DECISION" \
      | sed -n 's/.*BACKOFF_S=\([0-9.]*\).*/\1/p')
    BACKOFF="${BACKOFF:-$REQUEUE_BACKOFF_S}"
    JITTER=$(jitter_s "$BACKOFF" "$attempt")
    attempt=$((attempt + 1))
    echo "⟳ requeue attempt $attempt/$MAX_REQUEUES after ${BACKOFF}s" \
         "backoff + ${JITTER}s jitter (--resume auto)"
    sleep "$(awk -v a="$BACKOFF" -v j="$JITTER" \
      'BEGIN{printf "%.3f", a + j}')"
    continue
  fi
  verdict "$VERDICT_PATH" fail
  # 1 whatever the workload's code: 2, 3 and 124 mean other things here
  exit 1
done
echo "✅ distributed GPU job succeeded"
verdict "$VERDICT_PATH" success

# ---- the run's artifacts (best-effort: they never repaint a green run) -----
mkdir -p flightrec_artifacts
if [ "$MODE" = "serve" ]; then
  cp "$OBS_DIR/serve/metrics.jsonl" "$OBS_DIR/BENCH_SERVE.json" \
    flightrec_artifacts/ 2>/dev/null || true
else
  cp "$JOB_DIR/ckpt/metrics.jsonl" flightrec_artifacts/ 2>/dev/null || true
fi
cp "$OBS_DIR/pod_trace.json" flightrec_artifacts/ 2>/dev/null || true
if [ -n "${LIVE_PORT:-}" ]; then
  for f in live_status.json alerts.jsonl; do
    cp "$OBS_DIR/$f" flightrec_artifacts/ 2>/dev/null || true
  done
fi

# ---- 6. the sweep gate -----------------------------------------------------
if [ "${RUN_SWEEP:-0}" = "1" ]; then
  cp "$OBS_DIR/sweep.jsonl" sweep.jsonl 2>/dev/null || true
  cp "$OBS_DIR/BENCH_COLLECTIVES.json" BENCH_COLLECTIVES.json \
    2>/dev/null || true
  SWEEP_RC=$(cat "$JOB_DIR/sweep_rc.txt" 2>/dev/null || echo missing)
  case "$SWEEP_RC" in
    0)
      echo "✅ collective sweep passed the ${SWEEP_MIN_PCT}% gate"
      verdict "$SWEEP_VERDICT_PATH" success ;;
    3)
      echo "⚠️ collective sweep ungateable (no bus peak; set SWEEP_PEAK_GBPS)"
      verdict "$SWEEP_VERDICT_PATH" ungateable
      exit 3 ;;
    *)
      echo "❌ collective sweep below ${SWEEP_MIN_PCT}% of its peak" \
           "(rc=$SWEEP_RC)"
      verdict "$SWEEP_VERDICT_PATH" fail
      exit 2 ;;
  esac
fi
exit 0
