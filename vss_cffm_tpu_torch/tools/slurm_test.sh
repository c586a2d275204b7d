#!/usr/bin/env bash
# Slurm evaluation launcher of the port: one task a GPU, each task one rank of
# the test CLI (vss_cffm_tpu_torch/tools/test.py --distributed), which
# evaluates its shard and sums the confusion matrices over the ranks. The
# port's counterpart of the JAX package's tools/slurm_test.sh and of the
# reference's tools/slurm_test.sh.
#
#   vss_cffm_tpu_torch/tools/slurm_test.sh PARTITION CONFIG CHECKPOINT [test args...]
#
# GPUS, GPUS_PER_NODE, CPUS_PER_TASK, PORT, JOB_NAME, SRUN_ARGS and PYTHON as
# in slurm_train.sh: each node's cards requested with --gres, task
# SLURM_LOCALID on card cuda:SLURM_LOCALID, the coordinator on the first node.

set -euo pipefail

PARTITION=$1
CONFIG=$2
CHECKPOINT=$3
shift 3
JOB_NAME=${JOB_NAME:-vss_cffm_eval}
GPUS=${GPUS:-8}
GPUS_PER_NODE=${GPUS_PER_NODE:-$(( GPUS < 8 ? GPUS : 8 ))}
CPUS_PER_TASK=${CPUS_PER_TASK:-5}
PORT=${PORT:-29644}
PYTHON=${PYTHON:-python}
SRUN_ARGS=${SRUN_ARGS:-}
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"

if (( GPUS % GPUS_PER_NODE )); then
    echo "slurm_test.sh: GPUS=$GPUS is not a multiple of GPUS_PER_NODE=$GPUS_PER_NODE" >&2
    exit 2
fi

# each task: "$0" is the interpreter, "$@" the config, the checkpoint and the
# CLI's arguments
PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}" \
srun -p "$PARTITION" \
    --job-name="$JOB_NAME" \
    --ntasks="$GPUS" \
    --ntasks-per-node="$GPUS_PER_NODE" \
    --gres=gpu:"$GPUS_PER_NODE" \
    --cpus-per-task="$CPUS_PER_TASK" \
    --kill-on-bad-exit=1 \
    $SRUN_ARGS \
    bash -c "exec \"\$0\" -u -m vss_cffm_tpu_torch.tools.test \"\$@\" --distributed \
        --coordinator \"\$(scontrol show hostnames \"\$SLURM_JOB_NODELIST\" | head -n1):$PORT\" \
        --num-processes \"\$SLURM_NTASKS\" --process-id \"\$SLURM_PROCID\"" \
    "$PYTHON" "$CONFIG" "$CHECKPOINT" "$@"
