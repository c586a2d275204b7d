#!/usr/bin/env bash
# Slurm training launcher of the port: one task a GPU, each task one rank of
# the train CLI (vss_cffm_tpu_torch/tools/train.py --distributed) with the
# coordinator flags from Slurm's environment. The port's counterpart of the
# JAX package's tools/slurm_train.sh (one task a TPU host) and of the
# reference's tools/slurm_train.sh (srun + --launcher=slurm).
#
#   vss_cffm_tpu_torch/tools/slurm_train.sh PARTITION CONFIG [train args...]
#   GPUS=16 GPUS_PER_NODE=8 vss_cffm_tpu_torch/tools/slurm_train.sh gpu \
#       vss_cffm_tpu_torch/configs/cffm_b1_vspw_160k.py --work-dir work_dirs/b1
#
# GPUS tasks in all (default 8), GPUS_PER_NODE a node (default GPUS, at most
# 8), each node's cards requested with --gres and visible to all its tasks:
# task SLURM_LOCALID takes card cuda:SLURM_LOCALID (parallel/mesh.py reads the
# local rank from SLURM_LOCALID under the coordinator flags). The coordinator
# is the first node of the allocation, port PORT. NCCL by default.
# CPUS_PER_TASK, JOB_NAME, SRUN_ARGS (more srun flags) and PYTHON (the
# interpreter) as named.

set -euo pipefail

PARTITION=$1
CONFIG=$2
shift 2
JOB_NAME=${JOB_NAME:-vss_cffm}
GPUS=${GPUS:-8}
GPUS_PER_NODE=${GPUS_PER_NODE:-$(( GPUS < 8 ? GPUS : 8 ))}
CPUS_PER_TASK=${CPUS_PER_TASK:-5}
PORT=${PORT:-29633}
PYTHON=${PYTHON:-python}
SRUN_ARGS=${SRUN_ARGS:-}
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"

if (( GPUS % GPUS_PER_NODE )); then
    echo "slurm_train.sh: GPUS=$GPUS is not a multiple of GPUS_PER_NODE=$GPUS_PER_NODE" >&2
    exit 2
fi

# each task: "$0" is the interpreter, "$@" the config and the CLI's arguments
PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}" \
srun -p "$PARTITION" \
    --job-name="$JOB_NAME" \
    --ntasks="$GPUS" \
    --ntasks-per-node="$GPUS_PER_NODE" \
    --gres=gpu:"$GPUS_PER_NODE" \
    --cpus-per-task="$CPUS_PER_TASK" \
    --kill-on-bad-exit=1 \
    $SRUN_ARGS \
    bash -c "exec \"\$0\" -u -m vss_cffm_tpu_torch.tools.train \"\$@\" --distributed \
        --coordinator \"\$(scontrol show hostnames \"\$SLURM_JOB_NODELIST\" | head -n1):$PORT\" \
        --num-processes \"\$SLURM_NTASKS\" --process-id \"\$SLURM_PROCID\"" \
    "$PYTHON" "$CONFIG" "$@"
