#!/usr/bin/env bash
# Evaluate with NPROCS processes on this host, one rank each, through torchrun
# (python -m torch.distributed.run): the port's counterpart of the JAX
# package's tools/dist_test.sh and of the reference's. Each rank evaluates a
# shard (frames, or whole videos with --streaming) and the confusion
# matrices are summed. NPROCS <= 1 runs the CLI plainly, in one process.
#
#   vss_cffm_tpu_torch/tools/dist_test.sh CONFIG CHECKPOINT NPROCS [test args...]
#
# Devices and backends as in dist_train.sh. PYTHON names the interpreter.

set -euo pipefail

CONFIG=$1
CHECKPOINT=$2
NPROCS=$3
shift 3
PORT=${PORT:-29622}
PYTHON=${PYTHON:-python}
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"

if [ "$NPROCS" -le 1 ]; then
    exec "$PYTHON" -m vss_cffm_tpu_torch.tools.test "$CONFIG" "$CHECKPOINT" "$@"
fi
exec "$PYTHON" -m torch.distributed.run --nproc_per_node "$NPROCS" --master_port "$PORT" \
    -m vss_cffm_tpu_torch.tools.test "$CONFIG" "$CHECKPOINT" --distributed "$@"
