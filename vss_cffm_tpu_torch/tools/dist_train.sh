#!/usr/bin/env bash
# Train with NPROCS processes on this host, one rank each, through torchrun
# (python -m torch.distributed.run): the port's counterpart of the JAX
# package's tools/dist_train.sh and of the reference's (torch.distributed.launch).
# cfg.data.batch_size is the global batch; each rank loads its share.
# NPROCS <= 1 runs the CLI plainly, in one process.
#
#   vss_cffm_tpu_torch/tools/dist_train.sh CONFIG NPROCS [train args...]
#   PORT=29611 vss_cffm_tpu_torch/tools/dist_train.sh vss_cffm_tpu_torch/configs/cffm_b1_vspw_160k.py 4 --work-dir /tmp/w
#
# NCCL with one card a rank by default; "--device cuda:0 --backend gloo" puts
# every rank on card 0, "--device cpu" runs the ranks on the CPU (gloo).
# PYTHON names the interpreter (default: python).

set -euo pipefail

CONFIG=$1
NPROCS=$2
shift 2
PORT=${PORT:-29611}
PYTHON=${PYTHON:-python}
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"

if [ "$NPROCS" -le 1 ]; then
    exec "$PYTHON" -m vss_cffm_tpu_torch.tools.train "$CONFIG" "$@"
fi
exec "$PYTHON" -m torch.distributed.run --nproc_per_node "$NPROCS" --master_port "$PORT" \
    -m vss_cffm_tpu_torch.tools.train "$CONFIG" --distributed "$@"
