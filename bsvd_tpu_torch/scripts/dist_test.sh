#!/usr/bin/env bash
# Evaluation on several cards, one process each (counterpart of the JAX
# repo's scripts/dist_test.sh; see dist_train.sh):
#
#   bash bsvd_tpu_torch/scripts/dist_test.sh <nproc> <yml> [args ...]
set -e
NPROC=${1:-1}
OPT=$2
shift 2 || true
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
python -m torch.distributed.run --nproc_per_node="$NPROC" \
    --master_addr=127.0.0.1 --master_port="${PORT:-4321}" \
    -m bsvd_tpu_torch.test -opt "$OPT" --launcher pytorch \
    --force_yml num_gpu="$NPROC" "$@"
