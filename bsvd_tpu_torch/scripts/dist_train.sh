#!/usr/bin/env bash
# Training on several cards, one process each (counterpart of the JAX
# repo's scripts/dist_train.sh, BasicSR's):
#
#   bash bsvd_tpu_torch/scripts/dist_train.sh <nproc> <yml> [args ...]
#
# runs `python -m bsvd_tpu_torch.train -opt <yml> --launcher pytorch` under
# torchrun with <nproc> processes on this host (NCCL on the cards, gloo with
# `--device cpu`), num_gpu set to <nproc> (the world size). Further arguments
# go to the train command. PORT (default 4321) is the rendezvous port.
set -e
NPROC=${1:-1}
OPT=$2
shift 2 || true
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
python -m torch.distributed.run --nproc_per_node="$NPROC" \
    --master_addr=127.0.0.1 --master_port="${PORT:-4321}" \
    -m bsvd_tpu_torch.train -opt "$OPT" --launcher pytorch \
    --force_yml num_gpu="$NPROC" "$@"
