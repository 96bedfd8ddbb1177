#!/bin/bash
# GPT-2-medium with sequence parallelism (ring attention) on four cards
# of one host (examples/train_torch_ring.py), at seq 4096
# (max_position_embeddings 4096), micro-batch 2 a data rank, dropout 0,
# Lamb, ZeRO-2, bf16, 3 + 5 steps and 2 steps under torch.profiler:
# first the one-card dense references on the same global batches (2
# rows; 4 rows and 1 row at seq 16384 under remat, whose losses are the
# run's without it), then seq 4, seq 2 x data
# 2 and seq 2 x model 2 (their first 3 losses held to the one-card run's
# within 2e-3), and seq 4 at seq 16384, micro-batch 1.  Run from the
# root of a checkout:
#
#     bash examples/train_torch_ring_4card.sh
#
# REFERENCE (optional): a JSON-lines file of earlier one-card runs of
# this script; given, its lines stand in for the one-card runs.  The JSON
# lines go to chiprun_out/ring4card.jsonl.
set -u
out=chiprun_out/ring4card.jsonl
python3 -c "from deepspeed_tpu_torch.ops import op_builder; op_builder.build()" || exit 1
nvidia-smi --query-gpu=index,name,power.limit --format=csv,noheader
python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda, torch.cuda.nccl.version())'
mkdir -p chiprun_out
rm -f "$out"
if [ $# -ge 1 ]; then grep '"world": 1,' "$1" > "$out"; fi
rc=0
run() {
    local n=$1; shift
    timeout 420 torchrun --nproc-per-node "$n" examples/train_torch_ring.py \
        --reference "$out" --out "$out" "$@" || rc=1
}
if [ $# -lt 1 ]; then
    run 1 --dense
    run 1 --dense --remat --micro-batch 4
    run 1 --dense --remat --seq-len 16384 --micro-batch 1
fi
run 4 --seq 4
run 4 --seq 2 --data 2
run 4 --seq 2 --model 2
run 4 --seq 4 --seq-len 16384 --micro-batch 1
exit $rc
