#!/bin/bash
# GPT-2-medium with tensor parallelism, and MoE GPT-2-medium with expert
# parallelism, on four cards of one host (examples/train_torch_tp.py),
# on the same global batch of 8 rows as one card, at dropout 0: first
# the one-card references (dense, and MoE with 8 experts), then model 4,
# model 2 x data 2, pipe 2 x model 2, expert 4 and expert 2 x model 2,
# each 3 + 5 steps and 2 steps under torch.profiler; the 4-card runs'
# first 3 losses are held to the one-card run's of the same model.  Run
# from the root of a checkout:
#
#     bash examples/train_torch_tp_4card.sh
#
# REFERENCE (optional): a JSON-lines file of earlier one-card runs of
# this script; given, its lines stand in for the one-card runs.  The JSON
# lines go to chiprun_out/tp4card.jsonl.
set -u
out=chiprun_out/tp4card.jsonl
python3 -c "from deepspeed_tpu_torch.ops import op_builder; op_builder.build()" || exit 1
nvidia-smi --query-gpu=index,name,power.limit --format=csv,noheader
python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda, torch.cuda.nccl.version())'
mkdir -p chiprun_out
rm -f "$out"
if [ $# -ge 1 ]; then grep '"world": 1,' "$1" > "$out"; fi
rc=0
run() {
    local n=$1; shift
    timeout 420 torchrun --nproc-per-node "$n" examples/train_torch_tp.py \
        --reference "$out" --out "$out" "$@" || rc=1
}
if [ $# -lt 1 ]; then
    run 1
    run 1 --experts 8
fi
run 4 --model 4
run 4 --model 2 --data 2
run 4 --pipe 2 --model 2
run 4 --experts 8 --expert-axis 4
run 4 --experts 8 --expert-axis 2 --model 2
exit $rc
