#!/bin/bash
# What the model and pipe axes compose with on four cards of one host
# (examples/train_torch_tp.py), each on the same global batch as one
# card, at dropout 0: block-sparse GPT-2-medium at seq 4096 (a layout
# per group of heads) on model 2 x data 2, BERT-large under OneBitAdam
# (freeze 2) on data 2 x model 2, and GPT-2-medium under ZeRO-3 and
# under OneBitAdam on pipe 2 x data 2; each 3 + 5 steps and 2 steps under
# torch.profiler, the first 3 losses held to the one-card run's of the
# same model and optimizer (OneBitAdam's first 3 are its dense warmup and
# the first loss after it).  Run from the root of a checkout:
#
#     bash examples/train_torch_a18_4card.sh [REFERENCE]
#
# REFERENCE: a JSON-lines file of this script's one-card runs (run them
# on one card with `bash examples/train_torch_a18_4card.sh --one-card`);
# without it the one-card runs come first here.  The JSON lines go to
# chiprun_out/a18_4card.jsonl (the one-card runs alone to
# chiprun_out/a18_1card.jsonl).
set -u
python3 -c "from deepspeed_tpu_torch.ops import op_builder; op_builder.build()" || exit 1
nvidia-smi --query-gpu=index,name,power.limit --format=csv,noheader
python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda, torch.cuda.nccl.version())'
mkdir -p chiprun_out
rc=0
run() {
    local out=$1 n=$2; shift 2
    timeout 420 torchrun --nproc-per-node "$n" examples/train_torch_tp.py \
        --reference "$out" --out "$out" "$@" || rc=1
}
one_card() {
    run "$1" 1 --sparse
    run "$1" 1 --bert --optimizer onebit
    run "$1" 1
    run "$1" 1 --optimizer onebit
}
if [ "${1:-}" = "--one-card" ]; then
    out=chiprun_out/a18_1card.jsonl
    rm -f "$out"
    one_card "$out"
    exit $rc
fi
out=chiprun_out/a18_4card.jsonl
rm -f "$out"
if [ $# -ge 1 ]; then grep '"world": 1,' "$1" > "$out"; else one_card "$out"; fi
run "$out" 4 --sparse --model 2 --data 2
run "$out" 4 --bert --optimizer onebit --data 2 --model 2
run "$out" 4 --pipe 2 --data 2 --zero 3
run "$out" 4 --pipe 2 --data 2 --optimizer onebit
exit $rc
