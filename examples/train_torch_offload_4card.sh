#!/bin/bash
# ZeRO-Offload above one rank on four cards of one host
# (examples/train_torch_offload.py), each row on the same global batch as
# one card, at dropout 0: (a) GPT-2-large with fp32 host state at data 4,
# (b) the same under DeepSpeedCPUAdam (with the host kernel's team split
# over the ranks, then inherited from torchrun and every CPU in each
# rank), (c) GPT-2-large on pipe 2 x data 2, (d) GPT-2-xl at its 48
# layers with offload_gradients at data 4; each 3 + 2 steps (the thread
# variants 1 + 2), the first 3 losses held to the one-card run's of the
# same model and optimizer ((c) to (a)'s).  Run from the root of a
# checkout:
#
#     bash examples/train_torch_offload_4card.sh [REFERENCE]
#
# REFERENCE: a JSON-lines file of this script's one-card runs (run them
# on one card with `bash examples/train_torch_offload_4card.sh
# --one-card`); without it the one-card runs come first here.  ROWS
# (default abcd) names the rows to run.  Rows (a) and (d) end with a
# checkpoint's gather (--save-peak: its peak card memory beside the
# steps').  The JSON lines go to chiprun_out/offload_4card.jsonl (the
# one-card runs alone to chiprun_out/offload_1card.jsonl).
#
#     bash examples/train_torch_offload_4card.sh --data-one
#
# runs row (a)'s model on one card at {data: 1} and without a mesh,
# alternating (mesh, none, none, mesh; 1 + 4 steps each), into
# chiprun_out/offload_data1.jsonl.
set -u
ROWS=${ROWS:-abcd}
python3 -c "from deepspeed_tpu_torch.ops import op_builder; op_builder.build([*op_builder.SOURCES, *op_builder.HOST_SOURCES])" || exit 1
nvidia-smi --query-gpu=index,name,power.limit --format=csv,noheader
python3 -c 'import os, sys, torch; print(sys.version, torch.__version__, torch.version.cuda, torch.cuda.nccl.version(), "cpus", len(os.sched_getaffinity(0)))'
mkdir -p chiprun_out
rc=0
run() {
    local out=$1 n=$2; shift 2
    timeout 900 torchrun --nproc-per-node "$n" examples/train_torch_offload.py \
        --reference "$out" --out "$out" "$@" || rc=1
}
one_card() {
    run "$1" 1
    run "$1" 1 --optimizer cpu_adam
    run "$1" 1 --xl
}
if [ "${1:-}" = "--data-one" ]; then
    out=chiprun_out/offload_data1.jsonl
    rm -f "$out"
    for mesh in "" --no-mesh --no-mesh ""; do
        run "$out" 1 --steps 1 --timed 4 $mesh
    done
    exit $rc
fi
if [ "${1:-}" = "--one-card" ]; then
    out=chiprun_out/offload_1card.jsonl
    rm -f "$out"
    one_card "$out"
    exit $rc
fi
out=chiprun_out/offload_4card.jsonl
rm -f "$out"
if [ $# -ge 1 ]; then grep '"world": 1,' "$1" > "$out"; else one_card "$out"; fi
case $ROWS in *a*) run "$out" 4 --data 4 --save-peak;; esac
case $ROWS in *b*)
    run "$out" 4 --data 4 --optimizer cpu_adam
    run "$out" 4 --data 4 --optimizer cpu_adam --threads inherit --steps 1
    run "$out" 4 --data 4 --optimizer cpu_adam --threads all --steps 1;;
esac
case $ROWS in *c*) run "$out" 4 --pipe 2 --data 2;; esac
case $ROWS in *d*) run "$out" 4 --data 4 --xl --save-peak;; esac
exit $rc
