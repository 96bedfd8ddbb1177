#!/bin/bash
# Sequence parallelism through the gather cores on four cards of one
# host (examples/train_torch_ring.py, launched by the port's runner, one
# rank a card), bf16, dropout 0, Lamb, ZeRO-2, 3 + 5 steps and 2 steps
# under torch.profiler:
#   - GPT-2-medium with the dense core at seq 4 (s=4096, micro-batch 2),
#     against the one-card dense run on the same batch; the ring at seq
#     4 is examples/train_torch_ring_4card.sh's first row;
#   - BERT-large pretraining with the sparse core (Fixed bidirectional
#     128-row blocks, G = 4) at seq 4, s=4096, micro-batch 2, against
#     its one-card run;
#   - MoE GPT-2-medium (4 experts in every second block, top-2) at
#     expert 2 x seq 2, s=4096, micro-batch 2, against its one-card run.
# The multi-card runs' first 3 losses are held to the one-card runs'
# within 2e-3.  Run from the root of a checkout:
#
#     bash examples/train_torch_seq_4card.sh
#
# The JSON lines go to chiprun_out/seq4card.jsonl.
set -u
out=chiprun_out/seq4card.jsonl
python3 -c "from deepspeed_tpu_torch.ops import op_builder; op_builder.build()" || exit 1
nvidia-smi --query-gpu=index,name,power.limit --format=csv,noheader
python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda, torch.cuda.nccl.version())'
mkdir -p chiprun_out build
rm -f "$out"
rc=0
port=29601
run() {
    local n=$1; shift
    port=$((port + 1))
    timeout 480 python3 -m deepspeed_tpu_torch.launcher.runner \
        --hostfile build/no_hostfile --num_procs "$n" \
        --master_addr 127.0.0.1 --master_port "$port" \
        examples/train_torch_ring.py --reference "$out" --out "$out" "$@" \
        || rc=1
}
run 1 --dense
run 4 --seq 4 --core dense
run 1 --bert-sparse
run 4 --seq 4 --bert-sparse
run 1 --moe 4 --dense
run 4 --seq 2 --expert 2 --moe 4 --core dense
exit $rc
