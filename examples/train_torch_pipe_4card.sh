#!/bin/bash
# GPT-2-medium through the pipeline engine on four cards of one host:
# pipe 4 (6 blocks a card), then pipe 2 x data 2, each 3 + 5 steps, 2
# steps under torch.profiler and one step timed instruction by
# instruction (examples/train_torch_pipe.py).  Run from the
# root of a checkout:
#
#     bash examples/train_torch_pipe_4card.sh [REFERENCE]
#
# REFERENCE: a chip_smoke.py --out file whose pipe phase's one-stage
# losses the first three losses are compared with.  The JSON lines go
# to chiprun_out/pipe4card.jsonl.
set -u
ref=()
if [ $# -ge 1 ]; then ref=(--reference "$1"); fi
python3 -c "from deepspeed_tpu_torch.ops import op_builder; op_builder.build()" || exit 1
nvidia-smi --query-gpu=index,name,power.limit --format=csv,noheader
python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda, torch.cuda.nccl.version())'
mkdir -p chiprun_out
rc=0
timeout 360 torchrun --nproc-per-node 4 examples/train_torch_pipe.py --pipe 4 \
    "${ref[@]}" --out chiprun_out/pipe4card.jsonl || rc=1
timeout 360 torchrun --nproc-per-node 4 examples/train_torch_pipe.py --pipe 2 --data 2 \
    "${ref[@]}" --out chiprun_out/pipe4card.jsonl || rc=1
exit $rc
