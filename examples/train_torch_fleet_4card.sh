#!/usr/bin/env bash
# Four cards: the port's runner, given no hostfile, counts the cards and
# spawns one rank a card; the ranks train GPT-2-medium (bf16, ZeRO-0,
# NCCL, the replica script's elastic schedule: global batch 8 on 1, 2 or
# 4 ranks) with the fleet integrity plane armed (fingerprint consensus
# and the heartbeat); rank 3 is SIGKILLed entering step 4, after step
# 3's checkpoint; the launcher re-plans 4 -> 2 and the two-rank life
# auto-resumes to step 6.  One JSON summary line to stdout and to
# <out>/summary.json; the checkpoints go under build/ and are deleted.
#
#   bash examples/train_torch_fleet_4card.sh [out_dir]
set -uo pipefail
OUT=${1:-runs/fleet4card}
CKPT=build/fleet4card_ckpt
rm -rf "$OUT" "$CKPT"
mkdir -p "$OUT" build
if [ "${FLEET_MODEL:-gpt2-medium}" = tiny ]; then
    # a CPU rehearsal of the control flow: FLEET_MODEL=tiny
    # FLEET_RUNNER_ARGS="--num_procs 4" (gloo, the tiny GPT-2)
    echo "cpu rehearsal" > "$OUT/card.txt"
else
    python3 -c "from deepspeed_tpu_torch.ops import op_builder; op_builder.build()" || exit 1
    nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > "$OUT/card.txt"
fi
cat > build/fleet4card_elastic.json <<'JSON'
{"elasticity": {"enabled": true, "max_train_batch_size": 8,
 "micro_batch_sizes": [2, 4], "min_gpus": 1, "max_gpus": 4, "version": 0.1}}
JSON
export DS_ELASTIC_CONFIG=build/fleet4card_elastic.json DS_ELASTIC_DEVICES=4 \
    DS_ELASTIC_DEVICES_PER_FAILURE=1 DS_MAX_RESTARTS=1 \
    DS_TELEMETRY_DIR="$OUT/tel" DS_TERM_GRACE_SECS=30 \
    FLEET_MODEL=${FLEET_MODEL:-gpt2-medium} FLEET_STEPS=6 \
    FLEET_SAVE_EVERY=3 DS_CHAOS_KILL_STEP=4 DS_CHAOS_TARGET_RANK=3 \
    DS_INTEGRITY_PEER_TIMEOUT=60
T0=$(date +%s.%N)
python3 -m deepspeed_tpu_torch.launcher.runner --hostfile build/no_hostfile \
    --master_addr 127.0.0.1 \
    --master_port 29555 ${FLEET_RUNNER_ARGS:-} examples/torch_fleet_replica.py \
    train "$OUT/out" "$CKPT"
RC=$?
T1=$(date +%s.%N)
rm -rf "$CKPT"
python3 - "$OUT" "$RC" "$T0" "$T1" <<'PY'
import json, os, sys
out, rc, t0, t1 = sys.argv[1], int(sys.argv[2]), float(sys.argv[3]), float(sys.argv[4])
def lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
tel = os.path.join(out, "tel")
launcher = lines(os.path.join(tel, "events-launcher.jsonl"))
# rank 0's steps, each with the life that logged it
steps = [dict(rec, life=name[len("steps-rank0-"):-len(".jsonl")])
         for name in sorted(os.listdir(os.path.join(out, "out")))
         if name.startswith("steps-rank0-")
         for rec in lines(os.path.join(out, "out", name))]
verdicts = [r["data"] for name in sorted(os.listdir(tel))
            if name.startswith("events-rank")
            for r in lines(os.path.join(tel, name)) if r["type"] == "integrity"]
summary = {"card": open(os.path.join(out, "card.txt")).read().strip(),
           "rc": rc, "seconds": t1 - t0, "steps": steps,
           "launcher_events": [(r["type"], r["data"]) for r in launcher],
           "integrity_verdicts": sorted({(v["verdict"], v.get("voters"))
                                         for v in verdicts})}
with open(os.path.join(out, "summary.json"), "w") as f:
    json.dump(summary, f, indent=1)
print(json.dumps(summary))
PY
exit $RC
