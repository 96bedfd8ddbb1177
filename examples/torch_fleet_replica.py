"""One replica of a supervised fleet, for the port's launcher, elasticity
and fleet-integrity runs (no jax).  Start it under the launcher, one
process a slot::

    python -m deepspeed_tpu_torch.launcher.launch --world_info W \\
        --master_addr 127.0.0.1 --master_port P [--elastic-config E \\
        --telemetry-dir D --max-restarts N] \\
        examples/torch_fleet_replica.py train <out_dir> <ckpt_dir>
    ... examples/torch_fleet_replica.py serve <out_dir>

``FLEET_MODEL=tiny`` (the default: GPT-2 with 2 layers, hidden 32,
vocab 256, on the CPU) or ``gpt2-medium`` (full width and depth, bf16,
on the cards: each rank on ``cuda:<slot>``, or with ``FLEET_ONE_CARD=1``
every replica on ``cuda:0``, replicas sharing one card).

``train``: with ``FLEET_REPLICAS=1`` every process is a full replica
(it drops ``DS_COORDINATOR`` and trains the whole global batch alone,
so replicas agree bit for bit, the invariant the fingerprint consensus
votes on); otherwise the processes form one data-parallel world (gloo
on the CPU, NCCL on the cards) whose batch the config's ``elasticity``
block sizes from the planned world.  ``resilience.integrity`` is on
(consensus wherever each process holds a full replica, the heartbeat
with ``DS_INTEGRITY_PEER_TIMEOUT``).
Each life resumes the latest committed checkpoint
(``auto_resume``), saves one every ``FLEET_SAVE_EVERY`` steps (default
1; 0: none), and appends ``{step, loss, world,
samples}`` to ``steps-rank<r>-<life>.jsonl``; at the end each replica
votes once more on its final state and writes
``final-rank<r>.json`` (losses, its fingerprint history, its verdicts,
its kernel launches).  Chaos on the first life only, rank
``DS_CHAOS_TARGET_RANK``: ``DS_CHAOS_BITFLIP_STEP`` flips one seeded
bit of its master before that step, ``DS_CHAOS_HANG_STEP`` wedges it
before it enters that step, ``DS_CHAOS_KILL_STEP`` SIGKILLs it there.

``serve``: a replica with the health plane armed
(:class:`~deepspeed_tpu_torch.inference.ServingHealth` into the
launcher's ``DS_TELEMETRY_DIR``, :func:`arm_serving_preemption` for the
SIGTERM drain) serving one shared seeded request set exactly once: each
life unions every ledger (``results-<pid>.jsonl``) into a done set and
serves ``remaining[rank::world]``; a drained replica parks, beating and
voting, until every request is done; a replica convicted of corrupt
weights withdraws its own ledger before it exits 87, so healthy
replicas re-serve its requests; each life writes its kernel launches to
``launches-<pid>.json``.  Chaos on the first life of each slot,
``DS_SERVE_CHAOS_KIND`` = ``kill`` | ``hang`` | ``bitflip`` at replica
1's second engine iteration.
"""

import json
import os
import pickle
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import deepspeed_tpu_torch  # noqa: E402
from deepspeed_tpu_torch.inference import (InferenceEngine,  # noqa: E402
                                           ServingHealth,
                                           arm_serving_preemption)
from deepspeed_tpu_torch.inference.resilience import (  # noqa: E402
    read_fleet_weight_fingerprints)
from deepspeed_tpu_torch.models.gpt2 import (GPT2Config,  # noqa: E402
                                             GPT2LMHead, random_params)
from deepspeed_tpu_torch.ops.transformer import (  # noqa: E402
    flash_attention as fa)
from deepspeed_tpu_torch.resilience import integrity as integ  # noqa: E402
from deepspeed_tpu_torch.resilience.chaos import ChaosMonkey  # noqa: E402
from deepspeed_tpu_torch.resilience.constants import (  # noqa: E402
    FleetIntegrityError, TrainingDivergedError)
from deepspeed_tpu_torch.runtime.dataloader import (  # noqa: E402
    RepeatingLoader)

SEED = 0
SAMPLES = 40          # a train epoch: 5 global batches of 8
REQUESTS = 9          # the serving fleet's requests
TINY = dict(vocab_size=256, hidden_size=32, num_layers=2, num_heads=2,
            max_position_embeddings=64)
# the kernels whose launches a replica reports
COUNTERS = {"B1": fa.flash_attention_fwd, "B2a": fa.flash_attention_bwd_dq,
            "B2b": fa.flash_attention_bwd_dkv,
            "B3": fa.flash_attention_bwd_fused, "B4": fa.draw_keep_bits,
            "B4 applied": fa.in_kernel_dropout}
# the tiny model's elastic schedule: global batch 8 on 1, 2 or 4 ranks
ELASTIC = {"enabled": True, "max_train_batch_size": 8,
           "micro_batch_sizes": [2, 4], "min_gpus": 1, "max_gpus": 4,
           "version": 0.1}


def env_int(name, default=0):
    return int(os.environ.get(name, "") or default)


def env_float(name, default=0.0):
    return float(os.environ.get(name, "") or default)


def model_config():
    """(GPT2Config, device, sequence length): GPT-2-medium as
    chip_smoke's train cell (seq 1024, dropout 0.1), or the tiny model
    (seq 16, dropout 0) on the CPU."""
    if os.environ.get("FLEET_MODEL", "tiny") == "gpt2-medium":
        cfg = GPT2Config.gpt2_medium(embd_dropout=0.1, attn_dropout=0.1,
                                     resid_dropout=0.1)
        # replicas sharing one card all take cuda:0; otherwise each rank
        # binds cuda:<its slot> (the engine's default)
        device = "cuda:0" if os.environ.get("FLEET_ONE_CARD") == "1" \
            else None
        return cfg, device, 1024
    return GPT2Config(**TINY, embd_dropout=0.0, attn_dropout=0.0,
                      resid_dropout=0.0), "cpu", 16


def weights(cfg):
    """The model's numpy params: the pickle at ``FLEET_WEIGHTS`` (a
    parent that holds the weights already writes them once for all its
    replicas), else drawn from ``SEED``."""
    path = os.environ.get("FLEET_WEIGHTS")
    if path:
        with open(path, "rb") as f:
            return pickle.load(f)
    return random_params(cfg, SEED)


def reset_launches():
    for counter in COUNTERS.values():
        counter.launches = 0


def read_launches():
    return {name: counter.launches for name, counter in COUNTERS.items()}


# --------------------------------------------------------------- train
def train_config(cfg, device, ckpt_dir):
    replicas = os.environ.get("FLEET_REPLICAS") == "1"
    config = {
        "steps_per_print": 1,
        "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
        "resilience": {
            "enabled": True, "checkpoint_dir": ckpt_dir,
            "integrity": True,
            "integrity_peer_timeout_secs":
                env_float("DS_INTEGRITY_PEER_TIMEOUT"),
            "hang_timeout_secs": env_float("DS_WATCHDOG_SECS")},
        "telemetry": {"enabled": True},
    }
    if device != "cpu":
        config["bf16"] = {"enabled": True}
    if replicas:
        # every replica trains the whole global batch alone
        config["train_batch_size"] = env_int("FLEET_BATCH", 8)
    else:
        config["elasticity"] = dict(ELASTIC)
    return config


def train(out_dir, ckpt_dir):
    rank = env_int("DS_PROCESS_ID")
    torch.set_num_threads(1)
    replicas = os.environ.get("FLEET_REPLICAS") == "1"
    if replicas:
        # full replicas: no process group (the DS_PROCESS_ID and
        # DS_NUM_PROCESSES fleet identity still reaches the plane)
        os.environ.pop("DS_COORDINATOR", None)
    cfg, device, seq = model_config()
    total = env_int("FLEET_STEPS", 6)
    save_every = env_int("FLEET_SAVE_EVERY", 1)
    rng = np.random.default_rng(SEED + 1)
    samples = [{"input_ids": rng.integers(0, cfg.vocab_size, size=seq)}
               for _ in range(SAMPLES)]
    engine, _, loader, _ = deepspeed_tpu_torch.initialize(
        model=GPT2LMHead(cfg), model_parameters=weights(cfg),
        config=train_config(cfg, device, ckpt_dir), training_data=samples,
        device=device, auto_resume=True, dist_init_required=not replicas)
    fresh = engine.global_steps == 0
    target = env_int("DS_CHAOS_TARGET_RANK", -1)
    acc = engine.gradient_accumulation_steps()

    def pulls(name):
        step = env_int(name)
        return [(step - 1) * acc] if step and fresh else []

    it = ChaosMonkey(seed=SEED).wrap_iter(
        iter(RepeatingLoader(loader)), bitflip_steps=pulls(
            "DS_CHAOS_BITFLIP_STEP"), bitflip_engine=engine,
        hang_steps=pulls("DS_CHAOS_HANG_STEP"), hang_secs=600.0,
        kill_steps=pulls("DS_CHAOS_KILL_STEP"), rank=rank,
        target_rank=target)
    os.makedirs(out_dir, exist_ok=True)
    life = "fresh" if fresh else f"resumed@{engine.global_steps}"
    verdicts = []

    def note_verdict():
        plane = engine._integrity
        if plane is not None and plane.last_verdict is not None:
            verdicts.append(dict(plane.last_verdict))
            plane.last_verdict = None

    def lockstep():
        """Full replicas run unsynchronized; in this harness each waits
        until the whole fleet has published the fingerprint its last
        step fetched, so no replica races ahead (and a life's replicas
        all resume before rank 0 saves again).  A hung peer is the hang
        quorum's to convict, from the heartbeat thread."""
        plane = engine._integrity
        if plane is None or engine.global_steps % engine.steps_per_print():
            return
        label, deadline = engine.global_steps - 1, time.time() + 120
        while time.time() < deadline:
            fleet = integ.read_fleet_fingerprints(plane.run_dir,
                                                  plane.fleet_size)
            if len(fleet) == plane.fleet_size and all(
                    hist and max(hist) >= label for hist in fleet.values()):
                return
            time.sleep(0.02)

    reset_launches()
    losses = {}
    try:
        with open(os.path.join(out_dir, f"steps-rank{rank}-{life}.jsonl"),
                  "a") as f:
            while engine.global_steps < total:
                loss = float(engine.train_batch(it))
                note_verdict()
                losses[engine.global_steps] = loss
                # logged before the save: a life killed in the save has
                # logged a step its successor may train again
                f.write(json.dumps({
                    "step": engine.global_steps, "loss": loss,
                    "world": engine.dp_world_size,
                    "samples": engine.global_samples}) + "\n")
                f.flush()
                lockstep()
                if save_every and engine.global_steps % save_every == 0:
                    if not replicas:
                        # collective: rank 0 writes, and no rank goes on
                        # (to be killed) before the commit landed
                        engine.save_checkpoint(ckpt_dir, sync=True)
                        engine.wait_checkpoint(ckpt_dir)
                    elif rank == 0:
                        # of full replicas one writes for all
                        engine.save_checkpoint(ckpt_dir, sync=True)
        if device != "cpu":
            torch.cuda.synchronize()
        launches = read_launches()
        if engine._integrity is not None:
            # the final state: vote until the whole fleet has published
            # it (the replicas run unsynchronized)
            deadline = time.time() + 60
            while True:
                verdict = engine.vote_integrity()
                if (verdict["voters"] >= engine._integrity.fleet_size
                        or time.time() > deadline):
                    break
                time.sleep(0.05)
            note_verdict()
    except (FleetIntegrityError, TrainingDivergedError) as e:
        # the supervisor owns recovery: 87 evicts and resizes, 86 poisons
        sys.exit(e.exit_code)
    history = (dict(engine._integrity.history)
               if engine._integrity is not None else {})
    with open(os.path.join(out_dir, f"final-rank{rank}.json"), "w") as f:
        json.dump({"steps": engine.global_steps, "life": life,
                   "world": engine.dp_world_size,
                   "samples": engine.global_samples, "losses": losses,
                   "fingerprints": history, "verdicts": verdicts,
                   "launches": launches}, f)
    engine.close()


# --------------------------------------------------------------- serve
def request_set(vocab):
    """rid -> prompt: ``REQUESTS`` seeded prompts of 3-30 tokens, or
    with ``FLEET_MODEL=gpt2-medium`` the first ones of chip_smoke phase
    4's prompts (numpy seed 1, 32-960 tokens)."""
    n = REQUESTS
    if os.environ.get("FLEET_MODEL", "tiny") == "gpt2-medium":
        rng = np.random.default_rng(SEED + 1)
        lens = rng.integers(32, 961, size=16)
        prompts = [rng.integers(0, vocab, size=k).tolist() for k in lens]
    else:
        rng = np.random.RandomState(71)
        prompts = [[int(t) for t in rng.randint(0, vocab,
                                                size=rng.randint(3, 30))]
                   for _ in range(n)]
    return {f"req-{i:03d}": p for i, p in enumerate(prompts[:n])}


def serve_config(device):
    if device == "cpu":
        inf = {"kv_block_size": 8, "kv_blocks": 64, "max_batch_slots": 4,
               "max_seq_len": 64, "prefill_buckets": [8, 16, 32],
               "token_budget": 256}
    else:
        inf = {"kv_block_size": 16, "kv_blocks": 256, "max_batch_slots": 8,
               "max_seq_len": 1024, "prefill_buckets": [128, 256, 512, 1024],
               "token_budget": 8192, "weights_dtype": "bfloat16"}
    return {"inference": inf, "steps_per_print": 2,
            "telemetry": {"enabled": True,
                          "run_dir": os.environ["DS_TELEMETRY_DIR"]}}


def write_launches(out_dir):
    """This life's kernel launches, beside its ledger."""
    with open(os.path.join(out_dir, f"launches-{os.getpid()}.json"),
              "w") as f:
        json.dump(read_launches(), f)


def read_done(out_dir):
    """Union of every life's ledger; a torn line is not done."""
    done = {}
    for name in sorted(os.listdir(out_dir)):
        if not name.startswith("results-"):
            continue
        with open(os.path.join(out_dir, name)) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                    done[rec["rid"]] = rec
                except (ValueError, KeyError):
                    continue
    return done


def serve(out_dir):
    os.makedirs(out_dir, exist_ok=True)
    torch.set_num_threads(1)
    rank = env_int("DS_PROCESS_ID")
    world = env_int("DS_NUM_PROCESSES", 1)
    slot = env_int("DS_LOCAL_RANK")
    tel_dir = os.environ["DS_TELEMETRY_DIR"]
    max_new = env_int("DS_SERVE_MAX_NEW", 4)
    # chaos is a one-shot fault: later lives on this slot serve clean
    marker = os.path.join(out_dir, f"chaos-armed-slot{slot}")
    fresh = not os.path.exists(marker)
    with open(marker, "a"):
        pass
    cfg, device, _ = model_config()
    engine = InferenceEngine(GPT2LMHead(cfg), weights(cfg),
                             config=serve_config(device), device=device)
    # one prefill of each bucket and a decode before the health plane
    # arms: an unpublished replica cannot be convicted meanwhile
    buckets = engine.inference_config.prefill_buckets
    warm = [f"warmup-{os.getpid()}-{i}" for i in range(len(buckets))]
    for rid, bucket in zip(warm, buckets):
        engine.submit([1] * (bucket - 4), max_new_tokens=2, request_id=rid)
    engine.run()
    for rid in warm:
        engine.forget(rid)
    kind = os.environ.get("DS_SERVE_CHAOS_KIND", "")
    if fresh and kind:
        # at replica 1's second engine iteration, mid-serve
        ChaosMonkey(seed=SEED).wrap_engine_step(
            engine, kill_steps=[1] if kind == "kill" else (),
            hang_steps=[1] if kind == "hang" else (), hang_secs=600.0,
            bitflip_steps=[1] if kind == "bitflip" else (),
            rank=rank, target_rank=1)
    # this life's slice, read before the startup barrier below: no
    # replica of this life serves until every one has read the ledgers
    requests = request_set(cfg.vocab_size)
    done = read_done(out_dir)
    mine = sorted(r for r in requests if r not in done)[rank::world]
    health = ServingHealth(
        engine, tel_dir, rank, world,
        peer_timeout_secs=env_float("DS_SERVE_PEER_TIMEOUT", 30.0))
    engine.attach_health(health)
    # startup barrier: every replica's (healthy) fingerprint is on disk
    # before serving, so a later post-flip vote has every voter and a
    # corrupt-against-healthy tie cannot read as no majority
    health.sample()
    deadline = time.time() + 120
    while (len(read_fleet_weight_fingerprints(tel_dir, world)) < world
           and time.time() < deadline):
        time.sleep(0.05)
    reset_launches()
    ledger_path = os.path.join(out_dir, f"results-{os.getpid()}.jsonl")
    written = set()

    def flush_finished(f):
        """One flushed line per finished request: a death loses at most
        one torn (so re-served) record."""
        for rid in mine:
            req = engine.request(rid)
            if rid in written or req is None or req.state != "finished":
                continue
            # marked first: the SIGTERM drain may interrupt this loop
            # and run it again, and must not write the request twice
            written.add(rid)
            f.write(json.dumps({
                "rid": rid, "tokens": req.result()["tokens"], "rank": rank,
                "life": os.getpid()}) + "\n")
            f.flush()

    def drain_exit(code):
        # SIGTERM (a resize or preemption): arm_serving_preemption has
        # drained the engine; keep what finished, then die respawnable
        try:
            with open(ledger_path, "a") as f:
                flush_finished(f)
            write_launches(out_dir)
        finally:
            os._exit(code)

    arm_serving_preemption(engine, exit_fn=drain_exit)
    try:
        with open(ledger_path, "a") as f:
            for rid in mine:
                engine.submit(requests[rid], max_new_tokens=max_new,
                              request_id=rid)
            while not engine.scheduler.idle():
                engine.step()
                flush_finished(f)
            flush_finished(f)
            # park: keep beating (a clean finisher stays fresh to the hang
            # quorum) and voting until the fleet has served everything
            it = engine.decode_iterations
            while set(read_done(out_dir)) < set(requests):
                it += 1
                health.beat(it)
                if it % 20 == 0:
                    health.sample()
                time.sleep(0.05)
    except (FleetIntegrityError, TrainingDivergedError) as e:
        suspect = getattr(e, "suspect", None)
        if (getattr(e, "kind", None) == integ.KIND_SDC
                and suspect is not None and int(suspect) == rank):
            # every token this life served since the flip is suspect
            try:
                os.remove(ledger_path)
            except OSError:
                pass
        write_launches(out_dir)
        sys.exit(e.exit_code)
    write_launches(out_dir)
    engine.close()


def main():
    mode = sys.argv[1]
    if mode == "train":
        train(sys.argv[2], sys.argv[3])
    elif mode == "serve":
        serve(sys.argv[2])
    else:
        raise SystemExit(f"unknown mode {mode!r}: train or serve")


if __name__ == "__main__":
    main()
