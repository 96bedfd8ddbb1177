"""Per-node process spawner, one process per card (port of
``deepspeed_tpu/launcher/launch.py``, itself the reference's
``deepspeed/launcher/launch.py:67-167``): decodes the world info,
computes each local process's global id, sets the ``DS_*`` rendezvous
env consumed by ``utils/distributed.init_distributed`` (which hands it to
``torch.distributed.init_process_group``), spawns one Python process per
local slot, monitors them, and tears the node down if any child dies.
SIGINT/SIGTERM are forwarded to the children (reference ``:131-146``).

Each child gets its hostfile slot as ``DS_LOCAL_RANK`` and as torchrun's
``LOCAL_RANK``, from which ``utils/distributed.get_local_rank`` binds
``cuda:<slot>``.  No ``CUDA_VISIBLE_DEVICES`` is set, so a script that
passes an explicit ``device`` still picks its card; stale ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` from the launcher's
shell are dropped from the children's env.  ``--compile-cache-dir`` is
accepted and logs that it has no effect here: the port's kernels are
built once, keyed by a hash of their sources and renamed atomically
into ``build/`` (``ops/op_builder.py``), so a respawn finds them built.

Resilience contract (``deepspeed_tpu/resilience``):

- a child killed by a signal exits the launcher with ``128 + signum``
  (shell convention) and the signal is named in the log — a raw negative
  ``poll()`` code would wrap to a meaningless 24x value;
- ``--max-restarts N`` respawns a failed child up to N times with
  exponential backoff (``DS_RESTART_BACKOFF_SECS``, default 2s, doubling
  per restart of that slot, jittered by ``DS_RESTART_BACKOFF_JITTER`` so
  a fleet of launchers does not re-dial the coordinator in lockstep) —
  pair with ``deepspeed.initialize(..., auto_resume=True)`` so respawns
  land on the last committed checkpoint;
- **poison** exit codes (:data:`POISON_EXIT_CODES`, e.g. a divergence
  abort) never respawn: restarting would replay the same data into the
  same divergence.

Elastic resize-on-failure (``--elastic-config``): with
an elastic schedule armed, a *respawnable* child death — watchdog exit
85, a signal death, or a SIGTERM preemption notice the child drained its
final save under — no longer respawns the fleet at the same world size.
The supervisor (``elasticity/supervisor.py``) subtracts the failed
capacity from the device budget, asks the HCN planner for the largest
valid world size that still fits, re-derives micro-batch x grad-accum so
the global batch stays on the pre-declared schedule, and respawns the
whole fleet at the new size, exporting ``DS_ELASTIC_TARGET_WORLD_SIZE``
so scripts size their mesh, and ``DEEPSPEED_ELASTICITY_CONFIG`` so the
runtime's immutability check proves every life trains the same
schedule.  Poison codes still tear the node down: a divergence is never
"resized around".

Integrity-directed eviction (``resilience/integrity.py``): a child death
that carries an integrity verdict — exit 87 from a fingerprint-consensus
outlier or a hang-quorum fire, with the detecting rank's verdict file in
the shared run dir — turns the blind resize into an *aimed* one.  The
supervisor reads the verdict, charges the suspect's devices against the
elastic budget, blocklists the suspect's slot (``EvictionLedger``) so
the bad host never rejoins the fleet, clears the run dir's fleet state
(a new life must not vote against the previous life's stale
fingerprints), and respawns the fleet around the eviction; every rank
rolls back to the latest committed checkpoint via ``auto_resume``.
Verdicts past the eviction budget (``DS_INTEGRITY_MAX_EVICTIONS``,
default 1) poison the run instead: a fleet that keeps indicting ranks
after an eviction already removed the suspect has a problem no resize
fixes.
"""

import argparse
import json
import logging
import os
import random
import signal
import socket
import subprocess
import sys
import time

from ..elasticity.config import (ElasticityError,
                                 ElasticityIncompatibleWorldSize)
from ..elasticity.constants import ELASTICITY
from ..elasticity.supervisor import (EvictionLedger, export_plan_env,
                                     plan_world_size)
from ..resilience import integrity as fleet_integrity
from ..resilience.constants import (EXIT_DIVERGENCE_ABORT,
                                    EXIT_INTEGRITY_EVICT,
                                    POISON_EXIT_CODES)
# stdlib-only modules on purpose: the launcher never touches the card
# (the elasticity planner/supervisor above are plain-python too)
from ..telemetry.events import (EVENT_ELASTIC, EVENT_PROC_EXIT,
                                EVENT_PROC_RESPAWN, EVENT_PROC_SPAWN,
                                EVENT_RUN_END, EventLog)
from .constants import (ENV_COORDINATOR, ENV_LOCAL_RANK, ENV_NUM_PROCESSES,
                        ENV_PROCESS_ID, ENV_TORCH_LOCAL_RANK)
from .runner import decode_world_info

logger = logging.getLogger(__name__)

#: torchrun's rendezvous names: a copy left in the launcher's shell would
#: tell every child the same rank, so the spawner drops them
_STALE_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def parse_args(args=None):
    parser = argparse.ArgumentParser(
        description="DeepSpeed-TPU PyTorch port node spawner")
    parser.add_argument("--world_info", type=str, required=True)
    parser.add_argument("--node_rank", type=str, default="0",
                        help="this node's index, or 'auto' (match hostname)")
    parser.add_argument("--master_addr", type=str, required=True)
    parser.add_argument("--master_port", type=int, required=True)
    parser.add_argument("--max-restarts", "--max_restarts", type=int,
                        default=int(os.environ.get("DS_MAX_RESTARTS", "0")),
                        dest="max_restarts",
                        help="respawn a failed child up to N times with "
                             "backoff (poison exit codes never respawn); "
                             "default DS_MAX_RESTARTS, which the runner "
                             "forwards with the other DS_* variables")
    parser.add_argument("--telemetry-dir", "--telemetry_dir", type=str,
                        default=os.environ.get("DS_TELEMETRY_DIR", ""),
                        dest="telemetry_dir",
                        help="telemetry run dir: spawn/exit/respawn events "
                             "land in events-launcher.jsonl there (point "
                             "it at the engines' telemetry.run_dir so the "
                             "report CLI merges one timeline)")
    parser.add_argument("--compile-cache-dir", "--compile_cache_dir",
                        type=str,
                        default=os.environ.get("DS_COMPILE_CACHE_DIR", ""),
                        dest="compile_cache_dir",
                        help="accepted for the JAX launcher's command line; "
                             "no effect here (the kernels are built once, "
                             "hash-keyed, into build/)")
    parser.add_argument("--elastic-config", "--elastic_config", type=str,
                        default=os.environ.get("DS_ELASTIC_CONFIG", ""),
                        dest="elastic_config",
                        help="json file (a ds_config with an 'elasticity' "
                             "block, or a bare elasticity block) arming "
                             "elastic resize-on-failure: respawnable child "
                             "deaths re-plan the world size via the HCN "
                             "planner instead of respawning at the same "
                             "size")
    parser.add_argument("--elastic-devices", "--elastic_devices", type=int,
                        default=int(os.environ.get("DS_ELASTIC_DEVICES",
                                                   "0")),
                        dest="elastic_devices",
                        help="initial accelerator budget for the elastic "
                             "supervisor (default: one device per slot); "
                             "each respawnable failure subtracts "
                             "DS_ELASTIC_DEVICES_PER_FAILURE (default: "
                             "devices/processes) before re-planning")
    parser.add_argument("training_script", type=str)
    parser.add_argument("script_args", nargs=argparse.REMAINDER)
    ns = parser.parse_args(args)
    # tolerate the '--' separator the runner inserts
    if ns.training_script == "--" and ns.script_args:
        ns.training_script = ns.script_args[0]
        ns.script_args = ns.script_args[1:]
    return ns


def map_exit_code(ret):
    """Normalize ``Popen.poll()``'s return into a shell-meaningful exit
    code: signal deaths (negative) map to ``128 + signum``.  Returns
    ``(code, signal_name_or_None)``."""
    if ret is None or ret >= 0:
        return ret, None
    signum = -ret
    try:
        name = signal.Signals(signum).name
    except ValueError:
        name = f"signal {signum}"
    return 128 + signum, name


def load_elastic_config(path):
    """Read the ``elasticity`` block from ``path`` — a full ds_config
    json or a bare elasticity block — and require it enabled (an armed
    supervisor with a disabled schedule is a config error, not a silent
    no-op)."""
    with open(path) as f:
        cfg = json.load(f)
    block = cfg.get(ELASTICITY, cfg) if isinstance(cfg, dict) else None
    if not isinstance(block, dict):
        raise ValueError(f"--elastic-config {path}: expected a json object")
    if not block.get("enabled", False):
        raise ValueError(
            f"--elastic-config {path}: elasticity block is not enabled "
            "('enabled': true required to arm resize-on-failure)")
    return block


def backoff_jitter():
    """Multiplicative backoff jitter factor in [1, 1+DS_RESTART_BACKOFF_
    JITTER] (default 0.25): desynchronizes a fleet of launchers that all
    lost children to the same event, so the coordinator is not re-dialed
    in lockstep."""
    jitter = float(os.environ.get("DS_RESTART_BACKOFF_JITTER", "0.25"))
    return 1.0 + max(0.0, jitter) * random.random()


def resolve_node_rank(node_rank, world):
    if node_rank != "auto":
        return int(node_rank)
    hostname = socket.gethostname()
    hosts = list(world.keys())
    for cand in (hostname, hostname.split(".")[0], "localhost"):
        if cand in hosts:
            return hosts.index(cand)
    raise RuntimeError(
        f"cannot resolve node rank: hostname {hostname!r} not in {hosts}")


def main(argv=None):
    args = parse_args(argv)
    world = decode_world_info(args.world_info)
    node_rank = resolve_node_rank(args.node_rank, world)
    hosts = list(world.keys())
    assert 0 <= node_rank < len(hosts), f"node_rank {node_rank} vs {hosts}"

    # global process ids: hostfile order, then slot order
    first_id = sum(len(world[h]) for h in hosts[:node_rank])
    local_slots = world[hosts[node_rank]]
    total = sum(len(v) for v in world.values())

    # structured telemetry: restarts and exit codes become queryable
    # events instead of log lines (report CLI merges this stream with the
    # training ranks' events when they share a run dir)
    tel = (EventLog(args.telemetry_dir, rank="launcher",
                    filename="events-launcher.jsonl")
           if args.telemetry_dir else None)

    def tel_emit(event_type, **data):
        if tel is not None:
            tel.emit(event_type, **data)

    # -- elastic supervisor state (resize-on-failure; tentpole of the
    # preemptible-fleet story).  Armed by --elastic-config; the initial
    # world size ALSO comes from the planner so the first life and every
    # resized life share one derivation path.
    elastic = None
    if args.elastic_config:
        if len(hosts) > 1:
            raise RuntimeError(
                "--elastic-config: elastic resize-on-failure currently "
                "supervises a single-node fleet (one spawner owns the "
                "whole respawn decision); multi-node resize needs a "
                "cross-node supervisor")
        elastic_dict = load_elastic_config(args.elastic_config)
        budget = args.elastic_devices or len(local_slots)
        per_failure = int(os.environ.get(
            "DS_ELASTIC_DEVICES_PER_FAILURE",
            str(max(1, budget // max(1, len(local_slots))))))
        plan = plan_world_size(elastic_dict, budget)
        elastic = {"dict": elastic_dict, "budget": budget,
                   "per_failure": per_failure, "plan": plan, "resizes": 0,
                   "ledger": EvictionLedger()}
        # the FIRST life is also sized by the planner: processes scale
        # with the planned world size exactly as resizes do (a schedule
        # whose largest valid world is below the slot count must not
        # spawn extra ranks that own no mesh slice)
        n0 = min(len(local_slots),
                 max(1, round(len(local_slots) * plan.world_size
                              / max(1, budget))))
        local_slots = local_slots[:n0]
        total = n0
        logger.info(
            f"elastic supervisor armed: budget {budget} device(s), "
            f"world_size {plan.world_size} over {n0} process(es), "
            f"{per_failure} device(s) charged per failure")

    def spawn_env(local_rank, slot, n_procs, n_local):
        env = os.environ.copy()
        for name in _STALE_TORCHRUN_ENV:
            env.pop(name, None)
        if args.telemetry_dir:
            # every rank's engine defaults its telemetry run_dir here
            # (telemetry/config.py reads DS_TELEMETRY_DIR), so the
            # launcher's events-launcher.jsonl, the ranks' events/
            # metrics, AND the per-rank latency-rank<k>.json skew
            # exchange all share one directory — the report CLI merges
            # one timeline and cross-rank skew needs no other channel
            env["DS_TELEMETRY_DIR"] = os.path.abspath(args.telemetry_dir)
        env[ENV_COORDINATOR] = f"{args.master_addr}:{args.master_port}"
        env[ENV_NUM_PROCESSES] = str(n_procs)
        env[ENV_PROCESS_ID] = str(first_id + local_rank)
        # the SLOT id from the (include/exclude-filtered) hostfile, so slot
        # filtering reaches the process: get_local_rank binds cuda:<slot>
        # (torchrun's LOCAL_RANK for scripts written for torchrun)
        env[ENV_LOCAL_RANK] = str(slot)
        env[ENV_TORCH_LOCAL_RANK] = str(slot)
        # the ranks that share this host (torchrun's name): the host Adam
        # kernel splits the host's CPUs over them
        env["LOCAL_WORLD_SIZE"] = str(n_local)
        if elastic is not None:
            # the planned world size + normalized schedule travel to the
            # child: scripts size their mesh from the former, the
            # runtime's ensure_immutable_elastic_config proves the
            # latter never drifted across respawns
            export_plan_env(env, elastic["dict"], elastic["plan"])
        return env

    def spawn_fleet(slots, n_procs, restart=None):
        fleet = []
        for local_rank, slot in enumerate(slots):
            env = spawn_env(local_rank, slot, n_procs, len(slots))
            cmd = [sys.executable, "-u", args.training_script,
                   *args.script_args]
            logger.info(
                f"launching process {first_id + local_rank}/{n_procs}: "
                f"{' '.join(cmd)}")
            fleet.append({"proc": subprocess.Popen(cmd, env=env),
                          "cmd": cmd, "env": env, "slot": slot,
                          "rank": first_id + local_rank, "restarts": 0,
                          "respawn_at": None})
            tel_emit(EVENT_PROC_SPAWN, proc_rank=first_id + local_rank,
                     pid=fleet[-1]["proc"].pid,
                     **({} if restart is None else {"restart": restart}))
        return fleet

    if args.compile_cache_dir:
        logger.info("--compile-cache-dir has no effect on the PyTorch port: "
                    "its kernels are built once, hash-keyed, into build/")
    if args.telemetry_dir:
        # a reused run dir may hold a PREVIOUS run's verdict (teardown
        # paths don't clear — the launcher is already exiting) plus its
        # fingerprints/heartbeats: consumed at this run's first
        # respawnable death they would blocklist an innocent slot and
        # burn the eviction budget.  This run starts from a clean
        # integrity plane.  (Multi-node: a late-starting node's clear
        # briefly thins the live fleet's files; they republish within
        # one beat/print cadence.)
        n_stale = fleet_integrity.clear_fleet_state(args.telemetry_dir)
        if n_stale:
            logger.info(f"cleared {n_stale} stale integrity-plane "
                        "file(s) left in the run dir by a previous run")

    children = spawn_fleet(local_slots, total)   # [{proc, cmd, env, ...}]

    # Children may install a preemption checkpoint hook (checkpoint
    # subsystem, "save_on_preemption") that drains one final synchronous
    # save on SIGTERM — give them a grace window before escalating to
    # SIGKILL so that save can land.
    grace_secs = float(os.environ.get("DS_TERM_GRACE_SECS", "30"))

    def live_procs():
        return [c["proc"] for c in children if c["proc"] is not None]

    def terminate_all(sig=signal.SIGTERM, grace=grace_secs):
        for p in live_procs():
            if p.poll() is None:
                try:
                    p.send_signal(sig)
                except ProcessLookupError:
                    pass
        deadline = time.time() + grace
        while (time.time() < deadline
               and any(p.poll() is None for p in live_procs())):
            time.sleep(0.1)
        for p in live_procs():
            if p.poll() is None:
                logger.warning(f"process {p.pid} survived {grace:.0f}s "
                               "grace after signal; killing")
                p.kill()

    def tel_end(reason):
        # terminal marker for the launcher stream; reached from BOTH the
        # normal monitor-loop exit and the signal path (sys.exit there
        # would otherwise skip the end-of-main emit and the merged report
        # would read a clean preemption as a crashed launcher)
        if tel is not None:
            tel.emit(EVENT_RUN_END, reason=reason)
            tel.close()

    def forward_signal(signum, _frame):
        # the long grace exists for the SIGTERM preemption-save path; a
        # Ctrl-C should not pin the launcher for 30s (and a second Ctrl-C
        # escalates straight to SIGKILL via the nested handler's 0 grace)
        if signum == signal.SIGINT:
            signal.signal(signal.SIGINT,
                          lambda s, f: terminate_all(s, grace=0.0))
            terminate_all(signum, grace=min(grace_secs, 2.0))
        else:
            terminate_all(signum)
        tel_end(f"launcher signal {signum}")
        sys.exit(128 + signum)

    signal.signal(signal.SIGINT, forward_signal)
    signal.signal(signal.SIGTERM, forward_signal)

    consumed_verdicts = set()

    def consume_integrity_verdict(code):
        """The integrity verdict behind a child death, if any.  An exit
        87 should always have one (the detecting rank commits the
        verdict file before exiting); every OTHER respawnable death also
        checks, because the first death the monitor observes need not be
        the detecting rank (a hang victim dies by signal in the drain
        while its accusers exit 87).  Falls back to the CONSUMED marker
        a sibling node's launcher renamed the verdict to (multi-node
        shared run dir: deleting on first consumption would race the
        siblings' monitor polls and the node that owns the suspect's
        slot would resize blind); each verdict — identified by its
        commit (ts, suspect, kind) — is acted on at most once per
        launcher."""
        if not args.telemetry_dir:
            return None
        verdict = fleet_integrity.read_verdict(args.telemetry_dir,
                                               include_consumed=True)
        if verdict is not None:
            key = (verdict.get("ts"), verdict.get("suspect"),
                   verdict.get("kind"))
            if key in consumed_verdicts:
                verdict = None          # already acted on this one
            else:
                consumed_verdicts.add(key)
                # free VERDICT_FILE for the next life's first-writer-
                # wins commit while leaving the marker for siblings
                fleet_integrity.mark_verdict_consumed(args.telemetry_dir)
        if verdict is None and code == EXIT_INTEGRITY_EVICT:
            logger.warning(
                f"exit {code} (integrity eviction) without a readable "
                "verdict file in the run dir; resizing blind")
        return verdict

    def clear_integrity_state(reason, rank=None, keep_consumed=False):
        """Fleet state (fingerprints, heartbeats, the consumed verdict)
        must not leak into the next life: a rolled-back fleet recomputes
        the abandoned timeline and must not be voted against by its
        previous self.  ``rank`` narrows the clear to one rank's files
        (ordinary single-rank respawn: peers' state stays valid);
        ``keep_consumed`` preserves the consumed-verdict marker for
        sibling nodes' launchers (the resize path)."""
        if args.telemetry_dir:
            n = fleet_integrity.clear_fleet_state(
                args.telemetry_dir, rank=rank,
                keep_consumed=keep_consumed)
            if n:
                logger.info(f"cleared {n} integrity-plane file(s) from "
                            f"the run dir ({reason})")

    def elastic_resize(child, code, signame, verdict=None):
        """One resize cycle: charge the failed capacity, re-plan, drain
        the survivors (SIGTERM grace — their preemption saves land),
        respawn the whole fleet at the planned size.  With an integrity
        ``verdict``, the resize is aimed: the suspect's slot joins the
        eviction blocklist and never rejoins the fleet.  Returns the new
        children list, None when no valid world size is left, or
        ``"poison"`` when a repeated eviction must tear the run down
        un-respawned."""
        suspect_slot = None
        if verdict is not None:
            suspect = verdict.get("suspect")
            suspect_slot = next((c["slot"] for c in children
                                 if c["rank"] == suspect), None)
            tel_emit(EVENT_ELASTIC, phase="evict", suspect=suspect,
                     slot=suspect_slot, kind=verdict.get("kind"),
                     detail=verdict.get("detail"),
                     eviction=len(elastic["ledger"].evictions) + 1,
                     exit_code=code)
            if not elastic["ledger"].record(suspect, suspect_slot,
                                            verdict.get("kind", "?"),
                                            verdict.get("detail", "")):
                return "poison"
        elastic["resizes"] += 1
        elastic["budget"] -= elastic["per_failure"]
        prev = elastic["plan"]
        try:
            plan = plan_world_size(elastic["dict"], elastic["budget"])
        except ElasticityIncompatibleWorldSize as e:
            logger.error(f"elastic resize: {e}; tearing the node down")
            return None
        # a SIGTERM death is read as a preemption notice: the child's
        # grace-window save (checkpoint.save_on_preemption) already
        # landed, so the resized fleet resumes from it warm
        trigger = (f"integrity eviction (rank {verdict.get('suspect')}, "
                   f"{verdict.get('kind')})" if verdict is not None else
                   f"preemption notice ({signame})"
                   if signame == "SIGTERM" else
                   f"signal death ({signame})" if signame else
                   f"exit code {code}")
        tel_emit(EVENT_ELASTIC, phase="plan",
                 surviving_devices=elastic["budget"],
                 prev_world_size=prev.world_size,
                 planned_world_size=plan.world_size,
                 micro_batch=plan.micro_batch,
                 grad_accum=plan.grad_accum,
                 global_batch=plan.global_batch,
                 trigger=trigger, exit_code=code)
        delay = (backoff_base * (2 ** (elastic["resizes"] - 1))
                 * backoff_jitter())
        # the respawn event carries the PLANNED world size: a reader of
        # the launcher stream alone can see the fleet shrank, without
        # joining against the engines' streams
        tel_emit(EVENT_PROC_RESPAWN, proc_rank=child["rank"],
                 restart=elastic["resizes"], backoff_secs=delay,
                 exit_code=code, planned_world_size=plan.world_size)
        logger.warning(
            f"elastic resize {elastic['resizes']}/{args.max_restarts}: "
            f"{trigger} -> world {prev.world_size} -> {plan.world_size} "
            f"(micro={plan.micro_batch} x accum={plan.grad_accum}), "
            f"respawning after {delay:.1f}s backoff")
        # drain survivors under the SIGTERM grace before respawning: the
        # fleet must not straddle two world sizes, and in-flight saves
        # must commit before their writers die
        terminate_all()
        time.sleep(delay)
        # the new life rolls back to the latest committed checkpoint
        # (auto_resume) and recomputes the abandoned timeline — stale
        # fingerprints/heartbeats must go first; the consumed-verdict
        # marker stays (siblings sharing the run dir dedup by ts)
        clear_integrity_state(f"resize {elastic['resizes']}",
                              keep_consumed=True)
        n_prev = max(1, len(children))
        n_procs = max(1, round(n_prev * plan.world_size
                               / max(1, prev.world_size)))
        # spawn only from slots no integrity verdict has indicted: the
        # evicted host's devices never rejoin the fleet
        slots = elastic["ledger"].filter_slots(local_slots)
        if not slots:
            logger.error("elastic resize: every slot is on the eviction "
                         "blocklist; tearing the node down")
            return None
        n_procs = min(n_procs, len(slots))
        elastic["plan"] = plan
        fleet = spawn_fleet(slots[:n_procs], n_procs,
                            restart=elastic["resizes"])
        tel_emit(EVENT_ELASTIC, phase="resize", procs=n_procs,
                 world_size=plan.world_size, restart=elastic["resizes"],
                 **({"evicted_slots": sorted(
                     elastic["ledger"].blocked_slots)}
                    if elastic["ledger"].evictions else {}))
        return fleet

    # monitor: a failed child is respawned (up to --max-restarts, with
    # jittered exponential backoff) unless its exit code is poison;
    # with the elastic supervisor armed the respawn becomes a fleet
    # RESIZE; anything past the budget tears down the node (reference
    # :151-167)
    backoff_base = float(os.environ.get("DS_RESTART_BACKOFF_SECS", "2"))
    alive = list(children)
    rc = 0
    tearing_down = False
    while alive:
        time.sleep(float(os.environ.get("DS_MONITOR_POLL_SECS", "1")))
        for child in list(alive):
            if child["proc"] is None:
                # backoff window: the respawn deadline is checked per poll
                # tick instead of sleeping inline, so a sibling's poison
                # exit or signal death still tears the node down promptly
                if tearing_down:
                    alive.remove(child)
                elif time.time() >= child["respawn_at"]:
                    child["respawn_at"] = None
                    child["proc"] = subprocess.Popen(child["cmd"],
                                                     env=child["env"])
                    tel_emit(EVENT_PROC_SPAWN, proc_rank=child["rank"],
                             pid=child["proc"].pid,
                             restart=child["restarts"])
                continue
            ret = child["proc"].poll()
            if ret is None:
                continue
            code, signame = map_exit_code(ret)
            tel_emit(EVENT_PROC_EXIT, proc_rank=child["rank"], code=code,
                     signal=signame)
            if code == 0:
                alive.remove(child)
                continue
            where = (f"process {child['proc'].pid} (rank {child['rank']})")
            if signame is not None:
                logger.error(f"{where} killed by {signame}; exit code "
                             f"mapped to {code}")
            if code in POISON_EXIT_CODES:
                # a divergence abort is never "resized around": replaying
                # the same data on a smaller fleet reaches the same
                # divergence with less capacity
                logger.error(
                    f"{where} exited with poison code {code} (e.g. "
                    "divergence abort): never respawning — terminating "
                    "the node")
            elif (elastic is not None and not tearing_down
                    and elastic["resizes"] < args.max_restarts):
                fleet = elastic_resize(child, code, signame,
                                       verdict=consume_integrity_verdict(
                                           code))
                if fleet == "poison":
                    # repeated eviction: escalate to the poison code —
                    # the teardown below must never respawn, and the
                    # launcher's own exit says why
                    code = EXIT_DIVERGENCE_ABORT
                elif fleet is not None:
                    children = fleet
                    alive = list(children)
                    break   # the fleet was replaced wholesale
            elif (elastic is None and not tearing_down
                    and child["restarts"] < args.max_restarts):
                child["restarts"] += 1
                delay = (backoff_base * (2 ** (child["restarts"] - 1))
                         * backoff_jitter())
                logger.warning(
                    f"{where} exited with code {code}; respawning "
                    f"(restart {child['restarts']}/{args.max_restarts}) "
                    f"after {delay:.1f}s backoff")
                tel_emit(EVENT_PROC_RESPAWN, proc_rank=child["rank"],
                         restart=child["restarts"], backoff_secs=delay,
                         exit_code=code)
                if code == EXIT_INTEGRITY_EVICT:
                    # no supervisor to aim the respawn, but the new life
                    # still must not vote against its previous self's
                    # stale fingerprints/heartbeats
                    clear_integrity_state(
                        f"respawn of rank {child['rank']}")
                else:
                    # ordinary crash: the dead life's stale heartbeat
                    # would read as a hang (step lags the head, beat
                    # stale) through the backoff + re-init window and
                    # the quorum would falsely evict the new life —
                    # clear only THIS rank's files, peers' state is
                    # still valid
                    clear_integrity_state(
                        f"respawn of rank {child['rank']}",
                        rank=child["rank"])
                child["proc"] = None
                child["respawn_at"] = time.time() + delay
                continue
            else:
                logger.error(f"{where} exited with code {code}; "
                             "terminating remaining processes")
            alive.remove(child)
            tearing_down = True
            terminate_all()
            if rc == 0:  # keep the FIRST failure, not siblings' SIGTERM
                rc = code
    tel_end(f"launcher exit rc={rc}")
    sys.exit(rc)


if __name__ == "__main__":
    main()
