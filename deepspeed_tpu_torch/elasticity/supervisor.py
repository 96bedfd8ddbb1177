"""Elastic fleet supervisor: the re-planning half of resize-on-failure
(port of ``deepspeed_tpu/elasticity/supervisor.py``).

The HCN planner (:func:`~deepspeed_tpu_torch.elasticity.compute_elastic_config`)
is ahead-of-time: it fixes ONE global batch size and the set of device
counts that batch can re-factor over without changing convergence.  This
module turns that plan into the launcher's runtime decision: given the
devices still alive after a failure or preemption notice, pick the
largest valid world size that fits, re-derive micro-batch x grad-accum
so the global batch stays on the pre-declared schedule, and hand the
launcher the env contract its respawned children resume under.

Env contract (consumed by training scripts and ``DeepSpeedConfig``):

- ``DS_ELASTIC_TARGET_WORLD_SIZE`` — the data-parallel world size the
  supervisor planned for this (re)spawn; scripts size their mesh from it
  (:func:`elastic_world_size`).
- ``DEEPSPEED_ELASTICITY_CONFIG`` — the normalized elastic config json,
  so ``ensure_immutable_elastic_config`` proves every respawn still
  trains on the same schedule (a drifted config fails loudly instead of
  silently changing convergence).

Integrity-directed eviction (``resilience/integrity.py``): when the
fleet integrity plane names a bad rank — a state-fingerprint outlier or
a hang-quorum suspect — the resize is *aimed* instead of blind.  The
:class:`EvictionLedger` records which hostfile slots the verdicts have
indicted: their devices are charged against the elastic budget, the
slots join a blocklist every subsequent spawn respects (the suspect
host never rejoins the fleet), and evictions beyond the run's budget
escalate to the poison teardown — a fleet that keeps producing
integrity verdicts has a systemic problem no resize can fix.

Stdlib-only on purpose: the launcher imports this next to its other
stdlib-only collaborators.
"""

import json
import logging
import os
from collections import namedtuple

from . import constants as EC
from .config import ElasticityIncompatibleWorldSize
from .elasticity import compute_elastic_config

logger = logging.getLogger(__name__)

#: env var carrying the supervisor's planned data-parallel world size
DS_ELASTIC_TARGET_WORLD_SIZE = "DS_ELASTIC_TARGET_WORLD_SIZE"

ElasticPlan = namedtuple(
    "ElasticPlan",
    ["world_size",        # planned data-parallel device count
     "micro_batch",       # per-device micro batch at that world size
     "grad_accum",        # accumulation steps keeping the global batch
     "global_batch",      # the schedule's fixed global batch size
     "valid_world_sizes"  # every device count the schedule admits
     ])


def elastic_world_size(default=None):
    """The supervisor-planned world size for THIS process (or
    ``default`` when launched outside an elastic supervisor)."""
    val = os.environ.get(DS_ELASTIC_TARGET_WORLD_SIZE, "")
    return int(val) if val else default


def normalized_elastic_config(elastic_config_dict: dict) -> dict:
    """Canonical, json-stable form of an ``elasticity`` config block —
    what the supervisor exports as ``DEEPSPEED_ELASTICITY_CONFIG``.
    Micro-batch lists sort into one representation; the version rides
    through untouched (the immutability check compares versions as
    parsed numeric tuples, so ``0.1`` / ``"0.1"`` / ``"0.1.0"`` already
    agree without lossy coercion here)."""
    out = dict(elastic_config_dict)
    if EC.MICRO_BATCHES in out:
        out[EC.MICRO_BATCHES] = sorted(int(m) for m in out[EC.MICRO_BATCHES])
    return out


def plan_world_size(elastic_config_dict: dict, device_budget: int,
                    target_deepspeed_version=None) -> ElasticPlan:
    """Largest planner-valid world size not exceeding ``device_budget``,
    with the micro-batch x grad-accum factorization that keeps the
    global batch on the elastic schedule.

    Raises :class:`ElasticityIncompatibleWorldSize` when no valid device
    count fits the budget (fleet shrunk below the schedule's floor) —
    the launcher treats that as a terminal, non-respawnable condition.
    """
    ds_config = {EC.ELASTICITY: dict(elastic_config_dict)}
    final_batch, valid = compute_elastic_config(
        ds_config, target_deepspeed_version=target_deepspeed_version)
    fits = [w for w in valid if w <= int(device_budget)]
    if not fits:
        raise ElasticityIncompatibleWorldSize(
            f"no valid elastic world size fits {device_budget} surviving "
            f"device(s); the schedule admits {valid}")
    world = max(fits)
    _, _, micro = compute_elastic_config(
        ds_config, target_deepspeed_version=target_deepspeed_version,
        world_size=world)
    accum = final_batch // (micro * world)
    plan = ElasticPlan(world_size=world, micro_batch=micro,
                       grad_accum=accum, global_batch=final_batch,
                       valid_world_sizes=tuple(valid))
    logger.info(
        "elastic plan: %d surviving device(s) -> world_size=%d "
        "(micro=%d x accum=%d x dp=%d = global %d)", device_budget,
        world, micro, accum, world, final_batch)
    return plan


def export_plan_env(env: dict, elastic_config_dict: dict,
                    plan: ElasticPlan) -> dict:
    """Write the elastic env contract for one child spawn into ``env``
    (mutated and returned): the planned world size plus the normalized
    schedule for the immutability check on resume."""
    env[DS_ELASTIC_TARGET_WORLD_SIZE] = str(plan.world_size)
    env[EC.DEEPSPEED_ELASTICITY_CONFIG] = json.dumps(
        normalized_elastic_config(elastic_config_dict), sort_keys=True)
    return env


#: evictions one supervised run tolerates before poisoning (env
#: ``DS_INTEGRITY_MAX_EVICTIONS`` overrides): ONE bad host is the
#: cosmic-ray story the plane exists for; a fleet that keeps indicting
#: ranks after an eviction already resized around the suspect has a
#: systemic problem (bad batch of hosts, corrupted shared storage, a
#: software bug voting against itself) that shrinking cannot fix.
DEFAULT_MAX_EVICTIONS = 1


class EvictionLedger:
    """Integrity-verdict bookkeeping for one supervised run.

    The launcher records every consumed integrity verdict here:
    ``record()`` returns True while the eviction budget holds (resize
    around the suspect, blocklisting its slot) and False once the run
    must poison instead (*repeated eviction*).  ``blocked_slots`` is
    the planner-facing blocklist: every respawn spawns only from the
    slots NOT indicted by a previous verdict, so an evicted host's
    devices never rejoin the fleet no matter how many resizes follow.
    """

    def __init__(self, max_evictions=None):
        if max_evictions is None:
            raw = os.environ.get("DS_INTEGRITY_MAX_EVICTIONS",
                                 str(DEFAULT_MAX_EVICTIONS))
            try:
                max_evictions = int(raw)
            except ValueError:
                # same contract as the other env parses: a malformed
                # value degrades to the default, never kills the
                # launcher at startup
                logger.warning(
                    f"DS_INTEGRITY_MAX_EVICTIONS={raw!r} is not an "
                    f"integer; using {DEFAULT_MAX_EVICTIONS}")
                max_evictions = DEFAULT_MAX_EVICTIONS
        self.max_evictions = int(max_evictions)
        self.evictions = []     # [{"slot", "suspect", "kind", "detail"}]

    @property
    def blocked_slots(self):
        """Hostfile slots an integrity verdict has indicted — excluded
        from every subsequent spawn."""
        return frozenset(e["slot"] for e in self.evictions
                         if e["slot"] is not None)

    def filter_slots(self, slots):
        """``slots`` minus the blocklist, order preserved."""
        blocked = self.blocked_slots
        return [s for s in slots if s not in blocked]

    def record(self, suspect, slot, kind, detail=""):
        """Note one consumed verdict.  Returns True when the eviction
        fits the budget (resize around the suspect); False when this is
        a *repeated eviction* and the run must poison — there is no
        longer a basis to trust that evicting one more host fixes the
        fleet."""
        self.evictions.append({"slot": slot, "suspect": int(suspect),
                               "kind": str(kind), "detail": str(detail)})
        within = len(self.evictions) <= self.max_evictions
        if within:
            logger.warning(
                "integrity eviction %d/%d: rank %s (slot %s) indicted "
                "by %s verdict; its devices leave the elastic budget",
                len(self.evictions), self.max_evictions, suspect, slot,
                kind)
        else:
            logger.error(
                "repeated integrity eviction (%d > budget %d): rank %s "
                "(slot %s, %s) indicted after a previous eviction "
                "already resized around a suspect — poisoning the run "
                "instead of shrinking further",
                len(self.evictions), self.max_evictions, suspect, slot,
                kind)
        return within
