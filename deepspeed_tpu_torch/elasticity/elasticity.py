"""Elastic batch-size planning (port of
``deepspeed_tpu/elasticity/elasticity.py``, itself a behavioral port of
the reference's ``deepspeed/elasticity/elasticity.py`` (reference
``:122-171`` for the v0.1 algorithm, ``:240-334`` for the API): given
acceptable micro-batch sizes and a max global batch, choose the global batch
size divisible by the largest number of device counts, so the scheduler can
scale the job across that set without changing convergence (global batch
fixed; micro×grad_acc×devices re-factored per world size).

Elasticity here is *ahead-of-time planning*, exactly as in the reference —
not live scaling (SURVEY §5.3).
"""

import json
import logging
import math
import os

from . import constants as EC
from .config import (ElasticityConfig, ElasticityConfigError, ElasticityError,
                     ElasticityIncompatibleWorldSize)

logger = logging.getLogger(__name__)

# Highly composite numbers: candidates with many divisors ⇒ many compatible
# device counts.  Same table as reference ``elasticity.py:19-58``.
HCN_LIST = [
    1, 2, 4, 6, 12, 24, 36, 48, 60, 120, 180, 240, 360, 720, 840, 1260, 1680,
    2520, 5040, 7560, 10080, 15120, 20160, 25200, 27720, 45360, 50400, 55440,
    83160, 110880, 166320, 221760, 277200, 332640, 498960, 554400, 665280, 720720,
]


def get_candidate_batch_sizes(base_list, max_acceptable_batch_size):
    """For each base, the largest base×HCN not exceeding the cap."""
    candidates = set()
    for base in base_list:
        best = base
        for hcn in HCN_LIST:
            if base * hcn > max_acceptable_batch_size:
                break
            best = base * hcn
        candidates.add(best)
    return list(candidates)


def get_valid_gpus(batch_size, micro_batches, min_valid_gpus, max_valid_gpus):
    """Device counts n such that batch_size = n × micro × k for some micro in
    ``micro_batches`` and integer k (reference ``elasticity.py:78-94``)."""
    valid = set()
    for micro_batch in micro_batches:
        if batch_size % micro_batch != 0:
            continue
        max_devs = batch_size // micro_batch
        divisors = [max_devs] + [i for i in range(1, max_devs // 2 + 1) if max_devs % i == 0]
        for n in divisors:
            if min_valid_gpus <= n <= max_valid_gpus:
                valid.add(n)
    return sorted(valid)


def get_best_candidates(candidate_batch_sizes, micro_batches, min_gpus, max_gpus, prefer_larger):
    max_valid = 0
    best_valid_gpus = None
    best_batch = int(min(micro_batches))
    for batch_size in candidate_batch_sizes:
        cur = get_valid_gpus(batch_size, micro_batches, min_gpus, max_gpus)
        better_count = len(cur) > max_valid
        tie_break = len(cur) == max_valid and (
            (prefer_larger and batch_size > best_batch)
            or (not prefer_larger and batch_size < best_batch))
        if better_count or tie_break:
            max_valid = len(cur)
            best_valid_gpus = cur
            best_batch = batch_size
    return best_batch, best_valid_gpus


def _get_compatible_gpus_v01(micro_batches, max_acceptable_batch_size, min_gpus=None,
                             max_gpus=None, prefer_larger=True):
    """v0.1 heuristic (reference ``elasticity.py:122-171``): candidate bases
    are each micro-batch and their LCM, each scaled to the largest HCN
    multiple under the cap; pick the candidate with the most compatible
    device counts."""
    min_gpus = min_gpus or 1
    max_gpus = max_gpus or max_acceptable_batch_size // min(micro_batches)
    assert all(mb <= max_acceptable_batch_size for mb in micro_batches), (
        f"All micro batches must be <= max_acceptable_batch_size={max_acceptable_batch_size}")

    lcm = micro_batches[0]
    for mb in micro_batches[1:]:
        lcm = lcm * mb // math.gcd(lcm, mb)

    candidates = get_candidate_batch_sizes(list(micro_batches) + [lcm],
                                           max_acceptable_batch_size)
    return get_best_candidates(candidates, micro_batches, min_gpus, max_gpus, prefer_larger)


def elasticity_enabled(ds_config: dict):
    if EC.ELASTICITY not in ds_config:
        return False
    return ds_config[EC.ELASTICITY].get(EC.ENABLED, EC.ENABLED_DEFAULT)


def parse_version(version) -> tuple:
    """``"0.3.11"`` / ``0.1`` / ``"0"`` -> a comparable numeric tuple,
    zero-padded to three components so ``"0" == "0.0.0"`` (this repo's
    versions are plain dotted numerics; anything else raises)."""
    parts = str(version).strip().split(".")
    try:
        nums = tuple(int(p) for p in parts)
    except ValueError as e:
        raise ElasticityConfigError(
            f"cannot parse version {version!r} as a dotted numeric") from e
    return nums + (0,) * (3 - len(nums)) if len(nums) < 3 else nums


def _normalize_field(field, value):
    """Canonical form of one immutability-checked field, so a respawned
    process comparing its runtime config against the
    ``DEEPSPEED_ELASTICITY_CONFIG`` json the launcher exported never
    rejects a SAME-config resume over representation drift: version
    compares as a zero-padded numeric tuple (``0.1`` vs ``"0.1"`` vs
    ``"0.1.0"``), micro-batch lists as sorted int tuples (json
    round-trips tuples into lists)."""
    if field == "version":
        return parse_version(value)
    if field == "micro_batches":
        return tuple(sorted(int(m) for m in value))
    return value


def ensure_immutable_elastic_config(runtime_elastic_config_dict: dict):
    """Fail if the resource scheduler planned with a different elastic config
    than the runtime sees (reference ``elasticity.py:206-237``); the plan is
    carried in the ``DEEPSPEED_ELASTICITY_CONFIG`` env var.

    Comparisons are value-based, not representation-based: a launcher
    respawn re-exports the same config through json, and ``0.1 != "0.1"``
    must not kill an elastic resume (the resize-on-failure loop re-enters
    here on every respawn)."""
    if EC.DEEPSPEED_ELASTICITY_CONFIG in os.environ:
        scheduler_config = ElasticityConfig(
            json.loads(os.environ[EC.DEEPSPEED_ELASTICITY_CONFIG]))
        runtime_config = ElasticityConfig(runtime_elastic_config_dict)
        for field in ("max_acceptable_batch_size", "micro_batches", "version"):
            sched_val = _normalize_field(field,
                                         getattr(scheduler_config, field))
            run_val = _normalize_field(field, getattr(runtime_config, field))
            if sched_val != run_val:
                raise ElasticityConfigError(
                    f"Elastic config {field}={sched_val} seen by resource scheduler does "
                    f"not match config passed to runtime {field}={run_val}")
    else:
        logger.warning(
            "Unable to find DEEPSPEED_ELASTICITY_CONFIG environment variable, cannot "
            "guarantee resource scheduler will scale this job using compatible device counts.")


def compute_elastic_config(ds_config: dict, target_deepspeed_version=None,
                           world_size=0):
    """Compute (final_batch_size, valid_device_counts[, micro_batch]) for an
    elastic job (reference ``elasticity.py:240-334``).

    ``target_deepspeed_version`` defaults to this package's own version;
    passing one checks it against :data:`EC.MINIMUM_DEEPSPEED_VERSION`
    under THIS repo's versioning (plain dotted numerics, zero-padded, so
    the historical ``"0"`` sentinel still means ``0.0.0``, not a parse
    error — the reference compared version strings lexically)."""
    if not isinstance(ds_config, dict):
        raise ValueError(
            f"Expected ds_config dict, got {type(ds_config)}: {ds_config}")
    if target_deepspeed_version is None:
        from .. import __version__ as target_deepspeed_version
    if (parse_version(target_deepspeed_version)
            < parse_version(EC.MINIMUM_DEEPSPEED_VERSION)):
        raise ElasticityConfigError(
            f"target deepspeed version {target_deepspeed_version} is older "
            f"than the minimum elasticity-capable version "
            f"{EC.MINIMUM_DEEPSPEED_VERSION}")
    if EC.ELASTICITY not in ds_config:
        raise ElasticityConfigError(
            f"'{EC.ELASTICITY}' is missing from config json, please add it if "
            "running an elastic training job.")
    elastic_config_dict = ds_config[EC.ELASTICITY]
    if not elastic_config_dict.get(EC.ENABLED, EC.ENABLED_DEFAULT):
        raise ElasticityConfigError(
            "Elasticity is disabled, please enable it ('enabled':true) if "
            "running an elastic training job.")

    elastic_config = ElasticityConfig(elastic_config_dict)
    # algorithm-version comparisons go through parse_version too, so
    # "0.1.0" means v0.1 instead of crashing float()
    if (parse_version(elastic_config.version)
            > parse_version(EC.LATEST_ELASTICITY_VERSION)):
        raise ElasticityConfigError(
            f"Attempting to run elasticity version {elastic_config.version} but "
            f"runtime only supports up to {EC.LATEST_ELASTICITY_VERSION}")

    if parse_version(elastic_config.version) == parse_version("0.1"):
        final_batch_size, valid_gpus = _get_compatible_gpus_v01(
            micro_batches=elastic_config.micro_batches,
            max_acceptable_batch_size=elastic_config.max_acceptable_batch_size,
            min_gpus=elastic_config.min_gpus,
            max_gpus=elastic_config.max_gpus,
            prefer_larger=elastic_config.prefer_larger_batch_size)
        final_batch_size = int(final_batch_size)
    else:
        raise NotImplementedError(
            f"Unable to find elastic logic for version: {elastic_config.version}")

    if world_size > 0:
        if world_size not in valid_gpus:
            raise ElasticityIncompatibleWorldSize(
                f"World size ({world_size}) is not valid with the current list of "
                f"valid device counts: {valid_gpus}")
        # Pick the largest micro batch that evenly divides this world's share.
        micro_batch_size = None
        for mbsz in sorted(set(elastic_config.micro_batches), reverse=True):
            if final_batch_size // world_size % mbsz == 0:
                micro_batch_size = mbsz
                break
        assert micro_batch_size is not None, (
            f"Unable to find divisible micro batch size: world_size={world_size}, "
            f"final_batch_size={final_batch_size}, micro_batches="
            f"{elastic_config.micro_batches}.")
        return final_batch_size, valid_gpus, micro_batch_size

    return final_batch_size, valid_gpus
