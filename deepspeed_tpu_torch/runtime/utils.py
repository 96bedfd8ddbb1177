"""Runtime utilities, the part the pipeline needs (port of
``deepspeed_tpu/runtime/utils.py``: ``tree_path_key`` ``:23``,
``partition_uniform`` ``:101``, ``partition_balanced`` ``:149``).

The partitioning math is pure Python, copied, so the port splits a layer
list into the same stages as the JAX package.
"""

from bisect import bisect_left


def tree_path_key(path):
    """The checkpoint key of a tree path (a sequence of dict keys and
    tuple indices): the components ``/``-joined, as the JAX package's
    ``tree_path_key`` writes them (``layers/3/w``, ``tied/emb``)."""
    return "/".join(str(p) for p in path)


def partition_uniform(num_items, num_parts):
    """Evenly spaced part boundaries; ``len == num_parts + 1``."""
    parts = [0] * (num_parts + 1)
    if num_items <= num_parts:
        for p in range(num_parts + 1):
            parts[p] = min(p, num_items)
        return parts
    chunksize = num_items // num_parts
    for p in range(num_parts):
        parts[p] = min(chunksize * p, num_items)
    parts[num_parts] = num_items
    return parts


def _lprobe(weights, num_parts, bottleneck):
    """Can the prefix-summed ``weights`` split into ``num_parts`` chunks
    of sum at most ``bottleneck``?  Returns ``(parts, success)``."""
    num_items = len(weights)
    total_weight = weights[-1]
    parts = [0] * (num_parts + 1)
    bsum = bottleneck
    chunksize = num_items // num_parts
    step = chunksize
    for p in range(1, num_parts):
        while step < num_items and weights[step] < bsum:
            step += chunksize
        step = bisect_left(weights, bsum, lo=step - chunksize,
                           hi=min(step, num_items))
        parts[p] = step
        bsum += bottleneck
    parts[num_parts] = num_items
    return parts, bsum >= total_weight


def _rb_partition_balanced(weights, num_parts, eps):
    """Binary search for the smallest feasible bottleneck."""
    total_weight = weights[-1]
    lower = total_weight / num_parts
    upper = total_weight
    while upper > lower + eps:
        mid = lower + ((upper - lower) / 2)
        _, success = _lprobe(weights, num_parts, mid)
        if success:
            upper = mid
        else:
            lower = mid + eps
    return upper


def prefix_sum_inc(weights):
    """Inclusive prefix sum."""
    out = list(weights)
    for i in range(1, len(out)):
        out[i] += out[i - 1]
    return out


def partition_balanced(weights, num_parts, eps=1e-3):
    """Boundaries that minimise the largest part's weight."""
    num_items = len(weights)
    if num_items <= num_parts:
        return partition_uniform(num_items, num_parts)
    weights_ = prefix_sum_inc(weights)
    bottleneck = _rb_partition_balanced(weights_, num_parts, eps=eps)
    parts, success = _lprobe(weights_, num_parts, bottleneck)
    assert success
    return parts
