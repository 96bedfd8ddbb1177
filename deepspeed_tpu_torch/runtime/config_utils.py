"""Config parsing helpers (port of ``deepspeed_tpu/runtime/config_utils.py``)."""

import difflib
import json
from collections import Counter


def get_scalar_param(param_dict, param_name, param_default_value):
    return param_dict.get(param_name, param_default_value)


def dict_raise_error_on_duplicate_keys(ordered_pairs):
    """Reject duplicate keys during JSON load."""
    d = dict((k, v) for k, v in ordered_pairs)
    if len(d) != len(ordered_pairs):
        counter = Counter([pair[0] for pair in ordered_pairs])
        keys = [key for key, value in counter.items() if value > 1]
        raise ValueError("Duplicate keys in DeepSpeed config: {}".format(keys))
    return d


def load_config_json(path):
    with open(path, "r") as f:
        return json.load(f, object_pairs_hook=dict_raise_error_on_duplicate_keys)


def did_you_mean(key, candidates):
    """``"; did you mean 'x'?"`` for the closest known key, or ``""``
    (the JAX package's ``tools/dslint/schema.py`` cut-off, 0.75)."""
    match = difflib.get_close_matches(key, sorted(candidates), n=1,
                                      cutoff=0.75)
    return f"; did you mean '{match[0]}'?" if match else ""
