"""Config parsing helpers (port of ``deepspeed_tpu/runtime/config_utils.py``)."""


def get_scalar_param(param_dict, param_name, param_default_value):
    return param_dict.get(param_name, param_default_value)
