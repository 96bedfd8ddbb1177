from .profiler import (COMPOSITE, ELEMENTWISE, REDUCE, FlopCounter,
                       FlopsProfile, FlopsProfiler, aten_flops,
                       count_fn_flops, get_model_profile, kernel_launch,
                       named_scope, params_count)

__all__ = ["COMPOSITE", "ELEMENTWISE", "REDUCE", "FlopCounter",
           "FlopsProfile", "FlopsProfiler", "aten_flops", "count_fn_flops",
           "get_model_profile", "kernel_launch", "named_scope",
           "params_count"]
