"""Elastic training: the HCN batch planner, the config block and the
launcher's resize supervisor (port of ``deepspeed_tpu/elasticity/``)."""

from .elasticity import (compute_elastic_config, elasticity_enabled,
                         ensure_immutable_elastic_config)
from .config import (ElasticityConfig, ElasticityConfigError, ElasticityError,
                     ElasticityIncompatibleWorldSize)
from .supervisor import (DS_ELASTIC_TARGET_WORLD_SIZE, ElasticPlan,
                         elastic_world_size, export_plan_env,
                         normalized_elastic_config, plan_world_size)
