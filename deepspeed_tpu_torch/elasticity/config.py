"""Elasticity config object (port of ``deepspeed_tpu/elasticity/config.py``,
the reference's ``deepspeed/elasticity/config.py``)."""

import json

from . import constants as EC


class ElasticityError(Exception):
    """Base exception for all elasticity related errors."""


class ElasticityConfigError(ElasticityError):
    """Elasticity configuration error."""


class ElasticityIncompatibleWorldSize(ElasticityError):
    """World size incompatible with the elastic config's valid device counts."""


class ElasticityConfig:
    """Typed view of the ``"elasticity"`` subsection.

    Required when enabled: ``max_train_batch_size`` and ``micro_batch_sizes``
    (reference ``config.py:48-60``).  "gpus" in key names is kept for config
    compatibility; the unit is cards (data-parallel ranks).
    """

    def __init__(self, param_dict):
        self.enabled = param_dict.get(EC.ENABLED, EC.ENABLED_DEFAULT)
        if self.enabled:
            for required in (EC.MAX_ACCEPTABLE_BATCH_SIZE, EC.MICRO_BATCHES):
                if required not in param_dict:
                    raise ElasticityConfigError(f"Elasticity config missing {required}")
            self.max_acceptable_batch_size = param_dict[EC.MAX_ACCEPTABLE_BATCH_SIZE]
            self.micro_batches = param_dict[EC.MICRO_BATCHES]
        else:
            self.max_acceptable_batch_size = param_dict.get(
                EC.MAX_ACCEPTABLE_BATCH_SIZE, EC.MAX_ACCEPTABLE_BATCH_SIZE_DEFAULT)
            self.micro_batches = param_dict.get(EC.MICRO_BATCHES, EC.MICRO_BATCHES_DEFAULT)

        if not isinstance(self.micro_batches, list):
            raise ElasticityConfigError(
                f"Elasticity expected {EC.MICRO_BATCHES} to be a list, got "
                f"{type(self.micro_batches)}: {self.micro_batches}")
        if not all(isinstance(m, int) and m > 0 for m in self.micro_batches):
            raise ElasticityConfigError(
                f"Elasticity expected {EC.MICRO_BATCHES} to contain positive ints, "
                f"got {self.micro_batches}")

        self.min_gpus = param_dict.get(EC.MIN_GPUS, EC.MIN_GPUS_DEFAULT)
        self.max_gpus = param_dict.get(EC.MAX_GPUS, EC.MAX_GPUS_DEFAULT)
        if self.min_gpus < 1 or self.max_gpus < 1:
            raise ElasticityConfigError(
                f"Elasticity min/max device counts must be > 0, got min={self.min_gpus} "
                f"max={self.max_gpus}")
        if self.max_gpus < self.min_gpus:
            raise ElasticityConfigError(
                f"Elasticity min_gpus cannot exceed max_gpus: min={self.min_gpus} "
                f"max={self.max_gpus}")

        self.min_time = param_dict.get(EC.MIN_TIME, EC.MIN_TIME_DEFAULT)
        if self.min_time < 0:
            raise ElasticityConfigError(f"Elasticity min_time must be >= 0: {self.min_time}")

        self.version = param_dict.get(EC.VERSION, EC.VERSION_DEFAULT)
        self.prefer_larger_batch_size = param_dict.get(EC.PREFER_LARGER_BATCH,
                                                       EC.PREFER_LARGER_BATCH_DEFAULT)
        self.ignore_non_elastic_batch_info = param_dict.get(
            EC.IGNORE_NON_ELASTIC_BATCH_INFO, EC.IGNORE_NON_ELASTIC_BATCH_INFO_DEFAULT)

    def repr(self):
        return self.__dict__

    def __repr__(self):
        return json.dumps(self.__dict__, sort_keys=True, indent=4)
