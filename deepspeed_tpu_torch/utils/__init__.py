"""Port-side utilities."""

from .params import params_from_numpy, params_to_numpy

__all__ = ["params_from_numpy", "params_to_numpy"]
