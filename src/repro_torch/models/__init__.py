"""Model API of the port: the dense LM, its decode step, sizing helpers."""
from .model_zoo import init_params, make_paged_config, params_from_numpy

__all__ = ["init_params", "make_paged_config", "params_from_numpy"]
