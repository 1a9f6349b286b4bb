"""Model API of the port: the family LMs, their decode step, sizing helpers.

The names resolve lazily (PEP 562): the models call the attention
kernels, whose plain versions import :mod:`.attention`, so importing a
kernel module first must not pull in the models above it.
"""
__all__ = ["IGNORE_LABEL", "abstract_params", "forward_train", "init_params",
           "input_specs", "jax_layout", "loss_fn", "make_paged_config",
           "params_from_numpy", "params_to_numpy", "port_layout",
           "splits_window", "synth_batch"]


def __getattr__(name):
    if name in __all__:
        from . import model_zoo
        return getattr(model_zoo, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
