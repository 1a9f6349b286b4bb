"""Allocator-simulator trace scan: one CUDA launch per trace."""
from .ops import KERNEL, sim_trace  # noqa: F401
