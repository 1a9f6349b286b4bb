"""Fused support-core burst: one CUDA launch per HMQ batch."""
from .ops import KERNEL, support_core_burst  # noqa: F401
