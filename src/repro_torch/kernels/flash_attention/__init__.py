"""Flash prefill attention: one CUDA launch per prefill layer."""
from .ops import FLASH_KERNEL, flash_attention_op  # noqa: F401
