"""Per-architecture configs + registry (the families the port serves)."""
from .base import (ARCH_IDS, PORT_ONLY_ARCH_IDS, SHAPES, ArchConfig,
                   all_configs, get_config, register, smoke_config)

__all__ = ["ARCH_IDS", "PORT_ONLY_ARCH_IDS", "SHAPES", "ArchConfig",
           "all_configs", "get_config", "register", "smoke_config"]
