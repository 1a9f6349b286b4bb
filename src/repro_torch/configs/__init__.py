"""Per-architecture configs + registry (the dense and hybrid families of the port)."""
from .base import ARCH_IDS, ArchConfig, get_config, register, smoke_config

__all__ = ["ARCH_IDS", "ArchConfig", "get_config", "register", "smoke_config"]
