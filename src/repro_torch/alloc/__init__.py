"""`repro_torch.alloc`: the multi-tenant client API of the support-core.

- :mod:`repro_torch.alloc.service`  -- AllocService / BurstBuilder / tickets
- :mod:`repro_torch.alloc.policies` -- the free-list policy
"""
from .policies import ALLOC_POLICIES, FreeListPolicy, get_policy
from .service import (AllocService, BurstBuilder, BurstResult, BurstStats,
                      TenantHandle, TenantStats, Ticket)

__all__ = [
    "ALLOC_POLICIES", "FreeListPolicy", "get_policy",
    "AllocService", "BurstBuilder", "BurstResult", "BurstStats",
    "TenantHandle", "TenantStats", "Ticket",
]
