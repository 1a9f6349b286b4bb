"""`repro_torch.alloc`: the multi-tenant client API of the support-core.

- :mod:`repro_torch.alloc.service`  -- AllocService / BurstBuilder / tickets
- :mod:`repro_torch.alloc.policies` -- the free-list, bitmap and buddy
  policies and the ``register_policy`` seam
"""
from .policies import (ALLOC_POLICIES, AllocatorPolicy, BitmapPolicy,
                       BuddyPolicy, FreeListPolicy, get_policy,
                       register_policy)
from .service import (AllocService, BurstBuilder, BurstResult, BurstStats,
                      TenantHandle, TenantStats, Ticket)

__all__ = [
    "ALLOC_POLICIES", "AllocatorPolicy", "BitmapPolicy", "BuddyPolicy",
    "FreeListPolicy", "get_policy", "register_policy",
    "AllocService", "BurstBuilder", "BurstResult", "BurstStats",
    "TenantHandle", "TenantStats", "Ticket",
]
