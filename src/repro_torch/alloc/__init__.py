"""`repro_torch.alloc`: the multi-tenant client API of the support-core.

- :mod:`repro_torch.alloc.service`  -- AllocService / BurstBuilder / tickets
- :mod:`repro_torch.alloc.policies` -- the free-list, bitmap and buddy
  policies and the ``register_policy`` seam
- :mod:`repro_torch.alloc.eviction` -- LRU, 2Q and ARC for the KV prefix
  cache and the ``register_eviction`` seam
"""
from .eviction import (EVICTION_POLICIES, ARCEviction, EvictionPolicy,
                       LRUEviction, TwoQEviction, get_eviction,
                       register_eviction)
from .policies import (ALLOC_POLICIES, AllocatorPolicy, BitmapPolicy,
                       BuddyPolicy, FreeListPolicy, get_policy,
                       register_policy)
from .service import (NAMESPACE_SEP, AllocService, BurstBuilder, BurstResult,
                      BurstStats, TenantHandle, TenantStats, Ticket,
                      empty_burst_stats)

__all__ = [
    "ALLOC_POLICIES", "AllocatorPolicy", "BitmapPolicy", "BuddyPolicy",
    "FreeListPolicy", "get_policy", "register_policy",
    "EVICTION_POLICIES", "EvictionPolicy", "LRUEviction", "TwoQEviction",
    "ARCEviction", "get_eviction", "register_eviction",
    "NAMESPACE_SEP", "AllocService", "BurstBuilder", "BurstResult",
    "BurstStats", "TenantHandle", "TenantStats", "Ticket",
    "empty_burst_stats",
]
